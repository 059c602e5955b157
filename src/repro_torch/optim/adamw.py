"""AdamW with learning-rate schedules and global-norm clipping.

Ported from the reference's ``repro/optim/adamw.py``.  The moments are f32
whatever the parameters' dtype, with an optional f32 master copy; the new
parameters are cast back to each parameter's dtype.

Where the reference maps over pytrees, the port keys everything by
parameter name: ``params`` is an ``nn.Module`` or a mapping of names to
tensors, ``grads`` a mapping with the same names, and the state ``{"m":
{name: f32}, "v": {name: f32}, "step": int32 scalar, "master"?: {name:
f32}}``.  :func:`update` writes the parameters, the moments and the master
copy in place (a model at full width cannot hold a second copy of them
beside its gradients) and returns them, as the reference returns new ones.

Every scalar of the update is a tensor on the parameters' device, so that a
division is a division on the card as on the CPU: there a division by a
host scalar is a product with its reciprocal, one ulp off.
"""

from __future__ import annotations

import dataclasses
import math
from collections.abc import Iterable, Mapping

import torch
from torch import nn

from repro_torch.distributed import program as D


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    schedule: str = "cosine"  # cosine | linear | constant
    master_weights: bool = False


def named(params: nn.Module | Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """``{name: tensor}`` of a module's parameters, or of a mapping."""
    return dict(params.named_parameters()) if isinstance(params, nn.Module) else dict(params)


def leaf_order(names: Iterable[str]) -> list[str]:
    """The names in the order of the reference's ``jax.tree.leaves`` over its
    stacked pytree: dict keys sorted, list slots in order, and the stacked
    layer axis, which the port's names carry as their last numeric part
    (``blocks.<slot>.<group>.…``, ``blocks.<layer>.…``), inside its leaf, so
    that one leaf's layers come together."""

    def key(name: str):
        parts = name.split(".")
        nums = [i for i, p in enumerate(parts) if p.isdigit()]
        layer = int(parts[nums[-1]]) if nums else -1
        rest = [p for i, p in enumerate(parts) if not nums or i != nums[-1]]
        return tuple((0, int(p), "") if p.isdigit() else (1, 0, p) for p in rest), layer

    return sorted(names, key=key)


def _scalar(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def lr_at(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (an f32 scalar on ``step``'s device):
    linear warm-up, then cosine or linear decay to 0 at ``total_steps``, or
    constant."""
    step = step.float()
    warm = torch.clamp(step / _scalar(max(cfg.warmup_steps, 1), step), max=1.0)
    if cfg.schedule == "constant":
        decay = 1.0
    else:
        span = _scalar(max(cfg.total_steps - cfg.warmup_steps, 1), step)
        frac = torch.clamp((step - cfg.warmup_steps) / span, 0.0, 1.0)
        if cfg.schedule == "cosine":
            decay = 0.5 * (1.0 + torch.cos(math.pi * frac))
        else:
            decay = 1.0 - frac
    return cfg.lr * warm * decay


def init(cfg: AdamWConfig, params: nn.Module | Mapping[str, torch.Tensor]) -> dict:
    """Zero f32 moments for every parameter, step 0, and with
    ``master_weights`` an f32 copy of the parameters."""
    p = named(params)
    device = next(iter(p.values())).device
    state = {
        "m": {k: torch.zeros(t.shape, dtype=torch.float32, device=t.device) for k, t in p.items()},
        "v": {k: torch.zeros(t.shape, dtype=torch.float32, device=t.device) for k, t in p.items()},
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }
    if cfg.master_weights:
        state["master"] = {k: t.detach().float().clone() for k, t in p.items()}
    return state


def global_norm(grads: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of every leaf's f32 sum of squares, the leaves in
    the reference's order (:func:`leaf_order`).  Under a sharded program a
    leaf's sum is taken over the devices that hold distinct slices of it
    (``distributed/program.py::norm_parts``), so every device clips by the
    whole model's norm."""
    order = leaf_order(grads)
    parts = D.norm_parts({k: torch.sum(torch.square(grads[k].float())) for k in order})
    return torch.sqrt(sum(parts[k] for k in order))


@torch.no_grad()
def update(cfg: AdamWConfig, grads: Mapping[str, torch.Tensor], state: dict,
           params: nn.Module | Mapping[str, torch.Tensor]):
    """One AdamW step; returns ``(params, state, {"grad_norm", "lr"})``.
    The gradients are clipped to ``grad_clip`` by their global norm, then
    ``p <- p - lr (m̂ / (sqrt(v̂) + eps) + wd p)`` in f32 on the master copy
    when there is one.  Writes in place (module docstring), with two f32
    scratch tensors a parameter."""
    p = named(params)
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = (torch.clamp(_scalar(cfg.grad_clip, gnorm) / (gnorm + 1e-9), max=1.0)
             if cfg.grad_clip else _scalar(1.0, gnorm))
    lr = lr_at(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    stepf = step.float()
    bc1 = 1.0 - _scalar(b1, stepf) ** stepf
    bc2 = 1.0 - _scalar(b2, stepf) ** stepf
    master = state.get("master")
    for k, g in grads.items():
        # the reference's expression, each product and sum rounded in its
        # order, computed in place in two f32 scratch tensors
        m, v = state["m"][k], state["v"][k]
        g = g.float() * scale
        t = g * (1 - b2)
        v.mul_(b2).add_(t.mul_(g))  # b2 v + ((1 - b2) g) g
        m.mul_(b1).add_(g.mul_(1 - b1))  # b1 m + (1 - b1) g
        upd = torch.div(m, bc1, out=g).div_(torch.div(v, bc2, out=t).sqrt_().add_(cfg.eps))
        pf = (master[k] if master is not None else p[k]).float()  # p itself when p is f32
        upd.add_(torch.mul(pf, cfg.weight_decay, out=t)).mul_(lr)
        pf.sub_(upd)  # p - lr (m̂ / (sqrt(v̂) + eps) + wd p)
        if pf is not p[k]:
            p[k].copy_(pf)
    new_state = {"m": state["m"], "v": state["v"], "step": step}
    if master is not None:
        new_state["master"] = master
    return params, new_state, {"grad_norm": gnorm, "lr": lr}
