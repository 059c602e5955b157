"""Mamba2 (SSD) block: prefill forward through the SSD scan kernel and the
one-token decode step.

Ported from the reference's ``repro/models/mamba.py``.  Block structure:
in_proj -> split ``[z | x | B | C | dt]`` -> causal depthwise conv over
``(x, B, C)`` -> silu -> SSD scan (:func:`~repro_torch.kernels.ssd_scan.ssd_scan_cuda`)
-> a learned ``D`` skip -> RMSNorm of ``y * silu(z)`` -> out_proj.  The
parameters carry the reference's keys; ``A_log``, ``dt_bias`` and ``D`` are
f32 whatever the model's dtype, as in the reference.

Decode keeps two recurrent states per layer, the SSM state ``[B, H, P, N]``
(f32) and the conv window ``[B, conv - 1, C]`` of the last inputs; its
recurrence is plain PyTorch, as the reference computes it outside any
kernel.  The weights and the block's input and output pass through
``distributed/program.py`` (each returns its input unless a sharded program
is installed).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed import program as D
from repro_torch.kernels.ssd_scan import ssd_scan_cuda
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig


def dims(cfg: ModelConfig) -> tuple[int, int, int, int, int]:
    """(d_inner, state N, groups G, heads H, conv channels C = d_inner + 2 G N)."""
    di, n, g, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_groups, cfg.ssm_heads
    return di, n, g, h, di + 2 * g * n


class Mamba2(nn.Module):
    def __init__(self, cfg: ModelConfig, *, dtype: torch.dtype, device: torch.device | str):
        super().__init__()
        di, n, g, h, c = dims(cfg)
        kw = dict(dtype=dtype, device=device)
        f32 = dict(dtype=torch.float32, device=device)
        self.in_proj = L.Linear(cfg.d_model, 2 * di + 2 * g * n + h, bias=False, **kw)  # z x B C dt
        self.conv_w = L.param(torch.empty(cfg.ssm_conv, c, **kw))
        self.conv_b = L.param(torch.empty(c, **kw))
        self.A_log = L.param(torch.empty(h, **f32))  # A = -exp(A_log) < 0
        self.dt_bias = L.param(torch.empty(h, **f32))
        self.D = L.param(torch.empty(h, **f32))
        self.norm = L.RMSNorm(di, **kw)
        self.out_proj = L.Linear(di, cfg.d_model, bias=False, **kw)

    def init_(self, generator: torch.Generator) -> None:
        """The reference's scales: conv_w a truncated normal at 0.1, conv_b
        0, A_log 0 (A = -1), dt_bias -2 (softplus(-2) = 0.13), D 1."""
        self.conv_w.copy_(L.truncated_normal(tuple(self.conv_w.shape), 0.1, self.conv_w.dtype,
                                             generator, self.conv_w.device))
        self.conv_b.zero_()
        self.A_log.zero_()
        self.dt_bias.fill_(-2.0)
        self.D.fill_(1.0)


def _split(cfg: ModelConfig, proj: torch.Tensor):
    """in_proj's output -> (z, xbc = [x | B | C], dt_raw)."""
    di, n, g, h, c = dims(cfg)
    return proj.split([di, c, h], dim=-1)


def _split_xbc(cfg: ModelConfig, xbc: torch.Tensor):
    di, n, g, _, _ = dims(cfg)
    return xbc.split([di, g * n, g * n], dim=-1)


def _gated_out(p: Mamba2, y: torch.Tensor, x: torch.Tensor, z: torch.Tensor,
               cfg: ModelConfig) -> torch.Tensor:
    """D skip, RMSNorm of ``y * silu(z)``, out_proj; ``y``, ``x`` [..., H, P]."""
    y = y + x * D.weight(p.D)[:, None].to(x.dtype)
    y = y.reshape(*y.shape[:-2], cfg.d_inner)
    return D.exit(L.linear(p.out_proj, L.rmsnorm(p.norm, y * F.silu(z), cfg.norm_eps)), p)


def mamba_mixer(p: Mamba2, u: torch.Tensor, cfg: ModelConfig):
    """u [B, S, d] -> (out [B, S, d], final SSM state [B, H, P, N] f32, the
    conv inputs ``xbc_raw`` [B, S, C]), the SSD scan through its kernel's
    wrapper."""
    u = D.enter(u, p)
    Bsz, S, _ = u.shape
    di, n, g, h, c = dims(cfg)
    z, xbc_raw, dt_raw = _split(cfg, L.linear(p.in_proj, u))
    # causal depthwise conv: the reference's shifted sum of products, in its
    # order (not F.conv1d, which rounds otherwise in bf16)
    xp = F.pad(xbc_raw, (0, 0, cfg.ssm_conv - 1, 0))
    conv_w = D.weight(p.conv_w)
    conv = sum(xp[:, i: i + S] * conv_w[i] for i in range(cfg.ssm_conv))
    x, Bm, Cm = _split_xbc(cfg, F.silu(conv + D.weight(p.conv_b)))
    x = x.reshape(Bsz, S, h, cfg.ssm_headdim).contiguous()
    Bm = Bm.reshape(Bsz, S, g, n).contiguous()
    Cm = Cm.reshape(Bsz, S, g, n).contiguous()
    dt = F.softplus(dt_raw.float() + D.weight(p.dt_bias))  # [B, S, H] f32
    A = -torch.exp(D.weight(p.A_log))
    y, state = ssd_scan_cuda(x, dt, A, Bm, Cm, chunk=cfg.ssm_chunk)
    return _gated_out(p, y, x, z, cfg), state, xbc_raw


def mamba_forward(p: Mamba2, u: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """u [B, S, d] -> [B, S, d] (the prefill path)."""
    return mamba_mixer(p, u, cfg)[0]


def mamba_cache_init(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                     device: torch.device | str = "cuda") -> dict:
    di, n, g, h, c = dims(cfg)
    return {
        "ssm": torch.zeros(batch, h, cfg.ssm_headdim, n, dtype=torch.float32, device=device),
        "conv": torch.zeros(batch, cfg.ssm_conv - 1, c, dtype=dtype, device=device),
    }


def mamba_decode(p: Mamba2, u: torch.Tensor, cfg: ModelConfig,
                 cache: dict) -> tuple[torch.Tensor, dict]:
    """u [B, 1, d], one token per sequence -> (y [B, 1, d], the new
    ``{"ssm", "conv"}`` states).  The states are new tensors, as the
    reference's."""
    u = D.enter(u, p)
    Bsz = u.shape[0]
    di, n, g, h, c = dims(cfg)
    z, xbc, dt_raw = _split(cfg, L.linear(p.in_proj, u[:, 0]))
    window = torch.cat([cache["conv"], xbc[:, None, :]], dim=1)  # [B, conv, C]
    xbc = F.silu(torch.einsum("bkc,kc->bc", window, D.weight(p.conv_w)) + D.weight(p.conv_b))
    x, Bm, Cm = _split_xbc(cfg, xbc)
    x = x.reshape(Bsz, h, cfg.ssm_headdim)
    Bm = Bm.reshape(Bsz, g, n).repeat_interleave(h // g, dim=1).float()  # [B, H, N]
    Cm = Cm.reshape(Bsz, g, n).repeat_interleave(h // g, dim=1).float()
    dt = F.softplus(dt_raw.float() + D.weight(p.dt_bias))  # [B, H]
    dA = torch.exp(dt * -torch.exp(D.weight(p.A_log)))
    state = cache["ssm"] * dA[..., None, None] + (
        dt[..., None, None] * x.float()[..., None] * Bm[..., None, :]
    )
    y = torch.einsum("bhpn,bhn->bhp", state, Cm).to(u.dtype)
    out = _gated_out(p, y, x, z, cfg)[:, None, :]
    return out, {"ssm": state, "conv": window[:, 1:]}
