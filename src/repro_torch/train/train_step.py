"""Train-step factory: loss -> gradients -> AdamW update, with per-block
remat and microbatch gradient accumulation.

Ported from the reference's ``repro/train/train_step.py``.  The reference's
``jax.value_and_grad`` is PyTorch's autograd here; its ``lax.scan`` over
microbatches a Python loop.  The parameters are an ``nn.Module`` whose
gradients the step turns on (:func:`~repro_torch.models.layers.trainable`)
and which the update writes in place; gradients and moments are keyed by
parameter name.

On the card the forward of every attention and SSD layer is the
hand-written kernel and its backward PyTorch's autodiff of the plain
version (``FlashAttentionFn``, ``SSDScanFn``); with ``remat`` each layer
group's forward, kernel launches included, runs again in the backward.
"""

from __future__ import annotations

from collections.abc import Callable

import torch

from repro_torch.distributed import program as D
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import ModelApi
from repro_torch.optim import adamw
from repro_torch.train.losses import next_token_loss


def make_loss_fn(api: ModelApi, cfg: ModelConfig, *, remat: bool = True) -> Callable:
    """``loss_fn(params, batch) -> (loss, metrics)``: the model's forward and
    :func:`next_token_loss` (with the batch's ``mask``, the MoE aux loss and
    the vlm's patch prefix)."""

    def loss_fn(params, batch):
        logits, aux = api.module.forward(params, cfg, batch, remat=remat)
        prefix = cfg.num_patches if cfg.family == "vlm" else 0
        return next_token_loss(logits, batch["tokens"], cfg, mask=batch.get("mask"),
                               aux_loss=aux.get("aux_loss"), prefix_len=prefix)

    return loss_fn


def make_grad_fn(api: ModelApi, cfg: ModelConfig, *, remat: bool = True,
                 microbatches: int = 1) -> Callable:
    """``grad_fn(params, batch) -> (grads {name: tensor}, metrics)``, the
    first half of a train step.  With ``microbatches > 1`` the batch is split
    on axis 0 and the gradients are summed in f32 and divided by the count;
    the metrics are then ``{"loss"}``, the mean loss.  A parameter the loss
    does not reach gets a zero gradient, as under ``jax.grad``."""
    loss_fn = make_loss_fn(api, cfg, remat=remat)

    def grads_of(params, batch) -> tuple[dict, torch.Tensor, dict]:
        named = dict(L.trainable(params).named_parameters())
        loss, metrics = loss_fn(params, batch)
        grads = torch.autograd.grad(loss, list(named.values()), allow_unused=True)
        grads = {k: torch.zeros_like(p) if g is None else g for (k, p), g in zip(named.items(), grads)}
        return grads, metrics["loss"].detach(), {k: v.detach() for k, v in metrics.items()}

    def grad_fn(params, batch):
        if microbatches == 1:
            grads, _, metrics = grads_of(params, batch)
            return grads, metrics
        for k, x in batch.items():
            if x.shape[0] % microbatches:
                raise ValueError(f"batch {k!r} of {x.shape[0]} rows does not split into {microbatches} microbatches")
        micro = {k: x.chunk(microbatches) for k, x in batch.items()}
        acc, loss_sum = None, None
        for i in range(microbatches):
            grads, loss, _ = grads_of(params, {k: v[i] for k, v in micro.items()})
            if acc is None:
                acc = {k: torch.zeros(g.shape, dtype=torch.float32, device=g.device) for k, g in grads.items()}
                loss_sum = torch.zeros((), device=loss.device)
            for k, g in grads.items():
                acc[k].add_(g.float())
            loss_sum = loss_sum + loss
        count = torch.tensor(float(microbatches), device=loss_sum.device)
        return {k: a / count for k, a in acc.items()}, {"loss": loss_sum / count}

    return grad_fn


def make_train_step(
    api: ModelApi,
    cfg: ModelConfig,
    opt_cfg: adamw.AdamWConfig,
    *,
    remat: bool = True,
    microbatches: int = 1,
    grad_compressor: Callable | None = None,
) -> Callable:
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: :func:`make_grad_fn`'s gradients, then ``grad_compressor``
    (a hook for the distributed path's gradient compression, on the
    ``{name: gradient}`` mapping) if given, then
    :func:`~repro_torch.optim.adamw.update`, which writes the parameters and
    moments in place.  Under a sharded program the gradients are all-reduced
    over the batch axes their parameters are replicated on
    (``distributed/program.py::data_parallel_grads``), after the
    compressor."""
    grad_fn = make_grad_fn(api, cfg, remat=remat, microbatches=microbatches)

    def train_step(params, opt_state, batch):
        grads, metrics = grad_fn(params, batch)
        if grad_compressor is not None:
            grads = grad_compressor(grads)
        grads = D.data_parallel_grads(grads, params)
        params, opt_state, opt_metrics = adamw.update(opt_cfg, grads, opt_state, params)
        return params, opt_state, {**metrics, **opt_metrics}

    return train_step
