"""Training losses: next-token cross-entropy with z-loss, target masking,
the vlm's prefix and the MoE load-balance term.

Ported from the reference's ``repro/train/losses.py``.  The logsumexp and
the target logit go through ``distributed/program.py``, for logits whose
vocabulary a sharded program splits over devices; under a batch split the
mean is over every device's targets (``program.batch_sum``), so the
gradients that the step sums over the batch axes are the global mean's.
"""

from __future__ import annotations

import torch

from repro_torch.distributed import program as D
from repro_torch.models.config import ModelConfig


def next_token_loss(
    logits: torch.Tensor,  # [B, S, V] f32
    tokens: torch.Tensor,  # [B, S] (inputs; targets = shift-left)
    cfg: ModelConfig,
    *,
    mask: torch.Tensor | None = None,  # [B, S]: 1 where the *target* counts
    aux_loss: torch.Tensor | None = None,
    prefix_len: int = 0,  # vlm: logits cover [prefix | text]; loss on text only
) -> tuple[torch.Tensor, dict]:
    """(loss, metrics {"nll", "tokens", "z_loss"?, "moe_aux"?, "loss"}): the
    mean over counted targets of ``logsumexp - target logit``, plus
    ``z_loss`` times the mean squared ``logsumexp`` and the aux loss."""
    if prefix_len:
        logits = logits[:, prefix_len:]
    S = tokens.shape[1]
    pred = logits[:, : S - 1]
    targets = tokens[:, 1:].long()
    m = (torch.ones(targets.shape, dtype=torch.float32, device=pred.device) if mask is None
         else mask[:, 1:].float())
    logz = D.logsumexp(pred)  # over the vocabulary, split or not
    tgt_logit = D.pick(pred, targets)
    nll = (logz - tgt_logit) * m
    (count,) = D.batch_sum(m.sum())  # every device's targets, under a batch split
    denom = torch.clamp(count, min=1.0)
    loss = nll.sum() / denom
    metrics = {"nll": loss, "tokens": denom}
    if cfg.z_loss:
        zl = cfg.z_loss * torch.sum(torch.square(logz) * m) / denom
        loss = loss + zl
        metrics["z_loss"] = zl
    if aux_loss is not None:
        loss = loss + aux_loss
        metrics["moe_aux"] = aux_loss
    metrics["loss"] = loss
    # ``loss`` is this device's share of the objective; the reported terms
    # are the sums of every device's shares (a MoE layer's aux term is the
    # whole batch's, of which each device's share is its ``1 / n``:
    # ``program.moe_aux_share``)
    summed = [k for k in ("nll", "z_loss", "moe_aux", "loss") if k in metrics]
    metrics.update(zip(summed, D.batch_sum(*(metrics[k] for k in summed))))
    return loss, metrics
