"""Evaluation loop: held-out perplexity over the deterministic stream.

Ported from the reference's ``repro/train/evaluate.py``: the same seed (so
the same learnable mixture) at a step range far beyond anything training
reads, so the batches are unseen data from the same distribution.  Runs
without gradients, so every attention and SSD layer is one kernel launch.
"""

from __future__ import annotations

import math

import torch

from repro_torch.data.pipeline import DataConfig, SyntheticLMStream
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import ModelApi
from repro_torch.train.losses import next_token_loss


@torch.no_grad()
def evaluate(
    api: ModelApi,
    cfg: ModelConfig,
    params: torch.nn.Module,
    data_cfg: DataConfig,
    *,
    batches: int = 8,
    start_step: int = 1_000_000,
) -> dict:
    """``{"nll", "perplexity", "tokens"}`` over ``batches`` batches of the
    stream from ``start_step``, on the device of ``params``."""
    device = next(params.parameters()).device
    stream = SyntheticLMStream(data_cfg, step=start_step)
    prefix = cfg.num_patches if cfg.family == "vlm" else 0
    total_nll, total_tok = 0.0, 0.0
    for _ in range(batches):
        batch = {k: torch.from_numpy(v).to(device) for k, v in stream.next_batch().items()}
        logits, _ = api.module.forward(params, cfg, batch, remat=False)
        _, metrics = next_token_loss(logits, batch["tokens"], cfg, aux_loss=None, prefix_len=prefix)
        total_nll += float(metrics["nll"] * metrics["tokens"])
        total_tok += float(metrics["tokens"])
    nll = total_nll / max(total_tok, 1.0)
    return {"nll": nll, "perplexity": math.exp(min(nll, 50.0)), "tokens": total_tok}
