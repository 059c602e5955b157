"""KV-cache utilities: sizing and slot surgery for continuous batching.

Ported from the reference's ``repro/serve/kvcache.py``, with its own copy of
``kv_cache_bytes`` (``repro/core/autoshard.py``).  The reference's int8
block-quantized storage (``quantize_kv`` / ``dequantize_kv``) is not on the
serving path and is not ported yet.
"""

from __future__ import annotations

from collections.abc import Mapping, Sequence

import torch

from repro_torch.models.config import ModelConfig


def merge_slot(big_cache, small_cache, slot: int, max_slots: int):
    """Graft a batch-1 prefill cache into slot ``slot`` of an engine cache,
    in place, and return the engine cache.

    Handles stacked-layer leaves ([L, B, ...], batch on axis 1) and flat
    leaves ([B, ...]); anything else (the position) is left to the caller."""
    if isinstance(big_cache, Mapping):
        for key in big_cache:
            merge_slot(big_cache[key], small_cache[key], slot, max_slots)
    elif isinstance(big_cache, Sequence):
        for big, small in zip(big_cache, small_cache):
            merge_slot(big, small, slot, max_slots)
    elif isinstance(big_cache, torch.Tensor):
        big, small = big_cache, small_cache
        if big.dim() >= 2 and big.dim() == small.dim() and big.shape[1] == max_slots \
                and small.shape[1] == 1:
            big[:, slot].copy_(small[:, 0])
        elif big.dim() >= 1 and big.shape[0] == max_slots and small.shape[0] == 1:
            big[slot].copy_(small[0])
    return big_cache


def kv_cache_bytes(cfg: ModelConfig, batch: int, seq: int) -> float:
    """Bytes of a bf16 KV cache (f32 SSM state) for ``batch`` sequences of
    ``seq`` positions, window slots capped at the window."""
    hd = cfg.resolved_head_dim
    if cfg.family == "ssm":
        return cfg.num_layers * batch * cfg.ssm_heads * cfg.ssm_headdim * cfg.ssm_state * 4
    if cfg.family == "hybrid":
        ssm = cfg.num_layers * batch * cfg.ssm_heads * cfg.ssm_headdim * cfg.ssm_state * 4
        n_inv = sum(1 for i in range(cfg.num_layers) if (i + 1) % cfg.hybrid_period == 0)
        return ssm + n_inv * batch * cfg.num_kv_heads * seq * hd * 2 * 2
    if cfg.num_kv_heads == 0:
        return 0.0
    total = 0.0
    for i in range(cfg.num_layers):
        w = cfg.window if (cfg.window and (not cfg.local_global or i % 2 == 0)) else None
        s_eff = min(w, seq) if w else seq
        total += batch * cfg.num_kv_heads * s_eff * hd * 2 * 2
    if cfg.family == "encdec":
        total += cfg.num_layers * batch * cfg.num_kv_heads * cfg.enc_frames * hd * 2 * 2
    return total


def cache_bytes_report(cfg: ModelConfig, batch: int, seq: int) -> dict:
    """Sizing for capacity planning."""
    bf16 = kv_cache_bytes(cfg, batch, seq)
    return {
        "bf16_bytes": bf16,
        "int8_bytes": bf16 / 2 * (1 + 4 / (2 * cfg.resolved_head_dim)),
        "per_chip_bf16_256": bf16 / 256,
    }
