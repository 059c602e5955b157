"""KV-cache utilities: sizing and slot surgery for continuous batching.

Ported from the reference's ``repro/serve/kvcache.py``; ``kv_cache_bytes``
is re-exported from ``core/autoshard.py``, its one owner, as the reference
does.  The reference's int8
block-quantized storage (``quantize_kv`` / ``dequantize_kv``) is not on the
serving path and is not ported yet.
"""

from __future__ import annotations

from collections.abc import Mapping, Sequence

import torch

from repro_torch.core.autoshard import kv_cache_bytes  # re-export  # noqa: F401
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


def cache_bytes_report(cfg: ModelConfig, batch: int, seq: int) -> dict:
    """Sizing for capacity planning."""
    bf16 = kv_cache_bytes(cfg, batch, seq)
    return {
        "bf16_bytes": bf16,
        "int8_bytes": bf16 / 2 * (1 + 4 / (2 * cfg.resolved_head_dim)),
        "per_chip_bf16_256": bf16 / 256,
    }
