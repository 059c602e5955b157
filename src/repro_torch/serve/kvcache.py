"""KV-cache utilities: sizing, slot surgery for continuous batching, and
int8 block-quantized cache storage.

Ported from the reference's ``repro/serve/kvcache.py``; ``kv_cache_bytes``
is re-exported from ``core/autoshard.py``, its one owner, as the reference
does.  ``quantize_kv`` / ``dequantize_kv`` are plain PyTorch (the reference
has no Pallas kernel for them); both round half to even, as the reference
does, so the codes and scales equal its own bit for bit.
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


# -----------------------------------------------------------------------------
# int8 block-quantized KV storage
# -----------------------------------------------------------------------------


def quantize_kv(kv: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``[..., S, D]`` -> (int8 codes ``[..., S, D]``, f32 scales ``[..., S,
    1]``): one scale a position, its largest magnitude over 127 (1 where the
    row is zero), codes rounded half to even and clipped to +-127.  127
    divides as a tensor on the cache's device: CUDA turns a division by a
    host scalar into a product with its reciprocal, one ulp apart from the
    CPU's (and XLA's) division."""
    kf = kv.float()
    scale = kf.abs().amax(dim=-1, keepdim=True) / torch.tensor(127.0, device=kv.device)
    scale = torch.where(scale == 0, 1.0, scale)
    codes = torch.clamp(torch.round(kf / scale), -127, 127).to(torch.int8)
    return codes, scale


def dequantize_kv(codes: torch.Tensor, scale: torch.Tensor,
                  dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    return (codes.float() * scale).to(dtype)


def cache_bytes_report(cfg: ModelConfig, batch: int, seq: int) -> dict:
    """Sizing for capacity planning."""
    bf16 = kv_cache_bytes(cfg, batch, seq)
    return {
        "bf16_bytes": bf16,
        "int8_bytes": bf16 / 2 * (1 + 4 / (2 * cfg.resolved_head_dim)),
        "per_chip_bf16_256": bf16 / 256,
    }
