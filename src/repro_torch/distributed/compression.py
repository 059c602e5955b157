"""Gradient compression for the inter-pod reduction: a block-scaled int8
codec with error feedback.

Ported from the reference's ``repro/distributed/compression.py``, in plain
PyTorch.  Pod-level data parallelism pays one gradient all-reduce over the
data-centre network a step; int8 codes with one f32 scale a block of 256
cut those bytes 4x against f32, and the error feedback (the residual carried
to the next step) keeps the accumulated signal exact.

* :func:`quantize` / :func:`dequantize`: the codec;
* :func:`compress_roundtrip`: the compressed-then-restored tensor and its
  error;
* :func:`make_grad_compressor`: the ``grad_compressor`` hook of
  ``train/train_step.py::make_train_step`` (each gradient through the
  round trip, so the reduction that follows sees the compressed values);
* :class:`ErrorFeedbackState`: the same with the residual carried across
  steps.

The reference compresses each leaf of its gradient pytree, where a model's
layers are stacked on a leading axis, so a block of 256 may span layers.
The port's gradients are keyed by parameter name, a layer each; the hooks
compress the layers of one reference leaf (:func:`stacked_leaves`) as one
flat tensor in layer order, so that the blocks, their scales and their
codes are the reference's.

:func:`compressed_psum_pod` is the reference's collective over the pod axis
(quantize, take the largest scale, requantize, sum the codes in f32,
dequantize), over a backend's exchanges (``distributed/comm.py::DistComm``).
"""

from __future__ import annotations

import re
from collections.abc import Mapping

import torch
import torch.nn.functional as F

BLOCK = 256


def _pad_to_block(x: torch.Tensor) -> tuple[torch.Tensor, int]:
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % BLOCK
    if pad:
        flat = F.pad(flat, (0, pad))
    return flat, pad


def quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, int]:
    """x (any shape, float) -> (int8 codes ``[Nb, BLOCK]``, f32 scales
    ``[Nb]``, pad): each block's scale is its largest magnitude over 127 (1
    for a block of zeros), its codes the rounded quotients (half to even)."""
    flat, pad = _pad_to_block(x.float())
    blocks = flat.reshape(-1, BLOCK)
    # a device tensor as divisor: the card divides a tensor by a host scalar
    # as a product with its reciprocal, one ulp off the CPU's quotient
    scale = blocks.abs().amax(dim=1) / torch.tensor(127.0, device=blocks.device)
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    codes = torch.clamp(torch.round(blocks / scale[:, None]), -127, 127).to(torch.int8)
    return codes, scale, pad


def dequantize(codes: torch.Tensor, scale: torch.Tensor, pad: int, shape, dtype: torch.dtype) -> torch.Tensor:
    flat = (codes.float() * scale[:, None]).reshape(-1)
    if pad:
        flat = flat[:-pad]
    return flat.reshape(shape).to(dtype)


def compress_roundtrip(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(x compressed and restored, in x's dtype; the quantization error in
    f32)."""
    codes, scale, pad = quantize(x)
    xr = dequantize(codes, scale, pad, x.shape, x.dtype)
    return xr, x.float() - xr.float()


def stacked_leaves(names) -> list[list[str]]:
    """The port's parameter names grouped as the reference's stacked leaves:
    the names that differ only in their last numeric part (the layer: a
    transformer's group, an ssm model's layer), in layer order."""
    groups: dict[str, list[tuple[int, str]]] = {}
    for name in names:
        nums = [m for m in re.finditer(r"(?<=\.)\d+(?=\.)", name)]
        if nums:
            m = nums[-1]
            key, layer = name[:m.start()] + "*" + name[m.end():], int(m.group())
        else:
            key, layer = name, 0
        groups.setdefault(key, []).append((layer, name))
    return [[n for _, n in sorted(group)] for group in groups.values()]


def _roundtrip_leaves(grads: Mapping[str, torch.Tensor]) -> tuple[dict, dict]:
    """(compressed, error) of every gradient, a stacked leaf at a time."""
    out, err = {}, {}
    for group in stacked_leaves(grads):
        flat = torch.cat([grads[k].reshape(-1) for k in group])
        xr, e = compress_roundtrip(flat)
        start = 0
        for k in group:
            n = grads[k].numel()
            out[k] = xr[start:start + n].view(grads[k].shape)
            err[k] = e[start:start + n].view(grads[k].shape)
            start += n
    return out, err


def make_grad_compressor(error_feedback: bool = True):
    """The ``grad_compressor`` hook of ``make_train_step``: ``{name:
    gradient}`` -> each through :func:`compress_roundtrip`, a stacked leaf
    at a time.  Stateless, as the reference's; :class:`ErrorFeedbackState`
    carries the residual."""

    def compress(grads: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        return _roundtrip_leaves(grads)[0]

    return compress


class ErrorFeedbackState:
    """Carries each gradient's quantization residual to the next step (the
    trainer loop's wrapper; a ``grad_compressor`` hook)."""

    def __init__(self):
        self.residual: dict[str, torch.Tensor] | None = None

    def __call__(self, grads: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        if self.residual is not None:
            grads = {k: g + self.residual[k].to(g.dtype) for k, g in grads.items()}
        out, self.residual = _roundtrip_leaves(grads)
        return out


def compressed_psum_pod(x: torch.Tensor, comm, axis_name: str = "pod") -> torch.Tensor:
    """``x`` summed over the devices of ``axis_name`` through int8 codes:
    each device quantizes its ``x``, the scales' maximum is taken over the
    axis, each device requantizes its codes against it, the codes are summed
    in f32 (integer values, so the sum is exact in any order) and
    dequantized with the common scale.  ``comm``: the backend whose
    ``all_reduce`` takes ``op="max"``.  The bytes on the data-centre network
    are a code a value and a scale a block, against 4 a value in f32."""
    codes, scale, pad = quantize(x)
    gscale = comm.all_reduce(scale, (axis_name,), op="max")
    rescaled = torch.round(codes.float() * (scale / gscale)[:, None])
    summed = comm.all_reduce(rescaled, (axis_name,))
    flat = (summed * gscale[:, None]).reshape(-1)
    if pad:
        flat = flat[:-pad]
    return flat.reshape(x.shape).to(x.dtype)
