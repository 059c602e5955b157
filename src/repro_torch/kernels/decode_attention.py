"""Decode attention — one query token per sequence against its KV cache.

Two versions of one function, ``(q [B, H, D], k_cache, v_cache [B, Hkv, S,
D], lengths [B] int32) -> o [B, H, D]`` in q's dtype: head ``h`` reads kv
head ``h // (H // Hkv)``, key ``c`` is visible when ``c < lengths[b]``, the
logits are softcapped where asked, and the softmax state is f32:

* :func:`decode_attention_ref` — the plain PyTorch version.  Its numerics
  follow the TPU kernel ``repro/kernels/decode_attention.py::_decode_kernel``,
  which keeps the probabilities in f32 for the product with v, not the
  reference's jnp oracle, which rounds them to the cache dtype first;
* :func:`decode_attention_cuda` — the wrapper of the hand-written Hopper
  kernel ``csrc/decode_attention.cu``.  It is the one place that chooses an
  implementation, by the tensors' device alone: on CPU tensors it runs the
  plain version, on CUDA tensors it launches the kernel or raises.
  ``decode_attention_cuda.launches`` counts its kernel launches.

Keys are unordered, so a ring-buffered window cache needs only its length.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import _NEG, check_alignment, check_attention_args

_MAX_GRID_Y = 65535


def decode_attention_ref(
    q: torch.Tensor,  # [B, H, D]
    k_cache: torch.Tensor,  # [B, Hkv, S, D]
    v_cache: torch.Tensor,  # [B, Hkv, S, D]
    lengths: torch.Tensor,  # [B] int32
    *,
    softcap: float | None = None,
) -> torch.Tensor:
    """Plain PyTorch decode attention with the kernel's arithmetic: f32
    logits of the query scaled by ``D**-0.5``, softcap, masked max, ``p = exp(s - m)`` on
    the valid prefix only, ``(p v) / l`` with p in f32."""
    B, H, D = q.shape
    Hkv, S = k_cache.shape[1], k_cache.shape[2]
    if S == 0:
        return torch.zeros_like(q)
    group = H // Hkv
    qg = (q.float() * D**-0.5).reshape(B, Hkv, group, D)
    s = torch.einsum("bhgd,bhkd->bhgk", qg, k_cache.float())
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    valid = torch.arange(S, device=q.device)[None, :] < lengths.to(q.device, torch.long)[:, None]
    valid = valid[:, None, None, :]  # [B, 1, 1, S]
    s = torch.where(valid, s, _NEG)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    l = torch.where(l == 0.0, 1.0, l)
    o = torch.einsum("bhgk,bhkd->bhgd", p, v_cache.float()) / l
    return o.reshape(B, H, D).to(q.dtype)


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library, its C signatures declared."""
    lib = _build.load("decode_attention")
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.decode_attention.argtypes = [ptr] * 5 + [i32] * 6 + [f32, ptr]
    lib.decode_attention.restype = i32
    lib.decode_attention_smem.argtypes = [i32, i32]
    lib.decode_attention_smem.restype = ctypes.c_longlong
    lib.decode_attention_max_smem.argtypes = []
    lib.decode_attention_max_smem.restype = ctypes.c_longlong
    return lib


def decode_attention_cuda(
    q: torch.Tensor,  # [B, H, D]
    k_cache: torch.Tensor,  # [B, Hkv, S, D]
    v_cache: torch.Tensor,  # [B, Hkv, S, D]
    lengths: torch.Tensor,  # [B] int32
    *,
    softcap: float | None = None,
) -> torch.Tensor:
    """The CUDA kernel ``csrc/decode_attention.cu`` on PyTorch's current
    stream, or, for tensors on the CPU, :func:`decode_attention_ref`.

    Takes contiguous float32 or bfloat16 tensors of one dtype and contiguous
    int32 lengths, all on one device, on the CPU as on the card, and raises
    on anything else; on the card also on a GQA group or head width whose
    tiles exceed the card's shared memory and on grids beyond the launch
    limits."""
    check_attention_args(q, k_cache, v_cache, q_dims=3, window=None, softcap=softcap)
    B, H, D = q.shape
    Hkv, S = k_cache.shape[1], k_cache.shape[2]
    if (lengths.device != q.device or lengths.dtype != torch.int32
            or tuple(lengths.shape) != (B,) or not lengths.is_contiguous()):
        raise ValueError(
            f"lengths: need contiguous int32 [{B}] on {q.device}, got {lengths.dtype} "
            f"{tuple(lengths.shape)} on {lengths.device}"
        )
    if q.device.type == "cpu":
        return decode_attention_ref(q, k_cache, v_cache, lengths, softcap=softcap)
    lib = _library()
    if B > _MAX_GRID_Y:
        raise ValueError(f"batch {B} exceeds the kernel grid's {_MAX_GRID_Y}")
    smem = lib.decode_attention_smem(H // Hkv, D)
    max_smem = lib.decode_attention_max_smem()
    if max_smem < 0:
        _build.check(lib, int(-max_smem), "decode_attention shared-memory query")
    if smem > max_smem:
        raise ValueError(f"group {H // Hkv} x head width {D} needs {smem} B of shared memory "
                         f"per block (> {max_smem})")
    check_alignment(q, k_cache, v_cache)
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    err = lib.decode_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), lengths.data_ptr(), o.data_ptr(),
        B, H, Hkv, S, D, int(q.dtype == torch.bfloat16),
        0.0 if softcap is None else softcap, torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(lib, err, "decode_attention launch")
    decode_attention_cuda.launches += 1
    return o


decode_attention_cuda.launches = 0
