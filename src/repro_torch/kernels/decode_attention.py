"""Decode attention — one query token per sequence against its KV cache.

Two versions of one function, ``(q [B, H, D], k_cache, v_cache [B, Hkv, S,
D], lengths [B] int32) -> o [B, H, D]`` in q's dtype: head ``h`` reads kv
head ``h // (H // Hkv)``, key ``c`` is visible when ``c < lengths[b]``, the
logits are scaled (``D**-0.5`` unless the caller gives a scale) and
softcapped where asked, and the softmax state is f32:

* :func:`decode_attention_ref` — the plain PyTorch version.  Its numerics
  follow the TPU kernel ``repro/kernels/decode_attention.py::_decode_kernel``,
  which keeps the probabilities in f32 for the product with v, not the
  reference's jnp oracle, which rounds them to the cache dtype first;
* :func:`decode_attention_cuda` — the wrapper of the hand-written Hopper
  kernel ``csrc/decode_attention.cu``.  It is the one place that chooses an
  implementation, by the tensors' device alone: on CPU tensors it runs the
  plain version, on CUDA tensors it launches the kernel or raises.
  ``decode_attention_cuda.launches`` counts its calls that launch: one per
  call, though each launches two device kernels (the split-KV pass and its
  combine).  On meta tensors it is a shape function (the checks, the
  card's shape limits, the output and the f32 scratch of an H100's split
  plan, which the dry-run's peak holds; no launch).  Every call is one
  :func:`~repro_torch.kernels.work.kernel_call` of
  :func:`~repro_torch.kernels.work.decode_attention_work`.

The state variant, :func:`decode_attention_state_cuda` beside its plain
version :func:`decode_attention_state_ref`, also returns each row's softmax
state ``lse = m + log l`` ``[B, H]`` f32, the log of the softmax's
denominator over the row's visible keys (:data:`_NEG` and an output of 0
for a row with none): where a cache's keys are split over devices, each
device attends to its own and the devices' outputs are combined by it
(``distributed/program.py::decode_combine``).  It launches the same two
device kernels, whose combine also writes the state, and counts its own
launches (``decode_attention_state_cuda.launches``).

:func:`decode_split_plan` is how the wrapper spreads the keys over blocks;
it reads only shapes and the SM count, never the lengths on the device.
Keys are unordered, so a ring-buffered window cache needs only its length.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, work
from repro_torch.kernels.flash_attention import (
    _NEG,
    MAX_HEAD_DIM,
    check_alignment,
    check_attention_args,
    kernel_takes_head_dim,
    softmax_scale,
)

_MAX_GRID_YZ = 65535
SPLIT_RANGE = 64  # keys per split are a multiple of this
BLOCKS_PER_SM = 2  # the split pass aims at this many blocks per SM
PLANNED_SM_COUNT = 132  # an H100 SXM's SMs: the card whose scratch a call on meta plans


def decode_split_plan(Hkv: int, S: int, sm_count: int) -> tuple[int, int]:
    """``(splits, chunk)``: the split-KV kernel's grid is ``(splits, Hkv,
    B)``, and split ``i`` of a sequence walks keys ``[i * chunk, (i + 1) *
    chunk)`` cut at its length.  ``chunk`` is a multiple of
    :data:`SPLIT_RANGE`, one sequence has about ``BLOCKS_PER_SM *
    sm_count`` blocks where ``S`` allows, and the ranges cover ``[0, S)``
    exactly once (one empty range when ``S == 0``).  Depends on shapes
    only: the lengths stay on the device.  The plan does not read the batch:
    a row's splits, and so the order of its sums, are the same in a batch of
    any size, so a sequence decodes to the same bits alone and beside
    others."""
    ranges = max(1, -(-S // SPLIT_RANGE))
    want = max(1, -(-BLOCKS_PER_SM * sm_count // max(1, Hkv)))
    chunk = -(-ranges // min(ranges, want)) * SPLIT_RANGE
    return max(1, -(-S // chunk)), chunk


def check_decode_launch(B: int, Hkv: int, D: int) -> None:
    """Raise on what the split-KV kernel does not take: a head width that is
    not a multiple of 8 from 8 to 256, and a batch or kv-head count beyond
    the grid's y and z limits."""
    if not kernel_takes_head_dim(D):
        raise ValueError(f"the decode kernel takes head widths that are multiples of 8 from 8 "
                         f"to {MAX_HEAD_DIM}, not {D}")
    if B > _MAX_GRID_YZ or Hkv > _MAX_GRID_YZ:
        raise ValueError(f"batch {B} or kv heads {Hkv} exceed the kernel grid's {_MAX_GRID_YZ}")


@functools.lru_cache(maxsize=256)
def _launch_plan(B: int, H: int, Hkv: int, S: int, D: int, bf16: bool, device: int) -> tuple[int, int]:
    """The split plan of one shape on one card, after the checks that need
    the built library (the block's shared memory); kept per shape, so a
    decode step does these once and not per layer."""
    check_decode_launch(B, Hkv, D)
    lib = _library()
    smem = lib.decode_attention_smem(H // Hkv, D, int(bf16))
    max_smem = lib.decode_attention_max_smem()
    if max_smem < 0:
        _build.check(lib, int(-max_smem), "decode_attention shared-memory query")
    if smem > max_smem:
        raise ValueError(f"group {H // Hkv} x head width {D} needs {smem} B of shared memory "
                         f"per block (> {max_smem})")
    sm_count = torch.cuda.get_device_properties(device).multi_processor_count
    return decode_split_plan(Hkv, S, sm_count)


def _decode_ref(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor, lengths: torch.Tensor, *,
                softcap: float | None, scale: float | None) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version's output and softmax state (see the callers)."""
    B, H, D = q.shape
    Hkv, S = k_cache.shape[1], k_cache.shape[2]
    if S == 0:
        return torch.zeros_like(q), torch.full((B, H), _NEG, dtype=torch.float32, device=q.device)
    group = H // Hkv
    qg = (q.float() * softmax_scale(D, scale)).reshape(B, Hkv, group, D)
    s = torch.einsum("bhgd,bhkd->bhgk", qg, k_cache.float())
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    valid = torch.arange(S, device=q.device)[None, :] < lengths.to(q.device, torch.long)[:, None]
    valid = valid[:, None, None, :]  # [B, 1, 1, S]
    s = torch.where(valid, s, _NEG)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    lse = torch.where(l > 0.0, m + torch.log(l), _NEG).reshape(B, H)
    l = torch.where(l == 0.0, 1.0, l)
    o = torch.einsum("bhgk,bhkd->bhgd", p, v_cache.float()) / l
    return o.reshape(B, H, D).to(q.dtype), lse


def decode_attention_ref(
    q: torch.Tensor,  # [B, H, D]
    k_cache: torch.Tensor,  # [B, Hkv, S, D]
    v_cache: torch.Tensor,  # [B, Hkv, S, D]
    lengths: torch.Tensor,  # [B] int32
    *,
    softcap: float | None = None,
    scale: float | None = None,
) -> torch.Tensor:
    """Plain PyTorch decode attention with the kernel's arithmetic: f32
    logits of the query scaled by ``scale`` (``D**-0.5`` when None),
    softcap, masked max, ``p = exp(s - m)`` on the valid prefix only,
    ``(p v) / l`` with p in f32."""
    return _decode_ref(q, k_cache, v_cache, lengths, softcap=softcap, scale=scale)[0]


def decode_attention_state_ref(
    q: torch.Tensor,  # [B, H, D]
    k_cache: torch.Tensor,  # [B, Hkv, S, D]
    v_cache: torch.Tensor,  # [B, Hkv, S, D]
    lengths: torch.Tensor,  # [B] int32
    *,
    softcap: float | None = None,
    scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`decode_attention_ref` and each row's softmax state ``m + log
    l`` ``[B, H]`` f32 (:data:`_NEG` for a row with no visible key)."""
    return _decode_ref(q, k_cache, v_cache, lengths, softcap=softcap, scale=scale)


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library, its C signatures declared."""
    lib = _build.load("decode_attention")
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.decode_attention.argtypes = [ptr] * 6 + [i32] * 8 + [f32, f32, ptr]
    lib.decode_attention.restype = i32
    lib.decode_attention_state.argtypes = [ptr] * 7 + [i32] * 8 + [f32, f32, ptr]
    lib.decode_attention_state.restype = i32
    lib.decode_attention_smem.argtypes = [i32, i32, i32]
    lib.decode_attention_smem.restype = ctypes.c_longlong
    lib.decode_attention_max_smem.argtypes = []
    lib.decode_attention_max_smem.restype = ctypes.c_longlong
    return lib


def _check_decode_args(q, k_cache, v_cache, lengths, softcap) -> None:
    check_attention_args(q, k_cache, v_cache, q_dims=3, window=None, softcap=softcap)
    B = q.shape[0]
    if (lengths.device != q.device or lengths.dtype != torch.int32
            or tuple(lengths.shape) != (B,) or not lengths.is_contiguous()):
        raise ValueError(
            f"lengths: need contiguous int32 [{B}] on {q.device}, got {lengths.dtype} "
            f"{tuple(lengths.shape)} on {lengths.device}"
        )


def decode_attention_cuda(
    q: torch.Tensor,  # [B, H, D]
    k_cache: torch.Tensor,  # [B, Hkv, S, D]
    v_cache: torch.Tensor,  # [B, Hkv, S, D]
    lengths: torch.Tensor,  # [B] int32
    *,
    softcap: float | None = None,
    scale: float | None = None,
) -> torch.Tensor:
    """The CUDA kernel ``csrc/decode_attention.cu`` on PyTorch's current
    stream, or, for tensors on the CPU, :func:`decode_attention_ref`.  The
    logits are scaled by ``scale``, ``D**-0.5`` when it is None.

    Takes contiguous float32 or bfloat16 tensors of one dtype and contiguous
    int32 lengths, all on one device, on the CPU as on the card, and raises
    on anything else; on the card also on head widths the kernel does not
    take (:func:`check_decode_launch`), on a GQA group whose tiles exceed the card's
    shared memory and on grids beyond the launch limits.  The partial
    softmax states of the splits go to f32 scratch allocated here."""
    _check_decode_args(q, k_cache, v_cache, lengths, softcap)
    with work.kernel_call(lambda: work.decode_attention_work(q, k_cache, lengths)):
        if q.device.type == "cpu":
            return decode_attention_ref(q, k_cache, v_cache, lengths, softcap=softcap, scale=scale)
        if q.device.type == "meta":
            return _on_meta(q, k_cache, state=False)[0]
        return _on_card(q, k_cache, v_cache, lengths, softcap=softcap, scale=scale, state=False)[0]


def decode_attention_state_cuda(
    q: torch.Tensor,  # [B, H, D]
    k_cache: torch.Tensor,  # [B, Hkv, S, D]
    v_cache: torch.Tensor,  # [B, Hkv, S, D]
    lengths: torch.Tensor,  # [B] int32
    *,
    softcap: float | None = None,
    scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`decode_attention_cuda` and each row's softmax state ``lse``
    ``[B, H]`` f32 (module docstring): the kernel on the card (the same two
    device kernels, the combine writing the state too), the plain version
    :func:`decode_attention_state_ref` on the CPU, a shape function on meta,
    with the same checks.  One :func:`~repro_torch.kernels.work.kernel_call`
    a call, whose bytes count the state's write."""
    _check_decode_args(q, k_cache, v_cache, lengths, softcap)
    with work.kernel_call(lambda: work.decode_attention_work(q, k_cache, lengths, state=True)):
        if q.device.type == "cpu":
            return decode_attention_state_ref(q, k_cache, v_cache, lengths, softcap=softcap, scale=scale)
        if q.device.type == "meta":
            return _on_meta(q, k_cache, state=True)
        return _on_card(q, k_cache, v_cache, lengths, softcap=softcap, scale=scale, state=True)


def _scratch(q: torch.Tensor, splits: int) -> torch.Tensor:
    """The splits' partial outputs and softmax states, f32 ``[B, H, splits,
    D + 2]`` flat: allocated by each call and freed when it returns."""
    B, H, D = q.shape
    return torch.empty(B * H * splits * (D + 2), dtype=torch.float32, device=q.device)


def _on_meta(q: torch.Tensor, k_cache: torch.Tensor, *, state: bool) -> tuple[torch.Tensor, torch.Tensor | None]:
    """A call on meta tensors: the card's checks that need no library, the
    outputs and, live while the call runs as on the card, the scratch of
    the plan on :data:`PLANNED_SM_COUNT` SMs."""
    B, H, D = q.shape
    Hkv, S = k_cache.shape[1], k_cache.shape[2]
    check_decode_launch(B, Hkv, D)
    o = torch.empty_like(q)
    lse = q.new_empty((B, H), dtype=torch.float32) if state else None
    if o.numel():
        _scratch(q, decode_split_plan(Hkv, S, PLANNED_SM_COUNT)[0])
    return o, lse


def _on_card(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor, lengths: torch.Tensor, *,
             softcap: float | None, scale: float | None, state: bool) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Plan and launch one decode call on the card of ``q``; with ``state``
    the rows' softmax states too."""
    B, H, D = q.shape
    Hkv, S = k_cache.shape[1], k_cache.shape[2]
    with torch.cuda.device(q.device):  # the library queries the current card
        splits, chunk = _launch_plan(B, H, Hkv, S, D, q.dtype == torch.bfloat16, q.device.index)
    check_alignment(q, k_cache, v_cache)
    o = torch.empty_like(q)
    lse = torch.empty(B, H, dtype=torch.float32, device=q.device) if state else None
    if o.numel() == 0:
        return o, lse
    scratch = _scratch(q, splits)
    lib = _library()
    args = (B, H, Hkv, S, D, splits, chunk, int(q.dtype == torch.bfloat16), 0.0 if softcap is None else softcap,
            softmax_scale(D, scale), torch.cuda.current_stream(q.device).cuda_stream)
    with torch.cuda.device(q.device):  # the library launches on the current card
        if state:
            err = lib.decode_attention_state(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                                             lengths.data_ptr(), o.data_ptr(), lse.data_ptr(), scratch.data_ptr(),
                                             *args)
        else:
            err = lib.decode_attention(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), lengths.data_ptr(),
                                       o.data_ptr(), scratch.data_ptr(), *args)
    _build.check(lib, err, "decode_attention launch")
    if state:
        decode_attention_state_cuda.launches += 1
    else:
        decode_attention_cuda.launches += 1
    return o, lse


decode_attention_cuda.launches = 0
decode_attention_state_cuda.launches = 0
