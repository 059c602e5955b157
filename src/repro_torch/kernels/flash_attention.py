"""Flash attention for prefill — blockwise online-softmax attention.

Two versions of one function, ``(q [B, H, Sq, D], k, v [B, Hkv, Skv, D]) ->
o [B, H, Sq, D]`` in q's dtype, with GQA (head ``h`` reads kv head
``h // (H // Hkv)``), causal masking with the query rows at the end of the
keys (``q_offset = Skv - Sq``), a sliding window (``col > row - window``)
a logit softcap (``c * tanh(s / c)``) and a softmax scale (``D**-0.5``
unless the caller gives one), all in f32:

* :func:`flash_attention_ref` — the plain PyTorch version.  It follows the
  TPU kernel ``repro/kernels/flash_attention.py::_flash_kernel``, not the
  reference's jnp oracle, where the two differ: a row with no visible key
  gives zeros (the kernel's ``l == 0 -> 1`` rule), not the mean of v;
* :func:`flash_attention_cuda` — the wrapper of the hand-written Hopper
  kernel ``csrc/flash_attention.cu`` (bf16 on the tensor cores through
  ``wgmma`` fed by TMA, f32 on the CUDA cores).  It is the one place that
  chooses an implementation, by the tensors' device alone: on CPU tensors it
  runs the plain version, on CUDA tensors it launches the kernel or raises.
  ``flash_attention_cuda.launches`` counts its kernel launches.  On meta
  tensors it is a shape function: the same checks, the card's shape limits
  included, an output of the right shape and dtype, and no launch.  Every
  call, on any device, is one :func:`~repro_torch.kernels.work.kernel_call`
  of :func:`~repro_torch.kernels.work.flash_attention_work`.  When a
  gradient is wanted it goes through :class:`FlashAttentionFn`: the same
  forward, and a backward that is PyTorch's autodiff of the plain version
  recomputed (the TPU kernel has no backward either: the reference
  differentiates its jnp path).

Unlike the TPU kernel, both take any ``Sq`` and ``Skv``.  The TPU kernel
takes any head width D; the CUDA kernel takes every multiple of 8 from 8 to
:data:`MAX_HEAD_DIM` (:func:`kernel_takes_head_dim`): a bf16 row is then
whole 16-byte units, as TMA's row stride needs.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, work

_NEG = -1e30
DTYPES = (torch.float32, torch.bfloat16)
_MAX_GRID_YZ = 65535
MAX_HEAD_DIM = 256  # the widest head the CUDA kernels take


def kernel_takes_head_dim(D: int) -> bool:
    """Whether the CUDA attention kernels (flash and decode) take head
    width ``D``: a multiple of 8 from 8 to 256, so a bf16 row is whole
    16-byte units (TMA's row stride, the 16-byte loads); the kernels hold
    it zero-padded to 64, 128, 192 or 256 columns."""
    return 8 <= D <= MAX_HEAD_DIM and D % 8 == 0


def softmax_scale(D: int, scale: float | None) -> float:
    """The logits' scale: ``scale``, or ``D**-0.5`` when it is None."""
    return D**-0.5 if scale is None else float(scale)


def attention_mask(Sq: int, Skv: int, *, causal: bool, window: int | None,
                   device: torch.device | str = "cpu") -> torch.Tensor:
    """``[Sq, Skv]`` bool: which keys each query row sees, with the rows at
    kv positions ``Skv - Sq ...``."""
    rows = torch.arange(Sq, device=device)[:, None] + (Skv - Sq)
    cols = torch.arange(Skv, device=device)[None, :]
    mask = torch.ones(Sq, Skv, dtype=torch.bool, device=device)
    if causal:
        mask &= cols <= rows
    if window is not None:
        mask &= cols > rows - window
    return mask


def flash_attention_ref(
    q: torch.Tensor,  # [B, H, Sq, D]
    k: torch.Tensor,  # [B, Hkv, Skv, D]
    v: torch.Tensor,  # [B, Hkv, Skv, D]
    *,
    causal: bool = True,
    window: int | None = None,
    softcap: float | None = None,
    scale: float | None = None,
) -> torch.Tensor:
    """Plain PyTorch attention over the whole ``[Sq, Skv]`` score matrix,
    with the kernel's arithmetic: f32 logits of the query scaled by
    ``scale`` (``D**-0.5`` when None), softcap,
    masked max, ``p = exp(s - m)`` on visible keys only, ``(p v) / l``."""
    B, H, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    if Skv == 0:
        return torch.zeros_like(q)
    group = H // Hkv
    qg = (q.float() * softmax_scale(D, scale)).reshape(B, Hkv, group, Sq, D)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float())
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    mask = attention_mask(Sq, Skv, causal=causal, window=window, device=q.device)
    s = torch.where(mask, s, _NEG)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    l = torch.where(l == 0.0, 1.0, l)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float()) / l
    return o.reshape(B, H, Sq, D).to(q.dtype)


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library, its C signatures declared."""
    lib = _build.load("flash_attention")
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_attention.argtypes = [ptr] * 4 + [i32] * 9 + [f32, f32, ptr]
    lib.flash_attention.restype = i32
    lib.flash_attention_supports.argtypes = [i32]
    lib.flash_attention_supports.restype = i32
    lib.flash_attention_smem.argtypes = [i32, i32]
    lib.flash_attention_smem.restype = ctypes.c_longlong
    return lib


def check_attention_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, q_dims: int,
                         window: int | None, softcap: float | None) -> None:
    """Raise unless q, k, v are contiguous tensors of one dtype (f32 or bf16)
    on one CPU, CUDA or meta device, k and v alike, q ``[B, H, (Sq,) D]`` against
    k ``[B, Hkv, S, D]`` with ``H % Hkv == 0``, and the window and softcap
    positive where given."""
    device = q.device
    if device.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"attention takes CUDA, CPU or meta tensors, got {device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != device or t.dtype != q.dtype:
            raise ValueError(f"{name}: need {q.dtype} on {device}, got {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in DTYPES:
        raise ValueError(f"attention takes float32 or bfloat16, got {q.dtype}")
    if q.dim() != q_dims or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(
            f"need q of {q_dims} dims and k, v alike of 4, got {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}"
        )
    B, H, D = q.shape[0], q.shape[1], q.shape[-1]
    Hkv = k.shape[1]
    if k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree on batch or head width")
    if Hkv == 0 or H % Hkv:
        raise ValueError(f"{H} query heads are not a multiple of {Hkv} kv heads")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"softcap must be > 0, got {softcap}")


def check_alignment(*tensors: torch.Tensor) -> None:
    """The kernels read rows with 16-byte vector loads."""
    for t in tensors:
        if t.data_ptr() % 16 or (t.shape[-1] * t.element_size()) % 16:
            raise ValueError("kernel rows must start on 16-byte boundaries")


def flash_attention_cuda(
    q: torch.Tensor,  # [B, H, Sq, D]
    k: torch.Tensor,  # [B, Hkv, Skv, D]
    v: torch.Tensor,  # [B, Hkv, Skv, D]
    *,
    causal: bool = True,
    window: int | None = None,
    softcap: float | None = None,
    scale: float | None = None,
) -> torch.Tensor:
    """The CUDA kernel ``csrc/flash_attention.cu`` on PyTorch's current
    stream, or, for tensors on the CPU, :func:`flash_attention_ref`.  The
    logits are scaled by ``scale``, ``D**-0.5`` when it is None.

    Takes contiguous float32 or bfloat16 tensors of one dtype on one device,
    on the CPU as on the card, and raises on anything else; on the card also
    on head widths the kernel does not take (:func:`kernel_takes_head_dim`)
    and on grids beyond the launch limits.

    Differentiable: when grad mode is on and an input requires a gradient,
    the call goes through :class:`FlashAttentionFn`."""
    check_attention_args(q, k, v, q_dims=4, window=window, softcap=softcap)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, causal, window, softcap, scale)
    return _flash_forward(q, k, v, causal=causal, window=window, softcap=softcap, scale=scale)


def _flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
                   window: int | None, softcap: float | None, scale: float | None) -> torch.Tensor:
    """The plain version on the CPU, the kernel on the card, the output's
    shape on meta; arguments checked; one kernel call for a counter."""
    with work.kernel_call(lambda: work.flash_attention_work(q, k, causal=causal, window=window)):
        if q.device.type == "cpu":
            return flash_attention_ref(q, k, v, causal=causal, window=window, softcap=softcap,
                                       scale=scale)
        return _on_card(q, k, v, causal=causal, window=window, softcap=softcap, scale=scale)


def _on_card(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
             window: int | None, softcap: float | None, scale: float | None) -> torch.Tensor:
    """Check the card's limits and launch, or, on meta, return the output."""
    B, H, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    if not kernel_takes_head_dim(D):
        raise ValueError(f"the flash kernel takes head widths that are multiples of 8 from 8 "
                         f"to {MAX_HEAD_DIM}, not {D}")
    if B > _MAX_GRID_YZ or H > _MAX_GRID_YZ:
        raise ValueError(f"batch {B} or heads {H} exceed the kernel grid's {_MAX_GRID_YZ}")
    if q.device.type == "meta":
        return torch.empty_like(q)
    lib = _library()
    check_alignment(q, k, v)
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    with torch.cuda.device(q.device):  # the library launches on the current card
        err = lib.flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, H, Hkv, Sq, Skv, D,
            int(q.dtype == torch.bfloat16), int(causal), -1 if window is None else window,
            0.0 if softcap is None else softcap, softmax_scale(D, scale),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _build.check(lib, err, "flash_attention launch")
    flash_attention_cuda.launches += 1
    return o


flash_attention_cuda.launches = 0


class FlashAttentionFn(torch.autograd.Function):
    """Flash attention with a gradient: the forward of
    :func:`flash_attention_cuda` (the kernel on the card, the plain version
    on the CPU), the backward PyTorch's autodiff of
    :func:`flash_attention_ref` recomputed from the saved q, k, v.  The
    recomputation holds the whole f32 ``[B, H, Sq, Skv]`` score matrix and
    its softmax (268 MB each at B 4, H 16, S 1024).  Takes what the wrapper
    takes: causal or not, ``window``, ``softcap``, ``scale``, GQA and Sq !=
    Skv.  A hand-written backward kernel is later work."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, scale):
        ctx.save_for_backward(q, k, v)
        ctx.opts = dict(causal=causal, window=window, softcap=softcap, scale=scale)
        return _flash_forward(q, k, v, **ctx.opts)

    @staticmethod
    def backward(ctx, grad_o):
        inputs = [t.detach().requires_grad_(need) for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        wanted = [t for t in inputs if t.requires_grad]
        with torch.enable_grad():
            o = flash_attention_ref(*inputs, **ctx.opts)
        grads = iter(torch.autograd.grad(o, wanted, grad_o))
        return (*(next(grads) if t.requires_grad else None for t in inputs), None, None, None, None)
