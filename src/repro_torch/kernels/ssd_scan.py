"""Mamba2 SSD (state-space duality) scan.

One function, ``(x [B, L, H, P], dt [B, L, H], A [H], B [B, L, G, N],
C [B, L, G, N]) -> (y [B, L, H, P] in x's dtype, final state [B, H, P, N]
f32)``, the recurrence

    S_t = exp(dt_t A) S_{t-1} + dt_t x_t B_tᵀ ;   y_t = S_t C_t

from a zero state, with head ``h`` reading group ``h // (H // G)`` of B and
C and all arithmetic in f32:

* :func:`ssd_scan_ref` — the plain PyTorch version, the chunked (duality)
  form of the reference's ``kernels/ref.py::ssd_scan_chunked_ref``, taken to
  any L;
* :func:`ssd_scan_cuda` — the wrapper of the hand-written Hopper kernels
  ``csrc/ssd_scan.cu`` (bf16 at chunk 128, N 64 or 128 and P a multiple of
  32: chunk-parallel state passing on wgmma, three device kernels; every
  other shape, f32 or bf16: a chunk-serial CUDA-core kernel, chosen by
  :func:`ssd_plan`), which replace the reference's Pallas kernel
  ``repro/kernels/ssd_scan.py::ssd_scan_pallas``.  It is the one place that
  chooses an implementation, by the tensors' device alone: on CPU tensors it
  runs the plain version, on CUDA tensors it launches the kernel or raises.
  ``ssd_scan_cuda.launches`` counts its calls that launch, one per call.
  On meta tensors it is a shape function (the checks, :func:`ssd_plan`'s
  limits, the outputs; no launch).  Every call is one
  :func:`~repro_torch.kernels.work.kernel_call` of
  :func:`~repro_torch.kernels.work.ssd_scan_work`.
  When a gradient is wanted it goes through :class:`SSDScanFn`, whose
  backward is PyTorch's autodiff of :func:`ssd_scan_ref` recomputed;
* :func:`ssd_scan_sequential` — the step-by-step recurrence, the reference's
  ``ssd_scan_ref``, an oracle for the tests.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build, work
from repro_torch.kernels.flash_attention import check_alignment

DTYPES = (torch.float32, torch.bfloat16)
KERNEL_CHUNK = 128  # the wgmma kernels' chunk, and the longest chunk either design takes
KERNEL_STATES = (16, 32, 64, 128)  # state widths N the kernels are built for
KERNEL_P_ALIGN = 16  # head widths P must be multiples of it
WGMMA_STATES = (64, 128)  # the wgmma kernels' state widths
WGMMA_P_TILE = 32  # the wgmma kernels' head widths are multiples of it
_MAX_GRID_YZ = 65535
BLOCK_BYTES = 1 << 26  # the plain version's largest temporary when no gradient is recorded


def ssd_scan_ref(
    x: torch.Tensor,  # [B, L, H, P]
    dt: torch.Tensor,  # [B, L, H] f32, > 0
    A: torch.Tensor,  # [H] f32, < 0
    B_mat: torch.Tensor,  # [B, L, G, N]
    C_mat: torch.Tensor,  # [B, L, G, N]
    *,
    chunk: int = 128,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The chunked SSD scan in plain PyTorch: within a chunk of ``Q =
    min(chunk, L)`` steps, ``y_i = sum_{j<=i} (C_i·B_j) exp(acs_i - acs_j)
    dt_j x_j + exp(acs_i) C_i S`` with ``acs`` the in-chunk inclusive cumsum
    of ``dt·A``; between chunks ``S <- exp(acs_Q) S + sum_j exp(acs_Q -
    acs_j) dt_j x_j B_jᵀ``.

    Any L: the tail chunk is padded with ``x = B = C = 0`` and ``dt = 0``.
    A padded step then decays by ``exp(0·A) = 1`` and adds ``0``, so the
    final state is exact, not approximate, and the padded rows of y are
    dropped.  Returns ``(y [B, L, H, P] in x.dtype, final_state [B, H, P,
    N] f32)``."""
    Bsz, L, H, P = x.shape
    G, N = B_mat.shape[2], B_mat.shape[3]
    state = torch.zeros(Bsz, H, P, N, dtype=torch.float32, device=x.device)
    if L == 0:
        return torch.empty_like(x), state
    Q = min(chunk, L)
    nC = -(-L // Q)
    pad = nC * Q - L
    rep = H // G

    def chunks(t: torch.Tensor) -> torch.Tensor:  # [B, L, ...] -> [nC, B, Q, ...] f32
        t = t.float()
        t = F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
        return t.reshape(Bsz, nC, Q, *t.shape[2:]).transpose(0, 1)

    xq = chunks(x)  # [nC, B, Q, H, P]
    dq = chunks(dt)
    Bq = chunks(B_mat.repeat_interleave(rep, dim=2))
    Cq = chunks(C_mat.repeat_interleave(rep, dim=2))
    acs = torch.cumsum(dq * A.float(), dim=2)  # [nC, B, Q, H], inclusive
    tril = torch.tril(torch.ones(Q, Q, dtype=torch.bool, device=x.device))[None, None, :, :, None]

    def run(a, Cc, Bc, xc, dc, state):  # consecutive chunks [c, B, Q, ...] from ``state``
        seg = a[:, :, :, None, :] - a[:, :, None, :, :]  # [c, B, Qi, Qj, H]
        decay = torch.where(tril, torch.exp(torch.where(tril, seg, 0.0)), 0.0)
        m = torch.einsum("cbihn,cbjhn->cbijh", Cc, Bc) * decay
        y_intra = torch.einsum("cbijh,cbjhp->cbihp", m, xc * dc[..., None])
        a_tot = a[:, :, -1, :]  # [c, B, H]
        w = torch.exp(a_tot[:, :, None, :] - a) * dc  # [c, B, Q, H]
        ds = torch.einsum("cbjhp,cbjhn->cbhpn", xc, Bc * w[..., None])  # each chunk's own state
        step = torch.exp(a_tot)[..., None, None]
        entering = []  # the state entering each chunk, in order
        for i in range(ds.shape[0]):
            entering.append(state)
            state = state * step[i] + ds[i]
        y_inter = torch.einsum("cbihn,cbhpn->cbihp", Cc, torch.stack(entering)) * torch.exp(a)[..., None]
        return y_intra + y_inter, state

    # Chunks a block at a time, each block's [c, B, Q, Q, H] f32 temporaries
    # within BLOCK_BYTES; where autograd records, it keeps every chunk's
    # anyway, so all chunks in one block
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, dt, A, B_mat, C_mat)):
        block = nC
    else:
        block = max(1, BLOCK_BYTES // (Bsz * Q * Q * H * 4))
    if block >= nC:  # whole, with no slices for autograd to undo
        y, state = run(acs, Cq, Bq, xq, dq, state)
    else:
        ys = []
        for c in range(0, nC, block):
            yc, state = run(*(t[c:c + block] for t in (acs, Cq, Bq, xq, dq)), state)
            ys.append(yc)
        y = torch.cat(ys)
    y = y.transpose(0, 1).reshape(Bsz, nC * Q, H, P)[:, :L]
    return y.to(x.dtype), state


def ssd_scan_sequential(
    x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B_mat: torch.Tensor, C_mat: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """The recurrence one step at a time, in f32 (the reference's
    ``ssd_scan_ref``): an oracle for the tests, slow at any real L."""
    Bsz, L, H, P = x.shape
    G, N = B_mat.shape[2], B_mat.shape[3]
    rep = H // G
    Bh = B_mat.repeat_interleave(rep, dim=2).float()
    Ch = C_mat.repeat_interleave(rep, dim=2).float()
    xf, dtf, Af = x.float(), dt.float(), A.float()
    state = torch.zeros(Bsz, H, P, N, dtype=torch.float32, device=x.device)
    ys = []
    for t in range(L):
        dA = torch.exp(dtf[:, t] * Af[None, :])  # [B, H]
        state = state * dA[..., None, None] + (
            dtf[:, t, :, None, None] * xf[:, t, :, :, None] * Bh[:, t, :, None, :]
        )
        ys.append(torch.einsum("bhpn,bhn->bhp", state, Ch[:, t]))
    y = torch.stack(ys, dim=1) if ys else xf.new_zeros(Bsz, 0, H, P)
    return y.to(x.dtype), state


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library, its C signature declared."""
    lib = _build.load("ssd_scan")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.ssd_scan.argtypes = [ptr] * 9 + [i32] * 9 + [ptr]
    lib.ssd_scan.restype = i32
    return lib


def check_ssd_args(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B_mat: torch.Tensor,
                   C_mat: torch.Tensor) -> None:
    """Raise unless all five are contiguous tensors on one CPU, CUDA or meta
    device; x, B and C of one dtype, f32 or bf16; dt and A f32; x ``[B, L,
    H, P]``, dt ``[B, L, H]``, A ``[H]``, B and C alike ``[B, L, G, N]``
    with ``H % G == 0``."""
    device = x.device
    if device.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"the SSD scan takes CUDA, CPU or meta tensors, got {device}")
    for name, t, dtype in (("x", x, x.dtype), ("dt", dt, torch.float32), ("A", A, torch.float32),
                           ("B", B_mat, x.dtype), ("C", C_mat, x.dtype)):
        if t.device != device or t.dtype != dtype:
            raise ValueError(f"{name}: need {dtype} on {device}, got {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.dtype not in DTYPES:
        raise ValueError(f"x, B and C must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != 4 or B_mat.dim() != 4 or C_mat.shape != B_mat.shape:
        raise ValueError(f"need x [B, L, H, P] and B, C alike [B, L, G, N], got "
                         f"{tuple(x.shape)}, {tuple(B_mat.shape)}, {tuple(C_mat.shape)}")
    Bsz, L, H, _ = x.shape
    G = B_mat.shape[2]
    if tuple(B_mat.shape[:2]) != (Bsz, L) or tuple(dt.shape) != (Bsz, L, H) or tuple(A.shape) != (H,):
        raise ValueError(f"x {tuple(x.shape)}, dt {tuple(dt.shape)}, A {tuple(A.shape)} and "
                         f"B {tuple(B_mat.shape)} disagree on batch, length or heads")
    if G == 0 or H % G:
        raise ValueError(f"{H} heads are not a multiple of {G} groups")


def ssd_plan(dtype: torch.dtype, L: int, N: int, P: int, chunk: int) -> tuple[bool, int]:
    """Which of the two kernel designs takes a scan, by its shape alone, and
    the chunk it runs: ``(wgmma, Q)``.  ``wgmma`` is True for bf16 at chunk
    128 with N 64 or 128 and P a multiple of 32 (the three wgmma kernels, Q
    128, which pad a last chunk, or an L under 128, with zero steps); every
    other shape runs the chunk-serial CUDA-core kernel in chunks of ``Q =
    min(chunk, L)`` steps (at least 1), the TPU kernel's chunk.  Raises :class:`~repro_torch.kernels._build.
    KernelInputError` on a chunk outside 1-128, N outside 16/32/64/128 or P
    not a multiple of 16."""
    if not 1 <= chunk <= KERNEL_CHUNK:
        raise _build.KernelInputError(f"the SSD kernels take chunks of 1 to {KERNEL_CHUNK} steps, not {chunk}")
    if N not in KERNEL_STATES or P % KERNEL_P_ALIGN:
        raise _build.KernelInputError(f"the SSD kernels take N in {KERNEL_STATES} and P a multiple of "
                                      f"{KERNEL_P_ALIGN}, not N={N}, P={P}")
    if dtype == torch.bfloat16 and chunk == KERNEL_CHUNK and N in WGMMA_STATES and P % WGMMA_P_TILE == 0:
        return True, KERNEL_CHUNK
    return False, max(1, min(chunk, L))


def ssd_scan_cuda(
    x: torch.Tensor,  # [B, L, H, P]
    dt: torch.Tensor,  # [B, L, H] f32
    A: torch.Tensor,  # [H] f32
    B_mat: torch.Tensor,  # [B, L, G, N]
    C_mat: torch.Tensor,  # [B, L, G, N]
    *,
    chunk: int = 128,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The CUDA kernels ``csrc/ssd_scan.cu`` on PyTorch's current stream, or,
    for tensors on the CPU, :func:`ssd_scan_ref`.  Returns ``(y [B, L, H, P]
    in x.dtype, final_state [B, H, P, N] f32)``.

    Checks its arguments (:func:`check_ssd_args`) on the CPU as on the card;
    on the card :func:`ssd_plan` picks the kernel by shape and raises on a
    chunk outside 1-128, a state width N other than 16, 32, 64 or 128, a head
    width P that is not a multiple of 16, and it raises on grids beyond the
    launch limits.

    Differentiable: when grad mode is on and an input requires a gradient,
    the call goes through :class:`SSDScanFn`."""
    check_ssd_args(x, dt, A, B_mat, C_mat)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, dt, A, B_mat, C_mat)):
        return SSDScanFn.apply(x, dt, A, B_mat, C_mat, chunk)
    return _ssd_forward(x, dt, A, B_mat, C_mat, chunk)


def _ssd_forward(x, dt, A, B_mat, C_mat, chunk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version on the CPU, the kernels on the card, the outputs'
    shapes on meta; arguments checked; one kernel call for a counter."""
    with work.kernel_call(lambda: work.ssd_scan_work(x, B_mat)):
        if x.device.type == "cpu":
            return ssd_scan_ref(x, dt, A, B_mat, C_mat, chunk=chunk)
        if x.device.type == "meta":
            return _shapes(x, B_mat, chunk)
        return _on_card(x, dt, A, B_mat, C_mat, chunk)


class SSDScanFn(torch.autograd.Function):
    """The SSD scan with a gradient: the forward of :func:`ssd_scan_cuda`
    (the kernels on the card, the plain version on the CPU), returning ``(y,
    final_state)``; the backward PyTorch's autodiff of :func:`ssd_scan_ref`
    recomputed from the saved inputs, giving x, dt, A, B and C their
    gradients (a final state that nothing used has a zero gradient).  A
    hand-written backward kernel is later work."""

    @staticmethod
    def forward(ctx, x, dt, A, B_mat, C_mat, chunk):
        ctx.save_for_backward(x, dt, A, B_mat, C_mat)
        ctx.chunk = chunk
        return _ssd_forward(x, dt, A, B_mat, C_mat, chunk)

    @staticmethod
    def backward(ctx, grad_y, grad_state):
        inputs = [t.detach().requires_grad_(need) for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        wanted = [t for t in inputs if t.requires_grad]
        with torch.enable_grad():
            y, state = ssd_scan_ref(*inputs, chunk=ctx.chunk)
        grads = iter(torch.autograd.grad((y, state), wanted, (grad_y, grad_state)))
        return (*(next(grads) if t.requires_grad else None for t in inputs), None)


def _shapes(x: torch.Tensor, B_mat: torch.Tensor, chunk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """On meta: the card's checks (:func:`ssd_plan`, the grid) and the
    outputs, no launch."""
    Bsz, L, H, P = x.shape
    ssd_plan(x.dtype, L, B_mat.shape[3], P, chunk)
    if Bsz > _MAX_GRID_YZ or H > _MAX_GRID_YZ:
        raise ValueError(f"batch {Bsz} or heads {H} exceed the kernel grid's {_MAX_GRID_YZ}")
    return torch.empty_like(x), torch.empty(Bsz, H, P, B_mat.shape[3], dtype=torch.float32, device=x.device)


def _on_card(x, dt, A, B_mat, C_mat, chunk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plan and launch one scan on the card of ``x``."""
    Bsz, L, H, P = x.shape
    G, N = B_mat.shape[2], B_mat.shape[3]
    wgmma, Q = ssd_plan(x.dtype, L, N, P, chunk)
    if Bsz > _MAX_GRID_YZ or H > _MAX_GRID_YZ:
        raise ValueError(f"batch {Bsz} or heads {H} exceed the kernel grid's {_MAX_GRID_YZ}")
    lib = _library()
    check_alignment(x, B_mat, C_mat)
    y = torch.empty_like(x)
    state = torch.empty(Bsz, H, P, N, dtype=torch.float32, device=x.device)
    if state.numel() == 0:
        return y, state
    # the wgmma kernels' scratch: each chunk's state [N, P] and its total decay
    chunks = -(-L // KERNEL_CHUNK) if wgmma else 0
    states = torch.empty(Bsz, chunks, H, N, P, dtype=torch.float32, device=x.device)
    atot = torch.empty(Bsz, chunks, H, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):  # the library launches on the current card
        err = lib.ssd_scan(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B_mat.data_ptr(), C_mat.data_ptr(),
            y.data_ptr(), state.data_ptr(), states.data_ptr(), atot.data_ptr(), Bsz, L, H, G, P, N,
            Q, int(x.dtype == torch.bfloat16), int(wgmma),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _build.check(lib, err, "ssd_scan launch")
    ssd_scan_cuda.launches += 1
    return y, state


ssd_scan_cuda.launches = 0
