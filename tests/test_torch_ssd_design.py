"""The arithmetic of the Hopper SSD kernels, written out in plain PyTorch,
against the port's plain version and the JAX package.

The CUDA kernels run only on the card (``chip_smoke.py`` phase 8 holds them
to the plain version there).  What can be held here is the design's
arithmetic, the state-passing form of the chunked scan:

1. each chunk's own state from zero, ``ds = xᵀ (B o w)`` with ``w_j =
   exp(acs_Q - acs_j) dt_j``, and its total decay ``exp(acs_Q)``;
2. a pass over the chunks in order, ``S_c = exp(a_tot_c) S_{c-1} + ds_c``;
3. per chunk ``y = M x + exp(acs) (C S_enterᵀ)`` with ``M = (C Bᵀ) o
   exp(acs_i - acs_j) o dt_j`` below the diagonal.

In f32 it is held to ``ssd_scan_ref`` and to the reference's Pallas kernel
(interpret mode) or, at lengths its chunk does not divide, the reference's
sequential oracle, within the tolerances of tests/test_torch_ssd.py.  With
bf16 tensor-core operands it is held to the bounds ``chip_smoke.py`` puts
on the kernel: y within 3e-4 + 2**-8 |y| of the plain version run in f32,
the final state within 3e-4.  The three f32 operands of the products (M,
B o w and the entering state) go in as hi + lo, two bf16 values each; one
bf16 rounding of them misses both bounds, which the last test pins.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp
from repro.kernels import ref
from repro.kernels.ssd_scan import ssd_scan_pallas

from repro_torch.kernels.ssd_scan import KERNEL_CHUNK, ssd_scan_ref

TOL = 3e-4  # tests/test_torch_ssd.py, f32


def _operand(v: torch.Tensor, split: str | None) -> torch.Tensor:
    """An f32 operand as the tensor cores see it: unchanged (``None``), as
    bf16 hi + lo (``"hilo"``), or rounded once to bf16 (``"bf16"``)."""
    if split is None:
        return v
    hi = v.to(torch.bfloat16).float()
    return hi if split == "bf16" else hi + (v - hi).to(torch.bfloat16).float()


def state_passing_ssd(x, dt, A, B_mat, C_mat, *, chunk=KERNEL_CHUNK, split=None):
    """The kernels' three stages on x [B, L, H, P], dt [B, L, H], A [H], B, C
    [B, L, G, N]; returns y (f32, before any rounding) and the final state
    [B, H, P, N].  The tail chunk is padded with x = B = C = dt = 0."""
    Bsz, L, H, P = x.shape
    G, N = B_mat.shape[2:]
    n_chunks = -(-L // chunk)
    pad = n_chunks * chunk - L

    def chunks(t):  # [B, L, ...] -> [B, chunks, Q, ...] f32
        t = F.pad(t.float(), (0, 0) * (t.dim() - 2) + (0, pad))
        return t.reshape(Bsz, n_chunks, chunk, *t.shape[2:])

    xq, dq = chunks(x), chunks(dt)
    Bq = chunks(B_mat.repeat_interleave(H // G, dim=2))
    Cq = chunks(C_mat.repeat_interleave(H // G, dim=2))
    acs = torch.cumsum(dq * A.float(), dim=2)  # [B, c, Q, H]
    a_tot = acs[:, :, -1]  # [B, c, H]

    # 1. each chunk's own state from zero
    w = torch.exp(a_tot[:, :, None] - acs) * dq
    ds = torch.einsum("bcjhp,bcjhn->bchpn", xq, _operand(Bq * w[..., None], split))
    # 2. the states entering each chunk, in chunk order
    S = torch.zeros(Bsz, H, P, N)
    entering = []
    for c in range(n_chunks):
        entering.append(S)
        S = S * torch.exp(a_tot[:, c])[..., None, None] + ds[:, c]
    S_enter = torch.stack(entering, dim=1)
    # 3. y: the chunk's own part, then the entering state's, scaled after
    # the product
    tril = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool))[None, None, :, :, None]
    seg = acs[:, :, :, None, :] - acs[:, :, None, :, :]  # [B, c, i, j, H]
    decay = torch.where(tril, torch.exp(torch.where(tril, seg, 0.0)), 0.0)
    M = torch.einsum("bcihn,bcjhn->bcijh", Cq, Bq) * decay * dq[:, :, None]
    y = torch.einsum("bcijh,bcjhp->bcihp", _operand(M, split), xq)
    y = y + torch.einsum("bcihn,bchpn->bcihp", Cq, _operand(S_enter, split)) * torch.exp(acs)[..., None]
    return y.reshape(Bsz, n_chunks * chunk, H, P)[:, :L], S


def _inputs(seed, B, L, H, P, G, N, dtype=torch.float32):
    """numpy draws at the reference test's (and phase 8's) scales: x, B and C
    in ``dtype``, dt and A f32."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, L, H, P), dtype=np.float32)
    dt = np.abs(rng.standard_normal((B, L, H), dtype=np.float32)) * 0.1 + 0.01
    A = -(np.abs(rng.standard_normal(H, dtype=np.float32)) + 0.2)
    Bm = rng.standard_normal((B, L, G, N), dtype=np.float32) * 0.3
    Cm = rng.standard_normal((B, L, G, N), dtype=np.float32) * 0.3
    t = [torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)) for a in (x, dt, A, Bm, Cm)]
    return t[0].to(dtype), t[1], t[2], t[3].to(dtype), t[4].to(dtype)


def _jax(ts):
    return [jnp.asarray(t.float().numpy()) for t in ts]


@pytest.mark.parametrize("L", [5, 37, 891])
@pytest.mark.parametrize("G", [1, 2])
def test_state_passing_matches_the_plain_version_and_the_reference(L, G):
    """Ragged lengths in chunks of 16 (so the state passes between chunks
    even at L = 5 and 37), batch 2."""
    args = _inputs(L + G, 2, L, 4, 16, G, 16)
    y, state = state_passing_ssd(*args, chunk=16)
    y_ref, state_ref = ssd_scan_ref(*args, chunk=16)
    torch.testing.assert_close(y, y_ref, atol=TOL, rtol=TOL)
    torch.testing.assert_close(state, state_ref, atol=TOL, rtol=TOL)
    # the reference: its Pallas kernel where one chunk spans L (it takes
    # only lengths its chunk divides), else its sequential oracle
    jy, jstate = ssd_scan_pallas(*_jax(args), chunk=L) if L < KERNEL_CHUNK else ref.ssd_scan_ref(*_jax(args))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(state.numpy(), np.asarray(jstate), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("L,chunk", [(64, 16), (256, 64)])
def test_state_passing_matches_the_pallas_kernel_over_many_chunks(L, chunk):
    args = _inputs(L, 2, L, 4, 16, 2, 32)
    y, state = state_passing_ssd(*args, chunk=chunk)
    jy, jstate = ssd_scan_pallas(*_jax(args), chunk=chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(state.numpy(), np.asarray(jstate), atol=TOL, rtol=TOL)


def _excess(args, split):
    """(how far bf16 y exceeds 3e-4 + 2**-8 |y| at worst, the state's largest
    error) of the tensor-core arithmetic against the plain version in f32."""
    x, dt, A, Bm, Cm = args
    y32, state32 = ssd_scan_ref(x.float(), dt, A, Bm.float(), Cm.float())
    y, state = state_passing_ssd(*args, split=split)
    y = y.to(torch.bfloat16).float()  # the kernel rounds its f32 y once
    excess = float(((y - y32).abs() - (3e-4 + 2**-8 * y32.abs())).max())
    return excess, float((state - state32).abs().max())


@pytest.mark.parametrize("L", [891, 1024])
def test_hi_lo_operands_meet_the_kernels_bounds(L):
    """mamba2-780m's state width and head width at phase 8's input scales:
    the split operands keep y inside its bound and the state within 3e-4."""
    args = _inputs(L, 1, L, 8, 64, 1, 128, torch.bfloat16)
    excess, state_err = _excess(args, "hilo")
    assert excess <= 0.0, excess
    assert state_err <= 3e-4, state_err


@pytest.mark.parametrize("L", [891, 1024])
def test_rounding_the_operands_to_bf16_alone_misses_the_bounds(L):
    """Why the kernels split M, B o w and the entering state: one bf16
    rounding of each (2**-9 relative) puts y outside its bound by more than
    a millistep and the state outside 3e-4."""
    args = _inputs(L, 1, L, 8, 64, 1, 128, torch.bfloat16)
    excess, state_err = _excess(args, "bf16")
    assert excess > 1e-3, excess
    assert state_err > 3e-4, state_err
