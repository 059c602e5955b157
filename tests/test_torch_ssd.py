"""The port's SSD scan against the JAX package's.

The plain PyTorch version (``ssd_scan_ref``, the chunked form taken to any
L) is held to the reference's Pallas kernel, run in interpret mode on the
CPU as tests/test_kernels_ssd.py runs it, at lengths its chunk divides, and
to the reference's sequential oracle at ragged lengths, where the reference
itself falls back to that oracle.  The wrapper runs the plain version for
CPU tensors, counts no launch there, and refuses what the kernel does not
take.

Tolerances are those of tests/test_kernels_ssd.py: 3e-4 in f32, the
reference's own chunked-against-sequential limit (the two forms sum in
another order, and the decays come from a cumulative sum of dt·A taken in
another order), and 3e-2 in bf16, where y is rounded to bf16 (8 bits).
Inputs are numpy draws at the reference test's scales, rounded to the dtype
identically on both sides.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels import ref
from repro.kernels.ssd_scan import ssd_scan_pallas

from repro_torch.kernels.ssd_scan import ssd_scan_cuda, ssd_scan_ref, ssd_scan_sequential

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": 3e-4, "bfloat16": 3e-2}


def _inputs(seed, B, L, H, P, G, N, dtype="float32"):
    """(x, dt, A, B, C) as jax arrays and as torch tensors: x, B and C in
    ``dtype``, dt and A in f32."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, L, H, P), dtype=np.float32)
    dt = (np.abs(rng.standard_normal((B, L, H), dtype=np.float32)) * 0.1 + 0.01).astype(np.float32)
    A = -(np.abs(rng.standard_normal(H, dtype=np.float32)) + 0.2).astype(np.float32)
    Bm = (rng.standard_normal((B, L, G, N), dtype=np.float32) * 0.3).astype(np.float32)
    Cm = (rng.standard_normal((B, L, G, N), dtype=np.float32) * 0.3).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    typed = (True, False, False, True, True)
    jax_in = [jnp.asarray(a).astype(jdt) if t else jnp.asarray(a) for a, t in zip((x, dt, A, Bm, Cm), typed)]
    torch_in = [torch.from_numpy(a).to(tdt) if t else torch.from_numpy(a)
                for a, t in zip((x, dt, A, Bm, Cm), typed)]
    return jax_in, torch_in


def _close(port, reference, tol):
    np.testing.assert_allclose(
        port.float().numpy(), np.asarray(jnp.asarray(reference).astype(jnp.float32)), atol=tol, rtol=tol
    )


@pytest.mark.parametrize("B,L,H,P,G,N,chunk", [
    (1, 64, 2, 16, 1, 16, 16),    # four chunks
    (2, 128, 4, 32, 2, 32, 32),   # batch 2, two groups
    (1, 256, 4, 32, 1, 64, 64),
    (1, 24, 2, 16, 1, 16, 32),    # under one chunk: both take chunk = L
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas(B, L, H, P, G, N, chunk, dtype):
    jax_in, torch_in = _inputs(0, B, L, H, P, G, N, dtype)
    y, state = ssd_scan_ref(*torch_in, chunk=chunk)
    jy, jstate = ssd_scan_pallas(*jax_in, chunk=min(chunk, L))
    assert y.dtype == torch_in[0].dtype and state.dtype == torch.float32
    assert tuple(y.shape) == jy.shape and tuple(state.shape) == jstate.shape
    _close(y, jy, TOL[dtype])
    _close(state, jstate, TOL[dtype])


@pytest.mark.parametrize("L", [5, 37, 100])
@pytest.mark.parametrize("G", [1, 2])
def test_plain_matches_sequential_at_ragged_lengths(L, G):
    """L not a multiple of the chunk: the tail chunk is padded with dt = 0
    and adds nothing, so y and the final state match the step-by-step
    recurrence."""
    jax_in, torch_in = _inputs(L, 2, L, 4, 16, G, 16)
    y, state = ssd_scan_ref(*torch_in, chunk=16)
    jy, jstate = ref.ssd_scan_ref(*jax_in)
    _close(y, jy, TOL["float32"])
    _close(state, jstate, TOL["float32"])
    y_seq, state_seq = ssd_scan_sequential(*torch_in)
    _close(y, y_seq, TOL["float32"])
    _close(state, state_seq, TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sequential_oracle_matches_reference(dtype):
    jax_in, torch_in = _inputs(3, 2, 19, 4, 8, 2, 8, dtype)
    y, state = ssd_scan_sequential(*torch_in)
    jy, jstate = ref.ssd_scan_ref(*jax_in)
    _close(y, jy, 1e-5 if dtype == "float32" else TOL[dtype])
    _close(state, jstate, 1e-5)


def test_chunk_boundaries_carry_the_state():
    """The same inputs chunked at 8, 16 and 64 (one chunk) give the same
    scan: the state carried between chunks is the whole history."""
    _, torch_in = _inputs(4, 1, 64, 2, 16, 1, 16)
    y64, s64 = ssd_scan_ref(*torch_in, chunk=64)
    for chunk in (8, 16):
        y, s = ssd_scan_ref(*torch_in, chunk=chunk)
        _close(y, y64.numpy(), TOL["float32"])
        _close(s, s64.numpy(), TOL["float32"])


def test_padded_steps_add_nothing_to_the_state():
    """Steps with dt = 0 and x = B = C = 0, what the tail chunk is padded
    with, leave the state exactly as it was and give y = 0."""
    _, (x, dt, A, Bm, Cm) = _inputs(5, 1, 21, 2, 16, 1, 16)
    _, state = ssd_scan_sequential(x, dt, A, Bm, Cm)
    pad = lambda t: torch.cat([t, torch.zeros(1, 11, *t.shape[2:], dtype=t.dtype)], dim=1)  # noqa: E731
    y_pad, state_pad = ssd_scan_sequential(pad(x), pad(dt), A, pad(Bm), pad(Cm))
    assert torch.equal(state_pad, state)
    assert not y_pad[:, 21:].any()


def test_wrapper_runs_the_plain_version_on_the_cpu():
    _, torch_in = _inputs(6, 1, 40, 4, 16, 2, 16)
    before = ssd_scan_cuda.launches
    y, state = ssd_scan_cuda(*torch_in, chunk=16)
    y_ref, state_ref = ssd_scan_ref(*torch_in, chunk=16)
    assert torch.equal(y, y_ref) and torch.equal(state, state_ref)
    assert ssd_scan_cuda.launches == before


def test_wrapper_refuses_what_the_kernel_does_not_take():
    _, (x, dt, A, Bm, Cm) = _inputs(7, 1, 8, 4, 16, 2, 16)
    bad = [
        ((x, dt.to(torch.bfloat16), A, Bm, Cm), "dt: need torch.float32"),
        ((x, dt, A.double(), Bm, Cm), "A: need torch.float32"),
        ((x, dt, A, Bm.to(torch.bfloat16), Cm), "B: need torch.float32"),
        ((x.double(), dt, A, Bm.double(), Cm.double()), "float32 or bfloat16"),
        ((x.transpose(2, 3).contiguous().transpose(2, 3), dt, A, Bm, Cm), "contiguous"),
        ((x, dt, A, Bm, Cm[:, :, :1].contiguous()), "alike"),
        ((x, dt[:, :4].contiguous(), A, Bm, Cm), "disagree"),
        ((x, dt, A, torch.zeros(1, 8, 3, 16), torch.zeros(1, 8, 3, 16)), "multiple of 3 groups"),
    ]
    for args, match in bad:
        with pytest.raises(ValueError, match=match):
            ssd_scan_cuda(*args)
