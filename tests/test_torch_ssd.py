"""The port's SSD scan against the JAX package's.

The plain PyTorch version (``ssd_scan_ref``, the chunked form taken to any
L) is held to the reference's Pallas kernel, run in interpret mode on the
CPU as tests/test_kernels_ssd.py runs it, at lengths its chunk divides, and
to the reference's sequential oracle at ragged lengths, where the reference
itself falls back to that oracle.  The wrapper runs the plain version for
CPU tensors, counts no launch there, and refuses what the kernel does not
take; on the card it picks the kernel by shape, and it passes the reduced
configs' shapes and chunk to the library (checked here through stand-ins
for the library and the device).

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

from repro_torch.kernels.ssd_scan import ssd_plan, ssd_scan_cuda, ssd_scan_ref, ssd_scan_sequential
from repro_torch.models.registry import get_model

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


@pytest.mark.parametrize("chunks_a_block", [1, 3])
def test_plain_version_by_blocks_equals_it_whole(monkeypatch, chunks_a_block):
    """With no gradient recorded the plain version takes its chunks a block
    at a time within ``BLOCK_BYTES`` (here 1 and 3 chunks of 5, the last
    block short): the same scan as all chunks at once, and the reference's
    sequential recurrence."""
    from repro_torch.kernels import ssd_scan as S

    jax_in, torch_in = _inputs(8, 2, 72, 4, 16, 2, 16)
    whole = ssd_scan_ref(*torch_in, chunk=16)
    monkeypatch.setattr(S, "BLOCK_BYTES", chunks_a_block * 2 * 16 * 16 * 4 * 4)
    y, state = ssd_scan_ref(*torch_in, chunk=16)
    torch.testing.assert_close(y, whole[0], atol=1e-6, rtol=0)
    torch.testing.assert_close(state, whole[1], atol=1e-6, rtol=0)
    jy, jstate = ref.ssd_scan_ref(*jax_in)
    _close(y, jy, TOL["float32"])
    _close(state, jstate, TOL["float32"])


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


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_plan_takes_the_reduced_shapes_at_their_chunk(dtype):
    """The reduced mamba2-780m and zamba2-7b (chunk 16, N 16, P 16) go to
    the chunk-serial kernel in chunks of min(chunk, L), as the TPU kernel
    takes them; the full configs' bf16 shapes keep the wgmma kernels."""
    for arch in ("mamba2-780m", "zamba2-7b"):
        cfg = get_model(arch).reduced
        P, N, chunk = cfg.ssm_headdim, cfg.ssm_state, cfg.ssm_chunk
        assert (P, N, chunk) == (16, 16, 16)
        assert ssd_plan(dtype, 9, N, P, chunk) == (False, 9)
        assert ssd_plan(dtype, 40, N, P, chunk) == (False, 16)
    for arch in ("mamba2-780m", "zamba2-7b"):
        cfg = get_model(arch).config
        wgmma, Q = ssd_plan(dtype, 891, cfg.ssm_state, cfg.ssm_headdim, cfg.ssm_chunk)
        assert (wgmma, Q) == (dtype == torch.bfloat16, 128)
    assert ssd_plan(torch.bfloat16, 891, 128, 64, 64) == (False, 64)  # another chunk: CUDA cores
    assert ssd_plan(torch.bfloat16, 891, 32, 64, 128) == (False, 128)  # N 32: CUDA cores
    assert ssd_plan(torch.bfloat16, 891, 64, 48, 128) == (False, 128)  # P 48: CUDA cores
    for L, N, P, chunk, match in ((9, 16, 16, 0, "chunks of 1 to 128"), (9, 16, 16, 256, "chunks of 1 to 128"),
                                  (9, 24, 16, 16, "N in"), (9, 16, 8, 16, "multiple of 16")):
        with pytest.raises(ValueError, match=match):
            ssd_plan(dtype, L, N, P, chunk)


def test_wrapper_launches_the_reduced_shapes_on_the_card_of_its_tensors(monkeypatch):
    """The wrapper passes the plan, the chunk it runs and the shape to the library,
    makes its tensors' card current for the launch and counts one launch.
    No card here: tensors on the meta device stand for the card's, and the
    device switch, the stream and the library are stand-ins that record
    what they are given."""
    from types import SimpleNamespace

    from repro_torch.kernels import ssd_scan as ssd_mod

    current, seen = ["cuda:0"], []

    class Current:
        def __init__(self, device):
            self.device = "cuda:1"

        def __enter__(self):
            self.prev, current[0] = current[0], self.device

        def __exit__(self, *exc):
            current[0] = self.prev

    def ssd_scan(*args):
        seen.append((current[0], args[9:18]))
        return 0

    monkeypatch.setattr(torch.cuda, "device", Current)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: SimpleNamespace(cuda_stream=7))
    monkeypatch.setattr(ssd_mod, "_library", lambda: SimpleNamespace(ssd_scan=ssd_scan))
    before = ssd_scan_cuda.launches
    for dtype, (B, L, H, P, G, N), chunk in (
        (torch.bfloat16, (2, 9, 8, 16, 1, 16), 16),  # the reduced configs, a prompt under one chunk
        (torch.bfloat16, (1, 40, 8, 16, 1, 16), 16),  # three chunks of 16
        (torch.float32, (1, 40, 8, 16, 2, 32), 16),
        (torch.bfloat16, (1, 891, 48, 64, 1, 128), 128),  # mamba2-780m: the wgmma kernels
    ):
        x = torch.empty(B, L, H, P, dtype=dtype, device="meta")
        dt = torch.empty(B, L, H, device="meta")
        A = torch.empty(H, device="meta")
        Bm = torch.empty(B, L, G, N, dtype=dtype, device="meta")
        y, state = ssd_mod._on_card(x, dt, A, Bm, Bm, chunk)
        assert y.shape == x.shape and y.dtype == dtype and state.shape == (B, H, P, N)
        wgmma, Q = chunk == 128, min(chunk, L)  # the chunk the kernel runs: min(chunk, L), or 128
        assert seen[-1] == ("cuda:1", (B, L, H, G, P, N, Q, int(dtype == torch.bfloat16), int(wgmma)))
    assert current == ["cuda:0"]
    assert ssd_scan_cuda.launches == before + 4
