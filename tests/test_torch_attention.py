"""The port's flash and decode attention against the JAX package's.

The plain PyTorch versions are held to the reference's Pallas kernels, run
in interpret mode on the CPU as tests/test_kernels_attention.py runs them,
over the same shape, dtype, GQA and mask grid, and, at ragged lengths that
the Pallas kernels' block sizes do not divide, to the reference's jnp oracle.
The wrappers run the plain version for CPU tensors, count no launch there,
and refuse what the kernels do not take.

Tolerances are those of tests/test_kernels_attention.py: 2e-5 in f32, where
only the order of the f32 sums differs, and 2e-2 in bf16, where the output
is rounded to bf16 (8 bits) and one ulp of a value near 1 is 2**-7.
Inputs are numpy normals, rounded to the dtype identically on both sides.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels import ref
from repro.kernels.decode_attention import decode_attention_pallas
from repro.kernels.flash_attention import flash_attention_pallas

from repro_torch.kernels.decode_attention import decode_attention_cuda, decode_attention_ref
from repro_torch.kernels.flash_attention import flash_attention_cuda, flash_attention_ref

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _inputs(seed, shapes, dtype):
    """Numpy normals as (jax arrays, torch tensors) of ``dtype``."""
    rng = np.random.default_rng(seed)
    jdt, tdt = DTYPES[dtype]
    xs = [rng.standard_normal(s, dtype=np.float32) for s in shapes]
    return [jnp.asarray(x).astype(jdt) for x in xs], [torch.from_numpy(x).to(tdt) for x in xs]


def _close(port, reference, tol):
    np.testing.assert_allclose(
        port.float().numpy(), np.asarray(reference.astype(jnp.float32)), atol=tol, rtol=tol
    )


# -----------------------------------------------------------------------------
# flash attention
# -----------------------------------------------------------------------------


@pytest.mark.parametrize("B,H,Hkv,S,D", [
    (1, 4, 4, 128, 32),    # MHA
    (2, 4, 2, 128, 64),    # GQA 2x
    (1, 8, 2, 256, 32),    # GQA 4x
    (2, 4, 2, 128, 16),    # the reduced configs' head width
    (1, 4, 4, 128, 112),   # zamba2-7b's head width, no GQA
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_matches_pallas_shapes_dtypes(B, H, Hkv, S, D, dtype):
    (jq, jk, jv), (q, k, v) = _inputs(0, [(B, H, S, D), (B, Hkv, S, D), (B, Hkv, S, D)], dtype)
    out = flash_attention_ref(q, k, v)
    assert out.dtype == q.dtype
    _close(out, flash_attention_pallas(jq, jk, jv, block_q=64, block_k=64), TOL[dtype])


@pytest.mark.parametrize("kw", [
    dict(causal=True),
    dict(causal=False),
    dict(causal=True, window=32),       # SWA (mixtral) / local (gemma2)
    dict(causal=True, window=64),
    dict(causal=True, softcap=50.0),    # gemma2 logit softcap
    dict(causal=True, window=32, softcap=50.0),
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_flash_plain_matches_pallas_masking_modes(kw):
    (jq, jk, jv), (q, k, v) = _inputs(1, [(2, 4, 128, 32), (2, 2, 128, 32), (2, 2, 128, 32)], "float32")
    _close(flash_attention_ref(q, k, v, **kw),
           flash_attention_pallas(jq, jk, jv, block_q=32, block_k=32, **kw), TOL["float32"])


def test_flash_plain_matches_pallas_kv_longer_than_q():
    """Chunked prefill: Skv > Sq with the causal offset."""
    (jq, jk, jv), (q, k, v) = _inputs(2, [(1, 2, 64, 32), (1, 2, 256, 32), (1, 2, 256, 32)], "float32")
    _close(flash_attention_ref(q, k, v),
           flash_attention_pallas(jq, jk, jv, block_q=32, block_k=64), TOL["float32"])


def test_flash_rows_that_see_nothing_give_zeros_as_the_pallas_kernel():
    """Skv < Sq, causal: the first Sq - Skv rows see no key.  The kernel's
    ``l == 0 -> 1`` rule gives zeros there (the jnp oracle would give the
    mean of v)."""
    (jq, jk, jv), (q, k, v) = _inputs(3, [(1, 4, 64, 32), (1, 2, 32, 32), (1, 2, 32, 32)], "float32")
    out = flash_attention_ref(q, k, v)
    _close(out, flash_attention_pallas(jq, jk, jv, block_q=32, block_k=32), TOL["float32"])
    assert torch.equal(out[:, :, :32], torch.zeros_like(out[:, :, :32]))
    assert out[:, :, 32:].abs().amax() > 0


@pytest.mark.parametrize("Sq,Skv,kw", [
    (37, 37, dict(causal=True)),
    (100, 100, dict(causal=True, window=16, softcap=50.0)),
    (45, 150, dict(causal=True)),
    (1, 77, dict(causal=True)),
    (77, 77, dict(causal=False)),
    (129, 129, dict(causal=True, window=100)),
], ids=lambda x: str(x) if not isinstance(x, dict) else "-".join(f"{k}={v}" for k, v in x.items()))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_matches_oracle_at_ragged_lengths(Sq, Skv, kw, dtype):
    """Prompt lengths that no block size divides: the reference dispatcher
    would leave its kernel for the jnp oracle here; the port's kernel takes
    them, so its plain version is held to that oracle."""
    (jq, jk, jv), (q, k, v) = _inputs(Sq * Skv, [(2, 8, Sq, 64), (2, 2, Skv, 64), (2, 2, Skv, 64)], dtype)
    _close(flash_attention_ref(q, k, v, **kw), ref.flash_attention_ref(jq, jk, jv, **kw), TOL[dtype])


@pytest.mark.parametrize("D,scale", [(32, 0.1), (8, None), (8, 0.1)],
                         ids=["scale-0.1", "width-8", "width-8-scale-0.1"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_matches_pallas_scale_and_width_8(D, scale, dtype):
    """An explicit softmax scale, and deepseek-67b's reduced head width 8,
    GQA 4 (8 heads over 2), causal and not."""
    (jq, jk, jv), (q, k, v) = _inputs(12, [(2, 8, 128, D), (2, 2, 128, D), (2, 2, 128, D)], dtype)
    for causal in (True, False):
        out = flash_attention_ref(q, k, v, causal=causal, scale=scale)
        _close(out, flash_attention_pallas(jq, jk, jv, causal=causal, scale=scale, block_q=64, block_k=64),
               TOL[dtype])
        assert torch.equal(flash_attention_cuda(q, k, v, causal=causal, scale=scale), out)


# -----------------------------------------------------------------------------
# decode attention
# -----------------------------------------------------------------------------


@pytest.mark.parametrize("B,H,Hkv,S,D", [
    (1, 4, 4, 256, 32),
    (3, 8, 2, 512, 64),
    (2, 8, 2, 256, 16),    # the reduced configs' head width
    (2, 4, 4, 256, 112),   # zamba2-7b's head width, no GQA
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_plain_matches_pallas_shapes_dtypes(B, H, Hkv, S, D, dtype):
    (jq, jk, jv), (q, k, v) = _inputs(4, [(B, H, D), (B, Hkv, S, D), (B, Hkv, S, D)], dtype)
    lengths = np.asarray([S] + [S // 3] * (B - 1), np.int32)[:B]
    out = decode_attention_ref(q, k, v, torch.from_numpy(lengths))
    assert out.dtype == q.dtype
    _close(out, decode_attention_pallas(jq, jk, jv, jnp.asarray(lengths), block_k=128), TOL[dtype])


def test_decode_plain_matches_pallas_length_one():
    """Fresh cache with a single valid entry."""
    (jq, jk, jv), (q, k, v) = _inputs(5, [(2, 4, 32), (2, 2, 128, 32), (2, 2, 128, 32)], "float32")
    lengths = np.asarray([1, 1], np.int32)
    _close(decode_attention_ref(q, k, v, torch.from_numpy(lengths)),
           decode_attention_pallas(jq, jk, jv, jnp.asarray(lengths), block_k=64), TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_plain_matches_pallas_ragged_lengths_and_softcap(dtype):
    """Lengths 0 (no visible key: zeros), ragged and full, with gemma2's
    softcap, in a cache whose size is no multiple of 128."""
    (jq, jk, jv), (q, k, v) = _inputs(6, [(3, 8, 64), (3, 4, 100, 64), (3, 4, 100, 64)], dtype)
    lengths = np.asarray([0, 37, 100], np.int32)
    out = decode_attention_ref(q, k, v, torch.from_numpy(lengths), softcap=50.0)
    _close(out, decode_attention_pallas(jq, jk, jv, jnp.asarray(lengths), softcap=50.0), TOL[dtype])
    assert torch.equal(out[0], torch.zeros_like(out[0]))


@pytest.mark.parametrize("D,scale", [(32, 0.1), (8, None), (8, 0.1)],
                         ids=["scale-0.1", "width-8", "width-8-scale-0.1"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_plain_matches_pallas_scale_and_width_8(D, scale, dtype):
    """An explicit softmax scale, and deepseek-67b's reduced head width 8,
    GQA 4, at ragged lengths with a softcap."""
    (jq, jk, jv), (q, k, v) = _inputs(13, [(3, 8, D), (3, 2, 256, D), (3, 2, 256, D)], dtype)
    lengths = np.asarray([256, 1, 100], np.int32)
    out = decode_attention_ref(q, k, v, torch.from_numpy(lengths), softcap=30.0, scale=scale)
    _close(out, decode_attention_pallas(jq, jk, jv, jnp.asarray(lengths), softcap=30.0, scale=scale,
                                        block_k=128), TOL[dtype])
    assert torch.equal(decode_attention_cuda(q, k, v, torch.from_numpy(lengths), softcap=30.0, scale=scale), out)


def test_decode_keeps_probabilities_in_f32_unlike_the_jnp_oracle():
    """In bf16 the port follows the Pallas kernel, which keeps p in f32 for
    the product with v; the reference's jnp oracle rounds p to bf16 first.
    The port is closer to the kernel than to the oracle."""
    (jq, jk, jv), (q, k, v) = _inputs(7, [(2, 8, 64), (2, 2, 512, 64), (2, 2, 512, 64)], "float32")
    jq, jk, jv = (x.astype(jnp.bfloat16) for x in (jq, jk, jv))
    q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    lengths = np.asarray([512, 300], np.int32)
    out = decode_attention_ref(q, k, v, torch.from_numpy(lengths)).float().numpy()
    # compare before the final bf16 rounding: run both in f32 on the bf16 values
    out32 = decode_attention_ref(q.float(), k.float(), v.float(), torch.from_numpy(lengths)).numpy()
    kernel = np.asarray(decode_attention_pallas(
        jq.astype(jnp.float32), jk.astype(jnp.float32), jv.astype(jnp.float32),
        jnp.asarray(lengths), block_k=128))
    oracle = np.asarray(ref.decode_attention_ref(jq, jk, jv, jnp.asarray(lengths)).astype(jnp.float32))
    np.testing.assert_allclose(out32, kernel, atol=2e-5, rtol=2e-5)
    assert np.abs(out - out32).max() <= np.abs(oracle - out32).max()


# -----------------------------------------------------------------------------
# the wrappers
# -----------------------------------------------------------------------------


def test_cpu_wrappers_take_the_plain_versions_and_count_no_launch():
    _, (q, k, v) = _inputs(8, [(1, 4, 33, 64), (1, 2, 33, 64), (1, 2, 33, 64)], "bfloat16")
    before = flash_attention_cuda.launches
    assert torch.equal(flash_attention_cuda(q, k, v, window=8, softcap=30.0),
                       flash_attention_ref(q, k, v, window=8, softcap=30.0))
    assert flash_attention_cuda.launches == before

    _, (qd, kc, vc) = _inputs(9, [(2, 4, 64), (2, 2, 40, 64), (2, 2, 40, 64)], "float32")
    lengths = torch.tensor([3, 40], dtype=torch.int32)
    before = decode_attention_cuda.launches
    assert torch.equal(decode_attention_cuda(qd, kc, vc, lengths, softcap=50.0),
                       decode_attention_ref(qd, kc, vc, lengths, softcap=50.0))
    assert decode_attention_cuda.launches == before


def _flash_args():
    _, (q, k, v) = _inputs(10, [(1, 4, 16, 64), (1, 2, 16, 64), (1, 2, 16, 64)], "float32")
    return q, k, v


@pytest.mark.parametrize("bad", [
    lambda q, k, v: (q.half(), k.half(), v.half(), {}),                     # dtype
    lambda q, k, v: (q, k.double(), v, {}),                                 # mixed dtypes
    lambda q, k, v: (q[:, :3].contiguous(), k, v, {}),                      # 3 heads over 2 kv heads
    lambda q, k, v: (q[..., :32].contiguous(), k, v, {}),                   # head widths differ
    lambda q, k, v: (q[0], k, v, {}),                                       # q of 3 dims
    lambda q, k, v: (q, k, v[:, :, :8].contiguous(), {}),                   # k and v differ
    lambda q, k, v: (q.transpose(2, 3).contiguous().transpose(2, 3), k, v, {}),  # not contiguous
    lambda q, k, v: (q, k, v, {"window": 0}),
    lambda q, k, v: (q, k, v, {"softcap": -1.0}),
    lambda q, k, v: tuple(t[..., :12].contiguous().to("meta") for t in (q, k, v)) + ({},),  # meta: the card's limits, D 12
], ids=["float16", "mixed", "heads", "width", "q3d", "kv", "strides", "window", "softcap", "meta"])
def test_flash_wrapper_refuses(bad):
    q, k, v, kw = bad(*_flash_args())
    with pytest.raises(ValueError):
        flash_attention_cuda(q, k, v, **kw)


@pytest.mark.parametrize("bad", [
    lambda q, k, v, n: (q.half(), k.half(), v.half(), n),
    lambda q, k, v, n: (q, k, v, n.long()),                       # lengths not int32
    lambda q, k, v, n: (q, k, v, n[:1].contiguous()),             # lengths not [B]
    lambda q, k, v, n: (q[:, :3].contiguous(), k, v, n),          # 3 heads over 2 kv heads
    lambda q, k, v, n: (q[:, :, None], k, v, n),                  # q of 4 dims
    lambda q, k, v, n: (q, k[:, :, :, :32].contiguous(), v, n),   # k and v differ
], ids=["float16", "lengths-dtype", "lengths-shape", "heads", "q4d", "kv"])
def test_decode_wrapper_refuses(bad):
    _, (q, k, v) = _inputs(11, [(2, 4, 64), (2, 2, 16, 64), (2, 2, 16, 64)], "float32")
    q, k, v, n = bad(q, k, v, torch.tensor([4, 16], dtype=torch.int32))
    with pytest.raises(ValueError):
        decode_attention_cuda(q, k, v, n)


# -----------------------------------------------------------------------------
# the state variant and the combine of shares
# -----------------------------------------------------------------------------


def _direct_softmax(q, k, v, lengths):
    """Decode attention and its log-denominator by a direct f32 softmax over
    each row's visible keys (f64 products, then f32)."""
    B, H, D = q.shape
    G = H // k.shape[1]
    o = torch.zeros(B, H, D)
    lse = torch.full((B, H), -1e30)
    for b in range(B):
        n = int(lengths[b])
        for h in range(H):
            if n == 0:
                continue
            s = (k[b, h // G, :n].double() @ q[b, h].double()) * D ** -0.5
            lse[b, h] = float(torch.logsumexp(s, 0))
            o[b, h] = (torch.softmax(s, 0) @ v[b, h // G, :n].double()).float()
    return o, lse


@pytest.mark.parametrize("H,Hkv,D", [(4, 2, 16), (16, 2, 128), (32, 8, 128)],
                         ids=["reduced", "qwen2.5-3b", "mixtral-8x7b"])
def test_decode_state_variant_is_a_direct_softmax(H, Hkv, D):
    """``decode_attention_state_ref`` / ``decode_attention_state_cuda`` on
    the CPU: the output equals ``decode_attention_ref``'s bit for bit, and
    both it and ``lse`` equal a direct f32 softmax over the visible keys; a
    row with none gives 0 and -1e30, and no launch is counted."""
    from repro_torch.kernels.decode_attention import decode_attention_state_cuda, decode_attention_state_ref

    _, (q, k, v) = _inputs(12, [(3, H, D), (3, Hkv, 40, D), (3, Hkv, 40, D)], "float32")
    lengths = torch.tensor([0, 17, 40], dtype=torch.int32)
    before = decode_attention_state_cuda.launches
    o, lse = decode_attention_state_cuda(q, k, v, lengths)
    assert decode_attention_state_cuda.launches == before
    o_ref, lse_ref = decode_attention_state_ref(q, k, v, lengths)
    assert torch.equal(o, o_ref) and torch.equal(lse, lse_ref)
    assert torch.equal(o, decode_attention_ref(q, k, v, lengths))
    o_dir, lse_dir = _direct_softmax(q, k, v, lengths)
    np.testing.assert_allclose(o.numpy(), o_dir.numpy(), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(lse.numpy(), lse_dir.numpy(), atol=1e-5, rtol=1e-5)
    assert lse.dtype == torch.float32 and bool((o[0] == 0).all()) and bool((lse[0] == -1e30).all())


class _StackedComm:
    """Every device's tensors at once, stacked on a leading axis: an
    all-reduce is the reduction over it."""

    def all_reduce(self, x, axes, op="sum"):
        y = x.amax(0, keepdim=True) if op == "max" else x.sum(0, keepdim=True)
        return y.expand_as(x)


@pytest.mark.parametrize("H,Hkv,D", [(4, 2, 16), (16, 2, 128)], ids=["reduced", "qwen2.5-3b"])
@pytest.mark.parametrize("n", [2, 4])
def test_the_combine_of_n_shares_is_the_whole(H, Hkv, D, n):
    """The keys split into ``n`` shares, each attended to by the state
    variant's plain version and combined by ``Program.decode_combine``:
    the whole cache's attention within 2e-6, with rows whose keys end in
    the first share (the later shares empty)."""
    from repro_torch.distributed.program import Program
    from repro_torch.kernels.decode_attention import decode_attention_state_ref

    S = 64
    _, (q, k, v) = _inputs(13, [(4, H, D), (4, Hkv, S, D), (4, Hkv, S, D)], "float32")
    lengths = torch.tensor([1, S // n - 1, S // 2 + 3, S], dtype=torch.int32)
    share = S // n
    parts = [decode_attention_state_ref(q, k[:, :, i * share:(i + 1) * share].contiguous(),
                                        v[:, :, i * share:(i + 1) * share].contiguous(),
                                        torch.clamp(lengths - i * share, 0, share).to(torch.int32))
             for i in range(n)]
    o = torch.stack([p[0] for p in parts])
    lse = torch.stack([p[1] for p in parts])
    holder = type("Holder", (), {"comm": _StackedComm(), "_head_seq_axes": staticmethod(lambda axes: ())})()
    got = Program.decode_combine(holder, o, lse, ("model",))
    want = decode_attention_ref(q, k, v, lengths)
    for i in range(n):
        np.testing.assert_allclose(got[i].numpy(), want.numpy(), atol=2e-6, rtol=2e-6)
