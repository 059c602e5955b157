"""The arithmetic of the Hopper attention kernels, written out in plain
PyTorch, against the port's plain versions and the JAX package.

The CUDA kernels run only on the card (``chip_smoke.py`` holds them to the
plain versions there).  What can be held here is each design's arithmetic:

* the bf16 flash kernel's tensor-core numerics: 64 x 64 tiles, logits as
  f32 sums of exact bf16 products scaled after the product, an online
  softmax in f32, and ``O += p_hi V + p_lo V`` with ``p_hi = bf16(p)``,
  ``p_lo = bf16(p - p_hi)``.  Held to ``flash_attention_ref`` run in f32
  within 2e-5 + 2**-8 |y| (the bound ``chip_smoke.py`` puts on the kernel:
  the f32 summation-order slack plus half a bf16 step at y), and to the
  Pallas kernel in interpret mode within the bf16 tolerance of
  tests/test_torch_attention.py.  A head width D under the kernel's padded
  width DP (64, 128, 192, 256) reaches shared memory with the columns D..DP
  zero (TMA's fill), both products run over DP and the store keeps D
  columns; the logits stay scaled by ``D**-0.5``;
* the split-KV decode kernel's plan (:func:`decode_split_plan`, which the
  wrapper calls) and its split-then-combine arithmetic, held to
  ``decode_attention_ref`` within 2e-6 (f32 summation order), also with
  the rows of q and k zero-padded to DP as the kernel holds them.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels.flash_attention import flash_attention_pallas

from repro_torch.kernels.decode_attention import (
    SPLIT_RANGE,
    check_decode_launch,
    decode_attention_cuda,
    decode_attention_ref,
    decode_split_plan,
)
from repro_torch.kernels.flash_attention import attention_mask, flash_attention_ref

TILE = 64  # query rows and keys per tile of the wgmma kernel


@pytest.fixture(autouse=True, scope="module")
def _pinned_f32_arithmetic():
    """The bounds below are a few f32 ulps wide, so the module runs its
    plain f32 arithmetic on the test's own thread, with no intra-op thread
    team (in a run of six pytest workers side by side the qwen case once
    came out 7e-5 off; alone, at 1 to 8 threads, it never did), at full
    f32 matmul precision, and restores both after."""
    threads, precision = torch.get_num_threads(), torch.get_float32_matmul_precision()
    torch.set_num_threads(1)
    torch.set_float32_matmul_precision("highest")
    yield
    torch.set_num_threads(threads)
    torch.set_float32_matmul_precision(precision)


def _bf16(seed, shapes):
    """Numpy normals rounded to bf16 (torch), and the same values for JAX."""
    rng = np.random.default_rng(seed)
    xs = [torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).to(torch.bfloat16) for s in shapes]
    return xs, [jnp.asarray(x.float().numpy()).astype(jnp.bfloat16) for x in xs]


def padded_width(D: int) -> int:
    """The width the kernels are built for that holds head width D."""
    return -(-D // 64) * 64


def zero_pad(x: torch.Tensor) -> torch.Tensor:
    """Rows of D columns as the kernels hold them: DP columns, zeros past D."""
    return torch.nn.functional.pad(x, (0, padded_width(x.shape[-1]) - x.shape[-1]))


def tensor_core_flash(q, k, v, *, causal=True, window=None, softcap=None):
    """The wgmma kernel's arithmetic on bf16 q [B, H, Sq, D], k, v [B, Hkv,
    Skv, D]; returns the f32 result before its rounding to bf16.  The
    products run over the padded width, the store keeps D columns."""
    D = q.shape[-1]
    q, k, v = zero_pad(q), zero_pad(k), zero_pad(v)
    B, H, Sq, DP = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    idx = torch.arange(H) // (H // Hkv)
    qf, kf, vf = q.float(), k.float()[:, idx], v.float()[:, idx]
    mask = attention_mask(Sq, Skv, causal=causal, window=window)
    out = torch.zeros(B, H, Sq, DP)
    for q0 in range(0, Sq, TILE):
        rows = slice(q0, q0 + TILE)
        m = torch.full((B, H, qf[:, :, rows].shape[2], 1), -1e30)
        l = torch.zeros_like(m)
        acc = torch.zeros(B, H, m.shape[2], DP)
        for c0 in range(0, Skv, TILE):
            cols = slice(c0, c0 + TILE)
            vis = mask[rows, cols]
            if not vis.any():  # the kernel skips fully masked tiles
                continue
            s = (qf[:, :, rows] @ kf[:, :, cols].transpose(-1, -2)) * D**-0.5  # scale after the product
            if softcap is not None:
                s = softcap * torch.tanh(s / softcap)
            s = torch.where(vis, s, -torch.inf)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            corr = torch.exp(m - m_new)
            p = torch.exp(s - m_new)
            p_hi = p.to(torch.bfloat16).float()
            p_lo = (p - p_hi).to(torch.bfloat16).float()
            l = corr * l + p.sum(-1, keepdim=True)
            acc = corr * acc + p_hi @ vf[:, :, cols] + p_lo @ vf[:, :, cols]
            m = m_new
        out[:, :, rows] = acc / torch.where(l == 0, 1.0, l)
    return out[..., :D]


FLASH_CASES = {
    # qwen2.5-3b's heads at its longest serving prompt
    "qwen S=891": ((1, 16, 2, 891, 891, 128), {}),
    # gemma2-2b's head width with a window and its softcap, cut to size
    "gemma2-like S=300 window 100 softcap 50": ((1, 4, 2, 300, 300, 256), dict(window=100, softcap=50.0)),
    # a chunked prefill: keys before the query rows
    "chunk Sq=100 Skv=356": ((2, 4, 2, 100, 356, 64), {}),
    # zamba2-7b's shared attention at its longest serving prompt: D 112 of DP 128
    "zamba2 S=891 D=112": ((1, 32, 32, 891, 891, 112), {}),
    # the reduced configs' head width: D 16 of DP 64
    "reduced S=77 D=16 window 20 softcap 30": ((2, 4, 2, 77, 77, 16), dict(window=20, softcap=30.0)),
}


@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_tensor_core_numerics_meet_the_kernels_bound(case):
    (B, H, Hkv, Sq, Skv, D), kw = FLASH_CASES[case]
    (q, k, v), _ = _bf16(len(case), [(B, H, Sq, D), (B, Hkv, Skv, D), (B, Hkv, Skv, D)])
    y32 = flash_attention_ref(q.float(), k.float(), v.float(), **kw)
    pre = tensor_core_flash(q, k, v, **kw)
    # before the output's rounding: the f32 slack alone
    torch.testing.assert_close(pre, y32, atol=2e-5, rtol=2e-6)
    # the bf16 output, as chip_smoke.py holds the kernel's
    torch.testing.assert_close(pre.to(torch.bfloat16).float(), y32, atol=2e-5, rtol=2**-8)


def test_rounding_p_to_bf16_alone_would_miss_the_bound():
    """Why the kernel splits p: one bf16 P costs up to 2**-9 relative per
    probability, which the bound cannot absorb."""
    (q, k, v), _ = _bf16(5, [(1, 16, 891, 128), (1, 2, 891, 128), (1, 2, 891, 128)])
    y32 = flash_attention_ref(q.float(), k.float(), v.float())
    idx = torch.arange(16) // 8
    s = (q.float() @ k.float()[:, idx].transpose(-1, -2)) * 128**-0.5
    s = torch.where(attention_mask(891, 891, causal=True, window=None), s, -torch.inf)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    single = (p.to(torch.bfloat16).float() @ v.float()[:, idx]) / p.sum(-1, keepdim=True)
    split_err = (tensor_core_flash(q, k, v) - y32).abs().max()
    assert (single - y32).abs().max() > 2e-5 > split_err


@pytest.mark.parametrize("case", [
    ((1, 16, 2, 256, 128), {}),                                   # qwen's heads
    ((1, 4, 2, 256, 256), dict(window=100, softcap=50.0)),        # gemma2-like
    ((1, 4, 4, 256, 112), {}),                                    # zamba2's head width
    ((2, 4, 2, 128, 16), {}),                                     # the reduced head width
], ids=["qwen-heads-S256", "gemma2-like-window-softcap", "zamba2-width-112", "reduced-width-16"])
def test_tensor_core_numerics_match_the_pallas_kernel(case):
    (B, H, Hkv, S, D), kw = case
    (q, k, v), (jq, jk, jv) = _bf16(S + D, [(B, H, S, D), (B, Hkv, S, D), (B, Hkv, S, D)])
    pallas = flash_attention_pallas(jq, jk, jv, block_q=128, block_k=128, **kw)
    np.testing.assert_allclose(tensor_core_flash(q, k, v, **kw).to(torch.bfloat16).float().numpy(),
                               np.asarray(pallas.astype(jnp.float32)), atol=2e-2, rtol=2e-2)


# -----------------------------------------------------------------------------
# split-KV decode
# -----------------------------------------------------------------------------


@pytest.mark.parametrize("S", [0, 1, 63, 64, 65, 2048, 4096])
@pytest.mark.parametrize("sm_count", [1, 8, 132])
def test_split_plan_covers_every_key_once(S, sm_count):
    for Hkv in (1, 2, 8, 32):
        splits, chunk = decode_split_plan(Hkv, S, sm_count)
        assert splits >= 1 and chunk >= SPLIT_RANGE and chunk % SPLIT_RANGE == 0
        seen = torch.zeros(S, dtype=torch.int32)
        for i in range(splits):
            seen[i * chunk: (i + 1) * chunk] += 1
        assert bool((seen == 1).all()), (Hkv, S, splits, chunk)
        assert (splits - 1) * chunk < max(S, 1)  # no split lies wholly past the cache


def test_split_plan_fills_the_card_at_the_serving_shape():
    """qwen2.5-3b's 2048-key cache on 132 SMs: 32 splits of 64 keys, 64
    blocks a slot (256 at 4 slots); at the lockstep length 892, 14 live
    ranges per (kv head, sequence), 112 blocks doing work at 4 slots (the
    old kernel ran 8)."""
    splits, chunk = decode_split_plan(2, 2048, 132)
    assert (splits, chunk) == (32, 64)
    assert -(-892 // chunk) * 2 * 4 == 112


def split_then_combine(q, k, v, lengths, *, softcap=None, sm_count=132, pad=False):
    """The split kernel's partial states over the plan's ranges and the
    combine kernel's fold, in f32; returns the result before its rounding.
    ``pad``: the logits over rows of q and k zero-padded to the kernel's
    width DP, as its shared memory holds them."""
    B, H, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    G = H // Hkv
    splits, chunk = decode_split_plan(Hkv, S, sm_count)
    qs = (q.float() * D**-0.5).reshape(B, Hkv, G, D)
    if pad:
        qs, k = zero_pad(qs), zero_pad(k)
    out = torch.zeros(B, Hkv, G, D)
    for b in range(B):
        n = min(max(int(lengths[b]), 0), S)
        parts = []  # (m [Hkv, G], l [Hkv, G], acc [Hkv, G, D]) of the live splits
        for i in range(splits):
            lo, hi = i * chunk, min((i + 1) * chunk, n)
            if lo >= hi:
                continue  # the block exits; the combine reads the first ceil(n / chunk) splits
            s = torch.einsum("hgd,hkd->hgk", qs[b], k[b, :, lo:hi].float())
            if softcap is not None:
                s = softcap * torch.tanh(s / softcap)
            m = s.amax(-1)
            p = torch.exp(s - m[..., None])
            parts.append((m, p.sum(-1), torch.einsum("hgk,hkd->hgd", p, v[b, :, lo:hi].float())))
        if not parts:
            continue
        M = torch.stack([m for m, _, _ in parts]).amax(0)
        num = sum(torch.exp(m - M)[..., None] * acc for m, _, acc in parts)
        den = sum(torch.exp(m - M) * l for m, l, _ in parts)
        out[b] = num / torch.where(den == 0, 1.0, den)[..., None]
    return out.reshape(B, H, D)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("softcap", [None, 50.0], ids=["plain", "softcap"])
@pytest.mark.parametrize("sm_count", [132, 2], ids=["chunk64", "chunk1024"])
def test_split_then_combine_equals_the_plain_version(dtype, softcap, sm_count):
    S = 2048
    rng = np.random.default_rng(int(sm_count + (softcap or 0)))
    q, k, v = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).to(dtype)
               for s in [(6, 16, 128), (6, 2, S, 128), (6, 2, S, 128)])
    lengths = torch.tensor([0, 1, 63, 64, 517, S], dtype=torch.int32)
    out = split_then_combine(q, k, v, lengths, softcap=softcap, sm_count=sm_count)
    ref = decode_attention_ref(q.float(), k.float(), v.float(), lengths, softcap=softcap)
    torch.testing.assert_close(out, ref, atol=2e-6, rtol=2e-6)
    assert torch.equal(out[0], torch.zeros_like(out[0]))  # no visible key gives zeros


@pytest.mark.parametrize("H,Hkv,S,D,softcap", [
    (8, 8, 892, 112, None), (2, 1, 4096, 256, 50.0), (16, 2, 892, 128, None), (8, 2, 2048, 128, None),
    (2, 2, 1500, 64, None)], ids=["zamba2-share-892", "gemma2-share-4096", "qwen2.5-3b-892", "mixtral-share-2048",
                                  "whisper-cross-share-1500"])
def test_a_row_decodes_to_the_same_bits_alone_and_in_a_batch(H, Hkv, S, D, softcap):
    """Row 0 of a batch of 4 and of 13 is, bit for bit, the same sequence
    decoded alone: the split kernel sums a row's keys over ranges that the
    batch does not choose.  zamba2-7b's card share (8 kv heads of one query
    each) at the serving run's 892 keys, gemma2-2b's (a group of 2 over one
    kv head, softcapped) at 4,096, qwen2.5-3b whole at 892, mixtral-8x7b's
    card share at 2,048 and whisper-base's cross-attention share over 1,500
    frames."""
    rng = np.random.default_rng(S + D)
    B = 13
    q, k, v = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
               for s in [(B, H, D), (B, Hkv, S, D), (B, Hkv, S, D)])
    lengths = torch.full((B,), S, dtype=torch.int32)
    alone = split_then_combine(q[:1], k[:1], v[:1], lengths[:1], softcap=softcap)
    for n in (4, B):
        assert torch.equal(split_then_combine(q[:n], k[:n], v[:n], lengths[:n], softcap=softcap)[0], alone[0]), n


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("H,Hkv,D", [(32, 32, 112), (8, 2, 16)], ids=["zamba2-width-112", "width-16"])
def test_split_then_combine_at_padded_widths(H, Hkv, D, dtype):
    """Rows of q and k padded with zeros to DP (128 at D 112, 64 at D 16)
    give the plain version's logits; zamba2's 32 kv heads of one query each
    at 4 slots, and a GQA group at the reduced width."""
    S = 2048
    rng = np.random.default_rng(D)
    q, k, v = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).to(dtype)
               for s in [(4, H, D), (4, Hkv, S, D), (4, Hkv, S, D)])
    lengths = torch.tensor([892, 1, 517, S], dtype=torch.int32)
    out = split_then_combine(q, k, v, lengths, pad=True)
    ref = decode_attention_ref(q.float(), k.float(), v.float(), lengths)
    torch.testing.assert_close(out, ref, atol=2e-6, rtol=2e-6)


@pytest.mark.parametrize("B,Hkv,D", [(2, 2, 124), (2, 2, 4), (2, 2, 264), (65536, 1, 128), (1, 65536, 64)],
                         ids=["width-124", "width-4", "width-264", "batch", "kv-heads"])
def test_decode_launch_check_refuses(B, Hkv, D):
    """Head widths that are no multiple of 8 (a bf16 row of 16-byte units)
    or past 256, and grids past the launch limits."""
    with pytest.raises(ValueError):
        check_decode_launch(B, Hkv, D)


@pytest.mark.parametrize("D", [64, 128, 256, 16, 112, 8, 120, 24])
def test_decode_launch_check_takes_the_built_widths(D):
    check_decode_launch(4, 2, D)
    check_decode_launch(65535, 65535, D)


def test_cpu_decode_wrapper_takes_widths_the_kernel_does_not():
    """On the CPU the wrapper runs the plain version at any width (here
    36, no multiple of 8); the kernel's own limits apply on the card only."""
    rng = np.random.default_rng(12)
    q, k, v = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
               for s in [(2, 4, 36), (2, 2, 40, 36), (2, 2, 40, 36)])
    lengths = torch.tensor([3, 40], dtype=torch.int32)
    assert torch.equal(decode_attention_cuda(q, k, v, lengths), decode_attention_ref(q, k, v, lengths))
