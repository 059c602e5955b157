"""The port's sampling (``serve/sampling.py``) and int8 KV storage
(``serve/kvcache.py``) against the JAX package's.

``repro.serve.sampling`` imports in process.  Its masks are read from the
reference itself: ``jax.random.categorical`` is replaced, for one call, by
a function that keeps the logits it is handed and returns their argmax.
The draws cannot be the reference's (``torch.Generator`` against
``jax.random``), so they are held to the distribution: inside the mask
always, and 2,000 draws of one row against the masked softmax by a
chi-square test at the 0.001 level.  ``repro.serve.kvcache`` reaches
``repro.core``, so its functions run in the child process of
``tests/torch_reference.py`` (job ``kvcache``); the int8 codes, scales and
dequantized values must equal the reference's bit for bit, since both round
half to even.  The decode-attention error of a dequantized cache keeps the
reference's bound of 0.05 (tests/test_kvcache_elastic.py).
"""

import json

import numpy as np
import pytest
import torch
from scipy import stats

import jax
import jax.numpy as jnp
from repro.serve import sampling as jsampling

from repro_torch.kernels.decode_attention import decode_attention_ref
from repro_torch.models.registry import get_model
from repro_torch.serve.kvcache import cache_bytes_report, dequantize_kv, quantize_kv
from repro_torch.serve.sampling import SamplingConfig, mask_logits, sample

import torch_reference as ref_harness

B, V = 8, 256
CONFIGS = {
    "temperature": SamplingConfig(temperature=0.7),
    "top_k": SamplingConfig(temperature=1.0, top_k=5),
    "top_p": SamplingConfig(temperature=1.0, top_p=0.9),
    "top_k_top_p": SamplingConfig(temperature=0.8, top_k=20, top_p=0.7),
    "top_k_whole_vocab": SamplingConfig(temperature=1.0, top_k=V),
    "top_p_tiny": SamplingConfig(temperature=1.0, top_p=1e-6),
}
REPORTS = [["qwen2.5-3b", 128, 32768], ["mixtral-8x7b", 4, 2048], ["internvl2-76b", 2, 4096],
           ["whisper-base", 8, 448]]


def _logits(seed=0, ties=True) -> np.ndarray:
    """Seeded ``[8, 256]`` logits; with ``ties``, rows 0-3 hold their 3rd to
    7th largest values equal to the 5th (a tie across the k-th of top-5)."""
    x = (np.random.default_rng(seed).standard_normal((B, V)) * 3).astype(np.float32)
    if ties:
        for r in range(4):
            order = np.argsort(-x[r])
            x[r, order[2:7]] = x[r, order[4]]
    return x


def _reference_masked(logits: np.ndarray, cfg: SamplingConfig, monkeypatch) -> np.ndarray:
    """The logits the reference's ``sample`` hands to
    ``jax.random.categorical``."""
    seen = []

    def keep(key, lg, axis=-1):
        seen.append(np.asarray(lg))
        return jnp.argmax(lg, axis=axis)

    with monkeypatch.context() as m:
        m.setattr(jax.random, "categorical", keep)
        jsampling.sample(jnp.asarray(logits), jax.random.PRNGKey(0),
                         jsampling.SamplingConfig(cfg.temperature, cfg.top_k, cfg.top_p))
    (masked,) = seen
    return masked


def test_greedy_equals_the_reference_and_argmax():
    logits = _logits()
    out = sample(torch.from_numpy(logits), torch.Generator().manual_seed(0))
    ref = jsampling.sample(jnp.asarray(logits), jax.random.PRNGKey(0), jsampling.SamplingConfig())
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(out.numpy(), logits.argmax(-1))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_masks_equal_the_reference(name, monkeypatch):
    """The masked logits, ``-inf`` and kept values alike, bit for bit, on
    rows with planted ties at the k-th value (kept by ``logits < kth``)."""
    cfg = CONFIGS[name]
    logits = _logits()
    masked = mask_logits(torch.from_numpy(logits), cfg).numpy()
    np.testing.assert_array_equal(masked, _reference_masked(logits, cfg, monkeypatch))
    kept = np.isfinite(masked).sum(-1)
    assert (kept >= 1).all()
    if name == "top_k":
        assert (kept[:4] == 7).all() and (kept[4:] == 5).all()  # the tied rows keep every tie


@pytest.mark.parametrize("name", list(CONFIGS))
def test_draws_stay_inside_the_mask(name):
    cfg = CONFIGS[name]
    logits = torch.from_numpy(_logits(1))
    masked = mask_logits(logits, cfg)
    gen = torch.Generator().manual_seed(5)
    for _ in range(25):
        tok = sample(logits, gen, cfg)
        assert tok.dtype == torch.int32
        assert torch.isfinite(masked[torch.arange(B), tok.long()]).all()


def test_draw_frequencies_follow_the_masked_softmax():
    """2,000 draws of one row (temperature 0.8, top-k 12, top-p 0.9) against
    the masked softmax: chi-square p above 0.001."""
    cfg = SamplingConfig(temperature=0.8, top_k=12, top_p=0.9)
    row = torch.from_numpy(_logits(2, ties=False)[:1])
    probs = torch.softmax(mask_logits(row, cfg)[0], -1).numpy()
    draws = sample(row.expand(2000, V), torch.Generator().manual_seed(11), cfg).numpy()
    kept = np.flatnonzero(probs > 0)
    assert set(draws) <= set(kept.tolist())
    observed = np.bincount(draws, minlength=V)[kept]
    expected = probs[kept].astype(np.float64)
    _, p = stats.chisquare(observed, expected / expected.sum() * observed.sum())
    assert p > 1e-3, p


@pytest.fixture(scope="module")
def kv_reference():
    rng = np.random.default_rng(0)
    inputs = {"normal": rng.standard_normal((2, 3, 40, 32)).astype(np.float32) * 3,
              "zeros_and_ties": np.concatenate([np.zeros((1, 2, 8, 16), np.float32),
                                                np.full((1, 2, 8, 16), 0.5, np.float32)]),
              "halves": (rng.integers(-254, 255, (2, 2, 16, 8)) / 2).astype(np.float32)}
    inputs["halves"][..., 0] = 127.0  # scale 1: codes land on .5 exactly, rounded half to even
    out = ref_harness.run("kvcache", {"reports": REPORTS}, inputs)
    return inputs, out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_and_dequantize_equal_the_reference(kv_reference, dtype):
    inputs, out = kv_reference
    for name, x in inputs.items():
        codes, scale = quantize_kv(torch.from_numpy(x).to(getattr(torch, dtype)))
        assert codes.dtype == torch.int8 and scale.dtype == torch.float32
        np.testing.assert_array_equal(codes.numpy(), out[f"{name}/{dtype}/codes"])
        np.testing.assert_array_equal(scale.numpy(), out[f"{name}/{dtype}/scale"])
        for back in ("float32", "bfloat16"):
            deq = dequantize_kv(codes, scale, getattr(torch, back))
            assert deq.dtype == getattr(torch, back)
            np.testing.assert_array_equal(deq.float().numpy(), out[f"{name}/{dtype}/back/{back}"])


def test_cache_bytes_report_equals_the_reference(kv_reference):
    _, out = kv_reference
    for arch, batch, seq in REPORTS:
        report = cache_bytes_report(get_model(arch).config, batch, seq)
        assert json.dumps(report, sort_keys=True) == str(out[f"report/{arch}/{batch}/{seq}"])


def test_int8_cache_keeps_decode_attention_close():
    """The reference's tests/test_kvcache_elastic.py on the port: decode
    attention over the dequantized cache within 0.05 of the original, and
    the round trip within half a scale step."""
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in [(2, 4, 32), (2, 2, 128, 32), (2, 2, 128, 32)])
    lengths = torch.full((2,), 128, dtype=torch.int32)
    kq, ks = quantize_kv(k)
    vq, vs = quantize_kv(v)
    out_q = decode_attention_ref(q, dequantize_kv(kq, ks, torch.float32), dequantize_kv(vq, vs, torch.float32),
                                 lengths)
    err = float((decode_attention_ref(q, k, v, lengths) - out_q).abs().max())
    assert err < 0.05, err
    back = dequantize_kv(kq, ks, torch.float32)
    assert float((k - back).abs().max()) <= float(ks.max()) / 2 + 1e-6
