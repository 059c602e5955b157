"""The port's gradient compression (``distributed/compression.py``) against
the reference's ``repro/distributed/compression.py``, in process.

* The reference's three single-device tests (``tests/test_distributed.py``:
  the round trip's error bound, error feedback keeping the accumulated sum,
  a zero tensor), on the port.
* The int8 codes, the f32 scales and the pad equal the reference's bit for
  bit on seeded numpy inputs (several sizes, a block of zeros, bf16).
* The layers of one of the reference's stacked leaves are compressed as
  one array (its blocks span layers), bit for bit.
* One reduced qwen2.5-3b ``make_train_step`` with ``make_grad_compressor()``
  matches the reference's jitted step with its compressor: the loss,
  gradient norm and learning rate within rtol 1e-5, the parameters and
  moments within the tolerances of ``tests/test_torch_optim_data.py``'s
  train-step test (1e-5 + 0.05·lr, and 1e-5, plus 1e-4·max|x|).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from repro.distributed import compression as jc
from repro.optim import adamw as jadamw
from repro.train.train_step import make_train_step as jax_make_train_step

from repro_torch.distributed.compression import (
    ErrorFeedbackState,
    compress_roundtrip,
    dequantize,
    make_grad_compressor,
    quantize,
)
from repro_torch.models.convert import named_arrays
from repro_torch.optim import adamw
from repro_torch.train.train_step import make_train_step
from torch_train_common import batch_of, close, jax_batch, setup, torch_batch


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_quantize_roundtrip_error_bound():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(1000).astype(np.float32)) * 3.0
    codes, scale, pad = quantize(x)
    assert codes.dtype == torch.int8
    xr = dequantize(codes, scale, pad, x.shape, x.dtype)
    err = (x - xr).abs()
    assert float(err.max()) <= float(scale.max()) / 2 + 1e-7  # per-block max error <= scale / 2


def test_error_feedback_preserves_sum():
    ef = ErrorFeedbackState()
    rng = np.random.default_rng(1)
    total_true = np.zeros(64, np.float32)
    total_comp = np.zeros(64, np.float32)
    for _ in range(50):
        g = rng.standard_normal(64).astype(np.float32) * 0.01
        total_true += g
        out = ef({"g": torch.from_numpy(g)})
        total_comp += out["g"].numpy()
    resid = ef.residual["g"].numpy()
    np.testing.assert_allclose(total_comp + resid, total_true, atol=1e-5)
    assert np.abs(resid).max() < 0.01


def test_zero_tensor_roundtrip():
    xr, err = compress_roundtrip(torch.zeros(300))
    assert not xr.any() and not err.any()


@pytest.mark.parametrize("n,dtype", [(1000, "float32"), (256, "float32"), (7, "float32"), (4096, "bfloat16"),
                                     (513, "float32")])
def test_codes_and_scales_equal_the_reference_bit_for_bit(n, dtype):
    rng = np.random.default_rng(n)
    x = (rng.standard_normal(n) * rng.choice([1e-3, 1.0, 30.0], n)).astype(np.float32)
    if n >= 512:
        x[:256] = 0.0  # a block of zeros: scale 1
    t = torch.from_numpy(x).to(getattr(torch, dtype))
    j = jnp.asarray(x).astype(getattr(jnp, dtype))
    codes, scale, pad = quantize(t)
    jcodes, jscale, jpad = jc.quantize(j)
    assert pad == jpad
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    np.testing.assert_array_equal(scale.numpy().view(np.int32), np.asarray(jscale).view(np.int32))
    back = dequantize(codes, scale, pad, t.shape, t.dtype)
    jback = jc.dequantize(jcodes, jscale, jpad, j.shape, j.dtype)
    np.testing.assert_array_equal(back.float().numpy(), np.asarray(jback.astype(jnp.float32)))


def test_a_compressed_train_step_matches_the_reference():
    japi, api, cfg, tree, params = setup("qwen2.5-3b")
    kw = dict(lr=3e-3, warmup_steps=1, total_steps=10, grad_clip=0.5)
    opt_cfg, jcfg = adamw.AdamWConfig(**kw), jadamw.AdamWConfig(**kw)
    step = make_train_step(api, cfg, opt_cfg, grad_compressor=make_grad_compressor())
    jstep = jax.jit(jax_make_train_step(japi, cfg, jcfg, grad_compressor=jc.make_grad_compressor()))
    state, jstate = adamw.init(opt_cfg, params), jadamw.init(jcfg, tree)
    batch = batch_of(cfg, seed=10)
    params, state, metrics = step(params, state, torch_batch(batch))
    tree, jstate, jmetrics = jstep(tree, jstate, jax_batch(batch))
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), rtol=1e-5, err_msg=k)
    lr = float(jmetrics["lr"])
    ref = {"params": named_arrays(tree, cfg), "m": named_arrays(jstate["m"], cfg), "v": named_arrays(jstate["v"], cfg)}
    port = {"params": dict(params.named_parameters()), "m": state["m"], "v": state["v"]}
    for part, want in ref.items():
        moved = 0.05 * lr if part == "params" else 0.0
        for k in want:
            close(port[part][k], want[k], 1e-5 + moved, 1e-4, f"{part} {k}")


def test_a_stacked_leaf_is_compressed_as_one():
    """The layers of one reference leaf share their blocks: a block of 256
    spans layers as in the reference's stacked array."""
    rng = np.random.default_rng(3)
    layers = [rng.standard_normal(96).astype(np.float32) * (1 + 10 * i) for i in range(3)]
    grads = {f"blocks.0.{i}.attn.k.b": torch.from_numpy(a) for i, a in enumerate(layers)}
    grads["embed.tok"] = torch.from_numpy(rng.standard_normal(300).astype(np.float32))
    out = make_grad_compressor()(grads)
    stacked = jc.compress_roundtrip(jnp.asarray(np.stack(layers)))[0]
    for i in range(3):
        np.testing.assert_array_equal(out[f"blocks.0.{i}.attn.k.b"].numpy(), np.asarray(stacked[i]))
    np.testing.assert_array_equal(out["embed.tok"].numpy(),
                                  np.asarray(jc.compress_roundtrip(jnp.asarray(grads["embed.tok"].numpy()))[0]))
