"""AdamW, the loss, the data stream, microbatches, whole train steps and
evaluation against the JAX package's, in process (``repro.optim``,
``repro.train`` and ``repro.data`` do not reach ``repro.core``).

Tolerances:

* AdamW ``update`` and ``lr_at`` on the same inputs within 1e-6 of the
  largest value (XLA on the CPU fuses multiply-adds; PyTorch does not);
  bf16 parameters within one bf16 ulp (the f32 result before the cast may
  differ in its last bit);
* the loss and its metrics on the same logits within rtol 1e-6;
* the stream's tokens equal bit for bit;
* whole train steps on the reduced models: the loss, gradient norm and
  learning rate within rtol 1e-5, each moment within 1e-5 + 1e-4·max|x|,
  each parameter within that plus 5% of the distance the steps' learning
  rates can move it: AdamW divides each gradient element by its own
  running magnitude, so an element whose gradient is near zero turns the
  frameworks' f32 rounding of it into a share of a step (measured: at
  most 1.5%, gemma2-2b); ``microbatches=2`` against 1 at the reference's
  own rtol 2e-4 / atol 2e-5.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.data import pipeline as jpipeline
from repro.models.registry import get_model as jax_get_model
from repro.optim import adamw as jadamw
from repro.train.evaluate import evaluate as jax_evaluate
from repro.train.losses import next_token_loss as jax_next_token_loss
from repro.train.train_step import make_train_step as jax_make_train_step

from repro_torch.data.pipeline import DataConfig, Prefetcher, SyntheticLMStream
from repro_torch.models import layers as L
from repro_torch.models.convert import named_arrays, params_from_arrays
from repro_torch.models.registry import get_model
from repro_torch.optim import adamw
from repro_torch.train.evaluate import evaluate
from repro_torch.train.losses import next_token_loss
from repro_torch.train.train_step import make_train_step
from torch_train_common import S, batch_of, close, jax_batch, setup, torch_batch


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small ops; with the several pytest workers a test run starts
    side by side, each op's intra-op thread team waits on the others'."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -----------------------------------------------------------------------------
# AdamW
# -----------------------------------------------------------------------------

SHAPES = {"embed.tok": (6, 4), "blocks.0.1.attn.q.w": (4, 3), "blocks.0.0.attn.q.w": (4, 3), "ln.scale": (5,)}


def _near(port, reference, rel: float = 1e-6) -> None:
    p, r = np.asarray(port, np.float64), np.asarray(reference, np.float64)
    assert np.abs(p - r).max() <= rel * np.abs(r).max(), (np.abs(p - r).max(), np.abs(r).max())


@pytest.mark.parametrize("schedule,master,dtype", [("cosine", False, "float32"), ("linear", True, "float32"),
                                                   ("constant", False, "float32"), ("cosine", False, "bfloat16"),
                                                   ("cosine", True, "bfloat16")])
def test_adamw_update_matches_the_reference(schedule, master, dtype):
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=6, schedule=schedule, master_weights=master, grad_clip=3.0)
    cfg, jcfg = adamw.AdamWConfig(**kw), jadamw.AdamWConfig(**kw)
    rng = np.random.default_rng(0)
    init = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
    # copies: the port updates in place, and jnp.asarray may alias a numpy buffer
    params = {k: torch.tensor(v).to(L.torch_dtype(dtype)) for k, v in init.items()}
    jparams = {k: jnp.asarray(v).astype(dtype) for k, v in init.items()}
    state, jstate = adamw.init(cfg, params), jadamw.init(jcfg, jparams)
    for _ in range(7):  # past the schedule's end; the clip binds on some steps
        grads = {k: (rng.standard_normal(s) * rng.choice([0.3, 3.0])).astype(np.float32) for k, s in SHAPES.items()}
        params, state, metrics = adamw.update(cfg, {k: torch.from_numpy(g) for k, g in grads.items()}, state, params)
        jparams, jstate, jmetrics = jadamw.update(jcfg, {k: jnp.asarray(g) for k, g in grads.items()}, jstate,
                                                  jparams)
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), rtol=1e-6, atol=1e-12, err_msg=k)
        for k in SHAPES:
            assert params[k].dtype == L.torch_dtype(dtype)
            _near(state["m"][k].numpy(), np.asarray(jstate["m"][k]))
            _near(state["v"][k].numpy(), np.asarray(jstate["v"][k]))
            ref = np.asarray(jparams[k].astype(jnp.float32))
            _near(params[k].float().numpy(), ref, 1e-6 if dtype == "float32" else 2**-8)
            if master:
                _near(state["master"][k].numpy(), np.asarray(jstate["master"][k]))
    assert int(state["step"]) == int(jstate["step"]) == 7


@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_lr_schedule_matches_the_reference(schedule):
    kw = dict(lr=0.3, warmup_steps=10, total_steps=100, schedule=schedule)
    cfg, jcfg = adamw.AdamWConfig(**kw), jadamw.AdamWConfig(**kw)
    for s in (0, 1, 5, 10, 11, 55, 99, 100, 150):
        np.testing.assert_allclose(float(adamw.lr_at(cfg, torch.tensor(s))),
                                   float(jadamw.lr_at(jcfg, jnp.asarray(s))), rtol=1e-6, atol=1e-12)


def test_grad_clipping_applied():
    """The reference's own check: the clip's norm is the unclipped one."""
    cfg = adamw.AdamWConfig(lr=1.0, grad_clip=1.0, warmup_steps=0, weight_decay=0.0, schedule="constant")
    params = {"a": torch.zeros(4)}
    _, state, metrics = adamw.update(cfg, {"a": torch.full((4,), 1e6)}, adamw.init(cfg, params), params)
    assert float(metrics["grad_norm"]) == pytest.approx(2e6, rel=1e-5)
    # the first moment holds the clipped gradient: 0.1 · 1e6 · (1 / 2e6)
    assert torch.allclose(state["m"]["a"], torch.full((4,), 0.05))


def test_update_writes_a_module_in_place():
    api = get_model("qwen2.5-3b")
    cfg = dataclasses.replace(api.reduced, dtype="float32")
    params = api.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    opt_cfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=0)
    state = adamw.init(opt_cfg, params)
    grads = {k: torch.ones_like(p) for k, p in params.named_parameters()}
    tok = params.embed.tok
    before = tok.detach().clone()
    out, state, _ = adamw.update(opt_cfg, grads, state, params)
    assert out is params and params.embed.tok is tok and not torch.equal(tok, before)


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "gemma2-2b", "mamba2-780m", "zamba2-7b", "whisper-base",
                                  "qwen3-moe-30b-a3b"])
def test_leaf_order_is_the_reference_flatten_order(arch):
    """The port's names in ``leaf_order`` walk the reference's leaves in
    ``jax.tree.leaves`` order, each stacked leaf's layers together and in
    order; the global norm over a model's gradients agrees.  Only the
    reference tree's structure and shapes are needed (``jax.eval_shape``)."""
    japi, api = jax_get_model(arch), get_model(arch)
    cfg = dataclasses.replace(api.reduced, dtype="float32")
    jcfg = dataclasses.replace(japi.reduced, dtype="float32")
    tree = jax.eval_shape(lambda key: japi.init(key, jcfg), jax.random.PRNGKey(0))
    params = api.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    reference = []
    for kp, _ in jax.tree_util.tree_flatten_with_path(tree)[0]:
        reference.append(".".join(str(getattr(k, "key", getattr(k, "idx", None))) for k in kp))
    names = adamw.leaf_order(dict(params.named_parameters()))
    groups, layers = [], {}
    for name in names:
        parts = name.split(".")
        nums = [i for i, p in enumerate(parts) if p.isdigit()]
        stacked = nums[-1] if nums and not name.startswith("shared") else None
        key = ".".join(p for i, p in enumerate(parts) if i != stacked)
        if not groups or groups[-1] != key:
            groups.append(key)
        layers.setdefault(key, []).append(int(parts[stacked]) if stacked is not None else 0)
    assert groups == reference
    assert all(v == sorted(v) for v in layers.values())

    jgrads = jax.tree.map(lambda a: jnp.asarray(np.random.default_rng(a.size).standard_normal(a.shape), a.dtype),
                          tree)
    np.testing.assert_allclose(float(adamw.global_norm(named_arrays(jgrads, cfg))),
                               float(jax.jit(jadamw.global_norm)(jgrads)), rtol=1e-6)


# -----------------------------------------------------------------------------
# the loss
# -----------------------------------------------------------------------------


@pytest.mark.parametrize("mask,aux,prefix,z_loss", [(False, False, 0, 1e-4), (True, True, 0, 1e-4),
                                                    (True, False, 3, 1e-4), (False, True, 2, 0.0)])
def test_next_token_loss_matches_the_reference(mask, aux, prefix, z_loss):
    cfg = dataclasses.replace(get_model("qwen2.5-3b").reduced, z_loss=z_loss)
    rng = np.random.default_rng(7)
    Bn, Sn, V = 3, 9, 37
    logits = (3 * rng.standard_normal((Bn, prefix + Sn, V))).astype(np.float32)
    tokens = rng.integers(0, V, (Bn, Sn)).astype(np.int32)
    m = (rng.random((Bn, Sn)) < 0.6).astype(np.int32) if mask else None
    a = np.float32(0.0123) if aux else None
    loss, metrics = next_token_loss(torch.from_numpy(logits), torch.from_numpy(tokens), cfg,
                                    mask=None if m is None else torch.from_numpy(m),
                                    aux_loss=None if a is None else torch.tensor(a), prefix_len=prefix)
    jloss, jmetrics = jax_next_token_loss(jnp.asarray(logits), jnp.asarray(tokens), cfg,
                                          mask=None if m is None else jnp.asarray(m),
                                          aux_loss=None if a is None else jnp.asarray(a), prefix_len=prefix)
    assert sorted(metrics) == sorted(jmetrics)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
    for k in metrics:
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), rtol=1e-6, err_msg=k)


def test_a_mask_that_counts_nothing_gives_zero_not_nan():
    cfg = get_model("qwen2.5-3b").reduced
    loss, metrics = next_token_loss(torch.randn(2, 5, 11), torch.zeros(2, 5, dtype=torch.int32), cfg,
                                    mask=torch.zeros(2, 5))
    assert float(metrics["nll"]) == 0.0 and float(metrics["tokens"]) == 1.0 and float(loss) == 0.0


# -----------------------------------------------------------------------------
# the data stream
# -----------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [dict(vocab=128, seq_len=16, global_batch=4, seed=7),
                                dict(vocab=151936, seq_len=64, global_batch=4, seed=0, mixture_components=2),
                                dict(vocab=50, seq_len=33, global_batch=6, seed=3, num_hosts=3, host_index=2)])
def test_stream_tokens_equal_the_reference_bit_for_bit(kw):
    port = SyntheticLMStream(DataConfig(**kw), step=5)
    ref = jpipeline.SyntheticLMStream(jpipeline.DataConfig(**kw), step=5)
    for _ in range(3):
        a, b = port.next_batch(), ref.next_batch()
        assert a.keys() == b.keys() and a["tokens"].dtype == b["tokens"].dtype == np.int32
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
    assert port.state() == ref.state()
    assert int(port.next_batch()["tokens"].max()) < kw["vocab"]


def test_stream_host_shards_are_disjoint_and_the_reference_s():
    kw = dict(vocab=128, seq_len=16, global_batch=8, seed=1, num_hosts=2)
    shards = [SyntheticLMStream(DataConfig(host_index=h, **kw)).next_batch()["tokens"] for h in (0, 1)]
    assert shards[0].shape == (4, 16) and not np.array_equal(*shards)
    for h, shard in enumerate(shards):
        ref = jpipeline.SyntheticLMStream(jpipeline.DataConfig(host_index=h, **kw)).next_batch()["tokens"]
        np.testing.assert_array_equal(shard, ref)
    with pytest.raises(ValueError, match="divide"):
        SyntheticLMStream(DataConfig(vocab=8, seq_len=4, global_batch=3, num_hosts=2))


def test_stream_restores_from_its_state():
    cfg = DataConfig(vocab=128, seq_len=16, global_batch=4, seed=7)
    s1 = SyntheticLMStream(cfg)
    batches = [s1.next_batch()["tokens"] for _ in range(5)]
    s2 = SyntheticLMStream(cfg)
    s2.restore({"step": 3, "seed": 7})
    np.testing.assert_array_equal(s2.next_batch()["tokens"], batches[3])
    np.testing.assert_array_equal(s2.next_batch()["tokens"], batches[4])
    with pytest.raises(ValueError, match="seed"):
        s2.restore({"step": 1, "seed": 8})


def test_prefetcher_preserves_order():
    cfg = DataConfig(vocab=64, seq_len=8, global_batch=2, seed=3)
    direct = jpipeline.SyntheticLMStream(jpipeline.DataConfig(vocab=64, seq_len=8, global_batch=2, seed=3))
    expected = [direct.next_batch()["tokens"] for _ in range(6)]
    pf = Prefetcher(SyntheticLMStream(cfg), depth=2)
    try:
        for e in expected:
            np.testing.assert_array_equal(pf.next_batch()["tokens"], e)
    finally:
        pf.close()
    assert not pf.thread.is_alive()


# -----------------------------------------------------------------------------
# whole train steps and evaluation on the reduced models
# -----------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "mamba2-780m"])
def test_microbatches_equal_the_full_batch(arch):
    """The reference's own check (tests/test_train_optim_data.py) on the
    port, two microbatches against one, then against the reference's
    two-microbatch step."""
    japi, api, cfg, tree, _ = setup(arch)
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=0, schedule="constant")
    batch = batch_of(cfg, seed=3, batch=4)
    params = {}
    for mb in (1, 2):
        p = params_from_arrays(tree, cfg, device="cpu")
        step = make_train_step(api, cfg, opt_cfg, microbatches=mb)
        params[mb], _, metrics = step(p, adamw.init(opt_cfg, p), torch_batch(batch))
    for (k, a), b in zip(params[1].named_parameters(), params[2].parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=2e-4, atol=2e-5, err_msg=k)

    jcfg = jadamw.AdamWConfig(lr=1e-3, warmup_steps=0, schedule="constant")
    jstep = jax.jit(jax_make_train_step(japi, cfg, jcfg, microbatches=2))
    jparams, _, jmetrics = jstep(tree, jadamw.init(jcfg, tree), jax_batch(batch))
    np.testing.assert_allclose(float(metrics["loss"]), float(jmetrics["loss"]), rtol=1e-5)
    reference = named_arrays(jparams, cfg)
    for k, p in params[2].named_parameters():
        close(p, reference[k], 1e-5 + 0.05 * 1e-3, 1e-4, k)


@pytest.mark.parametrize("arch,master", [("qwen2.5-3b", False), ("mixtral-8x7b", True), ("gemma2-2b", False)])
def test_a_train_step_matches_the_reference(arch, master):
    """Three steps of ``make_train_step`` (remat on, the clip active at step
    1): the parameters, both moments, the master copy and the metrics."""
    japi, api, cfg, tree, params = setup(arch)
    kw = dict(lr=3e-3, warmup_steps=1, total_steps=10, grad_clip=0.5, master_weights=master)
    opt_cfg, jcfg = adamw.AdamWConfig(**kw), jadamw.AdamWConfig(**kw)
    step = make_train_step(api, cfg, opt_cfg)
    jstep = jax.jit(jax_make_train_step(japi, cfg, jcfg))
    state, jstate = adamw.init(opt_cfg, params), jadamw.init(jcfg, tree)
    lr_sum = 0.0
    for i in range(3):
        batch = batch_of(cfg, seed=10 + i)
        params, state, metrics = step(params, state, torch_batch(batch))
        tree, jstate, jmetrics = jstep(tree, jstate, jax_batch(batch))
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), rtol=1e-5, err_msg=k)
        lr_sum += float(jmetrics["lr"])
    assert int(state["step"]) == int(jstate["step"]) == 3
    reference = {"params": named_arrays(tree, cfg), "m": named_arrays(jstate["m"], cfg),
                 "v": named_arrays(jstate["v"], cfg)}
    port = {"params": dict(params.named_parameters()), "m": state["m"], "v": state["v"]}
    if master:
        reference["master"], port["master"] = named_arrays(jstate["master"], cfg), state["master"]
    for part, ref in reference.items():
        assert sorted(port[part]) == sorted(ref)
        moved = 0.05 * lr_sum if part in ("params", "master") else 0.0
        for k in ref:
            close(port[part][k], ref[k], 1e-5 + moved, 1e-4, f"{part} {k}")


def test_bf16_parameters_keep_their_dtype_and_f32_moments():
    api = get_model("qwen2.5-3b")
    cfg = api.reduced  # bf16
    params = api.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=0)
    state = adamw.init(opt_cfg, params)
    before = {k: p.detach().clone() for k, p in params.named_parameters()}
    params, state, metrics = make_train_step(api, cfg, opt_cfg)(params, state, torch_batch(batch_of(cfg, 4)))
    for k, p in params.named_parameters():
        assert p.dtype == before[k].dtype and state["m"][k].dtype == torch.float32, k
    assert all(not torch.equal(p, before[k]) for k, p in params.named_parameters())
    assert torch.isfinite(metrics["loss"]) and torch.isfinite(metrics["grad_norm"])


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "mamba2-780m"])
def test_evaluate_matches_the_reference(arch):
    japi, api, cfg, tree, params = setup(arch, vocab=64)
    kw = dict(vocab=64, seq_len=S, global_batch=2, seed=3, mixture_components=2)
    out = evaluate(api, cfg, params, DataConfig(**kw), batches=2)
    ref = jax_evaluate(japi, cfg, tree, jpipeline.DataConfig(**kw), batches=2)
    assert out["tokens"] == ref["tokens"] == 2 * 2 * (S - 1)
    np.testing.assert_allclose(out["nll"], ref["nll"], rtol=1e-5)
    np.testing.assert_allclose(out["perplexity"], ref["perplexity"], rtol=1e-5)


def test_evaluate_takes_no_gradient_and_changes_nothing():
    api = get_model("qwen2.5-3b")
    cfg = dataclasses.replace(api.reduced, dtype="float32", vocab=64)
    params = L.trainable(api.init(torch.Generator().manual_seed(0), cfg, device="cpu"))
    before = [p.detach().clone() for p in params.parameters()]
    evaluate(api, cfg, params, DataConfig(vocab=64, seq_len=16, global_batch=2), batches=1)
    assert all(p.grad is None and torch.equal(p, b) for p, b in zip(params.parameters(), before))
