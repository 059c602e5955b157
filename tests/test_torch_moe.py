"""The port's MoE family (the expert FFN, the transformer's ``moe`` branch,
conversion, engine) against the JAX package's, in process:
``repro.models.moe`` and ``repro.models.transformer`` import without
``repro.core``.

Both packages get the same parameters: the reference initialises its
pytree, every norm scale is set to seeded random values (the reference
initialises them to zero, which would hide them), and ``params_from_arrays``
carries the tree into the port's modules.  The router stays f32 in a bf16
model on both sides.  The reference runs its attention through its Pallas
kernels in interpret mode (``ops.configure(use_pallas=True)`` in a fixture
of this module, restored after it).

Configurations: the reduced qwen3-moe-30b-a3b (8 experts, top-2) and
mixtral-8x7b (4 experts, top-2, window 8), each as it is and with a small
capacity factor that makes experts drop pairs.

Tolerances: f32 within 1e-5 for one FFN (the frameworks order f32 sums and
softmax differently; the same experts are chosen, which the exact-dispatch
test holds bit for bit) and 1e-4 for the model's logits with identical
greedy tokens; bf16 within 5e-2 for one FFN and 1e-1 for the model, since
both round the activations to bf16 after every product, at slightly
different places, and one bf16 ulp of a value near 4 is 2**-5.  The engines
are compared in f32, token for token.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.kernels import ops
from repro.models import moe as jmoe
from repro.models.registry import get_model as jax_get_model
from repro.serve.engine import EngineConfig as JaxEngineConfig
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeEngine as JaxServeEngine

from repro_torch.launch import serve as serve_cli
from repro_torch.models import layers as L
from repro_torch.models import moe, transformer
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import load_arrays, params_from_arrays
from repro_torch.models.registry import get_model
from repro_torch.serve.engine import EngineConfig, Request, ServeEngine
from repro_torch.serve.kvcache import kv_cache_bytes

ARCHS = ["qwen3-moe-30b-a3b", "mixtral-8x7b"]
DTYPES = ["float32", "bfloat16"]
FFN_TOL = {"float32": 1e-5, "bfloat16": 5e-2}
MODEL_TOL = {"float32": 1e-4, "bfloat16": 1e-1}
CAPACITY = {"lossless": {}, "dropping": {"capacity_factor": 0.5}}

# the reference's own test config (tests/test_moe.py)
CFG = ModelConfig(
    name="t", family="moe", num_layers=1, d_model=32, vocab=64,
    num_heads=4, num_kv_heads=2, head_dim=8,
    num_experts=8, top_k=2, d_ff_expert=16, capacity_factor=64.0,  # lossless
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small ops; with the several pytest workers a test run starts
    side by side, each op's intra-op thread team waits on the others'."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", autouse=True)
def pallas_reference():
    """The reference's attention goes through its Pallas kernels for the
    tests of this module only."""
    before = ops.kernel_config().use_pallas
    ops.configure(use_pallas=True)
    yield
    ops.configure(use_pallas=before)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(port, reference, tol):
    assert tuple(port.shape) == tuple(reference.shape)
    np.testing.assert_allclose(_np(port), _np(reference), atol=tol, rtol=tol)


def _normal(seed, shape, dtype, scale=1.0):
    """The same numpy normals as a jax array and a torch tensor of ``dtype``."""
    x = (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)
    return jnp.asarray(x).astype(dtype), torch.from_numpy(x).to(L.torch_dtype(dtype))


def _trees(arch: str, dtype: str, seed: int = 0, **overrides):
    """(reference api, config, reference tree, numpy f32 tree) of the reduced
    ``arch`` in ``dtype``, with random norm scales; each leaf keeps the
    reference's dtype (the router f32)."""
    japi = jax_get_model(arch)
    cfg = dataclasses.replace(japi.reduced, dtype=dtype, **overrides)
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        if path[-1].key == "scale":
            return jnp.asarray(0.1 * rng.standard_normal(a.shape), jnp.float32).astype(a.dtype)
        return a

    jtree = jax.tree_util.tree_map_with_path(leaf, japi.init(jax.random.PRNGKey(seed), cfg))
    ntree = jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), jtree)
    return japi, cfg, jtree, ntree


def _ffn(cfg: ModelConfig, seed: int = 0):
    """One expert layer of ``cfg``: (reference dict, port module), the same
    values."""
    jp = jmoe.moe_init(jax.random.PRNGKey(seed), cfg, jnp.dtype(cfg.dtype))
    p = moe.MoE(cfg, dtype=L.torch_dtype(cfg.dtype), device="cpu")
    return jp, load_arrays(p, jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), jp))


# -----------------------------------------------------------------------------
# the reference's tests/test_moe.py, on the port
# -----------------------------------------------------------------------------


def _setup(cfg=CFG, B=2, S=16, seed=0):
    p = L.init_modules(moe.MoE(cfg, dtype=torch.float32, device="cpu"), torch.Generator().manual_seed(seed))
    x = torch.from_numpy(np.random.default_rng(seed + 1).standard_normal((B, S, cfg.d_model)).astype(np.float32))
    return p, x * 0.5


def test_lossless_capacity_matches_dense_oracle():
    p, x = _setup()
    y, _ = moe.moe_ffn(p, x, CFG)
    torch.testing.assert_close(y, moe.moe_ffn_dense_ref(p, x, CFG), atol=1e-5, rtol=1e-5)


def test_gates_renormalized():
    """The top-k gates sum to 1, so the output's size does not grow with k."""
    p, x = _setup()
    _, gates, _ = moe.route(p, x.reshape(-1, CFG.d_model), CFG)
    torch.testing.assert_close(gates.sum(-1), torch.ones(gates.shape[0]))
    y1, _ = moe.moe_ffn(p, x, dataclasses.replace(CFG, top_k=1))
    assert torch.isfinite(y1).all()


def test_aux_loss_uniform_router_is_one_coef():
    """A uniform router: me = 1/E, the top-1 choice a one-hot (ties to
    expert 0), so aux = coef * E * (1/E) = coef."""
    cfg = dataclasses.replace(CFG, aux_loss_coef=0.01)
    p, x = _setup(cfg)
    p.router.w.zero_()
    _, aux = moe.moe_ffn(p, x, cfg)
    assert float(aux) == pytest.approx(0.01, rel=1e-3)
    _, _, experts = moe.route(p, x.reshape(-1, cfg.d_model), cfg)
    assert (experts == torch.arange(cfg.top_k)).all()  # ties go to the lower id


def test_capacity_dropping_bounds_work():
    """An expert takes at most C pairs and the dropped pairs add nothing, so
    y leaves the lossless oracle.  Capacity factor 0.5 (the reference's test
    takes 1.0 and relies on its draws): E * C = 192 slots for 256 pairs, so
    some pairs must drop whatever the router does."""
    cfg = dataclasses.replace(CFG, capacity_factor=0.5)
    p, x = _setup(cfg, B=4, S=32)
    y, _ = moe.moe_ffn(p, x, cfg)
    assert torch.isfinite(y).all()
    _, _, experts = moe.route(p, x.reshape(-1, cfg.d_model), cfg)
    C = moe.moe_capacity(cfg, 4 * 32)
    slot, keep = moe.dispatch(experts, cfg.num_experts, C)
    assert not keep.all()
    per_expert = torch.bincount(experts[keep], minlength=cfg.num_experts)
    assert int(per_expert.max()) <= C
    assert len(set(slot[keep].tolist())) == int(keep.sum())  # kept slots are unique
    assert not torch.allclose(y, moe.moe_ffn_dense_ref(p, x, cfg))


def test_moe_capacity_rounding():
    cfg = dataclasses.replace(CFG, capacity_factor=1.25)
    c = moe.moe_capacity(cfg, 1024)
    assert c >= 1024 * cfg.top_k * 1.25 / cfg.num_experts and c % 8 == 0
    for T in (1, 4, 891, 1024):
        assert moe.moe_capacity(cfg, T) == jmoe.moe_capacity(cfg, T)


def test_dispatch_permutation_invariance():
    """Tokens shuffled, then unshuffled, give the same outputs (lossless):
    the dispatch does not couple tokens."""
    p, x = _setup()
    y, _ = moe.moe_ffn(p, x, CFG)
    perm = torch.from_numpy(np.random.default_rng(9).permutation(x.shape[1]))
    y_p, _ = moe.moe_ffn(p, x[:, perm], CFG)
    torch.testing.assert_close(y[:, perm], y_p, atol=1e-5, rtol=1e-5)


# -----------------------------------------------------------------------------
# the expert FFN against the reference's
# -----------------------------------------------------------------------------


@pytest.mark.parametrize("capacity", list(CAPACITY))
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_matches_reference(arch, dtype, capacity):
    cfg = dataclasses.replace(get_model(arch).reduced, dtype=dtype, **CAPACITY[capacity])
    jp, p = _ffn(cfg)
    assert p.router.w.dtype == torch.float32
    jx, x = _normal(1, (3, 17, cfg.d_model), dtype)
    y, aux = moe.moe_ffn(p, x, cfg)
    jy, jaux = jmoe.moe_ffn(jp, jx, cfg)
    assert y.dtype == x.dtype
    _close(y, jy, FFN_TOL[dtype])
    assert float(aux) == pytest.approx(float(jaux), rel=1e-5)
    if dtype == "float32" and capacity == "lossless":
        _close(moe.moe_ffn_dense_ref(p, x, cfg), jmoe.moe_ffn_dense_ref(jp, jx, cfg), 1e-5)


def _reference_dispatch(probs, cfg: ModelConfig, T: int):
    """The reference's top-k and dispatch steps (``moe_ffn``, lines of its
    routing and sort-based dispatch), on given probabilities, in pair order."""
    K, E = cfg.top_k, cfg.num_experts
    gate_vals, expert_idx = jax.lax.top_k(probs, K)
    C = jmoe.moe_capacity(cfg, T)
    flat_expert = expert_idx.reshape(T * K)
    order = jnp.argsort(flat_expert, stable=True)
    se = flat_expert[order]
    seg_start = jnp.searchsorted(se, jnp.arange(E), side="left")
    pos = jnp.arange(T * K) - seg_start[se]
    keep = pos < C
    slot = se * C + jnp.where(keep, pos, 0)
    # from sorted order back to pair order
    inv = jnp.argsort(order)
    return (np.asarray(gate_vals), np.asarray(expert_idx), np.asarray(slot[inv]).reshape(T, K),
            np.asarray(keep[inv]).reshape(T, K))


@pytest.mark.parametrize("capacity", list(CAPACITY))
@pytest.mark.parametrize("arch", ARCHS)
def test_dispatch_is_the_reference_bit_for_bit(arch, capacity):
    """The reference's router probabilities, with ties planted, through the
    port's top-k and dispatch: the same experts, gates, kept pairs and
    buffer slots, bit for bit."""
    cfg = dataclasses.replace(get_model(arch).reduced, **CAPACITY[capacity])
    T = 40
    jp, _ = _ffn(dataclasses.replace(cfg, dtype="float32"))
    jx, _ = _normal(2, (T, cfg.d_model), "float32")
    probs = np.array(jax.nn.softmax(jx @ jp["router"]["w"], axis=-1))
    probs[::5] = 1.0 / cfg.num_experts  # whole rows of ties
    probs[1::5, 1] = probs[1::5, 2] = probs[1::5].max(axis=-1)  # a tie for first place
    gates, experts, slot, keep = _reference_dispatch(jnp.asarray(probs), cfg, T)
    pgates, pexperts = moe.top_k(torch.from_numpy(probs), cfg.top_k)
    pslot, pkeep = moe.dispatch(pexperts, cfg.num_experts, moe.moe_capacity(cfg, T))
    np.testing.assert_array_equal(pexperts.numpy(), experts)
    np.testing.assert_array_equal(pgates.numpy(), gates)
    np.testing.assert_array_equal(pkeep.numpy(), keep)
    np.testing.assert_array_equal(pslot.numpy(), slot)
    if capacity == "dropping":
        assert not keep.all()


# -----------------------------------------------------------------------------
# the model: forward, prefill, decode
# -----------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_aux_match_reference(arch):
    japi, cfg, jtree, ntree = _trees(arch, "float32")
    params = params_from_arrays(ntree, cfg, device="cpu")
    tokens = np.random.default_rng(12).integers(0, cfg.vocab, (2, 13)).astype(np.int32)
    logits, aux = get_model(arch).forward(params, {"tokens": torch.from_numpy(tokens)}, cfg)
    jlogits, jaux = japi.forward(jtree, {"tokens": jnp.asarray(tokens)}, cfg)
    _close(logits, jlogits, MODEL_TOL["float32"])
    assert float(aux["aux_loss"]) > 0
    assert float(aux["aux_loss"]) == pytest.approx(float(jaux["aux_loss"]), rel=1e-5)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch, dtype):
    """A 11-token prompt for two sequences, then six greedy decode steps fed
    the reference's tokens: logits at every step and the caches at the end
    (mixtral's window of 8 makes its caches rings, so its prefill rolls and
    its decode wraps)."""
    japi, cfg, jtree, ntree = _trees(arch, dtype)
    api = get_model(arch)
    params = params_from_arrays(ntree, cfg, device="cpu")
    prompt = np.random.default_rng(11).integers(0, cfg.vocab, (2, 11)).astype(np.int32)
    jlogits, jcache = japi.prefill(jtree, jnp.asarray(prompt), japi.init_cache(2, 20, cfg), cfg)
    logits, cache = api.prefill(params, torch.from_numpy(prompt), api.init_cache(2, 20, cfg, device="cpu"), cfg)
    for step in range(7):
        _close(logits, jlogits, MODEL_TOL[dtype])
        tok = np.asarray(jnp.argmax(jlogits, axis=-1)).astype(np.int32)
        if dtype == "float32":
            assert np.array_equal(logits.argmax(dim=-1).numpy(), tok), step
        if step < 6:
            jlogits, jcache = japi.decode_step(jtree, jnp.asarray(tok), jcache, cfg)
            logits, cache = api.decode_step(params, torch.from_numpy(tok), cache, cfg)
    assert cache["pos"] == int(jcache["pos"]) == 17
    for slot, jkv in enumerate(jcache["kv"]):
        for name in ("k", "v"):
            _close(cache["kv"][slot][name], jkv[name], MODEL_TOL[dtype])


# -----------------------------------------------------------------------------
# the engine, the CLI, conversion and the parameters
# -----------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_reference_and_manual_decode(arch):
    """Five requests of two lengths through two slots (lockstep decode at
    the shared position, as the reference), and request 0 alone
    against a manual greedy loop."""
    japi, cfg, jtree, ntree = _trees(arch, "float32")
    api = get_model(arch)
    params = params_from_arrays(ntree, cfg, device="cpu")
    eng = ServeEngine(api, cfg, params, EngineConfig(max_slots=2, max_len=64), device="cpu")
    jeng = JaxServeEngine(japi, cfg, jtree, JaxEngineConfig(max_slots=2, max_len=64))
    # two prompt lengths, so the reference compiles two prefills
    reqs = [Request(rid=i, prompt=(np.arange(4 + 3 * (i % 2), dtype=np.int32) * 7 + i) % cfg.vocab,
                    max_new_tokens=5) for i in range(5)]
    jreqs = [JaxRequest(rid=r.rid, prompt=r.prompt, max_new_tokens=5) for r in reqs]
    for r, jr in zip(reqs, jreqs):
        eng.submit(r)
        jeng.submit(jr)
    eng.run_until_done()
    jeng.run_until_done()
    assert all(r.done and len(r.output) == 5 for r in reqs)
    assert [r.output for r in reqs] == [jr.output for jr in jreqs]

    alone = ServeEngine(api, cfg, params, EngineConfig(max_slots=1, max_len=64), device="cpu")
    r0 = Request(rid=0, prompt=reqs[0].prompt, max_new_tokens=5)
    alone.submit(r0)
    alone.run_until_done()
    cache = api.init_cache(1, 64, cfg, device="cpu")
    logits, cache = api.prefill(params, torch.from_numpy(r0.prompt)[None], cache, cfg)
    manual = [int(logits[0].argmax())]
    for _ in range(4):
        logits, cache = api.decode_step(params, torch.tensor([manual[-1]], dtype=torch.int32), cache, cfg)
        manual.append(int(logits[0].argmax()))
    assert r0.output == manual


@pytest.mark.parametrize("arch", ARCHS)
def test_cli_serves_moe_on_the_cpu(arch, capsys):
    serve_cli.main(["--device", "cpu", "--arch", arch, "--requests", "3", "--new-tokens", "4",
                    "--max-len", "16"])
    assert f"{arch} on cpu: 3 requests, 12 tokens" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_arrays_carries_the_moe_tree(arch):
    """The stacked ``moe`` leaves land in each layer's module, the router
    f32 in a bf16 model, the experts bf16."""
    _, cfg, _, ntree = _trees(arch, "bfloat16")
    params = params_from_arrays(ntree, cfg, device="cpu")
    for layer in range(cfg.num_layers):
        block = params.blocks[0][layer]
        assert block.mlp is None
        assert block.moe.router.w.dtype == torch.float32
        assert block.moe.gate.dtype == torch.bfloat16
        moe_tree = ntree["blocks"][0]["moe"]
        np.testing.assert_array_equal(block.moe.router.w.numpy(), moe_tree["router"]["w"][layer])
        np.testing.assert_array_equal(block.moe.down.float().numpy(),
                                      torch.from_numpy(np.array(moe_tree["down"][layer])).bfloat16().float().numpy())


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_draws_at_the_reference_scales(arch):
    """Every parameter the config counts; the experts' truncated normals at
    ``d ** -0.5`` (gate, up) and ``f ** -0.5`` (down), the router f32 at
    ``d ** -0.5``; one seed, one set of weights."""
    cfg = get_model(arch).reduced
    params = transformer.init_params(torch.Generator().manual_seed(3), cfg, device="cpu")
    again = transformer.init_params(torch.Generator().manual_seed(3), cfg, device="cpu")
    assert sum(p.numel() for p in params.parameters()) == cfg.param_count()
    d, f = cfg.d_model, cfg.d_ff_expert
    for (name, p), (_, p2) in zip(params.named_parameters(), again.named_parameters()):
        assert torch.equal(p, p2), name
        if ".moe." not in name:
            continue
        sigma = f**-0.5 if name.endswith("down") else d**-0.5
        assert p.dtype == (torch.float32 if "router" in name else torch.bfloat16), name
        assert float(p.float().abs().max()) <= 2 * sigma * 1.01, name
        assert abs(float(p.float().std()) / sigma - 0.8796) < 0.1, name


@pytest.mark.parametrize("arch", ARCHS)
def test_kv_cache_bytes_counts_the_engine_cache(arch):
    cfg = get_model(arch).reduced
    for batch, seq in ((1, 4), (3, 64)):
        cache = transformer.init_cache(cfg, batch, seq, device="cpu")
        held = sum(t.numel() * t.element_size() for kv in cache["kv"] for t in kv.values())
        assert kv_cache_bytes(cfg, batch, seq) == held
