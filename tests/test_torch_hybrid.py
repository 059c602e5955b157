"""The port's hybrid family (zamba2: Mamba2 layers and one shared attention
+ MLP block, conversion, engine) against the JAX package's.

Both packages get the same parameters: the reference initialises its
pytree, every A_log, dt_bias, D, conv bias and norm scale is set to seeded
random values (the reference initialises them to constants, which would
hide a wrong head or channel), and ``params_from_arrays`` carries the tree
into the port's modules.  The reference runs with its Pallas kernels in
interpret mode (``ops.configure(use_pallas=True)`` in a fixture of this
module, restored after it).

Two configurations: the reduced zamba2 (head width 16, the reference's own
``REDUCED``) and a variant of it with zamba2-7b's head width 112 (d_model
224, 2 heads x 112), the width the port's attention kernels had to learn.

Tolerances: f32 within 1e-4 and identical greedy tokens (the two frameworks
differ in the order of f32 sums and in libm).  bf16: the shared block within
5e-2, as the ssm and dense families' single layers; the whole model within
1e-1, because both sides round the activations to bf16 after every layer,
at slightly different places, and after 4 Mamba2 layers and 2 shared
invocations each lies 0.06-0.08 from the same model run in f32 on the same
bf16 weights, so the two can lie up to twice that apart.  The forward test
also holds the port's own bf16 error (from that f32 run) to at most 1.25
times the reference's.  The engines are compared in f32, token for token.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.kernels import ops
from repro.models import hybrid as jhybrid
from repro.models import layers as jL
from repro.models.registry import get_model as jax_get_model
from repro.serve.engine import EngineConfig as JaxEngineConfig
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeEngine as JaxServeEngine

from repro_torch.launch import serve as serve_cli
from repro_torch.models import hybrid
from repro_torch.models.convert import params_from_arrays
from repro_torch.models.registry import get_model
from repro_torch.serve.engine import EngineConfig, Request, ServeEngine
from repro_torch.serve.kvcache import kv_cache_bytes, merge_slot

ARCH = "zamba2-7b"
TOL = {"float32": 1e-4, "bfloat16": 5e-2}  # one layer
MODEL_TOL = {"float32": 1e-4, "bfloat16": 1e-1}  # the whole reduced model
DTYPES = ["float32", "bfloat16"]
# the reduced config, and the same with zamba2-7b's head width 112
WIDTHS = {"D16": {}, "D112": {"d_model": 224, "num_heads": 2, "num_kv_heads": 2, "head_dim": 112}}
# prompt lengths: a multiple of the reduced chunk 16, and not
FORWARD_LENGTHS = [16, 13]
PREFILL_LENGTHS = [32, 11]


@pytest.fixture(scope="module", autouse=True)
def pallas_reference():
    """The reference's kernels go through Pallas for the tests of this
    module only."""
    before = ops.kernel_config().use_pallas
    ops.configure(use_pallas=True)
    yield
    ops.configure(use_pallas=before)


_RANDOM = {  # leaf name -> (centre, spread) of its seeded random values
    "A_log": (0.0, 0.5), "dt_bias": (-2.0, 0.5), "D": (1.0, 0.2), "conv_b": (0.0, 0.1),
    "scale": (0.0, 0.1),
}


@functools.cache
def _trees(width: str, dtype: str, seed: int = 0):
    """(reference api, config, reference tree, numpy f32 tree) of the
    reduced zamba2 at ``width`` in ``dtype``, with random constants."""
    japi = jax_get_model(ARCH)
    cfg = dataclasses.replace(japi.reduced, dtype=dtype, **WIDTHS[width])
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        if path[-1].key in _RANDOM:
            centre, spread = _RANDOM[path[-1].key]
            return jnp.asarray(centre + spread * rng.standard_normal(a.shape), jnp.float32).astype(a.dtype)
        return a

    jtree = jax.tree_util.tree_map_with_path(leaf, japi.init(jax.random.PRNGKey(seed), cfg))
    ntree = jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), jtree)
    return japi, cfg, jtree, ntree


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(port, reference, tol):
    assert tuple(port.shape) == tuple(reference.shape)
    np.testing.assert_allclose(_np(port), _np(reference), atol=tol, rtol=tol)


def _setup(width: str, dtype: str, seed: int = 0):
    japi, cfg, jtree, ntree = _trees(width, dtype, seed)
    return japi, cfg, jtree, params_from_arrays(ntree, cfg, device="cpu")


def _greedy_on_forward(forward, prompt: np.ndarray, n: int) -> list[int]:
    """n tokens by greedy decoding on a model's full forward, rerun over the
    whole sequence for every token."""
    seq = list(prompt)
    for _ in range(n):
        seq.append(int(np.argmax(_np(forward(np.asarray(seq, np.int32)[None]))[0, -1])))
    return seq[len(prompt):]


# -----------------------------------------------------------------------------
# the shared block and the model
# -----------------------------------------------------------------------------


@pytest.mark.parametrize("S", FORWARD_LENGTHS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("width", list(WIDTHS))
def test_shared_block_matches_reference(width, dtype, S):
    """The shared attention + MLP block over two sequences, and the keys and
    values it leaves for the cache."""
    _, cfg, jtree, params = _setup(width, dtype)
    x = np.random.default_rng(S).standard_normal((2, S, cfg.d_model)).astype(np.float32)
    jx, tx = jnp.asarray(x).astype(dtype), torch.from_numpy(x).to(getattr(torch, dtype))
    out, (k, v) = hybrid._shared_forward(params.shared, tx, cfg)
    _close(out, jhybrid._shared_forward(jtree["shared"], jx, cfg), TOL[dtype])
    _, (jk, jv) = jL.attention_forward(
        jtree["shared"]["attn"], jL.rmsnorm(jtree["shared"]["ln_attn"], jx, cfg.norm_eps), cfg)
    _close(k, jk, TOL[dtype])
    _close(v, jv, TOL[dtype])


@pytest.mark.parametrize("S", FORWARD_LENGTHS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("width", list(WIDTHS))
def test_forward_matches_reference(width, dtype, S):
    japi, cfg, jtree, params = _setup(width, dtype)
    tokens = np.random.default_rng(12).integers(0, cfg.vocab, (2, S)).astype(np.int32)
    logits, aux = get_model(ARCH).forward(params, {"tokens": torch.from_numpy(tokens)}, cfg)
    jlogits, _ = japi.forward(jtree, {"tokens": jnp.asarray(tokens)}, cfg)
    assert logits.dtype == torch.float32
    _close(logits, jlogits, MODEL_TOL[dtype])
    assert float(aux["aux_loss"]) == 0.0
    if dtype == "bfloat16":  # the same weights in f32: the port rounds no worse than the reference
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        params32 = params_from_arrays(_trees(width, dtype)[3], cfg32, device="cpu")
        exact = _np(get_model(ARCH).forward(params32, {"tokens": torch.from_numpy(tokens)}, cfg32)[0])
        assert np.abs(_np(logits) - exact).max() <= 1.25 * np.abs(_np(jlogits) - exact).max()


@pytest.mark.parametrize("S", PREFILL_LENGTHS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("width", list(WIDTHS))
def test_prefill_and_decode_match_reference(width, dtype, S):
    """A prompt of S tokens for two sequences, then four greedy decode steps
    fed the reference's tokens: logits at every step and every cache entry
    at the end, in the reference's layout."""
    japi, cfg, jtree, params = _setup(width, dtype)
    api = get_model(ARCH)
    prompt = np.random.default_rng(S).integers(0, cfg.vocab, (2, S)).astype(np.int32)
    jlogits, jcache = japi.prefill(jtree, jnp.asarray(prompt), japi.init_cache(2, 64, cfg), cfg)
    logits, cache = api.prefill(params, torch.from_numpy(prompt),
                                api.init_cache(2, 64, cfg, device="cpu"), cfg)
    assert cache["pos"] == int(jcache["pos"]) == S
    for step in range(5):
        _close(logits, jlogits, MODEL_TOL[dtype])
        tok = np.asarray(jnp.argmax(jlogits, axis=-1)).astype(np.int32)
        if dtype == "float32":
            assert np.array_equal(logits.argmax(dim=-1).numpy(), tok), step
        if step < 4:
            jlogits, jcache = japi.decode_step(jtree, jnp.asarray(tok), jcache, cfg)
            logits, cache = api.decode_step(params, torch.from_numpy(tok), cache, cfg)
    assert cache["pos"] == int(jcache["pos"]) == S + 4
    for name in ("ssm", "conv"):
        _close(cache["layers"][name], jcache["layers"][name], MODEL_TOL[dtype])
    for name in ("k", "v"):
        _close(cache["shared_kv"][name], jcache["shared_kv"][name], MODEL_TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_prefill_longer_than_the_cache_keeps_its_ring(dtype):
    """A prompt of 20 tokens into caches of 16 positions: each shared
    invocation keeps the last 16 keys and values in ring order, as the
    reference's prefill does."""
    japi, cfg, jtree, params = _setup("D16", dtype)
    api = get_model(ARCH)
    prompt = np.random.default_rng(5).integers(0, cfg.vocab, (1, 20)).astype(np.int32)
    jlogits, jcache = japi.prefill(jtree, jnp.asarray(prompt), japi.init_cache(1, 16, cfg), cfg)
    logits, cache = api.prefill(params, torch.from_numpy(prompt),
                                api.init_cache(1, 16, cfg, device="cpu"), cfg)
    _close(logits, jlogits, MODEL_TOL[dtype])
    for name in ("k", "v"):
        _close(cache["shared_kv"][name], jcache["shared_kv"][name], MODEL_TOL[dtype])


@pytest.mark.parametrize("width", list(WIDTHS))
def test_cache_layout_matches_reference(width):
    japi, cfg, _, _ = _trees(width, "bfloat16")
    cache = hybrid.init_cache(cfg, 3, 64, device="cpu")
    jcache = japi.init_cache(3, 64, cfg)
    assert cache["pos"] == int(jcache["pos"]) == 0
    assert hybrid.num_shared_invocations(cfg) == jhybrid.num_shared_invocations(cfg) == 2
    entries = [(cache["layers"], jcache["layers"], "ssm", torch.float32),
               (cache["layers"], jcache["layers"], "conv", torch.bfloat16),
               (cache["shared_kv"], jcache["shared_kv"], "k", torch.bfloat16),
               (cache["shared_kv"], jcache["shared_kv"], "v", torch.bfloat16)]
    for port, ref, name, dtype in entries:
        assert tuple(port[name].shape) == ref[name].shape, name
        assert port[name].dtype == dtype and not port[name].any(), name
    # kv_cache_bytes counts the SSM states in f32 and the keys and values in bf16
    held = cache["layers"]["ssm"].numel() * 4 + sum(cache["shared_kv"][n].numel() * 2 for n in ("k", "v"))
    assert kv_cache_bytes(cfg, 3, 64) == held


def test_merge_slot_grafts_every_cache_entry():
    """A batch-1 prefill cache into slot 1 of a 3-slot engine cache: the
    Mamba2 states and both invocations' keys and values (batch on axis 1)."""
    _, cfg, _, _ = _trees("D16", "float32")
    big = hybrid.init_cache(cfg, 3, 16, device="cpu")
    small = hybrid.init_cache(cfg, 1, 16, device="cpu")
    gen = torch.Generator().manual_seed(0)
    for part in ("layers", "shared_kv"):
        for t in small[part].values():
            t.normal_(generator=gen)
    merge_slot({k: big[k] for k in ("layers", "shared_kv")},
               {k: small[k] for k in ("layers", "shared_kv")}, 1, 3)
    for part in ("layers", "shared_kv"):
        for name, t in big[part].items():
            assert torch.equal(t[:, 1], small[part][name][:, 0]), name
            assert not t[:, 0].any() and not t[:, 2].any(), name


# -----------------------------------------------------------------------------
# the engine
# -----------------------------------------------------------------------------


@pytest.mark.parametrize("width", list(WIDTHS))
def test_engine_matches_reference_and_manual_decode(width):
    """Five requests with prompts of 3-20 tokens through two slots, so slots
    are reused and decode in lockstep at the longest slot's position, the
    reference's fault (ROADMAP Queue C), which the shared attention reads:
    token for token the reference engine's.  Request 0 alone equals a manual
    prefill + decode loop."""
    japi, cfg, jtree, params = _setup(width, "float32")
    api = get_model(ARCH)
    eng = ServeEngine(api, cfg, params, EngineConfig(max_slots=2, max_len=64), device="cpu")
    jeng = JaxServeEngine(japi, cfg, jtree, JaxEngineConfig(max_slots=2, max_len=64))
    rng = np.random.default_rng(20)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in (3, 20, 7, 16, 11)]
    reqs = [Request(rid=i, prompt=p, max_new_tokens=4) for i, p in enumerate(prompts)]
    jreqs = [JaxRequest(rid=i, prompt=p, max_new_tokens=4) for i, p in enumerate(prompts)]
    for r, jr in zip(reqs, jreqs):
        eng.submit(r)
        jeng.submit(jr)
    eng.run_until_done()
    jeng.run_until_done()
    assert all(r.done and len(r.output) == 4 for r in reqs)
    assert [r.output for r in reqs] == [jr.output for jr in jreqs]
    assert eng.stats.prefills == 5
    assert eng.stats.decode_tokens == sum(len(r.output) - 1 for r in reqs)

    alone = ServeEngine(api, cfg, params, EngineConfig(max_slots=1, max_len=64), device="cpu")
    r0 = Request(rid=0, prompt=prompts[0], max_new_tokens=4)
    alone.submit(r0)
    alone.run_until_done()
    cache = api.init_cache(1, 64, cfg, device="cpu")
    logits, cache = api.prefill(params, torch.from_numpy(prompts[0])[None], cache, cfg)
    manual = [int(logits[0].argmax())]
    for _ in range(3):
        logits, cache = api.decode_step(params, torch.tensor([manual[-1]], dtype=torch.int32), cache, cfg)
        manual.append(int(logits[0].argmax()))
    assert r0.output == manual
    assert _greedy_on_forward(lambda t: api.forward(params, {"tokens": torch.from_numpy(t)}, cfg)[0],
                              prompts[0], 4) == manual


def test_short_prompts_follow_the_model_unlike_the_reference():
    """Prompts shorter than conv - 1 = 3 tokens: the port's prefill keeps the
    zero-padded conv window, so its engine gives the tokens of greedy
    decoding on the model's own forward.  The reference's prefill keeps a
    window of S < 3 rows, which its engine broadcasts over 3 (ROADMAP
    Queue C), so its tokens differ."""
    japi, cfg, jtree, params = _setup("D16", "float32")
    api = get_model(ARCH)
    differs = 0
    for S in (1, 2):
        prompt = np.random.default_rng(S).integers(0, cfg.vocab, S).astype(np.int32)
        eng = ServeEngine(api, cfg, params, EngineConfig(max_slots=1, max_len=64), device="cpu")
        jeng = JaxServeEngine(japi, cfg, jtree, JaxEngineConfig(max_slots=1, max_len=64))
        req, jreq = Request(rid=0, prompt=prompt, max_new_tokens=4), JaxRequest(rid=0, prompt=prompt, max_new_tokens=4)
        eng.submit(req)
        eng.run_until_done()
        jeng.submit(jreq)
        jeng.run_until_done()
        port_greedy = _greedy_on_forward(
            lambda t: api.forward(params, {"tokens": torch.from_numpy(t)}, cfg)[0], prompt, 4)
        ref_greedy = _greedy_on_forward(
            lambda t: japi.forward(jtree, {"tokens": jnp.asarray(t)}, cfg)[0], prompt, 4)
        assert port_greedy == ref_greedy, S
        assert req.output == port_greedy, S
        differs += jreq.output != ref_greedy
    assert differs == 2


# -----------------------------------------------------------------------------
# conversion, initialisation, sizes, the CLI
# -----------------------------------------------------------------------------


def test_params_from_arrays_carries_the_hybrid_tree():
    """Every stacked block leaf lands in its layer's module and every shared
    leaf in the one shared block, each in its own parameter's dtype: a bf16
    model holds A_log, dt_bias and D in f32 with the tree's values exactly."""
    _, cfg, _, ntree = _trees("D112", "bfloat16")
    params = params_from_arrays(ntree, cfg, device="cpu")
    assert isinstance(params, hybrid.HybridLM) and len(params.blocks) == cfg.num_layers
    for i, block in enumerate(params.blocks):
        for name in ("A_log", "dt_bias", "D"):
            p = getattr(block.mamba, name)
            assert p.dtype == torch.float32, name
            assert torch.equal(p, torch.tensor(ntree["blocks"]["mamba"][name][i])), name
        assert torch.equal(block.mamba.in_proj.w.float(),
                           torch.tensor(ntree["blocks"]["mamba"]["in_proj"]["w"][i]))
        assert torch.equal(block.ln.scale.float(), torch.tensor(ntree["blocks"]["ln"]["scale"][i]))
    shared = ntree["shared"]
    for mod, key in ((params.shared.attn.q, "q"), (params.shared.attn.o, "o")):
        assert mod.w.dtype == torch.bfloat16
        assert torch.equal(mod.w.float(), torch.tensor(shared["attn"][key]["w"]))
    assert torch.equal(params.shared.mlp.down.w.float(), torch.tensor(shared["mlp"]["down"]["w"]))
    assert torch.equal(params.shared.ln_mlp.scale.float(), torch.tensor(shared["ln_mlp"]["scale"]))
    assert params.embed.unembed is not None


def test_init_params_and_the_full_size():
    """One seed, one set of weights; the parameter count is the config's,
    at the reduced size and at zamba2-7b's full width (on ``meta``:
    6,751,130,832 parameters, 13.5 GB in bf16)."""
    api = get_model(ARCH)
    cfg = dataclasses.replace(api.reduced, dtype="float32")
    params = hybrid.init_params(torch.Generator().manual_seed(3), cfg, device="cpu")
    again = hybrid.init_params(torch.Generator().manual_seed(3), cfg, device="cpu")
    for (name, p), (_, p2) in zip(params.named_parameters(), again.named_parameters()):
        assert torch.equal(p, p2), name
    assert sum(p.numel() for p in params.parameters()) == cfg.param_count()
    full = hybrid.HybridLM(api.config, device="meta")
    assert sum(p.numel() for p in full.parameters()) == api.config.param_count() == 6_751_130_832
    assert hybrid.num_shared_invocations(api.config) == 13
    assert api.config.resolved_head_dim == 112


def test_cli_serves_zamba2_on_the_cpu(capsys):
    serve_cli.main(["--device", "cpu", "--arch", ARCH, "--requests", "3", "--new-tokens", "4",
                    "--max-len", "16"])
    assert f"{ARCH} on cpu: 3 requests, 12 tokens" in capsys.readouterr().out
