"""The port's dense-LM serving path against the JAX package's.

Both packages get the same parameters: the reference initialises its
pytree, every norm scale and bias is set to seeded random values (the
reference initialises them to zero, which would hide them), and
``params_from_arrays`` carries the tree into the port's modules.  The
reference runs with its Pallas attention kernels in interpret mode
(``ops.configure(use_pallas=True)`` in a fixture of this module, restored
after it), so both sides keep the softmax probabilities in f32.

Tolerances: f32 logits and caches within 1e-4 and identical greedy tokens
(the two frameworks differ only in the order of f32 sums and in libm); bf16
within 5e-2 (both round the activations to bf16 after every layer, at
slightly different places, and one bf16 ulp of a value near 4 is 2**-5).
The engines are compared in f32, token for token: in bf16 a near tie between
two logits may break differently in the two frameworks.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.kernels import ops
from repro.models import layers as jL
from repro.models import registry as jax_registry
from repro.models.registry import get_model as jax_get_model
from repro.serve.engine import EngineConfig as JaxEngineConfig
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeEngine as JaxServeEngine

from repro_torch.launch import serve as serve_cli
from repro_torch.models import encdec, registry, transformer, vlm
from repro_torch.models import layers as L
from repro_torch.models.convert import load_arrays, params_from_arrays
from repro_torch.models.registry import ALL_ARCHS, get_model
from repro_torch.serve.engine import EngineConfig, Request, ServeEngine
from repro_torch.serve.kvcache import cache_bytes_report, kv_cache_bytes, merge_slot

TOL = {"float32": 1e-4, "bfloat16": 5e-2}
DTYPES = ["float32", "bfloat16"]
# the dense family's architectures (the ssm family's tests are in test_torch_mamba.py)
DENSE_ARCHS = tuple(a for a in ALL_ARCHS if get_model(a).config.family == "dense")


@pytest.fixture(scope="module", autouse=True)
def pallas_reference():
    """The reference's attention goes through its Pallas kernels for the
    tests of this module only."""
    before = ops.kernel_config().use_pallas
    ops.configure(use_pallas=True)
    yield
    ops.configure(use_pallas=before)


def _trees(arch: str, dtype: str, seed: int = 0):
    """(reference api, config, reference tree, numpy tree) of the reduced
    ``arch`` in ``dtype``, with random norm scales and biases."""
    japi = jax_get_model(arch)
    cfg = dataclasses.replace(japi.reduced, dtype=dtype)
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        a = np.asarray(a.astype(jnp.float32))
        if path[-1].key in ("scale", "b"):
            a = (0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        return jnp.asarray(a).astype(cfg.dtype)

    jtree = jax.tree_util.tree_map_with_path(leaf, japi.init(jax.random.PRNGKey(seed), cfg))
    ntree = jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), jtree)
    return japi, cfg, jtree, ntree


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(port, reference, tol):
    np.testing.assert_allclose(_np(port), _np(reference), atol=tol, rtol=tol)


def _normal(seed, shape, dtype):
    """The same numpy normals as a jax array and a torch tensor of ``dtype``."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(x).astype(dtype), torch.from_numpy(x).to(L.torch_dtype(dtype))


def _first_block(cfg, jtree, ntree, slot=0):
    """Group 0 of window slot ``slot``: (reference dict, port module)."""
    jblock = jax.tree.map(lambda a: a[0], jtree["blocks"][slot])
    return jblock, params_from_arrays(ntree, cfg, device="cpu").blocks[slot][0]


# -----------------------------------------------------------------------------
# layers
# -----------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_rmsnorm_linear_and_qkv_match_reference(arch, dtype):
    _, cfg, jtree, ntree = _trees(arch, dtype)
    jb, pb = _first_block(cfg, jtree, ntree)
    jx, x = _normal(1, (2, 7, cfg.d_model), dtype)
    _close(L.rmsnorm(pb.ln_attn, x, cfg.norm_eps), jL.rmsnorm(jb["ln_attn"], jx, cfg.norm_eps), TOL[dtype])
    _close(L.linear(pb.attn.q, x), jL.linear(jb["attn"]["q"], jx), TOL[dtype])
    for port, reference in zip(L._project_qkv(pb.attn, x, cfg), jL._project_qkv(jb["attn"], jx, cfg)):
        assert tuple(port.shape) == reference.shape
        _close(port, reference, TOL[dtype])


@pytest.mark.parametrize("theta", [10000.0, 1e6])
def test_rope_matches_reference(theta):
    positions = np.array([0, 1, 7, 100, 2047, 4999], np.int32)
    for port, reference in zip(L.rope_tables(torch.from_numpy(positions), 128, theta),
                               jL.rope_tables(jnp.asarray(positions), 128, theta)):
        _close(port, reference, 1e-5)
    jx, x = _normal(2, (2, 6, 4, 128), "float32")
    sin, cos = L.rope_tables(torch.from_numpy(positions), 128, theta)
    jsin, jcos = jL.rope_tables(jnp.asarray(positions), 128, theta)
    _close(L.apply_rope(x, sin, cos), jL.apply_rope(jx, jsin, jcos), 1e-5)
    # the decode form: one position per sequence, [B, 1] -> [B, 1, D/2]
    pos = np.array([[3], [4999]], np.int32)
    sin, cos = L.rope_tables(torch.from_numpy(pos), 128, theta)
    jsin, jcos = jL.rope_tables(jnp.asarray(pos), 128, theta)
    _close(L.apply_rope(x[:, :1], sin, cos), jL.apply_rope(jx[:, :1], jsin, jcos), 1e-5)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_attention_forward_matches_reference(arch, dtype):
    """Prefill attention at a ragged length longer than gemma2's window."""
    _, cfg, jtree, ntree = _trees(arch, dtype)
    window = transformer.layer_windows(cfg)[0]
    jb, pb = _first_block(cfg, jtree, ntree)
    jx, x = _normal(3, (2, 11, cfg.d_model), dtype)
    out, (k, v) = L.attention_forward(pb.attn, x, cfg, window=window)
    jout, (jk, jv) = jL.attention_forward(jb["attn"], jx, cfg, window=window)
    for port, reference in ((out, jout), (k, jk), (v, jv)):
        assert tuple(port.shape) == reference.shape
        _close(port, reference, TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_attention_decode_matches_reference(arch, dtype):
    """One token per sequence at different positions, written into a
    ring-buffered cache of 8 slots (position 13 wraps to slot 5)."""
    _, cfg, jtree, ntree = _trees(arch, dtype)
    jb, pb = _first_block(cfg, jtree, ntree)
    shape = (2, cfg.num_kv_heads, 8, cfg.resolved_head_dim)
    jkc, kc = _normal(4, shape, dtype)
    jvc, vc = _normal(5, shape, dtype)
    jx, x = _normal(6, (2, 1, cfg.d_model), dtype)
    pos = np.array([3, 13], np.int32)
    out, kc2, vc2 = L.attention_decode(pb.attn, x, cfg, kc, vc, torch.from_numpy(pos), window=8)
    jout, jkc2, jvc2 = jL.attention_decode(jb["attn"], jx, cfg, jkc, jvc, jnp.asarray(pos), window=8)
    assert kc2 is kc and vc2 is vc  # written in place
    for port, reference in ((out, jout), (kc2, jkc2), (vc2, jvc2)):
        _close(port, reference, TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_mlp_matches_reference(act, dtype):
    """SwiGLU, and the plain GELU MLP with biases (tanh approximation, as
    jax.nn.gelu's default), which no dense config of the port uses."""
    cfg = dataclasses.replace(get_model("qwen2.5-3b").reduced, mlp_act=act, dtype=dtype)
    jp = jL.mlp_init(jax.random.PRNGKey(7), cfg, dtype=jnp.dtype(dtype))
    if act == "gelu":
        jp = {k: {**v, "b": jnp.full_like(v["b"], 0.05)} for k, v in jp.items()}
    p = load_arrays(L.MLP(cfg, dtype=L.torch_dtype(dtype), device="cpu"),
                    jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), jp))
    jx, x = _normal(8, (2, 5, cfg.d_model), dtype)
    _close(L.mlp(p, x, cfg), jL.mlp(jp, jx, cfg), TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_embed_and_unembed_match_reference(arch, dtype):
    """gemma2 scales its embedding (the scale rounded to the activation
    dtype first), ties the unembedding and softcaps the final logits."""
    _, cfg, jtree, ntree = _trees(arch, dtype)
    params = params_from_arrays(ntree, cfg, device="cpu")
    tokens = np.random.default_rng(9).integers(0, cfg.vocab, (2, 5)).astype(np.int32)
    _close(L.embed(params.embed, torch.from_numpy(tokens), cfg),
           jL.embed(jtree["embed"], jnp.asarray(tokens), cfg), TOL[dtype])
    jx, x = _normal(10, (2, 5, cfg.d_model), dtype)
    logits = L.unembed(params.embed, x, cfg)
    assert logits.dtype == torch.float32
    _close(logits, jL.unembed(jtree["embed"], jx, cfg), TOL[dtype])


# -----------------------------------------------------------------------------
# the model: forward, prefill, decode
# -----------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_prefill_and_decode_match_reference(arch, dtype):
    """A ragged 11-token prompt for two sequences, then six greedy decode
    steps fed the reference's tokens: logits at every step and the caches
    at the end (gemma2's local slot is a ring of 8 positions, so its prefill
    rolls and its decode wraps)."""
    japi, cfg, jtree, ntree = _trees(arch, dtype)
    api = get_model(arch)
    params = params_from_arrays(ntree, cfg, device="cpu")
    prompt = np.random.default_rng(11).integers(0, cfg.vocab, (2, 11)).astype(np.int32)
    jlogits, jcache = japi.prefill(jtree, jnp.asarray(prompt), japi.init_cache(2, 20, cfg), cfg)
    logits, cache = api.prefill(params, torch.from_numpy(prompt),
                                api.init_cache(2, 20, cfg, device="cpu"), cfg)
    assert cache["pos"] == int(jcache["pos"]) == 11
    for step in range(7):
        _close(logits, jlogits, TOL[dtype])
        tok = np.asarray(jnp.argmax(jlogits, axis=-1)).astype(np.int32)
        if dtype == "float32":
            assert np.array_equal(logits.argmax(dim=-1).numpy(), tok), step
        if step < 6:
            jlogits, jcache = japi.decode_step(jtree, jnp.asarray(tok), jcache, cfg)
            logits, cache = api.decode_step(params, torch.from_numpy(tok), cache, cfg)
    assert cache["pos"] == int(jcache["pos"]) == 17
    for slot, jkv in enumerate(jcache["kv"]):
        for name in ("k", "v"):
            assert tuple(cache["kv"][slot][name].shape) == jkv[name].shape
            _close(cache["kv"][slot][name], jkv[name], TOL[dtype])


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_forward_matches_reference(arch):
    japi, cfg, jtree, ntree = _trees(arch, "float32")
    params = params_from_arrays(ntree, cfg, device="cpu")
    tokens = np.random.default_rng(12).integers(0, cfg.vocab, (2, 13)).astype(np.int32)
    logits, aux = get_model(arch).forward(params, {"tokens": torch.from_numpy(tokens)}, cfg)
    jlogits, _ = japi.forward(jtree, {"tokens": jnp.asarray(tokens)}, cfg)
    _close(logits, jlogits, TOL["float32"])
    assert float(aux["aux_loss"]) == 0.0


# -----------------------------------------------------------------------------
# the engine (the scenarios of tests/test_serve_snakemake_continuum.py)
# -----------------------------------------------------------------------------


def _engines(arch="qwen2.5-3b", slots=2):
    japi, cfg, jtree, ntree = _trees(arch, "float32")
    api = get_model(arch)
    params = params_from_arrays(ntree, cfg, device="cpu")
    jeng = JaxServeEngine(japi, cfg, jtree, JaxEngineConfig(max_slots=slots, max_len=64))
    eng = ServeEngine(api, cfg, params, EngineConfig(max_slots=slots, max_len=64), device="cpu")
    return (api, cfg, params, eng), jeng


def test_engine_matches_manual_decode_and_reference():
    (api, cfg, params, eng), jeng = _engines()
    prompt = np.array([3, 1, 4, 1, 5], dtype=np.int32)
    cache = api.init_cache(1, 64, cfg, device="cpu")
    logits, cache = api.prefill(params, torch.from_numpy(prompt)[None], cache, cfg)
    expected = [int(logits[0].argmax())]
    for _ in range(4):
        logits, cache = api.decode_step(params, torch.tensor([expected[-1]], dtype=torch.int32),
                                        cache, cfg)
        expected.append(int(logits[0].argmax()))

    req, jreq = Request(rid=0, prompt=prompt, max_new_tokens=5), JaxRequest(rid=0, prompt=prompt, max_new_tokens=5)
    eng.submit(req)
    eng.run_until_done()
    jeng.submit(jreq)
    jeng.run_until_done()
    assert req.done and jreq.done
    assert req.output == expected == jreq.output
    assert req.first_token_at is not None
    assert (eng.stats.prefills, eng.stats.decode_ticks, eng.stats.decode_tokens) == (1, 4, 4)


def test_engine_batches_multiple_requests_as_reference():
    """Five requests of different lengths through two slots: lockstep decode
    at the shared position max(slot_pos), admission as slots free."""
    (_, cfg, _, eng), jeng = _engines()
    reqs = [Request(rid=i, prompt=np.arange(3 + i, dtype=np.int32) % cfg.vocab, max_new_tokens=4)
            for i in range(5)]
    jreqs = [JaxRequest(rid=r.rid, prompt=r.prompt, max_new_tokens=4) for r in reqs]
    for r, jr in zip(reqs, jreqs):
        eng.submit(r)
        jeng.submit(jr)
    eng.run_until_done()
    jeng.run_until_done()
    assert all(r.done for r in reqs) and all(len(r.output) == 4 for r in reqs)
    assert [r.output for r in reqs] == [jr.output for jr in jreqs]
    assert eng.stats.prefills == 5
    assert eng.stats.decode_tokens == sum(len(r.output) - 1 for r in reqs)


# -----------------------------------------------------------------------------
# the CLI, the registry, the cache utilities, the defaults
# -----------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "gemma2-2b"])
def test_cli_serves_on_the_cpu(arch, capsys):
    serve_cli.main(["--device", "cpu", "--arch", arch, "--requests", "3", "--new-tokens", "4",
                    "--max-len", "16"])
    out = capsys.readouterr().out
    assert f"{arch} on cpu: 3 requests, 12 tokens" in out


def test_cli_and_registry_refuse_what_is_not_ported():
    """Every architecture of the reference is ported; the CLI refuses
    whisper-base with the reference's message (its engine passes no
    frames), the registry an unknown arch, the transformer a family that is
    no decoder-only LM."""
    assert set(ALL_ARCHS) == set(jax_registry.ALL_ARCHS)
    with pytest.raises(SystemExit, match="whisper-base serving needs frames input"):
        serve_cli.main(["--device", "cpu", "--arch", "whisper-base"])
    with pytest.raises(KeyError, match="unknown arch"):
        get_model("gpt-2")
    encdec_cfg = dataclasses.replace(get_model("qwen2.5-3b").reduced, family="encdec")
    with pytest.raises(ValueError, match="not a transformer LM"):
        transformer.init_params(torch.Generator().manual_seed(0), encdec_cfg, device="cpu")


@pytest.mark.parametrize("arch,module", [("whisper-base", encdec), ("internvl2-76b", vlm)])
def test_registry_loads_the_encdec_and_vlm_families(arch, module):
    api = get_model(arch)
    assert api.module is module
    japi = jax_get_model(arch)
    for cfg, jcfg in ((api.config, japi.config), (api.reduced, japi.reduced)):
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert not hasattr(registry, "NOT_PORTED")


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present, so the default device works")
    api = get_model("qwen2.5-3b")
    params = api.init(torch.Generator().manual_seed(0), api.reduced, device="cpu")
    with pytest.raises(ValueError, match="engine on cuda"):
        ServeEngine(api, api.reduced, params, EngineConfig())
    with pytest.raises((AssertionError, RuntimeError)):
        api.init_cache(1, 8, api.reduced)


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_init_params_draws_at_the_reference_scales(arch):
    """Truncated normals on [-2, 2] times d_in ** -0.5 (0.02 for the
    embedding), zero biases and norm scales; one seed, one set of weights,
    whatever the device they are moved to."""
    cfg = dataclasses.replace(get_model(arch).reduced, dtype="float32")
    params = transformer.init_params(torch.Generator().manual_seed(3), cfg, device="cpu")
    again = transformer.init_params(torch.Generator().manual_seed(3), cfg, device="cpu")
    for (name, p), (_, p2) in zip(params.named_parameters(), again.named_parameters()):
        assert torch.equal(p, p2), name
        if name.endswith((".scale", ".b")):
            assert not p.any(), name
            continue
        sigma = 0.02 if name == "embed.tok" else p.shape[0] ** -0.5
        assert p.abs().max() <= 2 * sigma * (1 + 1e-6), name
        # the std of a standard normal truncated to [-2, 2] is 0.8796
        assert abs(float(p.std()) / sigma - 0.8796) < 0.1, name


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_kv_cache_bytes_counts_the_engine_cache(arch):
    cfg = get_model(arch).reduced
    for batch, seq in ((1, 4), (3, 64)):
        cache = transformer.init_cache(cfg, batch, seq, device="cpu")
        held = sum(t.numel() * t.element_size() for kv in cache["kv"] for t in kv.values())
        assert kv_cache_bytes(cfg, batch, seq) == held
        report = cache_bytes_report(cfg, batch, seq)
        assert report["bf16_bytes"] == held and report["int8_bytes"] < held


def test_merge_slot_copies_a_prefill_row_in_place():
    cfg = get_model("gemma2-2b").reduced
    big = transformer.init_cache(cfg, 3, 16, device="cpu")
    small = transformer.init_cache(cfg, 1, 16, device="cpu")
    for kv in small["kv"]:
        for t in kv.values():
            t.normal_(generator=torch.Generator().manual_seed(0))
    before = [t.clone() for kv in big["kv"] for t in kv.values()]
    out = merge_slot(big["kv"], small["kv"], 1, 3)
    assert out is big["kv"]
    for kv_big, kv_small in zip(big["kv"], small["kv"]):
        for name in ("k", "v"):
            assert torch.equal(kv_big[name][:, 1], kv_small[name][:, 0])
            assert not kv_big[name][:, 0].any() and not kv_big[name][:, 2].any()
    assert len(before) == 4
