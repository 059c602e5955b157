"""The port's ssm family (Mamba2 block, mamba2 LM, conversion, engine)
against the JAX package's.

Both packages get the same parameters: the reference initialises its
pytree, every A_log, dt_bias, D, conv bias and norm scale is set to seeded
random values (the reference initialises them to constants, which would
hide a wrong head or channel), and ``params_from_arrays`` carries the tree
into the port's modules.  The reference runs with its Pallas kernels in
interpret mode (``ops.configure(use_pallas=True)`` in a fixture of this
module, restored after it): a prompt that the reduced chunk (16) divides
reaches its Pallas SSD kernel, any other its sequential oracle.

Tolerances: f32 within 1e-4 and identical greedy tokens (the two frameworks
differ in the order of f32 sums and in libm); bf16 within 5e-2 (both round
the activations to bf16 after every layer, at slightly different places).
The engines are compared in f32, token for token.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.kernels import ops
from repro.models import ssm as jssm
from repro.models.registry import get_model as jax_get_model
from repro.serve.engine import EngineConfig as JaxEngineConfig
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeEngine as JaxServeEngine

from repro_torch.launch import serve as serve_cli
from repro_torch.models import mamba as M
from repro_torch.models import ssm
from repro_torch.models.convert import params_from_arrays
from repro_torch.models.registry import get_model
from repro_torch.serve.engine import EngineConfig, Request, ServeEngine

ARCH = "mamba2-780m"
TOL = {"float32": 1e-4, "bfloat16": 5e-2}
DTYPES = ["float32", "bfloat16"]
# prompt lengths: a multiple of the reduced chunk 16 reaches the reference's
# Pallas kernel, the other its sequential oracle
BLOCK_LENGTHS = [16, 37]
MODEL_LENGTHS = [32, 11]


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
def _trees(dtype: str, seed: int = 0):
    """(reference api, config, reference tree, numpy f32 tree) of the
    reduced mamba2 in ``dtype``, with random constants."""
    japi = jax_get_model(ARCH)
    cfg = dataclasses.replace(japi.reduced, dtype=dtype)
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


def _normal(seed, shape, dtype):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(x).astype(dtype), torch.from_numpy(x).to(getattr(torch, dtype))


def _setup(dtype: str, seed: int = 0):
    japi, cfg, jtree, ntree = _trees(dtype, seed)
    return japi, cfg, jtree, params_from_arrays(ntree, cfg, device="cpu")


def _greedy_on_forward(forward, prompt: np.ndarray, n: int) -> list[int]:
    """n tokens by greedy decoding on a model's full forward, rerun over the
    whole sequence for every token."""
    seq = list(prompt)
    for _ in range(n):
        seq.append(int(np.argmax(_np(forward(np.asarray(seq, np.int32)[None]))[0, -1])))
    return seq[len(prompt):]


# -----------------------------------------------------------------------------
# the block
# -----------------------------------------------------------------------------


@pytest.mark.parametrize("S", BLOCK_LENGTHS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_block_prefill_matches_reference(dtype, S):
    """The block's output and its end-of-sequence states (SSM state, conv
    window) for two sequences."""
    _, cfg, jtree, params = _setup(dtype)
    jblock = jax.tree.map(lambda a: a[0], jtree["blocks"])["mamba"]
    ju, u = _normal(S, (2, S, cfg.d_model), dtype)
    out, state = ssm.mamba_forward_with_state(params.blocks[0].mamba, u, cfg)
    jout, jstate = jssm._mamba_forward_with_state(jblock, ju, cfg)
    _close(out, jout, TOL[dtype])
    _close(state["ssm"], jstate["ssm"], TOL[dtype])
    _close(state["conv"], jstate["conv"], TOL[dtype])
    _close(M.mamba_forward(params.blocks[0].mamba, u, cfg), jout, TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_block_decode_matches_reference(dtype):
    """One token per sequence from random states."""
    from repro.models import mamba as jM

    _, cfg, jtree, params = _setup(dtype)
    jblock = jax.tree.map(lambda a: a[1], jtree["blocks"])["mamba"]
    di, n, g, h, c = M.dims(cfg)
    ju, u = _normal(1, (3, 1, cfg.d_model), dtype)
    jssm_state, ssm_state = _normal(2, (3, h, cfg.ssm_headdim, n), "float32")
    jconv, conv = _normal(3, (3, cfg.ssm_conv - 1, c), dtype)
    out, new = M.mamba_decode(params.blocks[1].mamba, u, cfg, {"ssm": ssm_state, "conv": conv})
    jout, jnew = jM.mamba_decode(jblock, ju, cfg, {"ssm": jssm_state, "conv": jconv})
    _close(out, jout, TOL[dtype])
    _close(new["ssm"], jnew["ssm"], TOL[dtype])
    _close(new["conv"], jnew["conv"], TOL[dtype])
    assert new["ssm"].dtype == torch.float32 and new["conv"].dtype == getattr(torch, dtype)


# -----------------------------------------------------------------------------
# the model
# -----------------------------------------------------------------------------


@pytest.mark.parametrize("S", [16, 13])
@pytest.mark.parametrize("dtype", DTYPES)
def test_forward_matches_reference(dtype, S):
    japi, cfg, jtree, params = _setup(dtype)
    tokens = np.random.default_rng(12).integers(0, cfg.vocab, (2, S)).astype(np.int32)
    logits, aux = get_model(ARCH).forward(params, {"tokens": torch.from_numpy(tokens)}, cfg)
    jlogits, _ = japi.forward(jtree, {"tokens": jnp.asarray(tokens)}, cfg)
    assert logits.dtype == torch.float32
    _close(logits, jlogits, TOL[dtype])
    assert float(aux["aux_loss"]) == 0.0


@pytest.mark.parametrize("S", MODEL_LENGTHS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_prefill_and_decode_match_reference(dtype, S):
    """A prompt of S tokens for two sequences, then four greedy decode steps
    fed the reference's tokens: logits at every step and both caches at the
    end, in the reference's layout."""
    japi, cfg, jtree, params = _setup(dtype)
    api = get_model(ARCH)
    prompt = np.random.default_rng(S).integers(0, cfg.vocab, (2, S)).astype(np.int32)
    jlogits, jcache = japi.prefill(jtree, jnp.asarray(prompt), japi.init_cache(2, 64, cfg), cfg)
    logits, cache = api.prefill(params, torch.from_numpy(prompt),
                                api.init_cache(2, 64, cfg, device="cpu"), cfg)
    assert cache["pos"] == int(jcache["pos"]) == S
    for step in range(5):
        _close(logits, jlogits, TOL[dtype])
        tok = np.asarray(jnp.argmax(jlogits, axis=-1)).astype(np.int32)
        if dtype == "float32":
            assert np.array_equal(logits.argmax(dim=-1).numpy(), tok), step
        if step < 4:
            jlogits, jcache = japi.decode_step(jtree, jnp.asarray(tok), jcache, cfg)
            logits, cache = api.decode_step(params, torch.from_numpy(tok), cache, cfg)
    assert cache["pos"] == int(jcache["pos"]) == S + 4
    for name in ("ssm", "conv"):
        _close(cache["layers"][name], jcache["layers"][name], TOL[dtype])


def test_cache_layout_matches_reference():
    japi, cfg, _, _ = _trees("bfloat16")
    cache = ssm.init_cache(cfg, 3, 64, device="cpu")
    jcache = japi.init_cache(3, 64, cfg)
    assert cache["pos"] == int(jcache["pos"]) == 0
    for name, dtype in (("ssm", torch.float32), ("conv", torch.bfloat16)):
        assert tuple(cache["layers"][name].shape) == jcache["layers"][name].shape
        assert cache["layers"][name].dtype == dtype and not cache["layers"][name].any()


# -----------------------------------------------------------------------------
# the engine
# -----------------------------------------------------------------------------


def _engines(slots: int, seed: int = 0):
    japi, cfg, jtree, params = _setup("float32", seed)
    eng = ServeEngine(get_model(ARCH), cfg, params, EngineConfig(max_slots=slots, max_len=64), device="cpu")
    jeng = JaxServeEngine(japi, cfg, jtree, JaxEngineConfig(max_slots=slots, max_len=64))
    return (japi, cfg, jtree, params), eng, jeng


def test_engine_matches_reference_and_manual_decode():
    """Five requests with prompts of 3-20 tokens through two slots, so that
    slots are reused: token for token the reference engine's; request 0
    alone equals a manual prefill + decode loop."""
    (_, cfg, _, params), eng, jeng = _engines(slots=2)
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

    api = get_model(ARCH)
    cache = api.init_cache(1, 64, cfg, device="cpu")
    logits, cache = api.prefill(params, torch.from_numpy(prompts[0])[None], cache, cfg)
    manual = [int(logits[0].argmax())]
    for _ in range(3):
        logits, cache = api.decode_step(params, torch.tensor([manual[-1]], dtype=torch.int32), cache, cfg)
        manual.append(int(logits[0].argmax()))
    assert reqs[0].output == manual


def test_short_prompts_follow_the_model_unlike_the_reference():
    """Prompts shorter than conv - 1 = 3 tokens: the port's prefill keeps the
    zero-padded conv window, so its engine gives the tokens of greedy
    decoding on the model's own forward.  The reference's prefill keeps a
    window of S < 3 rows, which its engine broadcasts over 3 (ROADMAP
    Queue C), so its tokens differ."""
    (japi, cfg, jtree, params), _, _ = _engines(slots=1)
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
# conversion, initialisation, the CLI
# -----------------------------------------------------------------------------


def test_params_from_arrays_keeps_f32_leaves_in_a_bf16_model():
    """A bf16 model holds A_log, dt_bias and D in f32, with the tree's f32
    values exactly (they are not bf16 numbers); every other parameter holds
    the tree's value in bf16."""
    _, cfg, _, ntree = _trees("bfloat16")
    params = params_from_arrays(ntree, cfg, device="cpu")
    for i, block in enumerate(params.blocks):
        for name in ("A_log", "dt_bias", "D"):
            p = getattr(block.mamba, name)
            assert p.dtype == torch.float32, name
            assert torch.equal(p, torch.tensor(ntree["blocks"]["mamba"][name][i])), name
            assert not torch.equal(p, p.to(torch.bfloat16).float()), name
        conv_w = torch.tensor(ntree["blocks"]["mamba"]["conv_w"][i])
        assert block.mamba.conv_w.dtype == torch.bfloat16
        assert torch.equal(block.mamba.conv_w.float(), conv_w)
    assert params.embed.tok.dtype == torch.bfloat16 and params.embed.unembed is None


def test_init_params_draws_at_the_reference_scales():
    """conv_w a truncated normal at 0.1, conv_b 0, A_log 0, dt_bias -2, D 1,
    norm scales 0; the parameter count is the config's, at full width too."""
    api = get_model(ARCH)
    cfg = dataclasses.replace(api.reduced, dtype="float32")
    params = ssm.init_params(torch.Generator().manual_seed(3), cfg, device="cpu")
    again = ssm.init_params(torch.Generator().manual_seed(3), cfg, device="cpu")
    for (name, p), (_, p2) in zip(params.named_parameters(), again.named_parameters()):
        assert torch.equal(p, p2), name
    for block in params.blocks:
        m = block.mamba
        assert m.conv_w.abs().max() <= 0.2 * (1 + 1e-6) and float(m.conv_w.std()) > 0.05
        assert not m.conv_b.any() and not m.A_log.any() and not block.ln.scale.any()
        assert torch.all(m.dt_bias == -2.0) and torch.all(m.D == 1.0)
    assert sum(p.numel() for p in params.parameters()) == cfg.param_count()
    full = ssm.Mamba2LM(api.config, device="meta")
    assert sum(p.numel() for p in full.parameters()) == api.config.param_count() == 780_148_992


def test_cli_serves_mamba_on_the_cpu(capsys):
    serve_cli.main(["--device", "cpu", "--arch", ARCH, "--requests", "3", "--new-tokens", "4",
                    "--max-len", "16"])
    assert f"{ARCH} on cpu: 3 requests, 12 tokens" in capsys.readouterr().out
