"""The port's vlm family (internvl2-76b) and the transformer's ``embeds``
path against the JAX package's, in process: ``repro.models.vlm`` and
``repro.serve.engine`` import without ``repro.core``.

Both packages get the same parameters: the reference initialises its
pytree (the transformer's and ``patch_pos``), every norm scale is set to
seeded random values (the reference initialises them to zero), and
``params_from_arrays`` carries the tree into the port's modules.  The
reference runs its default ``ops`` path, as tests/test_models_smoke.py runs
it.

Tolerances: f32 within 1e-4 for the model's logits, where only the
frameworks' f32 summation order differs, with identical greedy tokens; the
engines are compared token for token; the reference's own prefill/decode
check on the bf16 reduced config keeps its 5e-2.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.models import transformer as jT
from repro.models.registry import get_model as jax_get_model
from repro.serve.engine import EngineConfig as JaxEngineConfig
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeEngine as JaxServeEngine

from repro_torch.launch import serve as serve_cli
from repro_torch.models import transformer, vlm
from repro_torch.models.convert import params_from_arrays
from repro_torch.models.registry import get_model
from repro_torch.serve.engine import EngineConfig, Request, ServeEngine

ARCH = "internvl2-76b"
MODEL_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small ops; with the several pytest workers a test run starts
    side by side, each op's intra-op thread team waits on the others'."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(port, reference, tol):
    assert tuple(port.shape) == tuple(reference.shape)
    np.testing.assert_allclose(_np(port), _np(reference), atol=tol, rtol=tol)


def _trees(dtype="float32", seed=0):
    """(reference api, config, reference tree, port params) of the reduced
    internvl2-76b in ``dtype``, norm scales random."""
    japi = jax_get_model(ARCH)
    cfg = dataclasses.replace(japi.reduced, dtype=dtype)
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        if path[-1].key == "scale":
            return jnp.asarray(0.1 * rng.standard_normal(a.shape), jnp.float32).astype(a.dtype)
        return a

    jtree = jax.tree_util.tree_map_with_path(leaf, japi.init(jax.random.PRNGKey(seed), cfg))
    ntree = jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), jtree)
    return japi, cfg, jtree, params_from_arrays(ntree, cfg, device="cpu")


def _patches(cfg, B, seed=9):
    """Patch embeddings as the reference's test makes them: normals x 0.1."""
    x = (np.random.default_rng(seed).standard_normal((B, cfg.num_patches, cfg.d_model)) * 0.1).astype(np.float32)
    return jnp.asarray(x).astype(cfg.dtype), torch.from_numpy(x).to(getattr(torch, cfg.dtype))


def _tokens(cfg, B, S, seed=12):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S)).astype(np.int32)


def test_forward_with_patches_matches_reference():
    """Logits over the whole prefix + text sequence, [B, P + S, V]."""
    japi, cfg, jtree, params = _trees()
    jpatches, patches = _patches(cfg, 2)
    tokens = _tokens(cfg, 2, 13)
    logits, aux = get_model(ARCH).forward(params, {"tokens": torch.from_numpy(tokens), "patches": patches}, cfg)
    jlogits, _ = japi.forward(jtree, {"tokens": jnp.asarray(tokens), "patches": jpatches}, cfg)
    assert tuple(logits.shape) == (2, cfg.num_patches + 13, cfg.vocab)
    _close(logits, jlogits, MODEL_TOL)
    assert float(aux["aux_loss"]) == 0.0


def test_transformer_takes_embeds_as_the_reference():
    """``forward({"embeds"})`` and ``prefill(embeds=)`` of the language
    model alone, on the same embeddings."""
    _, cfg, jtree, params = _trees()
    x = (np.random.default_rng(5).standard_normal((2, 10, cfg.d_model)) * 0.1).astype(np.float32)
    logits, _ = transformer.forward(params, cfg, {"embeds": torch.from_numpy(x)})
    jlogits, _ = jT.forward(jtree, cfg, {"embeds": jnp.asarray(x)})
    _close(logits, jlogits, MODEL_TOL)
    dummy = np.zeros((2, 10), np.int32)
    lg, cache = transformer.prefill(params, cfg, torch.from_numpy(dummy),
                                    transformer.init_cache(cfg, 2, 16, device="cpu"), embeds=torch.from_numpy(x))
    jlg, jcache = jT.prefill(jtree, cfg, jnp.asarray(dummy), jT.init_cache(cfg, 2, 16), embeds=jnp.asarray(x))
    _close(lg, jlg, MODEL_TOL)
    assert cache["pos"] == int(jcache["pos"]) == 10


@pytest.mark.parametrize("with_patches", [True, False], ids=["patches", "text-only"])
def test_prefill_and_decode_match_reference(with_patches):
    """A 9-token prompt for two sequences behind their patches (or alone),
    then six greedy decode steps fed the reference's tokens: logits at every
    step, the cache position (offset by ``num_patches``) and the caches."""
    japi, cfg, jtree, params = _trees()
    api = get_model(ARCH)
    jpatches, patches = _patches(cfg, 2)
    extras = {"patches": patches} if with_patches else {}
    jextras = {"patches": jpatches} if with_patches else {}
    prompt = _tokens(cfg, 2, 9, seed=11)
    jlogits, jcache = japi.prefill(jtree, jnp.asarray(prompt), japi.init_cache(2, 32, cfg), cfg, **jextras)
    logits, cache = api.prefill(params, torch.from_numpy(prompt), api.init_cache(2, 32, cfg, device="cpu"),
                                cfg, **extras)
    offset = cfg.num_patches if with_patches else 0
    assert cache["pos"] == int(jcache["pos"]) == offset + 9
    for step in range(7):
        _close(logits, jlogits, MODEL_TOL)
        tok = np.asarray(jnp.argmax(jlogits, axis=-1)).astype(np.int32)
        assert np.array_equal(logits.argmax(dim=-1).numpy(), tok), step
        if step < 6:
            jlogits, jcache = japi.decode_step(jtree, jnp.asarray(tok), jcache, cfg)
            logits, cache = api.decode_step(params, torch.from_numpy(tok), cache, cfg)
    assert cache["pos"] == offset + 15
    for name in ("k", "v"):
        _close(cache["kv"][0][name], jcache["kv"][0][name], MODEL_TOL)


def test_prefill_decode_matches_forward():
    """The reference's own check (tests/test_models_smoke.py), on the port:
    teacher-forced decode behind the patches reproduces the full forward's
    logits at ``num_patches + t``, on the reduced config in its bf16,
    within that test's 5e-2."""
    api = get_model(ARCH)
    cfg = api.reduced
    params = api.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    B, S, split = 2, 16, 8
    toks = torch.from_numpy(_tokens(cfg, B, S, seed=1))
    _, patches = _patches(cfg, B)
    logits_full, _ = api.forward(params, {"tokens": toks, "patches": patches}, cfg)
    prefix = cfg.num_patches
    lg, cache = api.prefill(params, toks[:, :split], api.init_cache(B, 64, cfg, device="cpu"), cfg,
                            patches=patches)
    torch.testing.assert_close(lg, logits_full[:, prefix + split - 1], rtol=5e-2, atol=5e-2)
    for t in range(split, S):
        lg, cache = api.decode_step(params, toks[:, t], cache, cfg)
        torch.testing.assert_close(lg, logits_full[:, prefix + t], rtol=5e-2, atol=5e-2)


def test_engine_serves_text_only_as_the_reference():
    """The reference's engine passes no patches: five requests through two
    slots, token for token."""
    japi, cfg, jtree, params = _trees()
    api = get_model(ARCH)
    eng = ServeEngine(api, cfg, params, EngineConfig(max_slots=2, max_len=64), device="cpu")
    jeng = JaxServeEngine(japi, cfg, jtree, JaxEngineConfig(max_slots=2, max_len=64))
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


def test_cli_serves_vlm_on_the_cpu(capsys):
    serve_cli.main(["--device", "cpu", "--arch", ARCH, "--requests", "3", "--new-tokens", "4",
                    "--max-len", "16"])
    assert f"{ARCH} on cpu: 3 requests, 12 tokens" in capsys.readouterr().out


def test_params_and_conversion():
    """Every parameter the config counts, ``patch_pos`` carried from the
    reference tree, one seed one set of weights; the 8-layer cut at full
    width that the card serves."""
    _, cfg, jtree, params = _trees()
    assert isinstance(params, vlm.VLM)
    np.testing.assert_array_equal(params.patch_pos.numpy(), _np(jtree["patch_pos"]))
    api = get_model(ARCH)
    p1 = api.init(torch.Generator().manual_seed(3), api.reduced, device="cpu")
    p2 = api.init(torch.Generator().manual_seed(3), api.reduced, device="cpu")
    assert sum(p.numel() for p in p1.parameters()) == api.reduced.param_count()
    assert all(torch.equal(a, b) for a, b in zip(p1.parameters(), p2.parameters()))
    assert float(p1.patch_pos.float().abs().max()) <= 0.04 * 1.01
    assert dataclasses.replace(api.config, num_layers=8).param_count() == 8_948_686_848
