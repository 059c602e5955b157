"""The port's encdec family (whisper-base) and the attention layers'
cross-attention arguments against the JAX package's, in process:
``repro.models.encdec`` and ``repro.models.layers`` import without
``repro.core``.

Both packages get the same parameters: the reference initialises its
pytree, every norm scale and bias is set to seeded random values (the
reference initialises them to zero, which would hide them), and
``params_from_arrays`` carries the tree into the port's modules.  The
reference runs its default ``ops`` path (the jnp attention), as
tests/test_models_smoke.py runs it; in f32 that path rounds nothing the
port keeps.

Tolerances: f32 within 1e-5 for one attention layer and 1e-4 for the
model's states and logits, where only the frameworks' f32 summation order
differs, with identical greedy tokens; the reference's own prefill/decode
check on the bf16 reduced config keeps its 5e-2.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.models import encdec as jencdec
from repro.models import layers as jL
from repro.models.registry import get_model as jax_get_model

from repro_torch.models import encdec
from repro_torch.models import layers as L
from repro_torch.models.convert import params_from_arrays
from repro_torch.models.registry import get_model

ARCH = "whisper-base"
LAYER_TOL, MODEL_TOL = 1e-5, 1e-4


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


def _normal(seed, shape, dtype="float32", scale=1.0):
    """The same numpy normals as a jax array and a torch tensor of ``dtype``."""
    x = (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)
    return jnp.asarray(x).astype(dtype), torch.from_numpy(x).to(L.torch_dtype(dtype))


def _trees(dtype="float32", seed=0, **overrides):
    """(reference api, config, reference tree, port params) of the reduced
    whisper-base in ``dtype``, norm scales and biases random."""
    japi = jax_get_model(ARCH)
    cfg = dataclasses.replace(japi.reduced, dtype=dtype, **overrides)
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        if path[-1].key in ("scale", "b"):
            return jnp.asarray(0.1 * rng.standard_normal(a.shape), jnp.float32).astype(a.dtype)
        return a

    jtree = jax.tree_util.tree_map_with_path(leaf, japi.init(jax.random.PRNGKey(seed), cfg))
    ntree = jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), jtree)
    return japi, cfg, jtree, params_from_arrays(ntree, cfg, device="cpu")


def _frames(cfg, B, seed=4):
    """Frame embeddings as the reference's test makes them: normals x 0.1."""
    return _normal(seed, (B, cfg.enc_frames, cfg.d_model), cfg.dtype, scale=0.1)


# -----------------------------------------------------------------------------
# the attention layers' new arguments
# -----------------------------------------------------------------------------


def _attention(cfg, jtree, params):
    """The first decoder block's cross-attention: (reference dict, module)."""
    return jax.tree.map(lambda a: a[0], jtree["dec_blocks"])["cross_attn"], params.dec_blocks[0].cross_attn


@pytest.mark.parametrize("kw", [dict(causal=False, use_rope=False), dict(causal=False),
                                dict(causal=True, use_rope=False), dict(positions=np.arange(5, 16))],
                         ids=["noncausal-norope", "noncausal-rope", "causal-norope", "positions"])
def test_attention_forward_options_match_reference(kw):
    _, cfg, jtree, params = _trees()
    jp, p = _attention(cfg, jtree, params)
    jx, x = _normal(1, (2, 11, cfg.d_model))
    jkw = dict(kw, positions=jnp.asarray(kw["positions"])) if "positions" in kw else kw
    pkw = dict(kw, positions=torch.from_numpy(kw["positions"])) if "positions" in kw else kw
    out, (k, v) = L.attention_forward(p, x, cfg, **pkw)
    jout, (jk, jv) = jL.attention_forward(jp, jx, cfg, **jkw)
    for port, reference in ((out, jout), (k, jk), (v, jv)):
        _close(port, reference, LAYER_TOL)


def test_cross_attention_kv_override_matches_reference():
    """Prompt rows (Sq 7) against the encoder's keys (Skv 16), non-causal,
    no RoPE: the override comes back as the layer's (k, v)."""
    _, cfg, jtree, params = _trees()
    jp, p = _attention(cfg, jtree, params)
    jx, x = _normal(2, (2, 7, cfg.d_model))
    jenc, enc = _normal(3, (2, cfg.enc_frames, cfg.d_model))
    jkv = jencdec._cross_kv(jp, jenc, cfg)
    kv = encdec._cross_kv(p, enc, cfg)
    for port, reference in zip(kv, jkv):
        _close(port, reference, LAYER_TOL)
    out, back = L.attention_forward(p, x, cfg, causal=False, use_rope=False, kv_override=kv)
    jout, _ = jL.attention_forward(jp, jx, cfg, causal=False, use_rope=False, kv_override=jkv)
    _close(out, jout, LAYER_TOL)
    assert back[0] is kv[0] and back[1] is kv[1]


@pytest.mark.parametrize("update_cache", [True, False])
def test_attention_decode_without_rope_matches_reference(update_cache):
    """One token at positions 3 and 13 of a cache of 16, no RoPE; with
    ``update_cache=False`` the cache is read and left as it was."""
    _, cfg, jtree, params = _trees()
    jp, p = _attention(cfg, jtree, params)
    shape = (2, cfg.num_kv_heads, 16, cfg.resolved_head_dim)
    jkc, kc = _normal(4, shape)
    jvc, vc = _normal(5, shape)
    before = kc.clone()
    jx, x = _normal(6, (2, 1, cfg.d_model))
    pos = np.array([3, 13], np.int32)
    out, kc2, vc2 = L.attention_decode(p, x, cfg, kc, vc, torch.from_numpy(pos), use_rope=False,
                                       update_cache=update_cache)
    jout, jkc2, jvc2 = jL.attention_decode(jp, jx, cfg, jkc, jvc, jnp.asarray(pos), use_rope=False,
                                           update_cache=update_cache)
    for port, reference in ((out, jout), (kc2, jkc2), (vc2, jvc2)):
        _close(port, reference, LAYER_TOL)
    assert torch.equal(kc, before) != update_cache


# -----------------------------------------------------------------------------
# the model
# -----------------------------------------------------------------------------


def test_encode_matches_reference():
    _, cfg, jtree, params = _trees()
    jframes, frames = _frames(cfg, 2)
    _close(encdec.encode(params, cfg, frames), jencdec.encode(jtree, cfg, jframes), MODEL_TOL)


def test_forward_matches_reference():
    japi, cfg, jtree, params = _trees()
    jframes, frames = _frames(cfg, 2)
    tokens = np.random.default_rng(12).integers(0, cfg.vocab, (2, 13)).astype(np.int32)
    logits, aux = get_model(ARCH).forward(params, {"tokens": torch.from_numpy(tokens), "frames": frames}, cfg)
    jlogits, _ = japi.forward(jtree, {"tokens": jnp.asarray(tokens), "frames": jframes}, cfg)
    assert logits.dtype == torch.float32
    _close(logits, jlogits, MODEL_TOL)
    assert float(aux["aux_loss"]) == 0.0


def test_prefill_and_decode_match_reference():
    """A 9-token prompt for two sequences behind their frames, then six
    greedy decode steps fed the reference's tokens: logits at every step and
    the self- and cross-attention caches at the end."""
    japi, cfg, jtree, params = _trees()
    api = get_model(ARCH)
    jframes, frames = _frames(cfg, 2)
    prompt = np.random.default_rng(11).integers(0, cfg.vocab, (2, 9)).astype(np.int32)
    jlogits, jcache = japi.prefill(jtree, jnp.asarray(prompt), japi.init_cache(2, 20, cfg), cfg,
                                   frames=jframes)
    logits, cache = api.prefill(params, torch.from_numpy(prompt), api.init_cache(2, 20, cfg, device="cpu"),
                                cfg, frames=frames)
    for step in range(7):
        _close(logits, jlogits, MODEL_TOL)
        tok = np.asarray(jnp.argmax(jlogits, axis=-1)).astype(np.int32)
        assert np.array_equal(logits.argmax(dim=-1).numpy(), tok), step
        if step < 6:
            jlogits, jcache = japi.decode_step(jtree, jnp.asarray(tok), jcache, cfg)
            logits, cache = api.decode_step(params, torch.from_numpy(tok), cache, cfg)
    assert cache["pos"] == int(jcache["pos"]) == 15
    for name in ("self_k", "self_v", "cross_k", "cross_v"):
        _close(cache[name], jcache[name], MODEL_TOL)


def test_prefill_decode_matches_forward():
    """The reference's own check (tests/test_models_smoke.py), on the port:
    teacher-forced decode reproduces the full forward's logits, on the
    reduced config in its bf16, within that test's 5e-2."""
    api = get_model(ARCH)
    cfg = api.reduced
    params = api.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    B, S, split = 2, 12, 6
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab, (B, S)).astype(np.int32))
    _, frames = _frames(cfg, B)
    logits_full, _ = api.forward(params, {"tokens": toks, "frames": frames}, cfg)
    lg, cache = api.prefill(params, toks[:, :split], api.init_cache(B, 64, cfg, device="cpu"), cfg,
                            frames=frames)
    torch.testing.assert_close(lg, logits_full[:, split - 1], rtol=5e-2, atol=5e-2)
    for t in range(split, S):
        lg, cache = api.decode_step(params, toks[:, t], cache, cfg)
        torch.testing.assert_close(lg, logits_full[:, t], rtol=5e-2, atol=5e-2)


def test_prefill_needs_frames():
    api = get_model(ARCH)
    cfg = api.reduced
    params = api.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    with pytest.raises(ValueError, match="needs frames"):
        api.prefill(params, torch.zeros(1, 3, dtype=torch.int32), api.init_cache(1, 8, cfg, device="cpu"), cfg)


def test_prefill_refuses_frames_that_do_not_fill_the_cross_cache():
    """The prefill writes the encoder's keys into the cross cache in place,
    and a tick attends to every cached frame, so fewer frames than the cache
    holds would leave zero keys in the softmax: refused."""
    api = get_model(ARCH)
    cfg = api.reduced
    params = api.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    _, frames = _frames(cfg, 1)
    with pytest.raises(ValueError, match="do not fill the cross-attention cache"):
        api.prefill(params, torch.zeros(1, 3, dtype=torch.int32), api.init_cache(1, 8, cfg, device="cpu"), cfg,
                    frames=frames[:, :-1])


#: sha256 of the reduced whisper-base's prefill (4 prompts of 5 tokens behind
#: frames of numpy's seed 3, a cache of 32), three greedy ticks' logits and
#: the caches after them, with no program installed, recorded before the
#: prefill came to write the cross caches in place and the tick to read them
#: through ``layers.decode_cache``
NO_PROGRAM_SERVING_BITS = {
    "bfloat16": "aeec0302e569a789b8fc8bb39daa53165f2aebda166a25f12483d7e77bdf368f",
    "float32": "66c29e5771d0b68e0945bffadb68435e65687225c4ca6f12fbc21a85b4d5e27d",
}


@pytest.mark.parametrize("dtype", list(NO_PROGRAM_SERVING_BITS))
def test_serving_with_no_program_keeps_its_bits(dtype):
    import hashlib

    api = get_model(ARCH)
    cfg = dataclasses.replace(api.reduced, dtype=dtype)
    params = api.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    frames = torch.from_numpy((np.random.default_rng(3).standard_normal((4, cfg.enc_frames, cfg.d_model)) * 0.1)
                              .astype(np.float32)).to(L.torch_dtype(dtype))
    tokens = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab, (4, 5)).astype(np.int32))
    h = hashlib.sha256()

    def put(t):
        t = t.detach().contiguous()
        h.update((t.view(torch.int16) if t.dtype == torch.bfloat16 else t.view(torch.uint8)).numpy().tobytes())

    with torch.no_grad():
        logits, cache = api.prefill(params, tokens, api.init_cache(4, 32, cfg, device="cpu"), cfg, frames=frames)
        put(logits)
        for _ in range(3):
            logits, cache = api.decode_step(params, logits.argmax(-1).to(torch.int32), cache, cfg)
            put(logits)
    for name in ("self_k", "self_v", "cross_k", "cross_v"):
        h.update(name.encode())
        put(cache[name])
    h.update(str(cache["pos"]).encode())
    assert h.hexdigest() == NO_PROGRAM_SERVING_BITS[dtype]


def test_decode_past_the_learned_positions_raises_where_the_reference_clamps():
    """A fault of the reference (ROADMAP Queue C): at ``pos ==
    dec_positions`` its ``pos_dec[pos]`` gathers with JAX's clamp, so the
    step silently reuses the last learned position (equal to a run whose
    table holds that row once more); the port raises."""
    japi, cfg, jtree, params = _trees(dec_positions=8)
    api = get_model(ARCH)
    jframes, frames = _frames(cfg, 1)
    prompt = np.arange(8, dtype=np.int32)[None]
    _, jcache = japi.prefill(jtree, jnp.asarray(prompt), japi.init_cache(1, 16, cfg), cfg, frames=jframes)
    tok = jnp.asarray([5], jnp.int32)
    clamped, _ = japi.decode_step(jtree, tok, jcache, cfg)
    longer = dict(jtree, pos_dec=jnp.concatenate([jtree["pos_dec"], jtree["pos_dec"][-1:]]))
    extended, _ = japi.decode_step(longer, tok, jcache, cfg)
    assert np.isfinite(_np(clamped)).all()
    np.testing.assert_array_equal(_np(clamped), _np(extended))

    _, cache = api.prefill(params, torch.from_numpy(prompt), api.init_cache(1, 16, cfg, device="cpu"), cfg,
                           frames=frames)
    assert cache["pos"] == 8
    with pytest.raises(ValueError, match="outside the 8 learned decoder positions"):
        api.decode_step(params, torch.tensor([5], dtype=torch.int32), cache, cfg)


# -----------------------------------------------------------------------------
# conversion, parameters, the cache
# -----------------------------------------------------------------------------


def test_params_from_arrays_carries_the_encdec_tree():
    _, cfg, jtree, params = _trees()
    np.testing.assert_array_equal(params.pos_enc.numpy(), _np(jtree["pos_enc"]))
    np.testing.assert_array_equal(params.pos_dec.numpy(), _np(jtree["pos_dec"]))
    np.testing.assert_array_equal(params.ln_enc_final.scale.numpy(), _np(jtree["ln_enc_final"]["scale"]))
    for layer in range(cfg.num_layers):
        block = params.dec_blocks[layer]
        np.testing.assert_array_equal(block.cross_attn.k.w.numpy(), _np(jtree["dec_blocks"]["cross_attn"]["k"]["w"][layer]))
        np.testing.assert_array_equal(block.mlp.up.b.numpy(), _np(jtree["dec_blocks"]["mlp"]["up"]["b"][layer]))
    for layer in range(cfg.enc_layers):
        np.testing.assert_array_equal(params.enc_blocks[layer].attn.o.w.numpy(),
                                      _np(jtree["enc_blocks"]["attn"]["o"]["w"][layer]))


def test_init_params_and_cache_take_the_config():
    """Every parameter the config counts, one seed one set of weights, the
    position tables truncated normals of 0.02; the caches' shapes are the
    reference's."""
    api, japi = get_model(ARCH), jax_get_model(ARCH)
    cfg = api.reduced
    params = api.init(torch.Generator().manual_seed(3), cfg, device="cpu")
    again = api.init(torch.Generator().manual_seed(3), cfg, device="cpu")
    assert sum(p.numel() for p in params.parameters()) == cfg.param_count()
    for (name, p), (_, p2) in zip(params.named_parameters(), again.named_parameters()):
        assert torch.equal(p, p2), name
    for table in (params.pos_enc, params.pos_dec):
        assert float(table.float().abs().max()) <= 0.04 * 1.01
    cache = api.init_cache(3, 20, cfg, device="cpu")
    jcache = japi.init_cache(3, 20, cfg)
    for name in ("self_k", "self_v", "cross_k", "cross_v"):
        assert tuple(cache[name].shape) == jcache[name].shape
        assert cache[name].dtype == torch.bfloat16
    assert cache["pos"] == 0
    assert get_model(ARCH).config.param_count() == 88_187_392
