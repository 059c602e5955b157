"""The kernels' autograd Functions on CPU tensors against the reference.

``FlashAttentionFn`` and ``SSDScanFn`` forward through their wrapper's
plain version on the CPU (the kernel on the card) and differentiate a
recomputation of the plain version.  The reference has no backward kernel:
its training differentiates its jnp oracles, ``ref.flash_attention_ref``
and ``ref.ssd_scan_chunked_ref`` (the Pallas kernels take no ``jax.grad``),
so the port's values and gradients are held to ``jax.vjp`` of those, with
the same numpy inputs and output cotangents.

Tolerances, f32: attention within 2e-6 + 2e-5·max|g| per tensor, the SSD
scan within 1e-5 + 1e-4·max|g| (its chunk sums run in another order);
in bf16 the Function's gradients equal autograd of the plain version bit
for bit, since its backward is that autograd.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.kernels import ref as jref

from repro_torch.kernels.flash_attention import FlashAttentionFn, flash_attention_cuda, flash_attention_ref
from repro_torch.kernels.ssd_scan import SSDScanFn, ssd_scan_cuda, ssd_scan_ref


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(port, reference, atol: float, rel: float) -> None:
    p, r = _np(port), _np(reference)
    assert p.shape == r.shape
    bound = atol + rel * float(np.abs(r).max())
    err = float(np.abs(p - r).max())
    assert err <= bound, (err, bound)


def _vjp(fn, inputs, cotangent):
    """(fn's outputs, the gradients of its inputs for ``cotangent``), jitted
    (eager JAX dispatches op by op)."""

    @jax.jit
    def run(inputs, cotangent):
        out, vjp = jax.vjp(fn, *inputs)
        return out, vjp(cotangent)

    return run(tuple(map(jnp.asarray, inputs)), jax.tree.map(jnp.asarray, cotangent))


def _rand(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


FLASH_CASES = {
    "causal": dict(H=4, Hkv=2, Sq=12, Skv=12),
    "gqa4": dict(H=8, Hkv=2, Sq=10, Skv=10),
    "window": dict(H=4, Hkv=2, Sq=16, Skv=16, window=5),
    "softcap": dict(H=4, Hkv=4, Sq=9, Skv=9, softcap=2.0),
    "window_softcap": dict(H=4, Hkv=2, Sq=12, Skv=12, window=4, softcap=3.0),
    "scale": dict(H=4, Hkv=2, Sq=8, Skv=8, scale=0.7),
    "causal_sq_lt_skv": dict(H=4, Hkv=2, Sq=5, Skv=13),
    "cross": dict(H=4, Hkv=4, Sq=6, Skv=17, causal=False),
    "cross_gqa_scale": dict(H=4, Hkv=2, Sq=3, Skv=11, causal=False, scale=0.2),
}


def _flash_inputs(case: dict, seed: int, B: int = 2, D: int = 16):
    rng = np.random.default_rng(seed)
    q = _rand(rng, (B, case["H"], case["Sq"], D))
    k = _rand(rng, (B, case["Hkv"], case["Skv"], D))
    v = _rand(rng, (B, case["Hkv"], case["Skv"], D))
    w = _rand(rng, (B, case["H"], case["Sq"], D))
    opts = dict(causal=case.get("causal", True), window=case.get("window"),
                softcap=case.get("softcap"), scale=case.get("scale"))
    return (q, k, v), w, opts


@pytest.mark.parametrize("name", list(FLASH_CASES))
def test_flash_function_matches_reference_vjp(name):
    (q, k, v), w, opts = _flash_inputs(FLASH_CASES[name], seed=len(name))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o = FlashAttentionFn.apply(tq, tk, tv, opts["causal"], opts["window"], opts["softcap"], opts["scale"])
    o.backward(torch.from_numpy(w))

    jo, jgrads = _vjp(functools.partial(jref.flash_attention_ref, **opts), (q, k, v), w)
    _close(o, jo, 1e-6, 1e-5)
    for port, reference in zip((tq.grad, tk.grad, tv.grad), jgrads):
        _close(port, reference, 2e-6, 2e-5)


@pytest.mark.parametrize("name", ["window_softcap", "cross_gqa_scale"])
def test_flash_function_is_autograd_of_the_plain_version_in_bf16(name):
    (q, k, v), w, opts = _flash_inputs(FLASH_CASES[name], seed=1)

    def leaves():
        return [torch.from_numpy(a).to(torch.bfloat16).requires_grad_() for a in (q, k, v)]

    fn_in, plain_in = leaves(), leaves()
    gw = torch.from_numpy(w).to(torch.bfloat16)
    o_fn = FlashAttentionFn.apply(*fn_in, *opts.values())
    o_fn.backward(gw)
    o_plain = flash_attention_ref(*plain_in, **opts)
    o_plain.backward(gw)
    assert torch.equal(o_fn, o_plain)
    for a, b in zip(fn_in, plain_in):
        assert a.grad.dtype == torch.bfloat16 and torch.equal(a.grad, b.grad)


def test_flash_wrapper_takes_the_function_only_when_a_gradient_is_wanted():
    (q, k, v), _, opts = _flash_inputs(FLASH_CASES["causal"], seed=3)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    assert flash_attention_cuda(tq, tk, tv, **opts).grad_fn is None
    tk.requires_grad_()
    o = flash_attention_cuda(tq, tk, tv, **opts)
    assert type(o.grad_fn).__name__ == "FlashAttentionFnBackward"
    with torch.no_grad():
        assert flash_attention_cuda(tq, tk, tv, **opts).grad_fn is None
    o.sum().backward()
    assert tq.grad is None and tk.grad is not None and tv.grad is None


SSD_CASES = {
    "one_group": dict(L=32, H=4, G=1, chunk=16),
    "two_groups": dict(L=24, H=4, G=2, chunk=8),
    "one_chunk": dict(L=16, H=2, G=1, chunk=16),
}


def _ssd_inputs(L, H, G, seed, B=2, P=16, N=16):
    rng = np.random.default_rng(seed)
    x = _rand(rng, (B, L, H, P))
    dt = (0.05 + 0.2 * rng.random((B, L, H))).astype(np.float32)
    A = -(0.5 + rng.random(H)).astype(np.float32)
    Bm = _rand(rng, (B, L, G, N), 0.5)
    Cm = _rand(rng, (B, L, G, N), 0.5)
    wy = _rand(rng, (B, L, H, P))
    ws = _rand(rng, (B, H, P, N))
    return (x, dt, A, Bm, Cm), wy, ws


@pytest.mark.parametrize("name", list(SSD_CASES))
@pytest.mark.parametrize("state_used", [True, False])
def test_ssd_function_matches_reference_vjp(name, state_used):
    c = SSD_CASES[name]
    inputs, wy, ws = _ssd_inputs(c["L"], c["H"], c["G"], seed=len(name))
    if not state_used:  # the state's cotangent is then zeros in both
        ws = np.zeros_like(ws)
    tin = [torch.from_numpy(a).requires_grad_() for a in inputs]
    y, state = SSDScanFn.apply(*tin, c["chunk"])
    if state_used:
        torch.autograd.backward((y, state), (torch.from_numpy(wy), torch.from_numpy(ws)))
    else:
        y.backward(torch.from_numpy(wy))

    (jy, jstate), jgrads = _vjp(functools.partial(jref.ssd_scan_chunked_ref, chunk=c["chunk"]), inputs,
                                (wy, ws))
    _close(y, jy, 1e-5, 1e-5)
    _close(state, jstate, 1e-5, 1e-5)
    for t, reference in zip(tin, jgrads):
        _close(t.grad, reference, 1e-5, 1e-4)


def test_ssd_function_past_a_whole_chunk_matches_the_sequential_reference():
    """L 20 at chunk 8: the port pads the last chunk; the reference's
    sequential scan (``ref.ssd_scan_ref``) takes any L."""
    inputs, wy, ws = _ssd_inputs(20, 4, 2, seed=9)
    tin = [torch.from_numpy(a).requires_grad_() for a in inputs]
    y, state = SSDScanFn.apply(*tin, 8)
    torch.autograd.backward((y, state), (torch.from_numpy(wy), torch.from_numpy(ws)))
    _, jgrads = _vjp(jref.ssd_scan_ref, inputs, (wy, ws))
    for t, reference in zip(tin, jgrads):
        _close(t.grad, reference, 1e-5, 1e-4)


def test_ssd_function_is_autograd_of_the_plain_version_in_bf16():
    inputs, wy, _ = _ssd_inputs(32, 4, 1, seed=5)

    def leaves():
        x, dt, A, Bm, Cm = (torch.from_numpy(a) for a in inputs)
        return [x.bfloat16().requires_grad_(), dt.requires_grad_(), A.requires_grad_(),
                Bm.bfloat16().requires_grad_(), Cm.bfloat16().requires_grad_()]

    fn_in, plain_in = leaves(), leaves()
    gy = torch.from_numpy(wy).bfloat16()
    y_fn, _ = SSDScanFn.apply(*fn_in, 16)
    y_fn.backward(gy)
    y_plain, _ = ssd_scan_ref(*plain_in, chunk=16)
    y_plain.backward(gy)
    assert torch.equal(y_fn, y_plain)
    for a, b in zip(fn_in, plain_in):
        assert a.grad.dtype == a.dtype and torch.equal(a.grad, b.grad)


def test_ssd_wrapper_takes_the_function_only_when_a_gradient_is_wanted():
    inputs, _, _ = _ssd_inputs(16, 2, 1, seed=2)
    tin = [torch.from_numpy(a) for a in inputs]
    y, _ = ssd_scan_cuda(*tin, chunk=16)
    assert y.grad_fn is None
    tin[1].requires_grad_()
    y, state = ssd_scan_cuda(*tin, chunk=16)
    assert type(y.grad_fn).__name__ == "SSDScanFnBackward"
    y.sum().backward()
    assert tin[1].grad is not None and tin[0].grad is None
