"""The port's op counter (``launch/op_costs.py``) against the reference's
HLO cost model (``repro/launch/hlo_costs.py``), in process.

The cases of ``tests/test_hlo_costs.py`` in torch: a Python loop of 9
products (the reference's ``lax.scan``), one product, a batched product,
nested loops (5 x 3) and a loop-free gradient.  The reference counts each
jitted jnp version with ``analyze_hlo_text``; its scans are unrolled
(``unroll=True``) for the exact comparisons, since a ``while`` loop adds an
add and a compare a trip for its induction variable, which a Python loop
does not have (the rolled counts are held within 1% above the port's).
FLOPs and transcendentals are equal exactly where no elementwise op is
fused differently; for the gradient the products' FLOPs are exact and the
total within the reference test's own 10% of XLA's ``cost_analysis``.

A reduced qwen2.5-3b and mamba2-780m forward on one device: the products
outside the kernels equal the reference's dots less its attention's or
SSD scan's own (each counted alone at the layer's shapes), exactly.  The
kernels differ by design: the port counts the flash kernel's visible pairs,
4·D·B·H·S(S+1)/2 a layer, the reference's jnp path the full masked scores,
4·D·B·H·S²; the port counts the SSD scan as 4·P·N a step and head.

The kernel formulas (``kernels/work.py``) give the bounds that ``PERF.md``
§6 records: flash qwen S=891 0.003292 ms, decode qwen 4 x 892 keys
0.001100 ms, SSD mamba2 L=891 0.003925 ms (H100 peaks: 989e12 bf16 FLOP/s,
3.35e12 B/s).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from repro.launch.hlo_costs import analyze_hlo_text, bytes_by_scope

from repro_torch.kernels import work
from repro_torch.kernels.decode_attention import decode_attention_cuda
from repro_torch.kernels.flash_attention import attention_mask, flash_attention_cuda
from repro_torch.kernels.ssd_scan import ssd_scan_cuda
from repro_torch.launch.op_costs import OpCounter, count
from repro_torch.models.registry import get_model


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _ref(fn, *shapes):
    comp = jax.jit(fn).lower(*(jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes)).compile()
    return analyze_hlo_text(comp.as_text()), comp


def _dots(fn, *args) -> float:
    """The reference's dot FLOPs of a jitted function (trip counts scaled)."""
    txt = jax.jit(fn).lower(*args).compile().as_text()
    return sum(r[2] for r in bytes_by_scope(txt, depth=1, top=10**9))


def _meta(*shape):
    return torch.empty(shape, device="meta")


def _scan_ref(unroll):
    def step(xs, x):
        def body(c, w):
            return jnp.tanh(c @ w), ()
        c, _ = jax.lax.scan(body, x, xs, unroll=unroll)
        return c.sum()
    return step


def test_scan_trip_count_scaling():
    trips, m, k, n = 9, 8, 16, 16

    def step(xs, x):
        for i in range(trips):
            x = torch.tanh(x @ xs[i])
        return x.sum()

    _, c = count(step, _meta(trips, k, n), _meta(m, k))
    unrolled, _ = _ref(_scan_ref(True), (trips, k, n), (m, k))
    rolled, comp = _ref(_scan_ref(False), (trips, k, n), (m, k))
    assert c.costs.flops == unrolled.flops
    assert c.costs.transcendentals == unrolled.transcendentals == trips * m * n
    assert c.costs.matmul_flops == trips * 2 * m * k * n
    assert c.costs.flops <= rolled.flops <= 1.01 * c.costs.flops  # the induction variable's ops
    assert c.costs.flops > comp.cost_analysis()["flops"] * (trips - 2)  # raw counts the body once


def test_single_dot_flops_exact():
    m, k, n = 32, 64, 16
    _, c = count(lambda a, b: a @ b, _meta(m, k), _meta(k, n))
    ref, _ = _ref(lambda a, b: a @ b, (m, k), (k, n))
    assert c.costs.flops == ref.flops == 2 * m * k * n


def test_batched_dot_flops():
    b, m, k, n = 4, 8, 32, 16
    _, c = count(lambda a, x: torch.einsum("bmk,bkn->bmn", a, x), _meta(b, m, k), _meta(b, k, n))
    ref, _ = _ref(lambda a, x: jnp.einsum("bmk,bkn->bmn", a, x), (b, m, k), (b, k, n))
    assert c.costs.flops == ref.flops == 2 * b * m * k * n


def test_nested_scan_multiplies():
    def step(x):
        for _ in range(5):
            for _ in range(3):
                x = torch.tanh(x @ x)
        return x.sum()

    def ref_step(unroll):
        def f(xs):
            def outer(c, _):
                def inner(c2, _):
                    return jnp.tanh(c2 @ c2), ()
                c2, _ = jax.lax.scan(inner, c, None, length=3, unroll=unroll)
                return c2, ()
            c, _ = jax.lax.scan(outer, xs, None, length=5, unroll=unroll)
            return c.sum()
        return f

    _, c = count(step, _meta(16, 16))
    unrolled, _ = _ref(ref_step(True), (16, 16))
    rolled, _ = _ref(ref_step(False), (16, 16))
    assert c.costs.flops == unrolled.flops
    assert c.costs.matmul_flops == 15 * 2 * 16**3
    assert c.costs.transcendentals == unrolled.transcendentals == 15 * 256
    assert c.costs.flops <= rolled.flops <= 1.01 * c.costs.flops


def test_parser_consistent_with_cost_analysis_loop_free():
    def loss(w, x):
        h = torch.tanh(x @ w)
        h = torch.tanh(h @ w)
        return torch.sum(h**2)

    w = _meta(64, 64).requires_grad_()
    x = _meta(8, 64)
    _, c = count(lambda w, x: torch.autograd.grad(loss(w, x), w), w, x)

    def jloss(w, x):
        h = jnp.tanh(x @ w)
        h = jnp.tanh(h @ w)
        return jnp.sum(h**2)

    ref, comp = _ref(jax.grad(jloss), (64, 64), (8, 64))
    assert c.costs.matmul_flops == 5 * 2 * 8 * 64 * 64  # two forward products, three backward
    assert c.costs.matmul_flops == _dots(jax.grad(jloss), jax.ShapeDtypeStruct((64, 64), jnp.float32),
                                         jax.ShapeDtypeStruct((8, 64), jnp.float32))
    raw = comp.cost_analysis()["flops"]
    assert c.costs.flops == pytest.approx(raw, rel=0.1)
    assert ref.flops == pytest.approx(raw, rel=0.1)


def _reduced(arch):
    from repro.models.registry import get_model as jax_get_model

    from repro_torch.models.convert import params_from_arrays

    japi, api = jax_get_model(arch), get_model(arch)
    cfg = dataclasses.replace(japi.reduced, dtype="float32")
    tree = japi.init(jax.random.PRNGKey(0), cfg)
    return japi, api, cfg, tree, params_from_arrays(tree, dataclasses.replace(api.reduced, dtype="float32"),
                                                    device="cpu")


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "mamba2-780m"])
def test_reduced_forward_against_the_reference(arch):
    from repro.kernels import ops

    japi, api, cfg, tree, params = _reduced(arch)
    B, S = 2, 32
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (B, S)).astype(np.int32)
    (logits, _), c = count(lambda: api.module.forward(params, cfg, {"tokens": torch.from_numpy(tokens)}))
    ref_dots = _dots(lambda p, t: japi.forward(p, {"tokens": t}, cfg)[0], tree, jnp.asarray(tokens))
    kernel = sum(k["flops"] for k in c.costs.kernels.values())
    f32 = jnp.float32
    if cfg.family == "ssm":
        H, P, N, G = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state, cfg.ssm_groups
        core = _dots(lambda x, dt, A, Bm, Cm: ops.ssd_scan(x, dt, A, Bm, Cm, chunk=cfg.ssm_chunk)[0],
                     jax.ShapeDtypeStruct((B, S, H, P), f32), jax.ShapeDtypeStruct((B, S, H), f32),
                     jax.ShapeDtypeStruct((H,), f32), jax.ShapeDtypeStruct((B, S, G, N), f32),
                     jax.ShapeDtypeStruct((B, S, G, N), f32))
        assert c.costs.kernels["ssd_scan"] == {"calls": cfg.num_layers, "flops": cfg.num_layers * 4 * P * N * B * S * H,
                                               "bytes": c.costs.kernels["ssd_scan"]["bytes"]}
    else:
        H, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
        core = _dots(lambda q, k, v: ops.flash_attention(q, k, v, causal=True), jax.ShapeDtypeStruct((B, H, S, D), f32),
                     jax.ShapeDtypeStruct((B, Hkv, S, D), f32), jax.ShapeDtypeStruct((B, Hkv, S, D), f32))
        assert core == 4 * D * B * H * S * S  # the full masked scores
        assert kernel == cfg.num_layers * 4 * D * B * H * S * (S + 1) // 2  # the visible pairs
    assert c.costs.matmul_flops - kernel == ref_dots - cfg.num_layers * core
    assert logits.shape == (B, S, cfg.vocab) and not c.costs.unhandled


def test_kernel_formulas_give_the_recorded_bounds():
    """The formulas at the shapes of PERF.md §6's bounds, at the H100's
    peaks: the larger of FLOPs / 989e12 and bytes / 3.35e12."""
    def bound_ms(w):
        return 1e3 * max(w.flops / 989e12, w.bytes / 3.35e12)

    bf = torch.bfloat16
    q, k = torch.empty(1, 16, 891, 128, dtype=bf, device="meta"), torch.empty(1, 2, 891, 128, dtype=bf, device="meta")
    flash = work.flash_attention_work(q, k, causal=True, window=None)
    mask = attention_mask(891, 891, causal=True, window=None)
    assert flash.flops == 4 * 128 * 16 * int(mask.sum())
    assert round(bound_ms(flash), 6) == 0.003292
    lengths = torch.full((4,), 892, dtype=torch.int32)
    dec = work.decode_attention_work(torch.empty(4, 16, 128, dtype=bf), torch.empty(4, 2, 2048, 128, dtype=bf), lengths)
    assert round(bound_ms(dec), 6) == 0.0011
    x, Bm = torch.empty(1, 891, 48, 64, dtype=bf, device="meta"), torch.empty(1, 891, 1, 128, dtype=bf, device="meta")
    assert round(bound_ms(work.ssd_scan_work(x, Bm)), 6) == 0.003925


@pytest.mark.parametrize("Sq,Skv,causal,window", [(7, 7, True, None), (5, 9, True, 3), (9, 5, True, None),
                                                  (6, 11, False, 4), (1, 13, True, 5), (12, 12, False, None)])
def test_visible_pairs_follow_the_mask(Sq, Skv, causal, window):
    mask = attention_mask(Sq, Skv, causal=causal, window=window)
    pairs, keys = work.attention_visible(Sq, Skv, causal=causal, window=window)
    assert pairs == int(mask.sum()) and keys == int(mask.any(dim=0).sum())


def test_kernels_on_meta_launch_nothing_and_are_counted_once_a_call():
    before = (flash_attention_cuda.launches, decode_attention_cuda.launches, ssd_scan_cuda.launches)
    q = torch.empty(2, 4, 16, 64, dtype=torch.bfloat16, device="meta")
    kv = torch.empty(2, 2, 16, 64, dtype=torch.bfloat16, device="meta")
    x = torch.empty(2, 40, 4, 16, dtype=torch.bfloat16, device="meta")
    with OpCounter() as c:
        o = flash_attention_cuda(q, kv, kv)
        d = decode_attention_cuda(q[:, :, 0].contiguous(), kv, kv, torch.empty(2, dtype=torch.int32, device="meta"))
        y, s = ssd_scan_cuda(x, torch.empty(2, 40, 4, device="meta"), torch.empty(4, device="meta"),
                             torch.empty(2, 40, 1, 16, dtype=torch.bfloat16, device="meta"),
                             torch.empty(2, 40, 1, 16, dtype=torch.bfloat16, device="meta"), chunk=16)
    assert (o.shape, o.dtype, o.device.type) == (q.shape, q.dtype, "meta")
    assert d.shape == (2, 4, 64) and y.shape == x.shape and s.shape == (2, 4, 16, 16) and s.dtype == torch.float32
    assert {k: v["calls"] for k, v in c.costs.kernels.items()} == {"flash_attention": 1, "decode_attention": 1,
                                                                   "ssd_scan": 1}
    assert c.costs.kernels["decode_attention"]["flops"] == 4 * 64 * 4 * 2 * 16  # every key of the cache on meta
    assert (flash_attention_cuda.launches, decode_attention_cuda.launches, ssd_scan_cuda.launches) == before
    with pytest.raises(ValueError):  # the card's limits hold on meta: head width 12
        flash_attention_cuda(*(torch.empty(1, 2, 4, 12, device="meta"),) * 3)


def test_the_plain_version_inside_a_kernel_call_is_not_counted_again():
    """On the CPU the wrappers run their plain versions: the counter takes
    the kernel's formula and none of the plain version's ops."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 2, 8, 16, generator=g)
    k = torch.randn(1, 1, 8, 16, generator=g)
    with OpCounter() as c:
        flash_attention_cuda(q, k, k)
    w = work.flash_attention_work(q, k, causal=True, window=None)
    assert c.costs.flops == w.flops and c.costs.bytes == w.bytes and c.costs.matmul_flops == w.flops


def test_memory_follows_the_storages():
    a = torch.empty(1000, device="meta")
    with OpCounter(arguments=(a,)) as c:
        b = a * 2  # 4000 bytes live
        d = b + 1  # 8000
        del b  # 4000
        e = d.view(10, 100)  # a view: nothing new
        f = d.exp()  # 8000
        a.mul_(2)  # the argument written in place
    mem = c.memory(outputs=(f,))
    assert mem == {"argument_bytes": 4000, "output_bytes": 4000, "temp_bytes": 8000, "alias_bytes": 4000,
                   "peak_bytes": 12000}
    assert e.shape == (10, 100)


@pytest.mark.parametrize("threshold", [1, 100_000])
def test_a_storage_held_by_a_cycle_counts_until_the_count_ends(threshold):
    """Whether or not the collector would run between the ops (threshold 1:
    at almost every allocation), a storage that only a reference cycle
    holds stays live until the count ends: the peak does not depend on
    when Python collects."""
    import gc

    a = torch.empty(1000, device="meta")
    before = gc.get_threshold()
    gc.set_threshold(threshold)
    try:
        with OpCounter(arguments=(a,)) as c:
            for _ in range(3):
                b = a * 2  # 4000 bytes, held by a cycle alone once dropped
                cycle = [b]
                cycle.append(cycle)
                del b, cycle
                [object() for _ in range(10)]
            d = a + 1
        assert gc.isenabled()
    finally:
        gc.set_threshold(*before)
    assert c.memory(outputs=(d,))["temp_bytes"] == 16000


def test_the_hybrids_shared_block_counts_where_it_runs():
    """A deliberate departure (ROADMAP Queue C): the reference's scan runs
    zamba2's shared block under ``lax.cond`` and its HLO cost model takes
    the larger branch in every layer; the port's Python ``if`` runs, and
    its counter counts, the block after every ``hybrid_period``-th layer
    only.  The port's products outside the kernels equal the reference's
    dots less the shared block's in the layers where it does not run, less
    the attention and SSD cores, exactly."""
    from repro.kernels import ops
    from repro.models import hybrid as jhybrid

    from repro_torch.models.hybrid import num_shared_invocations

    japi, api, cfg, tree, params = _reduced("zamba2-7b")
    B, S = 2, 32
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (B, S)).astype(np.int32)
    (logits, _), c = count(lambda: api.module.forward(params, cfg, {"tokens": torch.from_numpy(tokens)}))
    n_inv, layers = num_shared_invocations(cfg), cfg.num_layers
    assert 0 < n_inv < layers and c.costs.kernels["flash_attention"]["calls"] == n_inv
    assert c.costs.kernels["ssd_scan"]["calls"] == layers
    f32 = jnp.float32
    x = jax.ShapeDtypeStruct((B, S, cfg.d_model), f32)
    H, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    attn_core = _dots(lambda q, k, v: ops.flash_attention(q, k, v, causal=True), jax.ShapeDtypeStruct((B, H, S, D), f32),
                      jax.ShapeDtypeStruct((B, Hkv, S, D), f32), jax.ShapeDtypeStruct((B, Hkv, S, D), f32))
    shared = _dots(lambda p, x: jhybrid._shared_forward(p, x, cfg), tree["shared"], x)
    Hs, P, N, G = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state, cfg.ssm_groups
    ssd_core = _dots(lambda x, dt, A, Bm, Cm: ops.ssd_scan(x, dt, A, Bm, Cm, chunk=cfg.ssm_chunk)[0],
                     jax.ShapeDtypeStruct((B, S, Hs, P), f32), jax.ShapeDtypeStruct((B, S, Hs), f32),
                     jax.ShapeDtypeStruct((Hs,), f32), jax.ShapeDtypeStruct((B, S, G, N), f32),
                     jax.ShapeDtypeStruct((B, S, G, N), f32))
    ref = _dots(lambda p, t: japi.forward(p, {"tokens": t}, cfg)[0], tree, jnp.asarray(tokens))
    kernel = sum(k["flops"] for k in c.costs.kernels.values())
    assert c.costs.matmul_flops - kernel == ref - layers * (shared + ssd_core) + n_inv * (shared - attn_core)


def test_bytes_are_each_eager_ops_operands_and_results():
    """The port's bytes notion (ROADMAP Queue C): every eager op is a
    fusion boundary, so ``a * 2 + 1`` moves a, the product, the product
    again and the sum, where XLA's fused loop would move a and the sum."""
    a = torch.empty(1000, device="meta")
    _, c = count(lambda a: a * 2 + 1, a)
    assert c.costs.bytes == 4 * 4000 and c.costs.flops == 2000


def test_an_exchanges_result_is_live_until_it_is_freed():
    """A weight gathered over model on (1, 4) is live from its exchange
    until it is freed: the plan's peak holds it beside the product that
    reads it, as a card's memory does (an exchange's result is made by an
    allocation, which no op counts), with the library's workspace that the
    product allocates."""
    from repro_torch.distributed.program import CountingComm
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.op_costs import LIBRARY_WORKSPACE_BYTES, OpCounter

    comm = CountingComm(make_mesh((1, 4), ("data", "model")))
    w = torch.empty(8, 16, device="meta")
    x = torch.empty(2, 32, device="meta")
    with OpCounter(arguments=(w, x)) as counter:
        whole = comm.all_gather(w, 0, ("model",))  # [32, 16] f32: 2,048 B
        y = x @ whole  # [2, 16] f32: 128 B
        del whole
        z = y * 2  # the gathered weight freed: 128 + 128 B
    assert counter.memory()["temp_bytes"] == LIBRARY_WORKSPACE_BYTES + 32 * 16 * 4 + 2 * 16 * 4
    assert counter.live == 2 * (2 * 16 * 4)
    del z


def test_the_librarys_workspace_is_live_from_the_first_product_on():
    """cuBLAS allocates its workspace at a process's first product and
    keeps it: a step with no product holds none of it, and in a step with
    one every peak after the product holds it beside the step's tensors,
    but no peak before it."""
    from repro_torch.launch.op_costs import LIBRARY_WORKSPACE_BYTES, OpCounter

    a = torch.empty(1000, device="meta")
    m = torch.empty(4, 4, device="meta")
    with OpCounter(arguments=(a, m)) as none:
        b = a * 2
        c = b + 1  # 8,000 B live
    assert none.memory()["temp_bytes"] == 8000
    with OpCounter(arguments=(a, m)) as one:
        b = a * 2
        c = b + 1
        del b, c
        d = m @ m  # 64 B beside the workspace
        e = d.exp()  # 128 B
    assert one.memory()["temp_bytes"] == LIBRARY_WORKSPACE_BYTES + 128
    assert one.memory()["peak_bytes"] == 4000 + 64 + LIBRARY_WORKSPACE_BYTES + 128
    assert LIBRARY_WORKSPACE_BYTES == 33_554_432 and e.shape == (4, 4)
