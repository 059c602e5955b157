"""The dry-run (``launch/dryrun.py``), the registry's dry-run specs and the
activation hints, against the reference, in process.

* Registry specs, exactly: ``batch_specs``, ``param_specs`` and
  ``cache_specs`` give the reference's ``jax.eval_shape`` leaves in shape
  and dtype (parameters through convert's names, each layer of a stacked
  leaf a module of its own; the cache's position is a Python int in the
  port and is left out), for every architecture x applicable suite, every
  tensor on meta: nothing allocated.
* The cells of ``tests/test_dryrun_lowering.py`` reach ``status == "ok"``
  on the mesh (2, 4): qwen2.5-3b ``decode_32k``, mamba2-780m ``train_4k``
  and qwen3-moe-30b-a3b ``decode_32k`` under ``baseline``; qwen2.5-3b
  ``decode_32k`` under ``serve-tp`` and ``serve-tp2``; qwen2.5-3b
  ``train_4k`` under ``seqpar`` with the activation hint.  Each cell's
  per-device argument bytes equal the sum of the reference's shard shapes
  of the same arguments (parameters; AdamW's moments and step; the batch;
  the cache less its position), exactly, and no kernel launch counter
  moves.
* The MoE buffer's spec (``@seqpar-ep``) lays the buffer out: equal to
  the port's own layout on (data, model), a gather over pods on (pod,
  data, model); an expert split that does not divide degrades to none.
* With no hint and no sharded program installed, every hook returns its
  input object itself, and a reduced forward on the CPU gives the same bits
  as one whose hooks are replaced by the identity.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding
from repro.configs.shapes import SHAPES
from repro.distributed import sharding as rs
from repro.models.registry import get_model as jax_get_model

from repro_torch.configs.shapes import ShapeSuite
from repro_torch.distributed import hints
from repro_torch.distributed import program as D
from repro_torch.kernels.decode_attention import decode_attention_cuda
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.ssd_scan import ssd_scan_cuda
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.registry import ALL_ARCHS, get_model
from test_torch_sharding import ref_path


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _leaves(tree) -> dict:
    return {rs._norm_path(kp): leaf for kp, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def _dtype(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_registry_specs_equal_the_reference(arch):
    japi, api = jax_get_model(arch), get_model(arch)
    cfg, jcfg = api.config, japi.config
    assert api.shapes() == japi.shapes()
    params = api.param_specs(cfg)
    ref = _leaves(japi.param_specs(jcfg))
    layers: dict[str, int] = {}
    for k, p in params.named_parameters():
        assert p.device.type == "meta", k
        path, stacked = ref_path(k, cfg.family)
        want = ref[path]
        assert tuple(p.shape) == (want.shape[1:] if stacked else want.shape), k
        assert _dtype(p) == str(want.dtype), k
        layers[path] = layers.get(path, 0) + (1 if stacked else want.shape[0] if want.shape else 1)
    # every leaf covered: a stacked leaf once a layer
    assert layers == {path: leaf.shape[0] if leaf.shape else 1 for path, leaf in ref.items()}
    for sname in api.shapes():
        suite = SHAPES[sname]
        batch, jbatch = api.batch_specs(cfg, suite), japi.batch_specs(jcfg, suite)
        assert sorted(batch) == sorted(jbatch)
        for k, t in batch.items():
            assert (t.device.type, tuple(t.shape), _dtype(t)) == ("meta", jbatch[k].shape, str(jbatch[k].dtype))
        if suite.kind == "train":
            continue
        from repro_torch.distributed.sharding import cache_leaves

        cache = dict(cache_leaves(api.cache_specs(cfg, suite)))
        jcache = _leaves(japi.cache_specs(jcfg, suite))
        assert sorted(cache) == sorted(jcache)
        for path, t in cache.items():
            if path.endswith("pos"):
                assert t == 0 and jcache[path].shape == ()
                continue
            assert (t.device.type, tuple(t.shape), _dtype(t)) == ("meta", jcache[path].shape, str(jcache[path].dtype))


def _ref_argument_bytes(arch: str, shape: str, amesh, policy) -> int:
    """The bytes of one device's shards of the reference's arguments of the
    cell (the cache's position left out)."""
    from repro.optim import adamw as jadamw

    japi = jax_get_model(arch)
    cfg, suite = japi.config, SHAPES[shape]
    rp = rs.ShardingPolicy(**{f: getattr(policy, f) for f in rs.ShardingPolicy.__dataclass_fields__})

    def nbytes(leaf, spec) -> int:
        return int(np.prod(NamedSharding(amesh, spec).shard_shape(leaf.shape))) * np.dtype(leaf.dtype).itemsize

    params = _leaves(japi.param_specs(cfg))
    specs = {p: rs.param_spec(p, leaf.shape, cfg, amesh, rp) for p, leaf in params.items()}
    total = sum(nbytes(leaf, specs[p]) for p, leaf in params.items())
    batch = japi.batch_specs(cfg, suite)
    bspecs = rs.batch_shardings(amesh, cfg, batch, rp)
    total += sum(nbytes(batch[k], bspecs[k].spec) for k in batch)
    if suite.kind == "train":
        opt = jax.eval_shape(lambda p: jadamw.init(jadamw.AdamWConfig(), p), japi.param_specs(cfg))
        for key in ("m", "v"):
            total += sum(nbytes(leaf, specs[p]) for p, leaf in _leaves(opt[key]).items())
        total += np.dtype(opt["step"].dtype).itemsize
    else:
        for path, leaf in _leaves(japi.cache_specs(cfg, suite)).items():
            if not path.endswith("pos"):
                total += nbytes(leaf, rs.cache_spec(path, leaf.shape, cfg, amesh, rp))
    return total


CELLS = [
    ("qwen2.5-3b", "decode_32k", "baseline"),
    ("mamba2-780m", "train_4k", "baseline"),
    ("qwen3-moe-30b-a3b", "decode_32k", "baseline"),
    ("qwen2.5-3b", "decode_32k", "serve-tp"),
    ("qwen2.5-3b", "decode_32k", "serve-tp2"),
    ("qwen2.5-3b", "train_4k", "seqpar"),
]


@pytest.mark.parametrize("arch,shape,policy", CELLS)
def test_lowering_cells_are_ok_on_meta(arch, shape, policy):
    mesh = make_mesh((2, 4), ("data", "model"))
    launches = (flash_attention_cuda.launches, decode_attention_cuda.launches, ssd_scan_cuda.launches)
    rec = dryrun.run_cell(arch, shape, "2x4", policy=dryrun.POLICIES[policy], mesh=mesh, write=False,
                          tag=f"@{policy}")
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["memory"]["argument_bytes"] == _ref_argument_bytes(arch, shape, AbstractMesh((2, 4), ("data", "model")),
                                                                  dryrun.POLICIES[policy])
    assert rec["kernel_launches"] == {k: 0 for k in rec["kernel_launches"]}
    assert launches == (flash_attention_cuda.launches, decode_attention_cuda.launches, ssd_scan_cuda.launches)
    assert rec["cost"]["flops_per_device"] > 0 and rec["memory"]["peak_bytes"] >= rec["memory"]["argument_bytes"]
    assert not rec["op_costs"]["unhandled"], rec["op_costs"]["unhandled"]
    if policy == "seqpar":
        assert rec["layout"]["sequence_parallel"] == ["model"]
        assert rec["collectives"]["counts"].get("reduce-scatter", 0) > 0
    if shape == "decode_32k" and policy == "baseline" and arch == "qwen2.5-3b":
        # 16 query heads over 4 devices, 2 kv heads: gathered whole (ROADMAP)
        assert rec["layout"]["attention"]["kv_mode"] == "gather"


def _moe_counts(arch, mesh, spec, **replace):
    cfg = dataclasses.replace(get_model(arch).reduced, **replace)
    suite = ShapeSuite("x", "train", 64, 16)
    with hints.moe_buffer_pspec(spec):
        cell = dryrun.build_cell(arch, suite, mesh, dryrun.POLICIES["seqpar-ep"], cfg=cfg)
        _, counter = dryrun.count_cell(cell, scopes=False)
    return counter.costs.to_json(), dryrun.layout(cell.program)["modules"]


def test_the_moe_buffer_spec_lays_the_buffer_out():
    """``@seqpar-ep``'s buffer spec (experts over model, capacity over
    data) against none: on (data, model) the port's own layout is already
    that one, so every count is equal; on (pod, data, model) the spec leaves
    the capacity whole over pods, so the whole batch's buffer is summed over
    pods (an all-reduce where the capacity is otherwise reduce-scattered
    over pods too) and the experts compute both pods' tokens (ROADMAP Queue
    C).  Either way the buffer is the whole batch's, summed over the token
    axes: no all-to-all."""
    flat = make_mesh((2, 4), ("data", "model"))
    assert _moe_counts("qwen3-moe-30b-a3b", flat, None) == _moe_counts("qwen3-moe-30b-a3b", flat,
                                                                        dryrun.MOE_BUFFER_SPEC)
    pods = make_mesh((2, 2, 4), ("pod", "data", "model"))
    (plain, modules), (ep, ep_modules) = (_moe_counts("qwen3-moe-30b-a3b", pods, spec)
                                          for spec in (None, dryrun.MOE_BUFFER_SPEC))
    assert modules == ep_modules and ["model"] in modules["experts"]
    assert ep["flops"] > plain["flops"]
    assert ep["collective_bytes"]["all-reduce"] > plain["collective_bytes"]["all-reduce"]
    assert ep["collective_bytes"]["reduce-scatter"] > plain["collective_bytes"]["reduce-scatter"]
    assert "all-to-all" not in ep["collective_bytes"] and "all-to-all" not in plain["collective_bytes"]


def test_a_moe_buffer_spec_that_does_not_divide_the_experts_degrades():
    """4 experts over model 8: the spec's expert split degrades to none, as
    the rule tables' ``_fit`` does, and the experts compute split by ffn
    columns as the rule tables store them (GSPMD would pad the experts)."""
    mesh = make_mesh((2, 8), ("data", "model"))
    plain, modules = _moe_counts("mixtral-8x7b", mesh, None, num_experts=4)
    ep, ep_modules = _moe_counts("mixtral-8x7b", mesh, dryrun.MOE_BUFFER_SPEC, num_experts=4)
    assert modules == ep_modules and "ffn" in modules and "experts" not in modules
    assert plain == ep


def test_a_moe_buffer_spec_installed_after_the_program_raises():
    cfg = get_model("qwen3-moe-30b-a3b").reduced
    cell = dryrun.build_cell("qwen3-moe-30b-a3b", ShapeSuite("x", "train", 64, 16), make_mesh((2, 4), ("data", "model")),
                             dryrun.POLICIES["seqpar-ep"], cfg=cfg)
    with hints.moe_buffer_pspec(dryrun.MOE_BUFFER_SPEC), pytest.raises(ValueError, match="installed after"):
        dryrun.count_cell(cell, scopes=False)


def test_a_one_device_mesh_exchanges_nothing():
    """On (1, 1) the program is the plain step: no exchange, and the same
    FLOPs as the step run with no program at all."""
    cfg = dataclasses.replace(get_model("qwen2.5-3b").reduced, num_layers=2)
    mesh = make_mesh((1, 1), ("data", "model"))
    cell = dryrun.build_cell("qwen2.5-3b", "train_4k", mesh, dryrun.POLICIES["baseline"], cfg=cfg)
    _, counter = dryrun.count_cell(cell, scopes=False)
    assert not counter.costs.collective_bytes
    from repro_torch.launch.op_costs import OpCounter
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import make_train_step

    api = get_model("qwen2.5-3b")
    params = api.param_specs(cfg)
    opt_cfg = adamw.AdamWConfig()
    state = adamw.init(opt_cfg, params)
    batch = api.batch_specs(cfg, SHAPES["train_4k"])
    with OpCounter(arguments=(params, state, batch)) as plain:
        make_train_step(api, cfg, opt_cfg, remat=True)(params, state, batch)
    assert plain.costs.flops == counter.costs.flops
    assert plain.memory()["argument_bytes"] == counter.memory()["argument_bytes"]


def test_hooks_are_the_identity_when_nothing_is_installed():
    assert hints.get_activation_pspec() is None and D.current() is None
    x = torch.randn(2, 3, 4)
    w = torch.randn(4, 4)
    assert hints.constrain(x) is x and hints.constrain_moe_buffer(x) is x
    assert D.weight(w) is w and D.enter(x, torch.nn.Linear(1, 1)) is x and D.exit(x, torch.nn.Linear(1, 1)) is x
    assert D.kv_heads(x) is x and D.decode_query(x, x) is x and D.decode_combine(x, w, x) is x
    assert D.kv_select(x, w, 3) == (x, w) and D.prompt_slice(x, w) is None and D.cache_span(x) == (0, 4)
    assert D.moe_dispatch(x, None) is x and D.moe_return(x, None, 4) is x
    assert D.moe_enter(x, None) == (x, x) and D.moe_gates(w, None) is w and D.moe_aux_share(w, None) is w
    assert D.moe_rows(24, None) == 24 and D.moe_offsets(w, 4, 2, None) is None and D.moe_token_devices(None) == 1
    g = {"a": x}
    assert D.data_parallel_grads(g, None) is g


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "qwen3-moe-30b-a3b", "mamba2-780m", "zamba2-7b", "whisper-base"])
def test_hints_off_change_no_bit(arch, monkeypatch):
    api = get_model(arch)
    cfg = dataclasses.replace(api.reduced, dtype="float32")
    params = api.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32))}
    if cfg.family == "encdec":
        batch["frames"] = torch.from_numpy(rng.standard_normal((2, cfg.enc_frames, cfg.d_model)).astype(np.float32))
    with hints.activation_pspec(None):
        logits, _ = api.forward(params, batch, cfg)
    identity = {
        "weight": lambda w: w, "enter": lambda x, m: x, "exit": lambda y, m: y, "kv_heads": lambda t: t,
        "kv_select": lambda k, v, h: (k, v), "lookup": lambda tok, t: tok[t],
        "moe_dispatch": lambda b, m: b, "moe_return": lambda o, m, e: o,
    }
    for name, fn in identity.items():
        monkeypatch.setattr(D, name, fn)
    monkeypatch.setattr(hints, "constrain", lambda x: x)
    monkeypatch.setattr(hints, "constrain_moe_buffer", lambda b: b)
    again, _ = api.forward(params, batch, cfg)
    assert torch.equal(logits, again)


@pytest.mark.parametrize("arch,kind", [("qwen2.5-3b", "train"), ("mamba2-780m", "train"), ("qwen2.5-3b", "decode"),
                                       ("qwen3-moe-30b-a3b", "train"), ("zamba2-7b", "decode")])
def test_meta_takes_no_other_branch(arch, kind):
    """A one-device cell on meta against the same step run on the CPU
    (reduced config, random weights): the same FLOPs and argument bytes, and
    for training the same peak (the CPU's plain decode kernel keeps
    temporaries of its own inside the kernel's call)."""
    from repro_torch.launch.op_costs import OpCounter
    from repro_torch.models import layers as L
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import make_train_step

    api = get_model(arch)
    cfg = api.reduced
    B, S = 2, 32
    one = make_mesh((1, 1), ("data", "model"))
    cell = dryrun.build_cell(arch, ShapeSuite("x", kind, S, B), one, dryrun.POLICIES["baseline"], cfg=cfg)
    _, meta = dryrun.count_cell(cell, scopes=False)
    g = torch.Generator().manual_seed(0)
    params = api.init(g, cfg, device="cpu")
    if kind == "train":
        L.trainable(params)
        opt_cfg = adamw.AdamWConfig()
        state = adamw.init(opt_cfg, params)
        batch = {"tokens": torch.randint(0, cfg.vocab, (B, S), dtype=torch.int32, generator=g)}
        args = (params, state, batch)
        with OpCounter(arguments=args) as cpu:
            make_train_step(api, cfg, opt_cfg, remat=True)(*args)
    else:
        cache = api.init_cache(B, S, cfg, device="cpu")
        cache["pos"] = S - 1
        token = torch.randint(0, cfg.vocab, (B,), dtype=torch.int32, generator=g)
        args = (params, token, cache)
        with OpCounter(arguments=args) as cpu, torch.no_grad():
            api.decode_step(params, token, cache, cfg)
    assert meta.costs.flops == cpu.costs.flops and meta.costs.kernels == cpu.costs.kernels
    assert meta.memory()["argument_bytes"] == cpu.memory()["argument_bytes"]
    if kind == "train":
        assert meta.memory()["peak_bytes"] == cpu.memory()["peak_bytes"]


@pytest.mark.parametrize("whole_bytes", [dryrun.DRAW_WHOLE_BYTES, 0], ids=["layers-whole", "batch-rows"])
def test_a_drawn_cache_is_every_devices_share_of_one_whole_cache(whole_bytes, monkeypatch):
    """A cache drawn from a seed on (2, 2), its kv heads over model and its
    batch over data: every device's leaves are its slices of one whole
    cache drawn in the same order, a layer at a time or, past
    ``DRAW_WHOLE_BYTES``, a batch row at a time; the position is kept."""
    from repro_torch.distributed.comm import local_slices

    monkeypatch.setattr(dryrun, "DRAW_WHOLE_BYTES", whole_bytes)
    mesh = make_mesh((2, 2), ("data", "model"))
    shape = (3, 4, 2, 6, 5)
    cache = {"layers": {"k": torch.zeros(shape), "v": torch.zeros(shape)}, "pos": 0}
    specs = {"layers/k": (None, "data", "model", None, None), "layers/v": (None, "data", "model", None, None),
             "pos": ()}
    g = torch.Generator().manual_seed(7)
    whole = {name: torch.empty(shape) for name in ("k", "v")}
    for t in whole.values():
        for layer in range(shape[0]):
            if whole_bytes:
                t[layer] = torch.randn(shape[1:], generator=g)
            else:
                for b in range(shape[1]):
                    t[layer, b] = torch.randn(shape[2:], generator=g)
    for rank in range(4):
        out = dryrun._draw_cache(cache, specs, mesh, rank, 7, torch.device("cpu"))
        assert out["pos"] == 0
        for name, t in whole.items():
            assert torch.equal(out["layers"][name], t[local_slices(shape, specs[f"layers/{name}"], mesh, rank)])


@pytest.mark.parametrize("whole_bytes", [dryrun.DRAW_WHOLE_BYTES, 0], ids=["layers-whole", "batch-rows"])
def test_a_drawn_cache_of_one_sequence_is_every_devices_cut_of_one_whole_draw(whole_bytes, monkeypatch):
    """A ``long_500k``-like cache on (1, 4): a batch of one, its kv heads
    over model (the row not split).  Every device's leaves are its cut of
    the cache drawn whole from the same seed on a mesh of one, a layer at a
    time or, past ``DRAW_WHOLE_BYTES``, the one row at a time; the position
    is kept."""
    from repro_torch.distributed.comm import local_slices

    monkeypatch.setattr(dryrun, "DRAW_WHOLE_BYTES", whole_bytes)
    mesh, one = make_mesh((1, 4), ("data", "model")), make_mesh((1, 1), ("data", "model"))
    shape = (3, 1, 4, 6, 5)
    cache = {"kv": ({"k": torch.zeros(shape), "v": torch.zeros(shape)},), "pos": 41}
    specs = {"kv/0/k": (None, "data", "model", None, None), "kv/0/v": (None, "data", "model", None, None),
             "pos": ()}
    whole = dryrun._draw_cache(cache, specs, one, 0, 7, torch.device("cpu"))
    assert whole["pos"] == 41
    for rank in range(4):
        out = dryrun._draw_cache(cache, specs, mesh, rank, 7, torch.device("cpu"))
        assert out["pos"] == 41
        for name in ("k", "v"):
            got, want = out["kv"][0][name], whole["kv"][0][name]
            assert got.shape == (3, 1, 1, 6, 5)
            assert torch.equal(got, want[local_slices(shape, specs[f"kv/0/{name}"], mesh, rank)])
