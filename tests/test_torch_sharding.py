"""The port's sharding rule tables (``distributed/sharding.py``) and mesh
against the reference's, in process: ``repro.distributed.sharding`` does
not reach ``repro.core``, and its rules run on a
``jax.sharding.AbstractMesh``, which needs no devices.

For every architecture's *full* config, on the meshes (16, 16), (2, 16, 16)
and (2, 4), under every preset of the dry-run's ``POLICIES``, exactly:

* every port parameter's spec is the reference's ``param_spec`` of its
  stacked leaf without the leading (layer) entry, and its local shape the
  reference's ``NamedSharding(mesh, spec).shard_shape`` without that axis;
* the AdamW state's specs mirror the parameters' and the step's is
  replicated, as the reference's;
* the batch's, the cache's (every applicable suite) and the logits' specs
  and local shapes equal the reference's.  Under ``serve-tp2`` (tensor
  parallel over data and model, the batch over data) the reference's rule
  gives a KV cache whose kv heads divide data x model a spec that maps
  ``data`` twice, which ``NamedSharding`` refuses; the port's spec is the
  same and its ``local_shape`` refuses it too.
"""

import jax
import pytest
import torch
from jax._src.named_sharding import DuplicateSpecError
from jax.sharding import AbstractMesh, NamedSharding, PartitionSpec as P
from repro.configs.shapes import SHAPES
from repro.distributed import sharding as rs
from repro.models.registry import get_model as jax_get_model
from repro.optim import adamw as jadamw

from repro_torch.distributed import sharding as ps
from repro_torch.launch.dryrun import POLICIES
from repro_torch.launch.mesh import make_mesh, make_production_mesh, required_devices
from repro_torch.models.registry import ALL_ARCHS, get_model
from repro_torch.optim import adamw

MESHES = [((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model")), ((2, 4), ("data", "model"))]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def ref_path(name: str, family: str) -> tuple[str, bool]:
    """The reference's pytree path of a port parameter, and whether its
    leaf is stacked on a leading layer axis."""
    parts = name.split(".")
    if parts[0] in ("blocks", "enc_blocks", "dec_blocks"):
        if family in ("dense", "moe", "vlm"):  # blocks.<slot>.<group>.…
            return "/".join(parts[:2] + parts[3:]), True
        return "/".join(parts[:1] + parts[2:]), True  # blocks.<layer>.…
    return "/".join(parts), False


def _ref_policy(policy: ps.ShardingPolicy) -> rs.ShardingPolicy:
    return rs.ShardingPolicy(**{f: getattr(policy, f) for f in rs.ShardingPolicy.__dataclass_fields__})


def _leaves(tree) -> dict[str, object]:
    return {rs._norm_path(kp): leaf for kp, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def test_mesh_values():
    assert make_production_mesh().shape == {"data": 16, "model": 16}
    assert make_production_mesh(multi_pod=True).shape == {"pod": 2, "data": 16, "model": 16}
    assert make_production_mesh(multi_pod=True).size == required_devices(True) == 512
    assert make_production_mesh().size == required_devices(False) == 256
    assert make_mesh((2, 4), ("data", "model")).shape == {"data": 2, "model": 4}
    with pytest.raises(ValueError):
        make_mesh((2, 4), ("data",))


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_every_spec_equals_the_reference(arch):
    japi, api = jax_get_model(arch), get_model(arch)
    cfg, jcfg = api.config, japi.config
    params = api.param_specs(cfg)
    named = dict(params.named_parameters())
    ref_params = _leaves(japi.param_specs(jcfg))
    ref_opt = jax.eval_shape(lambda p: jadamw.init(jadamw.AdamWConfig(), p), japi.param_specs(jcfg))
    opt = adamw.init(adamw.AdamWConfig(), params)
    paths = {k: ref_path(k, cfg.family) for k in named}
    assert {p for p, _ in paths.values()} == set(ref_params)
    suites = {s: SHAPES[s] for s in api.shapes()}
    duplicates = set()
    for sizes, axes in MESHES:
        mesh, amesh = make_mesh(sizes, axes), AbstractMesh(sizes, axes)
        for pname, policy in POLICIES.items():
            rp = _ref_policy(policy)
            what = f"{arch} {sizes} {pname}"
            specs = ps.make_param_shardings(mesh, cfg, params, policy)
            ref_specs = {path: rs.param_spec(path, leaf.shape, jcfg, amesh, rp) for path, leaf in ref_params.items()}
            ref_local = {path: NamedSharding(amesh, spec).shard_shape(ref_params[path].shape)
                         for path, spec in ref_specs.items()}
            for k, p in named.items():
                path, stacked = paths[k]
                want = tuple(ref_specs[path])
                want = want[1:] if stacked else want
                assert specs[k] == want, (what, k)
                local = ref_local[path][1:] if stacked else ref_local[path]
                assert ps.local_shape(tuple(p.shape), specs[k], mesh) == local, (what, k)
            # AdamW: the moments mirror the parameters, the step is replicated
            ref_o = rs.make_opt_shardings(amesh, jcfg, ref_opt, rs.make_param_shardings(amesh, jcfg, japi.param_specs(jcfg), rp), rp)
            o = ps.make_opt_shardings(mesh, cfg, opt, specs, policy)
            assert sorted(o) == sorted(ref_opt) and o["step"] == tuple(ref_o["step"].spec) == ()
            for key in ("m", "v"):
                ref_m = {rs._norm_path(kp): tuple(s.spec) for kp, s in jax.tree_util.tree_leaves_with_path(
                    ref_o[key], is_leaf=lambda x: isinstance(x, NamedSharding))}
                for k in named:
                    path, stacked = paths[k]
                    assert o[key][k] == (ref_m[path][1:] if stacked else ref_m[path]), (what, key, k)
            for sname, suite in suites.items():
                batch, ref_batch = api.batch_specs(cfg, suite), japi.batch_specs(jcfg, suite)
                b = ps.batch_shardings(mesh, cfg, batch, policy)
                rb = rs.batch_shardings(amesh, jcfg, ref_batch, rp)
                assert sorted(b) == sorted(rb)
                for k in b:
                    assert b[k] == tuple(rb[k].spec), (what, sname, k)
                    assert ps.local_shape(tuple(batch[k].shape), b[k], mesh) == rb[k].shard_shape(ref_batch[k].shape)
                assert ps.logits_sharding(mesh, cfg, suite.global_batch, policy) == tuple(
                    rs.logits_sharding(amesh, jcfg, suite.global_batch, rp).spec), (what, sname)
                if suite.kind == "train":
                    continue
                cache = api.cache_specs(cfg, suite)
                ref_cache = _leaves(japi.cache_specs(jcfg, suite))
                c = ps.make_cache_shardings(mesh, cfg, cache, policy)
                # the reference's make_cache_shardings, spec by spec (its
                # NamedSharding refuses some of its own specs, below)
                rc = {path: P() if path.endswith("pos") else rs.cache_spec(path, leaf.shape, jcfg, amesh, rp)
                      for path, leaf in ref_cache.items()}
                assert sorted(c) == sorted(rc)
                for path, leaf in ps.cache_leaves(cache):
                    assert c[path] == tuple(rc[path]), (what, sname, path)
                    if not isinstance(leaf, torch.Tensor):
                        continue
                    try:
                        want = NamedSharding(amesh, rc[path]).shard_shape(ref_cache[path].shape)
                    except DuplicateSpecError:  # the reference's own fault (ROADMAP Queue C)
                        with pytest.raises(ValueError, match="more than one dimension"):
                            ps.local_shape(tuple(leaf.shape), c[path], mesh)
                        duplicates.add((arch, sizes, pname, sname))
                        continue
                    assert ps.local_shape(tuple(leaf.shape), c[path], mesh) == want, (what, sname, path)
    assert all(p == "serve-tp2" for _, _, p, _ in duplicates), duplicates


def test_a_dimension_that_does_not_divide_degrades_to_replication():
    """The reference's fallback (sharding.py:55-67): the full axis tuple if
    it divides, else the longest suffix that does, else replicated."""
    mesh, amesh = make_mesh((2, 16, 16), ("pod", "data", "model")), AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    for dim in (1, 2, 16, 24, 32, 48, 512, 1500, 51865):
        for axes in (("pod", "data"), ("data", "model"), ("pod", "data", "model"), ("model",), ()):
            assert ps._fit(mesh, axes, dim) == rs._fit(amesh, axes, dim), (dim, axes)


def test_qwen_k_projection_splits_inside_a_head():
    """qwen2.5-3b's k projection [2048, 256] splits its columns 16 ways on
    (16, 16): 16 columns a device, 1/8 of a 128-wide head."""
    cfg = get_model("qwen2.5-3b").config
    mesh = make_production_mesh()
    spec = ps.param_spec("blocks.0.0.attn.k.w", (2048, 256), cfg, mesh, POLICIES["baseline"])
    assert spec == ("data", "model")
    assert ps.local_shape((2048, 256), spec, mesh) == (128, 16)
    assert tuple(rs.param_spec("blocks/0/attn/k/w", (36, 2048, 256), jax_get_model("qwen2.5-3b").config,
                               AbstractMesh((16, 16), ("data", "model")), rs.ShardingPolicy())) == (None, "data", "model")
