"""The dry-run: one device's share of every (architecture x shape suite x
mesh) cell, traced on meta tensors, and what it computes, stores and
exchanges.

The counterpart of the reference's ``repro/launch/dryrun.py``, which forces
512 host devices and compiles each cell's jitted step for them.  Here a cell
is built at the *local* shapes the rule tables give one device
(``distributed/sharding.py``): the model's parameters as their stored
slices, AdamW's state, the batch and the cache, and the step the port runs
(``make_train_step(remat=True, microbatches=)``, ``prefill`` or
``decode_step``) under the sharded program of that layout
(``distributed/program.py``), which puts each exchange between devices at
the point where it falls.  It runs on ``torch.device("meta")``: nothing is
allocated and no kernel launches; :class:`~repro_torch.launch.op_costs.
OpCounter` counts the ops, the kernels by their formulas, the exchanges and
the live bytes.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-3b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both --force

Results land in ``results/dryrun_torch/<arch>__<shape>__<mesh><tag>.json``
(existing cells are kept unless ``--force``).  A record has the reference's
keys where their meaning carries over: ``memory.{argument,output,temp,
alias,peak}_bytes``, ``cost.{flops_per_device,bytes_accessed_per_device}``,
``collectives`` (``bytes``, ``counts``, ``total_bytes``, by kind),
``model_flops_total`` (6 or 2 x active parameters x tokens), ``tokens``,
``params_total``, ``params_active`` and ``status`` (``error`` and
``traceback`` on an exception).  The port's own keys: ``trace_s`` (the
seconds the meta trace took, for the reference's ``lower_s`` and
``compile_s``), ``op_costs`` (for ``hlo_costs``: the counter's record),
``layout`` (how the attention, MLP and MoE compute: split over which axes,
the kv heads' mode), ``top_scopes`` (bytes and FLOPs by module) and
``kernel_launches`` (the kernel wrappers' launch counters' change, always
0).

``build_cell(..., comm=)`` builds the same cells as one device's share of a
real run over ``distributed/comm.py::DistComm``: a training step, a prefill
and a decode cell that carries its cache from tick to tick, each counted
alike, so that a real rank's counts can be held against the plan's.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import time
import traceback
from collections.abc import Callable, Mapping
from pathlib import Path

import torch

from repro_torch.configs.shapes import SHAPES, ShapeSuite, applicable_shapes
from repro_torch.distributed import hints
from repro_torch.distributed import program as D
from repro_torch.distributed.sharding import (
    ShardingPolicy,
    Spec,
    axes_of,
    batch_shardings,
    local_shape,
    logits_sharding,
    make_cache_shardings,
)
from repro_torch.launch import op_costs
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.models.registry import ALL_ARCHS, get_model
from repro_torch.optim import adamw
from repro_torch.train.train_step import make_train_step

RESULTS = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"

POLICIES: dict[str, ShardingPolicy] = {
    # baseline: FSDP parameters over data, TP over model, batch over (pod,) data
    "baseline": ShardingPolicy(dp_axes=("data",), tp_axes=("model",)),
    # pure data parallel: parameters FSDP over both axes, no TP (small models)
    "no-tp": ShardingPolicy(dp_axes=("data", "model"), tp_axes=()),
    # serving: TP-only parameters (no per-layer FSDP weight all-gather)
    "serve-tp": ShardingPolicy(dp_axes=("data",), tp_axes=("model",), param_fsdp_axes=()),
    # serving, weights split over both axes (256-way TP)
    "serve-tp2": ShardingPolicy(dp_axes=("data",), tp_axes=("data", "model"), param_fsdp_axes=()),
    # sequence-parallel residual stream (training)
    "seqpar": ShardingPolicy(dp_axes=("data",), tp_axes=("model",), sequence_parallel=True),
    # FSDP across pods too
    "fsdp-pod": ShardingPolicy(dp_axes=("data",), tp_axes=("model",), fsdp_over_pod=True),
    # sequence parallel + TP-only parameters
    "seqpar-tp": ShardingPolicy(dp_axes=("data",), tp_axes=("model",), sequence_parallel=True,
                                param_fsdp_axes=()),
    # sequence parallel + the MoE dispatch buffer's expert-parallel layout
    "seqpar-ep": ShardingPolicy(dp_axes=("data",), tp_axes=("model",), sequence_parallel=True),
}

# the @seqpar-ep cells' MoE buffer: experts over model, capacity over data,
# which keeps the token scatter with the batch and sequence shards
MOE_BUFFER_SPEC = ("model", "data", None)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _local_tree(tree, specs: Mapping[str, Spec], mesh: Mesh, device: torch.device | str = "meta",
                prefix: str = ""):
    """A cache (nested dicts and tuples of tensors) at one device's shapes,
    zeros on ``device`` (on meta, no data); the position kept."""
    if isinstance(tree, Mapping):
        return {k: _local_tree(v, specs, mesh, device, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_local_tree(v, specs, mesh, device, f"{prefix}{i}/") for i, v in enumerate(tree))
    if isinstance(tree, torch.Tensor):
        return torch.zeros(local_shape(tuple(tree.shape), specs[prefix[:-1]], mesh), dtype=tree.dtype, device=device)
    return tree


@dataclasses.dataclass
class Cell:
    """One device's step of a cell: ``run()`` runs it (the program and the
    hints installed), ``arguments`` are its inputs, ``params`` the model
    (stored slices), ``program`` its layout; a serving cell's ``cache`` is
    its device's cache as the last run left it."""

    run: Callable[..., object]
    arguments: tuple
    params: torch.nn.Module
    program: D.Program
    kind: str
    cache: dict | None = None


def activation_spec(mesh: Mesh, policy: ShardingPolicy) -> tuple | None:
    """The residual stream's spec under sequence parallelism, ``(dp, tp,
    None)`` as the reference's ``run_cell`` builds it, else None."""
    if not policy.sequence_parallel:
        return None
    dp = tuple(a for a in ("pod",) + policy.dp_axes if a in mesh.axis_names)
    tp = policy.tp_axes
    return (dp if len(dp) > 1 else dp[0], tp if len(tp) > 1 else (tp[0] if tp else None), None)


#: a drawn cache layer whose f32 draw is larger than this is drawn a batch
#: row at a time: drawn whole, a layer of zamba2-7b's shared cache at
#: ``decode_32k``'s fitting batch is 20 GB in f32 beside the device's share
#: of the cache; every layer of the transformers' cells served before is
#: at most this, so their draws are unchanged
DRAW_WHOLE_BYTES = 2**32


def _draw_cache(cache: Mapping, specs: Mapping[str, Spec], mesh: Mesh, rank: int, seed: int,
                device: torch.device, prefix: str = "", gen: torch.Generator | None = None):
    """Device ``rank``'s share of a cache of ``cache``'s global shapes filled
    with standard normal values from ``seed``: every leaf (``kv/<slot>/{k,
    v}``, ``layers/{ssm, conv}``, ``shared_kv/{k, v}``, ``self_*``,
    ``cross_*``, each ``[layers, ...]``) in the order of
    ``sharding.cache_leaves``, each layer's slice drawn whole on ``device``
    (a batch row at a time past ``DRAW_WHOLE_BYTES``) and cut, so the shares
    are those of one whole cache and no device holds it whole: each slice is
    copied into the device's leaf, so a draw is freed before the next.  The
    position is kept."""
    from repro_torch.distributed.comm import local_slices, take_local

    gen = gen or torch.Generator(device=device).manual_seed(seed)
    if isinstance(cache, Mapping):
        return {k: _draw_cache(v, specs, mesh, rank, seed, device, f"{prefix}{k}/", gen) for k, v in cache.items()}
    if isinstance(cache, (tuple, list)):
        return type(cache)(_draw_cache(v, specs, mesh, rank, seed, device, f"{prefix}{i}/", gen)
                           for i, v in enumerate(cache))
    if not isinstance(cache, torch.Tensor):
        return cache
    spec = specs[prefix[:-1]]
    mine = torch.empty(local_shape(tuple(cache.shape), spec, mesh), dtype=cache.dtype, device=device)
    layer_shape = tuple(cache.shape[1:])
    by_rows = 4 * math.prod(layer_shape) > DRAW_WHOLE_BYTES
    rows = local_slices(layer_shape, spec[1:], mesh, rank)[0]  # this device's batch rows
    for layer in range(cache.shape[0]):
        if not by_rows:
            whole = torch.randn(layer_shape, generator=gen, device=device).to(cache.dtype)
            mine[layer] = take_local(whole, spec[1:], mesh, rank)
            del whole
            continue
        for b in range(layer_shape[0]):
            whole = torch.randn(layer_shape[1:], generator=gen, device=device).to(cache.dtype)
            if rows.start <= b < rows.stop:
                mine[layer, b - rows.start] = take_local(whole, spec[2:], mesh, rank)
            del whole
    return mine


def kv_cache_of(cache: Mapping) -> torch.Tensor | None:
    """The first layer's KV cache ``[B, Hkv, S, D]`` of a family's first
    attention (``kv/0/k``, ``shared_kv/k`` or ``self_k``), or None where the
    cache holds no keys (an SSM, a hybrid too shallow for a shared
    invocation)."""
    if "kv" in cache:
        leaf = cache["kv"][0]["k"]
    elif "shared_kv" in cache:
        leaf = cache["shared_kv"]["k"]
    elif "self_k" in cache:
        leaf = cache["self_k"]
    else:
        return None
    return leaf[0] if leaf.shape[0] else None


def _cut_cache(cache: Mapping, specs: Mapping[str, Spec], mesh: Mesh, rank: int, device: torch.device,
               prefix: str = ""):
    """Device ``rank``'s share of a whole cache (its tensors cut, on
    ``device``; the position kept)."""
    from repro_torch.distributed.comm import take_local

    if isinstance(cache, Mapping):
        return {k: _cut_cache(v, specs, mesh, rank, device, f"{prefix}{k}/") for k, v in cache.items()}
    if isinstance(cache, (tuple, list)):
        return type(cache)(_cut_cache(v, specs, mesh, rank, device, f"{prefix}{i}/") for i, v in enumerate(cache))
    if isinstance(cache, torch.Tensor):
        return take_local(cache.to(device), specs[prefix[:-1]], mesh, rank)
    return cache


def build_cell(arch: str, shape: str | ShapeSuite, mesh: Mesh, policy: ShardingPolicy, *,
               microbatches: int = 1, cfg=None, comm=None,
               source: torch.nn.Module | torch.Generator | None = None,
               batch: Mapping[str, torch.Tensor] | None = None, opt_cfg: adamw.AdamWConfig | None = None,
               remat: bool = True, cache: Mapping | int | Cell | None = None) -> Cell:
    """One device's step of ``arch`` at ``shape`` (a suite's name, or a
    suite of its own) on ``mesh`` under ``policy``, at the local shapes, on
    meta (``cfg``: another config of the architecture, e.g. one cut in
    depth; ``batch``: inputs whose shapes replace the suite's, e.g. a prompt
    shorter than a prefill suite's cache).

    With ``comm`` (``distributed/comm.py::DistComm``) the same cell is
    device ``comm.rank``'s share of a real step.  ``source`` is a whole
    model of ``cfg``, cut in place to the device's stored slices, or a
    seeded ``torch.Generator`` on the device's card, from which the model is
    drawn a module at a time and cut (``Program.localize``: a model that
    fits no card).  ``batch`` (whole) is cut to the device's rows.

    * ``train``: AdamW's state (``opt_cfg``) is made at the local shapes on
      the model's device; ``run()`` steps on from the last run's state.
    * ``prefill``: ``batch`` holds ``tokens [B, S]`` (and the family's
      extras); the prompt's keys go into a zero cache of the suite's length
      (``make_cache_shardings``); ``run()`` gives the last position's logits
      in the layout of ``logits_sharding`` and the cache, kept in
      ``cell.cache``.
    * ``decode``: ``batch`` holds ``token [B]``, and ``cache`` is a seed (a
      cache of the suite's length drawn from it, at its last position, so
      that every row sees all its keys, as the plan on meta), a whole cache
      (cut to the device's share), or a prefill cell whose model, program
      and cache this cell continues; ``run(token=None)`` decodes ``token``
      (whole ``[B]``; default ``batch``'s) and carries the cache to the next
      run."""
    api = get_model(arch)
    cfg = cfg or api.config
    suite = SHAPES[shape] if isinstance(shape, str) else shape
    real = comm is not None
    if real and (source is None and not isinstance(cache, Cell) or batch is None):
        raise ValueError("a real backend runs a step of a given model and batch: give the whole model "
                         "(or a seeded generator) and batch")
    if real and suite.kind == "decode" and cache is None:
        raise ValueError("a real decode cell needs a cache: a seed, a whole cache or a prefill cell")
    if batch is None:
        batch = api.batch_specs(cfg, suite)
    bspecs = batch_shardings(mesh, cfg, batch, policy)
    if real:
        from repro_torch.distributed.comm import take_local

        local_batch = {k: take_local(x, bspecs[k], mesh, comm.rank) for k, x in batch.items()}
    else:
        local_batch = {k: _meta(local_shape(tuple(x.shape), bspecs[k], mesh), x.dtype) for k, x in batch.items()}
    if isinstance(cache, Cell):  # a decode continuing a prefill cell
        params, program = cache.params, cache.program
    else:
        first = "token" if suite.kind == "decode" else "tokens"
        batch_axes = axes_of(bspecs[first][0])
        seq = 1 if suite.kind == "decode" else suite.seq_len + (cfg.num_patches if cfg.family == "vlm" else 0)
        params = source if real and isinstance(source, torch.nn.Module) else api.param_specs(cfg)
        program = D.Program(mesh, policy, cfg, params, batch_axes=batch_axes, seq_len=seq, comm=comm)
        program.localize(params, source=source if real else None)
    lcfg = program.local_config()

    def installed():
        stack = contextlib.ExitStack()
        stack.enter_context(D.installed(program))
        stack.enter_context(hints.activation_pspec(activation_spec(mesh, policy)))
        return stack

    if suite.kind == "train":
        opt_cfg = opt_cfg or adamw.AdamWConfig()
        opt_state = adamw.init(opt_cfg, params)
        step = make_train_step(api, lcfg, opt_cfg, remat=remat, microbatches=microbatches)

        carried = [opt_state]  # each run steps on from the last one's state

        def run():
            with installed():
                out = step(params, carried[0], local_batch)
            carried[0] = out[1]
            return out

        return Cell(run, (params, opt_state, local_batch), params, program, "train")

    whole_cache = api.cache_specs(cfg, suite)
    cspecs = make_cache_shardings(mesh, cfg, whole_cache, policy)
    device = next(params.parameters()).device  # meta for the plan
    if isinstance(cache, Cell):
        local_cache = cache.cache
    elif not real or suite.kind == "prefill":
        local_cache = _local_tree(whole_cache, cspecs, mesh, device)
    elif isinstance(cache, int):
        local_cache = _draw_cache(whole_cache, cspecs, mesh, comm.rank, cache, device)
    else:
        local_cache = _cut_cache(cache, cspecs, mesh, comm.rank, device)
    if not isinstance(cache, Cell):
        program.add_cache(local_cache, cspecs)
    B = suite.global_batch
    logits_spec = logits_sharding(mesh, cfg, B, policy)
    logits_shape = local_shape((B, cfg.vocab), logits_spec, mesh)

    if suite.kind == "prefill":
        extras = {k: v for k, v in local_batch.items() if k != "tokens"}

        def run():
            with installed(), torch.no_grad():
                logits, out = api.prefill(params, local_batch["tokens"], local_cache, lcfg, **extras)
                cell.cache = out
                return program.to_layout(logits, logits_shape, logits_spec), out

        cell = Cell(run, (params, local_batch, local_cache), params, program, "prefill", local_cache)
        return cell

    if not real or isinstance(cache, int):
        local_cache["pos"] = suite.seq_len - 1  # a full cache: every row sees all its keys

    def run(token: torch.Tensor | None = None):
        tok = local_batch["token"]
        if token is not None:
            from repro_torch.distributed.comm import take_local

            tok = take_local(token, bspecs["token"], mesh, comm.rank)
        with installed(), torch.no_grad():
            logits, out = api.decode_step(params, tok, cell.cache, lcfg)
            cell.cache = out
            return program.to_layout(logits, logits_shape, logits_spec), out

    cell = Cell(run, (params, local_batch["token"], local_cache), params, program, "decode", local_cache)
    return cell


def _launches() -> dict[str, int]:
    from repro_torch.kernels.decode_attention import decode_attention_cuda, decode_attention_state_cuda
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.makespan import population_makespan_cuda
    from repro_torch.kernels.ssd_scan import ssd_scan_cuda

    return {f.__name__: f.launches for f in (flash_attention_cuda, decode_attention_cuda, decode_attention_state_cuda,
                                             ssd_scan_cuda, population_makespan_cuda)}


def layout(program: D.Program) -> dict:
    """How the cell's modules compute (``distributed/program.py``)."""
    out = {"attention": None if program.attention is None else dataclasses.asdict(program.attention),
           "vocab_axes": list(program.vocab_axes), "sequence_parallel": list(program._sp_axes)}
    mods = {}
    for plan in program.modules.values():
        if not plan.heads:
            mods.setdefault(plan.moe_mode or plan.kind, set()).add(tuple(plan.axes))
    out["modules"] = {k: sorted(list(a) for a in v) for k, v in mods.items()}
    return out


def count_cell(cell: Cell, *, scopes: bool = True) -> tuple[object, op_costs.OpCounter]:
    """Run one cell's step under a fresh counter."""
    counter = op_costs.OpCounter(arguments=cell.arguments,
                                 scopes=op_costs.module_scopes(cell.params) if scopes else None)
    with counter:
        out = cell.run()
    return out, counter


def run_cell(arch: str, shape: str, mesh_kind: str, *, force: bool = False,
             policy: ShardingPolicy | None = None, tag: str = "", microbatches: int = 1,
             mesh: Mesh | None = None, write: bool = True) -> dict:
    """One cell's record (module docstring), written to :data:`RESULTS`
    unless ``write`` is False; a cell already written is read back unless
    ``force``.  ``mesh``: another mesh than the production one of
    ``mesh_kind``."""
    name = f"{arch}__{shape}__{mesh_kind}{tag}"
    out_path = RESULTS / f"{name}.json"
    if write and out_path.exists() and not force:
        return json.loads(out_path.read_text())
    t0 = time.time()
    mesh = mesh or make_production_mesh(multi_pod=(mesh_kind == "multi"))
    policy = policy or POLICIES["baseline"]
    record: dict = {"arch": arch, "shape": shape, "mesh": mesh_kind, "tag": tag,
                    "mesh_shape": mesh.shape, "status": "unknown"}
    launches = _launches()
    try:
        moe_spec = MOE_BUFFER_SPEC if tag.startswith("@seqpar-ep") else None
        with hints.moe_buffer_pspec(moe_spec):
            cell = build_cell(arch, shape, mesh, policy, microbatches=microbatches)
            out, counter = count_cell(cell)
        trace_s = time.time() - t0
        costs = counter.costs.to_json()
        outputs = out[2] if cell.kind == "train" else out[0]
        cfg = get_model(arch).config
        suite = SHAPES[shape]
        if suite.kind == "decode":
            tokens = suite.global_batch
        else:
            tokens = suite.global_batch * suite.seq_len
        model_flops = (6 if suite.kind == "train" else 2) * cfg.active_param_count() * tokens
        record.update(
            status="ok",
            trace_s=round(trace_s, 2),
            memory=counter.memory(outputs),
            cost={"flops_per_device": costs["flops"], "bytes_accessed_per_device": costs["bytes"]},
            op_costs=costs,
            collectives={"bytes": costs["collective_bytes"], "counts": costs["collective_counts"],
                         "total_bytes": costs["collective_total_bytes"]},
            model_flops_total=model_flops,
            tokens=tokens,
            params_total=cfg.param_count(),
            params_active=cfg.active_param_count(),
            layout=layout(cell.program),
            top_scopes=[list(r) for r in op_costs.by_scope(counter, top=8)],
        )
    except Exception as e:  # a failed cell is a fault to fix, recorded with its cause
        record.update(status="error", error=f"{type(e).__name__}: {e}",
                      traceback=traceback.format_exc()[-2000:])
    after = _launches()
    record["kernel_launches"] = {k: after[k] - launches[k] for k in after}
    if write:
        RESULTS.mkdir(parents=True, exist_ok=True)
        out_path.write_text(json.dumps(record, indent=2))
    if record["status"] == "ok":
        print(f"[ok   ] {name}  trace={record['trace_s']}s flops/dev={record['cost']['flops_per_device']:.3e} "
              f"peak={record['memory']['peak_bytes'] / 1e9:.2f}GB "
              f"collective={record['collectives']['total_bytes'] / 1e9:.3f}GB", flush=True)
    else:
        print(f"[error] {name}  {record.get('error', '')[:200]}", flush=True)
    return record


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=ALL_ARCHS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=("single", "multi", "both"), default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--policy", choices=list(POLICIES), default="baseline",
                    help="sharding-policy preset")
    ap.add_argument("--microbatches", type=int, default=1)
    args = ap.parse_args(argv)

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.all:
        cells = [(arch, shape) for arch in ALL_ARCHS for shape in applicable_shapes(arch)]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        cells = [(args.arch, args.shape)]
    tag = "" if args.policy == "baseline" else f"@{args.policy}"
    if args.microbatches > 1:
        tag += f"@mb{args.microbatches}"
    t0 = time.time()
    failures = 0
    launches = _launches()
    for mesh_kind in meshes:
        for arch, shape in cells:
            rec = run_cell(arch, shape, mesh_kind, force=args.force, policy=POLICIES[args.policy], tag=tag,
                           microbatches=args.microbatches)
            failures += rec["status"] != "ok"
    after = _launches()
    moved = {k: after[k] - launches[k] for k in after}
    print(f"done: {len(cells) * len(meshes)} cells, {failures} failures in {time.time() - t0:.1f} s; "
          f"kernel launches {json.dumps(moved)}", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
