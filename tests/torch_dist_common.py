"""Gloo process groups for the port's sharded tests.

``run_group(job, world, params, tmp)`` starts ``world`` child processes,
this file run as a script, each a rank of one gloo group that meets through
a ``FileStore`` in ``tmp`` (no port to share between pytest workers).  Each
child sets one torch thread, calls ``JOBS[job](rank, world, params, tmp)``
and writes what it returns (a dict of numpy arrays and numbers) to
``tmp/out_<rank>.npz``.  A child that fails, or a group that outlasts its
timeout, fails the caller with the children's output; every child is
killed before ``run_group`` returns.

The jobs (:data:`JOBS`) run the port alone, on the CPU; the reference's
numbers reach them as inputs (``tmp/inputs.npz``) from the test.
"""

from __future__ import annotations

import datetime
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parents[1] / "src"
TESTS = Path(__file__).resolve().parent

#: seconds a group's rendezvous and each of its collectives may wait
GROUP_TIMEOUT = 120


def run_group(job: str, world: int, params: dict, tmp: Path, timeout: float = 300.0) -> list[dict]:
    """Run ``job`` on ``world`` gloo ranks; returns each rank's outputs."""
    tmp = Path(tmp)
    tmp.mkdir(parents=True, exist_ok=True)
    (tmp / "params.json").write_text(json.dumps(params))
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join([str(SRC), str(TESTS), env.get("PYTHONPATH", "")])
    logs = [open(tmp / f"log_{r}.txt", "w") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, __file__, job, str(r), str(world), str(tmp)], env=env,
                              stdout=log, stderr=subprocess.STDOUT) for r, log in enumerate(logs)]
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if time.monotonic() > deadline:
                raise TimeoutError(f"group {job!r} outlasted {timeout} s")
            if any(p.poll() not in (None, 0) for p in procs):
                time.sleep(1.0)  # let the others report the failure too
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for log in logs:
            log.close()
    if any(p.returncode != 0 for p in procs) or any(not (tmp / f"out_{r}.npz").exists() for r in range(world)):
        text = "\n".join(f"--- rank {r} (rc {p.returncode}) ---\n{(tmp / f'log_{r}.txt').read_text()[-3000:]}"
                         for r, p in enumerate(procs))
        raise RuntimeError(f"group {job!r} failed:\n{text}")
    out = []
    for r in range(world):
        with np.load(tmp / f"out_{r}.npz", allow_pickle=False) as f:
            out.append({k: f[k] for k in f.files})
    return out


def _child(job: str, rank: int, world: int, tmp: Path) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp / 'store'}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT))
    try:
        params = json.loads((tmp / "params.json").read_text())
        result = JOBS[job](rank, world, params, tmp)
        np.savez(tmp / f"out_{rank}.npz", **{k: np.asarray(v) for k, v in result.items()})
    finally:
        dist.destroy_process_group()


# -----------------------------------------------------------------------------
# the jobs: one rank's side
# -----------------------------------------------------------------------------

TOL = {"loss": 1e-4, "atol": 2e-4, "rtol": 2e-3}  # the reference's (tests/test_distributed.py:142)


def _inputs(tmp: Path) -> dict:
    path = tmp / "inputs.npz"
    if not path.exists():
        return {}
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def reduced(arch: str = "qwen2.5-3b", overrides: dict | None = None):
    """A reduced config in f32 (``overrides`` replaced in it), its weights
    from seed 0, and the reference test's batch (8 x 32 tokens from numpy's
    seed 1)."""
    import dataclasses

    import torch

    from repro_torch.models.registry import get_model

    api = get_model(arch)
    cfg = dataclasses.replace(api.reduced, dtype="float32", **(overrides or {}))
    params = api.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab, (8, 32)).astype(np.int32))
    return api, cfg, params, tokens


def _counts(counter) -> str:
    j = counter.costs.to_json()
    return json.dumps({"arguments": counter.memory()["argument_bytes"], "flops": j["flops"],
                       "collective_counts": j["collective_counts"], "collective_bytes": j["collective_bytes"],
                       "kernels": j["kernels"]}, sort_keys=True)


def train_case(rank: int, shape: tuple[int, int], policy: str, remat: bool, steps: int = 2,
               arch: str = "qwen2.5-3b", overrides: dict | None = None) -> dict:
    """Two AdamW steps of a reduced config (:func:`reduced`) sharded on
    ``shape`` (data, model) under ``policy``, against the same steps of the
    whole model in this process; the first step's gradients (from AdamW's
    first moment after step 1) against the whole model's; and the first
    sharded step's counts against the dry-run's plan of the same cell on
    meta.  The parameters gathered whole (``whole/<name>``) go to the test,
    which holds them against the reference's sharded step."""
    import copy

    import torch

    from repro_torch.configs.shapes import ShapeSuite
    from repro_torch.distributed.comm import DistComm
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import layers as L
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import make_train_step

    mesh = make_mesh(shape, ("data", "model"))
    comm = DistComm(mesh, rank, "gloo")
    api, cfg, whole, tokens = reduced(arch, overrides)
    batch = {"tokens": tokens, **extras(cfg, tokens.shape[0])}
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=0, schedule="constant")
    one = L.trainable(copy.deepcopy(whole))
    state = adamw.init(opt_cfg, one)
    single = make_train_step(api, cfg, opt_cfg, remat=remat)
    suite = ShapeSuite("x", "train", tokens.shape[1], tokens.shape[0])
    pol = dryrun.POLICIES[policy]
    cell = dryrun.build_cell(arch, suite, mesh, pol, cfg=cfg, comm=comm, source=whole,
                             batch=batch, opt_cfg=opt_cfg, remat=remat)
    plan = dryrun.build_cell(arch, suite, mesh, pol, cfg=cfg, batch=batch, opt_cfg=opt_cfg, remat=remat)
    _, planned = dryrun.count_cell(plan, scopes=False)
    losses, single_losses, norms, single_norms = [], [], [], []
    grad_err, grads_close, grad_worst = 0.0, True, ""
    for i in range(steps):
        _, state, m1 = single(one, state, batch)
        if i == 0:
            (_, opt, m2), counted = dryrun.count_cell(cell, scopes=False)
            # AdamW's m after step 1 is (1 - beta1) * clip * g: the first gradients
            scale = [min(1.0, opt_cfg.grad_clip / (float(m["grad_norm"]) + 1e-9)) for m in (m1, m2)]
            for k, t in opt["m"].items():
                g = cell.program.comm.gather_whole(t, cell.program.specs[k]) / ((1 - opt_cfg.beta1) * scale[1])
                ref = state["m"][k] / ((1 - opt_cfg.beta1) * scale[0])
                err = float((g - ref).abs().max())
                if err > grad_err:
                    grad_err, grad_worst = err, k
                grads_close &= bool(torch.allclose(g, ref, atol=TOL["atol"], rtol=TOL["rtol"]))
        else:
            _, _, m2 = cell.run()
        losses.append(float(m2["loss"]))
        single_losses.append(float(m1["loss"]))
        norms.append(float(m2["grad_norm"]))
        single_norms.append(float(m1["grad_norm"]))
    got = cell.program.whole(cell.params)
    errs, close = [], True
    for k, p in one.named_parameters():
        a, b = p.detach(), got[k]
        errs.append(float((a - b).abs().max()))
        close &= bool(torch.allclose(b, a, atol=TOL["atol"], rtol=TOL["rtol"]))
    return {
        "losses": np.array(losses), "single_losses": np.array(single_losses),
        "norms": np.array(norms), "single_norms": np.array(single_norms),
        "param_max_err": max(errs), "params_close": close, "grad_max_err": grad_err, "grads_close": grads_close,
        "grad_worst": grad_worst,
        **{f"whole/{k}": t.numpy() for k, t in got.items()},
        "plan": _counts(planned), "counted": _counts(counted),
        "layout": json.dumps(dryrun.layout(cell.program), sort_keys=True),
    }


#: the sharded serving cases' sizes: a batch of 4 prompts of 5 tokens into a
#: cache of 32 positions (a device's share of a sequence split 4 ways starts
#: at 8, past the prompt), then 4 greedy ticks; the reduced mixtral's window
#: of 8 is a ring buffer split 2 positions a device, which the ticks pass
SERVE = {"batch": 4, "prompt": 5, "max_len": 32, "ticks": 4}


def extras(cfg, rows: int) -> dict:
    """The family's inputs beside the tokens for a batch of ``rows``, f32
    from numpy's seed 3, scaled by 0.1: the vlm's patches ``[B, P, d]``, the
    encoder-decoder's frames ``[B, F, d]``; none for the others."""
    import torch

    what = {"vlm": ("patches", cfg.num_patches), "encdec": ("frames", cfg.enc_frames)}.get(cfg.family)
    if what is None:
        return {}
    rng = np.random.default_rng(3)
    name, n = what
    return {name: torch.from_numpy((rng.standard_normal((rows, n, cfg.d_model)) * 0.1).astype(np.float32))}


def serve_single(arch: str):
    """One device's serving of a reduced config (:func:`reduced`), the whole
    model with no program: the prompts (from numpy's seed 2) behind the
    family's extras (:func:`extras`), the logits of the prefill and of
    each greedy tick ``[1 + ticks, B, V]``, the greedy tokens ``[ticks, B]``
    int32, and the whole cache after the prefill."""
    import copy

    import torch

    api, cfg, whole, _ = reduced(arch)
    prompt = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab, (SERVE["batch"], SERVE["prompt"]))
                              .astype(np.int32))
    with torch.no_grad():
        cache = api.init_cache(SERVE["batch"], SERVE["max_len"], cfg, device="cpu")
        logits, cache = api.prefill(whole, prompt, cache, cfg, **extras(cfg, SERVE["batch"]))
        prefilled = copy.deepcopy(cache)
        steps, tokens = [logits], []
        for _ in range(SERVE["ticks"]):
            tokens.append(steps[-1].argmax(-1).to(torch.int32))
            logits, cache = api.decode_step(whole, tokens[-1], cache, cfg)
            steps.append(logits)
    return prompt, torch.stack(steps), torch.stack(tokens), prefilled


def serve_case(rank: int, arch: str, shape: tuple[int, int], policy: str) -> dict:
    """A prefill and greedy decode ticks of a reduced config (:func:`reduced`)
    sharded on ``shape`` (data, model) under ``policy`` through
    ``dryrun.build_cell(..., comm=)``: each step's logits in the layout of
    ``logits_sharding`` (``local_<i>``) and gathered whole (``logits_<i>``),
    against one device's prefill and ticks of the whole model in this
    process (:func:`serve_single`), on its greedy tokens; the prefill's and
    a full-cache tick's counts against the dry-run's plan of the same cells
    on meta; the first attention's cache span (none for an SSM), the
    encoder-decoder's cross cache span and the SSM states' stored shape.  A
    vlm's prefill also runs without its patches (``no_patches_diff``: how
    far its logits move), so that the patches are seen to reach the
    model."""
    import torch

    from repro_torch.configs.shapes import ShapeSuite
    from repro_torch.distributed.comm import DistComm
    from repro_torch.distributed.sharding import logits_sharding
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh(shape, ("data", "model"))
    comm = DistComm(mesh, rank, "gloo")
    api, cfg, _, _ = reduced(arch)
    pol = dryrun.POLICIES[policy]
    B, T = SERVE["batch"], SERVE["ticks"]
    prompt, single, tokens, prefilled = serve_single(arch)
    batch = {"tokens": prompt, **extras(cfg, SERVE["batch"])}
    pre = ShapeSuite("p", "prefill", SERVE["max_len"], B)
    dec = ShapeSuite("d", "decode", SERVE["max_len"], B)
    spec = logits_sharding(mesh, cfg, B, pol)
    # the sharded cells on the same weights (the source is cut in place: a copy)
    source = reduced(arch)[2]
    plan = dryrun.build_cell(arch, pre, mesh, pol, cfg=cfg, batch=batch)
    _, planned = dryrun.count_cell(plan, scopes=False)
    cell = dryrun.build_cell(arch, pre, mesh, pol, cfg=cfg, comm=comm, source=source, batch=batch)
    (local, _), counted = dryrun.count_cell(cell, scopes=False)
    kv = dryrun.kv_cache_of(cell.cache)  # the first attention's keys; None for an SSM
    out = {"prefill_plan": _counts(planned), "prefill_counted": _counts(counted),
           "layout": json.dumps(dryrun.layout(cell.program), sort_keys=True),
           "seq_axes": json.dumps([] if kv is None else list(cell.program.cache_seq_axes(kv))),
           "cache_span": np.array([] if kv is None else cell.program.cache_span(kv)),
           "logits_spec": json.dumps(spec)}
    if cfg.family == "encdec":  # the cross cache's span of the frames
        out["cross_span"] = np.array(cell.program.cache_span(cell.cache["cross_k"][0]))
    if "layers" in cell.cache:  # the Mamba2 states' stored shape
        out["ssm_shape"] = np.array(cell.cache["layers"]["ssm"].shape)
    got = [local]
    ticks = dryrun.build_cell(arch, dec, mesh, pol, cfg=cfg, comm=comm, batch={"token": tokens[0]}, cache=cell)
    for t in range(T):
        got.append(ticks.run(tokens[t])[0])
    for i, (a, b) in enumerate(zip(got, single)):
        out[f"local_{i}"] = a.numpy()
        w = comm.gather_whole(a, spec)
        out[f"logits_{i}"] = w.numpy()
        out[f"err_{i}"] = float((w - b).abs().max())
    # a decode cell from one device's whole cache after the prefill, cut to
    # this device's share: its first tick
    cut = dryrun.build_cell(arch, dec, mesh, pol, cfg=cfg, comm=comm, source=reduced(arch)[2],
                            batch={"token": tokens[0]}, cache=prefilled)
    out["whole_cache_err"] = float((comm.gather_whole(cut.run()[0], spec) - single[1]).abs().max())
    if cfg.family == "vlm":  # the same prompt without its patches
        bare = dryrun.build_cell(arch, pre, mesh, pol, cfg=cfg, comm=comm, source=reduced(arch)[2],
                                 batch={"tokens": prompt})
        out["no_patches_diff"] = float((comm.gather_whole(bare.run()[0], spec) - single[0]).abs().max())
    # a tick at a full cache drawn from a seed: its counts against the plan's
    plan = dryrun.build_cell(arch, dec, mesh, pol, cfg=cfg)
    _, planned = dryrun.count_cell(plan, scopes=False)
    full = dryrun.build_cell(arch, dec, mesh, pol, cfg=cfg, comm=comm, source=reduced(arch)[2],
                             batch={"token": tokens[0]}, cache=7)
    _, counted = dryrun.count_cell(full, scopes=False)
    out["decode_plan"], out["decode_counted"] = _counts(planned), _counts(counted)
    return out


#: the ``long_500k`` cell cut to size: batch 1 against a cache of 40
#: positions drawn from numpy's seed 4 at its last position, 39, then 4
#: greedy ticks (positions 39-42), so the reduced windows of 8 wrap during
#: them (slots 7, 0, 1, 2) and so does every cache of 40 (slot 0 at 40);
#: ``seed`` draws the cache of the seeded cell (``cache=<seed>``)
LONG = {"seq_len": 40, "ticks": 4, "cache_seed": 4, "token_seed": 5, "seed": 9}
#: the reduced gemma2-2b's and mixtral-8x7b's 2 kv heads split a cache by its
#: sequence on (1, 4); 4 kv heads split it by heads, as the full configs' do
LONG_HEADS = {"num_heads": 8, "num_kv_heads": 4}


def long_suite():
    from repro_torch.configs.shapes import ShapeSuite

    return ShapeSuite("long_500k", "decode", LONG["seq_len"], 1)


def long_cache(arch: str, overrides: dict | None) -> dict:
    """A whole cache of the reduced config (:func:`reduced`) at
    :func:`long_suite`, every leaf standard normal from numpy's seed
    ``LONG["cache_seed"]`` in the order of ``sharding.cache_leaves``, at
    the suite's last position."""
    import torch

    from repro_torch.distributed.sharding import cache_leaves

    api, cfg, _, _ = reduced(arch, overrides)
    cache = api.init_cache(1, LONG["seq_len"], cfg, device="cpu")
    rng = np.random.default_rng(LONG["cache_seed"])
    for path, leaf in cache_leaves(cache):
        if isinstance(leaf, torch.Tensor):
            leaf.copy_(torch.from_numpy(rng.standard_normal(tuple(leaf.shape)).astype(np.float32)))
    cache["pos"] = LONG["seq_len"] - 1
    return cache


def long_single(arch: str, overrides: dict | None):
    """One device's greedy ticks of the reduced config from
    :func:`long_cache`, the whole model with no program: the token fed at
    each tick ``[ticks, 1]`` int32 (the first from numpy's seed
    ``LONG["token_seed"]``) and each tick's logits ``[ticks, 1, V]``."""
    import torch

    api, cfg, whole, _ = reduced(arch, overrides)
    cache = long_cache(arch, overrides)
    tokens = [torch.from_numpy(np.random.default_rng(LONG["token_seed"]).integers(0, cfg.vocab, (1,))
                               .astype(np.int32))]
    steps = []
    with torch.no_grad():
        for t in range(LONG["ticks"]):
            logits, cache = api.decode_step(whole, tokens[-1], cache, cfg)
            steps.append(logits)
            if t + 1 < LONG["ticks"]:
                tokens.append(logits.argmax(-1).to(torch.int32))
    return torch.stack(tokens), torch.stack(steps)


def long_case(rank: int, arch: str, overrides: dict | None) -> dict:
    """The ``long_500k`` tick of a reduced config on (1, 4) under
    ``serve-tp`` through ``dryrun.build_cell(..., comm=, cache=<whole>)``:
    the whole cache of :func:`long_cache` cut to this device's share, then
    greedy ticks on this group's own tokens, each step's logits gathered
    whole (``logits_<i>``, ``err_<i>`` against :func:`long_single`) and its
    tokens (``tokens``); the first tick's counts against the dry-run's plan
    of the cell on meta, as a seeded cell's (``cache=<seed>``) are; the
    seeded cell's leaves against this device's cut of one whole draw on a
    mesh of one (``seed_cut_equal``)."""
    import torch

    from repro_torch.distributed.comm import DistComm, take_local
    from repro_torch.distributed.sharding import cache_leaves, logits_sharding, make_cache_shardings
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh((1, 4), ("data", "model"))
    comm = DistComm(mesh, rank, "gloo")
    api, cfg, _, _ = reduced(arch, overrides)
    pol = dryrun.POLICIES["serve-tp"]
    suite = long_suite()
    tokens, single = long_single(arch, overrides)
    spec = logits_sharding(mesh, cfg, 1, pol)
    plan = dryrun.build_cell(arch, suite, mesh, pol, cfg=cfg)
    _, planned = dryrun.count_cell(plan, scopes=False)
    cell = dryrun.build_cell(arch, suite, mesh, pol, cfg=cfg, comm=comm, source=reduced(arch, overrides)[2],
                             batch={"token": tokens[0]}, cache=long_cache(arch, overrides))
    (local, _), counted = dryrun.count_cell(cell, scopes=False)
    kv = dryrun.kv_cache_of(cell.cache)
    out = {"plan": _counts(planned), "counted": _counts(counted),
           "seq_axes": json.dumps([] if kv is None else list(cell.program.cache_seq_axes(kv)))}
    own = [tokens[0]]
    for t in range(LONG["ticks"]):
        if t:
            local = cell.run(own[-1])[0]
        w = comm.gather_whole(local, spec)
        out[f"logits_{t}"] = w.numpy()
        out[f"err_{t}"] = float((w - single[t]).abs().max())
        if t + 1 < LONG["ticks"]:
            own.append(w.argmax(-1).to(torch.int32))
    out["tokens"] = torch.stack(own).numpy()
    # a cell of a cache drawn from a seed: this device's cut of one whole draw
    seeded = dryrun.build_cell(arch, suite, mesh, pol, cfg=cfg, comm=comm, source=reduced(arch, overrides)[2],
                               batch={"token": tokens[0]}, cache=LONG["seed"])
    one = make_mesh((1, 1), ("data", "model"))
    whole_specs = api.cache_specs(cfg, suite)
    whole = dryrun._draw_cache(whole_specs, make_cache_shardings(one, cfg, whole_specs, pol), one, 0, LONG["seed"],
                               torch.device("cpu"))
    specs = make_cache_shardings(mesh, cfg, whole_specs, pol)
    mine = dict(cache_leaves(seeded.cache))
    out["seed_cut_equal"] = all(torch.equal(mine[p], take_local(t, specs[p], mesh, rank))
                                for p, t in cache_leaves(whole) if isinstance(t, torch.Tensor))
    out["seed_pos"] = int(mine["pos"])
    _, counted = dryrun.count_cell(seeded, scopes=False)
    out["seed_counted"] = _counts(counted)
    return out


def _whole_ref(params) -> dict:
    return {k: p.detach().clone() for k, p in params.named_parameters()}


def bodies(rank: int) -> dict:
    """Each rank-aware body alone on (2, 4) under ``baseline`` (the
    reduced qwen2.5-3b: one query head a device, kv heads gathered, the
    vocabulary over model, the batch over data), held against the same
    function of the whole model on this rank's share."""
    import torch

    from repro_torch.distributed import program as D
    from repro_torch.distributed.comm import DistComm, take_local
    from repro_torch.distributed.sharding import batch_shardings
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import layers as L
    from repro_torch.optim import adamw
    from repro_torch.train.losses import next_token_loss

    mesh = make_mesh((2, 4), ("data", "model"))
    comm = DistComm(mesh, rank, "gloo")
    api, cfg, model, tokens = reduced()
    whole = _whole_ref(model)
    prog = D.Program(mesh, dryrun.POLICIES["baseline"], cfg, model, batch_axes=("data",), seq_len=tokens.shape[1],
                     comm=comm)
    prog.localize(model, source=model)
    spec = batch_shardings(mesh, cfg, {"tokens": tokens})["tokens"]
    mine = take_local(tokens, spec, mesh, rank)
    rows = take_local(torch.arange(tokens.shape[0]), spec[:1], mesh, rank)
    out = {}
    g = torch.Generator().manual_seed(3)
    # the whole model's side, with no program installed
    mask = torch.from_numpy((np.arange(8 * 32).reshape(8, 32) % (3 + np.arange(8)[:, None]) != 0)
                            .astype(np.float32))
    full = torch.randn(8, 32, cfg.vocab, generator=g)
    ref_loss, ref_m = next_token_loss(full, tokens, cfg, mask=mask)
    names = ["blocks.0.0.attn.q.w", "blocks.0.0.ln_attn.scale"]
    grads = {k: torch.randn(whole[k].shape, generator=g) for k in names}
    ref_norm = float(adamw.global_norm(grads))
    with torch.no_grad(), D.installed(prog):
        # kv_select: the kv heads [B, Hkv, S, D] whole; this device's query head reads its group's
        k = torch.randn(2, cfg.num_kv_heads, 5, cfg.resolved_head_dim, generator=g)
        v = torch.randn(k.shape, generator=g)
        heads = prog.attention.heads
        ka, va = D.kv_select(k, v, heads)
        first_q = prog.index(prog.attention.axes) * heads
        group = cfg.num_heads // cfg.num_kv_heads
        want = slice(first_q // group, first_q // group + ka.shape[1])
        out["kv_select_group"] = first_q // group
        out["kv_select_ok"] = bool(torch.equal(ka, k[:, want]) and torch.equal(va, v[:, want]))
        # lookup: this device's rows of the table, summed over the vocabulary's devices
        x = L.embed(model.embed, mine, cfg)
        out["lookup_err"] = float((x - whole["embed.tok"][mine.long()]).abs().max())
        # logsumexp (a max over the devices, then a sum) and pick on this device's columns
        logits = torch.randn(tokens.shape[0], tokens.shape[1], cfg.vocab, generator=g)[rows]
        cols = prog._own(logits, -1, prog.vocab_axes)
        out["vocab_first"] = prog.index(prog.vocab_axes) * cols.shape[-1]
        out["logsumexp_err"] = float((D.logsumexp(cols) - torch.logsumexp(logits, -1)).abs().max())
        tgt = mine.long()
        out["pick_err"] = float((D.pick(cols, tgt) - logits.gather(-1, tgt[..., None])[..., 0]).abs().max())
        # the loss's mean over every device's targets, with a mask that differs by rows
        _, m = next_token_loss(prog._own(full[rows], -1, prog.vocab_axes), mine, cfg, mask=mask[rows])
        out["tokens"] = float(m["tokens"])
        out["tokens_ref"] = float(ref_m["tokens"])
        out["loss_err"] = abs(float(m["loss"]) - float(ref_loss))
        # global_norm: a split leaf and a replicated one (a norm scale)
        local = {k: prog._own(prog._own(grads[k], 0, _axes(prog, k, 0)), -1, _axes(prog, k, -1))
                 if grads[k].dim() == 2 else prog._own(grads[k], 0, _axes(prog, k, 0)) for k in names}
        out["global_norm_err"] = abs(float(adamw.global_norm(local)) - ref_norm)
        out["global_norm"] = ref_norm
    return out


def _axes(prog, name: str, dim: int) -> tuple[str, ...]:
    from repro_torch.distributed.sharding import axes_of

    return prog.live(axes_of(prog.specs[name][dim]))


def slices_gather(rank: int, inputs: dict) -> dict:
    """Each case of ``inputs`` (a shape, a spec, a mesh): this rank's slice
    of a seeded tensor, gathered whole again over the group."""
    import torch

    from repro_torch.distributed.comm import DistComm, take_local
    from repro_torch.launch.mesh import make_mesh

    out = {}
    comms = {}
    for i, case in enumerate(json.loads(str(inputs["slice_cases"]))):
        mesh = make_mesh(tuple(case["mesh"]), tuple(case["axes"]))
        comm = comms.get(mesh) or comms.setdefault(mesh, DistComm(mesh, rank, "gloo"))
        spec = tuple(tuple(e) if isinstance(e, list) else e for e in case["spec"])
        t = torch.arange(int(np.prod(case["shape"])), dtype=torch.float32).reshape(case["shape"])
        part = take_local(t, spec, mesh, rank)
        out[f"gather_{i}"] = bool(torch.equal(comm.gather_whole(part, spec), t))
    return out


def compressed(rank: int, inputs: dict) -> dict:
    """``compressed_psum_pod`` over ``pod`` on (pod 4, x 2): this device's
    row of the reference's input."""
    import torch

    from repro_torch.distributed.comm import DistComm
    from repro_torch.distributed.compression import compressed_psum_pod
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh((4, 2), ("pod", "x"))
    comm = DistComm(mesh, rank, "gloo")
    x = torch.from_numpy(inputs["psum_x"])[comm.coords["pod"]][None]
    return {"psum": compressed_psum_pod(x, comm, "pod").numpy()}


def cross_mesh(rank: int, tmp: Path) -> dict:
    """Save an 8 x 8 leaf laid out ('data', 'model') on (2, 4), restore it
    laid out ('model', 'data') on (4, 2) (the reference's elastic rescale)."""
    import torch

    from repro_torch.checkpoint.checkpoint import CheckpointManager, restore_pytree, save_pytree
    from repro_torch.distributed.comm import DistComm, take_local
    from repro_torch.launch.mesh import make_mesh

    mesh_a, mesh_b = make_mesh((2, 4), ("data", "model")), make_mesh((4, 2), ("data", "model"))
    comm, comm_b = DistComm(mesh_a, rank, "gloo"), DistComm(mesh_b, rank, "gloo")
    w = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    tree = {"w": take_local(w, ("data", "model"), mesh_a, rank)}
    save_pytree(tree, tmp / "ck", shardings={"w": comm.sharding(("data", "model"))})
    sh_b = comm_b.sharding(("model", "data"))
    got = restore_pytree(tree, tmp / "ck", shardings={"w": sh_b})["w"]  # device 0 reads and scatters
    # the manager: device 0 writes in the background, every device's restore waits for it
    manager = CheckpointManager(tmp / "mgr", keep=1, async_save=True)
    manager.save(7, tree, shardings={"w": comm.sharding(("data", "model"))})
    again, step = manager.restore(tree, shardings={"w": sh_b})
    return {"restored": got.numpy(), "whole_again": bool(torch.equal(comm_b.gather_whole(got, sh_b.spec), w)),
            "manager_step": step, "manager_restored": again["w"].numpy()}


def pipeline(rank: int, inputs: dict) -> dict:
    """The GPipe schedule at the reference test's shapes on 4 stages, this
    rank's stage of the reference's weights."""
    import torch

    from repro_torch.distributed.comm import DistComm
    from repro_torch.distributed.pipeline import pipeline_forward, split_stages
    from repro_torch.launch.mesh import make_mesh

    w = torch.from_numpy(inputs["pipe_w"])
    x = torch.from_numpy(inputs["pipe_x"])

    def block_fn(stage_w, h):
        for wi in stage_w:
            h = torch.tanh(h @ wi)
        return h

    mesh = make_mesh((4,), ("stage",))
    comm = DistComm(mesh, rank, "gloo")
    out = pipeline_forward(block_fn, split_stages(w, 4)[comm.coords["stage"]], x, comm)
    seq = torch.stack([block_fn(w, xm) for xm in x])
    return {"pipe": out.numpy(), "seq": seq.numpy()}


def moe(rank: int) -> dict:
    """The reduced qwen3-moe-30b-a3b in f32 under a batch split, (8, 1), a
    row a device: each device's aux loss against the whole batch's (one
    device, no program); and one MoE layer at a capacity factor of 0.5, so
    that the whole batch's capacity drops pairs, against the same layer on
    the whole batch, with each device's kept pairs of each expert against
    its even share of the capacity."""
    import dataclasses

    import torch

    from repro_torch.configs.shapes import ShapeSuite
    from repro_torch.distributed import program as D
    from repro_torch.distributed.comm import DistComm
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe as M
    from repro_torch.models.registry import get_model
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import make_loss_fn

    api = get_model("qwen3-moe-30b-a3b")
    cfg = dataclasses.replace(api.reduced, dtype="float32")
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab, (8, 32)).astype(np.int32))
    mesh = make_mesh((8, 1), ("data", "model"))
    comm = DistComm(mesh, rank, "gloo")
    whole = api.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    with torch.no_grad():
        _, m_all = make_loss_fn(api, cfg, remat=False)(whole, {"tokens": tokens})
        _, m_row = make_loss_fn(api, cfg, remat=False)(whole, {"tokens": tokens[rank:rank + 1]})
    cell = dryrun.build_cell("qwen3-moe-30b-a3b", ShapeSuite("x", "train", 32, 8), mesh, dryrun.POLICIES["baseline"],
                             cfg=cfg, comm=comm, source=api.init(torch.Generator().manual_seed(0), cfg, device="cpu"),
                             batch={"tokens": tokens}, opt_cfg=adamw.AdamWConfig(), remat=False)
    with torch.no_grad(), D.installed(cell.program):
        _, m = make_loss_fn(api, cell.program.local_config(), remat=False)(cell.params, {"tokens": tokens[rank:rank + 1]})
    out = {"aux": float(m["moe_aux"]), "aux_whole_batch": float(m_all["moe_aux"]), "aux_own_row": float(m_row["moe_aux"]),
           "loss": float(m["loss"]), "loss_whole_batch": float(m_all["loss"])}
    # one layer whose capacity binds: the whole batch's kept set
    tight = dataclasses.replace(cfg, capacity_factor=0.5)
    layer, mine = whole.blocks[0][0].moe, cell.params.blocks[0][0].moe
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((8, 32, cfg.d_model)).astype(np.float32))
    with torch.no_grad():
        y_all, aux_all = M.moe_ffn(layer, x, tight)
        C = M.moe_capacity(tight, 8 * 32)
        _, _, experts = M.route(layer, x.reshape(-1, cfg.d_model), tight)
        _, keep = M.dispatch(experts, tight.num_experts, C)
        with D.installed(cell.program):
            y, aux = M.moe_ffn(mine, x[rank:rank + 1], tight)
    own = experts.reshape(8, -1)[rank]
    kept = keep.reshape(8, -1)[rank]
    out.update(capacity=C, share=C / 8, dropped=int((~keep).sum()),
               kept_most=int(max(int((kept & (own == e)).sum()) for e in range(tight.num_experts))),
               layer_err=float((y - y_all[rank:rank + 1]).abs().max()), layer_aux_err=abs(float(aux) * 8 - float(aux_all)))
    return out


def combine_shares(rank: int) -> dict:
    """``decode_combine`` on four devices of (1, 4), the cache's sequence
    split over model, a device's share of 8 keys each: rows of 5, 12 and 30
    keys (so the last devices' shares of the first row are empty) attended
    on each share with the state variant's plain version and combined,
    against the whole cache's attention."""
    import torch

    from repro_torch.distributed.comm import DistComm
    from repro_torch.kernels.decode_attention import decode_attention_ref, decode_attention_state_cuda
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh((1, 4), ("data", "model"))
    comm = DistComm(mesh, rank, "gloo")
    g = torch.Generator().manual_seed(11)
    q = torch.randn(3, 4, 16, generator=g)
    k, v = torch.randn(3, 2, 32, 16, generator=g), torch.randn(3, 2, 32, 16, generator=g)
    lengths = torch.tensor([5, 12, 30], dtype=torch.int32)
    first = rank * 8
    mine = torch.clamp(lengths - first, 0, 8).to(torch.int32)
    o, lse = decode_attention_state_cuda(q, k[:, :, first:first + 8].contiguous(), v[:, :, first:first + 8].contiguous(),
                                         mine)
    holder = type("Holder", (), {"comm": comm, "_head_seq_axes": staticmethod(lambda axes: ())})()
    from repro_torch.distributed.program import Program

    got = Program.decode_combine(holder, o, lse, ("model",))
    return {"err": float((got - decode_attention_ref(q, k, v, lengths)).abs().max()),
            "empty_rows": int((mine == 0).sum()), "lse_empty": float(lse[mine == 0].max()) if (mine == 0).any() else 0.0}


def _cases(rank: int, params: dict) -> dict:
    """The train cases ``(name, shape, policy, remat[, arch, overrides])``,
    the serving cases ``(name, arch, shape, policy)`` and the ``long_500k``
    cases ``(name, arch, overrides)`` of ``params``."""
    out = {}
    for name, shape, policy, remat, *more in params["cases"]:
        arch, overrides = more if more else ("qwen2.5-3b", None)
        out.update({f"{name}/{k}": v for k, v in train_case(rank, tuple(shape), policy, remat, arch=arch,
                                                             overrides=overrides).items()})
    for name, arch, shape, policy in params.get("serve", ()):
        out.update({f"{name}/{k}": v for k, v in serve_case(rank, arch, tuple(shape), policy).items()})
    for name, arch, overrides in params.get("long", ()):
        out.update({f"{name}/{k}": v for k, v in long_case(rank, arch, overrides).items()})
    return out


def job_eight(rank: int, world: int, params: dict, tmp: Path) -> dict:
    """Every check of the 8-rank group, one after another."""
    inputs = _inputs(tmp)
    out = _cases(rank, params)
    out.update({f"bodies/{k}": v for k, v in bodies(rank).items()})
    out.update(slices_gather(rank, inputs))
    out.update(compressed(rank, inputs))
    out.update(cross_mesh(rank, tmp))
    out.update({f"moe/{k}": v for k, v in moe(rank).items()})
    return out


def job_four(rank: int, world: int, params: dict, tmp: Path) -> dict:
    """The 4-rank group: (1, 4), the batch not split, the ``long_500k``
    ticks, the pipeline and the decode combine with empty shares."""
    inputs = _inputs(tmp)
    out = _cases(rank, params)
    out.update(pipeline(rank, inputs))
    out.update({f"combine/{k}": v for k, v in combine_shares(rank).items()})
    return out


def job_cases(rank: int, world: int, params: dict, tmp: Path) -> dict:
    """The train and serving cases of ``params`` alone."""
    return _cases(rank, params)


JOBS = {"eight": job_eight, "four": job_four, "cases": job_cases}


if __name__ == "__main__":
    _child(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4]))
