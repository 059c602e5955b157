"""The sharded training step on real exchanges for the families beside the
dense qwen2.5-3b and the MoE (``tests/test_torch_distributed.py``): the
SSM (mamba2-780m), the hybrid (zamba2-7b), the encoder-decoder
(whisper-base, behind its frames), the vlm (internvl2-76b, behind its
patches), gemma2-2b and stablelm-1.6b.

Each reduced config runs in f32 through ``dryrun.build_cell(..., comm=)``
for two AdamW steps with remat on (``tests/torch_dist_common.py::
train_case``): on (2, 4) under ``baseline`` and under ``seqpar`` in one
group of eight gloo ranks, on (1, 4) under ``baseline`` in one of four;
beside them, in the eight-rank group, gemma2-2b on (1, 8) under ``seqpar``
(its 4 heads on 8 devices: attention computed whole) and the reduced
qwen3-moe-30b-a3b with 6 experts under ``seqpar`` (the ffn columns split).
Every rank is held against one device's two steps of the whole model and
against the reference's sharded step on the same weights, tokens and
extras (``tests/torch_reference.py::job_sharded_steps``, run beside the
groups), and its counts against the dry-run's plan on meta.

The cases hold three repairs: whisper's cross-attention keys and values
read the encoder states through the attention's plan (their gradient
summed over its tensor-parallel axes), its MLP adds the output bias once
after the devices' partial sums, and a weight consumed on the whole
sequence under ``seqpar`` (a Mamba2 block or an attention computed whole,
the vlm's ``patch_pos``) keeps the whole gradient every device computed
instead of summing it over the sequence's axes.  A MoE whose ffn columns
are split under ``seqpar`` routes the gathered sequence: its router is
such a weight too.
"""

import concurrent.futures
import dataclasses
import json

import numpy as np
import pytest
import torch

import torch_dist_common as G
import torch_reference as R
from repro_torch.configs.shapes import ShapeSuite
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh

ARCHS = {"mamba2": "mamba2-780m", "zamba2": "zamba2-7b", "whisper": "whisper-base", "internvl2": "internvl2-76b",
         "gemma2": "gemma2-2b", "stablelm": "stablelm-1.6b"}
MOE = "qwen3-moe-30b-a3b"
EIGHT = [c for short, arch in ARCHS.items() for c in ((f"{short}-2x4", (2, 4), "baseline", True, arch, None),
                                                      (f"{short}-2x4-seqpar", (2, 4), "seqpar", True, arch, None))]
# gemma2's 4 heads on 8: attention computed whole, on the gathered sequence
EIGHT.append(("gemma2-1x8-seqpar", (1, 8), "seqpar", True, "gemma2-2b", None))
EIGHT.append(("moe-ffn-2x4-seqpar", (2, 4), "seqpar", True, MOE, {"num_experts": 6}))
FOUR = [(f"{short}-1x4", (1, 4), "baseline", True, arch, None) for short, arch in ARCHS.items()]
CASES = EIGHT + FOUR


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """Each rank's outputs of the eight- and the four-rank group, and the
    reference's sharded steps of the same cases (``steps``), run beside
    them."""
    inputs = {}
    tokens = G.reduced()[3]
    for name, _, _, _, arch, overrides in CASES:
        _, cfg, model, toks = G.reduced(arch, overrides)
        assert torch.equal(toks, tokens), arch  # one vocabulary: the same tokens
        inputs.update({f"{name}/{k}": p.detach().numpy() for k, p in model.named_parameters()})
        inputs.update({f"extra/{name}/{k}": x.numpy() for k, x in G.extras(cfg, tokens.shape[0]).items()})
    out = {}
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        steps = ex.submit(R.run, "sharded_steps", {"train_cases": CASES}, {**inputs, "qwen_tokens": tokens.numpy()},
                          timeout=600, devices=8)
        for group, world, cases in (("eight", 8, EIGHT), ("four", 4, FOUR)):
            out[group] = G.run_group("cases", world, {"cases": cases}, tmp_path_factory.mktemp(group), timeout=600)
        out["steps"] = steps.result()
    return out


def _case(groups, name):
    group = "four" if name in [c[0] for c in FOUR] else "eight"
    return [{k.split("/", 1)[1]: v for k, v in r.items() if k.startswith(name + "/")} for r in groups[group]]


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_sharded_train_step_equals_one_devices_step(name, groups):
    """Two AdamW steps: every rank's losses within 1e-4 of one device's,
    the norm it clips by within rtol 1e-4, the first gradients (from
    AdamW's m after step 1) and the parameters after two steps, gathered
    whole, within atol 2e-4, rtol 2e-3 (the reference's tolerance)."""
    for rank, r in enumerate(_case(groups, name)):
        np.testing.assert_allclose(r["losses"], r["single_losses"], atol=G.TOL["loss"], rtol=0, err_msg=str(rank))
        np.testing.assert_allclose(r["norms"], r["single_norms"], rtol=1e-4, err_msg=str(rank))
        assert bool(r["grads_close"]), (rank, str(r["grad_worst"]), float(r["grad_max_err"]))
        assert bool(r["params_close"]), (rank, float(r["param_max_err"]))


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_sharded_train_step_equals_the_references_sharded_step(name, groups):
    """The reference's two steps (``jax.jit(step, in_shardings=...)`` on the
    same mesh and policy, the residual stream's hint under ``seqpar``, from
    the same weights, tokens and extras): every rank's losses within 1e-4
    and its parameters gathered whole within atol 2e-4, rtol 2e-3."""
    ref = groups["steps"]
    want = {k.split("/p/", 1)[1]: v for k, v in ref.items() if k.startswith(f"train/{name}/p/")}
    for rank, r in enumerate(_case(groups, name)):
        np.testing.assert_allclose(r["losses"], ref[f"train/{name}/losses"], atol=G.TOL["loss"], rtol=0,
                                   err_msg=str(rank))
        got = {k.split("/", 1)[1]: v for k, v in r.items() if k.startswith("whole/")}
        assert sorted(got) == sorted(want), rank
        for k, w in want.items():
            np.testing.assert_allclose(got[k], w, atol=G.TOL["atol"], rtol=G.TOL["rtol"], err_msg=f"{rank} {k}")


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_every_rank_counts_the_plan(name, groups):
    """The first sharded step counted on each rank (its extras in the
    batch): argument bytes, FLOPs, kernel calls and exchanges by kind equal
    the dry-run's cell of the same batch's shapes on meta, exactly."""
    for rank, r in enumerate(_case(groups, name)):
        assert json.loads(str(r["counted"])) == json.loads(str(r["plan"])), rank


def _plan(arch: str, shape, policy: str, overrides=None):
    from repro_torch.models.registry import get_model

    cfg = dataclasses.replace(get_model(arch).reduced, dtype="float32", **(overrides or {}))
    batch = {"tokens": torch.zeros(8, 32, dtype=torch.int32), **G.extras(cfg, 8)}
    cell = dryrun.build_cell(arch, ShapeSuite("x", "train", 32, 8), make_mesh(shape, ("data", "model")),
                             dryrun.POLICIES[policy], cfg=cfg, batch=batch)
    prog = cell.program
    return {prog.names[i]: w for i, w in prog.weights.items()}


@pytest.mark.parametrize("arch,shape,name,whole", [
    ("mamba2-780m", (2, 4), "blocks.0.mamba.in_proj.w", True), ("mamba2-780m", (2, 4), "blocks.0.mamba.conv_b", True),
    ("mamba2-780m", (2, 4), "blocks.0.mamba.norm.scale", True), ("mamba2-780m", (2, 4), "blocks.0.ln.scale", False),
    ("zamba2-7b", (2, 4), "blocks.0.mamba.out_proj.w", True), ("zamba2-7b", (2, 4), "shared.attn.q.w", False),
    ("internvl2-76b", (2, 4), "patch_pos", True), ("internvl2-76b", (2, 4), "embed.tok", False),
    ("gemma2-2b", (2, 4), "blocks.0.0.mlp.down.w", False), ("gemma2-2b", (2, 4), "blocks.0.0.attn.q.w", False),
    ("gemma2-2b", (1, 8), "blocks.0.0.attn.q.w", True), ("gemma2-2b", (1, 8), "blocks.0.0.mlp.up.w", False)])
def test_a_weight_consumed_on_the_whole_sequence_keeps_its_gradient_whole(arch, shape, name, whole):
    """Under ``seqpar``: a Mamba2 block's weights (the block computes whole,
    on the gathered sequence), an attention's whose heads do not divide the
    model axis (gemma2's 4 on 8) and the vlm's ``patch_pos`` keep every
    device's whole gradient over model (``whole_axes``; no sum there),
    while a weight consumed on a device's share of the sequence (a norm
    before the block, a tensor-parallel module's slice) is summed over it;
    under ``baseline`` no weight has such axes."""
    plan = _plan(arch, shape, "seqpar")[name]
    assert plan.whole_axes == (frozenset({"model"}) if whole else frozenset()), plan
    assert "model" not in plan.reduce_axes or not whole
    assert not any(w.whole_axes for w in _plan(arch, shape, "baseline").values())


def test_the_moe_router_under_an_ffn_split_keeps_its_gradient_whole():
    """With 6 experts the ffn columns split over model: under ``seqpar`` the
    router reads the gathered sequence, so its gradient is whole on every
    device; the experts' columns are a device's own."""
    plans = _plan(MOE, (2, 4), "seqpar", {"num_experts": 6})
    routers = [w for k, w in plans.items() if k.endswith("router.w")]
    assert routers and all(w.whole_axes == frozenset({"model"}) for w in routers)
    assert not any(w.whole_axes for k, w in plans.items() if k.endswith(("moe.gate", "moe.up", "moe.down")))
