"""The sharded step on real exchanges (``distributed/comm.py::DistComm``
over gloo process groups on the CPU), against the single-device step and
the reference's ``tests/test_distributed.py``.

Two groups run once for the module (``tests/torch_dist_common.py``), and
each test reads its part:

* eight ranks: the reduced qwen2.5-3b train step in f32 on (2, 4) under
  ``baseline`` (whole query heads a device, kv heads gathered, the
  vocabulary split), on (4, 2) and on (2, 4) under ``seqpar`` with the
  activation hint; the reduced qwen3-moe-30b-a3b's step on (8, 1) and (2,
  4) (the batch split: the whole batch's routing) and with 6 experts on (2,
  4) (an ffn split); the reduced qwen2.5-3b, deepseek-67b,
  internvl2-76b (behind its patches), zamba2-7b, whisper-base (behind its
  frames) and qwen3-moe-30b-a3b served on (2, 4) under ``serve-tp``, and
  whisper-base and zamba2-7b on (1, 8) (attention whole on every device,
  every cache split over its sequence);
  each rank-aware body alone; every slice gathered whole;
  ``compressed_psum_pod`` on (pod 4, x 2); a save under (2, 4) restored
  under (4, 2); the MoE aux loss and a binding capacity under a batch split;
* four ranks: the step on (1, 4), the batch not split, of the reduced
  qwen2.5-3b and qwen3-moe-30b-a3b (experts over model); every reduced
  architecture served on (1, 4) (the caches' sequence split where the kv
  heads do not divide, mixtral's and gemma2's ring-buffered windows too,
  mamba2-780m's states stored split over their heads); the ``long_500k``
  tick of mamba2-780m, zamba2-7b, gemma2-2b and mixtral-8x7b (batch 1, a
  whole cache at its last position, every cache split by heads, the
  windows wrapping); the decode combine with empty shares; and the
  pipeline on four stages.

The reference's side (``devices_indices_map``, ``compressed_psum_pod`` and
``pipeline_forward`` on 8 forced devices; its sharded train step,
``tests/test_distributed.py:142``, and its dry-run's jitted ``prefill_fn``
and ``decode_fn``, on the port's weights, tokens and ``long_500k`` caches
for each case, beside the groups) runs in children of
``tests/torch_reference.py``.  The dry-run's pinned cells must not move but
where a repair moved them; and a step with no program gives the bits it
gave then.
"""

import concurrent.futures
import dataclasses
import hashlib
import json

import numpy as np
import pytest
import torch

import torch_dist_common as G
import torch_reference as R
from repro_torch.configs.shapes import ShapeSuite
from repro_torch.distributed import hints
from repro_torch.distributed import program as D
from repro_torch.distributed.comm import local_slices
from repro_torch.distributed.sharding import cache_leaves
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import coords, make_mesh, rank_of

SLICE_CASES = [
    {"mesh": [2, 4], "axes": ["data", "model"], "shape": [8, 16, 4], "spec": ["data", None, "model"]},
    {"mesh": [2, 4], "axes": ["data", "model"], "shape": [16, 4], "spec": [["data", "model"], None]},
    {"mesh": [2, 4], "axes": ["data", "model"], "shape": [16, 4], "spec": [["model", "data"], None]},
    {"mesh": [2, 4], "axes": ["data", "model"], "shape": [4, 8, 6], "spec": [None, "model", "data"]},
    {"mesh": [4, 2], "axes": ["data", "model"], "shape": [8, 8], "spec": ["model", "data"]},
    {"mesh": [4, 2], "axes": ["pod", "x"], "shape": [4, 256], "spec": ["pod", None]},
]
EIGHT = [("2x4", (2, 4), "baseline", False), ("4x2", (4, 2), "baseline", True),
         ("2x4-seqpar", (2, 4), "seqpar", True)]
FOUR = [("1x4", (1, 4), "baseline", True)]
MOE = "qwen3-moe-30b-a3b"
MOE_EIGHT = [("moe-8x1", (8, 1), "baseline", False, MOE, None), ("moe-2x4", (2, 4), "baseline", True, MOE, None),
             ("moe-ffn-2x4", (2, 4), "baseline", False, MOE, {"num_experts": 6})]
MOE_FOUR = [("moe-1x4", (1, 4), "baseline", False, MOE, None)]
SERVE_EIGHT = [("serve-qwen-2x4", "qwen2.5-3b", (2, 4), "serve-tp"),
               ("serve-deepseek-2x4", "deepseek-67b", (2, 4), "serve-tp"),
               ("serve-internvl2-2x4", "internvl2-76b", (2, 4), "serve-tp"),
               # the hybrid's states split over the batch, whisper's frames, the
               # MoE routing of the whole batch while serving
               ("serve-zamba2-2x4", "zamba2-7b", (2, 4), "serve-tp"),
               ("serve-whisper-2x4", "whisper-base", (2, 4), "serve-tp"),
               ("serve-qwen3-moe-2x4", "qwen3-moe-30b-a3b", (2, 4), "serve-tp"),
               # 4 query and kv heads on 8: attention whole on every device, the
               # self, cross and shared caches split over their sequence
               ("serve-whisper-1x8", "whisper-base", (1, 8), "serve-tp"),
               ("serve-zamba2-1x8", "zamba2-7b", (1, 8), "serve-tp")]
SERVE_FOUR = [("serve-qwen-1x4", "qwen2.5-3b", (1, 4), "serve-tp"),
              ("serve-mixtral-1x4", "mixtral-8x7b", (1, 4), "serve-tp"),
              ("serve-deepseek-1x4", "deepseek-67b", (1, 4), "serve-tp"),
              ("serve-internvl2-1x4", "internvl2-76b", (1, 4), "serve-tp"),
              ("serve-mamba2-1x4", "mamba2-780m", (1, 4), "serve-tp"),
              ("serve-zamba2-1x4", "zamba2-7b", (1, 4), "serve-tp"),
              ("serve-whisper-1x4", "whisper-base", (1, 4), "serve-tp"),
              ("serve-gemma2-1x4", "gemma2-2b", (1, 4), "serve-tp"),
              ("serve-stablelm-1x4", "stablelm-1.6b", (1, 4), "serve-tp"),
              ("serve-qwen3-moe-1x4", "qwen3-moe-30b-a3b", (1, 4), "serve-tp")]
VLM_SERVE = [c[0] for c in SERVE_EIGHT + SERVE_FOUR if c[1] == "internvl2-76b"]
#: the ``long_500k`` tick of the four archs that have it, reduced, on (1, 4)
#: under ``serve-tp`` (``torch_dist_common.LONG``): every cache split by
#: heads, as at full width, so gemma2-2b and mixtral-8x7b take 4 kv heads
LONG_FOUR = [("long-mamba2", "mamba2-780m", None), ("long-zamba2", "zamba2-7b", None),
             ("long-gemma2", "gemma2-2b", G.LONG_HEADS), ("long-mixtral", "mixtral-8x7b", G.LONG_HEADS)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def reference():
    return R.run("distributed", {"slice_cases": SLICE_CASES}, devices=8, timeout=300)


@pytest.fixture(scope="module")
def groups(reference, tmp_path_factory):
    """Each rank's outputs of the eight- and the four-rank group, and the
    reference's sharded steps (``steps``), jitted serving steps (``serve``)
    and ``long_500k`` ticks (``long``) of the same cases on the same
    weights, tokens and caches, run beside them."""
    inputs = {"slice_cases": np.array(json.dumps(SLICE_CASES)), **{k: reference[k] for k in
              ("psum_x", "pipe_w", "pipe_x")}}
    _, _, params, tokens = G.reduced()
    weights = {f"qwen/{k}": p.detach().numpy() for k, p in params.named_parameters()}
    for name, _, _, _, arch, overrides in MOE_EIGHT + MOE_FOUR:
        weights.update({f"{name}/{k}": p.detach().numpy() for k, p in G.reduced(arch, overrides)[2].named_parameters()})
    served = {}
    for name, arch, _, _ in SERVE_EIGHT + SERVE_FOUR:
        prompt, _, ticks, _ = G.serve_single(arch)
        _, cfg, model, _ = G.reduced(arch)
        served.update({f"{name}/w/{k}": p.detach().numpy() for k, p in model.named_parameters()})
        served.update({f"{name}/{k}": x.numpy() for k, x in G.extras(cfg, G.SERVE["batch"]).items()})
        served[f"{name}/prompt"], served[f"{name}/tokens"] = prompt.numpy(), ticks.numpy()
    long = {}
    for name, arch, overrides in LONG_FOUR:
        long.update({f"{name}/w/{k}": p.detach().numpy() for k, p in G.reduced(arch, overrides)[2].named_parameters()})
        long.update({f"{name}/cache/{k}": np.asarray(x) for k, x in cache_leaves(G.long_cache(arch, overrides))})
        long[f"{name}/tokens"] = G.long_single(arch, overrides)[0].numpy()
    out = {}
    with concurrent.futures.ThreadPoolExecutor(3) as ex:
        steps = ex.submit(R.run, "sharded_steps", {"train_cases": EIGHT + FOUR + MOE_EIGHT + MOE_FOUR},
                          {**weights, "qwen_tokens": tokens.numpy()}, timeout=300, devices=8)
        serve = ex.submit(R.run, "sharded_serve", {"serve_cases": SERVE_EIGHT + SERVE_FOUR,
                                                   "max_len": G.SERVE["max_len"]}, served, timeout=300, devices=8)
        ticks = ex.submit(R.run, "long_decode", {"long_cases": LONG_FOUR, "seq_len": G.LONG["seq_len"]}, long,
                          timeout=300, devices=8)
        for name, world, cases, serving, longs in (("eight", 8, EIGHT + MOE_EIGHT, SERVE_EIGHT, []),
                                                   ("four", 4, FOUR + MOE_FOUR, SERVE_FOUR, LONG_FOUR)):
            tmp = tmp_path_factory.mktemp(name)
            np.savez(tmp / "inputs.npz", **inputs)
            out[name] = G.run_group(name, world, {"cases": cases, "serve": serving, "long": longs}, tmp)
        out["steps"], out["serve"], out["long"] = steps.result(), serve.result(), ticks.result()
    return out


# -----------------------------------------------------------------------------
# layouts
# -----------------------------------------------------------------------------


def test_coords_are_row_major_and_rank_of_inverts_them():
    mesh = make_mesh((2, 3, 4), ("pod", "data", "model"))
    assert [coords(mesh, r) for r in range(3)] == [(0, 0, 0), (0, 0, 1), (0, 0, 2)]
    assert coords(mesh, 4) == (0, 1, 0) and coords(mesh, 12) == (1, 0, 0)
    assert all(rank_of(mesh, coords(mesh, r)) == r for r in range(mesh.size))
    with pytest.raises(ValueError):
        coords(mesh, 24)


@pytest.mark.parametrize("case", range(len(SLICE_CASES)))
def test_every_slice_is_the_references(case, reference, groups):
    """Each rank's slice equals ``devices_indices_map`` of the device at its
    coordinates, and the group gathers the slices back to the whole."""
    c = SLICE_CASES[case]
    mesh = make_mesh(tuple(c["mesh"]), tuple(c["axes"]))
    spec = tuple(tuple(e) if isinstance(e, list) else e for e in c["spec"])
    want = reference[f"slices_{case}"]
    for rank in range(mesh.size):
        got = [[s.start, s.stop] for s in local_slices(c["shape"], spec, mesh, rank)]
        assert got == want[rank].tolist(), (rank, got, want[rank])
    assert all(r[f"gather_{case}"] for r in groups["eight"])


# -----------------------------------------------------------------------------
# the sharded train step
# -----------------------------------------------------------------------------


def _case(groups, name):
    group = "four" if name in [c[0] for c in FOUR + MOE_FOUR + SERVE_FOUR + LONG_FOUR] else "eight"
    return [{k.split("/", 1)[1]: v for k, v in r.items() if k.startswith(name + "/")} for r in groups[group]]


@pytest.mark.parametrize("name", [c[0] for c in EIGHT + FOUR])
def test_sharded_train_step_equals_the_single_device_step(name, groups):
    """Two AdamW steps: every rank's loss within 1e-4 of the single-device
    step's, the first gradients (from AdamW's m after step 1) and the
    parameters gathered whole within atol 2e-4, rtol 2e-3 (the reference's
    tolerance); the gradient norm every rank clips by is the whole model's."""
    for rank, r in enumerate(_case(groups, name)):
        np.testing.assert_allclose(r["losses"], r["single_losses"], atol=G.TOL["loss"], rtol=0, err_msg=str(rank))
        np.testing.assert_allclose(r["norms"], r["single_norms"], rtol=1e-4, err_msg=str(rank))
        assert bool(r["grads_close"]), (rank, str(r["grad_worst"]), float(r["grad_max_err"]))
        assert bool(r["params_close"]), (rank, float(r["param_max_err"]))


@pytest.mark.parametrize("name", [c[0] for c in EIGHT + FOUR])
def test_sharded_train_step_equals_the_references_sharded_step(name, groups):
    """The same two steps of the reference (``jax.jit(step, in_shardings=
    ...)`` on the same mesh, policy and hint, from the same weights and
    tokens): every rank's losses within 1e-4 and its parameters gathered
    whole within atol 2e-4, rtol 2e-3, the reference's tolerance."""
    ref = groups["steps"]
    want = {k.split("/p/", 1)[1]: v for k, v in ref.items() if k.startswith(f"train/{name}/p/")}
    for rank, r in enumerate(_case(groups, name)):
        np.testing.assert_allclose(r["losses"], ref[f"train/{name}/losses"], atol=G.TOL["loss"], rtol=0,
                                   err_msg=str(rank))
        got = {k.split("/", 1)[1]: v for k, v in r.items() if k.startswith("whole/")}
        assert sorted(got) == sorted(want), rank
        for k, w in want.items():
            np.testing.assert_allclose(got[k], w, atol=G.TOL["atol"], rtol=G.TOL["rtol"], err_msg=f"{rank} {k}")


@pytest.mark.parametrize("name", [c[0] for c in EIGHT + FOUR + MOE_EIGHT + MOE_FOUR])
def test_every_rank_counts_the_dry_runs_plan(name, groups):
    """The first sharded step counted on each rank: its argument bytes,
    FLOPs, kernel calls and exchanges by kind equal the dry-run's cell of
    the same config and mesh on meta, exactly."""
    for rank, r in enumerate(_case(groups, name)):
        assert json.loads(str(r["counted"])) == json.loads(str(r["plan"])), rank


@pytest.mark.parametrize("name", [c[0] for c in MOE_EIGHT + MOE_FOUR])
def test_sharded_moe_train_step_equals_the_single_device_and_the_references(name, groups):
    """The reduced qwen3-moe-30b-a3b in f32, experts over model on (1, 4),
    the batch split on (8, 1) and (2, 4), and with 6 experts the ffn columns
    over model on (2, 4): two AdamW steps, every rank's losses within 1e-4
    of one device's and of the reference's sharded step, the first
    gradients and the parameters after two steps, gathered whole, within
    atol 2e-4, rtol 2e-3 of one device's, and the parameters of the
    reference's."""
    ref = groups["steps"]
    want = {k.split("/p/", 1)[1]: v for k, v in ref.items() if k.startswith(f"train/{name}/p/")}
    for rank, r in enumerate(_case(groups, name)):
        np.testing.assert_allclose(r["losses"], r["single_losses"], atol=G.TOL["loss"], rtol=0, err_msg=str(rank))
        np.testing.assert_allclose(r["losses"], ref[f"train/{name}/losses"], atol=G.TOL["loss"], rtol=0,
                                   err_msg=str(rank))
        assert bool(r["grads_close"]), (rank, float(r["grad_max_err"]))
        assert bool(r["params_close"]), (rank, float(r["param_max_err"]))
        got = {k.split("/", 1)[1]: v for k, v in r.items() if k.startswith("whole/")}
        assert sorted(got) == sorted(want), rank
        for k, w in want.items():
            np.testing.assert_allclose(got[k], w, atol=G.TOL["atol"], rtol=G.TOL["rtol"], err_msg=f"{rank} {k}")


def test_the_moe_layouts_are_the_ones_named(groups):
    """Experts over model on (1, 4) and (2, 4), the ffn columns with 6
    experts, the MoE whole on every device of (8, 1)."""
    want = {"moe-1x4": "experts", "moe-2x4": "experts", "moe-ffn-2x4": "ffn", "moe-8x1": "whole"}
    for name, mode in want.items():
        for r in _case(groups, name):
            assert mode in json.loads(str(r["layout"]))["modules"], (name, str(r["layout"]))


def test_the_layouts_are_the_ones_named():
    """(2, 4): one query head a device, kv gathered; (4, 2): 2 heads and
    their kv head split; (1, 4): the batch whole; seqpar: the sequence over
    model."""
    from repro_torch.models.registry import get_model

    cfg = dataclasses.replace(get_model("qwen2.5-3b").reduced, dtype="float32")
    suite = ShapeSuite("x", "train", 32, 8)
    want = {(2, 4): ("gather", 1), (4, 2): ("split", 2), (1, 4): ("gather", 1)}
    for shape, (mode, heads) in want.items():
        cell = dryrun.build_cell("qwen2.5-3b", suite, make_mesh(shape, ("data", "model")),
                                 dryrun.POLICIES["baseline"], cfg=cfg)
        assert (cell.program.attention.kv_mode, cell.program.attention.heads) == (mode, heads)
        assert cell.program.batch_axes == (() if shape[0] == 1 else ("data",))
        assert cell.program.vocab_axes == ("model",)
    cell = dryrun.build_cell("qwen2.5-3b", suite, make_mesh((2, 4), ("data", "model")), dryrun.POLICIES["seqpar"],
                             cfg=cfg)
    assert dryrun.layout(cell.program)["sequence_parallel"] == ["model"]


# -----------------------------------------------------------------------------
# each repaired body alone
# -----------------------------------------------------------------------------


def test_kv_select_reads_the_group_of_this_devices_query_heads(groups):
    """Reduced qwen2.5-3b on (2, 4): one query head a device, a group of 2,
    so devices 2 and 3 of each model row read kv head 1."""
    rows = [r for r in groups["eight"]]
    assert [int(r["bodies/kv_select_group"]) for r in rows] == [0, 0, 1, 1] * 2
    assert all(bool(r["bodies/kv_select_ok"]) for r in rows)


def test_lookup_and_pick_read_this_devices_vocabulary(groups):
    rows = groups["eight"]
    assert [int(r["bodies/vocab_first"]) for r in rows] == [0, 64, 128, 192] * 2
    for r in rows:
        assert float(r["bodies/lookup_err"]) == 0.0
        assert float(r["bodies/pick_err"]) == 0.0


def test_logsumexp_takes_the_max_over_the_vocabularys_devices(groups):
    for r in groups["eight"]:
        assert float(r["bodies/logsumexp_err"]) < 1e-5


def test_the_loss_divides_by_every_devices_targets(groups):
    """A mask that keeps another count of targets in each row: every
    device's count is the whole batch's, and the loss the reference's mean."""
    for r in groups["eight"]:
        assert float(r["bodies/tokens"]) == float(r["bodies/tokens_ref"])
        assert float(r["bodies/loss_err"]) < 1e-5


def test_global_norm_counts_a_replicated_leaf_once(groups):
    for r in groups["eight"]:
        assert float(r["bodies/global_norm_err"]) <= 1e-6 * float(r["bodies/global_norm"])


def test_the_moe_aux_loss_under_a_batch_split_is_the_whole_batchs(groups):
    """(8, 1), a row a device: every device's aux loss is the load-balance
    statistic of the whole batch's tokens, as the reference's one global
    step takes it, not of its own row; its share of the reported loss sums
    over the devices to the whole batch's loss."""
    rows = groups["eight"]
    for r in rows:
        assert abs(float(r["moe/aux"]) - float(r["moe/aux_whole_batch"])) <= 1e-6 * abs(float(r["moe/aux_whole_batch"]))
        assert abs(float(r["moe/loss"]) - float(r["moe/loss_whole_batch"])) <= 1e-5
    assert any(abs(float(r["moe/aux_own_row"]) - float(r["moe/aux_whole_batch"])) > 1e-4 for r in rows)


def test_a_device_keeps_more_than_its_share_of_an_experts_capacity(groups):
    """One MoE layer at a capacity factor of 0.5 under (8, 1): the whole
    batch's capacity drops pairs, some device keeps more of one expert's
    pairs than an even share of the capacity, and every device's output
    and aux loss equal those of the layer over the whole batch."""
    rows = groups["eight"]
    assert all(int(r["moe/dropped"]) > 0 for r in rows)
    assert any(int(r["moe/kept_most"]) > float(r["moe/share"]) for r in rows)
    for r in rows:
        assert float(r["moe/layer_err"]) <= 1e-6, float(r["moe/layer_err"])
        assert float(r["moe/layer_aux_err"]) <= 1e-6, float(r["moe/layer_aux_err"])


# -----------------------------------------------------------------------------
# sharded serving
# -----------------------------------------------------------------------------


@pytest.mark.parametrize("name", [c[0] for c in SERVE_EIGHT + SERVE_FOUR])
def test_sharded_serving_equals_one_device_and_the_references_jitted_steps(name, groups):
    """A prefill of 4 prompts of 5 tokens (the vlm's behind 8 patches) and 4
    greedy ticks under ``serve-tp``: every rank's logits, in the layout of
    ``logits_sharding`` and gathered whole, within 1e-4 of one device's on
    the same weights and tokens, and of the reference's
    ``jax.jit(prefill_fn / decode_fn, in_shardings=...)`` on 8 CPU devices;
    a decode cell built from one device's whole cache after the prefill
    gives the first tick's too."""
    from repro_torch.distributed.comm import take_local

    ref = groups["serve"][f"serve/{name}/logits"]
    shape = dict((c[0], c[2]) for c in SERVE_EIGHT + SERVE_FOUR)[name]
    mesh = make_mesh(shape, ("data", "model"))
    for rank, r in enumerate(_case(groups, name)):
        spec = tuple(tuple(e) if isinstance(e, list) else e for e in json.loads(str(r["logits_spec"])))
        assert float(r["whole_cache_err"]) <= G.TOL["loss"], (rank, float(r["whole_cache_err"]))
        for i in range(1 + G.SERVE["ticks"]):
            assert float(r[f"err_{i}"]) <= G.TOL["loss"], (rank, i, float(r[f"err_{i}"]))
            np.testing.assert_allclose(r[f"logits_{i}"], ref[i], atol=G.TOL["loss"], rtol=0, err_msg=f"{rank} {i}")
            want = take_local(torch.from_numpy(r[f"logits_{i}"]), spec, mesh, rank).numpy()
            assert np.array_equal(r[f"local_{i}"], want), (rank, i)


@pytest.mark.parametrize("name", [c[0] for c in SERVE_EIGHT + SERVE_FOUR])
def test_every_rank_counts_the_serving_plan(name, groups):
    """The prefill, and a tick at a full cache drawn from a seed, counted on
    each rank: argument bytes, FLOPs, kernel calls and exchanges by kind
    equal the dry-run's prefill and decode cells on meta, exactly."""
    for rank, r in enumerate(_case(groups, name)):
        assert json.loads(str(r["prefill_counted"])) == json.loads(str(r["prefill_plan"])), rank
        assert json.loads(str(r["decode_counted"])) == json.loads(str(r["decode_plan"])), rank
        assert json.loads(str(r["decode_counted"]))["collective_counts"]["all-reduce"] > 0, rank


def test_the_cross_cache_split_over_devices_equals_one_device(groups):
    """The reduced whisper-base on (1, 8): its 4 heads do not divide 8, so
    attention runs whole on every device while the cross cache splits its
    16 frames 2 a rank; the prefill writes each rank's share of the
    encoder's keys in place, every tick combines the shares' attention, and
    every step's logits stay within 1e-4 of one device's, as does a tick
    from one device's whole cache cut to the shares."""
    frames = G.reduced("whisper-base")[1].enc_frames
    for rank, r in enumerate(_case(groups, "serve-whisper-1x8")):
        assert [int(x) for x in r["cross_span"]] == [rank * frames // 8, frames], rank
        assert json.loads(str(r["seq_axes"])) == ["model"]
        assert max(float(r[f"err_{i}"]) for i in range(1 + G.SERVE["ticks"])) <= G.TOL["loss"], rank
        assert float(r["whole_cache_err"]) <= G.TOL["loss"], (rank, float(r["whole_cache_err"]))
    for rank, r in enumerate(_case(groups, "serve-whisper-2x4")):  # heads split: every frame a rank
        assert [int(x) for x in r["cross_span"]] == [0, frames], rank


def test_the_ssm_state_is_stored_split_and_computed_whole(groups):
    """The reduced mamba2-780m on (1, 4): each rank stores a quarter of every
    layer's SSM state heads ``[L, B, H / 4, P, N]``, gathers them to compute
    the Mamba2 block whole, and every step's logits equal one device's
    within 1e-4; the model holds no attention cache."""
    cfg = G.reduced("mamba2-780m")[1]
    for rank, r in enumerate(_case(groups, "serve-mamba2-1x4")):
        assert [int(x) for x in r["ssm_shape"]] == [cfg.num_layers, G.SERVE["batch"], cfg.ssm_heads // 4, cfg.ssm_headdim,
                                                    cfg.ssm_state], rank
        assert json.loads(str(r["seq_axes"])) == [] and r["cache_span"].size == 0
        assert json.loads(str(r["layout"]))["modules"].get("whole"), rank
        assert max(float(r[f"err_{i}"]) for i in range(1 + G.SERVE["ticks"])) <= G.TOL["loss"], rank


@pytest.mark.parametrize("name", VLM_SERVE)
def test_the_vlms_patches_reach_the_sharded_prefill(name, groups):
    """The reduced internvl2-76b's sharded prefill of the same prompts
    without their patches moves every rank's logits far past the
    tolerance that holds the patched prefill to one device's."""
    for rank, r in enumerate(_case(groups, name)):
        assert float(r["no_patches_diff"]) > 100 * G.TOL["loss"], (rank, float(r["no_patches_diff"]))
        assert float(r["err_0"]) <= G.TOL["loss"], rank


def test_the_decode_combine_weighs_an_empty_share_nothing(groups):
    """Four shares of 8 keys each and rows of 5, 12 and 30 keys: the shares
    past a row's keys have the state -1e30 and an output of 0, and the
    combined attention equals the whole cache's; the reduced qwen2.5-3b's
    cache splits its 32 positions over the four ranks, so its prefill of 5
    tokens leaves three shares empty."""
    rows = groups["four"]
    assert sum(int(r["combine/empty_rows"]) for r in rows) > 0
    for r in rows:
        assert float(r["combine/err"]) <= 1e-6, float(r["combine/err"])
        if int(r["combine/empty_rows"]):
            assert float(r["combine/lse_empty"]) <= -1e29
    for rank, r in enumerate(_case(groups, "serve-qwen-1x4")):
        assert json.loads(str(r["seq_axes"])) == ["model"]
        first, whole = (int(x) for x in r["cache_span"])
        assert whole == G.SERVE["max_len"] and first == rank * whole // 4


def test_the_ring_buffered_window_split_over_devices_serves_past_its_window(groups):
    """The reduced mixtral-8x7b's window of 8 is a ring buffer of 8 slots,
    2 a rank on (1, 4); the prompt and the ticks pass it, and every step's
    logits stay within 1e-4 of one device's."""
    from repro_torch.models.registry import get_model

    window = get_model("mixtral-8x7b").reduced.window
    assert G.SERVE["prompt"] + G.SERVE["ticks"] > window
    for rank, r in enumerate(_case(groups, "serve-mixtral-1x4")):
        assert json.loads(str(r["seq_axes"])) == ["model"]
        assert [int(x) for x in r["cache_span"]] == [rank * window // 4, window]
        assert max(float(r[f"err_{i}"]) for i in range(1 + G.SERVE["ticks"])) <= G.TOL["loss"]


# -----------------------------------------------------------------------------
# the long_500k tick: batch 1 against a whole cache at its last position
# -----------------------------------------------------------------------------

LONG_OVERRIDES = {name: overrides for name, _, overrides in LONG_FOUR}


@pytest.mark.parametrize("name,arch", [c[:2] for c in LONG_FOUR])
def test_the_long_tick_equals_one_device_and_the_references_jitted_decode(name, arch, groups):
    """The reduced ``long_500k`` cell on (1, 4): a whole cache of 40
    positions at position 39 cut to each rank's share, then 4 greedy ticks
    (the windows of 8 wrap: slots 7, 0, 1, 2); every rank's logits,
    gathered whole, within 1e-4 of one device's ticks on the same weights
    and cache and of the reference's ``jax.jit(decode_fn, in_shardings=...)``
    on (1, 4), teacher-forced on one device's tokens; the group's greedy
    tokens equal one device's and the reference's."""
    from repro_torch.models.registry import get_model

    window = get_model(arch).reduced.window
    if window:
        assert [(G.LONG["seq_len"] - 1 + t) % window for t in range(G.LONG["ticks"])] == [7, 0, 1, 2]
    tokens, _ = G.long_single(arch, LONG_OVERRIDES[name])
    ref = groups["long"][f"long/{name}/logits"]
    assert ref.shape[0] == G.LONG["ticks"]
    assert np.array_equal(ref[:-1].argmax(-1), tokens.numpy()[1:])
    for rank, r in enumerate(_case(groups, name)):
        assert np.array_equal(r["tokens"], tokens.numpy()), rank
        for t in range(G.LONG["ticks"]):
            assert float(r[f"err_{t}"]) <= G.TOL["loss"], (rank, t, float(r[f"err_{t}"]))
            np.testing.assert_allclose(r[f"logits_{t}"], ref[t], atol=G.TOL["loss"], rtol=0, err_msg=f"{rank} {t}")


@pytest.mark.parametrize("name", [c[0] for c in LONG_FOUR])
def test_every_rank_counts_the_long_plan(name, groups):
    """The first tick from the whole cache and a tick of a cache drawn from
    a seed, counted on each rank: argument bytes, FLOPs, kernel calls and
    exchanges by kind equal the dry-run's ``long_500k`` cell on meta."""
    for rank, r in enumerate(_case(groups, name)):
        plan = json.loads(str(r["plan"]))
        assert json.loads(str(r["counted"])) == plan, rank
        assert json.loads(str(r["seed_counted"])) == plan, rank
        assert plan["collective_counts"]["all-reduce"] > 0, rank


@pytest.mark.parametrize("name", [c[0] for c in LONG_FOUR])
def test_a_seeded_long_cache_is_each_ranks_cut_of_one_whole_draw(name, groups):
    """``cache=<seed>`` at batch 1: every rank's leaves are its cut of the
    cache drawn whole from the same seed on a mesh of one, at the suite's
    last position."""
    for rank, r in enumerate(_case(groups, name)):
        assert bool(r["seed_cut_equal"]), rank
        assert int(r["seed_pos"]) == G.LONG["seq_len"] - 1, rank


@pytest.mark.parametrize("name,arch", [c[:2] for c in LONG_FOUR])
def test_every_long_cache_splits_by_heads(name, arch, groups):
    """Under serve-tp on (1, 4) every KV cache of ``long_500k`` splits by
    its kv heads, ``(None, 'data', 'model', None, None)``, at full width
    and in the reduced cell (gemma2-2b and mixtral-8x7b with 4 kv heads):
    each rank attends to whole sequences, and the ranks' caches hold no
    split sequence."""
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.distributed.sharding import make_cache_shardings
    from repro_torch.models.registry import get_model

    api = get_model(arch)
    mesh = make_mesh((1, 4), ("data", "model"))
    cfg = dataclasses.replace(api.reduced, **(LONG_OVERRIDES[name] or {}))
    for c, suite in ((api.config, SHAPES["long_500k"]), (cfg, G.long_suite())):
        specs = make_cache_shardings(mesh, c, api.cache_specs(c, suite), dryrun.POLICIES["serve-tp"])
        kv = {p: s for p, s in specs.items() if p.rsplit("/", 1)[-1] in ("k", "v")}
        assert all(s == (None, "data", "model", None, None) for s in kv.values()), specs
        assert bool(kv) == (arch != "mamba2-780m")
    for r in _case(groups, name):
        assert json.loads(str(r["seq_axes"])) == []


#: the four full-width ``long_500k`` cells' plans on (1, 4) under serve-tp,
#: on meta: the peak and argument bytes a card, the bytes a tick reads and
#: writes (the bound of ``chip_smoke.py``'s phase 26), the exchanges by kind
#: and the decode kernel's calls
PINNED_LONG = {
    "mamba2-780m": {"peak_bytes": 466342756, "argument_bytes": 409765636, "bytes": 2066342438.0,
                    "collective_counts": {"all-reduce": 1.0, "all-gather": 384.0}, "decode_calls": 0},
    "zamba2-7b": {"peak_bytes": 27985325044, "argument_bytes": 27843459860, "bytes": 39740921786.0,
                  "collective_counts": {"all-reduce": 27.0, "all-gather": 648.0}, "decode_calls": 13},
    "gemma2-2b": {"peak_bytes": 8375713284, "argument_bytes": 8341381636, "bytes": 8361949662.0,
                  "collective_counts": {"all-reduce": 53.0}, "decode_calls": 26},
    "mixtral-8x7b": {"peak_bytes": 23525171426, "argument_bytes": 23489683460, "bytes": 23621054678.0,
                     "collective_counts": {"all-reduce": 33.0, "all-gather": 32.0}, "decode_calls": 32},
}


@pytest.mark.parametrize("arch", list(PINNED_LONG))
def test_the_long_plans_are_pinned(arch):
    """Each full-width ``long_500k`` cell on (1, 4) under serve-tp, planned
    on meta: every count equal, exactly."""
    cell = dryrun.build_cell(arch, "long_500k", make_mesh((1, 4), ("data", "model")), dryrun.POLICIES["serve-tp"])
    _, c = dryrun.count_cell(cell, scopes=False)
    j, m = c.costs.to_json(), c.memory()
    got = {"peak_bytes": m["peak_bytes"], "argument_bytes": m["argument_bytes"], "bytes": j["bytes"],
           "collective_counts": j["collective_counts"],
           "decode_calls": j["kernels"].get("decode_attention", {}).get("calls", 0)}
    assert got == PINNED_LONG[arch]


# -----------------------------------------------------------------------------
# compression, the pipeline, the checkpoint
# -----------------------------------------------------------------------------


def test_compressed_psum_pod_equals_the_reference_bit_for_bit(reference, groups):
    """(pod 4, x 2), the sum over pod: each device's row equals the
    reference's output bit for bit, and meets the reference's bound
    (``tests/test_distributed.py:199``)."""
    x = reference["psum_x"]
    mesh = make_mesh((4, 2), ("pod", "x"))
    expect = x.sum(axis=0)
    scale = np.abs(x).max() / 127
    for rank, r in enumerate(groups["eight"]):
        pod = coords(mesh, rank)[0]
        got = r["psum"][0]
        assert got.view(np.uint32).tolist() == reference["psum"][pod].view(np.uint32).tolist(), rank
        assert np.abs(got - expect).max() <= scale * 4 * 1.5 + 1e-6


def test_pipeline_equals_the_sequential_blocks_and_the_reference(reference, groups):
    """GPipe over 4 stages (L 8, d 16, M 4, mb 2, S 8): every stage's
    output within 1e-5 of the blocks run in sequence and of the
    reference's pipeline output."""
    for r in groups["four"]:
        np.testing.assert_allclose(r["pipe"], r["seq"], atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(r["pipe"], reference["pipe_ref"], atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(groups["four"][0]["seq"], reference["pipe_seq_ref"], atol=1e-5, rtol=1e-5)


def test_pipeline_stages_split_the_stacked_layers():
    from repro_torch.distributed.pipeline import split_stages

    w = torch.arange(8 * 3).reshape(8, 3)
    stages = split_stages({"w": w}, 4)
    assert stages["w"].shape == (4, 2, 3) and torch.equal(stages["w"][1], w[2:4])
    with pytest.raises(ValueError):
        split_stages(w, 3)


def test_a_save_under_one_mesh_restores_under_another_bit_for_bit(reference, groups):
    """Saved laid out ('data', 'model') on (2, 4), restored ('model', 'data')
    on (4, 2): each rank's leaf is its ``devices_indices_map`` slice of the
    saved tensor, bit for bit, and the slices gather to it; the same through
    ``CheckpointManager`` with device 0 writing in the background."""
    w = np.arange(64, dtype=np.float32).reshape(8, 8)
    want = reference["slices_4"]
    for rank, r in enumerate(groups["eight"]):
        (a, b), (c, d) = want[rank]
        assert np.array_equal(r["restored"], w[a:b, c:d]), rank
        assert bool(r["whole_again"])
        assert int(r["manager_step"]) == 7 and np.array_equal(r["manager_restored"], w[a:b, c:d]), rank


# -----------------------------------------------------------------------------
# what the slice must not move
# -----------------------------------------------------------------------------

#: the dry-run's counts of these cells, recorded before the sharded step
#: (argument bytes, FLOPs, bytes, peak and exchanges by kind); the dense
#: cells must not move.  Every peak of a cell that gathers was re-pinned
#: when the counter came to hold an exchange's result live until it is
#: freed (an allocation, which it had not counted), and every peak again
#: when it came to hold cuBLAS's workspace from the first product on
#: (``op_costs.LIBRARY_WORKSPACE_BYTES``): see CHANGES.md
PINNED = {
    ("qwen2.5-3b", (2, 2)): {
        "flops": 24258479774915.0, "bytes": 417313976078.0, "argument_bytes": 8494118916,
        "peak_bytes": 11782320180,
        "collective_bytes": {"all-gather": 6171394048.0, "all-reduce": 1527142376.0,
                             "reduce-scatter": 1698430976.0},
        "collective_counts": {"all-gather": 506.0, "all-reduce": 366.0, "reduce-scatter": 254.0}},
    ("qwen2.5-3b", (1, 4)): {
        "flops": 24267830616729.0, "bytes": 495451098328.0, "argument_bytes": 8493896708,
        "peak_bytes": 11782051892,
        "collective_bytes": {"all-reduce": 3053502416.0, "all-gather": 301989888.0, "reduce-scatter": 37748736.0},
        "collective_counts": {"all-reduce": 185.0, "all-gather": 144.0, "reduce-scatter": 72.0}},
    # re-pinned when its MoE layers came to route the whole batch's tokens
    # (the global capacity, positions and aux loss; the buffer summed over
    # the token axes in place of the all-to-all): see CHANGES.md
    ("qwen3-moe-30b-a3b", (2, 2, 4)): {
        "flops": 62760879.0, "bytes": 32367968.0, "argument_bytes": 204932, "peak_bytes": 34817628,
        "collective_bytes": {"all-gather": 3067904.0, "all-reduce": 212816.0, "reduce-scatter": 878592.0},
        "collective_counts": {"all-gather": 66.0, "all-reduce": 34.0, "reduce-scatter": 42.0}},
    # dense and SSM cells, recorded on the commit before the MoE repairs: the
    # reduced configs' training step at 16 x 64 under ``baseline``
    ("mamba2-780m", (2, 4)): {
        "flops": 305831963.0, "bytes": 200700604.0, "argument_bytes": 101396, "peak_bytes": 40883468,
        "collective_bytes": {"all-gather": 309632.0, "all-reduce": 139344.0, "reduce-scatter": 34048.0},
        "collective_counts": {"all-gather": 34.0, "all-reduce": 20.0, "reduce-scatter": 6.0}},
    ("zamba2-7b", (2, 4)): {
        "flops": 717471397.0, "bytes": 447937756.0, "argument_bytes": 252580, "peak_bytes": 41176220,
        "collective_bytes": {"all-gather": 684800.0, "all-reduce": 797056.0, "reduce-scatter": 80384.0},
        "collective_counts": {"all-gather": 94.0, "all-reduce": 46.0, "reduce-scatter": 24.0}},
    ("gemma2-2b", (2, 4)): {
        "flops": 215091245.0, "bytes": 190422948.0, "argument_bytes": 217732, "peak_bytes": 37287456,
        "collective_bytes": {"all-gather": 688128.0, "all-reduce": 1712160.0, "reduce-scatter": 110592.0},
        "collective_counts": {"all-gather": 74.0, "all-reduce": 46.0, "reduce-scatter": 38.0}},
}


@pytest.mark.parametrize("arch,shape", list(PINNED))
def test_the_dry_runs_pinned_cells_have_not_moved(arch, shape):
    """qwen2.5-3b's training step at 4 x 1024 under ``baseline`` on (2, 2)
    and (1, 4), full width and depth; the reduced qwen3-moe's under
    ``seqpar-ep`` on (2, 2, 4) (16 x 64, re-pinned with the MoE repairs);
    the reduced mamba2-780m's, zamba2-7b's and gemma2-2b's under
    ``baseline`` on (2, 4) (16 x 64), which the MoE repairs must not move:
    every count equal, exactly."""
    from repro_torch.models.registry import get_model

    if arch == "qwen2.5-3b":
        cell = dryrun.build_cell(arch, ShapeSuite("train_4x1024", "train", 1024, 4),
                                 make_mesh(shape, ("data", "model")), dryrun.POLICIES["baseline"])
        _, c = dryrun.count_cell(cell, scopes=False)
    elif arch != MOE:
        cell = dryrun.build_cell(arch, ShapeSuite("x", "train", 64, 16), make_mesh(shape, ("data", "model")),
                                 dryrun.POLICIES["baseline"], cfg=get_model(arch).reduced)
        _, c = dryrun.count_cell(cell, scopes=False)
    else:
        with hints.moe_buffer_pspec(dryrun.MOE_BUFFER_SPEC):
            cell = dryrun.build_cell(arch, ShapeSuite("x", "train", 64, 16), make_mesh(shape, ("pod", "data", "model")),
                                     dryrun.POLICIES["seqpar-ep"], cfg=get_model(arch).reduced)
            _, c = dryrun.count_cell(cell, scopes=False)
    j, m = c.costs.to_json(), c.memory()
    got = {"flops": j["flops"], "bytes": j["bytes"], "argument_bytes": m["argument_bytes"],
           "peak_bytes": m["peak_bytes"], "collective_bytes": j["collective_bytes"],
           "collective_counts": j["collective_counts"]}
    assert got == PINNED[(arch, shape)]


#: sha256 of the parameters and metrics after two steps with no program
#: installed, recorded before the sharded step
NO_PROGRAM_BITS = {
    ("qwen2.5-3b", "float32", False, 1): "b5caf9b7bc753295e5579535f7f57c1d7c48b98f579037d59343650674192e76",
    ("qwen2.5-3b", None, True, 2): "a614cd50e62980d7ea1f080efd2e63a326cc61ffc8b741af646d5b848407428b",
    ("qwen3-moe-30b-a3b", "float32", True, 1): "8d6dbc32588720fa68088cf52954df717c9c326f94d291765b18399b197081f5",
    # recorded before the encoder-decoder's cross K/V and the whole-sequence
    # weights were repaired under a program (whisper behind its frames, the
    # vlm behind its patches)
    ("whisper-base", "float32", True, 1): "3a605530dc7a312816c78337ba647d4d9efa438da6065c4c876c76abd8a8c604",
    ("mamba2-780m", "float32", True, 1): "19f8a1155143cdad89c8250bcc0056e88de350e36b7ee0ad1c1fdc2b891d9085",
    ("internvl2-76b", "float32", True, 1): "743fea2ff9f37ab46119b07437e21252537d1dce3c1fda0b35fbc57690b987fd",
}


@pytest.mark.parametrize("arch,dtype,remat,microbatches", list(NO_PROGRAM_BITS))
def test_a_step_with_no_program_gives_the_same_bits(arch, dtype, remat, microbatches):
    from repro_torch.models import layers as L
    from repro_torch.models.registry import get_model
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import make_train_step

    assert D.current() is None
    api = get_model(arch)
    cfg = api.reduced if dtype is None else dataclasses.replace(api.reduced, dtype=dtype)
    params = L.trainable(api.init(torch.Generator().manual_seed(0), cfg, device="cpu"))
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=0, schedule="constant")
    state = adamw.init(opt_cfg, params)
    batch = {"tokens": torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab, (8, 32)).astype(np.int32)),
             **G.extras(cfg, 8)}
    step = make_train_step(api, cfg, opt_cfg, remat=remat, microbatches=microbatches)
    for _ in range(2):
        params, state, metrics = step(params, state, batch)
    h = hashlib.sha256()
    for k, p in params.named_parameters():
        h.update(k.encode())
        t = p.detach()
        h.update((t.view(torch.int16) if t.dtype == torch.bfloat16 else t.contiguous().view(torch.uint8)).numpy()
                 .tobytes())
    for k in sorted(metrics):
        h.update(k.encode())
        h.update(np.asarray(metrics[k].float().numpy()).tobytes())
    assert h.hexdigest() == NO_PROGRAM_BITS[(arch, dtype, remat, microbatches)]
