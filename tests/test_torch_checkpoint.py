"""Checkpoints, the Trainer, fault tolerance and the training CLI against
the JAX package's.

The reference's ``repro.checkpoint``, ``repro.train.trainer`` and
``repro.distributed.fault_tolerance`` import in process (msgpack is
installed here, as is zstandard, so the reference writes zstd unless a
test takes its zlib fallback, ``zstandard = None``, the path it takes on
the card's machine; the port never imports either and writes zlib).
``replacement_schedule`` reaches ``repro.core`` and runs in the child
harness (``tests/torch_reference.py::job_replacement``).

Tolerances: checkpoint leaves, msgpack bytes and stream state exact; the
Trainer's losses within rtol 1e-5 of the reference's Trainer from the same
initial parameters (f32 summation order, through AdamW steps); a resumed
run's losses equal the straight run's bit for bit on the CPU.
"""

import dataclasses
import json
import zlib

import msgpack
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.checkpoint import checkpoint as jckpt
from repro.data.pipeline import DataConfig as JDataConfig
from repro.models.registry import get_model as jax_get_model
from repro.optim import adamw as jadamw
from repro.train.trainer import Trainer as JTrainer
from repro.train.trainer import TrainerConfig as JTrainerConfig

import torch_reference as ref_harness
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.checkpoint.checkpoint import CheckpointManager, restore_pytree, save_pytree
from repro_torch.data.pipeline import DataConfig
from repro_torch.distributed.fault_tolerance import StragglerDetector, plan_remesh, replacement_schedule
from repro_torch.launch import train as train_cli
from repro_torch.models import layers as L
from repro_torch.models.convert import params_from_arrays
from repro_torch.models.registry import get_model
from repro_torch.optim import adamw
from repro_torch.train.trainer import Trainer, TrainerConfig


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small ops; with the several pytest workers a test run starts
    side by side, each op's intra-op thread team waits on the others'."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tree():
    return {
        "a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
        "b": {"c": torch.linspace(-3, 3, 5).to(torch.bfloat16), "d": torch.tensor(3, dtype=torch.int32)},
        "e": [torch.ones(2, 2, dtype=torch.int64), (np.float32(2.5), 7)],
    }


def _leaves(tree):
    return [leaf for _, leaf in ckpt._flatten(tree)]


# -----------------------------------------------------------------------------
# checkpoints
# -----------------------------------------------------------------------------


def test_save_restore_roundtrip(tmp_path):
    tree = _tree()
    save_pytree(tree, tmp_path / "ck")
    out = restore_pytree(tree, tmp_path / "ck")
    assert isinstance(out["e"], list) and isinstance(out["e"][1], tuple)
    for a, b in zip(_leaves(tree), _leaves(out)):
        a = torch.as_tensor(np.asarray(a)) if not isinstance(a, torch.Tensor) else a
        assert a.dtype == b.dtype and torch.equal(a, b)
    manifest = json.loads((tmp_path / "ck" / "manifest.json").read_text())
    assert manifest["num_leaves"] == 6
    assert manifest["paths"] == ["['a']", "['b']['c']", "['b']['d']", "['e'][0]", "['e'][1][0]", "['e'][1][1]"]


@pytest.fixture
def reference_writes_zlib(monkeypatch):
    """The reference's checkpoints as it writes them without zstandard."""
    monkeypatch.setattr(jckpt, "zstandard", None)


def test_layout_and_manifest_are_the_reference_s(tmp_path, reference_writes_zlib):
    """The same tree saved by both packages: the same files, the same
    manifest (``time`` aside) and the same leaf payloads; and each package
    restores the other's directory."""
    # 32-bit leaves: JAX without x64 would turn 64-bit ones into 32-bit ones
    tree = {"w": np.arange(6, dtype=np.float32).reshape(2, 3), "n": {"x": np.int32(4), "y": [np.ones(3, np.float32)]}}
    save_pytree(tree, tmp_path / "port")
    jckpt.save_pytree(jax.tree.map(jnp.asarray, tree), tmp_path / "ref")
    files = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert files == sorted(p.name for p in (tmp_path / "ref").iterdir())
    mp, mr = (json.loads((tmp_path / d / "manifest.json").read_text()) for d in ("port", "ref"))
    assert {k: v for k, v in mp.items() if k != "time"} == {k: v for k, v in mr.items() if k != "time"}
    for name in files:
        if name.endswith(".zst"):
            assert zlib.decompress((tmp_path / "port" / name).read_bytes()) == \
                zlib.decompress((tmp_path / "ref" / name).read_bytes()), name
    from_ref = restore_pytree(tree, tmp_path / "ref")
    from_port = jckpt.restore_pytree(jax.tree.map(jnp.asarray, tree), tmp_path / "port")
    for a, b, c in zip(_leaves(tree), _leaves(from_ref), jax.tree.leaves(from_port)):
        assert np.asarray(a).tobytes() == b.numpy().tobytes() == np.asarray(c).tobytes()


def test_save_is_atomic(tmp_path):
    save_pytree({"a": torch.zeros(4)}, tmp_path / "ck")
    save_pytree({"a": torch.ones(4)}, tmp_path / "ck")  # replaces wholesale; no .tmp residue
    assert not (tmp_path / "ck.tmp").exists()
    assert torch.equal(restore_pytree({"a": torch.zeros(4)}, tmp_path / "ck")["a"], torch.ones(4))


def test_leaf_count_mismatch_rejected(tmp_path):
    save_pytree({"a": torch.zeros(4)}, tmp_path / "ck")
    with pytest.raises(ValueError, match="leaves"):
        restore_pytree({"a": torch.zeros(4), "b": torch.zeros(2)}, tmp_path / "ck")


@pytest.mark.parametrize("async_save", [False, True])
def test_manager_retention_and_latest(tmp_path, async_save):
    mgr = CheckpointManager(tmp_path, keep=2, async_save=async_save)
    assert mgr.restore({"x": torch.tensor(0)}) == (None, None)
    x = torch.tensor(0)
    for s in (10, 20, 30):
        x.fill_(s)
        mgr.save(s, {"x": x})  # a snapshot: the in-place fill after it does not reach the file
    x.fill_(99)
    mgr.wait()
    assert mgr.latest_step() == 30
    assert mgr.all_steps() == [20, 30]  # step 10 collected
    out, step = mgr.restore({"x": torch.tensor(0)})
    assert step == 30 and int(out["x"]) == 30
    out, step = mgr.restore({"x": torch.tensor(0)}, step=20)
    assert int(out["x"]) == 20


def test_a_failed_async_save_raises_from_wait(tmp_path):
    mgr = CheckpointManager(tmp_path, async_save=True)
    (tmp_path / "step_00000001.tmp").write_text("a file where the save's directory goes")
    mgr.save(1, {"x": torch.zeros(2)})
    with pytest.raises(NotADirectoryError):
        mgr.wait()
    mgr.wait()  # raised once


@pytest.mark.parametrize("leaf", [np.arange(7, dtype=np.float32), np.arange(6, dtype=np.int32).reshape(2, 3),
                                  np.array(5, np.int32), np.zeros((0, 3), np.float32), "bf16"])
def test_each_package_reads_the_other_s_leaves(leaf, reference_writes_zlib):
    if isinstance(leaf, str):  # bf16: stored as its uint16 bits under "bfloat16"
        bits = np.random.default_rng(0).integers(0, 2**16, (4, 5), dtype=np.uint16)
        bits[(bits & 0x7F80) == 0x7F80] = 0  # no NaN or inf patterns
        port_leaf = torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)
        ref_leaf = jnp.asarray(bits.view(jnp.bfloat16))
    else:
        port_leaf, ref_leaf = torch.from_numpy(leaf), jnp.asarray(leaf)
    from_port = jckpt._decode_leaf(ckpt._encode_leaf(port_leaf))
    from_ref = ckpt._decode_leaf(jckpt._encode_leaf(ref_leaf))
    assert from_ref.dtype == port_leaf.dtype and from_ref.shape == port_leaf.shape
    assert np.asarray(from_port).dtype == np.asarray(ref_leaf).dtype
    assert torch.equal(from_ref.view(-1).view(torch.uint8), port_leaf.reshape(-1).view(torch.uint8))
    assert np.asarray(from_port).tobytes() == np.asarray(ref_leaf).tobytes()
    # the port's msgpack bytes are msgpack's
    a, dtype = ckpt._host_array(port_leaf)
    payload = {"dtype": dtype, "shape": list(a.shape), "data": a.tobytes()}
    assert ckpt.packb(payload) == msgpack.packb(payload)


@pytest.mark.parametrize("n", [0, 15, 16, 31, 32, 255, 256, 65535, 65536])
def test_msgpack_subset_is_msgpack_at_every_length(n):
    obj = {"s": "x" * n, "b": b"y" * n, "a": list(range(min(n, 300))), "i": n * 70000}
    packed = ckpt.packb(obj)
    assert packed == msgpack.packb(obj)
    out = ckpt.unpackb(packed)
    assert {**out, "b": bytes(out["b"])} == msgpack.unpackb(packed)


def test_msgpack_subset_refuses_what_a_leaf_never_holds():
    with pytest.raises(TypeError):
        ckpt.packb({"f": 1.5})
    with pytest.raises(ValueError, match="type byte"):
        ckpt.unpackb(msgpack.packb({"f": 1.5}))
    with pytest.raises(ValueError, match="type byte"):
        ckpt.unpackb(msgpack.packb({"shape": [-1]}))
    with pytest.raises(ValueError, match="after"):
        ckpt.unpackb(msgpack.packb(1) + b"\x00")


def test_a_zstd_leaf_raises_the_reference_s_error():
    """A leaf the reference wrote with zstandard (installed here): the port
    raises the error the reference raises without the module."""
    frame = jckpt._encode_leaf(jnp.arange(4.0))
    assert frame[:4] == b"\x28\xb5\x2f\xfd"
    with pytest.raises(ModuleNotFoundError, match="zstd-compressed but the 'zstandard' module"):
        ckpt._decode_leaf(frame)


# -----------------------------------------------------------------------------
# the Trainer
# -----------------------------------------------------------------------------


def _trainer_setup():
    """The reference's resume test's setting: reduced qwen2.5-3b in f32 at
    vocab 64."""
    japi, api = jax_get_model("qwen2.5-3b"), get_model("qwen2.5-3b")
    cfg = dataclasses.replace(api.reduced, dtype="float32", vocab=64)
    opt = dict(lr=1e-3, warmup_steps=2, total_steps=20, schedule="constant")
    data = dict(vocab=64, seq_len=32, global_batch=4, seed=5)
    return japi, api, cfg, opt, data


class _FromTree(Trainer):
    """A Trainer that starts from the reference's parameter tree."""

    tree = None

    def init_state(self):
        params = L.trainable(params_from_arrays(self.tree, self.cfg, device=self.device))
        return params, adamw.init(self.opt_cfg, params)


def test_trainer_losses_match_the_reference_trainer(tmp_path):
    japi, api, cfg, opt, data = _trainer_setup()
    jtrainer = JTrainer(japi, cfg, jadamw.AdamWConfig(**opt), JDataConfig(**data),
                        JTrainerConfig(steps=6, checkpoint_every=3, checkpoint_dir=str(tmp_path / "ref"),
                                       remat=True, resume=False))
    jresult = jtrainer.run()
    _FromTree.tree = jtrainer.init_state()[0]
    result = _FromTree(api, cfg, adamw.AdamWConfig(**opt), DataConfig(**data),
                       TrainerConfig(steps=6, checkpoint_every=3, checkpoint_dir=str(tmp_path / "port"),
                                     resume=False), device="cpu").run()
    np.testing.assert_allclose(result.losses, jresult.losses, rtol=1e-5)
    assert result.final_step == jresult.final_step == 6 and result.resumed_from is None
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == ["step_00000003", "step_00000006"]


def test_trainer_resume_reproduces_the_straight_run(tmp_path):
    """The reference's resume check, held to equal bits on the CPU."""
    _, api, cfg, opt, data = _trainer_setup()

    def make(dirname, steps, **kw):
        return Trainer(api, cfg, adamw.AdamWConfig(**opt), DataConfig(**data),
                       TrainerConfig(steps=steps, checkpoint_every=5, checkpoint_dir=str(tmp_path / dirname),
                                     remat=False, resume=True, **kw), device="cpu")

    full = make("full", 10).run()
    make("resume", 5).run()
    resumed = make("resume", 10).run()
    assert resumed.resumed_from == 5 and len(resumed.losses) == 5
    assert resumed.losses == full.losses[5:]
    # the saved state: every parameter, both moments, the step and the stream
    state, step = CheckpointManager(tmp_path / "resume").restore(
        make("x", 1)._state(*make("x", 1).init_state()))
    assert step == 10 and int(state["opt"]["step"]) == 10 and int(state["data"]["step"]) == 10


def test_trainer_flags_an_injected_straggler(tmp_path):
    """Every step is a virtual 10 s on top of its measured time, and steps
    9-11 take 5 s more: the detector's floor (5% of the mean, 0.5 s) then
    sits far above the host's jitter of a few ms, and the window stands out
    by 10 floors, as in the reference's own test of 1 s steps."""
    _, api, cfg, opt, data = _trainer_setup()
    trainer = Trainer(api, cfg, adamw.AdamWConfig(**opt), DataConfig(**data),
                      TrainerConfig(steps=14, checkpoint_every=100, checkpoint_dir=str(tmp_path), remat=False),
                      step_delay_injector=lambda s: 10.0 + (5.0 if s in (9, 10, 11) else 0.0), device="cpu")
    flags = trainer.run().straggler_flags
    assert flags and all(9 <= s <= 11 for s in flags), flags  # the window, as the reference's own test


# -----------------------------------------------------------------------------
# fault tolerance
# -----------------------------------------------------------------------------


def test_straggler_detector_flags_injected_delay():
    det = StragglerDetector(patience=2)
    flagged = [s for s in range(40) if det.observe(s, 5.0 if s in (25, 26, 27, 28) else 1.0 + 0.01 * (s % 3))]
    assert flagged and all(24 <= s <= 29 for s in flagged)


def test_straggler_detector_ignores_noise():
    det = StragglerDetector()
    rng = np.random.default_rng(0)
    assert not any(det.observe(s, 1.0 + 0.05 * rng.standard_normal()) for s in range(50))


def test_straggler_detector_equals_the_reference():
    from repro.distributed.fault_tolerance import StragglerDetector as JStragglerDetector

    rng = np.random.default_rng(1)
    times = 1.0 + 0.02 * rng.standard_normal(200)
    times[[50, 51, 52, 53, 120, 121, 122, 180]] = 3.0
    port, ref = StragglerDetector(), JStragglerDetector()
    assert [port.observe(s, t) for s, t in enumerate(times)] == [ref.observe(s, t) for s, t in enumerate(times)]
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)


def test_plan_remesh_equals_the_reference():
    from repro.distributed.fault_tolerance import plan_remesh as jplan_remesh

    for pods in (1, 2, 3, 7):
        for kw in ({}, {"chips_per_pod": 64, "model_parallel": 8}):
            assert dataclasses.asdict(plan_remesh(surviving_pods=pods, **kw)) == \
                dataclasses.asdict(jplan_remesh(surviving_pods=pods, **kw))
    assert plan_remesh(surviving_pods=2).mesh_shape == (2, 16, 16)
    assert plan_remesh(surviving_pods=1).axis_names == ("data", "model")
    with pytest.raises(ValueError):
        plan_remesh(surviving_pods=0)


def test_replacement_schedule_equals_the_reference():
    cases = [{"jobs": [{"name": f"job{i}", "flops": 1e15 * (i + 1), "bytes_in": 1.0} for i in range(4)], "pods": 2},
             {"jobs": [{"name": f"j{i}", "flops": 3e14 * (7 - i), "bytes_in": 1e9 * i} for i in range(7)], "pods": 3}]
    ref = ref_harness.run("replacement", {"cases": cases})
    for i, case in enumerate(cases):
        rep = replacement_schedule(case["jobs"], case["pods"])
        s = rep.schedule
        assert s.violations == 0 and np.isfinite(s.makespan)
        np.testing.assert_array_equal(s.assignment, ref[f"{i}/assignment"])
        np.testing.assert_array_equal(s.start, ref[f"{i}/start"])
        np.testing.assert_array_equal(s.finish, ref[f"{i}/finish"])
        np.testing.assert_array_equal([s.makespan, s.usage, s.objective, s.violations], ref[f"{i}/stats"])


# -----------------------------------------------------------------------------
# the CLI
# -----------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "mamba2-780m", "mixtral-8x7b"])
def test_cli_trains_on_the_cpu(arch, tmp_path, capsys):
    argv = ["--arch", arch, "--steps", "3", "--seq", "16", "--device", "cpu", "--ckpt-dir", str(tmp_path)]
    train_cli.main(argv)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith(f"arch={arch} steps=3 loss ") and "resumed" not in line
    train_cli.main(argv[:3] + ["5"] + argv[4:] + ["--resume"])
    assert capsys.readouterr().out.strip().endswith("(resumed from 3)")


@pytest.mark.parametrize("arch,key", [("whisper-base", "frames"), ("internvl2-76b", "patches")])
def test_cli_fails_as_the_reference_for_encdec_and_vlm(arch, key, tmp_path):
    with pytest.raises(KeyError, match=key):
        train_cli.main(["--arch", arch, "--steps", "2", "--device", "cpu", "--ckpt-dir", str(tmp_path)])
