"""Fault-tolerant training loop: checkpoint and restart, straggler
monitoring, delay injection for tests, deterministic data resume.

Ported from the reference's ``repro/train/trainer.py``.  The state is
``{"params": {name: tensor}, "opt": the AdamW state, "data": the stream's
state}``; it is checkpointed every ``checkpoint_every`` steps and at the
last, and a run with ``resume`` continues from the latest checkpoint.  A
step's time runs until its loss reaches the host.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from collections.abc import Callable
from pathlib import Path

import torch

from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.data.pipeline import DataConfig, SyntheticLMStream
from repro_torch.distributed.fault_tolerance import StragglerDetector
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import ModelApi
from repro_torch.optim import adamw
from repro_torch.train.train_step import make_train_step


def _default_checkpoint_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    checkpoint_every: int = 25
    checkpoint_dir: str = dataclasses.field(default_factory=_default_checkpoint_dir)
    keep_checkpoints: int = 3
    log_every: int = 10
    microbatches: int = 1
    remat: bool = True
    seed: int = 0
    resume: bool = True


@dataclasses.dataclass
class TrainResult:
    losses: list
    final_step: int
    resumed_from: int | None
    straggler_flags: list


class Trainer:
    """Trains ``api``'s model ``cfg`` on the synthetic stream, on ``device``
    (the card unless the caller asks for the CPU)."""

    def __init__(
        self,
        api: ModelApi,
        cfg: ModelConfig,
        opt_cfg: adamw.AdamWConfig,
        data_cfg: DataConfig,
        tcfg: TrainerConfig,
        *,
        grad_compressor: Callable | None = None,
        step_delay_injector: Callable[[int], float] | None = None,
        device: torch.device | str = "cuda",
    ):
        self.api = api
        self.cfg = cfg
        self.opt_cfg = opt_cfg
        self.tcfg = tcfg
        self.device = torch.device(device)
        self.stream = SyntheticLMStream(data_cfg)
        self.ckpt = CheckpointManager(Path(tcfg.checkpoint_dir), keep=tcfg.keep_checkpoints, async_save=False)
        self.detector = StragglerDetector()
        self.step_fn = make_train_step(api, cfg, opt_cfg, remat=tcfg.remat, microbatches=tcfg.microbatches,
                                       grad_compressor=grad_compressor)
        self.delay_injector = step_delay_injector

    def init_state(self) -> tuple[torch.nn.Module, dict]:
        """(parameters drawn from ``seed`` on the device, with gradients on;
        the AdamW state)."""
        generator = torch.Generator(device=self.device).manual_seed(self.tcfg.seed)
        params = L.trainable(self.api.init(generator, self.cfg, device=self.device))
        return params, adamw.init(self.opt_cfg, params)

    def _state(self, params: torch.nn.Module, opt_state: dict) -> dict:
        return {"params": dict(params.named_parameters()), "opt": opt_state, "data": self.stream.state()}

    def run(self) -> TrainResult:
        params, opt_state = self.init_state()
        start_step = 0
        resumed_from = None
        if self.tcfg.resume:
            restored, step = self.ckpt.restore(self._state(params, opt_state))
            if restored is not None:
                with torch.no_grad():
                    for name, p in params.named_parameters():
                        p.copy_(restored["params"][name])
                opt_state = restored["opt"]
                self.stream.restore({k: int(v) for k, v in restored["data"].items()})
                start_step = int(step)
                resumed_from = start_step

        losses: list[float] = []
        flags: list[int] = []
        for step in range(start_step, self.tcfg.steps):
            batch = {k: torch.from_numpy(v).to(self.device) for k, v in self.stream.next_batch().items()}
            t0 = time.perf_counter()
            params, opt_state, metrics = self.step_fn(params, opt_state, batch)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            if self.delay_injector is not None:
                dt += self.delay_injector(step)
            if self.detector.observe(step, dt):
                flags.append(step)
            losses.append(loss)
            if (step + 1) % self.tcfg.checkpoint_every == 0 or step + 1 == self.tcfg.steps:
                self.ckpt.save(step + 1, self._state(params, opt_state))
        self.ckpt.wait()
        return TrainResult(losses=losses, final_step=self.tcfg.steps, resumed_from=resumed_from,
                           straggler_flags=flags)
