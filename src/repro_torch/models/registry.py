"""Architecture registry: ``--arch <id>`` resolution for the serving CLI.

Each architecture binds a full :class:`ModelConfig`, a reduced one for tests
on the CPU, and its family module: every architecture of the reference, in
the dense, MoE, ssm, hybrid, encdec and vlm families.  The reference's
dry-run specs (``batch_specs``, ``param_specs``, ``cache_specs``) belong to
``launch/dryrun``, not ported yet.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any

import torch

from repro_torch.models.config import ModelConfig

ARCH_MODULES: dict[str, str] = {
    "qwen2.5-3b": "repro_torch.configs.qwen2_5_3b",
    "stablelm-1.6b": "repro_torch.configs.stablelm_1_6b",
    "gemma2-2b": "repro_torch.configs.gemma2_2b",
    "mamba2-780m": "repro_torch.configs.mamba2_780m",
    "zamba2-7b": "repro_torch.configs.zamba2_7b",
    "qwen3-moe-30b-a3b": "repro_torch.configs.qwen3_moe_30b_a3b",
    "mixtral-8x7b": "repro_torch.configs.mixtral_8x7b",
    "deepseek-67b": "repro_torch.configs.deepseek_67b",
    "whisper-base": "repro_torch.configs.whisper_base",
    "internvl2-76b": "repro_torch.configs.internvl2_76b",
}

ALL_ARCHS = tuple(ARCH_MODULES)

_FAMILY_MODULES = {
    "dense": "repro_torch.models.transformer",
    "moe": "repro_torch.models.transformer",
    "ssm": "repro_torch.models.ssm",
    "hybrid": "repro_torch.models.hybrid",
    "encdec": "repro_torch.models.encdec",
    "vlm": "repro_torch.models.vlm",
}


@dataclasses.dataclass(frozen=True)
class ModelApi:
    name: str
    config: ModelConfig
    reduced: ModelConfig
    module: Any  # family module

    def init(self, generator: torch.Generator, cfg: ModelConfig | None = None,
             device: torch.device | str = "cuda"):
        return self.module.init_params(generator, cfg or self.config, device)

    def forward(self, params, batch: dict, cfg: ModelConfig | None = None, *, remat: bool = False):
        """batch {"tokens"}, with {"frames"} (encdec) or {"patches"} (vlm)."""
        return self.module.forward(params, cfg or self.config, batch, remat=remat)

    def init_cache(self, batch: int, max_len: int, cfg: ModelConfig | None = None,
                   device: torch.device | str = "cuda") -> dict:
        return self.module.init_cache(cfg or self.config, batch, max_len, device)

    def prefill(self, params, tokens: torch.Tensor, cache: dict, cfg: ModelConfig | None = None,
                **extras):
        """``extras``: ``frames=`` (encdec, required) or ``patches=`` (vlm)."""
        return self.module.prefill(params, cfg or self.config, tokens, cache, **extras)

    def decode_step(self, params, token: torch.Tensor, cache: dict,
                    cfg: ModelConfig | None = None):
        return self.module.decode_step(params, cfg or self.config, token, cache)


def get_model(arch: str) -> ModelApi:
    if arch not in ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; options: {sorted(ARCH_MODULES)}")
    cfg_mod = importlib.import_module(ARCH_MODULES[arch])
    config: ModelConfig = cfg_mod.CONFIG
    fam_mod = importlib.import_module(_FAMILY_MODULES[config.family])
    return ModelApi(name=arch, config=config, reduced=cfg_mod.REDUCED, module=fam_mod)
