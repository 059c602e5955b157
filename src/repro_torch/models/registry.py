"""Architecture registry: ``--arch <id>`` resolution for every entry point.

Each architecture binds a full :class:`ModelConfig`, a reduced one for tests
on the CPU, and its family module: every architecture of the reference, in
the dense, MoE, ssm, hybrid, encdec and vlm families.  The dry-run specs
(``batch_specs``, ``param_specs``, ``cache_specs``, ``shapes``) stand in
for a step's inputs at a shape suite as the reference's ``ShapeDtypeStruct``
leaves do: tensors and modules on ``torch.device("meta")``, which allocate
nothing.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any

import torch

from repro_torch.configs.shapes import ShapeSuite, applicable_shapes
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

_MODEL_CLASSES = {  # each family module's parameter container
    "dense": "Transformer", "moe": "Transformer", "vlm": "VLM", "ssm": "Mamba2LM",
    "hybrid": "HybridLM", "encdec": "EncDec",
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

    # ---- dry-run specs: meta tensors, nothing allocated --------------------------
    def batch_specs(self, cfg: ModelConfig, suite: ShapeSuite) -> dict[str, torch.Tensor]:
        """Meta stand-ins for the *data* inputs of the step kind: int32
        ``tokens [B, S]`` (train, prefill; with ``frames`` or ``patches`` in
        the model's dtype for encdec and vlm) or ``token [B]`` (decode)."""
        B, S = suite.global_batch, suite.seq_len
        dt = getattr(torch, cfg.dtype)

        def meta(shape, dtype):
            return torch.empty(shape, dtype=dtype, device="meta")

        if suite.kind in ("train", "prefill"):
            specs = {"tokens": meta((B, S), torch.int32)}
            if cfg.family == "encdec":
                specs["frames"] = meta((B, cfg.enc_frames, cfg.d_model), dt)
            if cfg.family == "vlm":
                specs["patches"] = meta((B, cfg.num_patches, cfg.d_model), dt)
            return specs
        if suite.kind == "decode":
            return {"token": meta((B,), torch.int32)}
        raise ValueError(suite.kind)

    def param_specs(self, cfg: ModelConfig | None = None) -> torch.nn.Module:
        """The model's parameters built on meta."""
        cfg = cfg or self.config
        return getattr(self.module, _MODEL_CLASSES[cfg.family])(cfg, torch.device("meta"))

    def cache_specs(self, cfg: ModelConfig, suite: ShapeSuite) -> dict:
        """The serving cache for the suite's batch and length, on meta."""
        return self.module.init_cache(cfg, suite.global_batch, suite.seq_len, device="meta")

    def shapes(self) -> list[str]:
        return applicable_shapes(self.name)


def get_model(arch: str) -> ModelApi:
    if arch not in ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; options: {sorted(ARCH_MODULES)}")
    cfg_mod = importlib.import_module(ARCH_MODULES[arch])
    config: ModelConfig = cfg_mod.CONFIG
    fam_mod = importlib.import_module(_FAMILY_MODULES[config.family])
    return ModelApi(name=arch, config=config, reduced=cfg_mod.REDUCED, module=fam_mod)
