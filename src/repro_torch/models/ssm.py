"""Mamba2 language model, the attention-free SSM family.

Ported from the reference's ``repro/models/ssm.py``: a stack of Mamba2 SSD
blocks with pre-RMSNorm residuals.  The reference stacks the layers on a
leading axis and runs them with ``lax.scan``; here ``blocks`` is an
``nn.ModuleList`` of ``{ln, mamba}`` and the scan is a Python loop.  Every
prefill layer runs the SSD scan through its kernel's wrapper; decode carries
O(1) recurrent state per layer.

API, as the reference's: ``init_params`` / ``forward`` / ``init_cache`` /
``prefill`` / ``decode_step``.  The cache is ``{"layers": {"ssm": [L, B, H,
P, N] f32, "conv": [L, B, conv - 1, C]}, "pos": int}``, written in place
(through ``distributed/program.py``'s cache points, and each block's
residual stream through ``hints.constrain``: the input itself unless a
sharded program is installed).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed import hints
from repro_torch.distributed import program as D
from repro_torch.models import layers as L
from repro_torch.models import mamba as M
from repro_torch.models.config import ModelConfig


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family != "ssm":
        raise ValueError(f"{cfg.name}: family {cfg.family!r} is not the ssm family")


class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, *, dtype: torch.dtype, device: torch.device | str):
        super().__init__()
        self.ln = L.RMSNorm(cfg.d_model, dtype=dtype, device=device)
        self.mamba = M.Mamba2(cfg, dtype=dtype, device=device)


class Mamba2LM(nn.Module):
    """The parameters: ``embed``, ``blocks[i]`` (``ln``, ``mamba``),
    ``ln_final``."""

    def __init__(self, cfg: ModelConfig, device: torch.device | str):
        super().__init__()
        _check_family(cfg)
        kw = dict(dtype=L.torch_dtype(cfg.dtype), device=device)
        self.embed = L.Embed(cfg, **kw)
        self.blocks = nn.ModuleList(Block(cfg, **kw) for _ in range(cfg.num_layers))
        self.ln_final = L.RMSNorm(cfg.d_model, **kw)


def init_params(generator: torch.Generator, cfg: ModelConfig,
                device: torch.device | str = "cuda") -> Mamba2LM:
    """Random parameters at the reference's scales (see
    :meth:`Mamba2.init_` and ``transformer.init_params``), drawn from
    ``generator`` on its own device, then moved to ``device``."""
    return L.init_modules(Mamba2LM(cfg, torch.device("meta")).to_empty(device=device), generator)


def forward(params: Mamba2LM, cfg: ModelConfig, batch: dict, *,
            remat: bool = False) -> tuple[torch.Tensor, dict]:
    """batch {"tokens": [B, S]} -> (logits [B, S, V] f32, {"aux_loss": 0}).
    With ``remat`` each block is recomputed in the backward."""

    def block_fn(x: torch.Tensor, p: Block) -> torch.Tensor:
        x = hints.constrain(x)  # the residual stream's layout (sequence parallel)
        return x + M.mamba_forward(p.mamba, L.rmsnorm(p.ln, x, cfg.norm_eps), cfg)

    x = L.embed(params.embed, batch["tokens"], cfg)
    for p in params.blocks:
        x = L.remat(block_fn, x, p, enabled=remat)
    x = L.rmsnorm(params.ln_final, x, cfg.norm_eps)
    logits = L.unembed(params.embed, x, cfg)
    return logits, {"aux_loss": torch.zeros((), device=logits.device)}


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: torch.device | str = "cuda") -> dict:
    """Zeroed recurrent states for every layer; ``max_len`` is not needed
    (the state does not grow with the sequence)."""
    _check_family(cfg)
    one = M.mamba_cache_init(cfg, batch, L.torch_dtype(cfg.dtype), device)
    layers = {k: v[None].repeat(cfg.num_layers, *([1] * v.dim())) for k, v in one.items()}
    return {"layers": layers, "pos": 0}


def mamba_forward_with_state(p: M.Mamba2, u: torch.Tensor, cfg: ModelConfig):
    """The block's prefill: (out [B, S, d], {"ssm": the final SSM state,
    "conv": the conv window}).  The window is the last ``conv - 1`` rows of
    the conv inputs zero-padded on the left, as the model's own forward
    sees them, for any S >= 1 (the reference takes the last rows unpadded,
    which is short of rows for S < conv - 1)."""
    out, state, xbc_raw = M.mamba_mixer(p, u, cfg)
    pad = cfg.ssm_conv - 1
    window = F.pad(xbc_raw, (0, 0, pad, 0))[:, xbc_raw.shape[1]:]
    return out, {"ssm": state, "conv": window}


def prefill(params: Mamba2LM, cfg: ModelConfig, tokens: torch.Tensor,
            cache: dict) -> tuple[torch.Tensor, dict]:
    """Run the prompt ``tokens [B, S]`` and write each layer's final states
    into ``cache`` in place.  Returns (last-position logits [B, V] f32, the
    cache at position S)."""
    S = tokens.shape[1]
    x = L.embed(params.embed, tokens, cfg)
    layers = cache["layers"]
    for i, p in enumerate(params.blocks):
        x = hints.constrain(x)
        y, state = mamba_forward_with_state(p.mamba, L.rmsnorm(p.ln, x, cfg.norm_eps), cfg)
        x = x + y
        D.cache_store(layers["ssm"][i], state["ssm"])
        D.cache_store(layers["conv"][i], state["conv"])
    x = L.rmsnorm(params.ln_final, x, cfg.norm_eps)
    logits = L.unembed(params.embed, x[:, -1:], cfg)[:, 0]
    return logits, {"layers": layers, "pos": S}


def decode_step(params: Mamba2LM, cfg: ModelConfig, token: torch.Tensor,
                cache: dict) -> tuple[torch.Tensor, dict]:
    """One decode step: token [B] -> (logits [B, V] f32, the cache one
    position on, its states updated in place).  The step uses no position,
    so every slot of a batch is exact whatever its length."""
    x = L.embed(params.embed, token[:, None], cfg)
    layers = cache["layers"]
    for i, p in enumerate(params.blocks):
        c = {k: D.cache_load(v[i], v) for k, v in layers.items()}
        y, new = M.mamba_decode(p.mamba, L.rmsnorm(p.ln, x, cfg.norm_eps), cfg, c)
        x = x + y
        for k, v in new.items():
            D.cache_store(layers[k][i], v)
    x = L.rmsnorm(params.ln_final, x, cfg.norm_eps)
    logits = L.unembed(params.embed, x, cfg)[:, 0]
    return logits, {"layers": layers, "pos": cache["pos"] + 1}
