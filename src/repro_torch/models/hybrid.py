"""Zamba2-style hybrid LM: a Mamba2 backbone plus one *shared* attention +
MLP block applied after every ``hybrid_period``-th layer, its weights reused
and each invocation with its own KV cache.

Ported from the reference's ``repro/models/hybrid.py``, with its
simplification: the shared block is a plain pre-norm attention + MLP
residual block (no per-invocation LoRA adapters, no concatenation with the
embedding).  The reference stacks the Mamba2 layers on a leading axis and
runs them with ``lax.scan`` and ``lax.cond``; here ``blocks`` is an
``nn.ModuleList`` of :class:`~repro_torch.models.ssm.Block` and the scan is
a Python loop, with each layer's invocation index known on the host.  Every
prefill layer runs the SSD scan through its kernel's wrapper; every shared
invocation runs the flash kernel in prefill and the decode kernel in
decode.

API, as the reference's: ``init_params`` / ``forward`` / ``init_cache`` /
``prefill`` / ``decode_step``.  The cache is ``{"layers": {"ssm": [L, B, H,
P, N] f32, "conv": [L, B, conv - 1, C]}, "shared_kv": {"k", "v": [n_inv, B,
Hkv, max_len, D]}, "pos": int}``, written in place; batch is on axis 1 of
every entry, so the engine grafts a prefill into a slot as for the other
families.  The caches and the residual stream pass through
``distributed/program.py`` and ``hints.constrain`` (the input itself unless
a sharded program is installed).
"""

from __future__ import annotations

from collections.abc import Iterator

import torch
from torch import nn

from repro_torch.distributed import hints
from repro_torch.distributed import program as D
from repro_torch.models import layers as L
from repro_torch.models import mamba as M
from repro_torch.models import ssm
from repro_torch.models.config import ModelConfig


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family != "hybrid":
        raise ValueError(f"{cfg.name}: family {cfg.family!r} is not the hybrid family")


def num_shared_invocations(cfg: ModelConfig) -> int:
    return sum(1 for i in range(cfg.num_layers) if (i + 1) % cfg.hybrid_period == 0)


def _invocations(cfg: ModelConfig) -> Iterator[int | None]:
    """Per layer, in order: the index of the shared invocation that follows
    it, or None."""
    inv = 0
    for i in range(cfg.num_layers):
        if (i + 1) % cfg.hybrid_period == 0:
            yield inv
            inv += 1
        else:
            yield None


class SharedBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, *, dtype: torch.dtype, device: torch.device | str):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.ln_attn = L.RMSNorm(cfg.d_model, **kw)
        self.attn = L.Attention(cfg, **kw)
        self.ln_mlp = L.RMSNorm(cfg.d_model, **kw)
        self.mlp = L.MLP(cfg, **kw)


class HybridLM(nn.Module):
    """The parameters: ``embed``, ``blocks[i]`` (``ln``, ``mamba``),
    ``shared`` (``ln_attn``, ``attn``, ``ln_mlp``, ``mlp``), ``ln_final``."""

    def __init__(self, cfg: ModelConfig, device: torch.device | str):
        super().__init__()
        _check_family(cfg)
        kw = dict(dtype=L.torch_dtype(cfg.dtype), device=device)
        self.embed = L.Embed(cfg, **kw)
        self.blocks = nn.ModuleList(ssm.Block(cfg, **kw) for _ in range(cfg.num_layers))
        self.shared = SharedBlock(cfg, **kw)
        self.ln_final = L.RMSNorm(cfg.d_model, **kw)


def init_params(generator: torch.Generator, cfg: ModelConfig,
                device: torch.device | str = "cuda") -> HybridLM:
    """Random parameters at the reference's scales (those of the ssm and
    dense families), drawn from ``generator`` on its own device, then moved
    to ``device``."""
    return L.init_modules(HybridLM(cfg, torch.device("meta")).to_empty(device=device), generator)


def _mlp_residual(p: SharedBlock, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return x + L.mlp(p.mlp, L.rmsnorm(p.ln_mlp, x, cfg.norm_eps), cfg)


def _shared_forward(p: SharedBlock, x: torch.Tensor, cfg: ModelConfig):
    """The shared block over a whole sequence; returns (x, (k, v))."""
    h, kv = L.attention_forward(p.attn, L.rmsnorm(p.ln_attn, x, cfg.norm_eps), cfg)
    return _mlp_residual(p, x + h, cfg), kv


def forward(params: HybridLM, cfg: ModelConfig, batch: dict, *,
            remat: bool = False) -> tuple[torch.Tensor, dict]:
    """batch {"tokens": [B, S]} -> (logits [B, S, V] f32, {"aux_loss": 0}).
    With ``remat`` each block (a Mamba2 layer and the shared invocation
    after it, if any) is recomputed in the backward."""

    def block_fn(x: torch.Tensor, p: ssm.Block, inv: int | None) -> torch.Tensor:
        x = hints.constrain(x)  # the residual stream's layout (sequence parallel)
        x = x + M.mamba_forward(p.mamba, L.rmsnorm(p.ln, x, cfg.norm_eps), cfg)
        if inv is not None:
            x, _ = _shared_forward(params.shared, x, cfg)
        return x

    x = L.embed(params.embed, batch["tokens"], cfg)
    for p, inv in zip(params.blocks, _invocations(cfg)):
        x = L.remat(block_fn, x, p, inv, enabled=remat)
    x = L.rmsnorm(params.ln_final, x, cfg.norm_eps)
    logits = L.unembed(params.embed, x, cfg)
    return logits, {"aux_loss": torch.zeros((), device=logits.device)}


# -----------------------------------------------------------------------------
# Serving: Mamba2 states per layer + one KV cache per shared-block invocation
# -----------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: torch.device | str = "cuda") -> dict:
    """Zeroed recurrent states for every layer and a zeroed KV cache of
    ``max_len`` positions for every shared invocation, in the model's dtype
    (the SSM state f32)."""
    _check_family(cfg)
    dtype = L.torch_dtype(cfg.dtype)
    one = M.mamba_cache_init(cfg, batch, dtype, device)
    layers = {k: v[None].repeat(cfg.num_layers, *([1] * v.dim())) for k, v in one.items()}
    shape = (num_shared_invocations(cfg), batch, cfg.num_kv_heads, max_len, cfg.resolved_head_dim)
    shared_kv = {"k": torch.zeros(shape, dtype=dtype, device=device),
                 "v": torch.zeros(shape, dtype=dtype, device=device)}
    return {"layers": layers, "shared_kv": shared_kv, "pos": 0}


def prefill(params: HybridLM, cfg: ModelConfig, tokens: torch.Tensor,
            cache: dict) -> tuple[torch.Tensor, dict]:
    """Run the prompt ``tokens [B, S]``, writing each layer's final states
    and each shared invocation's keys and values into ``cache`` in place (a
    prompt longer than the cache keeps its last positions, as the ring
    buffer a decode step continues).  Returns (last-position logits [B, V]
    f32, the cache at position S).  The conv window is zero-padded for any
    S >= 1 (:func:`ssm.mamba_forward_with_state`)."""
    S = tokens.shape[1]
    x = L.embed(params.embed, tokens, cfg)
    layers, shared_kv = cache["layers"], cache["shared_kv"]
    for i, (p, inv) in enumerate(zip(params.blocks, _invocations(cfg))):
        x = hints.constrain(x)
        y, state = ssm.mamba_forward_with_state(p.mamba, L.rmsnorm(p.ln, x, cfg.norm_eps), cfg)
        x = x + y
        D.cache_store(layers["ssm"][i], state["ssm"])
        D.cache_store(layers["conv"][i], state["conv"])
        if inv is not None:
            x, (kc, vc) = _shared_forward(params.shared, x, cfg)
            L.write_prompt_kv(shared_kv["k"][inv], kc)
            L.write_prompt_kv(shared_kv["v"][inv], vc)
    x = L.rmsnorm(params.ln_final, x, cfg.norm_eps)
    logits = L.unembed(params.embed, x[:, -1:], cfg)[:, 0]
    return logits, {"layers": layers, "shared_kv": shared_kv, "pos": S}


def decode_step(params: HybridLM, cfg: ModelConfig, token: torch.Tensor,
                cache: dict) -> tuple[torch.Tensor, dict]:
    """One decode step: token [B] -> (logits [B, V] f32, the cache one
    position on).  Every sequence sits at ``cache["pos"]``, as in the
    reference; the states and caches are updated in place."""
    B = token.shape[0]
    x = L.embed(params.embed, token[:, None], cfg)
    pos = cache["pos"]
    posb = torch.as_tensor(pos, device=x.device).broadcast_to((B,))  # once, not per invocation
    layers, shared_kv = cache["layers"], cache["shared_kv"]
    sp = params.shared
    for i, (p, inv) in enumerate(zip(params.blocks, _invocations(cfg))):
        c = {k: D.cache_load(v[i], v) for k, v in layers.items()}
        y, new = M.mamba_decode(p.mamba, L.rmsnorm(p.ln, x, cfg.norm_eps), cfg, c)
        x = x + y
        for k, v in new.items():
            D.cache_store(layers[k][i], v)
        if inv is not None:
            h, _, _ = L.attention_decode(sp.attn, L.rmsnorm(sp.ln_attn, x, cfg.norm_eps), cfg,
                                         shared_kv["k"][inv], shared_kv["v"][inv], posb)
            x = _mlp_residual(sp, x + h, cfg)
    x = L.rmsnorm(params.ln_final, x, cfg.norm_eps)
    logits = L.unembed(params.embed, x, cfg)[:, 0]
    return logits, {"layers": layers, "shared_kv": shared_kv, "pos": pos + 1}
