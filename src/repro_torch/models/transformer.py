"""Decoder-only transformer LM, dense and MoE families, and the vlm family's
language model (``models/vlm.py`` prepends patch embeddings through
``forward({"embeds": ...})`` and ``prefill(embeds=)``).

Ported from the reference's ``repro/models/transformer.py``.  The reference
stacks each window slot's layers along a leading axis and runs them with
``lax.scan``; here the blocks are an ``nn.ModuleList`` per window slot
(``params.blocks[slot][group]``) and the scan is a Python loop over layer
groups.  gemma2's alternating local/global attention keeps its layer
groups: slot 0 is local (window-sized ring-buffer caches), slot 1 global.
Each block passes the residual stream through ``hints.constrain`` at the
reference's points (the input itself unless a sharded program lays it
out).  A block of the MoE family holds ``moe``
(:class:`~repro_torch.models.moe.MoE`) where a dense block holds ``mlp``,
and ``forward`` returns the sum of its layers' load-balance losses.

API, as the reference's: ``init_params`` / ``forward`` / ``init_cache`` /
``prefill`` / ``decode_step``.  The cache is ``{"kv": ({"k", "v"} per
slot, each [n_groups, B, Hkv, S, D]), "pos": int}``.
"""

from __future__ import annotations

from collections.abc import Iterator

import torch
from torch import nn

from repro_torch.distributed import hints
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.models.moe import MoE, moe_ffn


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in ("dense", "moe", "vlm"):
        raise ValueError(f"{cfg.name}: family {cfg.family!r} is not a transformer LM")


def layer_windows(cfg: ModelConfig) -> tuple[int | None, ...]:
    """Static per-slot window sizes within a layer group."""
    if cfg.local_global:
        return (cfg.window, None)  # gemma2: even layers local, odd global
    return (cfg.window,)


def group_size(cfg: ModelConfig) -> int:
    return len(layer_windows(cfg))


class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, *, dtype: torch.dtype, device: torch.device | str):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.ln_attn = L.RMSNorm(cfg.d_model, **kw)
        self.attn = L.Attention(cfg, **kw)
        self.ln_mlp = L.RMSNorm(cfg.d_model, **kw)
        self.mlp = L.MLP(cfg, **kw) if cfg.family != "moe" else None
        self.moe = MoE(cfg, **kw) if cfg.family == "moe" else None
        self.ln_attn_post = L.RMSNorm(cfg.d_model, **kw) if cfg.post_norms else None
        self.ln_mlp_post = L.RMSNorm(cfg.d_model, **kw) if cfg.post_norms else None


class Transformer(nn.Module):
    """The parameters: ``embed``, ``blocks[slot][group]``, ``ln_final``.
    Layer ``i`` is ``blocks[i % g][i // g]`` for a group of ``g`` slots."""

    def __init__(self, cfg: ModelConfig, device: torch.device | str):
        super().__init__()
        _check_family(cfg)
        g = group_size(cfg)
        if cfg.num_layers % g:
            raise ValueError(f"{cfg.num_layers} layers do not divide into groups of {g}")
        kw = dict(dtype=L.torch_dtype(cfg.dtype), device=device)
        self.embed = L.Embed(cfg, **kw)
        self.blocks = nn.ModuleList(
            nn.ModuleList(Block(cfg, **kw) for _ in range(cfg.num_layers // g)) for _ in range(g)
        )
        self.ln_final = L.RMSNorm(cfg.d_model, **kw)


def init_params(generator: torch.Generator, cfg: ModelConfig,
                device: torch.device | str = "cuda") -> Transformer:
    """Random parameters at the reference's scales: truncated normals on
    [-2, 2] (``d_in ** -0.5`` for weights, 0.02 for the embedding,
    ``d_model ** -0.5`` for an untied unembedding), zero biases and norm
    scales.  Drawn from ``generator`` on its own device, then moved to
    ``device``: the same generator state gives the same weights anywhere."""
    return L.init_modules(Transformer(cfg, torch.device("meta")).to_empty(device=device), generator)


def _layers(params: Transformer, cfg: ModelConfig) -> Iterator[tuple[int, int, int | None, Block]]:
    """(group, slot, window, block) in layer order."""
    windows = layer_windows(cfg)
    for grp in range(cfg.num_layers // len(windows)):
        for s, w in enumerate(windows):
            yield grp, s, w, params.blocks[s][grp]


def _mlp_residual(p: Block, x: torch.Tensor, cfg: ModelConfig) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The FFN half of a block: (x + ffn(norm(x)), the MoE load-balance loss
    or None for a dense block)."""
    y_in = L.rmsnorm(p.ln_mlp, x, cfg.norm_eps)
    aux = None
    if p.moe is not None:
        h, aux = moe_ffn(p.moe, y_in, cfg)
    else:
        h = L.mlp(p.mlp, y_in, cfg)
    if p.ln_mlp_post is not None:
        h = L.rmsnorm(p.ln_mlp_post, h, cfg.norm_eps)
    return x + h, aux


def _attn_residual(p: Block, x: torch.Tensor, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if p.ln_attn_post is not None:
        h = L.rmsnorm(p.ln_attn_post, h, cfg.norm_eps)
    return x + h


def _block_forward(p: Block, x: torch.Tensor, cfg: ModelConfig, window: int | None):
    """Full-sequence block; returns (x, (k, v), aux loss or None)."""
    x = hints.constrain(x)  # the residual stream's layout (sequence parallel)
    h, kv = L.attention_forward(p.attn, L.rmsnorm(p.ln_attn, x, cfg.norm_eps), cfg, window=window)
    x = _attn_residual(p, x, h, cfg)
    x, aux = _mlp_residual(p, x, cfg)
    return x, kv, aux


def forward(params: Transformer, cfg: ModelConfig, batch: dict, *,
            remat: bool = False) -> tuple[torch.Tensor, dict]:
    """batch {"tokens": [B, S]} (or {"embeds": [B, S, d]}, the vlm's prefix
    path) -> (logits [B, S, V] f32, {"aux_loss": the sum of the layers' MoE
    load-balance losses, 0 for a dense model}).  With ``remat`` each layer
    group (gemma2's local and global pair, else one layer) is recomputed in
    the backward, as the reference's ``jax.checkpoint`` of its group."""
    x = batch["embeds"] if "embeds" in batch else L.embed(params.embed, batch["tokens"], cfg)
    windows = layer_windows(cfg)

    def group_fn(x: torch.Tensor, grp: int) -> tuple[torch.Tensor, torch.Tensor]:
        aux_total = torch.zeros((), device=x.device)
        for s, w in enumerate(windows):
            x, _, aux = _block_forward(params.blocks[s][grp], x, cfg, w)
            if aux is not None:
                aux_total = aux_total + aux
        return x, aux_total

    aux_loss = torch.zeros((), device=x.device)
    for grp in range(cfg.num_layers // len(windows)):
        x, aux = L.remat(group_fn, x, grp, enabled=remat)
        aux_loss = aux_loss + aux
    x = L.rmsnorm(params.ln_final, x, cfg.norm_eps)
    logits = L.unembed(params.embed, x, cfg)
    return logits, {"aux_loss": aux_loss}


# -----------------------------------------------------------------------------
# Serving: cache init / prefill / decode
# -----------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: torch.device | str = "cuda") -> dict:
    """Zeroed KV caches per window slot, in the model's dtype; windowed slots
    are ring buffers of ``min(max_len, window)`` positions."""
    _check_family(cfg)
    dtype = L.torch_dtype(cfg.dtype)
    n_groups = cfg.num_layers // group_size(cfg)
    hkv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    caches = []
    for w in layer_windows(cfg):
        s = min(max_len, w) if w is not None else max_len
        shape = (n_groups, batch, hkv, s, hd)
        caches.append({"k": torch.zeros(shape, dtype=dtype, device=device),
                       "v": torch.zeros(shape, dtype=dtype, device=device)})
    return {"kv": tuple(caches), "pos": 0}


def prefill(params: Transformer, cfg: ModelConfig, tokens: torch.Tensor, cache: dict,
            embeds: torch.Tensor | None = None) -> tuple[torch.Tensor, dict]:
    """Run the whole prompt ``tokens [B, S]``, or ``embeds [B, S, d]`` in
    their place, and write its keys and values into ``cache`` in place (a
    window slot keeps the last ``window`` positions, laid out as its ring
    buffer).  Returns (last-position logits [B, V] f32, the cache at
    position S)."""
    x = L.embed(params.embed, tokens, cfg) if embeds is None else embeds
    S = x.shape[1]
    for grp, s, w, p in _layers(params, cfg):
        x, (kc, vc), _ = _block_forward(p, x, cfg, w)
        L.write_prompt_kv(cache["kv"][s]["k"][grp], kc)
        L.write_prompt_kv(cache["kv"][s]["v"][grp], vc)
    x = L.rmsnorm(params.ln_final, x, cfg.norm_eps)
    logits = L.unembed(params.embed, x[:, -1:], cfg)[:, 0]
    return logits, {"kv": cache["kv"], "pos": S}


def decode_step(params: Transformer, cfg: ModelConfig, token: torch.Tensor,
                cache: dict) -> tuple[torch.Tensor, dict]:
    """One decode step: token [B] -> (logits [B, V] f32, the cache one
    position on).  Every sequence sits at ``cache["pos"]``; the caches are
    updated in place."""
    B = token.shape[0]
    x = L.embed(params.embed, token[:, None], cfg)
    pos = cache["pos"]
    posb = torch.as_tensor(pos, device=x.device).broadcast_to((B,))  # once, not per layer
    for grp, s, w, p in _layers(params, cfg):
        kv = cache["kv"][s]
        h, _, _ = L.attention_decode(p.attn, L.rmsnorm(p.ln_attn, x, cfg.norm_eps), cfg,
                                     kv["k"][grp], kv["v"][grp], posb, window=w)
        x = _attn_residual(p, x, h, cfg)
        x, _ = _mlp_residual(p, x, cfg)
    x = L.rmsnorm(params.ln_final, x, cfg.norm_eps)
    logits = L.unembed(params.embed, x, cfg)[:, 0]
    return logits, {"kv": cache["kv"], "pos": pos + 1}
