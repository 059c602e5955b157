"""Whisper-style encoder-decoder backbone (the encdec family).

Ported from the reference's ``repro/models/encdec.py``.  The conv front end
is stubbed there, and so here: the encoder takes frame embeddings ``[B,
frames, d]`` (post-conv) as its input.  Learned positions (``pos_enc``,
``pos_dec``), non-causal encoder self-attention, causal decoder
self-attention and cross-attention, GELU MLPs with biases, tied decoder
embeddings, no RoPE anywhere.

Every attention goes through the kernel wrappers: the encoder's
self-attention through ``flash_attention_cuda(causal=False)`` at Sq = Skv =
frames, the decoder's self-attention causal, its cross-attention
non-causal with the prompt's rows against the frames' keys (Sq != Skv); a
decode tick runs the self-attention and the cross-attention (every frame
visible) through ``decode_attention_cuda``, or, where a program splits a
cache's sequence over devices, its state variant over the device's share
and the shares' combine (``layers.decode_cache``).

The reference scans stacked layers; here the blocks are ``nn.ModuleList``s
(``enc_blocks[i]``, ``dec_blocks[i]``) and the scan a Python loop.  The
cache is ``{"self_k", "self_v": [layers, B, Hkv, max_len, D], "cross_k",
"cross_v": [layers, B, Hkv, frames, D], "pos": int}``; prefill writes
both in place (the reference returns new cross caches), so that a program
knows every leaf it splits by its storage.

Departure: the reference reads ``pos_dec[pos]`` with JAX's clamping gather,
so a decode step at ``pos >= dec_positions`` silently reuses the last
learned position; the port raises (ROADMAP Queue C).
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.distributed import program as D
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family != "encdec":
        raise ValueError(f"{cfg.name}: family {cfg.family!r} is not an encoder-decoder")


class EncBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, *, dtype: torch.dtype, device: torch.device | str):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.ln_attn = L.RMSNorm(cfg.d_model, **kw)
        self.attn = L.Attention(cfg, **kw)
        self.ln_mlp = L.RMSNorm(cfg.d_model, **kw)
        self.mlp = L.MLP(cfg, **kw)


class DecBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, *, dtype: torch.dtype, device: torch.device | str):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.ln_self = L.RMSNorm(cfg.d_model, **kw)
        self.self_attn = L.Attention(cfg, **kw)
        self.ln_cross = L.RMSNorm(cfg.d_model, **kw)
        self.cross_attn = L.Attention(cfg, **kw)
        self.ln_mlp = L.RMSNorm(cfg.d_model, **kw)
        self.mlp = L.MLP(cfg, **kw)


class EncDec(nn.Module):
    """The parameters: ``embed``, ``pos_enc [frames, d]``, ``pos_dec
    [dec_positions, d]``, ``enc_blocks[i]``, ``dec_blocks[i]``,
    ``ln_enc_final``, ``ln_final``."""

    def __init__(self, cfg: ModelConfig, device: torch.device | str):
        super().__init__()
        _check_family(cfg)
        kw = dict(dtype=L.torch_dtype(cfg.dtype), device=device)
        self.embed = L.Embed(cfg, **kw)
        self.pos_enc = L.param(torch.empty(cfg.enc_frames, cfg.d_model, **kw))
        self.pos_dec = L.param(torch.empty(cfg.dec_positions, cfg.d_model, **kw))
        self.enc_blocks = nn.ModuleList(EncBlock(cfg, **kw) for _ in range(cfg.enc_layers))
        self.dec_blocks = nn.ModuleList(DecBlock(cfg, **kw) for _ in range(cfg.num_layers))
        self.ln_enc_final = L.RMSNorm(cfg.d_model, **kw)
        self.ln_final = L.RMSNorm(cfg.d_model, **kw)

    def init_(self, generator: torch.Generator) -> None:
        for table in (self.pos_enc, self.pos_dec):
            table.copy_(L.truncated_normal(tuple(table.shape), 0.02, table.dtype, generator, table.device))


def init_params(generator: torch.Generator, cfg: ModelConfig,
                device: torch.device | str = "cuda") -> EncDec:
    """Random parameters at the reference's scales (the position tables a
    truncated normal of 0.02), drawn from ``generator`` on its own device,
    then moved to ``device``."""
    return L.init_modules(EncDec(cfg, torch.device("meta")).to_empty(device=device), generator)


def encode(params: EncDec, cfg: ModelConfig, frames: torch.Tensor) -> torch.Tensor:
    """frames [B, F, d] (the stubbed front end's output) -> encoder states
    [B, F, d]: non-causal self-attention, no RoPE."""
    F = frames.shape[1]
    x = frames + D.weight(params.pos_enc)[:F][None]
    for p in params.enc_blocks:
        h, _ = L.attention_forward(p.attn, L.rmsnorm(p.ln_attn, x, cfg.norm_eps), cfg,
                                   causal=False, use_rope=False)
        x = x + h
        x = x + L.mlp(p.mlp, L.rmsnorm(p.ln_mlp, x, cfg.norm_eps), cfg)
    return L.rmsnorm(params.ln_enc_final, x, cfg.norm_eps)


def _cross_kv(p: L.Attention, enc: torch.Tensor, cfg: ModelConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """The cross-attention's keys and values of the encoder states, ``[B,
    Hkv, F, D]`` each.  The states enter the attention's plan as its
    query's input does: a device's heads give them a partial gradient,
    summed over the attention's tensor-parallel axes."""
    enc = D.enter(enc, p)
    B, F, _ = enc.shape
    hkv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    k = D.kv_heads(L.linear(p.k, enc)).reshape(B, F, hkv, hd)
    v = D.kv_heads(L.linear(p.v, enc)).reshape(B, F, hkv, hd)
    return k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()


def _dec_block(p: DecBlock, x: torch.Tensor, enc: torch.Tensor,
               cfg: ModelConfig) -> tuple[torch.Tensor, tuple[torch.Tensor, ...]]:
    """One decoder layer over the whole prompt: (x, (self k, self v, cross
    k, cross v))."""
    h, (kc, vc) = L.attention_forward(p.self_attn, L.rmsnorm(p.ln_self, x, cfg.norm_eps), cfg,
                                      causal=True, use_rope=False)
    x = x + h
    ck, cv = _cross_kv(p.cross_attn, enc, cfg)
    h, _ = L.attention_forward(p.cross_attn, L.rmsnorm(p.ln_cross, x, cfg.norm_eps), cfg,
                               causal=False, use_rope=False, kv_override=(ck, cv))
    x = x + h
    x = x + L.mlp(p.mlp, L.rmsnorm(p.ln_mlp, x, cfg.norm_eps), cfg)
    return x, (kc, vc, ck, cv)


def _decoder(params: EncDec, cfg: ModelConfig, tokens: torch.Tensor, enc: torch.Tensor, *,
             remat: bool = False) -> tuple[torch.Tensor, list[tuple[torch.Tensor, ...]]]:
    """The decoder over the whole prompt ``tokens [B, S]`` against the
    encoder states: (final states [B, S, d], each layer's (self k, self v,
    cross k, cross v)).  With ``remat`` each decoder layer is recomputed in
    the backward (the reference checkpoints the decoder's blocks, not the
    encoder's)."""
    S = tokens.shape[1]
    x = L.embed(params.embed, tokens, cfg) + D.weight(params.pos_dec)[:S][None]
    kvs = []
    for p in params.dec_blocks:
        x, kv = L.remat(_dec_block, p, x, enc, cfg, enabled=remat)
        kvs.append(kv)
    return L.rmsnorm(params.ln_final, x, cfg.norm_eps), kvs


def forward(params: EncDec, cfg: ModelConfig, batch: dict, *,
            remat: bool = False) -> tuple[torch.Tensor, dict]:
    """batch {"frames": [B, F, d], "tokens": [B, S]} -> (logits [B, S, V]
    f32, {"aux_loss": 0}); ``remat`` recomputes each decoder layer."""
    x, _ = _decoder(params, cfg, batch["tokens"], encode(params, cfg, batch["frames"]), remat=remat)
    logits = L.unembed(params.embed, x, cfg)
    return logits, {"aux_loss": torch.zeros((), device=logits.device)}


# -----------------------------------------------------------------------------
# Serving
# -----------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: torch.device | str = "cuda") -> dict:
    """Zeroed decoder self-attention caches of ``max_len`` positions and
    cross-attention caches of ``enc_frames``, per decoder layer, in the
    model's dtype."""
    _check_family(cfg)
    dtype = L.torch_dtype(cfg.dtype)
    hkv, hd, nl = cfg.num_kv_heads, cfg.resolved_head_dim, cfg.num_layers

    def zeros(n: int) -> torch.Tensor:
        return torch.zeros((nl, batch, hkv, n, hd), dtype=dtype, device=device)

    return {"self_k": zeros(max_len), "self_v": zeros(max_len),
            "cross_k": zeros(cfg.enc_frames), "cross_v": zeros(cfg.enc_frames), "pos": 0}


def prefill(params: EncDec, cfg: ModelConfig, tokens: torch.Tensor, cache: dict,
            frames: torch.Tensor | None = None) -> tuple[torch.Tensor, dict]:
    """Encode ``frames``, run the decoder prompt ``tokens [B, S]``, and write
    its self-attention keys and values and the encoder's cross-attention
    keys and values into the cache in place (each cut to this device's
    share where a program splits a cache's sequence).  The frames fill the
    cross cache.  Returns (last-position logits [B, V] f32, the cache at
    position S)."""
    if frames is None:
        raise ValueError("encdec prefill needs frames")
    held = D.cache_span(cache["cross_k"][0])[1]
    if frames.shape[1] != held:
        raise ValueError(f"{frames.shape[1]} frames do not fill the cross-attention cache of {held}")
    enc = encode(params, cfg, frames)
    S = tokens.shape[1]
    x, layers = _decoder(params, cfg, tokens, enc)
    for i, kvs in enumerate(layers):
        for name, t in zip(("self_k", "self_v", "cross_k", "cross_v"), kvs):
            L.write_prompt_kv(cache[name][i], t)
    logits = L.unembed(params.embed, x[:, -1:], cfg)[:, 0]
    return logits, {**cache, "pos": S}


def decode_step(params: EncDec, cfg: ModelConfig, token: torch.Tensor,
                cache: dict) -> tuple[torch.Tensor, dict]:
    """One decode step: token [B] -> (logits [B, V] f32, the cache one
    position on).  The self-attention caches are updated in place; the
    cross-attention reads every one of the cached frames."""
    pos = cache["pos"]
    if not 0 <= pos < cfg.dec_positions:
        raise ValueError(f"decode position {pos} is outside the {cfg.dec_positions} learned "
                         "decoder positions")
    B = token.shape[0]
    x = L.embed(params.embed, token[:, None], cfg) + D.weight(params.pos_dec)[pos][None, None]
    posb = torch.full((B,), pos, device=x.device)
    frames = torch.full((B,), cache["cross_k"].shape[3], dtype=torch.int32, device=x.device)  # its share: all seen
    H, hd = cfg.num_heads, cfg.resolved_head_dim
    for i, p in enumerate(params.dec_blocks):
        h, _, _ = L.attention_decode(p.self_attn, L.rmsnorm(p.ln_self, x, cfg.norm_eps), cfg,
                                     cache["self_k"][i], cache["self_v"][i], posb, use_rope=False)
        x = x + h
        xin = D.enter(L.rmsnorm(p.ln_cross, x, cfg.norm_eps), p.cross_attn)
        q = L.linear(p.cross_attn.q, xin).reshape(B, H, hd)
        o = L.decode_cache(q, cache["cross_k"][i], cache["cross_v"][i], frames)
        x = x + D.exit(L.linear(p.cross_attn.o, o.reshape(B, 1, H * hd)), p.cross_attn)
        x = x + L.mlp(p.mlp, L.rmsnorm(p.ln_mlp, x, cfg.norm_eps), cfg)
    x = L.rmsnorm(params.ln_final, x, cfg.norm_eps)
    logits = L.unembed(params.embed, x, cfg)[:, 0]
    return logits, {**cache, "pos": pos + 1}
