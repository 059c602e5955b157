"""Model-layer primitives: RMSNorm, RoPE, linear, embedding, GQA attention
(prefill and decode) and the SwiGLU/GELU MLPs.

Ported from the reference's ``repro/models/layers.py``.  Parameters live in
small ``nn.Module`` containers whose attribute names are the reference's
pytree keys (``Linear.w`` is ``[d_in, d_out]`` as in JAX, so ``x @ w``);
the arithmetic lives in plain functions that take those containers, as the
reference's take dicts.  The numerics are the reference's: RMSNorm in f32
with the ``(1 + scale)`` convention, RoPE in f32, the embedding scale
rounded to the activation dtype before the product, the unembedding as a
product in the weights' dtype, then an upcast, then the final softcap, and
``jax.nn.gelu``'s default, the tanh approximation.

Attention calls the kernel wrappers directly: a wrapper is the only code
that chooses an implementation, by the device of its tensors.

The functions pass their weights and their module's input and output
through ``distributed/program.py`` (``D.weight``, ``D.enter``, ``D.exit``
and the attention's kv-head points): with a sharded program installed they
run one device's share of the step; with none each returns its input.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed import program as D
from repro_torch.kernels.decode_attention import decode_attention_cuda, decode_attention_state_cuda
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.models.config import ModelConfig


def torch_dtype(name: str) -> torch.dtype:
    """``"bfloat16"`` -> ``torch.bfloat16``, and so on."""
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dtype


def truncated_normal(shape: tuple[int, ...], scale: float, dtype: torch.dtype,
                     generator: torch.Generator, device: torch.device | str) -> torch.Tensor:
    """Standard normal truncated to [-2, 2], drawn in f32 on the generator's
    device, times ``scale`` in place (one f32 draw held, not two: a card
    drawing a model that fits no card holds its largest tensor whole), then
    cast and moved: the reference's ``truncated_normal_init`` in
    distribution (not in its numbers)."""
    x = torch.empty(shape, dtype=torch.float32, device=generator.device)
    nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return x.mul_(scale).to(device=device, dtype=dtype)


def param(t: torch.Tensor) -> nn.Parameter:
    """A parameter that takes no gradient until :func:`trainable` turns
    gradients on, so that serving builds no autograd graph."""
    return nn.Parameter(t, requires_grad=False)


def trainable(module: nn.Module) -> nn.Module:
    """Turn gradients on for every parameter of ``module`` (in place, as
    training does before its first step); returns ``module``."""
    for p in module.parameters():
        p.requires_grad_(True)
    return module


def remat(fn, *args, enabled: bool):
    """``fn(*args)``; with ``enabled`` and grad mode on, under
    ``torch.utils.checkpoint`` (non-reentrant): its activations are dropped
    and recomputed in the backward, as the reference's ``jax.checkpoint``
    does for a layer group or a block."""
    if enabled and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def init_modules(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw every parameter of ``module`` from ``generator``, each submodule
    by its own ``init_``, in the order of ``module.modules()``."""
    for m in module.modules():
        if hasattr(m, "init_"):
            m.init_(generator)
    return module


class Linear(nn.Module):
    def __init__(self, d_in: int, d_out: int, *, bias: bool, dtype: torch.dtype,
                 device: torch.device | str):
        super().__init__()
        self.w = param(torch.empty(d_in, d_out, dtype=dtype, device=device))
        self.b = param(torch.empty(d_out, dtype=dtype, device=device)) if bias else None

    def init_(self, generator: torch.Generator) -> None:
        self.w.copy_(truncated_normal(tuple(self.w.shape), self.w.shape[0] ** -0.5,
                                      self.w.dtype, generator, self.w.device))
        if self.b is not None:
            self.b.zero_()


class RMSNorm(nn.Module):
    def __init__(self, d: int, *, dtype: torch.dtype, device: torch.device | str):
        super().__init__()
        self.scale = param(torch.empty(d, dtype=dtype, device=device))  # (1 + scale)

    def init_(self, generator: torch.Generator) -> None:
        self.scale.zero_()


class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, *, dtype: torch.dtype, device: torch.device | str):
        super().__init__()
        d, h, hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
        kw = dict(dtype=dtype, device=device)
        self.q = Linear(d, h * hd, bias=cfg.qkv_bias, **kw)
        self.k = Linear(d, hkv * hd, bias=cfg.qkv_bias, **kw)
        self.v = Linear(d, hkv * hd, bias=cfg.qkv_bias, **kw)
        self.o = Linear(h * hd, d, bias=False, **kw)


class MLP(nn.Module):
    """SwiGLU (``gate``, ``up``, ``down``) or, for ``mlp_act == "gelu"``, a
    plain two-matrix MLP with biases (``up``, ``down``)."""

    def __init__(self, cfg: ModelConfig, *, dtype: torch.dtype, device: torch.device | str):
        super().__init__()
        d, ff = cfg.d_model, cfg.d_ff
        kw = dict(dtype=dtype, device=device)
        gelu = cfg.mlp_act == "gelu"
        self.gate = None if gelu else Linear(d, ff, bias=False, **kw)
        self.up = Linear(d, ff, bias=gelu, **kw)
        self.down = Linear(ff, d, bias=gelu, **kw)


class Embed(nn.Module):
    def __init__(self, cfg: ModelConfig, *, dtype: torch.dtype, device: torch.device | str):
        super().__init__()
        self.tok = param(torch.empty(cfg.vocab, cfg.d_model, dtype=dtype, device=device))
        self.unembed = (None if cfg.tie_embeddings else
                        param(torch.empty(cfg.d_model, cfg.vocab, dtype=dtype, device=device)))

    def init_(self, generator: torch.Generator) -> None:
        self.tok.copy_(truncated_normal(tuple(self.tok.shape), 0.02, self.tok.dtype, generator,
                                        self.tok.device))
        if self.unembed is not None:
            d = self.unembed.shape[0]
            self.unembed.copy_(truncated_normal(tuple(self.unembed.shape), d**-0.5,
                                                self.unembed.dtype, generator, self.unembed.device))


def linear(p: Linear, x: torch.Tensor) -> torch.Tensor:
    y = x @ D.weight(p.w)
    if p.b is not None:
        y = y + D.weight(p.b)
    return y


def rmsnorm(p: RMSNorm, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + p.scale.float())).to(x.dtype)


# -----------------------------------------------------------------------------
# RoPE (GPT-NeoX rotate-half convention, as llama/qwen/gemma)
# -----------------------------------------------------------------------------


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """positions [...]; returns (sin, cos) with shape [..., head_dim//2], f32."""
    half = head_dim // 2
    exponent = torch.arange(half, dtype=torch.float32, device=positions.device) / half
    freqs = 1.0 / (theta**exponent)
    ang = positions.float()[..., None] * freqs
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
    """x [B, S, H, D] with sin/cos [S, D/2] or [B, S, D/2] (broadcast over
    the heads)."""
    half = x.shape[-1] // 2
    s = sin[..., None, :] if x.dim() == 4 else sin
    c = cos[..., None, :] if x.dim() == 4 else cos
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    out1 = xf1 * c - xf2 * s
    out2 = xf2 * c + xf1 * s
    return torch.cat([out1, out2], dim=-1).to(x.dtype)


# -----------------------------------------------------------------------------
# Attention (GQA): prefill and decode
# -----------------------------------------------------------------------------


def _project_qkv(p: Attention, x: torch.Tensor, cfg: ModelConfig):
    B, S, _ = x.shape
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = linear(p.q, x).reshape(B, S, h, hd)
    k = D.kv_heads(linear(p.k, x)).reshape(B, S, hkv, hd)
    v = D.kv_heads(linear(p.v, x)).reshape(B, S, hkv, hd)
    return q, k, v


def attention_forward(
    p: Attention,
    x: torch.Tensor,  # [B, S, d]
    cfg: ModelConfig,
    *,
    window: int | None = None,
    causal: bool = True,
    use_rope: bool = True,
    positions: torch.Tensor | None = None,
    kv_override: tuple[torch.Tensor, torch.Tensor] | None = None,  # cross-attention
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """Full-sequence attention (prefill): causal by default, with RoPE at
    ``positions`` (default ``0 .. S-1``).  ``kv_override`` gives the keys
    and values ``[B, Hkv, Skv, D]`` from elsewhere (cross-attention: no
    RoPE; the reference projects this block's k and v and drops them, the
    port does not project them).  Returns
    (out, (k, v)) with k, v in the cache layout ``[B, Hkv, S, D]``."""
    x = D.enter(x, p)
    B, S, _ = x.shape
    if kv_override is not None:
        q = linear(p.q, x).reshape(B, S, cfg.num_heads, cfg.resolved_head_dim)
        kc, vc = kv_override
    else:
        q, k, v = _project_qkv(p, x, cfg)
        if use_rope:
            pos = torch.arange(S, device=x.device) if positions is None else positions
            sin, cos = rope_tables(pos, cfg.resolved_head_dim, cfg.rope_theta)
            q = apply_rope(q, sin, cos)
            k = apply_rope(k, sin, cos)
        kc = k.transpose(1, 2).contiguous()  # [B, Hkv, S, D]
        vc = v.transpose(1, 2).contiguous()
    qh = q.transpose(1, 2).contiguous()  # [B, H, S, D]
    ka, va = D.kv_select(kc, vc, cfg.num_heads)
    o = flash_attention_cuda(qh, ka, va, causal=causal, window=window, softcap=cfg.attn_softcap)
    o = o.transpose(1, 2).reshape(B, S, cfg.num_heads * cfg.resolved_head_dim)
    return D.exit(linear(p.o, o), p), (kc, vc)


def write_prompt_kv(dst: torch.Tensor, src: torch.Tensor) -> None:
    """Write a prompt's keys or values ``src [B, Hkv, S, D]`` into the cache
    ``dst [B, Hkv, cap, D]`` in place: positions ``0 .. S-1`` when they fit,
    else the last ``cap`` of them laid out as the ring buffer a decode step
    continues (position ``p`` at slot ``p % cap``)."""
    share = D.prompt_slice(dst, src)
    if share is not None:  # a sequence split over devices: this device's share
        dst.copy_(share)
        return
    S, cap = src.shape[2], dst.shape[2]
    if S >= cap:
        dst.copy_(torch.roll(src[:, :, S - cap:], S % cap, dims=2))
    else:
        dst[:, :, :S].copy_(src)


def attention_decode(
    p: Attention,
    x: torch.Tensor,  # [B, 1, d]: one new token
    cfg: ModelConfig,
    k_cache: torch.Tensor,  # [B, Hkv, S, D]
    v_cache: torch.Tensor,
    pos: int | torch.Tensor,  # [] or [B]: the position of the new token
    *,
    window: int | None = None,
    use_rope: bool = True,
    update_cache: bool = True,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode against a KV cache; returns (out, k_cache, v_cache).

    The new token's k and v are written into the caches in place (the
    reference returns updated copies; writing in place saves a copy of the
    cache per layer and step), unless ``update_cache`` is False.  A
    window-sized cache is a ring buffer: the token goes to slot ``pos % S``
    and at most ``S`` keys are visible.  Under a program that splits the
    cache's sequence over devices, ``S`` is the whole cache's: the device
    that holds the slot writes it, each device attends to the keys of its
    share, and the shares' outputs are combined by their softmax states."""
    x = D.enter(x, p)
    B = x.shape[0]
    q, k, v = _project_qkv(p, x, cfg)  # S == 1
    posb = torch.as_tensor(pos, device=x.device).broadcast_to((B,))
    if use_rope:
        sin, cos = rope_tables(posb[:, None], cfg.resolved_head_dim, cfg.rope_theta)
        q = apply_rope(q, sin, cos)  # q, k [B, 1, H, D]; sin, cos [B, 1, D/2]
        k = apply_rope(k, sin, cos)
    S = k_cache.shape[2]
    first, S_all = D.cache_span(k_cache)  # the cache's sequence may be split over devices
    if update_cache and S_all == S:
        slot = posb % S
        bidx = torch.arange(B, device=x.device)
        k_cache[bidx, :, slot] = k[:, 0].to(k_cache.dtype)
        v_cache[bidx, :, slot] = v[:, 0].to(v_cache.dtype)
    elif update_cache:  # the device that holds the global slot writes it
        slot = posb % S_all - first
        bidx = torch.arange(B, device=x.device)
        mine = ((slot >= 0) & (slot < S))[:, None, None]
        at = slot.clamp(0, S - 1)
        k_cache[bidx, :, at] = torch.where(mine, k[:, 0].to(k_cache.dtype), k_cache[bidx, :, at])
        v_cache[bidx, :, at] = torch.where(mine, v[:, 0].to(v_cache.dtype), v_cache[bidx, :, at])
    if S_all == S:
        lengths = torch.clamp(posb + 1, max=S).to(torch.int32)
    else:  # the keys of this device's share
        lengths = torch.clamp(torch.clamp(posb + 1, max=S_all) - first, 0, S).to(torch.int32)
    o = decode_cache(q[:, 0].contiguous(), k_cache, v_cache, lengths, softcap=cfg.attn_softcap)
    o = o.reshape(B, 1, cfg.num_heads * cfg.resolved_head_dim)
    return D.exit(linear(p.o, o), p), k_cache, v_cache


def decode_cache(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor, lengths: torch.Tensor, *,
                 softcap: float | None = None) -> torch.Tensor:
    """This device's query heads ``q [B, H, D]`` (one token) against a
    layer's cache ``[B, Hkv, S, D]``, ``lengths [B]`` of its keys visible:
    the decode kernel, or, where a program splits the cache's sequence over
    devices, the heads gathered where the same axes split them, the state
    variant over this device's share and every share combined by its
    softmax state."""
    q1 = D.decode_query(q, k_cache)
    ka, va = D.kv_select(k_cache, v_cache, q1.shape[1])
    if D.cache_span(k_cache)[1] == k_cache.shape[2]:
        return decode_attention_cuda(q1, ka, va, lengths, softcap=softcap)
    o, lse = decode_attention_state_cuda(q1, ka, va, lengths, softcap=softcap)
    return D.decode_combine(o, lse, k_cache)


# -----------------------------------------------------------------------------
# MLP, embedding, unembedding
# -----------------------------------------------------------------------------


def mlp(p: MLP, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    x = D.enter(x, p)
    if p.gate is not None:
        return D.exit(linear(p.down, F.silu(linear(p.gate, x)) * linear(p.up, x)), p)
    # the output bias after the exit: added once to the devices' summed
    # partial products, not once a device
    y = D.exit(F.gelu(linear(p.up, x), approximate="tanh") @ D.weight(p.down.w), p)
    return y + D.weight(p.down.b)


def embed(p: Embed, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    x = D.lookup(p.tok, tokens)
    if cfg.scale_embedding:
        # the scale is first rounded to the activation dtype, as
        # jnp.asarray(d ** 0.5, x.dtype) does
        x = x * float(torch.tensor(cfg.d_model**0.5, dtype=x.dtype))
    return x


def unembed(p: Embed, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    x = D.enter(x, p)
    w = D.weight(p.tok).T if p.unembed is None else D.weight(p.unembed)
    logits = (x @ w).float()
    if cfg.final_softcap is not None:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    return logits
