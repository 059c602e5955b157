"""Unified model configuration, copied from the reference's
``repro/models/config.py`` (the port imports nothing of ``repro``).

One frozen dataclass describes every architecture family of the reference:
dense decoder LMs (llama/qwen style, gemma2 local-global + softcaps), MoE,
SSM (mamba2 SSD), hybrid (zamba2), encoder-decoder (whisper) and VLM
backbones.  The port has every one of these families;
``param_count`` covers all of them, as in the reference.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    vocab: int
    # attention
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0  # 0 → d_model // num_heads
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    window: int | None = None  # sliding-window size (SWA) for all attn layers
    local_global: bool = False  # gemma2: alternate local(window)/global layers
    attn_softcap: float | None = None  # gemma2 logit softcapping
    final_softcap: float | None = None  # gemma2 final-logit softcapping
    post_norms: bool = False  # gemma2 post-attention/post-ffn RMSNorms
    scale_embedding: bool = False  # gemma2 embeds scaled by sqrt(d_model)
    # mlp
    d_ff: int = 0
    mlp_act: str = "silu"  # silu (swiglu) | gelu (plain 2-matrix mlp)
    # moe
    num_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    aux_loss_coef: float = 0.01
    # ssm (mamba2 SSD)
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_groups: int = 1
    ssm_conv: int = 4
    ssm_chunk: int = 128
    # hybrid (zamba2): one shared attention(+mlp) block applied every period
    hybrid_period: int = 6
    # encoder-decoder (whisper backbone)
    enc_layers: int = 0
    enc_frames: int = 1500  # post-conv-frontend frames (stub input)
    dec_positions: int = 32768  # learned decoder position table size
    # vlm (internvl2 backbone)
    num_patches: int = 0  # stubbed ViT patch embeddings prepended to text
    # numerics / training
    dtype: str = "bfloat16"
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    z_loss: float = 1e-4

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)

    @property
    def ssm_heads(self) -> int:
        return (self.ssm_expand * self.d_model) // self.ssm_headdim

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    def param_count(self) -> int:
        """Analytic parameter count N (for MODEL_FLOPS = 6·N·D in §Roofline)."""
        d, v = self.d_model, self.vocab
        hd = self.resolved_head_dim
        emb = v * d * (1 if self.tie_embeddings else 2)

        def attn_params() -> int:
            q = d * self.num_heads * hd
            kv = 2 * d * self.num_kv_heads * hd
            o = self.num_heads * hd * d
            bias = (self.num_heads + 2 * self.num_kv_heads) * hd if self.qkv_bias else 0
            return q + kv + o + bias

        def dense_mlp(ff: int) -> int:
            if self.mlp_act == "gelu":
                return 2 * d * ff + ff + d  # up/down with biases
            return 3 * d * ff  # swiglu: gate, up, down

        def mamba_block() -> int:
            di, n, g, hds = self.d_inner, self.ssm_state, self.ssm_groups, self.ssm_heads
            in_proj = d * (2 * di + 2 * g * n + hds)  # z, x, B, C, dt
            conv = (di + 2 * g * n) * (self.ssm_conv + 1)  # weights + bias
            out = di * d
            extra = hds * 3 + di  # A_log, dt_bias, D skip, internal norm
            return in_proj + conv + out + extra

        total = emb
        if self.family in ("dense", "vlm"):
            per_layer = attn_params() + dense_mlp(self.d_ff) + 2 * d * (2 if self.post_norms else 1)
            total += self.num_layers * per_layer + d
        elif self.family == "moe":
            moe = self.num_experts * 3 * d * self.d_ff_expert + d * self.num_experts
            per_layer = attn_params() + moe + 2 * d
            total += self.num_layers * per_layer + d
        elif self.family == "ssm":
            total += self.num_layers * (mamba_block() + d) + d
        elif self.family == "hybrid":
            shared = attn_params() + dense_mlp(self.d_ff) + 2 * d
            total += self.num_layers * (mamba_block() + d) + shared + d
        elif self.family == "encdec":
            enc = self.enc_layers * (attn_params() + dense_mlp(self.d_ff) + 2 * d)
            dec = self.num_layers * (2 * attn_params() + dense_mlp(self.d_ff) + 3 * d)
            total += enc + dec + 2 * d
            total += (self.enc_frames + self.dec_positions) * d  # learned positions
        else:
            raise ValueError(self.family)
        if self.family == "vlm":
            total += self.num_patches * d  # stub patch-position table
        return total

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: top_k of num_experts)."""
        if self.family != "moe":
            return self.param_count()
        d = self.d_model
        inactive = (self.num_experts - self.top_k) * 3 * d * self.d_ff_expert
        return self.param_count() - self.num_layers * inactive
