"""zamba2-7b — Mamba2 backbone + shared attention block every 6 layers
[arXiv:2411.15242; unverified].  Simplified as in the reference: no
per-invocation LoRA, plain residual shared block."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b", family="hybrid",
    num_layers=81, d_model=3584, num_heads=32, num_kv_heads=32, head_dim=112,
    d_ff=14336, vocab=32000,
    ssm_state=64, ssm_headdim=64, ssm_expand=2, ssm_groups=1, ssm_conv=4,
    ssm_chunk=128, hybrid_period=6,
)

REDUCED = ModelConfig(
    name="zamba2-reduced", family="hybrid",
    num_layers=4, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
    d_ff=128, vocab=256,
    ssm_state=16, ssm_headdim=16, ssm_expand=2, ssm_groups=1, ssm_conv=4,
    ssm_chunk=16, hybrid_period=2,
)
