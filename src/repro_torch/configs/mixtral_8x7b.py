"""mixtral-8x7b — 8 experts top-2, sliding-window attention (4096)
[arXiv:2401.04088; hf]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b", family="moe",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8, head_dim=128,
    vocab=32000, num_experts=8, top_k=2, d_ff_expert=14336,
    window=4096, rope_theta=1e6,
)

REDUCED = ModelConfig(
    name="mixtral-reduced", family="moe",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    vocab=256, num_experts=4, top_k=2, d_ff_expert=32, window=8,
)
