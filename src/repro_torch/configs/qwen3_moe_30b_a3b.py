"""qwen3-moe-30b-a3b — 128 experts top-8, GQA kv=4
[hf:Qwen/Qwen3-30B-A3B; hf]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    num_layers=48, d_model=2048, num_heads=32, num_kv_heads=4, head_dim=128,
    vocab=151936, num_experts=128, top_k=8, d_ff_expert=768,
    rope_theta=1e6,
)

REDUCED = ModelConfig(
    name="qwen3-moe-reduced", family="moe",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    vocab=256, num_experts=8, top_k=2, d_ff_expert=32,
)
