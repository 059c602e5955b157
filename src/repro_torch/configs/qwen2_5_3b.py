"""qwen2.5-3b — dense, GQA kv=2, QKV bias [hf:Qwen/Qwen2.5; hf]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-3b", family="dense",
    num_layers=36, d_model=2048, num_heads=16, num_kv_heads=2, head_dim=128,
    d_ff=11008, vocab=151936, qkv_bias=True, rope_theta=1e6,
)

REDUCED = ModelConfig(
    name="qwen2.5-3b-reduced", family="dense",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab=256, qkv_bias=True,
)
