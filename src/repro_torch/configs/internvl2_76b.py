"""internvl2-76b — InternViT (STUBBED patch embeddings) + llama3-70b-class
LM backbone [arXiv:2404.16821; unverified]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b", family="vlm",
    num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8, head_dim=128,
    d_ff=28672, vocab=128256, num_patches=256, rope_theta=5e5,
)

REDUCED = ModelConfig(
    name="internvl2-reduced", family="vlm",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab=256, num_patches=8,
)
