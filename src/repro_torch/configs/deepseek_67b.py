"""deepseek-67b — dense llama-arch, GQA kv=8 [arXiv:2401.02954; hf]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-67b", family="dense",
    num_layers=95, d_model=8192, num_heads=64, num_kv_heads=8, head_dim=128,
    d_ff=22016, vocab=102400,
)

REDUCED = ModelConfig(
    name="deepseek-67b-reduced", family="dense",
    num_layers=3, d_model=64, num_heads=8, num_kv_heads=2, head_dim=8,
    d_ff=160, vocab=256,
)
