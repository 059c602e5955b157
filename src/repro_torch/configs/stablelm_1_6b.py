"""stablelm-1.6b — dense, MHA (kv=32) [hf:stabilityai/stablelm-2-1_6b;
unverified].  Simplified vs. release: full RoPE (not partial 25%) and
RMSNorm (not biased LayerNorm) — noted in DESIGN.md §7."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-1.6b", family="dense",
    num_layers=24, d_model=2048, num_heads=32, num_kv_heads=32, head_dim=64,
    d_ff=5632, vocab=100352,
)

REDUCED = ModelConfig(
    name="stablelm-1.6b-reduced", family="dense",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
    d_ff=128, vocab=256,
)
