"""gemma2-2b — local(4096)/global alternating attention, logit softcaps,
pre+post RMSNorm, scaled tied embeddings [arXiv:2408.00118; hf]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b", family="dense",
    num_layers=26, d_model=2304, num_heads=8, num_kv_heads=4, head_dim=256,
    d_ff=9216, vocab=256000,
    local_global=True, window=4096, attn_softcap=50.0, final_softcap=30.0,
    post_norms=True, scale_embedding=True, tie_embeddings=True,
)

REDUCED = ModelConfig(
    name="gemma2-2b-reduced", family="dense",
    num_layers=4, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab=256,
    local_global=True, window=8, attn_softcap=50.0, final_softcap=30.0,
    post_norms=True, scale_embedding=True, tie_embeddings=True,
)
