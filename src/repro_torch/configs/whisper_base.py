"""whisper-base — enc-dec audio backbone; conv frontend STUBBED
(input_specs feeds post-conv frame embeddings) [arXiv:2212.04356;
unverified]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base", family="encdec",
    num_layers=6, enc_layers=6, d_model=512, num_heads=8, num_kv_heads=8,
    head_dim=64, d_ff=2048, vocab=51865, mlp_act="gelu",
    enc_frames=1500, tie_embeddings=True,
)

REDUCED = ModelConfig(
    name="whisper-base-reduced", family="encdec",
    num_layers=2, enc_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
    head_dim=16, d_ff=128, vocab=256, mlp_act="gelu",
    enc_frames=16, dec_positions=256, tie_embeddings=True,
)
