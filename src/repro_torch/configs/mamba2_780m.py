"""mamba2-780m — attention-free SSD (state-space duality)
[arXiv:2405.21060; unverified]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m", family="ssm",
    num_layers=48, d_model=1536, vocab=50280,
    ssm_state=128, ssm_headdim=64, ssm_expand=2, ssm_groups=1, ssm_conv=4,
    ssm_chunk=128, tie_embeddings=True,
)

REDUCED = ModelConfig(
    name="mamba2-780m-reduced", family="ssm",
    num_layers=2, d_model=64, vocab=256,
    ssm_state=16, ssm_headdim=16, ssm_expand=2, ssm_groups=1, ssm_conv=4,
    ssm_chunk=16, tie_embeddings=True,
)
