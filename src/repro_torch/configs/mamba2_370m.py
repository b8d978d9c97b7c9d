"""mamba2-370m [ssm] — arXiv:2405.21060 (unverified).

48L d_model=1024 (attn-free) d_ff=0 vocab=50280, ssm_state=128 — SSD.
d_inner = 2*d_model = 2048, head_dim 64 -> 32 SSD heads.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    num_layers=48,
    d_model=1024,
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=50_280,
    layer_pattern=("mamba",),
    ssm_state=128,
    ssm_head_dim=64,
    tie_embeddings=True,
)
