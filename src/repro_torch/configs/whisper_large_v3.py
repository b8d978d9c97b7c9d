"""whisper-large-v3 [audio] — arXiv:2212.04356 (unverified).

32L d_model=1280 20H (kv=20, MHA) d_ff=5120 vocab=51866 — enc-dec.
Conv frontend is a STUB per the assignment: input_specs() provides 1500
precomputed frame embeddings; the decoder is the assigned 32-layer
backbone (self-attn + cross-attn + FFN), absolute sinusoidal positions.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="audio",
    num_layers=32,
    d_model=1280,
    num_heads=20,
    num_kv_heads=20,
    head_dim=64,
    d_ff=5120,
    vocab_size=51_866,
    layer_pattern=("xattn",),
    encoder_layers=32,
    encoder_seq=1500,
    rope_theta=0.0,  # unused: absolute sinusoidal positions
)
