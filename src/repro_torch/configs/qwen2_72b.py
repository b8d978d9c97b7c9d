"""qwen2-72b [dense] — arXiv:2407.10671 (hf).

80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064 — GQA, QKV bias.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-72b",
    family="dense",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=29568,
    vocab_size=152_064,
    layer_pattern=("attn",),
    qkv_bias=True,
)
