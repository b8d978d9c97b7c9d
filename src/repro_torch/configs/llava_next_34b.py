"""llava-next-34b [vlm] — hf:llava-hf (unverified); Yi-34B-class backbone.

60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000 — anyres tiling.
The anyres tiler/vision tower is a STUB per the assignment: input_specs()
provides precomputed patch embeddings (576 tokens = one 24x24 tile set)
prepended to the text sequence.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b",
    family="vlm",
    num_layers=60,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=20480,
    vocab_size=64_000,
    layer_pattern=("attn",),
    num_image_tokens=576,
)
