"""grok-1-314b [moe] — hf:xai-org/grok-1 (unverified).

64L d_model=6144 48H (GQA kv=8) d_ff=32768 vocab=131072, MoE 8e top-2.
Optimizer moments in bf16 (HBM budget at 314B params — DESIGN.md §8).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    family="moe",
    num_layers=64,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=32768,
    vocab_size=131_072,
    layer_pattern=("attn_moe",),
    num_experts=8,
    num_experts_per_tok=2,
    moe_d_ff=32768,
    adam_dtype="bfloat16",
)
