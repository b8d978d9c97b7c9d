"""moonshot-v1-16b-a3b [moe] — hf:moonshotai/Moonlight-16B-A3B (hf).

48L d_model=2048 16H (GQA kv=16) d_ff=1408 vocab=163840, MoE 64e top-6
(DeepSeek-style fine-grained experts: per-expert d_ff=1408).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=163_840,
    layer_pattern=("attn_moe",),
    num_experts=64,
    num_experts_per_tok=6,
    moe_d_ff=1408,
)
