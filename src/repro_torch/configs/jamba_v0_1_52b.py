"""jamba-v0.1-52b [hybrid] — arXiv:2403.19887 (hf).

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536, MoE 16e top-2.
Mamba:attention 1:7 interleave, MoE on every other layer — period-8
pattern with attention at position 4 (the Jamba paper's block layout).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=65_536,
    layer_pattern=(
        "mamba_mlp", "mamba_moe", "mamba_mlp", "mamba_moe",
        "attn", "mamba_moe", "mamba_mlp", "mamba_moe",
    ),
    num_experts=16,
    num_experts_per_tok=2,
    moe_d_ff=14336,
    ssm_state=16,
    ssm_head_dim=64,
)
