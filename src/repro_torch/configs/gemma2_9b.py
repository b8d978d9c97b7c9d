"""gemma2-9b [dense] — arXiv:2408.00118 (hf).

42L d_model=3584 16H (GQA kv=8) d_ff=14336 vocab=256000 — local+global
alternating (window 4096), attention softcap 50, final-logit softcap 30,
head_dim 256.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b",
    family="dense",
    num_layers=42,
    d_model=3584,
    num_heads=16,
    num_kv_heads=8,
    head_dim=256,
    d_ff=14336,
    vocab_size=256_000,
    layer_pattern=("local", "attn"),   # alternating local/global
    local_window=4096,
    attn_softcap=50.0,
    logit_softcap=30.0,
    tie_embeddings=True,
    kv_cache_dtype="int8",   # §Perf iteration A-3: halves decode cache reads
)
