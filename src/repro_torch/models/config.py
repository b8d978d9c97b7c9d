"""Model and shape configuration schema of the language-model substrate
(a copy of ``repro.models.config``; plain dataclasses, no torch).

One ``ModelConfig`` per architecture (``repro_torch/configs/<id>.py``).
``layer_pattern`` is the repeating unit of the layer stack: layer
``i * len(layer_pattern) + j`` is period ``i``, pattern position ``j``.
The JAX package stacks each pattern position's parameters over the
periods and scans them; the port keeps its blocks in layer order
(``models.transformer``). Fields that steer only the JAX package's
compiles and shardings (``remat``, ``fsdp_params``, ``scan_layers``) are
kept so that the configs stay equal field for field.

Layer kind tokens:
  "attn"     global attention + dense FFN
  "local"    sliding-window attention + dense FFN (gemma2)
  "attn_moe" global attention + MoE FFN
  "mamba"    pure Mamba2/SSD block, no FFN
  "mamba_moe" / "mamba_mlp"  jamba-style SSD + MoE / + dense FFN
  "xattn"    whisper decoder: self-attention + cross-attention + FFN
"""
from __future__ import annotations

from dataclasses import dataclass, replace


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense | moe | hybrid | vlm | ssm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    layer_pattern: tuple[str, ...] = ("attn",)

    # attention features
    rope_theta: float = 10_000.0
    qkv_bias: bool = False
    logit_softcap: float | None = None     # final-logit softcap (gemma2: 30)
    attn_softcap: float | None = None      # attention-score softcap (gemma2: 50)
    local_window: int | None = None        # sliding window for "local" layers

    # MoE
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25

    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    conv_width: int = 4
    ssd_chunk: int = 128

    # encoder-decoder (whisper)
    encoder_layers: int = 0
    encoder_seq: int = 0                   # stub frame count (whisper: 1500)

    # VLM stub (llava)
    num_image_tokens: int = 0              # anyres tile stub token count

    # numerics / training
    dtype: str = "bfloat16"
    remat: str = "full"                    # none | dots | full
    # int8 KV cache (§Perf iteration A-3): halves decode cache bandwidth;
    # symmetric per-(position, kv-head) scales stored alongside
    kv_cache_dtype: str = "bfloat16"       # bfloat16 | int8
    tie_embeddings: bool = False
    ce_chunk: int = 1024                   # chunked cross-entropy block (L axis)
    adam_dtype: str = "float32"            # grok: bfloat16 to fit HBM
    grad_accum: int = 1

    # sharding hints
    fsdp_params: bool = True               # shard params over data axis too
    # scan-over-layers keeps HLO small, but shard_map (the MoE dispatch)
    # inside lax.scan crashes this XLA version's backward pass ("invalid
    # binary instruction opcode copy") — MoE archs unroll the train stack
    scan_layers: bool = True

    @property
    def vocab_padded(self) -> int:
        """Vocab rounded to a model-axis-friendly multiple (TP sharding)."""
        return _round_up(self.vocab_size, 256)

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    @property
    def pattern_period(self) -> int:
        return len(self.layer_pattern)

    @property
    def num_periods(self) -> int:
        assert self.num_layers % self.pattern_period == 0, (
            self.name, self.num_layers, self.layer_pattern)
        return self.num_layers // self.pattern_period

    @property
    def is_enc_dec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def has_attention(self) -> bool:
        return any("attn" in k or k in ("local", "global") for k in self.layer_pattern)

    def reduced(self, **overrides) -> "ModelConfig":
        """A small same-family config for CPU smoke tests."""
        period = self.pattern_period
        base = dict(
            num_layers=max(period, 2 if period == 1 else period),
            d_model=128,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 2) if self.num_kv_heads else 0,
            head_dim=32,
            d_ff=256,
            vocab_size=512,
            num_experts=min(self.num_experts, 4),
            num_experts_per_tok=min(self.num_experts_per_tok, 2),
            moe_d_ff=64 if self.num_experts else 0,
            ssm_state=min(self.ssm_state, 16),
            ssm_head_dim=16,
            encoder_layers=2 if self.encoder_layers else 0,
            encoder_seq=16 if self.encoder_seq else 0,
            num_image_tokens=8 if self.num_image_tokens else 0,
            local_window=16 if self.local_window else None,
            ce_chunk=64,
            ssd_chunk=16,
            dtype="float32",
            remat="none",
        )
        base.update(overrides)
        return replace(self, **base)


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned (input-shape) cell."""
    name: str
    seq_len: int
    global_batch: int
    kind: str            # train | prefill | decode


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}
