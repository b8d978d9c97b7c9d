"""--arch registry: id -> ModelConfig."""
from __future__ import annotations

from repro_torch.models.config import ModelConfig

from repro_torch.configs.phi4_mini_3_8b import CONFIG as _phi4
from repro_torch.configs.gemma2_9b import CONFIG as _gemma2
from repro_torch.configs.qwen2_72b import CONFIG as _qwen72
from repro_torch.configs.qwen2_1_5b import CONFIG as _qwen15
from repro_torch.configs.grok1_314b import CONFIG as _grok
from repro_torch.configs.moonshot_v1_16b_a3b import CONFIG as _moonshot
from repro_torch.configs.jamba_v0_1_52b import CONFIG as _jamba
from repro_torch.configs.llava_next_34b import CONFIG as _llava
from repro_torch.configs.mamba2_370m import CONFIG as _mamba2
from repro_torch.configs.whisper_large_v3 import CONFIG as _whisper

ARCHS: dict[str, ModelConfig] = {
    "phi4-mini-3.8b": _phi4,
    "gemma2-9b": _gemma2,
    "qwen2-72b": _qwen72,
    "qwen2-1.5b": _qwen15,
    "grok-1-314b": _grok,
    "moonshot-v1-16b-a3b": _moonshot,
    "jamba-v0.1-52b": _jamba,
    "llava-next-34b": _llava,
    "mamba2-370m": _mamba2,
    "whisper-large-v3": _whisper,
}

# long_500k applicability (DESIGN.md §7): sub-quadratic context only.
LONG_CONTEXT_ARCHS = {"jamba-v0.1-52b", "mamba2-370m"}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]


def cell_is_applicable(arch: str, shape_name: str) -> tuple[bool, str]:
    """(runs?, reason-if-skipped) for an (arch x shape) cell."""
    if shape_name == "long_500k" and arch not in LONG_CONTEXT_ARCHS:
        return False, ("pure full-attention arch: 512k context is not the "
                       "sub-quadratic regime this cell targets (DESIGN.md §7)")
    return True, ""
