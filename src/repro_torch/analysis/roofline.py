"""Roofline terms of one call on the H100 (port of
``repro.analysis.roofline``'s ``HW`` and ``roofline_terms``).

The three terms, in seconds, for one device:

  compute    = flops / peak_flops
  memory     = bytes / hbm_bw
  collective = wire bytes / link_bw

and the bound is the largest. :class:`HW` defaults to one NVIDIA H100
SXM at its 700 W limit, from NVIDIA's H100 data sheet and the Hopper
architecture white paper: 989 TFLOP/s dense bf16 on the tensor cores,
3.35 TB/s of HBM3, and 25 GB/s for ``link_bw``, which is one NVLink 4
link in one direction (the card's 900 GB/s is the sum over its 18 links
of both directions). The sketch kernels do integer work outside the
tensor cores, so their compute term is far below their memory term; the
models (``analysis.flops``) count bytes first.

``model_flops`` is the 6*N*D rule (2*N*D forward-only) with N the
active parameters (``active_params``: MoE layers count their top-k
experts only), the reference's formulas.
"""
from __future__ import annotations

from dataclasses import dataclass

__all__ = ["HW", "roofline_terms", "model_flops", "active_params"]


@dataclass(frozen=True)
class HW:
    """Peak rates of one device: FLOP/s, device-memory bytes/s, and bytes/s
    of one inter-device link in one direction (defaults: H100 SXM)."""

    peak_flops: float = 989e12   # dense bf16, tensor cores
    hbm_bw: float = 3.35e12      # HBM3 bytes/s
    link_bw: float = 25e9        # one NVLink 4 link, one direction


def roofline_terms(flops_per_dev: float, bytes_per_dev: float,
                   wire_bytes_per_dev: float, hw: HW = HW()) -> dict:
    """The compute, memory and collective times of one call, the dominant
    term, the bound (their maximum) and the compute term's share of it."""
    t_comp = flops_per_dev / hw.peak_flops
    t_mem = bytes_per_dev / hw.hbm_bw
    t_coll = wire_bytes_per_dev / hw.link_bw
    dominant = max((t_comp, "compute"), (t_mem, "memory"),
                   (t_coll, "collective"))[1]
    bound = max(t_comp, t_mem, t_coll)
    return {
        "t_compute_s": t_comp,
        "t_memory_s": t_mem,
        "t_collective_s": t_coll,
        "dominant": dominant,
        "bound_s": bound,
        # the compute term's share of the bound: how close the call is to
        # being compute-limited
        "compute_fraction": t_comp / bound if bound > 0 else 0.0,
    }


def active_params(cfg) -> float:
    """Active parameter count (MoE: top-k experts only) for 6*N*D."""
    d, v = cfg.d_model, cfg.vocab_padded
    total = v * d * (1 if cfg.tie_embeddings else 2)
    for kind in cfg.layer_pattern:
        n_layer = cfg.num_periods
        if "mamba" in kind:
            di, h, n = cfg.ssm_d_inner, cfg.ssm_heads, cfg.ssm_state
            total += n_layer * (d * (2 * di + 2 * n + h) + di * d)
        else:
            hd = cfg.head_dim
            total += n_layer * (d * cfg.num_heads * hd
                                + 2 * d * cfg.num_kv_heads * hd
                                + cfg.num_heads * hd * d)
            if cfg.is_enc_dec:  # cross-attention
                total += n_layer * 2 * (d * cfg.num_heads * hd
                                        + d * cfg.num_kv_heads * hd)
        if kind.endswith("_moe") or kind == "attn_moe":
            total += n_layer * 3 * d * cfg.moe_d_ff * cfg.num_experts_per_tok
        elif "mamba" != kind and not kind.endswith("_moe"):
            if cfg.d_ff:
                total += n_layer * 3 * d * cfg.d_ff
    if cfg.is_enc_dec:
        total += cfg.encoder_layers * (4 * d * cfg.num_heads * cfg.head_dim
                                       + 3 * d * cfg.d_ff)
    return float(total)


def model_flops(cfg, tokens: float, kind: str) -> float:
    """6*N_active*D (train) / 2*N_active*D (forward-only) useful FLOPs."""
    n = active_params(cfg)
    mult = 6.0 if kind == "train" else 2.0
    return mult * n * tokens
