"""Analytic FLOP and byte accounting (port of ``repro.analysis.flops``,
the same formulas): the language models' per-cell costs and the sketch
kernels' per-call models.

**Model cells.** ``cell_flops`` gives a cell's (useful, padded) global
FLOPs from the config and the shape alone: useful are the model's
mathematical FLOPs (causal-aware), padded what the reference's compiled
program executes (heads padded to the 16-way model axis, every MoE
capacity slot). ``cell_bytes`` gives the per-device bytes of one step
(parameter, remat, attention, logit and cache traffic) and, as the
reference does, divides the batch by ``chips // 16``: below 16 chips it
raises ``ZeroDivisionError``. ``cell_costs`` bundles both.

**Sketch ops.** The dominant traffic terms of a sketch kernel follow
from shapes alone. The register panel is the only term the packed layout
changes, a row costing ``r`` bytes in the byte layout and ``r/2``
packed, so the byte/packed ratio of these models is the device-memory
saving the packing buys a query. Fed to
``analysis.roofline.roofline_terms``, they give each op's modeled bound
(``chip_smoke.py``'s autotune phase prints each swept winner beside it).
``ertl_stats`` and ``hip_delta`` have no model, as in the JAX package.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.models.config import ModelConfig, ShapeConfig

__all__ = ["cell_flops", "cell_bytes", "cell_costs", "CellCosts",
           "SKETCH_OPS", "sketch_op_costs"]


def _ceil_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass
class CellCosts:
    flops_useful_global: float
    flops_padded_global: float
    bytes_per_dev: float
    params_total: float
    params_bytes_per_dev: float


def _attn_flops(cfg, b, l, kv_len, *, causal, window, h, hkv):
    hd = cfg.head_dim
    d = cfg.d_model
    proj = 2.0 * b * l * d * (h * hd + 2 * hkv * hd) + 2.0 * b * l * h * hd * d
    if causal and kv_len == l:
        eff = window and min(window, l) or l
        pairs = l * eff - (eff * (eff - 1)) / 2 if window else l * (l + 1) / 2
    else:
        pairs = l * kv_len
    core = 2.0 * b * h * pairs * hd * 2
    return proj + core


def _mlp_flops(b, l, d, f):
    return 2.0 * b * l * d * f * 3


def _moe_flops(cfg, b, l, *, padded):
    d = cfg.d_model
    e, k, f = cfg.num_experts, cfg.num_experts_per_tok, cfg.moe_d_ff
    t = b * l
    router = 2.0 * t * d * e
    if padded:
        cap = (t // e * k * cfg.capacity_factor + 1)
        compute_tokens = e * cap          # every slot computed, incl. empty
    else:
        compute_tokens = t * k
    return router + 2.0 * compute_tokens * d * f * 3


def _mamba_flops(cfg, b, l):
    d = cfg.d_model
    di, h, n, p = cfg.ssm_d_inner, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim
    proj = 2.0 * b * l * d * (2 * di + 2 * n + h) + 2.0 * b * l * di * d
    conv = 2.0 * b * l * (di + 2 * n) * cfg.conv_width
    q = min(cfg.ssd_chunk, l)
    nc = max(l // q, 1)
    cb = 2.0 * b * nc * q * q * n
    intra = 2.0 * b * nc * q * q * h * p / 2          # causal half
    states = 2.0 * b * nc * q * h * p * n * 2
    inter = 2.0 * b * l * h * p * n
    return proj + conv + cb + intra + states + inter


def _layer_flops(cfg, kind, b, l, kv_len, *, causal, padded, model_axis=16):
    h, hkv = cfg.num_heads, cfg.num_kv_heads
    if padded and h % model_axis:
        h = _ceil_to(h, model_axis)
    if padded and hkv and hkv % model_axis:
        hkv = _ceil_to(hkv, model_axis)
    total = 0.0
    window = cfg.local_window if kind.startswith("local") else None
    if "mamba" in kind:
        total += _mamba_flops(cfg, b, l)
    else:
        total += _attn_flops(cfg, b, l, kv_len, causal=causal, window=window,
                             h=h, hkv=hkv)
    if kind == "xattn":
        total += _attn_flops(cfg, b, l, cfg.encoder_seq, causal=False,
                             window=None, h=h, hkv=hkv)
    if kind.endswith("_moe") or kind == "attn_moe":
        total += _moe_flops(cfg, b, l, padded=padded)
    elif kind != "mamba" and cfg.d_ff:
        total += _mlp_flops(b, l, cfg.d_model, cfg.d_ff)
    return total


def _forward_flops(cfg: ModelConfig, b: int, l: int, kv_len: int,
                   *, causal: bool, padded: bool,
                   include_encoder: bool = True) -> float:
    total = 0.0
    for kind in cfg.layer_pattern:
        total += cfg.num_periods * _layer_flops(
            cfg, kind, b, l, kv_len, causal=causal, padded=padded)
    if cfg.is_enc_dec and include_encoder:
        le = cfg.encoder_seq
        total += cfg.encoder_layers * (
            _attn_flops(cfg, b, le, le, causal=False, window=None,
                        h=cfg.num_heads, hkv=cfg.num_kv_heads)
            + _mlp_flops(b, le, cfg.d_model, cfg.d_ff))
    # LM head
    v = cfg.vocab_padded if padded else cfg.vocab_size
    total += 2.0 * b * l * cfg.d_model * v
    return total


def _count_params(cfg: ModelConfig) -> float:
    d = cfg.d_model
    total = cfg.vocab_padded * d * (1 if cfg.tie_embeddings else 2)
    for kind in cfg.layer_pattern:
        n = cfg.num_periods
        if "mamba" in kind:
            di, h, s = cfg.ssm_d_inner, cfg.ssm_heads, cfg.ssm_state
            total += n * (d * (2 * di + 2 * s + h) + di * d
                          + cfg.conv_width * (di + 2 * s))
        else:
            hd = cfg.head_dim
            total += n * (d * cfg.num_heads * hd * 2
                          + d * cfg.num_kv_heads * hd * 2)
            if kind == "xattn":
                total += n * (d * cfg.num_heads * hd * 2
                              + d * cfg.num_kv_heads * hd * 2)
        if kind.endswith("_moe") or kind == "attn_moe":
            total += n * (3 * d * cfg.moe_d_ff * cfg.num_experts
                          + d * cfg.num_experts)
        elif kind != "mamba" and cfg.d_ff:
            total += n * 3 * d * cfg.d_ff
    if cfg.is_enc_dec:
        total += cfg.encoder_layers * (
            d * cfg.num_heads * cfg.head_dim * 2
            + d * cfg.num_kv_heads * cfg.head_dim * 2
            + 3 * d * cfg.d_ff)
    return float(total)


def cell_flops(cfg: ModelConfig, shape: ShapeConfig,
               model_axis: int = 16) -> tuple[float, float]:
    """(useful, padded) global FLOPs for one step of this cell."""
    b, l = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        fwd_u = _forward_flops(cfg, b, l, l, causal=True, padded=False)
        fwd_p = _forward_flops(cfg, b, l, l, causal=True, padded=True)
        return 3.0 * fwd_u, 3.0 * fwd_p   # bwd = 2x fwd
    if shape.kind == "prefill":
        return (_forward_flops(cfg, b, l, l, causal=True, padded=False),
                _forward_flops(cfg, b, l, l, causal=True, padded=True))
    # decode: 1 new token against kv_len cache (enc-dec: cross-K/V cached,
    # the encoder does NOT rerun per token)
    fwd_u = _forward_flops(cfg, b, 1, l, causal=False, padded=False,
                           include_encoder=False)
    fwd_p = _forward_flops(cfg, b, 1, l, causal=False, padded=True,
                           include_encoder=False)
    return fwd_u, fwd_p


def cell_bytes(cfg: ModelConfig, shape: ShapeConfig, chips: int) -> float:
    """Per-device HBM bytes for one step (dominant traffic terms)."""
    params = _count_params(cfg)
    p_bytes = params * 2 / chips            # bf16, fully sharded
    b_loc = max(shape.global_batch // (chips // 16), 1)
    d = cfg.d_model
    if shape.kind == "train":
        opt_bytes = params * (4 if cfg.adam_dtype == "float32" else 2) * 2 / chips
        # params: fwd read + bwd read + grad write + opt read/write + p write
        param_traffic = p_bytes * 4 + opt_bytes * 2
        l = shape.seq_len
        # remat carries written+read, recompute activation traffic ~4x carry
        act = cfg.num_layers * b_loc * l * d * 2 * 6
        ce = 2 * b_loc * l * cfg.vocab_padded / 16 * 4 / (
            shape.seq_len // min(cfg.ce_chunk, shape.seq_len))
        return param_traffic + act + ce
    if shape.kind == "prefill":
        l = shape.seq_len
        act = cfg.num_layers * b_loc * l * d * 2 * 3
        return p_bytes + act
    # decode: weights once + cache read/write
    cache = 0.0
    for kind in cfg.layer_pattern:
        n = cfg.num_periods
        if "mamba" in kind:
            st = (cfg.ssm_heads * cfg.ssm_head_dim * cfg.ssm_state * 4
                  + (cfg.ssm_d_inner + 2 * cfg.ssm_state) * cfg.conv_width * 2)
            cache += n * shape.global_batch * st * 2        # read + write
        else:
            s_eff = shape.seq_len
            if kind.startswith("local") and cfg.local_window:
                s_eff = min(s_eff, cfg.local_window)  # ring cache (§Perf 2-2)
            kv_bytes = 1 if cfg.kv_cache_dtype == "int8" else 2
            per_pos = cfg.num_kv_heads * (cfg.head_dim * kv_bytes
                                          + (4 if kv_bytes == 1 else 0))
            kv = 2 * s_eff * per_pos
            cache += n * shape.global_batch * kv            # read (write ~0)
    if cfg.is_enc_dec:
        cache += (cfg.num_periods * shape.global_batch
                  * 2 * cfg.encoder_seq * cfg.num_kv_heads * cfg.head_dim * 2)
    return p_bytes + cache / chips


# --------------------------------------------------------------- sketch ops

#: the kernel ops the model covers
SKETCH_OPS = ("accumulate", "propagate", "estimate",
              "union_estimate", "intersection_stats")

#: rough scalar-op cost of one fused hash64 + bucket/rho split (two fmix32
#: chains of about 10 ops each, the cross-mix, the clz window): the
#: compute term only; the ops are memory-bound either way
_HASH_FLOPS = 40.0


def _lane_width(p: int, layout: str) -> int:
    """Bytes a register row takes: r byte, r/2 packed."""
    r = 1 << p
    if layout == "packed":
        return r // 2
    if layout != "byte":
        raise ValueError(f"unknown layout {layout!r}")
    return r


def sketch_op_costs(op: str, *, p: int, layout: str = "byte",
                    n: int = 1 << 16, edges: int = 1 << 16,
                    sets: int = 256, set_size: int = 8,
                    pairs: int = 1 << 12) -> dict:
    """Modeled per-call HBM bytes and FLOPs of one sketch kernel op.

    Shapes: ``n`` register rows, ``edges`` routed edge slots
    (accumulate/propagate), ``sets`` union sets of ``set_size`` members,
    ``pairs`` intersection pairs. Returns ``{"hbm_bytes", "flops"}``.
    Only the register-panel terms depend on ``layout``; index, mask and
    output traffic is layout-invariant, which is why the modeled byte
    ratio is slightly below the raw 2x lane packing.
    """
    if op not in SKETCH_OPS:
        raise ValueError(f"op must be one of {SKETCH_OPS}, got {op!r}")
    r = 1 << p
    q = 64 - p
    w = _lane_width(p, layout)
    if op == "accumulate":
        # panel read+write, plus per-edge row index (i32), key (i32), mask
        return {"hbm_bytes": 2.0 * n * w + edges * 9.0,
                "flops": edges * (_HASH_FLOPS + 2.0 * w)}
    if op == "propagate":
        # panel read+write, gathered source rows, src/dst indices + mask
        return {"hbm_bytes": 2.0 * n * w + edges * (w + 9.0),
                "flops": edges * 2.0 * w}
    if op == "estimate":
        # panel read, one f32 estimate per row out
        return {"hbm_bytes": n * w + n * 4.0,
                "flops": n * 4.0 * r}
    if op == "union_estimate":
        # gathered member rows, member ids (i32) + mask, one f32 per set
        rows = sets * set_size
        return {"hbm_bytes": rows * w + rows * 5.0 + sets * 4.0,
                "flops": rows * 2.0 * w + sets * 4.0 * r}
    # intersection_stats: two gathered rows per pair, pair ids, the
    # (5, q+2) f32 histogram panel out
    return {"hbm_bytes": pairs * (2.0 * w + 8.0 + 5.0 * (q + 2) * 4.0),
            "flops": pairs * (q + 2) * 4.0 * r}


def cell_costs(cfg: ModelConfig, shape: ShapeConfig, chips: int) -> CellCosts:
    fu, fp = cell_flops(cfg, shape)
    return CellCosts(
        flops_useful_global=fu,
        flops_padded_global=fp,
        bytes_per_dev=cell_bytes(cfg, shape, chips),
        params_total=_count_params(cfg),
        params_bytes_per_dev=_count_params(cfg) * 2 / chips,
    )
