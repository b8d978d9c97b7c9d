"""GQA attention: blockwise online softmax for train/prefill, cache
attention for decode (port of ``repro.models.attention``). RoPE, the
sliding window ("local" layers), the score softcap (gemma2) and QKV bias
(qwen2).

The plain form is the reference's, not a library attention
(``scaled_dot_product_attention``, flash): the JAX package computes
attention outside any Pallas kernel, and the softcap, the window and its
padding rules must hold. Scores and P·V accumulate in float32 as the
reference's ``preferred_element_type=float32`` einsums do: bf16 operands
are upcast (their products are exact in float32), so nothing is rounded
to bf16 before the reference rounds it.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models.layers import Dense, dense, rope, softcap

__all__ = ["Attention", "attention_core", "attention_train",
           "attention_decode", "quantize_kv", "dequantize_kv", "NEG_INF"]

NEG_INF = -2.0 ** 30


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 per-(..., position, head) quantization over head_dim.

    x: (B, S, Hkv, hd) -> (int8 of the same shape, float32 scales
    (B, S, Hkv)); round half to even, clipped to ±127.
    """
    x32 = x.float()
    scale = torch.clamp(x32.abs().amax(dim=-1), min=1e-6) / 127.0
    q = torch.clamp(torch.round(x32 / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype
                  ) -> torch.Tensor:
    return (q.float() * scale[..., None]).to(dtype)


class Attention(nn.Module):
    """The q, k, v and o projections (``Dense``; q/k/v biased for qwen2)."""

    def __init__(self, gen, cfg, dtype, device):
        super().__init__()
        d, h, hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, \
            cfg.head_dim
        self.q = Dense(gen, d, h * hd, dtype, device, bias=cfg.qkv_bias)
        self.k = Dense(gen, d, hkv * hd, dtype, device, bias=cfg.qkv_bias)
        self.v = Dense(gen, d, hkv * hd, dtype, device, bias=cfg.qkv_bias)
        self.o = Dense(gen, h * hd, d, dtype, device)


def _project_qkv(p, x, cfg, positions):
    b, l, _ = x.shape
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = dense(p.q, x).reshape(b, l, h, hd)
    k = dense(p.k, x).reshape(b, l, hkv, hd)
    v = dense(p.v, x).reshape(b, l, hkv, hd)
    # rope_theta <= 0 disables RoPE (whisper: absolute sinusoidal positions)
    if positions is not None and cfg.rope_theta > 0:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def _scores_mask(q_pos, k_pos, causal: bool, window: int | None):
    m = torch.ones((q_pos.shape[-1], k_pos.shape[-1]), dtype=torch.bool,
                   device=q_pos.device)
    if causal:
        m &= q_pos[:, None] >= k_pos[None, :]
    if window is not None:
        m &= q_pos[:, None] - k_pos[None, :] < window
    return m


def _pad_seq(x: torch.Tensor, n: int, value=0) -> torch.Tensor:
    """``x`` padded with ``n`` entries of ``value`` along dim 1 (dim 0 of
    a 1-D tensor)."""
    if n == 0:
        return x
    dim = 0 if x.dim() == 1 else 1
    shape = list(x.shape)
    shape[dim] = n
    return torch.cat([x, torch.full(shape, value, dtype=x.dtype,
                                    device=x.device)], dim=dim)


def attention_core(q, k, v, cfg, *, causal: bool, window: int | None,
                   q_positions, k_positions, q_block: int = 1024,
                   kv_block: int = 1024):
    """Blockwise online-softmax attention.

    q: (B, Lq, H, D); k, v: (B, Lk, Hkv, D). Returns (B, Lq, H, D) in q's
    dtype. Sequences are padded to block multiples as the reference pads
    them (query positions -1, key positions 2^30, zero rows); a padded key
    is masked only by the causal mask, as there.
    """
    b, lq, h, hd = q.shape
    lk, hkv = k.shape[1], k.shape[2]
    rep = h // hkv
    scale = hd ** -0.5
    q_block = min(q_block, lq)
    kv_block = min(kv_block, lk)
    nq = (lq + q_block - 1) // q_block
    nk = (lk + kv_block - 1) // kv_block
    lq_p, lk_p = nq * q_block, nk * kv_block
    qp = _pad_seq(q, lq_p - lq).reshape(b, nq, q_block, hkv, rep, hd)
    kp = _pad_seq(k, lk_p - lk).reshape(b, nk, kv_block, hkv, hd)
    vp = _pad_seq(v, lk_p - lk).reshape(b, nk, kv_block, hkv, hd)
    qpos = _pad_seq(q_positions, lq_p - lq, -1).reshape(nq, q_block)
    kpos = _pad_seq(k_positions, lk_p - lk, 2 ** 30).reshape(nk, kv_block)

    outs = []
    for qi in range(nq):
        qblk = qp[:, qi].float()                       # (B, qb, G, R, D)
        m_run = torch.full((b, hkv, rep, q_block), NEG_INF,
                           dtype=torch.float32, device=q.device)
        l_run = torch.zeros_like(m_run)
        acc = torch.zeros((b, hkv, rep, q_block, hd), dtype=torch.float32,
                          device=q.device)
        for ki in range(nk):
            vblk = vp[:, ki]
            s = torch.einsum("bqgrd,bkgd->bgrqk", qblk,
                             kp[:, ki].float()) * scale
            s = softcap(s, cfg.attn_softcap)
            mask = _scores_mask(qpos[qi], kpos[ki], causal, window)
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m_run, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m_run - m_new)
            l_run = l_run * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bgrqk,bkgd->bgrqd", p.to(vblk.dtype).float(), vblk.float())
            m_run = m_new
        outs.append(acc / torch.clamp(l_run, min=1e-30)[..., None])
    out = torch.stack(outs, dim=1)                     # (B, nq, G, R, qb, D)
    out = out.permute(0, 1, 4, 2, 3, 5).reshape(b, lq_p, h, hd)[:, :lq]
    return out.to(q.dtype)


def attention_train(p, x, cfg, *, window: int | None, positions):
    """Full causal (or windowed) self-attention for train/prefill.

    x: (B, L, D); positions: (L,). Returns (B, L, D) plus (k, v) for the
    cache.
    """
    q, k, v = _project_qkv(p, x, cfg, positions[None])
    out = attention_core(q, k, v, cfg, causal=True, window=window,
                         q_positions=positions, k_positions=positions)
    return dense(p.o, out.reshape(x.shape[0], x.shape[1], -1)), (k, v)


def attention_decode(p, x, cfg, cache: dict, pos: int, *,
                     window: int | None):
    """One-token decode against a KV cache, which is updated in place.

    x: (B, 1, D); cache: {"k","v" (B, S, Hkv, D)[, "k_scale","v_scale"
    (B, S, Hkv)]}; pos: the current position. Returns (out (B, 1, D),
    cache).

    Windowed layers may carry a ring cache (S <= window): slot i holds the
    newest position p <= pos with p = i (mod S); the write goes to
    pos % S and the validity mask rebuilds true positions. An int8 cache
    stores symmetric per-(position, head) scales and is dequantized to
    x's dtype before the scores.
    """
    b = x.shape[0]
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    quant = cache["k"].dtype == torch.int8
    s = cache["k"].shape[1]
    ring = window is not None and s <= window
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _project_qkv(p, x, cfg, positions)
    slot = pos % s if ring else pos
    if quant:
        k_new, ks = quantize_kv(k_new)
        v_new, vs = quantize_kv(v_new)
        cache["k_scale"][:, slot:slot + 1] = ks
        cache["v_scale"][:, slot:slot + 1] = vs
    cache["k"][:, slot:slot + 1] = k_new
    cache["v"][:, slot:slot + 1] = v_new
    cache_k, cache_v = cache["k"], cache["v"]
    if quant:
        cache_k = dequantize_kv(cache_k, cache["k_scale"], x.dtype)
        cache_v = dequantize_kv(cache_v, cache["v_scale"], x.dtype)
    rep = h // hkv
    qh = q.reshape(b, hkv, rep, hd)
    scores = torch.einsum("bgrd,bsgd->bgrs", qh.float(),
                          cache_k.float()) * hd ** -0.5
    scores = softcap(scores, cfg.attn_softcap)
    idx = torch.arange(s, device=x.device)
    if ring:
        # true position held in slot i: pos - ((pos - i) mod S)
        kpos = pos - torch.remainder(pos - idx, s)
        valid = kpos >= 0
    else:
        kpos = idx
        valid = kpos <= pos
        if window is not None:
            valid &= (pos - kpos) < window
    scores = torch.where(valid, scores, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(cache_v.dtype)
    out = torch.einsum("bgrs,bsgd->bgrd", w, cache_v)
    return dense(p.o, out.reshape(b, 1, h * hd)), cache
