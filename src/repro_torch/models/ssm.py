"""Mamba2 / SSD (state-space duality) block, arXiv:2405.21060 (port of
``repro.models.ssm``).

Prefill uses the chunked SSD algorithm in float32: within a chunk the
recurrence is an attention-like (Q x Q) product; across chunks a short
loop carries the (H, P, N) state. Decode is the O(1) state update, which
is what keeps the ``long_500k`` cell sub-quadratic.

Conventions: x (B, L, H, P) heads, dt (B, L, H), A (H,) negative decay,
B/C (B, L, N) with one group, D (H,) skip.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import Dense, RMSNorm, const, normal, rmsnorm

__all__ = ["Mamba", "mamba_train", "mamba_prefill", "mamba_decode",
           "init_mamba_state"]


class Mamba(nn.Module):
    """``in_proj``, the depthwise causal conv, ``A_log``/``D``/``dt_bias``
    (float32), the gated norm and ``out_proj``."""

    def __init__(self, gen, cfg, dtype, device):
        super().__init__()
        d, di, h, n = cfg.d_model, cfg.ssm_d_inner, cfg.ssm_heads, \
            cfg.ssm_state
        conv_ch = di + 2 * n
        self.in_proj = Dense(gen, d, 2 * di + 2 * n + h, dtype, device)
        self.conv_w = normal(gen, (cfg.conv_width, conv_ch),
                             (cfg.conv_width * conv_ch) ** -0.5, dtype,
                             device)
        self.conv_b = const((conv_ch,), 0.0, dtype, device)
        self.A_log = nn.Parameter(torch.log(torch.linspace(
            1.0, 16.0, h, dtype=torch.float32, device=device)),
            requires_grad=False)
        self.D = const((h,), 1.0, torch.float32, device)
        self.dt_bias = const((h,), 0.5, torch.float32, device)
        self.norm = RMSNorm(di, dtype, device)
        self.out_proj = Dense(gen, di, d, dtype, device, scale=di ** -0.5)


def _split_proj(p, x, cfg):
    di, n = cfg.ssm_d_inner, cfg.ssm_state
    zxbcdt = x @ p.in_proj.w
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:di + di + 2 * n]
    dt_raw = zxbcdt[..., di + di + 2 * n:]
    dt = F.softplus(dt_raw.float() + p.dt_bias)
    return z, xbc, dt


def _causal_conv(p, xbc, cfg):
    """Depthwise causal conv over time. xbc: (B, L, C)."""
    w = p.conv_w                                        # (W, C)
    width, l = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, width - 1, 0))
    out = 0
    for i in range(width):
        out = out + pad[:, i:i + l, :] * w[i]
    return F.silu(out + p.conv_b)


def _ssd_chunked(xh, dt, A, Bm, Cm, chunk: int, h0=None):
    """Chunked SSD scan, in float32.

    xh: (B, L, H, P); dt: (B, L, H); A: (H,); Bm/Cm: (B, L, N).
    Returns (y (B, L, H, P), h_final (B, H, P, N)).
    """
    b, l, h, p = xh.shape
    n = Bm.shape[-1]
    nc = l // chunk
    assert l % chunk == 0, (l, chunk)
    xs = xh.reshape(b, nc, chunk, h, p).float()
    dts = dt.reshape(b, nc, chunk, h)
    Bs = Bm.reshape(b, nc, chunk, n).float()
    Cs = Cm.reshape(b, nc, chunk, n).float()

    cum = torch.cumsum(dts * A, dim=2)                  # s_i, negative
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # s_i - s_j
    ii = torch.arange(chunk, device=xh.device)
    causal = (ii[:, None] >= ii[None, :])[None, None, :, :, None]
    # double where: zero the non-causal exponents BEFORE exp, as the
    # reference does (its backward would see exp(+huge) * 0 otherwise)
    seg = torch.where(causal, seg, 0.0)
    decay = torch.where(causal, torch.exp(seg), 0.0)

    cb = torch.einsum("bcin,bcjn->bcij", Cs, Bs)        # (B, nc, Q, Q)
    m = cb[..., None] * decay * dts[:, :, None, :, :]   # (B, nc, Q, Q, H)
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", m, xs)

    # chunk states: S_c = sum_j exp(s_last - s_j) dt_j B_j x_j
    last = cum[:, :, -1:, :]                            # (B, nc, 1, H)
    w_j = torch.exp(last - cum) * dts                   # (B, nc, Q, H)
    S = torch.einsum("bcjh,bcjn,bcjhp->bchpn", w_j, Bs, xs)

    # cross-chunk recurrence: the state entering each chunk
    chunk_decay = torch.exp(last[:, :, 0, :])           # (B, nc, H)
    hstate = (torch.zeros((b, h, p, n), dtype=torch.float32,
                          device=xh.device) if h0 is None else h0)
    h_prevs = []
    for c in range(nc):
        h_prevs.append(hstate)
        hstate = hstate * chunk_decay[:, c, :, None, None] + S[:, c]
    h_prevs = torch.stack(h_prevs, dim=1)               # (B, nc, H, P, N)

    y_inter = torch.einsum("bcin,bchpn,bcih->bcihp", Cs, h_prevs,
                           torch.exp(cum))
    return (y_intra + y_inter).reshape(b, l, h, p), hstate


def _mamba_full(p, x, cfg):
    b, l, _ = x.shape
    di, h, n, hp = cfg.ssm_d_inner, cfg.ssm_heads, cfg.ssm_state, \
        cfg.ssm_head_dim
    z, xbc_raw, dt = _split_proj(p, x, cfg)
    xbc = _causal_conv(p, xbc_raw, cfg)
    xh = xbc[..., :di].reshape(b, l, h, hp)
    Bm = xbc[..., di:di + n]
    Cm = xbc[..., di + n:]
    A = -torch.exp(p.A_log)
    y, h_fin = _ssd_chunked(xh, dt, A, Bm, Cm, min(cfg.ssd_chunk, l))
    y = y + p.D[None, None, :, None] * xh.float()
    y = y.reshape(b, l, di).to(x.dtype)
    y = rmsnorm(p.norm, y * F.silu(z))
    return y @ p.out_proj.w, h_fin, xbc_raw


def mamba_train(p, x, cfg):
    """x: (B, L, D) -> (B, L, D). Full-sequence SSD (the forward)."""
    y, _, _ = _mamba_full(p, x, cfg)
    return y


def mamba_prefill(p, x, cfg, state: dict):
    """Full-sequence SSD that also hands off the (conv, ssm) state for
    decode; ``state`` is written in place and returned."""
    y, h_fin, xbc_raw = _mamba_full(p, x, cfg)
    width = cfg.conv_width
    state["conv"].copy_(xbc_raw[:, -(width - 1):, :])
    state["ssm"].copy_(h_fin)
    return y, state


def init_mamba_state(cfg, batch: int, dtype, device) -> dict:
    di, h, n, hp = cfg.ssm_d_inner, cfg.ssm_heads, cfg.ssm_state, \
        cfg.ssm_head_dim
    return {
        "conv": torch.zeros((batch, cfg.conv_width - 1, di + 2 * n),
                            dtype=dtype, device=device),
        "ssm": torch.zeros((batch, h, hp, n), dtype=torch.float32,
                           device=device),
    }


def mamba_decode(p, x, cfg, state: dict):
    """One-token step, ``state`` (from ``init_mamba_state``) updated in
    place. x: (B, 1, D)."""
    b = x.shape[0]
    di, h, n, hp = cfg.ssm_d_inner, cfg.ssm_heads, cfg.ssm_state, \
        cfg.ssm_head_dim
    z, xbc, dt = _split_proj(p, x, cfg)                  # (B, 1, *)
    win = torch.cat([state["conv"], xbc], dim=1)         # (B, W, C)
    conv_out = torch.sum(win * p.conv_w[None], dim=1, keepdim=True) \
        + p.conv_b
    xbc_t = F.silu(conv_out)                             # (B, 1, C)
    xh = xbc_t[..., :di].reshape(b, h, hp)
    Bm = xbc_t[:, 0, di:di + n]
    Cm = xbc_t[:, 0, di + n:]
    A = -torch.exp(p.A_log)
    a = torch.exp(dt[:, 0] * A)                          # (B, H)
    hs = state["ssm"] * a[:, :, None, None] + torch.einsum(
        "bh,bn,bhp->bhpn", dt[:, 0], Bm.float(), xh.float())
    y = torch.einsum("bn,bhpn->bhp", Cm.float(), hs)
    y = y + p.D[None, :, None] * xh.float()
    y = y.reshape(b, 1, di).to(x.dtype)
    y = rmsnorm(p.norm, y * F.silu(z))
    state["conv"].copy_(win[:, 1:])
    state["ssm"].copy_(hs)
    return y @ p.out_proj.w, state
