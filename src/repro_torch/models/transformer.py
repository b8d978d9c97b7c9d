"""Model assembly: the decoder stack, whisper's encoder-decoder, caches
(port of ``repro.models.transformer``).

The JAX package stacks each pattern position's parameters over the
periods and scans them. Here :class:`Transformer` holds its blocks in
layer order: ``blocks[i * period + j]`` is period ``i``, pattern position
``j`` (``models.convert`` maps one form onto the other);
:func:`param_shapes` gives the parameters' shapes and dtypes under the
reference's stacked tree keys, allocating nothing. The activation
sharding hints (``models.pshard``) sit where the reference has them: on
the embedded input of ``forward_hidden`` and ``prefill``, and after each
block of ``prefill``. With no mesh set (one card) they return their
input; with one set they only check the spec.

Remat (``cfg.remat``, the reference's ``_remat``) wraps each period of
the decoder stack and each encoder block in a non-reentrant
``torch.utils.checkpoint`` when gradients are being taken (grad mode on
and a parameter that requires them): ``"full"`` saves only the period's
input, as ``save_only_these_names("block_in")`` does; ``"dots"`` also
saves the outputs of the matrix products (``aten.mm``, ``bmm``,
``addmm``) and recomputes the rest, as ``checkpoint_dots`` does;
``"none"`` saves everything. Prefill and decode never checkpoint: they
write caches in place, and a recomputed block must write nothing.

Forward surfaces:
  init_params(gen, cfg, device)               -> Transformer
  forward_hidden(params, cfg, tokens, ...)    -> (B, L, D), aux
  init_cache(cfg, batch, seq, device)         -> cache
  prefill(params, cfg, tokens, cache, ...)    -> (last logits, cache)
  decode_step(params, cfg, token, cache, pos) -> (logits, cache)
  encode(params, cfg, frames)                 -> encoder output (whisper)

Caches are ``{"blocks": [one dict a layer], "cross": [one dict a period]
(whisper)}`` and are written in place by ``prefill`` and ``decode_step``,
which return them. Modality stubs as in the reference: whisper's conv
frontend and llava's anyres tiler are given embeddings (``embeds``),
cross-attended (whisper) or prepended (llava).
"""
from __future__ import annotations

import functools

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.kernels.inputs import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import pshard
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    Dense, Embedding, RMSNorm, SwiGLU, dense, dtype_of, embed, rmsnorm,
    softcap, swiglu,
)

__all__ = [
    "Block", "Encoder", "Transformer", "init_params", "forward_hidden",
    "init_cache", "prefill", "decode_step", "encode", "lm_logits",
    "embed_lookup", "taking_grads", "param_shapes",
]


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

class Block(nn.Module):
    """One layer of kind ``kind``: ``norm1`` + ``mixer`` (attention or
    Mamba), whisper's ``norm_x`` + ``cross``, and ``norm2`` + ``ffn``
    (SwiGLU or MoE; pure mamba2 blocks have none)."""

    def __init__(self, gen, kind: str, cfg: ModelConfig, dtype, device):
        super().__init__()
        self.kind = kind
        self.norm1 = RMSNorm(cfg.d_model, dtype, device)
        if "mamba" in kind:
            self.mixer = ssm_mod.Mamba(gen, cfg, dtype, device)
        else:
            self.mixer = attn_mod.Attention(gen, cfg, dtype, device)
        if kind == "xattn":
            self.norm_x = RMSNorm(cfg.d_model, dtype, device)
            self.cross = attn_mod.Attention(gen, cfg, dtype, device)
        if kind != "mamba":
            self.norm2 = RMSNorm(cfg.d_model, dtype, device)
            if kind.endswith("_moe"):
                self.ffn = moe_mod.MoE(gen, cfg, dtype, device)
            else:
                self.ffn = SwiGLU(gen, cfg.d_model, cfg.d_ff, dtype, device)


class Encoder(nn.Module):
    """Whisper's bidirectional encoder: ``encoder_layers`` attention
    blocks and a final norm."""

    def __init__(self, gen, cfg: ModelConfig, dtype, device):
        super().__init__()
        self.blocks = nn.ModuleList(Block(gen, "attn", cfg, dtype, device)
                                    for _ in range(cfg.encoder_layers))
        self.final_norm = RMSNorm(cfg.d_model, dtype, device)


class Transformer(nn.Module):
    """The whole model: ``embed``, ``final_norm``, ``lm_head`` (untied
    configs), ``blocks`` in layer order and whisper's ``encoder``.

    ``gen``: the ``torch.Generator`` the weights are drawn from, one
    tensor at a time, with the reference's distributions and scales
    (``None``: left uninitialised, for ``models.convert`` to fill).
    ``device``: ``None`` means the card, which must be present; ``"cpu"``
    and ``"meta"`` are taken as given.
    """

    def __init__(self, cfg: ModelConfig, gen: torch.Generator | None = None,
                 device=None):
        super().__init__()
        if device is None:
            device = resolve_device(None)
        self.cfg = cfg
        dtype = dtype_of(cfg.dtype)
        self.embed = Embedding(gen, cfg.vocab_padded, cfg.d_model, dtype,
                               device)
        self.final_norm = RMSNorm(cfg.d_model, dtype, device)
        if not cfg.tie_embeddings:
            self.lm_head = Dense(gen, cfg.d_model, cfg.vocab_padded, dtype,
                                 device)
        self.blocks = nn.ModuleList(
            Block(gen, kind, cfg, dtype, device)
            for _ in range(cfg.num_periods) for kind in cfg.layer_pattern)
        if cfg.is_enc_dec:
            self.encoder = Encoder(gen, cfg, dtype, device)


def init_params(gen: torch.Generator, cfg: ModelConfig,
                device=None) -> Transformer:
    """The model with weights drawn from ``gen`` on ``device`` (``None``:
    the card, which must be present)."""
    return Transformer(cfg, gen, resolve_device(device))


def param_shapes(cfg: ModelConfig) -> dict:
    """The parameters as ``meta`` tensors under the JAX package's tree
    keys (``blocks[j]`` stacked over the periods, as ``models.convert``
    maps them): shapes and dtypes for the dry-run, no allocation."""
    from repro_torch.models.convert import _stacked
    model = Transformer(cfg, None, "meta")
    return _stacked(cfg, {k: v.detach()
                          for k, v in model.named_parameters()}, torch.stack)


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------

def taking_grads(params) -> bool:
    """Whether a forward now builds a graph for gradients: grad mode on
    and a parameter of ``params`` that requires them."""
    return torch.is_grad_enabled() and any(p.requires_grad
                                           for p in params.parameters())


_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
             torch.ops.aten.addmm.default)


def _save_products(ctx, op, *args, **kwargs):
    """``checkpoint_dots``: keep the matrix products, recompute the rest."""
    if op in _PRODUCTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, cfg: ModelConfig):
    """``fn`` under ``cfg.remat`` (the reference's ``_remat``)."""
    if cfg.remat == "none":
        return fn
    if cfg.remat == "dots":
        return functools.partial(
            checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts,
                                         _save_products))
    # "full": only the inputs (the period's x and aux) are kept
    return functools.partial(checkpoint, fn, use_reentrant=False)


# ---------------------------------------------------------------------------
# embeddings and logits
# ---------------------------------------------------------------------------

def _sinusoidal(l: int, d: int, device) -> torch.Tensor:
    pos = torch.arange(l, device=device)[:, None].float()
    dim = torch.arange(0, d, 2, device=device)[None, :].float()
    ang = pos / torch.pow(10_000.0, dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _sinusoidal_at(pos: int, d: int, device) -> torch.Tensor:
    dim = torch.arange(0, d, 2, device=device).float()
    ang = torch.tensor(float(pos), device=device) / torch.pow(10_000.0,
                                                              dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)])[None, None, :]


def _embed_inputs(params, cfg, tokens, embeds):
    """Token embedding + the modality prefix (llava) or the sinusoidal
    positions (whisper)."""
    x = embed(params.embed, tokens)
    if cfg.family == "vlm" and embeds is not None:
        x = torch.cat([embeds.to(x.dtype), x], dim=1)
    if cfg.is_enc_dec:
        x = x + _sinusoidal(x.shape[1], cfg.d_model, x.device).to(x.dtype)
    return x


def embed_lookup(params, cfg, tokens):
    """Public token-embedding lookup (telemetry, examples)."""
    return embed(params.embed, tokens)


def lm_logits(params, cfg, hidden):
    """Final norm + LM head (+ gemma2's final softcap), float32 logits.
    hidden: (..., D)."""
    h = rmsnorm(params.final_norm, hidden)
    w = params.embed.w.T if cfg.tie_embeddings else params.lm_head.w
    return softcap(h.float() @ w.float(), cfg.logit_softcap)


# ---------------------------------------------------------------------------
# encoder (whisper)
# ---------------------------------------------------------------------------

def encode(params, cfg: ModelConfig, frames):
    """frames: (B, S_enc, D) stub embeddings. Bidirectional attention
    stack, absolute sinusoidal positions added at the input."""
    x = frames.to(dtype_of(cfg.dtype))
    x = x + _sinusoidal(x.shape[1], cfg.d_model, x.device).to(x.dtype)
    positions = torch.arange(x.shape[1], device=x.device)
    grads = taking_grads(params)
    for p in params.encoder.blocks:
        body = functools.partial(_encoder_block, p, cfg, positions)
        x = (_remat(body, cfg) if grads else body)(x)
    return rmsnorm(params.encoder.final_norm, x)


def _encoder_block(p: Block, cfg, positions, x):
    q, k, v = attn_mod._project_qkv(p.mixer, rmsnorm(p.norm1, x), cfg, None)
    out = attn_mod.attention_core(q, k, v, cfg, causal=False, window=None,
                                  q_positions=positions,
                                  k_positions=positions)
    x = x + dense(p.mixer.o, out.reshape(x.shape[0], x.shape[1], -1))
    return x + swiglu(p.ffn, rmsnorm(p.norm2, x))


# ---------------------------------------------------------------------------
# forward and prefill
# ---------------------------------------------------------------------------

def _cross_kv(p, cfg, enc_out):
    b, s = enc_out.shape[0], enc_out.shape[1]
    k = dense(p.cross.k, enc_out).reshape(b, s, cfg.num_kv_heads,
                                          cfg.head_dim)
    v = dense(p.cross.v, enc_out).reshape(b, s, cfg.num_kv_heads,
                                          cfg.head_dim)
    return k, v


def _write_kv(cfg, cj: dict, k, v) -> None:
    """A prompt's K/V written into the cache ``cj`` at positions [0, L),
    or, when L exceeds the cache (a ring), its last S positions rolled so
    that slot i holds the position = i (mod S)."""
    s_cache = cj["k"].shape[1]
    l = k.shape[1]
    shift = (l - s_cache) % s_cache
    for name, val in (("k", k), ("v", v)):
        if cfg.kv_cache_dtype == "int8":
            val, scale = attn_mod.quantize_kv(val)
            if l > s_cache:
                cj[name + "_scale"].copy_(torch.roll(scale[:, -s_cache:],
                                                     shift, dims=1))
            else:
                cj[name + "_scale"][:, :l] = scale
        if l > s_cache:
            cj[name].copy_(torch.roll(val[:, -s_cache:], shift, dims=1))
        else:
            cj[name][:, :l] = val.to(cj[name].dtype)


def _apply_block(p: Block, x, cfg, positions, aux, enc_out=None,
                 cache_j=None):
    """One block over a whole sequence; with ``cache_j``, also the prompt's
    K/V or the Mamba (conv, ssm) state written into it."""
    kind = p.kind
    window = cfg.local_window if kind.startswith("local") else None
    h = rmsnorm(p.norm1, x)
    if "mamba" in kind:
        if cache_j is None:
            mixed = ssm_mod.mamba_train(p.mixer, h, cfg)
        else:
            mixed, _ = ssm_mod.mamba_prefill(p.mixer, h, cfg, cache_j)
    else:
        mixed, (k, v) = attn_mod.attention_train(
            p.mixer, h, cfg, window=window, positions=positions)
        if cache_j is not None:
            _write_kv(cfg, cache_j, k, v)
    x = x + mixed
    if kind == "xattn":
        b, lq = x.shape[0], x.shape[1]
        q = dense(p.cross.q, rmsnorm(p.norm_x, x)).reshape(
            b, lq, cfg.num_heads, cfg.head_dim)
        k, v = _cross_kv(p, cfg, enc_out)
        out = attn_mod.attention_core(
            q, k, v, cfg, causal=False, window=None, q_positions=positions,
            k_positions=torch.arange(enc_out.shape[1], device=x.device))
        x = x + dense(p.cross.o, out.reshape(b, lq, -1))
    if hasattr(p, "ffn"):
        hh = rmsnorm(p.norm2, x)
        if kind.endswith("_moe"):
            y, moe_aux, _ = moe_mod.moe_ffn(p.ffn, hh, cfg)
            aux = aux + moe_aux
        else:
            y = swiglu(p.ffn, hh)
        x = x + y
    return x, aux


def _apply_period(params, cfg, i: int, positions, enc_out, cache, x, aux):
    """Period ``i``'s blocks, in pattern order."""
    period = cfg.pattern_period
    for l in range(i * period, (i + 1) * period):
        x, aux = _apply_block(params.blocks[l], x, cfg, positions, aux,
                              enc_out,
                              None if cache is None else cache["blocks"][l])
        if cache is not None:
            x = pshard.hint(x, "btd")
    return x, aux


def _run_blocks(params, cfg, tokens, embeds, cache=None):
    """Embed, then every block in layer order, each period under
    ``cfg.remat`` when gradients are being taken (never with a cache);
    returns (hidden, aux, encoder output)."""
    enc_out = encode(params, cfg, embeds) if cfg.is_enc_dec else None
    x = pshard.hint(_embed_inputs(params, cfg, tokens, embeds), "btd")
    positions = torch.arange(x.shape[1], device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    grads = cache is None and taking_grads(params)
    for i in range(cfg.num_periods):
        body = functools.partial(_apply_period, params, cfg, i, positions,
                                 enc_out, cache)
        x, aux = (_remat(body, cfg) if grads else body)(x, aux)
    return x, aux, enc_out


def forward_hidden(params, cfg: ModelConfig, tokens, embeds=None):
    """Full-sequence forward to the final hidden states (before the final
    norm) and the summed MoE aux loss."""
    x, aux, _ = _run_blocks(params, cfg, tokens, embeds)
    return x, aux


def prefill(params, cfg: ModelConfig, tokens, cache: dict, embeds=None):
    """Process a prompt, filling the cache in place. Returns (last
    logits (B, V), cache).

    Attention K/V of the prompt are written at positions [0, L) (a ring
    keeps the last S); Mamba states are advanced by the chunked scan;
    whisper's cross-attention K/V are computed once from the encoder
    output.
    """
    x, _, enc_out = _run_blocks(params, cfg, tokens, embeds, cache)
    if cfg.is_enc_dec:
        period = cfg.pattern_period
        cache["cross"] = [
            dict(zip(("k", "v"), _cross_kv(params.blocks[i * period], cfg,
                                           enc_out)))
            for i in range(cfg.num_periods)]
    return lm_logits(params, cfg, x[:, -1, :]), cache


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, seq: int, device=None) -> dict:
    """Zeroed caches sized for ``seq`` positions on ``device`` (``None``:
    the card; ``"meta"``: shapes only, for the dry-run). Sliding-window
    layers carry a ring of window size."""
    meta = device is not None and torch.device(device).type == "meta"
    device = torch.device("meta") if meta else resolve_device(device)
    dtype = dtype_of(cfg.dtype)
    kv_dtype = torch.int8 if cfg.kv_cache_dtype == "int8" else dtype
    blocks = []
    for _ in range(cfg.num_periods):
        for kind in cfg.layer_pattern:
            if "mamba" in kind:
                blocks.append(ssm_mod.init_mamba_state(cfg, batch, dtype,
                                                       device))
                continue
            s_eff = seq
            if kind.startswith("local") and cfg.local_window:
                s_eff = min(seq, cfg.local_window)
            shape = (batch, s_eff, cfg.num_kv_heads, cfg.head_dim)
            entry = {n: torch.zeros(shape, dtype=kv_dtype, device=device)
                     for n in ("k", "v")}
            if cfg.kv_cache_dtype == "int8":
                for n in ("k_scale", "v_scale"):
                    entry[n] = torch.zeros(shape[:-1], dtype=torch.float32,
                                           device=device)
            blocks.append(entry)
    cache: dict = {"blocks": blocks}
    if cfg.is_enc_dec:
        shape = (batch, cfg.encoder_seq, cfg.num_kv_heads, cfg.head_dim)
        cache["cross"] = [{n: torch.zeros(shape, dtype=dtype, device=device)
                           for n in ("k", "v")}
                          for _ in range(cfg.num_periods)]
    return cache


def _apply_block_decode(p: Block, x, cfg, cache_j, pos: int, cross_j=None):
    kind = p.kind
    window = cfg.local_window if kind.startswith("local") else None
    h = rmsnorm(p.norm1, x)
    if "mamba" in kind:
        mixed, _ = ssm_mod.mamba_decode(p.mixer, h, cfg, cache_j)
    else:
        mixed, _ = attn_mod.attention_decode(p.mixer, h, cfg, cache_j, pos,
                                             window=window)
    x = x + mixed
    if kind == "xattn":
        b = x.shape[0]
        rep = cfg.num_heads // cfg.num_kv_heads
        q = dense(p.cross.q, rmsnorm(p.norm_x, x))
        qh = q.reshape(b, cfg.num_kv_heads, rep, cfg.head_dim)
        scores = torch.einsum("bgrd,bsgd->bgrs", qh.float(),
                              cross_j["k"].float())
        scores = scores * cfg.head_dim ** -0.5
        w = torch.softmax(scores, dim=-1).to(cross_j["v"].dtype)
        out = torch.einsum("bgrs,bsgd->bgrd", w, cross_j["v"])
        x = x + dense(p.cross.o, out.reshape(b, 1, -1))
    if hasattr(p, "ffn"):
        hh = rmsnorm(p.norm2, x)
        if kind.endswith("_moe"):
            y, _, _ = moe_mod.moe_ffn(p.ffn, hh, cfg)
        else:
            y = swiglu(p.ffn, hh)
        x = x + y
    return x


def decode_step(params, cfg: ModelConfig, token, cache: dict, pos: int):
    """token: (B, 1) ids; pos: the position being written. Returns
    (logits float32 (B, V), cache), the cache updated in place."""
    x = embed(params.embed, token)
    if cfg.is_enc_dec:
        x = x + _sinusoidal_at(pos, cfg.d_model, x.device).to(x.dtype)
    cross = cache.get("cross")
    period = cfg.pattern_period
    for l, p in enumerate(params.blocks):
        x = _apply_block_decode(
            p, x, cfg, cache["blocks"][l], pos,
            None if cross is None else cross[l // period])
    return lm_logits(params, cfg, x[:, 0, :]), cache
