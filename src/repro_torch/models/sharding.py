"""Sharding rules: parameter, optimizer, batch and cache partition specs
(port of ``repro.models.sharding``).

Mesh contract (``launch.mesh``): ("data", "model") single-pod or
("pod", "data", "model") multi-pod. Batch and FSDP use all data-like axes
(("pod", "data") when present); tensor parallelism uses "model".

A spec is a plain tuple, one entry a dimension: ``None``, an axis name,
or a tuple of two or more axis names; it equals ``tuple(PartitionSpec)``
of the reference (which writes a one-name tuple as the name and an empty
one as ``None``). Spec trees mirror the stand-in trees they describe
(dicts and tuples), with a spec where the stand-in has a tensor; the
stand-ins are ``meta`` tensors in place of ``ShapeDtypeStruct``s and
allocate nothing. :func:`bytes_per_device` reckons what a tree takes on
one device under its specs: each sharded dimension divided by the
product of its axes' sizes, rounded up, since GSPMD pads.

Parameter rules (Megatron/MaxText conventions):
  embed (V, D)          -> ("model", None)      vocab TP
  lm_head (D, V)        -> (None, "model")
  attn q/k/v (D, H*hd)  -> (fsdp, "model")       head sharding
  attn o (H*hd, D)      -> ("model", fsdp)
  mlp gate/up (D, F)    -> (fsdp, "model")
  mlp down (F, D)       -> ("model", fsdp)
  moe experts (E, D, F) -> EP ("model", fsdp, None) when E % model == 0
                           else TP (None, fsdp, "model")
  mamba in/out proj     -> like mlp; per-head vectors on "model"
  norms                 -> replicated

Stacked layer params carry a leading periods axis -> specs get a leading
None.

The reference's ``__all__`` also names ``train_arg_shardings``, which it
never defines (``from repro.models.sharding import *`` raises); the port
leaves the name out.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models import transformer as tfm
from repro_torch.models.config import ModelConfig, ShapeConfig

__all__ = [
    "batch_axes", "param_shardings", "opt_shardings", "make_batch_specs",
    "make_cache_shardings", "input_specs", "cache_shapes",
    "leaves_with_specs", "bytes_per_device",
]


def batch_axes(mesh) -> tuple:
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def P(*dims) -> tuple:
    """A spec, with ``PartitionSpec``'s normal form: a one-name tuple is
    the name, an empty one ``None``."""
    out = []
    for d in dims:
        if isinstance(d, (tuple, list)):
            d = None if not d else d[0] if len(d) == 1 else tuple(d)
        out.append(d)
    return tuple(out)


def _tree_items(tree, path=()):
    """(path, leaf) for every leaf of a tree of dicts, tuples and lists,
    dict keys in sorted order (the JAX package's leaf order)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _tree_items(tree[k], path + (k,))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _tree_items(v, path + (i,))
    else:
        yield path, tree


def _map_with_path(fn, tree, path=()):
    """``tree``'s structure with ``fn(path, leaf)`` at each leaf."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def leaves_with_specs(structs, specs):
    """(path, stand-in, spec) for every leaf of ``structs`` (a tensor or a
    tree of them) and the matching spec of ``specs``, in the JAX
    package's leaf order; ``path`` holds dict keys and sequence
    indices."""
    for path, leaf in _tree_items(structs):
        spec = specs
        for k in path:
            spec = spec[k]
        yield path, leaf, spec


def _path_str(path) -> str:
    return "/".join(map(str, path))


def _rule(path: str, ndim: int, cfg: ModelConfig, mesh) -> tuple:
    fsdp = batch_axes(mesh) if cfg.fsdp_params else None
    model_size = mesh.shape["model"]
    stacked = path.startswith("blocks/") or path.startswith("encoder/blocks")
    lead = (None,) if stacked else ()

    def spec(*dims):
        return P(*(lead + dims))

    leaf = path.split("/")
    if path.startswith("embed/"):
        # vocab TP only: FSDP-sharding D here lets GSPMD propagate a
        # data-axis sharding into activations through the embedding gather
        return P("model", None)
    if path.startswith("lm_head/"):
        return P(None, "model")
    if "router" in leaf:
        return spec(None, None)
    if ("gate" in leaf or "up" in leaf or "down" in leaf) and ndim - len(lead) == 3:
        # MoE expert stacks (E, D, F) / (E, F, D)
        if cfg.num_experts % model_size == 0:
            return spec("model", fsdp, None) if "down" not in leaf else \
                spec("model", None, fsdp)
        return spec(None, fsdp, "model") if "down" not in leaf else \
            spec(None, "model", fsdp)
    if "down" in leaf:                      # dense mlp down (F, D)
        return spec("model", fsdp)
    if "gate" in leaf or "up" in leaf:      # dense mlp in (D, F)
        return spec(fsdp, "model")
    if leaf[-2:] == ["o", "w"] or "out_proj" in leaf:
        return spec("model", fsdp)
    if leaf[-1] == "w" and any(k in leaf for k in ("q", "k", "v", "in_proj")):
        return spec(fsdp, "model")
    if leaf[-1] == "b" and any(k in leaf for k in ("q", "k", "v")):
        return spec("model")
    if "conv_w" in leaf:
        return spec(None, "model")
    if "conv_b" in leaf:
        return spec("model")
    if leaf[-1] in ("A_log", "D", "dt_bias"):
        return spec("model")
    if "norm" in path and leaf[-1] == "scale":
        # mamba gated norm is (d_inner,) sharded; model norms replicated
        if "mixer" in leaf:
            return spec("model")
        return spec(None)
    # fallback: replicate (biases, scalars)
    return spec(*([None] * (ndim - len(lead))))


def param_shardings(cfg: ModelConfig, mesh, params_tree):
    """A spec for every leaf of ``params_tree`` (``param_shapes``'s)."""
    return _map_with_path(
        lambda path, leaf: _rule(_path_str(path), leaf.ndim, cfg, mesh),
        params_tree)


def opt_shardings(cfg: ModelConfig, mesh, params_tree) -> dict:
    ps = param_shardings(cfg, mesh, params_tree)
    return {"m": ps, "v": ps, "count": P()}


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def make_batch_specs(cfg: ModelConfig, shape: ShapeConfig, mesh):
    """Stand-ins and specs for a train/prefill batch."""
    b_ax = batch_axes(mesh)
    bsz, seq = shape.global_batch, shape.seq_len
    text_len = seq
    structs: dict = {}
    specs: dict = {}
    if cfg.family == "vlm":
        text_len = seq - cfg.num_image_tokens
        structs["embeds"] = _meta((bsz, cfg.num_image_tokens, cfg.d_model),
                                  torch.bfloat16)
        specs["embeds"] = P(b_ax, None, None)
    if cfg.is_enc_dec:
        structs["embeds"] = _meta((bsz, cfg.encoder_seq, cfg.d_model),
                                  torch.bfloat16)
        specs["embeds"] = P(b_ax, None, None)
    structs["tokens"] = _meta((bsz, text_len), torch.int32)
    specs["tokens"] = P(b_ax, None)
    if shape.kind == "train":
        structs["labels"] = _meta((bsz, text_len), torch.int32)
        structs["loss_mask"] = _meta((bsz, text_len), torch.float32)
        specs["labels"] = P(b_ax, None)
        specs["loss_mask"] = P(b_ax, None)
    return structs, specs


def cache_shapes(cfg: ModelConfig, batch: int, seq: int) -> dict:
    """The decode cache as ``meta`` tensors in the JAX package's layout
    (``blocks[j]`` stacked over the periods, whisper's ``cross`` too)."""
    cache = tfm.init_cache(cfg, batch, seq, "meta")
    period = cfg.pattern_period
    blocks = cache["blocks"]
    tree: dict = {"blocks": tuple(
        {n: torch.stack([blocks[i * period + j][n]
                         for i in range(cfg.num_periods)])
         for n in blocks[j]}
        for j in range(period))}
    if "cross" in cache:
        tree["cross"] = {n: torch.stack([c[n] for c in cache["cross"]])
                         for n in ("k", "v")}
    return tree


def make_cache_shardings(cfg: ModelConfig, mesh, cache_tree,
                         shard_seq: bool):
    """Cache specs. shard_seq=True (long_500k, batch=1): KV seq over the
    data axes; else batch over data axes. The head-like axis takes
    'model': the kv-head axis when divisible by the model-axis size, else
    the sequence axis (flash-decode: partial scores stay local), else
    head_dim (whisper's cross cache: S=1500)."""
    b_ax = batch_axes(mesh)
    model_size = mesh.shape["model"]
    kv_on_heads = cfg.num_kv_heads and cfg.num_kv_heads % model_size == 0

    def assign(path, leaf):
        p = _path_str(path)
        parts = p.split("/")
        nd = leaf.ndim
        if parts[-1] in ("k_scale", "v_scale"):
            # (periods, B, S, Hkv): int8-cache scales follow the cache
            if shard_seq:
                h = "model" if kv_on_heads else None
                return P(None, None, b_ax, h)
            if kv_on_heads:
                return P(None, b_ax, None, "model")
            if leaf.shape[2] % model_size == 0:
                return P(None, b_ax, "model", None)
            return P(None, b_ax, None, None)
        if p.startswith("cross") or "k" in parts or "v" in parts:
            # (periods, B, S, Hkv, hd)
            if shard_seq:
                heads = ("model", None) if kv_on_heads else (None, "model")
                return P(None, None, b_ax, *heads)
            if kv_on_heads:
                return P(None, b_ax, None, "model", None)
            if leaf.shape[2] % model_size == 0:
                return P(None, b_ax, "model", None, None)
            return P(None, b_ax, None, None, "model")
        if "ssm" in parts:   # (periods, B, H, Phd, N)
            if shard_seq:
                return P(None, None, "model", None, None)
            return P(None, b_ax, "model", None, None)
        if "conv" in parts:  # (periods, B, W-1, C)
            if shard_seq:
                return P(None, None, None, "model")
            return P(None, b_ax, None, "model")
        return P(*([None] * nd))

    return _map_with_path(assign, cache_tree)


def input_specs(arch_cfg: ModelConfig, shape: ShapeConfig, mesh) -> dict:
    """Stand-ins + specs for every model input of the given cell: the
    dry-run contract (no device allocation).

    Returns a dict of (stand-ins, specs):
      kind="train":   {params, opt_state, batch, step}
      kind="prefill": {params, batch, cache}
      kind="decode":  {params, token, cache, pos}
    """
    from repro_torch.optim.adamw import AdamWConfig, adamw_init

    b_ax = batch_axes(mesh)
    params_s = tfm.param_shapes(arch_cfg)
    out: dict = {"params": (params_s,
                            param_shardings(arch_cfg, mesh, params_s))}

    if shape.kind == "train":
        opt_s = adamw_init(params_s, AdamWConfig(dtype=arch_cfg.adam_dtype))
        out["opt_state"] = (opt_s, opt_shardings(arch_cfg, mesh, params_s))
        out["batch"] = make_batch_specs(arch_cfg, shape, mesh)
        out["step"] = (_meta((), torch.int32), P())
        return out

    if shape.kind == "prefill":
        out["batch"] = make_batch_specs(arch_cfg, shape, mesh)
        cache_s = cache_shapes(arch_cfg, shape.global_batch, shape.seq_len)
        out["cache"] = (cache_s, make_cache_shardings(
            arch_cfg, mesh, cache_s, shard_seq=False))
        return out

    # decode: one new token against a seq_len cache. batch=1 (long_500k)
    # cannot shard on batch -> shard the cache sequence axis instead
    shard_seq = shape.global_batch == 1
    cache_s = cache_shapes(arch_cfg, shape.global_batch, shape.seq_len)
    out["cache"] = (cache_s, make_cache_shardings(arch_cfg, mesh, cache_s,
                                                  shard_seq=shard_seq))
    out["token"] = (_meta((shape.global_batch, 1), torch.int32),
                    P(None, None) if shard_seq else P(b_ax, None))
    out["pos"] = (_meta((), torch.int32), P())
    return out


def _shard_size(dim: int, entry, mesh) -> int:
    if entry is None:
        return dim
    axes = entry if isinstance(entry, tuple) else (entry,)
    return -(-dim // math.prod(mesh.shape[a] for a in axes))


def bytes_per_device(structs, specs, mesh) -> int:
    """Bytes one device holds of ``structs`` (a tensor or a tree of them)
    under ``specs`` (the matching spec or spec tree) on ``mesh``: each
    sharded dimension divided by its axes' sizes and rounded up."""
    total = 0
    for _, leaf, spec in leaves_with_specs(structs, specs):
        dims = [_shard_size(d, spec[i] if i < len(spec) else None, mesh)
                for i, d in enumerate(leaf.shape)]
        total += math.prod(dims) * leaf.element_size()
    return total
