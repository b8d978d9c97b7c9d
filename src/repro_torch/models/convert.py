"""The JAX package's parameter and cache trees carried across, both ways.

The reference keeps each pattern position's leaves stacked over the
periods under ``blocks[j]`` (and the encoder's over its layers under
``encoder["blocks"]``); the port keeps one module (one cache dict) a
layer, ``blocks[i * period + j]``. Other leaves (``embed``, ``lm_head``,
``final_norm``, ``encoder["final_norm"]``) map by name. Leaves are numpy
arrays; a ``bfloat16`` leaf travels as its raw ``uint16`` view (numpy has
no ``bfloat16``), as checkpoints store it, or as an ``ml_dtypes``
``bfloat16`` array when the caller has one.

* :func:`params_from_tree` / :func:`params_to_tree`: the model;
* :func:`train_state_to_tree` / :func:`train_state_from_tree`: the model
  and its AdamW state (``m`` and ``v`` keyed by parameter name, stacked
  as the parameters are), the JAX ``train_loop``'s checkpoint tree;
  :data:`TRAIN_STATE` hands both to the port's ``train_loop``;
* :func:`cache_from_tree` / :func:`cache_to_tree`: a decode cache.

A round trip gives equal arrays.
"""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from repro_torch.kernels.inputs import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import Transformer

__all__ = ["params_from_tree", "params_to_tree", "train_state_to_tree",
           "train_state_like", "train_state_from_tree", "TRAIN_STATE",
           "cache_from_tree", "cache_to_tree"]


def _from_numpy(arr: np.ndarray) -> torch.Tensor:
    """A CPU tensor over ``arr``, copied first when it is read-only or not
    contiguous (a tensor may not alias read-only memory)."""
    if not (arr.flags.writeable and arr.flags.c_contiguous):
        arr = np.array(arr, order="C")
    return torch.from_numpy(arr)


def _to_tensor(arr, device, dtype: torch.dtype | None = None
               ) -> torch.Tensor:
    """A numpy leaf as a tensor of ``dtype`` on ``device`` (``None``: the
    leaf's own, ``bfloat16`` for a ``uint16`` view)."""
    arr = np.asarray(arr)
    if dtype is None and (arr.dtype == np.uint16
                          or arr.dtype.name == "bfloat16"):
        dtype = torch.bfloat16
    if dtype == torch.bfloat16 and arr.dtype != np.float32:
        if arr.dtype != np.uint16:  # an ml_dtypes bfloat16 array
            arr = arr.view(np.uint16)
        t = _from_numpy(arr.view(np.int16))
        return t.view(torch.bfloat16).to(device)
    return _from_numpy(arr).to(device=device, dtype=dtype)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy leaf (``bfloat16``: its ``uint16`` view)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _leaves(tree, path=()):
    """(path, leaf) for every leaf of a tree of dicts, tuples and lists."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _port_keys(cfg: ModelConfig, path: tuple):
    """The port's (state-dict key, index into the leading axis or None)
    for each slice of the reference leaf at ``path``."""
    period = cfg.pattern_period
    if path[0] == "blocks":
        j, rest = path[1], ".".join(map(str, path[2:]))
        return [(f"blocks.{i * period + j}.{rest}", i)
                for i in range(cfg.num_periods)]
    if path[:2] == ("encoder", "blocks"):
        rest = ".".join(map(str, path[2:]))
        return [(f"encoder.blocks.{i}.{rest}", i)
                for i in range(cfg.encoder_layers)]
    return [(".".join(map(str, path)), None)]


def _fill(cfg: ModelConfig, named: dict, tree, what: str) -> None:
    """Copy every leaf of the reference tree ``tree`` (numpy arrays or
    tensors) into the port's tensors ``named`` (by parameter name), each
    stacked leaf sliced over its periods; every tensor must be given, with
    the reference's shape."""
    filled = set()
    for path, leaf in _leaves(tree):
        for key, i in _port_keys(cfg, path):
            if key not in named:
                raise KeyError(f"{'/'.join(map(str, path))}: no parameter "
                               f"{key!r} in the port's model")
            dst = named[key]
            if isinstance(leaf, torch.Tensor):
                src = leaf if i is None else leaf[i]
            else:
                arr = np.asarray(leaf) if i is None else np.asarray(leaf)[i]
                src = _to_tensor(arr, dst.device, dst.dtype)
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(f"{what} {key}: shape {tuple(src.shape)}, "
                                 f"want {tuple(dst.shape)}")
            with torch.no_grad():
                dst.copy_(src)
            filled.add(key)
    missing = sorted(set(named) - filled)
    if missing:
        raise KeyError(f"the {what} tree has no leaf for {missing}")


def params_from_tree(cfg: ModelConfig, tree, device=None) -> Transformer:
    """The port's model holding the reference tree's weights, on
    ``device`` (``None``: the card, which must be present). Every
    parameter must be given, with the reference's shape."""
    model = Transformer(cfg, None, resolve_device(device))
    _fill(cfg, dict(model.named_parameters()), tree, "parameter")
    return model


def _nest(flat: dict) -> dict:
    """A nested dict from ``{"a.b.c": leaf}``."""
    out: dict = {}
    for key, leaf in flat.items():
        node = out
        *head, last = key.split(".")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = leaf
    return out


def _stacked(cfg: ModelConfig, flat: dict, stack) -> dict:
    """The reference's tree of ``{parameter name: leaf}``: each pattern
    position's block leaves (and the encoder's) stacked over the periods
    with ``stack`` (``np.stack`` or ``torch.stack``)."""
    period = cfg.pattern_period
    flat = dict(flat)
    blocks = [dict() for _ in range(period)]
    enc_blocks: dict = {}
    for key in list(flat):
        parts = key.split(".")
        if parts[0] == "blocks":
            l, rest = int(parts[1]), ".".join(parts[2:])
            blocks[l % period].setdefault(rest, [None] * cfg.num_periods)[
                l // period] = flat.pop(key)
        elif parts[:2] == ["encoder", "blocks"]:
            rest = ".".join(parts[3:])
            enc_blocks.setdefault(rest, [None] * cfg.encoder_layers)[
                int(parts[2])] = flat.pop(key)
    tree = _nest(flat)
    tree["blocks"] = tuple(_nest({k: stack(v) for k, v in b.items()})
                           for b in blocks)
    if enc_blocks:
        tree["encoder"]["blocks"] = _nest(
            {k: stack(v) for k, v in enc_blocks.items()})
    return tree


def params_to_tree(model: Transformer):
    """The reference's parameter tree (numpy leaves) of ``model``."""
    return _stacked(model.cfg, {k: _to_numpy(v)
                                for k, v in model.named_parameters()},
                    np.stack)


def train_state_to_tree(model: Transformer, opt_state: dict) -> dict:
    """``{"params": ..., "opt": {"m", "v", "count"}}`` in the JAX
    package's train-checkpoint layout (``train_loop``'s tree), with CPU
    tensor leaves (a ``bfloat16`` leaf stays ``bfloat16``, which the
    checkpoint stores as the reference does). ``opt_state`` is
    ``optim.adamw_init``'s state of ``model``. Costs one host copy of
    every leaf and one more of each stacked leaf."""
    cfg = model.cfg

    def tree(named):
        return _stacked(cfg, {k: v.detach().cpu() for k, v in named.items()},
                        torch.stack)

    return {"params": tree(dict(model.named_parameters())),
            "opt": {"m": tree(opt_state["m"]), "v": tree(opt_state["v"]),
                    "count": opt_state["count"].detach().cpu()}}


def train_state_like(model: Transformer, opt_state: dict) -> dict:
    """The structure of :func:`train_state_to_tree` with empty CPU tensors
    of each leaf's dtype: the template ``ckpt.restore_checkpoint`` reads
    a train checkpoint into, without a copy of the state."""
    cfg = model.cfg

    def tree(named):
        return _stacked(cfg, {k: torch.empty(0, dtype=v.dtype)
                              for k, v in named.items()},
                        lambda v: v[0])

    return {"params": tree(dict(model.named_parameters())),
            "opt": {"m": tree(opt_state["m"]), "v": tree(opt_state["v"]),
                    "count": torch.empty(0, dtype=opt_state["count"].dtype)}}


def train_state_from_tree(model: Transformer, opt_state: dict, tree: dict
                          ) -> tuple[Transformer, dict]:
    """Copy a train tree (the JAX package's layout, numpy or tensor
    leaves) into ``model`` and ``opt_state`` in place; returns them."""
    cfg = model.cfg
    _fill(cfg, dict(model.named_parameters()), tree["params"], "parameter")
    _fill(cfg, opt_state["m"], tree["opt"]["m"], "m")
    _fill(cfg, opt_state["v"], tree["opt"]["v"], "v")
    with torch.no_grad():
        opt_state["count"].copy_(torch.as_tensor(tree["opt"]["count"]))
    return model, opt_state


#: ``runtime.ft.train_loop``'s ``codec`` for a ``Transformer`` and its
#: ``adamw_init`` state: checkpoints in the JAX package's train layout
TRAIN_STATE = SimpleNamespace(to_tree=train_state_to_tree,
                              like_tree=train_state_like,
                              from_tree=train_state_from_tree)


def cache_from_tree(cfg: ModelConfig, tree, device=None) -> dict:
    """The port's cache from the reference's (``blocks`` a tuple over the
    pattern of leaves stacked over the periods; whisper's ``cross``
    stacked over the periods)."""
    device = resolve_device(device)
    period = cfg.pattern_period
    cache: dict = {"blocks": [
        {n: _to_tensor(np.asarray(v)[i], device)
         for n, v in tree["blocks"][j].items()}
        for i in range(cfg.num_periods) for j in range(period)]}
    if "cross" in tree:
        cache["cross"] = [{n: _to_tensor(np.asarray(v)[i], device)
                           for n, v in tree["cross"].items()}
                          for i in range(cfg.num_periods)]
    return cache


def cache_to_tree(cfg: ModelConfig, cache: dict) -> dict:
    """The reference's cache tree (numpy leaves) of the port's cache."""
    period = cfg.pattern_period
    blocks = cache["blocks"]
    tree: dict = {"blocks": tuple(
        {n: np.stack([_to_numpy(blocks[i * period + j][n])
                      for i in range(cfg.num_periods)])
         for n in blocks[j]}
        for j in range(period))}
    if "cross" in cache:
        tree["cross"] = {n: np.stack([_to_numpy(c[n])
                                      for c in cache["cross"]])
                         for n in ("k", "v")}
    return tree
