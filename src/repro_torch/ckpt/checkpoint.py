"""Checkpoints with atomic commit, in the JAX package's on-disk format.

Port of ``repro.ckpt.checkpoint``. Layout: ``<dir>/step_<N>/`` holds one
``<key>.npy`` per leaf and a ``manifest.json`` with the step, each leaf's
shape and dtype, and an optional ``extra`` dict. Writes go to a
``.tmp-step_<N>`` staging directory that is renamed into place, so a
crashed writer never corrupts the latest checkpoint, and
:func:`latest_step` only trusts directories with a manifest. Either
package loads the other's files.

A tree is a leaf (a tensor, an array or a number) or a dict, list or
tuple of trees. Leaves are keyed as the JAX package keys its pytree
paths: dict keys and sequence indices joined by ``.`` (``regs``,
``params.blocks.0.w``), dict keys in sorted order; ``None`` holds no
leaf. ``bfloat16`` tensors are stored as the JAX package stores them, a
raw ``uint16`` view with the logical dtype in the manifest; they come
back through a template (:func:`restore_checkpoint` with ``like_tree``)
whose leaf is a ``bfloat16`` tensor, and a flat restore refuses them
with ``ValueError`` (numpy has no ``bfloat16``).
:class:`AsyncCheckpointer` writes steps on a background thread, from a
host copy of every leaf taken before the thread starts.

The sketch family guard lives here too: register bytes are
family-portable, their meaning is not, so restoring or merging across
families raises :class:`FamilyMismatch`.
"""
from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch

__all__ = ["save_checkpoint", "restore_checkpoint", "read_manifest",
           "latest_step", "AsyncCheckpointer", "FamilyMismatch",
           "manifest_family", "require_family"]


class FamilyMismatch(ValueError):
    """A checkpoint's or engine's sketch family does not match the one
    asked for: an ADS panel read as HLL would serve Flajolet
    cardinalities where HIP curves were accumulated, and vice versa."""


def manifest_family(extra: dict | None) -> str:
    """The sketch family a manifest's ``extra`` dict records.

    Checkpoints written before the family coordinate existed carry no
    ``"family"`` key; they are all HLL by construction.
    """
    return (extra or {}).get("family", "hll")


def require_family(extra: dict | None, expected: str, what: str) -> str:
    """Assert a manifest's family matches ``expected``; return the name.

    Raises :class:`FamilyMismatch` naming both families and the operation
    (``what``, e.g. ``"load"``) otherwise.
    """
    saved = manifest_family(extra)
    if saved != expected:
        raise FamilyMismatch(
            f"{what}: checkpoint holds a {saved!r}-family sketch but a "
            f"{expected!r}-family engine was requested; register bytes do "
            f"not change meaning across families — re-accumulate or load "
            f"with family={saved!r}")
    return saved


def _flatten(tree, prefix: tuple = ()) -> list:
    """``(key, leaf)`` pairs of ``tree`` in the JAX package's leaf order:
    dict keys sorted, sequence items in order, ``None`` holding none."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _flatten(tree[k], prefix + (str(k),))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, sub in enumerate(tree)
                for kv in _flatten(sub, prefix + (str(i),))]
    return [(".".join(prefix), tree)]


def _host_leaf(leaf) -> tuple[np.ndarray, str]:
    """``(array to store, logical dtype)`` of one leaf, as a host array
    that owns its bytes: a tensor is copied off its device (or out of its
    CPU storage, which the caller may go on mutating), a ``bfloat16`` one
    as its raw ``uint16`` view; a numpy leaf is kept as it is."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
        return arr, str(arr.dtype)
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _host_leaves(tree) -> list:
    """``(key, array, logical dtype)`` for every leaf of ``tree``."""
    return [(key, *_host_leaf(leaf)) for key, leaf in _flatten(tree)]


def _write(ckpt_dir: str, step: int, leaves: list,
           extra: dict | None) -> str:
    """Atomically write host ``leaves`` as step_<step>; the final path."""
    final = os.path.join(ckpt_dir, f"step_{step}")
    tmp = os.path.join(ckpt_dir, f".tmp-step_{step}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "leaves": {}}
    if extra is not None:
        manifest["extra"] = extra
    for key, arr, logical in leaves:
        np.save(os.path.join(tmp, key + ".npy"), arr)
        manifest["leaves"][key] = {"shape": list(arr.shape),
                                   "dtype": logical}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def save_checkpoint(ckpt_dir: str, step: int, tree,
                    extra: dict | None = None) -> str:
    """Atomically write ``tree`` (a leaf, or nested dicts, lists and
    tuples of tensors, arrays and numbers) as step_<step>.

    ``extra`` is a JSON-serializable dict stored verbatim in the manifest.
    Returns the final path.
    """
    return _write(ckpt_dir, step, _host_leaves(tree), extra)


def read_manifest(ckpt_dir: str, step: int) -> dict:
    """Read the manifest of step_<step> (leaves and ``extra`` dict)."""
    with open(os.path.join(ckpt_dir, f"step_{step}", "manifest.json")) as f:
        return json.load(f)


def latest_step(ckpt_dir: str) -> int | None:
    """The highest step under ``ckpt_dir`` with a manifest, or ``None``."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(name.split("_")[1]) for name in os.listdir(ckpt_dir)
             if name.startswith("step_") and os.path.exists(
                 os.path.join(ckpt_dir, name, "manifest.json"))]
    return max(steps) if steps else None


def _like(arr: np.ndarray, logical: str, like, key: str, src: str):
    """A stored leaf shaped after its template leaf ``like``: a tensor on
    ``like``'s device and of its dtype, an array of its dtype, or a number
    of its type."""
    if isinstance(like, torch.Tensor):
        if logical == "bfloat16":
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        return t.to(device=like.device, dtype=like.dtype)
    if logical != str(arr.dtype):
        raise ValueError(
            f"leaf {key!r} of {src!r} is stored as {arr.dtype} for "
            f"logical dtype {logical!r}; restore it into a torch tensor "
            f"template, numpy has no {logical}")
    if isinstance(like, np.ndarray):
        return arr.astype(like.dtype, copy=False)
    if isinstance(like, (bool, int, float)):
        return type(like)(arr.item())
    return arr


def _unflatten(like, prefix: tuple, load):
    """``like``'s structure with each leaf replaced by ``load(key, leaf)``."""
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _unflatten(v, prefix + (str(k),), load)
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, prefix + (str(i),), load)
                          for i, v in enumerate(like))
    return load(".".join(prefix), like)


def restore_checkpoint(ckpt_dir: str, step: int, like_tree=None):
    """The leaves of step_<step>.

    Without ``like_tree``: every leaf as ``{key: np.ndarray}``; a leaf
    stored as a view of another dtype (the ``bfloat16`` leaves) raises
    ``ValueError``. With ``like_tree``: a tree of its structure, each
    leaf read by its key and put on the template leaf's device and dtype
    (a tensor), or cast to its dtype (an array) or type (a number); a
    key the step lacks raises ``KeyError``.
    """
    src = os.path.join(ckpt_dir, f"step_{step}")
    leaves = read_manifest(ckpt_dir, step)["leaves"]

    def load(key, like):
        if key not in leaves:
            raise KeyError(f"{src!r} holds no leaf {key!r}; it has "
                           f"{sorted(leaves)}")
        arr = np.load(os.path.join(src, key + ".npy"))
        return _like(arr, leaves[key]["dtype"], like, key, src)

    if like_tree is not None:
        return _unflatten(like_tree, (), load)
    return {key: load(key, None) for key in leaves}


class AsyncCheckpointer:
    """Background-thread checkpoint writer (overlaps checkpoint I/O with
    the caller's work).

    :meth:`save` waits for the previous write, takes a host copy of every
    leaf on the calling thread, then writes the step on a new thread and
    keeps the newest ``keep`` steps. :meth:`wait` joins the write in
    flight.
    """

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: threading.Thread | None = None

    def wait(self) -> None:
        """Block until the write in flight (if any) has finished."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def save(self, step: int, tree, extra: dict | None = None) -> None:
        """Write ``tree`` (as in :func:`save_checkpoint`) as step_<step> in
        the background; ``extra`` goes to the manifest."""
        self.wait()
        leaves = _host_leaves(tree)

        def work():
            _write(self.ckpt_dir, step, leaves, extra)
            self._gc()

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def _gc(self) -> None:
        steps = sorted(
            int(n.split("_")[1]) for n in os.listdir(self.ckpt_dir)
            if n.startswith("step_"))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.ckpt_dir, f"step_{s}"),
                          ignore_errors=True)
