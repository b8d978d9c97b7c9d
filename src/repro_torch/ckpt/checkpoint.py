"""Checkpoints with atomic commit, in the JAX package's on-disk format.

Port of ``repro.ckpt.checkpoint``. Layout: ``<dir>/step_<N>/`` holds one
``<key>.npy`` per leaf and a ``manifest.json`` with the step, each leaf's
shape and dtype, and an optional ``extra`` dict. Writes go to a
``.tmp-step_<N>`` staging directory that is renamed into place, so a
crashed writer never corrupts the latest checkpoint, and
:func:`latest_step` only trusts directories with a manifest. Either
package loads the other's files.

The tree is a flat dict of numpy arrays; its keys are the leaf keys the
JAX package derives from a dict's paths (``regs``, ``edges``,
``replica_ids``). The JAX package stores ``bfloat16`` leaves as a raw
integer view and records the logical dtype; the port has no
``ml_dtypes`` and refuses such a leaf with ``ValueError``.
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


def save_checkpoint(ckpt_dir: str, step: int, tree: dict,
                    extra: dict | None = None) -> str:
    """Atomically write ``tree`` (``{key: array}``) as step_<step>.

    ``extra`` is a JSON-serializable dict stored verbatim in the manifest.
    Returns the final path.
    """
    final = os.path.join(ckpt_dir, f"step_{step}")
    tmp = os.path.join(ckpt_dir, f".tmp-step_{step}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "leaves": {}}
    if extra is not None:
        manifest["extra"] = extra
    for key in sorted(tree):  # the JAX package flattens a dict by sorted key
        arr = np.asarray(tree[key])
        np.save(os.path.join(tmp, key + ".npy"), arr)
        manifest["leaves"][key] = {"shape": list(arr.shape),
                                   "dtype": str(arr.dtype)}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


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


def restore_checkpoint(ckpt_dir: str, step: int) -> dict:
    """Every leaf of step_<step> as ``{key: np.ndarray}``.

    Raises ``ValueError`` for a leaf stored as a view of another dtype
    (the JAX package's ``bfloat16`` leaves).
    """
    src = os.path.join(ckpt_dir, f"step_{step}")
    manifest = read_manifest(ckpt_dir, step)
    out = {}
    for key, meta in manifest["leaves"].items():
        arr = np.load(os.path.join(src, key + ".npy"))
        if str(arr.dtype) != meta["dtype"]:
            raise ValueError(
                f"leaf {key!r} of {src!r} is stored as {arr.dtype} for "
                f"logical dtype {meta['dtype']!r}; view dtypes need "
                f"ml_dtypes, which the port does not use")
        out[key] = arr
    return out


def _host_copy(leaf) -> np.ndarray:
    """A host array that owns its bytes: a tensor is copied off its device
    (or out of its CPU storage, which the writer may go on mutating); a
    numpy leaf is kept as it is."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.asarray(leaf)


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

    def save(self, step: int, tree: dict, extra: dict | None = None) -> None:
        """Write ``tree`` (``{key: array or tensor}``) as step_<step> in the
        background; ``extra`` goes to the manifest as in
        :func:`save_checkpoint`."""
        self.wait()
        host_tree = {k: _host_copy(v) for k, v in tree.items()}

        def work():
            save_checkpoint(self.ckpt_dir, step, host_tree, extra=extra)
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
