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
``ml_dtypes`` and refuses such a leaf with ``ValueError``. The
background writer (``AsyncCheckpointer``) is not ported yet (ROADMAP).

The sketch family guard lives here too: register bytes are
family-portable, their meaning is not, so restoring or merging across
families raises :class:`FamilyMismatch`.
"""
from __future__ import annotations

import json
import os
import shutil

import numpy as np

__all__ = ["save_checkpoint", "restore_checkpoint", "read_manifest",
           "latest_step", "FamilyMismatch", "manifest_family",
           "require_family"]


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
