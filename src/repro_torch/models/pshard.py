"""Activation sharding hints (port of ``repro.models.pshard``).

The reference pins activations at block boundaries with
``with_sharding_constraint`` so that GSPMD's propagation cannot resolve
conflicting sources the wrong way (the embedding table's data-axis
sharding un-sharding the batch). The mesh context is process-global, set
by a launcher or the dry-run; with none set every hint returns its input.

One process holds the whole tensor here, so a hint with a mesh set
places nothing: it checks what ``NamedSharding`` would reject (an axis
name that is not in the mesh, an axis used twice, a spec longer than the
tensor's rank), raises ``ValueError`` on those and returns ``x`` itself.
It does not check divisibility: GSPMD pads a dimension that does not
divide. The call sites are the reference's (``models.transformer``,
``models.steps``), so a later multi-card placement finds them in place.
"""
from __future__ import annotations

__all__ = ["set_mesh", "clear_mesh", "num_batch_shards", "hint",
           "hint_moe_dispatch"]

_MESH = None
_BATCH_AXES: tuple | None = None
_SEQ_AXES: tuple | None = None   # long_500k: shard L instead of B


def set_mesh(mesh, batch_axes: tuple, seq_axes: tuple = ()) -> None:
    """Set the process's mesh (``launch.mesh.Mesh``) and the axes the
    batch (or, for batch-1 long-context decode, the sequence) is split
    over."""
    global _MESH, _BATCH_AXES, _SEQ_AXES
    _MESH = mesh
    _BATCH_AXES = tuple(batch_axes) or None
    _SEQ_AXES = tuple(seq_axes) or None


def clear_mesh() -> None:
    global _MESH, _BATCH_AXES, _SEQ_AXES
    _MESH = _BATCH_AXES = _SEQ_AXES = None


def num_batch_shards() -> int:
    """Product of the batch-axis sizes (1 when no mesh context is set):
    the MoE groups a token dispatch would be split into, one a data
    shard."""
    if _MESH is None or _BATCH_AXES is None:
        return 1
    n = 1
    for a in _BATCH_AXES:
        n *= _MESH.shape[a]
    return n


def _check(x, spec: tuple):
    """``x`` itself once ``spec`` names only the mesh's axes, each once,
    in no more entries than ``x`` has dimensions."""
    names = [a for entry in spec if entry is not None
             for a in (entry if isinstance(entry, tuple) else (entry,))]
    unknown = [a for a in names if a not in _MESH.axis_names]
    if unknown:
        raise ValueError(f"sharding hint {spec}: axes {unknown} are not in "
                         f"the mesh {tuple(_MESH.axis_names)}")
    if len(set(names)) != len(names):
        raise ValueError(f"sharding hint {spec}: an axis is used twice")
    if len(spec) > x.ndim:
        raise ValueError(f"sharding hint {spec} has {len(spec)} entries for "
                         f"a tensor of rank {x.ndim}")
    return x


def hint(x, kind: str):
    """Constrain activation sharding. kinds:
    btd: (B, L, D)   bt: (B, L)   btv: (B, L, Vshard)
    bthd: (B, L, H, hd)
    """
    if _MESH is None:
        return x
    b, s = _BATCH_AXES, _SEQ_AXES
    spec = {
        "btd": (b, s, None),
        "bt": (b, s),
        "btv": (b, s, "model"),
        "bthd": (b, s, "model", None),
    }[kind]
    return _check(x, spec)


def hint_moe_dispatch(x, num_experts: int):
    """(G, E, C, D) dispatch buffer: G on the batch axes, E on 'model' when
    the expert count divides the model axis (EP), else replicated."""
    if _MESH is None or _BATCH_AXES is None:
        return x
    e_spec = "model" if num_experts % _MESH.shape["model"] == 0 else None
    return _check(x, (_BATCH_AXES, e_spec, None, None))
