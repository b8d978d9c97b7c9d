"""Check: the registers of the engine the last step built.

Exact: the number of registers (one a register, the packed layout's two
nibbles a byte read apart) that differ from the reference panel. The
hash, the accumulation and the packing are judged here.
"""
from __future__ import annotations

from sketchbench.reference.sketch import unpack_split_half


#: rows compared at a time
_BLOCK = 1 << 20


def capture(record, engine):
    """(layout, the program's register rows of the n true rows) on the
    device (a copy: the engine is freed before the reference runs)."""
    return engine.layout, engine.regs[: engine.n].clone()


def control(record, ref):
    """The low-precision reference's registers (exact: no float in them)."""
    return "byte", ref.panel()


def compare(got, record, ref) -> dict:
    """{"reg_mismatch": registers that differ from the reference's}."""
    layout, regs = got
    want = ref.panel()
    bad = 0
    for s in range(0, want.shape[0], _BLOCK):
        rows = regs[s:s + _BLOCK]
        if layout == "packed":
            rows = unpack_split_half(rows)
        bad += int((rows != want[s:s + _BLOCK]).sum())
    return {"reg_mismatch": bad}
