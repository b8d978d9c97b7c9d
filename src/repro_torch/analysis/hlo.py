"""HLO text analysis: collective-op extraction for the roofline (port of
``repro.analysis.hlo``, pure Python, the same parsing and formulas).

``compiled.as_text()`` (post-SPMD-partitioning) carries per-partition
shapes. For each collective we record the RESULT shape bytes and the
replica-group size, then convert to per-device *wire* bytes with the
standard ring formulas:

  all-reduce          2 * S * (P-1)/P      (reduce-scatter + all-gather)
  all-gather          S * (P-1)/P          (S = gathered result per device)
  reduce-scatter      S * (P-1)            (S = scattered result)
  all-to-all          S * (P-1)/P
  collective-permute  S                    (point-to-point)

These are the bytes every device must push through its links, which is
what the collective roofline term divides by link bandwidth
(``analysis.roofline.HW.link_bw``). The dry-run (``launch.dryrun``) has
no compiled HLO: it derives its collective list from the sharding rules
and feeds it through :func:`collective_wire_bytes`.
"""
from __future__ import annotations

import re
from collections import defaultdict
from dataclasses import dataclass

__all__ = ["parse_collectives", "collective_wire_bytes", "Collective"]

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8,
}

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")

# result type: one or more "dtype[1,2,3]" chunks before " <op-name>("
_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")
_GROUPS_RE = re.compile(r"replica_groups=\{\{([\d,]+)\}")
_GROUPS_IOTA_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]")


@dataclass
class Collective:
    kind: str
    result_bytes: int
    group_size: int
    count: int = 1


def _shape_bytes(text: str) -> int:
    total = 0
    for dt, dims in _SHAPE_RE.findall(text):
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def parse_collectives(hlo_text: str, default_group: int) -> list[Collective]:
    out: list[Collective] = []
    for line in hlo_text.splitlines():
        stripped = line.strip()
        if not stripped or stripped.startswith("//"):
            continue
        for kind in _COLLECTIVES:
            token = f" {kind}("
            alt = f" {kind}-start("
            if token in stripped or alt in stripped:
                lhs = stripped.split(token if token in stripped else alt)[0]
                # lhs: "%name = <result type>" — parse shapes after '='
                rhs = lhs.split("=", 1)[-1]
                rb = _shape_bytes(rhs)
                g = default_group
                gm = _GROUPS_RE.search(stripped)
                if gm:
                    g = len(gm.group(1).split(","))
                else:
                    gi = _GROUPS_IOTA_RE.search(stripped)
                    if gi:
                        g = int(gi.group(2))
                if kind == "collective-permute":
                    g = 2  # point-to-point
                if rb > 0:
                    out.append(Collective(kind, rb, max(g, 1)))
                break
    return out


def collective_wire_bytes(colls: list[Collective]) -> tuple[float, dict]:
    """Per-device wire bytes total and a per-kind breakdown."""
    per_kind: dict = defaultdict(float)
    for c in colls:
        p = max(c.group_size, 1)
        s = float(c.result_bytes)
        if c.kind == "all-reduce":
            wire = 2.0 * s * (p - 1) / p
        elif c.kind == "all-gather":
            wire = s * (p - 1) / p
        elif c.kind == "reduce-scatter":
            wire = s * (p - 1)
        elif c.kind == "all-to-all":
            wire = s * (p - 1) / p
        else:  # collective-permute
            wire = s
        per_kind[c.kind] += wire
    return float(sum(per_kind.values())), dict(per_kind)
