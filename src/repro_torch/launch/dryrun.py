"""Multi-pod dry-run: every (arch x shape x mesh) cell's specs, memory,
collectives and roofline, derived without a device (port of
``repro.launch.dryrun``).

    python -m repro_torch.launch.dryrun --arch qwen2-72b --shape train_4k
        [--multi-pod] [--out build/dryrun]
    python -m repro_torch.launch.dryrun --all [--out build/dryrun]

The dry-run runs on ``meta`` tensors only: it needs no card, never
initialises CUDA, and is the one launcher of the port that does not
default to the card. The production meshes (``launch.mesh``) are built
over 256 or 512 placeholder devices, where the reference forces 512 host
devices on XLA. ``--all`` sweeps every cell in one process (nothing is
compiled, so no cell needs a process of its own) and ends with one line,
``DRYRUN SWEEP {json}``, that counts the cells and reports whether CUDA
was initialised.

Per cell, :func:`run_cell` records into ``<out>/<arch>__<shape>__<mesh>.json``:

1. ``cell_is_applicable``'s skip and its reason, or else
2. ``mesh_shape``; ``input_specs``' stand-ins and specs for every input;
3. ``memory``: per-device bytes of the parameters, the AdamW moments
   (train), the batch, the caches and the scalars, from the sharding
   rules (``models.sharding.bytes_per_device``: each sharded dimension
   divided by its axes' sizes, rounded up, as GSPMD pads), not from XLA;
4. the analytic ``cell_costs`` (FLOPs useful and padded, bytes a device,
   parameters) and ``roofline_terms`` on ``hw`` (default: the H100 SXM
   of ``analysis.roofline.HW``), which the record names;
5. ``collectives``: XLA's compiled HLO has no counterpart here, so the
   list is derived from the sharding rules (:func:`derive_collectives`)
   and fed through ``analysis.hlo.collective_wire_bytes``.

The derivation, per step, for each stacked leaf one collective a period
(a group of one moves nothing and is left out). ``T`` is a device's
tokens: its batch shard (``ceil(batch / data shards)``, 1 for batch-1
decode) times the sequence (1 in decode; whisper's encoder blocks use
the encoder's frames and do not run in decode). Train runs a forward,
remat's recompute of it (``remat != "none"``) and a backward:

* an all-gather of every FSDP-sharded parameter over its data axes,
  result the parameter with only its 'model' sharding left; once in
  serving, twice in train (forward, backward);
* train: a reduce-scatter of each such gradient over the same axes,
  result the device's shard; and an all-reduce over the data axes of
  each gradient of a parameter not sharded over them;
* an all-reduce over 'model' of each row-parallel product's output
  (``T x d_model`` activations: attention and cross-attention ``o``,
  dense and expert-TP ``down``, Mamba ``out_proj``) in each pass, and of
  the vocab-parallel embedding's output once a step;
* for an expert-parallel MoE layer (``E % model == 0``), an all-to-all
  over 'model' of the device's share of the dispatch buffer
  (``E x C x d_model / model``, C the capacity of T tokens: the model
  group holds its data shard's tokens once, split among its devices) and
  one of the combine, in each pass.

The collective roofline term divides these wire bytes by
``HW.link_bw``. The list is a model of the rules; it is not compared
with XLA's.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback

import torch

from repro_torch.analysis.flops import cell_costs
from repro_torch.analysis.hlo import Collective, collective_wire_bytes
from repro_torch.analysis.roofline import HW, roofline_terms
from repro_torch.configs import ARCHS, SHAPES
from repro_torch.configs.registry import cell_is_applicable
from repro_torch.launch.mesh import make_production_mesh, placeholder_devices
from repro_torch.models import sharding
from repro_torch.models.config import ModelConfig, ShapeConfig
from repro_torch.models.layers import dtype_of

__all__ = ["run_cell", "derive_collectives", "sweep", "main", "OUT",
           "SWEEP_SHAPES"]

OUT = os.path.join("build", "dryrun")
SWEEP_SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
_ROW_PARALLEL = ("o", "down", "out_proj")


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _leaf_bytes(leaf, spec, mesh, keep=lambda a: True) -> int:
    """Device bytes of ``leaf`` under ``spec`` with only the axes that
    ``keep`` admits still splitting it."""
    dims = []
    for i, d in enumerate(leaf.shape):
        axes = [a for a in _axes(spec[i] if i < len(spec) else None)
                if keep(a)]
        dims.append(-(-d // math.prod(mesh.shape[a] for a in axes)))
    return math.prod(dims) * leaf.element_size()


def derive_collectives(cfg: ModelConfig, shape: ShapeConfig, mesh,
                       params, specs) -> list[Collective]:
    """One step's collectives from the parameter specs (the module
    docstring states the derivation)."""
    data_axes = sharding.batch_axes(mesh)
    data = math.prod(mesh.shape[a] for a in data_axes)
    model = mesh.shape["model"]
    train = shape.kind == "train"
    shard_seq = shape.kind == "decode" and shape.global_batch == 1
    b_local = 1 if shard_seq else -(-shape.global_batch // data)
    seq = 1 if shape.kind == "decode" else shape.seq_len
    forwards = 1 + (train and cfg.remat != "none")
    passes = forwards + train           # forward(s) and the backward
    act = torch.empty((), dtype=dtype_of(cfg.dtype)).element_size()
    out: list[Collective] = []

    def emit(kind, nbytes, group, times):
        if group > 1 and nbytes > 0:
            out.extend(Collective(kind, int(nbytes), group)
                       for _ in range(times))

    for path, leaf, spec in sharding.leaves_with_specs(params, specs):
        names = [str(k) for k in path]
        stacked = names[0] == "blocks" or names[:2] == ["encoder", "blocks"]
        periods = leaf.shape[0] if stacked else 1
        if names[0] == "encoder" and shape.kind == "decode":
            continue                    # the encoder ran in the prefill
        tokens = b_local * (cfg.encoder_seq if names[0] == "encoder"
                            else seq)
        fsdp = [a for e in spec for a in _axes(e) if a in data_axes]
        if fsdp:
            group = math.prod(mesh.shape[a] for a in fsdp)
            gathered = _leaf_bytes(leaf, spec, mesh,
                                   lambda a: a not in data_axes) // periods
            emit("all-gather", gathered, group, periods * (1 + train))
            if train:
                emit("reduce-scatter", _leaf_bytes(leaf, spec, mesh)
                     // periods, group, periods)
        elif train:
            emit("all-reduce", _leaf_bytes(leaf, spec, mesh) // periods,
                 data, periods)
        lead = 1 if stacked else 0
        # the dimension a row-parallel product contracts over 'model'
        contraction = ()
        if leaf.ndim - lead == 3 and names[-1] in ("gate", "up", "down"):
            if names[-1] == "gate" and "model" in _axes(spec[lead]):  # EP
                e, k = cfg.num_experts, cfg.num_experts_per_tok
                cap = max(int(tokens // e * k * cfg.capacity_factor) + 1, k)
                emit("all-to-all", e * cap * cfg.d_model * act // model,
                     model, periods * 2 * passes)
            if names[-1] == "down":             # expert TP: (E, F, D)
                contraction = _axes(spec[lead + 1])
        elif leaf.ndim - lead >= 2 and (
                names[0] == "embed" or any(n in names for n in _ROW_PARALLEL)):
            contraction = _axes(spec[lead])
        if "model" in contraction:
            emit("all-reduce", tokens * cfg.d_model * act, model,
                 periods * (1 if names[0] == "embed" else passes))
    return out


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: str,
             hw: HW = HW()) -> dict:
    """One cell's record (the module docstring lists its fields); a cell
    ``cell_is_applicable`` rules out is ``ok`` and ``skipped``. ``out_dir``
    is the reference's argument; :func:`main` writes the record there."""
    mesh_name = "multi_pod" if multi_pod else "single_pod"
    record: dict = {"arch": arch, "shape": shape_name, "mesh": mesh_name}
    runs, reason = cell_is_applicable(arch, shape_name)
    if not runs:
        record.update(ok=True, skipped=True, reason=reason)
        return record

    cfg = ARCHS[arch]
    shape = SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod,
                                devices=placeholder_devices(
                                    512 if multi_pod else 256))
    record["mesh_shape"] = {k: int(v) for k, v in mesh.shape.items()}
    chips = mesh.size
    record["hw"] = {"name": "NVIDIA H100 SXM" if hw == HW() else "custom",
                    **dataclasses.asdict(hw)}

    specs = sharding.input_specs(cfg, shape, mesh)
    per_input = {k: sharding.bytes_per_device(s, sp, mesh)
                 for k, (s, sp) in specs.items()}
    record["memory"] = {
        "source": "sharding rules on meta stand-ins "
                  "(models.sharding.bytes_per_device), not XLA",
        "bytes_per_dev": per_input,
        "total_bytes_per_dev": sum(per_input.values()),
    }
    colls = derive_collectives(cfg, shape, mesh, *specs["params"])
    wire, per_kind = collective_wire_bytes(colls)
    record["collectives"] = {
        "source": "derived from the sharding rules (launch.dryrun "
                  "docstring), not XLA's HLO",
        "count": len(colls),
        "total_wire_bytes_per_dev": wire,
        "per_kind_wire_bytes": per_kind,
    }

    costs = cell_costs(cfg, shape, chips)
    record["flops_useful_global"] = costs.flops_useful_global
    record["flops_padded_global"] = costs.flops_padded_global
    record["bytes_per_dev_analytic"] = costs.bytes_per_dev
    record["params_total"] = costs.params_total
    record["params_bytes_per_dev"] = costs.params_bytes_per_dev
    flops_dev = costs.flops_padded_global / chips
    record["roofline"] = roofline_terms(flops_dev, costs.bytes_per_dev,
                                        wire, hw)
    record["flops_ratio_useful"] = (
        costs.flops_useful_global / costs.flops_padded_global)
    record["ok"] = True
    return record


def _run_and_write(arch: str, shape: str, multi_pod: bool, out: str
                   ) -> dict:
    """One cell: its record written as JSON and its ``DRYRUN`` line
    printed; an exception is recorded as a failure."""
    mesh_name = "multi_pod" if multi_pod else "single_pod"
    path = os.path.join(out, f"{arch}__{shape}__{mesh_name}.json")
    try:
        record = run_cell(arch, shape, multi_pod, out)
    except Exception:
        record = {"arch": arch, "shape": shape, "mesh": mesh_name,
                  "ok": False, "error": traceback.format_exc()}
    with open(path, "w") as f:
        json.dump(record, f, indent=2, default=str)
    status = ("SKIP" if record.get("skipped")
              else "OK" if record.get("ok") else "FAIL")
    print(f"DRYRUN {status} {arch} {shape} {mesh_name} -> {path}",
          flush=True)
    if not record.get("ok"):
        print(record.get("error", ""), flush=True)
    return record


def sweep(out: str) -> dict:
    """Every (arch x shape x mesh) cell, in this process; returns the
    counts the ``DRYRUN SWEEP`` line prints."""
    t0 = time.perf_counter()
    counts = {"cells": 0, "ok": 0, "skip": 0, "fail": 0}
    for multi in (False, True):
        for arch in sorted(ARCHS):
            for shape in SWEEP_SHAPES:
                rec = _run_and_write(arch, shape, multi, out)
                counts["cells"] += 1
                counts["skip" if rec.get("skipped") else
                       "ok" if rec.get("ok") else "fail"] += 1
    counts["seconds"] = round(time.perf_counter() - t0, 2)
    counts["cuda_initialized"] = torch.cuda.is_initialized()
    return counts


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=sorted(ARCHS))
    ap.add_argument("--shape", choices=sorted(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="sweep every arch x shape x mesh cell")
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)

    if args.all:
        counts = sweep(args.out)
        print(f"DRYRUN SWEEP {json.dumps(counts)}", flush=True)
        if counts["fail"]:
            raise SystemExit(1)
        return
    if args.arch is None or args.shape is None:
        ap.error("--arch and --shape are required without --all")
    if not _run_and_write(args.arch, args.shape, args.multi_pod,
                          args.out).get("ok"):
        raise SystemExit(1)


if __name__ == "__main__":
    main()
