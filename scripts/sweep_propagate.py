#!/usr/bin/env python3
"""Time variants of the propagate kernels' design constants on one card.

    python3 scripts/sweep_propagate.py EDGES_NPY [TREE ...]

Run it from a checkout's root. ``csrc/hll_propagate.cu`` holds its design
choices as constants: for the one-panel pass the batch ``kBatch`` and the
block size ``kThreads``; for the two-panel merge (``hll_propagate_into``)
the block size ``kIntoThreads``, the blocks per SM its register budget
must allow on each layout (``kIntoMinBlocksByte``,
``kIntoMinBlocksPacked``), the registers of source rows a lane holds
``kIntoRowRegs`` and the most rows a lane has in flight
``kIntoMaxBatch``. Both run lengths are launcher arguments: the
one-panel pass runs at its autotune fallback (``edge_block``, once the
constant ``kRunEdges``), whose candidates ``kernels.autotune.sweep``
times on the main routing (``autotune_times``, one line a layout), and
every variant of the two-panel merge runs at each of ``RUNS``. A tree
whose one-panel launcher still has the constant is timed as it is.

This script compiles the source once per entry of ``VARIANTS`` (the
constants replaced in a copy under ``build/propagate_sweep/``, each copy
built by its own ``nvcc``, all started together) and, for each ``TREE``
(another checkout or an unpacked ``git archive``, e.g. the parent commit's
``src/repro_torch/csrc`` under ``build/parent``), that tree's source, run
as ``tree:<its directory's name>``: a design that the source no longer
holds is timed from the tree that does. It prints each library's
``nvcc -Xptxas -v`` registers, spills, stack frame and static shared
memory per kernel instantiation (``as_is`` and each tree build every
source of ``csrc/``), and each tree's instantiations beside this tree's
at the autotune fallback (``ptxas fallback`` lines, ``compare_fallback``:
equal or DIFFERS), then times,
as CUDA-event medians over ``REPS`` launches of the launcher alone
(``out`` restored between launches, outside the events):

* the one-panel launchers (rows 3/3p) on the main path's routing: the
  scale-22 graph (RMAT, edge factor 16, seed 0, cached at ``EDGES_NPY``
  by the first run, as ``scripts/time_main_path.py`` caches it), its
  panel built with ``HLLConfig(p=8)`` and the engine's routing;
* the two-panel launchers at the shapes of ``chip_smoke.py`` phase 4,
  shard 0 of 4: ``ring`` (block 1 into shard 0 plus 4,096 self-index
  pairs), ``allgather`` (every edge into shard 0 over all rows),
  ``replica`` (the edges from the 1,024 highest in-degree sources over a
  1,024-row panel), and the control ``ring_l2``: the ring step's edges
  with each source index taken modulo ``L2_ROWS``, so the same segments
  read a source block that fits in L2.

Every variant's output must equal the plain version (or, for the
one-panel pass, the library kernel) bit for bit. Each shape's line gives
its edges, its gather floor (one source row read per edge over
the H100's 3.35 TB/s, ``analysis.roofline.HW``) and its bytes bound
(each distinct source and destination row read once, each destination
row written once, 8 bytes an edge).

Prints the card's name and power limit, then one JSON line; the full
results also go to ``build/propagate_sweep/results.json``. Exits non-zero
without a CUDA device.
"""
from __future__ import annotations

import ctypes
import json
import os
import re
import shutil
import statistics
import subprocess
import sys

REPS = 10
SCALE, EDGE_FACTOR, SEED, P = 22, 16, 0, 8
SHARDS, SELF_PAIRS, REPLICAS, L2_ROWS = 4, 4096, 1024, 65536
RUNS = (1024, 512, 256, 128, 64, 32)
#: name -> {constant: value} replaced in the source; {} is the source as is
VARIANTS = {
    "as_is": {},
    "no_register_cap": {"kIntoMinBlocksByte": "1",
                        "kIntoMinBlocksPacked": "1"},
    "regs64": {"kIntoMinBlocksByte": "4", "kIntoMinBlocksPacked": "4",
               "kIntoRowRegs": "16", "kIntoMaxBatch": "8"},
    "byte_minblocks6": {"kIntoMinBlocksByte": "6"},
    "packed_minblocks8": {"kIntoMinBlocksPacked": "8"},
    "packed_batch8": {"kIntoMaxBatch": "8", "kIntoMinBlocksPacked": "4"},
    "threads128": {"kIntoThreads": "128", "kIntoMinBlocksByte": "16",
                   "kIntoMinBlocksPacked": "12"},
}


def variant_source(text: str, consts: dict[str, str]) -> str:
    """The source with each named ``constexpr`` given a new value."""
    for name, value in consts.items():
        pattern = rf"(constexpr \w+ {name} = )[^;]+;"
        if not re.search(pattern, text):
            raise SystemExit(f"sweep_propagate: constant {name} not found")
        text = re.sub(pattern, rf"\g<1>{value};", text)
    return text


#: ptxas report fields, in print order
PTXAS_FIELDS = ("registers", "spill_stores", "spill_loads", "stack", "smem")


def ptxas_report(log: str) -> dict[str, dict[str, int]]:
    """``-Xptxas -v``'s registers, spill stores and loads, stack frame and
    static shared memory of each kernel instantiation in ``log``, keyed
    ``<kernel><template arguments>`` (e.g. ``hll_propagate_kernel<1, 4,
    1024>``: packed, 4-word lanes, runs of 1,024)."""
    found: dict[str, dict[str, int]] = {}
    name = None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)'?", line)
        if m:
            k = re.search(r"([a-z][a-z_]*_kernel)I((?:L[a-z]+\d+E)+)E",
                          m.group(1))
            name = (f"{k.group(1)}<"
                    + ", ".join(re.findall(r"L[a-z]+(\d+)E", k.group(2)))
                    + ">") if k else m.group(1)
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            found.setdefault(name, {}).update(
                stack=int(m.group(1)), spill_stores=int(m.group(2)),
                spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            s = re.search(r"(\d+) bytes smem", line)
            found.setdefault(name, {}).update(
                registers=int(m.group(1)), smem=int(s.group(1)) if s else 0)
    return {k: v for k, v in found.items() if "registers" in v}


def fmt_ptxas(rec: dict[str, int] | None) -> str:
    return "missing" if rec is None else ", ".join(
        f"{rec.get(f, 0)} {f.replace('_', ' ')}" for f in PTXAS_FIELDS)


def compare_fallback(reports: dict[str, dict], trees: list[str]) -> int:
    """Each tree's kernel instantiations against this tree's at the
    autotune fallback (``as_is``): where a launch shape became a template
    argument (accumulate's edges a thread, propagate's run length, the
    union kernel's sets a block, ``ertl_stats``' pairs a block,
    ``hip_delta``'s block size) and the tree's kernel lacks it, the
    instantiation at the fallback value is compared. Prints one line a
    kernel; returns how many differ or are missing."""
    from repro_torch.kernels.autotune import FALLBACK
    extra = {
        "hll_accumulate_kernel": FALLBACK["accumulate"]["edge_block"] // 32,
        "hll_propagate_kernel": FALLBACK["propagate"]["edge_block"],
        "union_estimate_kernel": FALLBACK["union_estimate"]["set_block"],
        "ertl_stats_kernel": FALLBACK["ertl_stats"]["pair_block"],
        "hip_delta_kernel": FALLBACK["hip_delta"]["row_block"],
    }
    new, bad = reports["as_is"], 0
    for tree in trees:
        name = f"tree:{os.path.basename(os.path.abspath(tree))}"
        for kernel, before in sorted(reports[name].items()):
            base, args = kernel.split("<", 1)
            key = kernel
            if base in extra and kernel not in new:
                key = f"{base}<{args[:-1]}, {extra[base]}>"
            after = new.get(key)
            same = after == before
            bad += not same
            print(f"ptxas fallback {name} {kernel} -> as_is {key}: "
                  f"{fmt_ptxas(before)} | {fmt_ptxas(after)} | "
                  f"{'equal' if same else 'DIFFERS'}", flush=True)
    return bad


def takes_knob(text: str, launcher: str) -> bool:
    """Whether ``launcher``'s C signature in source ``text`` has the
    argument ``_build.KERNELS`` gives it last before the stream (an older
    tree's launcher may lack it)."""
    from repro_torch.kernels import _build
    m = re.search(rf'extern "C" int {launcher}\(([^)]*)\)', text)
    if not m:
        raise SystemExit(f"launcher {launcher} not found")
    return m.group(1).count(",") + 1 == len(_build.KERNELS[launcher])


def build_variants(root: str, trees: list[str]):
    """{name: (library, its two-panel launchers take a run length, its
    one-panel ones too)}, all compiled together
    (``_build.compile_library``), and {name: ``ptxas_report``}."""
    from concurrent.futures import ThreadPoolExecutor
    from pathlib import Path

    from repro_torch.kernels import _build
    csrc = Path(root, "src", "repro_torch", "csrc")
    out = Path(root, "build", "propagate_sweep")
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    shutil.copy(csrc / "common.cuh", out)
    text = (csrc / "hll_propagate.cu").read_text()
    # as_is and each tree build every source (the ptxas comparison);
    # a variant only its propagate source
    jobs = {"as_is": (csrc / "hll_propagate.cu", sorted(csrc.glob("*.cu")),
                      out / "libprop_as_is.so")}
    for name, consts in VARIANTS.items():
        if name != "as_is":
            src = out / f"hll_propagate_{name}.cu"
            src.write_text(variant_source(text, consts))
            jobs[name] = (src, [src], out / f"libprop_{name}.so")
    for tree in trees:
        name = f"tree:{Path(tree).resolve().name}"
        tree_dir = out / name.replace(":", "_")
        shutil.copytree(Path(tree, "src", "repro_torch", "csrc"), tree_dir)
        jobs[name] = (tree_dir / "hll_propagate.cu",
                      sorted(tree_dir.glob("*.cu")),
                      out / f"libprop_{name.replace(':', '_')}.so")
    with ThreadPoolExecutor(len(jobs)) as pool:
        logs = dict(zip(jobs, pool.map(
            lambda job: _build.compile_library(job[1], job[2]),
            jobs.values())))
    libs, reports = {}, {}
    for name, (src, _, path) in jobs.items():
        path.with_suffix(".log").write_text(logs[name])
        reports[name] = ptxas_report(logs[name])
        text = src.read_text()
        takes_run = "run_edges" in text
        one_run = takes_knob(text, "hll_propagate")
        lib = ctypes.CDLL(str(path))
        for kernel in ("hll_propagate", "hll_propagate_packed",
                       "hll_propagate_into", "hll_propagate_into_packed"):
            fn = getattr(lib, kernel)
            types = list(_build.KERNELS[kernel])
            if not (one_run if "into" not in kernel else takes_run):
                types.pop(-2)  # an older launcher has no run length
            fn.argtypes = types
            fn.restype = ctypes.c_int
        libs[name] = (lib, takes_run, one_run)
    return libs, reports


def autotune_times(cells) -> dict:
    """Each block size of ``kernels.autotune.SWEEPS`` timed by a fresh
    ``autotune.sweep`` on each cell's inputs (``(op, layout, label,
    inputs)``, ``inputs`` as ``ops.<op>`` takes them): its wrapper, the
    L2 written over before each call, the median of ``SWEEP_REPS``
    rounds. One line a cell; {"<op> <layout> <label>": {block: ms}}."""
    from repro_torch.kernels import autotune
    out = {}
    for op, layout, label, inputs in cells:
        (name,) = autotune.FALLBACK[op]
        won = autotune.sweep(op, p=P, layout=layout, inputs=inputs,
                             force=True)[name]
        times = autotune.sweep_times(op, p=P, layout=layout,
                                     size=autotune.work_size(op, inputs))
        key = f"{op} {layout} {label}"
        out[key] = {str(c[name]): ms for c, ms in times}
        print(f"autotune {key} {name}: "
              + ", ".join(f"{c[name]} {ms:.4f} ms" for c, ms in times)
              + f"; winner {won}", flush=True)
    autotune.clear_cache()
    return out


def launcher_ms(torch, call, out, out0) -> float:
    """CUDA-event median of ``call()`` over REPS launches, ``out`` set
    back to ``out0`` before each (untimed)."""
    pairs = []
    for _ in range(REPS + 1):
        out.copy_(out0)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        err = call()
        end.record()
        if err != 0:
            raise SystemExit(f"sweep_propagate: cudaError {err}")
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs[1:])


def into_shapes(torch, np, regs, src, dst):
    """{shape: (out0, src_panel, src, dst)}: chip_smoke.py phase 4's three
    shapes of shard 0 of SHARDS, and the ring step over an L2-sized
    source block."""
    from repro_torch.kernels import hll_propagate
    v_loc = regs.shape[0] // SHARDS
    out0 = regs[:v_loc].clone()
    keep = (dst < v_loc) & (src >= v_loc) & (src < 2 * v_loc)
    x = torch.from_numpy(np.random.default_rng(SEED + 7).choice(
        v_loc, SELF_PAIRS, replace=False).astype(np.int32)).to(regs.device)
    s_ring, d_ring = hll_propagate.sort_routing(
        torch.cat([src[keep] - v_loc, x]), torch.cat([dst[keep], x]))
    block = regs[v_loc:2 * v_loc].clone()
    into0 = dst < v_loc
    s_ag, d_ag = src[into0], dst[into0]
    deg = torch.bincount(src.to(torch.int64), minlength=regs.shape[0])
    hot = torch.topk(deg, REPLICAS).indices.sort().values
    hit = torch.isin(s_ag.to(torch.int64), hot)
    slot = torch.searchsorted(hot, s_ag[hit].to(torch.int64)).to(torch.int32)
    return {
        "ring": (out0, block, s_ring, d_ring),
        "allgather": (out0, regs, s_ag, d_ag),
        "replica": (out0, regs[hot].clone(), slot, d_ag[hit].contiguous()),
        "ring_l2": (out0, block[:L2_ROWS].clone(),
                    (s_ring % L2_ROWS).contiguous(), d_ring),
    }


def shape_line(torch, name, out0, panel, s, d) -> dict:
    from repro_torch.analysis.roofline import HW
    hbm = HW().hbm_bw
    w = out0.shape[1]
    e = s.numel()
    info = {"edges": e, "src_rows": panel.shape[0], "out_rows": out0.shape[0],
            "row_bytes": w,
            "gather_floor_ms": e * w / hbm * 1e3,
            "bound_ms": (torch.unique(s).numel() * w
                         + 2 * torch.unique(d).numel() * w + 8 * e)
            / hbm * 1e3}
    print(f"shape {name}: {e} edges, {panel.shape[0]} source rows into "
          f"{out0.shape[0]}, {w}-byte rows; gather floor "
          f"{info['gather_floor_ms']:.4f} ms, bound {info['bound_ms']:.4f} "
          f"ms (bytes)", flush=True)
    return info


def main(edges_path: str, trees: list[str]) -> int:
    root = os.getcwd()
    sys.path.insert(0, os.path.join(root, "src"))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("sweep_propagate: no CUDA device available", file=sys.stderr)
        return 2
    from repro_torch import engine
    from repro_torch.core.hll import HLLConfig
    from repro_torch.graph import generators
    from repro_torch.kernels import _build, autotune, hll_propagate
    from repro_torch.kernels.inputs import directed_routing

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    libs, reports = build_variants(root, trees)
    for name, report in reports.items():
        for kernel, rec in sorted(report.items()):
            print(f"ptxas {name}: {kernel}: {fmt_ptxas(rec)}")
    differ = compare_fallback(reports, trees)
    if not os.path.exists(edges_path):
        os.makedirs(os.path.dirname(os.path.abspath(edges_path)),
                    exist_ok=True)
        np.save(edges_path, generators.rmat(SCALE, EDGE_FACTOR, seed=SEED))
    edges = np.load(edges_path)
    n = 1 << SCALE
    src, dst = directed_routing(edges, torch.device("cuda"))
    stream = torch.cuda.current_stream().cuda_stream
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    results, shapes, blocks = {}, {}, {}
    for layout in ("byte", "packed"):
        regs = engine.build(edges, n, HLLConfig(p=P), layout=layout,
                            device="cuda").regs
        r = 1 << P
        # rows 3/3p, the drift control: the one-panel launchers
        name = _build.kernel_name("hll_propagate", layout)
        want = hll_propagate.hll_propagate(regs, src, dst, layout=layout)
        out = regs.clone()
        for lib_name in ["as_is"] + [k for k in libs if k.startswith("tree:")]:
            lib, _, one_run = libs[lib_name]
            fn = getattr(lib, name)
            extra = ((autotune.FALLBACK["propagate"]["edge_block"],)
                     if one_run else ())
            ms = launcher_ms(torch, lambda: fn(
                regs.data_ptr(), out.data_ptr(), src.data_ptr(),
                dst.data_ptr(), src.numel(), regs.shape[0], r, *extra,
                stream), out, regs)
            if not torch.equal(out, want):
                raise SystemExit(f"{name} {lib_name} differs")
            results[f"{layout}/one_panel/{lib_name}"] = ms
            print(f"{name} {lib_name}: {ms:.4f} ms", flush=True)
        del want, out
        blocks.update(autotune_times([("propagate", layout, "main routing",
                                       (regs, src, dst))]))
        # the two-panel launchers
        name = _build.kernel_name("hll_propagate_into", layout)
        for shape, (out0, panel, s, d) in into_shapes(
                torch, np, regs, src, dst).items():
            shapes[f"{layout}/{shape}"] = shape_line(
                torch, f"{layout}/{shape}", out0, panel, s, d)
            shapes[f"{layout}/{shape}"]["chosen_run"] = \
                hll_propagate.run_edges(s.numel(), n_sms)
            want = hll_propagate.plain_into(out0.clone(), panel, s, d,
                                            layout=layout)
            out = out0.clone()
            for lib_name, (lib, takes_run, _) in libs.items():
                fn = getattr(lib, name)
                for run in RUNS if takes_run else (None,):
                    extra = (run,) if takes_run else ()
                    ms = launcher_ms(torch, lambda: fn(
                        panel.data_ptr(), out.data_ptr(), s.data_ptr(),
                        d.data_ptr(), s.numel(), panel.shape[0],
                        out0.shape[0], r, *extra, stream), out, out0)
                    if not torch.equal(out, want):
                        raise SystemExit(f"{name} {lib_name} run {run} "
                                         f"differs from its plain version "
                                         f"at {shape}")
                    key = f"{layout}/{shape}/{lib_name}/{run}"
                    results[key] = ms
                    print(f"{key}: {ms:.4f} ms", flush=True)
            del want, out
        del regs
        torch.cuda.empty_cache()
    doc = {"card": card, "sms": n_sms, "reps": REPS, "shapes": shapes,
           "ptxas": reports, "ptxas_fallback_differ": differ,
           "results": results, "autotune": blocks}
    with open(os.path.join(root, "build", "propagate_sweep", "results.json"),
              "w") as f:
        json.dump(doc, f, indent=1)
    print(card)
    print(json.dumps({"card": card, "shapes": shapes, "results": results,
                      "autotune": blocks, "ptxas_fallback_differ": differ}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        sys.exit(2)
    sys.exit(main(sys.argv[1], sys.argv[2:]))
