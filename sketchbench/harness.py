"""One run of one benchmark cell, driven by ``BENCHMARK.json``.

Everything particular to a cell is found by name in files of its own:

* ``configs/<config>.json``: the deployment (graph, sketch, layout);
* ``traffic/<traffic>.json``: the mix, data read by the loop it names
  (``loops/<loop>.py``), whose calls take arguments made by
  ``gen/<gen>.py`` and are judged by ``checks/<check>.py``;
* ``limits/<workload>.json``: the limit of every number the cell's
  checks compare;
* ``metrics/<metric>.py``: one reader a metric, end to end or per layer.

A run: set-up (the graph made on the device from the seed and copied to
the host once, the kernel library loaded, the loop's own set-up and its
warm-up steps), then the measured window, then the checks against the
plain reference once the program's state is freed, then the metrics.
Nothing here imports the JAX package; the program is imported from the
checkout's ``src``.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import subprocess
import sys
import time
import types
from dataclasses import dataclass, field
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
#: top-level module names that may not be loaded in a run's process
BANNED_MODULES = ("jax", "jaxlib", "flax", "repro")
#: the float type one step below each a configuration states: the
#: precision the control computes in
CONTROL_BELOW = {"float32": "bfloat16"}


def load_module(path: Path):
    """Import the Python file ``path`` under a name of its own."""
    name = "sketchbench_" + "_".join(
        path.relative_to(BENCH_DIR).with_suffix("").parts).replace(".", "_")
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def read_json(path: Path):
    with open(path, encoding="utf-8") as f:
        return json.load(f)


@dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def find_cell(root: Path, workload: str) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json`` (``KeyError`` for
    an unknown name)."""
    bench = read_json(root / "BENCHMARK.json")
    entry = {w["name"]: w for w in bench["workloads"]}[workload]
    config = {c["name"]: c for c in bench["configs"]}[entry["config"]]
    return Cell(
        name=workload, chips=int(entry["chips"]),
        config=read_json(root / config["file"]),
        traffic=read_json(BENCH_DIR / "traffic" / f"{entry['traffic']}.json"),
        limits=read_json(BENCH_DIR / "limits" / f"{workload}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, workload)])


class Device:
    """The device a run drives: synchronize and peak memory on the card,
    no-ops on the CPU (which only the tests use)."""

    def __init__(self, torch, kind: str):
        self.torch = torch
        self.kind = kind
        self.is_cuda = kind == "cuda"

    def sync(self) -> None:
        if self.is_cuda:
            self.torch.cuda.synchronize()

    def reset_peak(self) -> None:
        if self.is_cuda:
            self.torch.cuda.reset_peak_memory_stats()

    def peak_bytes(self) -> int:
        return int(self.torch.cuda.max_memory_allocated()) if self.is_cuda \
            else 0

    def free(self) -> None:
        gc.collect()
        if self.is_cuda:
            self.torch.cuda.empty_cache()


@dataclass
class CallRecord:
    """One call of a step: its spec, arguments and result."""

    spec: dict
    args: list
    kwargs: dict
    result: object = None


@dataclass
class Step:
    """One step (a request or a job) of the loop."""

    start: float = 0.0
    end: float = 0.0
    work: float = 0.0
    spans: dict = field(default_factory=dict)
    calls: list = field(default_factory=list)
    profiled: bool = False
    failed: bool = False


class Context:
    """What a loop, a generator and a check see of the run."""

    def __init__(self, root: Path, cell: Cell, seed: int, device: Device,
                 program):
        self.cell = cell
        self.config = cell.config
        self.seed = int(seed)
        self.device = device
        self.program = program
        self.root = root
        self.edges = None   # canonical edges, host int32[m, 2]
        self.n = 0
        self.cache = {}     # what generators keep between steps

    # ---------------------------------------------------------- inputs
    def make_graph(self) -> None:
        """The configuration's graph, made on the device from the seed and
        copied to the host once, as the program and the reference take
        it."""
        cfg = self.config
        gen = load_module(BENCH_DIR / "gen" / f"{cfg['generator']}_torch.py")
        e = gen.rmat(cfg["scale"], cfg["edge_factor"], self.seed, cfg["a"],
                     cfg["b"], cfg["c"], self.device.kind)
        self.edges = e.cpu().numpy()
        self.n = 1 << cfg["scale"]
        del e
        self.device.free()

    def arg(self, spec, step: int):
        """A call argument: a literal, or ``{"gen": name, ...}`` made by
        ``gen/<name>.py``'s ``make(spec, ctx, step)``."""
        if isinstance(spec, dict) and "gen" in spec:
            return load_module(BENCH_DIR / "gen" / f"{spec['gen']}.py").make(
                spec, self, step)
        return spec

    def reserve(self, calls: list, steps: int) -> None:
        """Let each generator of ``calls``' arguments make those of steps
        0 .. steps - 1 now, in set-up (``gen/<name>.py``'s optional
        ``reserve(spec, ctx, steps)``)."""
        for spec in calls:
            for a in (*spec.get("args", []), *spec.get("kwargs", {}).values()):
                if isinstance(a, dict) and "gen" in a:
                    gen = load_module(BENCH_DIR / "gen" / f"{a['gen']}.py")
                    if hasattr(gen, "reserve"):
                        gen.reserve(a, self, steps)

    # ---------------------------------------------------------- program
    def build(self):
        """``engine.build`` of the whole graph under the configuration."""
        cfg = self.config
        sk = dict(cfg["sketch"])
        fam = self.program.registry.family(sk.pop("family"))
        return self.program.engine.build(
            self.edges, self.n, fam.config_from_dict(sk),
            layout=cfg["layout"], impl=cfg["impl"], backend=cfg["backend"],
            device=self.device.kind)


def _program(root: Path):
    """Import the program under test from the checkout's ``src``."""
    src = str(root / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    from repro_torch import engine
    from repro_torch.kernels import _build, registry
    return types.SimpleNamespace(engine=engine, registry=registry,
                                 build_lib=_build)


def banned_modules() -> list[str]:
    """Top-level names of loaded modules that the run may not load."""
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(BANNED_MODULES))


def _card(torch, chips: int) -> dict:
    kind = torch.cuda.get_device_name(0)
    try:
        limit = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        limit = "not read"
    return {"platform": "gpu", "kind": kind, "count": chips,
            "power_limit": limit}


@dataclass
class Run:
    """What the metric readers read."""

    cell: Cell
    ctx: Context
    setup_s: float
    window_start: float
    window_end: float
    steps: list
    peak_bytes: int
    device: dict
    trace: object = None

    @property
    def window_s(self) -> float:
        return self.window_end - self.window_start

    @property
    def profiled(self) -> list:
        return [s for s in self.steps if s.profiled]


def run_cell(root: Path, workload: str, seed: int, seconds: float,
             trace: bool, *, device: str = "cuda", t_start: float | None = None,
             cell: Cell | None = None, controls: bool = False) -> dict:
    """One run of ``workload``; returns the result's fields (``checks``
    last). ``cell`` replaces the one read from ``BENCHMARK.json`` (the
    tests' small sizes); ``controls`` also judges the low-precision
    reference in the program's place (``result["control"]``)."""
    t_start = time.perf_counter() if t_start is None else t_start
    import torch
    cell = cell or find_cell(root, workload)
    dev = Device(torch, device)
    prog = _program(root)
    ctx = Context(root, cell, seed, dev, prog)
    ctx.make_graph()
    nvcc_s = 0.0
    if dev.is_cuda:
        t = time.perf_counter()
        prog.build_lib.library()
        nvcc_s = time.perf_counter() - t
    loop = load_module(BENCH_DIR / "loops" / f"{cell.traffic['loop']}.py")
    state = loop.setup(ctx, cell.traffic, seconds)
    window = loop.run(ctx, cell.traffic, state, seconds, trace, t_start)
    card = _card(torch, cell.chips) if dev.is_cuda else {
        "platform": "cpu", "kind": "cpu", "count": 0}
    card["memory_peak_bytes"] = window.peak_bytes
    run = Run(cell=cell, ctx=ctx, setup_s=window.setup_s,
              window_start=window.start, window_end=window.end,
              steps=window.steps, peak_bytes=window.peak_bytes, device=card,
              trace=window.trace)
    checks, control = judge(ctx, window, state, controls)
    metrics = read_metrics(run, cell.per_layer if trace else cell.end_to_end)
    attempted = len(window.steps)
    failed = sum(s.failed for s in window.steps)
    correct = bool(checks) and all(
        c["value"] <= c["limit"] for c in checks.values())
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": card}
    if window.trace is not None:
        card["busy_s"] = window.trace.busy_s
        card["window_s"] = window.trace.window_s
        out["breakdown"] = window.trace.breakdown()
    out["nvcc_s"] = nvcc_s
    out["step_s"] = [s.end - s.start for s in window.steps]
    if control is not None:
        out["control"] = control
    out["checks"] = checks
    found = banned_modules()  # after the checks and the readers, too
    if found:
        raise SystemExit(f"loaded by the run's end: {', '.join(found)}")
    return out


def judge(ctx: Context, window, state, controls: bool):
    """Compare the last step's outputs with the plain reference, once the
    program's state is freed: ``({name: {value, limit}}, control)``.

    A value that is not a number reads as infinite; a number the cell's
    limits lack raises. With ``controls``, the reference computed one
    precision lower is judged in the program's place too (``{name:
    value}``)."""
    import torch

    from sketchbench.reference import Reference
    last = window.steps[-1] if window.steps else None
    judged = []
    if last is not None and not last.failed:
        for rec in last.calls:
            name = rec.spec.get("check")
            if name:
                chk = load_module(BENCH_DIR / "checks" / f"{name}.py")
                judged.append((chk, rec, chk.capture(rec, state.engine)))
    state.engine = None
    ctx.device.free()
    ref = Reference(ctx.edges, ctx.n, ctx.config, ctx.device.kind)
    values = {}
    for chk, rec, got in judged:
        values.update(chk.compare(got, rec, ref))
    checks = {name: {"value": value if value == value else float("inf"),
                     "limit": float(ctx.cell.limits[name])}
              for name, value in values.items()}
    control = None
    if controls:
        low = ref.lower(getattr(torch, CONTROL_BELOW[ctx.config["floats"]]))
        control = {}
        for chk, rec, _ in judged:
            control.update(chk.compare(chk.control(rec, low), rec, ref))
    del judged
    ref.free()
    ctx.device.free()
    return checks, control


def read_metrics(run: Run, metrics: list) -> dict:
    """Each metric's reader on the run; a reader that finds nothing to
    read returns None and the metric is left out."""
    out = {}
    for m in metrics:
        reader = load_module(BENCH_DIR / "metrics" / f"{m['name']}.py")
        value = reader.read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
