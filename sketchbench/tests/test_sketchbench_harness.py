"""The harness on the CPU at small sizes: sound runs are correct, the
control and every fault a cell can have are not, a new configuration,
traffic mix and metric are found by their files alone, and a run refuses
to report without its cards, its program or with the JAX package loaded.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

from conftest import ROOT, run_small
from repro_torch.core import intersection
from repro_torch.engine import base, local, plans
from sketchbench import harness

CELLS = ("g500-22.pairs", "g500-24p.hops", "g500-22.hops")


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_sound_run_is_correct(workload, trace):
    out = run_small(workload, trace=trace)
    assert out["correct"] and out["attempted"] >= 1 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    assert set(out["checks"]) == set(harness.find_cell(ROOT,
                                                       workload).limits)
    cell = harness.find_cell(ROOT, workload)
    want = cell.per_layer if trace else cell.end_to_end
    assert set(out["metrics"]) <= {m["name"] for m in want}
    if not trace:
        assert "setup_s" in out["metrics"]


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("seed", [1, 2 ** 31 + 2, 7])
def test_control_is_not_correct(workload, seed):
    """The reference one precision lower, in the program's place, fails one
    of the cell's numbers at least."""
    out = run_small(workload, seed=seed, controls=True)
    assert out["correct"]
    assert any(v > out["checks"][k]["limit"]
               for k, v in out["control"].items())


def _mean_over_half(cfg, kernels, method, iters):
    plan = _PLANS["intersection"](cfg, kernels, method, iters)

    def broken(regs, ids):
        half = ids.shape[0] // 2
        out = plan(regs, ids[:half])
        return torch_cat([out, out.mean().expand(ids.shape[0] - half)])
    return broken


def torch_cat(parts):
    import torch
    return torch.cat(parts)


_PLANS = {"intersection": plans.build_intersection_plan}


def _alter_one_answer(fn):
    def broken(self, *args, **kwargs):
        out = fn(self, *args, **kwargs).copy()
        out[out.argmax()] *= 1.05
        return out
    return broken


def _alter_one_estimate(fn):
    def broken(self, panel):
        out = fn(self, panel).copy()
        out[out.argmax()] *= 1.01
        return out
    return broken


FAULTS = {
    # a step that returns its state unchanged
    ("g500-24p.hops", "propagate returns its input"): (
        local.LocalEngine, "_propagate",
        lambda orig: lambda self, regs, schedule: regs.clone()),
    ("g500-22.pairs", "Newton returns its start"): (
        intersection, "_newton_solve",
        lambda orig: lambda theta0, stats, q, r, iters: theta0),
    # half of the batch left out
    ("g500-24p.hops", "half of each ingest chunk"): (
        local.LocalEngine, "_accumulate_block",
        lambda orig: lambda self, chunk: orig(self, chunk[: len(chunk) // 2])),
    ("g500-22.pairs", "half the pairs, the rest their mean"): (
        plans, "build_intersection_plan", lambda orig: _mean_over_half),
    # an answer altered where it is produced
    ("g500-24p.hops", "one estimate 1% off"): (
        base.SketchEngine, "_estimate_panel", _alter_one_estimate),
    ("g500-22.pairs", "one T~ 5% off"): (
        base.SketchEngine, "_intersection_presplit", _alter_one_answer),
}


@pytest.mark.parametrize("workload,fault", list(FAULTS),
                         ids=[f"{w}-{f}" for w, f in FAULTS])
def test_fault_is_not_correct(workload, fault, monkeypatch):
    owner, name, make = FAULTS[(workload, fault)]
    monkeypatch.setattr(owner, name, make(getattr(owner, name)))
    plans.global_cache().clear()
    try:
        out = run_small(workload)
    finally:
        plans.global_cache().clear()
    assert not out["correct"], out["checks"]


def _copy_benchmark(dst):
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    shutil.copytree(ROOT / "sketchbench", dst / "sketchbench",
                    ignore=shutil.ignore_patterns("__pycache__"))


def test_new_config_traffic_and_metric_are_found(tmp_path):
    """A configuration, a traffic mix and a per-layer metric added as files
    and entries alone, in a copy of the benchmark."""
    _copy_benchmark(tmp_path)
    (tmp_path / "src").symlink_to(ROOT / "src")
    sb = tmp_path / "sketchbench"
    cfg = json.loads((sb / "configs" / "graph500-22.json").read_text())
    cfg.update(name="dummy-9", scale=9)
    (sb / "configs" / "dummy-9.json").write_text(json.dumps(cfg))
    (sb / "traffic" / "dummy.json").write_text(json.dumps({
        "loop": "closed", "engine": "setup", "work": 1, "warmup_steps": 1,
        "profile_steps": 1,
        "calls": [{"call": "degrees", "span": "degrees"},
                  {"call": "build", "span": "build", "check": "registers"}]}))
    (sb / "metrics" / "dummy_ms.py").write_text(
        "def read(run):\n    return 1e3 * run.window_s / len(run.steps)\n")
    (sb / "limits" / "dummy.cell.json").write_text('{"reg_mismatch": 0}')
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "dummy-9", "source": "a test",
                             "file": "sketchbench/configs/dummy-9.json",
                             "reduced": ["scale"], "why": "a test"})
    bench["workloads"].append({"name": "dummy.cell", "config": "dummy-9",
                               "traffic": "dummy", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "dummy_ms", "unit": "ms",
                               "better": "lower", "source": "host_clock",
                               "layer": "engine", "moves": "setup_s",
                               "workloads": ["dummy.cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import sys, json; sys.path.insert(0, '.');"
            "from pathlib import Path; from sketchbench import harness;"
            "print(json.dumps(harness.run_cell(Path('.').resolve(), "
            "'dummy.cell', 5, 0.2, True, device='cpu')))")
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"]
    assert "dummy_ms" in out["metrics"]


def _run_py(cwd, fake_card: bool):
    """run.py in ``cwd``; with ``fake_card`` the card check is told that a
    card is there (the CPU then fails further on)."""
    pre = ("import torch; torch.cuda.is_available = lambda: True;"
           "torch.cuda.device_count = lambda: 1;") if fake_card else ""
    code = (f"import sys, runpy; {pre} sys.argv = ['run.py', '--workload', "
            "'g500-22.pairs', '--seed', '3', '--seconds', '1', '--trace', "
            "'0']; runpy.run_path('sketchbench/run.py', run_name='__main__')")
    env = dict(os.environ, PYTHONPATH="")
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    res = _run_py(ROOT, fake_card=False)
    assert res.returncode != 0 and not res.stdout.strip()


def test_benchmark_alone_no_result(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files."""
    _copy_benchmark(tmp_path)
    res = _run_py(tmp_path, fake_card=True)
    assert res.returncode != 0 and not res.stdout.strip()
    assert "repro_torch" in res.stderr


def test_late_load_of_jax_package_is_refused(tmp_path):
    """A metric reader that loads the JAX package, once the window has
    closed: the run ends with no result."""
    _copy_benchmark(tmp_path)
    (tmp_path / "src").symlink_to(ROOT / "src")
    (tmp_path / "sketchbench" / "metrics" / "late_ms.py").write_text(
        "def read(run):\n    from repro.analysis import roofline\n"
        "    return 1e3 * run.window_s + 0 * roofline.HW.hbm_bw\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["end_to_end"].append({"name": "late_ms", "unit": "ms",
                                "better": "lower", "bound": 0.01,
                                "source": "host_clock"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import sys, json; sys.path.insert(0, '.');"
            "from pathlib import Path; from sketchbench import harness;"
            "root = Path('.').resolve();"
            "cell = harness.find_cell(root, 'g500-22.pairs');"
            "cell.config = dict(cell.config, scale=9);"
            "cell.traffic['calls'][0]['args'][0]['count'] = 256;"
            "print(json.dumps(harness.run_cell(root, 'g500-22.pairs', 5, "
            "0.2, False, device='cpu', cell=cell)))")
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0 and not res.stdout.strip()
    assert "loaded by the run's end: repro" in res.stderr


def test_jax_package_loaded_is_refused(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro", object())
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", object())
    assert harness.banned_modules() == ["jaxlib", "repro"]
    with pytest.raises(SystemExit):
        run_small("g500-22.pairs")
