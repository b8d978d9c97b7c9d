"""The port's dry-run (``repro_torch.launch.dryrun``) on the CPU.

* ``run_cell``'s analytic fields (FLOPs useful and padded, bytes a
  device, parameters, the useful share) equal what the JAX
  ``repro.analysis.flops.cell_costs`` gives for the same cell, and its
  roofline's compute and memory terms equal the JAX ``roofline_terms``
  at the same ``HW`` numbers, passed to both, for every applicable cell
  on both production meshes (the JAX ``run_cell`` itself compiles on 512
  forced devices and is not run);
* the record's memory is the sharding rules' per-device bytes of each
  input, and its collectives are ``derive_collectives``' list through
  ``collective_wire_bytes``; the derivation counted by hand on a reduced
  config over a (2, 2) mesh, for decode and for train;
* the sweep in process: 80 cells, each ``OK`` or ``SKIP``, the skips
  exactly ``cell_is_applicable``'s, CUDA never initialised;
* the CLI in a subprocess: one ``train_4k`` cell writes an ``ok`` record
  and one ``long_500k`` cell of a pure full-attention arch ``SKIP``s.
"""
import collections
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro.analysis import flops as jflops  # noqa: E402
from repro.analysis import roofline as jroofline  # noqa: E402
from repro.configs import ARCHS as JAX_ARCHS, SHAPES as JAX_SHAPES  # noqa: E402
from repro_torch.analysis.hlo import collective_wire_bytes  # noqa: E402
from repro_torch.analysis.roofline import HW  # noqa: E402
from repro_torch.configs import ARCHS, SHAPES  # noqa: E402
from repro_torch.configs.registry import cell_is_applicable  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import (  # noqa: E402
    Mesh, make_production_mesh, placeholder_devices)
from repro_torch.models import sharding  # noqa: E402
from repro_torch.models.config import ShapeConfig  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: any rates will do, as long as both packages get the same ones
RATES = dict(peak_flops=5e14, hbm_bw=2e12, link_bw=1e11)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file (the suite's workers share the
    cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("multi_pod", [False, True],
                         ids=["single_pod", "multi_pod"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_run_cell_analytics_equal_the_jax_cost_model(arch, multi_pod,
                                                     tmp_path):
    chips = 512 if multi_pod else 256
    jhw = jroofline.HW(**RATES)
    for shape in SHAPES:
        rec = dryrun.run_cell(arch, shape, multi_pod, str(tmp_path),
                              hw=HW(**RATES))
        runs, reason = cell_is_applicable(arch, shape)
        if not runs:
            assert rec["skipped"] and rec["ok"] and rec["reason"] == reason
            continue
        want = jflops.cell_costs(JAX_ARCHS[arch], JAX_SHAPES[shape], chips)
        assert rec["flops_useful_global"] == want.flops_useful_global
        assert rec["flops_padded_global"] == want.flops_padded_global
        assert rec["bytes_per_dev_analytic"] == want.bytes_per_dev
        assert rec["params_total"] == want.params_total
        assert rec["params_bytes_per_dev"] == want.params_bytes_per_dev
        assert rec["flops_ratio_useful"] == (want.flops_useful_global
                                             / want.flops_padded_global)
        wire = rec["collectives"]["total_wire_bytes_per_dev"]
        jr = jroofline.roofline_terms(want.flops_padded_global / chips,
                                      want.bytes_per_dev, wire, jhw)
        for key in ("t_compute_s", "t_memory_s", "t_collective_s",
                    "bound_s", "dominant"):
            assert rec["roofline"][key] == jr[key], (shape, key)
        assert rec["hw"] == {"name": "custom", **RATES}
        assert rec["mesh_shape"] == (
            {"pod": 2, "data": 16, "model": 16} if multi_pod
            else {"data": 16, "model": 16})
        assert rec["ok"] and not rec.get("skipped")


@pytest.mark.parametrize("arch,shape", [
    ("moonshot-v1-16b-a3b", "train_4k"), ("grok-1-314b", "decode_32k"),
    ("whisper-large-v3", "prefill_32k"), ("mamba2-370m", "long_500k")])
def test_record_memory_and_collectives_come_from_the_rules(arch, shape,
                                                           tmp_path):
    rec = dryrun.run_cell(arch, shape, True, str(tmp_path))
    assert rec["hw"]["name"] == "NVIDIA H100 SXM"
    mesh = make_production_mesh(multi_pod=True,
                                devices=placeholder_devices(512))
    specs = sharding.input_specs(ARCHS[arch], SHAPES[shape], mesh)
    per_input = {k: sharding.bytes_per_device(s, sp, mesh)
                 for k, (s, sp) in specs.items()}
    assert rec["memory"]["bytes_per_dev"] == per_input
    assert rec["memory"]["total_bytes_per_dev"] == sum(per_input.values())
    assert "not XLA" in rec["memory"]["source"]
    colls = dryrun.derive_collectives(ARCHS[arch], SHAPES[shape], mesh,
                                      *specs["params"])
    wire, per_kind = collective_wire_bytes(colls)
    assert rec["collectives"]["count"] == len(colls) > 0
    assert rec["collectives"]["total_wire_bytes_per_dev"] == wire
    assert rec["collectives"]["per_kind_wire_bytes"] == per_kind
    kinds = set(per_kind)
    assert ("reduce-scatter" in kinds) == (SHAPES[shape].kind == "train")
    # moonshot's 64 experts divide the model axis (EP); grok's 8 do not
    assert ("all-to-all" in kinds) == (arch == "moonshot-v1-16b-a3b")


def test_derivation_counted_by_hand():
    """qwen2-1.5b reduced (2 layers, float32, tied embeddings, q/k/v
    biases) on a (2, 2) mesh, batch 4: seven FSDP leaves a period (q, k,
    v, o, gate, up, down), row-parallel o and down, the vocab-parallel
    embedding."""
    cfg = ARCHS["qwen2-1.5b"].reduced()
    mesh = Mesh((2, 2), ("data", "model"), placeholder_devices(4))
    params = sharding.input_specs(cfg, SHAPES["train_4k"], mesh)["params"]
    act = 2 * 128 * 4                          # T tokens x d_model x f32

    def count(shape):
        colls = dryrun.derive_collectives(cfg, shape, mesh, *params)
        assert all(c.group_size == 2 and c.count == 1 for c in colls)
        return collections.Counter(c.kind for c in colls), colls

    kinds, colls = count(ShapeConfig("d", 8, 4, "decode"))
    assert kinds == {"all-gather": 14, "all-reduce": 5}
    gathered = sorted(c.result_bytes for c in colls
                      if c.kind == "all-gather")
    # per period: k, v 128 x 32; q, o 128 x 64; gate, up, down 128 x 128
    assert gathered == sorted([16384] * 4 + [32768] * 4 + [65536] * 6)
    assert {c.result_bytes for c in colls if c.kind == "all-reduce"} == \
        {act}

    kinds, colls = count(ShapeConfig("t", 8, 4, "train"))
    # all-reduce: 12 replicated gradients (embed, final norm, and a
    # period's q/k/v biases and two norms, twice) + o and down in the
    # forward and the backward of 2 periods + the embedding once
    assert kinds == {"all-gather": 28, "reduce-scatter": 14,
                     "all-reduce": 12 + 8 + 1}
    tp = [c for c in colls if c.kind == "all-reduce"
          and c.result_bytes == 8 * act]
    assert len(tp) == 9
    one = Mesh((1, 1), ("data", "model"), placeholder_devices(1))
    assert dryrun.derive_collectives(
        cfg, SHAPES["train_4k"], one,
        *sharding.input_specs(cfg, SHAPES["train_4k"], one)["params"]) == []


def test_sweep_in_process(tmp_path, capsys):
    dryrun.main(["--all", "--out", str(tmp_path)])
    lines = capsys.readouterr().out.splitlines()
    assert lines[-1].startswith("DRYRUN SWEEP ")
    counts = json.loads(lines[-1][len("DRYRUN SWEEP "):])
    cells = [ln.split()[1:5] for ln in lines if ln.startswith("DRYRUN ")
             and not ln.startswith("DRYRUN SWEEP")]
    want_skip = {(a, s, m) for a in ARCHS for s in dryrun.SWEEP_SHAPES
                 for m in ("single_pod", "multi_pod")
                 if not cell_is_applicable(a, s)[0]}
    assert len(cells) == counts["cells"] == 80
    assert {st for st, *_ in cells} == {"OK", "SKIP"}
    assert {tuple(c[1:]) for c in cells if c[0] == "SKIP"} == want_skip
    assert counts["skip"] == len(want_skip) and counts["fail"] == 0
    assert counts["ok"] == 80 - len(want_skip)
    assert counts["cuda_initialized"] is False
    assert len(os.listdir(tmp_path)) == 80


def test_cli_cells_in_a_subprocess(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))

    def cli(*args):
        res = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", *args,
             "--out", str(tmp_path)],
            env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
        assert res.returncode == 0, res.stderr[-3000:]
        return res.stdout

    out = cli("--arch", "qwen2-1.5b", "--shape", "train_4k")
    assert out.startswith("DRYRUN OK qwen2-1.5b train_4k single_pod")
    rec = json.load(open(tmp_path / "qwen2-1.5b__train_4k__single_pod.json"))
    assert rec["ok"] and rec["memory"]["bytes_per_dev"]["opt_state"] > 0
    out = cli("--arch", "qwen2-72b", "--shape", "long_500k", "--multi-pod")
    assert out.startswith("DRYRUN SKIP qwen2-72b long_500k multi_pod")
    skip = json.load(open(tmp_path / "qwen2-72b__long_500k__multi_pod.json"))
    assert skip["skipped"] and skip["ok"] and skip["reason"]
