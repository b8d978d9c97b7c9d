"""Port parity: the sharded backend on the CPU.

``repro_torch.engine`` with ``backend="sharded"`` (S in {1, 2, 4, 8}
shard panels, byte and packed, ``impl`` "cuda" and "ref") against the
JAX reference's *local* engine (``impl="ref"``) and the port's local
engine. The JAX sharded union and intersection path is a reference
defect (ROADMAP Queue C item 4) and ``impl="pallas"`` another (item 3);
nothing here is held against either. Tolerances and why:

* register panels byte-identical to the JAX engine's, the accumulated
  panel and every hop panel D^t of every schedule (integer max of the
  same hash);
* every answer equal to the port's local engine bit for bit: the sharded
  backend runs the same kernels on the same rows (per shard, or on rows
  gathered into a compact panel);
* against the JAX engine the tolerances of ``tests/test_torch_engine.py``
  and ``tests/test_torch_union.py`` (degrees, neighborhood and unions
  ``rtol=1e-5``; the MLE intersection ``1e-4`` of its value), not bit
  for bit: the port sums a row's ``2^-reg`` exactly and rounds once, the
  JAX package sums float32 in its own order with XLA's CPU ``exp2``, so
  the two estimates are about one float32 ulp apart on the same
  registers (the registers themselves are equal, above); the ADS
  distance queries those of ``tests/test_torch_ads.py``; triangles those of
  ``tests/test_torch_triangles.py``;
* the triangle total against the port's local engine to ``1e-12``
  relative (float64 sums of the same float32 estimates in another order);
  per-edge estimates bit for bit.
"""
import functools
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import engine as jax_engine  # noqa: E402
from repro.core.ads import ADSConfig as JaxADSConfig  # noqa: E402
from repro.core.hll import HLLConfig as JaxConfig  # noqa: E402
from repro_torch import engine  # noqa: E402
from repro_torch.core import degreesketch as dsk  # noqa: E402
from repro_torch.core.ads import ADSConfig  # noqa: E402
from repro_torch.core.hll import HLLConfig  # noqa: E402
from repro_torch.distributed import sketch_dist as sd  # noqa: E402
from repro_torch.engine import plans  # noqa: E402
from repro_torch.engine.sharded import ShardedEngine  # noqa: E402
from repro_torch.graph import generators  # noqa: E402
from repro_torch.serve import QueryServer  # noqa: E402
from repro_torch.serve import server as server_mod  # noqa: E402

P = 6
T_MAX = 3
ITERS = 10
EDGES = generators.rmat(8, 8, seed=3)
N = 293  # > max id + 1: rows of isolated vertices and a ragged last shard
SCHEDULES = ["auto", "ring", "ring_overlap", "allgather"]
CASES = [(s, lay, impl) for s in (1, 2, 4, 8) for lay in ("byte", "packed")
         for impl in ("cuda", "ref")]
IDS = [f"S{s}-{lay}-{impl}" for s, lay, impl in CASES]
RNG = np.random.default_rng(3)
PAIRS = EDGES[RNG.choice(len(EDGES), 48, replace=False)]
SETS = [RNG.integers(0, N, size=int(k)) for k in RNG.integers(1, 12, 24)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file: the parallel suite runs a whole
    file in one worker, and this file's many small tensor ops would
    otherwise oversubscribe the cores the other workers share."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _jax(layout):
    return jax_engine.build(EDGES, N, JaxConfig(p=P), impl="ref",
                            layout=layout, backend="local")


@functools.lru_cache(maxsize=None)
def _local(layout):
    return engine.build(EDGES, N, HLLConfig(p=P), layout=layout,
                        device="cpu")


def _sharded(shards, layout, impl, edges=EDGES, cfg=None, **kw):
    return engine.build(edges, N, cfg or HLLConfig(p=P), layout=layout,
                        impl=impl, device="cpu", backend="sharded",
                        shards=shards, **kw)


def _close(got, want, rtol):
    want = np.asarray(want)
    assert np.all(np.abs(got - want) <= rtol * np.abs(want)), np.max(
        np.abs(got - want) / np.maximum(np.abs(want), 1e-30))


def _hops(eng, schedule):
    """The D^1..D^T_MAX panels of ``eng`` under ``schedule`` as numpy
    arrays of the n true rows."""
    out = []
    for panel in eng._panels_up_to(T_MAX, eng._canonical_schedule(schedule)):
        rows = (torch.cat(panel) if isinstance(panel, list) else panel)
        out.append(rows[:N].numpy())
    return out


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_registers_match_jax(case):
    shards, layout, impl = case
    eng = _sharded(*case)
    assert isinstance(eng, ShardedEngine) and eng.backend == "sharded"
    assert eng.shards == shards and eng.impl == impl
    n_pad, v_loc = sd.vertex_partition(N, shards)
    assert (eng.n_pad, eng.v_loc) == (n_pad, v_loc)
    parts = eng.shard_regs
    assert [p.shape[0] for p in parts] == [v_loc] * shards
    assert len({p.data_ptr() for p in parts}) == shards  # own allocations
    np.testing.assert_array_equal(eng.regs[:N].numpy(),
                                  np.asarray(_jax(layout).regs)[:N])
    assert eng.m == len(EDGES)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_degrees_and_neighborhood_schedules(case):
    _, layout, _ = case
    eng, local, ref = _sharded(*case), _local(layout), _jax(layout)
    deg = eng.degrees()
    np.testing.assert_array_equal(deg, local.degrees())
    _close(deg, ref.degrees(), 1e-5)
    want_hops = [np.asarray(h)[:N] for h in ref._panels_up_to(T_MAX, "ring")]
    want_l, want_g = local.neighborhood(T_MAX)
    for schedule in SCHEDULES:
        for got, want in zip(_hops(eng, schedule), want_hops):
            np.testing.assert_array_equal(got, want)
        got_l, got_g = eng.neighborhood(T_MAX, schedule=schedule)
        np.testing.assert_array_equal(got_l, want_l)
        np.testing.assert_array_equal(got_g, want_g)
        _close(got_l, ref.neighborhood(T_MAX)[0], 1e-5)
        passes = eng.propagate_passes
        eng.neighborhood(T_MAX, schedule=schedule)
        assert eng.propagate_passes == passes  # cached per schedule


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_union_intersection_and_batches(case):
    _, layout, _ = case
    eng, local, ref = _sharded(*case), _local(layout), _jax(layout)
    uni = eng.union_size(SETS)
    np.testing.assert_array_equal(uni, local.union_size(SETS))
    _close(uni, ref.union_size(SETS), 1e-5)
    assert eng.union_size(SETS[0]) == local.union_size(SETS[0])
    for method in ("mle", "ie"):
        got = eng.intersection_size(PAIRS, method=method, iters=ITERS)
        np.testing.assert_array_equal(
            got, local.intersection_size(PAIRS, method=method, iters=ITERS))
    _close(eng.intersection_size(PAIRS, iters=ITERS),
           ref.intersection_size(PAIRS, iters=ITERS), 1e-4)
    for kw in ({"degrees": True, "vertex_sets": SETS, "pairs": PAIRS},
               {"vertex_sets": SETS, "pairs": PAIRS},
               {"degrees": True, "pairs": PAIRS}, {"vertex_sets": SETS}):
        got = eng.query_batch(iters=ITERS, **kw)
        want = local.query_batch(iters=ITERS, **kw)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    got = eng.query_batch(degrees=True, vertex_sets=SETS, pairs=PAIRS,
                          iters=ITERS)
    want = ref.query_batch(degrees=True, vertex_sets=SETS, pairs=PAIRS,
                           iters=ITERS)
    assert got.keys() == want.keys()
    for k in want:
        _close(got[k], want[k], 1e-4 if k == "intersection" else 1e-5)


@pytest.mark.parametrize("shards", [1, 2, 4, 8])
def test_exchanges_move_the_schedules_bytes(shards):
    """Ring: S - 1 shifts of every block; all-gather: the whole panel onto
    every shard; replica pre-pass: K rows gathered, then copied to every
    shard."""
    eng = _sharded(shards, "byte", "cuda")
    plan = eng.plan
    w = eng.regs.shape[1]
    panel = eng.n_pad * w
    for fn, kind, want in (
            (lambda p: sd.dist_propagate_ring(plan, p), "ppermute",
             (shards - 1) * panel),
            (lambda p: sd.dist_propagate_allgather(plan, p), "all_gather",
             shards * panel)):
        sd.reset_copied_bytes()
        fn(eng.shard_regs)
        assert sd.copied_bytes()[kind] == want
    eng.replicate(np.arange(5))
    sd.reset_copied_bytes()
    sd.dist_propagate_ring(eng.plan, eng.shard_regs)
    got = sd.copied_bytes()
    assert got["replica"] == 5 * w * shards and got["rows"] == 5 * w


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_replicate_then_propagate(shards, schedule):
    """Hot-source edges leave the exchange groups and merge from the
    replica panel; the panels and answers do not change."""
    eng = _sharded(shards, "byte", "cuda")
    want_l, want_g = _local("byte").neighborhood(T_MAX)
    deg = np.bincount(EDGES.ravel(), minlength=N)
    eng.replicate(np.argsort(-deg)[:8])
    assert eng.plan.has_replicas
    assert sum(int(r.numel()) for r in eng.plan.rep_dst) > 0
    got_l, got_g = eng.neighborhood(T_MAX, schedule=schedule)
    np.testing.assert_array_equal(got_l, want_l)
    np.testing.assert_array_equal(got_g, want_g)
    eng.replicate(np.array([], np.int64))
    assert eng.replicated_ids is None and not eng.plan.has_replicas


@pytest.mark.parametrize("shards", [2, 4])
def test_ads_distance_queries(shards):
    cfg = ADSConfig(p=P)
    eng = _sharded(shards, "byte", "cuda", cfg=cfg, family="ads")
    local = engine.build(EDGES, N, cfg, family="ads", device="cpu")
    ref = jax_engine.build(EDGES, N, JaxADSConfig(p=P), impl="ref",
                           layout="byte", backend="local", family="ads")
    np.testing.assert_array_equal(eng.regs[:N].numpy(),
                                  np.asarray(ref.regs)[:N])
    for schedule in SCHEDULES:
        hist, glob = eng.distance_histogram(T_MAX, schedule=schedule)
        w_hist, w_glob = local.distance_histogram(T_MAX)
        np.testing.assert_array_equal(hist, w_hist)
        np.testing.assert_array_equal(glob, w_glob)
        np.testing.assert_array_equal(eng.closeness(T_MAX, schedule),
                                      local.closeness(T_MAX))
        assert eng.effective_diameter(T_MAX, 0.9, schedule) == \
            local.effective_diameter(T_MAX, 0.9)
    j_hist, j_glob = ref.distance_histogram(T_MAX)
    np.testing.assert_allclose(glob, np.asarray(j_glob), rtol=1e-5)
    np.testing.assert_allclose(eng.closeness(T_MAX),
                               np.asarray(ref.closeness(T_MAX)), rtol=1e-5)
    assert abs(eng.effective_diameter(T_MAX, 0.9)
               - float(ref.effective_diameter(T_MAX, 0.9))) <= 1e-6


@pytest.mark.parametrize("block", [1, 97, 1000])
def test_chunked_ingest_equals_one_shot(monkeypatch, block):
    monkeypatch.setattr(engine.SketchEngine, "INGEST_BLOCK", block)
    eng = engine.open(N, HLLConfig(p=P), device="cpu", backend="sharded",
                      shards=4)
    for s in range(0, len(EDGES), 5 * block):
        eng.ingest(EDGES[s:s + 5 * block])
    np.testing.assert_array_equal(eng.regs.numpy(),
                                  _sharded(4, "byte", "cuda").regs.numpy())
    np.testing.assert_array_equal(eng.neighborhood(2)[0],
                                  _local("byte").neighborhood(2)[0])


def test_snapshot_keeps_answers_while_the_writer_ingests():
    half = len(EDGES) // 2
    eng = _sharded(4, "byte", "cuda", edges=EDGES[:half])
    want_l, _ = eng.neighborhood(2, schedule="allgather")
    want_u = eng.union_size(SETS)
    snap = eng.snapshot()
    assert snap.frozen and snap.regs_leased is False and eng.regs_leased
    clones = plans.event_counts().get("lease_clone", 0)
    eng.ingest(EDGES[half:])
    assert plans.event_counts().get("lease_clone", 0) == clones + 1
    np.testing.assert_array_equal(snap.neighborhood(2, "allgather")[0],
                                  want_l)
    np.testing.assert_array_equal(snap.union_size(SETS), want_u)
    np.testing.assert_array_equal(eng.neighborhood(2)[0],
                                  _local("byte").neighborhood(2)[0])
    assert snap.plan is not eng.plan  # each rebuilt from its own edges


def test_query_server_over_a_sharded_engine(monkeypatch):
    def wait(self):
        if not self.done.wait(timeout=120):
            raise TimeoutError(f"{self.kind} request not served in 120 s")
        if self.error is not None:
            raise self.error
        return self.result
    monkeypatch.setattr(server_mod._Request, "wait", wait)
    eng = _sharded(2, "byte", "cuda")
    local = _local("byte")
    with QueryServer(eng) as srv:
        np.testing.assert_array_equal(srv.degrees(), local.degrees())
        np.testing.assert_array_equal(srv.union_size(SETS),
                                      local.union_size(SETS))
        np.testing.assert_array_equal(srv.intersection_size(PAIRS),
                                      local.intersection_size(PAIRS))
        for schedule in ("auto", "allgather"):
            np.testing.assert_array_equal(
                srv.neighborhood(T_MAX, schedule)[0],
                local.neighborhood(T_MAX)[0])
        srv.ingest(np.array([[0, 250]], np.int32))
        grown = engine.build(np.concatenate([EDGES, [[0, 250]]]), N,
                             HLLConfig(p=P), device="cpu")
        np.testing.assert_array_equal(srv.degrees(), grown.degrees())


@functools.lru_cache(maxsize=None)
def _triangle_refs():
    ref = _jax("byte")
    local = _local("byte")
    est = dsk.edge_triangle_estimates(
        dsk.DegreeSketch(regs=local.regs, n=N, cfg=local.cfg), EDGES,
        iters=ITERS)
    deg = np.asarray(ref.degrees())
    union = np.asarray(ref.union_size([list(e) for e in EDGES]))
    tol = 1e-4 * (np.abs(est) + deg[EDGES[:, 0]] + deg[EDGES[:, 1]] + union)
    return ref, local, est, tol


@pytest.mark.parametrize("shards", [1, 3, 8])
@pytest.mark.parametrize("layout", ["byte", "packed"])
def test_edge_triangle_estimates_equal_the_local_engines(shards, layout):
    eng = _sharded(shards, layout, "cuda")
    local = _local(layout)
    want = dsk.edge_triangle_estimates(
        dsk.DegreeSketch(regs=local.regs, n=N, cfg=local.cfg, layout=layout),
        EDGES, iters=ITERS)
    np.testing.assert_array_equal(eng.edge_triangle_estimates(ITERS), want)


@pytest.mark.parametrize("shards", [1, 3, 8])
@pytest.mark.parametrize("mode", ["edge", "vertex"])
def test_triangle_heavy_hitters_match(shards, mode):
    ref, local, est, tol = _triangle_refs()
    eng = _sharded(shards, "byte", "cuda")
    k = 20
    total, vals, top = eng.triangle_heavy_hitters(k, mode=mode, iters=ITERS)
    l_total, l_vals, l_top = local.triangle_heavy_hitters(k, mode=mode,
                                                          iters=ITERS)
    w_total, w_vals, w_top = ref.triangle_heavy_hitters(k, mode=mode,
                                                        iters=ITERS)
    assert abs(total - l_total) <= 1e-12 * abs(l_total)
    assert abs(total - w_total) <= tol.sum() / 3
    assert np.all(np.diff(vals) <= 0) and len(vals) == len(top) == k
    np.testing.assert_allclose(vals, l_vals, rtol=1e-12)
    atol = tol.max() if mode == "edge" else None
    if mode == "vertex":
        vtol = np.zeros(N)
        np.add.at(vtol, EDGES[:, 0], tol)
        np.add.at(vtol, EDGES[:, 1], tol)
        atol = vtol.max() / 2
        assert top.dtype.kind == "i" and (top < N).all()
    else:
        real = {tuple(e) for e in EDGES}
        assert all(tuple(e) in real for e in top)
    np.testing.assert_allclose(vals, w_vals, rtol=0, atol=atol)
    key = [tuple(np.atleast_1d(i)) for i in top]
    for j in range(1, k):  # id sets equal at every well-separated cut
        if l_vals[j - 1] - l_vals[j] > 1e-9 * abs(l_vals[0]):
            assert set(key[:j]) == {tuple(np.atleast_1d(i))
                                    for i in l_top[:j]}


def test_k_beyond_the_candidates_returns_only_real_ids():
    eng = _sharded(4, "byte", "cuda")
    _, vals, top = eng.triangle_heavy_hitters(10 * len(EDGES), iters=ITERS)
    assert len(vals) == len(EDGES)
    assert {tuple(e) for e in top} == {tuple(e) for e in EDGES}
    _, vvals, vtop = eng.triangle_heavy_hitters(10 * N, mode="vertex",
                                                iters=ITERS)
    assert len(vvals) == N and sorted(vtop.tolist()) == list(range(N))


def test_backend_arguments_are_validated():
    cfg = HLLConfig(p=P)
    with pytest.raises(ValueError, match="backend"):
        engine.open(N, cfg, device="cpu", backend="mesh")
    with pytest.raises(ValueError, match="shards"):
        engine.open(N, cfg, device="cpu", shards=2)
    for bad in (0, -1, 2.5, True):
        with pytest.raises(ValueError, match="shards"):
            engine.open(N, cfg, device="cpu", backend="sharded", shards=bad)
    eng = engine.open(N, cfg, device="cpu", backend="sharded")
    assert eng.shards == 1  # one shard on the CPU by default
    with pytest.raises(ValueError, match="schedule"):
        _sharded(2, "byte", "cuda").neighborhood(2, schedule="tree")
    with pytest.raises(ValueError, match="mode"):
        _sharded(2, "byte", "cuda").triangle_heavy_hitters(3, mode="global")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            engine.open(N, cfg, backend="sharded", shards=2)


def test_merge_and_save_record_backend_and_shards(tmp_path):
    import json
    left = _sharded(4, "byte", "cuda", edges=EDGES[0::2])
    right = _sharded(2, "packed", "cuda", edges=EDGES[1::2])
    local = _local("byte")
    left.merge(_sharded(2, "byte", "cuda", edges=EDGES[1::2]))
    np.testing.assert_array_equal(left.regs[:N].numpy(),
                                  local.regs[:N].numpy())
    packed = _sharded(4, "packed", "cuda", edges=EDGES[0::2]).merge(right)
    np.testing.assert_array_equal(packed.regs[:N].numpy(),
                                  _local("packed").regs[:N].numpy())
    step = left.save(str(tmp_path / "ck"))
    extra = json.load(open(os.path.join(step, "manifest.json")))["extra"]
    assert extra["backend"] == "sharded" and extra["shards"] == 4


_SCRIPT_8DEV = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import numpy as np, jax
from repro.core import hll as jhll
from repro.distributed import sketch_dist as jsd
from repro_torch.core.hll import HLLConfig
from repro_torch.distributed import sketch_dist as sd
from repro_torch.graph import generators as gen

edges = gen.rmat(7, 8, seed=9); n = 150
mesh = jax.make_mesh((8,), ("data",))
jplan = jsd.build_plan(edges, n, 8)
jcfg = jhll.HLLConfig(p=6)
jregs = jsd.dist_accumulate(mesh, "data", jplan, jcfg)
plan = sd.build_plan(edges, n, 8, device="cpu")
cfg = HLLConfig(p=6)
parts = sd.dist_accumulate(plan, cfg)
assert np.array_equal(np.concatenate([p.numpy() for p in parts]),
                      np.asarray(jregs)), "accumulate"
want = np.asarray(jsd.dist_propagate_ring(mesh, "data", jplan, jregs))
assert np.array_equal(np.asarray(jsd.dist_propagate_allgather(
    mesh, "data", jplan, jregs)), want)
for got in (sd.dist_propagate_ring(plan, parts),
            sd.dist_propagate_ring(plan, parts, overlap=True),
            sd.dist_propagate_allgather(plan, parts)):
    assert np.array_equal(np.concatenate([p.numpy() for p in got]), want)
for mode in ("edge", "vertex"):
    wt, wv, wi = jsd.dist_triangle_heavy_hitters(mesh, "data", jplan, jcfg,
                                                 jregs, 10, iters=10,
                                                 mode=mode)
    gt, gv, gi = sd.dist_triangle_heavy_hitters(plan, cfg, parts, 10,
                                                iters=10, mode=mode)
    print(mode, wt, gt, np.asarray(wv).tolist(), gv.tolist())
    assert abs(gt - wt) <= 1e-4 * abs(wt), (mode, gt, wt)
    assert np.allclose(gv, wv, rtol=1e-3), (mode, gv, wv)
    top = {tuple(np.atleast_1d(i)) for i in gi[:3]}
    assert top == {tuple(np.atleast_1d(i)) for i in np.asarray(wi)[:3]}
print("DIST8_OK")
"""


def test_schedules_and_triangles_match_jax_on_8_devices():
    """The JAX shard_map schedules on 8 simulated devices against the
    port's 8 shard panels: propagate panels byte-identical; triangle
    totals to 1e-4 relative, top-3 ids equal and top-10 values to 1e-3
    (float32 MLE in another order; XLA's float32 psum)."""
    env = dict(os.environ)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = os.path.join(root, "src")
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"
    env["OMP_NUM_THREADS"] = "1"  # see _one_thread
    res = subprocess.run([sys.executable, "-c", _SCRIPT_8DEV], env=env,
                         capture_output=True, text=True, timeout=600,
                         cwd=root)
    assert "DIST8_OK" in res.stdout, res.stdout + "\n" + res.stderr


@pytest.mark.parametrize("extra", [[], ["--continuous"]],
                         ids=["barrier", "continuous"])
def test_sketch_serve_sharded_answers_as_local(capsys, extra):
    """``sketch_serve --backend sharded --shards 2`` on the CPU serves the
    local launcher's final answers (the served neighborhood line)."""
    from repro_torch.launch import sketch_serve

    def run(*flags):
        sketch_serve.main(["--smoke", "--device", "cpu", *flags, *extra])
        out = capsys.readouterr().out
        return out, [ln for ln in out.splitlines()
                     if ln.startswith("neighborhood(")][0]

    local_out, local_line = run()
    out, line = run("--backend", "sharded", "--shards", "2")
    assert "backend=sharded shards=2" in out
    assert "backend=local shards=1" in local_out
    assert line == local_line
    with pytest.raises(SystemExit):
        sketch_serve.main(["--smoke", "--device", "cpu", "--shards", "2"])
