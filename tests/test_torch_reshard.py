"""Port parity: elastic reshard, ``engine.load(path, shards=S2)``.

A checkpoint saved by the sharded backend at S = 4 loads at S' in
{1, 2, 8} and on the local backend with every answer unchanged bit for
bit (the rows are repartitioned, no edge is replayed), the saved replica
set reinstalled and routed by the rebuilt plan, and ingestion resuming
where the saved engine stopped. Checkpoints cross the packages both
ways: a port sharded checkpoint through the JAX package's
``repro.engine.load(backend="local")``, and a JAX checkpoint saved with
``backend="sharded", shards=1`` through the port at S = 4. Registers are
byte-identical everywhere; answers of the two packages on the same
registers agree to ``rtol=1e-5`` (float32 estimates summed in another
order, as in ``tests/test_torch_ckpt.py``). The JAX sharded engine's
``replicate`` is a reference defect (ROADMAP Queue C), so its checkpoint
here carries no replica set.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import engine as jax_engine  # noqa: E402
from repro.core.hll import HLLConfig as JaxConfig  # noqa: E402
from repro_torch import engine  # noqa: E402
from repro_torch.core.hll import HLLConfig  # noqa: E402
from repro_torch.engine.sharded import ShardedEngine  # noqa: E402
from repro_torch.graph import generators  # noqa: E402

P = 6
N = 300
EDGES = generators.rmat(8, 8, seed=12)
HOT = np.array([0, 1, 2, 3, 17, 299])
RNG = np.random.default_rng(12)
SETS = [RNG.integers(0, N, size=int(k)) for k in RNG.integers(1, 9, 16)]
PAIRS = EDGES[RNG.choice(len(EDGES), 32, replace=False)]

@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file: the parallel suite runs a whole
    file in one worker, and this file's many small tensor ops would
    otherwise oversubscribe the cores the other workers share."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)



def _answers(eng):
    out = [eng.regs[: eng.n].numpy(), eng.degrees(),
           eng.union_size(SETS), eng.intersection_size(PAIRS, iters=10)]
    for schedule in ("ring", "allgather"):
        out.extend(eng.neighborhood(2, schedule=schedule))
    return out


def _same(a, b):
    for x, y in zip(_answers(a), _answers(b)):
        np.testing.assert_array_equal(x, y)


@pytest.fixture(scope="module", params=["byte", "packed"])
def saved(request, tmp_path_factory):
    """(path, the S = 4 engine saved there with a replica set, layout)."""
    layout = request.param
    eng = engine.build(EDGES, N, HLLConfig(p=P), layout=layout,
                       device="cpu", backend="sharded", shards=4)
    eng.replicate(HOT)
    path = str(tmp_path_factory.mktemp(f"reshard_{layout}") / "ck")
    eng.save(path)
    return path, eng, layout


@pytest.mark.parametrize("shards", [1, 2, 4, 8])
def test_load_at_another_shard_count_keeps_every_answer(saved, shards):
    path, eng, layout = saved
    back = engine.load(path, device="cpu", shards=shards)
    assert isinstance(back, ShardedEngine) and back.shards == shards
    assert back.layout == layout and back.m == eng.m
    np.testing.assert_array_equal(back.replicated_ids, HOT)
    assert back.plan.has_replicas
    np.testing.assert_array_equal(back.plan.rep_ids, HOT)
    _same(back, eng)


def test_load_keeps_the_saved_shard_count_by_default(saved):
    path, eng, _ = saved
    extra = json.load(open(os.path.join(path, "step_0", "manifest.json")))
    assert extra["extra"]["backend"] == "sharded"
    assert extra["extra"]["shards"] == 4
    back = engine.load(path, device="cpu")
    assert back.backend == "sharded" and back.shards == 4
    _same(back, eng)


def test_load_on_the_local_backend(saved):
    path, eng, _ = saved
    back = engine.load(path, device="cpu", backend="local")
    assert back.backend == "local"
    np.testing.assert_array_equal(back.replicated_ids, HOT)
    _same(back, eng)
    with pytest.raises(ValueError, match="shards"):
        engine.load(path, device="cpu", backend="local", shards=2)


def test_local_checkpoint_loads_sharded(tmp_path):
    local = engine.build(EDGES, N, HLLConfig(p=P), device="cpu")
    local.replicate(HOT)
    local.save(str(tmp_path / "ck"))
    back = engine.load(str(tmp_path / "ck"), device="cpu",
                       backend="sharded", shards=3)
    assert back.shards == 3
    np.testing.assert_array_equal(back.replicated_ids, HOT)
    _same(back, local)


@pytest.mark.parametrize("shards", [1, 2, 8])
def test_replicas_survive_reshard_through_propagate(saved, shards):
    """``neighborhood(2)`` again after the reinstalled replica set: every
    schedule merges the replica panel and answers as before."""
    path, eng, _ = saved
    back = engine.load(path, device="cpu", shards=shards)
    want = eng.neighborhood(2)
    for schedule in ("ring", "ring_overlap", "allgather"):
        got = back.neighborhood(2, schedule=schedule)
        np.testing.assert_array_equal(got[0], want[0])
    back.replicate(np.array([5, 6], np.int64))
    np.testing.assert_array_equal(back.neighborhood(2, "allgather")[0],
                                  want[0])


@pytest.mark.parametrize("shards", [1, 2, 8])
def test_resharded_engine_resumes_ingest(tmp_path, shards):
    half = len(EDGES) // 2
    eng = engine.build(EDGES[:half], N, HLLConfig(p=P), device="cpu",
                       backend="sharded", shards=4)
    eng.save(str(tmp_path / "ck"))
    back = engine.load(str(tmp_path / "ck"), device="cpu", shards=shards)
    back.ingest(EDGES[half:])
    whole = engine.build(EDGES, N, HLLConfig(p=P), device="cpu",
                         backend="sharded", shards=shards)
    _same(back, whole)


def test_reshard_with_a_layout_change(saved):
    path, eng, layout = saved
    other = "byte" if layout == "packed" else "packed"
    back = engine.load(path, device="cpu", shards=2, layout=other)
    want = engine.build(EDGES, N, HLLConfig(p=P), layout=other,
                        device="cpu")
    if other == "packed":  # byte -> packed saturates at 15, merge-exact
        np.testing.assert_array_equal(back.regs[:N].numpy(),
                                      want.regs[:N].numpy())
    else:  # packed -> byte is exact: the unpacked packed panel
        from repro_torch.kernels import packing
        np.testing.assert_array_equal(
            back.regs[:N].numpy(),
            packing.unpack_rows(eng.regs[:N]).numpy())


def test_port_sharded_checkpoint_loads_in_jax(saved):
    path, eng, layout = saved
    back = jax_engine.load(path, backend="local")
    assert back.backend == "local" and back.layout == layout
    np.testing.assert_array_equal(np.asarray(back.regs)[:N],
                                  eng.regs[:N].numpy())
    np.testing.assert_array_equal(np.asarray(back.edges), eng.edges)
    np.testing.assert_array_equal(np.asarray(back.replicated_ids), HOT)
    np.testing.assert_allclose(eng.degrees(), np.asarray(back.degrees()),
                               rtol=1e-5)
    np.testing.assert_allclose(eng.neighborhood(2)[0],
                               np.asarray(back.neighborhood(2)[0]),
                               rtol=1e-5)


@pytest.mark.parametrize("layout", ["byte", "packed"])
def test_jax_sharded_checkpoint_loads_at_four_shards(tmp_path, layout):
    want = jax_engine.build(EDGES, N, JaxConfig(p=P), impl="ref",
                            layout=layout, backend="sharded", shards=1)
    want.save(str(tmp_path / "ck"))
    back = engine.load(str(tmp_path / "ck"), device="cpu", shards=4)
    assert back.backend == "sharded" and back.shards == 4
    np.testing.assert_array_equal(back.regs[:N].numpy(),
                                  np.asarray(want.regs)[:N])
    local = engine.build(EDGES, N, HLLConfig(p=P), layout=layout,
                         device="cpu")
    _same(back, local)
    np.testing.assert_allclose(back.degrees(), np.asarray(want.degrees()),
                               rtol=1e-5)
