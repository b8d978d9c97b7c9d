"""Port parity: the failover runtime (``repro_torch.runtime``).

The coordinator runs beside the JAX package's on the same edges, config
and fault plan, on the local backend: its ``stats`` must equal the JAX
coordinator's (``last_recovery_ms`` aside, and the straggler count where
an injected delay drives it), its registers byte for byte. Its answers
equal a one-shot local build of the port bit for bit, and the JAX
coordinator's engine at ``rtol=1e-5``, the tolerance at which the port's
answers on the same registers meet the JAX package's. The sharded
backend's recovery (4 hosts -> 3 shards) is held against the port's
local engine: the JAX sharded engine's union is a reference defect
(ROADMAP Queue C). Checkpoints cross both ways: the coordinator and
``train_loop`` of either package resume from the other's files. The
``StragglerWatchdog`` makes the JAX watchdog's decisions on the same time
sequences. The graph is the JAX tests' ``rmat(8, 8, seed=11)``.
"""
import importlib
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import engine as jax_engine  # noqa: E402
from repro.core.ads import ADSConfig as JaxADSConfig  # noqa: E402
from repro.core.hll import HLLConfig as JaxHLLConfig  # noqa: E402
from repro.data.pipeline import SyntheticCorpus as JaxCorpus  # noqa: E402
from repro.runtime import faults as jax_faults  # noqa: E402
from repro.runtime import ft as jax_ft  # noqa: E402
from repro_torch import engine  # noqa: E402
from repro_torch import runtime  # noqa: E402
from repro_torch.core.ads import ADSConfig  # noqa: E402
from repro_torch.core.hll import HLLConfig  # noqa: E402
from repro_torch.data.pipeline import SyntheticCorpus  # noqa: E402
from repro_torch.engine.base import SCHEDULES  # noqa: E402
from repro_torch.graph import generators  # noqa: E402
from repro_torch.runtime import faults  # noqa: E402
from repro_torch.runtime import ft  # noqa: E402

# the packages re-export the function ``coordinator`` beside the module of
# that name, so the modules are imported by name
jax_coord = importlib.import_module("repro.runtime.coordinator")
coord = importlib.import_module("repro_torch.runtime.coordinator")

P = 6
BLOCK = 64
EDGES = generators.rmat(8, 8, seed=11)
N = int(EDGES.max()) + 1
SETS = [[0, 1, 2], [3, 17, 40, 41], [N - 1]]
TIMING = ("last_recovery_ms", "straggler_steps")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file: the parallel suite runs a whole
    file in one worker, and this file's many small tensor ops would
    otherwise oversubscribe the cores the other workers share."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfgs(family):
    if family == "ads":
        return ADSConfig(p=P), JaxADSConfig(p=P)
    return HLLConfig(p=P), JaxHLLConfig(p=P)


def _plan(mod, spec):
    """A fresh injector of ``mod`` (either package's ``faults``) for
    ``spec``: ``(kind, kwargs)`` pairs."""
    return mod.FaultInjector(faults=tuple(
        getattr(mod, kind)(**kw) for kind, kw in spec))


def _both(tmp_path, spec=(), family="hll", layout="byte", pre=None,
          cc=None, ftkw=None, **kw):
    """Run the JAX coordinator and the port's on the same edges, config
    and fault plan, each in its own checkpoint directory (seeded with
    ``pre(dir)`` when given). Returns ``(port engine, port stats, JAX
    engine, JAX stats)``."""
    cfg, jcfg = _cfgs(family)
    cc = cc or {"hosts": 3, "block": BLOCK, "ckpt_every": 2}
    ftkw = ftkw or {}
    out = []
    for side, run, cfg_, ftmod, cmod, fmod in (
            ("torch", coord.coordinator, cfg, ft, coord, faults),
            ("jax", jax_coord.coordinator, jcfg, jax_ft, jax_coord,
             jax_faults)):
        ck = str(tmp_path / side / "ckpt")
        if pre is not None:
            pre(ck)
        extra = {"device": "cpu"} if side == "torch" else {}
        eng, stats = run(EDGES, N, cfg_,
                         ft=ftmod.FTConfig(ckpt_dir=ck, **ftkw),
                         config=cmod.CoordinatorConfig(**cc),
                         faults=_plan(fmod, spec), family=family,
                         layout=layout, **extra, **kw)
        out += [eng, stats]
    return out


def _same_stats(stats, jstats, skip=TIMING):
    assert stats.keys() == jstats.keys()
    for k in stats:
        if k not in skip:
            assert stats[k] == jstats[k], k


def _same_regs(eng, jeng):
    np.testing.assert_array_equal(eng.regs[:N].numpy(),
                                  np.asarray(jeng.regs)[:N])


def _answers(eng, family):
    out = [eng.degrees()]
    for sched in ("ring", "ring_overlap"):
        out += list(eng.neighborhood(2, schedule=sched))
    if family == "hll":
        out.append(eng.union_size(SETS))
    else:
        out.append(eng.distance_histogram(2)[0])
    return [np.asarray(x) for x in out]


def _check(eng, stats, jeng, jstats, family="hll", layout="byte",
           skip=TIMING):
    """Stats and registers equal to the JAX run's; answers equal to a
    one-shot port build bit for bit and to the JAX run's at 1e-5."""
    _same_stats(stats, jstats, skip)
    _same_regs(eng, jeng)
    assert eng.m == jeng.m == len(EDGES)
    ref = engine.build(EDGES, N, _cfgs(family)[0], family=family,
                       layout=layout, device="cpu")
    for got, want, jax_got in zip(_answers(eng, family),
                                  _answers(ref, family),
                                  _answers(jeng, family)):
        np.testing.assert_array_equal(got, want)
        np.testing.assert_allclose(got, jax_got, rtol=1e-5)


# --------------------------------------------------------------- watchdog
SEQUENCES = {
    # (factor, alpha, warmup, step times): the JAX tests' sequences
    "warmup_excludes_cold_compile": (3.0, 0.2, 1, [0.005, 2.0, 0.06]),
    "warmup_zero_over_fires": (3.0, 0.2, 0, [0.005, 2.0]),
    "straggler_after_warmup": (3.0, 0.2, 1, [1.5, 0.05, 0.05, 0.05, 30.0]),
    "ewma_not_poisoned": (2.0, 0.5, 1, [1.0] * 5 + [10.0, 1.0]),
}


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_watchdog_decides_as_the_reference(name):
    factor, alpha, warmup, times = SEQUENCES[name]
    fired = []
    wd = ft.StragglerWatchdog(factor=factor, alpha=alpha, warmup=warmup,
                              on_straggler=lambda dt, e: fired.append(dt))
    jwd = jax_ft.StragglerWatchdog(factor=factor, alpha=alpha,
                                   warmup=warmup)
    got = [wd.observe(dt) for dt in times]
    assert got == [jwd.observe(dt) for dt in times]
    assert (wd.straggler_steps, wd.ewma, wd.seen) == (
        jwd.straggler_steps, jwd.ewma, jwd.seen)
    assert fired == [dt for dt, s in zip(times, got) if s]
    want = {"warmup_excludes_cold_compile": 0, "warmup_zero_over_fires": 1,
            "straggler_after_warmup": 1, "ewma_not_poisoned": 1}[name]
    assert wd.straggler_steps == want


def test_ftconfig_has_the_reference_fields_and_defaults():
    assert ft.FTConfig().__dict__ == jax_ft.FTConfig().__dict__
    assert ft.FTConfig().warmup_steps == 1


def test_runtime_exports_and_the_ft_shim(tmp_path):
    """``repro_torch.runtime`` re-exports the reference's names; the
    ``ft.coordinator`` shim runs the real loop."""
    for name in ("FTConfig", "StragglerWatchdog", "train_loop"):
        assert getattr(runtime, name) is getattr(ft, name)
    assert ft.__all__ == jax_ft.__all__
    assert set(coord.__all__) == set(jax_coord.__all__)
    eng, stats = ft.coordinator(
        EDGES[:256], N, HLLConfig(p=P),
        ft=ft.FTConfig(ckpt_dir=str(tmp_path / "c")),
        config=coord.CoordinatorConfig(hosts=2, block=BLOCK),
        device="cpu")
    assert stats["recoveries"] == 0 and eng.m == 256
    assert stats["checkpoints_written"] == 3  # blocks 1, 3 and the final


# ------------------------------------------------------------- coordinator
@pytest.mark.parametrize("family,layout", [("hll", "byte"),
                                           ("hll", "packed"),
                                           ("ads", "byte")])
def test_kill_host_recovers_as_the_reference(tmp_path, family, layout):
    eng, stats, jeng, jstats = _both(
        tmp_path, [("KillHost", {"host": 2, "at_block": 5})],
        family=family, layout=layout)
    assert stats["recoveries"] == stats["evictions"] == 1
    assert stats["hosts_evicted"] == [2] and stats["hosts_alive"] == 2
    assert stats["blocks_replayed"] >= 1
    assert stats["last_recovery_ms"] is not None
    assert eng.layout == layout and eng.family.name == family
    _check(eng, stats, jeng, jstats, family, layout)


def test_lease_expiry_evicts_the_silent_host(tmp_path):
    eng, stats, jeng, jstats = _both(
        tmp_path, [("DropHeartbeat", {"host": 1, "at_block": 4,
                                      "count": 50})],
        cc={"hosts": 3, "block": BLOCK, "ckpt_every": 2, "lease_blocks": 2})
    assert stats["evictions"] == 1 and stats["hosts_evicted"] == [1]
    assert stats["heartbeats_seen"] > 0
    _check(eng, stats, jeng, jstats)


def test_short_heartbeat_drop_is_absorbed(tmp_path):
    eng, stats, jeng, jstats = _both(
        tmp_path, [("DropHeartbeat", {"host": 1, "at_block": 4,
                                      "count": 2})],
        cc={"hosts": 3, "block": BLOCK, "lease_blocks": 3})
    assert stats["evictions"] == stats["recoveries"] == 0
    _check(eng, stats, jeng, jstats)


def test_slow_host_counts_a_straggler_without_eviction(tmp_path):
    """An injected delay tens of times a block's time on either package
    trips the watchdog; slowness is never loss."""
    eng, stats, jeng, jstats = _both(
        tmp_path, [("SlowHost", {"host": 0, "at_block": 10,
                                 "delay_s": 0.2})],
        cc={"hosts": 2, "block": BLOCK})
    assert stats["straggler_steps"] >= 1 and jstats["straggler_steps"] >= 1
    assert stats["evictions"] == stats["recoveries"] == 0
    _check(eng, stats, jeng, jstats)


def test_loss_during_an_async_write_restores_the_previous_manifest(
        tmp_path):
    """A step directory without a manifest is invisible: recovery lands on
    the complete step-1 checkpoint, which the port wrote, in both
    packages."""
    def pre(ck):
        engine.build(EDGES[:2 * BLOCK], N, HLLConfig(p=P),
                     device="cpu").save(ck, step=1)
        os.makedirs(os.path.join(ck, "step_4"))
        np.save(os.path.join(ck, "step_4", "regs.npy"),
                np.zeros((4, 4), np.uint8))

    eng, stats, jeng, jstats = _both(
        tmp_path, [("KillHost", {"host": 0, "at_block": 6})], pre=pre,
        cc={"hosts": 2, "block": BLOCK, "ckpt_every": 10_000},
        ftkw={"ckpt_every": 10_000})
    assert stats["recoveries"] == 1 and stats["blocks_replayed"] == 4
    _check(eng, stats, jeng, jstats)


def test_double_failure_before_recovery_completes(tmp_path):
    eng, stats, jeng, jstats = _both(
        tmp_path, [("KillHost", {"host": 0, "at_block": 8}),
                   ("KillHost", {"host": 1, "at_block": 6, "at_visit": 2})],
        cc={"hosts": 4, "block": BLOCK, "ckpt_every": 3})
    assert stats["recoveries"] == stats["evictions"] == 2
    assert sorted(stats["hosts_evicted"]) == [0, 1]
    assert stats["hosts_alive"] == 2
    _check(eng, stats, jeng, jstats)


def test_replica_ids_survive_recovery(tmp_path):
    ids = [0, 1, 5, 9]
    eng, stats, jeng, jstats = _both(
        tmp_path, [("KillHost", {"host": 1, "at_block": 5})],
        replicate=ids)
    assert stats["recoveries"] == 1
    np.testing.assert_array_equal(np.sort(eng.replicated_ids), ids)
    np.testing.assert_array_equal(eng.replicated_ids, jeng.replicated_ids)
    _check(eng, stats, jeng, jstats)


def test_cluster_failed_when_too_few_hosts_survive(tmp_path):
    with pytest.raises(coord.ClusterFailed):
        coord.coordinator(
            EDGES, N, HLLConfig(p=P),
            ft=ft.FTConfig(ckpt_dir=str(tmp_path / "ckpt")),
            config=coord.CoordinatorConfig(hosts=2, block=BLOCK,
                                           min_hosts=2),
            faults=_plan(faults, [("KillHost", {"host": 0,
                                                "at_block": 3})]),
            device="cpu")
    with pytest.raises(coord.ClusterFailed, match="max_recoveries"):
        coord.coordinator(
            EDGES, N, HLLConfig(p=P),
            ft=ft.FTConfig(ckpt_dir=str(tmp_path / "ckpt2")),
            config=coord.CoordinatorConfig(hosts=4, block=BLOCK,
                                           max_recoveries=1),
            faults=_plan(faults, [("KillHost", {"host": 0, "at_block": 4}),
                                  ("KillHost", {"host": 1,
                                                "at_block": 9})]),
            device="cpu")


def test_restart_exact_resume_from_a_jax_checkpoint(tmp_path):
    """``run`` restores the newest checkpoint on entry: both packages'
    coordinators resume from a JAX engine's step-3 save and replay only
    the tail."""
    def pre(ck):
        jax_engine.build(EDGES[:4 * BLOCK], N,
                         JaxHLLConfig(p=P)).save(ck, step=3)

    eng, stats, jeng, jstats = _both(tmp_path, pre=pre,
                                     cc={"hosts": 2, "block": BLOCK})
    assert stats["blocks_done"] == -(-len(EDGES) // BLOCK) - 4
    _check(eng, stats, jeng, jstats)


@pytest.mark.parametrize("first", ["jax", "torch"])
def test_coordinators_resume_from_each_others_checkpoints(tmp_path, first):
    """One package's coordinator ingests the first 10 blocks; the other's
    resumes from its final checkpoint to the end. The registers equal a
    one-shot build."""
    ck = str(tmp_path / "ckpt")
    half = EDGES[:10 * BLOCK]  # a final checkpoint on a block boundary
    runs = {
        "torch": lambda e: coord.coordinator(
            e, N, HLLConfig(p=P), ft=ft.FTConfig(ckpt_dir=ck),
            config=coord.CoordinatorConfig(hosts=2, block=BLOCK),
            device="cpu"),
        "jax": lambda e: jax_coord.coordinator(
            e, N, JaxHLLConfig(p=P), ft=jax_ft.FTConfig(ckpt_dir=ck),
            config=jax_coord.CoordinatorConfig(hosts=2, block=BLOCK)),
    }
    second = "jax" if first == "torch" else "torch"
    runs[first](half)
    eng, stats = runs[second](EDGES)
    assert stats["blocks_done"] == (-(-len(EDGES) // BLOCK)
                                    - len(half) // BLOCK)
    assert eng.m == len(EDGES)
    ref = engine.build(EDGES, N, HLLConfig(p=P), device="cpu")
    np.testing.assert_array_equal(np.asarray(eng.regs)[:N],
                                  ref.regs[:N].numpy())


def test_a_failed_attempt_leaves_m_unchanged_and_the_retry_counts_once(
        tmp_path, monkeypatch):
    """A block whose third ingest chunk raises on its first attempt: the
    attempt leaves ``m`` where it was, the retry applies the block once,
    and the run equals a one-shot build."""
    monkeypatch.setattr(engine.LocalEngine, "INGEST_BLOCK", 16)
    real = engine.LocalEngine._accumulate_block
    calls = {"n": 0, "m": []}

    def flaky(self, chunk):
        calls["n"] += 1
        if calls["n"] == 4 * 5 + 3:  # block 5, chunk 3, first attempt
            calls["m"].append(self.m)
            raise RuntimeError("transient device error")
        return real(self, chunk)

    monkeypatch.setattr(engine.LocalEngine, "_accumulate_block", flaky)
    eng, stats = coord.coordinator(
        EDGES, N, HLLConfig(p=P),
        ft=ft.FTConfig(ckpt_dir=str(tmp_path / "ckpt")),
        config=coord.CoordinatorConfig(hosts=2, block=BLOCK), device="cpu")
    assert calls["m"] == [5 * BLOCK]
    assert stats["retries"] == 1 and eng.m == len(EDGES)
    monkeypatch.setattr(engine.LocalEngine, "_accumulate_block", real)
    ref = engine.build(EDGES, N, HLLConfig(p=P), device="cpu")
    assert torch.equal(eng.regs, ref.regs)
    np.testing.assert_array_equal(eng.edges, ref.edges)


def test_a_block_that_keeps_failing_surfaces(tmp_path, monkeypatch):
    """After ``max_retries`` retries the error surfaces; nothing goes on
    without the block."""
    def broken(self, chunk):
        raise RuntimeError("kernel launch failed")

    monkeypatch.setattr(engine.LocalEngine, "_accumulate_block", broken)
    c = coord.Coordinator(EDGES, N, HLLConfig(p=P),
                          ft=ft.FTConfig(ckpt_dir=str(tmp_path / "c")),
                          config=coord.CoordinatorConfig(block=BLOCK),
                          device="cpu")
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        c.run()
    assert c.stats["retries"] == c.ft.max_retries


@pytest.mark.parametrize("layout", ["byte", "packed"])
def test_sharded_kill_reshards_to_three_and_equals_local(tmp_path, layout):
    """4 hosts, sharded; host 2 killed at block 8: the recovered engine
    has 3 shards (rows that do not split evenly three ways), and its
    registers and answers under every schedule equal the port's local
    build bit for bit."""
    eng, stats = coord.coordinator(
        EDGES, N, HLLConfig(p=P),
        ft=ft.FTConfig(ckpt_dir=str(tmp_path / "ckpt")),
        config=coord.CoordinatorConfig(hosts=4, block=BLOCK, ckpt_every=2),
        faults=_plan(faults, [("KillHost", {"host": 2, "at_block": 8})]),
        backend="sharded", layout=layout, replicate=[0, 1, 2, 3],
        device="cpu")
    assert stats["recoveries"] == stats["evictions"] == 1
    assert stats["hosts_alive"] == 3 and eng.shards == 3
    assert N % 3 and eng.m == len(EDGES)
    ref = engine.build(EDGES, N, HLLConfig(p=P), layout=layout,
                       device="cpu")
    assert torch.equal(eng.regs[:N], ref.regs[:N])
    np.testing.assert_array_equal(eng.degrees(), ref.degrees())
    np.testing.assert_array_equal(eng.union_size(SETS), ref.union_size(SETS))
    want = ref.neighborhood(3)
    for sched in ("ring", "ring_overlap", "allgather"):
        for got, exp in zip(eng.neighborhood(3, schedule=sched), want):
            np.testing.assert_array_equal(got, exp)
    np.testing.assert_array_equal(eng.replicated_ids, [0, 1, 2, 3])


def test_smoke_entry_point_on_the_cpu(capsys):
    assert coord._main(["--smoke", "--device", "cpu"]) == 0
    assert "FAILOVER_SMOKE_OK" in capsys.readouterr().out


def test_ring_overlap_in_the_schedule_surface():
    assert "ring_overlap" in SCHEDULES
    sh = engine.build(EDGES, N, HLLConfig(p=P), device="cpu",
                      backend="sharded", shards=1)
    for a, b in zip(sh.neighborhood(2, schedule="ring"),
                    sh.neighborhood(2, schedule="ring_overlap")):
        np.testing.assert_array_equal(a, b)
    loc = engine.build(EDGES[:256], N, HLLConfig(p=P), device="cpu")
    for a, b in zip(loc.neighborhood(2, schedule="ring"),
                    loc.neighborhood(2, schedule="ring_overlap")):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        loc.neighborhood(2, schedule="ring_pipelined")


# -------------------------------------------------------------- train_loop
def _corpus():
    return SyntheticCorpus(vocab_size=10, seq_len=4, global_batch=2)


def _counting_step(calls):
    def step_fn(params, opt, batch, step):
        assert isinstance(step, int)
        calls.append(step)
        params = {"w": params["w"] + 1, "blocks": [
            {"b": b["b"] * 2} for b in params["blocks"]]}
        return params, opt + 1, {"loss": torch.tensor(1.0)}
    return step_fn


def _params():
    return {"w": torch.zeros(()), "blocks": [
        {"b": torch.ones(2, dtype=torch.bfloat16)},
        {"b": torch.ones(3, dtype=torch.float64)}]}


def test_train_loop_restart_exact(tmp_path):
    """Crash mid-run, restart with zeroed state: the loop restores step 6
    into the template's structure and dtypes and runs steps 7 and 8."""
    calls = []
    cfg = ft.FTConfig(ckpt_dir=str(tmp_path), ckpt_every=3, keep=5)
    p, o, hist = ft.train_loop(
        step_fn=_counting_step(calls), params=_params(),
        opt_state=torch.zeros((), dtype=torch.int64), corpus=_corpus(),
        num_steps=7, ft=cfg, log_every=0)
    assert float(p["w"]) == 7 and int(o) == 7 and hist["loss"] == [1.0] * 7
    p2, o2, hist2 = ft.train_loop(
        step_fn=_counting_step(calls), params=_params(),
        opt_state=torch.zeros((), dtype=torch.int64), corpus=_corpus(),
        num_steps=9, ft=cfg, log_every=0)
    assert hist2["restored_from"] == 6 and calls == list(range(7)) + [7, 8]
    assert float(p2["w"]) == 9 and int(o2) == 9
    assert p2["blocks"][0]["b"].dtype == torch.bfloat16
    assert p2["blocks"][0]["b"].tolist() == [2.0 ** 9] * 2
    assert p2["blocks"][1]["b"].dtype == torch.float64
    assert sorted(int(s.split("_")[1]) for s in os.listdir(tmp_path)) == [
        3, 6]


def test_train_loop_retries_then_surfaces(tmp_path):
    failures = {"n": 0}

    def step_fn(params, opt, batch, step):
        if step == 2 and failures["n"] < 1:
            failures["n"] += 1
            raise RuntimeError("transient device error")
        return params, opt, {"loss": 0.5}

    cfg = ft.FTConfig(ckpt_dir=str(tmp_path / "none"), ckpt_every=0)
    _, _, hist = ft.train_loop(step_fn=step_fn, params=torch.zeros(()),
                               opt_state=torch.zeros(()), corpus=_corpus(),
                               num_steps=4, ft=cfg, log_every=0)
    assert hist["retries"] == 1 and hist["loss"] == [0.5] * 4

    def always(params, opt, batch, step):
        raise RuntimeError("kernel launch failed")

    with pytest.raises(RuntimeError, match="kernel launch failed"):
        ft.train_loop(step_fn=always, params=torch.zeros(()),
                      opt_state=torch.zeros(()), corpus=_corpus(),
                      num_steps=2, ft=cfg, log_every=0)


def test_train_loop_moves_batches_and_sees_the_reference_batches(tmp_path):
    seen = []

    def step_fn(params, opt, batch, step):
        seen.append(batch)
        return params, opt, {"loss": 0.0}

    ft.train_loop(step_fn=step_fn, params=torch.zeros(()),
                  opt_state=torch.zeros(()), corpus=_corpus(), num_steps=3,
                  ft=ft.FTConfig(ckpt_dir=str(tmp_path), ckpt_every=0),
                  to_device=lambda b: {k: torch.from_numpy(v)
                                       for k, v in b.items()},
                  log_every=0)
    jc = JaxCorpus(vocab_size=10, seq_len=4, global_batch=2)
    for step, batch in enumerate(seen):
        for k, v in jc.batch(step).items():
            np.testing.assert_array_equal(batch[k].numpy(), v)


@pytest.mark.parametrize("first", ["jax", "torch"])
def test_train_loops_resume_from_each_others_checkpoints(tmp_path, first):
    """Either package's ``train_loop`` resumes the other's run: the same
    leaf keys, a ``bfloat16`` leaf included."""
    def jax_step(params, opt, batch, step):
        return ({"w": params["w"] + 1,
                 "blocks": [{"b": params["blocks"][0]["b"] * 2}]},
                opt + 1, {"loss": jnp.asarray(1.0)})

    def torch_step(params, opt, batch, step):
        return ({"w": params["w"] + 1,
                 "blocks": [{"b": params["blocks"][0]["b"] * 2}]},
                opt + 1, {"loss": torch.tensor(1.0)})

    loops = {
        "jax": lambda n: jax_ft.train_loop(
            step_fn=jax_step, params={"w": jnp.zeros(()), "blocks": [
                {"b": jnp.ones(2, jnp.bfloat16)}]},
            opt_state=jnp.zeros((), jnp.int32), corpus=_corpus(),
            num_steps=n, ft=jax_ft.FTConfig(ckpt_dir=str(tmp_path),
                                            ckpt_every=2), log_every=0),
        "torch": lambda n: ft.train_loop(
            step_fn=torch_step, params={"w": torch.zeros(()), "blocks": [
                {"b": torch.ones(2, dtype=torch.bfloat16)}]},
            opt_state=torch.zeros((), dtype=torch.int32), corpus=_corpus(),
            num_steps=n, ft=ft.FTConfig(ckpt_dir=str(tmp_path),
                                        ckpt_every=2), log_every=0),
    }
    second = "jax" if first == "torch" else "torch"
    loops[first](5)
    p, o, hist = loops[second](7)
    assert hist["restored_from"] == 4
    assert float(p["w"]) == 7 and int(o) == 7
    b = p["blocks"][0]["b"]
    b = (b.float().numpy() if isinstance(b, torch.Tensor)
         else np.asarray(b).astype(np.float32))
    assert b.tolist() == [128.0, 128.0]


def test_checkpoint_trees_keep_the_reference_keys(tmp_path):
    """Nested trees are keyed as the JAX package keys them, restore into
    a template's structure, and a key the step lacks raises."""
    from repro.ckpt import checkpoint as jax_ckpt
    from repro_torch.ckpt import checkpoint as ckpt
    tree = {"b": [torch.arange(3, dtype=torch.int32), (np.ones(2, np.float32), 4)],
            "a": torch.tensor(2.5, dtype=torch.bfloat16), "none": None}
    ckpt.save_checkpoint(str(tmp_path / "t"), 1, tree)
    jtree = {"b": [jnp.arange(3), (jnp.ones(2, jnp.float32), 4)],
             "a": jnp.asarray(2.5, jnp.bfloat16), "none": None}
    jax_ckpt.save_checkpoint(str(tmp_path / "j"), 1, jtree)
    assert (ckpt.read_manifest(str(tmp_path / "t"), 1)["leaves"]
            == ckpt.read_manifest(str(tmp_path / "j"), 1)["leaves"])
    for d in ("t", "j"):
        back = ckpt.restore_checkpoint(str(tmp_path / d), 1, tree)
        assert back["none"] is None and back["b"][1][1] == 4
        assert isinstance(back["b"][1], tuple)
        assert torch.equal(back["b"][0], tree["b"][0])
        assert back["a"].dtype == torch.bfloat16 and float(back["a"]) == 2.5
        np.testing.assert_array_equal(back["b"][1][0], np.ones(2))
        got = jax_ckpt.restore_checkpoint(str(tmp_path / d), 1, jtree)
        assert float(got["a"]) == 2.5
    with pytest.raises(ValueError, match="bfloat16"):
        ckpt.restore_checkpoint(str(tmp_path / "t"), 1)
    with pytest.raises(KeyError, match="missing"):
        ckpt.restore_checkpoint(str(tmp_path / "t"), 1, {"missing": 0})
    shutil.rmtree(tmp_path / "t")
