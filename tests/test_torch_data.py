"""Port parity: the data layer (``repro_torch.data``).

``SyntheticCorpus`` batches equal the JAX package's arrays exactly, for
several seeds, steps, shards and shard counts. ``NGramSketch``'s window
hashes equal the JAX rolled hash bit for bit and its sketches byte for
byte; ``RoutingSketch``'s tables equal the JAX tables byte for byte, its
coverage the JAX estimates at ``rtol=1e-6`` and its ``collapse_score``
(one MLE over every pair) the JAX pair-by-pair matrix within 1e-4. The
JAX tests' accuracy cases (``tests/test_substrate.py``) run on the port.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.hashing import fmix32 as jax_fmix32  # noqa: E402
from repro.core.hll import HLLConfig as JaxHLLConfig  # noqa: E402
from repro.data import pipeline as jax_pipeline  # noqa: E402
from repro.data import telemetry as jax_telemetry  # noqa: E402
from repro_torch import data  # noqa: E402
from repro_torch.core.hll import HLLConfig, rel_std  # noqa: E402
from repro_torch.data import pipeline, telemetry  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file: the parallel suite runs a whole
    file in one worker, and this file's many small tensor ops would
    otherwise oversubscribe the cores the other workers share."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_exports_match_the_reference():
    import repro.data as jax_data
    for name in ("SyntheticCorpus", "batch_for_step", "RoutingSketch",
                 "NGramSketch"):
        assert hasattr(jax_data, name) and hasattr(data, name)
    assert pipeline.__all__ == jax_pipeline.__all__
    assert telemetry.__all__ == jax_telemetry.__all__


# ---------------------------------------------------------------- pipeline
@pytest.mark.parametrize("seed,step,num_shards,shard,kw", [
    (0, 0, 1, 0, {}),
    (1, 5, 2, 1, {}),
    (7, 123, 4, 3, {"zipf_a": 1.1, "state_period": 16}),
    (3, 2, 8, 0, {}),
])
def test_corpus_batches_equal_the_reference(seed, step, num_shards, shard,
                                            kw):
    args = dict(vocab_size=500, seq_len=33, global_batch=16, seed=seed,
                num_shards=num_shards, shard=shard, **kw)
    got = pipeline.batch_for_step(pipeline.SyntheticCorpus(**args), step)
    want = jax_pipeline.batch_for_step(jax_pipeline.SyntheticCorpus(**args),
                                       step)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    assert got["tokens"].shape == (16 // num_shards, 33)


def test_corpus_is_deterministic_sharded_and_shifted():
    c = pipeline.SyntheticCorpus(vocab_size=100, seq_len=16, global_batch=8,
                                 seed=1)
    b = c.batch(5)
    np.testing.assert_array_equal(b["tokens"], c.batch(5)["tokens"])
    assert not np.array_equal(c.batch(6)["tokens"], b["tokens"])
    s0, s1 = (pipeline.SyntheticCorpus(vocab_size=100, seq_len=16,
                                       global_batch=8, seed=1, num_shards=2,
                                       shard=s).batch(0) for s in (0, 1))
    assert not np.array_equal(s0["tokens"], s1["tokens"])
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


# ---------------------------------------------------------------- n-grams
def _jax_window_hashes(tokens, n):
    """The JAX ``NGramSketch.update``'s rolled hash, spelled out."""
    toks = jnp.asarray(tokens).astype(jnp.uint32)
    width = toks.shape[-1] - n + 1
    h = jax_fmix32(toks[..., :width])
    for i in range(1, n):
        h = jax_fmix32(h ^ (toks[..., i:width + i] * jnp.uint32(0x9E3779B9)))
    return np.asarray(h)


@pytest.mark.parametrize("n,p", [(1, 8), (2, 12), (3, 6)])
def test_ngram_hashes_and_sketches_equal_the_reference(n, p):
    rng = np.random.default_rng(n)
    tokens = rng.integers(0, 1 << 31, size=(3, 97)).astype(np.int32)
    tokens[0, :5] = [-1, -7, 0, 2 ** 31 - 1, -2 ** 31]  # every uint32 bit
    ns = telemetry.NGramSketch(n=n, cfg=HLLConfig(p=p))
    h = telemetry._window_hashes(
        telemetry._int64_on(tokens, torch.device("cpu")), n)
    np.testing.assert_array_equal(h.numpy().astype(np.uint32),
                                  _jax_window_hashes(tokens, n))
    assert h.shape == (3, 97 - n + 1)
    jns = jax_telemetry.NGramSketch(n=n, cfg=JaxHLLConfig(p=p))
    sk = ns.update(ns.init(device="cpu"), tokens)
    jsk = jns.update(jns.init(), jnp.asarray(tokens))
    np.testing.assert_array_equal(sk.numpy(), np.asarray(jsk))
    np.testing.assert_allclose(ns.distinct(sk), jns.distinct(jsk),
                               rtol=1e-6)
    assert ns.init(device="cpu").shape == (1 << p,)


def test_ngram_sketch_counts_windows_and_merges_across_shards():
    ns = telemetry.NGramSketch(n=2, cfg=HLLConfig(p=12))
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, 1000, size=(4, 256)))
    sk = ns.update(ns.init(device="cpu"), toks)
    assert ns.distinct(sk) == pytest.approx(4 * 255, rel=0.15)
    parts = [ns.update(ns.init(device="cpu"), toks[i:i + 1])
             for i in range(4)]
    merged = parts[0]
    for part in parts[1:]:
        merged = ns.merge(merged, part)
    assert torch.equal(merged, sk)


# ---------------------------------------------------------------- routing
def _routing(rng, experts, t, k):
    """Seeded top-k assignments of ``t`` tokens, distinct experts a row."""
    ids = np.argsort(rng.random((t, experts)), axis=1)[:, :k]
    return ids.astype(np.int32), rng.integers(0, 1 << 32, t).astype(
        np.uint32)


@pytest.mark.parametrize("p", [6, 10])
def test_routing_tables_coverage_and_collapse_equal_the_reference(p):
    rng = np.random.default_rng(p)
    ids, toks = _routing(rng, 5, 3000, 2)
    rs = telemetry.RoutingSketch(num_experts=5, cfg=HLLConfig(p=p))
    jrs = jax_telemetry.RoutingSketch(num_experts=5, cfg=JaxHLLConfig(p=p))
    table = rs.init(device="cpu")
    jtable = jrs.init()
    for lo in (0, 1000):  # two updates, one as arrays and one as tensors
        sl = slice(lo, lo + 1000 if lo == 0 else None)
        table = (rs.update(table, ids[sl], toks[sl]) if lo == 0 else
                 rs.update(table, torch.from_numpy(ids[sl]),
                           torch.from_numpy(toks[sl])))
        jtable = jrs.update(jtable, jnp.asarray(ids[sl]),
                            jnp.asarray(toks[sl]))
    np.testing.assert_array_equal(table.numpy(), np.asarray(jtable))
    np.testing.assert_allclose(rs.coverage(table).numpy(),
                               np.asarray(jrs.coverage(jtable)), rtol=1e-6)
    jac = rs.collapse_score(table)
    want = jrs.collapse_score(jtable)
    assert jac.shape == (5, 5) and np.all(np.diag(jac) == 0)
    np.testing.assert_allclose(jac, want, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(jac, jac.T)
    assert rs.overlap(table, 0, 1) == pytest.approx(
        jrs.overlap(jtable, 0, 1), rel=1e-4)


def test_routing_sketch_flags_a_collapsed_pair():
    """The JAX test's case: experts 0 and 1 see the same 2,000 tokens,
    expert 2 others, expert 3 none."""
    rs = telemetry.RoutingSketch(num_experts=4, cfg=HLLConfig(p=10))
    table = rs.init(device="cpu")
    rng = np.random.default_rng(0)
    shared = rng.integers(0, 1 << 30, size=2000).astype(np.uint32)
    distinct = (rng.integers(0, 1 << 30, size=2000) | (1 << 31)).astype(
        np.uint32)
    for e, toks in [(0, shared), (1, shared), (2, distinct)]:
        table = rs.update(table, np.full((len(toks), 1), e, np.int32), toks)
    cov = rs.coverage(table).numpy()
    assert abs(cov[0] - 2000) / 2000 < 3 * rel_std(10) and cov[3] == 0.0
    jac = rs.collapse_score(table)
    assert jac[0, 1] > 0.6 and jac[0, 2] < 0.2
