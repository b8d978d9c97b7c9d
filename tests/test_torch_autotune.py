"""The port's autotune table (``repro_torch.kernels.autotune``) on the CPU.

Mirrors ``tests/test_autotune.py``'s determinism rules with the port's
impl names ("cuda", "ref"): a repeat sweep of one ``(device_kind, p, op,
impl, layout, size_class)`` key is a cache hit; off the card a sweep
installs the fallback table and times nothing; unknown entries degrade
to ``{}`` / ``None``; an explicit block value wins. Then what the port
adds: a winner applying to its own size class only, the fallback kept
unless a candidate beats it by more than ``WIN_MARGIN``, the
table's shape against the JAX module's, every block value of every op
and layout dispatching to the same answer as ``None`` and as the JAX
``ops.*`` at ``impl="ref"`` (registers byte for byte, statistics at the
tolerances of ``tests/test_torch_kernels.py`` and
``tests/test_torch_union.py``), a wrapper refusing an off-grid value on
the CPU, and the launchers' extra argument. The card's sweep and every
candidate on the card are in ``tests/test_torch_cuda.py``.
"""
import ctypes

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.ads import ADSConfig as JaxADSConfig  # noqa: E402
from repro.core.hll import HLLConfig as JaxConfig  # noqa: E402
from repro.kernels import autotune as jax_autotune  # noqa: E402
from repro.kernels import ops as jax_ops  # noqa: E402
from repro.kernels import packing as jax_packing  # noqa: E402
from repro_torch.core.hll import HLLConfig  # noqa: E402
from repro_torch.kernels import _build, autotune, ops, registry  # noqa: E402
from repro_torch.kernels import ertl_stats, hip_delta  # noqa: E402
from repro_torch.kernels import hll_accumulate, hll_estimate  # noqa: E402
from repro_torch.kernels import hll_propagate  # noqa: E402
from repro_torch.kernels import intersection_stats  # noqa: E402
from repro_torch.kernels import union_estimate  # noqa: E402

P = 6
LAYOUT_OPS = [(op, layout) for op in autotune.SWEEPS
              for layout in ("byte", "packed")
              if not (op == "hip_delta" and layout == "packed")]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file (the parallel suite shares the
    cores between files)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _fresh_cache():
    """Each test starts from an empty winner cache and no launch count,
    and launches nothing (every tensor here lies on the CPU)."""
    autotune.clear_cache()
    _build.reset_launch_counts()
    yield
    autotune.clear_cache()
    assert set(_build.launch_counts().values()) == {0}


def test_sweep_winner_stable_across_two_sweeps():
    """A second sweep of the same key returns the cached winner and
    drives nothing."""
    first = autotune.sweep("accumulate", p=8, impl="cuda", layout="packed")
    drives = autotune.drive_count()
    second = autotune.sweep("accumulate", p=8, impl="cuda", layout="packed")
    assert first == second
    assert autotune.drive_count() == drives


def test_off_card_sweep_resolves_from_fallback_without_driving():
    """Without a card every sweep installs the fallback table and times
    nothing, for every op and layout."""
    assert not torch.cuda.is_available()  # this suite runs off the card
    before = autotune.drive_count()
    for op, layout in LAYOUT_OPS:
        assert autotune.sweep(op, p=8, layout=layout) == autotune.FALLBACK[op]
        assert autotune.sweep_times(op, p=8, layout=layout) == []
    assert autotune.drive_count() == before == 0


def test_cache_key_carries_all_coordinates():
    key = autotune.cache_key("estimate", 12, "cuda", "packed")
    # the reference's five coordinates, then the size class of the default
    # sweep shape's 2^20 rows
    assert key == (autotune.device_kind(), 12, "estimate", "cuda", "packed",
                   20)
    assert autotune.device_kind() == "cpu"
    # distinct layouts, impls, p and size classes never collide
    assert key != autotune.cache_key("estimate", 12, "cuda", "byte")
    assert key != autotune.cache_key("estimate", 12, "ref", "packed")
    assert key != autotune.cache_key("estimate", 8, "cuda", "packed")
    assert key != autotune.cache_key("hip_delta", 12, "cuda", "packed", 1)
    assert key != autotune.cache_key("estimate", 12, "cuda", "packed",
                                     1 << 22)
    assert key == autotune.cache_key("estimate", 12, "cuda", "packed",
                                     (1 << 19) + 1)


@pytest.mark.parametrize("n,cls", [(0, 0), (1, 0), (2, 1), (3, 2), (4, 2),
                                   (5, 3), (4096, 12), (16384, 14),
                                   ((1 << 22) - 1, 22), (1 << 22, 22),
                                   ((1 << 22) + 1, 23), (128302398, 27)])
def test_size_class_is_the_ceiling_log2(n, cls):
    assert autotune.size_class(n) == cls


def test_work_size_reads_each_op_s_work_argument():
    """Edges for accumulate and propagate, rows for estimate, hip_delta
    and ertl_stats, sets for union_estimate, pairs for
    intersection_stats."""
    regs = torch.zeros((10, 16), dtype=torch.uint8)
    e7 = torch.zeros(7, dtype=torch.int32)
    want = {"accumulate": ((regs, e7, e7), 7), "propagate": ((regs, e7, e7), 7),
            "estimate": ((regs,), 10), "hip_delta": ((regs, regs), 10),
            "union_estimate": ((regs, torch.zeros((3, 5)),
                                torch.zeros((3, 5))), 3),
            "intersection_stats": ((regs, torch.zeros((6, 2))), 6),
            "ertl_stats": ((regs[:4], regs[:4]), 4)}
    assert set(want) == set(autotune.SWEEPS) == set(autotune.WORK_ARG)
    for op, (inputs, n) in want.items():
        assert autotune.work_size(op, inputs) == n


def test_winner_applies_only_to_its_size_class():
    """A winner swept at one size never reaches a call of another: the
    main path's 4,194,304-row estimate keeps the fallback after a sweep
    at 2^20 rows, and takes its own class's winner."""
    fb = autotune.FALLBACK["estimate"]["row_block"]
    autotune._CACHE[autotune.cache_key("estimate", 8, size=1 << 20)] = {
        "row_block": 128}
    assert autotune.resolve_block("estimate", "row_block", None, p=8,
                                  size=1 << 20) == 128
    assert autotune.resolve_block("estimate", "row_block", None, p=8,
                                  size=(1 << 19) + 3) == 128
    assert autotune.resolve_block("estimate", "row_block", None, p=8,
                                  size=1 << 22) == fb
    assert autotune.resolve_block("estimate", "row_block", None, p=8,
                                  size=1 << 18) == fb
    autotune._CACHE[autotune.cache_key("estimate", 8, size=1 << 22)] = {
        "row_block": 256}
    assert autotune.tuned_params("estimate", p=8, size=1 << 22) == {
        "row_block": 256}
    assert autotune.tuned_params("estimate", p=8) == {"row_block": 128}


def test_ops_resolve_by_the_call_s_size_class():
    """``ops.estimate`` passes its row count: a winner cached for another
    size class is never handed to the wrapper."""
    seen = []
    real = ops.hll_estimate_stats

    def spy(regs, *, layout, row_block):
        seen.append(row_block)
        return real(regs, layout=layout, row_block=row_block)
    regs = torch.zeros((40, 1 << P), dtype=torch.uint8)
    autotune._CACHE[autotune.cache_key("estimate", P, size=1 << 20)] = {
        "row_block": 128}
    autotune._CACHE[autotune.cache_key("estimate", P, size=40)] = {
        "row_block": 256}
    try:
        ops.hll_estimate_stats = spy
        ops.estimate(regs, HLLConfig(p=P))
        ops.estimate(regs[:3], HLLConfig(p=P))
    finally:
        ops.hll_estimate_stats = real
    assert seen == [256, autotune.FALLBACK["estimate"]["row_block"]]


@pytest.mark.parametrize("op", sorted(autotune.SWEEPS))
def test_pick_winner_keeps_the_fallback_within_the_margin(op):
    """A candidate replaces the fallback only when it is faster by more
    than ``WIN_MARGIN``; then the fastest wins."""
    (name,) = autotune.FALLBACK[op]
    grid = autotune.SWEEPS[op]
    fb = autotune.FALLBACK[op]
    near = [(c, 1.0 if c == fb else 1.0 - 0.9 * autotune.WIN_MARGIN)
            for c in grid]
    assert autotune.pick_winner(op, near) == fb
    others = [c for c in grid if c != fb]
    far = [(c, 1.0 if c == fb else 0.9 - 0.01 * i)
           for i, c in enumerate(grid)]
    want = min(far, key=lambda t: t[1])[0]
    assert want in others
    assert autotune.pick_winner(op, far) == want
    slower = [(c, 1.0 if c == fb else 1.5) for c in grid]
    assert autotune.pick_winner(op, slower) == fb


def test_off_card_sweep_on_given_inputs_installs_the_fallback():
    """``sweep(inputs=...)`` off the card files the fallback under the
    inputs' size class and drives nothing."""
    regs = torch.zeros((1000, 1 << P), dtype=torch.uint8)
    got = autotune.sweep("estimate", p=P, inputs=(regs,))
    assert got == autotune.FALLBACK["estimate"]
    assert autotune.cache_key("estimate", P, size=1000) in autotune._CACHE
    assert autotune.cache_key("estimate", P) not in autotune._CACHE
    assert autotune.sweep_times("estimate", p=P, size=1000) == []
    assert autotune.drive_count() == 0


def test_unknown_entry_degrades_gracefully():
    """A lookup miss returns empty parameters, never raises."""
    assert autotune.tuned_params("no_such_op", p=8) == {}
    assert autotune.resolve_block("no_such_op", "edge_block", None,
                                  p=8) is None
    assert autotune.resolve_block("estimate", "no_such_arg", None,
                                  p=8) is None
    assert autotune.sweep("no_such_op", p=8) == {}  # no candidates: no-op
    assert autotune.drive_count() == 0


def test_explicit_block_value_wins_over_cache():
    autotune._CACHE[autotune.cache_key("estimate", 8)] = {"row_block": 256}
    assert autotune.resolve_block("estimate", "row_block", 128, p=8) == 128
    assert autotune.resolve_block("estimate", "row_block", None, p=8) == 256
    assert autotune.tuned_params("estimate", p=8) == {"row_block": 256}
    # another p, layout or impl keeps the fallback
    assert (autotune.resolve_block("estimate", "row_block", None, p=9)
            == autotune.resolve_block("estimate", "row_block", None, p=8,
                                      layout="packed")
            == autotune.resolve_block("estimate", "row_block", None, p=8,
                                      impl="ref")
            == autotune.FALLBACK["estimate"]["row_block"])


def test_ref_impl_never_drives():
    """``impl="ref"`` installs the fallback, even for a key already
    holding a winner under "cuda"."""
    autotune._CACHE[autotune.cache_key("propagate", 8)] = {"edge_block": 256}
    for op, layout in LAYOUT_OPS:
        assert (autotune.sweep(op, p=8, impl="ref", layout=layout)
                == autotune.FALLBACK[op])
        assert (autotune.sweep(op, p=8, impl="ref", layout=layout,
                               force=True) == autotune.FALLBACK[op])
    assert autotune.tuned_params("propagate", p=8) == {"edge_block": 256}
    assert autotune.drive_count() == 0


def test_table_shape_matches_the_jax_module():
    """The same ops in FALLBACK and SWEEPS, one argument an op with the
    JAX name, and each fallback value inside its own grid."""
    assert set(autotune.FALLBACK) == set(jax_autotune.FALLBACK)
    assert set(autotune.SWEEPS) == set(jax_autotune.SWEEPS)
    assert set(autotune.SWEEPS) == set(autotune.FALLBACK)
    for op, fallback in autotune.FALLBACK.items():
        assert list(fallback) == list(jax_autotune.FALLBACK[op])
        (name,) = fallback
        grid = [c[name] for c in autotune.SWEEPS[op]]
        assert all(list(c) == [name] for c in autotune.SWEEPS[op])
        assert {list(c)[0] for c in jax_autotune.SWEEPS[op]} == {name}
        assert fallback[name] in grid
        assert len(set(grid)) == len(grid) >= 3
    assert set(autotune.__all__) >= set(jax_autotune.__all__)


def test_launchers_take_the_block_argument():
    """The 13 tuned launchers take their block as the int before the
    stream; the two-panel ones keep their 64-bit run length, and the
    Newton launcher, not tuned, its iteration count."""
    want = {"hll_accumulate": 11, "hll_estimate_stats": 6,
            "hll_propagate": 9, "intersection_stats": 11,
            "union_estimate_stats": 10, "ertl_stats": 8,
            "hip_delta_rows": 7}
    untuned = ("hll_propagate_into", "hll_propagate_into_packed",
               "intersection_newton")
    tuned = [name for name in _build.KERNELS if name not in untuned]
    assert len(tuned) == 13
    for name in tuned:
        types = _build.KERNELS[name]
        assert len(types) == want[name.removesuffix("_packed")]
        assert types[-2] is ctypes.c_int and types[-1] is ctypes.c_void_p
    for name in ("hll_propagate_into", "hll_propagate_into_packed"):
        assert _build.KERNELS[name][-2] is ctypes.c_int64


def _wrapper_calls(rng):
    """op -> (its block argument, a call of its wrapper on CPU tensors
    taking that argument as a keyword)."""
    regs = torch.from_numpy(rng.integers(0, 9, (16, 1 << P)).astype(np.uint8))
    ids = torch.from_numpy(rng.integers(0, 16, 20).astype(np.int32))
    keys = ids.to(torch.int64).to(torch.uint32)
    sets = torch.from_numpy(rng.integers(0, 16, (3, 4)).astype(np.int32))
    mask = torch.ones((3, 4), dtype=torch.bool)
    return {
        "accumulate": ("edge_block", lambda **kw: hll_accumulate.
                       hll_accumulate(regs.clone(), ids, keys, p=P, **kw)),
        "propagate": ("edge_block", lambda **kw: hll_propagate.hll_propagate(
            regs, ids, ids.sort().values, **kw)),
        "estimate": ("row_block", lambda **kw: hll_estimate.
                     hll_estimate_stats(regs, **kw)),
        "union_estimate": ("set_block", lambda **kw: union_estimate.
                           union_estimate_stats(regs, sets, mask, **kw)),
        "intersection_stats": ("pair_block", lambda **kw: intersection_stats.
                               intersection_stats(regs, ids, ids.flip(0),
                                                  64 - P, **kw)),
        "ertl_stats": ("pair_block", lambda **kw: ertl_stats.ertl_stats(
            regs, regs.flip(0).contiguous(), 64 - P, **kw)),
        "hip_delta": ("row_block", lambda **kw: hip_delta.hip_delta_rows(
            regs, regs, **kw)),
    }


@pytest.mark.parametrize("op", sorted(autotune.SWEEPS))
def test_wrapper_refuses_an_off_grid_block_on_the_cpu(op):
    """Each wrapper checks its block against the op's grid before it
    picks the plain version: a bad value raises on the CPU, naming the
    grid; a grid value and ``None`` run."""
    name, call = _wrapper_calls(np.random.default_rng(1))[op]
    grid = [c[name] for c in autotune.SWEEPS[op]]
    for bad in (0, 3, max(grid) * 2, -grid[0]):
        with pytest.raises(ValueError, match=str(grid).replace("[", r"\[")):
            call(**{name: bad})
    want = call()
    for value in grid:
        got = call(**{name: value})
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            assert torch.equal(g, w)


def _case(op, layout, rng):
    """(port call(**block), JAX ``ops`` call at impl="ref", compare, the
    call's work count) for one op and layout at a small size; the port's
    call takes fresh copies of its inputs."""
    return (*_case_calls(op, layout, rng),
            {"accumulate": 600, "propagate": 600, "union_estimate": 9,
             "intersection_stats": 11}.get(op, 48))


def _case_calls(op, layout, rng):
    """``_case`` without the work count."""
    v, e = 48, 600
    jcfg, cfg = JaxConfig(p=P), HLLConfig(p=P)
    full = rng.integers(0, 12, (v, 1 << P)).astype(np.uint8)
    regs = (np.asarray(jax_packing.pack_rows(jnp.asarray(full)))
            if layout == "packed" else full)

    def t(x):
        return torch.from_numpy(np.array(x))
    if op == "accumulate":
        rows = rng.integers(0, v, e).astype(np.int32)
        keys = rng.integers(0, 2 ** 32, e, dtype=np.uint64).astype(np.uint32)
        mask = rng.random(e) > 0.2
        want = jax_ops.accumulate(jnp.asarray(regs), jnp.asarray(rows),
                                  jnp.asarray(keys), jcfg,
                                  mask=jnp.asarray(mask), impl="ref",
                                  layout=layout)
        return (lambda **kw: ops.accumulate(t(regs), t(rows), t(keys), cfg,
                                            mask=t(mask), layout=layout,
                                            **kw), want, "exact")
    if op == "propagate":
        src = rng.integers(0, v, e).astype(np.int32)
        dst = rng.integers(0, v, e).astype(np.int32)
        want = jax_ops.propagate(jnp.asarray(regs), jnp.asarray(src),
                                 jnp.asarray(dst), impl="ref", layout=layout)
        return (lambda **kw: ops.propagate(t(regs), t(src), t(dst),
                                           layout=layout, **kw), want,
                "exact")
    if op == "estimate":
        want = jax_ops.estimate(jnp.asarray(regs), jcfg, impl="ref",
                                layout=layout)
        return (lambda **kw: ops.estimate(t(regs), cfg, layout=layout, **kw),
                want, 1e-6)
    if op == "union_estimate":
        ids = rng.integers(0, v, (9, 7)).astype(np.int32)
        mask = rng.random((9, 7)) > 0.3
        want = jax_ops.union_estimate(jnp.asarray(regs), jnp.asarray(ids),
                                      jnp.asarray(mask), jcfg, impl="ref",
                                      layout=layout)
        return (lambda **kw: ops.union_estimate(t(regs), t(ids), t(mask), cfg,
                                                layout=layout, **kw), want,
                1e-5)
    if op == "intersection_stats":
        pairs = rng.integers(0, v, (11, 2)).astype(np.int32)
        want = jax_ops.intersection_stats(jnp.asarray(regs),
                                          jnp.asarray(pairs), jcfg,
                                          impl="ref", layout=layout)
        return (lambda **kw: ops.intersection_stats(t(regs), t(pairs), cfg,
                                                    layout=layout, **kw),
                want, "pair")
    if op == "ertl_stats":
        other = np.ascontiguousarray(regs[::-1])
        want = jax_ops.ertl_stats(jnp.asarray(regs), jnp.asarray(other), jcfg,
                                  impl="ref", layout=layout)
        return (lambda **kw: ops.ertl_stats(t(regs), t(other), cfg,
                                            layout=layout, **kw), want,
                "exact")
    # hip_delta: registers below 13, where XLA's CPU exp2 is exact
    cur = np.maximum(regs, rng.integers(0, 12, regs.shape).astype(np.uint8))
    want = jax_ops.hip_delta(jnp.asarray(regs), jnp.asarray(cur), impl="ref")
    assert JaxADSConfig(p=P).r == cfg.r
    return (lambda **kw: ops.hip_delta(t(regs), t(cur), **kw), want, "exact")


def _same(got, want, how):
    if how == "exact":
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    elif how == "pair":
        (stats, sz), (w_stats, w_sz) = got, want
        np.testing.assert_array_equal(stats.numpy(), np.asarray(w_stats))
        np.testing.assert_array_equal(sz[..., 1].numpy(),
                                      np.asarray(w_sz)[..., 1])
        np.testing.assert_allclose(sz[..., 0].numpy(),
                                   np.asarray(w_sz)[..., 0], rtol=1e-6)
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=how,
                                   atol=1e-6)


@pytest.mark.parametrize("op,layout", LAYOUT_OPS)
def test_dispatch_with_autotuned_blocks_matches_explicit_and_jax(op, layout):
    """``ops.<op>`` with its block left ``None`` (the autotune path), with
    a cached winner, and with each grid value explicit, all equal one
    another bit for bit and the JAX ``ops.<op>`` at ``impl="ref"``."""
    call, want, how, size = _case(op, layout, np.random.default_rng(len(op)))
    name = list(autotune.FALLBACK[op])[0]
    auto = call()
    _same(auto, want, how)
    every = [auto]
    for value in [c[name] for c in autotune.SWEEPS[op]]:
        every.append(call(**{name: value}))
        autotune._CACHE[autotune.cache_key(op, P, "cuda", layout, size)] = {
            name: value}
        every.append(call())
        autotune.clear_cache()
    for got in every[1:]:
        for g, a in zip(got if isinstance(got, tuple) else (got,),
                        auto if isinstance(auto, tuple) else (auto,)):
            assert torch.equal(g, a)
    ref_call = call(impl="ref")
    _same(ref_call, want, how)


def test_kernel_set_passes_block_arguments_on():
    """``KernelSet`` methods take the JAX ``OpSet``'s block keywords and
    hand them to ``kernels.ops``."""
    import inspect
    ks = registry.KernelSet("cuda", "byte", "hll")
    for method, name in (("accumulate", "edge_block"),
                         ("propagate", "edge_block"),
                         ("ertl_stats", "pair_block"),
                         ("union_estimate", "set_block"),
                         ("intersection_stats", "pair_block"),
                         ("hip_delta", "row_block")):
        params = inspect.signature(getattr(ks, method)).parameters
        assert params[name].default is None
    rng = np.random.default_rng(2)
    regs = torch.from_numpy(rng.integers(0, 9, (16, 1 << P)).astype(np.uint8))
    pairs = torch.from_numpy(rng.integers(0, 16, (5, 2)).astype(np.int32))
    cfg = HLLConfig(p=P)
    want = ks.intersection_stats(regs, pairs, cfg)
    got = ks.intersection_stats(regs, pairs, cfg, pair_block=1)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    with pytest.raises(ValueError, match="grid"):
        ks.intersection_stats(regs, pairs, cfg, pair_block=3)
    with pytest.raises(ValueError, match="grid"):
        ks.propagate(regs, pairs[:, 0].contiguous(),
                     pairs[:, 1].sort().values, edge_block=100)
