"""Port parity: the two-panel merge and the run length of its kernel.

* ``hll_propagate.plain_into(out, src_panel, src, dst)`` against the JAX
  package's ``packing.scatter_max_rows(out, dst, src_panel[src], layout)``,
  the plain jnp merge step of its sharded schedules: two panels of their
  own row counts, ``src == dst`` pairs (two different vertices, never
  skipped), a hub segment, an empty routing, both layouts, several p.
  Exactly equal (integer registers).
* ``hll_propagate.run_edges``, the run length the wrapper hands the
  card's kernel: a power of two within the kernel's limits, at least one
  run for any routing, and several waves of runs at the three shapes
  ``chip_smoke.py`` phase 4 gives the kernel (shard 0 of 4 of the scale-22
  panel) on the H100's 132 SMs.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import packing as jax_packing  # noqa: E402
from repro_torch.kernels import _build, hll_propagate, packing  # noqa: E402

#: the H100's SMs, and phase 4's shapes: a ring step (block 1 into shard
#: 0 plus 4,096 self-index pairs), the all-gather merge of shard 0 and
#: its replica pre-pass (1,024 source rows)
H100_SMS = 132
PHASE4_EDGES = {"ring": 7_884_172, "allgather": 31_859_448,
                "replica": 3_626_017}
#: warps one SM holds at once
WARPS_PER_SM = 64


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file (the parallel suite shares the
    cores between files)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _no_launches():
    """Every call here takes the plain version: no launch is counted."""
    _build.reset_launch_counts()
    yield
    assert set(_build.launch_counts().values()) == {0}


def _panel(rng, v, p, layout):
    regs = rng.integers(0, 22, (v, 1 << p)).astype(np.uint8)
    regs[rng.random(v) < 0.25] = 0
    t = torch.from_numpy(regs)
    return packing.pack_rows(t) if layout == "packed" else t


def _routing(rng, case, v_src, v_out):
    """(src, dst) int32 numpy routing of ``case``, sorted by dst."""
    src = rng.integers(0, v_src, 900)
    dst = rng.integers(0, v_out, 900)
    if case == "self_index":  # every pair src == dst
        k = min(v_src, v_out)
        src = dst = np.repeat(np.arange(k), 3)
    elif case == "hub":  # one destination takes 1,500 edges
        dst = np.concatenate([np.full(1_500, v_out // 2), dst[:300]])
        src = rng.integers(0, v_src, dst.shape[0])
    elif case == "empty":
        src = dst = np.zeros(0, np.int64)
    order = np.argsort(dst, kind="stable")
    return src[order].astype(np.int32), dst[order].astype(np.int32)


@pytest.mark.parametrize("layout", ["byte", "packed"])
@pytest.mark.parametrize("p", [4, 8, 12])
@pytest.mark.parametrize("case", ["v_src_less", "v_src_more", "self_index",
                                  "hub", "empty"])
def test_plain_into_matches_scatter_max_rows(layout, p, case):
    rng = np.random.default_rng(p * 7 + len(case) + len(layout))
    v_src, v_out = {"v_src_less": (23, 151), "v_src_more": (151, 23)}.get(
        case, (97, 97))
    src_panel, out = _panel(rng, v_src, p, layout), _panel(rng, v_out, p,
                                                            layout)
    src, dst = _routing(rng, case, v_src, v_out)
    target = out.clone()
    got = hll_propagate.hll_propagate_into(
        target, src_panel, torch.from_numpy(src), torch.from_numpy(dst),
        layout=layout)
    assert got.data_ptr() == target.data_ptr()  # in place
    want = jax_packing.scatter_max_rows(
        jnp.asarray(out.numpy()), jnp.asarray(dst),
        jnp.asarray(src_panel.numpy())[jnp.asarray(src)], layout)
    assert np.array_equal(got.numpy(), np.asarray(want))
    if case == "self_index":  # the merges took: a skip would leave out
        assert not torch.equal(got, out)
    if case == "empty":
        assert torch.equal(got, out)


@pytest.mark.parametrize("sms", [1, 8, 66, 132, 264])
@pytest.mark.parametrize("n_edges", [1, 31, 32, 33, 1_000, 65_537,
                                     3_626_017, 7_884_172, 31_859_448,
                                     128_302_398, 1 << 34])
def test_run_edges_within_the_kernels_limits(n_edges, sms):
    run = hll_propagate.run_edges(n_edges, sms)
    assert run & (run - 1) == 0
    assert hll_propagate.RUN_EDGES_MIN <= run <= hll_propagate.RUN_EDGES_MAX
    assert -(-n_edges // run) >= 1  # at least one run
    want = sms * hll_propagate.RUNS_PER_SM  # runs the chooser aims at
    if run > hll_propagate.RUN_EDGES_MIN:  # enough runs at this length
        assert n_edges >= run * want
    if run < hll_propagate.RUN_EDGES_MAX:  # too few at twice the length
        assert n_edges < 2 * run * want
    # more SMs never lengthen a run, more edges never shorten it
    assert hll_propagate.run_edges(n_edges, 2 * sms) <= run
    assert hll_propagate.run_edges(2 * n_edges, sms) >= run


@pytest.mark.parametrize("shape", sorted(PHASE4_EDGES))
def test_run_edges_fills_the_h100_at_phase4_shapes(shape):
    """Several waves of runs over the warps the card holds at once."""
    n_edges = PHASE4_EDGES[shape]
    run = hll_propagate.run_edges(n_edges, H100_SMS)
    runs = -(-n_edges // run)
    assert runs >= 4 * H100_SMS * WARPS_PER_SM
