"""The port's optimiser (``repro_torch.optim``) against the JAX package's
on the CPU.

* ``cosine_schedule``: bit for bit at every step of a 0..total sweep
  (and past it), for several peaks, warmups and totals, from a tensor of
  steps and from Python ``int`` steps;
* ``adamw_init`` / ``adamw_update`` on the same numpy trees and
  gradients, three steps: float32 and bfloat16 moments, the clip active
  and inactive; parameters, ``m`` and ``v`` within rtol 1e-6 (measured:
  equal), ``count`` and ``grad_norm`` equal; and the port's model
  (an ``nn.Module``) updated as its parameter tree is; a failure partway
  through the in-place update flagged (``PartialUpdateError``) and
  ``count`` written last;
* ``int8_compress``/``int8_decompress`` and ``apply_error_feedback``
  equal; ``compressed_psum`` over 4 pods against the JAX function under
  ``jax.vmap(..., axis_name="pod")`` (``pmax``/``psum`` on one device),
  equal.
"""
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import optim as joptim  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import compression as jcomp  # noqa: E402
from repro.optim import schedule as jsched  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.optim import adamw, compression, schedule  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_exports_match_the_reference():
    for name in ("AdamWConfig", "adamw_init", "adamw_update",
                 "cosine_schedule", "int8_compress", "int8_decompress",
                 "compressed_psum"):
        assert hasattr(joptim, name) and hasattr(optim, name), name
    assert adamw.__all__ == jadamw.__all__
    assert schedule.__all__ == jsched.__all__
    assert compression.__all__ == jcomp.__all__
    assert optim.AdamWConfig().__dict__ == jadamw.AdamWConfig().__dict__


# ------------------------------------------------------------- schedule
@pytest.mark.parametrize("peak,warmup,total", [
    (3e-3, 10, 100), (3e-4, 100, 10_000), (1e-3, 1, 7), (2.5e-4, 37, 5003),
    (1e-2, 0, 50)])
def test_cosine_schedule_bit_for_bit(peak, warmup, total):
    steps = np.arange(0, total + 3, dtype=np.int32)
    want = np.asarray(jsched.cosine_schedule(
        jnp.asarray(steps), peak_lr=peak, warmup=warmup, total=total))
    got = schedule.cosine_schedule(torch.from_numpy(steps), peak_lr=peak,
                                   warmup=warmup, total=total)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    for s in steps[:: max(len(steps) // 40, 1)]:
        one = schedule.cosine_schedule(int(s), peak_lr=peak, warmup=warmup,
                                       total=total)
        assert one.shape == () and one.numpy() == want[s]


# ---------------------------------------------------------------- adamw
def _tree(rng, scale):
    return {"a": (rng.normal(size=(3, 4)) * scale).astype(np.float32),
            "b": [(rng.normal(size=(5,)) * scale).astype(np.float32),
                  (rng.normal(size=(2, 2, 3)) * scale).astype(np.float32)],
            "c": {"x": (rng.normal(size=(7,)) * scale).astype(np.float32)}}


def _torch_tree(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("gscale", [1e-3, 10.0], ids=["no_clip", "clip"])
def test_adamw_matches_the_reference(dtype, gscale):
    rng = np.random.default_rng(0)
    params = _tree(rng, 1.0)
    jcfg, cfg = jadamw.AdamWConfig(dtype=dtype), adamw.AdamWConfig(dtype=dtype)
    jp = jax.tree.map(jnp.asarray, params)
    js = jadamw.adamw_init(jp, jcfg)
    tp = _torch_tree(params)
    ts = adamw.adamw_init(tp, cfg)
    assert ts["count"].dtype == torch.int32 and int(ts["count"]) == 0
    for leaf in jax.tree.leaves(ts["m"]) + jax.tree.leaves(ts["v"]):
        assert leaf.dtype == adamw._DTYPES[dtype] and not leaf.any()
    for it in range(3):
        grads = _tree(rng, gscale)
        lr = np.float32(1e-3 * (it + 1))
        jp, js, jm = jadamw.adamw_update(jp, jax.tree.map(jnp.asarray, grads),
                                         js, jnp.float32(lr), jcfg)
        tp, ts, tm = adamw.adamw_update(tp, _torch_tree(grads), ts,
                                        torch.tensor(lr), cfg)
        clipped = float(jm["grad_norm"]) > jcfg.clip_norm
        assert clipped == (gscale > 1)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
    assert int(ts["count"]) == int(js["count"]) == 3
    for want, got in zip(jax.tree.leaves(jp), jax.tree.leaves(tp)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    for key in ("m", "v"):
        for want, got in zip(jax.tree.leaves(js[key]),
                             jax.tree.leaves(ts[key])):
            np.testing.assert_allclose(got.float().numpy(),
                                       np.asarray(want, np.float32),
                                       rtol=1e-6)


def test_adamw_on_the_model_updates_its_parameters_in_place():
    """A module's parameters (and their dict of moments) take the same
    step as the same tensors given as a tree."""
    cfg = ARCHS["qwen2-1.5b"].reduced()
    model = tfm.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    named = {k: p.detach().clone() for k, p in model.named_parameters()}
    gen = torch.Generator().manual_seed(1)
    grads = {k: torch.randn(p.shape, generator=gen) for k, p in named.items()}
    ocfg = adamw.AdamWConfig()
    state = adamw.adamw_init(model, ocfg)
    assert list(state["m"]) == list(named)
    ptrs = [p.data_ptr() for p in model.parameters()]
    lr = torch.tensor(1e-3)
    out, state, m = adamw.adamw_update(model, grads, state, lr, ocfg)
    assert out is model and ptrs == [p.data_ptr() for p in model.parameters()]
    tree_state = adamw.adamw_init(named, ocfg)
    named, tree_state, tm = adamw.adamw_update(named, grads, tree_state, lr,
                                               ocfg)
    assert torch.equal(m["grad_norm"], tm["grad_norm"])
    for k, p in model.named_parameters():
        assert torch.equal(p, named[k]), k
        assert torch.equal(state["m"][k], tree_state["m"][k])
        assert torch.equal(state["v"][k], tree_state["v"][k])
    with pytest.raises(ValueError):
        adamw.adamw_update(model, {"one": grads["embed.w"]}, state, lr, ocfg)


def _failing_sqrt(at):
    """``torch.sqrt`` that raises on its ``at``-th call: AdamW calls it
    once for the global norm, then once a leaf before writing it."""
    real, calls = torch.sqrt, []

    def sqrt(x):
        calls.append(1)
        if len(calls) == at:
            raise RuntimeError("planted fault")
        return real(x)
    return mock.patch.object(torch, "sqrt", sqrt)


@pytest.mark.parametrize("leaf", [0, 2])
def test_adamw_failure_before_or_after_its_first_write(leaf):
    """A failure at the first leaf leaves the state as it was and
    surfaces as it is; one at leaf 2 of 4 (two leaves written) raises
    ``PartialUpdateError`` with ``state_written`` true, the later leaves
    and ``count`` unwritten."""
    rng = np.random.default_rng(0)
    params, grads = _torch_tree(_tree(rng, 1.0)), _torch_tree(_tree(rng, 1.0))
    cfg = adamw.AdamWConfig()
    state = adamw.adamw_update(params, grads, adamw.adamw_init(params, cfg),
                               torch.tensor(1e-3), cfg)[1]
    before = jax.tree.map(torch.clone, (params, state))
    with _failing_sqrt(2 + leaf), pytest.raises(RuntimeError) as err:
        adamw.adamw_update(params, grads, state, torch.tensor(1e-3), cfg)
    assert isinstance(err.value, adamw.PartialUpdateError) == (leaf > 0)
    assert getattr(err.value, "state_written", False) == (leaf > 0)
    assert int(state["count"]) == 1
    now = jax.tree.leaves((params, state["m"], state["v"]))
    old = jax.tree.leaves((before[0], before[1]["m"], before[1]["v"]))
    n = len(jax.tree.leaves(params))
    changed = [not torch.equal(a, b) for a, b in zip(now, old)]
    for i in range(3):
        assert changed[i * n:(i + 1) * n] == [j < leaf for j in range(n)]


# ---------------------------------------------------------- compression
def _pods(scale):
    rng = np.random.default_rng(7)
    return (rng.normal(size=(4, 3, 50)) * scale).astype(np.float32)


@pytest.mark.parametrize("scale", [1e-3, 1.0, 300.0])
def test_int8_round_trip_and_error_feedback_equal(scale):
    x = _pods(scale)[0]
    jq, js = jcomp.int8_compress(jnp.asarray(x))
    q, s = compression.int8_compress(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert s.item() == float(js)
    np.testing.assert_array_equal(
        compression.int8_decompress(q, s).numpy(),
        np.asarray(jcomp.int8_decompress(jq, js)))
    res = (_pods(scale)[1] * 0.01).astype(np.float32)
    want = jcomp.apply_error_feedback(jnp.asarray(x), jnp.asarray(res))
    got = compression.apply_error_feedback(torch.from_numpy(x),
                                           torch.from_numpy(res))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("scale", [1e-3, 1.0, 300.0])
def test_compressed_psum_equals_the_pod_axis_reduction(scale):
    x = _pods(scale)
    want = jax.vmap(lambda v: jcomp.compressed_psum(v, "pod"),
                    axis_name="pod")(jnp.asarray(x))
    got = compression.compressed_psum([torch.from_numpy(r) for r in x])
    assert got.dtype == torch.float32 and got.shape == x.shape[1:]
    for pod in range(x.shape[0]):  # every member receives the same total
        np.testing.assert_array_equal(got.numpy(), np.asarray(want[pod]))
