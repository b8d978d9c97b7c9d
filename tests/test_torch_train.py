"""The port's LM training path (``models.steps.make_train_step``, remat,
``launch.train``, train checkpoints) against the JAX package's on the
CPU, every architecture at ``reduced()`` in float32.

The weights are the JAX package's ``init_params(key(0))``, carried across
by ``models.convert.params_from_tree``; the batch is seeded numpy (2 x 32
tokens, labels the next token, and llava's image prefix or whisper's
encoder frames). One step of the JAX ``make_train_step`` (its gradients
read where it hands them to ``adamw_update``, one compile an arch)
against one step of the port's:

* the loss within rtol 1e-5 (measured: 9.5e-7 absolute on ~6.5);
* every gradient within rtol 1e-4 and 1e-5 of the arch's largest
  gradient (measured: 2.7e-6 of it, jamba);
* ``grad_norm`` within rtol 1e-5, the rate equal;
* every updated parameter within ``PARAM_TOL`` = 1e-3 x lr, except
  where Adam normalises a gradient at its rounding floor: its first step
  moves a parameter by about ``lr * g / (|g| + eps)``, so a gradient under
  ``FLOOR`` = 1e-4 of the arch's largest may move it by up to lr either
  way. Such elements are held within 2 x lr and may be at most 1e-3 of
  all (measured: 23 to 451 an arch, 2.6e-4 of jamba's 1.7M at most, the
  largest 0.099 lr, llava);
* ``m`` and ``v`` within rtol 1e-4 (grok-1's bfloat16 moments: one
  bfloat16 ulp, 2^-7) and the gradients' tolerance carried through
  ``m = (1 - b1) g`` and ``v = (1 - b2) g^2``: 1e-6 x the largest
  gradient, and its square.

The port's global norm sums one leaf a layer where the reference's
leaves are stacked per period, so the clip scale may differ by an ulp;
the tolerances above cover it. Also: ``grad_accum=2`` against the JAX
step at ``grad_accum=2`` and against the port's own ``grad_accum=1``
step on the same batch (1e-5); remat ``"none"``/``"dots"``/``"full"``
giving equal gradients and checkpointing only while gradients are
taken; the chunked loss's gradient equal to one chunk's; the launcher on
the CPU; and checkpoints crossing between the packages' trainers both
ways.
"""
import dataclasses
import functools
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.ckpt import checkpoint as jckpt  # noqa: E402
from repro.configs import ARCHS as JAX_ARCHS  # noqa: E402
from repro.data.pipeline import SyntheticCorpus as JaxCorpus  # noqa: E402
from repro.models import steps as jsteps  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.runtime import ft as jft  # noqa: E402
from repro_torch.ckpt.checkpoint import restore_checkpoint  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.data.pipeline import SyntheticCorpus  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import convert, steps  # noqa: E402
from repro_torch.models.parity import FLOOR  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.runtime import ft  # noqa: E402

B, L = 2, 32
PEAK, WARMUP, TOTAL = 3e-3, 2, 10
LR0 = PEAK / WARMUP                  # the rate of step 0
PARAM_TOL = 1e-3 * LR0


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread (the parallel suite runs a file a worker)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batch(cfg, accum=1):
    """Seeded numpy batch; with ``accum`` > 1 each leaf (A, B/A, ...)."""
    rng = np.random.default_rng(1)
    text = L - (cfg.num_image_tokens if cfg.family == "vlm" else 0)
    toks = rng.integers(0, cfg.vocab_size, (B, text + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "loss_mask": np.ones((B, text), np.float32)}
    if cfg.family == "vlm" or cfg.is_enc_dec:
        s = cfg.num_image_tokens if cfg.family == "vlm" else cfg.encoder_seq
        batch["embeds"] = rng.normal(size=(B, s, cfg.d_model)).astype(
            np.float32)
    if accum > 1:
        batch = {k: v.reshape(accum, B // accum, *v.shape[1:])
                 for k, v in batch.items()}
    return batch


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32)
                        if a.dtype == jnp.bfloat16 else np.asarray(a), tree)


@functools.lru_cache(maxsize=None)
def _jax_step(arch, accum=1):
    """One JAX ``make_train_step`` (compiled once), with the gradients it
    hands to ``adamw_update``: numpy trees of everything."""
    jcfg = dataclasses.replace(JAX_ARCHS[arch].reduced(), grad_accum=accum)
    params = jtfm.init_params(jax.random.key(0), jcfg)
    ocfg = jadamw.AdamWConfig(dtype=jcfg.adam_dtype)
    state = jadamw.adamw_init(params, ocfg)
    batch = _batch(jcfg, accum)
    seen = {}

    def capture(p, g, s, lr, c):
        seen["grads"] = g
        return jadamw.adamw_update(p, g, s, lr, c)

    step = jsteps.make_train_step(jcfg, ocfg, peak_lr=PEAK, warmup=WARMUP,
                                  total_steps=TOTAL)
    with mock.patch.object(jsteps, "adamw_update", capture):
        (p2, s2, m), grads = jax.jit(
            lambda p, o, b, s: (step(p, o, b, s), seen["grads"]))(
                params, state, batch, jnp.asarray(0))
    return {"params": _np(params), "batch": batch, "grads": _np(grads),
            "new": _np(p2), "m": _np(s2["m"]), "v": _np(s2["v"]),
            "count": int(s2["count"]), "loss": float(m["loss"]),
            "lr": np.float32(m["lr"]), "grad_norm": float(m["grad_norm"])}


def _as_port(cfg, tree):
    """A reference tree as ``{port parameter name: tensor}``."""
    return dict(convert.params_from_tree(cfg, tree, "cpu")
                .named_parameters())


def _port_step(cfg, run, batch=None):
    """The port's step from the same weights: (model, state, metrics,
    gradients by name)."""
    model = convert.params_from_tree(cfg, run["params"], "cpu")
    ocfg = adamw.AdamWConfig(dtype=cfg.adam_dtype)
    state = adamw.adamw_init(model, ocfg)
    step = steps.make_train_step(cfg, ocfg, peak_lr=PEAK, warmup=WARMUP,
                                 total_steps=TOTAL, return_grads=True)
    batch = run["batch"] if batch is None else batch
    model, state, m = step(
        model, state, {k: torch.from_numpy(v) for k, v in batch.items()}, 0)
    return model, state, m, m.pop("grads")


def _check_step(cfg, run, model, state, m, grads):
    assert not any(p.requires_grad for p in model.parameters())
    np.testing.assert_allclose(float(m["loss"]), run["loss"], rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), run["grad_norm"],
                               rtol=1e-5)
    assert m["lr"].numpy() == run["lr"]
    want_g = _as_port(cfg, run["grads"])
    gmax = max(float(g.abs().max()) for g in want_g.values())
    for k, g in grads.items():
        np.testing.assert_allclose(g.float().numpy(), want_g[k].numpy(),
                                   rtol=1e-4, atol=1e-5 * gmax, err_msg=k)
    want_p = _as_port(cfg, run["new"])
    off = total = 0
    for k, p in model.named_parameters():
        d = (p - want_p[k]).abs()
        far = d > PARAM_TOL
        off += int(far.sum())
        total += d.numel()
        if bool(far.any()):  # only where Adam normalises a floor gradient
            assert float(want_g[k][far].abs().max()) <= FLOOR * gmax, k
            assert float(d.max()) <= 2 * LR0, (k, float(d.max()))
    assert off <= 1e-3 * total, (off, total)
    # m = (1 - b1) g and v = (1 - b2) g^2 carry the gradients' tolerance
    rtol = 2.0 ** -7 if cfg.adam_dtype == "bfloat16" else 1e-4
    for key, atol in (("m", 1e-6 * gmax), ("v", 1e-6 * gmax ** 2)):
        want = _as_port(cfg, run[key])
        for k, t in state[key].items():
            assert t.dtype == adamw._DTYPES[cfg.adam_dtype]
            np.testing.assert_allclose(t.float().numpy(), want[k].numpy(),
                                       rtol=rtol, atol=atol, err_msg=k)
    assert int(state["count"]) == run["count"] == 1


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_train_step_matches_jax(arch):
    cfg = ARCHS[arch].reduced()
    run = _jax_step(arch)
    _check_step(cfg, run, *_port_step(cfg, run))


def test_grad_accum_matches_jax_and_one_microbatch():
    """``grad_accum=2`` (float32 sums of the two microbatches' gradients)
    against the JAX step at ``grad_accum=2``, and against the port's
    ``grad_accum=1`` step on the same 2 x 32 tokens within 1e-5 (a dense
    arch: the MoE capacity depends on a microbatch's tokens)."""
    arch = "qwen2-1.5b"
    cfg = dataclasses.replace(ARCHS[arch].reduced(), grad_accum=2)
    run = _jax_step(arch, 2)
    two = _port_step(cfg, run)
    _check_step(cfg, run, *two)
    one = _port_step(ARCHS[arch].reduced(), _jax_step(arch))
    np.testing.assert_allclose(float(two[2]["loss"]), float(one[2]["loss"]),
                               rtol=1e-5)
    for k, g in two[3].items():
        np.testing.assert_allclose(g.numpy(), one[3][k].numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    for (k, p), q in zip(two[0].named_parameters(), one[0].parameters()):
        np.testing.assert_allclose(p.numpy(), q.numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=k)


# ---------------------------------------------------------------- remat
def _grads(cfg, model, batch):
    loss, grads = steps.loss_and_grads(cfg, model, batch)
    return float(loss), grads


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "whisper-large-v3",
                                  "jamba-v0.1-52b", "gemma2-9b"])
def test_remat_policies_give_equal_gradients(arch):
    """``"dots"`` and ``"full"`` recompute what ``"none"`` keeps: equal
    losses and gradients; one checkpoint a period (and an encoder block)
    while gradients are taken, none in a prefill."""
    base = ARCHS[arch].reduced()
    model = tfm.init_params(torch.Generator().manual_seed(0), base, "cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(base).items()}
    loss0, want = _grads(base, model, batch)
    for policy in ("dots", "full"):
        cfg = dataclasses.replace(base, remat=policy)
        with mock.patch.object(tfm, "checkpoint",
                               wraps=tfm.checkpoint) as ckpt:
            loss, got = _grads(cfg, model, batch)
        assert ckpt.call_count == cfg.num_periods + cfg.encoder_layers
        assert loss == loss0
        for k, g in got.items():
            np.testing.assert_allclose(g.numpy(), want[k].numpy(), rtol=1e-6,
                                       atol=1e-7, err_msg=f"{policy} {k}")
    cfg = dataclasses.replace(base, remat="full")
    cache = tfm.init_cache(cfg, B, L + 8, "cpu")
    with mock.patch.object(tfm, "checkpoint") as ckpt:
        tfm.prefill(model, cfg, batch["tokens"], cache,
                    embeds=batch.get("embeds"))
        tfm.forward_hidden(model, cfg, batch["tokens"],
                           embeds=batch.get("embeds"))
    assert ckpt.call_count == 0


def test_chunked_loss_gradient_equals_one_chunk():
    """Four checkpointed chunks of 8 positions against one of 32."""
    cfg = ARCHS["qwen2-1.5b"].reduced()
    model = tfm.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    batch["loss_mask"][:, -5:] = 0
    loss1, want = _grads(cfg, model, batch)
    with mock.patch.object(steps, "checkpoint",
                           wraps=steps.checkpoint) as ckpt:
        loss4, got = _grads(dataclasses.replace(cfg, ce_chunk=8), model,
                            batch)
    assert ckpt.call_count == 4
    np.testing.assert_allclose(loss4, loss1, rtol=1e-6)
    for k, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[k].numpy(), rtol=1e-5,
                                   atol=1e-7, err_msg=k)


# ------------------------------------------------- launcher and checkpoints
def test_launcher_trains_on_the_cpu(tmp_path, capsys):
    """``launch.train --device cpu``: the loss falls; a second run to more
    steps restores the newest checkpoint and resumes after it."""
    args = ["--arch", "qwen2-1.5b", "--steps", "12", "--batch", "4",
            "--seq", "32", "--ckpt-every", "5", "--ckpt-dir",
            str(tmp_path), "--device", "cpu"]
    launch_train.main(args)
    out = capsys.readouterr().out
    assert "arch=qwen2-1.5b reduced=True devices=1 (cpu)" in out
    line = next(ln for ln in out.splitlines() if ln.startswith("final"))
    last, first = line[len("final loss: "):].split(")")[0].split(" (first: ")
    assert float(last) < float(first)
    assert sorted(os.listdir(tmp_path)) == ["step_10", "step_5"]
    launch_train.main(args[:3] + ["15"] + args[4:])
    out = capsys.readouterr().out
    assert "restored from step 10" in out
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="no CUDA device"):
            launch_train.main(args[:-2])


def test_port_checkpoint_restores_into_the_jax_train_tree(tmp_path):
    """A checkpoint the port's launcher writes (params and AdamW state at
    ``reduced()``, step 2 of 3) restores through the JAX
    ``restore_checkpoint`` into the JAX package's train tree, its keys,
    shapes and dtypes (grok-1: bfloat16 moments), with the values the
    port's ``train_loop`` restores (``TRAIN_STATE``) bit for bit."""
    for arch in ("qwen2-1.5b", "grok-1-314b"):
        d = str(tmp_path / arch)
        launch_train.main(["--arch", arch, "--steps", "3", "--batch", "2",
                           "--seq", "16", "--ckpt-every", "2", "--ckpt-dir",
                           d, "--device", "cpu"])
        jcfg = JAX_ARCHS[arch].reduced()
        params = jtfm.init_params(jax.random.key(0), jcfg)
        like = {"params": params, "opt": jadamw.adamw_init(
            params, jadamw.AdamWConfig(dtype=jcfg.adam_dtype))}
        got = jckpt.restore_checkpoint(d, 2, like)
        assert int(got["opt"]["count"]) == 3
        cfg = ARCHS[arch].reduced()
        model = tfm.init_params(torch.Generator().manual_seed(9), cfg, "cpu")
        state = adamw.adamw_init(model, adamw.AdamWConfig(
            dtype=cfg.adam_dtype))
        tree = restore_checkpoint(d, 2, convert.TRAIN_STATE.like_tree(
            model, state))
        model, state = convert.TRAIN_STATE.from_tree(model, state, tree)
        port = convert.TRAIN_STATE.to_tree(model, state)
        flat = jax.tree_util.tree_flatten_with_path(like)[0]
        assert len(flat) == len(jax.tree.leaves(port))
        for (path, a), b, c in zip(flat, jax.tree.leaves(got),
                                   jax.tree.leaves(port)):
            assert a.shape == b.shape == tuple(c.shape), path
            assert a.dtype == b.dtype, path
            np.testing.assert_array_equal(np.asarray(b, np.float32),
                                          c.float().numpy())


def test_jax_checkpoint_resumes_the_port(tmp_path):
    """The JAX ``train_loop`` writes step 3; the port's ``train_loop``
    (``codec=TRAIN_STATE``) restores it and runs step 4, whose loss equals
    the JAX loop's step 4 within 1e-4."""
    arch = "qwen2-1.5b"
    jcfg, cfg = JAX_ARCHS[arch].reduced(), ARCHS[arch].reduced()
    params = jtfm.init_params(jax.random.key(0), jcfg)
    ocfg = jadamw.AdamWConfig()
    jstep = jax.jit(jsteps.make_train_step(jcfg, ocfg, peak_lr=PEAK,
                                           warmup=WARMUP, total_steps=TOTAL))
    corpus = dict(vocab_size=cfg.vocab_size, seq_len=16, global_batch=2,
                  seed=1)
    _, _, jhist = jft.train_loop(
        step_fn=jstep, params=params, opt_state=jadamw.adamw_init(params,
                                                                  ocfg),
        corpus=JaxCorpus(**corpus), num_steps=5,
        ft=jft.FTConfig(ckpt_dir=str(tmp_path), ckpt_every=3),
        to_device=lambda b: {k: jnp.asarray(v) for k, v in b.items()},
        log_every=0)
    model = tfm.init_params(torch.Generator().manual_seed(5), cfg, "cpu")
    state = adamw.adamw_init(model, adamw.AdamWConfig())
    model, state, hist = ft.train_loop(
        step_fn=steps.make_train_step(cfg, adamw.AdamWConfig(), peak_lr=PEAK,
                                      warmup=WARMUP, total_steps=TOTAL),
        params=model, opt_state=state, corpus=SyntheticCorpus(**corpus),
        num_steps=5, ft=ft.FTConfig(ckpt_dir=str(tmp_path), ckpt_every=0),
        to_device=lambda b: {k: torch.from_numpy(v) for k, v in b.items()},
        log_every=0, codec=convert.TRAIN_STATE)
    assert hist["restored_from"] == 3 and len(hist["loss"]) == 1
    assert int(state["count"]) == 5
    np.testing.assert_allclose(hist["loss"][0], jhist["loss"][4], rtol=1e-4)


def test_step_mismatches_allows_only_floor_gradients():
    """``models.parity.step_mismatches`` (the card checks' comparison):
    equal steps pass; a parameter off by more than the tolerance fails
    unless its gradient is at the floor, and then only within 2 x lr."""
    from repro_torch.models.parity import step_mismatches, train_step_on_both

    want, got = train_step_on_both(ARCHS["qwen2-1.5b"].reduced(), "cpu")
    assert step_mismatches(want, got, 1e-6) == (
        {"loss": 0.0, "grad_norm": 0.0, "grads": 0.0, "params": 0.0,
         "floor": 0, "floor_lr": 0.0}, [])
    lr = want["lr"]
    for side in (want, got):                         # a floor gradient
        side["grads"]["final_norm.scale"] = side["grads"][
            "final_norm.scale"].clone()
        side["grads"]["final_norm.scale"][0] = 0.0
    for shift, ok in ((1.5 * lr, True), (2.5 * lr, False)):
        moved = {k: v.clone() for k, v in got["params"].items()}
        moved["final_norm.scale"][0] += shift
        errs, bad = step_mismatches(want, dict(got, params=moved), 1e-6)
        assert errs["floor"] == 1 and (not bad) == ok, (shift, bad)
    moved["final_norm.scale"][0] -= 2.5 * lr
    moved["final_norm.scale"][1] += 1e-5             # its gradient is not
    assert step_mismatches(want, dict(got, params=moved), 1e-6)[1]
    grads = dict(got["grads"], **{"embed.w": got["grads"]["embed.w"] + 1e-3})
    assert step_mismatches(want, dict(got, grads=grads), 1e-6)[1]


# ------------------------------------------------------- faults in a step
def _faulty_run(tmp_path, fault, ckpt_every, num_steps=4, at=2):
    """The port's ``train_loop`` over the reduced qwen2's in-place step,
    whose step ``at`` fails on its first attempt: in its gradients
    (``"grads"``, nothing written yet), partway through AdamW
    (``"adamw"``: the third leaf's ``torch.sqrt`` raises, two leaves
    written), or in nothing (``None``). Returns (model, state, history,
    attempts by step, the error or ``None``)."""
    cfg = ARCHS["qwen2-1.5b"].reduced()
    model = tfm.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    state = adamw.adamw_init(model, adamw.AdamWConfig())
    step = steps.make_train_step(cfg, adamw.AdamWConfig(), peak_lr=PEAK,
                                 warmup=WARMUP, total_steps=TOTAL)
    attempts = {}

    def faulty(params, opt_state, batch, i):
        attempts[i] = attempts.get(i, 0) + 1
        if fault is None or i != at or attempts[i] > 1:
            return step(params, opt_state, batch, i)
        if fault == "grads":
            with mock.patch.object(steps, "make_loss_fn",
                                   side_effect=RuntimeError("planted")):
                return step(params, opt_state, batch, i)
        real, calls = torch.sqrt, []

        def sqrt(x):
            calls.append(1)
            if len(calls) == 4:      # the global norm, then a leaf each
                raise RuntimeError("planted")
            return real(x)
        with mock.patch.object(torch, "sqrt", sqrt):
            return step(params, opt_state, batch, i)

    err = hist = None
    try:
        model, state, hist = ft.train_loop(
            step_fn=faulty, params=model, opt_state=state,
            corpus=SyntheticCorpus(vocab_size=cfg.vocab_size, seq_len=16,
                                   global_batch=2, seed=1),
            num_steps=num_steps,
            ft=ft.FTConfig(ckpt_dir=str(tmp_path), ckpt_every=ckpt_every),
            to_device=lambda b: {k: torch.from_numpy(v)
                                 for k, v in b.items()},
            log_every=0, codec=convert.TRAIN_STATE)
    except RuntimeError as e:
        err = e
    return model, state, hist, attempts, err


@pytest.mark.parametrize("fault,ckpt_every", [
    ("grads", 0), ("adamw", 1), ("adamw", 0)])
def test_train_loop_never_retries_a_half_written_step(tmp_path, fault,
                                                      ckpt_every):
    """The in-place step's failure before its first write is retried in
    place; one partway through AdamW is not: the loop restores the newest
    checkpoint (step 1) and runs step 2 again, or, with no checkpoint,
    raises ``PartialUpdateError`` without a retry. Where the run ends, the
    parameters, moments and ``count`` equal an undisturbed run's bit for
    bit."""
    want = _faulty_run(tmp_path / "clean", None, 0)
    model, state, hist, attempts, err = _faulty_run(tmp_path / "run", fault,
                                                    ckpt_every)
    if fault == "adamw" and not ckpt_every:
        assert isinstance(err, adamw.PartialUpdateError)
        assert err.state_written and attempts == {0: 1, 1: 1, 2: 1}
        assert int(state["count"]) == 2            # count is written last
        return
    assert err is None and hist["retries"] == 1
    assert hist["rollbacks"] == ([1] if fault == "adamw" else [])
    assert attempts == {0: 1, 1: 1, 2: 2, 3: 1}
    assert hist["loss"] == want[2]["loss"]
    assert int(state["count"]) == 4
    for (k, p), q in zip(model.named_parameters(), want[0].parameters()):
        assert torch.equal(p, q), k
        assert torch.equal(state["m"][k], want[1]["m"][k]), k
        assert torch.equal(state["v"][k], want[1]["v"][k]), k
