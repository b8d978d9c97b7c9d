"""Fault-tolerant training runtime: checkpoint/restart, retry, stragglers
(port of ``repro.runtime.ft``).

* restart-exact: ``train_loop`` restores the newest checkpoint on start,
  and the data pipeline is a pure function of the step
  (``repro_torch.data.pipeline``), so a preempted job resumes losslessly.
* retry: a failed step is retried up to ``max_retries`` times before it
  surfaces; a step that updates its state in place and fails after a
  write restores the newest checkpoint instead. A failed kernel build or
  launch is an exception like any other: it is retried, then raised;
  nothing falls back to a plain version.
* straggler watchdog: per-step wall time against an EWMA; steps slower
  than ``straggler_factor`` x the EWMA are counted and reported to a
  callback. The first ``warmup`` observations are left out: a cold first
  step (kernel builds, allocator warm-up) would otherwise seed or trip
  the EWMA.
* async checkpointing overlaps the writes with the next steps.

The multi-host failover coordinator (lost-host detection, eviction, the
newest complete checkpoint restored at a smaller shard count, ingest
resumed from the ``m_ingested`` cursor) is
:mod:`repro_torch.runtime.coordinator`; :func:`coordinator` here
delegates to it.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from types import SimpleNamespace

from repro_torch.ckpt.checkpoint import (AsyncCheckpointer, latest_step,
                                         restore_checkpoint)

__all__ = ["FTConfig", "StragglerWatchdog", "coordinator", "train_loop"]


def coordinator(*args, **kwargs):
    """The multi-host failover coordinator: forwards to
    :func:`repro_torch.runtime.coordinator.coordinator` and returns its
    ``(engine, stats)`` pair. Imported on call, so that
    ``repro_torch.runtime`` imports without the engine stack."""
    from repro_torch.runtime.coordinator import coordinator as _real
    return _real(*args, **kwargs)


@dataclass
class FTConfig:
    """Fault-tolerance knobs shared by ``train_loop``, the coordinator and
    the failover-aware ``ContinuousServer`` writer.

    Attributes:
      ckpt_dir: directory of the asynchronous checkpoint stream.
      ckpt_every: checkpoint cadence: ingest blocks for the coordinator
        and the writer, steps for ``train_loop``.
      keep: newest checkpoints kept on disk.
      max_retries: retries of a failed step (or ingest block) before the
        failure surfaces.
      straggler_factor, ewma_alpha, warmup_steps: the
        :class:`StragglerWatchdog`'s factor, EWMA weight and warmup.
    """

    ckpt_dir: str = "checkpoints"
    ckpt_every: int = 50
    keep: int = 3
    max_retries: int = 2
    straggler_factor: float = 3.0
    ewma_alpha: float = 0.2
    warmup_steps: int = 1


@dataclass
class StragglerWatchdog:
    """Flags steps slower than ``factor`` x an EWMA of recent step times.

    The first ``warmup`` observations are ignored outright, neither
    judged nor folded into the EWMA: a fast bookkeeping step followed by
    a cold one would otherwise seed a tiny EWMA and fire on step 2.
    Straggler samples are kept out of the EWMA too, so one slow host
    cannot drag the baseline up and mask the next one.
    """

    factor: float = 3.0
    alpha: float = 0.2
    warmup: int = 1
    ewma: float | None = None
    straggler_steps: int = 0
    seen: int = 0
    on_straggler: object = None

    def observe(self, dt: float) -> bool:
        """Record one step's wall time; True iff it counts as a straggler."""
        self.seen += 1
        if self.seen <= self.warmup:
            return False
        is_straggler = False
        if self.ewma is not None and dt > self.factor * self.ewma:
            self.straggler_steps += 1
            is_straggler = True
            if self.on_straggler is not None:
                self.on_straggler(dt, self.ewma)
        if not is_straggler:
            self.ewma = (dt if self.ewma is None
                         else self.alpha * dt + (1 - self.alpha) * self.ewma)
        return is_straggler


#: ``train_loop``'s default ``codec``: the checkpoint tree is
#: ``{"params": params, "opt": opt_state}`` as given
TREE = SimpleNamespace(
    to_tree=lambda params, opt_state: {"params": params, "opt": opt_state},
    like_tree=lambda params, opt_state: {"params": params, "opt": opt_state},
    from_tree=lambda params, opt_state, tree: (tree["params"], tree["opt"]))


def train_loop(*, step_fn, params, opt_state, corpus, num_steps: int,
               ft: FTConfig = FTConfig(), to_device=None, log_every: int = 10,
               on_metrics=None, codec=TREE):
    """Run steps up to ``num_steps`` with checkpoint/restart, retries and
    straggler tracking.

    ``step_fn(params, opt_state, batch, step) -> (params, opt_state,
    metrics)``, with ``step`` a Python ``int`` and ``metrics["loss"]``
    anything ``float()`` reads (a 0-d tensor, a number). ``params`` and
    ``opt_state`` are tensors or arrays, or nested dicts, lists and
    tuples of them. The newest checkpoint under ``ft.ckpt_dir`` is
    restored on entry into the structure, devices and dtypes of the given
    ``params`` and ``opt_state``, and the loop resumes after its step;
    the JAX package's ``train_loop`` checkpoints restore here and the
    other way round (the same leaf keys). ``corpus.batch(step)`` gives
    each step's batch; ``to_device`` optionally moves it. The step's
    wall time includes a synchronize of the card when one is present, so
    the watchdog times the step's work and not its launches.

    A step that raises is retried, ``ft.max_retries`` times at most for
    one step, then the error surfaces after the write in flight completes.
    A step may update its state in place (the port's ``make_train_step``
    does); one that fails after its first write raises an error whose
    ``state_written`` is true (``optim.adamw.PartialUpdateError``), and an
    error from the synchronize after a step counts as such too. That state
    is not retried: the newest checkpoint is restored and the steps after
    it run again (the corpus is a function of the step, so they repeat
    exactly, and ``on_metrics`` sees them again); without a checkpoint the
    error surfaces.

    ``codec`` carries state that is not a tree of tensors (the port's
    ``Transformer`` and its AdamW state: ``models.convert.TRAIN_STATE``)
    to and from the checkpoint tree: ``to_tree(params, opt_state)`` gives
    the tree to write, ``like_tree(params, opt_state)`` the template to
    read it into, and ``from_tree(params, opt_state, tree)`` puts a read
    tree back and returns ``(params, opt_state)``; the default
    (:data:`TREE`) writes ``{"params": params, "opt": opt_state}``.

    Returns ``(params, opt_state, history)``; ``history`` holds ``loss``
    (one float a step, from the first step after ``restored_from``),
    ``restored_from`` (the step restored on entry or ``None``),
    ``straggler_steps``, ``retries`` (failed attempts) and ``rollbacks``
    (the checkpoint step restored after each failure that wrote state).
    """
    ckpt = AsyncCheckpointer(ft.ckpt_dir, keep=ft.keep)
    watchdog = StragglerWatchdog(factor=ft.straggler_factor,
                                 alpha=ft.ewma_alpha,
                                 warmup=ft.warmup_steps)

    def restore(step):
        tree = restore_checkpoint(ft.ckpt_dir, step,
                                  codec.like_tree(params, opt_state))
        return codec.from_tree(params, opt_state, tree)

    start = 0
    last = latest_step(ft.ckpt_dir)
    if last is not None:
        params, opt_state = restore(last)
        start = last + 1

    history = {"loss": [], "restored_from": last, "straggler_steps": 0,
               "retries": 0, "rollbacks": []}
    failures: dict[int, int] = {}
    step = start
    while step < num_steps:
        batch = corpus.batch(step)
        if to_device is not None:
            batch = to_device(batch)
        t0 = time.time()
        out = None
        try:
            out = step_fn(params, opt_state, batch, step)
            _synchronize()
        except Exception as e:
            history["retries"] += 1
            failures[step] = failures.get(step, 0) + 1
            if failures[step] > ft.max_retries:
                ckpt.wait()
                raise
            # after step_fn returned, its writes were queued
            if out is not None or getattr(e, "state_written", False):
                ckpt.wait()
                back = latest_step(ft.ckpt_dir)
                if back is None:
                    raise
                params, opt_state = restore(back)
                history["rollbacks"].append(back)
                del history["loss"][back + 1 - start:]
                step = back + 1
            continue
        params, opt_state, metrics = out
        dt = time.time() - t0
        watchdog.observe(dt)
        loss = float(metrics["loss"])
        history["loss"].append(loss)
        if on_metrics is not None:
            on_metrics(step, metrics, dt)
        if log_every and step % log_every == 0:
            print(f"step {step}: loss={loss:.4f} dt={dt:.2f}s", flush=True)
        if ft.ckpt_every and step % ft.ckpt_every == 0 and step > start:
            ckpt.save(step, codec.to_tree(params, opt_state))
        step += 1
    history["straggler_steps"] = watchdog.straggler_steps
    ckpt.wait()
    return params, opt_state, history


def _synchronize() -> None:
    """Wait for the card's queued work, when torch has initialised one."""
    import torch
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
