"""One model on two devices: the same weights and inputs on the CPU and
on ``device``, and the logits of a prefill and of greedy decode steps
(:func:`logits_on_both`), or one train step's loss, gradients and
updated parameters (:func:`train_step_on_both`), on both; and both of
those on ``device`` with a sharding mesh set and without one
(:func:`mesh_runs`, :func:`mesh_mismatches`), which must be equal bit for
bit since a hint only checks its spec.

The CPU tests hold the CPU side against the JAX package; holding the card
against the CPU closes the chain. ``chip_smoke.py`` and
``tests/test_torch_cuda.py`` both call these.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import convert, steps
from repro_torch.models import transformer as tfm
from repro_torch.models.config import ModelConfig
from repro_torch.optim.adamw import AdamWConfig, adamw_init

__all__ = ["logits_on_both", "train_step_on_both", "step_mismatches",
           "mesh_runs", "mesh_mismatches"]


def _inputs(cfg: ModelConfig, batch: int, length: int, data_seed: int):
    """Seeded tokens (B, text length) and llava's image or whisper's
    encoder embeddings (``None`` for the others), as CPU tensors."""
    rng = np.random.default_rng(data_seed)
    text = length - (cfg.num_image_tokens if cfg.family == "vlm" else 0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (batch, text)))
    emb = None
    if cfg.family == "vlm" or cfg.is_enc_dec:
        s = cfg.num_image_tokens if cfg.family == "vlm" else cfg.encoder_seq
        emb = torch.from_numpy(rng.normal(size=(batch, s, cfg.d_model))
                               .astype(np.float32))
    return toks, emb


def logits_on_both(cfg: ModelConfig, device, *, batch: int = 2,
                   length: int = 32, decodes: int = 3, seed: int = 0,
                   data_seed: int = 0) -> list[tuple[torch.Tensor,
                                                     torch.Tensor]]:
    """``[(CPU logits, device logits copied to the CPU)]`` for the prefill
    of ``length`` positions, then for each of ``decodes`` greedy decode
    steps fed the CPU's tokens.

    Weights are drawn on the CPU from ``torch.Generator`` seed ``seed``
    and carried to ``device`` by ``models.convert``; tokens (and llava's
    image or whisper's encoder embeddings) come from numpy seed
    ``data_seed``. An int8 cache is carried from the CPU before each
    decode step: a value on a rounding boundary may round apart on two
    devices, and the step is not held against it.
    """
    cpu = tfm.init_params(torch.Generator().manual_seed(seed), cfg, "cpu")
    dev = convert.params_from_tree(cfg, convert.params_to_tree(cpu), device)
    toks, emb = _inputs(cfg, batch, length, data_seed)
    caches = [tfm.init_cache(cfg, batch, length + decodes + 8, d)
              for d in ("cpu", device)]
    want, _ = tfm.prefill(cpu, cfg, toks, caches[0], embeds=emb)
    got, _ = tfm.prefill(dev, cfg, toks.to(device), caches[1],
                         embeds=None if emb is None else emb.to(device))
    out = [(want, got.cpu())]
    for i in range(decodes):
        tok = want.argmax(-1)[:, None]
        if cfg.kv_cache_dtype == "int8":
            caches[1] = convert.cache_from_tree(
                cfg, convert.cache_to_tree(cfg, caches[0]), device)
        want, _ = tfm.decode_step(cpu, cfg, tok, caches[0], length + i)
        got, _ = tfm.decode_step(dev, cfg, tok.to(device), caches[1],
                                 length + i)
        out.append((want, got.cpu()))
    return out


def train_step_on_both(cfg: ModelConfig, device, *, batch: int = 2,
                       length: int = 32, seed: int = 0, data_seed: int = 0,
                       peak_lr: float = 3e-4, warmup: int = 1
                       ) -> list[dict]:
    """``[CPU, device]``: for each, one ``make_train_step`` step (step 0,
    rate ``peak_lr / warmup``, AdamW in the config's ``adam_dtype``) of
    the same weights on the same batch: ``{"loss", "grad_norm", "lr",
    "grads": {name: tensor}, "params": {name: updated tensor}}``, every
    tensor on the CPU.

    Weights are drawn on the CPU from ``torch.Generator`` seed ``seed``
    and carried to ``device`` by ``models.convert``; the batch (labels
    the next token, every position counted) comes from numpy seed
    ``data_seed``. ``grads`` are those the step hands to AdamW: with
    ``cfg.grad_accum = A > 1`` the batch is split into A microbatches and
    they are the float32 means of theirs.
    """
    toks, emb = _inputs(cfg, batch, length + 1, data_seed)
    host = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
            "loss_mask": torch.ones(toks[:, 1:].shape)}
    if emb is not None:
        host["embeds"] = emb
    if cfg.grad_accum > 1:
        a = cfg.grad_accum
        host = {k: v.reshape(a, v.shape[0] // a, *v.shape[1:])
                for k, v in host.items()}
    cpu = tfm.init_params(torch.Generator().manual_seed(seed), cfg, "cpu")
    tree = convert.params_to_tree(cpu)
    opt_cfg = AdamWConfig(dtype=cfg.adam_dtype)
    out = []
    for dev in ("cpu", device):
        model = convert.params_from_tree(cfg, tree, dev)
        b = {k: v.to(dev) for k, v in host.items()}
        step = steps.make_train_step(cfg, opt_cfg, peak_lr=peak_lr,
                                     warmup=warmup, total_steps=10 * warmup,
                                     return_grads=True)
        model, _, m = step(model, adamw_init(model, opt_cfg), b, 0)
        out.append({"loss": float(m["loss"]),
                    "grad_norm": float(m["grad_norm"]),
                    "lr": float(m["lr"]),
                    "grads": {k: g.cpu() for k, g in m["grads"].items()},
                    "params": {k: p.detach().cpu()
                               for k, p in model.named_parameters()}})
    return out


#: a gradient under this share of the step's largest is at its rounding
#: floor: Adam's first step normalises it (``lr * g / (|g| + eps)``), so
#: two devices may move its parameter by up to the rate each way
FLOOR = 1e-4


def step_mismatches(want: dict, got: dict, tol: float
                    ) -> tuple[dict, list[str]]:
    """Hold ``got``'s train step (a :func:`train_step_on_both` entry) to
    ``want``'s: the loss and the gradient norm within ``tol`` (relative),
    every gradient within ``tol`` (relative and absolute, when both carry
    them), and every updated parameter within ``tol``, except where
    ``want``'s gradient is under ``FLOOR`` of its largest: such an element
    may differ by up to 2 x lr, and they may be at most a thousandth of
    all. Returns (the largest errors: ``params`` over the elements within
    ``tol``, ``floor`` the count beyond it and ``floor_lr`` their largest
    error over the rate; the failures as text, empty when the steps
    agree)."""
    bad = []
    errs = {"loss": abs(got["loss"] - want["loss"]),
            "grad_norm": abs(got["grad_norm"] - want["grad_norm"]),
            "grads": 0.0, "params": 0.0, "floor": 0, "floor_lr": 0.0}
    for key in ("loss", "grad_norm"):
        if errs[key] > tol * max(1.0, abs(want[key])):
            bad.append(f"{key} {got[key]} against {want[key]}")
    for k, g in got["grads"].items():
        w = want["grads"][k]
        d = (g.float() - w.float()).abs()
        errs["grads"] = max(errs["grads"], float(d.max()))
        if bool((d > tol + tol * w.float().abs()).any()):
            bad.append(f"gradient {k}: max abs err {float(d.max())}")
    grads = want["grads"]
    gmax = max((float(g.abs().max()) for g in grads.values()), default=0.0)
    lr, total = want["lr"], 0
    for k, p in got["params"].items():
        d = (p.float() - want["params"][k].float()).abs()
        total += d.numel()
        far = d > tol
        if bool((~far).any()):
            errs["params"] = max(errs["params"], float(d[~far].max()))
        if not bool(far.any()):
            continue
        n_far, worst = int(far.sum()), float(d[far].max())
        errs["floor"] += n_far
        errs["floor_lr"] = max(errs["floor_lr"], worst / lr)
        at_floor = k in grads and bool(
            (grads[k].float().abs()[far] <= FLOOR * gmax).all())
        if not at_floor or worst > 2 * lr:
            bad.append(f"parameter {k}: {n_far} elements beyond {tol}, "
                       f"max {worst} (rate {lr})")
    if errs["floor"] > 1e-3 * total:
        bad.append(f"{errs['floor']} of {total} parameters beyond {tol}")
    return errs, bad


def mesh_runs(cfg: ModelConfig, device, mesh, *, seed: int = 0,
              data_seed: int = 0) -> dict:
    """``device``'s side of :func:`logits_on_both` (``"logits"``) and of
    :func:`train_step_on_both` (``"step"``), with ``models.pshard``'s mesh
    set to ``mesh`` (batch over ``sharding.batch_axes(mesh)``) and cleared
    afterwards; ``mesh=None`` runs with none set."""
    from repro_torch.models import pshard, sharding

    if mesh is not None:
        pshard.set_mesh(mesh, sharding.batch_axes(mesh))
    try:
        logits = [got for _, got in logits_on_both(
            cfg, device, seed=seed, data_seed=data_seed)]
        step = train_step_on_both(cfg, device, seed=seed,
                                  data_seed=data_seed)[1]
    finally:
        pshard.clear_mesh()
    return {"logits": logits, "step": step}


def mesh_mismatches(a: dict, b: dict) -> list[str]:
    """What differs, bit for bit, between two :func:`mesh_runs`."""
    bad = [f"logits[{i}]" for i, (x, y) in
           enumerate(zip(a["logits"], b["logits"])) if not torch.equal(x, y)]
    for k in ("loss", "grad_norm"):
        if a["step"][k] != b["step"][k]:
            bad.append(k)
    for what in ("grads", "params"):
        bad += [f"{what} {k}" for k, v in a["step"][what].items()
                if not torch.equal(v, b["step"][what][k])]
    return bad
