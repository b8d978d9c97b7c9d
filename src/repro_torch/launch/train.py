"""Training launcher (port of ``repro.launch.train``).

    python -m repro_torch.launch.train --arch <id> [--steps N] [--batch B]
        [--seq L] [--reduced | --full] [--ckpt-dir DIR] [--ckpt-every K]
        [--lr LR] [--device cuda|cpu]

Composes the stack as the reference does: the config registry -> the
model from seed 0 -> AdamW (its moments in the config's ``adam_dtype``)
-> ``make_train_step`` (cosine schedule, warmup a tenth of the steps) ->
the synthetic corpus -> the fault-tolerant ``train_loop`` (checkpoints
in the JAX package's layout every ``--ckpt-every`` steps, restart from
the newest one, retries, the straggler watchdog). ``--reduced`` (the
default) trains the architecture's small config; ``--full`` its
published one. ``--device``: the card by default (raises without one);
``cpu`` runs on the CPU. Prints the arch and device line, the parameter
count, ``restored from step N`` when a checkpoint was restored, and the
final and first losses.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import ARCHS
from repro_torch.data.pipeline import SyntheticCorpus
from repro_torch.kernels.inputs import resolve_device
from repro_torch.models import convert
from repro_torch.models import transformer as tfm
from repro_torch.models.steps import make_train_step
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.runtime.ft import FTConfig, train_loop


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--ckpt-dir", default="checkpoints")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--device", default=None,
                    help="cuda (default: the card; raises without one) "
                         "or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = ARCHS[args.arch]
    if args.reduced:
        cfg = cfg.reduced()
    devices = torch.cuda.device_count() if device.type == "cuda" else 1
    print(f"arch={cfg.name} reduced={args.reduced} devices={devices} "
          f"({device.type})")

    params = tfm.init_params(torch.Generator(device).manual_seed(0), cfg,
                             device)
    opt_cfg = AdamWConfig(dtype=cfg.adam_dtype)
    opt_state = adamw_init(params, opt_cfg)
    n_params = sum(p.numel() for p in params.parameters())
    print(f"params: {n_params/1e6:.1f}M")

    step_fn = make_train_step(
        cfg, opt_cfg, peak_lr=args.lr, warmup=max(args.steps // 10, 1),
        total_steps=args.steps)
    corpus = SyntheticCorpus(vocab_size=cfg.vocab_size, seq_len=args.seq,
                             global_batch=args.batch)

    def to_device(b):
        return {k: torch.from_numpy(v).to(device) for k, v in b.items()}

    params, opt_state, hist = train_loop(
        step_fn=step_fn, params=params, opt_state=opt_state, corpus=corpus,
        num_steps=args.steps,
        ft=FTConfig(ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every),
        to_device=to_device, codec=convert.TRAIN_STATE)
    if hist["restored_from"] is not None:
        print(f"restored from step {hist['restored_from']}")
    print(f"final loss: {hist['loss'][-1]:.4f} "
          f"(first: {hist['loss'][0]:.4f}); "
          f"stragglers={hist['straggler_steps']} retries={hist['retries']}")


if __name__ == "__main__":
    main()
