#!/usr/bin/env python3
"""Where the port's LM training step goes on one card: Moonlight-16B-A3B
at full width, cut in depth as ``chip_smoke.py`` phase 9g cuts it
(``--layers``, default its ``TR_LAYERS``; bf16 weights, float32 AdamW
moments, remat "full", 4 x 2,048 ``SyntheticCorpus(seed=1)`` tokens a
step).

    python3 scripts/profile_lm_train.py [OUT_DIR] [--layers N]

Run from a checkout's root. Draws the weights on the card (seed 0) and
runs two warm steps, then prints the peak ``max_memory_allocated`` of
those steps (the weights, gradients and moments included). Then, each
the median of ``REPS`` CUDA-event timings: the whole step
(``make_train_step``); its gradients alone (``steps.loss_and_grads``);
AdamW alone on those gradients; the chunked loss alone (its forward
and backward from the final hidden states); and one period's forward
with and without the "full" checkpoint. Then one step under
``torch.profiler``: the wall time, the device time summed over kernels,
their ratio (the device's busy share), the number of launches and the
kernels with the most device time (``scripts/profile_lm_serve.py``'s
report); the full table goes to ``OUT_DIR/lm_train_profile.txt``
(default ``build``). Prints the card's name and power limit first.
Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import statistics
import subprocess
import sys

REPS = 3
#: the depth ``chip_smoke.py`` phase 9g trains (its ``TR_LAYERS``)
TR_LAYERS = 8


def _ms(torch, fn, reps=REPS):
    """Median CUDA-event milliseconds of ``fn`` over ``reps`` calls."""
    out = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end))
    return statistics.median(out)


def main() -> int:
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, os.path.join(root, "src"))
    sys.path.insert(0, os.path.join(root, "scripts"))
    import torch
    if not torch.cuda.is_available():
        print("profile_lm_train: no CUDA device", file=sys.stderr)
        return 2
    from profile_lm_serve import _report, _window
    from repro_torch.configs import ARCHS
    from repro_torch.data.pipeline import SyntheticCorpus
    from repro_torch.models import steps
    from repro_torch.models import transformer as tfm
    from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("out_dir", nargs="?", default="build")
    ap.add_argument("--layers", type=int, default=TR_LAYERS)
    args = ap.parse_args()
    out_dir = args.out_dir
    os.makedirs(out_dir, exist_ok=True)

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(ARCHS["moonshot-v1-16b-a3b"],
                              num_layers=args.layers)
    model = tfm.init_params(torch.Generator(device="cuda").manual_seed(0),
                            cfg, "cuda")
    opt_cfg = AdamWConfig(dtype=cfg.adam_dtype)
    opt = adamw_init(model, opt_cfg)
    host = SyntheticCorpus(vocab_size=cfg.vocab_size, seq_len=2048,
                           global_batch=4, seed=1).batch(0)
    batch = {k: torch.from_numpy(v).cuda() for k, v in host.items()}
    step = steps.make_train_step(cfg, opt_cfg, peak_lr=3e-4, warmup=1,
                                 total_steps=8)
    for i in range(2):
        step(model, opt, batch, i)
    torch.cuda.synchronize()
    print(f"{args.layers} layers, {sum(p.numel() for p in model.parameters())}"
          f" parameters: peak over two steps "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    leaves = list(model.parameters())

    def grads():
        return steps.loss_and_grads(cfg, model, batch)[1]

    lr = torch.tensor(1e-9, device="cuda")
    with torch.no_grad():
        hidden, _ = tfm.forward_hidden(model, cfg, batch["tokens"])

    def head():
        model.lm_head.w.requires_grad_(True)
        model.final_norm.scale.requires_grad_(True)
        h = hidden.detach().requires_grad_(True)
        try:
            loss = steps.chunked_ce_loss(model, cfg, h, batch["labels"],
                                         batch["loss_mask"])
            torch.autograd.grad(loss, [h, model.lm_head.w,
                                       model.final_norm.scale])
        finally:
            model.lm_head.w.requires_grad_(False)
            model.final_norm.scale.requires_grad_(False)

    x = hidden.detach()
    pos = torch.arange(x.shape[1], device="cuda")
    aux = torch.zeros((), device="cuda")

    def period(remat):
        body = lambda x, aux: tfm._apply_period(model, cfg, 0, pos, None,
                                                None, x, aux)
        for p in leaves:
            p.requires_grad_(True)
        try:
            xx = x.clone().requires_grad_(True)
            y, a = (tfm._remat(body, cfg) if remat else body)(xx, aux)
            return y, a
        finally:
            for p in leaves:
                p.requires_grad_(False)

    lines = [f"step {_ms(torch, lambda: step(model, opt, batch, 3)):.1f} ms",
             f"gradients {_ms(torch, grads):.1f} ms"]
    g = grads()
    adamw = _ms(torch, lambda: adamw_update(model, g, opt, lr, opt_cfg))
    lines.append(f"AdamW {adamw:.1f} ms")
    del g
    lines += [
        f"chunked loss forward + backward {_ms(torch, head):.1f} ms",
        f"one period forward, no checkpoint "
        f"{_ms(torch, lambda: period(False)):.1f} ms",
        f"one period forward, remat full "
        f"{_ms(torch, lambda: period(True)):.1f} ms"]
    for line in lines:
        print(line, flush=True)
    with open(os.path.join(out_dir, "lm_train_profile.txt"), "w") as out:
        out.write(card + "\n" + "\n".join(lines) + "\n")
        wall, kernels = _window(torch, lambda: step(model, opt, batch, 4))
        _report("train step 4 x 2048", wall, kernels, out)
    print(f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return 0


if __name__ == "__main__":
    sys.exit(main())
