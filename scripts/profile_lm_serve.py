#!/usr/bin/env python3
"""Where the port's LM serving time goes on one card: Moonlight-16B-A3B
at full width in bf16, as ``chip_smoke.py`` phase 9m serves it.

    python3 scripts/profile_lm_serve.py [OUT_DIR]

Run from a checkout's root. Draws the weights on the card (seed 0),
takes 4 x 2,048 ``SyntheticCorpus`` prompts, runs one warm prefill and
two warm decode steps, then under ``torch.profiler`` (CPU and CUDA
activities) one prefill and ``STEPS`` decode steps. For each window it
prints the wall time (host clock ending in a synchronize), the device
time summed over kernels, their ratio (the device's busy share; kernels
that overlap would count twice, and in one stream they do not), the
number of kernel launches, and the kernels with the most device time,
grouped by name. The full tables go to ``OUT_DIR/lm_profile.txt``
(default ``build``). Prints the card's name and power limit first.
Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import os
import subprocess
import sys
import time

STEPS = 4
TOP = 15


def _window(torch, fn):
    """(wall s, per-kernel device time {name: (us, calls)}) of ``fn``
    under the profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = {}
    for row in prof.key_averages():
        if row.device_type.name == "CUDA" and row.self_device_time_total > 0:
            kernels[row.key] = (row.self_device_time_total, row.count)
    return wall, kernels


def _report(label, wall, kernels, out):
    busy = sum(us for us, _ in kernels.values()) / 1e6
    if busy == 0:
        raise SystemExit(f"{label}: the profiler saw no device time")
    launches = sum(n for _, n in kernels.values())
    head = (f"{label}: wall {wall * 1e3:.3f} ms, device time "
            f"{busy * 1e3:.3f} ms ({100 * busy / wall:.1f}% busy), "
            f"{launches} kernel launches")
    print(head, flush=True)
    out.write(head + "\n")
    rows = sorted(kernels.items(), key=lambda kv: -kv[1][0])
    for i, (name, (us, n)) in enumerate(rows):
        line = (f"  {us / 1e3:9.3f} ms {100 * us / 1e6 / busy:5.1f}% "
                f"{n:6d} x  {name[:110]}")
        out.write(line + "\n")
        if i < TOP:
            print(line, flush=True)


def main() -> int:
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, os.path.join(root, "src"))
    import torch
    if not torch.cuda.is_available():
        print("profile_lm_serve: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs import ARCHS
    from repro_torch.data.pipeline import SyntheticCorpus
    from repro_torch.models import transformer as tfm
    from repro_torch.models.steps import make_decode_step, make_prefill_step

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    out_dir = sys.argv[1] if len(sys.argv) > 1 else "build"
    os.makedirs(out_dir, exist_ok=True)

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = ARCHS["moonshot-v1-16b-a3b"]
    model = tfm.init_params(torch.Generator(device="cuda").manual_seed(0),
                            cfg, "cuda")
    batch, prompt = 4, 2048
    tokens = torch.from_numpy(SyntheticCorpus(
        vocab_size=cfg.vocab_size, seq_len=prompt, global_batch=batch,
        seed=0).batch(0)["tokens"]).cuda()
    cache = tfm.init_cache(cfg, batch, prompt + STEPS + 8, "cuda")
    prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)
    tok, cache = prefill(model, {"tokens": tokens}, cache)
    tok = tok[:, None]
    for i in range(2):
        decode(model, tok, cache, prompt + i)

    def run_prefill():
        prefill(model, {"tokens": tokens}, cache)

    def run_decode():
        t = tok
        for i in range(STEPS):
            t, _ = decode(model, t, cache, prompt + i)

    with open(os.path.join(out_dir, "lm_profile.txt"), "w") as out:
        out.write(card + "\n")
        wall, kernels = _window(torch, run_prefill)
        _report(f"prefill {batch} x {prompt}", wall, kernels, out)
        wall, kernels = _window(torch, run_decode)
        _report(f"decode, {STEPS} steps", wall, kernels, out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
