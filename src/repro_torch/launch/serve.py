"""Serving launcher: batched prefill + greedy decode with a KV cache (port
of ``repro.launch.serve``).

    python -m repro_torch.launch.serve --arch <id> [--batch B]
        [--prompt-len L] [--gen N] [--device cuda|cpu]

Runs the architecture's reduced config (``ModelConfig.reduced()``) with
weights drawn from seed 0 and prompts from seed 1, on ``--device``
(default: the card; raises without one; ``cpu`` runs on the CPU), and
prints ``generated (B, N + 1) tokens; prefill ... ms, ... ms/token``.
Times are host clock around work that ends in a device synchronize.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import ARCHS
from repro_torch.kernels.inputs import resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.models.steps import make_decode_step, make_prefill_step


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="cuda (default: the card; raises without one) "
                         "or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = ARCHS[args.arch].reduced()
    params = tfm.init_params(torch.Generator(device).manual_seed(0), cfg,
                             device)
    prefill = make_prefill_step(cfg)
    decode = make_decode_step(cfg)

    b, l = args.batch, args.prompt_len
    gen = torch.Generator(device).manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, l), generator=gen,
                                     device=device, dtype=torch.int32)}
    if cfg.family == "vlm":
        batch["embeds"] = torch.randn((b, cfg.num_image_tokens, cfg.d_model),
                                      generator=gen, device=device)
    if cfg.is_enc_dec:
        batch["embeds"] = torch.randn((b, cfg.encoder_seq, cfg.d_model),
                                      generator=gen, device=device)

    cache = tfm.init_cache(cfg, b, l + args.gen + 8, device)
    t0 = time.perf_counter()
    tok, cache = prefill(params, batch, cache)
    tok = tok[:, None]
    _sync(device)
    prefill_t = time.perf_counter() - t0
    pos0 = l + (cfg.num_image_tokens if cfg.family == "vlm" else 0)

    out = [tok]
    t0 = time.perf_counter()
    for i in range(args.gen):
        tok, cache = decode(params, tok, cache, pos0 + i)
        out.append(tok)
    _sync(device)
    decode_t = (time.perf_counter() - t0) / max(args.gen, 1)
    toks = torch.cat(out, dim=1)
    print(f"generated {tuple(toks.shape)} tokens; prefill "
          f"{prefill_t * 1e3:.1f}ms, {decode_t * 1e3:.1f}ms/token")
    print("sample:", toks[0, :12].tolist())


if __name__ == "__main__":
    main()
