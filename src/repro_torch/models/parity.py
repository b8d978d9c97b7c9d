"""One model on two devices: the same weights and inputs on the CPU and
on ``device``, and the logits of a prefill and of greedy decode steps on
both.

The CPU tests hold the CPU side against the JAX package; holding the card
against the CPU closes the chain. ``chip_smoke.py`` and
``tests/test_torch_cuda.py`` both call :func:`logits_on_both`.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import convert
from repro_torch.models import transformer as tfm
from repro_torch.models.config import ModelConfig

__all__ = ["logits_on_both"]


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
    rng = np.random.default_rng(data_seed)
    text = length - (cfg.num_image_tokens if cfg.family == "vlm" else 0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (batch, text)))
    emb = None
    if cfg.family == "vlm" or cfg.is_enc_dec:
        s = cfg.num_image_tokens if cfg.family == "vlm" else cfg.encoder_seq
        emb = torch.from_numpy(rng.normal(size=(batch, s, cfg.d_model))
                               .astype(np.float32))
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
