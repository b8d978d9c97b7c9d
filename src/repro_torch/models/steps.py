"""Step factories of the serving path and the forward-only loss (port of
``repro.models.steps``).

``make_prefill_step`` / ``make_decode_step`` are greedy: the argmax of
the float32 logits (the first maximum on ties, as ``jnp.argmax``). The
loss is chunked over the sequence so that (B, L, V) logits never exist
at once: at vocab 200k+ they would dominate device memory.
``make_train_step`` (gradients, AdamW, the schedule) comes with the
training slice.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import transformer as tfm
from repro_torch.models.config import ModelConfig

__all__ = ["chunked_ce_loss", "make_loss_fn", "make_prefill_step",
           "make_decode_step"]


def chunked_ce_loss(params, cfg: ModelConfig, hidden, labels, loss_mask):
    """Mean CE over masked positions; logits chunked along L.

    hidden: (B, L, D); labels, loss_mask: (B, L).
    """
    l = hidden.shape[1]
    chunk = min(cfg.ce_chunk, l)
    pad = (-l) % chunk
    if pad:
        hidden = F.pad(hidden, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad))
        loss_mask = F.pad(loss_mask, (0, pad))
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c in range(0, l + pad, chunk):
        logits = tfm.lm_logits(params, cfg, hidden[:, c:c + chunk])
        logz = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, labels[:, c:c + chunk, None].long())[..., 0]
        m = loss_mask[:, c:c + chunk].float()
        tot = tot + torch.sum((logz - gold) * m)
        cnt = cnt + torch.sum(m)
    return tot / torch.clamp(cnt, min=1.0)


def make_loss_fn(cfg: ModelConfig, aux_weight: float = 0.01):
    """loss_fn(params, batch) -> (CE + aux_weight * aux, {"ce", "aux"})."""
    def loss_fn(params, batch):
        hidden, aux = tfm.forward_hidden(params, cfg, batch["tokens"],
                                         embeds=batch.get("embeds"))
        if cfg.family == "vlm":
            # loss over the text positions only (image prefix excluded)
            hidden = hidden[:, -batch["tokens"].shape[1]:]
        loss = chunked_ce_loss(params, cfg, hidden, batch["labels"],
                               batch["loss_mask"])
        return loss + aux_weight * aux, {"ce": loss, "aux": aux}
    return loss_fn


def make_prefill_step(cfg: ModelConfig):
    """prefill_step(params, batch, cache) -> (next token int32 (B,),
    cache)."""
    def prefill_step(params, batch, cache):
        logits, cache = tfm.prefill(params, cfg, batch["tokens"], cache,
                                    embeds=batch.get("embeds"))
        return torch.argmax(logits, dim=-1).to(torch.int32), cache
    return prefill_step


def make_decode_step(cfg: ModelConfig):
    """decode_step(params, token, cache, pos) -> (next token int32
    (B, 1), cache)."""
    def decode_step(params, token, cache, pos):
        logits, cache = tfm.decode_step(params, cfg, token, cache, pos)
        return torch.argmax(logits, dim=-1).to(torch.int32)[:, None], cache
    return decode_step
