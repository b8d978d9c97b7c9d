"""Step factories: training and serving (port of ``repro.models.steps``).

The loss is chunked over the sequence so that (B, L, V) logits never
exist at once: at vocab 200k+ they would dominate device memory. While
gradients are taken each chunk runs under a non-reentrant checkpoint
(the reference's ``@jax.checkpoint`` on the chunk body), so the backward
holds one chunk's float32 logits at a time.

``make_train_step``: forward (each period under ``cfg.remat``) ->
chunked CE -> gradients -> AdamW, over ``cfg.grad_accum`` microbatches
(sequential, float32 gradient sums). ``make_prefill_step`` /
``make_decode_step`` are greedy: the argmax of the float32 logits (the
first maximum on ties, as ``jnp.argmax``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models import pshard
from repro_torch.models import transformer as tfm
from repro_torch.models.config import ModelConfig
from repro_torch.optim.adamw import AdamWConfig, adamw_update
from repro_torch.optim.schedule import cosine_schedule

__all__ = ["chunked_ce_loss", "make_loss_fn", "loss_and_grads",
           "make_train_step", "make_prefill_step", "make_decode_step"]


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

    def body(h, y, m):
        logits = pshard.hint(tfm.lm_logits(params, cfg, h), "btv")
        logz = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, y[..., None].long())[..., 0]
        return torch.sum((logz - gold) * m)

    grads = tfm.taking_grads(params)
    for c in range(0, l + pad, chunk):
        xs = (hidden[:, c:c + chunk], labels[:, c:c + chunk],
              loss_mask[:, c:c + chunk].float())
        tot = tot + (checkpoint(body, *xs, use_reentrant=False) if grads
                     else body(*xs))
        cnt = cnt + torch.sum(xs[2])
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


def loss_and_grads(cfg: ModelConfig, model, batch: dict,
                   aux_weight: float = 0.01) -> tuple[torch.Tensor, dict]:
    """The loss (detached) and its gradient for every parameter of
    ``model``, by name. The parameters require gradients only inside the
    call, so serving runs without autograd."""
    names, leaves = zip(*model.named_parameters())
    for p in leaves:
        p.requires_grad_(True)
    try:
        loss, _ = make_loss_fn(cfg, aux_weight)(model, batch)
        grads = torch.autograd.grad(loss, leaves)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    return loss.detach(), dict(zip(names, grads))


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, *,
                    peak_lr: float = 3e-4, warmup: int = 100,
                    total_steps: int = 10_000, aux_weight: float = 0.01,
                    return_grads: bool = False):
    """Returns ``train_step(params, opt_state, batch, step) -> (params,
    opt_state, metrics)``.

    ``params`` is the port's ``Transformer``, ``opt_state`` its
    ``adamw_init`` state; both are updated in place and returned (a
    failure after AdamW's first write raises
    ``optim.adamw.PartialUpdateError``; ``runtime.ft.train_loop`` then
    restores a checkpoint rather than retry). ``batch`` holds tensors on
    the model's device (``tokens``, ``labels``, ``loss_mask``, and
    ``embeds`` for llava and whisper); with ``cfg.grad_accum = A > 1``
    each leaf is ``(A, B/A, ...)`` and the microbatches' gradients are
    summed in float32, then divided by A. ``step`` is the step counter
    (an ``int``) of the cosine schedule. ``metrics``: ``loss``, ``lr`` and
    ``grad_norm``, float32 scalars on the device, and with
    ``return_grads`` the gradients handed to AdamW, by parameter name.
    """
    def train_step(params, opt_state, batch, step):
        if cfg.grad_accum > 1:
            gsum = lsum = None
            for a in range(cfg.grad_accum):
                loss, grads = loss_and_grads(
                    cfg, params, {k: v[a] for k, v in batch.items()},
                    aux_weight)
                if gsum is None:
                    gsum = {k: torch.zeros(g.shape, dtype=torch.float32,
                                           device=g.device)
                            for k, g in grads.items()}
                    lsum = torch.zeros((), dtype=torch.float32,
                                       device=loss.device)
                for k, g in grads.items():
                    gsum[k].add_(g)
                lsum = lsum + loss
                del grads
            # over a tensor: CUDA divides by a Python number as a
            # product with its reciprocal
            n = torch.full((), float(cfg.grad_accum), device=lsum.device)
            grads = {k: s.div_(n) for k, s in gsum.items()}
            loss = lsum / n
        else:
            loss, grads = loss_and_grads(cfg, params, batch, aux_weight)
        lr = cosine_schedule(step, peak_lr=peak_lr, warmup=warmup,
                             total=total_steps).to(loss.device)
        params, opt_state, om = adamw_update(params, grads, opt_state, lr,
                                             opt_cfg)
        return params, opt_state, {"loss": loss, "lr": lr, **om,
                                   **({"grads": grads} if return_grads
                                      else {})}

    return train_step


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
