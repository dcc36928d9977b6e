"""Causal-LM training step (loss, grads, AdamW update).

The port of `repro.training.train_step`. The forward takes the
differentiable route (`models.forward(..., differentiable=True)`): GQA
and hymba's attention heads run the blocked `flash_attention`, MLA, MoE
and the SSM mixers their plain torch ops, so no kernel of `kernels.ops`
is launched. The step is functional, as the reference's is: it returns
new params and a new optimizer state and leaves its inputs untouched,
so the loop can retry a step from the last good state.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, List, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import forward
from repro_torch.training.optimizer import AdamWState, adamw_update
from repro_torch.training.tree import (leaves, leaves_with_paths, path_key,
                                       unflatten)

PyTree = Any


def lm_loss(params, cfg: ModelConfig, tokens=None, embeds=None,
            labels=None, remat: bool = True,
            remat_policy: str = "none") -> torch.Tensor:
    """Next-token cross-entropy over float32 logits. For token inputs,
    labels default to the shifted input; with `embeds` (the vision and
    audio frontends) they are given."""
    logits, _ = forward(params, cfg, tokens=tokens, embeds=embeds,
                        remat=remat, remat_policy=remat_policy,
                        differentiable=True)
    if labels is None:
        if tokens is None:
            raise ValueError("embeds inputs need their labels")
        logits = logits[:, :-1]
        labels = tokens[:, 1:]
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return (logz - gold).mean()


def value_and_grad(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
                   *, remat: bool = True, remat_policy: str = "none"
                   ) -> Tuple[torch.Tensor, PyTree, List[str]]:
    """(loss, grads shaped like params, the leaves the loss did not
    reach). Each unreached leaf (the token table under `embeds`) gets a
    zero grad, as `jax.grad` gives it."""
    paths, flat = zip(*leaves_with_paths(params))
    live = [p.detach().requires_grad_(True) for p in flat]
    tree = unflatten(params, live)
    with torch.enable_grad():
        loss = lm_loss(tree, cfg, tokens=batch.get("tokens"),
                       embeds=batch.get("embeds"), labels=batch.get("labels"),
                       remat=remat, remat_policy=remat_policy)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    missing = [path_key(pa) for pa, g in zip(paths, grads) if g is None]
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(flat, grads)]
    return loss.detach(), unflatten(params, grads), missing


def train_step(params, opt_state: AdamWState, batch, cfg: ModelConfig, *,
               lr: float = 3e-4, remat: bool = True, microbatches: int = 1,
               remat_policy: str = "none", scaled=None
               ) -> Tuple[PyTree, AdamWState, torch.Tensor]:
    """One optimization step. batch: dict with 'tokens' or 'embeds'
    (+ 'labels').

    With microbatches > 1, the global batch is split along dim 0 and the
    grads are accumulated in float32, then the loss and the grads are
    averaged (bounds activation memory).

    `scaled`, an op counter's `scaled` (launch/op_count.py), is for a
    trace: with microbatches > 1 only the first microbatch runs, and it is
    counted for all of them (they share one shape): its value_and_grad
    and the loss's sum `microbatches` times, its accumulation's add
    `microbatches - 1` times.

    Returns (new_params, new_opt_state, loss)."""
    if microbatches <= 1:
        loss, grads, _ = value_and_grad(params, batch, cfg, remat=remat,
                                        remat_policy=remat_policy)
    else:
        B = next(iter(batch.values())).shape[0]
        if B % microbatches:
            raise ValueError(f"batch {B} does not split into "
                             f"{microbatches} microbatches")
        chunks = {k: v.chunk(microbatches) for k, v in batch.items()}
        loss_sum, acc = 0.0, None
        for i in range(1 if scaled else microbatches):
            with (scaled(microbatches) if scaled
                  else contextlib.nullcontext()):
                loss, g, _ = value_and_grad(
                    params, {k: v[i] for k, v in chunks.items()}, cfg,
                    remat=remat, remat_policy=remat_policy)
                loss_sum = loss_sum + loss
            if acc is None:
                acc = [x.float().clone() for x in leaves(g)]
            if i or scaled:
                with (scaled(microbatches - 1) if scaled
                      else contextlib.nullcontext()):
                    for a, x in zip(acc, leaves(g)):
                        a.add_(x.float())
            del g
        loss = loss_sum / microbatches
        grads = unflatten(params, [a.div_(microbatches) for a in acc])
    new_params, new_opt = adamw_update(grads, opt_state, params, lr=lr)
    return new_params, new_opt, loss


def make_train_step(cfg: ModelConfig, lr: float = 3e-4, remat: bool = True,
                    microbatches: int = 1, remat_policy: str = "none"):
    """step(params, opt_state, batch) -> (params, opt_state, loss)."""
    def step(params, opt_state, batch):
        return train_step(params, opt_state, batch, cfg, lr=lr, remat=remat,
                          microbatches=microbatches,
                          remat_policy=remat_policy)
    return step
