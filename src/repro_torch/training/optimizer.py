"""AdamW with optional error-feedback int8 gradient compression.

The port of `repro.training.optimizer`. The moments are float32 whatever
the params' dtype, and the update runs in the reference's order: g in
float32, m and v, their bias corrections, then
`mhat / (sqrt(vhat) + eps) + wd * p`, the new param computed in float32
and cast to p's dtype. It is functional: new tensors come back and the
inputs stay untouched. It runs leaf by leaf, so its float32 scratch is a
few copies of the largest leaf (`torch.optim.AdamW` decays first and
keeps bf16 moments for bf16 params, so it is not this update).

`opt_state_axes` gives the ZeRO-1 logical axes of the state (the moments
sharded over "data" through "opt_fsdp").
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.transformer import params_from_jax
from repro_torch.training.tree import leaves, map_axes, tree_map, unflatten

PyTree = Any


class AdamWState(NamedTuple):
    step: torch.Tensor       # () int32
    m: PyTree                # float32, like params
    v: PyTree                # float32, like params


def adamw_init(params: PyTree) -> AdamWState:
    """Zero moments in float32 on each param's device; step 0 (int32) on
    the first leaf's."""
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                  device=p.device)
    dev = leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      m=tree_map(zeros, params), v=tree_map(zeros, params))


def _upd(g, m, v, p, bc1, bc2, lr, b1, b2, eps, weight_decay):
    """One leaf's update, op for op the reference's (each product and sum
    rounded in float32 as there); returns (p_new, m_new, v_new)."""
    g = g.float()
    m_new = m * b1
    m_new.add_(g * (1 - b1))
    v_new = v * b2
    v_new.add_(g.square().mul_(1 - b2))
    del g
    denom = (v_new / bc2).sqrt_().add_(eps)
    delta = (m_new / bc1).div_(denom)
    del denom
    p32 = p.float()
    delta.add_(p32 * weight_decay)
    p_new = (p32 - delta.mul_(lr)).to(p.dtype)
    return p_new, m_new, v_new


@torch.no_grad()
def adamw_update(grads: PyTree, state: AdamWState, params: PyTree, *,
                 lr: float = 3e-4, b1: float = 0.9, b2: float = 0.95,
                 eps: float = 1e-8, weight_decay: float = 0.1,
                 ) -> Tuple[PyTree, AdamWState]:
    step = state.step + 1
    t = step.float()
    bc1 = 1.0 - b1 ** t
    bc2 = 1.0 - b2 ** t
    flat_p = leaves(params)
    flat = zip(leaves(grads), leaves(state.m), leaves(state.v), flat_p)
    out = [_upd(g, m, v, p, bc1, bc2, lr, b1, b2, eps, weight_decay)
           for g, m, v, p in flat]
    new_p = unflatten(params, [o[0] for o in out])
    new_m = unflatten(params, [o[1] for o in out])
    new_v = unflatten(params, [o[2] for o in out])
    return new_p, AdamWState(step, new_m, new_v)


def opt_state_axes(params_axes: PyTree) -> AdamWState:
    """Logical axes for AdamWState (ZeRO-1): the moments replace the
    weights' "fsdp" logical axis with "opt_fsdp", so optimizer state can
    be sharded over the data axis while the weights stay replicated
    across it."""
    def swap(axes):
        return tuple("opt_fsdp" if a == "fsdp" else a for a in axes)

    mapped = map_axes(swap, params_axes)
    return AdamWState(step=(), m=mapped, v=mapped)


def adamw_state_from_jax(cfg, np_state, device="cuda") -> AdamWState:
    """The JAX package's AdamWState with numpy leaves (e.g. from
    `jax.tree.map(np.asarray, state)`) as the port's: the int32 step and
    float32 moments laid out as `models.params_from_jax` lays out the
    weights."""
    step, m, v = np_state
    moments = [params_from_jax(cfg, t, device=device, dtype=torch.float32)
               for t in (m, v)]
    step = torch.from_numpy(np.asarray(step, np.int32).copy()).to(
        moments[0]["final_norm"].device)
    return AdamWState(step, *moments)


# ---------------------------------------------------------------------------
# error-feedback int8 gradient compression
# ---------------------------------------------------------------------------

@torch.no_grad()
def compress_grads(grads: PyTree, residual: Optional[PyTree]):
    """Quantize grads to int8 with a per-tensor scale and error feedback.

    Returns (q_grads, scales, new_residual): the residual keeps the
    quantization error for the next step."""
    if residual is None:
        residual = tree_map(lambda g: torch.zeros_like(g, dtype=torch.float32),
                            grads)

    def q(g, r):
        g = g.float() + r
        scale = torch.clamp(g.abs().max(), min=1e-12) / 127.0
        qg = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
        new_r = g - qg.float() * scale
        return qg, scale, new_r

    out = [q(g, r) for g, r in zip(leaves(grads), leaves(residual))]
    return (unflatten(grads, [o[0] for o in out]),
            unflatten(grads, [o[1] for o in out]),
            unflatten(grads, [o[2] for o in out]))


def decompress_grads(q_grads: PyTree, scales: PyTree) -> PyTree:
    return tree_map(lambda qg, s: qg.float() * s, q_grads, scales)
