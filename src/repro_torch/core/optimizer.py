"""Gradient-based global query optimizer (paper §4, Eq. 10-15).

The port of `repro.core.optimizer`. Minimize expected cost subject to
Bayesian lower bounds on global recall and precision exceeding the user
targets:

    L = L_cost + beta * ReLU(T_P - l_P) + beta * ReLU(T_R - l_R)

over pick logits and thresholds of every physical operator, through the
soft cascade simulation (relaxation.py) and the Beta credible bounds
(bounds.py), with Adam and an exponential temperature schedule. At
tau -> 0 the plan is extracted discretely and re-verified with *hard*
counts; if the hard bounds miss the targets the planner falls back to
more conservative candidates and ultimately the gold-only plan.

The JAX package runs its restarts under `jax.jit(jax.vmap(run_one))` with
a hand-written Adam inside a `lax.scan`. Here the parameters carry a
leading restart dimension `(K, P)`: the relaxation broadcasts over it,
the K independent losses are summed, and one `backward` gives every
restart its own gradient (no restart's loss depends on another's
parameters). The Adam arithmetic, the init grid, the tau schedule and the
snapshot extraction are the reference's.

Where the loop runs follows the reference's jit, which runs on its
default device: the device the pipelines' tensors lie on
(`runtime.plan_utils.pipelines_data(device=)` places them). `adam_loop`
writes one Adam step (forward through the relaxation and the bounds,
`torch.autograd.grad`, Adam) over static state tensors (`adam_step`):
  CPU   the step runs eagerly, one step after another.
  CUDA  the bounds run kernel E; the step is captured once as a
        `torch.cuda.CUDAGraph` and replayed `cfg.steps` times; step and
        tau live on the device, losses and snapshots are copied into
        preallocated buffers, and nothing reads the device until the
        discrete extraction copies its candidates to the host once.
        `adam_loop(graph=False)` runs the same step eagerly (bit for bit
        the graph's result).
The Exp 3 baselines (`core/baselines.py`) run their own loss through the
same loop.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import bounds as B
from repro_torch.core import relaxation as R
from repro_torch.kernels import ops

_F32 = torch.float32


@dataclasses.dataclass
class PlannerConfig:
    steps: int = 400
    lr: float = 5e-2
    beta: float = 25.0
    tau_start: float = 1.0
    tau_end: float = 0.02
    pick_tau: float = 1.0    # constant: annealing the pick sigmoid kills its
    #                          gradient once an op drifts off (sigmoid sat.)
    restarts: int = 6        # multi-start (local optima are real)
    snapshots: int = 4       # candidates along the annealing path: early
    #                          snapshots are conservative, late aggressive
    margin: float = 0.02     # optimize against target+margin: keeps slack
    #                          for the soft->hard extraction gap
    credibility: float = 0.95
    seed: int = 0


class OptimizedPlan(NamedTuple):
    params: List[R.PipelineParams]       # final (discrete-ready) parameters
    selected: List[np.ndarray]           # bool mask per pipeline
    sample_tp: float
    sample_fp: float
    sample_fn: float
    recall_bound: float
    precision_bound: float
    est_cost: float                      # expected cost on sample (s)
    feasible: bool
    loss_history: Optional[np.ndarray] = None


def flatten_params(params_list):
    """Concatenate per-pipeline (pick, thr_hi, thr_lo) along the last
    dimension: the optimizer's parameter layout."""
    return torch.cat([torch.cat([p.pick_logits, p.thr_hi, p.thr_lo], -1)
                      for p in params_list], -1)


def unflatten_params(flat, sizes):
    """Inverse of flatten_params given each pipeline's operator count;
    leading dimensions are kept."""
    out, off = [], 0
    for n in sizes:
        out.append(R.PipelineParams(flat[..., off:off + n],
                                    flat[..., off + n:off + 2 * n],
                                    flat[..., off + 2 * n:off + 3 * n]))
        off += 3 * n
    return out


def _median(x):
    """jnp.median along the last axis: the midpoint of the two middle
    values for an even count (torch.median returns the lower one)."""
    s = torch.sort(x, dim=-1).values
    n = s.shape[-1]
    if n % 2:
        return s[..., n // 2]
    lo, hi = s[..., n // 2 - 1], s[..., n // 2]
    return lo + (hi - lo) * 0.5


def init_pipeline_params(data: R.PipelineData, pick0: float = 0.5,
                         width: float = 0.5) -> R.PipelineParams:
    """Thresholds straddling the median score; everything mildly picked."""
    n = data.scores.shape[0]
    med = _median(data.scores)
    spread = torch.clamp(data.scores.std(dim=1, unbiased=False), min=1e-3)
    return R.PipelineParams(
        pick_logits=torch.zeros(n, device=data.scores.device) + pick0,
        thr_hi=med + width * spread,
        thr_lo=med - width * spread,
    )


def _bounds(c: R.QueryCounts, credibility: float):
    """(recall, precision) lower bounds, both in one betaincinv call."""
    both = B.beta_lower_bound(torch.stack([c.tp, c.tp]),
                              torch.stack([c.fn, c.fp]), credibility)
    return both[0], both[1]


def tau_decay(cfg: PlannerConfig) -> float:
    """The per-step factor of the exponential temperature schedule."""
    return (cfg.tau_end / cfg.tau_start) ** (1.0 / max(cfg.steps - 1, 1))


def snapshot_steps(cfg: PlannerConfig) -> List[int]:
    """Steps after which the parameters are kept as extraction
    candidates (conservative early, aggressive late)."""
    every = max(cfg.steps // max(cfg.snapshots, 1), 1)
    return [j * every - 1 for j in range(1, cfg.snapshots)
            if 0 <= j * every - 1 < cfg.steps - 1]


class AdamRun(NamedTuple):
    flat: torch.Tensor                  # (K, P) after the last step
    losses: torch.Tensor                # (steps, K)
    snaps: Dict[int, torch.Tensor]      # step -> (K, P) after that step
    replays: int = 0                    # CUDA graph replays (0: eager)
    capture_s: float = 0.0              # host s for warm-up and capture


def adam_step(loss_fn, state: Dict[str, torch.Tensor], cfg: PlannerConfig,
              consts) -> None:
    """One Adam step on static state tensors, updated in place: `flat`,
    `m`, `v` (K, P), `step` (a 0-dim float32 step index) and `loss` (K,).
    Step and tau are device tensors, so that the step can be captured
    once and replayed. loss_fn(flat (K, P), tau) -> (K,)."""
    decay, b1, b2 = consts
    with torch.profiler.record_function("optimizer.forward"):
        tau = cfg.tau_start * decay ** state["step"]
        x = state["flat"].detach().requires_grad_(True)
        loss = loss_fn(x, tau)
    with torch.profiler.record_function("optimizer.backward"):
        grad, = torch.autograd.grad(loss.sum(), x)
    with torch.profiler.record_function("optimizer.adam"), torch.no_grad():
        m = 0.9 * state["m"] + 0.1 * grad
        v = 0.999 * state["v"] + 0.001 * torch.square(grad)
        t = state["step"] + 1.0
        mhat = m / (1 - b1 ** t)
        vhat = v / (1 - b2 ** t)
        flat = state["flat"] - cfg.lr * mhat / (torch.sqrt(vhat) + 1e-8)
        state["m"].copy_(m)
        state["v"].copy_(v)
        state["flat"].copy_(flat)
        state["loss"].copy_(loss.detach())
        state["step"].copy_(t)


def adam_loop(loss_fn, flat0, cfg: PlannerConfig, snap_steps,
              graph: Optional[bool] = None) -> AdamRun:
    """cfg.steps Adam steps of `adam_step` on flat0's device; after each
    step the loss and, at snapshot steps, the parameters are copied into
    preallocated buffers, and nothing waits on the device here. With
    `graph` (default: on CUDA) the step is captured once as a CUDA graph
    (`ops.capture_graph`, kept for this call) and replayed; without it
    the step runs eagerly (the CPU's loop; on the card, bit for bit the
    graph's result)."""
    dev = flat0.device
    graph = dev.type == "cuda" if graph is None else graph
    consts = tuple(torch.tensor(c, dtype=_F32, device=dev)
                   for c in (tau_decay(cfg), 0.9, 0.999))
    state = {"flat": flat0.clone(), "m": torch.zeros_like(flat0),
             "v": torch.zeros_like(flat0),
             "step": torch.zeros((), dtype=_F32, device=dev),
             "loss": torch.zeros(flat0.shape[0], dtype=_F32, device=dev)}
    losses = torch.zeros((cfg.steps, flat0.shape[0]), dtype=_F32,
                         device=dev)
    snaps = {i: torch.empty_like(flat0) for i in snap_steps}

    def step():
        adam_step(loss_fn, state, cfg, consts)

    def reset():
        state["flat"].copy_(flat0)
        for key in ("m", "v", "step", "loss"):
            state[key].zero_()
    run, replays, capture_s = step, 0, 0.0
    if graph and cfg.steps > 0:
        if dev.type != "cuda":
            raise ValueError(f"a CUDA graph needs a CUDA device, not {dev}")
        t0 = time.perf_counter()
        run = ops.capture_graph(step, reset, dev)
        capture_s = time.perf_counter() - t0
        replays = cfg.steps
    for i in range(cfg.steps):
        run()
        losses[i].copy_(state["loss"])
        if i in snaps:
            snaps[i].copy_(state["flat"])
    return AdamRun(state["flat"], losses, snaps, replays, capture_s)


class Problem(NamedTuple):
    """One optimize_query problem, built on its device."""
    pipelines: List[R.PipelineData]
    sizes: List[int]
    counts_fn: Callable
    loss_fn: Callable
    flat0: torch.Tensor                 # (K, P) restart inits
    snap_steps: List[int]


def setup_problem(pipelines: Sequence[R.PipelineData], gold_membership,
                  target_recall: float, target_precision: float,
                  cfg: PlannerConfig,
                  batch_hint: Optional[R.BatchHint] = None,
                  groups: Optional[Sequence[R.TreeGroup]] = None,
                  device=None) -> Problem:
    """The loss, its counts and the restart inits of `optimize_query`,
    every tensor on the pipelines' device. `device`, where given, must be
    that device."""
    pipelines = list(pipelines)
    dev = pipelines[0].scores.device
    # an empty tensor resolves "cuda" to the current card
    if device is not None and torch.empty(0, device=device).device != dev \
            or any(p.scores.device != dev for p in pipelines):
        raise ValueError(
            f"the pipelines lie on {[str(p.scores.device) for p in pipelines]}"
            f", not {device if device is not None else dev}: place them "
            f"with runtime.plan_utils.pipelines_data(device=)")
    sizes = [p.scores.shape[0] for p in pipelines]
    g = torch.as_tensor(np.asarray(gold_membership), dtype=_F32).to(dev)

    max_cost = sum(
        float(p.costs.sum())
        + (float(p.fixed.sum()) if p.fixed is not None else 0.0)
        for p in pipelines) * g.shape[0]
    max_cost = max(max_cost, 1e-9)
    t_rec = min(target_recall + cfg.margin, 0.999)
    t_prec = min(target_precision + cfg.margin, 0.999)

    def counts_fn(params_list, tau, hard=False, pick_tau=None):
        if groups is not None:
            return R.tree_counts(pipelines, params_list, g, groups, tau,
                                 hard=hard, pick_tau=pick_tau)
        return R.query_counts(pipelines, params_list, g, tau, hard=hard,
                              pick_tau=pick_tau, batch_hint=batch_hint)

    def loss_fn(flat, tau):
        c = counts_fn(unflatten_params(flat, sizes), tau,
                      pick_tau=cfg.pick_tau)
        l_rec, l_prec = _bounds(c, cfg.credibility)
        l_cost = c.cost / max_cost                                 # Eq. 12
        pen = torch.relu(t_rec - l_rec) + torch.relu(t_prec - l_prec)
        return l_cost + cfg.beta * pen                             # (K,)

    # multi-start inits: a collapsed pick factor has a dead sigmoid
    # gradient, so Adam runs from several starts at once
    grid = [(2.0, 0.3), (2.0, 1.0), (0.5, 0.5), (3.0, 0.1), (0.5, 1.5),
            (4.0, 0.6)][:max(1, cfg.restarts)]
    flat0 = torch.stack([flatten_params(
        [init_pipeline_params(p, pick0, width) for p in pipelines])
        for pick0, width in grid])                              # (K, P)
    return Problem(pipelines, sizes, counts_fn, loss_fn, flat0,
                   snapshot_steps(cfg))


def optimize_query(pipelines: Sequence[R.PipelineData],
                   gold_membership: np.ndarray,
                   target_recall: float, target_precision: float,
                   cfg: Optional[PlannerConfig] = None,
                   batch_hint: Optional[R.BatchHint] = None,
                   groups: Optional[Sequence[R.TreeGroup]] = None,
                   device=None) -> OptimizedPlan:
    """batch_hint activates the batch-size-aware cost model for pipelines
    carrying fixed per-call costs (see relaxation.BatchHint).

    groups switches the simulation from the linear `query_counts` chain
    to the grouped `tree_counts` (join trees: side pipelines reset their
    reach, the pairing cascade's entry mass is the product of the side
    survivals, and per-group cost weights / hints price each pipeline
    against its own corpus), so the query-level error budget is
    allocated across every pipeline of the tree by the same joint
    gradient relaxation.

    The loop runs where the pipelines lie (`device`, if given, must be
    that device); on CUDA one Adam step is a CUDA graph. The returned
    parameters lie on the CPU."""
    cfg = cfg if cfg is not None else PlannerConfig()
    prob = setup_problem(pipelines, gold_membership, target_recall,
                         target_precision, cfg, batch_hint, groups, device)
    sizes = prob.sizes
    run = adam_loop(prob.loss_fn, prob.flat0, cfg, prob.snap_steps)
    flat = run.flat

    # --- discrete extraction: cheapest feasible candidate wins ---
    K = flat.shape[0]
    cands = [flat[k] for k in range(K)]
    # annealing-path snapshots per restart (conservative -> aggressive)
    for k in range(K):
        for step_i in prob.snap_steps:
            cands.append(run.snaps[step_i][k])
    # fallback: gold-only, identical to the reference by construction
    gold_only = []
    for n in sizes:
        pick = torch.full((n,), -10.0, device=flat.device)
        pick[-1] = 10.0
        gold_only.append(R.PipelineParams(pick, torch.zeros_like(pick),
                                          torch.zeros_like(pick)))
    cands.append(flatten_params(gold_only))
    cands = torch.stack(cands)
    with torch.no_grad():
        c = prob.counts_fn(unflatten_params(cands, sizes), 0.0, hard=True)
        l_rec, l_prec = _bounds(c, cfg.credibility)
    # the one copy to the host: every candidate with its counts and bounds
    n_c, P = cands.shape
    host = torch.cat([torch.stack([c.cost, l_rec, l_prec, c.tp, c.fp, c.fn])
                      .flatten(), cands.flatten(),
                      run.losses[:, 0].detach()]).cpu()
    cost_h, rec_h, prec_h, tp_h, fp_h, fn_h = host[:6 * n_c].view(6, n_c)
    cands = host[6 * n_c:6 * n_c + n_c * P].view(n_c, P)
    history = host[6 * n_c + n_c * P:]
    best = None
    for ci in range(n_c):
        cost = float(cost_h[ci])
        if float(rec_h[ci]) >= target_recall \
                and float(prec_h[ci]) >= target_precision:
            if best is None or cost < best[1]:
                best = (ci, cost)
    feasible = best is not None
    ci = best[0] if feasible else n_c - 1   # gold-only otherwise
    cand = unflatten_params(cands[ci], sizes)
    sel = [(torch.sigmoid(p.pick_logits) > 0.5).numpy() for p in cand]
    for s in sel:
        s[-1] = True  # gold always on
    return OptimizedPlan(
        params=cand, selected=sel, sample_tp=float(tp_h[ci]),
        sample_fp=float(fp_h[ci]), sample_fn=float(fn_h[ci]),
        recall_bound=float(rec_h[ci]), precision_bound=float(prec_h[ci]),
        est_cost=float(cost_h[ci]), feasible=feasible,
        loss_history=history.numpy())
