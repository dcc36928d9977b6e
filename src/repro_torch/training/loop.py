"""Fault-tolerant training loop with straggler mitigation.

The port of `repro.training.loop`:
  - resume-from-latest on start (the checkpoint restores on any device)
  - periodic atomic checkpoints
  - per-step watchdog: a step slower than `straggler_factor` x the EMA step
    time is recorded as a straggler event (on a fleet this would trigger
    re-dispatch to a hot spare; here the signal is counted)
  - transient-failure retry: a step that raises is retried from the last
    good state up to `max_retries` times (the step is functional, so that
    state is still whole)
  - optional failure injection for tests
A step's wall time ends with a sync on its loss's device, so on the card
it is the device's time for the step.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import torch

from repro_torch.training import checkpoint as CKPT


@dataclass
class LoopConfig:
    total_steps: int = 100
    ckpt_every: int = 20
    ckpt_dir: Optional[str] = None
    keep_last: int = 3
    straggler_factor: float = 3.0
    ema_decay: float = 0.9
    max_retries: int = 2


@dataclass
class LoopReport:
    steps_run: int = 0
    resumed_from: Optional[int] = None
    losses: List[float] = field(default_factory=list)
    straggler_events: int = 0
    retries: int = 0
    ckpts: List[str] = field(default_factory=list)
    step_seconds: List[float] = field(default_factory=list)


def _sync(loss: torch.Tensor) -> None:
    if loss.is_cuda:
        torch.cuda.synchronize(loss.device)


def run_training(step_fn: Callable, params, opt_state, batches,
                 cfg: LoopConfig,
                 failure_injector: Optional[Callable[[int], None]] = None
                 ) -> tuple:
    """batches: iterable of batch dicts (len >= total_steps).

    Returns (params, opt_state, LoopReport)."""
    report = LoopReport()
    start = 0
    if cfg.ckpt_dir:
        latest = CKPT.latest_step(cfg.ckpt_dir)
        if latest is not None:
            (params, opt_state), start = CKPT.restore_checkpoint(
                cfg.ckpt_dir, (params, opt_state))
            report.resumed_from = start

    ema = None
    it = iter(batches)
    # fast-forward the data stream on resume (deterministic pipelines)
    for _ in range(start):
        next(it)

    for step in range(start, cfg.total_steps):
        batch = next(it)
        for attempt in range(cfg.max_retries + 1):
            t0 = time.perf_counter()
            try:
                if failure_injector is not None:
                    failure_injector(step)
                new_params, new_opt, loss = step_fn(params, opt_state, batch)
                _sync(loss)
                break
            except Exception:
                report.retries += 1
                if attempt == cfg.max_retries:
                    raise
        dt = time.perf_counter() - t0
        if ema is not None and dt > cfg.straggler_factor * ema:
            report.straggler_events += 1
        ema = dt if ema is None else cfg.ema_decay * ema + (
            1 - cfg.ema_decay) * dt
        params, opt_state = new_params, new_opt
        report.losses.append(float(loss))
        report.step_seconds.append(dt)
        report.steps_run += 1
        if cfg.ckpt_dir and (step + 1) % cfg.ckpt_every == 0:
            report.ckpts.append(CKPT.save_checkpoint(
                cfg.ckpt_dir, step + 1, (params, opt_state),
                cfg.keep_last))
    return params, opt_state, report
