"""Gold-operator flushes over long documents whose caches sit on the card.

The online gold operator of a cascade: every call of `sem_filter` on the
gold rung feeds one query token per document through the decode path
over the documents' device-resident caches, and reads each document's
log-odds (yes - no) back to the host (`ServingEngine._run_tokens` and
`run_filter`). The engine has no public call for a flush over a cache
already on the card, so this driver calls the model layer as
`_run_tokens` does: `decode_multi` where the model has a fused decode
(GQA), else one `decode_step` per query token (MLA), with the dense
layers pinned at `rows` rows.

Closed loop, one flush at a time. Parameters (the workload file):

  batch          documents per flush (all of them, every flush)
  len_min/max    their lengths: the quantiles (i + 1/2) / batch of the
                 log-uniform law, the same set for every seed, in an
                 order drawn from the seed
  query_len      query tokens per item (headroom: query_len + 2 rows,
                 the cache padded to `pad_multiple`, as `_load_for` does)
  rows           the engine's row pin (`max_batch`)
  cache_std      per cache leaf, the spread of the cached rows (keys
                 spread enough that attention picks out a few rows)
  warm_flushes   flushes run before the window
  trace_flushes  flushes in the traced window (trace 1)
  sample_from, sample_flushes
                 the flushes compared with the reference: this many drawn
                 from the seed among the first `sample_from`, and the last
  kernels        the port's kernel sources this path builds

Each flush draws a filter task from the seed: a query token and a pair
of answer tokens (yes, no).
"""
from __future__ import annotations

import gc
import sys
import time

import numpy as np
import torch

from stretto_bench import compare, devtrace, inputs

MAX_FLUSHES = 1 << 17


def doc_lengths(ctx):
    p = ctx.params
    grid = inputs.log_uniform_grid(p["batch"], p["len_min"], p["len_max"])
    order = inputs.host_rng(ctx.seed, "order").permutation(len(grid))
    return [grid[i] for i in order]


def cache_len(ctx, lengths):
    p = ctx.params
    return inputs.round_up(max(lengths) + p["query_len"] + 2,
                           p["pad_multiple"])


def tasks(ctx):
    """(query tokens (n, query_len), yes (n,), no (n,)) per flush."""
    V = int(ctx.model["vocab_size"])
    rng = inputs.host_rng(ctx.seed, "tasks")
    q = rng.integers(0, V, size=(MAX_FLUSHES, ctx.params["query_len"]))
    yes = rng.integers(0, V, size=MAX_FLUSHES)
    no = (yes + 1 + rng.integers(0, V - 1, size=MAX_FLUSHES)) % V
    return q, yes, no


class Program:
    """The inputs on the device and one flush of the timed path."""

    def __init__(self, ctx):
        from repro_torch.kernels import build
        from repro_torch.kernels import ops as KOPS
        from repro_torch.models import supports_fused_decode
        self.ctx = ctx
        dev = ctx.device
        if ctx.params["query_len"] != 1:
            raise ValueError("the reference compares one-token flushes")
        if dev.type == "cuda":
            build.build(ctx.params["kernels"])     # nvcc, once per checkout
        self.lengths = doc_lengths(ctx)
        self.S = cache_len(ctx, self.lengths)
        _, self.params = inputs.weights(ctx.model, ctx.seed, dev)
        self.cache = inputs.cache(ctx.model, self.lengths, self.S, ctx.seed,
                                  dev, ctx.params["cache_std"])
        self.q, self.yes, self.no = tasks(ctx)
        self.fused = supports_fused_decode(ctx.cfg)
        self.backend = KOPS.resolve_backend(None)
        self.clock = devtrace.StepClock(dev)

    def flush(self, f: int):
        """Flush f: (logits on the device, log-odds on the host, host
        seconds to enqueue the decode, milliseconds until the log-odds
        were on the host)."""
        from repro_torch.models import decode_multi, decode_step
        ctx, B = self.ctx, len(self.lengths)
        rows = ctx.params["rows"]
        self.clock.start()
        t0 = time.perf_counter()
        q = torch.tensor([list(self.q[f])] * B, dtype=torch.long,
                         device=ctx.device)
        if self.fused:
            logits = decode_multi(self.params, ctx.cfg, self.cache,
                                  tokens=q, kernels=self.backend,
                                  rows=rows)[0]
        else:
            cache = self.cache
            for t in range(q.shape[1]):
                logits, cache = decode_step(self.params, ctx.cfg, cache,
                                            tokens=q[:, t:t + 1],
                                            kernels=self.backend, rows=rows)
        host_s = time.perf_counter() - t0
        lo = (logits[:, int(self.yes[f])] - logits[:, int(self.no[f])]) \
            .float().cpu().numpy()
        return logits, lo, host_s, self.clock.stop_ms()


def reference_logits(ctx, lengths, S, tokens, precision="f32"):
    """The reference's logits (F, B, V) on the host for the query tokens
    `tokens` (F, B) (one token per item), on inputs made again from the
    seed."""
    from stretto_bench.reference.model import Reference
    dev = ctx.device
    _, params = inputs.weights(ctx.model, ctx.seed, dev)
    cache = inputs.cache(ctx.model, lengths, S, ctx.seed, dev,
                         ctx.params["cache_std"])
    ref = Reference(ctx.model, params, precision)
    out = ref.decode(cache, lengths, torch.as_tensor(tokens, device=dev))
    return out.float().cpu()


def run(ctx) -> dict:
    p = ctx.params
    dev = ctx.device
    prog = Program(ctx)
    for f in range(p["warm_flushes"]):
        prog.flush(MAX_FLUSHES - 1 - f)
    devtrace.sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    rng = inputs.host_rng(ctx.seed, "sample")
    sample = set(rng.choice(p["sample_from"], size=p["sample_flushes"],
                            replace=False).tolist())
    kept, lat, host, answers = {}, [], [], []
    devtrace.settle()
    t0 = time.perf_counter()
    setup_s = t0 - ctx.t0
    f, t_end, between = 0, t0, 0.0
    while True:
        between = max(between, time.perf_counter() - t_end)
        logits, lo, hs, ms = prog.flush(f)
        t_end = time.perf_counter()
        answers.append(lo)
        host.append(hs)
        lat.append(ms)
        if f in sample:
            kept[f] = logits
        f += 1
        if t_end - t0 >= ctx.seconds:
            break
    window_s = time.perf_counter() - t0
    gc.unfreeze()
    print(f"window: {f} flushes in {window_s:.4f} s, latency max "
          f"{max(lat):.3f} ms, longest pause between flushes "
          f"{between * 1e3:.3f} ms", file=sys.stderr)
    kept[f - 1] = logits
    n = f
    trace = None
    if ctx.trace:
        with devtrace.traced(dev) as trace:
            for g in range(n, n + p["trace_flushes"]):
                prog.flush(g)
        trace["steps"] = p["trace_flushes"]
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    B = len(prog.lengths)
    answers = np.stack(answers)                              # (n, B)
    failed = int((~np.isfinite(answers)).sum())
    order = sorted(kept)
    prog_logits = torch.stack([kept[g].float().cpu() for g in order])
    lengths, S = prog.lengths, prog.S
    tokens = prog.q[order][:, 0][:, None].repeat(B, axis=1)  # (F, B)
    yes, no = prog.yes[order], prog.no[order]
    del prog, kept, logits
    devtrace.free(dev)
    ref = reference_logits(ctx, lengths, S, tokens)
    values = compare.logit_gaps(prog_logits, ref, torch.as_tensor(yes),
                                torch.as_tensor(no),
                                torch.as_tensor(answers[order]))
    return {"setup_s": setup_s, "memory_peak_bytes": peak,
            "attempted": n * B, "failed": failed,
            "window": {"seconds": window_s, "steps": n, "items": n * B,
                       "latency_ms": lat, "host_s": host,
                       "lengths": lengths, "S": S},
            "trace": trace,
            "values": values,
            "checks": compare.judged(values, ctx.cell.workload["limits"])}


def control(ctx) -> dict:
    """The control's numbers: the reference in float8 put in the
    program's place, on flushes drawn as a run draws them, judged
    against the float32 reference."""
    p = ctx.params
    lengths = doc_lengths(ctx)
    S = cache_len(ctx, lengths)
    q, yes, no = tasks(ctx)
    rng = inputs.host_rng(ctx.seed, "sample")
    order = sorted(rng.choice(p["sample_from"], size=p["sample_flushes"],
                              replace=False).tolist()) + [p["sample_from"]]
    tokens = q[order][:, 0][:, None].repeat(len(lengths), axis=1)
    yes, no = torch.as_tensor(yes[order]), torch.as_tensor(no[order])
    ref = reference_logits(ctx, lengths, S, tokens)
    devtrace.free(ctx.device)
    low = reference_logits(ctx, lengths, S, tokens, precision="fp8")
    f = torch.arange(len(order))
    return compare.logit_gaps(low, ref, yes, no,
                              low[f, :, yes] - low[f, :, no])
