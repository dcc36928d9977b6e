"""The offline profile build's card work over long documents.

`ServingEngine.build_profiles` prefills a corpus chunk by chunk and
scores each chunk's cached keys once with Expected Attention: per chunk
the prompts padded to a multiple of 16 (`_pad_tokens`), `prefill` with
the items' lengths, then `score_chunk` (one launch of kernel C over every
layer and item), and one wait for the card. Compression and the store
are left out: they write every rung to disk.

Parameters (the workload file):

  n_docs, len_min, len_max
                 a pool of documents at the quantiles (i + 1/2) / n_docs of
                 the log-uniform law: the same lengths for every seed
  chunk          documents per prefill chunk
  pairing_seed   the fixed grouping of the pool into chunks and the order
                 they cycle in, the same for every seed: the seed draws the
                 tokens, so every seed's window does the same work
  pad_multiple   the prompt padding (`_pad_tokens`)
  stats_std      the spread of the query statistics kernel C scores with
  kernels        the port's kernel sources this path builds

The window runs whole cycles of the chunks, at least `seconds` long, so
every window does the same mix; the traced window (trace 1) is one more
cycle. One chunk drawn from the seed, from the window's last cycle, is
compared with the reference: every layer's cached K and V over each
item's live positions, the last-position logits and the keep-scores.
"""
from __future__ import annotations

import gc
import sys
import time

import numpy as np
import torch

from stretto_bench import compare, devtrace, inputs


def chunks(ctx):
    """[(document ids)] in the order the window cycles through them."""
    p = ctx.params
    pool = np.random.default_rng(p["pairing_seed"]).permutation(p["n_docs"])
    return [tuple(int(i) for i in pool[s:s + p["chunk"]])
            for s in range(0, len(pool), p["chunk"])]


def documents(ctx):
    """(lengths, token arrays) of the pool."""
    p = ctx.params
    lengths = inputs.log_uniform_grid(p["n_docs"], p["len_min"],
                                      p["len_max"])
    rng = inputs.host_rng(ctx.seed, "tokens")
    V = int(ctx.model["vocab_size"])
    return lengths, [rng.integers(0, V, size=n) for n in lengths]


def padded(token_lists, multiple):
    """The chunk's prompts right-padded with zeros (`_pad_tokens`)."""
    n = max(len(t) for t in token_lists)
    n = (n + multiple - 1) // multiple * multiple
    out = np.zeros((len(token_lists), n), np.int64)
    for i, t in enumerate(token_lists):
        out[i, :len(t)] = t
    return out


class Program:
    def __init__(self, ctx):
        from repro_torch.cache.compression import QueryStats
        from repro_torch.kernels import build
        from repro_torch.kernels import ops as KOPS
        self.ctx = ctx
        dev = ctx.device
        if dev.type == "cuda":
            build.build(ctx.params["kernels"])
        self.lengths, self.tokens = documents(ctx)
        self.order = chunks(ctx)
        _, self.params = inputs.weights(ctx.model, ctx.seed, dev)
        self.stats = QueryStats(*inputs.query_stats(
            ctx.model, ctx.seed, dev, ctx.params["stats_std"]))
        self.backend = KOPS.resolve_backend(None)
        self.nonfinite = torch.zeros((), dtype=torch.long, device=dev)

    def step(self, docs):
        """One chunk: (logits (B, V), cache, scores (L, B, S))."""
        from repro_torch.cache.compression import score_chunk
        from repro_torch.models import prefill
        ctx = self.ctx
        dev = ctx.device
        lens = [self.lengths[i] for i in docs]
        toks = torch.from_numpy(padded([self.tokens[i] for i in docs],
                                       ctx.params["pad_multiple"])).to(dev)
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        logits, cache = prefill(self.params, ctx.cfg, tokens=toks,
                                max_len=toks.shape[1], lengths=lengths,
                                kernels=self.backend)
        scores = score_chunk(ctx.cfg, cache, self.stats, lens,
                             kernels=self.backend)
        self.nonfinite += (~torch.isfinite(logits)).any(-1).sum()
        devtrace.sync(dev)
        return logits, cache, scores


def reference_outputs(ctx, docs, precision="f32"):
    """Per document of `docs`: (logits (V,), K, V (L, n, KV, dh), scores
    (L, n)), from inputs made again from the seed."""
    from stretto_bench.reference.model import Reference
    dev = ctx.device
    _, params = inputs.weights(ctx.model, ctx.seed, dev)
    mu, sig2 = inputs.query_stats(ctx.model, ctx.seed, dev,
                                  ctx.params["stats_std"])
    lengths, tokens = documents(ctx)
    ref = Reference(ctx.model, params, precision)
    out = []
    for i in docs:
        logits, K, V = ref.prefill(torch.as_tensor(tokens[i], device=dev))
        out.append((logits, K, V, ref.keep_scores(K, mu, sig2)))
    return out


def gaps(prog_out, docs, lengths, refs):
    """The prefill's numbers: logits_err, cache_err, score_err."""
    logits, cache, scores = prog_out
    vals = {"logits_err": 0.0, "cache_err": 0.0, "score_err": 0.0}
    for b, (i, r) in enumerate(zip(docs, refs)):
        n = lengths[i]
        r_logits, rK, rV, r_scores = r
        vals["logits_err"] = max(vals["logits_err"],
                                 compare.scaled_gap(logits[b], r_logits))
        for layer in range(rK.shape[0]):
            for name, rt in (("k", rK), ("v", rV)):
                vals["cache_err"] = max(vals["cache_err"], compare.row_gap(
                    cache[name][layer, b, :n], rt[layer]))
            vals["score_err"] = max(vals["score_err"], compare.scaled_gap(
                scores[layer, b, :n], r_scores[layer]))
    return vals


def run(ctx) -> dict:
    p = ctx.params
    dev = ctx.device
    prog = Program(ctx)
    for docs in prog.order:                 # every shape the window uses
        prog.step(docs)
    devtrace.sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    prog.nonfinite.zero_()
    done, tokens = [], 0
    sample = int(inputs.host_rng(ctx.seed, "sample").integers(
        len(prog.order)))
    devtrace.settle()
    t0 = time.perf_counter()
    setup_s = t0 - ctx.t0
    c = 0
    while time.perf_counter() - t0 < ctx.seconds:
        for k, docs in enumerate(prog.order):   # whole cycles: one mix
            out = prog.step(docs)
            if k == sample:
                kept = docs, out
            done.append([prog.lengths[i] for i in docs])
            tokens += sum(done[-1])
            c += 1
    window_s = time.perf_counter() - t0
    gc.unfreeze()
    print(f"window: {c} chunks, {tokens} live tokens in {window_s:.4f} s",
          file=sys.stderr)
    del out
    trace = None
    if ctx.trace:
        with devtrace.traced(dev) as trace:
            for d in prog.order:
                prog.step(d)
        traced_chunks = [[prog.lengths[i] for i in d] for d in prog.order]
        trace["chunks"] = traced_chunks
        trace["S"] = [inputs.round_up(max(ls), p["pad_multiple"])
                      for ls in traced_chunks]
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    failed = int(prog.nonfinite)
    lengths = prog.lengths
    del prog
    devtrace.free(dev)
    docs, out = kept
    refs = reference_outputs(ctx, docs)
    values = gaps(out, docs, lengths, refs)
    return {"setup_s": setup_s, "memory_peak_bytes": peak,
            "attempted": c * p["chunk"], "failed": failed,
            "window": {"seconds": window_s, "steps": c, "tokens": tokens,
                       "chunks": done},
            "trace": trace,
            "values": values,
            "checks": compare.judged(values, ctx.cell.workload["limits"])}


def control(ctx) -> dict:
    """The control's numbers: the reference in float8 put in the
    program's place on a chunk drawn from the seed, judged against the
    float32 reference."""
    order = chunks(ctx)
    docs = order[int(inputs.host_rng(ctx.seed, "control").integers(
        len(order)))]
    lengths, _ = documents(ctx)
    ref = reference_outputs(ctx, docs)
    devtrace.free(ctx.device)
    low = reference_outputs(ctx, docs, precision="fp8")
    def items(j):               # (L, n, ...) per item -> (L, B, n_max, ...)
        n = max(r[j].shape[1] for r in low)
        return torch.stack([torch.nn.functional.pad(
            r[j], (0, 0) * (r[j].dim() - 2) + (0, n - r[j].shape[1]))
            for r in low], 1)
    out = (torch.stack([r[0] for r in low]), {"k": items(1), "v": items(2)},
           items(3))
    return gaps(out, docs, lengths, ref)
