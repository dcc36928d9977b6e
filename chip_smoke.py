#!/usr/bin/env python3
"""Drive the PyTorch port of Stretto on one NVIDIA card, end to end.

    python3 chip_smoke.py          # from the root of a checkout

Phases, one JSON line each:
  device   the card (and the `nvidia-smi` name / power-limit line)
  build    nvcc builds every kernel of src/repro_torch/csrc/, in parallel
  kernel   each hand-written CUDA kernel against its plain PyTorch version
           on the card, at the planted and the stretto-llama-8b shapes:
           max abs error within the stated tolerance, and its time beside
           the plain version's, the bound and (bf16/f32 attention) one SDPA
           call, under a write and a read L2 flush; the decode kernels in
           float32/bfloat16 and over int8 K/V, also against their CPU
           twin's algorithm (kernel_edges: rows that see no cache position,
           lengths at split boundaries, calls in a row on the same arrival
           counters, and an item's output alone vs in a larger,
           further-padded batch); the prefill
           kernel (D) also against the blocked `flash_attention`, causal
           and not, windowed and not, dk != dv, and batch invariance, in
           both bodies (tensor cores for bf16 at head dims that are
           multiples of 16, FMAs otherwise); its 8B rows also against the
           tensor-core body's CPU twin, timed beside it and the FMA body;
           the FMA body's rows against its own twin; the Expected-Attention
           kernel (C) at the prefill chunks' shapes (every layer and item
           in one launch) and at the MLA latent rows' (dk 576, 288),
           against its plain version and its twin; B, C and D also at
           hymba-1.5b's Session shapes (KV 5, G 5, d 64, window 1024 and
           global), the kernels line's "hymba" entries
  planted  the planted sm/lg world (200 items) under a hand-written
           cascade plan through KVCacheBackend + run_plan; inline vs
           threads:2 bit-identical; the same plan on the CPU equal outside
           a margin; the scan path (fused=False) agreeing
  llama8b  stretto-llama-8b at full width (32 layers, d_model 4096,
           bfloat16, random weights from a seed), 16 items of 1024 tokens,
           a hand-written filter + map plan, one scan-path flush, and one
           flush's logits kernel vs plain
  session_planted  the main path: the quickstart query (sem_filter task 1,
           sem_map task 2, recall and precision 0.75) through a
           repro_torch.Session on the card with int8 rungs declared
           (sm_int8 0.5, lg_int8 0.3): profiles, EXPLAIN (profiling + the
           gradient planner, whose Adam steps run on the card as one CUDA
           graph each, the bounds through kernel E), execute, metrics
           against gold; the same plan on the CPU equal outside a margin;
           scan-path flushes (kernel B, B-int8)
  baselines_planted  the four comparison planners (core/baselines.py)
           over the same corpus, planned on the card and executed through
           the Session; each plan's CPU run equal outside the margin
  session_llama8b  the same query through Session(cfg, engine=eng) with
           stretto-llama-8b registered as "lg" (rungs 0.8 / 0.5 / int8 0.5
           / gold), 32 items of 512 tokens, scan-path flushes, and one
           int8 flush's logits kernel vs plain
  baselines_llama8b  plan_query and the four comparison planners over the
           8B Session's corpus and store (the paper's Exp 1 comparison at
           8B width, no claim): plan / execute seconds, items/s, recall and
           precision against gold, stages, A's launches
  session_join_planted  the join path: a sem_filter on each side of
           make_join_corpora (120 + 120 items) and sem_join "same v3"
           blocked on `category` (SemFrame.sem_join -> Session.plan_tree ->
           run_tree): EXPLAIN, execute, metrics against gold_tree; then a
           hand-set TreePlan with compressed stages (lg-kv50 on the right
           side, lg-pair50 ahead of the gold pair scorer) through
           Session.run_tree; each plan on the CPU over the card's stored
           profiles gives the same decisions, item by item and pair by
           pair, up to scores within a margin of a threshold
  session_join_llama8b  the same tree through Session(cfg, engine=eng)
           with stretto-llama-8b as "lg" (ladder 0.5 + gold), 24 + 24
           items of 512 tokens
  planner  over each Session's own optimizer call (planted, 8B): the
           CUDA-graph loop against an eager loop on the card (bit for bit)
           and the CPU's eager loop (the same stages but at picks within
           5e-3 of 0.5), optimize_s of each, ms per graph replay, the
           step's device time by part (torch.profiler: forward, bounds,
           backward, Adam), and kernel E (csrc/beta_bounds.cu) against its
           plain version on the card and the CPU and its twin, over the
           Session's real (a, b, q) and a wide grid, timed at a step's
           and the extraction's shapes beside its latency bound
  pool_planted  the reference's two-tier pool (tests/test_pool.py): a
           "fast" engine serving the planted sm (kv80, kv50) and an
           "accurate" one serving lg (kv50 and the gold), 90 items, the
           quickstart query through a multi-engine Session: EXPLAIN with
           the engine column, the stages' placement, per-engine totals
           that partition the run with each engine's kv_bytes equal to
           its own store's counter; inline, threads:2 and the affinity
           dispatcher (EngineSpec(dispatcher=2)) bit-identical; the same
           plan on the CPU equal outside the margin
  scheduler_planted  QueryScheduler(max_concurrent=3, paused) over that
           pool: three copies of the quickstart query, each bit-equal to
           its solo run with its solo run's integer StageStats, the
           queries' kv_bytes tiling the stores' loads, flushes merged
           (n_calls < n_flushes), the EXPLAIN ANALYZE "scheduler:" footer;
           and the oracle world's parity (tests/test_scheduler.py) under
           inline and threads:2
  pool_llama8b  two ServingEngines on the card, "compressed" (lg 0.5,
           int8 0.5) and "gold" (lg 0.8, gold), each with its own store and
           memory budget, both serving stretto-llama-8b from the same
           params tensors, joined as Session(backend=PoolBackend(...),
           reference=ReferenceBackend(gold engine)); the quickstart query
           over the 8B Session's corpus (32 x 512 tokens): build s per
           engine, plan / execute s, placement, per-engine totals against
           the stores; fails if the weights are held twice
  scheduler_llama8b  the scheduler over that pool: three copies of the
           quickstart query and a sem_filter on task 2 that plans (and
           captures its optimizer's CUDA graph) while the copies flush;
           each query bit-equal to its solo run, merged flushes, A's
           launches against the solo runs' sum, E 203 / 202 for the plan
  flush_invariance  per rung (planted float32 sm / lg, 8B bf16 at 0.5,
           int8 0.5 and the gold), whether an item's flush outputs are
           bit-equal alone and in flushes of 2, 4, ... up to the
           profile's batch, with the engine's pinned dense-layer row
           count and without it (fails unless every pinned size is
           equal); and the pin's cost on a warm 8B flush
  remote_planted  the reference's remote world (tests/test_remote.py):
           an in-process repro_torch.remote.RemoteWorker serving the
           planted "fast" tier (sm kv80, kv50) on 127.0.0.1, in a Session
           whose "accurate" engine is local (EngineSpec(address=)); held
           to pool_planted's all-local Session: the catalog, every fast
           operator's scores, and a hand-set plan (first stages on
           "fast", gold on "accurate") bit-equal under inline, threads:2
           and three scheduled copies (fewer wire calls than three solo
           runs); wire calls > 0, no fallback; the EXPLAIN ANALYZE
           "remote:" footer; the Session planning the quickstart query
           over the wire; the plan on the CPU equal outside the margin
  remote_worker_cli  `python -m repro_torch.launch.remote_worker` as a
           subprocess on the card (its DEVICE line must name CUDA): the
           hand-set plan bit-equal to remote_planted's, then a SIGKILL
           mid-run: "fallback" ends on the gold engine with fallbacks > 0,
           "fail" raises RemoteEngineError and gold still runs. Its
           launches are the worker's own (reported by its `stats` verb)
           and are left off the kernels line
  remote_llama8b  pool_llama8b's pool with its "compressed" tier served
           by an in-process worker that registers stretto-llama-8b from
           the same params tensors; "gold" local. A hand-set plan (int8
           0.5, then bf16 0.5, then gold; thresholds at quantiles of each
           stage's scores) bit-equal to the all-local pool, inline and
           threads:2, three scheduled copies, per-engine kv_bytes against
           each store; the worker's build steps, wire calls, bytes and RTT,
           each flush's client wall against the worker's server_wall_s,
           plan / execute s, peak memory (fails if the weights are held
           twice)
  serve_planted  repro_torch.launch.serve.main in-process on the card
           (200 items, 48 requests, concurrency 48: only queries on one
           task merge their flushes): flushes merged (saved_calls > 0)
           and every tenant's line printed
  sharded_planted  the planted Session's plan, and a SemTopK query (k 10)
           the Session plans, under sharded:2, sharded:3, mesh and mesh:2
           (the partition scatter; every shard of the mesh on the one
           card), each run from a cold device LRU: decisions, map values,
           top-k picks and integer StageStats bit-equal to inline; wall_s
           beside runtime_s
  sharded_llama8b  the 8B Session's plan under sharded:2 and mesh:2 the
           same way; the weights' data_ptrs unchanged and never copied,
           each scatter's peak memory within 1 GB of inline's
  pool_release  a planted two-engine pool Session built, run, closed and
           deleted with the cyclic collector off, under inline, the
           scheduler and sharded:2: no ServingEngine left alive
  session_deepseek  deepseek-v2-lite-16b at full width and depth (27
           layers, MLA r 512 + rope 64, 64 routed experts top-6 + 2
           shared, vocab 102400, bfloat16, random weights from a seed)
           through a Session over 32 x 512-token items, rungs 0.8 / 0.5 /
           gold: build by step, plan (profiling, optimizer), execute, peak
           memory; C scores the latent rows (KV 1, G 16, dk 576), one
           launch per prefill chunk; MLA decodes token by token in plain
           torch (no kernel, as in the JAX package). Then the same world
           cut to 12 layers in float32, planned and run on the card, and
           its plan and a hand cascade run again by the port on the CPU
           over the card's store: decisions equal outside the margin,
           integer StageStats
  session_hymba  hymba-1.5b at full width and depth (32 layers, d_model
           1600, 25 q / 5 KV heads of 64, window 1024, global layers 0 /
           15 / 31, Mamba heads d_state 16; bfloat16, random weights)
           through a Session over 16 x 1536-token items, rungs 0.8 / 0.5 /
           int8 0.5 / gold: build by step, the Mamba scan's ms per step,
           plan, execute, peak memory, launches of B, C and D; every rung
           bit-equal at flushes of 2 up to 16 (flush_invariance); a 4-layer
           float32 cut on the card and on the CPU as session_deepseek's
  session_rwkv6  rwkv6-1.6b at full width and depth (24 layers, d_model
           2048, bfloat16): the rung-less build over 16 x 512-token items,
           a Session over gold (its ratio-0 profile), no attention kernel,
           its rung bit-equal across flush sizes; a 4-layer float32 cut's
           prefill and decode logits on the card against the CPU
  zoo_legs  granite-8b, minitron-8b, gemma3-27b (6 layers: a global one
           beside the 1024 windows), llava-next-34b and musicgen-medium
           (frontend embeddings), dbrx-132b (MoE) at full width, 2
           layers, random weights: a prefill of items of 1536 and 1200
           tokens (D, tensor-core body, in every layer) and a fused
           decode flush of 2 query tokens (A) held to the plain route
           within 5 % of the largest magnitude, C over the chunk held to
           its plain version; hymba-1.5b (its global layer 0 and a windowed
           one: D, and B at each of two decode steps, G 5, window 1024);
           minicpm3-4b (2 layers): C at its latent shape (KV 1, G 40, dk
           288)
  train_parity  granite-8b at full width, 2 layers, float32: one step's
           loss and grads on the card (B 1, S 256) against the port's CPU
           step from the same weights and batch (loss 1e-5 relative, each
           grad leaf 1e-3 of its max), and adamw_update fed the CPU's
           grads on both (1e-6 of each leaf's max)
  train_granite  granite-8b at full width (d_model 4096, 32 / 8 heads of
           128, d_ff 14336, vocab 49152, bf16), 8 of 36 layers: the bytes
           reckoned from launch/specs.py's meta tensors first (B cut
           until they fit), a finite non-zero grad on every param leaf on
           step 1's batch, then 10 AdamW steps of B 8 x S 1024 Zipfian
           tokens (data/pipeline.lm_batches) through run_training(
           make_train_step(...)): losses finite and falling, step ms
           (median after 2 warm-up steps), tokens/s, MFU (6 N T + the
           causal attention's flops over 989 TFLOP/s), peak memory against
           the reckoned bytes, the step's device time by part
           (torch.profiler: attention, dense products, optimizer, other),
           remat off / none / dots at B 2, and the blocked attention's
           forward + backward against SDPA's at one layer's shapes
  train_zoo  every registered arch's reduced() config, float32: one
           step's loss and grads on the card against the CPU's (1e-5,
           1e-4 of each leaf's max): hymba's scan, the WKV, MLA, MoE and
           the frontends backward on CUDA
  train_loop  launch/train.main on the card (reduced granite, 4 steps),
           then run_training with a failure injected at step 7 and a
           resume from a checkpoint at step 8
  dryrun_granite  the launch tooling, after every other phase: the host
           cost of the wrappers' shape-only check; then `python -m
           repro_torch.launch.dryrun --arch granite-8b --shape S` for
           train_4k, prefill_32k and decode_32k at full width (36 layers),
           started in the background (no card visible to them), each ok
           on 256 devices priced at h100-sxm (reckoned figures: roofline,
           per-device bytes, trace_s); meanwhile each cell from the dry
           run's own build_cell cut to 2 of 36 layers (prefill B 1 of 32,
           decode B 128 over a cache of random bf16 K / V full to 32768,
           train B 2 of 256 with AdamW), traced on fake tensors by the op
           counter and run on the card: the trace's kernel calls equal the
           launches, its aten flops FlopCounterMode's within 1e-6, the
           median step (CUDA events, 5 after a warm-up) is at least the
           counter's roofline bound, and the counter's temp over the
           step's measured transient (max_memory_allocated less
           memory_allocated before the step) and the reckoned peak
           (arguments + temp) over the measured one lie in 0.995-1.005;
           kernel D at S 32768 (its last 256 query rows) and B at B 128 x
           S 32768 (8 items) held to their plain versions within 2e-2 x
           max |want|, a planted fault (D's key tile, B's split left out)
           failing each hold, and timed beside SDPA
The train phases launch none of A-E (a kernel reached under autograd
raises: the kernels have no backward); each fails if a count moved.
Every profile build (prefill and calibration) runs the prefill kernel D
in every layer, so D is launched on every Session path: its tensor-core
body on the 8B paths (bfloat16, d 128) and its FMA body on the planted
ones (float32); any other body on a path fails the run. Each build scores
every prefill chunk with one launch of C: a path whose C launches differ
from the chunks its engine prefilled fails.
Then the kernels line, the nvidia-smi line and, last, the result line.

Launch counts: every count is set to 0 just before a path is driven and
read just after. The kernels line carries, per kernel, the sum of its
counts over the Session paths (the quickstart query and the join, planted
and 8B, with the scan legs and the hand-set join tree, the pools and the
scheduler runs over them, the in-process remote paths with their workers'
launches, the serving launcher, and dryrun_granite's cut cells), and
each path's count; D appears once per body (prefill_attention_tc, _fma), with that
body's counts; E once per entry (beta_incinv, beta_incinv_grad_terms),
counting each launch a CUDA-graph replay makes, and its bound_ms is one
FMA latency (4 cycles at 1.98 GHz) per continued-fraction term of its
longest thread. Its bound_ms is the larger of the bytes over 3.35 TB/s and the
flops over the peak rate for the operands' type (989 TFLOP/s on the bf16
tensor cores, 67 TFLOP/s for float32). Any failed phase exits non-zero. Without CUDA, or without the
repository around it, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import gc
import json
import math
import os
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "src")
WORK = os.path.join(HERE, "build", "chip_smoke")
if os.path.isdir(os.path.join(SRC, "repro_torch")):   # else main() stops
    sys.path.insert(0, SRC)
    # the H100 SXM peaks (launch/mesh.H100_SXM) and each kernel's bound
    from repro_torch.kernels.cost import (  # noqa: E402
        PEAK_BF16_TC_FLOPS, bound, decode_bound, decode_visible,
        expected_attention_work, prefill_bound)

GLOBAL = 1 << 30
DEV = "cuda"                  # the card (the CPU only to rehearse a phase)


def emit(phase: str, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def die(phase: str, err: str):
    emit(phase, ok=False, error=err)
    sys.exit(1)


# --------------------------------------------------------------------------
# timing and bounds
# --------------------------------------------------------------------------

def time_ms(torch, fn, flush, iters=20, warmup=3, mode="write") -> float:
    """Median device time of fn() over `iters` launches, CUDA events, with
    the 50 MB L2 cache flushed before each one. The flush (1 GB, about 0.3
    ms) also gives the host time to enqueue the call before the card
    reaches the start event, so host overhead stays out of the time.
    mode "write" flushes with a memset, which leaves L2 full of dirty
    lines that the timed call's own reads must write back; "read" flushes
    with a sum over the buffer, which leaves clean lines. Kernel rows are
    timed both ways (`*_ms` and `*_ms_read`)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    evs = []
    for _ in range(iters):
        if mode == "write":
            flush.zero_()
        else:
            flush.sum()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        evs.append((s, e))
    torch.cuda.synchronize()
    t = sorted(s.elapsed_time(e) for s, e in evs)
    return t[len(t) // 2]


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------

def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    line = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    emit("device", ok=True, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=line,
         torch=torch.__version__, cuda=torch.version.cuda)
    return line


def phase_build():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    secs = build.build()
    emit("build", ok=True, seconds=time.perf_counter() - t0,
         per_source=secs, dir=str(build.build_dir()))


def _decode_inputs(torch, gen, B, Lq, KV, G, dk, S, dtype, min_len):
    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)
    q = rnd(B, Lq, KV, G, dk)
    k, v = rnd(B, S, KV, dk), rnd(B, S, KV, dk)
    lengths = torch.randint(min_len, S - 2, (B,), generator=gen,
                            device="cuda", dtype=torch.int32)
    lengths[0] = S - 3                      # the longest item, as padded
    return q, k, v, lengths


def _quantize(torch, x):
    """int8 rows and (B, S, KV) absmax scales, as the int8 rungs hold them."""
    s = x.float().abs().amax(-1) / 127.0
    return torch.round(x.float() / s.clamp(min=1e-9)[..., None]) \
        .to(torch.int8), s


DECODE = ("decode_query_attention", "decode_query_attention_int8",
          "decode_attention", "decode_attention_int8")


def _decode_call(name, q, k, v, scales):
    """(kernel, plain) closures of one decode kernel on these inputs; q is
    (B, Lq, ...) and the single-token kernels take its first token."""
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import ref
    kern, plain = getattr(DA, name), getattr(ref, name + "_ref")
    qq = q if name.startswith("decode_query") else q[:, 0]
    args = (qq, k, v) + (scales if name.endswith("int8") else ())

    def run(fn):
        return lambda lengths, window=GLOBAL: fn(*args, lengths,
                                                 window=window)
    return qq, run(kern), run(plain)


def _decode_twin(name, q, k, v, lengths, window, scales=()):
    """The CPU twin of the decode body, run on the card (A's for the query
    kernel, B's for the single-token one; over int8 K/V with `scales`)."""
    from repro_torch.kernels import ref
    twin = (ref.decode_query_attention_twin if name.startswith("decode_query")
            else ref.decode_attention_twin)
    ks, vs = scales if scales else (None, None)
    return twin(q, k, v, lengths, window=window, k_scale=ks, v_scale=vs)


def phase_kernels(torch, flush):
    """Each kernel against its plain version at the path's shapes."""
    import torch.nn.functional as F
    from repro_torch.kernels import expected_attention as EA
    from repro_torch.kernels import ref
    gen = torch.Generator(device="cuda").manual_seed(1234)
    f32, bf16 = torch.float32, torch.bfloat16
    tol = {f32: 2e-5, bf16: 2e-2}
    rows = {name: [] for name in DECODE + ("expected_attention_scores",)}
    # (label, B, KV, G, dk, S, dtype, window, main-path shape?); the hymba
    # rows are the hymba Session's flush: 16 items of 1536 tokens and the
    # query token (lengths 1537) in a cache padded to 1664, KV 5, G 5
    cases = [("planted-sm", 16, 2, 1, 16, 256, f32, GLOBAL, False),
             ("planted-lg", 16, 4, 1, 24, 256, f32, GLOBAL, False),
             ("planted-lg-window", 16, 4, 1, 24, 256, f32, 8, False),
             ("llama8b-S256", 14, 8, 4, 128, 256, bf16, GLOBAL, False),
             ("llama8b-S640", 14, 8, 4, 128, 640, bf16, GLOBAL, False),
             ("llama8b-S1152", 14, 8, 4, 128, 1152, bf16, GLOBAL, True),
             ("hymba-S1664-w1024", 16, 5, 5, 64, 1664, bf16, 1024, False),
             ("hymba-S1664-global", 16, 5, 5, 64, 1664, bf16, GLOBAL,
              False)]
    for label, B, KV, G, dk, S, dt, window, main in cases:
        hymba = label.startswith("hymba")
        for Lq in (1, 3):
            q, k, v, lengths = _decode_inputs(torch, gen, B, Lq, KV, G, dk,
                                              S, dt, Lq)
            if hymba:
                lengths.fill_(HYMBA_LEN + Lq)
            k8, ks = _quantize(torch, k)
            v8, vs = _quantize(torch, v)
            for name in DECODE:
                if name.startswith("decode_attention") and Lq != 1:
                    continue
                quant = name.endswith("int8")
                kk, vv = (k8, v8) if quant else (k, v)
                qq, kern, plain = _decode_call(name, q, kk, vv, (ks, vs))
                got = kern(lengths, window)
                want = plain(lengths, window)
                torch.cuda.synchronize()
                err = float((got.float() - want.float()).abs().max())
                row = dict(kernel=name, shape=label, B=B, Lq=Lq, KV=KV, G=G,
                           dk=dk, S=S, dtype=str(dt)[6:], window=window,
                           kv_dtype="int8" if quant else str(dt)[6:],
                           max_abs_err=err, tol=tol[dt])
                twin = _decode_twin(name, qq, kk, vv, lengths, window,
                                    (ks, vs) if quant else ())
                row["max_abs_err_vs_twin"] = float(
                    (got.float() - twin.float()).abs().max())
                errs = [err, row["max_abs_err_vs_twin"]]
                row["ok"] = bool(max(errs) <= tol[dt]
                                 and all(math.isfinite(e) for e in errs))
                if Lq == 1 and not label.endswith("window"):
                    row["kernel_ms"] = time_ms(
                        torch, lambda: kern(lengths, window), flush)
                    row["kernel_ms_read"] = time_ms(
                        torch, lambda: kern(lengths, window), flush,
                        mode="read")
                    row["plain_ms"] = time_ms(
                        torch, lambda: plain(lengths, window), flush,
                        iters=5)
                    row["visible_rows"] = decode_visible(
                        lengths.tolist(), S, 1, window)
                    row["bound_ms"], row["bound_by"] = decode_bound(
                        qq, kk, vv, lengths.tolist(), window,
                        8 if quant else 0)
                    row["library_ms"] = row["library_ms_read"] = None
                    if not quant:
                        # yardstick: one SDPA call on head-expanded K/V
                        # (no single PyTorch call dequantises int8)
                        H = KV * G
                        qs = q.reshape(B, Lq, H, dk).transpose(1, 2)
                        ke = k.repeat_interleave(G, dim=2).transpose(1, 2)
                        ve = v.repeat_interleave(G, dim=2).transpose(1, 2)
                        pos = torch.arange(S, device="cuda")
                        qpos = (lengths[:, None] - Lq
                                + torch.arange(Lq, device="cuda")[None, :])
                        mask = ((pos[None, None, :] <= qpos[:, :, None])
                                & ((qpos[:, :, None] - pos[None, None, :])
                                   < window))[:, None]
                        def sdpa():
                            return F.scaled_dot_product_attention(
                                qs, ke, ve, attn_mask=mask)
                        row["library_ms"] = time_ms(torch, sdpa, flush)
                        row["library_ms_read"] = time_ms(torch, sdpa, flush,
                                                         mode="read")
                    row["main_path_shape"] = main
                    row["hymba_path_shape"] = (
                        label == "hymba-S1664-w1024"
                        and name == "decode_attention")
                rows[name].append(row)
                emit("kernel", **row)
                if not row["ok"]:
                    die("kernel", f"{name} at {label} Lq={Lq}: errors {errs}"
                                  f" vs the plain version and the twin")
    _decode_edge_cases(torch, gen, tol)
    rows["prefill_attention"] = _prefill_cases(torch, gen, tol, flush)
    rows["expected_attention_scores"] = _ea_cases(torch, gen, flush)
    return rows


def _ea_cases(torch, gen, flush):
    """Kernel C at the prefill chunks' shapes, every layer and item in one
    launch, stats in the model's dtype: the 8B Session chunk (L 32, B 4, S
    512, the main path) and the hand plan's (S 1024), the same at B 16, one
    item alone, the planted chunks (dk 16: lanes of 16-byte vectors; dk
    24: the row kernel), one layer without the layer axis (the shape
    of the kernel's earlier per-layer calls), and the MLA latent chunks
    (KV 1, dk 576 deepseek / 288 minicpm3: the row kernel), and the hymba
    Session's chunk (L 32, B 16, S 1536, KV 5, G 5, dk 64). Against the plain version
    and C's CPU twin at 2e-5 x max(1, |score|); timed beside the plain
    version under a write and a read L2 flush."""
    from repro_torch.kernels import expected_attention as EA
    from repro_torch.kernels import ref
    f32, bf16 = torch.float32, torch.bfloat16
    # (label, L or None (no layer axis), B, S, KV, G, dk, dtype, main path)
    cases = [("llama8b-session-chunk", 32, 4, 512, 8, 4, 128, bf16, True),
             ("llama8b-hand-chunk", 32, 4, 1024, 8, 4, 128, bf16, False),
             ("llama8b-L32-B16-S512", 32, 16, 512, 8, 4, 128, bf16, False),
             ("llama8b-L32-B16-S1024", 32, 16, 1024, 8, 4, 128, bf16, False),
             ("llama8b-item-S1024", 32, 1, 1024, 8, 4, 128, bf16, False),
             ("llama8b-one-layer", None, 1, 1024, 8, 4, 128, bf16, False),
             ("planted-sm-chunk", 2, 16, 160, 2, 1, 16, f32, False),
             ("planted-lg-chunk", 2, 16, 160, 4, 1, 24, f32, False),
             # MLA latent rows [c_kv ; k_rope] as one KV head: the
             # deepseek Session's chunk and minicpm3's at full depth
             ("deepseek-latent-chunk", 27, 4, 512, 1, 16, 576, bf16, False),
             ("minicpm3-latent-chunk", 62, 4, 512, 1, 40, 288, bf16, False),
             # the hymba Session's one prefill chunk (KV 5, G 5, dk 64)
             ("hymba-session-chunk", 32, 16, 1536, 5, 5, 64, bf16, False)]
    out = []
    for label, L, B, S, KV, G, dk, dt, main in cases:
        lead = (L,) if L else ()
        k = torch.randn(lead + (B, S, KV, dk), generator=gen,
                        device="cuda").to(dt)
        mu = torch.randn(lead + (KV, G, dk), generator=gen,
                         device="cuda").to(dt)
        sig2 = torch.rand(lead + (KV, G, dk), generator=gen,
                          device="cuda").to(dt)

        def kern():
            return EA.expected_attention_scores(k, mu, sig2)

        def plain():
            return ref.expected_attention_scores_ref(k, mu, sig2)
        before = EA.expected_attention_scores.launches
        got = kern()
        launches = EA.expected_attention_scores.launches - before
        want = plain()
        twin = ref.expected_attention_scores_twin(k, mu, sig2)
        torch.cuda.synchronize()
        mag = want.abs().clamp(min=1.0)
        rel = float(((got - want).abs() / mag).max())
        rel_twin = float(((got - twin).abs() / mag).max())
        row = dict(kernel="expected_attention_scores", shape=label,
                   L=L or 1, B=B, S=S, KV=KV, G=G, dk=dk, dtype=str(dt)[6:],
                   max_abs_err=float((got - want).abs().max()),
                   max_abs_err_vs_twin=float((got - twin).abs().max()),
                   max_rel_err=rel, max_rel_err_vs_twin=rel_twin,
                   tol="2e-5 x max(1, |score|)", launches=launches,
                   ok=bool(max(rel, rel_twin) <= 2e-5 and launches == 1
                           and math.isfinite(rel + rel_twin)),
                   main_path_shape=main,
                   hymba_path_shape=label.startswith("hymba"))
        del want, twin
        row["kernel_ms"] = time_ms(torch, kern, flush)
        row["kernel_ms_read"] = time_ms(torch, kern, flush, mode="read")
        row["plain_ms"] = time_ms(torch, plain, flush, iters=5)
        # the least work (kernels/cost.py): the stats reduce over g once,
        # a K element takes two FMAs, at the float32 rate
        flops, nbytes = expected_attention_work(
            k.numel(), k.element_size(), mu.numel(), mu.element_size(),
            got.numel())
        row["bound_ms"], row["bound_by"] = bound(nbytes, flops,
                                                 torch.float32)
        row["library_ms"] = row["library_ms_read"] = None
        out.append(row)
        emit("kernel", **row)
        if not row["ok"]:
            die("kernel", f"expected_attention_scores at {label}: relative "
                          f"errors {rel} / {rel_twin} vs the plain version / "
                          f"the twin, {launches} launches per call")
        del k, mu, sig2, got
        torch.cuda.empty_cache()
    return out


def _prefill_fma(PA, q, k, v, window, causal):
    """Kernel D's FMA body on bf16 inputs the rule gives to the tensor-core
    body: the kernel these inputs ran on before the tensor-core body,
    timed beside it in the same run. Not counted (a yardstick, never on a
    path)."""
    import torch
    B, S, KV, G, dk = q.shape
    dv = v.shape[-1]
    out = torch.empty((B, S, KV, G, dv), dtype=q.dtype, device=q.device)
    err = PA._entry("fma")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S, KV,
        G, dk, dv, window, int(causal), dk ** -0.5, 1,
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"prefill_attention fma body: cudaError {err}")
    return out


def _prefill_cases(torch, gen, tol, flush):
    """Kernel D against the plain version (the attention oracle) and the
    blocked `flash_attention` at the build shapes: the planted models
    (B 16, S 160, float32, dk 16 / 24: the FMA body), stretto-llama-8b
    (B 4, S 512 and 1024, bfloat16: the tensor-core body) and hymba-1.5b
    (B 16, S 1536, KV 5, G 5, d 64, window 1024 and global), windowed and
    not; one non-causal and one dk != dv case. The 8B and hymba rows are
    also held to the tensor-core body's CPU twin run on the card, and
    timed beside the twin, the FMA body (on the same inputs) and SDPA.
    Then an item's rows alone vs in a larger, further-padded batch, in
    both bodies (bit-identical)."""
    import torch.nn.functional as F
    from repro_torch.kernels import prefill_attention as PA
    from repro_torch.kernels import ref
    from repro_torch.models.layers import flash_attention
    f32, bf16 = torch.float32, torch.bfloat16
    # (label, B, S, KV, G, dk, dv, dtype, window, causal, main-path shape?)
    cases = [("planted-sm", 16, 160, 2, 1, 16, 16, f32, GLOBAL, True, False),
             ("planted-lg", 16, 160, 4, 1, 24, 24, f32, GLOBAL, True, True),
             ("planted-lg-window", 16, 160, 4, 1, 24, 24, f32, 8, True,
              False),
             ("llama8b-S512", 4, 512, 8, 4, 128, 128, bf16, GLOBAL, True,
              True),
             ("llama8b-S512-window", 4, 512, 8, 4, 128, 128, bf16, 256, True,
              False),
             ("llama8b-S1024", 4, 1024, 8, 4, 128, 128, bf16, GLOBAL, True,
              False),
             ("llama8b-S1024-window", 4, 1024, 8, 4, 128, 128, bf16, 256,
              True, False),
             ("noncausal-G3", 2, 200, 2, 3, 24, 24, f32, GLOBAL, False,
              False),
             ("dk-ne-dv", 2, 130, 2, 2, 32, 48, f32, 17, True, False),
             ("dk-ne-dv-bf16", 2, 130, 2, 2, 32, 48, bf16, 17, True, False),
             # the hymba Session's prefill chunk: 29 of its 32 layers
             # windowed, the global layers 0 / 15 / 31
             ("hymba-S1536-w1024", 16, 1536, 5, 5, 64, 64, bf16, 1024, True,
              False),
             ("hymba-S1536-global", 16, 1536, 5, 5, 64, 64, bf16, GLOBAL,
              True, False)]
    out = []
    for label, B, S, KV, G, dk, dv, dt, window, causal, main in cases:
        def rnd(*shape):
            return torch.randn(shape, generator=gen, device="cuda").to(dt)
        q, k, v = rnd(B, S, KV, G, dk), rnd(B, S, KV, dk), rnd(B, S, KV, dv)
        body = PA.body(dt, dk, dv)

        def kern():
            return PA.prefill_attention(q, k, v, window=window,
                                        causal=causal)

        def plain():
            return ref.prefill_attention_ref(q, k, v, window=window,
                                             causal=causal)
        got, want = kern(), plain()
        blocked = flash_attention(q.reshape(B, S, KV * G, dk), k, v, window,
                                  causal=causal).reshape(got.shape)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        err_blocked = float((got.float() - blocked.float()).abs().max())
        row = dict(kernel="prefill_attention", body=body, shape=label, B=B,
                   S=S, KV=KV, G=G, dk=dk, dv=dv, dtype=str(dt)[6:],
                   window=window, causal=causal, max_abs_err=err,
                   max_abs_err_vs_blocked=err_blocked, tol=tol[dt],
                   main_path_shape=main,
                   hymba_path_shape=label == "hymba-S1536-w1024")
        errs = [err, err_blocked]
        # the full-width paths' rows: held to the tensor-core twin too,
        # and timed beside the plain version and SDPA, windowed or not
        llama = label.startswith(("llama8b", "hymba"))
        if body == "fma":
            row["max_abs_err_vs_twin"] = float((got.float() - ref
                                                .prefill_attention_fma_twin(
                                                    q, k, v, window=window,
                                                    causal=causal).float())
                                               .abs().max())
            errs.append(row["max_abs_err_vs_twin"])
        if llama:
            # the hymba chunk's twin (a Python-blocked algorithm) takes
            # about 9 s at B 16: held on its first two items (the kernel
            # is batch-invariant), and not timed
            nb = 2 if label.startswith("hymba") else B

            def twin():
                return ref.prefill_attention_tc_twin(
                    q[:nb], k[:nb], v[:nb], window=window, causal=causal)
            row["max_abs_err_vs_twin"] = float(
                (got[:nb].float() - twin().float()).abs().max())
            row["twin_items"] = nb
            errs.append(row["max_abs_err_vs_twin"])
            if nb == B:
                row["twin_ms"] = time_ms(torch, twin, flush, iters=3,
                                         warmup=1)
            row["fma_body_ms"] = time_ms(
                torch, lambda: _prefill_fma(PA, q, k, v, window, causal),
                flush)
        row["ok"] = bool(max(errs) <= tol[dt]
                         and all(math.isfinite(e) for e in errs))
        row["kernel_ms"] = time_ms(torch, kern, flush)
        row["kernel_ms_read"] = time_ms(torch, kern, flush, mode="read")
        row["bound_ms"], row["bound_by"], row["f32_fma_ms"] = \
            prefill_bound(q, k, v, window, causal)
        if (window == GLOBAL and causal) or llama:
            row["plain_ms"] = time_ms(torch, plain, flush, iters=5)
            row["blocked_ms"] = time_ms(
                torch, lambda: flash_attention(q.reshape(B, S, KV * G, dk),
                                               k, v, window, causal=causal),
                flush, iters=5)
            # yardstick: one SDPA call, heads first, K/V shared by G heads
            # (a window needs an explicit mask)
            qs = q.reshape(B, S, KV * G, dk).transpose(1, 2)
            ks, vs = k.transpose(1, 2), v.transpose(1, 2)
            mask = None
            if window != GLOBAL:
                pos = torch.arange(S, device="cuda")
                d = pos[:, None] - pos[None, :]
                mask = (d >= 0) & (d < window)
            def sdpa():
                return F.scaled_dot_product_attention(
                    qs, ks, vs, attn_mask=mask, is_causal=mask is None,
                    enable_gqa=True)
            row["library_ms"] = time_ms(torch, sdpa, flush)
            row["library_ms_read"] = time_ms(torch, sdpa, flush, mode="read")
        out.append(row)
        emit("kernel", **row)
        if not row["ok"]:
            die("kernel", f"prefill_attention at {label}: errors {errs} vs "
                          f"the oracle, the blocked attention, the twins")
    # batch invariance: item 1's first 300 rows alone vs in the S 512 batch
    same = {}
    for dt in (bf16, f32):
        q = torch.randn((3, 512, 8, 4, 128), generator=gen, device="cuda")
        k = torch.randn((3, 512, 8, 128), generator=gen, device="cuda")
        v = torch.randn((3, 512, 8, 128), generator=gen, device="cuda")
        q, k, v = q.to(dt), k.to(dt), v.to(dt)
        for G in (4, 3):
            qg = q[:, :, :, :G].contiguous()
            for window in (GLOBAL, 100):
                batched = PA.prefill_attention(qg, k, v, window=window)
                alone = PA.prefill_attention(qg[1:2, :300], k[1:2, :300],
                                             v[1:2, :300], window=window)
                torch.cuda.synchronize()
                same[f"{PA.body(dt, 128, 128)} G{G} window {window}"] = \
                    bool(torch.equal(alone[0], batched[1, :300]))
    ok = all(same.values())
    emit("kernel_edges", kernel="prefill_attention", batch_invariant=same,
         ok=ok)
    if not ok:
        die("kernel", f"prefill_attention batch invariance: {same}")
    return out


def _decode_edge_cases(torch, gen, tol):
    """Rows that see no cache position get the mean of V over all S
    positions, as the JAX package's kernels return it (lengths < Lq, an
    empty item, a window of 0); and an item's output is bit-identical
    alone and inside a larger, further-padded batch, for every decode
    kernel. Rows that see nothing are left out of the batch check: in the
    reference too their value depends on the padding."""
    for dt in (torch.float32, torch.bfloat16):
        q, k, v, lengths = _decode_inputs(torch, gen, 4, 3, 8, 4, 128, 384,
                                          dt, 3)
        lengths[1], lengths[2], lengths[3] = 1, 2, 0
        k8, ks = _quantize(torch, k)
        v8, vs = _quantize(torch, v)
        for name in DECODE:
            quant = name.endswith("int8")
            kk, vv = (k8, v8) if quant else (k, v)
            errs = []
            for window in (GLOBAL, 0):
                _, kern, plain = _decode_call(name, q, kk, vv, (ks, vs))
                got = kern(lengths, window)
                want = plain(lengths, window)
                errs.append(float((got.float() - want.float()).abs().max()))
            # batch invariance: item 0 alone at S 256 vs in the S 384 batch
            lens = lengths.clone()
            lens[0] = 200
            _, kern, _ = _decode_call(name, q, kk, vv, (ks, vs))
            _, kern1, _ = _decode_call(
                name, q[:1], kk[:1, :256], vv[:1, :256],
                (ks[:1, :256], vs[:1, :256]))
            torch.cuda.synchronize()
            same = bool(torch.equal(kern(lens)[0], kern1(lens[:1])[0]))
            err = max(errs)
            extra = _decode_split_edges(torch, name, q, kk, vv, dt,
                                        (ks, vs) if quant else ())
            ok = (err <= tol[dt] and math.isfinite(err) and same
                  and all(extra.get(key, True) for key in
                          ("split_boundaries_ok", "repeat_equal")))
            emit("kernel_edges", kernel=name, dtype=str(dt)[6:],
                 no_position_rows_max_abs_err=err, tol=tol[dt],
                 batch_invariant=same, **extra, ok=ok)
            if not ok:
                die("kernel", f"{name} {dt}: rows that see no position err "
                              f"{err}, batch invariance {same} or {extra}")


def _decode_split_edges(torch, name, q, k, v, dt, scales=()):
    """Lengths one below, at and one above each multiple of the decode
    body's split size, against the plain version; and three calls in a row
    on the same arrival counters, bit-identical."""
    from repro_torch.kernels import decode_attention as DA
    tol = 2e-5 if dt == torch.float32 else 2e-2
    S = k.shape[1]
    n = [s * DA.SPLIT + o for s in range(1, S // DA.SPLIT) for o in (-1, 0, 1)]
    lengths = torch.tensor(n, dtype=torch.int32, device="cuda")
    idx = torch.arange(len(n), device="cuda") % q.shape[0]
    qq, kk, vv = q[idx], k[idx], v[idx]
    _, kern, plain = _decode_call(name, qq, kk, vv,
                                  tuple(x[idx] for x in scales))
    got = kern(lengths)
    err = float((got.float() - plain(lengths).float()).abs().max())
    again = [kern(lengths) for _ in range(2)]
    torch.cuda.synchronize()
    return dict(split_boundary_lengths=len(n), split_boundaries_max_abs_err=err,
                split_boundaries_ok=bool(err <= tol and math.isfinite(err)),
                repeat_equal=all(bool(torch.equal(got, a)) for a in again))


# A hand-set plan holds the runtime to fixed stages (the Session phases run
# the planner's own). Its thresholds sit outside the range where this
# seeded world's non-gold scores of gold-positive and gold-negative items
# overlap, so early decisions rarely disagree with gold
PLANTED_STAGES = [(0, 0, "sm-kv80", 2.5, -3.0, False, False),
                  (1, 0, "sm-kv50", 1.5, -math.inf, True, False),
                  (0, 1, "lg-kv50", 3.0, -4.0, False, False),
                  (0, 2, "lg-kv00", 0.0, 0.0, False, True),
                  (1, 1, "lg-kv00", 0.0, 0.0, True, True)]
MARGIN = 1e-3     # float32 scores on card vs CPU agree far inside this


def _planted_engine(torch, root, device, ds, **kw):
    from repro_torch.cache.store import CacheStore
    from repro_torch.data.synthetic import make_planted_params, planted_config
    from repro_torch.serving.engine import ServingEngine
    eng = ServingEngine(CacheStore(root), device=device, **kw)
    for size in ("sm", "lg"):
        cfg = planted_config(size)
        eng.register_model(size, cfg, make_planted_params(cfg, seed=0,
                                                          device=device))
        eng.build_profiles(size, ds.items, ratios=(0.8, 0.5, 0.0),
                           prefill_batch=32)
    return eng


def _decisions(r):
    return r.accepted, {li: v.astype("int64") for li, v in
                        r.map_values.items()}


def _ints(r):
    return [(s.op_name, s.logical_idx, s.stage, s.n_tuples, s.n_llm_calls,
             s.kv_bytes) for s in r.stage_stats]


def phase_planted(torch):
    import numpy as np
    from repro_torch.core.logical import Query, SemFilter, SemMap
    from repro_torch.core.physical import PhysicalPlan, PhysicalPlanStage
    from repro_torch.data import synthetic as syn
    from repro_torch.kernels import ops
    from repro_torch.runtime.backend import KVCacheBackend, ReferenceBackend
    from repro_torch.runtime.executor import run_plan
    from repro_torch.serving.engine import ServingEngine

    ds = syn.make_dataset("smoke", 200, seed=3)
    query = Query([SemFilter("mentions topic 1", 1),
                   SemMap("extract field 2", 2)])
    plan = PhysicalPlan([PhysicalPlanStage(*s, cost=0.1)
                         for s in PLANTED_STAGES], [], 0.0, 1.0, 1.0, True)
    t0 = time.perf_counter()
    gpu = _planted_engine(torch, os.path.join(WORK, "planted-gpu"), "cuda",
                          ds)
    build_s = time.perf_counter() - t0
    backend = KVCacheBackend(gpu)
    ops.reset_launch_counts()
    inline = run_plan(plan, query, ds.items, backend, partition_size=50)
    fused_counts = ops.launch_counts()
    threads = run_plan(plan, query, ds.items, backend, partition_size=50,
                       dispatcher="threads:2")
    a, b = _decisions(inline), _decisions(threads)
    same_threads = bool(np.array_equal(a[0], b[0]) and all(
        np.array_equal(a[1][li], b[1][li]) for li in a[1]))
    if not same_threads:
        die("planted", "inline and threads:2 decisions differ")

    # per-tuple scores of every plan stage, for the margin
    ids = [it.item_id for it in ds.items]
    near = np.zeros(len(ids), bool)
    for li, _, op, hi, lo, is_map, is_gold in PLANTED_STAGES:
        model, ratio = op.split("-kv")[0], int(op.split("-kv")[1]) / 100
        if is_map:
            _, s = gpu.run_map(model, ratio, ids, [syn.map_query_token(2)],
                               [syn.value_token(v) for v in range(8)])
        else:
            s = gpu.run_filter(model, ratio, ids, [syn.filter_query_token(1)],
                               syn.TOK_YES, syn.TOK_NO)
        for t in ([0.0] if is_gold else [x for x in (hi, lo)
                                         if math.isfinite(x)]):
            near |= np.abs(s - t) < MARGIN

    # the same plan on the CPU, plain versions
    cpu = _planted_engine(torch, os.path.join(WORK, "planted-cpu"), "cpu", ds)
    on_cpu = run_plan(plan, query, ds.items, KVCacheBackend(cpu),
                      partition_size=50)
    c = _decisions(on_cpu)
    far = ~near
    cpu_same = bool(np.array_equal(a[0][far], c[0][far]) and all(
        np.array_equal(a[1][li][far], c[1][li][far]) for li in a[1]))
    if not cpu_same:
        die("planted", "card and CPU decisions differ outside the margin")
    all_same = bool(np.array_equal(a[0], c[0]) and all(
        np.array_equal(a[1][li], c[1][li]) for li in a[1]))
    if all_same and _ints(inline) != _ints(on_cpu):
        die("planted", f"integer telemetry differs: {_ints(inline)} vs "
                       f"{_ints(on_cpu)}")

    # the scan path: one decode_step per query token, kernel B
    scan = ServingEngine(gpu.store, fused=False, device="cuda")
    scan.models = gpu.models
    ops.reset_launch_counts()
    scanned = run_plan(plan, query, ds.items, KVCacheBackend(scan),
                       partition_size=50)
    scan_counts = ops.launch_counts()
    s_ = _decisions(scanned)
    scan_same = bool(np.array_equal(a[0][far], s_[0][far]) and all(
        np.array_equal(a[1][li][far], s_[1][li][far]) for li in a[1]))
    if not scan_same:
        die("planted", "scan-path decisions differ outside the margin")
    if scan_counts["decode_attention"] <= 0:
        die("planted", f"scan path launched no decode_attention kernel: "
                       f"{scan_counts}")
    if fused_counts["decode_query_attention"] <= 0:
        die("planted", f"fused path launched no query kernel: {fused_counts}")

    # quality against the uncompressed gold
    gold_plan = PhysicalPlan(
        [PhysicalPlanStage(0, 0, "lg-kv00", 0.0, 0.0, False, True, 1.0),
         PhysicalPlanStage(1, 0, "lg-kv00", 0.0, 0.0, True, True, 1.0)],
        [], 0.0, 1.0, 1.0, True)
    gold = run_plan(gold_plan, query, ds.items, ReferenceBackend(gpu))
    tp = int((inline.accepted & gold.accepted).sum())
    recall = tp / max(int(gold.accepted.sum()), 1)
    precision = tp / max(int(inline.accepted.sum()), 1)
    vals, gvals = inline.map_values.get(1), gold.map_values.get(1)
    acc = inline.accepted & gold.accepted
    map_acc = float((vals[acc] == gvals[acc]).mean()) if acc.any() else None
    emit("planted", ok=True, items=len(ds.items), build_s=build_s,
         accepted=int(inline.accepted.sum()),
         inline_equals_threads=same_threads,
         cpu_equal_outside_margin=cpu_same, cpu_equal_everywhere=all_same,
         n_near_margin=int(near.sum()), margin=MARGIN,
         cpu_ints_equal=_ints(inline) == _ints(on_cpu),
         scan_equal_outside_margin=scan_same,
         fused_launches=fused_counts, scan_launches=scan_counts,
         recall=recall, precision=precision, map_accuracy=map_acc,
         wall_s=inline.wall_s,
         stage_stats=[s.as_dict() for s in inline.stage_stats])
    del gpu, cpu, scan
    torch.cuda.empty_cache()


def phase_llama8b(torch):
    import numpy as np
    from repro_torch.cache.store import CacheStore, Profile
    from repro_torch.configs.stretto_llama_8b import CONFIG as cfg
    from repro_torch.core.logical import Query, SemFilter, SemMap
    from repro_torch.core.physical import PhysicalPlan, PhysicalPlanStage
    from repro_torch.data import synthetic as syn
    from repro_torch.kernels import ops
    from repro_torch.models import decode_multi, init_params
    from repro_torch.runtime.backend import KVCacheBackend
    from repro_torch.runtime.executor import run_plan
    from repro_torch.serving.engine import ServingEngine

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_params(cfg, gen, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    ds = syn.make_dataset("llama8b", 16, seq_len=1024, seed=5)
    eng = ServingEngine(CacheStore(os.path.join(WORK, "llama8b")),
                        device="cuda")
    eng.register_model("llama", cfg, params)
    query = Query([SemFilter("mentions topic 1", 1),
                   SemMap("extract field 2", 2)])
    stages = []
    for li, is_map in ((0, False), (1, True)):
        for st, op in enumerate(("llama-kv80", "llama-kv50")):
            stages.append(PhysicalPlanStage(li, st, op, math.inf, -math.inf,
                                            is_map, False, 0.1))
        stages.append(PhysicalPlanStage(li, 2, "llama-kv00", 0.0, 0.0,
                                        is_map, True, 1.0))
    plan = PhysicalPlan(stages, [], 0.0, 1.0, 1.0, True)
    backend = KVCacheBackend(eng, sm="llama", lg="llama", sm_ratios=(),
                             lg_ratios=(0.8, 0.5), include_cheap=False)
    scan = ServingEngine(eng.store, fused=False, device="cuda")
    scan.models = eng.models
    ids = [it.item_id for it in ds.items]

    # ---- the main path: counts from 0, driven, read ----
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t1 = time.perf_counter()
    eng.build_profiles("llama", ds.items, ratios=(0.8, 0.5, 0.0),
                       prefill_batch=4)
    build_s = time.perf_counter() - t1
    t2 = time.perf_counter()
    result = run_plan(plan, query, ds.items, backend)
    plan_s = time.perf_counter() - t2
    t3 = time.perf_counter()
    scan_lo = scan.run_filter("llama", 0.8, ids[:4],
                              [syn.filter_query_token(1)], syn.TOK_YES,
                              syn.TOK_NO)
    torch.cuda.synchronize()
    scan_s = time.perf_counter() - t3
    counts = ops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # ---------------------------------------------------------------
    # this hand-written plan has no int8 stage: A, B (scan flush), C and
    # the build's D
    missing = [k for k in ("decode_query_attention", "decode_attention",
                           "expected_attention_scores", "prefill_attention")
               if counts[k] <= 0]
    if missing:
        die("llama8b", f"kernels not launched on this path: {missing}")
    _check_chunks("llama8b", counts, eng)
    if not np.all(np.isfinite(scan_lo)):
        die("llama8b", "non-finite scan-path scores")
    flush_items = sum(s.n_tuples for s in result.stage_stats)
    flush_s = sum(s.wall_s for s in result.stage_stats)
    if result.accepted.shape != (16,):
        die("llama8b", "result has the wrong shape")

    # one flush's logits, kernel vs plain path, on the card
    prof = Profile("llama", 0.5)
    tok = torch.full((8, 1), syn.filter_query_token(1), dtype=torch.long,
                     device="cuda")
    caches = [eng.store.load_batch(cfg, prof, ids[:8], pad_to_multiple=128,
                                   headroom=3, device="cuda")[0]
              for _ in range(2)]
    got = decode_multi(params, cfg, caches[0], tokens=tok, kernels="cuda")[0]
    want = decode_multi(params, cfg, caches[1], tokens=tok, kernels="ref")[0]
    err = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    logit_tol = 0.05 * scale        # bfloat16 through 32 layers
    finite = bool(torch.isfinite(got.float()).all())
    emit("llama8b", ok=bool(finite and err <= logit_tol),
         items=len(ds.items), seq_len=1024, init_s=init_s, build_s=build_s,
         build_steps_s=eng.build_seconds, plan_wall_s=plan_s,
         run_wall_s=result.wall_s, flush_items=flush_items,
         flush_s=flush_s, flush_items_per_s=flush_items / max(flush_s, 1e-9),
         scan_flush_s=scan_s, launches=counts, peak_mem_gb=peak_gb,
         accepted=int(result.accepted.sum()),
         h2d_overlap_s=eng.h2d_overlap_s, donated_bytes=eng.donated_bytes,
         stage_stats=[s.as_dict() for s in result.stage_stats],
         logits_max_abs_err=err, logits_max_abs=scale, logits_tol=logit_tol)
    if not (finite and err <= logit_tol):
        die("llama8b", f"flush logits kernel vs plain: err {err} > "
                       f"{logit_tol} or non-finite")
    del eng, scan, caches
    shutil.rmtree(os.path.join(WORK, "llama8b"), ignore_errors=True)
    torch.cuda.empty_cache()
    return counts, params


# ---------------------------------------------------------------------------
# the Session path: SessionConfig -> frame -> plan_query -> execute -> metrics
# ---------------------------------------------------------------------------

QUERY = (("mentions topic 1", 1), ("extract field 2", 2))
TARGET = 0.75


def _frame(sess, items):
    return (sess.frame(items)
            .sem_filter(QUERY[0][0], task_id=QUERY[0][1])
            .sem_map(QUERY[1][0], task_id=QUERY[1][1])
            .with_guarantees(recall=TARGET, precision=TARGET))


class _PlanTimer:
    """Seconds plan_query spends profiling and optimizing, by wrapping the
    two calls it makes (the planner reports only its total), and the
    arguments of each optimizer call (the profiled sample as the
    optimizer got it, on the Session's device). The optimizer's seconds
    end when its result is on the host (it copies its plan there)."""

    def __init__(self):
        import repro_torch.core.planner as P
        self.P, self.s = P, {"profile_s": 0.0, "optimize_s": 0.0}
        self.real = (P.profile_query, P.optimize_query)
        self.opt_calls = []

        def timed(fn, key):
            def run(*a, **kw):
                if key == "optimize_s":
                    self.opt_calls.append((a, kw))
                t0 = time.perf_counter()
                try:
                    return fn(*a, **kw)
                finally:
                    self.s[key] += time.perf_counter() - t0
            return run
        P.profile_query = timed(self.real[0], "profile_s")
        P.optimize_query = timed(self.real[1], "optimize_s")

    def close(self):
        self.P.profile_query, self.P.optimize_query = self.real


def _drive_session(torch, sess, corpora, frame):
    """A path through the user's entry points, counts from 0: profiles
    for every corpus, EXPLAIN (plan), execute, metrics against gold. Also
    returns the optimizer's calls (their arguments) of the plan."""
    from repro_torch.kernels import ops
    timer = _PlanTimer()
    ops.reset_launch_counts()
    try:
        t0 = time.perf_counter()
        for items in corpora:
            sess.prepare(items)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        report = frame.explain()
        t2 = time.perf_counter()
        result = frame.execute()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        metrics = result.metrics()
        torch.cuda.synchronize()
        counts = ops.launch_counts()
    finally:
        timer.close()
    times = dict(build_s=t1 - t0, plan_s=t2 - t1, **timer.s,
                 execute_s=t3 - t2, execute_wall_s=result.wall_s,
                 items_per_s=sum(map(len, corpora)) / max(t3 - t2, 1e-9),
                 gold_s=time.perf_counter() - t3)
    return report, result, metrics, counts, times, timer.opt_calls


def _check_chunks(phase, counts, eng):
    """One launch of C per prefill chunk the path's engine built."""
    if counts["expected_attention_scores"] != eng.prefill_chunks:
        die(phase, f"{counts['expected_attention_scores']} launches of C for "
                   f"{eng.prefill_chunks} prefill chunks")


def _check_session(phase, report, result, metrics, counts, n_items, eng):
    _check_chunks(phase, counts, eng)
    if counts["decode_query_attention_int8"] <= 0:
        die(phase, f"the Session path launched no int8 query kernel: "
                   f"{counts}")
    for name in ("decode_query_attention", "expected_attention_scores",
                 "prefill_attention"):
        if counts[name] <= 0:
            die(phase, f"the Session path launched no {name}: {counts}")
    if not all(any(c.endswith("i8") for c in names)
               for names in report.candidates):
        die(phase, f"EXPLAIN lists no int8 candidate: {report.candidates}")
    if result.accepted.shape != (n_items,):
        die(phase, "result has the wrong shape")
    if metrics["recall"] < TARGET or metrics["precision"] < TARGET:
        die(phase, f"guarantees missed against gold: {metrics}")


def _scan_leg(torch, eng, model, ratios_quant, ids, query_len=1):
    """Scan-path flushes (fused=False, one decode_step per token) over
    the engine's store: kernel B, and B-int8 on the int8 rungs."""
    from repro_torch.data import synthetic as syn
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import ServingEngine
    scan = ServingEngine(eng.store, fused=False, device=eng.device)
    scan.models = eng.models
    ops.reset_launch_counts()
    outs = [scan.run_filter(model, ratio, ids, [syn.filter_query_token(1)],
                            syn.TOK_YES, syn.TOK_NO, quant=quant)
            for ratio, quant in ratios_quant]
    torch.cuda.synchronize()
    import numpy as np
    if not all(np.all(np.isfinite(o)) for o in outs):
        die("session", "non-finite scan-path scores")
    return ops.launch_counts()


def _cpu_engine(cfg, root):
    """The planted models on the CPU over the store the card built."""
    from repro_torch.cache.store import CacheStore
    from repro_torch.data import synthetic as syn
    from repro_torch.serving.engine import ServingEngine
    eng = ServingEngine(CacheStore(root), device="cpu")
    for size in cfg.models:
        mcfg = syn.planted_config(size)
        eng.register_model(size, mcfg, syn.make_planted_params(
            mcfg, seed=cfg.model_seed, device="cpu"))
    return eng


def _linear_card_vs_cpu(phase, sess, plan, query, items, card, cpu):
    """One linear plan's card run against its CPU run: decisions equal for
    every tuple whose card score at some stage sits more than MARGIN from
    a threshold that stage applies, and, where every decision is equal,
    equal integer telemetry. Returns (equal outside the margin, equal
    everywhere, tuples near a threshold)."""
    import numpy as np
    from repro_torch.runtime.executor import run_operator
    near = np.zeros(len(items), bool)
    ops_ = query.semantic_ops
    for st in plan.stages:
        sc = np.asarray(run_operator(sess.backend, ops_[st.logical_idx],
                                     st.op_name, items).scores)
        thrs = [0.0] if st.is_gold else [
            x for x in ((st.thr_hi,) if st.is_map else (st.thr_hi, st.thr_lo))
            if math.isfinite(x)]
        for x in thrs:
            near |= np.abs(sc - x) < MARGIN
    a, c = _decisions(card), _decisions(cpu)
    far = ~near
    cpu_same = bool(np.array_equal(a[0][far], c[0][far]) and all(
        np.array_equal(a[1][li][far], c[1][li][far]) for li in a[1]))
    if not cpu_same:
        die(phase, "card and CPU decisions differ outside the margin")
    all_same = bool(np.array_equal(a[0], c[0]) and all(
        np.array_equal(a[1][li], c[1][li]) for li in a[1]))
    if all_same and _ints(card) != _ints(cpu):
        die(phase, f"integer telemetry differs: {_ints(card)} vs "
                   f"{_ints(cpu)}")
    return cpu_same, all_same, int(near.sum())


BASELINES = ("plan_lotus", "plan_pareto_cascades", "plan_stretto_local",
             "plan_stretto_independent")


def _run_planners(torch, sess, query, items, with_stretto=False):
    """Each comparison planner (and, `with_stretto`, plan_query) on the
    Session's device over its backend, with the Session's planner
    settings; each plan then executed through the Session. Counts from 0
    per planner. Returns [(name, plan, result, row)] and the summed
    counts."""
    from repro_torch.core import baselines as BL
    from repro_torch.core.executor import evaluate_vs_gold
    from repro_torch.core.planner import plan_query
    from repro_torch.kernels import ops
    cfg = sess.config
    common = dict(sample_frac=cfg.sample_frac, seed=cfg.seed,
                  device=sess.device)
    planners = [(name, getattr(BL, name)) for name in BASELINES]
    if with_stretto:
        planners.insert(0, ("plan_query", plan_query))
    gold = sess.gold(query, items)
    out, total = [], None
    for name, fn in planners:
        kw = dict(common)
        if name in ("plan_query", "plan_stretto_local",
                    "plan_stretto_independent"):
            kw["cfg"] = cfg.planner
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        plan = fn(query, items, sess.backend, **kw)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        plan_counts = ops.launch_counts()
        # from a cold device LRU, as a CPU run over the store starts: a
        # hit loads no bytes, and profiling leaves the sample resident
        sess.engine.evict()
        result = sess.run(plan, query, items)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        counts = ops.launch_counts()
        m = evaluate_vs_gold(result, gold, query.semantic_ops)
        a_launches = (counts["decode_query_attention"]
                      + counts["decode_query_attention_int8"])
        row = dict(planner=name, plan_s=t1 - t0, execute_s=t2 - t1,
                   items_per_s=len(items) / max(t2 - t1, 1e-9),
                   recall=m["recall"], precision=m["precision"],
                   stages=[s_.op_name for s_ in plan.stages],
                   feasible=plan.feasible, recall_bound=plan.recall_bound,
                   precision_bound=plan.precision_bound,
                   est_cost=plan.est_cost, a_launches=a_launches,
                   e_launches_planning=plan_counts["beta_incinv"]
                   + plan_counts["beta_incinv_grad_terms"],
                   n_llm_tuples=result.n_llm_tuples)
        if result.accepted.shape != (len(items),) or a_launches <= 0:
            die("baselines", f"{name}: result of the wrong shape or no "
                             f"launch of A: {row}")
        if name != "plan_lotus" and name != "plan_pareto_cascades" \
                and row["e_launches_planning"] <= 0:
            die("baselines", f"{name} planned without kernel E on the card")
        out.append((name, plan, result, row))
        total = counts if total is None else {
            k: (total[k] + v if not isinstance(v, dict) else
                {b: total[k][b] + n for b, n in v.items()})
            for k, v in counts.items()}
    return out, total


def phase_session_planted(torch):
    """The quickstart query through repro_torch.Session on the card, with
    int8 rungs declared on both planted models; then the comparison
    planners over the same corpus (`baselines_planted`), each plan on the
    card and on the CPU."""
    from repro_torch.api import Session, SessionConfig
    from repro_torch.core.optimizer import PlannerConfig
    from repro_torch.data import synthetic as syn

    ds = syn.make_dataset("session", 200, seed=3)
    root = os.path.join(WORK, "session-planted")
    cfg = SessionConfig(
        profile_ratios=(0.0, 0.3, 0.5, 0.8), sm_ratios=(0.8, 0.5, 0.0),
        lg_ratios=(0.8, 0.5, 0.3), sm_int8=(0.5,), lg_int8=(0.3,),
        planner=PlannerConfig(steps=200, restarts=3), sample_frac=0.25,
        partition_size=64, cache_dir=root)
    sess = Session(cfg)
    frame = _frame(sess, ds.items)
    report, result, metrics, counts, times, opt_calls = _drive_session(
        torch, sess, [ds.items], frame)
    emit("session_explain", text=str(report))
    _check_session("session_planted", report, result, metrics, counts,
                   len(ds.items), sess.engine)
    query, plan = frame.to_query(), result.raw.plan

    # the same plan by the port on the CPU, over the same stored profiles
    cpu_eng = _cpu_engine(cfg, root)
    cpu_sess = Session(cfg, engine=cpu_eng, device="cpu")
    cpu = cpu_sess.run(plan, query, ds.items)
    cpu_same, all_same, n_near = _linear_card_vs_cpu(
        "session_planted", sess, plan, query, ds.items, result.raw, cpu)
    ids = [it.item_id for it in ds.items[:16]]
    scan = _scan_leg(torch, sess.engine, "lg",
                     [(0.3, True), (0.5, False)], ids)
    emit("session_planted", ok=True, items=len(ds.items), **times,
         planning_time_s=report.planning_time_s,
         stages=[s.op_name for s in report.stages],
         int8_stages=[s.op_name for s in report.stages
                      if s.op_name.endswith("i8")],
         feasible=report.feasible, recall_bound=report.recall_bound,
         precision_bound=report.precision_bound, metrics=metrics,
         launches=counts, scan_launches=scan,
         prefill_chunks=sess.engine.prefill_chunks,
         cpu_equal_outside_margin=cpu_same, cpu_equal_everywhere=all_same,
         n_near_margin=n_near, margin=MARGIN,
         cpu_ints_equal=_ints(result.raw) == _ints(cpu),
         stage_stats=[s.as_dict() for s in result.stage_stats])

    # the comparison planners on the card, each plan also on the CPU
    runs, base_counts = _run_planners(torch, sess, query, ds.items)
    rows = []
    for name, bplan, bres, row in runs:
        cpu_eng.evict()
        bcpu = cpu_sess.run(bplan, query, ds.items)
        row["cpu_equal_outside_margin"], row["cpu_equal_everywhere"], \
            row["n_near_margin"] = _linear_card_vs_cpu(
                "baselines_planted", sess, bplan, query, ds.items, bres,
                bcpu)
        rows.append(row)
    emit("baselines_planted", ok=True, items=len(ds.items), planners=rows,
         launches=base_counts)
    sharded = phase_sharded_planted(torch, sess, plan, query, ds.items)
    sess.close()
    cpu_sess.close()
    del sess, cpu_sess, cpu_eng
    torch.cuda.empty_cache()
    return counts, scan, base_counts, opt_calls[-1], sharded


SESSION_8B_ITEMS, SESSION_8B_LEN = 32, 512


def phase_session_llama8b(torch, params):
    """The same query through Session(cfg, engine=eng) with
    stretto-llama-8b (full width, random weights) registered as "lg", an
    int8 rung declared, and one int8 flush's logits kernel vs plain."""
    from repro_torch.api import EngineSpec, Session, SessionConfig
    from repro_torch.cache.store import CacheStore, Profile
    from repro_torch.configs.stretto_llama_8b import CONFIG as cfg8
    from repro_torch.core.optimizer import PlannerConfig
    from repro_torch.data import synthetic as syn
    from repro_torch.models import decode_multi
    from repro_torch.serving.engine import ServingEngine

    ds = syn.make_dataset("llama8b-session", SESSION_8B_ITEMS,
                          seq_len=SESSION_8B_LEN, seed=6)
    eng = ServingEngine(CacheStore(os.path.join(WORK, "session-8b")),
                        device="cuda")
    eng.register_model("lg", cfg8, params)
    spec = EngineSpec("llama8b", models=("lg",), sm_ratios=(),
                      lg_ratios=(0.8, 0.5), lg_int8=(0.5,),
                      include_cheap=False, prefill_batch=4)
    sess = Session(SessionConfig(
        engines=(spec,), planner=PlannerConfig(steps=200, restarts=3)),
        engine=eng)
    torch.cuda.reset_peak_memory_stats()
    report, result, metrics, counts, times, opt_calls = _drive_session(
        torch, sess, [ds.items], _frame(sess, ds.items))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    emit("session_explain", text=str(report))
    _check_session("session_llama8b", report, result, metrics, counts,
                   len(ds.items), eng)
    n_sample = max(20, round(0.15 * len(ds.items)))
    ids = [it.item_id for it in ds.items]
    scan = _scan_leg(torch, eng, "lg", [(0.5, True), (0.8, False)], ids[:4])

    # one int8 flush's logits, kernels vs plain versions, on the card
    tok = torch.full((8, 1), syn.filter_query_token(1), dtype=torch.long,
                     device=eng.device)
    caches = [eng.store.load_batch(cfg8, Profile("lg", 0.5, True), ids[:8],
                                   pad_to_multiple=128, headroom=3,
                                   device=eng.device)[0] for _ in range(2)]
    got = decode_multi(params, cfg8, caches[0], tokens=tok,
                       kernels="cuda")[0]
    want = decode_multi(params, cfg8, caches[1], tokens=tok,
                        kernels="ref")[0]
    err = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    finite = bool(torch.isfinite(got.float()).all())
    ok = finite and err <= 0.05 * scale
    emit("session_llama8b", ok=ok, items=len(ds.items),
         item_tokens=SESSION_8B_LEN, sample_items=n_sample, **times,
         planning_time_s=report.planning_time_s,
         stages=[s.op_name for s in report.stages],
         int8_stages=[s.op_name for s in report.stages
                      if s.op_name.endswith("i8")],
         feasible=report.feasible, metrics=metrics, launches=counts,
         prefill_chunks=eng.prefill_chunks,
         scan_launches=scan, peak_mem_gb=peak_gb,
         build_steps_s=eng.build_seconds,
         int8_logits_max_abs_err=err, logits_max_abs=scale,
         logits_tol=0.05 * scale,
         stage_stats=[s.as_dict() for s in result.stage_stats])
    if n_sample >= len(ds.items):
        die("session_llama8b", "the planner's sample is the whole corpus")
    if not ok:
        die("session_llama8b", f"int8 flush logits kernel vs plain: err "
                               f"{err} > {0.05 * scale} or non-finite")
    del caches
    # the Session and its store stay for sharded_llama8b and
    # baselines_llama8b
    return counts, scan, opt_calls[-1], (sess, ds.items,
                                         _frame(sess, ds.items).to_query(),
                                         result.raw.plan)


def phase_baselines_llama8b(torch, kept):
    """The paper's Exp 1 comparison at 8B width on the card, no claim:
    plan_query and the four comparison planners over the 8B Session's
    corpus and store (not built again), each planned on the card and
    executed through the Session; plan and execute seconds, items/s,
    recall and precision against gold, stages, and A's launches. Then
    the store is removed."""
    sess, items, query, _ = kept
    runs, counts = _run_planners(torch, sess, query, items,
                                 with_stretto=True)
    emit("baselines_llama8b", ok=True, items=len(items),
         item_tokens=SESSION_8B_LEN, planners=[r[3] for r in runs],
         launches=counts)
    sess.close()
    del sess, runs
    shutil.rmtree(os.path.join(WORK, "session-8b"), ignore_errors=True)
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# the join path: SemFrame.sem_join -> Session.plan_tree -> run_tree -> gold
# ---------------------------------------------------------------------------

JOIN = ("same v3", 3, "category")
SIDE_FILTERS = (("mentions topic 1", 1), ("mentions topic 4", 4))


def _join_frame(sess, left, right):
    (lt, lk), (rt, rk) = SIDE_FILTERS
    return (sess.frame(left).sem_filter(lt, task_id=lk)
            .sem_join(sess.frame(right).sem_filter(rt, task_id=rk),
                      JOIN[0], JOIN[1], on=JOIN[2])
            .with_guarantees(recall=TARGET, precision=TARGET))


def _check_join(phase, result, metrics, counts, eng, gold_may_be_empty=False):
    """D, C (once per prefill chunk) and A launched; recall and precision
    at the targets against gold_tree. With random weights (8B) the gold
    join may be empty; then the result must be empty too."""
    _check_chunks(phase, counts, eng)
    for name in ("prefill_attention", "expected_attention_scores",
                 "decode_query_attention"):
        if counts[name] <= 0:
            die(phase, f"the join path launched no {name}: {counts}")
    if metrics["n_gold"] == 0 and gold_may_be_empty:
        if metrics["n_result"] != 0:
            die(phase, f"the gold join is empty but the result is not: "
                       f"{metrics}")
    elif metrics["n_gold"] <= 0:
        die(phase, f"the gold join is empty: {metrics}")
    elif metrics["recall"] < TARGET or metrics["precision"] < TARGET:
        die(phase, f"guarantees missed against gold_tree: {metrics}")
    if not result.stage_stats:
        die(phase, "the join executed no stage")


def _role_near(backend, plan, role, items):
    """Of these tuples of one role, those whose card score at some stage
    of the role's plan sits within MARGIN of a threshold that stage
    applies."""
    import numpy as np
    from repro_torch.runtime.executor import run_operator
    near = np.zeros(len(items), bool)
    if not items:
        return near
    ops_ = plan.queries[role].semantic_ops
    for st in plan.roles[role].stages:
        s = np.asarray(run_operator(backend, ops_[st.logical_idx],
                                    st.op_name, items).scores)
        thrs = [0.0] if st.is_gold else [
            x for x in ((st.thr_hi,) if st.is_map
                        else (st.thr_hi, st.thr_lo)) if math.isfinite(x)]
        for x in thrs:
            near |= np.abs(s - x) < MARGIN
    return near


def _tree_card_vs_cpu(phase, backend, plan, card, cpu, left, right):
    """One TreePlan's card run against its CPU run, decision by decision.
    Every side item whose decision differs, and every pair both runs
    scored whose decision differs, must have a card score within MARGIN
    of a threshold its role's plan applies; a pair only one run scored
    must have a side item whose decision differs. Where every decision is
    equal, the integer StageStats must be too. Returns (all equal, the
    number of differing tuples near a threshold per role)."""
    import numpy as np
    n_near = {}
    differing_ids = set()
    for role, items in (("left", left), ("right", right)):
        a, c = card.roles[role].accepted, cpu.roles[role].accepted
        idx = np.flatnonzero(a != c)
        diff = [items[i] for i in idx]
        near = _role_near(backend, plan, role, diff)
        if not near.all():
            die(phase, f"{role} decisions differ on the card and the CPU "
                       f"with no score within {MARGIN} of a threshold: ids "
                       f"{[it.item_id for it in diff]}")
        n_near[role] = len(diff)
        differing_ids |= {it.item_id for it in diff}
    a_ids, c_ids = set(card.pair_ids), set(cpu.pair_ids)
    c_scored = {p.item_id for p in cpu.pair_items}
    a_scored = {p.item_id for p in card.pair_items}
    both = [p for p in card.pair_items if p.item_id in c_scored
            and (p.item_id in a_ids) != (p.item_id in c_ids)]
    near = _role_near(backend, plan, "pair", both)
    if not near.all():
        die(phase, f"pair decisions differ on the card and the CPU with no "
                   f"score within {MARGIN} of a threshold: "
                   f"{[p.item_id for p in both]}")
    unexplained = [pid for pid in a_scored ^ c_scored
                   if not set(pid) & differing_ids]
    if unexplained:
        die(phase, f"pairs scored by one run only, with no side decision "
                   f"differing: {unexplained[:8]}")
    n_near["pair"] = len(both)
    same = (not any(n_near.values()) and a_scored == c_scored
            and card.pair_ids == cpu.pair_ids)
    if same and _ints(card) != _ints(cpu):
        die(phase, f"integer StageStats differ: {_ints(card)} vs "
                   f"{_ints(cpu)}")
    return same, n_near


def _hand_tree(plan):
    """The planned TreePlan with hand-set role stages: a compressed rung
    ahead of gold on the right side and, on the pair cascade, kernel A
    over both sides' 50 % caches ahead of the gold pair scorer. The
    thresholds sit where this seeded world's compressed scores of gold
    positives and negatives do not overlap, so the early decisions agree
    with gold and the rest reach the gold stage."""
    import dataclasses
    from repro_torch.core.physical import PhysicalPlan, PhysicalPlanStage

    def role(name, stages):
        planned = plan.roles[name]
        return PhysicalPlan([PhysicalPlanStage(*st) for st in stages],
                            planned.relational, 0.0, 1.0, 1.0, True,
                            post_relational=planned.post_relational)
    return dataclasses.replace(plan, roles={
        "left": role("left", [(0, 0, "lg-kv00", 0.0, 0.0, False, True, 1.0)]),
        "right": role("right", [
            (0, 0, "lg-kv50", 3.0, -1.0, False, False, 0.5),
            (0, 1, "lg-kv00", 0.0, 0.0, False, True, 1.0)]),
        "pair": role("pair", [
            (0, 0, "lg-pair50", 5.5, -5.5, False, False, 0.5),
            (0, 1, "lg-pair00", 0.0, 0.0, False, True, 1.0)])})


def phase_session_join_planted(torch):
    """The join tree through repro_torch.Session on the card over the
    planted models, planned and under a hand-set plan with compressed
    side and pair stages; each plan's CPU run over the card's stored
    profiles must give the same decisions, up to scores at a threshold."""
    from repro_torch.api import Session, SessionConfig
    from repro_torch.api.result import JoinResult
    from repro_torch.core.optimizer import PlannerConfig
    from repro_torch.data import synthetic as syn
    from repro_torch.kernels import ops

    left, right = syn.make_join_corpora(n_left=120, n_right=120, seed=0)
    root = os.path.join(WORK, "join-planted")
    cfg = SessionConfig(
        profile_ratios=(0.0, 0.3, 0.5, 0.8), sm_ratios=(0.8, 0.5, 0.0),
        lg_ratios=(0.8, 0.5, 0.3),
        planner=PlannerConfig(steps=200, restarts=3), sample_frac=0.25,
        partition_size=64, cache_dir=root)
    sess = Session(cfg)
    report, result, metrics, counts, times, opt_calls = _drive_session(
        torch, sess, [left.items, right.items],
        _join_frame(sess, left.items, right.items))
    emit("session_explain", text=str(report))
    _check_join("session_join_planted", result, metrics, counts, sess.engine)
    plan = result.raw.plan

    # the hand-set plan on the card, counts from 0, from a cold device LRU
    # as the CPU runs below start: a hit loads no bytes (kv_bytes counts
    # real loads), and metrics() above ran gold over every item, which
    # leaves batches of a gold-first role resident
    hand = _hand_tree(plan)
    sess.engine.evict()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    hand_run = sess.run_tree(hand, left.items, right.items)
    torch.cuda.synchronize()
    hand_s = time.perf_counter() - t0
    hand_counts = ops.launch_counts()
    hand_metrics = JoinResult(sess, left.items, right.items,
                              hand_run).metrics()
    if hand_counts["decode_query_attention"] <= 0:
        die("session_join_planted", f"the hand-set tree launched no "
                                    f"decode_query_attention: {hand_counts}")
    if (hand_metrics["n_gold"] <= 0 or hand_metrics["recall"] < TARGET
            or hand_metrics["precision"] < TARGET):
        die("session_join_planted", f"the hand-set tree missed its "
                                    f"targets against gold: {hand_metrics}")
    early = [s for s in hand_run.roles["pair"].stage_stats
             if s.op_name == "lg-pair50"]
    if not early or early[0].n_llm_calls <= 0:
        die("session_join_planted", "the compressed pair stage scored "
                                    "no pair on the card")

    # each plan by the port on the CPU, over the same stored profiles
    cpu_eng = _cpu_engine(cfg, root)
    cpu_sess = Session(cfg, engine=cpu_eng, device="cpu")
    checks = {}
    for name, tree, card in (("planned", plan, result.raw),
                             ("hand", hand, hand_run)):
        cpu_eng.evict()
        cpu = cpu_sess.run_tree(tree, left.items, right.items)
        checks[name] = _tree_card_vs_cpu(
            "session_join_planted", sess.backend, tree, card, cpu,
            left.items, right.items)
    emit("session_join_planted", ok=True, items=[len(left.items),
                                                 len(right.items)],
         **times, planning_time_s=report.planning_time_s,
         stages={role: [s.op_name for s in rep.stages]
                 for role, rep in report.sections},
         split=report.split, est_pairs=report.est_pairs,
         feasible=report.feasible, recall_bound=report.recall_bound,
         precision_bound=report.precision_bound, metrics=metrics,
         pairs_scored=len(result.pair_items), pairs=len(result.pair_ids),
         launches=counts, prefill_chunks=sess.engine.prefill_chunks,
         hand_stages={r: [s.op_name for s in p.stages]
                      for r, p in hand.roles.items()},
         hand_execute_s=hand_s, hand_metrics=hand_metrics,
         hand_launches=hand_counts,
         cpu_all_equal={k: v[0] for k, v in checks.items()},
         n_differing_near_margin={k: v[1] for k, v in checks.items()},
         margin=MARGIN,
         stage_stats=[s.as_dict() for s in result.stage_stats],
         hand_stage_stats=[s.as_dict() for s in hand_run.stage_stats])
    sess.close()
    cpu_sess.close()
    del sess, cpu_sess, cpu_eng
    torch.cuda.empty_cache()
    return counts, hand_counts


JOIN_8B_ITEMS, JOIN_8B_LEN = 24, 512


def phase_session_join_llama8b(torch, params):
    """The join tree through Session(cfg, engine=eng) with
    stretto-llama-8b (full width, random weights) registered as "lg":
    ladder 0.5 + gold, two corpora of 24 items of 512 tokens."""
    from repro_torch.api import EngineSpec, Session, SessionConfig
    from repro_torch.cache.store import CacheStore
    from repro_torch.configs.stretto_llama_8b import CONFIG as cfg8
    from repro_torch.core.optimizer import PlannerConfig
    from repro_torch.data import synthetic as syn
    from repro_torch.serving.engine import ServingEngine

    left = syn.make_dataset("join8b-left", JOIN_8B_ITEMS,
                            seq_len=JOIN_8B_LEN, seed=7)
    right = syn.make_dataset("join8b-right", JOIN_8B_ITEMS,
                             seq_len=JOIN_8B_LEN, seed=8)
    for it in right.items:            # disjoint ids, as make_join_corpora
        it.item_id += 1_000_000
    eng = ServingEngine(CacheStore(os.path.join(WORK, "join-8b")),
                        device="cuda")
    eng.register_model("lg", cfg8, params)
    spec = EngineSpec("llama8b", models=("lg",), sm_ratios=(),
                      lg_ratios=(0.5,), include_cheap=False, prefill_batch=4)
    sess = Session(SessionConfig(
        engines=(spec,), planner=PlannerConfig(steps=200, restarts=3)),
        engine=eng)
    torch.cuda.reset_peak_memory_stats()
    report, result, metrics, counts, times, opt_calls = _drive_session(
        torch, sess, [left.items, right.items],
        _join_frame(sess, left.items, right.items))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    emit("session_explain", text=str(report))
    _check_join("session_join_llama8b", result, metrics, counts, eng,
                gold_may_be_empty=True)
    emit("session_join_llama8b", ok=True,
         items=[len(left.items), len(right.items)], item_tokens=JOIN_8B_LEN,
         **times, planning_time_s=report.planning_time_s,
         stages={role: [s.op_name for s in rep.stages]
                 for role, rep in report.sections},
         split=report.split, est_pairs=report.est_pairs,
         feasible=report.feasible, metrics=metrics,
         pairs_scored=len(result.pair_items), pairs=len(result.pair_ids),
         launches=counts, prefill_chunks=eng.prefill_chunks,
         peak_mem_gb=peak_gb,
         build_steps_s=eng.build_seconds,
         stage_stats=[s.as_dict() for s in result.stage_stats])
    sess.close()
    del sess, eng
    shutil.rmtree(os.path.join(WORK, "join-8b"), ignore_errors=True)
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# the planner on the card: kernel E and the optimizer's CUDA graph
# ---------------------------------------------------------------------------

# kernel E on the Sessions' real inputs (a, b = 1 + soft counts of at
# most 50 sample tuples, q = 0.05), against the plain version on the card,
# the twin and the CPU: the root; the backward's four betainc terms (max
# abs); dI/da, dI/db formed from them (max error over max size: a kernel
# that dropped the step reads 1, one that swapped the signs 2, and the
# check must reject both); the pdf (relative). scripts/beta_bounds_errors.py
# read a, b in [1, 60] at q <= 0.05: terms 3.1e-6, gradient 3.2 %, pdf
# 7.6e-6 (tests/test_torch_gpu.py holds E over that grid and wider ones).
E_TOL = dict(x=2e-5, fd=1e-5, grad=0.15, pdf=1e-4)
E_TOL_WIDE_X = 1e-4                      # a, b to 1e4: the root only
FMA_LATENCY_CYCLES = 4                   # H100: a dependent float32 FMA
BOOST_HZ = 1.98e9                        # H100 SXM maximum SM clock
TIE = 5e-3                               # optimizer ties (ROADMAP queue 3)


def _on_cpu(pipelines):
    """The optimizer's pipelines with every tensor copied to the host (the
    optimizer runs where its pipelines lie)."""
    return [p._replace(**{f: v.cpu() for f, v in p._asdict().items()
                          if hasattr(v, "cpu")}) for p in pipelines]


def _same_run(torch, a, b) -> bool:
    """Two optimizer loops' outputs equal bit for bit: every restart's
    parameters, every loss, every snapshot."""
    return (torch.equal(a.flat, b.flat) and torch.equal(a.losses, b.losses)
            and sorted(a.snaps) == sorted(b.snaps)
            and all(torch.equal(a.snaps[i], b.snaps[i]) for i in a.snaps))


def _tie_check(torch, card, cpu):
    """Stages selected differently by the card's and the CPU's plan, each
    with both final pick probabilities; None if one lies more than TIE
    from 0.5."""
    diff = []
    for li, (sa, sb, pa, pb) in enumerate(zip(card.selected, cpu.selected,
                                              card.params, cpu.params)):
        qa = torch.sigmoid(pa.pick_logits.double())
        qb = torch.sigmoid(pb.pick_logits.double())
        for i in (sa != sb).nonzero()[0]:
            i = int(i)
            diff.append(dict(pipeline=li, op=i, p_card=float(qa[i]),
                             p_cpu=float(qb[i])))
            if abs(float(qa[i]) - 0.5) > TIE or abs(float(qb[i]) - 0.5) > TIE:
                return None, diff
    return True, diff


def _record_e(torch, ops):
    """Wrap ops.beta_incinv / beta_incinv_grad_terms to keep the inputs of
    every call made outside a CUDA-graph capture (a, b, q / x); returns
    (records, restore)."""
    rec = {"fwd": [], "bwd": []}
    real = (ops.beta_incinv, ops.beta_incinv_grad_terms)

    def keep(key, ts):
        if not torch.cuda.is_current_stream_capturing():
            rec[key].append(tuple(t.detach().clone() for t in ts))

    def fwd(a, b, q, **kw):
        keep("fwd", torch.broadcast_tensors(a, b, q))
        return real[0](a, b, q, **kw)

    def bwd(a, b, x, **kw):
        keep("bwd", (a, b, x))
        return real[1](a, b, x, **kw)
    ops.beta_incinv, ops.beta_incinv_grad_terms = fwd, bwd

    def restore():
        ops.beta_incinv, ops.beta_incinv_grad_terms = real
    return rec, restore


def _optimizer_split(torch, TO, prob, cfg):
    """Device ms per Adam step by part, from a torch.profiler trace of
    eager steps on the card: each kernel's launch is matched (by its
    correlation id) to the host op that issued it, and that op's start to
    the step's ranges (`optimizer.forward` / `.backward` / `.adam`,
    record_function ranges in `adam_step`); kernel E (both entries) is
    `bounds`. None where the trace holds no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        TO.adam_loop(prob.loss_fn, prob.flat0, cfg, prob.snap_steps,
                     graph=False)
        torch.cuda.synchronize()
    evs = prof.profiler.kineto_results.events()
    host = {e.correlation_id(): e.start_ns() for e in evs
            if e.device_type() == DeviceType.CPU}
    names = ("optimizer.forward", "optimizer.backward", "optimizer.adam")
    ranges = [(e.start_ns(), e.end_ns(), e.name().split(".", 1)[1])
              for e in evs if e.device_type() == DeviceType.CPU
              and e.name() in names]
    split = dict.fromkeys(("forward", "bounds", "backward", "adam"), 0.0)
    other, n_kernels = {}, 0
    for e in evs:
        # the device-side copies of the step's own ranges are no work
        if e.device_type() != DeviceType.CUDA or e.name() in names:
            continue
        ms = e.duration_ns() / 1e6
        t = host.get(e.linked_correlation_id())
        part = "bounds" if "beta_incinv" in e.name() else next(
            (n for lo, hi, n in ranges if t is not None and lo <= t <= hi),
            None)
        if part is None:
            # device activity no host op of a step issued (not one of
            # the step's kernels: the attributed sum is the graph's)
            other[e.name()] = other.get(e.name(), 0.0) + ms
            continue
        n_kernels += 1
        split[part] += ms
    total = sum(split.values())
    if total <= 0:
        return None
    per_step = {k + "_ms": v / cfg.steps for k, v in split.items()}
    per_step["kernels_per_step"] = n_kernels / cfg.steps
    per_step["device_ms_per_step"] = total / cfg.steps
    per_step["other_device_ms_per_step"] = {
        k: v / cfg.steps for k, v in sorted(
            other.items(), key=lambda kv: -kv[1])[:4]}
    return per_step


def _e_bound_ms(terms) -> float:
    """Kernel E's least time: the longest serial chain of any thread, one
    dependent FMA latency per continued-fraction term it runs (each term
    is a chain of a dozen dependent operations, two of them divisions, so
    this is far below what the chain needs)."""
    return int(terms.max()) * FMA_LATENCY_CYCLES / BOOST_HZ * 1e3


def _e_rows(torch, flush, rec, label, main):
    """Kernel E at one step's shape (the Session's bounds: restarts x 2)
    and at the extraction's: the kernel against its plain version on the
    card and on the CPU (the twin is held over every step's inputs by
    `_e_grid_check`); its time beside the plain version's and the bound.
    No PyTorch call computes betaincinv."""
    from repro_torch.kernels import beta_bounds as BB
    from repro_torch.kernels import ops, ref
    rows = {"beta_incinv": [], "beta_incinv_grad_terms": []}
    shapes = (("step", rec["fwd"][-2], rec["bwd"][-1], main),
              ("extraction", rec["fwd"][-1], None, False))
    # the continued-fraction terms each of E's threads runs, both shapes
    # in one twin call on the CPU
    flat = [torch.cat([sh[1][i].reshape(-1).cpu() for sh in shapes])
            for i in range(3)]
    _, terms = ref.betaincinv_twin(*flat, count=True)
    terms = terms.split([sh[1][0].numel() for sh in shapes])
    for (shape, fwd, bwd, is_main), fwd_terms in zip(shapes, terms):
        a, b, q = (t.contiguous() for t in fwd)
        x = BB.beta_incinv(a, b, q)
        want = ops.beta_incinv(a, b, q, backend="ref")
        cpu = ref.betaincinv_ref(a.cpu(), b.cpu(), q.cpu()).cuda()
        row = dict(kernel="beta_incinv", shape=f"{label}-{shape}",
                   n=a.numel(), max_abs_err=float((x - want).abs().max()),
                   max_abs_err_vs_cpu=float((x - cpu).abs().max()),
                   equal_to_cpu=int((x == cpu).sum()),
                   cf_terms_max=int(fwd_terms.max()),
                   kernel_ms=time_ms(torch, lambda: BB.beta_incinv(a, b, q),
                                     flush),
                   plain_ms=time_ms(torch, lambda: ops.beta_incinv(
                       a, b, q, backend="ref"), flush, iters=5),
                   bound_ms=_e_bound_ms(fwd_terms), bound_by="operations",
                   library_ms=None, main_path_shape=is_main)
        row["ok"] = max(row["max_abs_err"],
                        row["max_abs_err_vs_cpu"]) <= E_TOL["x"]
        rows["beta_incinv"].append(row)
        emit("kernel", **row)
        if not row["ok"]:
            die("planner", f"kernel E at {row['shape']}: {row}")
        if bwd is None:
            continue
        a, b, xb = (t.contiguous() for t in bwd)
        err = _e_terms_check(torch, a, b, xb)
        _, _, bwd_terms = ref.betaincinv_grad_terms_twin(
            a.cpu(), b.cpu(), xb.cpu(), count=True)
        row = dict(kernel="beta_incinv_grad_terms", shape=f"{label}-{shape}",
                   n=a.numel(), max_abs_err=err["fd_err_vs_plain"],
                   max_abs_err_vs_twin=err["fd_err_vs_twin"],
                   max_abs_err_vs_cpu=err["fd_err_vs_cpu"],
                   **{k: v for k, v in err.items()
                      if k.startswith(("grad_", "pdf_"))},
                   cf_terms_max=int(bwd_terms.max()),
                   kernel_ms=time_ms(torch, lambda: BB.beta_incinv_grad_terms(
                       a, b, xb), flush),
                   plain_ms=time_ms(torch, lambda: ops.beta_incinv_grad_terms(
                       a, b, xb, backend="ref"), flush, iters=5),
                   bound_ms=_e_bound_ms(bwd_terms), bound_by="operations",
                   library_ms=None, main_path_shape=is_main, ok=err["ok"])
        rows["beta_incinv_grad_terms"].append(row)
        emit("kernel", **row)
        if not row["ok"]:
            die("planner", f"kernel E's gradient terms at {row['shape']}: "
                           f"{row}")
    return rows


def _grad_err(got, want) -> float:
    """max |got - want| over max |want|, for dI/da and for dI/db: the
    larger."""
    return max(float((got[i] - want[i]).abs().max()
                     / want[i].abs().max().clamp(min=1e-30))
               for i in range(2))


def _e_terms_check(torch, a, b, x) -> dict:
    """E's gradient terms at (a, b, x) against the plain version on the
    card, the twin and the CPU's plain version, and what a kernel that
    dropped the central-difference step (all four terms equal) or swapped
    its signs would read on the gradient measure; ok under E_TOL only if
    the check rejects both."""
    from repro_torch.kernels import beta_bounds as BB
    from repro_torch.kernels import ops, ref
    fd, pdf = BB.beta_incinv_grad_terms(a, b, x)
    want = {"plain": ops.beta_incinv_grad_terms(a, b, x, backend="ref"),
            "twin": ref.betaincinv_grad_terms_twin(a, b, x),
            "cpu": [t.cuda() for t in ref.betaincinv_grad_terms_ref(
                a.cpu(), b.cpu(), x.cpu())]}
    grad = ref.fd_grads(fd, a, b)
    out = {}
    for k, (wfd, wpdf) in want.items():
        out[f"fd_err_vs_{k}"] = float((fd - wfd).abs().max())
        out[f"grad_err_vs_{k}"] = _grad_err(grad, ref.fd_grads(wfd, a, b))
        out[f"pdf_rel_err_vs_{k}"] = float(((pdf - wpdf).abs()
                                            / wpdf.abs()).max())
    plain = ref.fd_grads(want["plain"][0], a, b)
    out["grad_err_zero_step"] = _grad_err(
        ref.fd_grads(fd[[0, 0, 2, 2]], a, b), plain)
    out["grad_err_swapped"] = _grad_err(
        ref.fd_grads(fd[[1, 0, 3, 2]], a, b), plain)
    out["ok"] = (max(out[f"fd_err_vs_{k}"] for k in want) <= E_TOL["fd"]
                 and max(out[f"grad_err_vs_{k}"] for k in want)
                 <= E_TOL["grad"]
                 and max(out[f"pdf_rel_err_vs_{k}"] for k in want)
                 <= E_TOL["pdf"]
                 and min(out["grad_err_zero_step"],
                         out["grad_err_swapped"]) > E_TOL["grad"])
    return out


def _e_grid_check(torch, rec):
    """E over every (a, b, q) the eager card loop gave the bounds and
    every (a, b, x) it gave their gradient (the Session path's real
    inputs), and the root over a, b log-uniform in [0.5, 1e4] at q near
    0, 0.5 and 1, against the plain version (card and CPU) and the
    twin."""
    from repro_torch.kernels import beta_bounds as BB
    from repro_torch.kernels import ops, ref
    a, b, q = (torch.cat([r[i].reshape(-1) for r in rec["fwd"]])
               for i in range(3))
    x = BB.beta_incinv(a, b, q)
    errs = {"real_vs_plain": float((x - ops.beta_incinv(
        a, b, q, backend="ref")).abs().max()),
        "real_vs_twin": float((x - ref.betaincinv_twin(a, b, q))
                              .abs().max()),
        "real_vs_cpu": float((x - ref.betaincinv_ref(
            a.cpu(), b.cpu(), q.cpu()).cuda()).abs().max())}
    gen = torch.Generator().manual_seed(17)
    lo, hi = math.log(0.5), math.log(1e4)
    wa, wb = torch.exp(torch.empty(2, 512).uniform_(lo, hi, generator=gen))
    wide = 0.0
    for qv in (1e-6, 0.05, 0.5, 0.95, 1 - 1e-6):
        wq = torch.full_like(wa, qv)
        got = BB.beta_incinv(wa.cuda(), wb.cuda(), wq.cuda()).cpu()
        wide = max(wide, float((got - ref.betaincinv_ref(wa, wb, wq))
                               .abs().max()))
    errs["wide_vs_cpu"] = wide
    terms = _e_terms_check(torch, *(torch.cat([r[i].reshape(-1)
                                               for r in rec["bwd"]])
                                    for i in range(3)))
    ok = max(errs[k] for k in errs if k != "wide_vs_cpu") <= E_TOL["x"] \
        and wide <= E_TOL_WIDE_X and terms["ok"]
    return dict(real_elements=a.numel(), real_terms=terms,
                real_a_range=[float(a.min()), float(a.max())],
                real_b_range=[float(b.min()), float(b.max())],
                q=sorted(set(q.cpu().tolist())), **errs, ok=ok)


def phase_planner(torch, problems):
    """The planner on the card, over each Session's own optimizer call
    (the profiled sample as the optimizer got it): the CUDA-graph loop
    against an eager loop on the card (bit for bit) and the CPU's eager
    loop (same selections but at 0.5 ties), optimize_s of each in this
    run, the graph's ms per replay, the step's device time by part, and
    kernel E against its plain version and twin over the real inputs and
    a wide grid."""
    import dataclasses
    from repro_torch.core import optimizer as TO
    from repro_torch.kernels import ops
    flush = torch.empty(1 << 30, dtype=torch.uint8, device="cuda")
    e_rows = {"beta_incinv": [], "beta_incinv_grad_terms": []}
    for label, (args, kw) in problems.items():
        cfg = args[4]
        row = dict(steps=cfg.steps, restarts=cfg.restarts)
        plans = {}
        for name, on in (("card_graph", args),
                         ("cpu", (_on_cpu(args[0]),) + tuple(args[1:]))):
            # the card plan's last call to E outside the capture is the
            # extraction's
            rec, restore = _record_e(torch, ops) if name == "card_graph" \
                else (None, lambda: None)
            if rec is not None:
                extraction = rec
            ops.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                plans[name] = TO.optimize_query(*on, **kw)
                torch.cuda.synchronize()
            finally:
                restore()
            row[f"optimize_s_{name}"] = time.perf_counter() - t0
            c = ops.launch_counts()
            row[f"e_launches_{name}"] = [c["beta_incinv"],
                                         c["beta_incinv_grad_terms"]]
        # the graph plan: two warm-up steps, one launch of each entry per
        # replay, and the extraction's bounds
        if row["e_launches_card_graph"] != [cfg.steps + 3, cfg.steps + 2]:
            die("planner", f"{label}: E's launches per graph plan "
                           f"{row['e_launches_card_graph']}, not "
                           f"{[cfg.steps + 3, cfg.steps + 2]}")
        ties, diff = _tie_check(torch, plans["card_graph"], plans["cpu"])
        row.update(selected_card=[s_.tolist() for s_ in
                                  plans["card_graph"].selected],
                   selected_cpu=[s_.tolist() for s_ in plans["cpu"].selected],
                   selections_equal=not diff, differing_picks=diff,
                   recall_bound=[plans[k].recall_bound for k in plans],
                   precision_bound=[plans[k].precision_bound for k in plans],
                   est_cost=[plans[k].est_cost for k in plans])
        if ties is None:
            die("planner", f"{label}: card and CPU select differently away "
                           f"from a 0.5 tie: {diff}")
        # the loop alone: graph replays against the same step eagerly on
        # the card, bit for bit, then the step's split
        prob = TO.setup_problem(*args, **kw)
        loops = {}
        for name, graph in (("graph", True), ("eager", False)):
            rec, restore = (None, lambda: None) if graph \
                else _record_e(torch, ops)
            if rec is not None:
                steps_rec = rec
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                loops[name] = TO.adam_loop(prob.loss_fn, prob.flat0, cfg,
                                           prob.snap_steps, graph=graph)
                torch.cuda.synchronize()
            finally:
                restore()
            row[f"loop_s_{name}"] = time.perf_counter() - t0
        if not _same_run(torch, loops["graph"], loops["eager"]):
            die("planner", f"{label}: the CUDA-graph loop and the eager "
                           f"loop on the card disagree")
        run = loops["graph"]
        row.update(graph_equals_eager_bitwise=True,
                   replays_per_plan=run.replays, capture_s=run.capture_s,
                   graph_ms_per_replay=(row["loop_s_graph"] - run.capture_s)
                   / max(run.replays, 1) * 1e3)
        # the eager loop's inputs to E, and the extraction's (the graph
        # plan's last forward call)
        e_rec = {"fwd": steps_rec["fwd"] + extraction["fwd"][-1:],
                 "bwd": steps_rec["bwd"]}
        short = dataclasses.replace(cfg, steps=10)
        split = _optimizer_split(torch, TO, TO.setup_problem(
            *args[:4], short, **kw), short)
        row["split_per_step"] = split
        row["e_grid"] = _e_grid_check(torch, e_rec)
        if not row["e_grid"]["ok"]:
            die("planner", f"{label}: kernel E over the grid: "
                           f"{row['e_grid']}")
        for name, rs in _e_rows(torch, flush, e_rec, label,
                                main=label == "session_llama8b").items():
            e_rows[name] += rs
        emit("planner", ok=True, path=label, **row)
    del flush
    return e_rows


# ---------------------------------------------------------------------------
# engine pools and the query scheduler
# ---------------------------------------------------------------------------

POOL_ITEMS = 90
AFFINITY = {"fast": 2, "accurate": 2}


def _pool_cfg(root):
    """The reference's two-tier pool (tests/test_pool.py:41-57): a fast
    engine serving the planted "sm" (kv80, kv50) and an accurate one
    serving "lg" (kv50 and the gold, the reference), each with a thread
    affinity of 2 under the session's threads:2 default."""
    from repro_torch.api import EngineSpec, SessionConfig
    from repro_torch.core.optimizer import PlannerConfig
    return SessionConfig(
        engines=(EngineSpec("fast", models=("sm",), sm_ratios=(0.8, 0.5),
                            lg_ratios=(), dispatcher=AFFINITY["fast"],
                            cache_dir=os.path.join(root, "fast")),
                 EngineSpec("accurate", models=("lg",), sm_ratios=(),
                            lg_ratios=(0.5,), include_cheap=False,
                            dispatcher=AFFINITY["accurate"],
                            cache_dir=os.path.join(root, "accurate"))),
        gold_engine="accurate", dispatcher="threads:2",
        planner=PlannerConfig(steps=120, restarts=2, snapshots=2),
        sample_frac=0.35, partition_size=40)


def _cpu_pool(cfg):
    """The pool's engines on the CPU over the stores the card built,
    joined as a backend-mode Session (it builds nothing)."""
    from repro_torch.api import Session
    from repro_torch.runtime.backend import (KVCacheBackend, PoolBackend,
                                             ReferenceBackend)
    engines = {s.name: _cpu_engine(s, s.cache_dir) for s in cfg.engines}
    members = [(s.name, KVCacheBackend(
        engines[s.name], sm=s.sm_model, lg=s.lg_model, sm_ratios=s.sm_ratios,
        lg_ratios=s.lg_ratios, sm_int8=s.sm_int8, lg_int8=s.lg_int8,
        include_cheap=s.include_cheap)) for s in cfg.engines]
    gold = next(s for s in cfg.engines if s.name == cfg.gold_engine)
    return Session(cfg, backend=PoolBackend(members, gold=cfg.gold_engine),
                   reference=ReferenceBackend(engines[gold.name],
                                              lg=gold.lg_model),
                   device="cpu"), engines


def _evict_all(engines):
    for e in engines:
        e.evict()


def _same(a, b) -> bool:
    """Bit-equal decisions and map values of two results."""
    import numpy as np
    return bool(np.array_equal(a.accepted, b.accepted) and set(
        a.map_values) == set(b.map_values) and all(
        np.array_equal(a.map_values[li], b.map_values[li])
        for li in a.map_values))


def _engine_totals_check(phase, result, stores_before, engines):
    """Per-engine totals partition the run exactly, and each engine's
    kv_bytes equal its own CacheStore's counter over the run."""
    per = result.engine_totals()
    deltas = {n: e.store.bytes_loaded - stores_before[n]
              for n, e in engines.items()}
    stats = result.stage_stats
    ok = (sum(d["kv_bytes"] for d in per.values())
          == sum(s.kv_bytes for s in stats)
          and sum(d["n_tuples"] for d in per.values())
          == sum(s.n_tuples for s in stats)
          and sum(d["n_llm_calls"] for d in per.values())
          == result.n_llm_tuples
          and all(per.get(n, {"kv_bytes": 0})["kv_bytes"] == d
                  for n, d in deltas.items())
          and all(s.op_name.startswith(s.engine + "/") for s in stats))
    if not ok:
        die(phase, f"per-engine totals do not partition the run or miss "
                   f"the stores' counters: {per} vs {deltas}")
    return per, deltas


def _placement(phase, plan, gold_engine):
    stages = [(s.op_name, s.engine) for s in plan.stages]
    if not all(op.startswith(eng + "/") for op, eng in stages) or any(
            s.engine != gold_engine for s in plan.stages if s.is_gold):
        die(phase, f"stages not placed on their engines: {stages}")
    return stages


def phase_pool_planted(torch):
    """The reference's two-tier pool on the card: 90 planted items, the
    quickstart query through a multi-engine Session (profiles per engine,
    EXPLAIN with the engine column, execute under the affinity
    dispatcher, metrics against the gold engine); per-engine totals
    against each store; inline, threads:2 and affinity bit-identical; the
    same plan on the CPU equal outside the margin."""
    from repro_torch.api import Session
    from repro_torch.data import synthetic as syn
    from repro_torch.runtime import ThreadPoolDispatcher

    ds = syn.make_dataset("pool", POOL_ITEMS, seed=7)
    cfg = _pool_cfg(os.path.join(WORK, "pool-planted"))
    sess = Session(cfg)
    frame = _frame(sess, ds.items)
    report, result, metrics, counts, times, _ = _drive_session(
        torch, sess, [ds.items], frame)
    emit("session_explain", text=str(report))
    chunks = sum(e.prefill_chunks for e in sess.engines.values())
    if counts["expected_attention_scores"] != chunks:
        die("pool_planted", f"{counts['expected_attention_scores']} launches "
                            f"of C for {chunks} prefill chunks")
    for name in ("decode_query_attention", "prefill_attention"):
        if counts[name] <= 0:
            die("pool_planted", f"the pool path launched no {name}: {counts}")
    plan, query = result.raw.plan, frame.to_query()
    stages = _placement("pool_planted", plan, "accurate")
    if not (all(s.engine for s in report.stages) and "engine" in str(report)):
        die("pool_planted", "EXPLAIN has no engine column")
    disp = sess._default_dispatcher()
    if not (isinstance(disp, ThreadPoolDispatcher)
            and disp.engine_workers == AFFINITY):
        die("pool_planted", f"the session built no affinity dispatcher: "
                            f"{disp}")

    # from a cold device LRU: every engine's kv_bytes against its store
    engines = sess.engines
    _evict_all(engines.values())
    before = {n: e.store.bytes_loaded for n, e in engines.items()}
    inline = frame.execute(dispatcher="inline")
    per, deltas = _engine_totals_check("pool_planted", inline, before,
                                       engines)
    threads = frame.execute(dispatcher="threads:2")
    if not (_same(inline, threads) and _same(inline, result)):
        die("pool_planted", "inline, threads:2 and the affinity dispatcher "
                            "decide differently")

    cpu_sess, cpu_engines = _cpu_pool(cfg)
    cpu = cpu_sess.run(plan, query, ds.items, dispatcher="inline")
    cpu_same, all_same, n_near = _linear_card_vs_cpu(
        "pool_planted", sess, plan, query, ds.items, inline.raw, cpu)
    emit("pool_planted", ok=True, items=len(ds.items), **times,
         stages=stages, engines_used=sorted({e for _, e in stages}),
         feasible=report.feasible, metrics=metrics,
         guarantees_met=metrics["recall"] >= TARGET
         and metrics["precision"] >= TARGET,
         engine_totals=per, store_kv_deltas=deltas,
         inline_threads_affinity_equal=True,
         cpu_equal_outside_margin=cpu_same, cpu_equal_everywhere=all_same,
         n_near_margin=n_near, margin=MARGIN,
         prefill_chunks={n: e.prefill_chunks for n, e in engines.items()},
         launches=counts,
         stage_stats=[s.as_dict() for s in inline.stage_stats])
    cpu_sess.close()
    del cpu_sess, cpu_engines
    return counts, (sess, ds.items, frame, inline)


def _tiles(a, b) -> bool:
    """Equal integer StageStats per stage (a query's share of merged
    flushes against its solo run)."""
    key = lambda s: (s.logical_idx, s.stage, s.op_name)
    ints = lambda r: {key(s): (s.n_tuples, s.n_llm_calls, s.n_batches)
                      for s in r.stage_stats}
    return ints(a) == ints(b)


def _oracle_parity(execute):
    """tests/test_scheduler.py:118-150 on the card: recording operators
    (no engine) under four concurrent queries, each bit-identical to its
    solo run, stats tiling; planned on the card."""
    import threading
    import numpy as np
    from repro_torch.api import Session
    from repro_torch.core.optimizer import PlannerConfig
    from repro_torch.core.physical import PhysicalOperator
    from repro_torch.data import synthetic as syn
    from repro_torch.runtime import OracleBackend
    from repro_torch.scheduler import QueryScheduler

    lock, log = threading.Lock(), []

    class SinFilter(PhysicalOperator):
        uses_llm = True

        def __init__(self, name, is_gold=False):
            self.name, self.is_gold = name, is_gold

        def run_filter(self, items, op):
            idx = np.asarray([it.item_id for it in items], np.float64)
            with lock:
                log.append(len(items))
            return np.asarray(3.0 * np.sin(idx * 12.9898
                                           + op.task_id * 78.233), np.float32)

    ops_ = [SinFilter("cheap"), SinFilter("gold", is_gold=True)]
    sess = Session(backend=OracleBackend(lambda op: ops_),
                   planner=PlannerConfig(steps=40, restarts=1, snapshots=2),
                   sample_frac=0.5)
    ds = syn.make_dataset("sched-par", 90, seed=3)
    frames = [sess.frame(ds.items).sem_filter(f"f{t}", task_id=t)
              .with_guarantees(recall=0.7, precision=0.7)
              for t in (1, 1, 2, 1)]
    solo = [f.execute() for f in frames]
    for f in frames:
        f.plan()
    with QueryScheduler(sess, max_concurrent=4, paused=True,
                        execute=execute) as sched:
        hs = [sched.submit(f) for f in frames]
        sched.resume()
        got = [h.result(timeout=300) for h in hs]
        stats = sched.stats()
    sess.close()
    ok = all(_same(r, s) and _tiles(r, s) for r, s in zip(got, solo)) \
        and stats["n_flushes"] >= stats["n_calls"] > 0
    return ok, {k: stats[k] for k in ("n_calls", "n_flushes",
                                      "n_merged_calls")}


def _scheduled(torch, sess, submissions, max_concurrent):
    """One paused scheduler over `submissions` [(frame, plan or None)],
    resumed at once; returns (results, stats, seconds)."""
    from repro_torch.scheduler import QueryScheduler
    t0 = time.perf_counter()
    with QueryScheduler(sess, max_concurrent=max_concurrent,
                        paused=True) as sched:
        hs = [sched.submit(f, plan=p) for f, p in submissions]
        sched.resume()
        results = [h.result(timeout=900) for h in hs]
        stats = sched.stats()
    torch.cuda.synchronize()
    return results, stats, time.perf_counter() - t0


def _merge_checks(phase, results, solos, stats, loaded):
    """Every query bit-equal to its solo run, its integer StageStats
    equal to the solo run's, the per-query kv_bytes tiling the loads the
    merged calls made, flushes merged, and the EXPLAIN ANALYZE footer."""
    if not all(_same(r, s) for r, s in zip(results, solos)):
        die(phase, "a scheduled query decides differently from its solo run")
    if not all(_tiles(r, s) for r, s in zip(results, solos)):
        die(phase, "a scheduled query's StageStats differ from its solo run")
    kv = sum(s.kv_bytes for r in results for s in r.stage_stats)
    if kv != loaded:
        die(phase, f"per-query kv_bytes {kv} do not tile the stores' loads "
                   f"{loaded}")
    if not stats["n_calls"] < stats["n_flushes"]:
        die(phase, f"the hub merged no flushes: {stats}")
    text = results[0].explain_analyze().render()
    if "scheduler: tenant=default (standard)" not in text:
        die(phase, "EXPLAIN ANALYZE has no scheduler footer")
    return kv, text


def _a_launches(c) -> int:
    return c["decode_query_attention"] + c["decode_query_attention_int8"]


def phase_scheduler_planted(torch, kept):
    """QueryScheduler(max_concurrent=3, paused) over the planted pool:
    three copies of the quickstart query, against its solo run; then the
    oracle world's parity under inline and threads:2."""
    from repro_torch.kernels import ops
    sess, items, frame, solo = kept
    engines = list(sess.engines.values())
    _evict_all(engines)
    before = sum(e.store.bytes_loaded for e in engines)
    ops.reset_launch_counts()
    results, stats, wall = _scheduled(torch, sess, [(frame, None)] * 3, 3)
    counts = ops.launch_counts()
    loaded = sum(e.store.bytes_loaded for e in engines) - before
    kv, text = _merge_checks("scheduler_planted", results, [solo] * 3,
                             stats, loaded)
    if _a_launches(counts) <= 0:
        die("scheduler_planted", f"no launch of A: {counts}")
    oracle = {}
    for execute in ("inline", "threads:2"):
        ok, st = _oracle_parity(execute)
        if not ok:
            die("scheduler_planted", f"oracle world under {execute}: a query "
                                     f"differs from its solo run: {st}")
        oracle[execute] = st
    emit("scheduler_planted", ok=True, queries=3, items=len(items),
         wall_s=wall, stats=stats,
         sched=[r.sched.as_dict() for r in results], kv_bytes=kv,
         a_launches=_a_launches(counts), launches=counts,
         footer=[ln for ln in text.splitlines() if "scheduler" in ln
                 or "shared_batches" in ln], oracle_parity=oracle)
    return counts


POOL_8B = {"compressed": dict(lg_ratios=(0.5,), lg_int8=(0.5,),
                              build=(0.5,)),
           "gold": dict(lg_ratios=(0.8,), lg_int8=(), build=(0.8, 0.0))}


def _weights_bytes(params) -> int:
    if isinstance(params, dict):
        return sum(_weights_bytes(v) for v in params.values())
    return params.numel() * params.element_size()


def phase_pool_llama8b(torch, params):
    """Two ServingEngines on the card, "compressed" (lg 0.5, int8 0.5)
    and "gold" (lg 0.8, gold), each with its own CacheStore and memory
    budget (device LRU off: every flush loads, so the stores' counters
    account for each query exactly), both registering stretto-llama-8b as
    "lg" with the same params tensors (the weights once), joined as
    Session(cfg, backend=PoolBackend(...), reference=ReferenceBackend(gold
    engine)); the quickstart query over the 8B Session's corpus."""
    from repro_torch.api import Session, SessionConfig
    from repro_torch.cache.store import CacheStore
    from repro_torch.configs.stretto_llama_8b import CONFIG as cfg8
    from repro_torch.core.optimizer import PlannerConfig
    from repro_torch.data import synthetic as syn
    from repro_torch.kernels import ops
    from repro_torch.runtime.backend import (KVCacheBackend, PoolBackend,
                                             ReferenceBackend)
    from repro_torch.serving.engine import ServingEngine

    ds = syn.make_dataset("llama8b-session", SESSION_8B_ITEMS,
                          seq_len=SESSION_8B_LEN, seed=6)
    weights_gb = _weights_bytes(params) / 1e9
    torch.cuda.reset_peak_memory_stats()
    timer = _PlanTimer()
    ops.reset_launch_counts()
    try:
        engines, build_s, members = {}, {}, []
        for name, rung in POOL_8B.items():
            eng = ServingEngine(
                CacheStore(os.path.join(WORK, f"pool-8b-{name}")),
                memory_budget_bytes=2e9, device_cache=False, device="cuda")
            eng.register_model("lg", cfg8, params)
            t0 = time.perf_counter()
            eng.build_profiles("lg", ds.items, ratios=rung["build"],
                               prefill_batch=4, quant_ratios=rung["lg_int8"])
            torch.cuda.synchronize()
            build_s[name] = time.perf_counter() - t0
            engines[name] = eng
            members.append((name, KVCacheBackend(
                eng, sm="lg", lg="lg", sm_ratios=(),
                lg_ratios=rung["lg_ratios"], lg_int8=rung["lg_int8"],
                include_cheap=False)))
        sess = Session(SessionConfig(planner=PlannerConfig(steps=200,
                                                           restarts=3)),
                       backend=PoolBackend(members, gold="gold"),
                       reference=ReferenceBackend(engines["gold"], lg="lg"))
        frame = _frame(sess, ds.items)
        t1 = time.perf_counter()
        report = frame.explain()
        t2 = time.perf_counter()
        result = frame.execute()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        counts = ops.launch_counts()
    finally:
        timer.close()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    emit("session_explain", text=str(report))
    chunks = sum(e.prefill_chunks for e in engines.values())
    if counts["expected_attention_scores"] != chunks:
        die("pool_llama8b", f"{counts['expected_attention_scores']} launches "
                            f"of C for {chunks} prefill chunks")
    for name in ("decode_query_attention", "prefill_attention"):
        if counts[name] <= 0:
            die("pool_llama8b", f"the 8B pool launched no {name}: {counts}")
    if engines["compressed"].models["lg"].params is not \
            engines["gold"].models["lg"].params or peak_gb >= 2 * weights_gb:
        die("pool_llama8b", f"the weights are held twice: peak {peak_gb} GB "
                            f"for {weights_gb} GB of weights")
    plan = result.raw.plan
    stages = _placement("pool_llama8b", plan, "gold")
    if result.accepted.shape != (len(ds.items),):
        die("pool_llama8b", "result has the wrong shape")

    # the solo run the scheduler is held to, from a cold LRU: per-engine
    # totals against each store, and A's launches of one execution
    _evict_all(engines.values())
    before = {n: e.store.bytes_loaded for n, e in engines.items()}
    ops.reset_launch_counts()
    solo = frame.execute(dispatcher="inline")
    solo_counts = ops.launch_counts()
    per, deltas = _engine_totals_check("pool_llama8b", solo, before, engines)
    if not _same(solo, result):
        die("pool_llama8b", "inline and the default dispatcher differ")
    metrics = result.metrics()
    emit("pool_llama8b", ok=True, items=len(ds.items),
         item_tokens=SESSION_8B_LEN, build_s=build_s,
         plan_s=t2 - t1, **timer.s, execute_s=t3 - t2,
         items_per_s=len(ds.items) / max(t3 - t2, 1e-9),
         stages=stages, engines_used=sorted({e for _, e in stages}),
         feasible=report.feasible, metrics=metrics, engine_totals=per,
         store_kv_deltas=deltas, weights_gb=weights_gb, peak_mem_gb=peak_gb,
         prefill_chunks={n: e.prefill_chunks for n, e in engines.items()},
         launches=counts, solo_a_launches=_a_launches(solo_counts),
         stage_stats=[s.as_dict() for s in solo.stage_stats])
    return counts, (sess, ds.items, frame, solo, solo_counts, engines)


def phase_scheduler_llama8b(torch, kept):
    """The scheduler over the 8B pool: three copies of the quickstart
    query (planned already) and one sem_filter on task 2, submitted
    paused, so the filter's query thread plans (captures the optimizer's CUDA
    graph) while the copies flush. Each query against its solo run, the
    hub's merge counters, A's launches against the solo runs' sum
    (executions, and the filter's planning again outside the memo), and
    E's launches for the one plan made (203 / 202)."""
    from repro_torch.core.planner import plan_query
    from repro_torch.kernels import ops
    from repro_torch.runtime.dispatch import DEFAULT_COALESCE
    sess, items, frame, solo, solo_counts, engines = kept
    filt = (sess.frame(items).sem_filter("mentions topic 2", task_id=2)
            .with_guarantees(recall=TARGET, precision=TARGET))
    plan = frame.plan()
    _evict_all(engines.values())
    before = sum(e.store.bytes_loaded for e in engines.values())
    ops.reset_launch_counts()
    results, stats, wall = _scheduled(
        torch, sess, [(frame, plan)] * 3 + [(filt, None)], 4)
    counts = ops.launch_counts()
    loaded = sum(e.store.bytes_loaded for e in engines.values()) - before
    cfg = sess.config.planner
    e_plan = [counts["beta_incinv"], counts["beta_incinv_grad_terms"]]
    if e_plan != [cfg.steps + 3, cfg.steps + 2]:
        die("scheduler_llama8b", f"E's launches for the one plan made: "
                                 f"{e_plan}, not "
                                 f"{[cfg.steps + 3, cfg.steps + 2]}")

    # the filter's solo run (its plan is the one its query thread made), from a
    # cold LRU, and its planning's launches again, outside the memo
    fplan, fquery = filt.plan(), filt.to_query()
    _evict_all(engines.values())
    ops.reset_launch_counts()
    fsolo = sess.run(fplan, fquery, items, dispatcher="inline")
    f_counts = ops.launch_counts()
    _evict_all(engines.values())
    p_before = sum(e.store.bytes_loaded for e in engines.values())
    ops.reset_launch_counts()
    c = sess.config
    plan_query(fquery, items, sess.backend, cfg, sample_frac=c.sample_frac,
               seed=c.seed, reorder=c.reorder, coalesce=DEFAULT_COALESCE,
               device=sess.device)
    torch.cuda.synchronize()
    p_counts = ops.launch_counts()
    # with the device LRU off every flush and every profiling call loads,
    # so the queries' kv_bytes tile what the stores loaded less the
    # filter's profiling loads
    p_loaded = sum(e.store.bytes_loaded for e in engines.values()) - p_before
    kv, text = _merge_checks("scheduler_llama8b", results,
                             [solo] * 3 + [fsolo], stats, loaded - p_loaded)
    sched_a = _a_launches(counts)
    solo_a = 3 * _a_launches(solo_counts) + _a_launches(f_counts) \
        + _a_launches(p_counts)
    if not sched_a < solo_a:
        die("scheduler_llama8b", f"A's launches under the scheduler "
                                 f"{sched_a} not below the solo runs' "
                                 f"{solo_a}")
    emit("scheduler_llama8b", ok=True, queries=4, items=len(items),
         item_tokens=SESSION_8B_LEN, wall_s=wall, stats=stats,
         sched=[r.sched.as_dict() for r in results], kv_bytes=kv,
         a_launches_scheduler=sched_a, a_launches_solo_sum=solo_a,
         a_launches_filter_planning=_a_launches(p_counts),
         e_launches_per_plan=e_plan,
         filter_stages=[(s.op_name, s.engine) for s in fplan.stages],
         launches=counts)
    return counts


def _dense_ms(torch, params, cfg, rows, reps=5) -> float:
    """Device ms of one decode flush's dense layers at `rows` rows (every
    layer's q/k/v/o projections and SwiGLU, then the head), CUDA events,
    median of `reps`; the 16 GB of weights keep L2 cold on their own."""
    import statistics
    from repro_torch.models.transformer import _head
    lay = params["layers"]
    a, m = lay["attn"], lay["mlp"]
    x = torch.randn(rows, cfg.d_model, device="cuda").to(params["embed"].dtype)
    o = torch.randn(rows, cfg.n_heads * cfg.d_head,
                    device="cuda").to(x.dtype)
    head = _head(params, cfg)

    def run():
        for i in range(cfg.n_layers):
            x @ a["wq"][i], x @ a["wk"][i], x @ a["wv"][i], o @ a["wo"][i]
            ((x @ m["w_gate"][i]) * (x @ m["w_up"][i])) @ m["w_down"][i]
        x @ head
    run()
    times = []
    for _ in range(reps):
        s_, e_ = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s_.record()
        run()
        e_.record()
        torch.cuda.synchronize()
        times.append(s_.elapsed_time(e_))
    return statistics.median(times)


def _pin_cost_ms(torch, eng, ids, sizes=(8, 32), reps=5):
    """The pin's cost at 8B, per flush size n, unpinned against pinned,
    in turns (off, on, on, off): the host ms of one warm flush (device LRU
    hit, so decode only; median each), and the device ms of its dense
    layers at n rows against the pinned rows."""
    import statistics
    from repro_torch.data import synthetic as syn
    em = eng.models["lg"]
    out, lru = {}, eng.device_cache
    eng.device_cache = True
    for n in sizes:
        times = {False: [], True: []}
        for pin in (False, True, True, False):
            eng.pin_rows = pin
            for _ in range(reps):
                t0 = time.perf_counter()
                eng.run_filter("lg", 0.5, ids[:n], [syn.filter_query_token(1)],
                               syn.TOK_YES, syn.TOK_NO)
                times[pin].append((time.perf_counter() - t0) * 1e3)
        eng.pin_rows = True
        dense = {}
        for rows in (n, eng.max_batch, eng.max_batch, n):
            dense.setdefault(rows, []).append(
                _dense_ms(torch, em.params, em.cfg, rows))
        out[n] = {"flush_unpinned_ms": statistics.median(times[False]),
                  "flush_pinned_ms": statistics.median(times[True]),
                  "dense_unpinned_ms": min(dense[n]),
                  "dense_pinned_ms": min(dense[eng.max_batch])}
    eng.device_cache = lru
    eng.evict()
    return out


def phase_flush_invariance(torch, planted, llama):
    """Does an item's flush output depend on its batch? Per rung (planted
    float32 sm / lg at 0.5 and the lg gold, 8B bfloat16 at 0.5, int8 0.5
    and the gold), flush_invariance (serving/engine.py): the item alone
    against flushes of 2, 4, ... up to the profile's batch, first and
    last, with the engines' pinned row count and without it. Fails unless
    every pinned size is bit-equal. Then the pin's cost on a warm 8B
    flush. Measurement only: no path, so no launch counts."""
    from repro_torch.data import synthetic as syn
    from repro_torch.serving.engine import flush_invariance
    psess, pitems = planted[0], planted[1]
    lsess, litems, engines8 = llama[0], llama[1], llama[5]
    rungs = [("planted sm kv50 float32", psess.engines["fast"], "sm", 0.5,
              False, pitems),
             ("planted lg kv50 float32", psess.engines["accurate"], "lg",
              0.5, False, pitems),
             ("planted lg gold float32", psess.engines["accurate"], "lg", 0.0,
              False, pitems),
             ("8B lg kv50 bfloat16", engines8["compressed"], "lg", 0.5,
              False, litems),
             ("8B lg kv50 int8", engines8["compressed"], "lg", 0.5, True,
              litems),
             ("8B lg gold bfloat16", engines8["gold"], "lg", 0.0, False,
              litems)]
    rows = []
    for label, eng, model, ratio, quant, items in rungs:
        ids = [it.item_id for it in items]
        row = {"rung": label}
        for pin in (True, False):
            eng.pin_rows = pin
            try:
                got = flush_invariance(
                    eng, model, ratio, ids[0], ids[1:],
                    filter_args=([syn.filter_query_token(1)], syn.TOK_YES,
                                 syn.TOK_NO),
                    map_args=([syn.map_query_token(2)],
                              [syn.value_token(v) for v in range(8)]),
                    quant=quant)
            finally:
                eng.pin_rows = True
            row["pinned" if pin else "unpinned"] = {
                str(n): ok for n, ok in got.items()}
        rows.append(row)
        if not all(row["pinned"].values()):
            die("flush_invariance", f"{label}: an item's flush output "
                                    f"depends on its batch: {row}")
    ids8 = [it.item_id for it in litems]
    cost = _pin_cost_ms(torch, engines8["compressed"], ids8)
    emit("flush_invariance", ok=True, rungs=rows,
         pinned_rows={"planted": psess.engines["fast"].max_batch,
                      "8B": engines8["compressed"].max_batch},
         pin_cost_8b_flush=cost)


# ---------------------------------------------------------------------------
# remote engine members and the launchers
# ---------------------------------------------------------------------------

# the worker's identity for the planted "fast" tier: the pool's local
# "fast" spec (_pool_cfg) with its defaults, so scores are bit-equal
FAST_WORKER = dict(models=("sm",), sm_ratios=(0.8, 0.5), lg_ratios=())
# a hand-set plan over the planted pool (tests/test_torch_remote.py): the
# first stages on "fast", gold on "accurate"; whichever stages a planner
# keeps rests on measured times (on the card it has kept gold only)
REMOTE_STAGES = [(0, 0, "fast/sm-kv80", 2.5, -3.0, False, False, "fast"),
                 (1, 0, "fast/sm-kv50", 1.5, -math.inf, True, False, "fast"),
                 (0, 1, "accurate/lg-kv50", 3.0, -4.0, False, False,
                  "accurate"),
                 (0, 2, "accurate/lg-kv00", 0.0, 0.0, False, True,
                  "accurate"),
                 (1, 1, "accurate/lg-kv00", 0.0, 0.0, True, True,
                  "accurate")]


def _plan_of(stages):
    from repro_torch.core.physical import PhysicalPlan, PhysicalPlanStage
    return PhysicalPlan(
        [PhysicalPlanStage(li, st, op, hi, lo, is_map, gold, 0.1, engine=eng)
         for li, st, op, hi, lo, is_map, gold, eng in stages],
        [], 0.0, 1.0, 1.0, True)


def _int_stats(r):
    """Integer StageStats per stage: engine, tuples, LLM calls, batches,
    kv_bytes."""
    return {(s.logical_idx, s.stage, s.op_name):
            (s.engine, s.n_tuples, s.n_llm_calls, s.n_batches, s.kv_bytes)
            for s in r.stage_stats}


DISPATCHERS = ("inline", "threads:2")


def _local_runs(plan, query, items, local, engines_l):
    """The plan run by the all-local pool under each dispatcher, each from
    a cold LRU: the reference that _remote_parity holds the remote pool
    to, run outside the remote path's launch-count window."""
    runs = {}
    for dispatcher in DISPATCHERS:
        _evict_all(engines_l)
        runs[dispatcher] = local.run(plan, query, items,
                                     dispatcher=dispatcher)
    return runs


def _remote_parity(phase, plan, query, items, want, remote, engines_r,
                   flushes):
    """The plan run by the pool with a remote member under each
    dispatcher, each from a cold LRU, against the all-local runs `want`
    (_local_runs): bit-equal decisions, map values and integer StageStats,
    wire calls > 0, no fallback and no error. Returns the remote runs and
    the wire flushes (_wire_timer's `flushes`) each made, by dispatcher."""
    runs, by_dispatcher = {}, {}
    for dispatcher in DISPATCHERS:
        _evict_all(engines_r)
        n0 = len(flushes)
        rr = remote.run(plan, query, items, dispatcher=dispatcher)
        by_dispatcher[dispatcher] = flushes[n0:]
        lr = want[dispatcher]
        if not _same(rr, lr):
            die(phase, f"{dispatcher}: the remote pool decides differently "
                       f"from the all-local pool")
        if _int_stats(rr) != _int_stats(lr):
            die(phase, f"{dispatcher}: integer StageStats differ: "
                       f"{_int_stats(rr)} vs {_int_stats(lr)}")
        _wire_ok(phase, rr.remote)
        runs[dispatcher] = rr
    return runs, by_dispatcher


def _wire_ok(phase, info):
    if not info or info["calls"] <= 0 or info["fallbacks"] \
            or info["errors"]:
        die(phase, f"wire telemetry shows no call, a fallback or an "
                   f"error: {info}")


def _wire_copies(torch, phase, sess, frame, plan, solo, member, engines):
    """Three copies of `plan` through a paused QueryScheduler, from a cold
    LRU: _merge_checks against the solo run, and fewer wire calls than
    three solo runs make."""
    _evict_all(engines)
    b0 = sum(e.store.bytes_loaded for e in engines)
    c0 = member.snapshot()["calls"]
    results, stats, wall = _scheduled(torch, sess, [(frame, plan)] * 3, 3)
    calls = member.snapshot()["calls"] - c0
    loaded = sum(e.store.bytes_loaded for e in engines) - b0
    kv, _ = _merge_checks(phase, results, [solo] * 3, stats, loaded)
    if not calls < 3 * solo.remote["calls"]:
        die(phase, f"{calls} wire calls for three copies, "
                   f"{solo.remote['calls']} solo")
    return dict(wall_s=wall, wire_calls=calls,
                solo_wire_calls=solo.remote["calls"], kv_bytes=kv,
                **{k: stats[k] for k in ("n_calls", "n_flushes",
                                         "n_merged_calls")})


def _wire_timer(member):
    """Record each scoring call of `member`: (client wall, the worker's
    server_wall_s) in seconds; their difference is the wire's share.
    Returns the list and a function that puts the member's call back."""
    flushes, real = [], member._call

    def timed(msg, **kw):
        t0 = time.perf_counter()
        resp = real(msg, **kw)
        if msg["verb"] in ("score_filter", "run_map"):
            flushes.append((time.perf_counter() - t0,
                            resp["stats"]["server_wall_s"]))
        return resp
    member._call = timed
    return flushes, lambda: setattr(member, "_call", real)


def _wire_share(flushes):
    """Each flush's client and worker ms, and the wire's share of the
    client wall over them all. The worker times a call once it holds its
    one-call lock, so a flush that queued behind another's call (threads:2)
    counts its wait as wire."""
    return {"flush_ms_client_worker": [(1e3 * c, 1e3 * w)
                                       for c, w in flushes],
            "wire_share": sum(c - w for c, w in flushes)
            / max(sum(c for c, _ in flushes), 1e-12)}


def _check_path(phase, counts, chunks, names):
    if counts["expected_attention_scores"] != chunks:
        die(phase, f"{counts['expected_attention_scores']} launches of C "
                   f"for {chunks} prefill chunks")
    for name in names:
        if counts[name] <= 0:
            die(phase, f"the path launched no {name}: {counts}")


def phase_remote_planted(torch, planted):
    """The reference's remote world (tests/test_remote.py:230-270) on the
    card: an in-process worker serving the planted "fast" tier on
    127.0.0.1, joined by a Session whose "accurate" engine (lg kv50 and
    the gold) is local. Held to pool_planted's all-local Session: the
    catalog (names, gold flags, costs), every fast operator's scores, and
    a hand-set plan (inline, threads:2, and three scheduled copies)
    bit-equal; the EXPLAIN ANALYZE footer; the Session planning the
    quickstart query over the wire; the plan on the CPU equal outside
    the margin."""
    from dataclasses import replace
    import numpy as np
    from repro_torch.api import EngineSpec, Session, SessionConfig
    from repro_torch.api.result import QueryResult
    from repro_torch.core.logical import SemMap
    from repro_torch.core.optimizer import PlannerConfig
    from repro_torch.kernels import ops
    from repro_torch.remote import RemoteWorker, remote_members, start_server

    local, items, lframe, _ = planted
    query = lframe.to_query()
    plan = _plan_of(REMOTE_STAGES)
    root = os.path.join(WORK, "remote-planted")

    # the all-local pool's side of every comparison, before the remote
    # path's launch-count window opens: the catalog, every fast
    # operator's scores item by item, the hand plan by dispatcher
    local_ops = []
    for op in query.semantic_ops:
        lc = local.backend.candidates(op)
        fast = {}
        for c in lc:
            if c.name.startswith("fast/"):
                fast[c.name] = (local.backend.run_map(op, c.name, items)
                                if isinstance(op, SemMap) else
                                local.backend.score_filter(op, c.name, items))
        local_ops.append((op, [(c.name, c.is_gold, c.cost_model())
                               for c in lc], fast))
    engines_l = list(local.engines.values())
    want = _local_runs(plan, query, items, local, engines_l)
    torch.cuda.synchronize()

    ops.reset_launch_counts()
    worker = RemoteWorker("fast", cache_dir=os.path.join(root, "worker"),
                          **FAST_WORKER)
    server, _, addr = start_server(worker)
    accurate = next(s for s in local.engine_specs if s.name == "accurate")
    remote = Session(SessionConfig(
        engines=(EngineSpec("fast", address=addr),
                 replace(accurate, dispatcher=None,
                         cache_dir=os.path.join(root, "accurate"))),
        gold_engine="accurate",
        planner=PlannerConfig(steps=120, restarts=2, snapshots=2),
        sample_frac=0.35, partition_size=40))
    try:
        t0 = time.perf_counter()
        remote.prepare(items)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        member = remote_members(remote.backend)[0]
        engines_r = [worker.engine, *remote.engines.values()]
        if set(remote.engines) != {"accurate"}:
            die("remote_planted", f"the Session built a local engine for "
                                  f"the remote spec: {set(remote.engines)}")

        # the catalog and every fast operator, item by item
        n_ops = 0
        for op, catalog, fast in local_ops:
            rc = remote.backend.candidates(op)
            if [(c.name, c.is_gold, c.cost_model()) for c in rc] != catalog:
                die("remote_planted", f"the catalog differs from the local "
                                      f"candidates for {op}")
            for name, got in fast.items():
                if isinstance(op, SemMap):
                    same = all(np.array_equal(a, b) for a, b in zip(
                        remote.backend.run_map(op, name, items), got))
                else:
                    same = np.array_equal(
                        remote.backend.score_filter(op, name, items), got)
                if not same:
                    die("remote_planted", f"{name} scores differ over "
                                          f"the wire")
                n_ops += 1

        flushes, restore = _wire_timer(member)
        try:
            runs, hand_flushes = _remote_parity(
                "remote_planted", plan, query, items, want, remote,
                engines_r, flushes)
        finally:
            restore()
        inline = runs["inline"]
        text = QueryResult(remote, query, items, inline) \
            .explain_analyze().render()
        if "remote: calls=" not in text or "remote fast: calls=" not in text:
            die("remote_planted", "EXPLAIN ANALYZE has no remote footer")
        frame = _frame(remote, items)
        sched = _wire_copies(torch, "remote_planted", remote, frame, plan,
                             inline, member, engines_r)

        # the Session plans the quickstart query over the wire (its
        # profiling scores the remote operators; the optimizer runs E)
        t0 = time.perf_counter()
        report = frame.explain()
        plan_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        counts = ops.launch_counts()

        cpu_sess, _ = _cpu_pool(_pool_cfg(os.path.join(WORK,
                                                       "pool-planted")))
        cpu = cpu_sess.run(plan, query, items, dispatcher="inline")
        cpu_same, all_same, n_near = _linear_card_vs_cpu(
            "remote_planted", remote, plan, query, items, inline, cpu)
        cpu_sess.close()
        stats = member.worker_stats()
    finally:
        remote.close()
        server.shutdown()
        server.server_close()
    _check_path("remote_planted", counts, sum(
        e.prefill_chunks for e in engines_r), (
        "decode_query_attention", "prefill_attention", "beta_incinv"))
    if worker.engine.attn_dispatches <= 0:
        die("remote_planted", "the worker's engine dispatched no decode "
                              "attention")
    emit("remote_planted", ok=True, items=len(items), address=addr,
         build_s=build_s, worker_build_steps_s=worker.engine.build_seconds,
         fast_ops_bit_equal=n_ops, inline_threads_bit_equal=True,
         remote=inline.remote,
         hand_wire={d: _wire_share(f) for d, f in hand_flushes.items()},
         scheduler=sched, plan_s=plan_s,
         planned_stages=[(s.op_name, s.engine) for s in report.stages],
         footer=[ln for ln in text.splitlines() if "remote" in ln],
         cpu_equal_outside_margin=cpu_same, cpu_equal_everywhere=all_same,
         n_near_margin=n_near, margin=MARGIN, worker_stats=stats,
         prefill_chunks={"worker": worker.engine.prefill_chunks,
                         "accurate": remote.engines[
                             "accurate"].prefill_chunks},
         launches=counts,
         stage_stats=[s.as_dict() for s in inline.stage_stats])
    return counts, inline


def phase_remote_worker_cli(torch, planted, want):
    """`python -m repro_torch.launch.remote_worker` as a subprocess on the
    card (remote/testing.spawn_worker): its DEVICE line must name CUDA;
    the hand-set plan through it bit-equal to remote_planted's; then the
    worker is SIGKILLed mid-run: on_unavailable="fallback" completes on
    the gold engine with fallbacks > 0, "fail" raises RemoteEngineError
    and the Session still runs gold. The worker's launches are its own
    (its `stats` verb reports attn_dispatches); none reach the kernels
    line."""
    import signal
    from dataclasses import replace
    from repro_torch.api import EngineSpec, Session, SessionConfig
    from repro_torch.remote import RemoteEngineError, remote_members
    from repro_torch.remote.testing import spawn_worker
    from repro_torch.runtime import gold_plan_for

    local, items, lframe, _ = planted
    query = lframe.to_query()
    plan = _plan_of(REMOTE_STAGES)
    accurate = next(s for s in local.engine_specs if s.name == "accurate")
    root = os.path.join(WORK, "remote-cli")
    t0 = time.perf_counter()
    proc, addr = spawn_worker(timeout_s=300, name="fast", extra=(
        "--cache-dir", os.path.join(root, "worker")), **FAST_WORKER)
    start_s = time.perf_counter() - t0

    def session(tag, **kw):
        return Session(SessionConfig(
            engines=(EngineSpec("fast", address=addr, **kw),
                     replace(accurate, dispatcher=None,
                             cache_dir=os.path.join(root, tag))),
            gold_engine="accurate", partition_size=40))

    fb, fail = session("fb", remote_retries=1, on_unavailable="fallback"), \
        session("ff", remote_retries=0, on_unavailable="fail")
    try:
        if not str(proc.device).startswith("cuda"):
            die("remote_worker_cli", f"the worker runs on {proc.device}")
        t0 = time.perf_counter()
        for sess in (fb, fail):
            sess.prepare(items)
            for op in query.semantic_ops:
                sess.backend.candidates(op)
        sync_s = time.perf_counter() - t0
        same = fb.run(plan, query, items, dispatcher="inline")
        if not (_same(same, want) and _tiles(same, want)):
            die("remote_worker_cli", "the subprocess worker decides "
                                     "differently from remote_planted")
        _wire_ok("remote_worker_cli", same.remote)
        member = remote_members(fb.backend)[0]
        stats = member.worker_stats()

        gen = fb.iter_run(plan, query, items, partition_size=30, coalesce=1,
                          dispatcher="inline")
        next(gen)                               # partition 1 over the wire
        os.kill(proc.pid, signal.SIGKILL)
        proc.wait(timeout=30)
        result = None
        try:
            while True:
                next(gen)
        except StopIteration as stop:
            result = stop.value
        snap = member.snapshot()
        if result is None or result.accepted.shape != (len(items),) \
                or snap["fallbacks"] <= 0:
            die("remote_worker_cli", f"the run did not complete on the "
                                     f"gold fallback: {snap}")
        try:
            fail.run(plan, query, items, dispatcher="inline")
            die("remote_worker_cli", "on_unavailable='fail' did not raise")
        except RemoteEngineError as exc:
            if not exc.transport:
                die("remote_worker_cli", f"not a transport error: {exc}")
            raised = str(exc)
        gold = fail.run(gold_plan_for(query, fail.backend), query, items,
                        dispatcher="inline")
        if gold.remote is not None or gold.accepted.shape != (len(items),):
            die("remote_worker_cli", "the Session does not run gold after "
                                     "the failure")
    finally:
        proc.kill()
        fb.close()
        fail.close()
    emit("remote_worker_cli", ok=True, device=proc.device, address=addr,
         start_s=start_s, sync_s=sync_s, bit_equal_remote_planted=True,
         remote=same.remote, worker_stats=stats,
         fallback=dict(fallbacks=snap["fallbacks"],
                       retries=snap["retries"], errors=snap["errors"]),
         fail_raised=raised[:200])


def _worker_8b_class():
    """A RemoteWorker serving stretto-llama-8b from given params tensors
    (the weights once), ladder and device LRU as pool_llama8b's
    "compressed" engine."""
    from repro_torch.configs.stretto_llama_8b import CONFIG as cfg8
    from repro_torch.remote import RemoteWorker

    class Llama8bWorker(RemoteWorker):
        def __init__(self, params, build, **kw):
            self._params, self._build = params, build
            super().__init__(**kw)
            self.engine.device_cache = False

        def register_models(self):
            self.engine.register_model("lg", cfg8, self._params)

        def _ladder(self):
            return list(self._build)
    return Llama8bWorker


def _hand_8b_plan(member, items, filt, mapper):
    """The hand-set 8B plan: the filter's first stage on the remote
    tier's int8 0.5 rung, then its bf16 0.5 rung, then gold; the map's on
    the bf16 0.5 rung, then gold. Random weights put the log-odds
    anywhere, so each threshold is a quantile of its stage's scores over
    the corpus: about a third of the tuples decide at each early stage."""
    import numpy as np
    i8 = member.score_filter(filt, "lg-kv50i8", items)
    bf = member.score_filter(filt, "lg-kv50", items)
    _, conf = member.run_map(mapper, "lg-kv50", items)
    q = lambda s, p: float(np.quantile(s, p))
    return _plan_of(
        [(0, 0, "compressed/lg-kv50i8", q(i8, 5 / 6), q(i8, 1 / 6), False,
          False, "compressed"),
         (0, 1, "compressed/lg-kv50", q(bf, 3 / 4), q(bf, 1 / 4), False,
          False, "compressed"),
         (0, 2, "gold/lg-kv00", 0.0, 0.0, False, True, "gold"),
         (1, 0, "compressed/lg-kv50", q(conf, 1 / 2), -math.inf, True,
          False, "compressed"),
         (1, 1, "gold/lg-kv00", 0.0, 0.0, True, True, "gold")])


def phase_remote_llama8b(torch, params, llama):
    """pool_llama8b's pool with its "compressed" tier (lg 0.5, int8 0.5)
    served by an in-process worker on 127.0.0.1, registering
    stretto-llama-8b from the same params tensors; "gold" (0.8, gold) is
    pool_llama8b's own engine, local. The hand-set plan (_hand_8b_plan)
    bit-equal to the all-local pool's run of it, three scheduled copies,
    per-engine kv_bytes against each store; the worker's build steps, the
    wire (calls, bytes, RTT, each flush's client wall against the
    worker's server_wall_s), plan / execute s, peak memory."""
    from repro_torch.api import Session, SessionConfig
    from repro_torch.api.result import QueryResult
    from repro_torch.core.optimizer import PlannerConfig
    from repro_torch.kernels import ops
    from repro_torch.remote import RemoteEngineMember, start_server
    from repro_torch.remote.client import remote_run_info
    from repro_torch.runtime.backend import (KVCacheBackend, PoolBackend,
                                             ReferenceBackend)

    lsess, items, frame_l, _, _, engines = llama
    weights_gb = _weights_bytes(params) / 1e9
    rung = POOL_8B["compressed"]
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    worker = _worker_8b_class()(
        params, rung["build"], name="compressed", models=("lg",),
        sm_ratios=(), lg_ratios=rung["lg_ratios"], lg_int8=rung["lg_int8"],
        include_cheap=False, prefill_batch=4,
        cache_dir=os.path.join(WORK, "remote-8b"))
    server, _, addr = start_server(worker)
    member = RemoteEngineMember("compressed", addr)
    gold = KVCacheBackend(engines["gold"], sm="lg", lg="lg", sm_ratios=(),
                          lg_ratios=POOL_8B["gold"]["lg_ratios"],
                          include_cheap=False)
    pool = PoolBackend([("compressed", member), ("gold", gold)], gold="gold")
    member.set_fallback(pool.members["gold"])
    sess = Session(SessionConfig(planner=PlannerConfig(steps=200,
                                                       restarts=3)),
                   backend=pool, reference=ReferenceBackend(engines["gold"],
                                                            lg="lg"))
    flushes, restore = _wire_timer(member)
    try:
        t0 = time.perf_counter()
        member.sync(items)
        torch.cuda.synchronize()
        sync_s = time.perf_counter() - t0
        if worker.engine.models["lg"].params is not \
                engines["gold"].models["lg"].params:
            die("remote_llama8b", "the worker holds its own weights")
        frame = _frame(sess, items)
        query = frame.to_query()
        filt, mapper = query.semantic_ops
        plan = _hand_8b_plan(member, items, filt, mapper)
        remote_engines = {"compressed": worker.engine, "gold": engines["gold"]}
        local_engines = {"compressed": engines["compressed"],
                         "gold": engines["gold"]}

        def run(s, name_engines, dispatcher):
            _evict_all(name_engines.values())
            before = {n: e.store.bytes_loaded
                      for n, e in name_engines.items()}
            snap = {"compressed": member.snapshot()}
            r = s.run(plan, query, items, dispatcher=dispatcher)
            r.remote = remote_run_info(snap, {"compressed":
                                              member.snapshot()})
            return r, before

        n_flushes0 = len(flushes)
        t0 = time.perf_counter()
        rr, before = run(sess, remote_engines, "inline")
        torch.cuda.synchronize()
        execute_hand_s = time.perf_counter() - t0
        per, deltas = _engine_totals_check(
            "remote_llama8b", QueryResult(sess, query, items, rr), before,
            remote_engines)
        hand_flushes = flushes[n_flushes0:]
        _wire_ok("remote_llama8b", rr.remote)
        threads, _ = run(sess, remote_engines, "threads:2")
        if not (_same(threads, rr) and _int_stats(threads) ==
                _int_stats(rr)):
            die("remote_llama8b", "inline and threads:2 differ")
        stages_used = {s.op_name for s in rr.stage_stats if s.n_tuples}
        if not {"compressed/lg-kv50i8", "compressed/lg-kv50",
                "gold/lg-kv00"} <= stages_used:
            die("remote_llama8b", f"a stage of the hand plan saw no tuple: "
                                  f"{stages_used}")

        sched = _wire_copies(torch, "remote_llama8b", sess, frame, plan, rr,
                             member, list(remote_engines.values()))

        # the Session plans the quickstart query over the wire, then runs
        t1 = time.perf_counter()
        report = frame.explain()
        t2 = time.perf_counter()
        result = frame.execute()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        counts = ops.launch_counts()
        snap = member.snapshot()

        # the all-local pool's run of the hand plan, after the remote
        # path's launch-count window
        lr, _ = run(lsess, local_engines, "inline")
        if not (_same(rr, lr) and _int_stats(rr) == _int_stats(lr)):
            die("remote_llama8b", f"the hand plan differs from the all-local "
                                  f"pool: {_int_stats(rr)} vs "
                                  f"{_int_stats(lr)}")
    finally:
        restore()
        member.close()
        server.shutdown()
        server.server_close()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if peak_gb >= 2 * weights_gb:
        die("remote_llama8b", f"peak {peak_gb} GB for {weights_gb} GB of "
                              f"weights: held twice")
    _check_path("remote_llama8b", counts, worker.engine.prefill_chunks, (
        "decode_query_attention", "decode_query_attention_int8",
        "prefill_attention", "beta_incinv"))
    if result.accepted.shape != (len(items),):
        die("remote_llama8b", "result has the wrong shape")
    rtts = sorted(snap["rtt_recent"])
    emit("remote_llama8b", ok=True, items=len(items),
         item_tokens=SESSION_8B_LEN, sync_s=sync_s,
         worker_build_steps_s=worker.engine.build_seconds,
         hand_plan=[(s.op_name, s.thr_hi, s.thr_lo) for s in plan.stages],
         execute_hand_s=execute_hand_s, remote=rr.remote,
         engine_totals=per, store_kv_deltas=deltas,
         hand_wire=_wire_share(hand_flushes),
         wire_all_calls=dict(calls=snap["calls"],
                         bytes_sent=snap["bytes_sent"],
                         bytes_recv=snap["bytes_recv"],
                         rtt_ms_p50=1e3 * rtts[len(rtts) // 2],
                         rtt_ms_p95=1e3 * rtts[min(int(0.95 * len(rtts)),
                                                   len(rtts) - 1)]),
         scheduler=sched,
         plan_s=t2 - t1, execute_s=t3 - t2,
         planned_stages=[(s.op_name, s.engine) for s in report.stages],
         weights_gb=weights_gb, peak_mem_gb=peak_gb,
         prefill_chunks=worker.engine.prefill_chunks, launches=counts,
         stage_stats=[s.as_dict() for s in rr.stage_stats])
    sess.close()
    shutil.rmtree(os.path.join(WORK, "remote-8b"), ignore_errors=True)
    return counts


SERVE_ITEMS, SERVE_BATCH = 200, 16


POOL_RELEASE_ITEMS = 24


def phase_pool_release(torch):
    """A planted two-engine pool Session on the card ("fast": sm kv80;
    "accurate": lg and its gold), built, run (the quickstart filter),
    closed and deleted with the cyclic garbage collector off, under
    inline, the scheduler and sharded:2: no ServingEngine may be left
    alive (counted with weak references); the card memory still allocated
    after it, against before it, is reported (module-level buffers such
    as the decode kernel's arrival counters stay). Its launches are not
    counted on a path."""
    import weakref
    from repro_torch.api import EngineSpec, Session, SessionConfig
    from repro_torch.core.optimizer import PlannerConfig
    from repro_torch.data import synthetic as syn
    from repro_torch.serving import engine as E
    alive = weakref.WeakSet()
    real = E.ServingEngine.__init__

    def init(self, *a, **kw):
        real(self, *a, **kw)
        alive.add(self)

    items = syn.make_dataset("pool-release", POOL_RELEASE_ITEMS,
                             seed=7).items
    rows = []
    E.ServingEngine.__init__ = init
    try:
        for mode in ("inline", "scheduler", "sharded:2"):
            root = os.path.join(WORK, "pool-release")
            gc.collect()
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            gc.disable()
            try:
                sess = Session(SessionConfig(
                    engines=(EngineSpec("fast", models=("sm",),
                                        sm_ratios=(0.8,), lg_ratios=(),
                                        cache_dir=os.path.join(root, "f")),
                             EngineSpec("accurate", models=("lg",),
                                        sm_ratios=(), lg_ratios=(),
                                        include_cheap=False,
                                        cache_dir=os.path.join(root, "a"))),
                    gold_engine="accurate",
                    planner=PlannerConfig(steps=20, restarts=1,
                                          snapshots=2)))
                frame, sched = _frame(sess, items), None
                if mode == "scheduler":
                    with sess.scheduler() as sched:
                        result = sched.submit(frame).result()
                else:
                    result = frame.execute(dispatcher=mode)
                n_during = len(alive)
                sess.close()
                del sess, frame, result, sched
                torch.cuda.synchronize()
                left = len(alive)
                held = torch.cuda.memory_allocated() - before
            finally:
                gc.enable()
            shutil.rmtree(root, ignore_errors=True)
            rows.append(dict(mode=mode, engines_during=n_during,
                             engines_left=left, bytes_held_after=held))
            if n_during != 2 or left:
                die("pool_release", f"{mode}: {left} of {n_during} engines "
                                    f"alive after close() and del")
    finally:
        E.ServingEngine.__init__ = real
    emit("pool_release", ok=True, items=len(items), runs=rows)


def phase_serve_planted(torch):
    """The concurrent serving launcher in-process on the card:
    repro_torch.launch.serve.main over 200 planted items, 48 requests at
    concurrency 48. The hub merges flushes of one (engine, operator,
    semantic operator) only, so only requests on the same filter task can
    share a call: the launcher's first 6 draws are 6 distinct tasks. Two
    such requests merge when both have their plan while the other's
    flushes wait, and plans are made one at a time (Session.plan holds
    the session's lock), so the run needs many repeats: 48 draws repeat
    each of the 10 tasks. Its flushes must merge (saved_calls > 0) and
    every tenant's line must be printed."""
    import contextlib
    import io
    import re
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    out = io.StringIO()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = serve.main(["--items", str(SERVE_ITEMS), "--requests", "48",
                         "--concurrency", "48", "--cache-dir",
                         os.path.join(WORK, "serve")])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    text = out.getvalue()
    lines = text.splitlines()
    saved = re.search(r"\((\d+) saved by coalescing\)", text)
    tenants = [ln for ln in lines if ln.startswith("[serve]   tenant ")]
    if rc != 0 or saved is None or int(saved.group(1)) <= 0:
        die("serve_planted", f"no flush merged: {lines[-5:]}")
    if {ln.split()[2] for ln in tenants} != {"premium", "standard", "batch"}:
        die("serve_planted", f"a tenant line is missing: {tenants}")
    if "on cuda" not in lines[0]:
        die("serve_planted", f"the launcher ran elsewhere: {lines[0]}")
    # two planted models, each prefilled in chunks of the default batch
    _check_path("serve_planted", counts,
                2 * math.ceil(SERVE_ITEMS / SERVE_BATCH),
                ("decode_query_attention", "prefill_attention",
                 "beta_incinv"))
    emit("serve_planted", ok=True, wall_s=wall, saved_calls=int(
        saved.group(1)), output=lines, launches=counts)
    return counts


# ---------------------------------------------------------------------------
# the partition scatter (sharded / mesh dispatchers) on the card
# ---------------------------------------------------------------------------

SCATTER = ("sharded:2", "sharded:3", "mesh", "mesh:2")


def _quantile_plan(sess, query, items, filt_stages, map_stage):
    """A hand cascade over a Session's one engine: the filter through
    `filt_stages` ((op, low quantile, high quantile) each) then gold, the
    map through `map_stage` then gold. Random or planted weights put the
    scores anywhere, so each early stage's thresholds are quantiles of
    its scores over the corpus: a share of the tuples decides at each
    stage, and the rest go on."""
    import numpy as np
    from repro_torch.runtime.executor import run_operator
    f_op, m_op = query.semantic_ops
    q = lambda s, p: float(np.quantile(s, p))
    rows = []
    for st, (name, lo, hi) in enumerate(filt_stages):
        sc = np.asarray(run_operator(sess.backend, f_op, name, items).scores)
        rows.append((0, st, name, q(sc, hi), q(sc, lo), False, False, ""))
    rows.append((0, len(filt_stages), "lg-kv00", 0.0, 0.0, False, True, ""))
    sc = np.asarray(run_operator(sess.backend, m_op, map_stage,
                                 items).scores)
    rows.append((1, 0, map_stage, q(sc, 0.5), -math.inf, True, False, ""))
    rows.append((1, 1, "lg-kv00", 0.0, 0.0, True, True, ""))
    return _plan_of(rows)


def _add_counts(total, counts):
    """Launch counts summed over windows (D's per-body counts too)."""
    if total is None:
        return counts
    return {k: (total[k] + v if not isinstance(v, dict) else
                {b: total[k][b] + n for b, n in v.items()})
            for k, v in counts.items()}


def _scatter_runs(torch, phase, sess, plan, query, items, specs):
    """`plan` through the Session under inline, then under each spec of
    `specs`, every run from a cold device LRU (a hit loads no bytes):
    decisions, map values and integer StageStats (n_batches aside: shards
    flush on their own) of each scatter bit-equal to inline's. The launch
    counts are set to 0 just before each scatter run and read just after
    it, so the inline run stays outside them. Returns the rows, the
    inline result and the scatter runs' launches summed."""
    import numpy as np
    from repro_torch.kernels import ops
    from repro_torch.runtime.dispatch import backend_engines
    runs, counts = {}, None
    for spec in ("inline",) + tuple(specs):
        for eng in backend_engines(sess.backend):
            eng.evict()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        r = sess.run(plan, query, items, dispatcher=spec)
        torch.cuda.synchronize()
        runs[spec] = (r, time.perf_counter() - t0,
                      torch.cuda.max_memory_allocated() / 1e9)
        if spec != "inline":
            counts = _add_counts(counts, ops.launch_counts())
    base = runs["inline"][0]
    rows = []
    for spec, (r, secs, peak) in runs.items():
        a, b = _decisions(base), _decisions(r)
        same = bool(np.array_equal(a[0], b[0]) and set(a[1]) == set(b[1])
                    and all(np.array_equal(a[1][li], b[1][li])
                            for li in a[1]))
        ints = sorted(_ints(base)) == sorted(_ints(r))
        rows.append(dict(dispatcher=spec, ran=r.dispatcher,
                         n_workers=r.n_workers, seconds=secs,
                         wall_s=r.wall_s, runtime_s=r.runtime_s,
                         n_partitions=r.n_partitions, peak_mem_gb=peak,
                         accepted=int(r.accepted.sum()), equal=same,
                         ints_equal=ints))
        if not (same and ints):
            die(phase, f"{spec} differs from inline: decisions equal "
                       f"{same}, integer StageStats equal {ints}")
    return rows, base, counts


def _check_scatter_launches(phase, counts, names):
    """The scatter runs themselves (their windows alone) launched each
    kernel of `names`."""
    for name in names:
        if counts[name] <= 0:
            die(phase, f"the scatter runs launched no {name}: {counts}")


def phase_sharded_planted(torch, sess, plan, query, items):
    """The planted Session's plan, a hand cascade (sm-kv80, sm-kv50 and
    lg-kv50 before gold; thresholds at quantiles) and a SemTopK query (k
    10) planned by the Session, each under sharded:2, sharded:3, mesh and
    mesh:2 bit-equal to inline; wall_s (the scatter's wall clock) beside
    runtime_s (operator time summed over shards). The launches are the
    scatter runs' alone, and A must be among them."""
    hand = _quantile_plan(sess, query, items, [("sm-kv80", 0.2, 0.8),
                                               ("sm-kv50", 0.25, 0.75),
                                               ("lg-kv50", 0.3, 0.7)],
                          "sm-kv50")
    top = (sess.frame(items).sem_topk(QUERY[0][0], task_id=QUERY[0][1],
                                      k=10)
           .with_guarantees(recall=TARGET, precision=TARGET))
    tq = top.to_query()
    tplan = sess.plan(tq, items)
    rows, _, counts = _scatter_runs(torch, "sharded_planted", sess, plan,
                                    query, items, SCATTER)
    hrows, _, hcounts = _scatter_runs(torch, "sharded_planted", sess, hand,
                                      query, items, SCATTER)
    trows, tbase, tcounts = _scatter_runs(torch, "sharded_planted", sess,
                                          tplan, tq, items, SCATTER)
    counts = _add_counts(_add_counts(counts, hcounts), tcounts)
    if int(tbase.accepted.sum()) != 10:
        die("sharded_planted", f"SemTopK kept {int(tbase.accepted.sum())} "
                               f"of k 10")
    _check_scatter_launches("sharded_planted", hcounts,
                            ("decode_query_attention",))
    emit("sharded_planted", ok=True, items=len(items),
         stages=[s.op_name for s in plan.stages], runs=rows,
         hand_stages=[s.op_name for s in hand.stages], hand_runs=hrows,
         topk_stages=[s.op_name for s in tplan.stages], topk_runs=trows,
         launches=counts, hand_launches=hcounts)
    return counts


def phase_sharded_llama8b(torch, kept, params):
    """The 8B Session's plan, and a hand cascade (int8 0.5, 0.8 before
    gold; thresholds at quantiles), under sharded:2 and mesh:2 against
    inline, each from a cold device LRU so kv_bytes compare exactly:
    decisions and integer StageStats bit-equal; the weights' data_ptrs
    unchanged and no copy made (the shards' device is the weights' own);
    each scatter's peak memory within 1 GB of the inline run's. The
    launches are the scatter runs' alone; the hand cascade's must hold A
    and A-int8."""
    sess, items, query, session_plan = kept
    plans = {"session": session_plan,
             "hand": _quantile_plan(sess, query, items,
                                    [("lg-kv50i8", 1 / 6, 5 / 6),
                                     ("lg-kv80", 0.25, 0.75)], "lg-kv50")}

    def ptrs(tree):
        if isinstance(tree, dict):
            return {k: ptrs(v) for k, v in tree.items()}
        return tree.data_ptr()
    before = ptrs(params)
    rows, by_plan, counts = {}, {}, None
    for k, plan in plans.items():
        rows[k], _, by_plan[k] = _scatter_runs(
            torch, "sharded_llama8b", sess, plan, query, items,
            ("sharded:2", "mesh:2"))
        counts = _add_counts(counts, by_plan[k])
    _check_scatter_launches("sharded_llama8b", by_plan["hand"],
                            ("decode_query_attention",
                             "decode_query_attention_int8"))
    eng = sess.engine
    shared = ptrs(eng.models["lg"].params) == before == ptrs(params) \
        and not eng._placed_params
    extra = max(r["peak_mem_gb"] - runs[0]["peak_mem_gb"]
                for runs in rows.values() for r in runs)
    emit("sharded_llama8b", ok=shared and extra <= 1.0, items=len(items),
         stages={k: [s.op_name for s in p.stages] for k, p in plans.items()},
         runs=rows,
         weights_shared=shared, weights_gb=_weights_bytes(params) / 1e9,
         peak_over_inline_gb=extra, launches=counts,
         launches_by_plan=by_plan)
    if not shared:
        die("sharded_llama8b", "a scatter copied or moved the weights")
    if extra > 1.0:
        die("sharded_llama8b", f"a scatter's peak memory is {extra:.3f} GB "
                               f"over inline's")
    return counts


# ---------------------------------------------------------------------------
# deepseek-v2-lite-16b at full width and depth: MLA + MoE through a Session
# ---------------------------------------------------------------------------

DEEPSEEK_ITEMS, DEEPSEEK_LEN, DEEPSEEK_CPU_LAYERS = 32, 512, 12


def _lg_session(name, cfg, params, root, device=None, prefill_batch=4,
                lg_ratios=(0.8, 0.5), lg_int8=()):
    """Session(cfg, engine=eng) with one model registered as "lg": the
    rungs `lg_ratios` (and int8 `lg_int8`) before gold, `prefill_batch`
    items per prefill chunk. deepseek: 0.8 / 0.5 / gold (MLA keeps
    latents: no int8 rung), 4 items per chunk."""
    from repro_torch.api import EngineSpec, Session, SessionConfig
    from repro_torch.cache.store import CacheStore
    from repro_torch.core.optimizer import PlannerConfig
    from repro_torch.serving.engine import ServingEngine
    device = device or DEV
    eng = ServingEngine(CacheStore(root), device=device)
    eng.register_model("lg", cfg, params)
    spec = EngineSpec(name, models=("lg",), sm_ratios=(),
                      lg_ratios=lg_ratios, lg_int8=lg_int8,
                      include_cheap=False, prefill_batch=prefill_batch,
                      device=device)
    return eng, Session(SessionConfig(
        engines=(spec,), planner=PlannerConfig(steps=200, restarts=3)),
        engine=eng)


def _check_deepseek(phase, counts, result, metrics, eng, n_items):
    _check_chunks(phase, counts, eng)
    if counts["expected_attention_scores"] <= 0:
        die(phase, f"no launch of C at the latent shape: {counts}")
    if counts["prefill_attention"] or counts["decode_query_attention"]:
        die(phase, f"an MLA path launched D or A: {counts}")
    if result.accepted.shape != (n_items,):
        die(phase, "result has the wrong shape")
    if metrics["recall"] < TARGET or metrics["precision"] < TARGET:
        die(phase, f"guarantees missed against gold: {metrics}")


def phase_session_deepseek(torch):
    """deepseek-v2-lite-16b at full width and depth (27 layers, d_model
    2048, MLA r 512 + rope 64, 64 routed experts top-6 + 2 shared, vocab
    102400, bfloat16, random weights from seed 0) through a Session over
    32 x 512-token items: build by step, plan (profiling, optimizer),
    execute, peak memory, and C's launches at the latent shape (KV 1, G
    16, dk 576). Then the same world cut to DEEPSEEK_CPU_LAYERS layers, in
    float32, planned and run on the card, and its plan and a hand
    cascade (0.8, 0.5 before gold; thresholds at quantiles) run again by
    the port on the CPU over the card's store: decisions equal outside
    MARGIN of every threshold, integer StageStats equal where every
    decision is. (In bfloat16 a
    router logit within rounding of the 6th largest picks another expert
    on the CPU than on the card, so that comparison would read rounding,
    not the port.)"""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.data import synthetic as syn
    from repro_torch.models import init_params

    cfg = get_config("deepseek-v2-lite-16b")
    m = cfg.mla
    # what earlier phases still hold, before and after the collector runs
    # (nothing should wait for it since the pool's cycle was repaired),
    # so that the peak below is this phase's own
    held_pre_gb = torch.cuda.memory_allocated() / 1e9
    gc.collect()
    torch.cuda.empty_cache()
    held_gb = torch.cuda.memory_allocated() / 1e9
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=DEV).manual_seed(0),
                         device=DEV)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights_gb = _weights_bytes(params) / 1e9
    ds = syn.make_dataset("deepseek-session", DEEPSEEK_ITEMS,
                          seq_len=DEEPSEEK_LEN, seed=8)
    root = os.path.join(WORK, "session-deepseek")
    eng, sess = _lg_session("deepseek", cfg, params, root)
    torch.cuda.reset_peak_memory_stats()
    report, result, metrics, counts, times, _ = _drive_session(
        torch, sess, [ds.items], _frame(sess, ds.items))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    emit("session_explain", text=str(report))
    _check_deepseek("session_deepseek", counts, result, metrics, eng,
                    len(ds.items))
    full = dict(init_s=init_s, weights_gb=weights_gb,
                held_before_collect_gb=held_pre_gb, held_before_gb=held_gb,
                **times,
                planning_time_s=report.planning_time_s,
                stages=[s.op_name for s in report.stages],
                feasible=report.feasible, metrics=metrics,
                prefill_chunks=eng.prefill_chunks,
                build_steps_s=dict(eng.build_seconds), peak_mem_gb=peak_gb,
                attn_dispatches=eng.attn_dispatches,
                c_shape=dict(L=cfg.n_layers, B=4, S=DEEPSEEK_LEN, KV=1,
                             G=cfg.n_heads, dk=m.kv_lora_rank
                             + m.qk_rope_dim))
    sess.close()
    shutil.rmtree(root, ignore_errors=True)
    del sess, eng, params, result
    torch.cuda.empty_cache()

    # the same world cut in depth, float32, on the card and on the CPU
    cut = dataclasses.replace(cfg, n_layers=DEEPSEEK_CPU_LAYERS,
                              dtype="float32")
    params = init_params(cut, torch.Generator(device=DEV).manual_seed(0),
                         device=DEV)
    root = os.path.join(WORK, "session-deepseek-cut")
    eng, sess = _lg_session("deepseek", cut, params, root)
    frame = _frame(sess, ds.items)
    _, cres, cmetrics, ccounts, ctimes, _ = _drive_session(
        torch, sess, [ds.items], frame)
    _check_deepseek("session_deepseek", ccounts, cres, cmetrics, eng,
                    len(ds.items))
    query = frame.to_query()
    plans = {"session": cres.raw.plan,
             "hand": _quantile_plan(sess, query, ds.items,
                                    [("lg-kv80", 0.2, 0.8),
                                     ("lg-kv50", 0.25, 0.75)], "lg-kv50")}
    compared = _card_vs_cpu("session_deepseek", sess, eng, cut, params, root,
                            plans, query, ds.items)
    emit("session_deepseek", ok=True, items=len(ds.items),
         item_tokens=DEEPSEEK_LEN, **full, launches=counts,
         cut=dict(n_layers=DEEPSEEK_CPU_LAYERS, dtype="float32",
                  plan_s=ctimes["plan_s"], build_s=ctimes["build_s"],
                  margin=MARGIN, plans=compared, launches=ccounts))
    sess.close()
    shutil.rmtree(root, ignore_errors=True)
    del sess, eng, params
    torch.cuda.empty_cache()
    return counts


def _card_vs_cpu(phase, sess, eng, cut, params, root, plans, query, items,
                 **ladder):
    """Each plan run on the card (`sess` over `eng`) and again by the
    port on the CPU, over the card's store (`root`), with the cut's
    weights copied to the host (`ladder`: the Session's lg rungs):
    decisions equal outside MARGIN of every threshold, integer StageStats
    equal where every decision is (`_linear_card_vs_cpu`)."""
    spec = sess.engine_specs[0]
    cpu_eng, cpu_sess = _lg_session(spec.name, cut, _tree_cpu(params), root,
                                    device="cpu",
                                    prefill_batch=spec.prefill_batch,
                                    **ladder)
    compared = {}
    for name, plan in plans.items():
        eng.evict()
        cpu_eng.evict()
        card = sess.run(plan, query, items)
        t0 = time.perf_counter()
        cpu = cpu_sess.run(plan, query, items)
        cpu_s = time.perf_counter() - t0
        cpu_same, all_same, n_near = _linear_card_vs_cpu(
            phase, sess, plan, query, items, card, cpu)
        compared[name] = dict(
            stages=[s.op_name for s in plan.stages], cpu_run_s=cpu_s,
            cpu_equal_outside_margin=cpu_same,
            cpu_equal_everywhere=all_same, n_near_margin=n_near,
            cpu_ints_equal=_ints(card) == _ints(cpu),
            accepted=int(card.accepted.sum()))
    cpu_sess.close()
    return compared


def _tree_cpu(tree):
    return {k: (_tree_cpu(v) if isinstance(v, dict) else v.cpu())
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# the SSM families at full width: hymba-1.5b (GQA heads beside Mamba heads)
# and rwkv6-1.6b (chunked WKV) through a Session
# ---------------------------------------------------------------------------

HYMBA_ITEMS, HYMBA_LEN, HYMBA_CUT_LAYERS = 16, 1536, 4
RWKV_ITEMS, RWKV_LEN, RWKV_CUT_LAYERS = 16, 512, 4
HYMBA_LADDER = dict(lg_ratios=(0.8, 0.5), lg_int8=(0.5,))


def _mamba_ms_per_step(torch, params, cfg, B, S):
    """Device ms per token of one layer's Mamba prefill scan
    (`mamba_mix_full` over (B, S, d), plain torch, a Python loop of S
    steps), CUDA events around the whole call, divided by S."""
    from repro_torch.models import layers as L
    p = {k: v[0] for k, v in params["layers"]["attn"]["ssm"].items()}
    x = torch.randn((B, S, cfg.d_model), device=DEV).to(params["embed"].dtype)
    L.mamba_mix_full(p, x[:, :8], cfg)                 # warm-up
    s_, e_ = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0 = time.perf_counter()
    s_.record()
    L.mamba_mix_full(p, x, cfg)
    e_.record()
    torch.cuda.synchronize()
    return {"device_ms_per_step": s_.elapsed_time(e_) / S,
            "host_ms_per_step": (time.perf_counter() - t0) * 1e3 / S,
            "B": B, "S": S, "steps_per_chunk": S * cfg.n_layers}


def _ssm_invariance(phase, eng, items, rungs):
    """flush_invariance per rung (label, ratio, quant): an item alone
    against flushes of 2, 4, ... up to the profile's batch, the engine's
    pinned rows; fails unless every size is bit-equal."""
    from repro_torch.data import synthetic as syn
    from repro_torch.serving.engine import flush_invariance
    ids = [it.item_id for it in items]
    rows = []
    for label, ratio, quant in rungs:
        got = flush_invariance(
            eng, "lg", ratio, ids[0], ids[1:],
            filter_args=([syn.filter_query_token(1)], syn.TOK_YES,
                         syn.TOK_NO),
            map_args=([syn.map_query_token(2)],
                      [syn.value_token(v) for v in range(8)]),
            quant=quant)
        rows.append({"rung": label, "pinned": {str(n): ok
                                               for n, ok in got.items()}})
        if not all(got.values()):
            die(phase, f"{label}: an item's flush output depends on its "
                       f"batch: {got}")
    emit("flush_invariance", ok=True, path=phase, rungs=rows,
         pinned_rows=eng.max_batch)
    return rows


def _check_hymba(phase, counts, result, metrics, eng, n_items):
    """The hymba path's kernels: C once per prefill chunk, D (tensor-core
    body for bf16) and B in every layer; never A or the int8 bodies
    (hymba decodes token by token and dequantises its int8 rung to
    bfloat16 before the mixer)."""
    _check_chunks(phase, counts, eng)
    for name in ("decode_attention", "prefill_attention"):
        if counts[name] <= 0:
            die(phase, f"the hymba path launched no {name}: {counts}")
    for name in ("decode_query_attention", "decode_query_attention_int8",
                 "decode_attention_int8"):
        if counts[name]:
            die(phase, f"the hymba path launched {name}: {counts}")
    if result.accepted.shape != (n_items,):
        die(phase, "result has the wrong shape")
    # random weights may give gold no positive: then recall and precision
    # hold vacuously, and the result must accept nothing either
    if (metrics["tp"] + metrics["fn"] and metrics["recall"] < TARGET) \
            or (metrics["tp"] + metrics["fp"]
                and metrics["precision"] < TARGET):
        die(phase, f"guarantees missed against gold: {metrics}")


def phase_session_hymba(torch):
    """hymba-1.5b at full width and depth (32 layers, d_model 1600, 25 q /
    5 KV heads of 64, window 1024 with global layers 0 / 15 / 31, Mamba
    heads d_state 16, d_conv 4, expand 2, vocab 32001; bfloat16, random
    weights from seed 0) through a Session over 16 items of 1536 tokens
    (longer than the window, so the windows bind in D and B), rungs 0.8 /
    0.5 / int8 0.5 / gold, all 16 items in one prefill chunk: build by
    step, the Mamba scan's ms per step, plan (profiling, optimizer),
    execute, peak memory, the launches of B, C and each body of D; every
    rung bit-equal across flush sizes. Then the same world cut to 4
    layers (global layer 0 and the published window) in float32, planned
    and run on the card, and its plan and a hand cascade (0.8, int8 0.5
    before gold) run again by the port on the CPU over the card's store:
    decisions equal outside MARGIN of every threshold, integer
    StageStats equal where every decision is."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.data import synthetic as syn
    from repro_torch.models import init_params

    cfg = get_config("hymba-1.5b")
    gc.collect()
    torch.cuda.empty_cache()
    held_gb = torch.cuda.memory_allocated() / 1e9
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=DEV).manual_seed(0),
                         device=DEV)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    ds = syn.make_dataset("hymba-session", HYMBA_ITEMS, seq_len=HYMBA_LEN,
                          seed=9)
    root = os.path.join(WORK, "session-hymba")
    eng, sess = _lg_session("hymba", cfg, params, root,
                            prefill_batch=HYMBA_ITEMS, **HYMBA_LADDER)
    torch.cuda.reset_peak_memory_stats()
    report, result, metrics, counts, times, _ = _drive_session(
        torch, sess, [ds.items], _frame(sess, ds.items))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    emit("session_explain", text=str(report))
    _check_hymba("session_hymba", counts, result, metrics, eng,
                 len(ds.items))
    if counts["prefill_attention_by_body"]["fma"]:
        die("session_hymba", f"bf16 hymba ran D's FMA body: {counts}")
    scan = _mamba_ms_per_step(torch, params, cfg, HYMBA_ITEMS, HYMBA_LEN)
    inv = _ssm_invariance("session_hymba", eng, ds.items,
                          [("hymba kv80 bfloat16", 0.8, False),
                           ("hymba kv50 bfloat16", 0.5, False),
                           ("hymba kv50 int8", 0.5, True),
                           ("hymba gold bfloat16", 0.0, False)])
    full = dict(init_s=init_s, weights_gb=_weights_bytes(params) / 1e9,
                held_before_gb=held_gb,
                **times, planning_time_s=report.planning_time_s,
                stages=[s.op_name for s in report.stages],
                feasible=report.feasible, metrics=metrics,
                prefill_chunks=eng.prefill_chunks,
                build_steps_s=dict(eng.build_seconds), peak_mem_gb=peak_gb,
                attn_dispatches=eng.attn_dispatches, mamba_scan=scan,
                flush_invariance=inv,
                launches_b=counts["decode_attention"],
                launches_c=counts["expected_attention_scores"],
                launches_d=counts["prefill_attention_by_body"],
                shapes=dict(KV=cfg.n_kv_heads,
                            G=cfg.n_heads // cfg.n_kv_heads, d=cfg.d_head,
                            window=cfg.window, global_layers=list(
                                cfg.global_layers)))
    sess.close()
    shutil.rmtree(root, ignore_errors=True)
    del sess, eng, params, result
    torch.cuda.empty_cache()

    cut = dataclasses.replace(cfg, n_layers=HYMBA_CUT_LAYERS,
                              global_layers=(0,), dtype="float32")
    params = init_params(cut, torch.Generator(device=DEV).manual_seed(0),
                         device=DEV)
    root = os.path.join(WORK, "session-hymba-cut")
    eng, sess = _lg_session("hymba", cut, params, root,
                            prefill_batch=HYMBA_ITEMS, **HYMBA_LADDER)
    frame = _frame(sess, ds.items)
    _, cres, cmetrics, ccounts, ctimes, _ = _drive_session(
        torch, sess, [ds.items], frame)
    _check_hymba("session_hymba", ccounts, cres, cmetrics, eng,
                 len(ds.items))
    query = frame.to_query()
    plans = {"session": cres.raw.plan,
             "hand": _quantile_plan(sess, query, ds.items,
                                    [("lg-kv80", 0.2, 0.8),
                                     ("lg-kv50i8", 0.25, 0.75)], "lg-kv50")}
    compared = _card_vs_cpu("session_hymba", sess, eng, cut, params, root,
                            plans, query, ds.items, **HYMBA_LADDER)
    emit("session_hymba", ok=True, items=len(ds.items),
         item_tokens=HYMBA_LEN, **full, launches=counts,
         cut=dict(n_layers=HYMBA_CUT_LAYERS, global_layers=[0],
                  dtype="float32", plan_s=ctimes["plan_s"],
                  build_s=ctimes["build_s"], margin=MARGIN, plans=compared,
                  launches=ccounts),
         note="items cut to 16 (one prefill chunk); widths, depth and "
              "window as published")
    sess.close()
    shutil.rmtree(root, ignore_errors=True)
    del sess, eng, params
    torch.cuda.empty_cache()
    return counts


def _rwkv_logits_vs_cpu(torch, cfg, params, tokens):
    """The prefill's last logits and two decode steps' logits, on the
    card and by the port on the CPU on the same weights and tokens (the
    last 2 tokens of `tokens` decode): max abs error over the largest
    magnitude of each."""
    from repro_torch.models import decode_step, prefill
    out = {}
    for dev, p in ((DEV, params), ("cpu", _tree_cpu(params))):
        toks = tokens.to(dev)
        last, cache = prefill(p, cfg, tokens=toks[:, :-2])
        steps = []
        for t in (2, 1):
            logits, cache = decode_step(p, cfg, cache, rows=8,
                                        tokens=toks[:, -t:][:, :1])
            steps.append(logits)
        out[dev] = [last.float().cpu()] + [x.float().cpu() for x in steps]
    errs = {}
    for name, a, b in zip(("prefill", "decode1", "decode2"), out[DEV],
                          out["cpu"]):
        errs[name] = float((a - b).abs().max())
        errs[name + "_scale"] = float(b.abs().max())
    return errs


def phase_session_rwkv6(torch):
    """rwkv6-1.6b at full width and depth (24 layers, d_model 2048, 32 WKV
    heads of 64, channel mix 7168, vocab 65536; bfloat16, random weights
    from seed 0): the rung-less build over 16 items of 512 tokens (no
    calibration, ratio 0 only: the states stored as they are), then a
    Session over the ratio-0 profile and gold (the only candidate: no
    rung); build, plan, execute, peak memory, and its one rung bit-equal
    across flush sizes. No attention kernel is launched: rwkv6 has no
    attention and no positional cache (plain torch, as the JAX package's
    jnp). Then a float32 cut of 4
    layers: the prefill's and two decode steps' logits on the card
    against the port's CPU path on the same weights."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.data import synthetic as syn
    from repro_torch.kernels import ops
    from repro_torch.models import init_params

    emit("session_rwkv6_kernels", note="rwkv6 launches no attention "
         "kernel (A, B, C, D): no attention and no positional cache; its "
         "mixers are plain torch. Only the planner's kernel E may run")
    cfg = get_config("rwkv6-1.6b")
    gc.collect()
    torch.cuda.empty_cache()
    held_gb = torch.cuda.memory_allocated() / 1e9
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=DEV).manual_seed(0),
                         device=DEV)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    ds = syn.make_dataset("rwkv6-session", RWKV_ITEMS, seq_len=RWKV_LEN,
                          seed=10)
    root = os.path.join(WORK, "session-rwkv6")
    eng, sess = _lg_session("rwkv6", cfg, params, root,
                            prefill_batch=RWKV_ITEMS, lg_ratios=())
    torch.cuda.reset_peak_memory_stats()
    report, result, metrics, counts, times, _ = _drive_session(
        torch, sess, [ds.items], _frame(sess, ds.items))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    emit("session_explain", text=str(report))
    launched = {k: counts[k] for k in KERNEL_META if counts[k]}
    if launched or counts["prefill_attention"]:
        die("session_rwkv6", f"rwkv6 launched an attention kernel: "
                             f"{counts}")
    if eng.models["lg"].stats is not None:
        die("session_rwkv6", "rwkv6 was calibrated")
    # its only candidate is gold: the result is gold's, item for item
    if result.accepted.shape != (len(ds.items),) or metrics["fp"] \
            or metrics["fn"]:
        die("session_rwkv6", f"the gold-only plan differs from gold: "
                             f"{metrics}")
    inv = _ssm_invariance("session_rwkv6", eng, ds.items,
                          [("rwkv6 ratio 0 bfloat16", 0.0, False)])
    full = dict(init_s=init_s, weights_gb=_weights_bytes(params) / 1e9,
                held_before_gb=held_gb,
                **times, planning_time_s=report.planning_time_s,
                stages=[s.op_name for s in report.stages],
                candidates=report.candidates, metrics=metrics,
                prefill_chunks=eng.prefill_chunks,
                build_steps_s=dict(eng.build_seconds), peak_mem_gb=peak_gb,
                attn_dispatches=eng.attn_dispatches, flush_invariance=inv)
    sess.close()
    shutil.rmtree(root, ignore_errors=True)
    del sess, eng, params, result
    torch.cuda.empty_cache()

    cut = dataclasses.replace(cfg, n_layers=RWKV_CUT_LAYERS, dtype="float32")
    params = init_params(cut, torch.Generator(device=DEV).manual_seed(0),
                         device=DEV)
    toks = torch.tensor([it.tokens[:130] for it in ds.items[:4]])
    ops.reset_launch_counts()
    errs = _rwkv_logits_vs_cpu(torch, cut, params, toks)
    for name in ("prefill", "decode1", "decode2"):
        if not errs[name] <= 1e-4 * max(1.0, errs[name + "_scale"]):
            die("session_rwkv6", f"float32 cut: card vs CPU {name} logits "
                                 f"{errs}")
    emit("session_rwkv6", ok=True, items=len(ds.items), item_tokens=RWKV_LEN,
         **full, launches=counts,
         cut=dict(n_layers=RWKV_CUT_LAYERS, dtype="float32",
                  items=4, tokens=128, logits_vs_cpu=errs, tol="1e-4 x "
                  "max(1, max |cpu|)"),
         note="items cut to 16 (one prefill chunk); widths and depth as "
              "published")
    del params
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# the GQA zoo configs at full width, cut in depth: D and A at new shapes
# ---------------------------------------------------------------------------

# (config, layers): 6 for gemma3 so that a global layer (every 6th) runs;
# hymba cut to its global layer 0 and a windowed layer (G 5, window 1024)
ZOO_GQA = (("granite-8b", 2), ("minitron-8b", 2), ("gemma3-27b", 6),
           ("llava-next-34b", 2), ("musicgen-medium", 2), ("dbrx-132b", 2),
           ("hymba-1.5b", 2))
ZOO_LENGTHS = (1536, 1200)      # longer than gemma3's 1024 window
ZOO_TOL = 0.05                  # x the plain version's max |value| (bf16)
# a launch's output element against the plain version's: bf16 steps at
# |plain|, plus a share of the attention over |v|
ZOO_ELEM_TOL = (2, 2.0 ** -10)
ZOO_FAULT_KEYS = 64             # the planted fault: the window one key tile


def _zoo_inputs(torch, cfg, gen, n, S):
    """tokens (n, S), or the frontend's embeddings (n, S, d) for llava /
    musicgen."""
    if cfg.frontend == "none":
        return {"tokens": torch.randint(0, cfg.vocab_size, (n, S),
                                        generator=gen, device=DEV)}
    return {"embeds": torch.randn((n, S, cfg.d_model), generator=gen,
                                  device=DEV).to(torch.bfloat16)}


class _KernelCalls:
    """Records each call of `ops.prefill_attention`,
    `ops.decode_query_attention` and `ops.decode_attention` made while it
    is active (its inputs and output), so each launch on the model's path
    can be held against the plain version on the same inputs."""

    NAMES = ("prefill_attention", "decode_query_attention",
             "decode_attention")

    def __init__(self, ops):
        self.ops, self.calls = ops, []
        self.real = {n: getattr(ops, n) for n in self.NAMES}

        def rec(name, fn):
            def run(*a, **kw):
                out = fn(*a, **kw)
                self.calls.append((name, a, kw, out))
                return out
            return run
        for n, fn in self.real.items():
            setattr(ops, n, rec(n, fn))

    def close(self):
        for n, fn in self.real.items():
            setattr(self.ops, n, fn)

    def hold(self, phase, label):
        """Every recorded launch against the plain version on its inputs,
        element by element (ZOO_ELEM_TOL): within two bf16 steps of the
        plain value plus 2^-10 of the same attention over |v|, which
        bounds what float32 accumulation can move an output whose terms
        cancel. On a windowed launch the window is also shifted by one
        key block (ZOO_FAULT_KEYS) in the plain version: that planted
        fault must fail the same check. Returns the worst (error over
        limit) per kernel, and the least (fault's error over limit) where
        a fault was planted."""
        from repro_torch.kernels import ref
        worst = {}
        for name, a, kw, out in self.calls:
            window = min(int(kw.get("window", GLOBAL)), GLOBAL)
            kw = {k: v for k, v in kw.items()
                  if k not in ("backend", "k_scale", "v_scale", "window")}
            plain = getattr(ref, name + "_ref")
            q, k, v, *rest = a
            want = plain(q, k, v, *rest, window=window, **kw).float()
            spread = plain(q, k, v.abs(), *rest, window=window,
                           **kw).float()
            ratio = _elem_ratio(out, want, spread)
            worst[name] = max(worst.get(name, 0.0), ratio)
            if not ratio <= 1.0:
                die(phase, f"{label}: {name} vs its plain version on the "
                           f"same inputs: error {ratio} x the limit "
                           f"{ZOO_ELEM_TOL}")
            reach = k.shape[1] if name == "prefill_attention" else \
                int(rest[0].max())
            if window < reach:
                fault = plain(q, k, v, *rest, window=window - ZOO_FAULT_KEYS,
                              **kw).float()
                f = _elem_ratio(out, fault, spread)
                key = name + "_fault"
                worst[key] = min(worst.get(key, math.inf), f)
                if not f > 1.0:
                    die(phase, f"{label}: {name}'s check passes a window "
                               f"off by {ZOO_FAULT_KEYS} keys ({f} x the "
                               f"limit)")
        self.calls = []
        return worst


def _bf16_step(x):
    """The spacing of bfloat16 numbers at |x| (8 significant bits)."""
    import torch
    e = torch.floor(torch.log2(x.abs().clamp(min=2.0 ** -126)))
    return torch.exp2(e - 7)


def _elem_ratio(got, want, spread):
    """max over elements of |got - want| / (steps x bf16 step at |want| +
    rel x spread): at most 1 passes ZOO_ELEM_TOL. NaN or inf in `got`
    gives inf."""
    steps, rel = ZOO_ELEM_TOL
    err = (got.float() - want).abs()
    lim = steps * _bf16_step(want) + rel * spread
    r = err / lim
    if not bool(got.float().isfinite().all()):
        return math.inf
    return float(r.max())


def _close(phase, label, got, want):
    err = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    if not (bool(got.float().isfinite().all()) and err <= ZOO_TOL * scale):
        die(phase, f"{label}: kernel route vs plain: err {err} > "
                   f"{ZOO_TOL} x {scale} or non-finite")
    return err, scale


def phase_zoo_legs(torch):
    """Each GQA zoo config at full width, cut in depth (ZOO_GQA), random
    weights from a seed: one prefill of two items (ZOO_LENGTHS) on the
    kernel route (D in every layer) held against the plain route (the
    blocked flash_attention), last logits and k / v caches; one fused
    decode flush of 2 query tokens (A in every layer) against the plain
    decode (hymba, which has no fused decode: two decode steps, B in
    every layer at each); every launch of D and A (B) also against its plain version on
    the same inputs, element by element (`_KernelCalls.hold`: two bf16
    steps plus 2^-10 of the attention over |v|; on gemma3's windowed
    layers a window one key tile short must fail it), which alone holds
    dbrx (MoE: an expert
    picked from bf16 router logits may differ between the two routes, so
    its end-to-end errors are printed, not held); C over the chunk
    against its plain version. Then minicpm3-4b
    (MLA r 256 + rope 32, cut to 2 layers): one build chunk's C at its
    latent shape (KV 1, G 40, dk 288). Each model is freed before the
    next. Launches on the kernel routes count."""
    import dataclasses
    from repro_torch.cache.compression import (calibrate_query_stats,
                                               score_chunk)
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import (decode_multi, decode_step, init_params,
                                    prefill, supports_fused_decode)
    gen = torch.Generator(device=DEV).manual_seed(11)

    def decode(params, cfg, cache, kernels, q):
        """The 2 query tokens' last logits: one fused flush, or (no fused
        decode) two decode steps; the dense layers at 8 pinned rows."""
        cache = {k: v.clone() for k, v in cache.items()}
        if supports_fused_decode(cfg):
            return decode_multi(params, cfg, cache, kernels=kernels, rows=8,
                                **q)[0]
        for t in range(2):
            logits, cache = decode_step(
                params, cfg, cache, kernels=kernels, rows=8,
                **{k: v[:, t:t + 1] for k, v in q.items()})
        return logits
    S = max(ZOO_LENGTHS)
    lengths = torch.tensor(ZOO_LENGTHS, dtype=torch.int32, device=DEV)
    total, rows = None, []

    def c_check(label, cfg, params, cache, inputs):
        stats = calibrate_query_stats(params, cfg, kernels="cuda", **inputs)
        got = score_chunk(cfg, cache, stats, ZOO_LENGTHS, kernels="cuda")
        want = score_chunk(cfg, cache, stats, ZOO_LENGTHS, kernels="ref")
        live = want.isfinite()
        mag = want[live].abs().clamp(min=1.0)
        rel = float(((got[live] - want[live]).abs() / mag).max())
        if not (rel <= 2e-5 and bool((got.isfinite() == live).all())):
            die("zoo_legs", f"{label}: C vs plain relative error {rel}")
        return rel

    for name, depth in ZOO_GQA:
        t0 = time.perf_counter()
        cfg = dataclasses.replace(get_config(name), n_layers=depth)
        if cfg.global_layers:
            cfg = dataclasses.replace(cfg, global_layers=(0,))
        params = init_params(cfg, gen, device=DEV)
        inputs = _zoo_inputs(torch, cfg, gen, len(ZOO_LENGTHS), S)
        # an MoE router picks its experts from bf16 logits: a rounding
        # difference upstream (the kernel's attention against the blocked
        # one) may pick another expert for a token, so dbrx's logits are
        # reported, and its kernels held call by call
        gate = not cfg.is_moe
        rec = _KernelCalls(ops)
        try:
            ops.reset_launch_counts()
            last, cache = prefill(params, cfg, max_len=S + 128,
                                  lengths=lengths, kernels="cuda", **inputs)
            torch.cuda.synchronize()
            counts = ops.launch_counts()
            errs = rec.hold("zoo_legs", f"{name} prefill")
            last_p, cache_p = prefill(params, cfg, max_len=S + 128,
                                      lengths=lengths, kernels="ref",
                                      **inputs)
            q = _zoo_inputs(torch, cfg, gen, len(ZOO_LENGTHS), 2)
            ops.reset_launch_counts()
            dec = decode(params, cfg, cache, "cuda", q)
            torch.cuda.synchronize()
            dcounts = ops.launch_counts()
            errs.update(rec.hold("zoo_legs", f"{name} decode"))
        finally:
            rec.close()
        dec_p = decode(params, cfg, cache_p, "ref", q)
        for label, got, want in (("prefill_logits", last, last_p),
                                 ("cache_k", cache["k"], cache_p["k"]),
                                 ("cache_v", cache["v"], cache_p["v"]),
                                 ("decode_logits", dec, dec_p)):
            if gate:
                errs[label] = _close("zoo_legs", f"{name} {label}", got,
                                     want)[0]
            else:
                errs[label] = float((got.float() - want.float()).abs().max())
                errs[label + "_scale"] = float(want.float().abs().max())
        ops.reset_launch_counts()
        errs["c_rel"] = c_check(name, cfg, params, cache,
                                {k: v[:, :S] for k, v in inputs.items()})
        ccounts = ops.launch_counts()
        for c in (counts, dcounts, ccounts):
            total = _add_counts(total, c)
        fused = supports_fused_decode(cfg)
        dname = "decode_query_attention" if fused else "decode_attention"
        if cfg.window and not {"prefill_attention_fault",
                               dname + "_fault"} <= set(errs):
            die("zoo_legs", f"{name}: no windowed launch to plant the "
                            f"fault in")
        if counts["prefill_attention_by_body"]["tc"] != depth \
                or dcounts[dname] != depth * (1 if fused else 2):
            die("zoo_legs", f"{name}: D {counts['prefill_attention']} / "
                            f"{dname} {dcounts[dname]} launches for {depth} "
                            f"layers")
        KV = cfg.n_kv_heads
        rows.append(dict(config=name, layers=depth, d_model=cfg.d_model,
                         KV=KV, G=cfg.n_heads // KV, dk=cfg.d_head,
                         window=cfg.window or None, S=S, **errs,
                         seconds=time.perf_counter() - t0))
        emit("zoo_leg", **rows[-1])
        del params, cache, cache_p, last, last_p, dec, dec_p, inputs
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config("minicpm3-4b"), n_layers=2)
    params = init_params(cfg, gen, device=DEV)
    toks = torch.randint(0, cfg.vocab_size, (4, 512), generator=gen,
                         device=DEV)
    _, cache = prefill(params, cfg, tokens=toks)
    ops.reset_launch_counts()
    stats = calibrate_query_stats(params, cfg, tokens=toks, kernels="cuda")
    got = score_chunk(cfg, cache, stats, [512] * 4, kernels="cuda")
    torch.cuda.synchronize()
    ccounts = ops.launch_counts()
    want = score_chunk(cfg, cache, stats, [512] * 4, kernels="ref")
    rel = float(((got - want).abs() / want.abs().clamp(min=1.0)).max())
    total = _add_counts(total, ccounts)
    m = cfg.mla
    rows.append(dict(config="minicpm3-4b", layers=2, KV=1, G=cfg.n_heads,
                     dk=m.kv_lora_rank + m.qk_rope_dim, S=512, c_rel=rel,
                     c_launches=ccounts["expected_attention_scores"],
                     seconds=time.perf_counter() - t0))
    emit("zoo_leg", **rows[-1])
    if not (rel <= 2e-5 and ccounts["expected_attention_scores"] == 1):
        die("zoo_legs", f"minicpm3-4b: C at the latent shape: relative "
                        f"error {rel}, {ccounts['expected_attention_scores']}"
                        f" launches")
    del params, cache, stats, got, want
    torch.cuda.empty_cache()
    emit("zoo_legs", ok=True, legs=rows, tol=f"{ZOO_TOL} x max |plain|",
         launch_tol=f"{ZOO_ELEM_TOL[0]} bf16 steps + {ZOO_ELEM_TOL[1]} x "
                    f"attention over |v|, per element",
         launches=total)
    return total


# ---------------------------------------------------------------------------
# training on the card: granite-8b at full width, cut in depth
# ---------------------------------------------------------------------------

TRAIN_ARCH = "granite-8b"
TRAIN_LAYERS = 8                 # of 36: 2.15 B params, 25.8 GB of state
TRAIN_B, TRAIN_S = 8, 1024
TRAIN_STEPS, TRAIN_WARMUP = 10, 2
TRAIN_LR = 5e-5                  # no warm-up: 1e-4 and above spike at step 2
REMAT_B = 2
FIT_SHARE = 0.9                  # of the card's free memory
PARITY_LAYERS, PARITY_S = 2, 256
ZOO_TRAIN_B, ZOO_TRAIN_S = 2, 64


def _mem_gb(torch):
    return torch.cuda.memory_allocated() / 1e9


def _no_kernel_launched(phase, before, after):
    if before != after:
        die(phase, f"the train path launched a kernel of kernels.ops: "
                   f"{before} -> {after}")


def _leaf_errs(got, want):
    """Max over leaves of max |got - want| / max |want|, and the leaf."""
    from repro_torch.training.tree import leaves_with_paths, path_key
    want = {path_key(p): x for p, x in leaves_with_paths(want)}
    worst, at = 0.0, None
    for p, x in leaves_with_paths(got):
        w = want[path_key(p)].float().cpu()
        e = float((x.float().cpu() - w).abs().max()) / max(
            float(w.abs().max()), 1e-30)
        if e >= worst:
            worst, at = e, path_key(p)
    return worst, at


def _train_batch(cfg, B, S, device, seed=1234):
    """The first batch of the port's `lm_batches` (Zipfian tokens, or
    embeds + labels for a frontend) on `device`."""
    from repro_torch.data.pipeline import lm_batches
    from repro_torch.launch.train import to_device
    embeds_dim = cfg.d_model if cfg.frontend != "none" else None
    return to_device(next(lm_batches(cfg.vocab_size, B, S, seed=seed,
                                     embeds_dim=embeds_dim)), device)


def _card_vs_cpu_step(torch, cfg, params, B, S):
    """value_and_grad of one batch on the card and by the port on the CPU
    from the same weights: (loss rel err, (grad err, leaf), the card's
    missing leaves, the card's loss, CPU params and grads)."""
    from repro_torch.training.train_step import value_and_grad
    from repro_torch.training.tree import tree_map
    batch = _train_batch(cfg, B, S, DEV)
    loss, grads, missing = value_and_grad(params, batch, cfg, remat=False)
    cpu = tree_map(lambda t: t.cpu(), params)
    closs, cgrads, _ = value_and_grad(
        cpu, {k: v.cpu() for k, v in batch.items()}, cfg, remat=False)
    rel = abs(float(loss) - float(closs)) / abs(float(closs))
    return rel, _leaf_errs(grads, cgrads), missing, float(loss), cpu, cgrads


def phase_train_parity(torch):
    """granite-8b at full width, 2 layers, float32: one train step's loss
    and grads on the card against the port's CPU step from the same
    weights and batch (B 1, S 256); then adamw_update fed the CPU's grads,
    on the card and on the CPU."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import init_params
    from repro_torch.training.optimizer import adamw_init, adamw_update
    from repro_torch.training.train_step import train_step
    from repro_torch.training.tree import tree_map
    emit("train_parity_memory", allocated_gb=_mem_gb(torch))
    cfg = dataclasses.replace(get_config(TRAIN_ARCH),
                              n_layers=PARITY_LAYERS, dtype="float32")
    params = init_params(cfg, torch.Generator(device=DEV).manual_seed(0),
                         device=DEV)
    before = ops.launch_counts()
    t0 = time.perf_counter()
    rel, (gerr, gleaf), missing, loss, cpu, cgrads = _card_vs_cpu_step(
        torch, cfg, params, 1, PARITY_S)
    step_s = time.perf_counter() - t0
    new_p, new_o, step_loss = train_step(
        params, adamw_init(params), _train_batch(cfg, 1, PARITY_S, DEV), cfg,
        remat=False)
    _no_kernel_launched("train_parity", before, ops.launch_counts())
    if not (rel <= 1e-5 and gerr <= 1e-3 and not missing
            and int(new_o.step) == 1 and abs(float(step_loss) - loss)
            <= 1e-6 * abs(loss)):
        die("train_parity", f"loss rel {rel}, grads {gerr} at {gleaf}, "
                            f"missing {missing}, step loss {step_loss}")
    del new_p, new_o
    got_p, got_s = adamw_update(tree_map(lambda g: g.to(DEV), cgrads),
                                adamw_init(params), params)
    want_p, want_s = adamw_update(cgrads, adamw_init(cpu), cpu)
    upd = {"params": _leaf_errs(got_p, want_p),
           "m": _leaf_errs(got_s.m, want_s.m),
           "v": _leaf_errs(got_s.v, want_s.v)}
    if not all(e <= 1e-6 for e, _ in upd.values()):
        die("train_parity", f"adamw_update card vs CPU: {upd}")
    emit("train_parity", ok=True, arch=TRAIN_ARCH, n_layers=PARITY_LAYERS,
         dtype="float32", batch=1, seq=PARITY_S, loss=loss,
         loss_rel_err=rel, grad_err=gerr, grad_err_leaf=gleaf,
         update_rel_err={k: e for k, (e, _) in upd.items()},
         value_and_grad_card_and_cpu_s=step_s,
         tol="loss 1e-5 relative; grads 1e-3 x each leaf's max |grad|; "
             "adamw_update 1e-6 x each leaf's max")
    del params, cpu, cgrads, got_p, got_s, want_p, want_s
    gc.collect()
    torch.cuda.empty_cache()


def _train_activation_bytes(cfg, B, S) -> int:
    """What autograd keeps for one step's backward with remat off (an
    estimate from the ops each layer records): the norms' float32 copies
    and outputs, q / k / v and their float32 rope copies, the blocked
    attention's float32 scores and probabilities per live (query, key)
    block pair with its accumulators and float32 k / v blocks, the
    output projection's input, the MLP's gate, up, activation and
    product, per layer; then the embeddings."""
    from repro_torch.models.layers import FLASH_BLOCK
    T, d, H, KV, dh, ff = (B * S, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                           cfg.d_head, cfg.d_ff)
    e, f = (2 if cfg.dtype == "bfloat16" else 4), 4
    blk = min(FLASH_BLOCK, S)
    nq = S // blk
    pairs = nq * (nq + 1) // 2
    attn = pairs * (2 * B * H * blk * blk * f + B * H * blk * dh * f
                    + 2 * B * blk * KV * dh * f) + T * H * dh * f * 2
    per_layer = (2 * T * d * (2 * f + e) + T * (H + 2 * KV) * dh * e
                 + T * (H + KV) * dh * f + attn + T * H * dh * e
                 + T * d * e + 4 * T * ff * e)
    return cfg.n_layers * per_layer + T * d * e


def _train_reckon(cfg, B, S) -> dict:
    """Bytes the step holds, reckoned from the meta-device specs before
    anything is allocated. Steady state: params + AdamW state. Backward:
    plus the activations, the loss's logits (bf16, a float32 copy and its
    float32 grad) and the grads. Update (functional): plus the grads, the
    new params and moments, and four float32 copies of the largest leaf."""
    from repro_torch.launch.specs import opt_state_sds, params_sds, \
        tree_bytes
    from repro_torch.training.tree import leaves
    p_sds = params_sds(cfg)
    P, O = tree_bytes(p_sds), tree_bytes(opt_state_sds(cfg))
    largest = max(t.numel() for t in leaves(p_sds)) * 4
    act = _train_activation_bytes(cfg, B, S)
    logits = B * S * cfg.vocab_padded * (2 + 4 + 4)
    backward = P + O + act + logits + P
    update = P + O + P + (P + O) + 4 * largest
    n_params = sum(t.numel() for t in leaves(p_sds))
    return dict(params_gb=P / 1e9, opt_state_gb=O / 1e9,
                steady_gb=(P + O) / 1e9, grads_gb=P / 1e9,
                activations_gb=act / 1e9, logits_gb=logits / 1e9,
                update_new_gb=(P + O) / 1e9, backward_peak_gb=backward / 1e9,
                update_peak_gb=update / 1e9,
                reckoned_peak_gb=max(backward, update) / 1e9,
                n_params=n_params)


def _train_flops(cfg, n_params, B, S) -> float:
    """6 N T for the weights, plus the causal attention's products: 4 dh
    flops per live (query, key) pair and head in the forward, x3 with the
    backward."""
    attn = 12 * cfg.d_head * B * cfg.n_heads * (S * (S + 1) // 2)
    return 6 * n_params * B * S + cfg.n_layers * attn


def _train_split(torch, step):
    """The device ms of one `step()` by part, from a torch.profiler trace:
    "attention" is the blocked attention (every kernel issued inside
    `flash_attention`, marked by a record_function range, and in the
    backward every kernel of an autograd node whose sequence number one of
    those forward ops recorded), "optimizer" `adamw_update`, "dense" the
    weight products (`aten::mm`, forward and backward) outside those,
    "other" the rest (norms, rope, the loss, elementwise). None where the
    trace holds no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.models import layers as L
    from repro_torch.training import train_step as TS
    real = (L.flash_attention, TS.adamw_update)

    def attn(*a, **kw):
        with record_function("train.attention"):
            return real[0](*a, **kw)

    def adam(*a, **kw):
        with record_function("train.optimizer"):
            return real[1](*a, **kw)
    L.flash_attention, TS.adamw_update = attn, adam
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step()
            torch.cuda.synchronize()
    finally:
        L.flash_attention, TS.adamw_update = real
    evs = prof.profiler.kineto_results.events()
    cpu = [e for e in evs if e.device_type() == DeviceType.CPU]
    host = {e.correlation_id(): e for e in cpu}

    def ranges(name):
        return [(e.start_thread_id(), e.start_ns(), e.end_ns()) for e in cpu
                if e.name() == name]
    attn_r, opt_r = ranges("train.attention"), ranges("train.optimizer")

    def inside(e, rs):
        return any(t == e.start_thread_id() and lo <= e.start_ns() <= hi
                   for t, lo, hi in rs)
    seqs = {e.sequence_nr() for e in cpu
            if e.sequence_nr() >= 0 and inside(e, attn_r)}
    nodes = [(e.start_thread_id(), e.start_ns(), e.end_ns(),
              e.sequence_nr()) for e in cpu
             if e.name().startswith("autograd::engine::evaluate_function")]
    bwd_attn = [(t, lo, hi) for t, lo, hi, s in nodes if s in seqs]
    split = dict.fromkeys(("attention", "dense", "optimizer", "other"), 0.0)
    n = 0
    for e in evs:
        if e.device_type() != DeviceType.CUDA or e.name().startswith(
                "train."):
            continue
        h = host.get(e.linked_correlation_id())
        ms = e.duration_ns() / 1e6
        n += 1
        if h is None:
            split["other"] += ms
        elif inside(h, opt_r):
            split["optimizer"] += ms
        elif inside(h, attn_r) or inside(h, bwd_attn):
            split["attention"] += ms
        elif h.name() in ("aten::mm", "aten::addmm"):
            split["dense"] += ms
        else:
            split["other"] += ms
    total = sum(split.values())
    if total <= 0:
        return None
    out = {k + "_ms": v for k, v in split.items()}
    out.update(device_ms=total, kernels=n,
               attention_share=split["attention"] / total)
    return out


def _attention_yardstick(torch, flush, B, S, H, KV, dh):
    """Forward + backward of the blocked attention (the train path's)
    against scaled_dot_product_attention with its backward, at one
    layer's shapes (causal, bf16): device ms of each, L2 flushed, and the
    two's outputs and grads against each other. SDPA stays off the path."""
    import torch.nn.functional as F
    from repro_torch.models import layers as L
    g = torch.Generator(device=DEV).manual_seed(5)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=DEV).to(torch.bfloat16)
    q, k, v = rnd(B, S, H, dh), rnd(B, S, KV, dh), rnd(B, S, KV, dh)
    go = rnd(B, S, H, dh)
    for t in (q, k, v):
        t.requires_grad_(True)

    def blocked():
        out = L.flash_attention(q, k, v, L.GLOBAL_WINDOW,
                                block_q=L.FLASH_BLOCK, block_k=L.FLASH_BLOCK)
        return (out,) + torch.autograd.grad(out, (q, k, v), go)

    def sdpa():
        try:
            out = F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=True, enable_gqa=True)
        except TypeError:          # a torch without enable_gqa
            rep = lambda t: t.transpose(1, 2).repeat_interleave(  # noqa
                H // KV, dim=1)
            out = F.scaled_dot_product_attention(
                q.transpose(1, 2), rep(k), rep(v), is_causal=True)
        out = out.transpose(1, 2)
        return (out,) + torch.autograd.grad(out, (q, k, v), go)
    errs = {}
    for name, a, b in zip(("out", "dq", "dk", "dv"), blocked(), sdpa()):
        a, b = a.detach().float(), b.detach().float()
        errs[name] = float((a - b).abs().max()) / max(
            float(b.abs().max()), 1e-30)
    ms = time_ms(torch, blocked, flush, iters=5, warmup=2)
    sdpa_ms = time_ms(torch, sdpa, flush, iters=5, warmup=2)
    flops = 12 * dh * B * H * (S * (S + 1) // 2)
    return dict(shape=dict(B=B, S=S, H=H, KV=KV, d=dh, dtype="bfloat16",
                           causal=True),
                blocked_fwd_bwd_ms=ms, sdpa_fwd_bwd_ms=sdpa_ms,
                blocked_over_sdpa=ms / sdpa_ms,
                bound_ms=flops / PEAK_BF16_TC_FLOPS * 1e3,
                blocked_vs_sdpa_rel_err=errs)


def _remat_rows(torch, cfg, params, opt):
    """At B 2 x S 1024 under remat off / none / dots: a train step's ms
    (median of 2 after 1 warm-up), and the peak memory of its forward +
    backward alone (the functional update's new state, the same under
    every policy, stays out of it)."""
    import statistics
    from repro_torch.training.train_step import train_step, value_and_grad
    batch = _train_batch(cfg, REMAT_B, TRAIN_S, DEV, seed=7)
    rows = {}
    for label, remat, policy in (("off", False, "none"),
                                 ("none", True, "none"),
                                 ("dots", True, "dots")):
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = train_step(params, opt, batch, cfg, lr=TRAIN_LR,
                             remat=remat, remat_policy=policy)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            del out
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        loss, grads, _ = value_and_grad(params, batch, cfg, remat=remat,
                                        remat_policy=policy)
        torch.cuda.synchronize()
        rows[label] = dict(step_ms=statistics.median(times[1:]),
                           fwd_bwd_peak_gb=torch.cuda.max_memory_allocated()
                           / 1e9, loss=float(loss))
        del grads
    losses = [r["loss"] for r in rows.values()]
    if max(losses) - min(losses) > 1e-3 * abs(losses[0]):
        die("train_granite", f"remat changed the loss: {rows}")
    return rows


def phase_train_granite(torch, smi_line):
    """granite-8b at full width (d_model 4096, 32 q / 8 KV heads of 128,
    d_ff 14336, vocab 49152, bf16), 8 of its 36 layers, remat off:
    the bytes reckoned from the specs first (B cut until they fit), a
    grad on every param leaf on step 1's batch, then 10 steps of B 8 x
    S 1024 Zipfian tokens from `lm_batches` through
    run_training(make_train_step(...)): losses finite and falling, step
    ms, tokens/s, MFU, peak memory, the device split (torch.profiler),
    remat off / none / dots at B 2, and the attention's yardstick."""
    import dataclasses
    import statistics
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import lm_batches
    from repro_torch.kernels import ops
    from repro_torch.launch.train import to_device
    from repro_torch.models import init_params
    from repro_torch.training.loop import LoopConfig, run_training
    from repro_torch.training.optimizer import adamw_init
    from repro_torch.training.train_step import (make_train_step,
                                                 train_step, value_and_grad)
    from repro_torch.training.tree import leaves_with_paths, path_key
    gc.collect()
    torch.cuda.empty_cache()
    emit("train_granite_memory", allocated_gb=_mem_gb(torch))
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=TRAIN_LAYERS)
    free = torch.cuda.mem_get_info()[0] / 1e9
    B, cuts = TRAIN_B, []
    rk = _train_reckon(cfg, B, TRAIN_S)
    while rk["reckoned_peak_gb"] > FIT_SHARE * free and B > 1:
        cuts.append(f"B {B}: reckoned {rk['reckoned_peak_gb']:.1f} GB > "
                    f"{FIT_SHARE} x {free:.1f} GB free")
        B //= 2
        rk = _train_reckon(cfg, B, TRAIN_S)
    emit("train_granite_reckoned", batch=B, seq=TRAIN_S, free_gb=free,
         cuts=cuts, **rk)
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=DEV).manual_seed(0),
                         device=DEV)
    opt = adamw_init(params)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    before = ops.launch_counts()
    stream = (to_device(b, DEV) for b in lm_batches(cfg.vocab_size, B,
                                                     TRAIN_S))
    # the stream's first batch (the same seed)
    loss1, grads, missing = value_and_grad(
        params, _train_batch(cfg, B, TRAIN_S, DEV), cfg, remat=False)
    bad = [path_key(p) for p, g in leaves_with_paths(grads)
           if not bool(torch.isfinite(g).all())]
    zero = [path_key(p) for p, g in leaves_with_paths(grads)
            if not bool(g.abs().max() > 0)]
    if missing or bad or zero:
        die("train_granite", f"step 1: leaves with no grad {missing}, "
                             f"non-finite {bad}, all-zero {zero}")
    n_leaves = len(leaves_with_paths(grads))
    del grads
    step_fn = make_train_step(cfg, lr=TRAIN_LR, remat=False)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    box = [params, opt]
    del params, opt
    # popped into the call: the loop holds the only reference to each
    # state, so the step before last is freed as the loop moves on
    params, opt, rep = run_training(step_fn, box.pop(0), box.pop(0), stream,
                                    LoopConfig(total_steps=TRAIN_STEPS,
                                               ckpt_dir=None))
    peak = torch.cuda.max_memory_allocated() / 1e9
    _no_kernel_launched("train_granite", before, ops.launch_counts())
    losses = rep.losses
    if not (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]
            and abs(losses[0] - float(loss1)) <= 1e-2 * abs(losses[0])):
        die("train_granite", f"losses {losses} (step 1 alone {loss1})")
    step_s = statistics.median(rep.step_seconds[TRAIN_WARMUP:])
    flops = _train_flops(cfg, rk["n_params"], B, TRAIN_S)
    batch = _train_batch(cfg, B, TRAIN_S, DEV, seed=9)
    split = _train_split(torch, lambda: train_step(params, opt, batch, cfg,
                                                   lr=TRAIN_LR, remat=False))
    del batch
    gc.collect()
    torch.cuda.empty_cache()
    remat = _remat_rows(torch, cfg, params, opt)
    flush = torch.empty(1 << 30, dtype=torch.uint8, device=DEV)
    yard = _attention_yardstick(torch, flush, B, TRAIN_S, cfg.n_heads,
                                cfg.n_kv_heads, cfg.d_head)
    del flush
    emit("train_granite", ok=True, arch=TRAIN_ARCH, n_layers=TRAIN_LAYERS,
         of_layers=get_config(TRAIN_ARCH).n_layers, dtype=cfg.dtype,
         n_params=rk["n_params"], batch=B, seq=TRAIN_S, steps=TRAIN_STEPS,
         lr=TRAIN_LR, init_s=init_s, param_leaves=n_leaves, losses=losses,
         step_s=rep.step_seconds, step_ms=step_s * 1e3,
         tokens_per_s=B * TRAIN_S / step_s, peak_gb=peak,
         reckoned_peak_gb=rk["reckoned_peak_gb"],
         peak_over_reckoned=peak / rk["reckoned_peak_gb"],
         model_flops=flops, mfu=flops / step_s / PEAK_BF16_TC_FLOPS,
         mfu_peak="989 TFLOP/s bf16 dense", device_split=split,
         remat_b2=remat, attention_yardstick=yard, card=smi_line,
         stragglers=rep.straggler_events,
         cut=f"depth {TRAIN_LAYERS} of 36 layers" + (
             f"; batch {B} of {TRAIN_B}" if B != TRAIN_B else ""))
    del params, opt
    gc.collect()
    torch.cuda.empty_cache()


def phase_train_zoo(torch):
    """Every registered arch's reduced() config in float32: one step's
    loss and grads on the card against the port's CPU step from the same
    weights (drawn on the CPU), B 2 x S 64 from `lm_batches`, and one
    train_step on the card. Covers the backward of hymba's scan, the WKV,
    MLA, MoE and the frontends on CUDA."""
    from repro_torch.configs import REGISTRY
    from repro_torch.kernels import ops
    from repro_torch.models import init_params
    from repro_torch.training.optimizer import adamw_init
    from repro_torch.training.train_step import train_step
    from repro_torch.training.tree import tree_map
    emit("train_zoo_memory", allocated_gb=_mem_gb(torch))
    rows = {}
    before = ops.launch_counts()
    for arch in sorted(REGISTRY):
        cfg = REGISTRY[arch].reduced(dtype="float32")
        params = tree_map(lambda t: t.to(DEV), init_params(
            cfg, torch.Generator().manual_seed(0), device="cpu"))
        rel, (gerr, leaf), missing, loss, _, _ = _card_vs_cpu_step(
            torch, cfg, params, ZOO_TRAIN_B, ZOO_TRAIN_S)
        _, new_o, _ = train_step(params, adamw_init(params), _train_batch(
            cfg, ZOO_TRAIN_B, ZOO_TRAIN_S, DEV), cfg, remat=False)
        want_missing = ["embed"] if cfg.frontend != "none" else []
        rows[arch] = dict(loss=loss, loss_rel_err=rel, grad_err=gerr,
                          grad_err_leaf=leaf, missing=missing)
        if not (rel <= 1e-5 and gerr <= 1e-4 and missing == want_missing
                and int(new_o.step) == 1):
            die("train_zoo", f"{arch}: {rows[arch]}")
    _no_kernel_launched("train_zoo", before, ops.launch_counts())
    emit("train_zoo", ok=True, archs=rows, batch=ZOO_TRAIN_B,
         seq=ZOO_TRAIN_S, tol="loss 1e-5 relative; grads 1e-4 x each "
         "leaf's max |grad|")
    torch.cuda.empty_cache()


def phase_train_loop(torch):
    """The launcher's main() on the card (reduced granite, 4 steps), then
    run_training as the reference's test drives it: 10 steps with a
    checkpoint every 4 in a temp dir, a failure injected at step 7
    (retried once), and a rerun that resumes from step 8."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch_train
    from repro_torch.models import init_params
    from repro_torch.training.loop import LoopConfig, run_training
    from repro_torch.training.optimizer import adamw_init
    from repro_torch.training.train_step import make_train_step
    from repro_torch.training.tree import leaves
    emit("train_loop_memory", allocated_gb=_mem_gb(torch))
    before = ops.launch_counts()
    rep = launch_train.main(["--steps", "4", "--batch", "2", "--seq", "64"])
    if not (rep.steps_run == 4 and all(math.isfinite(x)
                                       for x in rep.losses)):
        die("train_loop", f"launcher: {rep}")
    cfg = get_config(TRAIN_ARCH).reduced(n_layers=1, d_model=32, n_heads=2,
                                         n_kv_heads=2, d_head=16, d_ff=32)
    params = init_params(cfg, torch.Generator(device=DEV).manual_seed(0),
                         device=DEV)
    opt = adamw_init(params)
    step_fn = make_train_step(cfg, remat=False)
    g = torch.Generator(device=DEV).manual_seed(0)
    batches = [{"tokens": torch.randint(0, cfg.vocab_size, (2, 16),
                                        generator=g, device=DEV)}
               for _ in range(12)]
    boom = {"armed": True}

    def injector(step):
        if step == 7 and boom["armed"]:
            boom["armed"] = False
            raise RuntimeError("simulated preemption")
    root = os.path.join(WORK, "train-ckpt")
    shutil.rmtree(root, ignore_errors=True)
    p1, o1, rep1 = run_training(step_fn, params, opt, batches,
                                LoopConfig(total_steps=10, ckpt_every=4,
                                           ckpt_dir=root),
                                failure_injector=injector)
    p2, o2, rep2 = run_training(step_fn, params, opt, batches,
                                LoopConfig(total_steps=10, ckpt_every=4,
                                           ckpt_dir=root))
    _no_kernel_launched("train_loop", before, ops.launch_counts())
    on_card = all(t.is_cuda for t in leaves((p2, o2)))
    diff = max(float((a.float() - b.float()).abs().max())
               for a, b in zip(leaves((p1, o1)), leaves((p2, o2))))
    if not (rep1.steps_run == 10 and rep1.retries == 1
            and rep2.resumed_from == 8 and rep2.steps_run == 2 and on_card
            and int(o2.step) == 10):
        die("train_loop", f"first run {rep1}, resumed run {rep2}, "
                          f"on the card {on_card}")
    shutil.rmtree(root, ignore_errors=True)
    emit("train_loop", ok=True, launcher_losses=rep.losses,
         retries=rep1.retries, resumed_from=rep2.resumed_from,
         resumed_steps=rep2.steps_run, ckpts=len(rep1.ckpts),
         resumed_vs_uninterrupted_max_abs=diff)


# --------------------------------------------------------------------------
# the launch tooling: granite-8b's dry-run cells, reckoned and run
# --------------------------------------------------------------------------

DRYRUN_ARCH = "granite-8b"
DRYRUN_SHAPES = ("train_4k", "prefill_32k", "decode_32k")
DRYRUN_LAYERS = 2                        # of 36
DRYRUN_BATCH = {"train_4k": 2, "prefill_32k": 1, "decode_32k": 128}
DRYRUN_REPS = 5                          # timed steps, after one warm-up
DRYRUN_TIMEOUT = 900                     # s, for the full-width dry runs
FLOPS_RTOL = 1e-6                        # the counter's vs FlopCounterMode's
# reckoned / measured, for the step's transient (the counter's temp
# against max_memory_allocated less memory_allocated before the step) and
# for the whole peak (arguments + temp); the card's readings were within
# 1.5e-3 of 1 (decode_32k's transient)
PEAK_BAND = (0.995, 1.005)
HOLD_ROWS = 256                          # D at S 32768: its last query rows
HOLD_ITEMS = 8                           # B at B 128: its first items
# D at S 32768, B at S 32768: max |got - want| <= HOLD_RTOL x max |want|.
# The outputs are softmax means over 32k keys, about 1e-2, so the limit
# scales with them: about 2.5 bf16 ulps of the largest output
HOLD_RTOL = 2e-2
CHILDREN = []                            # background processes; main stops


def start_dryruns():
    """`python -m repro_torch.launch.dryrun` for granite-8b's three cells
    at full width (36 layers), started in the background with no card
    visible: a dry run touches no device. They run
    beside `phase_dryrun_granite`'s card work only, whose times are CUDA
    events; every earlier phase has ended. Each writes its record under
    WORK."""
    env = dict(os.environ, PYTHONPATH=SRC, CUDA_VISIBLE_DEVICES="")
    procs = {}
    for shape in DRYRUN_SHAPES:
        out = os.path.join(WORK, f"dryrun_{shape}.json")
        with open(out, "w") as fo, open(out + ".err", "w") as fe:
            p = subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                 DRYRUN_ARCH, "--shape", shape], stdout=fo, stderr=fe,
                env=env, cwd=HERE)
        CHILDREN.append(p)
        procs[shape] = (p, out)
    return procs


def _dryrun_records(procs):
    """Each full-width record: ok, on 256 devices, priced at h100-sxm."""
    recs = {}
    for shape, (p, out) in procs.items():
        try:
            p.wait(timeout=DRYRUN_TIMEOUT)
        except subprocess.TimeoutExpired:
            p.kill()
            die("dryrun_granite", f"the {shape} dry run ran over "
                                  f"{DRYRUN_TIMEOUT} s")
        with open(out + ".err") as f:
            err = f.read()[-2000:]
        if p.returncode != 0:
            die("dryrun_granite", f"the {shape} dry run exited "
                                  f"{p.returncode}: {err}")
        with open(out) as f:
            rec = json.load(f)
        if not (rec.get("ok") and rec.get("n_devices") == 256
                and rec.get("peaks") == "h100-sxm"
                and rec.get("n_layers") == 36):
            die("dryrun_granite", f"the {shape} record: ok "
                                  f"{rec.get('ok')}, n_devices "
                                  f"{rec.get('n_devices')}, peaks "
                                  f"{rec.get('peaks')}, "
                                  f"{rec.get('error')}")
        emit("dryrun_record", ok=True, arch=DRYRUN_ARCH, shape=shape,
             n_devices=rec["n_devices"], peaks=rec["peaks"],
             mesh=rec["mesh"], trace_s=rec["trace_s"],
             roofline=rec["roofline"],
             per_device_bytes=rec["per_device_bytes"],
             flops_per_dev=rec["flops_per_dev"],
             bytes_per_dev=rec["bytes_per_dev"],
             useful_flops_ratio=rec["useful_flops_ratio"],
             kernel_calls=rec["kernel_calls"],
             microbatches=rec["microbatches"], reckoned=True)
        recs[shape] = rec
    return recs


def _dryrun_cut(shape_name):
    """(cfg, shape, fn, args stand-ins) of the cell from the dry run's own
    build_cell, cut to DRYRUN_LAYERS layers and DRYRUN_BATCH items."""
    import dataclasses
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_production_mesh
    cfg = dataclasses.replace(get_config(DRYRUN_ARCH),
                              n_layers=DRYRUN_LAYERS)
    full = SHAPES[shape_name]
    shape = ShapeConfig(full.name, full.seq_len, DRYRUN_BATCH[shape_name],
                        full.kind)
    fn, sds, _, _ = D.build_cell(cfg, shape, make_production_mesh())
    return cfg, shape, fn, sds


def _dryrun_args(torch, cfg, shape):
    """Real arguments of the cut cell on the card: seeded random weights
    (and AdamW state), random tokens, and for decode a cache of random
    bf16 K / V with every item at length S - 1 (the new token's K / V go
    to position S - 1, and every row is then visible)."""
    from repro_torch.models import init_params
    from repro_torch.models.transformer import init_cache
    from repro_torch.training.optimizer import adamw_init
    g = torch.Generator(device=DEV).manual_seed(0)
    params = init_params(cfg, g, device=DEV)
    B, S = shape.global_batch, shape.seq_len
    batch = {"tokens": torch.randint(
        0, cfg.vocab_size, (B, 1 if shape.kind == "decode" else S),
        generator=g, device=DEV, dtype=torch.int32)}
    if shape.kind == "train":
        return (params, adamw_init(params), batch)
    if shape.kind == "prefill":
        return (params, batch)
    cache = init_cache(cfg, B, S, device=DEV)
    for name in ("k", "v"):
        cache[name].normal_(generator=g)
    cache["lengths"].fill_(S - 1)
    return (params, cache, batch)


def _launch_delta(before, after):
    return {k: after[k] - before[k] for k in after
            if not isinstance(after[k], dict) and after[k] != before[k]}


def _dryrun_cell_run(torch, shape_name):
    """The cut cell: a fake trace (the op counter) and the real step on
    the card. Fails unless the trace's kernel calls equal the real step's
    launches, its aten flops equal FlopCounterMode's on the real step
    within FLOPS_RTOL, the median step (CUDA events) is at least the
    counter's roofline bound, and the reckoned peak (arguments + temp)
    over the measured one, and the counter's temp over the step's measured
    transient, lie in PEAK_BAND. Returns (row, launches on the
    path, the real arguments)."""
    import contextlib
    import statistics
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import SHAPES
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import H100_SXM
    from repro_torch.launch.specs import tree_bytes
    from repro_torch.training.tree import leaves
    phase = "dryrun_granite"
    cfg, shape, fn, sds = _dryrun_cut(shape_name)
    tr = D.trace_cell(fn, sds, "cpu" if shape.kind == "train" else "cuda")
    args = _dryrun_args(torch, cfg, shape)
    layout = [(tuple(t.shape), t.dtype) for t in leaves(args)]
    if layout != [(tuple(t.shape), t.dtype) for t in leaves(sds)]:
        die(phase, f"{shape_name}: the real arguments differ from the "
                   f"cell's stand-ins")
    arg_bytes = sum(tree_bytes(a) for a in sds)
    grad = shape.kind == "train"

    def step():
        with (contextlib.nullcontext() if grad else torch.no_grad()):
            return fn(*args)
    start = ops.launch_counts()
    out = step()                                  # warm-up
    torch.cuda.synchronize()
    del out
    before = ops.launch_counts()
    with FlopCounterMode(display=False) as fc:
        out = step()
    torch.cuda.synchronize()
    launched = _launch_delta(before, ops.launch_counts())
    del out
    gc.collect()
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = step()
    torch.cuda.synchronize()
    transient = torch.cuda.max_memory_allocated() - resident
    peak = arg_bytes + transient
    del out
    times = []
    for _ in range(DRYRUN_REPS):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        out = step()
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e))
        del out
    end = ops.launch_counts()
    path = _launch_delta(start, end)
    by_body = {b: end["prefill_attention_by_body"][b]
               - start["prefill_attention_by_body"][b]
               for b in start["prefill_attention_by_body"]}
    ms = statistics.median(times)
    calls = {k: v["calls"] for k, v in tr["kernel_calls"].items()}
    real_flops = fc.get_total_flops()
    rel = abs(tr["aten_flops"] - real_flops) / max(real_flops, 1)
    t_compute = tr["flops"] / H100_SXM.flops * 1e3
    t_memory = tr["bytes"] / H100_SXM.hbm_bw * 1e3
    bound_ms = max(t_compute, t_memory)
    reckoned = arg_bytes + tr["peak_bytes"]
    row = dict(shape=shape_name, n_layers=cfg.n_layers, of_layers=36,
               batch=shape.global_batch, seq=shape.seq_len,
               cut=f"depth {cfg.n_layers} of 36; batch "
                   f"{shape.global_batch} of "
                   f"{SHAPES[shape_name].global_batch}",
               step_ms=ms, step_ms_all=times, kernel_calls=calls,
               launches=launched, trace_s=tr["trace_s"],
               counter_aten_flops=tr["aten_flops"],
               flop_counter_mode_flops=real_flops, flops_rel_err=rel,
               counter_flops=tr["flops"], counter_bytes=tr["bytes"],
               bound_ms=bound_ms,
               bound_by="operations" if t_compute >= t_memory else "bytes",
               share=bound_ms / ms, reckoned_peak_gb=reckoned / 1e9,
               arguments_gb=arg_bytes / 1e9,
               temp_gb=tr["peak_bytes"] / 1e9, measured_peak_gb=peak / 1e9,
               measured_transient_gb=transient / 1e9,
               temp_ratio=tr["peak_bytes"] / transient,
               peak_ratio=reckoned / peak, peak_band=PEAK_BAND,
               path_launches=path, prefill_by_body=by_body)
    fails = []
    if calls != launched:
        fails.append(f"kernel calls {calls} != launches {launched}")
    if rel > FLOPS_RTOL:
        fails.append(f"aten flops {tr['aten_flops']} vs FlopCounterMode "
                     f"{real_flops} (rel {rel})")
    if not bound_ms <= ms:
        fails.append(f"step {ms} ms under the bound {bound_ms} ms")
    for ratio in ("temp_ratio", "peak_ratio"):
        if not PEAK_BAND[0] <= row[ratio] <= PEAK_BAND[1]:
            fails.append(f"{ratio} {row[ratio]} outside {PEAK_BAND}")
    row["ok"] = not fails
    emit("dryrun_cut", **row)
    if fails:
        die(phase, f"{shape_name}: " + "; ".join(fails))
    return row, path, by_body, args, cfg


def _hold(got, want):
    """(max |got - want|, the limit HOLD_RTOL x max |want|, max |want|)."""
    top = float(want.float().abs().max())
    return (float((got.float() - want.float()).abs().max()),
            HOLD_RTOL * top, top)


def _without(torch, ts, lo, n):
    """Each (B, S, ...) tensor of `ts` without positions [lo, lo + n)."""
    return [torch.cat([t[:, :lo], t[:, lo + n:]], 1) for t in ts]


def _dryrun_d_row(torch, flush, cfg, S):
    """Kernel D at granite's prefill_32k item: B 1, S 32768, KV 8, G 4,
    d 128, causal, bf16. Its plain version would build 137 GB of float32
    scores, so the last HOLD_ROWS query rows are held against all keys
    with the plain version on that slice (the fused-query decode's plain
    version: rows at lengths - Lq + r, causal). A planted fault must fail
    the hold: the plain version with one of D's key tiles (64 positions,
    at S / 2) left out of every held row."""
    import torch.nn.functional as F
    from repro_torch.kernels import prefill_attention as PA
    from repro_torch.kernels import ref
    g = torch.Generator(device=DEV).manual_seed(7)
    KV, dh = cfg.n_kv_heads, cfg.d_head
    G = cfg.n_heads // KV

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=DEV).to(torch.bfloat16)
    q, k, v = rnd(1, S, KV, G, dh), rnd(1, S, KV, dh), rnd(1, S, KV, dh)
    lengths = torch.full((1,), S, dtype=torch.int32, device=DEV)
    qs = q[:, -HOLD_ROWS:].contiguous()

    def kern():
        return PA.prefill_attention(q, k, v, window=GLOBAL, causal=True)

    def plain():
        return ref.decode_query_attention_ref(qs, k, v, lengths,
                                              window=GLOBAL)
    got, want = kern(), plain()
    torch.cuda.synchronize()
    err, tol, top = _hold(got[:, -HOLD_ROWS:], want)
    kd, vd = _without(torch, (k, v), S // 2, 64)
    fault = ref.decode_query_attention_ref(qs, kd, vd, lengths - 64,
                                           window=GLOBAL)
    fault_err = _hold(fault, want)[0]
    del kd, vd, fault
    row = dict(kernel="prefill_attention", body=PA.body(q.dtype, dh, dh),
               shape=f"granite-prefill-S{S}", B=1, S=S, KV=KV, G=G, dk=dh,
               dv=dh, dtype="bfloat16", window=GLOBAL, causal=True,
               max_abs_err=err, tol=tol, tol_rule=f"{HOLD_RTOL} x max|want|",
               max_abs_want=top,
               held=f"the last {HOLD_ROWS} query rows against all keys",
               planted_fault=f"key tile [{S // 2}, {S // 2 + 64}) left out",
               planted_fault_err=fault_err,
               main_path_shape=False, dryrun_path_shape=True,
               ok=bool(err <= tol and math.isfinite(err)
                       and fault_err > tol))
    row["kernel_ms"] = time_ms(torch, kern, flush, iters=10)
    row["kernel_ms_read"] = time_ms(torch, kern, flush, iters=10,
                                    mode="read")
    row["plain_ms"] = time_ms(torch, plain, flush, iters=5)
    row["plain_scope"] = f"the held {HOLD_ROWS} rows"
    row["bound_ms"], row["bound_by"], row["f32_fma_ms"] = prefill_bound(
        q, k, v, GLOBAL, True)
    qh = q.reshape(1, S, KV * G, dh).transpose(1, 2)
    kh, vh = k.transpose(1, 2), v.transpose(1, 2)

    def sdpa():
        return F.scaled_dot_product_attention(qh, kh, vh, is_causal=True,
                                              enable_gqa=True)
    row["library_ms"] = time_ms(torch, sdpa, flush, iters=10)
    row["library_ms_read"] = time_ms(torch, sdpa, flush, iters=10,
                                     mode="read")
    emit("kernel", **row)
    if not row["ok"]:
        die("kernel", f"prefill_attention at S {S}: error {err} on the "
                      f"last {HOLD_ROWS} rows, the planted fault's "
                      f"{fault_err}, limit {tol}")
    return row


def _dryrun_b_row(torch, flush, cfg, cache):
    """Kernel B at granite's decode_32k step on the cut run's own cache
    (layer 0: B 128, S 32768, KV 8, G 4, d 128, bf16, every row visible).
    Its plain version makes float32 copies of the whole K / V (34 GB), so
    it is held on the first HOLD_ITEMS items: both are batch-invariant. A
    planted fault must fail the hold: the plain version with one of B's
    splits (128 positions, at S / 2) left out."""
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import ref
    k, v = cache["k"][0], cache["v"][0]
    B, S, KV, dh = k.shape
    G = cfg.n_heads // KV
    g = torch.Generator(device=DEV).manual_seed(8)
    q = torch.randn((B, KV, G, dh), generator=g, device=DEV).to(
        torch.bfloat16)
    lengths = torch.full((B,), S, dtype=torch.int32, device=DEV)
    n = HOLD_ITEMS

    def kern():
        return DA.decode_attention(q, k, v, lengths)

    def plain():
        return ref.decode_attention_ref(q[:n], k[:n], v[:n], lengths[:n])
    got, want = kern(), plain()
    torch.cuda.synchronize()
    err, tol, top = _hold(got[:n], want)
    kd, vd = _without(torch, (k[:n], v[:n]), S // 2, 128)
    fault = ref.decode_attention_ref(q[:n], kd, vd, lengths[:n] - 128)
    fault_err = _hold(fault, want)[0]
    del kd, vd, fault
    row = dict(kernel="decode_attention", shape=f"granite-decode-B{B}-S{S}",
               B=B, Lq=1, KV=KV, G=G, dk=dh, S=S, dtype="bfloat16",
               kv_dtype="bfloat16", window=GLOBAL, max_abs_err=err,
               tol=tol, tol_rule=f"{HOLD_RTOL} x max|want|", max_abs_want=top,
               held=f"the first {n} of {B} items",
               planted_fault=f"split [{S // 2}, {S // 2 + 128}) left out",
               planted_fault_err=fault_err,
               main_path_shape=False, dryrun_path_shape=True,
               ok=bool(err <= tol and math.isfinite(err)
                       and fault_err > tol))
    row["kernel_ms"] = time_ms(torch, kern, flush, iters=10)
    row["kernel_ms_read"] = time_ms(torch, kern, flush, iters=10,
                                    mode="read")
    row["plain_ms"] = time_ms(torch, plain, flush, iters=5)
    row["plain_scope"] = f"the held {n} items"
    row["visible_rows"] = B * S
    row["bound_ms"], row["bound_by"] = decode_bound(q, k, v, [S] * B,
                                                    GLOBAL)
    qh = q.reshape(B, KV * G, 1, dh)
    kh, vh = k.transpose(1, 2), v.transpose(1, 2)

    def sdpa():
        return F.scaled_dot_product_attention(qh, kh, vh, enable_gqa=True)
    row["library_ms"] = time_ms(torch, sdpa, flush, iters=10)
    row["library_ms_read"] = time_ms(torch, sdpa, flush, iters=10,
                                     mode="read")
    emit("kernel", **row)
    if not row["ok"]:
        die("kernel", f"decode_attention at B {B} x S {S}: error {err} on "
                      f"{n} items, the planted fault's {fault_err}, limit "
                      f"{tol}")
    return row


def _fake_route_cost(torch):
    """Host ns per call that the shape-only route's check adds to every
    kernel call on a real tensor, and a B call's whole host time (us, the
    planted flush's shape, no sync) for scale."""
    from repro_torch.kernels import cost
    from repro_torch.kernels import decode_attention as DA
    x = torch.zeros(8, device=DEV)
    n = 200_000
    t0 = time.perf_counter()
    for _ in range(n):
        cost.is_fake(x)
    check_ns = (time.perf_counter() - t0) / n * 1e9
    q = torch.randn((16, 2, 1, 16), device=DEV)
    k = torch.randn((16, 256, 2, 16), device=DEV)
    lengths = torch.full((16,), 200, dtype=torch.int32, device=DEV)
    DA.decode_attention(q, k, k, lengths)
    torch.cuda.synchronize()
    reps = 2000
    t0 = time.perf_counter()
    for _ in range(reps):
        DA.decode_attention(q, k, k, lengths)
    call_us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return check_ns, call_us, reps + 1


def phase_dryrun_granite(torch, smi_line):
    """granite-8b's prefill_32k, decode_32k and train_4k: each cell cut to
    2 of 36 layers (prefill B 1 of 32, decode B 128, train B 2 of 256 with
    AdamW) traced by the op counter and run on the card, held to each
    other; kernel D at S 32768 and kernel B at B 128 x S 32768 against
    their plain versions; and the full-width dry-run records, which run in
    the background meanwhile (`start_dryruns`, after the fake route's host
    cost is measured). Returns (launches on the path, kernel rows)."""
    from repro_torch.kernels import ops
    gc.collect()
    torch.cuda.empty_cache()
    emit("dryrun_granite_memory", allocated_gb=_mem_gb(torch))
    t0 = time.perf_counter()
    check_ns, call_us, fake_calls = _fake_route_cost(torch)  # off the path
    procs = start_dryruns()
    flush = torch.empty(1 << 30, dtype=torch.uint8, device=DEV)
    path = dict.fromkeys(ops.KERNELS, 0)
    by_body = {"tc": 0, "fma": 0}
    cuts, rows = {}, {"decode_attention": [], "prefill_attention": []}
    for shape in ("prefill_32k", "decode_32k", "train_4k"):
        row, launched, bodies, args, cfg = _dryrun_cell_run(torch, shape)
        cuts[shape] = row
        for k, n in launched.items():
            path[k] += n
        for b, n in bodies.items():
            by_body[b] += n
        if shape == "prefill_32k":
            del args
            gc.collect()
            torch.cuda.empty_cache()
            rows["prefill_attention"].append(
                _dryrun_d_row(torch, flush, cfg, row["seq"]))
        elif shape == "decode_32k":
            rows["decode_attention"].append(
                _dryrun_b_row(torch, flush, cfg, args[1]))
        args = None
        gc.collect()
        torch.cuda.empty_cache()
    del flush
    t_wait = time.perf_counter()
    recs = _dryrun_records(procs)
    wait_s = time.perf_counter() - t_wait
    path["prefill_attention_by_body"] = by_body
    emit("dryrun_granite", ok=True, arch=DRYRUN_ARCH, card=smi_line,
         records={s: {"trace_s": r["trace_s"], "roofline": r["roofline"],
                      "per_device_bytes": r["per_device_bytes"]}
                  for s, r in recs.items()},
         waited_for_records_s=wait_s,
         cuts={s: {k: r[k] for k in ("step_ms", "bound_ms", "bound_by",
                                     "share", "temp_ratio", "peak_ratio",
                                     "kernel_calls", "flops_rel_err")}
               for s, r in cuts.items()},
         fake_check_ns_per_call=check_ns, decode_call_host_us=call_us,
         fake_cost_calls_not_on_path=fake_calls,
         seconds=time.perf_counter() - t0,
         path_launches={k: v for k, v in path.items() if v})
    return path, rows


KERNEL_META = {
    "decode_query_attention": ("src/repro_torch/csrc/decode_attention.cu",
                               "src/repro/kernels/decode_attention.py:185"),
    "decode_query_attention_int8": (
        "src/repro_torch/csrc/decode_attention.cu",
        "src/repro/kernels/decode_attention.py:203"),
    "decode_attention": ("src/repro_torch/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention.py:60"),
    "decode_attention_int8": ("src/repro_torch/csrc/decode_attention.cu",
                              "src/repro/kernels/decode_attention.py:78"),
    "expected_attention_scores": (
        "src/repro_torch/csrc/expected_attention.cu",
        "src/repro/kernels/expected_attention.py:53"),
}
# kernel E's two entries: XLA-compiled code in the JAX package (no
# pallas_call), the bisection and the custom VJP's backward
E_META = {
    "beta_incinv": ("src/repro_torch/csrc/beta_bounds.cu",
                    "src/repro/core/bounds.py:27"),
    "beta_incinv_grad_terms": ("src/repro_torch/csrc/beta_bounds.cu",
                               "src/repro/core/bounds.py:54"),
}
# kernel D's two bodies, each a kernel of its own in the kernels line
PREFILL_BODIES = {
    "tc": ("src/repro_torch/csrc/prefill_attention_tc.cu",
           "src/repro/kernels/prefill_attention.py:28"),
    "fma": ("src/repro_torch/csrc/prefill_attention.cu",
            "src/repro/kernels/prefill_attention.py:28"),
}


# bfloat16 paths besides the 8B ones: D's tensor-core body only
BF16_PATHS = ("session_deepseek", "session_hymba", "session_rwkv6",
              "zoo_legs", "dryrun_granite")


def _check_prefill_bodies(paths):
    """D's body on each path: the tensor-core body on every bf16 path
    (8B, the zoo) that builds profiles and on no planted one, the FMA body
    on no bf16 path."""
    for path, counts in paths.items():
        by_body = counts["prefill_attention_by_body"]
        if path in BF16_PATHS or "llama8b" in path:
            if by_body["fma"] or (counts["prefill_attention"]
                                  and not by_body["tc"]):
                die("kernels", f"{path} launched D's FMA body or no "
                               f"tensor-core body: {by_body}")
        elif by_body["tc"]:
            die("kernels", f"planted path {path} launched D's tensor-core "
                           f"body: {by_body}")
    for path in ("llama8b", "session_llama8b", "session_join_llama8b",
                 "session_hymba", "zoo_legs"):
        if paths[path]["prefill_attention_by_body"]["tc"] <= 0:
            die("kernels", f"{path} launched no tensor-core body of D")


def _timing(row):
    return {"ms": row["kernel_ms"], "ms_read_flush": row.get("kernel_ms_read"),
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"]}


def _kernel_entry(name, source, replaces, rows, launches_by_path):
    """One kernel's entry of the kernels line: its row at the main path's
    shape, (B, C, D's tensor-core body) its row at the hymba Session's
    shape under "hymba", and (B, D's tensor-core body) its row at
    granite-8b's dry-run cell under "dryrun_granite"."""
    row = [r for r in rows if r.get("main_path_shape")][0]
    if sum(launches_by_path.values()) <= 0:
        die("kernels", f"{name} was launched on no Session path")
    entry = {"name": name, "route": "cuda", "source": source,
             "replaces": replaces,
             "launches": sum(launches_by_path.values()),
             "launches_by_path": launches_by_path,
             "max_abs_err": max(r["max_abs_err"] for r in rows),
             **_timing(row)}
    hymba = [r for r in rows if r.get("hymba_path_shape")]
    if hymba:
        entry["hymba"] = {"shape": hymba[0]["shape"], **_timing(hymba[0])}
    dry = [r for r in rows if r.get("dryrun_path_shape")]
    if dry:
        entry["dryrun_granite"] = {"shape": dry[0]["shape"],
                                   **_timing(dry[0])}
    return entry


def main() -> int:
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print("chip_smoke.py: src/repro_torch not found next to this script",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: CUDA is not available; the port's path runs "
              "on the card only", file=sys.stderr)
        return 1
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK, exist_ok=True)
    t_start = time.perf_counter()
    try:
        smi_line = phase_device(torch)
        phase_build()
        flush = torch.empty(1 << 30, dtype=torch.uint8, device="cuda")
        rows = phase_kernels(torch, flush)
        del flush
        phase_planted(torch)
        paths = {}
        paths["llama8b"], params = phase_llama8b(torch)
        problems = {}
        (paths["session_planted"], paths["session_planted_scan"],
         paths["baselines_planted"], problems["session_planted"],
         paths["sharded_planted"]) = phase_session_planted(torch)
        paths["session_join_planted"], paths["session_join_planted_hand"] \
            = phase_session_join_planted(torch)
        (paths["session_llama8b"], paths["session_llama8b_scan"],
         problems["session_llama8b"], kept) = \
            phase_session_llama8b(torch, params)
        paths["sharded_llama8b"] = phase_sharded_llama8b(torch, kept, params)
        paths["baselines_llama8b"] = phase_baselines_llama8b(torch, kept)
        del kept
        paths["session_join_llama8b"] = phase_session_join_llama8b(torch,
                                                                   params)
        paths["pool_planted"], planted = phase_pool_planted(torch)
        paths["scheduler_planted"] = phase_scheduler_planted(torch, planted)
        paths["remote_planted"], remote_run = phase_remote_planted(torch,
                                                                   planted)
        phase_remote_worker_cli(torch, planted, remote_run)
        paths["pool_llama8b"], llama = phase_pool_llama8b(torch, params)
        paths["scheduler_llama8b"] = phase_scheduler_llama8b(torch, llama)
        paths["remote_llama8b"] = phase_remote_llama8b(torch, params, llama)
        phase_flush_invariance(torch, planted, llama)
        planted[0].close()
        llama[0].close()
        del planted, llama, params
        torch.cuda.empty_cache()
        paths["serve_planted"] = phase_serve_planted(torch)
        phase_pool_release(torch)
        paths["session_deepseek"] = phase_session_deepseek(torch)
        paths["session_hymba"] = phase_session_hymba(torch)
        paths["session_rwkv6"] = phase_session_rwkv6(torch)
        paths["zoo_legs"] = phase_zoo_legs(torch)
        _check_prefill_bodies(paths)
        phase_train_parity(torch)
        phase_train_granite(torch, smi_line)
        phase_train_zoo(torch)
        phase_train_loop(torch)
        rows.update(phase_planner(torch, problems))
        paths["dryrun_granite"], dry_rows = phase_dryrun_granite(torch,
                                                                 smi_line)
        for name, extra in dry_rows.items():
            rows[name] = rows[name] + extra
    finally:
        for p in CHILDREN:
            if p.poll() is None:
                p.kill()
            p.wait()
        shutil.rmtree(WORK, ignore_errors=True)
    session_paths = {p: c for p, c in paths.items() if p != "llama8b"}
    kernels = [_kernel_entry(name, source, replaces, rows[name],
                             {p: c[name] for p, c in session_paths.items()})
               for name, (source, replaces) in {**KERNEL_META,
                                                **E_META}.items()]
    for body, (source, replaces) in PREFILL_BODIES.items():
        kernels.append(_kernel_entry(
            f"prefill_attention_{body}", source, replaces,
            [r for r in rows["prefill_attention"] if r["body"] == body],
            {p: c["prefill_attention_by_body"][body]
             for p, c in session_paths.items()}))
    emit("summary", ok=True, seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
