#!/usr/bin/env python3
"""Drive the PyTorch port of Stretto on one NVIDIA card, end to end.

    python3 chip_smoke.py          # from the root of a checkout

Phases, one JSON line each:
  device   the card (and the `nvidia-smi` name / power-limit line)
  build    nvcc builds every kernel of src/repro_torch/csrc/, in parallel
  kernel   each hand-written CUDA kernel against its plain PyTorch version
           on the card, at the planted and the stretto-llama-8b shapes:
           max abs error within the stated tolerance, and its time beside
           the plain version's, the bound and (bf16/f32 decode) one SDPA
           call; the decode kernels in float32/bfloat16 and over int8 K/V
           (kernel_edges: rows that see no cache position, and an item's
           output alone vs in a larger, further-padded batch)
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
           gradient planner), execute, metrics against gold; the same plan
           on the CPU equal outside a margin; scan-path flushes (kernel B,
           B-int8)
  session_llama8b  the same query through Session(cfg, engine=eng) with
           stretto-llama-8b registered as "lg" (rungs 0.8 / 0.5 / int8 0.5
           / gold), 32 items of 512 tokens, scan-path flushes, and one
           int8 flush's logits kernel vs plain
Then the kernels line, the nvidia-smi line and, last, the result line.

Launch counts: every count is set to 0 just before a path is driven and
read just after. The kernels line carries, per kernel, the sum of its
counts over the two Session paths and their scan legs, and each path's
count. Any failed phase exits non-zero. Without CUDA, or without the
repository around it, the script exits non-zero and prints no result.
"""
from __future__ import annotations

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

PEAK_BYTES_S = 3.35e12        # H100 SXM HBM3
PEAK_F32_FLOPS = 67e12        # H100 SXM float32 outside the tensor cores
GLOBAL = 1 << 30


def emit(phase: str, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def die(phase: str, err: str):
    emit(phase, ok=False, error=err)
    sys.exit(1)


# --------------------------------------------------------------------------
# timing and bounds
# --------------------------------------------------------------------------

def time_ms(torch, fn, flush, iters=20, warmup=3) -> float:
    """Median device time of fn() over `iters` launches, CUDA events, with
    the 50 MB L2 cache flushed before each one. The flush (a 1 GB memset,
    about 0.3 ms) also gives the host time to enqueue the call before the
    card reaches the start event, so host overhead stays out of the time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    evs = []
    for _ in range(iters):
        flush.zero_()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        evs.append((s, e))
    torch.cuda.synchronize()
    t = sorted(s.elapsed_time(e) for s, e in evs)
    return t[len(t) // 2]


def bound(nbytes: float, flops: float):
    tb, tf = nbytes / PEAK_BYTES_S * 1e3, flops / PEAK_F32_FLOPS * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def decode_bound(q, k, v, lengths, window, scale_bytes=0):
    """Least time for a decode call on these inputs: the visible K/V rows
    (positions below each item's length inside some row's window) read
    once, with `scale_bytes` per visible (position, head) of dequantisation
    scales (8 for int8 K and V: two float32), q read and the output written
    once; 4 flops per query row per K or V element of a visible row
    (float32 FMAs)."""
    B, Lq, KV, G, dk = q.shape if q.dim() == 5 else \
        (q.shape[0], 1) + tuple(q.shape[1:])
    S, dv = v.shape[1], v.shape[3]
    vis = 0
    for n in lengths.tolist():
        hi = min(n, S)
        lo = max(0, n - Lq - window + 1)
        vis += max(0, hi - lo)
    nbytes = (vis * KV * ((dk + dv) * k.element_size() + scale_bytes)
              + q.numel() * q.element_size() * (1 + dv / dk) + 4 * B)
    flops = vis * KV * Lq * G * 2 * (dk + dv)
    return bound(nbytes, flops)


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


def phase_kernels(torch, flush):
    """Each kernel against its plain version at the path's shapes."""
    import torch.nn.functional as F
    from repro_torch.kernels import expected_attention as EA
    from repro_torch.kernels import ref
    gen = torch.Generator(device="cuda").manual_seed(1234)
    f32, bf16 = torch.float32, torch.bfloat16
    tol = {f32: 2e-5, bf16: 2e-2}
    rows = {name: [] for name in DECODE + ("expected_attention_scores",)}
    # (label, B, KV, G, dk, S, dtype, window, main-path shape?)
    cases = [("planted-sm", 16, 2, 1, 16, 256, f32, GLOBAL, False),
             ("planted-lg", 16, 4, 1, 24, 256, f32, GLOBAL, False),
             ("planted-lg-window", 16, 4, 1, 24, 256, f32, 8, False),
             ("llama8b-S256", 14, 8, 4, 128, 256, bf16, GLOBAL, False),
             ("llama8b-S640", 14, 8, 4, 128, 640, bf16, GLOBAL, False),
             ("llama8b-S1152", 14, 8, 4, 128, 1152, bf16, GLOBAL, True)]
    for label, B, KV, G, dk, S, dt, window, main in cases:
        for Lq in (1, 3):
            q, k, v, lengths = _decode_inputs(torch, gen, B, Lq, KV, G, dk,
                                              S, dt, Lq)
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
                           max_abs_err=err, tol=tol[dt],
                           ok=bool(err <= tol[dt] and math.isfinite(err)))
                if Lq == 1 and not label.endswith("window"):
                    row["kernel_ms"] = time_ms(
                        torch, lambda: kern(lengths, window), flush)
                    row["plain_ms"] = time_ms(
                        torch, lambda: plain(lengths, window), flush,
                        iters=5)
                    row["bound_ms"], row["bound_by"] = decode_bound(
                        qq, kk, vv, lengths, window, 8 if quant else 0)
                    row["library_ms"] = None
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
                        row["library_ms"] = time_ms(
                            torch, lambda: F.scaled_dot_product_attention(
                                qs, ke, ve, attn_mask=mask), flush)
                    row["main_path_shape"] = main
                rows[name].append(row)
                emit("kernel", **row)
                if not row["ok"]:
                    die("kernel", f"{name} at {label} Lq={Lq}: error {err}")
    _decode_edge_cases(torch, gen, tol)
    ea_cases = [("llama8b", 1, 1024, 8, 4, 128, bf16, True),
                ("planted-sm", 1, 160, 2, 1, 16, f32, False),
                ("planted-lg", 1, 160, 4, 1, 24, f32, False)]
    for label, B, S, KV, G, dk, dt, main in ea_cases:
        k = torch.randn((B, S, KV, dk), generator=gen, device="cuda").to(dt)
        mu = torch.randn((KV, G, dk), generator=gen, device="cuda")
        sig2 = torch.rand((KV, G, dk), generator=gen, device="cuda")
        got = EA.expected_attention_scores(k, mu, sig2)
        want = ref.expected_attention_scores_ref(k, mu, sig2)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        etol = 2e-5 * max(1.0, scale)       # float32 sums of dk terms
        row = dict(kernel="expected_attention_scores", shape=label, B=B, S=S,
                   KV=KV, G=G, dk=dk, dtype=str(dt)[6:], max_abs_err=err,
                   tol=etol, ok=bool(err <= etol and math.isfinite(err)),
                   main_path_shape=main)
        row["kernel_ms"] = time_ms(torch, lambda: EA.expected_attention_scores(
            k, mu, sig2), flush)
        row["plain_ms"] = time_ms(torch, lambda: ref
                                  .expected_attention_scores_ref(k, mu, sig2),
                                  flush)
        nbytes = k.numel() * k.element_size() + 2 * mu.numel() * 4 \
            + B * S * KV * 4
        row["bound_ms"], row["bound_by"] = bound(nbytes,
                                                 B * S * KV * G * dk * 4)
        row["library_ms"] = None
        rows["expected_attention_scores"].append(row)
        emit("kernel", **row)
        if not row["ok"]:
            die("kernel", f"expected_attention_scores at {label}: error {err}")
    return rows


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
            ok = err <= tol[dt] and math.isfinite(err) and same
            emit("kernel_edges", kernel=name, dtype=str(dt)[6:],
                 no_position_rows_max_abs_err=err, tol=tol[dt],
                 batch_invariant=same, ok=ok)
            if not ok:
                die("kernel", f"{name} {dt}: rows that see no position err "
                              f"{err} or batch invariance {same}")


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
    # this hand-written plan has no int8 stage: A, B (scan flush) and C
    missing = [k for k in ("decode_query_attention", "decode_attention",
                           "expected_attention_scores") if counts[k] <= 0]
    if missing:
        die("llama8b", f"kernels not launched on this path: {missing}")
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
    two calls it makes (the planner reports only its total)."""

    def __init__(self):
        import repro_torch.core.planner as P
        self.P, self.s = P, {"profile_s": 0.0, "optimize_s": 0.0}
        self.real = (P.profile_query, P.optimize_query)

        def timed(fn, key):
            def run(*a, **kw):
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


def _drive_session(torch, sess, items):
    """The main path through the user's entry points, counts from 0:
    profiles, EXPLAIN (plan), execute, metrics against gold."""
    from repro_torch.kernels import ops
    timer = _PlanTimer()
    ops.reset_launch_counts()
    try:
        t0 = time.perf_counter()
        sess.prepare(items)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        frame = _frame(sess, items)
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
                 items_per_s=len(items) / max(t3 - t2, 1e-9),
                 gold_s=time.perf_counter() - t3)
    return frame, report, result, metrics, counts, times


def _check_session(phase, report, result, metrics, counts, n_items):
    if counts["decode_query_attention_int8"] <= 0:
        die(phase, f"the Session path launched no int8 query kernel: "
                   f"{counts}")
    for name in ("decode_query_attention", "expected_attention_scores"):
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


def phase_session_planted(torch):
    """The quickstart query through repro_torch.Session on the card, with
    int8 rungs declared on both planted models."""
    import numpy as np
    from repro_torch.api import Session, SessionConfig
    from repro_torch.cache.store import CacheStore
    from repro_torch.core.optimizer import PlannerConfig
    from repro_torch.data import synthetic as syn
    from repro_torch.runtime.executor import run_operator
    from repro_torch.serving.engine import ServingEngine

    ds = syn.make_dataset("session", 200, seed=3)
    root = os.path.join(WORK, "session-planted")
    cfg = SessionConfig(
        profile_ratios=(0.0, 0.3, 0.5, 0.8), sm_ratios=(0.8, 0.5, 0.0),
        lg_ratios=(0.8, 0.5, 0.3), sm_int8=(0.5,), lg_int8=(0.3,),
        planner=PlannerConfig(steps=200, restarts=3), sample_frac=0.25,
        partition_size=64, cache_dir=root)
    sess = Session(cfg)
    frame, report, result, metrics, counts, times = _drive_session(
        torch, sess, ds.items)
    emit("session_explain", text=str(report))
    _check_session("session_planted", report, result, metrics, counts,
                   len(ds.items))
    query, plan = frame.to_query(), result.raw.plan

    # the same plan by the port on the CPU, over the same stored profiles
    cpu_eng = ServingEngine(CacheStore(root), device="cpu")
    for size in cfg.models:
        mcfg = syn.planted_config(size)
        cpu_eng.register_model(size, mcfg, syn.make_planted_params(
            mcfg, seed=cfg.model_seed, device="cpu"))
    cpu = Session(cfg, engine=cpu_eng, device="cpu").run(plan, query,
                                                         ds.items)
    near = np.zeros(len(ds.items), bool)
    ops_ = query.semantic_ops
    for st in plan.stages:
        s = np.asarray(run_operator(sess.backend, ops_[st.logical_idx],
                                    st.op_name, ds.items).scores)
        thrs = [0.0] if st.is_gold else [
            x for x in ((st.thr_hi,) if st.is_map else (st.thr_hi, st.thr_lo))
            if math.isfinite(x)]
        for x in thrs:
            near |= np.abs(s - x) < MARGIN
    a, c = _decisions(result.raw), _decisions(cpu)
    far = ~near
    cpu_same = bool(np.array_equal(a[0][far], c[0][far]) and all(
        np.array_equal(a[1][li][far], c[1][li][far]) for li in a[1]))
    if not cpu_same:
        die("session_planted", "card and CPU decisions differ outside the "
                               "margin")
    all_same = bool(np.array_equal(a[0], c[0]) and all(
        np.array_equal(a[1][li], c[1][li]) for li in a[1]))
    if all_same and _ints(result.raw) != _ints(cpu):
        die("session_planted", f"integer telemetry differs: "
                               f"{_ints(result.raw)} vs {_ints(cpu)}")
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
         cpu_equal_outside_margin=cpu_same, cpu_equal_everywhere=all_same,
         n_near_margin=int(near.sum()), margin=MARGIN,
         cpu_ints_equal=_ints(result.raw) == _ints(cpu),
         stage_stats=[s.as_dict() for s in result.stage_stats])
    sess.close()
    del sess, cpu_eng
    torch.cuda.empty_cache()
    return counts, scan


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
    frame, report, result, metrics, counts, times = _drive_session(
        torch, sess, ds.items)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    emit("session_explain", text=str(report))
    _check_session("session_llama8b", report, result, metrics, counts,
                   len(ds.items))
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
    sess.close()
    del sess, eng, caches
    shutil.rmtree(os.path.join(WORK, "session-8b"), ignore_errors=True)
    torch.cuda.empty_cache()
    return counts, scan


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
        "src/repro/kernels/expected_attention.py:38"),
}


def main() -> int:
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print("chip_smoke.py: src/repro_torch not found next to this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: CUDA is not available; the port's path runs "
              "on the card only", file=sys.stderr)
        return 1
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK, exist_ok=True)
    try:
        smi_line = phase_device(torch)
        phase_build()
        flush = torch.empty(1 << 30, dtype=torch.uint8, device="cuda")
        rows = phase_kernels(torch, flush)
        del flush
        phase_planted(torch)
        _, params = phase_llama8b(torch)
        paths = {}
        paths["session_planted"], paths["session_planted_scan"] = \
            phase_session_planted(torch)
        paths["session_llama8b"], paths["session_llama8b_scan"] = \
            phase_session_llama8b(torch, params)
        del params
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    kernels = []
    for name, (source, replaces) in KERNEL_META.items():
        main_rows = [r for r in rows[name] if r.get("main_path_shape")]
        row = main_rows[0]
        by_path = {p: c[name] for p, c in paths.items()}
        if sum(by_path.values()) <= 0:
            die("kernels", f"{name} was launched on no Session path")
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": max(r["max_abs_err"] for r in rows[name]),
            "ms": row["kernel_ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
