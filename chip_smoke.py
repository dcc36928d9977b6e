#!/usr/bin/env python3
"""Drive the PyTorch port of Stretto on one NVIDIA card, end to end.

    python3 chip_smoke.py          # from the root of a checkout

Phases, one JSON line each:
  device   the card (and the `nvidia-smi` name / power-limit line)
  build    nvcc builds every kernel of src/repro_torch/csrc/, in parallel
  kernel   each hand-written CUDA kernel against its plain PyTorch version
           on the card, at the planted and the stretto-llama-8b shapes:
           max abs error within the stated tolerance, and its time beside
           the plain version's, the bound and (decode) one SDPA call
  planted  the planted sm/lg world (200 items): profiles, a hand-written
           cascade plan for the quickstart query through KVCacheBackend +
           run_plan; inline vs threads:2 bit-identical; the same plan on
           the CPU (plain versions) equal outside a margin; the scan path
           (fused=False) agreeing, through the single-token kernel;
           recall / precision against the ReferenceBackend gold
  llama8b  the main path at full width: stretto-llama-8b (32 layers,
           d_model 4096, bfloat16, random weights from a seed), 16 items of
           1024 tokens, profiles at ratios 0.8 / 0.5 / 0.0, a filter + map
           plan cascading kv80 -> kv50 -> kv00 over every item, one
           scan-path flush, and one flush's logits kernel vs plain
Then the kernels line, the nvidia-smi line and, last, the result line.

Launch counts: every count is set to 0 just before a path is driven and
read just after; the kernels line carries the counts of the llama8b run.
Any failed phase exits non-zero. Without CUDA, or without the repository
around it, the script exits non-zero and prints no result.
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


def decode_bound(q, k, v, lengths, window):
    """Least time for a decode call on these inputs: the visible K/V rows
    (positions below each item's length inside some row's window) read
    once, q read and the output written once; 4 flops per query row per
    K or V element of a visible row (float32 FMAs)."""
    B, Lq, KV, G, dk = q.shape if q.dim() == 5 else \
        (q.shape[0], 1) + tuple(q.shape[1:])
    S, dv = v.shape[1], v.shape[3]
    vis = 0
    for n in lengths.tolist():
        hi = min(n, S)
        lo = max(0, n - Lq - window + 1)
        vis += max(0, hi - lo)
    nbytes = (vis * KV * (dk + dv) * k.element_size()
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


def phase_kernels(torch, flush):
    """Each kernel against its plain version at the path's shapes."""
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import expected_attention as EA
    from repro_torch.kernels import ref
    gen = torch.Generator(device="cuda").manual_seed(1234)
    f32, bf16 = torch.float32, torch.bfloat16
    tol = {f32: 2e-5, bf16: 2e-2}
    rows = {"decode_query_attention": [], "decode_attention": [],
            "expected_attention_scores": []}
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
            for name in ("decode_query_attention", "decode_attention"):
                if name == "decode_attention" and Lq != 1:
                    continue
                qq = q if name == "decode_query_attention" else q[:, 0]
                kern = getattr(DA, name)
                plain = getattr(ref, name + "_ref")
                got = kern(qq, k, v, lengths, window=window)
                want = plain(qq, k, v, lengths, window=window)
                torch.cuda.synchronize()
                err = float((got.float() - want.float()).abs().max())
                row = dict(kernel=name, shape=label, B=B, Lq=Lq, KV=KV, G=G,
                           dk=dk, S=S, dtype=str(dt)[6:], window=window,
                           max_abs_err=err, tol=tol[dt],
                           ok=bool(err <= tol[dt] and math.isfinite(err)))
                if Lq == 1 and not label.endswith("window"):
                    row["kernel_ms"] = time_ms(torch, lambda: kern(
                        qq, k, v, lengths, window=window), flush)
                    row["plain_ms"] = time_ms(torch, lambda: plain(
                        qq, k, v, lengths, window=window), flush, iters=5)
                    row["bound_ms"], row["bound_by"] = decode_bound(
                        qq, k, v, lengths, window)
                    # yardstick: one SDPA call on head-expanded K/V
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


# Hand-set thresholds (the planner is not ported yet), placed outside the
# range where this seeded world's non-gold scores of gold-positive and
# gold-negative items overlap, so early decisions rarely disagree with gold
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
    missing = [k for k, n in counts.items() if n <= 0]
    if missing:
        die("llama8b", f"kernels not launched on the main path: {missing}")
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
    del eng, scan, params, caches
    torch.cuda.empty_cache()
    return counts


KERNEL_META = {
    "decode_query_attention": ("src/repro_torch/csrc/decode_attention.cu",
                               "src/repro/kernels/decode_attention.py:259"),
    "decode_attention": ("src/repro_torch/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention.py:129"),
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
        counts = phase_llama8b(torch)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    kernels = []
    for name, (source, replaces) in KERNEL_META.items():
        main_rows = [r for r in rows[name] if r.get("main_path_shape")]
        row = main_rows[0]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": counts[name],
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
