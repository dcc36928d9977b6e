#!/usr/bin/env python3
"""Split the decode kernel's (A's) device time by phase, on one NVIDIA card.

    python3 scripts/decode_phase_split.py                   # csrc's kernel
    python3 scripts/decode_phase_split.py --int8            # over int8 K/V
    python3 scripts/decode_phase_split.py --source OLD.cu   # another version

Copies the decode source (default `src/repro_torch/csrc/decode_attention.cu`)
with clock64 / globaltimer stamps added at the boundaries of its phases,
builds the copy with nvcc under `build/phase_split/`, runs it on random
inputs at chip_smoke.py's decode shapes (float32 / bfloat16 K/V, or with
--int8 the same K/V quantised to int8 with per-row scales, as the int8
rungs hold them), and prints one JSON line per shape: live CTAs, the mean cycles of each phase
per live CTA and their shares, the mean CTA duration, the kernel's span
and how many live CTAs an SM holds on average, and the kernel's time
(CUDA events, L2 flushed with a write before each launch). The copy is
never loaded by the package. Two designs are known, told apart by the
source:

  split-combine  a CTA stages its chunk, then scores, softmax and P.V in
                 three phases behind block barriers; a second kernel
                 combines the splits (the time is also taken without it)
  one-launch     8 warps each load, score and weigh 16 positions; the CTA
                 merges its warps, writes its partial, counts its arrival,
                 and the last CTA of an (item, KV head) merges the splits
                 (one body for float32 / bfloat16 and int8 K/V; --int8
                 needs it)

The stamps slow the kernel down: the times printed are the instrumented
copy's on this script's inputs, not the kernel's (chip_smoke.py times
that). Exits non-zero without CUDA.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, os.path.join(ROOT, "src"))
GLOBAL = 1 << 30
SLOTS = 16                      # stamps per CTA record
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

PROBE_API = """
extern "C" {
int probe_clear() {
  void* p; cudaError_t e = cudaGetSymbolAddress(&p, g_probe);
  if (e) return (int)e;
  return (int)cudaMemset(p, 0, sizeof(unsigned long long) << 20);
}
int probe_read(void* host) {
  return (int)cudaMemcpyFromSymbol(host, g_probe,
                                   sizeof(unsigned long long) << 20);
}
void probe_skip_combine(int on) { g_skip_combine = on; }
}
"""
GLOBALS = ("__device__ unsigned long long g_probe[1 << 20];\n"
           "static int g_skip_combine = 0;\n")
# thread 0 writes the CTA's stamps ts[0..9], its start and end on the
# globaltimer, its SM and flags (bit 0 live, 1 last to arrive, 2 one split)
RECORD = ("  if (threadIdx.x == 0) {{ unsigned long long g1;"
          " asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(g1));"
          " unsigned smid; asm volatile(\"mov.u32 %0, %%smid;\" : \"=r\"(smid));"
          " const long cta = blockIdx.x + (long)gridDim.x * (blockIdx.y +"
          " (long)gridDim.y * blockIdx.z);"
          " unsigned long long* rec = g_probe + cta * 16;"
          " if (cta * 16 + 16 <= (1 << 20)) {{"
          " const long long ts[10] = {{{ts}}};"
          " for (int z = 0; z < 10; ++z) rec[z] = ts[z];"
          " rec[10] = g0; rec[11] = g1; rec[12] = smid; rec[13] = {flags};"
          " }} }}\n")
START = ("  const long long t0 = clock64(); unsigned long long g0;"
         " asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(g0));\n")


def _rep(src, old, new, count=1):
    if src.count(old) != count:
        raise SystemExit(f"decode_phase_split: the source does not match the "
                         f"known design at {old[:60]!r}")
    return src.replace(old, new)


def instrument_split_combine(src):
    """Phases: stage, scores, softmax, P.V (per CTA, behind barriers)."""
    src = _rep(src, "namespace {\n\nconstexpr int THREADS",
               GLOBALS + "namespace {\n\nconstexpr int THREADS")
    src = _rep(src, "  const int tid = threadIdx.x;\n",
               "  const int tid = threadIdx.x;\n" + START)
    for nxt, name in (("scores", "t1"), ("softmax", "t2"), ("PV", "t3")):
        src = _rep(src, f"  __syncthreads();\n\n  // ---- {nxt}",
                   f"  __syncthreads();\n  const long long {name} = clock64();"
                   f"\n\n  // ---- {nxt}")
    src = _rep(src, "  }\n}\n\n// One CTA per (item, KV head)",
               "  }\n  __syncthreads();\n  const long long t4 = clock64();\n"
               + RECORD.format(ts="t0, t1, t2, t3, t4, t4, t4, t4, t4, t4",
                               flags="1")
               + "}\n\n// One CTA per (item, KV head)")
    src = _rep(src, "  if (e != cudaSuccess) return e;\n  combine_kernel",
               "  if (e != cudaSuccess) return e;\n  if (g_skip_combine) "
               "return e;\n  combine_kernel")
    return src + PROBE_API, ("stage", "scores", "softmax", "pv")


def instrument_one_launch(src):
    """Phases of the float32 / bfloat16 body, seen by warp 0: the loads
    issued and q staged; the wait for K; Q.K and the softmax; the wait for
    V; P.V; the other warps; the warp merge and the partial; the fence and
    arrival; the final merge (last CTA only)."""
    src = _rep(src, "namespace {\n\n__device__ __forceinline__ float to_f(",
               GLOBALS + "namespace {\n\n__device__ __forceinline__ "
               "float to_f(")
    ks = ("  TKV* ks = reinterpret_cast<TKV*>(smem_raw);   "
          if "namespace body {" in src else
          "  T* ks = reinterpret_cast<T*>(smem_raw);   ")
    src = _rep(src, ks, START + "  long long t2 = 0, t3a = 0, t3 = 0, t4 = 0,"
               " t6 = 0, t7 = 0;\n" + ks)
    src = _rep(src, "  __syncthreads();\n\n  if (warp_live) {",
               "  __syncthreads();\n  const long long t1 = clock64();\n\n"
               "  if (warp_live) {")
    src = _rep(src, "    cp_async_wait<1>();                          "
               "// K landed\n    __syncwarp();\n",
               "    cp_async_wait<1>();                          "
               "// K landed\n    __syncwarp();\n    t2 = clock64();\n")
    src, n = re.subn(r"cp_async_wait<0>\(\);(\s*)// V landed",
                     lambda m: "t3a = clock64(); cp_async_wait<0>(); "
                               "t3 = clock64();" + m.group(1) + "// V landed",
                     src)
    if n != 2:
        raise SystemExit("decode_phase_split: V waits not found")
    src = _rep(src, "  } else {\n    for (int i = lane; i < R; i += 32) {\n"
                    "      wm[warp * R + i] = -INFINITY;",
               "    t4 = clock64();\n  } else {\n    for (int i = lane; "
               "i < R; i += 32) {\n      wm[warp * R + i] = -INFINITY;")
    src = _rep(src, "  __syncthreads();\n\n  // ---- the split's partial",
               "  __syncthreads();\n  const long long t5 = clock64();\n\n"
               "  // ---- the split's partial")
    rec = RECORD.format(ts="t0, t1, t2, t3a, t3, t4, t5, t6, t7, 0",
                        flags="1 | ((n_live == 1) << 2)")
    src = _rep(src, "  if (n_live == 1) return;\n",
               "  t6 = clock64();\n  if (n_live == 1) {\n" + rec
               + "    return;\n  }\n")
    src = _rep(src, "  __syncthreads();\n  if (!is_last) return;\n",
               "  __syncthreads();\n  t7 = clock64();\n  if (!is_last) {\n"
               + rec + "    return;\n  }\n")
    tail = re.search(r"R, reinterpret_cast<float\*>\(smem_raw\)\);\n}\n", src)
    if tail is None:
        raise SystemExit("decode_phase_split: the final merge not found")
    src = src[:tail.start()] + (
        "R, reinterpret_cast<float*>(smem_raw));\n  __syncthreads();\n"
        "  const long long t8 = clock64();\n" + RECORD.format(
            ts="t0, t1, t2, t3a, t3, t4, t5, t6, t7, t8", flags="1 | 2")
        + "}\n") + src[tail.end():]
    return src + PROBE_API, (
        "issue_and_q", "wait_k", "qk_softmax", "wait_v", "pv", "other_warps",
        "warp_merge_partial", "fence_arrive", "final_merge")


def _quantize(torch, x):
    """int8 rows and (B, S, KV) absmax scales, as the int8 rungs hold them."""
    s = x.float().abs().amax(-1) / 127.0
    return torch.round(x.float() / s.clamp(min=1e-9)[..., None]) \
        .to(torch.int8), s


def time_ms(torch, fn, flush, iters=20, warmup=3):
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", default=os.path.join(
        ROOT, "src", "repro_torch", "csrc", "decode_attention.cu"))
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "phase_split"))
    ap.add_argument("--label", default=None)
    ap.add_argument("--int8", action="store_true",
                    help="int8 K/V with per-row scales (the int8 entry)")
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("decode_phase_split: CUDA is not available", file=sys.stderr)
        return 1
    from repro_torch.kernels import build
    src = open(args.source).read()
    one_launch = "namespace fp {" in src or "namespace body {" in src
    if args.int8 and "namespace body {" not in src:
        raise SystemExit("decode_phase_split: --int8 takes the one-launch "
                         "body shared by float and int8 K/V")
    src, phases = (instrument_one_launch(src) if one_launch
                   else instrument_split_combine(src))
    os.makedirs(args.out, exist_ok=True)
    tag = args.label or ("one_launch" if one_launch else "split_combine") \
        + ("_int8" if args.int8 else "")
    cu = os.path.join(args.out, f"decode_{tag}.cu")
    so = os.path.join(args.out, f"libdecode_{tag}.so")
    with open(cu, "w") as f:
        f.write(src)
    subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", so, cu],
                   check=True)
    lib = ctypes.CDLL(so)
    entry = (lib.stretto_decode_query_attention_int8 if args.int8
             else lib.stretto_decode_query_attention)
    n_ptr = (11 if args.int8 else 9) if one_launch else 8
    entry.argtypes = [_P] * n_ptr + [_I] * 8 + [_F, _I, _P]
    entry.restype = _I
    lib.probe_read.argtypes = [_P]
    if one_launch:      # the fp body's split: WARPS x SUB positions
        split = int(re.search(r"constexpr int WARPS = (\d+);", src).group(1)) \
            * int(re.search(r"constexpr int SUB = (\d+);", src).group(1))
    else:
        split = int(re.search(r"constexpr int CHUNK = (\d+);", src).group(1))
    counters = torch.zeros(4096, dtype=torch.int32, device="cuda")

    def call(q, k, v, lens, scales=()):
        B, Lq, KV, G, dk = q.shape
        S, dv = v.shape[1], v.shape[3]
        n_split = (S + split - 1) // split
        f32 = dict(dtype=torch.float32, device="cuda")
        pm = torch.empty((B, KV, n_split, Lq * G), **f32)
        pl = torch.empty((B, KV, n_split, Lq * G), **f32)
        pa = torch.empty((B, KV, n_split, Lq * G, dv), **f32)
        out = torch.empty((B, Lq, KV, G, dv), dtype=q.dtype, device="cuda")
        ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(),
                *(x.data_ptr() for x in scales), lens.data_ptr(),
                out.data_ptr(), pm.data_ptr(), pl.data_ptr(), pa.data_ptr()]
        if one_launch:
            ptrs.append(counters.data_ptr())
        err = entry(*ptrs, B, Lq, KV, G, dk, dv, S, GLOBAL, dk ** -0.5,
                    0 if q.dtype == torch.float32 else 1,
                    torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: cudaError {err}")
        return out

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    flush = torch.empty(1 << 30, dtype=torch.uint8, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1234)
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [("planted-sm", 16, 1, 2, 1, 16, 256, f32),
             ("planted-lg", 16, 1, 4, 1, 24, 256, f32),
             ("llama8b-S256", 14, 1, 8, 4, 128, 256, bf16),
             ("llama8b-S640", 14, 1, 8, 4, 128, 640, bf16),
             ("llama8b-S1152", 14, 1, 8, 4, 128, 1152, bf16),
             ("llama8b-S1152-Lq3", 14, 3, 8, 4, 128, 1152, bf16)]
    print(json.dumps({"design": tag, "source": args.source, "nvidia_smi": smi,
                      "phases": phases}), flush=True)
    for label, B, Lq, KV, G, dk, S, dt in cases:
        def rnd(*shape):
            return torch.randn(shape, generator=gen, device="cuda").to(dt)
        q, k, v = rnd(B, Lq, KV, G, dk), rnd(B, S, KV, dk), rnd(B, S, KV, dk)
        scales = ()
        if args.int8:
            (k, ks), (v, vs) = _quantize(torch, k), _quantize(torch, v)
            scales = (ks, vs)
        lens = torch.randint(Lq, S - 2, (B,), generator=gen, device="cuda",
                             dtype=torch.int32)
        lens[0] = S - 3
        row = {"shape": label, "B": B, "Lq": Lq, "S": S,
               "kv_dtype": "int8" if args.int8 else str(dt)[6:]}
        if not one_launch:
            lib.probe_skip_combine(1)
            row["split_kernel_ms"] = time_ms(torch, lambda: call(q, k, v, lens),
                                         flush)
            lib.probe_skip_combine(0)
        row["kernel_ms"] = time_ms(torch, lambda: call(q, k, v, lens, scales),
                                   flush)
        flush.zero_()
        assert lib.probe_clear() == 0
        call(q, k, v, lens, scales)
        torch.cuda.synchronize()
        buf = np.zeros(1 << 20, dtype=np.uint64)
        assert lib.probe_read(buf.ctypes.data) == 0
        rec = buf.reshape(-1, SLOTS)
        live = rec[(rec[:, 13] & 1) == 1]
        ts = live[:, :10].astype(np.int64)
        cycles = {}
        for i, name in enumerate(phases):
            a, b = ts[:, i], ts[:, i + 1]
            ok = (a > 0) & (b > 0) & (b >= a)
            cycles[name] = float((b[ok] - a[ok]).mean()) if ok.any() else None
        total = sum(c for c in cycles.values() if c)
        g0, g1 = live[:, 10].astype(np.float64), live[:, 11].astype(np.float64)
        span = float(g1.max() - g0.min())
        last = (live[:, 13] & 2) > 0
        row.update(
            live_ctas=int(len(live)), last_ctas=int(last.sum()),
            mean_cycles=cycles,
            share={n: (c / total if c else None) for n, c in cycles.items()},
            mean_cta_us=float((g1 - g0).mean() / 1e3), span_us=span / 1e3,
            mean_live_ctas_per_sm=float((g1 - g0).sum() / span / 132),
            sm_ghz=float(((ts[:, len(phases)] - ts[:, 0]) / np.maximum(
                g1 - g0, 1)).mean()) if not one_launch else None)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
