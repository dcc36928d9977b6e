// Causal / windowed flash attention over whole sequences (the offline
// prefill), for Hopper (sm_90a): the float32 FMA body of kernel D. It
// serves float32 inputs (the planted models, whose decisions sit at the
// float32 tolerance) and bfloat16 head dims that are not multiples of 16;
// other bfloat16 inputs run the tensor-core body, prefill_attention_tc.cu
// (kernels/prefill_attention.py picks the body).
//
// Replaces the Pallas TPU kernel repro/kernels/prefill_attention.py
// (prefill_attention -> _prefill_kernel). Query position i attends to key
// position j iff  i - j < window  and, when causal, j <= i. The softmax is
// taken online over key tiles in float32, with the Pallas kernel's finite
// mask value -1e30, its running max m initialised to -1e30, and its final
// division by max(l, 1e-30).
//
// Layouts (row-major, contiguous). q, k, v and out share one type T
// (float32 or bfloat16):
//   q    (B, S, KV, G, dk)
//   k    (B, S, KV, dk)
//   v    (B, S, KV, dv)
//   out  (B, S, KV, G, dv)
// The query rows of one (item, KV head) are taken in order of
// f = position * G + head; a row tile is ROWS = 16 consecutive rows (its
// positions share every K / V tile).
//
// What bounds it on the H100: float32 operands run outside the tensor
// cores, at 67 TFLOP/s. At the planted build shapes (B 16, S 160, d 16 and
// 24) that is about 0.001 ms of work per call, so a call is bound by the
// latency of its longest chain: the row tile on the causal diagonal walks
// every key tile in series, and each tile's loads, products and softmax
// follow one another.
//
// What the design does about it:
//  * One warp per CTA, one row tile per warp: 16 rows, so the lg shape
//    runs 640 CTAs and all of them are resident at once. The tiles on the
//    diagonal (the longest walks) are launched first.
//  * Key tiles of BK = 32 positions are walked in increasing order from
//    the first tile the window reaches to the tile holding the causal
//    diagonal of the row tile's last query, so tiles wholly above the
//    diagonal or outside the window are never read (as the Pallas kernel
//    skips them). Within a tile the mask is exact per (row, key).
//  * Loads issued up front: K and V tiles stream through a ring of 3
//    stages in shared memory (2 where 3 do not fit in 40 KB) by 16-byte
//    cp.async, so while the warp computes on one tile the next two are in
//    flight; no tile waits behind a block barrier for its own load. Only
//    __syncwarp runs inside the key loop. A K row's stride is an odd
//    number of 16-byte chunks, so the 8 rows a quarter-warp reads sit in
//    distinct banks. Positions past S are zero-filled, never read. Head
//    dims whose rows are not 16-byte multiples load element-wise.
//  * Lane (rg, cg) = (lane / 8, lane % 8) owns rows 4 rg .. 4 rg + 3; of
//    each key tile the keys cg + 8 j; of the output the columns
//    cg * DVT .. cg * DVT + DVT - 1. m and l live in registers, replicated
//    over the 8 lanes of a row group, which reduce with shuffles. q (scaled)
//    and K are read 4 elements at a time; P goes through a small
//    transposed tile in shared memory, read back as one float4 per key.
//  * Scores and P V are float32 FMAs; exp is expf (full precision), as
//    the Pallas kernel feeds float32 operands to the MXU.
//  * No atomics and no split of S: a row's sums run in one fixed order
//    that depends only on its row tile (fixed by its position and head),
//    the window and the tile sizes, never on B or on S beyond the row
//    (keys past a causal row are masked to exact zeros). An item's rows
//    are therefore bit-identical alone and inside a larger, further
//    right-padded batch, which the profile store relies on.
//  * Head dims are runtime loop bounds (dk <= 256); dv is padded to the
//    next of 8, 16, 24, 32, 64 or 128 in registers and shared memory, with
//    the pad columns zero in every stage and never written. dk != dv
//    works.
//  * A row whose first live tile is all masked (its softmax then runs over
//    exact 1s of finite values, wiped by exp(-1e30 - m) once a real score
//    arrives, as in the Pallas kernel) never touches NaN or Inf.
//
// `window` and `causal` are runtime arguments, so per-layer windows need no
// other build. The wrapper clamps window to 2^30 (GLOBAL) and refuses
// window < 1; positions and windows stay far inside int32.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>
#include <type_traits>

namespace {

constexpr int ROWS = 16;       // query rows (position x head) per warp
constexpr int RPT = 4;         // rows per lane
constexpr int CG = 8;          // column groups (lanes per row group)
constexpr int BK = 32;         // key positions per tile
constexpr int CPT = BK / CG;   // key columns per lane
constexpr int PST = 20;        // row stride of the transposed P tile
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;
constexpr size_t RING_3 = 40 * 1024;   // a 3-stage ring up to this size

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// 4 consecutive elements at p (16 bytes for float, 8 for bfloat16; p
// aligned to that), as floats.
__device__ __forceinline__ void load4(const float* p, float* o) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  o[0] = u.x; o[1] = u.y; o[2] = u.z; o[3] = u.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* o) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
}
// N consecutive elements (a multiple of 4 at 16-byte alignment for float,
// 8-byte for bfloat16; else element by element).
template <int N, typename T>
__device__ __forceinline__ void load_n(const T* p, float* o) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) load4(p + i, o + i);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) o[i] = to_f(p[i]);
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most `pending` groups of this lane are in flight (1 or 2).
__device__ __forceinline__ void cp_async_wait(int pending) {
  if (pending >= 2)
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Rows p0 .. p0 + BK - 1 of one (item, KV head), width elements each, into
// dst (row stride `stride`); row p at src[(row0 + p * KV) * width]; rows at
// or past S are zero. VEC: 16-byte cp.async, else element-wise loads.
template <typename T, bool VEC>
__device__ __forceinline__ void load_tile(T* dst, const T* __restrict__ src,
                                          long row0, int KV, int p0, int S,
                                          int width, int stride, int lane) {
  if constexpr (VEC) {
    // chunk i = lane + 32 n is (row r, chunk c); step (r, c) without a
    // division per chunk
    constexpr int EPC = 16 / (int)sizeof(T);   // elements per chunk
    const int nc = width / EPC;
    const int dr = 32 / nc, dc = 32 - dr * nc;
    int r = lane / nc, c = lane - r * nc;
    for (; r < BK; r += dr) {
      const int p = p0 + r;
      const bool ok = p < S;
      const T* g = ok ? src + (row0 + (long)p * KV) * width + c * EPC : src;
      cp_async16(dst + r * stride + c * EPC, g, ok ? 16 : 0);
      c += dc;
      if (c >= nc) {
        c -= nc;
        ++r;
      }
    }
  } else {
    for (int i = lane; i < BK * width; i += 32) {
      const int r = i / width, c = i - r * width;
      const int p = p0 + r;
      dst[r * stride + c] =
          p < S ? src[(row0 + (long)p * KV) * width + c] : from_f<T>(0.f);
    }
  }
}

// DVT output columns per lane: dv <= 8 * DVT (DVT in 1, 2, 3, 4, 8, 16).
// VEC: rows of 16-byte multiples, copied by cp.async.
template <typename T, int DVT, bool VEC>
__global__ void __launch_bounds__(32)
prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, T* __restrict__ out, int S, int KV,
               int G, int dk, int dv, int window, int causal, float scale,
               int qst, int kst, int n_stage) {
  constexpr int DVP = CG * DVT;            // padded dv, V's row stride
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);   // [ROWS][qst], scaled
  float* Ps = Qs + ROWS * qst;                       // [BK][PST], P^T
  T* ring = reinterpret_cast<T*>(Ps + BK * PST);     // n_stage x (K, V)
  const int stage_elems = BK * (kst + DVP);

  const int lane = threadIdx.x;
  const int rg = lane / CG, cg = lane % CG;
  const int kv = blockIdx.y, b = blockIdx.z;
  const int tile = gridDim.x - 1 - blockIdx.x;     // longest walks first
  const int f0 = tile * ROWS;                      // first row: pos * G + g
  const int q_first = f0 / G;
  const int q_last = min((f0 + ROWS - 1) / G, S - 1);

  // ---- the key tiles this warp's rows can see, and the first loads ----
  const int k_end = causal ? q_last + 1 : S;       // exclusive
  const int k_start = max(0, q_first - window + 1);
  const int t_first = k_start / BK;
  const int t_last = (k_end - 1) / BK;
  const long row0 = (long)b * S * KV + kv;         // row (b, 0, kv)
  auto issue = [&](int t) {
    if (t <= t_last) {
      T* Ks = ring + ((t - t_first) % n_stage) * stage_elems;
      load_tile<T, VEC>(Ks, k, row0, KV, t * BK, S, dk, kst, lane);
      load_tile<T, VEC>(Ks + BK * kst, v, row0, KV, t * BK, S, dv, DVP,
                        lane);
    }
    cp_async_commit();                             // empty groups count too
  };
  for (int s = 0; s < n_stage - 1; ++s) issue(t_first + s);

  // V's pad columns are zero in every stage and never overwritten
  for (int i = lane; i < n_stage * BK; i += 32) {
    T* row = ring + (i / BK) * stage_elems + BK * kst + (i % BK) * DVP;
    for (int c = dv; c < DVP; ++c) row[c] = from_f<T>(0.f);
  }
  // ---- stage Q (scaled, float32); rows past S are zero. Lane l takes
  // columns l, l + 32, ... of every row, so its loads are independent ----
  for (int d = lane; d < dk; d += 32) {
    float x[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int f = f0 + r, pos = f / G, g = f - pos * G;
      x[r] = pos < S ? to_f(q[((((long)b * S + pos) * KV + kv) * G + g) * dk +
                              d])
                     : 0.f;
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) Qs[r * qst + d] = x[r] * scale;
  }

  float m[RPT], l[RPT], acc[RPT][DVT];
  int qpos[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
    qpos[i] = (f0 + rg * RPT + i) / G;
#pragma unroll
    for (int j = 0; j < DVT; ++j) acc[i][j] = 0.f;
  }
  const int dk4 = dk & ~3;

  for (int t = t_first; t <= t_last; ++t) {
    issue(t + n_stage - 1);
    cp_async_wait(n_stage - 1);                    // tile t has landed
    __syncwarp();
    const T* Ks = ring + ((t - t_first) % n_stage) * stage_elems;
    const T* Vs = Ks + BK * kst;
    const int p0 = t * BK;

    // scores s[i][j] for rows rg*RPT+i, keys p0 + cg + CG*j
    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
    const float* qrow = Qs + rg * RPT * qst;
    const T* krow = Ks + cg * kst;
    for (int d = 0; d < dk4; d += 4) {
      float qv[RPT][4], kf[CPT][4];
#pragma unroll
      for (int i = 0; i < RPT; ++i) load4(qrow + i * qst + d, qv[i]);
#pragma unroll
      for (int j = 0; j < CPT; ++j) load4(krow + j * CG * kst + d, kf[j]);
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int j = 0; j < CPT; ++j)
            s[i][j] = fmaf(qv[i][e], kf[j][e], s[i][j]);
    }
    for (int d = dk4; d < dk; ++d) {
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j)
          s[i][j] = fmaf(qrow[i * qst + d], to_f(krow[j * CG * kst + d]),
                         s[i][j]);
    }

    // mask, online softmax (all 8 lanes of a row group agree on m, l)
    float alpha[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int kp = p0 + cg + CG * j;
        bool live = kp < S && (qpos[i] - kp) < window;
        if (causal) live = live && kp <= qpos[i];
        if (!live) s[i][j] = NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < CG; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
#pragma unroll
      for (int off = 1; off < CG; off <<= 1)
        sum += __shfl_xor_sync(FULL, sum, off);
      alpha[i] = expf(m[i] - m_new);
      l[i] = l[i] * alpha[i] + sum;
      m[i] = m_new;
    }
    // P^T: key kk's 4 probabilities of row group rg at Ps[kk][4 rg ..]
#pragma unroll
    for (int j = 0; j < CPT; ++j)
      *reinterpret_cast<float4*>(Ps + (cg + CG * j) * PST + rg * RPT) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncwarp();

    // acc = acc * alpha + P V over this tile's keys, in key order
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < DVT; ++j) acc[i][j] *= alpha[i];
    const T* vcol = Vs + cg * DVT;
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      const float4 pv = *reinterpret_cast<const float4*>(Ps + kk * PST +
                                                         rg * RPT);
      float vv[DVT];
      load_n<DVT>(vcol + kk * DVP, vv);
#pragma unroll
      for (int j = 0; j < DVT; ++j) {
        acc[0][j] = fmaf(pv.x, vv[j], acc[0][j]);
        acc[1][j] = fmaf(pv.y, vv[j], acc[1][j]);
        acc[2][j] = fmaf(pv.z, vv[j], acc[2][j]);
        acc[3][j] = fmaf(pv.w, vv[j], acc[3][j]);
      }
    }
    __syncwarp();    // this stage and P are read before they are refilled
  }

  // ---- out = acc / max(l, 1e-30), in T ----
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int f = f0 + rg * RPT + i;
    const int pos = f / G, g = f - pos * G;
    if (pos >= S) continue;
    const float inv_l = 1.f / fmaxf(l[i], 1e-30f);
    T* orow = out + ((((long)b * S + pos) * KV + kv) * G + g) * dv;
#pragma unroll
    for (int j = 0; j < DVT; ++j) {
      const int c = cg * DVT + j;
      if (c < dv) orow[c] = from_f<T>(acc[i][j] * inv_l);
    }
  }
}

template <typename T, int DVT, bool VEC>
cudaError_t launch_typed(const void* q, const void* k, const void* v,
                         void* out, int B, int S, int KV, int G, int dk,
                         int dv, int window, int causal, float scale,
                         cudaStream_t stream) {
  constexpr int EPC = 16 / (int)sizeof(T);
  const int qst = (dk + 3) & ~3;
  // K rows: an odd number of 16-byte chunks (VEC), else a multiple of 4
  const int kst = VEC ? ((dk / EPC) | 1) * EPC : (dk + 3) & ~3;
  const size_t stage = sizeof(T) * (size_t)BK * (kst + CG * DVT);
  const int n_stage = 3 * stage <= RING_3 ? 3 : 2;
  const size_t smem = sizeof(float) * ((size_t)ROWS * qst + BK * PST) +
                      n_stage * stage;
  auto kern = prefill_kernel<T, DVT, VEC>;
  static size_t smem_opted = 48 * 1024;   // per instantiation
  if (smem > smem_opted) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    smem_opted = smem;
  }
  const long n_tiles = ((long)S * G + ROWS - 1) / ROWS;
  dim3 grid((unsigned)n_tiles, KV, B);
  kern<<<grid, 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, KV, G, dk, dv,
      window, causal, scale, qst, kst, n_stage);
  return cudaGetLastError();
}

template <typename T, bool VEC>
cudaError_t launch_dv(const void* q, const void* k, const void* v, void* out,
                      int B, int S, int KV, int G, int dk, int dv, int window,
                      int causal, float scale, cudaStream_t stream) {
#define STRETTO_PREFILL(DVT)                                                \
  return launch_typed<T, DVT, VEC>(q, k, v, out, B, S, KV, G, dk, dv,      \
                                   window, causal, scale, stream)
  if (dv <= 8) STRETTO_PREFILL(1);
  if (dv <= 16) STRETTO_PREFILL(2);
  if (dv <= 24) STRETTO_PREFILL(3);
  if (dv <= 32) STRETTO_PREFILL(4);
  if (dv <= 64) STRETTO_PREFILL(8);
  STRETTO_PREFILL(16);
#undef STRETTO_PREFILL
}

template <typename T>
cudaError_t launch_any(const void* q, const void* k, const void* v,
                       void* out, int B, int S, int KV, int G, int dk,
                       int dv, int window, int causal, float scale,
                       cudaStream_t stream) {
  constexpr int EPC = 16 / (int)sizeof(T);
  const bool vec = dk % EPC == 0 && dv % EPC == 0 &&
                   reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(v) % 16 == 0;
  if (vec)
    return launch_dv<T, true>(q, k, v, out, B, S, KV, G, dk, dv, window,
                              causal, scale, stream);
  return launch_dv<T, false>(q, k, v, out, B, S, KV, G, dk, dv, window,
                             causal, scale, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out). The caller checks
// 1 <= G <= 64, dk <= 256, dv <= 128, window >= 1.
int stretto_prefill_attention(const void* q, const void* k, const void* v,
                              void* out, int B, int S, int KV, int G, int dk,
                              int dv, int window, int causal, float scale,
                              int dtype, void* stream) {
  if (G < 1 || G > 64 || dk < 1 || dk > 256 || dv < 1 || dv > 128 ||
      window < 1 || B < 1 || S < 1 || KV < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0)
    e = launch_any<float>(q, k, v, out, B, S, KV, G, dk, dv, window, causal,
                          scale, st);
  else if (dtype == 1)
    e = launch_any<__nv_bfloat16>(q, k, v, out, B, S, KV, G, dk, dv, window,
                                  causal, scale, st);
  else
    e = cudaErrorInvalidValue;
  return (int)e;
}

}  // extern "C"
