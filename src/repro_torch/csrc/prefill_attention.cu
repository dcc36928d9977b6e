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
// Rows of a CTA: R = BQ * G query rows, row r = (query position q0 + r / G,
// head g = r % G) of one KV head, with BQ = 64 / G positions, so a CTA
// reads each K/V tile once for all G heads that share it.
//
// What bounds it on the H100: float32 operands run outside the tensor
// cores, at 67 TFLOP/s. At the planted build shapes (B 16, S 160, d 16 and
// 24) that is under 0.002 ms of work per call, so a call is bound by its
// launch and its serial walk over key tiles (PERF.md).
//
// What the design does about it, kept simple and right first:
//  * One CTA per (query tile, KV head, batch row); 128 threads. Thread
//    (rg, cg) = (tid / 8, tid % 8) owns rows 4 rg .. 4 rg + 3 and, of each
//    key tile, columns cg + 8 j; of the output, columns cg + 8 j. The row
//    statistics m and l live in registers, replicated over the 8 threads
//    of a row group, which reduce with shuffles inside one warp.
//  * Key tiles of BK = 32 positions are walked in increasing order from
//    the first tile the window reaches to the tile holding the causal
//    diagonal of the CTA's last query, so tiles wholly above the diagonal
//    or outside the window are never read (as the Pallas kernel skips
//    them). Within a tile the mask is exact per (row, key).
//  * The scaled Q tile and each K / V tile are staged in shared memory as
//    float32, with an odd row stride for Q and K so the 4 row groups of a
//    warp read different banks. At d 128 that is about 74 KB, above the
//    48 KB default, so the launcher raises the dynamic limit.
//  * Scores and P·V are float32 FMAs; exp is expf (full precision), as
//    the Pallas kernel feeds float32 operands to the MXU.
//  * No atomics and no split of S across CTAs: a row's sums run in one
//    fixed order that depends only on its position, the window and the
//    tile sizes, never on B or on S beyond the row (keys past a causal
//    row are masked to exact zeros). An item's rows are therefore
//    bit-identical alone and inside a larger, further right-padded batch,
//    which the profile store relies on.
//  * Head dims are runtime loop bounds (dk <= 256); dv is padded to the
//    next of 8, 16, 32, 64 or 128 in registers and shared memory, with the
//    pad columns zero-filled and never written (24 -> 32 on the planted lg
//    model). dk != dv works.
//  * Positions past S inside the last tiles are zero-filled, so a row
//    whose first live tile is all masked (its softmax then runs over
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

namespace {

constexpr int THREADS = 128;
constexpr int ROWS = 64;       // query rows (position x head) per CTA
constexpr int RPT = 4;         // rows per thread
constexpr int CG = 8;          // column groups (threads per row group)
constexpr int BK = 32;         // key positions per tile
constexpr int CPT = BK / CG;   // key columns per thread
constexpr float NEG_INF = -1e30f;

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

__host__ __device__ inline int odd_stride(int d) { return d | 1; }

// DVT output columns per thread: dv <= 8 * DVT.
template <typename T, int DVT>
__global__ void __launch_bounds__(THREADS)
prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, T* __restrict__ out, int S, int KV,
               int G, int dk, int dv, int window, int causal, float scale) {
  constexpr int DVP = CG * DVT;            // padded dv
  extern __shared__ float smem[];
  const int qs_stride = odd_stride(dk);
  float* Qs = smem;                        // [ROWS][qs_stride], scaled
  float* Ks = Qs + ROWS * qs_stride;       // [BK][qs_stride]
  float* Vs = Ks + BK * qs_stride;         // [BK][DVP]
  float* Ps = Vs + BK * DVP;               // [ROWS][BK + 1]
  constexpr int PS = BK + 1;

  const int tid = threadIdx.x;
  const int rg = tid / CG, cg = tid % CG;
  const int kv = blockIdx.y, b = blockIdx.z;
  const int BQ = ROWS / G;                 // query positions per CTA
  const int R = BQ * G;                    // live rows (<= ROWS)
  const int q0 = blockIdx.x * BQ;
  const int q_last = min(q0 + BQ, S) - 1;

  // ---- stage Q (scaled, float32); rows past S or past R are zero ----
  const long q_base = ((long)b * S * KV + kv) * G * dk;   // (b, 0, kv)
  const long q_pos_stride = (long)KV * G * dk;
  for (int e = tid; e < ROWS * dk; e += THREADS) {
    const int r = e / dk, d = e - r * dk;
    const int pos = q0 + r / G, g = r % G;
    float x = 0.f;
    if (r < R && pos < S)
      x = to_f(q[q_base + pos * q_pos_stride + (long)g * dk + d]) * scale;
    Qs[r * qs_stride + d] = x;
  }

  // ---- the key tiles this CTA's rows can see ----
  const int k_end = causal ? q_last + 1 : S;             // exclusive
  const int k_start = max(0, q0 - window + 1);
  const int t_first = k_start / BK;
  const int t_last = (k_end - 1) / BK;

  float m[RPT], l[RPT], acc[RPT][DVT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DVT; ++j) acc[i][j] = 0.f;
  }
  int qpos[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) qpos[i] = q0 + (rg * RPT + i) / G;

  const long kv_pos_stride = (long)KV;
  const long k_base = (long)b * S * KV + kv;               // row (b, 0, kv)

  for (int t = t_first; t <= t_last; ++t) {
    const int p0 = t * BK;
    __syncthreads();   // previous tile's K/V/P (and Q staging) done
    for (int e = tid; e < BK * dk; e += THREADS) {
      const int r = e / dk, d = e - r * dk;
      const int pos = p0 + r;
      Ks[r * qs_stride + d] =
          pos < S ? to_f(k[(k_base + pos * kv_pos_stride) * dk + d]) : 0.f;
    }
    for (int e = tid; e < BK * DVP; e += THREADS) {
      const int r = e / DVP, c = e - r * DVP;
      const int pos = p0 + r;
      Vs[e] = (pos < S && c < dv)
                  ? to_f(v[(k_base + pos * kv_pos_stride) * dv + c]) : 0.f;
    }
    __syncthreads();

    // scores s[i][j] for rows rg*RPT+i, keys p0 + cg + CG*j
    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
    const float* qrow = Qs + rg * RPT * qs_stride;
    const float* krow = Ks + cg * qs_stride;
    for (int d = 0; d < dk; ++d) {
      float qv[RPT], kvv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qv[i] = qrow[i * qs_stride + d];
#pragma unroll
      for (int j = 0; j < CPT; ++j) kvv[j] = krow[j * CG * qs_stride + d];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) s[i][j] = fmaf(qv[i], kvv[j], s[i][j]);
    }

    // mask, online softmax (all 8 threads of a row group agree on m, l)
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
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
#pragma unroll
      for (int off = 1; off < CG; off <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      alpha[i] = expf(m[i] - m_new);
      l[i] = l[i] * alpha[i] + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < CPT; ++j)
        Ps[(rg * RPT + i) * PS + cg + CG * j] = s[i][j];
    }
    __syncthreads();

    // acc = acc * alpha + P V over this tile's keys, in key order
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < DVT; ++j) acc[i][j] *= alpha[i];
    const float* prow = Ps + rg * RPT * PS;
    for (int kk = 0; kk < BK; ++kk) {
      float pv[RPT], vv[DVT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pv[i] = prow[i * PS + kk];
#pragma unroll
      for (int j = 0; j < DVT; ++j) vv[j] = Vs[kk * DVP + cg + CG * j];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < DVT; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

  // ---- out = acc / max(l, 1e-30), in T ----
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = rg * RPT + i;
    const int pos = q0 + r / G, g = r % G;
    if (r >= R || pos >= S) continue;
    const float inv_l = 1.f / fmaxf(l[i], 1e-30f);
    T* orow = out + ((((long)b * S + pos) * KV + kv) * G + g) * dv;
#pragma unroll
    for (int j = 0; j < DVT; ++j) {
      const int c = cg + CG * j;
      if (c < dv) orow[c] = from_f<T>(acc[i][j] * inv_l);
    }
  }
}

template <typename T, int DVT>
cudaError_t launch_typed(const void* q, const void* k, const void* v,
                         void* out, int B, int S, int KV, int G, int dk,
                         int dv, int window, int causal, float scale,
                         cudaStream_t stream) {
  const int qs_stride = odd_stride(dk);
  const size_t smem = sizeof(float) *
      ((size_t)(ROWS + BK) * qs_stride + (size_t)BK * CG * DVT +
       (size_t)ROWS * (BK + 1));
  auto kern = prefill_kernel<T, DVT>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const int BQ = ROWS / G;
  dim3 grid((S + BQ - 1) / BQ, KV, B);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, KV, G, dk, dv,
      window, causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_any(const void* q, const void* k, const void* v,
                       void* out, int B, int S, int KV, int G, int dk,
                       int dv, int window, int causal, float scale,
                       cudaStream_t stream) {
#define STRETTO_PREFILL(DVT)                                                \
  return launch_typed<T, DVT>(q, k, v, out, B, S, KV, G, dk, dv, window,   \
                              causal, scale, stream)
  if (dv <= 8) STRETTO_PREFILL(1);
  if (dv <= 16) STRETTO_PREFILL(2);
  if (dv <= 32) STRETTO_PREFILL(4);
  if (dv <= 64) STRETTO_PREFILL(8);
  STRETTO_PREFILL(16);
#undef STRETTO_PREFILL
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out). The caller checks
// 1 <= G <= 64, dk <= 256, dv <= 128, window >= 1.
int stretto_prefill_attention(const void* q, const void* k, const void* v,
                              void* out, int B, int S, int KV, int G, int dk,
                              int dv, int window, int causal, float scale,
                              int dtype, void* stream) {
  if (G < 1 || G > ROWS || dk < 1 || dk > 256 || dv < 1 || dv > 128 ||
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
