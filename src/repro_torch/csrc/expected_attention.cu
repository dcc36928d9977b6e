// Expected-Attention compression scores, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/expected_attention.py
// (expected_attention_scores -> _ea_kernel), which the JAX package maps
// over the layers with jax.vmap. For every layer l, item b, cached position
// s and KV head h:
//   score[l, b, s, h] = mean_g[ (k . mu_g) / sqrt(dk) + 0.5 (k*k) . sig2_g / dk ]
// with mu, sig2 the (KV, G, dk) Gaussian statistics of layer l's future
// queries. One launch scores every layer and item of a prefill chunk.
//
// Layouts:
//   k     (L, B, S, KV, dk)  float32 or bfloat16; (S, KV, dk) contiguous,
//                            the layer and item axes at any stride (a
//                            chunk's cache, or one item's slice of it)
//   mu    (L, KV, G, dk)     float32 or bfloat16, contiguous
//   sig2  (L, KV, G, dk)     mu's type, contiguous
//   out   (L, B, S, KV)      float32, contiguous
//
// What bounds it on the H100: bytes. Every K element is read once; the
// statistics are tiny and the output is one float per K row. At the 8B
// Session chunk (L 32, B 4, S 512, KV 8, dk 128, bfloat16) that is 134 MB,
// about 40 us at 3.35 TB/s. The arithmetic as the TPU kernel writes it (two
// dot products per query head, 4 G flops per element, 8 per byte of
// bfloat16) would take about 40% of that time on the float32 pipe at G = 4,
// so the design cuts instructions per element first.
//
// What the design does about it:
//  * mean_g is linear, so each CTA reduces its layer's stats over g once,
//    in order g = 0 .. G-1, and folds the factors in:
//      a[d] = (sum_g mu_g[d]) * fa,    fa = dk^-1/2 / G
//      c[d] = (sum_g sig2_g[d]) * fc,  fc = 0.5 / dk / G
//    and a row's score is sum_d k[d] (a[d] + k[d] c[d]): two FMAs and one
//    widening per element, whatever G is.
//  * Stats in registers: a row of dk elements is W lanes, each owning a
//    fixed slice of NV 16-byte vectors (bfloat16 dk 128: 16 lanes of 8),
//    with a[] and c[] of its slice in registers (read again from shared
//    memory per row only when a lane's rows change KV head). A lane sums
//    its slice in order; the row's W partials are added with an xor
//    butterfly, once per row.
//  * Bytes in flight, in the order they lie: the grid is (items x row
//    tiles, layers); a CTA reads one stretch of an item's (S, KV, dk)
//    block (bfloat16 dk 128: 256 rows, 64 KB), all KV heads of its
//    positions. Every lane issues its first UNROLL 16-byte loads before
//    the CTA reduces the stats of every KV head, and each of the PASSES
//    passes issues the next one's loads before it computes.
//  * Odd widths (a row not a power-of-two count of 16-byte vectors, or not
//    16-byte aligned: the planted dk 24, dk 18) run the row kernel: one
//    thread per row, the reduced stats in shared memory (read as
//    broadcasts), 16-byte or element loads.
//  * Determinism: a score depends only on its own K row and its (layer,
//    KV head) stats, summed in an order fixed by dk, so an item's scores
//    are bit-identical scored alone or at any place in any chunk.
// The TPU kernel runs the two dot products as (bs, dk) x (dk, G) matrix
// products on the MXU; at G <= 8 that is far too narrow for a tensor-core
// tile, and after the reduction over g it is a dot product per row.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <algorithm>
#include <type_traits>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 2;     // rows a lane loads at once (vector kernel)
constexpr int PASSES = 8;     // such loads per lane (vector kernel)
constexpr int TILE = 512;     // positions of one item per CTA (row kernel)
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// A 16-byte vector of T as floats.
template <typename T>
__device__ __forceinline__ void widen(uint4 u, float* out) {
  if constexpr (std::is_same<T, float>::value) {
    out[0] = __uint_as_float(u.x); out[1] = __uint_as_float(u.y);
    out[2] = __uint_as_float(u.z); out[3] = __uint_as_float(u.w);
  } else {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(h[e]);
      out[2 * e] = f.x;
      out[2 * e + 1] = f.y;
    }
  }
}

// LW consecutive elements at p as floats: one element, or a 16-byte vector
// (p 16-byte aligned, LW * sizeof(T) == 16).
template <typename T, int LW>
__device__ __forceinline__ void load_vec(const T* __restrict__ p, float* out) {
  static_assert(LW == 1 || LW * sizeof(T) == 16, "one element or 16 bytes");
  if constexpr (LW == 1)
    out[0] = to_f(p[0]);
  else
    widen<T>(__ldg(reinterpret_cast<const uint4*>(p)), out);
}

// The reduced stats of column d of (layer l, KV head kv), in order over g.
template <typename TS>
__device__ __forceinline__ void reduce_stats(const TS* __restrict__ mu,
                                             const TS* __restrict__ sig2,
                                             long head, int G, int dk, int d,
                                             float fa, float fc, float& a,
                                             float& c) {
  float sa = 0.f, sc = 0.f;
  for (int g = 0; g < G; ++g) {
    sa += to_f(mu[(head * G + g) * dk + d]);
    sc += to_f(sig2[(head * G + g) * dk + d]);
  }
  a = sa * fa;
  c = sc * fc;
}

// grid (B * n_tiles, L); a row is W = dk / (NV * LW) lanes. The rows of
// one (layer, item) are taken flat, r = s * KV + h, as they lie in memory,
// and a CTA reads PASSES * UNROLL * THREADS / W consecutive ones: every
// lane issues its first UNROLL rows' loads, the CTA reduces the stats of
// all KV heads into shared memory (2 KV dk floats) while they are in
// flight, and each pass issues the next pass's loads before it computes.
template <typename T, typename TS, int NV>
__global__ void __launch_bounds__(THREADS)
ea_vec_kernel(const T* __restrict__ k, const TS* __restrict__ mu,
              const TS* __restrict__ sig2, float* __restrict__ out, int B,
              int S, int KV, int G, int dk, long long sL, long long sB,
              int n_tiles, float fa, float fc) {
  constexpr int LW = 16 / (int)sizeof(T);
  constexpr int EPL = NV * LW;                 // elements per lane
  extern __shared__ float smem[];
  float* sa = smem;                            // [KV][dk]
  float* sc = smem + KV * dk;                  // [KV][dk]
  const int l = blockIdx.y;
  const int b = blockIdx.x / n_tiles, tile = blockIdx.x - b * n_tiles;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int W = dk / EPL;
  const int sub = lane & (W - 1), grp = lane / W;
  const int step = THREADS / W;                // rows per CTA pass
  const int n_rows = S * KV;
  const int r0 = tile * PASSES * UNROLL * step + warp * (32 / W) + grp;

  const T* kb = k + l * sL + b * sB + sub * EPL;
  uint4 raw[2][UNROLL][NV];
  auto load = [&](int pass, uint4 (&x)[UNROLL][NV]) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int r = r0 + (pass * UNROLL + u) * step;
      if (r < n_rows) {
#pragma unroll
        for (int v = 0; v < NV; ++v)
          x[u][v] = __ldg(reinterpret_cast<const uint4*>(
              kb + (long)r * dk + v * LW));
      }
    }
  };
  load(0, raw[0]);
  for (int i = threadIdx.x; i < KV * dk; i += THREADS) {
    const int h = i / dk;
    reduce_stats(mu, sig2, (long)l * KV + h, G, dk, i - h * dk, fa, fc,
                 sa[i], sc[i]);
  }
  __syncthreads();
  // a lane's rows share one KV head when a pass spans whole positions
  const bool one_head = step % KV == 0;
  float a[EPL], c[EPL];
  auto stats_of = [&](int h) {
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      a[e] = sa[h * dk + sub * EPL + e];
      c[e] = sc[h * dk + sub * EPL + e];
    }
  };
  stats_of(r0 % KV);

  float* ob = out + ((long)l * B + b) * n_rows;
#pragma unroll
  for (int pass = 0; pass < PASSES; ++pass) {
    if (pass + 1 < PASSES) load(pass + 1, raw[(pass + 1) & 1]);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int r = r0 + (pass * UNROLL + u) * step;
      float acc = 0.f;
      if (r < n_rows) {
        if (!one_head) stats_of(r % KV);
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          float x[LW];
          widen<T>(raw[pass & 1][u][v], x);
#pragma unroll
          for (int e = 0; e < LW; ++e)
            acc = fmaf(x[e], fmaf(x[e], c[v * LW + e], a[v * LW + e]), acc);
        }
      }
      // every lane runs every shuffle (pass and u are uniform)
      for (int off = W >> 1; off > 0; off >>= 1)
        acc += __shfl_xor_sync(FULL, acc, off);
      if (r < n_rows && sub == 0) ob[r] = acc;
    }
  }
}

// grid (B * n_tiles, KV, L); one thread per row, LW elements per load, the
// reduced stats in shared memory (2 dk floats).
template <typename T, typename TS, int LW>
__global__ void __launch_bounds__(THREADS)
ea_row_kernel(const T* __restrict__ k, const TS* __restrict__ mu,
              const TS* __restrict__ sig2, float* __restrict__ out, int B,
              int S, int KV, int G, int dk, long long sL, long long sB,
              int n_tiles, float fa, float fc) {
  extern __shared__ float smem[];
  float* sa = smem;            // [dk]
  float* sc = smem + dk;       // [dk]
  const int kv = blockIdx.y, l = blockIdx.z;
  const int b = blockIdx.x / n_tiles, tile = blockIdx.x - b * n_tiles;
  const long head = (long)l * KV + kv;
  for (int d = threadIdx.x; d < dk; d += THREADS)
    reduce_stats(mu, sig2, head, G, dk, d, fa, fc, sa[d], sc[d]);
  __syncthreads();
  const T* kb = k + l * sL + b * sB + (long)kv * dk;
  float* ob = out + ((long)l * B + b) * S * KV + kv;
  const int s1 = min(S, (tile + 1) * TILE);
  for (int s = tile * TILE + threadIdx.x; s < s1; s += THREADS) {
    const T* row = kb + (long)s * KV * dk;
    float acc = 0.f;
    for (int d = 0; d < dk; d += LW) {
      float x[LW];
      load_vec<T, LW>(row + d, x);
#pragma unroll
      for (int e = 0; e < LW; ++e)
        acc = fmaf(x[e], fmaf(x[e], sc[d + e], sa[d + e]), acc);
    }
    ob[(long)s * KV] = acc;
  }
}

struct Args {
  const void* k; const void* mu; const void* sig2; float* out;
  int L, B, S, KV, G, dk; long long sL, sB; float fa, fc;
  cudaStream_t stream;
};

template <typename T, typename TS>
cudaError_t launch_typed(const Args& a) {
  constexpr int LW = 16 / (int)sizeof(T);
  const int esz = (int)sizeof(T);
  const bool aligned = reinterpret_cast<uintptr_t>(a.k) % 16 == 0 &&
                       (a.sL * esz) % 16 == 0 && (a.sB * esz) % 16 == 0 &&
                       (a.dk * esz) % 16 == 0;
  const int chunks = aligned ? a.dk * esz / 16 : 0;   // 16-byte vectors
  const bool vec = chunks > 0 && (chunks & (chunks - 1)) == 0 &&
                   chunks <= 64 && 2 * sizeof(float) * a.KV * a.dk <= 48 * 1024;
  if ((long)a.S * a.KV > 0x7fffffffL) return cudaErrorInvalidValue;
  // the vector kernel's CTA takes PASSES * UNROLL * THREADS / W flat (s, h)
  // rows of one item; the row kernel's TILE positions of one KV head
  const int W = std::min(chunks, 32);
  const long span = vec ? (long)a.S * a.KV : a.S;
  const int tile = vec ? PASSES * UNROLL * THREADS / W : TILE;
  const int n_tiles = (int)((span + tile - 1) / tile);
  if ((long)a.B * n_tiles > 0x7fffffffL || a.KV > 65535 || a.L > 65535)
    return cudaErrorInvalidValue;
  const dim3 grid = vec ? dim3(a.B * n_tiles, a.L)
                        : dim3(a.B * n_tiles, a.KV, a.L);
  const size_t smem = sizeof(float) * 2 * (size_t)(vec ? a.KV : 1) * a.dk;
  if (smem > 48 * 1024) return cudaErrorInvalidValue;     // dk > 6144
  const T* k = static_cast<const T*>(a.k);
  const TS* mu = static_cast<const TS*>(a.mu);
  const TS* sg = static_cast<const TS*>(a.sig2);
  if (vec && chunks <= 32)
    ea_vec_kernel<T, TS, 1><<<grid, THREADS, smem, a.stream>>>(
        k, mu, sg, a.out, a.B, a.S, a.KV, a.G, a.dk, a.sL, a.sB, n_tiles,
        a.fa, a.fc);
  else if (vec)
    ea_vec_kernel<T, TS, 2><<<grid, THREADS, smem, a.stream>>>(
        k, mu, sg, a.out, a.B, a.S, a.KV, a.G, a.dk, a.sL, a.sB, n_tiles,
        a.fa, a.fc);
  else if (chunks > 0)
    ea_row_kernel<T, TS, LW><<<grid, THREADS, smem, a.stream>>>(
        k, mu, sg, a.out, a.B, a.S, a.KV, a.G, a.dk, a.sL, a.sB, n_tiles,
        a.fa, a.fc);
  else
    ea_row_kernel<T, TS, 1><<<grid, THREADS, smem, a.stream>>>(
        k, mu, sg, a.out, a.B, a.S, a.KV, a.G, a.dk, a.sL, a.sB, n_tiles,
        a.fa, a.fc);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_stats(const Args& a, int stats_dtype) {
  if (stats_dtype == 0) return launch_typed<T, float>(a);
  if (stats_dtype == 1) return launch_typed<T, __nv_bfloat16>(a);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype, stats_dtype: 0 = float32, 1 = bfloat16 (the types of k and of
// mu / sig2). sL, sB: the element strides of k's layer and item axes.
int stretto_expected_attention_scores(const void* k, const void* mu,
                                      const void* sig2, float* out, int L,
                                      int B, int S, int KV, int G, int dk,
                                      long long sL, long long sB, float fa,
                                      float fc, int dtype, int stats_dtype,
                                      void* stream) {
  if (L < 1 || B < 1 || S < 1 || KV < 1 || G < 1 || dk < 1)
    return (int)cudaErrorInvalidValue;
  const Args a{k, mu, sig2, out, L, B, S, KV, G, dk, sL, sB, fa, fc,
               static_cast<cudaStream_t>(stream)};
  cudaError_t e;
  if (dtype == 0)
    e = launch_stats<float>(a, stats_dtype);
  else if (dtype == 1)
    e = launch_stats<__nv_bfloat16>(a, stats_dtype);
  else
    e = cudaErrorInvalidValue;
  return (int)e;
}

}  // extern "C"
