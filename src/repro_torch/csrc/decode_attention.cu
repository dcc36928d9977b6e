// Flash-decode over right-padded (compressed) KV caches, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of repro/kernels/decode_attention.py:
//   decode_query_attention (_query_kernel -> _query_core), the fused
//     Lq-token query decode: query i sits at lengths-Lq+i and sees cache
//     position p iff p <= q_pos and q_pos - p < window;
//   decode_attention (_decode_kernel -> _decode_core), the single-token
//     decode: the same math at Lq = 1 (pos < length, length-1-pos < window).
// Both entry points below launch the same two kernels; each keeps its own
// C symbol so the Python wrappers count their launches apart.
//
// Layouts (row-major, contiguous), one element type T (float32 or bfloat16):
//   q    (B, Lq, KV, G, dk)
//   k    (B, S, KV, dk)
//   v    (B, S, KV, dv)
//   lens (B,) int32          valid tokens per item, query tokens included
//   out  (B, Lq, KV, G, dv)
// Sums run in float32.
//
// What bounds it on the H100: bytes. Every query row of a KV head reads the
// whole visible K/V of that head once, and there are only Lq*G rows (4 at
// stretto-llama-8b with Lq = 1, 1 on the planted models), far too few rows
// to feed a tensor-core tile (wgmma needs M = 64). At the 8B shapes (B 14,
// S 1152 after padding, KV 8, dk = dv = 128, bfloat16) one layer call reads
// about 66 MB of K and V: about 20 us at 3.35 TB/s. The arithmetic, 4 FMAs
// per K or V element at 8B, is far below the card's rate.
//
// What the design does about it:
//  * Split-S ("FlashDecoding"): one CTA per (split, kv head, item), each
//    over a fixed chunk of CHUNK cache positions, so an 8B layer call runs
//    about 1000 CTAs and keeps every SM streaming. The TPU kernel instead
//    walks S in order and carries (m, l, acc) across grid steps; no Hopper
//    block can do that, so a second small kernel combines the splits.
//  * A CTA handles all Lq*G query rows of its KV head, so each K/V byte
//    is read from device memory once for all of them.
//  * A CTA first copies its chunk's visible K and V rows into shared
//    memory with 16-byte vector loads (neighbouring threads, neighbouring
//    addresses; every load independent of the others, so a CTA keeps its
//    whole chunk in flight at once instead of one row per thread). At 8B
//    that is 64 KB per CTA, two CTAs (16 warps) per SM.
//  * The number of query rows held in registers (RT: 1, 4 or 16) is a
//    template parameter chosen from Lq*G, so the inner loops carry no
//    predicated work for rows that do not exist.
//  * QK: a group of W threads shares one cache position and reads its K
//    row from shared memory, then reduces the W partial dots with
//    shuffles. PV: one thread per output dimension reads V from shared
//    memory; no cross-thread sum is needed at dv = 128.
//  * Positions at or beyond an item's length, and whole chunks outside
//    every row's window, are never read: a padded or compressed batch
//    streams only the bytes it needs.
//  * Determinism: the chunk size is fixed, so the splits depend on S alone
//    and a position always falls into the same split. A split an item
//    cannot see writes (m = -inf, l = 0, acc = 0), and the combine adds
//    them in a fixed order as exact zeros. An item's output therefore does
//    not depend on the batch it rides in or on how far the batch is padded.
//  * Odd head dims (24 on the planted lg model) fall back to scalar loads
//    bounded by dk, which masks the ragged edge.
//
// The window arrives as an int clamped to 2^30 by the wrapper (the JAX
// wrapper's int32 window overflows beyond that).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;  // threads per CTA
constexpr int CHUNK = 128;    // cache positions per split

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

// VEC consecutive elements at p, as floats. VEC > 1 needs p 16-byte aligned.
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float* out) {
  if constexpr (VEC == 1) {
    out[0] = to_f(p[0]);
  } else if constexpr (sizeof(T) == 4) {
    static_assert(VEC == 4, "float vectors hold 4 elements");
    const float4 u = *reinterpret_cast<const float4*>(p);
    out[0] = u.x; out[1] = u.y; out[2] = u.z; out[3] = u.w;
  } else {
    static_assert(VEC == 8, "bfloat16 vectors hold 8 elements");
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
    for (int e = 0; e < 8; ++e) out[e] = __bfloat162float(h[e]);
  }
}

__device__ __forceinline__ int pow2_at_least(int n, int cap) {
  int w = 1;
  while (w < n && w < cap) w <<= 1;
  return w;
}

// dst[r * width + c] = src[r * stride + c] for r < n_rows, c < width, with
// VEC-element (16-byte) copies when VEC > 1.
template <typename T, int VEC>
__device__ __forceinline__ void stage_rows(T* dst, const T* __restrict__ src,
                                           long stride, int n_rows, int width) {
  const int nv = width / VEC;
#pragma unroll 4
  for (int i = threadIdx.x; i < n_rows * nv; i += THREADS) {
    const int r = i / nv, c = (i - r * nv) * VEC;
    if constexpr (VEC == 1) {
      dst[r * width + c] = src[r * stride + c];
    } else {
      *reinterpret_cast<uint4*>(dst + r * width + c) =
          *reinterpret_cast<const uint4*>(src + r * stride + c);
    }
  }
}

// One CTA: item b, KV head kv, cache positions [split*CHUNK, +CHUNK).
// Writes the split's row maxima m, row sums l and unnormalised outputs acc.
// Query rows are processed RT at a time.
template <typename T, int VEC, int RT>
__global__ void __launch_bounds__(THREADS)
split_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const int* __restrict__ lens,
             float* __restrict__ part_m, float* __restrict__ part_l,
             float* __restrict__ part_acc, int Lq, int KV, int G, int dk,
             int dv, int S, int window, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int split = blockIdx.x, kv = blockIdx.y, b = blockIdx.z;
  const int n_split = gridDim.x;
  const int R = Lq * G;
  const int tid = threadIdx.x;
  const int p0 = split * CHUNK;
  const int length = lens[b];

  const long part_row = ((long)(b * KV + kv) * n_split + split) * R;

  // Chunk visible to no row: positions >= length are masked for every
  // row, and a row at q_pos sees nothing at or before q_pos - window.
  const int last_q = length - 1, first_q = length - Lq;
  const int p_last = min(p0 + CHUNK, S) - 1;
  if (p0 > last_q || first_q - p_last >= window) {
    for (int i = tid; i < R; i += THREADS) {
      part_m[part_row + i] = -INFINITY;
      part_l[part_row + i] = 0.f;
    }
    for (int i = tid; i < R * dv; i += THREADS) part_acc[part_row * dv + i] = 0.f;
    return;
  }
  // positions this chunk must read: [p0, p0 + n_pos)
  const int n_pos = min(p0 + CHUNK, min(S, length)) - p0;

  T* ks = reinterpret_cast<T*>(smem_raw);           // [CHUNK][dk]
  T* vs = ks + CHUNK * dk;                          // [CHUNK][dv]
  float* qs = reinterpret_cast<float*>(vs + CHUNK * dv);  // [R][dk], scaled
  float* sc = qs + R * dk;           // [R][CHUNK], scores then probabilities
  float* red = sc + R * CHUNK;       // [THREADS][RT], PV partials

  const long row0 = ((long)b * S + p0) * KV + kv;   // (b, p0, kv) row
  stage_rows<T, VEC>(ks, k + row0 * dk, (long)KV * dk, n_pos, dk);
  stage_rows<T, VEC>(vs, v + row0 * dv, (long)KV * dv, n_pos, dv);
  for (int i = tid; i < R * dk; i += THREADS) {
    const int r = i / dk, d = i - r * dk;
    const int qi = r / G, g = r - qi * G;
    const long off = (((long)(b * Lq + qi) * KV + kv) * G + g) * dk + d;
    qs[i] = to_f(q[off]) * scale;
  }
  __syncthreads();

  // ---- scores: W threads per position --------------------------------
  const int nvec = dk / VEC;
  const int W = pow2_at_least(nvec, 32);
  const int n_groups = THREADS / W;
  const int grp = tid / W, lane = tid - grp * W;
  for (int r0 = 0; r0 < R; r0 += RT) {
    const int nr = min(RT, R - r0);   // uniform across the block
    for (int pl = grp; pl < CHUNK; pl += n_groups) {
      float part[RT];
#pragma unroll
      for (int rr = 0; rr < RT; ++rr) part[rr] = 0.f;
      if (pl < n_pos) {
        for (int vi = lane; vi < nvec; vi += W) {
          float kf[VEC];
          load_vec<T, VEC>(ks + pl * dk + vi * VEC, kf);
#pragma unroll
          for (int rr = 0; rr < RT; ++rr) {
            if (RT == 1 || rr < nr) {
              const float* qr = qs + (r0 + rr) * dk + vi * VEC;
#pragma unroll
              for (int e = 0; e < VEC; ++e) part[rr] = fmaf(qr[e], kf[e], part[rr]);
            }
          }
        }
      }
      // every lane of the warp runs the same iterations: full-mask shuffles
#pragma unroll
      for (int rr = 0; rr < RT; ++rr) {
        if (rr < nr) {
          for (int off = W >> 1; off > 0; off >>= 1)
            part[rr] += __shfl_xor_sync(0xffffffffu, part[rr], off);
        }
      }
      if (lane == 0) {
        const int p = p0 + pl;
        for (int rr = 0; rr < nr; ++rr) {
          const int r = r0 + rr;
          const int q_pos = first_q + r / G;
          const bool ok = pl < n_pos && p <= q_pos && q_pos - p < window;
          sc[r * CHUNK + pl] = ok ? part[rr] : -INFINITY;
        }
      }
    }
  }
  __syncthreads();

  // ---- softmax within the chunk: one warp per row ----------------------
  const int warp = tid >> 5, wl = tid & 31;
  for (int r = warp; r < R; r += THREADS / 32) {
    float* row = sc + r * CHUNK;
    float m = -INFINITY;
    for (int i = wl; i < CHUNK; i += 32) m = fmaxf(m, row[i]);
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float l = 0.f;
    for (int i = wl; i < CHUNK; i += 32) {
      const float pr = (m == -INFINITY) ? 0.f : expf(row[i] - m);
      row[i] = pr;
      l += pr;
    }
    for (int off = 16; off > 0; off >>= 1)
      l += __shfl_xor_sync(0xffffffffu, l, off);
    if (wl == 0) {
      part_m[part_row + r] = m;
      part_l[part_row + r] = l;
    }
  }
  __syncthreads();

  // ---- PV: DV_T threads over output dims, NG position groups ----------
  const int DV_T = pow2_at_least(dv, THREADS);
  const int NG = THREADS / DV_T;
  const int pg = tid / DV_T, d0 = tid - pg * DV_T;
  for (int r0 = 0; r0 < R; r0 += RT) {
    const int nr = min(RT, R - r0);
    for (int dbase = 0; dbase < dv; dbase += DV_T) {
      const int d = dbase + d0;
      float acc[RT];
#pragma unroll
      for (int rr = 0; rr < RT; ++rr) acc[rr] = 0.f;
      if (d < dv) {
        for (int pl = pg; pl < n_pos; pl += NG) {
          const float vv = to_f(vs[pl * dv + d]);
#pragma unroll
          for (int rr = 0; rr < RT; ++rr)
            if (RT == 1 || rr < nr)
              acc[rr] = fmaf(sc[(r0 + rr) * CHUNK + pl], vv, acc[rr]);
        }
      }
      if (NG == 1) {
        if (d < dv) {
          for (int rr = 0; rr < nr; ++rr)
            part_acc[(part_row + r0 + rr) * dv + d] = acc[rr];
        }
      } else {
        // sum the NG position groups in a fixed order
#pragma unroll
        for (int rr = 0; rr < RT; ++rr) red[tid * RT + rr] = acc[rr];
        __syncthreads();
        if (pg == 0 && d < dv) {
          for (int rr = 0; rr < nr; ++rr) {
            float s = 0.f;
            for (int gi = 0; gi < NG; ++gi) s += red[(gi * DV_T + d0) * RT + rr];
            part_acc[(part_row + r0 + rr) * dv + d] = s;
          }
        }
        __syncthreads();
      }
    }
  }
}

// One CTA per (item, KV head): merge the splits in split order.
template <typename T>
__global__ void __launch_bounds__(THREADS)
combine_kernel(const float* __restrict__ part_m, const float* __restrict__ part_l,
               const float* __restrict__ part_acc, T* __restrict__ out,
               int Lq, int KV, int G, int dv, int n_split) {
  const int bk = blockIdx.x;
  const int b = bk / KV, kv = bk - b * KV;
  const int R = Lq * G;
  const long base = (long)bk * n_split * R;
  for (int i = threadIdx.x; i < R * dv; i += THREADS) {
    const int r = i / dv, d = i - r * dv;
    float M = -INFINITY;
    for (int s = 0; s < n_split; ++s) M = fmaxf(M, part_m[base + (long)s * R + r]);
    float num = 0.f, den = 0.f;
    if (M != -INFINITY) {
      for (int s = 0; s < n_split; ++s) {
        const long j = base + (long)s * R + r;
        const float w = expf(part_m[j] - M);  // exp(-inf) = 0 for empty splits
        den += part_l[j] * w;
        num += part_acc[j * dv + d] * w;
      }
    }
    const float o = den > 0.f ? num / den : 0.f;
    const int qi = r / G, g = r - qi * G;
    out[(((long)(b * Lq + qi) * KV + kv) * G + g) * dv + d] = from_f<T>(o);
  }
}

template <typename T, int VEC, int RT>
cudaError_t launch_typed(const void* q, const void* k, const void* v,
                         const int* lens, void* out, float* pm, float* pl,
                         float* pacc, int B, int Lq, int KV, int G, int dk,
                         int dv, int S, int window, float scale,
                         cudaStream_t stream) {
  const int n_split = (S + CHUNK - 1) / CHUNK;
  const size_t R = (size_t)Lq * G;
  const size_t smem = sizeof(T) * CHUNK * (dk + dv) +
                      sizeof(float) * (R * dk + R * CHUNK + (size_t)THREADS * RT);
  auto kern = split_kernel<T, VEC, RT>;
  static size_t smem_opted = 48 * 1024;   // per instantiation
  if (smem > smem_opted) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    smem_opted = smem;
  }
  dim3 grid(n_split, KV, B);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lens, pm, pl, pacc, Lq, KV, G, dk, dv, S,
      window, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  combine_kernel<T><<<B * KV, THREADS, 0, stream>>>(
      pm, pl, pacc, static_cast<T*>(out), Lq, KV, G, dv, n_split);
  return cudaGetLastError();
}

template <typename T, int VEC>
cudaError_t launch_rows(const void* q, const void* k, const void* v,
                        const int* lens, void* out, float* pm, float* pl,
                        float* pacc, int B, int Lq, int KV, int G, int dk,
                        int dv, int S, int window, float scale,
                        cudaStream_t stream) {
  const int R = Lq * G;
  if (R == 1)
    return launch_typed<T, VEC, 1>(q, k, v, lens, out, pm, pl, pacc, B, Lq,
                                   KV, G, dk, dv, S, window, scale, stream);
  if (R <= 4)
    return launch_typed<T, VEC, 4>(q, k, v, lens, out, pm, pl, pacc, B, Lq,
                                   KV, G, dk, dv, S, window, scale, stream);
  return launch_typed<T, VEC, 16>(q, k, v, lens, out, pm, pl, pacc, B, Lq,
                                  KV, G, dk, dv, S, window, scale, stream);
}

template <typename T>
cudaError_t launch_any(const void* q, const void* k, const void* v,
                       const int* lens, void* out, float* pm, float* pl,
                       float* pacc, int B, int Lq, int KV, int G, int dk,
                       int dv, int S, int window, float scale,
                       cudaStream_t stream) {
  constexpr int VEC = 16 / (int)sizeof(T);
  const bool vec_ok = dk % VEC == 0 && dv % VEC == 0 &&
                      reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(v) % 16 == 0;
  if (vec_ok)
    return launch_rows<T, VEC>(q, k, v, lens, out, pm, pl, pacc, B, Lq, KV, G,
                               dk, dv, S, window, scale, stream);
  return launch_rows<T, 1>(q, k, v, lens, out, pm, pl, pacc, B, Lq, KV, G, dk,
                           dv, S, window, scale, stream);
}

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it)
int launch(const void* q, const void* k, const void* v, const int* lens,
           void* out, float* pm, float* pl, float* pacc, int B, int Lq, int KV,
           int G, int dk, int dv, int S, int window, float scale, int dtype,
           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0)
    e = launch_any<float>(q, k, v, lens, out, pm, pl, pacc, B, Lq, KV, G, dk,
                          dv, S, window, scale, st);
  else if (dtype == 1)
    e = launch_any<__nv_bfloat16>(q, k, v, lens, out, pm, pl, pacc, B, Lq, KV,
                                  G, dk, dv, S, window, scale, st);
  else
    e = cudaErrorInvalidValue;
  return (int)e;
}

}  // namespace

extern "C" {

// Fused Lq-token query decode (replaces decode_query_attention).
int stretto_decode_query_attention(const void* q, const void* k, const void* v,
                                   const int* lens, void* out, float* pm,
                                   float* pl, float* pacc, int B, int Lq,
                                   int KV, int G, int dk, int dv, int S,
                                   int window, float scale, int dtype,
                                   void* stream) {
  return launch(q, k, v, lens, out, pm, pl, pacc, B, Lq, KV, G, dk, dv, S,
                window, scale, dtype, stream);
}

// Single-token decode (replaces decode_attention): the same kernels at Lq=1.
int stretto_decode_attention(const void* q, const void* k, const void* v,
                             const int* lens, void* out, float* pm, float* pl,
                             float* pacc, int B, int KV, int G, int dk, int dv,
                             int S, int window, float scale, int dtype,
                             void* stream) {
  return launch(q, k, v, lens, out, pm, pl, pacc, B, 1, KV, G, dk, dv, S,
                window, scale, dtype, stream);
}

}  // extern "C"
