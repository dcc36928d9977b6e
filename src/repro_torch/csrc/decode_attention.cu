// Flash-decode over right-padded (compressed) KV caches, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of repro/kernels/decode_attention.py:
//   decode_query_attention (_query_kernel -> _query_core), the fused
//     Lq-token query decode: query i sits at lengths-Lq+i and sees cache
//     position p iff p <= q_pos and q_pos - p < window;
//   decode_attention (_decode_kernel -> _decode_core), the single-token
//     decode: the same math at Lq = 1 (pos < length, length-1-pos < window);
//   and the int8 bodies of both calls (_query_kernel_int8,
//     _decode_kernel_int8): K and V are int8 with one float32 scale per
//     (item, position, KV head), dequantised in float32 as int8 * scale
//     right after the load from shared memory.
// The four entry points below launch the same two kernel templates; each
// keeps its own C symbol so the Python wrappers count their launches apart.
//
// Layouts (row-major, contiguous). q and out share one type TQ (float32 or
// bfloat16); K and V have type TKV, which is TQ or int8:
//   q    (B, Lq, KV, G, dk)
//   k    (B, S, KV, dk)
//   v    (B, S, KV, dv)
//   ksc, vsc (B, S, KV) float32   int8 only: the per-row scales
//   lens (B,) int32          valid tokens per item, query tokens included
//   out  (B, Lq, KV, G, dv)
// Sums run in float32.
//
// Rows that see no cache position (lengths < Lq, or a window that excludes
// every position) get the mean of V over all S positions given, padding
// included: the Pallas kernels mask with a finite -1e30, so such a row's
// softmax is uniform over every position, and this kernel returns the same.
//
// What bounds it on the H100: bytes. Every query row of a KV head reads the
// whole visible K/V of that head once, and there are only Lq*G rows (4 at
// stretto-llama-8b with Lq = 1, 1 on the planted models), far too few rows
// to feed a tensor-core tile (wgmma needs M = 64). At the 8B shapes (B 14,
// S 1152 after padding, KV 8, dk = dv = 128, bfloat16) one layer call reads
// about 66 MB of K and V: about 20 us at 3.35 TB/s. The int8 bodies read 1
// byte per element plus 8 bytes of scales per (position, head), a little
// over half of that. The arithmetic, 4 FMAs per K or V element at 8B (and
// one multiply per element to dequantise), is far below the card's rate.
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
//    bounded by dk, which masks the ragged edge. int8 rows take 16-element
//    vectors, so dk = 24 takes the scalar path there too.
//  * int8: the chunk's K/V rows are staged as int8 (a quarter of the
//    float32 bytes in shared memory and from device memory) with the
//    chunk's scales beside them, and dequantised element by element as
//    they are read for the dot products.
//
// The window arrives as an int clamped to 2^30 by the wrapper (the JAX
// wrapper's int32 window overflows beyond that).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>
#include <type_traits>

namespace {

constexpr int THREADS = 256;  // threads per CTA
constexpr int CHUNK = 128;    // cache positions per split

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(int8_t x) { return (float)x; }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// VEC consecutive elements at p, as floats. VEC > 1 needs p 16-byte aligned
// and VEC * sizeof(T) == 16.
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float* out) {
  if constexpr (VEC == 1) {
    out[0] = to_f(p[0]);
  } else if constexpr (std::is_same<T, float>::value) {
    static_assert(VEC == 4, "float vectors hold 4 elements");
    const float4 u = *reinterpret_cast<const float4*>(p);
    out[0] = u.x; out[1] = u.y; out[2] = u.z; out[3] = u.w;
  } else if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    static_assert(VEC == 8, "bfloat16 vectors hold 8 elements");
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
    for (int e = 0; e < 8; ++e) out[e] = __bfloat162float(h[e]);
  } else {
    static_assert(VEC == 16, "int8 vectors hold 16 elements");
    const int4 u = *reinterpret_cast<const int4*>(p);
    const int8_t* h = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
    for (int e = 0; e < 16; ++e) out[e] = (float)h[e];
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
// Query rows are processed RT at a time. TKV = int8 reads ksc/vsc.
template <typename TQ, typename TKV, int VEC, int RT>
__global__ void __launch_bounds__(THREADS)
split_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
             const TKV* __restrict__ v, const float* __restrict__ ksc,
             const float* __restrict__ vsc, const int* __restrict__ lens,
             float* __restrict__ part_m, float* __restrict__ part_l,
             float* __restrict__ part_acc, int Lq, int KV, int G, int dk,
             int dv, int S, int window, float scale) {
  constexpr bool QUANT = std::is_same<TKV, int8_t>::value;
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

  TKV* ks = reinterpret_cast<TKV*>(smem_raw);       // [CHUNK][dk]
  TKV* vs = ks + CHUNK * dk;                        // [CHUNK][dv]
  float* kss = reinterpret_cast<float*>(vs + CHUNK * dv);  // [CHUNK] int8 only
  float* vss = kss + (QUANT ? CHUNK : 0);                  // [CHUNK] int8 only
  float* qs = vss + (QUANT ? CHUNK : 0);  // [R][dk], scaled
  float* sc = qs + R * dk;           // [R][CHUNK], scores then probabilities
  float* red = sc + R * CHUNK;       // [THREADS][RT], PV partials

  const long row0 = ((long)b * S + p0) * KV + kv;   // (b, p0, kv) row
  stage_rows<TKV, VEC>(ks, k + row0 * dk, (long)KV * dk, n_pos, dk);
  stage_rows<TKV, VEC>(vs, v + row0 * dv, (long)KV * dv, n_pos, dv);
  if constexpr (QUANT) {
    for (int i = tid; i < n_pos; i += THREADS) {
      kss[i] = ksc[row0 + (long)i * KV];
      vss[i] = vsc[row0 + (long)i * KV];
    }
  }
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
        const float kscale = QUANT ? kss[pl] : 1.f;
        for (int vi = lane; vi < nvec; vi += W) {
          float kf[VEC];
          load_vec<TKV, VEC>(ks + pl * dk + vi * VEC, kf);
          if constexpr (QUANT) {
#pragma unroll
            for (int e = 0; e < VEC; ++e) kf[e] = kf[e] * kscale;
          }
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
          float vv = to_f(vs[pl * dv + d]);
          if constexpr (QUANT) vv = vv * vss[pl];
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

// One CTA per (item, KV head): merge the splits in split order. A row that
// saw no position in any split (every m = -inf) takes the mean of V over
// all S positions, as the Pallas kernels' finite mask gives it.
template <typename TQ, typename TKV>
__global__ void __launch_bounds__(THREADS)
combine_kernel(const float* __restrict__ part_m, const float* __restrict__ part_l,
               const float* __restrict__ part_acc, const TKV* __restrict__ v,
               const float* __restrict__ vsc, TQ* __restrict__ out, int Lq,
               int KV, int G, int dv, int S, int n_split) {
  constexpr bool QUANT = std::is_same<TKV, int8_t>::value;
  const int bk = blockIdx.x;
  const int b = bk / KV, kv = bk - b * KV;
  const int R = Lq * G;
  const long base = (long)bk * n_split * R;
  for (int i = threadIdx.x; i < R * dv; i += THREADS) {
    const int r = i / dv, d = i - r * dv;
    float M = -INFINITY;
    for (int s = 0; s < n_split; ++s) M = fmaxf(M, part_m[base + (long)s * R + r]);
    float o;
    if (M != -INFINITY) {
      float num = 0.f, den = 0.f;
      for (int s = 0; s < n_split; ++s) {
        const long j = base + (long)s * R + r;
        const float w = expf(part_m[j] - M);  // exp(-inf) = 0 for empty splits
        den += part_l[j] * w;
        num += part_acc[j * dv + d] * w;
      }
      o = num / den;
    } else {
      float sum = 0.f;
      for (int p = 0; p < S; ++p) {
        const long row = ((long)b * S + p) * KV + kv;
        float x = to_f(v[row * dv + d]);
        if constexpr (QUANT) x = x * vsc[row];
        sum += x;
      }
      o = sum / (float)S;
    }
    const int qi = r / G, g = r - qi * G;
    out[(((long)(b * Lq + qi) * KV + kv) * G + g) * dv + d] = from_f<TQ>(o);
  }
}

struct Args {
  const void* q; const void* k; const void* v; const float* ksc;
  const float* vsc; const int* lens; void* out; float* pm; float* pl;
  float* pacc; int B, Lq, KV, G, dk, dv, S, window; float scale;
  cudaStream_t stream;
};

template <typename TQ, typename TKV, int VEC, int RT>
cudaError_t launch_typed(const Args& a) {
  constexpr bool QUANT = std::is_same<TKV, int8_t>::value;
  const int n_split = (a.S + CHUNK - 1) / CHUNK;
  const size_t R = (size_t)a.Lq * a.G;
  const size_t smem = sizeof(TKV) * CHUNK * (a.dk + a.dv) +
                      sizeof(float) * ((QUANT ? 2 * CHUNK : 0) + R * a.dk +
                                       R * CHUNK + (size_t)THREADS * RT);
  auto kern = split_kernel<TQ, TKV, VEC, RT>;
  static size_t smem_opted = 48 * 1024;   // per instantiation
  if (smem > smem_opted) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    smem_opted = smem;
  }
  dim3 grid(n_split, a.KV, a.B);
  kern<<<grid, THREADS, smem, a.stream>>>(
      static_cast<const TQ*>(a.q), static_cast<const TKV*>(a.k),
      static_cast<const TKV*>(a.v), a.ksc, a.vsc, a.lens, a.pm, a.pl, a.pacc,
      a.Lq, a.KV, a.G, a.dk, a.dv, a.S, a.window, a.scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  combine_kernel<TQ, TKV><<<a.B * a.KV, THREADS, 0, a.stream>>>(
      a.pm, a.pl, a.pacc, static_cast<const TKV*>(a.v), a.vsc,
      static_cast<TQ*>(a.out), a.Lq, a.KV, a.G, a.dv, a.S, n_split);
  return cudaGetLastError();
}

template <typename TQ, typename TKV, int VEC>
cudaError_t launch_rows(const Args& a) {
  const int R = a.Lq * a.G;
  if (R == 1) return launch_typed<TQ, TKV, VEC, 1>(a);
  if (R <= 4) return launch_typed<TQ, TKV, VEC, 4>(a);
  return launch_typed<TQ, TKV, VEC, 16>(a);
}

template <typename TQ, typename TKV>
cudaError_t launch_any(const Args& a) {
  constexpr int VEC = 16 / (int)sizeof(TKV);
  const bool vec_ok = a.dk % VEC == 0 && a.dv % VEC == 0 &&
                      reinterpret_cast<uintptr_t>(a.k) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(a.v) % 16 == 0;
  if (vec_ok) return launch_rows<TQ, TKV, VEC>(a);
  return launch_rows<TQ, TKV, 1>(a);
}

// dtype: 0 = float32, 1 = bfloat16 (q and out; k and v too unless int8)
int launch(const Args& a, int dtype, bool int8_kv) {
  cudaError_t e;
  if (dtype == 0)
    e = int8_kv ? launch_any<float, int8_t>(a) : launch_any<float, float>(a);
  else if (dtype == 1)
    e = int8_kv ? launch_any<__nv_bfloat16, int8_t>(a)
                : launch_any<__nv_bfloat16, __nv_bfloat16>(a);
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
  const Args a{q, k, v, nullptr, nullptr, lens, out, pm, pl, pacc, B, Lq, KV,
               G, dk, dv, S, window, scale, static_cast<cudaStream_t>(stream)};
  return launch(a, dtype, false);
}

// Single-token decode (replaces decode_attention): the same kernels at Lq=1.
int stretto_decode_attention(const void* q, const void* k, const void* v,
                             const int* lens, void* out, float* pm, float* pl,
                             float* pacc, int B, int KV, int G, int dk, int dv,
                             int S, int window, float scale, int dtype,
                             void* stream) {
  const Args a{q, k, v, nullptr, nullptr, lens, out, pm, pl, pacc, B, 1, KV,
               G, dk, dv, S, window, scale, static_cast<cudaStream_t>(stream)};
  return launch(a, dtype, false);
}

// int8 K/V with (B, S, KV) float32 scales (replaces _query_kernel_int8).
int stretto_decode_query_attention_int8(
    const void* q, const void* k, const void* v, const float* ksc,
    const float* vsc, const int* lens, void* out, float* pm, float* pl,
    float* pacc, int B, int Lq, int KV, int G, int dk, int dv, int S,
    int window, float scale, int dtype, void* stream) {
  const Args a{q, k, v, ksc, vsc, lens, out, pm, pl, pacc, B, Lq, KV, G, dk,
               dv, S, window, scale, static_cast<cudaStream_t>(stream)};
  return launch(a, dtype, true);
}

// int8 single-token decode (replaces _decode_kernel_int8).
int stretto_decode_attention_int8(
    const void* q, const void* k, const void* v, const float* ksc,
    const float* vsc, const int* lens, void* out, float* pm, float* pl,
    float* pacc, int B, int KV, int G, int dk, int dv, int S, int window,
    float scale, int dtype, void* stream) {
  const Args a{q, k, v, ksc, vsc, lens, out, pm, pl, pacc, B, 1, KV, G, dk,
               dv, S, window, scale, static_cast<cudaStream_t>(stream)};
  return launch(a, dtype, true);
}

}  // extern "C"
