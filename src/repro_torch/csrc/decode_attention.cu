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
//     (item, position, KV head), the reference's dequantisation int8 * scale.
// One body (namespace body) serves all four entry points, over float32 /
// bfloat16 K/V or int8 K/V; each entry keeps its own C symbol so the Python
// wrappers count their launches apart.
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
// included (dequantised for int8): the Pallas kernels mask with a finite
// -1e30, so such a row's softmax is uniform over every position, and this
// kernel returns the same.
//
// What bounds it on the H100: bytes. Every query row of a KV head reads the
// whole visible K/V of that head once, and there are only R = Lq*G rows (4
// at stretto-llama-8b with Lq = 1, 1 on the planted models), far too few
// rows to fill a wgmma tile (M = 64). At the 8B shapes (B 14, S 1152 after
// padding, KV 8, dk = dv = 128) one layer call reads up to 66 MB of bf16 K
// and V (about 20 us at 3.35 TB/s), or half that as int8 plus 8 bytes of
// scales per (position, head). The arithmetic, 4 FMAs per K or V element at
// 8B, is far below the card's rate, so the body has to keep enough loads in
// flight and spend few instructions per element.
//
// The body, and what it does about that:
//  * Split-S ("FlashDecoding"): one CTA of 8 warps per (split, kv head,
//    item) over SPLIT = 128 cache positions, 16 per warp. The split size
//    is a constant, so the splits depend on S alone. An 8B layer call runs
//    9 x 8 x 14 CTAs, about half of them live, 3 resident per SM.
//  * A CTA handles all R query rows of its KV head, so each K/V byte is
//    read from device memory once for all of them.
//  * Loads issued up front, q's first: each warp copies its own 16 K rows
//    (and, for int8, their 16 scales), then its 16 V rows (and scales),
//    into shared memory with cp.async (two commit groups); Q.K starts when
//    K lands, while V is still in flight, and only warp-level syncs guard
//    the copies. Positions outside the item's visible span are zero-filled,
//    never read. A row's stride is an odd number of 16-byte chunks, so the
//    8 rows an ldmatrix (or a quarter-warp) reads sit in distinct banks.
//  * bfloat16 q on the tensor cores, mma.sync m16n8k16 with the R rows
//    padded to 8 or 16 (raw bf16 q; the scores, exact products summed in
//    float32, are scaled afterwards). The softmax over the warp's 16
//    positions stays in the accumulator fragments (two shuffles per row
//    statistic). P goes to P.V as a bf16 high part and a bf16 low part
//    (about 16 bits of P): a single bf16 P moved an 8B logit past the card
//    test's bound for kernel D.
//     - bfloat16 K/V (dk, dv multiples of 16 up to 128): K and V fragments
//       by ldmatrix.
//     - int8 K/V (dk 64 or 128, dv a multiple of 32 up to 128): ldmatrix
//       takes 16-bit elements, so a lane reads its int8 words itself and
//       widens them in registers (int8 -> bf16 is exact: xor 0x80 and a
//       float magic number give the integer, whose bf16 is the top half of
//       its float). For Q.K^T a lane owns a quarter of each K row, bytes
//       [t dk/4, (t+1) dk/4), and the k index of the product is permuted
//       to match (q's fragments are read the same way; the sum over d is
//       the same sum). For P.V a lane reads, at 4 positions, the 4-byte
//       word at column 32 J + 4 g, which holds its column of 4 n-tiles; the
//       8 outputs it gets per row are 8 consecutive columns. The K scale
//       multiplies the float32 score after the product; the V scale is
//       folded into P (after l is summed) before P is split: both are the
//       reference's int8 * scale with float32 sums.
//  * Everything else (float32 q, the planted models; odd head dims):
//    float32 FMAs. Lane (position ps = lane % 16, half = lane / 16) dots its
//    half of the K row with every row of q (pre-scaled), one shuffle adds
//    the halves, int8 multiplies by the K scale, and the softmax over the
//    16 positions runs in registers; for P.V each half-warp takes 8
//    positions and a lane 16 bytes (int8: 4) of every V row, P broadcast by
//    shuffle (int8: times the V scale).
//  * The 8 warps' (m, l, acc) merge in warp order (factors exp(m_w - M)
//    computed once per row) into the split's partial; each warp's acc sits
//    in its own K rows when one row tile covers R and fits. One launch: each
//    (item, kv head) has an arrival counter in a scratch int buffer the
//    wrapper keeps per stream; one thread fences the CTA's partial and
//    counts its arrival, and the CTA that arrives last merges the live
//    splits in split order (weights and denominators once per (split, row)
//    in shared memory) and resets the counter to 0, so the result does not
//    depend on which CTA merges. An item with one live split writes its
//    output directly (the value the merge would give).
//  * Only live splits run: a split outside every row's visible span exits
//    at once and is not counted, so a padded or windowed batch streams
//    only the bytes it needs.
//  * Determinism: a position always falls into the same split and the same
//    warp; every sum runs in an order fixed by the position, and splits
//    that an item cannot see are never merged. An item's output therefore
//    does not depend on the batch it rides in or on how far the batch is
//    padded.
//  * What holds it back now (PERF.md): after its loads land, a CTA still
//    spends several microseconds on its products, the warp merge, and the
//    fence and arrival, during which its slot loads nothing.
//  * Head dims that 16-byte vectors do not split evenly take element-wise
//    loads; dk, dv <= 256.
//
// The window arrives as an int clamped to 2^30 by the wrapper (the JAX
// wrapper's int32 window overflows beyond that).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>
#include <algorithm>
#include <type_traits>

namespace {

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
template <>
__device__ __forceinline__ int8_t from_f<int8_t>(float x) {
  return (int8_t)x;
}

// VEC consecutive elements at p, as floats. VEC > 1 needs p aligned to
// VEC * sizeof(T) bytes, which is 16 (float, bfloat16) or 4 (int8).
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
    static_assert(VEC == 4, "int8 vectors hold 4 elements");
    const char4 u = *reinterpret_cast<const char4*>(p);
    out[0] = u.x; out[1] = u.y; out[2] = u.z; out[3] = u.w;
  }
}

// ===========================================================================
// the decode body
// ===========================================================================
namespace body {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int SUB = 16;               // cache positions per warp
constexpr int SPLIT = WARPS * SUB;    // cache positions per CTA (one split)
constexpr unsigned FULL = 0xffffffffu;
constexpr size_t SMEM_MAX = 232448;   // an H100 block's shared memory

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The cache positions some query row of an item can see: [lo, hi], empty
// when lo > hi. Row i (q_pos = length - Lq + i) sees (q_pos - window, q_pos].
struct Span {
  int lo, hi;
};
__device__ __forceinline__ Span visible(int length, int Lq, int S,
                                        int window) {
  Span s;
  s.hi = min(length - 1, S - 1);
  s.lo = window < 1 ? s.hi + 1 : max(0, length - Lq - window + 1);
  return s;
}

// Rows p_first .. p_first + SUB - 1 of one (item, KV head) into dst (row
// stride `stride` elements); row p lives at src[(row0 + p * KV) * width].
// Rows outside [lo, hi] are zero-filled and not read. VEC > 1: 16-byte
// cp.async (one commit group per call, issued by the caller); VEC == 1:
// element-wise loads.
template <typename T, int VEC>
__device__ __forceinline__ void stage_rows(T* dst, const T* __restrict__ src,
                                           long row0, int KV, int p_first,
                                           Span vis, int width, int stride,
                                           int lane) {
  if constexpr (VEC > 1) {
    // chunk i = lane + 32 n is (row r, vector c); step (r, c) without a
    // division per chunk
    const int nc = width / VEC;
    const int dr = 32 / nc, dc = 32 - dr * nc;
    int r = lane / nc, c = lane - r * nc;
    for (; r < SUB; r += dr) {
      const int p = p_first + r;
      const bool ok = p >= vis.lo && p <= vis.hi;
      const T* g = ok ? src + (row0 + (long)p * KV) * width + c * VEC : src;
      cp_async16(dst + r * stride + c * VEC, g, ok ? 16 : 0);
      c += dc;
      if (c >= nc) {
        c -= nc;
        ++r;
      }
    }
  } else {
    for (int i = lane; i < SUB * width; i += 32) {
      const int r = i / width, c = i - r * width;
      const int p = p_first + r;
      dst[r * stride + c] = (p >= vis.lo && p <= vis.hi)
                                ? src[(row0 + (long)p * KV) * width + c]
                                : from_f<T>(0.f);
    }
  }
}

// The scales of positions p_first .. p_first + SUB - 1 (int8 only): lane
// `lane - first` (when in [0, SUB)) copies one, zero outside [lo, hi].
template <int VEC>
__device__ __forceinline__ void stage_scales(float* dst,
                                             const float* __restrict__ src,
                                             long row0, int KV, int p_first,
                                             Span vis, int lane, int first) {
  const int r = lane - first;
  if (r < 0 || r >= SUB) return;
  const int p = p_first + r;
  const bool ok = p >= vis.lo && p <= vis.hi;
  if constexpr (VEC > 1)
    cp_async4(dst + r, ok ? src + row0 + (long)p * KV : src, ok ? 4 : 0);
  else
    dst[r] = ok ? src[row0 + (long)p * KV] : 0.f;
}

// The mean of V over all S positions of (item b, KV head kv), column d,
// dequantised for int8: the value of a row that sees no position.
template <typename TKV>
__device__ float mean_v(const TKV* __restrict__ v,
                        const float* __restrict__ vsc, int b, int kv, int d,
                        int S, int KV, int dv) {
  float sum = 0.f;
  for (int p = 0; p < S; ++p) {
    const long row = ((long)b * S + p) * KV + kv;
    float x = to_f(v[row * dv + d]);
    if constexpr (std::is_same<TKV, int8_t>::value) x = x * vsc[row];
    sum += x;
  }
  return sum / (float)S;
}

template <typename T>
__device__ __forceinline__ void store_out(T* __restrict__ out, int b, int r,
                                          int kv, int d, int Lq, int KV,
                                          int G, int dv, float o) {
  const int qi = r / G, g = r - qi * G;
  out[(((long)(b * Lq + qi) * KV + kv) * G + g) * dv + d] = from_f<T>(o);
}

// ---- tensor-core helpers -------------------------------------------------
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}
// c += a (16 x 16, row-major) * b (16 x 8, column-major), bf16 in, f32 sum
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}
// x = bf16 high part + bf16 low part (about 16 bits of x): hi, lo packed
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x - __low2float(h), y - __high2float(h));
}
// Byte c of the int8 word w, as an exact float: u = w ^ 0x80808080 holds
// the bytes + 128; 2^23 + u_c is a float with u_c in its low mantissa bits.
__device__ __forceinline__ float i8_at(uint32_t u, int c) {
  return __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 + c)) -
         8388736.f;                                  // 2^23 + 128
}
// Two exact floats of integers below 2^8 in magnitude as a bf16 pair (lo
// in the low half): their bf16 is the top half of their float.
__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// The last CTA of (b, kv): the n_live splits' partials from `base` merged
// in split order, o = sum_s acc_s w_s / sum_s l_s w_s with w_s = exp(m_s -
// max m). m and l are copied to shared memory, where the weights and the
// denominators are computed once per (split, row); a thread then owns MV
// consecutive output columns of one row and reads the splits' acc from L2
// (other SMs wrote them), several in flight. smem holds 2 (n_live + 1) R
// floats.
template <typename TQ, typename TKV, int MV>
__device__ void merge_splits(TQ* __restrict__ out, const TKV* __restrict__ v,
                             const float* __restrict__ vsc,
                             const float* part_m, const float* part_l,
                             const float* part_acc, int n_live, int b, int kv,
                             int Lq, int KV, int G, int dv, int S, int R,
                             float* smem) {
  const int nm = n_live * R;
  float* w = smem;              // [n_live][R]: m, then the weights
  float* l = w + nm;            // [n_live][R]
  float* mx = l + nm;           // [R]
  float* den = mx + R;          // [R]; -1 for a row that sees nothing
  for (int i = threadIdx.x; i < nm; i += THREADS) {
    w[i] = __ldcg(part_m + i);
    l[i] = __ldcg(part_l + i);
  }
  __syncthreads();
  for (int r = threadIdx.x; r < R; r += THREADS) {
    float M = -INFINITY;
    for (int s = 0; s < n_live; ++s) M = fmaxf(M, w[s * R + r]);
    mx[r] = M;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nm; i += THREADS) {
    const float M = mx[i % R];
    w[i] = M == -INFINITY ? 0.f : expf(w[i] - M);
  }
  __syncthreads();
  for (int r = threadIdx.x; r < R; r += THREADS) {
    float d = 0.f;
    for (int s = 0; s < n_live; ++s) d += l[s * R + r] * w[s * R + r];
    den[r] = mx[r] == -INFINITY ? -1.f : d;
  }
  __syncthreads();
  const int per_row = dv / MV;
  for (int i = threadIdx.x; i < R * per_row; i += THREADS) {
    const int r = i / per_row, d0 = (i - r * per_row) * MV;
    float o[MV];
    if (den[r] >= 0.f) {
      float num[MV];
#pragma unroll
      for (int e = 0; e < MV; ++e) num[e] = 0.f;
#pragma unroll 8
      for (int s = 0; s < n_live; ++s) {
        const float ws = w[s * R + r];
        const float* pa = part_acc + ((long)s * R + r) * dv + d0;
        if constexpr (MV == 4) {
          const float4 x = __ldcg(reinterpret_cast<const float4*>(pa));
          num[0] += x.x * ws; num[1] += x.y * ws;
          num[2] += x.z * ws; num[3] += x.w * ws;
        } else {
          num[0] += __ldcg(pa) * ws;
        }
      }
#pragma unroll
      for (int e = 0; e < MV; ++e) o[e] = num[e] / den[r];
    } else {
#pragma unroll
      for (int e = 0; e < MV; ++e)
        o[e] = mean_v(v, vsc, b, kv, d0 + e, S, KV, dv);
    }
#pragma unroll
    for (int e = 0; e < MV; ++e)
      store_out(out, b, r, kv, d0 + e, Lq, KV, G, dv, o[e]);
  }
}

// One CTA: item b, KV head kv, cache positions [split * SPLIT, + SPLIT).
// Query rows go RT at a time. TKV = int8_t reads the scales ksc / vsc.
// VEC > 1: 16-byte cp.async staging (VEC elements of TKV), else element
// loads.
//  MMA (bfloat16 q): Q.K^T and P.V on mma.sync m16n8k16, RT = 8 or 16 rows
//    padded to 16; bfloat16 K and V fragments by ldmatrix, int8 ones read
//    and widened by each lane; P as a bf16 high and low part.
//  else (FMA): a lane of a half-warp holds E output columns of each row
//    (E / LV vectors of LV elements).
template <typename TQ, typename TKV, int VEC, int RT, int E, bool MMA>
__global__ void __launch_bounds__(THREADS)
split_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
             const TKV* __restrict__ v, const float* __restrict__ ksc,
             const float* __restrict__ vsc, const int* __restrict__ lens,
             TQ* __restrict__ out, float* __restrict__ part_m,
             float* __restrict__ part_l, float* __restrict__ part_acc,
             int* __restrict__ arrivals, int Lq, int KV, int G, int dk,
             int dv, int S, int window, float scale, int kst, int vst,
             int wacc_in_k) {
  constexpr bool QUANT = std::is_same<TKV, int8_t>::value;
  // elements per shared-memory load in the FMA path
  constexpr int LV = VEC == 1 ? 1 : (QUANT ? 4 : VEC);
  static_assert(E % LV == 0, "a lane holds whole vectors of V");
  static_assert(QUANT || std::is_same<TQ, TKV>::value,
                "q and float K/V share one type");
  static_assert(!MMA || (std::is_same<TQ, __nv_bfloat16>::value &&
                         (RT == 8 || RT == 16) && VEC > 1),
                "the tensor-core path takes bfloat16 q and 8 or 16 rows");
  constexpr int QPT = 8;          // q elements a thread loads up front
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int is_last;
  const int split = blockIdx.x, kv = blockIdx.y, b = blockIdx.z;
  const int n_split = gridDim.x;
  const int R = Lq * G;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int length = lens[b];
  const Span vis = visible(length, Lq, S, window);
  const int n_live = vis.lo > vis.hi ? 0 : vis.hi / SPLIT - vis.lo / SPLIT + 1;
  const int s_lo = n_live ? vis.lo / SPLIT : 0;
  const long bk = (long)b * KV + kv;

  if (n_live == 0 || split < s_lo || split >= s_lo + n_live) {
    if (n_live == 0 && split == 0) {   // no row of this item sees anything
      for (int i = tid; i < R * dv; i += THREADS) {
        const int r = i / dv, d = i - r * dv;
        store_out(out, b, r, kv, d, Lq, KV, G, dv,
                  mean_v(v, vsc, b, kv, d, S, KV, dv));
      }
    }
    return;
  }

  // shared memory: K and V rows; their scales (int8); q (scaled float32,
  // or raw bf16 for the tensor cores); each warp's (m, l) and its acc,
  // which sits in the warp's own K rows when one row tile covers R (K is
  // no longer read then); the merge factors
  TKV* ks = reinterpret_cast<TKV*>(smem_raw);               // [SPLIT][kst]
  TKV* vs = ks + SPLIT * kst;                               // [SPLIT][vst]
  float* kss = reinterpret_cast<float*>(vs + SPLIT * vst);  // [SPLIT] int8
  float* vss = kss + (QUANT ? SPLIT : 0);                   // [SPLIT] int8
  float* qs = vss + (QUANT ? SPLIT : 0);                    // [R][dk]
  TQ* qb = reinterpret_cast<TQ*>(qs);
  float* wm = qs + (MMA ? (R * dk + 1) / 2 : R * dk);       // [WARPS][R]
  float* wl = wm + WARPS * R;                               // [WARPS][R]
  float* cf = wl + WARPS * R;                               // [WARPS][R]
  float* cl = cf + WARPS * R;                               // [R]
  float* wacc_all = cl + ((R + 3) & ~3);                    // [WARPS][R][dv]
  auto wacc_of = [&](int w) {
    return wacc_in_k ? reinterpret_cast<float*>(ks + w * SUB * kst)
                     : wacc_all + w * R * dv;
  };
  float* wacc = wacc_of(warp);                              // [R][dv]

  // ---- loads first: q (the first QPT elements a thread stages, into
  // registers), then this warp's K rows, then its V rows ----------------
  auto q_at = [&](int i) {
    const int r = i / dk, d = i - r * dk;
    const int qi = r / G, g = r - qi * G;
    return q[(((long)(b * Lq + qi) * KV + kv) * G + g) * dk + d];
  };
  TQ q_reg[QPT];
#pragma unroll
  for (int j = 0; j < QPT; ++j) {
    const int i = tid + j * THREADS;
    q_reg[j] = i < R * dk ? q_at(i) : from_f<TQ>(0.f);
  }
  const int pw = split * SPLIT + warp * SUB;    // the warp's first position
  const bool warp_live = pw <= vis.hi && pw + SUB - 1 >= vis.lo;
  const long row0 = (long)b * S * KV + kv;      // row (b, 0, kv)
  if (warp_live) {
    stage_rows<TKV, VEC>(ks + warp * SUB * kst, k, row0, KV, pw, vis, dk, kst,
                         lane);
    if constexpr (QUANT)
      stage_scales<VEC>(kss + warp * SUB, ksc, row0, KV, pw, vis, lane, 0);
    cp_async_commit();
    stage_rows<TKV, VEC>(vs + warp * SUB * vst, v, row0, KV, pw, vis, dv, vst,
                         lane);
    if constexpr (QUANT)
      stage_scales<VEC>(vss + warp * SUB, vsc, row0, KV, pw, vis, lane, SUB);
    cp_async_commit();
  }
  auto put_q = [&](int i, TQ x) {
    if constexpr (MMA)
      qb[i] = x;
    else
      qs[i] = to_f(x) * scale;
  };
#pragma unroll
  for (int j = 0; j < QPT; ++j)
    if (tid + j * THREADS < R * dk) put_q(tid + j * THREADS, q_reg[j]);
  for (int i = tid + QPT * THREADS; i < R * dk; i += THREADS)
    put_q(i, q_at(i));
  __syncthreads();

  if (warp_live) {
    const int first_q = length - Lq;
    cp_async_wait<1>();                          // K landed
    __syncwarp();
    if constexpr (MMA) {
      // fragment coordinates: g = lane / 4 (row, and key / column within an
      // 8-wide tile), t = lane % 4; ldmatrix: matrix lane / 8, row lane % 8
      const int g = lane >> 2, t = lane & 3;
      const int mi = lane >> 3, mr = lane & 7;
      const int dk16 = dk >> 4, dv16 = dv >> 4;
      const TKV* kw = ks + warp * SUB * kst;
      const TKV* vw = vs + warp * SUB * vst;
      const uint32_t* q32 = reinterpret_cast<const uint32_t*>(qb);
      // int8: the positions of this lane's score fragments are 2t, 2t+1,
      // 8+2t, 9+2t; their K and V scales
      float ksl[4] = {1.f, 1.f, 1.f, 1.f}, vsl[4] = {1.f, 1.f, 1.f, 1.f};
      if constexpr (QUANT) {
        const float* kq = kss + warp * SUB + 2 * t;
        ksl[0] = kq[0]; ksl[1] = kq[1]; ksl[2] = kq[8]; ksl[3] = kq[9];
      }
      for (int r0 = 0; r0 < R; r0 += RT) {
        const int ra = r0 + g, rb = r0 + g + 8;  // this lane's two rows
        const bool va = ra < R, vb = RT == 16 && rb < R;
        // ---- S = Q K^T: 16 rows x 16 positions, dk / 16 steps ----
        float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
        if constexpr (QUANT) {
          // step kk takes d = t dk/4 + 4 kk + {0, 1 | 2, 3} as the k index
          // {2t, 2t+1 | 2t+8, 2t+9}, for q and K alike
          const int dq = dk >> 2;
          const int8_t* k0 = kw + g * kst + t * dq;        // position g
          const int8_t* k1 = k0 + 8 * kst;                 // position g + 8
#pragma unroll
          for (int k4 = 0; k4 < 2; ++k4) {
            if (k4 < dk16 / 4) {
              const uint4 w0 = *reinterpret_cast<const uint4*>(k0 + 16 * k4);
              const uint4 w1 = *reinterpret_cast<const uint4*>(k1 + 16 * k4);
              const uint32_t x0[4] = {w0.x, w0.y, w0.z, w0.w};
              const uint32_t x1[4] = {w1.x, w1.y, w1.z, w1.w};
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                const int c = t * dq + 16 * k4 + 4 * j;
                uint32_t a[4];
                const uint2 qa = va ? *reinterpret_cast<const uint2*>(
                                          q32 + ((ra * dk + c) >> 1))
                                    : make_uint2(0u, 0u);
                const uint2 qc = vb ? *reinterpret_cast<const uint2*>(
                                          q32 + ((rb * dk + c) >> 1))
                                    : make_uint2(0u, 0u);
                a[0] = qa.x; a[1] = qc.x; a[2] = qa.y; a[3] = qc.y;
                const uint32_t u0 = x0[j] ^ 0x80808080u;
                const uint32_t u1 = x1[j] ^ 0x80808080u;
                mma_bf16(sc[0], a, bf16_pair(i8_at(u0, 0), i8_at(u0, 1)),
                         bf16_pair(i8_at(u0, 2), i8_at(u0, 3)));
                mma_bf16(sc[1], a, bf16_pair(i8_at(u1, 0), i8_at(u1, 1)),
                         bf16_pair(i8_at(u1, 2), i8_at(u1, 3)));
              }
            }
          }
        } else {
#pragma unroll
          for (int kk = 0; kk < 8; ++kk) {
            if (kk < dk16) {
              uint32_t a[4], bb[4];
              const int c = (kk * 16 + 2 * t) >> 1;   // in bf16 pairs
              a[0] = va ? q32[(ra * dk >> 1) + c] : 0u;
              a[1] = vb ? q32[(rb * dk >> 1) + c] : 0u;
              a[2] = va ? q32[(ra * dk >> 1) + c + 4] : 0u;
              a[3] = vb ? q32[(rb * dk >> 1) + c + 4] : 0u;
              ldsm_x4(bb, kw + ((mi >> 1) * 8 + mr) * kst + kk * 16 +
                              (mi & 1) * 8);
              mma_bf16(sc[0], a, bb[0], bb[1]);
              mma_bf16(sc[1], a, bb[2], bb[3]);
            }
          }
        }
        __syncwarp();            // K read: its rows may take the acc now
        // ---- mask and softmax over the 16 positions, per row; the 4
        // lanes of a quad share a row ----
        float pr[2][4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {            // h = 0: row ra, 1: rb
          const int r = h ? rb : ra;
          const int q_pos = first_q + r / G;
          float x[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int p = pw + (e >> 1) * 8 + 2 * t + (e & 1);
            const bool live = (h ? vb : va) && p <= vis.hi && p <= q_pos &&
                              q_pos - p < window;
            const float s = sc[e >> 1][2 * h + (e & 1)];
            x[e] = live ? (QUANT ? s * ksl[e] * scale : s * scale)
                        : -INFINITY;
          }
          float m = fmaxf(fmaxf(x[0], x[1]), fmaxf(x[2], x[3]));
          m = fmaxf(m, __shfl_xor_sync(FULL, m, 1));
          m = fmaxf(m, __shfl_xor_sync(FULL, m, 2));
          float l = 0.f;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float ex = (m == -INFINITY) ? 0.f : expf(x[e] - m);
            pr[e >> 1][2 * h + (e & 1)] = ex;
            l += ex;
          }
          l += __shfl_xor_sync(FULL, l, 1);
          l += __shfl_xor_sync(FULL, l, 2);
          if (t == 0 && (h ? vb : va)) {
            wm[warp * R + r] = m;
            wl[warp * R + r] = l;
          }
        }
        if (r0 == 0) {
          cp_async_wait<0>();                      // V landed
          __syncwarp();
          if constexpr (QUANT) {
            const float* vq = vss + warp * SUB + 2 * t;
            vsl[0] = vq[0]; vsl[1] = vq[1]; vsl[2] = vq[8]; vsl[3] = vq[9];
          }
        }
        if constexpr (QUANT) {                     // P times the V scale
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            pr[e >> 1][e & 1] *= vsl[e];
            pr[e >> 1][2 + (e & 1)] *= vsl[e];
          }
        }
        // P as the A operand (k = the 16 positions), high and low parts
        uint32_t ph[4], plo[4];
        split_bf16(pr[0][0], pr[0][1], ph[0], plo[0]);
        split_bf16(pr[0][2], pr[0][3], ph[1], plo[1]);
        split_bf16(pr[1][0], pr[1][1], ph[2], plo[2]);
        split_bf16(pr[1][2], pr[1][3], ph[3], plo[3]);
        if constexpr (QUANT) {
          // ---- O = P V: per 32 columns J, the word at column 32 J + 4 g
          // of positions 2t, 2t+1, 8+2t, 9+2t holds n-tiles 4 J .. 4 J + 3
          const int8_t* v0 = vw + 2 * t * vst + 4 * g;
          for (int J = 0; J < (dv >> 5); ++J) {
            const uint32_t u0 = *reinterpret_cast<const uint32_t*>(
                                    v0 + 32 * J) ^ 0x80808080u;
            const uint32_t u1 = *reinterpret_cast<const uint32_t*>(
                                    v0 + vst + 32 * J) ^ 0x80808080u;
            const uint32_t u2 = *reinterpret_cast<const uint32_t*>(
                                    v0 + 8 * vst + 32 * J) ^ 0x80808080u;
            const uint32_t u3 = *reinterpret_cast<const uint32_t*>(
                                    v0 + 9 * vst + 32 * J) ^ 0x80808080u;
            float o[4][4];
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const uint32_t b0 = bf16_pair(i8_at(u0, c), i8_at(u1, c));
              const uint32_t b1 = bf16_pair(i8_at(u2, c), i8_at(u3, c));
              o[c][0] = o[c][1] = o[c][2] = o[c][3] = 0.f;
              mma_bf16(o[c], ph, b0, b1);
              mma_bf16(o[c], plo, b0, b1);
            }
            // n = 2t, 2t+1 of n-tile 4J + c: columns 32J + 8t + c, + 4
            const int col = 32 * J + 8 * t;
            if (va) {
              *reinterpret_cast<float4*>(wacc + ra * dv + col) =
                  make_float4(o[0][0], o[1][0], o[2][0], o[3][0]);
              *reinterpret_cast<float4*>(wacc + ra * dv + col + 4) =
                  make_float4(o[0][1], o[1][1], o[2][1], o[3][1]);
            }
            if (vb) {
              *reinterpret_cast<float4*>(wacc + rb * dv + col) =
                  make_float4(o[0][2], o[1][2], o[2][2], o[3][2]);
              *reinterpret_cast<float4*>(wacc + rb * dv + col + 4) =
                  make_float4(o[0][3], o[1][3], o[2][3], o[3][3]);
            }
          }
        } else {
          // ---- O = P V: 16 rows x dv, 16 columns per ldmatrix ----
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            if (j < dv16) {
              uint32_t bb[4];
              ldsm_x4_t(bb, vw + ((mi & 1) * 8 + mr) * vst + j * 16 +
                                (mi >> 1) * 8);
              float o[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
              mma_bf16(o[0], ph, bb[0], bb[1]);
              mma_bf16(o[0], plo, bb[0], bb[1]);
              mma_bf16(o[1], ph, bb[2], bb[3]);
              mma_bf16(o[1], plo, bb[2], bb[3]);
#pragma unroll
              for (int n = 0; n < 2; ++n) {
                const int c = j * 16 + n * 8 + 2 * t;
                if (va) {
                  wacc[ra * dv + c] = o[n][0];
                  wacc[ra * dv + c + 1] = o[n][1];
                }
                if (vb) {
                  wacc[rb * dv + c] = o[n][2];
                  wacc[rb * dv + c + 1] = o[n][3];
                }
              }
            }
          }
        }
      }
    } else {
      const int ps = lane & 15, hf = lane >> 4, j = lane & 15;
      const int p = pw + ps;                     // this lane's Q.K position
      const TKV* krow = ks + (warp * SUB + ps) * kst;
      for (int r0 = 0; r0 < R; r0 += RT) {
        const int nr = min(RT, R - r0);          // uniform across the warp
        // ---- Q.K over this lane's half of dk ----
        float s[RT];
#pragma unroll
        for (int rr = 0; rr < RT; ++rr) s[rr] = 0.f;
        if constexpr (LV > 1) {
          const int nh = dk / (2 * LV);          // vectors per half
          for (int c = hf * nh; c < (hf + 1) * nh; ++c) {
            float kf[LV];
            load_vec<TKV, LV>(krow + c * LV, kf);
#pragma unroll
            for (int rr = 0; rr < RT; ++rr) {
              if (RT == 1 || rr < nr) {
                const float4* q4 = reinterpret_cast<const float4*>(
                    qs + (r0 + rr) * dk + c * LV);
#pragma unroll
                for (int e4 = 0; e4 < LV / 4; ++e4) {
                  const float4 x = q4[e4];
                  s[rr] = fmaf(x.x, kf[4 * e4 + 0], s[rr]);
                  s[rr] = fmaf(x.y, kf[4 * e4 + 1], s[rr]);
                  s[rr] = fmaf(x.z, kf[4 * e4 + 2], s[rr]);
                  s[rr] = fmaf(x.w, kf[4 * e4 + 3], s[rr]);
                }
              }
            }
          }
        } else {
          const int dh = (dk + 1) / 2;
          for (int d = hf * dh; d < min(dk, (hf + 1) * dh); ++d) {
            const float kf = to_f(krow[d]);
#pragma unroll
            for (int rr = 0; rr < RT; ++rr)
              if (RT == 1 || rr < nr)
                s[rr] = fmaf(qs[(r0 + rr) * dk + d], kf, s[rr]);
          }
        }
        const float kscale = QUANT ? kss[warp * SUB + ps] : 1.f;
        // ---- the softmax over the warp's 16 positions, in registers ----
        float pr[RT];
#pragma unroll
        for (int rr = 0; rr < RT; ++rr) {
          pr[rr] = 0.f;
          if (RT == 1 || rr < nr) {
            s[rr] += __shfl_xor_sync(FULL, s[rr], 16);
            const int q_pos = first_q + (r0 + rr) / G;
            const bool live = p <= vis.hi && p <= q_pos && q_pos - p < window;
            const float x = live ? (QUANT ? s[rr] * kscale : s[rr])
                                 : -INFINITY;
            float m = x;
#pragma unroll
            for (int off = 8; off > 0; off >>= 1)
              m = fmaxf(m, __shfl_xor_sync(FULL, m, off));
            const float e = (m == -INFINITY) ? 0.f : expf(x - m);
            float l = e;
#pragma unroll
            for (int off = 8; off > 0; off >>= 1)
              l += __shfl_xor_sync(FULL, l, off);
            pr[rr] = e;
            if (lane == 0) {
              wm[warp * R + r0 + rr] = m;
              wl[warp * R + r0 + rr] = l;
            }
          }
        }
        if (r0 == 0) {
          cp_async_wait<0>();                    // V landed
        }
        __syncwarp();            // V landed; K read (its rows may take acc)
        // ---- P.V: half hf takes positions hf*8 .. hf*8+7 ----
        float acc[RT][E];
#pragma unroll
        for (int rr = 0; rr < RT; ++rr)
#pragma unroll
          for (int e = 0; e < E; ++e) acc[rr][e] = 0.f;
#pragma unroll 2
        for (int i = 0; i < SUB / 2; ++i) {
          const int src = hf * (SUB / 2) + i;
          const float vscale = QUANT ? vss[warp * SUB + src] : 1.f;
          float pv[RT];
#pragma unroll
          for (int rr = 0; rr < RT; ++rr) {
            pv[rr] = (RT == 1 || rr < nr) ? __shfl_sync(FULL, pr[rr], src)
                                          : 0.f;
            if constexpr (QUANT) pv[rr] *= vscale;
          }
          const TKV* vrow = vs + (warp * SUB + src) * vst;
#pragma unroll
          for (int tt = 0; tt < E / LV; ++tt) {
            const int c0 = (j + 16 * tt) * LV;
            if (c0 < dv) {
              float vf[LV];
              load_vec<TKV, LV>(vrow + c0, vf);
#pragma unroll
              for (int rr = 0; rr < RT; ++rr)
#pragma unroll
                for (int e = 0; e < LV; ++e)
                  acc[rr][tt * LV + e] =
                      fmaf(pv[rr], vf[e], acc[rr][tt * LV + e]);
            }
          }
        }
#pragma unroll
        for (int rr = 0; rr < RT; ++rr) {
          if (RT == 1 || rr < nr) {
#pragma unroll
            for (int e = 0; e < E; ++e)
              acc[rr][e] += __shfl_xor_sync(FULL, acc[rr][e], 16);
            if (hf == 0) {
              float* dst = wacc + (r0 + rr) * dv;
#pragma unroll
              for (int tt = 0; tt < E / LV; ++tt)
#pragma unroll
                for (int e = 0; e < LV; ++e) {
                  const int c = (j + 16 * tt) * LV + e;
                  if (c < dv) dst[c] = acc[rr][tt * LV + e];
                }
            }
          }
        }
      }
    }
  } else {
    for (int i = lane; i < R; i += 32) {
      wm[warp * R + i] = -INFINITY;
      wl[warp * R + i] = 0.f;
    }
    for (int i = lane; i < R * dv; i += 32) wacc[i] = 0.f;
  }
  __syncthreads();

  // ---- the split's partial: the warps merged in warp order ----------------
  // factors f_w = exp(m_w - M) per (warp, row), and l, once per row
  const long prow = (bk * n_split + split) * R;
  for (int r = tid; r < R; r += THREADS) {
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) M = fmaxf(M, wm[w * R + r]);
    float l = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float f = M == -INFINITY ? 0.f : expf(wm[w * R + r] - M);
      cf[w * R + r] = f;                           // 0 for an empty warp
      l += wl[w * R + r] * f;
    }
    cl[r] = l;
    if (n_live > 1) {
      part_m[prow + r] = M;
      part_l[prow + r] = l;
    } else {
      wm[r] = M;
    }
  }
  __syncthreads();
  for (int i = tid; i < R * dv; i += THREADS) {
    const int r = i / dv, d = i - r * dv;
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) a += wacc_of(w)[r * dv + d] * cf[w * R + r];
    if (n_live == 1) {
      // the merge of one split: num / den with weight exp(M - M) = 1
      store_out(out, b, r, kv, d, Lq, KV, G, dv,
                wm[r] != -INFINITY ? a / cl[r]
                                   : mean_v(v, vsc, b, kv, d, S, KV, dv));
    } else {
      part_acc[(prow + r) * dv + d] = a;
    }
  }
  if (n_live == 1) return;

  // ---- the last CTA of (b, kv) to arrive merges the splits in order: one
  // thread fences the CTA's partial (the barrier orders the others' writes
  // before it) and counts the arrival ----
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    const int prev = atomicAdd(arrivals + bk, 1);
    is_last = prev == n_live - 1;
    if (is_last) {
      arrivals[bk] = 0;                  // ready for the next launch
      __threadfence();
    }
  }
  __syncthreads();
  if (!is_last) return;
  const long base = (bk * n_split + s_lo) * R;
  if (dv % 4 == 0)
    merge_splits<TQ, TKV, 4>(out, v, vsc, part_m + base, part_l + base,
                             part_acc + base * dv, n_live, b, kv, Lq, KV, G,
                             dv, S, R, reinterpret_cast<float*>(smem_raw));
  else
    merge_splits<TQ, TKV, 1>(out, v, vsc, part_m + base, part_l + base,
                             part_acc + base * dv, n_live, b, kv, Lq, KV, G,
                             dv, S, R, reinterpret_cast<float*>(smem_raw));
}

struct Args {
  const void* q; const void* k; const void* v; const float* ksc;
  const float* vsc; const int* lens; void* out;
  float* pm; float* pl; float* pacc; int* arrivals;
  int B, Lq, KV, G, dk, dv, S, window; float scale;
  cudaStream_t stream;
};

// Row stride in elements: an odd number of 16-byte chunks (VEC > 1), so
// the 8 rows a quarter-warp (or an ldmatrix) reads fall in distinct banks;
// else the width.
template <int VEC>
int row_stride(int width) {
  if (VEC == 1) return width;
  const int chunks = width / VEC;
  return (chunks | 1) * VEC;
}

template <typename TQ, typename TKV, int VEC, int RT, int E, bool MMA>
cudaError_t launch_typed(const Args& a) {
  constexpr bool QUANT = std::is_same<TKV, int8_t>::value;
  const int n_split = (a.S + SPLIT - 1) / SPLIT;
  const int kst = row_stride<VEC>(a.dk), vst = row_stride<VEC>(a.dv);
  const size_t R = (size_t)a.Lq * a.G;
  const size_t n_split_max = n_split;
  // each warp's acc in its own K rows when one row tile covers R
  const int in_k = R <= (size_t)RT &&
                   R * a.dv * sizeof(float) <= SUB * kst * sizeof(TKV);
  const size_t q_floats = MMA ? (R * a.dk + 1) / 2 : R * a.dk;
  size_t smem = sizeof(TKV) * SPLIT * (size_t)(kst + vst) +
                sizeof(float) * ((QUANT ? 2 * SPLIT : 0) + q_floats +
                                 3 * WARPS * R + ((R + 3) & ~(size_t)3) +
                                 (in_k ? 0 : WARPS * R * a.dv));
  // the final merge's m, l and denominators reuse the same memory
  smem = std::max(smem, sizeof(float) * 2 * (n_split_max + 1) * R);
  if (smem > SMEM_MAX) return cudaErrorInvalidValue;
  auto kern = split_kernel<TQ, TKV, VEC, RT, E, MMA>;
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
      static_cast<const TKV*>(a.v), a.ksc, a.vsc, a.lens,
      static_cast<TQ*>(a.out), a.pm, a.pl, a.pacc, a.arrivals, a.Lq, a.KV,
      a.G, a.dk, a.dv, a.S, a.window, a.scale, kst, vst, in_k);
  return cudaGetLastError();
}

template <typename TQ, typename TKV, int VEC>
cudaError_t launch_rows(const Args& a) {
  const bool wide = a.dv > 128;
  if (a.Lq * a.G == 1)
    return wide ? launch_typed<TQ, TKV, VEC, 1, 16, false>(a)
                : launch_typed<TQ, TKV, VEC, 1, 8, false>(a);
  return wide ? launch_typed<TQ, TKV, VEC, 4, 16, false>(a)
              : launch_typed<TQ, TKV, VEC, 4, 8, false>(a);
}

template <typename TQ, typename TKV>
cudaError_t launch_any(const Args& a) {
  constexpr bool QUANT = std::is_same<TKV, int8_t>::value;
  if (a.dk < 1 || a.dv < 1 || a.dk > 256 || a.dv > 256 || a.S < 1)
    return cudaErrorInvalidValue;
  constexpr int VEC = 16 / (int)sizeof(TKV);
  constexpr int LV = QUANT ? 4 : VEC;      // the FMA path's loads
  const bool aligned = reinterpret_cast<uintptr_t>(a.k) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(a.v) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(a.q) % 4 == 0;
  if constexpr (std::is_same<TQ, __nv_bfloat16>::value) {
    const bool tc = QUANT ? (a.dk == 64 || a.dk == 128) && a.dv % 32 == 0 &&
                                a.dv <= 128
                          : a.dk % 16 == 0 && a.dv % 16 == 0 &&
                                a.dk <= 128 && a.dv <= 128;
    if (aligned && tc)
      return a.Lq * a.G <= 8 ? launch_typed<TQ, TKV, VEC, 8, VEC, true>(a)
                             : launch_typed<TQ, TKV, VEC, 16, VEC, true>(a);
  }
  if (aligned && a.dk % VEC == 0 && a.dv % VEC == 0 && a.dk % (2 * LV) == 0 &&
      a.dv % LV == 0)
    return launch_rows<TQ, TKV, VEC>(a);
  return launch_rows<TQ, TKV, 1>(a);
}

// dtype: 0 = float32, 1 = bfloat16 (q and out; K and V too unless int8)
template <bool QUANT>
int launch(const Args& a, int dtype) {
  cudaError_t e;
  if (dtype == 0)
    e = launch_any<float, std::conditional_t<QUANT, int8_t, float>>(a);
  else if (dtype == 1)
    e = launch_any<__nv_bfloat16,
                   std::conditional_t<QUANT, int8_t, __nv_bfloat16>>(a);
  else
    e = cudaErrorInvalidValue;
  return (int)e;
}

}  // namespace body

}  // namespace

extern "C" {

// pm, pl, pacc: (B, KV, n_split, Lq*G[, dv]) float32 partials; arrivals:
// B*KV ints, zero before the launch and zero again after it.

// Fused Lq-token query decode (replaces decode_query_attention).
int stretto_decode_query_attention(const void* q, const void* k, const void* v,
                                   const int* lens, void* out, float* pm,
                                   float* pl, float* pacc, int* arrivals,
                                   int B, int Lq, int KV, int G, int dk,
                                   int dv, int S, int window, float scale,
                                   int dtype, void* stream) {
  const body::Args a{q, k, v, nullptr, nullptr, lens, out, pm, pl, pacc,
                     arrivals, B, Lq, KV, G, dk, dv, S, window, scale,
                     static_cast<cudaStream_t>(stream)};
  return body::launch<false>(a, dtype);
}

// Single-token decode (replaces decode_attention): the same kernel at Lq=1.
int stretto_decode_attention(const void* q, const void* k, const void* v,
                             const int* lens, void* out, float* pm, float* pl,
                             float* pacc, int* arrivals, int B, int KV, int G,
                             int dk, int dv, int S, int window, float scale,
                             int dtype, void* stream) {
  const body::Args a{q, k, v, nullptr, nullptr, lens, out, pm, pl, pacc,
                     arrivals, B, 1, KV, G, dk, dv, S, window, scale,
                     static_cast<cudaStream_t>(stream)};
  return body::launch<false>(a, dtype);
}

// int8 K/V with (B, S, KV) float32 scales (replaces _query_kernel_int8).
int stretto_decode_query_attention_int8(
    const void* q, const void* k, const void* v, const float* ksc,
    const float* vsc, const int* lens, void* out, float* pm, float* pl,
    float* pacc, int* arrivals, int B, int Lq, int KV, int G, int dk, int dv,
    int S, int window, float scale, int dtype, void* stream) {
  const body::Args a{q, k, v, ksc, vsc, lens, out, pm, pl, pacc, arrivals,
                     B, Lq, KV, G, dk, dv, S, window, scale,
                     static_cast<cudaStream_t>(stream)};
  return body::launch<true>(a, dtype);
}

// int8 single-token decode (replaces _decode_kernel_int8): Lq = 1.
int stretto_decode_attention_int8(
    const void* q, const void* k, const void* v, const float* ksc,
    const float* vsc, const int* lens, void* out, float* pm, float* pl,
    float* pacc, int* arrivals, int B, int KV, int G, int dk, int dv, int S,
    int window, float scale, int dtype, void* stream) {
  const body::Args a{q, k, v, ksc, vsc, lens, out, pm, pl, pacc, arrivals,
                     B, 1, KV, G, dk, dv, S, window, scale,
                     static_cast<cudaStream_t>(stream)};
  return body::launch<true>(a, dtype);
}

}  // extern "C"
