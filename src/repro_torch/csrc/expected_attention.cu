// Expected-Attention compression scores, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/expected_attention.py
// (expected_attention_scores -> _ea_kernel). For every cached position s of
// item b under KV head h:
//   score[b, s, h] = mean_g[ (k . mu_g) / sqrt(dk) + 0.5 (k*k) . sig2_g / dk ]
// with mu, sig2 the (KV, G, dk) Gaussian statistics of the future queries.
//
// Layouts (row-major, contiguous):
//   k     (B, S, KV, dk)  float32 or bfloat16
//   mu    (KV, G, dk)     float32
//   sig2  (KV, G, dk)     float32
//   out   (B, S, KV)      float32
//
// What bounds it on the H100: bytes. Each K element is read once and feeds
// 4*G flops (two FMAs per g); at the 8B shapes (G = 4, bfloat16) that is 8
// flops per byte, far below the card's ratio of flops to bandwidth. The
// statistics are tiny (2*G*dk floats per head) and the output is one float
// per K row. A (1, 1024, 8, 128) bfloat16 call moves about 2.1 MB: under
// a microsecond at 3.35 TB/s, so at that size the launch costs more than
// the work.
//
// What the design does about it: grid.y walks the KV heads and stages that
// head's mu and sig2 (4 KB at 8B) in shared memory once per CTA; a group of
// W threads scores one K row, reading it with 16-byte vector loads, and
// reduces the partial dots with shuffles. The TPU kernel runs the two dot
// products as (bs, dk) x (dk, G) matrix products on the MXU; with G <= 8
// that is far too narrow for a tensor-core tile, so FMAs do it here. Odd
// head dims fall back to scalar loads bounded by dk.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int MAX_G = 8;      // query heads per pass held in registers

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* __restrict__ p, float* out) {
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

__host__ __device__ inline int pow2_at_least(int n, int cap) {
  int w = 1;
  while (w < n && w < cap) w <<= 1;
  return w;
}

// grid (ceil(BS / rows_per_cta), KV); W threads per K row.
template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
ea_kernel(const T* __restrict__ k, const float* __restrict__ mu,
          const float* __restrict__ sig2, float* __restrict__ out, int BS,
          int KV, int G, int dk, float scale) {
  extern __shared__ float smem[];
  const int kv = blockIdx.y;
  const int tid = threadIdx.x;
  float* smu = smem;             // [G][dk]
  float* ssg = smem + G * dk;    // [G][dk]
  const float* mu_h = mu + (long)kv * G * dk;
  const float* sg_h = sig2 + (long)kv * G * dk;
  for (int i = tid; i < G * dk; i += THREADS) {
    smu[i] = mu_h[i];
    ssg[i] = sg_h[i];
  }
  __syncthreads();

  const int nvec = dk / VEC;
  const int W = pow2_at_least(nvec, 32);
  const int rows_per_cta = THREADS / W;
  const int grp = tid / W, lane = tid - grp * W;
  const int row = blockIdx.x * rows_per_cta + grp;   // index into B*S
  const bool valid = row < BS;
  const T* krow = k + ((long)row * KV + kv) * dk;
  const float half_sq = 0.5f * scale * scale;

  float total = 0.f;
  for (int g0 = 0; g0 < G; g0 += MAX_G) {
    float lin[MAX_G], quad[MAX_G];
#pragma unroll
    for (int gg = 0; gg < MAX_G; ++gg) { lin[gg] = 0.f; quad[gg] = 0.f; }
    if (valid) {
      for (int vi = lane; vi < nvec; vi += W) {
        float kf[VEC];
        load_vec<T, VEC>(krow + vi * VEC, kf);
#pragma unroll
        for (int gg = 0; gg < MAX_G; ++gg) {
          if (g0 + gg < G) {
            const float* m = smu + (g0 + gg) * dk + vi * VEC;
            const float* s = ssg + (g0 + gg) * dk + vi * VEC;
#pragma unroll
            for (int e = 0; e < VEC; ++e) {
              lin[gg] = fmaf(kf[e], m[e], lin[gg]);
              quad[gg] = fmaf(kf[e] * kf[e], s[e], quad[gg]);
            }
          }
        }
      }
    }
    // all lanes of the warp take part (invalid rows add zeros)
#pragma unroll
    for (int gg = 0; gg < MAX_G; ++gg) {
      if (g0 + gg < G) {                // uniform across the block
        for (int off = W >> 1; off > 0; off >>= 1) {
          lin[gg] += __shfl_xor_sync(0xffffffffu, lin[gg], off);
          quad[gg] += __shfl_xor_sync(0xffffffffu, quad[gg], off);
        }
      }
    }
    for (int gg = 0; gg < MAX_G && g0 + gg < G; ++gg)
      total += lin[gg] * scale + quad[gg] * half_sq;
  }
  if (valid && lane == 0) out[(long)row * KV + kv] = total / (float)G;
}

template <typename T, int VEC>
cudaError_t launch_typed(const void* k, const float* mu, const float* sig2,
                         float* out, int BS, int KV, int G, int dk,
                         float scale, cudaStream_t stream) {
  const int W = pow2_at_least(dk / VEC, 32);
  const int rows_per_cta = THREADS / W;
  const size_t smem = sizeof(float) * 2 * (size_t)G * dk;
  auto kern = ea_kernel<T, VEC>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid((BS + rows_per_cta - 1) / rows_per_cta, KV);
  kern<<<grid, THREADS, smem, stream>>>(static_cast<const T*>(k), mu, sig2, out,
                                        BS, KV, G, dk, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_any(const void* k, const float* mu, const float* sig2,
                       float* out, int BS, int KV, int G, int dk,
                       float scale, cudaStream_t stream) {
  constexpr int VEC = 16 / (int)sizeof(T);
  if (dk % VEC == 0 && reinterpret_cast<uintptr_t>(k) % 16 == 0)
    return launch_typed<T, VEC>(k, mu, sig2, out, BS, KV, G, dk, scale, stream);
  return launch_typed<T, 1>(k, mu, sig2, out, BS, KV, G, dk, scale, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (the type of k).
int stretto_expected_attention_scores(const void* k, const float* mu,
                                      const float* sig2, float* out, int BS,
                                      int KV, int G, int dk, float scale,
                                      int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0)
    e = launch_any<float>(k, mu, sig2, out, BS, KV, G, dk, scale, st);
  else if (dtype == 1)
    e = launch_any<__nv_bfloat16>(k, mu, sig2, out, BS, KV, G, dk, scale, st);
  else
    e = cudaErrorInvalidValue;
  return (int)e;
}

}  // extern "C"
