// Beta credible bounds of the planner (kernel E), for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package's `repro/core/bounds.py`
// (betaincinv by bisection on jax.scipy.special.betainc, whose continued
// fraction is a while-loop) is compiled by XLA into fused loops inside the
// optimizer's jit(vmap(scan)). This is the port's counterpart of that
// compiled code, so that one Adam step of `core/optimizer.py` can run as
// one CUDA graph with no host sync.
//
// Two entries, one thread per element (or per term):
//   stretto_beta_incinv      x = betaincinv(a, b, q): 60 bisection steps,
//                            each scoring betainc(a, b, mid) by the
//                            modified Lentz continued fraction (at most
//                            199 terms); each element leaves both loops at
//                            its own convergence
//   stretto_beta_incinv_grad the backward's terms at x (clamped to
//                            [1e-12, 1]): fd = betainc at (a + ha, b),
//                            (a - ha, b), (a, b + hb), (a, b - hb) with
//                            ha = 1e-4 max(a, 1), hb = 1e-4 max(b, 1),
//                            and the Beta pdf at x floored at 1e-30
// Layouts: a, b, q, x, pdf (n,) float32 contiguous; fd (4, n) float32.
//
// The arithmetic is the plain version's (kernels/ref.py: betainc, the
// Lanczos log-gamma, the continued fraction, the sequential bisection)
// operation by operation, in float32 with the same rounding points: this
// file is compiled with -fmad=false (no contraction of a product into a
// sum) and IEEE division; where PyTorch computes `c / t` as reciprocal(t)
// * c, so does this file. log B(a, b) for the pdf is taken in double, as
// the plain version does. What can still differ from the host: expf,
// logf, log1pf and lgamma differ from the CPU's by an ulp at times.
//
// What bounds it on the H100: latency. The planner asks for K restarts x 2
// bounds (6-40 elements) per step; each element is a serial chain of up to
// 60 x 199 continued-fraction iterations, each a dozen dependent float32
// operations with two divisions. Bytes (16 per element) and flops are
// negligible; the time is one thread's chain, so the design keeps each
// chain short (per-element exits, no shared state) and puts every element,
// and each of the backward's four terms, on a thread of its own.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int CF_ITERS = 200;   // XLA's cap for float32 (terms 1..199)
constexpr int BISECT = 60;

// float32 of the plain version's Python constants (decimal -> double ->
// float, as PyTorch converts a Python float)
__device__ __forceinline__ float f32(double v) { return static_cast<float>(v); }

#define EPS_F f32(5.9604644775390625e-08)        // finfo(float32).eps / 2
#define TINY_F f32(2.350988701644575e-38)        // finfo(float32).tiny * 2

__device__ float lanczos_c(int i) {
  switch (i) {
    case 0: return f32(676.520368121885098567009190444019);
    case 1: return f32(-1259.13921672240287047156078755283);
    case 2: return f32(771.3234287776530788486528258894);
    case 3: return f32(-176.61502916214059906584551354);
    case 4: return f32(12.507343278686904814458936853);
    case 5: return f32(-0.13857109526572011689554707);
    case 6: return f32(9.984369578019570859563e-6);
    default: return f32(1.50563273514931155834e-7);
  }
}

// log Gamma(x), XLA's Lanczos recipe (g = 7, n = 9) for x >= 0.5
__device__ float lgamma_lanczos(float x) {
  if (!(x >= 0.5f)) return lgammaf(x);
  const float z = x - 1.0f;
  float s = f32(0.99999999999980993227684700473478);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float den = (z + static_cast<float>(i)) + 1.0f;
    s = s + (1.0f / den) * lanczos_c(i);       // c / den = recip(den) * c
  }
  const float t = z + 7.5f;
  const float log_t = log1pf(z / 7.5f) + f32(2.0149030205422647);
  const float body = ((z + 0.5f) - t / log_t) * log_t;
  return (body + f32(0.9189385332046727)) + logf(s);
}

// modified Lentz continued fraction of I(x; a, b), own exit
__device__ float cont_frac(float a, float b, float x) {
  const float one = 1.0f, small = EPS_F;
  float h = small, c = small, d = 0.0f;
  for (int it = 1; it < CF_ITERS; ++it) {
    float num;
    if (it == 1) {
      num = one;
    } else {
      const float m = static_cast<float>((it - 1) / 2);
      const float a2m = a + 2.0f * m;
      if ((it & 1) == 0) {
        if (m == 0.0f)
          num = (-(a + b) * x) / (a + one);
        else
          num = ((-(a + m) * ((a + b) + m)) * x) / (a2m * (a2m + one));
      } else {
        num = (((b - m) * m) * x) / ((a2m - one) * a2m);
      }
    }
    float c_new = one + num / c;
    if (fabsf(c_new) < small) c_new = small;
    float d_new = one + num * d;
    if (fabsf(d_new) < small) d_new = small;
    d_new = 1.0f / d_new;
    const float delta = c_new * d_new;
    h = h * delta;
    c = c_new;
    d = d_new;
    if (!(fabsf(delta - 1.0f) >= EPS_F)) break;
  }
  return h;
}

// regularized incomplete beta I(x; a, b), float32
__device__ float betainc_f(float a, float b, float x) {
  const bool rapid = x < (a + 1.0f) / ((a + b) + 2.0f);
  const float a2 = rapid ? a : b;
  const float b2 = rapid ? b : a;
  const float x2 = rapid ? x : 1.0f - x;
  const float cf = cont_frac(a2, b2, x2);
  const float lbeta_small_a = lgamma_lanczos(b2) - lgamma_lanczos(a2 + b2);
  const float lbeta = lgamma_lanczos(a2) + lbeta_small_a;
  float factor;
  if (a2 < TINY_F)
    factor = expf(log1pf(-x2) * b2 - lbeta_small_a);
  else
    factor = expf((logf(x2) * a2 + log1pf(-x2) * b2) - lbeta) / a2;
  const float out = cf * factor;
  return rapid ? out : 1.0f - out;
}

__global__ void __launch_bounds__(THREADS)
beta_incinv_kernel(const float* __restrict__ a, const float* __restrict__ b,
                   const float* __restrict__ q, float* __restrict__ x,
                   long long n) {
  const long long i = static_cast<long long>(blockIdx.x) * THREADS
                      + threadIdx.x;
  if (i >= n) return;
  const float ai = a[i], bi = b[i], qi = q[i];
  float lo = 0.0f, hi = 1.0f;
  for (int s = 0; s < BISECT; ++s) {
    const float mid = (lo + hi) * 0.5f;
    // lo only holds points below q and hi points at or above it, so once
    // the midpoint is one of them the remaining steps change nothing
    if (mid == lo || mid == hi) break;
    if (betainc_f(ai, bi, mid) < qi) lo = mid; else hi = mid;
  }
  x[i] = (lo + hi) * 0.5f;
}

// torch.clamp's order and NaN propagation: max(x, lo), then min(., hi)
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x < lo ? lo : x;
}
__device__ __forceinline__ float clamp_max(float x, float hi) {
  return x > hi ? hi : x;
}

// thread i < 4n computes term i / n of element i % n; threads below n also
// the pdf
__global__ void __launch_bounds__(THREADS)
beta_incinv_grad_kernel(const float* __restrict__ a,
                        const float* __restrict__ b,
                        const float* __restrict__ x, float* __restrict__ fd,
                        float* __restrict__ pdf, long long n) {
  const long long i = static_cast<long long>(blockIdx.x) * THREADS
                      + threadIdx.x;
  if (i >= 4 * n) return;
  const int term = static_cast<int>(i / n);
  const long long e = i - term * n;
  const float ai = a[e], bi = b[e];
  const float xi = clamp_max(clamp_min(x[e], f32(1e-12)), f32(1.0 - 1e-12));
  if (term == 0) {
    const double a64 = ai, b64 = bi;
    const float lbeta = static_cast<float>(
        (lgamma(a64) + lgamma(b64)) - lgamma(a64 + b64));
    const float logpdf = ((ai - 1.0f) * logf(xi)
                          + (bi - 1.0f) * log1pf(-xi)) - lbeta;
    pdf[e] = clamp_min(expf(logpdf), f32(1e-30));
  }
  const float ha = clamp_min(ai, 1.0f) * f32(1e-4);
  const float hb = clamp_min(bi, 1.0f) * f32(1e-4);
  float ta = ai, tb = bi;
  switch (term) {
    case 0: ta = ai + ha; break;
    case 1: ta = ai - ha; break;
    case 2: tb = bi + hb; break;
    default: tb = bi - hb; break;
  }
  fd[i] = betainc_f(ta, tb, xi);
}

inline unsigned blocks(long long work) {
  return static_cast<unsigned>((work + THREADS - 1) / THREADS);
}

}  // namespace

extern "C" {

int stretto_beta_incinv(const float* a, const float* b, const float* q,
                        float* x, long long n, void* stream) {
  if (n > 0)
    beta_incinv_kernel<<<blocks(n), THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(a, b, q, x, n);
  return static_cast<int>(cudaGetLastError());
}

int stretto_beta_incinv_grad(const float* a, const float* b, const float* x,
                             float* fd, float* pdf, long long n,
                             void* stream) {
  if (n > 0)
    beta_incinv_grad_kernel<<<blocks(4 * n), THREADS, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        a, b, x, fd, pdf, n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
