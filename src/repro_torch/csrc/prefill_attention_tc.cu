// Causal / windowed flash attention over whole sequences (the offline
// prefill) on Hopper's tensor cores: the bfloat16 body of kernel D, for
// sm_90a. The float32 body, and bf16 shapes this body does not take, stay
// in prefill_attention.cu; kernels/prefill_attention.py picks the body.
//
// Replaces the Pallas TPU kernel repro/kernels/prefill_attention.py
// (prefill_attention -> _prefill_kernel) for bfloat16 inputs. Query
// position i attends to key position j iff  i - j < window  and, when
// causal, j <= i. The softmax is taken online over key tiles in float32,
// with the Pallas kernel's finite mask value -1e30, its running max m
// initialised to -1e30, and its final division by max(l, 1e-30).
//
// Layouts (row-major, contiguous, bfloat16):
//   q    (B, S, KV, G, dk)      dk % 16 == 0, dk <= 256
//   k    (B, S, KV, dk)
//   v    (B, S, KV, dv)         dv % 16 == 0, dv <= 128
//   out  (B, S, KV, G, dv)
//
// What bounds it on the H100: at the 8B build shapes (B 4, S 512-1024,
// KV 8, G 4, d 128) the tensor cores and the bytes are within 1.5x of
// each other: 2 (dk + dv) flops per live (query row, key) pair at 989
// TFLOP/s against q, k, v read once and out written once at 3.35 TB/s.
// What holds this body back is neither: per key tile a warpgroup runs
// Q K^T, then the softmax, then P V, one after the other, and the softmax
// (exp on the special-function unit, the row max and sum, the rescale of
// O) takes about as long as both products (PERF.md).
//
// The design:
//  * Both products run as wgmma.mma_async on bf16 operands with float32
//    accumulators in registers. A CTA holds two consumer warpgroups of
//    M = 64 rows each; row r = (query position q0 + r / G, head r % G) of
//    one KV head, so BQ = 128 / G positions share every K / V tile. Rows
//    from BQ * G to 127 are padding (G 3: 126 live rows), zero in Q.
//  * S = Q K^T: wgmma m64n64k16 with Q and K from shared memory (both
//    K-major, 128-byte swizzle), dk / 16 steps (dk padded to a multiple
//    of 64 with zero columns). The scale dk^-0.5 times log2 e is applied
//    to the float32 scores; exp is ex2.approx.
//  * The online softmax (m, l and the rescale of O) stays in registers: a
//    thread holds two rows of the accumulator fragment, and the four lanes
//    that share a row reduce with two shuffles. l is kept as a per-thread
//    partial sum and reduced once at the end. The exact (row, key) mask is
//    taken only on tiles that straddle the diagonal, a window edge or S.
//  * P goes to wgmma as its A operand from registers (the accumulator
//    fragment of S is the A fragment of P), split into a bf16 high part
//    and a bf16 low part, P = hi + lo to about 16 bits: O += hi V + lo V,
//    wgmma m64n64k16 per 64 columns of dv, V read from shared memory as an
//    MN-major (transposed) B operand. A single bf16 P, as SDPA and FA2/3
//    round it, moved a full-width 8B prefill's logits (32 layers) past 5 %
//    of their magnitude against the blocked attention; the split costs a
//    second product per k-step and keeps the error at the output's own
//    bf16 rounding.
//  * The two warpgroups take turns at Q K^T (named barriers), so one's
//    softmax tends to run beside the other's products.
//  * Loads: one producer warp issues TMA (cp.async.bulk.tensor) copies.
//    K and V tiles of BK = 64 positions (rank-4 maps over (d, KV, S, B),
//    64-column boxes, 128-byte swizzle matching the wgmma descriptors) go
//    into a ring of 3 stages (2 where dk > 192), with a full and an empty
//    mbarrier per stage. Q (a rank-5 map over (dk, G, KV, S, B), a box of
//    64 columns x G heads x BQ positions: the CTA's rows in order) goes
//    into one of two buffers, so the next item's Q and first tiles arrive
//    while the current item finishes. S is a dimension of every map:
//    positions past S, and columns past d, arrive as zeros.
//  * Persistent CTAs, one per SM: work items (query tile, KV head, batch
//    row) are numbered from the last query tile down, so the longest
//    causal items start first, and CTA c takes items c, c + grid, ...
//    Each item walks its key tiles in increasing order from the first the
//    window reaches to the tile of its last query's diagonal; tiles wholly
//    above the diagonal or outside the window are never loaded.
//  * The output goes straight from registers to device memory in bf16.
//  * No atomics and no split of S: a row's sums run in one order fixed by
//    its position, the window and the tile sizes. Keys past S or past a
//    causal row give P = 0 exactly, and alpha is exactly 1 while m does
//    not change, so an item's rows are bit-identical alone and inside a
//    larger, further-padded batch.
//
// The host entry encodes the three tensor maps per call through the driver
// entry point cuTensorMapEncodeTiled (no -lcuda needed) and passes them as
// a __grid_constant__ kernel parameter.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr int CONSUMER_WARPS = 8;  // two consumer warpgroups
constexpr int THREADS = 32 * (CONSUMER_WARPS + 1);   // + a producer warp
constexpr int ROWS = 128;          // query rows (position x head) per CTA
constexpr int BK = 64;             // key positions per tile
constexpr int CHUNK = 64;          // bf16 columns per 128-byte swizzled row
constexpr int Q_CHUNK_BYTES = ROWS * 128;
constexpr int KV_CHUNK_BYTES = BK * 128;
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarrier / TMA -----------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// A load that never lands (a bad tensor map) traps after about 2^30 polls
// instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (polls == (1u << 30)) __trap();
  }
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3) : "memory");
}

__device__ __forceinline__ void tma_load_5d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3), "r"(c4) : "memory");
}

// Named barriers 2 + w, over the two consumer warpgroups only (the
// producer warp has left): warpgroup w's turn at the tensor cores.
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(2 + wg), "n"(CONSUMER_WARPS * 32)
               : "memory");
}
__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(3 - wg), "n"(CONSUMER_WARPS * 32)
               : "memory");
}

// ---- wgmma --------------------------------------------------------------

// Shared-memory matrix descriptor, 128-byte swizzle. For the K-major
// operands (Q, K) only the 8-row stride (SBO, 1024 bytes) is read; for the
// MN-major V at N = 64 one swizzle atom spans N, so the 8-row stride along
// K is the only offset read, and both fields carry it.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  constexpr uint64_t kStride = 1024 >> 4;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (kStride << 16) |
         (kStride << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {   // all committed groups
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving register reads or writes of a wgmma
// operand across the asynchronous instruction's issue or its wait.
__device__ __forceinline__ void fence_reg(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}
__device__ __forceinline__ void fence_reg(uint32_t& r) {
  asm volatile("" : "+r"(r)::"memory");
}

#define STRETTO_D32(d)                                                        \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),     \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),            \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),        \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),        \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),        \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),        \
      "+f"(d[31])
#define STRETTO_R32                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "   \
  "%30, %31}"

// d(64x64) (+)= A(64x16, smem, K-major) * B(16x64, smem, K-major)
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " STRETTO_R32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : STRETTO_D32(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d(64x64) += A(64x16, registers) * B(16x64, smem, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " STRETTO_R32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : STRETTO_D32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef STRETTO_D32
#undef STRETTO_R32

// 2^x on the special-function unit (one instruction; results below 2^-126
// flush to 0, which only ever meets probabilities of masked or negligible
// keys).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// ---- the kernel ---------------------------------------------------------

// S = Q K^T over DKC 64-column chunks of dk (4 steps of 16 each; columns
// past dk are zero in both Q and K, so they add exact zeros).
template <int DKC>
__device__ __forceinline__ void issue_qk(float (&s)[32], uint32_t qa,
                                         uint32_t ks) {
#pragma unroll
  for (int x = 0; x < 32; ++x) fence_reg(s[x]);
  wgmma_fence();
#pragma unroll
  for (int c = 0; c < DKC; ++c)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)   // 16 columns = 32 bytes a step
      wgmma_ss(s, desc_sw128(qa + c * Q_CHUNK_BYTES + kk * 32),
               desc_sw128(ks + c * KV_CHUNK_BYTES + kk * 32), c + kk > 0);
  wgmma_commit();
}

// O += P V over the BK keys of a tile, 4 steps of 16 keys, 64 columns of
// dv per instruction, P as its bf16 high part then its bf16 low part.
template <int DVC>
__device__ __forceinline__ void issue_pv(float (&o)[DVC][32],
                                         uint32_t (&p)[2][4][4],
                                         uint32_t vs) {
#pragma unroll
  for (int c = 0; c < DVC; ++c)
#pragma unroll
    for (int x = 0; x < 32; ++x) fence_reg(o[c][x]);
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) fence_reg(p[h][kk][j]);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int c = 0; c < DVC; ++c) {
      const uint64_t d = desc_sw128(vs + c * KV_CHUNK_BYTES + kk * 16 * 128);
      wgmma_rs(o[c], p[0][kk], d);
      wgmma_rs(o[c], p[1][kk], d);
    }
  wgmma_commit();
}

template <int DVC>
__device__ __forceinline__ void fence_pv(float (&o)[DVC][32],
                                         uint32_t (&p)[2][4][4]) {
#pragma unroll
  for (int c = 0; c < DVC; ++c)
#pragma unroll
    for (int x = 0; x < 32; ++x) fence_reg(o[c][x]);
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) fence_reg(p[h][kk][j]);
}

// One tile of the online softmax over this thread's 2 rows x 16 keys of
// the score fragment: scale, mask (MASK: tiles that straddle the diagonal,
// a window edge or S), running max across the 4 lanes of a row,
// s <- 2^(s - m), l <- l * alpha + sum. Row h sees the tile's key columns
// c (0-63) with lo[h] < c <= hi[h].
template <bool MASK>
__device__ __forceinline__ void online_softmax(float (&s)[32], float (&m)[2],
                                               float (&l)[2],
                                               float (&alpha)[2],
                                               const int (&lo)[2],
                                               const int (&hi)[2], int lane,
                                               float scale2) {
  float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int x = 0; x < 32; ++x) {
    const int h = (x >> 1) & 1;
    float y = s[x] * scale2;
    if (MASK) {
      const int c = 8 * (x >> 2) + 2 * (lane & 3) + (x & 1);
      if (c <= lo[h] || c > hi[h]) y = NEG_INF;
    }
    s[x] = y;
    mx[h] = fmaxf(mx[h], y);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const float m_new = fmaxf(m[h], mx[h]);
    alpha[h] = m_new == m[h] ? 1.f : ex2(m[h] - m_new);
    m[h] = m_new;
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int x = 0; x < 32; ++x) {
    const int h = (x >> 1) & 1;
    s[x] = ex2(s[x] - m[h]);
    sum[h] += s[x];
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + sum[h];
}

// O *= alpha (per row), then P as two bf16 parts, P = hi + lo to about
// 16 bits: the score fragment of 16 keys is the A fragment of one k-step.
template <int DVC>
__device__ __forceinline__ void rescale_and_pack(float (&o)[DVC][32],
                                                 uint32_t (&p)[2][4][4],
                                                 const float (&s)[32],
                                                 const float (&alpha)[2]) {
#pragma unroll
  for (int c = 0; c < DVC; ++c)
#pragma unroll
    for (int x = 0; x < 32; ++x) o[c][x] *= alpha[(x >> 1) & 1];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float a = s[8 * kk + 2 * j], b = s[8 * kk + 2 * j + 1];
      const __nv_bfloat162 hi = __floats2bfloat162_rn(a, b);
      const float2 h = __bfloat1622float2(hi);
      p[0][kk][j] = *reinterpret_cast<const uint32_t*>(&hi);
      p[1][kk][j] = pack_bf16(a - h.x, b - h.y);
    }
}

// The three tensor maps of a call (kernel parameters, 128 bytes each).
struct Maps {
  CUtensorMap q, k, v;
};

// K / V ring depth: 3 where two Q buffers and 3 stages fit in shared
// memory (dk <= 192), else 2.
__host__ __device__ constexpr int stages_for(int dkc, int dvc) {
  return 2 * dkc * Q_CHUNK_BYTES + 3 * (dkc + dvc) * KV_CHUNK_BYTES <=
                 220 * 1024
             ? 3
             : 2;
}

// One work item: a query tile of one (item, KV head), and its key tiles.
struct Item {
  int kv, b, q0, q_last, t_first, n_tiles;
};

// DKC, DVC = 64-column chunks of dk (1-4) and dv (1-2). Warps 0-7 are
// the two consumer warpgroups; warp 8 issues the TMA loads. One CTA per
// SM walks its items in turn; the producer fetches the next item's Q and
// key tiles while the consumers finish the current one.
template <int DKC, int DVC>
__global__ void __launch_bounds__(THREADS, 1)
prefill_tc_kernel(const __grid_constant__ Maps maps,
                  __nv_bfloat16* __restrict__ out, int B, int S, int KV,
                  int G, int dv, int window, int causal, float scale) {
  constexpr int STAGES = stages_for(DKC, DVC);
  constexpr uint32_t STAGE_BYTES = (DKC + DVC) * KV_CHUNK_BYTES;
  constexpr uint32_t Q_BYTES = DKC * Q_CHUNK_BYTES;
  extern __shared__ uint8_t smem_raw[];
  // 1024-byte alignment: the 128-byte swizzle repeats every 8 rows
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* sbase = smem_raw + (base - raw);
  const uint32_t qs = base;                          // 2 Q buffers
  const uint32_t ring = qs + 2 * Q_BYTES;            // STAGES K / V stages
  const uint32_t full = ring + STAGES * STAGE_BYTES;  // mbarriers
  const uint32_t empty = full + 8 * STAGES;
  const uint32_t qfull = empty + 8 * STAGES;
  const uint32_t qempty = qfull + 16;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int BQ = ROWS / G;
  const int R = BQ * G;
  const int n_qt = (S + BQ - 1) / BQ;
  const int n_items = n_qt * KV * B;
  auto item_of = [&](int j) {
    Item it;
    const int qt = n_qt - 1 - j / (KV * B);
    it.kv = j % KV;
    it.b = (j / KV) % B;
    it.q0 = qt * BQ;
    it.q_last = min(it.q0 + BQ, S) - 1;
    const int k_end = causal ? it.q_last + 1 : S;             // exclusive
    it.t_first = max(0, it.q0 - window + 1) / BK;
    it.n_tiles = (k_end - 1) / BK - it.t_first + 1;
    return it;
  };

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMER_WARPS);
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(qfull + 8 * s, 1);
      mbar_init(qempty + 8 * s, CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // Q rows past BQ * G (G not a power of two) are zero, never loaded
  for (int e = tid; e < 2 * (ROWS - R) * DKC * 8; e += THREADS) {
    const int f = e % ((ROWS - R) * DKC * 8), qb = e / ((ROWS - R) * DKC * 8);
    const int r = R + f / (DKC * 8), c = (f / 8) % DKC, j = f % 8;
    *reinterpret_cast<uint4*>(sbase + qb * Q_BYTES + c * Q_CHUNK_BYTES +
                              r * 128 + j * 16) = make_uint4(0, 0, 0, 0);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();   // barriers initialised, padding rows zeroed

  if (warp == CONSUMER_WARPS) {
    // ---- producer: per item, Q into buffer n % 2 once free, then each
    // key tile into stage g % STAGES once free (g counts all tiles) ----
    if (lane == 0) {
      int g = 0;
      for (int j = blockIdx.x, n = 0; j < n_items; j += gridDim.x, ++n) {
        const Item it = item_of(j);
        const int qb = n & 1;
        if (n >= 2) mbar_wait(qempty + 8 * qb, ((n >> 1) + 1) & 1);
        mbar_expect_tx(qfull + 8 * qb, DKC * R * 128);
#pragma unroll
        for (int c = 0; c < DKC; ++c)
          tma_load_5d(qs + qb * Q_BYTES + c * Q_CHUNK_BYTES, &maps.q,
                      qfull + 8 * qb, c * CHUNK, 0, it.kv, it.q0, it.b);
        for (int i = 0; i < it.n_tiles; ++i, ++g) {
          const int st = g % STAGES;
          if (g >= STAGES) mbar_wait(empty + 8 * st, ((g / STAGES) + 1) & 1);
          const uint32_t bar = full + 8 * st;
          const uint32_t ks = ring + st * STAGE_BYTES;
          const uint32_t vs = ks + DKC * KV_CHUNK_BYTES;
          const int p0 = (it.t_first + i) * BK;
          mbar_expect_tx(bar, STAGE_BYTES);
#pragma unroll
          for (int c = 0; c < DKC; ++c)
            tma_load_4d(ks + c * KV_CHUNK_BYTES, &maps.k, bar, c * CHUNK,
                        it.kv, p0, it.b);
#pragma unroll
          for (int c = 0; c < DVC; ++c)
            tma_load_4d(vs + c * KV_CHUNK_BYTES, &maps.v, bar, c * CHUNK,
                        it.kv, p0, it.b);
        }
      }
    }
    return;
  }

  // ---- consumers ----
  const int wg = warp / 4;
  const int r0 = wg * 64 + (warp % 4) * 16 + lane / 4;   // and r0 + 8
  const float scale2 = scale * LOG2E;
  float o[DVC][32], s[32];
  uint32_t p[2][4][4];   // P's bf16 high and low parts
#pragma unroll
  for (int x = 0; x < 32; ++x) s[x] = 0.f;

  // The warpgroups take turns at Q K^T, so one's softmax runs beside the
  // other's products: warpgroup 0 goes first, and takes warpgroup 1's
  // last turn at the end.
  if (wg == 1) turn_pass(wg);
  int g = 0;
  for (int j = blockIdx.x, n = 0; j < n_items; j += gridDim.x, ++n) {
    const Item it = item_of(j);
    const int qb = n & 1;
    int qpos[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) qpos[h] = it.q0 + (r0 + 8 * h) / G;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, alpha[2];
#pragma unroll
    for (int c = 0; c < DVC; ++c)
#pragma unroll
      for (int x = 0; x < 32; ++x) o[c][x] = 0.f;
    const uint32_t qa = qs + qb * Q_BYTES + wg * 64 * 128;   // 64 Q rows
    mbar_wait(qfull + 8 * qb, (uint32_t)((n >> 1) & 1));
    for (int i = 0; i < it.n_tiles; ++i, ++g) {
      const int st = g % STAGES;
      const int p0 = (it.t_first + i) * BK;
      const bool whole = p0 + BK <= S &&
                         (!causal || p0 + BK - 1 <= it.q0) &&
                         it.q_last - p0 < window;
      const uint32_t ks = ring + st * STAGE_BYTES;
      mbar_wait(full + 8 * st, (uint32_t)((g / STAGES) & 1));
      turn_wait(wg);
      issue_qk<DKC>(s, qa, ks);
      wgmma_wait();
      turn_pass(wg);
#pragma unroll
      for (int x = 0; x < 32; ++x) fence_reg(s[x]);
      // key p0 + c is live for query position qp iff qp - window < p0 + c,
      // p0 + c < S and, when causal, p0 + c <= qp
      int lo[2] = {-1, -1}, hi[2] = {BK, BK};
      if (whole) {
        online_softmax<false>(s, m, l, alpha, lo, hi, lane, scale2);
      } else {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          lo[h] = qpos[h] - window - p0;
          hi[h] = (causal ? min(qpos[h], S - 1) : S - 1) - p0;
        }
        online_softmax<true>(s, m, l, alpha, lo, hi, lane, scale2);
      }
      rescale_and_pack<DVC>(o, p, s, alpha);
      issue_pv<DVC>(o, p, ks + DKC * KV_CHUNK_BYTES);
      wgmma_wait();
      fence_pv<DVC>(o, p);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * st);
    }
    if (lane == 0) mbar_arrive(qempty + 8 * qb);   // this Q is done

    // ---- out = O / max(l, 1e-30) in bf16, straight from registers ----
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
      const int pos = qpos[h], g_head = r % G;
      if (r >= R || pos >= S) continue;
      const float inv = 1.f / fmaxf(l[h], 1e-30f);
      __nv_bfloat16* orow =
          out + ((((long)it.b * S + pos) * KV + it.kv) * G + g_head) * dv;
#pragma unroll
      for (int c = 0; c < DVC; ++c)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int col = c * CHUNK + 8 * jj + 2 * (lane & 3);
          if (col < dv)
            *reinterpret_cast<__nv_bfloat162*>(orow + col) =
                __floats2bfloat162_rn(o[c][4 * jj + 2 * h] * inv,
                                      o[c][4 * jj + 2 * h + 1] * inv);
        }
    }
  }
  if (wg == 0) turn_wait(wg);
}

// ---- host: tensor maps and launch ---------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A tensor map over a contiguous bf16 tensor of the given dims (innermost
// first), 64-column boxes, 128-byte swizzle, zero fill past the edges.
bool encode(CUtensorMap* map, const void* ptr, int rank,
            const cuuint64_t* dims, const cuuint32_t* box) {
  EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return false;
  cuuint64_t strides[4];
  cuuint64_t stride = 2;
  for (int i = 0; i + 1 < rank; ++i) strides[i] = stride *= dims[i];
  const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
            const_cast<void*>(ptr), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// q / out: rank 5 over (d, G, KV, S, B), boxes of 64 columns x G heads x
// BQ positions (the CTA's rows in order); k / v: rank 4 over (d, KV, S, B),
// boxes of 64 columns x BK positions. S is a dimension of its own, so
// positions past S load as zeros and are never stored.
bool encode_maps(Maps* m, const void* q, const void* k, const void* v, int B,
                 int S, int KV, int G, int dk, int dv) {
  const cuuint32_t BQ = ROWS / G;
  const cuuint64_t qd[5] = {(cuuint64_t)dk, (cuuint64_t)G, (cuuint64_t)KV,
                            (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t kd[4] = {(cuuint64_t)dk, (cuuint64_t)KV, (cuuint64_t)S,
                            (cuuint64_t)B};
  const cuuint64_t vd[4] = {(cuuint64_t)dv, (cuuint64_t)KV, (cuuint64_t)S,
                            (cuuint64_t)B};
  const cuuint32_t qbox[5] = {CHUNK, (cuuint32_t)G, 1, BQ, 1};
  const cuuint32_t kbox[4] = {CHUNK, 1, BK, 1};
  return encode(&m->q, q, 5, qd, qbox) && encode(&m->k, k, 4, kd, kbox) &&
         encode(&m->v, v, 4, vd, kbox);
}

size_t smem_bytes(int dkc, int dvc) {
  const int stages = stages_for(dkc, dvc);
  return 1024 + 2 * (size_t)dkc * Q_CHUNK_BYTES +
         (size_t)stages * (dkc + dvc) * KV_CHUNK_BYTES + 8 * (2 * stages + 4);
}

template <int DKC, int DVC>
cudaError_t launch(const Maps& maps, void* out, int B, int S, int KV, int G,
                   int dv, int window, int causal, float scale,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(DKC, DVC);
  auto kern = prefill_tc_kernel<DKC, DVC>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const int BQ = ROWS / G;
  const long items = (long)((S + BQ - 1) / BQ) * KV * B;
  kern<<<(int)(items < sms ? items : sms), THREADS, smem, stream>>>(
      maps, static_cast<__nv_bfloat16*>(out), B, S, KV, G, dv, window,
      causal, scale);
  return cudaGetLastError();
}

template <int DVC>
cudaError_t launch_dk(const Maps& maps, void* out, int B, int S, int KV, int G,
                      int dk, int dv, int window, int causal, float scale,
                      cudaStream_t stream) {
#define STRETTO_TC(DKC)                                                     \
  return launch<DKC, DVC>(maps, out, B, S, KV, G, dv, window, causal, scale, \
                          stream)
  if (dk <= 64) STRETTO_TC(1);
  if (dk <= 128) STRETTO_TC(2);
  if (dk <= 192) STRETTO_TC(3);
  STRETTO_TC(4);
#undef STRETTO_TC
}

}  // namespace

extern "C" {

// bfloat16 q, k, v and out. The caller checks 1 <= G <= 64, dk % 16 == 0,
// dk <= 256, dv % 16 == 0, dv <= 128, window >= 1 and 16-byte aligned
// base pointers; they are checked again here.
int stretto_prefill_attention_tc(const void* q, const void* k, const void* v,
                                 void* out, int B, int S, int KV, int G,
                                 int dk, int dv, int window, int causal,
                                 float scale, void* stream) {
  if (G < 1 || G > 64 || dk < 16 || dk > 256 || dk % 16 || dv < 16 ||
      dv > 128 || dv % 16 || window < 1 || B < 1 || S < 1 || KV < 1)
    return (int)cudaErrorInvalidValue;
  for (const void* p : {q, k, v, (const void*)out})
    if (reinterpret_cast<uintptr_t>(p) % 16) return (int)cudaErrorInvalidValue;
  Maps maps;
  if (!encode_maps(&maps, q, k, v, B, S, KV, G, dk, dv))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dv <= CHUNK)
    return (int)launch_dk<1>(maps, out, B, S, KV, G, dk, dv, window, causal,
                             scale, st);
  return (int)launch_dk<2>(maps, out, B, S, KV, G, dk, dv, window, causal,
                           scale, st);
}

}  // extern "C"
