// Causal GQA flash-attention backward for NVIDIA Hopper (sm_90a): dq and
// dk/dv from the forward's saved q, k, v, out and lse.
//
// flash_bwd_dq replaces src/repro/kernels/flash/flash.py::_bwd_dq_kernel
// (:142, launched by _flash_bwd at :279); flash_bwd_dkv replaces
// ::_bwd_dkv_kernel (:179, launched at :296) together with the group sum
// _flash_bwd does after it (:305-306). Both recompute the probabilities
// from lse instead of reading an S x S matrix:
//   p   = exp(q k^T * scale - lse)     (0 above the causal diagonal)
//   dp  = dout v^T
//   ds  = p * (dp - D) * scale         D = rowsum(dout * out), f32, given
//   dq  = sum_kv ds k                  (B, Sq, H, Hd) bf16
//   dk  = sum_{q heads of the group} sum_q ds^T q     (B, Skv, KvH, Hd) bf16
//   dv  = sum_{q heads of the group} sum_q p^T dout
//
// What bounds them on this card. At the training slice's shape (B=8, H=12,
// KvH=2, S=512, Hd=128, causal) dq does 9.7 GFLOP (9.8 us at 989 TFLOP/s
// bf16) and moves ~42 MB (12.6 us at 3.35 TB/s): bound by bytes; dk/dv
// does 12.9 GFLOP (13.1 us; 19.6 us with the hi/lo split of its two f32
// operands) against ~34 MB (10.1 us): bound by operations, as both are at
// S=4096 (dkv 104 us). Every sum is kept in registers until one bf16
// store, and the products that take an f32 operand split it into a bf16
// high and low part.
//
// flash_bwd_dq (the first port's design, mma.sync):
//   * grid (Sq / blk_q, B*H), one CTA owns blk_q query rows of one head
//     (blk_q / 16 warps, warp w owns rows 16w..16w+15). The Pallas kv grid
//     axis with its revisited dq block becomes a loop over kv blocks of
//     BKV rows inside the CTA; the causal skip (pl.when, :175) is the
//     loop's bound. The q and dout tiles stay in shared memory; each kv
//     step stages one K and one V tile. dq accumulates in f32 registers
//     and is written once, in bf16 (the JAX cast at :311).
//   * products: mma.sync.aligned.m16n8k16 bf16 x bf16 -> f32; ds k takes
//     ds split into hi = bf16(x) and lo = bf16(x - hi), both multiplied.
//
// flash_bwd_dkv (wgmma over a TMA ring, the group summed in a cluster):
//   * grid (H, Skv / 64 x B): one CTA owns 64 kv rows (wgmma's M) of one
//     q head, so a GQA group's q heads run in parallel on as many CTAs,
//     issued lowest kv block (the most q blocks) first. The CTA loops over
//     the q blocks of BQ rows from the diagonal on.
//   * the group sum in a fixed order, with no atomics: the group's CTAs of
//     one kv block form a thread-block cluster (group <= 8, the portable
//     cluster size). Each leaves its f32 dk/dv tile in its own shared
//     memory; after a cluster barrier CTA r sums slice r of the tiles over
//     the group's CTAs in q-head order 0..g-1 through distributed shared
//     memory and stores bf16. A group larger than 8 writes f32 per-q-head
//     partials (B, Skv, H, Hd) instead, which dkv_group_sum adds in the
//     same order (the JAX structure, flash.py:296-306). Either way the
//     result is the same from run to run.
//   * one warpgroup a CTA (128 threads, two CTAs an SM, so the registers
//     dk, dv and the score tiles need, up to 255 a thread, fit beside the
//     other CTA's; a separate producer warp or warpgroup would cap them at
//     168 or 128, as the SM's four register quarters are shared by warp
//     count, and setmaxnreg does not lift the compiler's cap). Thread 0
//     loads K and V once and then, per q block, the q and dout tiles (TMA,
//     128-byte swizzled, from the model layout through 4-D tensor maps)
//     and the lse and delta rows (bulk copies) into a ring of 2 (BQ 64) or
//     3 (BQ 32) stages handed over by mbarriers: full when the bytes have
//     arrived; empty when all 128 threads are done with the stage, after
//     which one lane of warp 0 refills it with the step ST ahead, so loads
//     run under the math of the steps between.
//   * products on wgmma: s^T = k q^T and dp^T = v dout^T with both
//     operands K-major in shared memory (exact bf16 products summed in
//     f32, as the Pallas f32 dots); dv += p^T dout and dk += ds^T q take p^T
//     and ds^T from registers (the accumulators re-packed as A operands),
//     split into bf16 hi + lo (two wgmma each), and dout / q MN-major.
//   * the arithmetic order of the Pallas kernels: s * scale, the mask,
//     exp(s - lse), p * (dp - D) * scale, in f32 with expf (built without
//     --use_fast_math).
//   * q, k, v and dout are read in the model's (B, S, heads, Hd) layout
//     through element strides (the last axis contiguous, 16-byte rows);
//     dq, dk and dv are written contiguous.
//
// Instances: dq: Hd in {64, 128} x BKV in {32, 64}, blk_q 16..128 by 16s
// at run time (blockDim.x = 2 * blk_q). dkv: Hd in {64, 128} x BQ in {32,
// 64}, 64 kv rows a CTA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* dout;
  const float* lse;     // (B*H, Sq)
  const float* delta;   // (B*H, Sq)
  __nv_bfloat16* dq;    // (B, Sq, H, Hd) contiguous
  __nv_bfloat16* dk;    // (B, Skv, KvH, Hd) contiguous
  __nv_bfloat16* dv;    // (B, Skv, KvH, Hd) contiguous
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;   // dout
  int H, KvH, Sq, Skv, blk, causal;
  float scale;
};

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

using sm90::as_u32;
using sm90::split2;

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return as_u32(__halves2bfloat162(lo, hi));
}

// A fragment (16 x 16, row major) of rows row0.. of a padded smem tile
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* s,
                                       int ld, int row0, int kk, int g, int t) {
  const __nv_bfloat16* p = s + (row0 + g) * ld + kk * 16 + 2 * t;
  a[0] = *reinterpret_cast<const uint32_t*>(p);
  a[1] = *reinterpret_cast<const uint32_t*>(p + 8 * ld);
  a[2] = *reinterpret_cast<const uint32_t*>(p + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(p + 8 * ld + 8);
}

// B fragment (16 x 8) with B[k][n] = tile[n0 + n][k0 + k]: rows of the
// tile are the product's columns (the X^T of A X^T)
__device__ __forceinline__ void load_b_rows(uint32_t (&b)[2],
                                            const __nv_bfloat16* s, int ld,
                                            int n0, int k0, int g, int t) {
  const __nv_bfloat16* p = s + (n0 + g) * ld + k0 + 2 * t;
  b[0] = *reinterpret_cast<const uint32_t*>(p);
  b[1] = *reinterpret_cast<const uint32_t*>(p + 8);
}

// B fragment (16 x 8) with B[k][n] = tile[k0 + k][n0 + n]: the tile as it
// is (the X of A X)
__device__ __forceinline__ void load_b_cols(uint32_t (&b)[2],
                                            const __nv_bfloat16* s, int ld,
                                            int k0, int n0, int g, int t) {
  const __nv_bfloat16* p = s + (k0 + 2 * t) * ld + n0 + g;
  b[0] = pack2(p[0], p[ld]);
  b[1] = pack2(p[8 * ld], p[9 * ld]);
}

// stage `rows` rows of Hd bf16 from global (row stride `rs`) into smem
template <int HD>
__device__ __forceinline__ void stage(__nv_bfloat16* dst,
                                      const __nv_bfloat16* src, long long rs,
                                      int rows, int tid, int nthr) {
  constexpr int LD = HD + 8;
  constexpr int CH = HD / 8;
  for (int c = tid; c < rows * CH; c += nthr) {
    const int r = c / CH, col = (c % CH) * 8;
    *reinterpret_cast<uint4*>(dst + r * LD + col) =
        *reinterpret_cast<const uint4*>(src + (long long)r * rs + col);
  }
}

// acc[HD/8] += A (16 x 16*NK, f32 in C-fragment layout, split hi + lo) x
// tile (rows k0.., HD columns)
template <int HD, int NK>
__device__ __forceinline__ void mma_f32a(float (&acc)[HD / 8][4],
                                         const float (&x)[2 * NK][4],
                                         const __nv_bfloat16* tile, int ld,
                                         int g, int t) {
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) {
    uint32_t ah[4], al[4];
    split2(x[2 * kk][0], x[2 * kk][1], ah[0], al[0]);
    split2(x[2 * kk][2], x[2 * kk][3], ah[1], al[1]);
    split2(x[2 * kk + 1][0], x[2 * kk + 1][1], ah[2], al[2]);
    split2(x[2 * kk + 1][2], x[2 * kk + 1][3], ah[3], al[3]);
#pragma unroll
    for (int d = 0; d < HD / 8; ++d) {
      uint32_t bb[2];
      load_b_cols(bb, tile, ld, kk * 16, d * 8, g, t);
      mma_bf16(acc[d], ah, bb);
      mma_bf16(acc[d], al, bb);
    }
  }
}

// ---------------------------------------------------------------------------
// dq: one CTA per (q block, batch * head)
// ---------------------------------------------------------------------------

template <int HD, int BKV>
__global__ void __launch_bounds__(256) flash_bwd_dq_kernel(Params p) {
  constexpr int LD = HD + 8;
  constexpr int NT = BKV / 8;
  constexpr int DT = HD / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int blk_q = p.blk;
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* o_s = q_s + blk_q * LD;
  __nv_bfloat16* k_s = o_s + blk_q * LD;
  __nv_bfloat16* v_s = k_s + BKV * LD;

  const int qi = gridDim.x - 1 - blockIdx.x;     // heaviest q blocks first
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int kvh = h / (p.H / p.KvH);
  const int q0 = qi * blk_q;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = warp * 16;
  const int qpos0 = q0 + row0 + g, qpos1 = qpos0 + 8;

  const __nv_bfloat16* kg = p.k + b * p.k_sb + kvh * p.k_sh;
  const __nv_bfloat16* vg = p.v + b * p.v_sb + kvh * p.v_sh;
  stage<HD>(q_s, p.q + b * p.q_sb + h * p.q_sh + (long long)q0 * p.q_ss,
            p.q_ss, blk_q, tid, nthr);
  stage<HD>(o_s, p.dout + b * p.o_sb + h * p.o_sh + (long long)q0 * p.o_ss,
            p.o_ss, blk_q, tid, nthr);
  const float lse0 = p.lse[(long long)bh * p.Sq + qpos0];
  const float lse1 = p.lse[(long long)bh * p.Sq + qpos1];
  const float dd0 = p.delta[(long long)bh * p.Sq + qpos0];
  const float dd1 = p.delta[(long long)bh * p.Sq + qpos1];

  float acc[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[d][e] = 0.f;

  const int n_kv = p.Skv / BKV;
  const int kv_end = p.causal ? min(n_kv, (q0 + blk_q - 1) / BKV + 1) : n_kv;
  for (int j = 0; j < kv_end; ++j) {
    const int kv0 = j * BKV;
    __syncthreads();    // the previous tiles are consumed (and q/dout staged)
    stage<HD>(k_s, kg + (long long)kv0 * p.k_ss, p.k_ss, BKV, tid, nthr);
    stage<HD>(v_s, vg + (long long)kv0 * p.v_ss, p.v_ss, BKV, tid, nthr);
    __syncthreads();

    // s = q k^T and dp = dout v^T over this warp's 16 rows x BKV columns
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t aq[4], ao[4];
      load_a(aq, q_s, LD, row0, kk, g, t);
      load_a(ao, o_s, LD, row0, kk, g, t);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        uint32_t bk[2], bv[2];
        load_b_rows(bk, k_s, LD, n * 8, kk * 16, g, t);
        load_b_rows(bv, v_s, LD, n * 8, kk * 16, g, t);
        mma_bf16(s[n], aq, bk);
        mma_bf16(dp[n], ao, bv);
      }
    }
    // p = exp(s * scale - lse) (0 where masked); ds = p * (dp - D) * scale,
    // kept in s
    const bool masked = p.causal && (kv0 + BKV - 1 > q0 + row0);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool r1 = e >= 2;
        float pr = expf(s[n][e] * p.scale - (r1 ? lse1 : lse0));
        if (masked && kv0 + n * 8 + 2 * t + (e & 1) > (r1 ? qpos1 : qpos0))
          pr = 0.f;
        s[n][e] = pr * (dp[n][e] - (r1 ? dd1 : dd0)) * p.scale;
      }
    }
    // dq += ds k
    mma_f32a<HD, BKV / 16>(acc, s, k_s, LD, g, t);
  }

  __nv_bfloat16* out0 = p.dq + ((long long)(b * p.Sq + qpos0) * p.H + h) * HD;
  __nv_bfloat16* out1 = p.dq + ((long long)(b * p.Sq + qpos1) * p.H + h) * HD;
#pragma unroll
  for (int d = 0; d < DT; ++d) {
    const int col = d * 8 + 2 * t;
    *reinterpret_cast<__nv_bfloat162*>(out0 + col) =
        __floats2bfloat162_rn(acc[d][0], acc[d][1]);
    *reinterpret_cast<__nv_bfloat162*>(out1 + col) =
        __floats2bfloat162_rn(acc[d][2], acc[d][3]);
  }
}

using KernelFn = void (*)(Params);

// kind 0: dq (inner = BKV)
KernelFn pick(int kind, int hd, int inner) {
  if (kind == 0) {
    if (hd == 64 && inner == 32) return flash_bwd_dq_kernel<64, 32>;
    if (hd == 64 && inner == 64) return flash_bwd_dq_kernel<64, 64>;
    if (hd == 128 && inner == 32) return flash_bwd_dq_kernel<128, 32>;
    if (hd == 128 && inner == 64) return flash_bwd_dq_kernel<128, 64>;
  }
  return nullptr;
}

// ---------------------------------------------------------------------------
// dk, dv: one CTA per (q head, kv block, batch); the group sums in a cluster
// ---------------------------------------------------------------------------

constexpr int kDkvRows = 64;       // kv rows a CTA: one consumer warpgroup
constexpr int kMaxCluster = 8;     // portable thread-block cluster size
constexpr int kAlign = 1024;

struct DkvParams {
  CUtensorMap tm_q, tm_k, tm_v, tm_do;   // 4-D (hd, heads, S, B) maps
  const float* lse;     // (B*H, Sq)
  const float* delta;   // (B*H, Sq)
  __nv_bfloat16* dk;    // (B, Skv, KvH, Hd) contiguous
  __nv_bfloat16* dv;
  float* part;          // null, or (2, B, Skv, H, Hd) f32 per-q-head partials
  int B, H, KvH, Sq, Skv, causal;
  float scale;
};

template <int HD, int BQ>
struct DkvSmem {
  static constexpr int kStages = BQ == 64 ? 2 : 3;
  static constexpr int kKV = kDkvRows * HD;      // bf16 elements of K or V
  static constexpr int kQ = BQ * HD;             // of one q or dout tile
  static constexpr int kTiles = (2 * kKV + kStages * 2 * kQ) * 2;   // bytes
  static constexpr int kMain = kTiles + kStages * 2 * BQ * 4;       // + stats
  static constexpr int kRedLd = HD + 8;          // f32 row of the sum tile
  static constexpr int kRed = 2 * kDkvRows * kRedLd * 4;
  static constexpr int kBody = kMain > kRed ? kMain : kRed;
  static constexpr int kBytes = kBody + 64 + kAlign;   // + barriers, align
};

template <int HD, int BQ>
__global__ void __launch_bounds__(128, 2)
    flash_bwd_dkv_kernel(const __grid_constant__ DkvParams p) {
  using S = DkvSmem<HD, BQ>;
  constexpr int ST = S::kStages;
  constexpr int NT = BQ / 8;            // 8-column blocks of s^T
  constexpr int LD = S::kRedLd;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + kAlign - 1) &
      ~uintptr_t(kAlign - 1));
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(base);
  __nv_bfloat16* v_s = k_s + S::kKV;
  __nv_bfloat16* ring = v_s + S::kKV;   // stage st: q at 2 st, dout 2 st + 1
  float* stats = reinterpret_cast<float*>(base + S::kTiles);  // lse, delta
  float* red = reinterpret_cast<float*>(base);   // dk, dv after the loop
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + S::kBody);
  uint64_t* kv_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + ST;

  const int h = blockIdx.x;
  const int group = p.H / p.KvH;
  const int hg = h % group, kvh = h / group;     // hg: the rank in the cluster
  const int kj = blockIdx.y / p.B, b = blockIdx.y % p.B;
  const int kv0 = kj * kDkvRows;
  const int n_q = p.Sq / BQ;
  const int qi_start = p.causal ? min(kv0 / BQ, n_q) : 0;
  const long long bh = (long long)b * p.H + h;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // warp 0, read through a shuffle so the compiler sees it is uniform
  const bool warp0 = __shfl_sync(0xffffffffu, warp, 0) == 0;
  const int n_steps = n_q - qi_start;

  // the q, dout, lse and delta rows of step it into its stage
  auto load_step = [&](int it) {
    const int st = it % ST, q0 = (qi_start + it) * BQ;
    sm90::mbar_expect_tx(&full[st], 2 * S::kQ * 2 + 2 * BQ * 4);
    __nv_bfloat16* q_t = ring + 2 * st * S::kQ;
    sm90::tma_load_rows<HD>(q_t, &p.tm_q, &full[st], BQ, h, q0, b);
    sm90::tma_load_rows<HD>(q_t + S::kQ, &p.tm_do, &full[st], BQ, h, q0, b);
    float* st_t = stats + 2 * st * BQ;
    sm90::bulk_load(st_t, p.lse + bh * p.Sq + q0, BQ * 4, &full[st]);
    sm90::bulk_load(st_t + BQ, p.delta + bh * p.Sq + q0, BQ * 4, &full[st]);
  };

  if (threadIdx.x == 0) {
    sm90::mbar_init(kv_full, 1);
    for (int s = 0; s < ST; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 128);
    }
    sm90::fence_barrier_init();
    // K and V once, then the ring's first ST steps
    sm90::mbar_expect_tx(kv_full, 2 * S::kKV * 2);
    sm90::tma_load_rows<HD>(k_s, &p.tm_k, kv_full, kDkvRows, kvh, kv0, b);
    sm90::tma_load_rows<HD>(v_s, &p.tm_v, kv_full, kDkvRows, kvh, kv0, b);
    for (int it = 0; it < min(ST, n_steps); ++it) load_step(it);
  }
  __syncthreads();

  {
    const int w = warp, g = lane >> 2, t = lane & 3;
    const int kpos0 = kv0 + w * 16 + g, kpos1 = kpos0 + 8;
    float dk[HD / 2], dv[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) dk[i] = dv[i] = 0.f;

    sm90::mbar_wait(kv_full, 0);
    for (int qi = qi_start, it = 0; qi < n_q; ++qi, ++it) {
      const int st = it % ST, ph = (it / ST) & 1;
      const int q0 = qi * BQ;
      sm90::mbar_wait(&full[st], ph);
      const __nv_bfloat16* q_t = ring + 2 * st * S::kQ;
      const __nv_bfloat16* o_t = q_t + S::kQ;
      const float* lse_t = stats + 2 * st * BQ;
      const float* dd_t = lse_t + BQ;

      // s^T = k q^T and dp^T = v dout^T: 64 kv rows x BQ query columns
      float s[BQ / 2], dp[BQ / 2];
#pragma unroll
      for (int i = 0; i < BQ / 2; ++i) s[i] = dp[i] = 0.f;
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        sm90::wgmma_ss<0>(s, sm90::desc_kmajor(k_s, kDkvRows, kk),
                          sm90::desc_kmajor(q_t, BQ, kk), 1);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        sm90::wgmma_ss<0>(dp, sm90::desc_kmajor(v_s, kDkvRows, kk),
                          sm90::desc_kmajor(o_t, BQ, kk), 1);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(s);
      sm90::fence_regs(dp);

      // p^T (kept in s) and ds^T (kept in dp); column c is query q0 + c
      const bool masked = p.causal && (q0 < kv0 + w * 16 + 15);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = n * 8 + 2 * t + (e & 1);
          float pr = expf(s[4 * n + e] * p.scale - lse_t[c]);
          if (masked && q0 + c < (e >= 2 ? kpos1 : kpos0)) pr = 0.f;
          s[4 * n + e] = pr;
          dp[4 * n + e] = pr * (dp[4 * n + e] - dd_t[c]) * p.scale;
        }
      }
      // dv += p^T dout, dk += ds^T q, each f32 operand split hi + lo
      uint32_t p_hi[BQ / 16][4], p_lo[BQ / 16][4];
      uint32_t ds_hi[BQ / 16][4], ds_lo[BQ / 16][4];
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        sm90::split_a(s, kk, p_hi[kk], p_lo[kk]);
        sm90::split_a(dp, kk, ds_hi[kk], ds_lo[kk]);
      }
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        const uint64_t bo = sm90::desc_mnmajor(o_t, BQ, kk);
        const uint64_t bq = sm90::desc_mnmajor(q_t, BQ, kk);
        sm90::wgmma_rs<1>(dv, p_hi[kk], bo, 1);
        sm90::wgmma_rs<1>(dv, p_lo[kk], bo, 1);
        sm90::wgmma_rs<1>(dk, ds_hi[kk], bq, 1);
        sm90::wgmma_rs<1>(dk, ds_lo[kk], bq, 1);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(dk);
      sm90::fence_regs(dv);
      sm90::mbar_arrive(&empty[st]);
      // once every thread is done with the stage, warp 0 refills it with
      // step it + ST, which then loads under the next steps' math
      if (warp0 && it + ST < n_steps) {
        sm90::mbar_wait(&empty[st], ph);
        if (sm90::elect_one()) load_step(it + ST);
        __syncwarp();
      }
    }

    if (p.part != nullptr) {
      // f32 partials of this q head; dkv_group_sum adds the group
      const long long plane = (long long)p.B * p.Skv * p.H * HD;
      float* pk0 = p.part + (((long long)b * p.Skv + kpos0) * p.H + h) * HD;
      float* pk1 = p.part + (((long long)b * p.Skv + kpos1) * p.H + h) * HD;
#pragma unroll
      for (int d = 0; d < HD / 8; ++d) {
        const int col = d * 8 + 2 * t;
        *reinterpret_cast<float2*>(pk0 + col) = make_float2(dk[4 * d], dk[4 * d + 1]);
        *reinterpret_cast<float2*>(pk1 + col) = make_float2(dk[4 * d + 2], dk[4 * d + 3]);
        *reinterpret_cast<float2*>(pk0 + plane + col) = make_float2(dv[4 * d], dv[4 * d + 1]);
        *reinterpret_cast<float2*>(pk1 + plane + col) = make_float2(dv[4 * d + 2], dv[4 * d + 3]);
      }
    } else {
      // the f32 tiles into this CTA's shared memory (over K, V and the ring,
      // all consumed), then CTA hg sums slice hg over the cluster
      const int lr0 = w * 16 + g, lr1 = lr0 + 8;
      float* rv = red + kDkvRows * LD;
#pragma unroll
      for (int d = 0; d < HD / 8; ++d) {
        const int col = d * 8 + 2 * t;
        *reinterpret_cast<float2*>(red + lr0 * LD + col) = make_float2(dk[4 * d], dk[4 * d + 1]);
        *reinterpret_cast<float2*>(red + lr1 * LD + col) = make_float2(dk[4 * d + 2], dk[4 * d + 3]);
        *reinterpret_cast<float2*>(rv + lr0 * LD + col) = make_float2(dv[4 * d], dv[4 * d + 1]);
        *reinterpret_cast<float2*>(rv + lr1 * LD + col) = make_float2(dv[4 * d + 2], dv[4 * d + 3]);
      }
      sm90::cluster_sync();
      constexpr int C4 = HD / 4;                 // float4s a row
      constexpr int N4 = 2 * kDkvRows * C4;      // over dk and dv
      const int lo = hg * N4 / group, hi = (hg + 1) * N4 / group;
      for (int i = lo + threadIdx.x; i < hi; i += 128) {
        const int tsel = i / (kDkvRows * C4), rem = i % (kDkvRows * C4);
        const int row = rem / C4, c4 = rem % C4;
        const float* src = red + tsel * kDkvRows * LD + row * LD + 4 * c4;
        float4 acc = sm90::ld_cluster_f4(src, 0);
        for (int r = 1; r < group; ++r) {
          const float4 x = sm90::ld_cluster_f4(src, r);
          acc.x += x.x;
          acc.y += x.y;
          acc.z += x.z;
          acc.w += x.w;
        }
        __nv_bfloat16* dst = (tsel ? p.dv : p.dk) +
            (((long long)b * p.Skv + kv0 + row) * p.KvH + kvh) * HD + 4 * c4;
        uint2 packed;
        packed.x = sm90::as_u32(__floats2bfloat162_rn(acc.x, acc.y));
        packed.y = sm90::as_u32(__floats2bfloat162_rn(acc.z, acc.w));
        *reinterpret_cast<uint2*>(dst) = packed;
      }
      sm90::cluster_sync();    // no CTA leaves while another reads it
    }
  }
}

// dk/dv = the per-q-head f32 partials summed over each group in q-head
// order, in bf16 (the path of groups larger than one cluster)
template <int HD>
__global__ void __launch_bounds__(256)
    dkv_group_sum_kernel(const float* part, __nv_bfloat16* dk,
                         __nv_bfloat16* dv, int B, int Skv, int H, int KvH) {
  constexpr int C4 = HD / 4;
  const int group = H / KvH;
  const long long n4 = (long long)B * Skv * KvH * C4;
  const long long plane = (long long)B * Skv * H * HD;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < 2 * n4; i += (long long)gridDim.x * blockDim.x) {
    const int tsel = (int)(i / n4);
    const long long j = i % n4;
    const int c4 = (int)(j % C4);
    const long long r = j / C4;                  // (b * Skv + s) * KvH + kvh
    const long long bs = r / KvH;
    const int kvh = (int)(r % KvH);
    const float* src = part + tsel * plane + (bs * H + (long long)kvh * group) * HD + 4 * c4;
    float4 acc = *reinterpret_cast<const float4*>(src);
    for (int hg = 1; hg < group; ++hg) {
      const float4 x = *reinterpret_cast<const float4*>(src + hg * HD);
      acc.x += x.x;
      acc.y += x.y;
      acc.z += x.z;
      acc.w += x.w;
    }
    uint2 packed;
    packed.x = sm90::as_u32(__floats2bfloat162_rn(acc.x, acc.y));
    packed.y = sm90::as_u32(__floats2bfloat162_rn(acc.z, acc.w));
    *reinterpret_cast<uint2*>((tsel ? dv : dk) + r * HD + 4 * c4) = packed;
  }
}

using DkvFn = void (*)(DkvParams);

struct DkvInstance {
  DkvFn fn;
  int smem;
  cudaError_t smem_set;   // setting the dynamic shared memory, once
};

template <int HD, int BQ>
DkvInstance dkv_inst() {
  static const cudaError_t smem_set = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<HD, BQ>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, DkvSmem<HD, BQ>::kBytes);
  return {flash_bwd_dkv_kernel<HD, BQ>, DkvSmem<HD, BQ>::kBytes, smem_set};
}

DkvInstance pick_dkv(int hd, int blk_q) {
  if (hd == 64 && blk_q == 32) return dkv_inst<64, 32>();
  if (hd == 64 && blk_q == 64) return dkv_inst<64, 64>();
  if (hd == 128 && blk_q == 32) return dkv_inst<128, 32>();
  if (hd == 128 && blk_q == 64) return dkv_inst<128, 64>();
  return {nullptr, 0, cudaSuccess};
}

cudaLaunchConfig_t dkv_config(const DkvInstance& in, dim3 grid, int cluster,
                              cudaLaunchAttribute* attr, void* stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(128);
  cfg.dynamicSmemBytes = in.smem;
  cfg.stream = (cudaStream_t)stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

extern "C" {

// dq = flash_bwd_dq(q, k, v, dout, lse, delta) on `stream`: blk_q query
// rows a CTA (a multiple of 16 up to 128), blk_kv (32 or 64) kv rows a
// step. Strides are in elements; every row's last axis is contiguous and
// 16-byte aligned (the wrapper checks). Returns cudaGetLastError().
int flash_bwd_dq_launch(int hd, int blk_q, int blk_kv, int causal,
                        const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* delta,
                        void* dq, int B, int H, int KvH, int Sq, int Skv,
                        long long q_sb, long long q_ss, long long q_sh,
                        long long k_sb, long long k_ss, long long k_sh,
                        long long v_sb, long long v_ss, long long v_sh,
                        long long o_sb, long long o_ss, long long o_sh,
                        float scale, void* stream) {
  Params p{static_cast<const __nv_bfloat16*>(q),
           static_cast<const __nv_bfloat16*>(k),
           static_cast<const __nv_bfloat16*>(v),
           static_cast<const __nv_bfloat16*>(dout),
           static_cast<const float*>(lse), static_cast<const float*>(delta),
           static_cast<__nv_bfloat16*>(dq), nullptr, nullptr,
           q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
           o_sb, o_ss, o_sh, H, KvH, Sq, Skv, blk_q, causal, scale};
  KernelFn fn = pick(0, hd, blk_kv);
  if (fn == nullptr || blk_q % 16 != 0 || blk_q < 16 || blk_q > 128 ||
      Sq % blk_q != 0 || Skv % blk_kv != 0 || KvH <= 0 || H % KvH != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(2 * blk_q + 2 * blk_kv) * (hd + 8) * 2;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid(Sq / blk_q, B * H);
  fn<<<grid, 2 * blk_q, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// (dk, dv) = flash_bwd_dkv(q, k, v, dout, lse, delta): 64 kv rows (blk_kv)
// of one q head a CTA, blk_q (32 or 64) query rows a stage; each group of
// up to 8 q heads sums in a cluster. A larger group needs `part`, (2, B,
// Skv, H, Hd) f32 scratch, summed by a second kernel on the same stream.
int flash_bwd_dkv_launch(int hd, int blk_q, int blk_kv, int causal,
                         const void* q, const void* k, const void* v,
                         const void* dout, const void* lse, const void* delta,
                         void* dk, void* dv, void* part, int B, int H,
                         int KvH, int Sq, int Skv, long long q_sb,
                         long long q_ss, long long q_sh, long long k_sb,
                         long long k_ss, long long k_sh, long long v_sb,
                         long long v_ss, long long v_sh, long long o_sb,
                         long long o_ss, long long o_sh, float scale,
                         void* stream) {
  DkvInstance in = pick_dkv(hd, blk_q);
  if (in.fn == nullptr || blk_kv != kDkvRows || Sq % blk_q != 0 ||
      Skv % kDkvRows != 0 || KvH <= 0 || H % KvH != 0)
    return (int)cudaErrorInvalidValue;
  const int group = H / KvH;
  if (group > kMaxCluster && part == nullptr) return (int)cudaErrorInvalidValue;
  DkvParams p;
  int rc = sm90_host::encode_rows(&p.tm_q, q, B, Sq, H, hd, q_sb, q_ss, q_sh,
                                  blk_q);
  if (rc == 0)
    rc = sm90_host::encode_rows(&p.tm_do, dout, B, Sq, H, hd, o_sb, o_ss,
                                o_sh, blk_q);
  if (rc == 0)
    rc = sm90_host::encode_rows(&p.tm_k, k, B, Skv, KvH, hd, k_sb, k_ss,
                                k_sh, kDkvRows);
  if (rc == 0)
    rc = sm90_host::encode_rows(&p.tm_v, v, B, Skv, KvH, hd, v_sb, v_ss,
                                v_sh, kDkvRows);
  if (rc != 0) return rc;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  p.part = group > kMaxCluster ? static_cast<float*>(part) : nullptr;
  p.B = B;
  p.H = H;
  p.KvH = KvH;
  p.Sq = Sq;
  p.Skv = Skv;
  p.causal = causal;
  p.scale = scale;
  if (in.smem_set != cudaSuccess) return (int)in.smem_set;
  cudaError_t err;
  const dim3 grid(H, (Skv / kDkvRows) * B);
  if (p.part == nullptr) {
    cudaLaunchAttribute attr[1];
    cudaLaunchConfig_t cfg = dkv_config(in, grid, group, attr, stream);
    err = cudaLaunchKernelEx(&cfg, in.fn, p);
    if (err != cudaSuccess) return (int)err;
  } else {
    in.fn<<<grid, 128, in.smem, (cudaStream_t)stream>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const long long n = 2LL * B * Skv * KvH * (hd / 4);
    const int blocks = (int)((n + 255) / 256 < 65535 ? (n + 255) / 256 : 65535);
    if (hd == 64)
      dkv_group_sum_kernel<64><<<blocks, 256, 0, (cudaStream_t)stream>>>(
          p.part, p.dk, p.dv, B, Skv, H, KvH);
    else
      dkv_group_sum_kernel<128><<<blocks, 256, 0, (cudaStream_t)stream>>>(
          p.part, p.dk, p.dv, B, Skv, H, KvH);
  }
  return (int)cudaGetLastError();
}

// Registers a thread at launch and local (spilled) bytes of one instance:
// kind 0 is dq (inner = blk_kv), kind 1 is dkv (inner = blk_q).
int flash_bwd_func_attrs(int kind, int hd, int inner, int* regs,
                         int* local_bytes) {
  const void* fn = nullptr;
  if (kind == 0) fn = reinterpret_cast<const void*>(pick(0, hd, inner));
  if (kind == 1) fn = reinterpret_cast<const void*>(pick_dkv(hd, inner).fn);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  return 0;
}

// The most clusters of `group` dkv CTAs (hd, blk_q) the card holds at once
// (cudaOccupancyMaxActiveClusters), into *clusters.
int flash_bwd_dkv_occupancy(int hd, int blk_q, int group, int* clusters) {
  DkvInstance in = pick_dkv(hd, blk_q);
  if (in.fn == nullptr || group < 1 || group > kMaxCluster)
    return (int)cudaErrorInvalidValue;
  if (in.smem_set != cudaSuccess) return (int)in.smem_set;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg =
      dkv_config(in, dim3(group * 64, 1), group, attr, nullptr);
  return (int)cudaOccupancyMaxActiveClusters(clusters, in.fn, &cfg);
}

}  // extern "C"
