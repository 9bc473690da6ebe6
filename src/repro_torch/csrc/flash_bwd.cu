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
// does 12.9 GFLOP (13.1 us) against ~34 MB (10.1 us): bound by operations.
// Both are ~1 ms of a training step that takes hundreds, so the design
// aims at exactness first: no S x S matrix reaches device memory, every
// sum is kept in registers until one bf16 store, and the products that
// take an f32 operand split it into a bf16 high and low part.
//
// Design (what the Pallas kernels compute, re-blocked for Hopper):
//   * flash_bwd_dq: grid (Sq / blk_q, B*H), one CTA owns blk_q query rows
//     of one head (blk_q / 16 warps, warp w owns rows 16w..16w+15). The
//     Pallas kv grid axis with its revisited dq block becomes a loop over
//     kv blocks of BKV rows inside the CTA; the causal skip (pl.when,
//     :175) is the loop's bound. The q and dout tiles stay in shared
//     memory; each kv step stages one K and one V tile. dq accumulates in
//     f32 registers and is written once, in bf16 (the JAX cast at :311).
//   * flash_bwd_dkv: grid (Skv / blk_kv, B*KvH), one CTA owns blk_kv rows
//     of one KV head and loops over the group's q heads and, per head,
//     over the q blocks of BQ rows from the diagonal on. So the JAX
//     package's (BH, S, Hd) f32 per-q-head partials and their group sum
//     go away: dk and dv of the kv head accumulate in f32 registers, with
//     no atomics and no second pass, and the result is the same from run
//     to run. The warp computes the transposed products (s^T = k q^T,
//     dp^T = v dout^T) so that its accumulator rows are kv rows.
//   * products: mma.sync.aligned.m16n8k16 bf16 x bf16 -> f32. q k^T and
//     dout v^T take bf16 operands whose products are exact in f32, as the
//     Pallas f32 dots of bf16-valued operands. ds k, p^T dout and ds^T q
//     take an f32 operand (ds or p): it is split into hi = bf16(x) and
//     lo = bf16(x - hi) and both are multiplied (one extra mma), so it
//     keeps ~16 bits; a plain bf16 cast would sit ~2^-9 away.
//   * the arithmetic order of the Pallas kernels: s * scale, the mask,
//     exp(s - lse), p * (dp - D) * scale, in f32 with expf (built without
//     --use_fast_math).
//   * q, k, v and dout are read in the model's (B, S, heads, Hd) layout
//     through element strides (the last axis contiguous); dq, dk and dv
//     are written contiguous.
//
// Instances: Hd in {64, 128} x the inner block (BKV for dq, BQ for dkv)
// in {32, 64}; the outer block (blk_q for dq, blk_kv for dkv) in 16..128
// by 16s at run time, blockDim.x = 2 * outer block.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// (x, y) -> hi = bf16(x, y), lo = bf16(x - hi.x, y - hi.y); x in the low half
__device__ __forceinline__ void split2(float x, float y, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(x - __low2float(h), y - __high2float(h)));
}

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

// ---------------------------------------------------------------------------
// dk, dv: one CTA per (kv block, batch * kv head)
// ---------------------------------------------------------------------------

template <int HD, int BQ>
__global__ void __launch_bounds__(256) flash_bwd_dkv_kernel(Params p) {
  constexpr int LD = HD + 8;
  constexpr int NT = BQ / 8;
  constexpr int DT = HD / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int blk_kv = p.blk;
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* v_s = k_s + blk_kv * LD;
  __nv_bfloat16* q_s = v_s + blk_kv * LD;
  __nv_bfloat16* o_s = q_s + BQ * LD;
  float* lse_s = reinterpret_cast<float*>(o_s + BQ * LD);
  float* dd_s = lse_s + BQ;

  const int kj = blockIdx.x;          // low kv blocks see the most q blocks
  const int bkv = blockIdx.y;
  const int b = bkv / p.KvH, kvh = bkv % p.KvH;
  const int group = p.H / p.KvH;
  const int kv0 = kj * blk_kv;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = warp * 16;
  const int kpos0 = kv0 + row0 + g, kpos1 = kpos0 + 8;

  stage<HD>(k_s, p.k + b * p.k_sb + kvh * p.k_sh + (long long)kv0 * p.k_ss,
            p.k_ss, blk_kv, tid, nthr);
  stage<HD>(v_s, p.v + b * p.v_sb + kvh * p.v_sh + (long long)kv0 * p.v_ss,
            p.v_ss, blk_kv, tid, nthr);

  float dk[DT][4], dv[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[d][e] = dv[d][e] = 0.f;

  const int n_q = p.Sq / BQ;
  const int qi_start = p.causal ? kv0 / BQ : 0;
  for (int hg = 0; hg < group; ++hg) {
    const int h = kvh * group + hg;
    const long long bh = (long long)b * p.H + h;
    const __nv_bfloat16* qg = p.q + b * p.q_sb + h * p.q_sh;
    const __nv_bfloat16* og = p.dout + b * p.o_sb + h * p.o_sh;
    for (int qi = qi_start; qi < n_q; ++qi) {
      const int q0 = qi * BQ;
      __syncthreads();  // the previous q/dout tiles are consumed
      stage<HD>(q_s, qg + (long long)q0 * p.q_ss, p.q_ss, BQ, tid, nthr);
      stage<HD>(o_s, og + (long long)q0 * p.o_ss, p.o_ss, BQ, tid, nthr);
      for (int c = tid; c < BQ; c += nthr) {
        lse_s[c] = p.lse[bh * p.Sq + q0 + c];
        dd_s[c] = p.delta[bh * p.Sq + q0 + c];
      }
      __syncthreads();

      // s^T = k q^T and dp^T = v dout^T: this warp's 16 kv rows x BQ q columns
      float s[NT][4], dp[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        uint32_t ak[4], av[4];
        load_a(ak, k_s, LD, row0, kk, g, t);
        load_a(av, v_s, LD, row0, kk, g, t);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          uint32_t bq[2], bo[2];
          load_b_rows(bq, q_s, LD, n * 8, kk * 16, g, t);
          load_b_rows(bo, o_s, LD, n * 8, kk * 16, g, t);
          mma_bf16(s[n], ak, bq);
          mma_bf16(dp[n], av, bo);
        }
      }
      // p^T (kept in s) and ds^T (kept in dp); column c is query q0 + c
      const bool masked = p.causal && (q0 < kv0 + row0 + 15);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = n * 8 + 2 * t + (e & 1);
          float pr = expf(s[n][e] * p.scale - lse_s[c]);
          if (masked && q0 + c < (e >= 2 ? kpos1 : kpos0)) pr = 0.f;
          s[n][e] = pr;
          dp[n][e] = pr * (dp[n][e] - dd_s[c]) * p.scale;
        }
      }
      // dv += p^T dout, dk += ds^T q
      mma_f32a<HD, BQ / 16>(dv, s, o_s, LD, g, t);
      mma_f32a<HD, BQ / 16>(dk, dp, q_s, LD, g, t);
    }
  }

  const long long r0 = ((long long)(b * p.Skv + kpos0) * p.KvH + kvh) * HD;
  const long long r1 = ((long long)(b * p.Skv + kpos1) * p.KvH + kvh) * HD;
#pragma unroll
  for (int d = 0; d < DT; ++d) {
    const int col = d * 8 + 2 * t;
    *reinterpret_cast<__nv_bfloat162*>(p.dk + r0 + col) =
        __floats2bfloat162_rn(dk[d][0], dk[d][1]);
    *reinterpret_cast<__nv_bfloat162*>(p.dk + r1 + col) =
        __floats2bfloat162_rn(dk[d][2], dk[d][3]);
    *reinterpret_cast<__nv_bfloat162*>(p.dv + r0 + col) =
        __floats2bfloat162_rn(dv[d][0], dv[d][1]);
    *reinterpret_cast<__nv_bfloat162*>(p.dv + r1 + col) =
        __floats2bfloat162_rn(dv[d][2], dv[d][3]);
  }
}

using KernelFn = void (*)(Params);

// kind 0: dq (inner = BKV); kind 1: dkv (inner = BQ)
KernelFn pick(int kind, int hd, int inner) {
  if (kind == 0) {
    if (hd == 64 && inner == 32) return flash_bwd_dq_kernel<64, 32>;
    if (hd == 64 && inner == 64) return flash_bwd_dq_kernel<64, 64>;
    if (hd == 128 && inner == 32) return flash_bwd_dq_kernel<128, 32>;
    if (hd == 128 && inner == 64) return flash_bwd_dq_kernel<128, 64>;
  } else if (kind == 1) {
    if (hd == 64 && inner == 32) return flash_bwd_dkv_kernel<64, 32>;
    if (hd == 64 && inner == 64) return flash_bwd_dkv_kernel<64, 64>;
    if (hd == 128 && inner == 32) return flash_bwd_dkv_kernel<128, 32>;
    if (hd == 128 && inner == 64) return flash_bwd_dkv_kernel<128, 64>;
  }
  return nullptr;
}

int launch(int kind, int hd, int outer, int inner, int n_outer_rows,
           int n_inner_rows, int grid_y, const Params& p, void* stream) {
  KernelFn fn = pick(kind, hd, inner);
  if (fn == nullptr || outer % 16 != 0 || outer < 16 || outer > 128 ||
      n_outer_rows % outer != 0 || n_inner_rows % inner != 0 ||
      p.KvH <= 0 || p.H % p.KvH != 0)
    return (int)cudaErrorInvalidValue;
  size_t smem = (size_t)(2 * outer + 2 * inner) * (hd + 8) * 2;
  if (kind == 1) smem += 2 * inner * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid(n_outer_rows / outer, grid_y);
  fn<<<grid, 2 * outer, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
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
  return launch(0, hd, blk_q, blk_kv, Sq, Skv, B * H, p, stream);
}

// (dk, dv) = flash_bwd_dkv(q, k, v, dout, lse, delta): blk_kv kv rows a
// CTA (a multiple of 16 up to 128), blk_q (32 or 64) query rows a step,
// over every q head of the kv head's group.
int flash_bwd_dkv_launch(int hd, int blk_q, int blk_kv, int causal,
                         const void* q, const void* k, const void* v,
                         const void* dout, const void* lse, const void* delta,
                         void* dk, void* dv, int B, int H, int KvH, int Sq,
                         int Skv, long long q_sb, long long q_ss,
                         long long q_sh, long long k_sb, long long k_ss,
                         long long k_sh, long long v_sb, long long v_ss,
                         long long v_sh, long long o_sb, long long o_ss,
                         long long o_sh, float scale, void* stream) {
  Params p{static_cast<const __nv_bfloat16*>(q),
           static_cast<const __nv_bfloat16*>(k),
           static_cast<const __nv_bfloat16*>(v),
           static_cast<const __nv_bfloat16*>(dout),
           static_cast<const float*>(lse), static_cast<const float*>(delta),
           nullptr, static_cast<__nv_bfloat16*>(dk),
           static_cast<__nv_bfloat16*>(dv),
           q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
           o_sb, o_ss, o_sh, H, KvH, Sq, Skv, blk_kv, causal, scale};
  return launch(1, hd, blk_kv, blk_q, Skv, Sq, B * KvH, p, stream);
}

// Registers a thread and local (spilled) bytes of one instance: kind 0 is
// dq (inner = blk_kv), kind 1 is dkv (inner = blk_q).
int flash_bwd_func_attrs(int kind, int hd, int inner, int* regs,
                         int* local_bytes) {
  KernelFn fn = pick(kind, hd, inner);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  return 0;
}

}  // extern "C"
