// Causal GQA flash-attention forward for NVIDIA Hopper (sm_90a).
//
// flash_fwd replaces src/repro/kernels/flash/flash.py::_kernel (:37), as
// launched by _fwd_with_stats (:220) and flash_attention_bhsd (:79), with
// the normalisation the JAX wrappers do outside the kernel (:119,
// :248-249) fused into the epilogue:
//   out = acc / max(l, 1e-30)             in q's dtype (bf16)
//   lse = m + log(max(l, 1e-30))          (B*H, Sq) f32, kept for the
//                                         training slice's backward
//
// What bounds it on this card. At the serving slice's prefill shapes
// (B=1, H=12, KvH=2, S <= 512, Hd=128) it moves ~3.7 MB and does ~0.8
// GFLOP: ~1 us of HBM time and ~1 us of tensor-core time, so a launch and
// its one wave of CTAs bound it (latency-bound). At S=4096 it does 51.6
// GFLOP of useful work (~52 us at 989 TFLOP/s bf16; ~78 us with the hi/lo
// split of P V) against ~26 MB, so it is bound by operations. What the
// design does about it: both products run on wgmma, the only path to the
// full tensor-core rate; the next K/V tile's TMA load overlaps this tile's
// math; no S x S score matrix reaches device memory; kv tiles above the
// causal diagonal are never loaded.
//
// Design (what the Pallas kernel computes, re-blocked for Hopper):
//   * grid (B*H, n_q): one CTA owns blk_q query rows of one head; q blocks
//     are issued heaviest (last) first, every head's before the next
//     lighter block. The Pallas sequential kv grid axis and its revisited
//     acc/l/m blocks become a loop inside the CTA; the causal skip
//     (pl.when, :72-74) is the loop's upper bound.
//   * roles: blk_q / 64 consumer warpgroups, each owning 64 query rows
//     (wgmma's M), and one producer warp (160 threads and two CTAs an SM
//     at blk_q 64, 288 and one at 128; 168 registers a thread at most,
//     what the SM's four register quarters give three warps each). The
//     producer's one thread loads the q tile once and then each kv step's
//     K and V tiles (blk_kv rows) into a 2-stage ring with TMA, handed
//     over by mbarriers (full: the bytes arrived; empty: every consumer
//     thread is done with the stage).
//   * GQA: head h reads kv head h / (H / KvH), as the index map at
//     :112-113; K/V are never replicated.
//   * the kernel reads q, k, v in the model's (B, S, H, Hd) layout through
//     4-D tensor maps (element strides, last axis contiguous, 16-byte
//     rows), 128-byte swizzled in 64-column slabs (sm90.cuh), and writes
//     out as a contiguous (B, Sq, H, Hd): no transposes around it.
//   * products: S = Q K^T is wgmma m64n{blk_kv}k16 with both operands
//     K-major in shared memory: exact products of bf16 summed in f32, as
//     the Pallas kernel's f32 dot of bf16-valued operands. O += P V takes
//     P from registers (the S accumulator re-packed as the A operand) and
//     V MN-major from shared memory; the f32 probabilities are split into
//     a bf16 high part and a bf16 low part (p - hi) and both are
//     multiplied, so p keeps ~16 bits as the Pallas kernel's f32 p does.
//   * the scale (Hd^-0.5), the causal mask with NEG_INF = -1e30 (:55-59,
//     applied only on tiles that cross the diagonal) and the online-softmax
//     update m, corr, l, acc (:61-70) are f32, with expf/logf and IEEE
//     division (built without --use_fast_math). A consumer whose 64 rows
//     lie wholly above a tile's columns skips the tile (it would add
//     exactly nothing).
//
// Instances: Hd in {64, 128} x blk_q in {64, 128} x blk_kv in {64, 128}.
// Threads 2 blk_q + 32. Dynamic shared memory (blk_q + 4 blk_kv) Hd x 2
// bytes plus 1 KiB to align the tiles to 1024 bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kStages = 2;
constexpr int kAlign = 1024;

struct Params {
  CUtensorMap tm_q, tm_k, tm_v;   // 4-D (hd, heads, S, B) maps
  __nv_bfloat16* out;             // (B, Sq, H, Hd) contiguous
  float* lse;                     // (B*H, Sq)
  int H, KvH, Sq, Skv, causal;
  float scale;
};

template <int HD, int BQ, int BKV>
struct Smem {
  static constexpr int kQ = BQ * HD;          // bf16 elements
  static constexpr int kKV = BKV * HD;
  static constexpr int kTiles = (kQ + kStages * 2 * kKV) * 2;   // bytes
  static constexpr int kBytes = kTiles + 64 + kAlign;           // + barriers
};

template <int HD, int BQ, int BKV>
__global__ void __launch_bounds__(2 * BQ + 32, BQ == 64 ? 2 : 1)
    flash_fwd_kernel(const __grid_constant__ Params p) {
  using namespace sm90;
  using S = Smem<HD, BQ, BKV>;
  constexpr int NWG = BQ / 64;          // consumer warpgroups
  constexpr int NT = BKV / 8;           // 8-column blocks of a score tile
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + kAlign - 1) &
      ~uintptr_t(kAlign - 1));
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(base);
  __nv_bfloat16* kv_s = q_s + S::kQ;    // stage st: K at 2 st, V at 2 st + 1
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + S::kTiles);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + kStages;

  const int bh = blockIdx.x;
  const int qi = gridDim.y - 1 - blockIdx.y;    // heaviest q blocks first
  const int b = bh / p.H, h = bh % p.H;
  const int kvh = h / (p.H / p.KvH);
  const int q0 = qi * BQ;
  const int n_kv = p.Skv / BKV;
  const int kv_end = p.causal ? min(n_kv, (q0 + BQ - 1) / BKV + 1) : n_kv;
  // the warpgroup, read through a shuffle so the compiler sees it is
  // uniform across the warp
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NWG * 128);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == NWG) {
    // ---- producer warp: one thread issues every load
    if (threadIdx.x == NWG * 128) {
      mbar_expect_tx(q_full, S::kQ * 2);
      tma_load_rows<HD>(q_s, &p.tm_q, q_full, BQ, h, q0, b);
      for (int j = 0; j < kv_end; ++j) {
        const int st = j % kStages, ph = (j / kStages) & 1;
        mbar_wait(&empty[st], ph ^ 1);
        mbar_expect_tx(&full[st], 2 * S::kKV * 2);
        tma_load_rows<HD>(kv_s + 2 * st * S::kKV, &p.tm_k, &full[st], BKV,
                          kvh, j * BKV, b);
        tma_load_rows<HD>(kv_s + (2 * st + 1) * S::kKV, &p.tm_v, &full[st],
                          BKV, kvh, j * BKV, b);
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each
    const int w = warp & 3;
    const int g = lane >> 2, t = lane & 3;
    const int r0 = q0 + wg * 64;                  // first row of this WG
    const int qpos0 = r0 + w * 16 + g, qpos1 = qpos0 + 8;
    const __nv_bfloat16* qa = q_s + wg * 64 * 64; // this WG's rows, slab 0

    float o[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
    float m_r[2] = {kNegInf, kNegInf};
    float l_r[2] = {0.f, 0.f};

    mbar_wait(q_full, 0);
    for (int j = 0; j < kv_end; ++j) {
      const int st = j % kStages, ph = (j / kStages) & 1;
      const int kv0 = j * BKV;
      mbar_wait(&full[st], ph);
      if (p.causal && kv0 > r0 + 63) {    // wholly above this WG's rows
        mbar_arrive(&empty[st]);
        continue;
      }
      const __nv_bfloat16* k_t = kv_s + 2 * st * S::kKV;
      const __nv_bfloat16* v_t = k_t + S::kKV;

      // ---- S = Q K^T: 64 rows x BKV columns
      float s[BKV / 2];
#pragma unroll
      for (int i = 0; i < BKV / 2; ++i) s[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss<0>(s, desc_kmajor(qa, BQ, kk), desc_kmajor(k_t, BKV, kk), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);

      // ---- scale, causal mask, online softmax (rows qpos0 and qpos1)
      const bool masked = p.causal && (kv0 + BKV - 1 > r0 + w * 16);
      float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float val = s[4 * n + e] * p.scale;
          if (masked) {
            const int col = kv0 + n * 8 + 2 * t + (e & 1);
            if (col > (e < 2 ? qpos0 : qpos1)) val = kNegInf;
          }
          s[4 * n + e] = val;
        }
        mx0 = fmaxf(mx0, fmaxf(s[4 * n], s[4 * n + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[4 * n + 2], s[4 * n + 3]));
      }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float mn0 = fmaxf(m_r[0], mx0), mn1 = fmaxf(m_r[1], mx1);
      const float corr0 = expf(m_r[0] - mn0), corr1 = expf(m_r[1] - mn1);
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        s[4 * n] = expf(s[4 * n] - mn0);
        s[4 * n + 1] = expf(s[4 * n + 1] - mn0);
        s[4 * n + 2] = expf(s[4 * n + 2] - mn1);
        s[4 * n + 3] = expf(s[4 * n + 3] - mn1);
        sum0 += s[4 * n] + s[4 * n + 1];
        sum1 += s[4 * n + 2] + s[4 * n + 3];
      }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        sum0 += __shfl_xor_sync(0xffffffffu, sum0, off);
        sum1 += __shfl_xor_sync(0xffffffffu, sum1, off);
      }
      l_r[0] = l_r[0] * corr0 + sum0;
      l_r[1] = l_r[1] * corr1 + sum1;
      m_r[0] = mn0;
      m_r[1] = mn1;
#pragma unroll
      for (int d = 0; d < HD / 8; ++d) {
        o[4 * d] *= corr0;
        o[4 * d + 1] *= corr0;
        o[4 * d + 2] *= corr1;
        o[4 * d + 3] *= corr1;
      }

      // ---- O += P V, P split into bf16 hi + lo
      uint32_t ph_a[BKV / 16][4], pl_a[BKV / 16][4];
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) split_a(s, kk, ph_a[kk], pl_a[kk]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) {
        const uint64_t bv = desc_mnmajor(v_t, BKV, kk);
        wgmma_rs<1>(o, ph_a[kk], bv, 1);
        wgmma_rs<1>(o, pl_a[kk], bv, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      mbar_arrive(&empty[st]);
    }

    // ---- epilogue: out = acc / max(l, 1e-30) in bf16;
    //      lse = m + log(max(l, 1e-30))
    const float den0 = fmaxf(l_r[0], 1e-30f), den1 = fmaxf(l_r[1], 1e-30f);
    __nv_bfloat16* out0 =
        p.out + ((long long)(b * p.Sq + qpos0) * p.H + h) * HD;
    __nv_bfloat16* out1 =
        p.out + ((long long)(b * p.Sq + qpos1) * p.H + h) * HD;
#pragma unroll
    for (int d = 0; d < HD / 8; ++d) {
      const int col = d * 8 + 2 * t;
      *reinterpret_cast<__nv_bfloat162*>(out0 + col) =
          __floats2bfloat162_rn(o[4 * d] / den0, o[4 * d + 1] / den0);
      *reinterpret_cast<__nv_bfloat162*>(out1 + col) =
          __floats2bfloat162_rn(o[4 * d + 2] / den1, o[4 * d + 3] / den1);
    }
    if (t == 0) {
      p.lse[(long long)bh * p.Sq + qpos0] = m_r[0] + logf(den0);
      p.lse[(long long)bh * p.Sq + qpos1] = m_r[1] + logf(den1);
    }
  }
}

using KernelFn = void (*)(Params);

struct Instance {
  KernelFn fn;
  int smem;
  cudaError_t smem_set;   // setting the dynamic shared memory, once
};

template <int HD, int BQ, int BKV>
Instance inst() {
  static const cudaError_t smem_set = cudaFuncSetAttribute(
      flash_fwd_kernel<HD, BQ, BKV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<HD, BQ, BKV>::kBytes);
  return {flash_fwd_kernel<HD, BQ, BKV>, Smem<HD, BQ, BKV>::kBytes, smem_set};
}

Instance pick(int hd, int blk_q, int blk_kv) {
#define FLASH_FWD_CASE(HD_, BQ_, BKV_) \
  if (hd == HD_ && blk_q == BQ_ && blk_kv == BKV_) return inst<HD_, BQ_, BKV_>();
  FLASH_FWD_CASE(64, 64, 64)
  FLASH_FWD_CASE(64, 64, 128)
  FLASH_FWD_CASE(64, 128, 64)
  FLASH_FWD_CASE(64, 128, 128)
  FLASH_FWD_CASE(128, 64, 64)
  FLASH_FWD_CASE(128, 64, 128)
  FLASH_FWD_CASE(128, 128, 64)
  FLASH_FWD_CASE(128, 128, 128)
#undef FLASH_FWD_CASE
  return {nullptr, 0, cudaSuccess};
}

// The grid of a launch: one CTA per (batch x head, blk_q query rows).
dim3 grid_of(int B, int H, int Sq, int blk_q) {
  return dim3(B * H, Sq / blk_q);
}

}  // namespace

extern "C" {

// Launch flash_fwd on `stream`. Strides are in elements; q/k/v's last axis
// is contiguous and every row starts on a 16-byte boundary (the wrapper
// checks both). Returns cudaGetLastError() (0 when the launch was
// accepted); cudaErrorInvalidValue for an unsupported (hd, blk_q, blk_kv)
// or shape.
int flash_fwd_launch(int hd, int blk_q, int blk_kv, int causal,
                     const void* q, const void* k, const void* v, void* out,
                     void* lse, int B, int H, int KvH, int Sq, int Skv,
                     long long q_sb, long long q_ss, long long q_sh,
                     long long k_sb, long long k_ss, long long k_sh,
                     long long v_sb, long long v_ss, long long v_sh,
                     float scale, void* stream) {
  Instance in = pick(hd, blk_q, blk_kv);
  if (in.fn == nullptr || Sq % blk_q != 0 || Skv % blk_kv != 0 || KvH <= 0 ||
      H % KvH != 0)
    return (int)cudaErrorInvalidValue;
  Params p;
  int rc = sm90_host::encode_rows(&p.tm_q, q, B, Sq, H, hd, q_sb, q_ss, q_sh,
                                  blk_q);
  if (rc == 0)
    rc = sm90_host::encode_rows(&p.tm_k, k, B, Skv, KvH, hd, k_sb, k_ss, k_sh,
                                blk_kv);
  if (rc == 0)
    rc = sm90_host::encode_rows(&p.tm_v, v, B, Skv, KvH, hd, v_sb, v_ss, v_sh,
                                blk_kv);
  if (rc != 0) return rc;
  p.out = static_cast<__nv_bfloat16*>(out);
  p.lse = static_cast<float*>(lse);
  p.H = H;
  p.KvH = KvH;
  p.Sq = Sq;
  p.Skv = Skv;
  p.causal = causal;
  p.scale = scale;
  if (in.smem_set != cudaSuccess) return (int)in.smem_set;
  in.fn<<<grid_of(B, H, Sq, blk_q), 2 * blk_q + 32, in.smem,
          (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// The shape flash_fwd_launch gives a launch: the instance's dynamic shared
// memory, its static shared memory (cudaFuncGetAttributes) and the grid's
// blocks. Launches nothing.
int flash_launch_shape(int hd, int blk_q, int blk_kv, int B, int H, int Sq,
                       long long* dynamic_bytes, long long* static_bytes,
                       long long* blocks) {
  Instance in = pick(hd, blk_q, blk_kv);
  if (in.fn == nullptr || Sq % blk_q != 0) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, in.fn);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid = grid_of(B, H, Sq, blk_q);
  *dynamic_bytes = in.smem;
  *static_bytes = (long long)attr.sharedSizeBytes;
  *blocks = (long long)grid.x * grid.y * grid.z;
  return 0;
}

// Registers a thread at launch and local (spilled) bytes of one instance,
// as the compiler laid it out.
int flash_func_attrs(int hd, int blk_q, int blk_kv, int* regs,
                     int* local_bytes) {
  Instance in = pick(hd, blk_q, blk_kv);
  if (in.fn == nullptr) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, in.fn);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  return 0;
}

}  // extern "C"
