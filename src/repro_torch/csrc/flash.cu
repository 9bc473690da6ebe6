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
// its few waves of blocks bound it (launch-bound). At S=4096 it does 51.6
// GFLOP of useful work (~52 us at 989 TFLOP/s bf16) against ~26 MB, so
// it is bound by operations. What the design does about it: no S x S
// score matrix ever reaches device memory — each block keeps its 16-row
// score tiles in registers, K/V tiles in shared memory, and writes only
// out and lse; blocks above the causal diagonal are never visited.
//
// Design (what the Pallas kernel computes, re-blocked for Hopper):
//   * grid (n_q, B*H): one block owns blk_q query rows of one head; the
//     Pallas sequential kv grid axis and its revisited acc/l/m blocks
//     become a loop inside the block, so nothing carries between blocks.
//     The causal skip (pl.when, :72-74) is the loop's upper bound. q
//     blocks are issued heaviest (last) first.
//   * GQA: head h reads kv head h / (H / KvH), as the index map at
//     :112-113; K/V are never replicated.
//   * the kernel reads q, k, v in the model's (B, S, H, Hd) layout through
//     element strides (the last axis contiguous), and writes out as a
//     contiguous (B, Sq, H, Hd): no transposes around it.
//   * blk_q/16 warps; warp w owns rows 16w..16w+15 of the q tile. The q
//     tile, and per kv step one K and one V tile of BKV x Hd bf16, are
//     staged in shared memory with 16-byte loads (rows padded by 8 bf16 so
//     the fragment loads hit 32 distinct banks).
//   * products: mma.sync.aligned.m16n8k16 bf16 x bf16 -> f32. S = Q K^T
//     is exact products of bf16 summed in f32, as the Pallas kernel's f32
//     dot of bf16-valued operands. For P V the f32 probabilities are split
//     into a bf16 high part and a bf16 low part (p - hi) and both are
//     multiplied, so p keeps ~16 bits as the Pallas kernel's f32 p does
//     (one extra mma per P V product).
//   * the scale (Hd^-0.5), the causal mask with NEG_INF = -1e30 (:55-59)
//     and the online-softmax update m, corr, l, acc (:61-70) are f32, with
//     expf/logf and IEEE division (built without --use_fast_math).
//
// Instances: Hd in {64, 128} x BKV in {32, 64, 128}; blk_q in {16, 32,
// 64, 128} at run time (blockDim.x = 2 * blk_q). Dynamic shared memory:
// (blk_q + 2 * BKV) * (Hd + 8) * 2 bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* out;   // (B, Sq, H, Hd) contiguous
  float* lse;           // (B*H, Sq)
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  int H, KvH, Sq, Skv, blk_q, causal;
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

template <int HD, int BKV>
__global__ void __launch_bounds__(256) flash_fwd_kernel(Params p) {
  constexpr int LD = HD + 8;      // padded smem row, in bf16
  constexpr int CH = HD / 8;      // 16-byte chunks a row
  constexpr int NT = BKV / 8;     // 8-column score tiles a warp holds
  constexpr int DT = HD / 8;      // 8-column output tiles a warp holds
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* k_s = q_s + p.blk_q * LD;
  __nv_bfloat16* v_s = k_s + BKV * LD;

  const int qi = gridDim.x - 1 - blockIdx.x;     // heaviest q blocks first
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int kvh = h / (p.H / p.KvH);
  const int q0 = qi * p.blk_q;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = warp * 16;                   // first row of this warp
  const int qpos0 = q0 + row0 + g, qpos1 = qpos0 + 8;

  const __nv_bfloat16* qg = p.q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kg = p.k + b * p.k_sb + kvh * p.k_sh;
  const __nv_bfloat16* vg = p.v + b * p.v_sb + kvh * p.v_sh;

  for (int c = tid; c < p.blk_q * CH; c += nthr) {
    const int r = c / CH, col = (c % CH) * 8;
    *reinterpret_cast<uint4*>(q_s + r * LD + col) =
        *reinterpret_cast<const uint4*>(qg + (long long)(q0 + r) * p.q_ss + col);
  }

  float o[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[d][e] = 0.f;
  float m_r[2] = {kNegInf, kNegInf};
  float l_r[2] = {0.f, 0.f};

  const int n_kv = p.Skv / BKV;
  const int kv_end =
      p.causal ? min(n_kv, (q0 + p.blk_q - 1) / BKV + 1) : n_kv;

  for (int j = 0; j < kv_end; ++j) {
    const int kv0 = j * BKV;
    __syncthreads();    // the previous tiles are consumed (and q_s stored)
    for (int c = tid; c < BKV * CH; c += nthr) {
      const int r = c / CH, col = (c % CH) * 8;
      *reinterpret_cast<uint4*>(k_s + r * LD + col) =
          *reinterpret_cast<const uint4*>(kg + (long long)(kv0 + r) * p.k_ss + col);
      *reinterpret_cast<uint4*>(v_s + r * LD + col) =
          *reinterpret_cast<const uint4*>(vg + (long long)(kv0 + r) * p.v_ss + col);
    }
    __syncthreads();

    // ---- S = Q K^T over this warp's 16 rows x BKV columns
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const __nv_bfloat16* qa = q_s + (row0 + g) * LD + kk * 16 + 2 * t;
      uint32_t a[4];
      a[0] = *reinterpret_cast<const uint32_t*>(qa);
      a[1] = *reinterpret_cast<const uint32_t*>(qa + 8 * LD);
      a[2] = *reinterpret_cast<const uint32_t*>(qa + 8);
      a[3] = *reinterpret_cast<const uint32_t*>(qa + 8 * LD + 8);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const __nv_bfloat16* kb = k_s + (n * 8 + g) * LD + kk * 16 + 2 * t;
        uint32_t bb[2];
        bb[0] = *reinterpret_cast<const uint32_t*>(kb);
        bb[1] = *reinterpret_cast<const uint32_t*>(kb + 8);
        mma_bf16(s[n], a, bb);
      }
    }

    // ---- scale, causal mask, online softmax (rows qpos0 and qpos1)
    const bool masked = p.causal && (kv0 + BKV - 1 > q0 + row0);
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float val = s[n][e] * p.scale;
        if (masked) {
          const int col = kv0 + n * 8 + 2 * t + (e & 1);
          if (col > (e < 2 ? qpos0 : qpos1)) val = kNegInf;
        }
        s[n][e] = val;
      }
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
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
      s[n][0] = expf(s[n][0] - mn0);
      s[n][1] = expf(s[n][1] - mn0);
      s[n][2] = expf(s[n][2] - mn1);
      s[n][3] = expf(s[n][3] - mn1);
      sum0 += s[n][0] + s[n][1];
      sum1 += s[n][2] + s[n][3];
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
    for (int d = 0; d < DT; ++d) {
      o[d][0] *= corr0;
      o[d][1] *= corr0;
      o[d][2] *= corr1;
      o[d][3] *= corr1;
    }

    // ---- O += P V, P split into bf16 hi + lo
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      uint32_t ah[4], al[4];
      split2(s[2 * kk][0], s[2 * kk][1], ah[0], al[0]);
      split2(s[2 * kk][2], s[2 * kk][3], ah[1], al[1]);
      split2(s[2 * kk + 1][0], s[2 * kk + 1][1], ah[2], al[2]);
      split2(s[2 * kk + 1][2], s[2 * kk + 1][3], ah[3], al[3]);
      const __nv_bfloat16* vb = v_s + (kk * 16 + 2 * t) * LD + g;
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        const __nv_bfloat16* vd = vb + d * 8;
        uint32_t bb[2];
        bb[0] = pack2(vd[0], vd[LD]);
        bb[1] = pack2(vd[8 * LD], vd[9 * LD]);
        mma_bf16(o[d], ah, bb);
        mma_bf16(o[d], al, bb);
      }
    }
  }

  // ---- epilogue: out = acc / max(l, 1e-30) in bf16; lse = m + log(max(l, 1e-30))
  const float den0 = fmaxf(l_r[0], 1e-30f), den1 = fmaxf(l_r[1], 1e-30f);
  __nv_bfloat16* out0 = p.out + ((long long)(b * p.Sq + qpos0) * p.H + h) * HD;
  __nv_bfloat16* out1 = p.out + ((long long)(b * p.Sq + qpos1) * p.H + h) * HD;
#pragma unroll
  for (int d = 0; d < DT; ++d) {
    const int col = d * 8 + 2 * t;
    *reinterpret_cast<__nv_bfloat162*>(out0 + col) =
        __floats2bfloat162_rn(o[d][0] / den0, o[d][1] / den0);
    *reinterpret_cast<__nv_bfloat162*>(out1 + col) =
        __floats2bfloat162_rn(o[d][2] / den1, o[d][3] / den1);
  }
  if (t == 0) {
    p.lse[(long long)bh * p.Sq + qpos0] = m_r[0] + logf(den0);
    p.lse[(long long)bh * p.Sq + qpos1] = m_r[1] + logf(den1);
  }
}

using KernelFn = void (*)(Params);

KernelFn pick(int hd, int blk_kv) {
  if (hd == 64) {
    if (blk_kv == 32) return flash_fwd_kernel<64, 32>;
    if (blk_kv == 64) return flash_fwd_kernel<64, 64>;
    if (blk_kv == 128) return flash_fwd_kernel<64, 128>;
  } else if (hd == 128) {
    if (blk_kv == 32) return flash_fwd_kernel<128, 32>;
    if (blk_kv == 64) return flash_fwd_kernel<128, 64>;
    if (blk_kv == 128) return flash_fwd_kernel<128, 128>;
  }
  return nullptr;
}

}  // namespace

extern "C" {

// Launch flash_fwd on `stream`. Strides are in elements; q/k/v's last axis
// is contiguous and every row starts on a 16-byte boundary (the wrapper
// checks both). Returns cudaGetLastError() (0 when the launch was
// accepted); cudaErrorInvalidValue for an unsupported (hd, blk_q, blk_kv).
int flash_fwd_launch(int hd, int blk_q, int blk_kv, int causal,
                     const void* q, const void* k, const void* v, void* out,
                     void* lse, int B, int H, int KvH, int Sq, int Skv,
                     long long q_sb, long long q_ss, long long q_sh,
                     long long k_sb, long long k_ss, long long k_sh,
                     long long v_sb, long long v_ss, long long v_sh,
                     float scale, void* stream) {
  KernelFn fn = pick(hd, blk_kv);
  if (fn == nullptr || blk_q % 16 != 0 || blk_q < 16 || blk_q > 128 ||
      Sq % blk_q != 0 || Skv % blk_kv != 0 || KvH <= 0 || H % KvH != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(blk_q + 2 * blk_kv) * (hd + 8) * 2;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  Params p{static_cast<const __nv_bfloat16*>(q),
           static_cast<const __nv_bfloat16*>(k),
           static_cast<const __nv_bfloat16*>(v),
           static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse),
           q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
           H, KvH, Sq, Skv, blk_q, causal, scale};
  dim3 grid(Sq / blk_q, B * H);
  fn<<<grid, 2 * blk_q, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// Registers a thread and local (spilled) bytes of one instance, as the
// compiler laid it out.
int flash_func_attrs(int hd, int blk_kv, int* regs, int* local_bytes) {
  KernelFn fn = pick(hd, blk_kv);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  return 0;
}

}  // extern "C"
