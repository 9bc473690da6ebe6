// GPP (General Plasmon Pole) kernels for NVIDIA Hopper (sm_90a).
//
// gpp_fused   (v9/v10) replaces src/repro/kernels/gpp/pallas_gpp.py::_kernel_fused
// gpp_banded  (v6-v8)  replaces src/repro/kernels/gpp/pallas_gpp.py::_kernel
// Both share band_sweep(), as the Pallas kernels share _band_sweep.
//
// What bounds them on this card: instruction issue, not bytes. At Si-214
// there are 1.72e10 (ig, igp, band, iw) terms against 210 MB of
// compulsory traffic, two orders of magnitude above the card's ridge. The
// SASS census of the band loop (repro_torch.core.sass; chip_smoke.py
// phase 2b) counts 95.5 instructions a term at one element a thread (the
// tuned config): 24 FFMA, 20 FMUL, 8 FADD, 2 MUFU, 15.5 selects and
// compares, 2.5 LDS, 9.5 integer and 12 control, an FMA ratio of 0.46;
// 89.5 of them issue when no reciprocal takes its slow path. Each IEEE
// 1.0f/x is 13 (see recip()). The first port's term took 111.5 (102.5 on
// the fast path), with three reciprocals. The kernel runs at ~86% of its
// fast-path issue bound (terms x instructions / (SMs x 4 schedulers x 32
// lanes x clock)).
//
// What the design does about it:
//   * every term's operands come from registers or shared memory: a thread
//     owns EPT (ig, igp) elements and keeps wtilde, eps, wtilde^2, Omega^2,
//     vcoul and the term's band invariants (14 floats an element) in
//     registers for its whole band sweep — the reuse the TPU kernel gets
//     from a VMEM-resident tile;
//   * per band chunk the block stages aqsn^T[band, ig-tile], aqsm[band,
//     igp-tile] and wx[band, :] in shared memory with one load per float;
//   * each thread accumulates 4*NW sums in registers; at the end a warp
//     shuffle plus shared-memory block reduction writes one (4, NW) partial
//     per block. There are no atomics, so a result repeats bit for bit; the
//     wrapper sums the partials.
//   * gpp_fused sweeps every band inside the block (the Pallas sequential
//     band axis and its scratch carry become this loop); gpp_banded sweeps
//     one band block per block and writes one partial per band block,
//     re-reading wtilde/eps per band block — the traffic v9 removes.
//   * TRANSPOSED=false reads aqsm from the (ngpown, nbands) array in place:
//     neighbouring threads read addresses nbands floats apart (the paper's
//     v6 layout); TRANSPOSED=true reads the (nbands, ngpown) transpose
//     with neighbouring threads on neighbouring addresses (v7 onwards).
//   * the term takes two reciprocals, not three: the reference computes
//     both branches' ssx and keeps one; term() chooses the branch's
//     numerator, denominator and |denominator|^2 first and takes one
//     reciprocal and one complex product of them. Band invariants (wt_im^2,
//     wt_re wt_im, wt2_im^2, 4 wt2: each exact) live in Elem.
//
// The arithmetic is pallas_gpp.py:140-184's function, and every kept
// result goes through its operations in its order: the guard c2sq == 0 ->
// 1, no guard on c1sq, cond1/cond2 as written. Division stays IEEE (built
// without --use_fast_math); nvcc's default FMA contraction is on.
//
// Launch: grid (n_igp, n_ig, 1) fused or (n_igp, n_ig, n_band_blocks)
// banded; blockDim.x = threads (a multiple of 32); dynamic shared memory
// blk_band * (2*blk_ig + 2*blk_igp + NW) floats.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kLimitOne = 16.0f;      // 1 / (0.25 * 0.25)
constexpr float kLimitTwo = 0.0625f;    // 0.25 * 0.25
constexpr float kTolZero = 1e-12f;
constexpr int kMaxWarps = 32;

struct Elem {
  float wt_re, wt_im, eps_re, eps_im;
  float wt2_re, wt2_im, om2_re, om2_im;
  float vc;
  // band-invariant factors of the term, hoisted out of the band loop
  float wt_im_sq;             // wt_im^2 = wd_im^2, since wd_im = -wt_im
  float wt_re_im;             // wt_re wt_im (wt_re wd_im = -wt_re_im)
  float wt2_im_sq;            // wt2_im^2 = cden1_im^2
  float wt2x4_re, wt2x4_im;   // 4 wt2, exact: wt2 f4 = wt2x4 (delw + 1/2)
};

struct Args {
  const float* wt_re;
  const float* wt_im;
  const float* eps_re;
  const float* eps_im;
  const float* aqsn_re;   // (nbands, ncouls)
  const float* aqsn_im;
  const float* aqsm_re;   // (nbands, ngpown) transposed, else (ngpown, nbands)
  const float* aqsm_im;
  const float* wx;        // (nbands, NW)
  const float* vcoul;     // (ncouls,)
  float* out;             // (n_igp, n_ig[, n_b], 4, NW)
  int ncouls, ngpown, nbands;
  int blk_ig, blk_igp, blk_band;
};

// IEEE 1/x (no --use_fast_math): MUFU.RCP, a refinement, an exponent
// test and the branch around a slow-path call, 13 instructions. MUFU.RCP
// and one Newton step (3) was faster but moved the Si-214 totals further
// from float64 (PERF.md, PR 16), so the reciprocal stays IEEE.
__device__ __forceinline__ float recip(float x) { return 1.0f / x; }

// One (element, band) step of the sweep for every frequency iw. The
// reference computes both branches' ssx, each with its own reciprocal,
// and keeps one (pallas_gpp.py:159-177); here the branch's numerator,
// denominator and |denominator|^2 are chosen first and go through one
// reciprocal and one complex product, the same operations in the same
// order for every element that keeps its result.
template <int NW>
__device__ __forceinline__ void term(const Elem& e, float an_re, float an_im,
                                     float am_re, float am_im,
                                     const float (&wxb)[NW],
                                     float (&acc)[4][NW]) {
  // mat(ig,igp) = conj(aqsm)*aqsn, pre-scaled by vcoul(ig)
  const float mat_re = an_re * am_re + an_im * am_im;
  const float mat_im = an_im * am_re - an_re * am_im;
  const float wre = e.vc * mat_re;
  const float wim = e.vc * mat_im;
#pragma unroll
  for (int iw = 0; iw < NW; ++iw) {
    const float wxv = wxb[iw];
    const float wd_re = wxv - e.wt_re;
    const float wdiffr = wd_re * wd_re + e.wt_im_sq;
    const float rden = recip(wdiffr);
    const float delw_re = (e.wt_re * wd_re - e.wt_im_sq) * rden;
    const float delw_im = (e.wt_im * wd_re + e.wt_re_im) * rden;
    const float delwr = delw_re * delw_re + delw_im * delw_im;
    const bool cond1 = (wdiffr > kLimitTwo) && (delwr < kLimitOne);
    const bool keep = cond1 || (delwr > kTolZero);   // cond1 or cond2

    const float sch_re = cond1 ? delw_re * e.eps_re - delw_im * e.eps_im : 0.0f;
    const float sch_im = cond1 ? delw_re * e.eps_im + delw_im * e.eps_re : 0.0f;

    // branch 1: om2 / cden1; branch 2: n2 / cd2
    const float cden1_re = wxv * wxv - e.wt2_re;
    const float c1sq = cden1_re * cden1_re + e.wt2_im_sq;
    const float dh = delw_re + 0.5f;
    const float cd2_re = e.wt2x4_re * dh - e.wt2x4_im * delw_im;
    const float cd2_im = e.wt2x4_re * delw_im + e.wt2x4_im * dh;
    float c2sq = cd2_re * cd2_re + cd2_im * cd2_im;
    c2sq = (c2sq == 0.0f) ? 1.0f : c2sq;
    const float n2_re = -(e.om2_re * delw_re - e.om2_im * delw_im);
    const float n2_im = -(e.om2_re * delw_im + e.om2_im * delw_re);
    const float num_re = cond1 ? e.om2_re : n2_re;
    const float num_im = cond1 ? e.om2_im : n2_im;
    const float den_re = cond1 ? cden1_re : cd2_re;
    const float den_im = cond1 ? -e.wt2_im : cd2_im;
    const float r = recip(cond1 ? c1sq : c2sq);
    const float ssx_re = keep ? (num_re * den_re + num_im * den_im) * r : 0.0f;
    const float ssx_im = keep ? (num_im * den_re - num_re * den_im) * r : 0.0f;

    acc[0][iw] += wre * sch_re - wim * sch_im;
    acc[1][iw] += wre * sch_im + wim * sch_re;
    acc[2][iw] += wre * ssx_re - wim * ssx_im;
    acc[3][iw] += wre * ssx_im + wim * ssx_re;
  }
}

// Load this thread's elements of the (ig0.., igp0..) tile and hoist the
// band-invariant subexpressions (the paper's v5 hoist, and the term's own).
template <int EPT>
__device__ __forceinline__ void load_elems(const Args& a, int ig0, int igp0,
                                           Elem (&el)[EPT], int (&g)[EPT],
                                           int (&p)[EPT], bool (&valid)[EPT]) {
  const int elems = a.blk_ig * a.blk_igp;
#pragma unroll
  for (int k = 0; k < EPT; ++k) {
    const int e = threadIdx.x + k * blockDim.x;
    valid[k] = e < elems;
    g[k] = valid[k] ? e / a.blk_igp : 0;
    p[k] = valid[k] ? e % a.blk_igp : 0;
    Elem x = {};
    if (valid[k]) {
      const size_t idx = (size_t)(ig0 + g[k]) * a.ngpown + igp0 + p[k];
      x.wt_re = a.wt_re[idx];
      x.wt_im = a.wt_im[idx];
      x.eps_re = a.eps_re[idx];
      x.eps_im = a.eps_im[idx];
      x.vc = a.vcoul[ig0 + g[k]];
      x.wt2_re = x.wt_re * x.wt_re - x.wt_im * x.wt_im;
      x.wt2_im = 2.0f * x.wt_re * x.wt_im;
      x.om2_re = x.wt2_re * x.eps_re - x.wt2_im * x.eps_im;
      x.om2_im = x.wt2_re * x.eps_im + x.wt2_im * x.eps_re;
      x.wt_im_sq = x.wt_im * x.wt_im;
      x.wt_re_im = x.wt_re * x.wt_im;
      x.wt2_im_sq = x.wt2_im * x.wt2_im;
      x.wt2x4_re = 4.0f * x.wt2_re;
      x.wt2x4_im = 4.0f * x.wt2_im;
    }
    el[k] = x;
  }
}

// The band sweep both kernels share: bands [band_lo, band_hi) in chunks of
// blk_band, each chunk staged in shared memory, then reduced into acc.
template <int NW, int EPT, bool TRANSPOSED>
__device__ __forceinline__ void band_sweep(const Args& a, int ig0, int igp0,
                                           int band_lo, int band_hi,
                                           const Elem (&el)[EPT],
                                           const int (&g)[EPT],
                                           const int (&p)[EPT],
                                           const bool (&valid)[EPT],
                                           float* smem, float (&acc)[4][NW]) {
  float* s_an_re = smem;
  float* s_an_im = s_an_re + a.blk_band * a.blk_ig;
  float* s_am_re = s_an_im + a.blk_band * a.blk_ig;
  float* s_am_im = s_am_re + a.blk_band * a.blk_igp;
  float* s_wx = s_am_im + a.blk_band * a.blk_igp;

  for (int band0 = band_lo; band0 < band_hi; band0 += a.blk_band) {
    const int nb = a.blk_band;
    for (int i = threadIdx.x; i < nb * a.blk_ig; i += blockDim.x) {
      const int b = i / a.blk_ig, gg = i % a.blk_ig;
      const size_t src = (size_t)(band0 + b) * a.ncouls + ig0 + gg;
      s_an_re[i] = a.aqsn_re[src];
      s_an_im[i] = a.aqsn_im[src];
    }
    for (int i = threadIdx.x; i < nb * a.blk_igp; i += blockDim.x) {
      const int b = i / a.blk_igp, pp = i % a.blk_igp;
      const size_t src = TRANSPOSED
          ? (size_t)(band0 + b) * a.ngpown + igp0 + pp       // coalesced row
          : (size_t)(igp0 + pp) * a.nbands + band0 + b;      // strided, v6
      s_am_re[i] = a.aqsm_re[src];
      s_am_im[i] = a.aqsm_im[src];
    }
    for (int i = threadIdx.x; i < nb * NW; i += blockDim.x) {
      s_wx[i] = a.wx[(size_t)band0 * NW + i];
    }
    __syncthreads();

    for (int b = 0; b < nb; ++b) {
      float wxb[NW];
#pragma unroll
      for (int iw = 0; iw < NW; ++iw) wxb[iw] = s_wx[b * NW + iw];
#pragma unroll
      for (int k = 0; k < EPT; ++k) {
        if (valid[k]) {
          const float an_re = s_an_re[b * a.blk_ig + g[k]];
          const float an_im = s_an_im[b * a.blk_ig + g[k]];
          const float am_re = s_am_re[b * a.blk_igp + p[k]];
          const float am_im = s_am_im[b * a.blk_igp + p[k]];
          term<NW>(el[k], an_re, an_im, am_re, am_im, wxb, acc);
        }
      }
    }
    __syncthreads();
  }
}

// Warp shuffle, then one shared-memory pass over the warps; thread q*NW+iw
// writes out[q*NW+iw]. The order is fixed, so results repeat exactly.
template <int NW>
__device__ __forceinline__ void block_reduce_store(float (&acc)[4][NW],
                                                   float* out) {
  __shared__ float s_red[kMaxWarps * 4 * NW];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
#pragma unroll
    for (int iw = 0; iw < NW; ++iw) {
      float v = acc[q][iw];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_down_sync(0xffffffffu, v, off);
      if (lane == 0) s_red[warp * 4 * NW + q * NW + iw] = v;
    }
  }
  __syncthreads();
  if (threadIdx.x < 4 * NW) {
    float s = 0.0f;
    for (int w = 0; w < nwarps; ++w) s += s_red[w * 4 * NW + threadIdx.x];
    out[threadIdx.x] = s;
  }
}

template <int NW, int EPT, bool TRANSPOSED>
__global__ void gpp_fused_kernel(Args a) {
  extern __shared__ float smem[];
  const int igp0 = blockIdx.x * a.blk_igp;
  const int ig0 = blockIdx.y * a.blk_ig;
  Elem el[EPT];
  int g[EPT], p[EPT];
  bool valid[EPT];
  load_elems<EPT>(a, ig0, igp0, el, g, p, valid);
  float acc[4][NW] = {};
  band_sweep<NW, EPT, TRANSPOSED>(a, ig0, igp0, 0, a.nbands, el, g, p, valid,
                                  smem, acc);
  const size_t blk = (size_t)blockIdx.x * gridDim.y + blockIdx.y;
  block_reduce_store<NW>(acc, a.out + blk * 4 * NW);
}

template <int NW, int EPT, bool TRANSPOSED>
__global__ void gpp_banded_kernel(Args a) {
  extern __shared__ float smem[];
  const int igp0 = blockIdx.x * a.blk_igp;
  const int ig0 = blockIdx.y * a.blk_ig;
  const int band_lo = blockIdx.z * a.blk_band;
  Elem el[EPT];
  int g[EPT], p[EPT];
  bool valid[EPT];
  load_elems<EPT>(a, ig0, igp0, el, g, p, valid);
  float acc[4][NW] = {};
  band_sweep<NW, EPT, TRANSPOSED>(a, ig0, igp0, band_lo, band_lo + a.blk_band,
                                  el, g, p, valid, smem, acc);
  const size_t blk = ((size_t)blockIdx.x * gridDim.y + blockIdx.y) * gridDim.z
                     + blockIdx.z;
  block_reduce_store<NW>(acc, a.out + blk * 4 * NW);
}

using KernelFn = void (*)(Args);

template <int NW, int EPT>
KernelFn pick_layout(int fused, int transposed) {
  if (fused)
    return transposed ? gpp_fused_kernel<NW, EPT, true>
                      : gpp_fused_kernel<NW, EPT, false>;
  return transposed ? gpp_banded_kernel<NW, EPT, true>
                    : gpp_banded_kernel<NW, EPT, false>;
}

// The instantiations: NW = 2 (every size the repo defines) and EPT, the
// elements a thread owns, rounded up to a power of two up to 8.
KernelFn pick(int fused, int transposed, int ept, int nw) {
  if (nw != 2) return nullptr;
  switch (ept) {
    case 1: return pick_layout<2, 1>(fused, transposed);
    case 2: return pick_layout<2, 2>(fused, transposed);
    case 4: return pick_layout<2, 4>(fused, transposed);
    case 8: return pick_layout<2, 8>(fused, transposed);
    default: return nullptr;
  }
}

}  // namespace

extern "C" {

// Launch one GPP kernel on `stream`. Returns cudaGetLastError() (0 when the
// launch was accepted); cudaErrorInvalidValue for an unsupported (ept, nw).
int gpp_launch(int fused, int transposed, int ept, int nw, int threads,
               const float* wt_re, const float* wt_im, const float* eps_re,
               const float* eps_im, const float* aqsn_re, const float* aqsn_im,
               const float* aqsm_re, const float* aqsm_im, const float* wx,
               const float* vcoul, float* out, int ncouls, int ngpown,
               int nbands, int blk_ig, int blk_igp, int blk_band,
               void* stream) {
  KernelFn fn = pick(fused, transposed, ept, nw);
  if (fn == nullptr || threads % 32 != 0 || threads > 32 * kMaxWarps)
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * (size_t)blk_band * (2 * blk_ig + 2 * blk_igp + nw);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  Args a{wt_re, wt_im, eps_re, eps_im, aqsn_re, aqsn_im, aqsm_re, aqsm_im,
         wx, vcoul, out, ncouls, ngpown, nbands, blk_ig, blk_igp, blk_band};
  dim3 grid(ngpown / blk_igp, ncouls / blk_ig, fused ? 1 : nbands / blk_band);
  fn<<<grid, threads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// Registers a thread and local (spilled) bytes of one instantiation, as
// the compiler laid it out.
int gpp_func_attrs(int fused, int transposed, int ept, int nw, int* regs,
                   int* local_bytes) {
  KernelFn fn = pick(fused, transposed, ept, nw);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  return 0;
}

}  // extern "C"
