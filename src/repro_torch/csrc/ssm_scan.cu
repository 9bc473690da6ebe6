// Mamba selective scan for NVIDIA Hopper (sm_90a).
//
// ssm_scan replaces src/repro/kernels/ssm/ssm_scan.py::_kernel (:30), as
// launched by ssm_scan_pallas (:64). Same function, same contract:
//   x, dt (B,T,C) f32; b, c (B,T,N) f32; a_log (C,N) and d (C,) f32 or
//   bf16 (read as f32, as the Pallas kernel does); h0 (B,C,N) f32;
//   per step  h <- exp(dt*a) * h + (dt*x) * b     with a = -exp(a_log)
//             y_t = sum_n h_n * c_t,n + d * x_t
//   outputs   y (B,T,C) f32 and hT (B,C,N) f32.
//
// What bounds it on this card. The recurrence along T is serial; its only
// loop-carried chain is one FMA on h (exp(dt*a) does not depend on h).
// At hymba-1.5b's prefill (B=1, T=1152, C=3200, N=16) the kernel must move
// 45 MB (13.4 us at 3.35 TB/s) and do one expf and ~7 FP32 operations per
// (t, c, n), 5.9e7 of them: it is bound by instruction issue and latency,
// not by bytes. What the design does about it: every (t, c, n) costs one
// expf, four multiplies or FMAs, two shared-memory loads and a quarter of
// a shuffle-and-add; the staging of the next time tile overlaps the
// current one's steps.
//
// Design (the TPU block is not carried over: the TPU keeps a whole
// (T, blk_c) slab in VMEM and one grid step walks all T steps for 128
// channels; on Hopper that is 25 CTAs at hymba's shape, and one thread
// per channel would be 100 warps on 132 SMs):
//   * N is split over lanes: thread (cl, n) = (threadIdx.x / N, % N) owns
//     channel c0 + cl and state n, and keeps h_n and a_n in registers.
//     Threads are rounded up to whole warps; the extra lanes compute on a
//     clamped channel and write nothing.
//   * y: each lane keeps h_n * c_t,n for N consecutive steps in registers,
//     then a transposing butterfly over the channel's N lanes (N-1
//     __shfl_xor_sync, each moving half of the remaining values) leaves
//     lane n with the sum for step n of the block; it adds d * x_t and
//     stores y_t to shared memory. The butterfly is off the loop-carried
//     chain.
//   * a CTA of blk_c channels stages TT = 64 steps at a time: x and dt
//     (TT x blk_c, interleaved) and b and c (TT x N, interleaved), copied
//     with cp.async into two buffers, so tile k+1 is in flight while tile
//     k runs. Rows past T are zero-filled by the copy (src-size 0): dt = 0
//     gives exp(0) = 1 and a zero input, so h passes such a step
//     unchanged, and those rows of y are never written out. The y tile
//     goes back to device memory in coalesced rows.
//   * grid (C / blk_c, B): nothing carries between CTAs; the sequential
//     TPU time walk is the loop inside the CTA.
//   * expf (not __expf), IEEE products, built without --use_fast_math.
//
// Instances: N in {4, 8, 16} x params f32 or bf16; blk_c at run time
// (blk_c * N <= 1024). Dynamic shared memory (5 * blk_c + 4 * N + 1) * TT
// * 4 bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TT = 64;   // steps a staged tile holds; a multiple of every N

struct Params {
  const float* x;       // (B, T, C)
  const float* dt;      // (B, T, C)
  const float* bm;      // (B, T, N)
  const float* cm;      // (B, T, N)
  const void* a_log;    // (C, N)
  const void* d;        // (C,)
  const float* h0;      // (B, C, N)
  float* y;             // (B, T, C)
  float* hT;            // (B, C, N)
  int T, C, blk_c;
};

__device__ __forceinline__ float load_param(const float* p, long long i) {
  return p[i];
}
__device__ __forceinline__ float load_param(const __nv_bfloat16* p,
                                            long long i) {
  return __bfloat162float(p[i]);
}

// 4-byte asynchronous copy device -> shared memory; zero-fills when !valid
// (src must still be a mapped address).
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned saddr = (unsigned)__cvta_generic_to_shared(dst);
  const int src_size = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(saddr), "l"(src), "r"(src_size) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// p[j] of the N lanes of a channel group -> lane n holds in p[0] the sum
// over the group of p[n]. Each stage halves the values a lane holds: the
// lane whose bit O is set keeps the upper half and sends the lower. (A
// template recursion, so every index is a constant and p stays in
// registers.)
template <int N, int O>
struct TransposeSum {
  static __device__ __forceinline__ void run(float (&p)[N], int n) {
    const bool upper = (n & O) != 0;
#pragma unroll
    for (int j = 0; j < O; ++j) {
      const float send = upper ? p[j] : p[j + O];
      const float keep = upper ? p[j + O] : p[j];
      p[j] = keep + __shfl_xor_sync(0xffffffffu, send, O);
    }
    TransposeSum<N, O / 2>::run(p, n);
  }
};

template <int N>
struct TransposeSum<N, 0> {
  static __device__ __forceinline__ void run(float (&)[N], int) {}
};

template <int N, typename PT>
__global__ void __launch_bounds__(1024) ssm_scan_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  const int blk_c = p.blk_c;
  const int ys_ld = blk_c + 1;                   // padded: fewer bank conflicts
  const int buf_floats = TT * 2 * (blk_c + N);
  float* ys = smem + 2 * buf_floats;             // [TT][blk_c + 1]

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int cl = tid / N;
  const int n = tid % N;
  const bool live = cl < blk_c;
  const int clc = live ? cl : blk_c - 1;
  const int b = blockIdx.y;
  const int c0 = blockIdx.x * blk_c;
  const int c = c0 + clc;
  const int T = p.T, C = p.C;

  const PT* a_log = static_cast<const PT*>(p.a_log);
  const PT* dpar = static_cast<const PT*>(p.d);
  const float a = -expf(load_param(a_log, (long long)c * N + n));
  const float dd = load_param(dpar, c);
  float h = p.h0[((long long)b * C + c) * N + n];

  const long long row0 = (long long)b * T;      // first (b, t) row
  const float* xb = p.x + row0 * C + c0;
  const float* dtb = p.dt + row0 * C + c0;
  const float* bb = p.bm + row0 * N;
  const float* cb = p.cm + row0 * N;
  float* yb = p.y + row0 * C + c0;

  // stage the tile of steps t0.. into buffer `buf`: xd [TT][blk_c] and
  // bc [TT][N] of float2 (x, dt) and (b, c)
  auto stage = [&](int t0, int buf) {
    float* xd = smem + buf * buf_floats;
    float* bc = xd + TT * 2 * blk_c;
    for (int i = tid; i < TT * blk_c; i += nthreads) {
      const int r = i / blk_c, col = i - r * blk_c;
      const bool ok = t0 + r < T;
      const long long g = (long long)(ok ? t0 + r : t0) * C + col;
      cp_async4(xd + 2 * i, xb + g, ok);
      cp_async4(xd + 2 * i + 1, dtb + g, ok);
    }
    for (int i = tid; i < TT * N; i += nthreads) {
      const bool ok = t0 + i / N < T;
      const long long g = (long long)t0 * N + (ok ? i : 0);
      cp_async4(bc + 2 * i, bb + g, ok);
      cp_async4(bc + 2 * i + 1, cb + g, ok);
    }
  };

  const int ntiles = (T + TT - 1) / TT;
  stage(0, 0);
  cp_async_commit();
  for (int k = 0; k < ntiles; ++k) {
    if (k + 1 < ntiles) stage((k + 1) * TT, (k + 1) & 1);
    cp_async_commit();                  // (empty for the last tile)
    cp_async_wait_one();                // tile k has landed
    __syncthreads();
    const float2* xd = reinterpret_cast<const float2*>(
        smem + (k & 1) * buf_floats);
    const float2* bc = xd + TT * blk_c;
    for (int r0 = 0; r0 < TT; r0 += N) {
      float pr[N];
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float2 v = xd[(r0 + j) * blk_c + clc];     // (x, dt)
        const float2 w = bc[(r0 + j) * N + n];           // (b, c)
        const float da = expf(v.y * a);
        h = fmaf(da, h, (v.y * v.x) * w.x);
        pr[j] = h * w.y;
      }
      TransposeSum<N, N / 2>::run(pr, n);
      if (live) ys[(r0 + n) * ys_ld + cl] = pr[0] + dd * xd[(r0 + n) * blk_c + cl].x;
    }
    __syncthreads();
    const int nt = min(TT, T - k * TT);
    for (int i = tid; i < nt * blk_c; i += nthreads) {
      const int r = i / blk_c, col = i - r * blk_c;
      yb[(long long)(k * TT + r) * C + col] = ys[r * ys_ld + col];
    }
    // buffer k & 1 is staged again at iteration k + 1 (tile k + 2), after
    // the barrier above; ys is written again only after the next barrier
  }
  if (live) p.hT[((long long)b * C + c) * N + n] = h;
}

using KernelFn = void (*)(Params);

KernelFn pick(int n, int bf16_params) {
  if (bf16_params) {
    if (n == 4) return ssm_scan_kernel<4, __nv_bfloat16>;
    if (n == 8) return ssm_scan_kernel<8, __nv_bfloat16>;
    if (n == 16) return ssm_scan_kernel<16, __nv_bfloat16>;
  } else {
    if (n == 4) return ssm_scan_kernel<4, float>;
    if (n == 8) return ssm_scan_kernel<8, float>;
    if (n == 16) return ssm_scan_kernel<16, float>;
  }
  return nullptr;
}

}  // namespace

extern "C" {

// Launch ssm_scan on `stream`. Every tensor is contiguous (the wrapper
// checks). time_tile must equal the compiled TT. Returns
// cudaGetLastError() (0 when the launch was accepted);
// cudaErrorInvalidValue for an unsupported N, blk_c or time tile.
int ssm_scan_launch(int n, int bf16_params, int blk_c, const void* x,
                    const void* dt, const void* bm, const void* cm,
                    const void* a_log, const void* d, const void* h0,
                    void* y, void* hT, int B, int T, int C, int time_tile,
                    void* stream) {
  KernelFn fn = pick(n, bf16_params);
  const int threads = (blk_c * n + 31) / 32 * 32;
  if (fn == nullptr || blk_c <= 0 || C % blk_c != 0 || threads > 1024 ||
      time_tile != TT || B <= 0 || T <= 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(5 * blk_c + 4 * n + 1) * TT * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  Params p{static_cast<const float*>(x), static_cast<const float*>(dt),
           static_cast<const float*>(bm), static_cast<const float*>(cm),
           a_log, d, static_cast<const float*>(h0), static_cast<float*>(y),
           static_cast<float*>(hT), T, C, blk_c};
  dim3 grid(C / blk_c, B);
  fn<<<grid, threads, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// Registers a thread and local (spilled) bytes of one instance, as the
// compiler laid it out.
int ssm_func_attrs(int n, int bf16_params, int* regs, int* local_bytes) {
  KernelFn fn = pick(n, bf16_params);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  return 0;
}

}  // extern "C"
