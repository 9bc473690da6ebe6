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
// loop-carried chain is one FMA on h (exp(dt*a) does not depend on h). At
// hymba-1.5b's prefill (B=1, T=1152, C=3200, N=16) the kernel moves 45 MB
// (13.4 us at 3.35 TB/s) over 5.9e7 (t, c, n) elements, each an IEEE expf
// (8 instructions with one MUFU.EX2) and four FP32 operations: instruction
// issue bounds it, and the census of the compiled loop (PERF.md) counts
// what an element costs. One state a thread (the kernel this one
// replaced) spent 22 instructions an element, reloading x and dt and
// recomputing dt*x for every state and summing y over 16 lanes with a
// shuffle butterfly. The other limit is parallelism: at B=1 the scan has
// only C x N = 51,200 chains, 1,600 warps of single-state threads.
//
// Design (the TPU block is not carried over: the TPU keeps a (T, 128) slab
// in VMEM and one grid step walks all T steps):
//   * a thread owns S consecutive states s0 = l*S.. of one channel, so a
//     channel has L = N / S lanes; thread (cl, l) = (tid / L, tid % L) keeps
//     h and a of its S states in registers. Per step it loads x and dt
//     once and computes dt*x once for the S states, reads its b and c as
//     two vector loads of S floats, and sums h*c over its S states as an
//     FFMA chain. Threads are rounded up to whole warps; the extra lanes
//     compute on a clamped channel and write nothing.
//   * every G steps (32 at S = 2, 16 otherwise: the faster on the card),
//     each block of L steps of partial sums goes through a transposing
//     butterfly over the channel's L lanes (log2 L stages, each lane
//     sending half of what it holds), which leaves lane l with the sum for
//     step l of the block; it adds d*x and stores y straight to device
//     memory: a warp's store covers whole 32-byte sectors of 8 or more
//     channels. The butterfly is off the chain on h.
//   * a scheduler holds one or two of these warps at B=1, so its issue rate
//     rests on the ILP of one warp's code: __launch_bounds__(256, 1) lets
//     ptxas spend the registers its schedule of the unrolled steps wants
//     (71-95, against 48-80 without the 1), which ran 5-25% faster.
//   * a CTA of blk_c channels stages TT = 64 steps at a time in a ring of
//     three tiles, two in flight while one is computed: b and c rows are
//     one contiguous run of TT*N floats each, one bulk copy (cp.async.bulk)
//     apiece completing on the stage's mbarrier; x and dt rows by 16-byte
//     cp.async (4-byte when C or blk_c is not a multiple of 4). Rows past T
//     are zero-filled by the x/dt copy (dt = 0 gives exp(0) = 1 and a zero
//     input, so h passes such a step unchanged) and zeroed in b/c after
//     the bulk copy; their y is never written. A stuck mbarrier traps
//     after ~10 s (sm90.cuh) instead of hanging the card.
//   * grid (C / blk_c, B): nothing carries between CTAs, and every sum is
//     taken in a fixed order, so two launches give the same bits.
//   * expf (not __expf) on the f32 product dt*a, IEEE products, built
//     without --use_fast_math: decay_rate() and decay() hold the exp's form
//     (tools/ssm_scan_probe.py --exp2 swaps in ex2.approx to compare).
//
// Instances: N in {4, 8, 16} x S in {2, 4, 8} (S <= N) x params f32 or
// bf16; blk_c at run time (blk_c * N / S <= 256 threads). Dynamic shared
// memory STAGES * (TT * (2 * blk_c + 2 * N) * 4 + 8) bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int TT = 64;            // steps a staged tile holds
constexpr int STAGES = 3;         // tiles in the ring
constexpr int MAX_THREADS = 256;  // the launch bound

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
  int vec;              // x and dt rows go as 16-byte copies
};

__device__ __forceinline__ float load_param(const float* p, long long i) {
  return p[i];
}
__device__ __forceinline__ float load_param(const __nv_bfloat16* p,
                                            long long i) {
  return __bfloat162float(p[i]);
}

// exp(dt * a) of one (t, c, n) element, a as decay_rate() keeps it in
// registers: IEEE expf of the f32 product, as the plain version computes it
__device__ __forceinline__ float decay_rate(float a) { return a; }

__device__ __forceinline__ float decay(float dt, float a) { return expf(dt * a); }

// asynchronous copies device -> shared memory that zero-fill when !valid
// (src must still be a mapped address)
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(sm90::smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(sm90::smem_u32(dst)), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int K>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(K) : "memory");
}

// S consecutive floats (8- or 16-byte aligned) into registers
template <int S>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[S]) {
  if constexpr (S == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x;
    v[1] = t.y;
  } else {
#pragma unroll
    for (int i = 0; i < S; i += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + i);
      v[i] = t.x;
      v[i + 1] = t.y;
      v[i + 2] = t.z;
      v[i + 3] = t.w;
    }
  }
}

// p[j] of the L lanes of a channel -> lane l holds in p[0] the sum over
// the channel's lanes of p[l]. Each stage halves the values a lane holds:
// the lane whose bit O is set keeps the upper half and sends the lower. (A
// template recursion, so every index is a constant and p stays in
// registers.)
template <int L, int O>
struct TransposeSum {
  static __device__ __forceinline__ void run(float (&p)[L], int l) {
    const bool upper = (l & O) != 0;
#pragma unroll
    for (int j = 0; j < O; ++j) {
      const float send = upper ? p[j] : p[j + O];
      const float keep = upper ? p[j + O] : p[j];
      p[j] = keep + __shfl_xor_sync(0xffffffffu, send, O);
    }
    TransposeSum<L, O / 2>::run(p, l);
  }
};

template <int L>
struct TransposeSum<L, 0> {
  static __device__ __forceinline__ void run(float (&)[L], int) {}
};

template <int N, int S, typename PT>
__global__ void __launch_bounds__(MAX_THREADS, 1) ssm_scan_kernel(Params p) {
  constexpr int L = N / S;
  constexpr int G = S == 2 ? 32 : 16;    // steps between two butterflies
  static_assert(N % S == 0 && G % L == 0 && TT % G == 0, "tile shape");
  extern __shared__ __align__(16) float smem[];
  const int blk_c = p.blk_c;
  // a stage: x [TT][blk_c], dt [TT][blk_c], b [TT][N], c [TT][N]
  const int stage_floats = TT * (2 * blk_c + 2 * N);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + STAGES * stage_floats);

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int l = tid % L;
  const bool live = tid / L < blk_c;
  const int cl = live ? tid / L : blk_c - 1;
  const int bi = blockIdx.y;
  const int c0 = blockIdx.x * blk_c;
  const int c = c0 + cl;
  const int T = p.T, C = p.C;
  const int s0 = l * S;

  const PT* a_log = static_cast<const PT*>(p.a_log);
  const long long hoff = ((long long)bi * C + c) * N + s0;
  float a[S], h[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    a[s] = decay_rate(-expf(load_param(a_log, (long long)c * N + s0 + s)));
    h[s] = p.h0[hoff + s];
  }
  const float dd = load_param(static_cast<const PT*>(p.d), c);

  const long long row0 = (long long)bi * T;     // first (b, t) row
  const float* xg = p.x + row0 * C + c0;
  const float* dtg = p.dt + row0 * C + c0;
  const float* bg = p.bm + row0 * N;
  const float* cg = p.cm + row0 * N;
  float* yg = p.y + row0 * C + c0;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) sm90::mbar_init(&bar[s], 1);
    sm90::fence_barrier_init();
  }
  __syncthreads();

  // x and dt rows go in chunks of w floats, q chunks a row; thread tid
  // copies chunk tid % q of rows tid / q, tid / q + rstep, ...
  const int w = p.vec ? 4 : 1;
  const int q = blk_c / w;
  const int rstep = nthreads / q;
  const int crow = tid / q;
  const int ccol = (tid - crow * q) * w;

  // stage the tile of steps k*TT.. into buffer k % STAGES
  auto stage = [&](int k) {
    const int buf = k % STAGES;
    float* xs = smem + buf * stage_floats;
    float* dts = xs + TT * blk_c;
    float* bs = dts + TT * blk_c;
    float* cs = bs + TT * N;
    const int t0 = k * TT;
    const int rows = min(TT, T - t0);
    if (tid == 0) {
      const uint32_t bytes = (uint32_t)rows * N * sizeof(float);
      sm90::fence_proxy_async();
      sm90::mbar_expect_tx(&bar[buf], 2 * bytes);
      sm90::bulk_load(bs, bg + (long long)t0 * N, bytes, &bar[buf]);
      sm90::bulk_load(cs, cg + (long long)t0 * N, bytes, &bar[buf]);
    }
    if (crow < rstep) {
      for (int r = crow; r < TT; r += rstep) {
        const bool ok = r < rows;
        const long long g = (long long)(t0 + (ok ? r : 0)) * C + ccol;
        float* xd = xs + r * blk_c + ccol;
        float* dtd = dts + r * blk_c + ccol;
        if (w == 4) {
          cp_async16(xd, xg + g, ok);
          cp_async16(dtd, dtg + g, ok);
        } else {
          cp_async4(xd, xg + g, ok);
          cp_async4(dtd, dtg + g, ok);
        }
      }
    }
  };

  const int ntiles = (T + TT - 1) / TT;
#pragma unroll
  for (int k = 0; k < STAGES - 1; ++k) {
    if (k < ntiles) stage(k);
    cp_async_commit();
  }
  for (int k = 0; k < ntiles; ++k) {
    __syncthreads();                       // buffer (k - 1) % STAGES is free
    if (k + STAGES - 1 < ntiles) stage(k + STAGES - 1);
    cp_async_commit();                     // (empty near the end)
    cp_async_wait<STAGES - 1>();           // this thread's x/dt of tile k
    const int buf = k % STAGES;
    sm90::mbar_wait(&bar[buf], (k / STAGES) & 1);   // b and c of tile k
    const float* xs = smem + buf * stage_floats;
    const float* dts = xs + TT * blk_c;
    float* bs = smem + buf * stage_floats + 2 * TT * blk_c;
    float* cs = bs + TT * N;
    const int t0 = k * TT;
    const int rows = min(TT, T - t0);
    if (rows < TT) {                       // the last tile: no b, c past T
      for (int i = rows * N + tid; i < TT * N; i += nthreads) {
        bs[i] = 0.f;
        cs[i] = 0.f;
      }
    }
    __syncthreads();                       // every thread's copies landed

#pragma unroll 1
    for (int g = 0; g < rows; g += G) {
      float part[G];
#pragma unroll
      for (int j = 0; j < G; ++j) {
        const int r = g + j;
        const float dtv = dts[r * blk_c + cl];
        const float u = dtv * xs[r * blk_c + cl];
        float bv[S], cv[S];
        load_vec<S>(bs + r * N + s0, bv);
        load_vec<S>(cs + r * N + s0, cv);
        float acc = 0.f;
#pragma unroll
        for (int s = 0; s < S; ++s) {
          h[s] = fmaf(decay(dtv, a[s]), h[s], u * bv[s]);
          acc = s == 0 ? h[s] * cv[s] : fmaf(h[s], cv[s], acc);
        }
        part[j] = acc;
      }
#pragma unroll
      for (int m = 0; m < G / L; ++m) {
        float blk[L];
#pragma unroll
        for (int i = 0; i < L; ++i) blk[i] = part[m * L + i];
        TransposeSum<L, L / 2>::run(blk, l);
        const int r = g + m * L + l;
        if (live && r < rows)
          yg[(long long)(t0 + r) * C + cl] =
              fmaf(dd, xs[r * blk_c + cl], blk[0]);
      }
    }
  }
  if (live) {
#pragma unroll
    for (int s = 0; s < S; ++s) p.hT[hoff + s] = h[s];
  }
}

using KernelFn = void (*)(Params);

KernelFn pick(int n, int s, int bf16_params) {
#define SSM_INSTANCE(NN, SS)                                          \
  if (n == NN && s == SS)                                             \
    return bf16_params ? ssm_scan_kernel<NN, SS, __nv_bfloat16>       \
                       : ssm_scan_kernel<NN, SS, float>;
  SSM_INSTANCE(4, 2)
  SSM_INSTANCE(4, 4)
  SSM_INSTANCE(8, 2)
  SSM_INSTANCE(8, 4)
  SSM_INSTANCE(8, 8)
  SSM_INSTANCE(16, 2)
  SSM_INSTANCE(16, 4)
  SSM_INSTANCE(16, 8)
#undef SSM_INSTANCE
  return nullptr;
}

// A launch's dynamic shared memory: STAGES tiles of x and dt (TT x blk_c)
// and of b and c (TT x N), f32, and one mbarrier a stage.
size_t dynamic_smem(int n, int blk_c) {
  return (size_t)STAGES *
         ((size_t)TT * (2 * blk_c + 2 * n) * sizeof(float) + sizeof(uint64_t));
}

// The grid of a launch: one CTA per (blk_c channels, batch row).
dim3 grid_of(int B, int C, int blk_c) { return dim3(C / blk_c, B); }

}  // namespace

extern "C" {

// Launch ssm_scan on `stream` with `states` states a thread. Every tensor
// is contiguous (the wrapper checks) and bm, cm start on 16-byte
// boundaries. time_tile must equal the compiled TT. Returns
// cudaGetLastError() (0 when the launch was accepted);
// cudaErrorInvalidValue for an unsupported N, states, blk_c, time tile or
// alignment.
int ssm_scan_run(int n, int states, int bf16_params, int blk_c,
                 const void* x, const void* dt, const void* bm,
                 const void* cm, const void* a_log, const void* d,
                 const void* h0, void* y, void* hT, int B, int T, int C,
                 int time_tile, void* stream) {
  KernelFn fn = pick(n, states, bf16_params);
  if (fn == nullptr || blk_c <= 0 || C % blk_c != 0 || time_tile != TT ||
      B <= 0 || B > 65535 || T <= 0 || (uintptr_t)bm % 16 != 0 ||
      (uintptr_t)cm % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int threads = (blk_c * (n / states) + 31) / 32 * 32;
  if (threads > MAX_THREADS) return (int)cudaErrorInvalidValue;
  const int vec = C % 4 == 0 && blk_c % 4 == 0 && (uintptr_t)x % 16 == 0 &&
                  (uintptr_t)dt % 16 == 0;
  const size_t smem = dynamic_smem(n, blk_c);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  Params p{static_cast<const float*>(x), static_cast<const float*>(dt),
           static_cast<const float*>(bm), static_cast<const float*>(cm),
           a_log, d, static_cast<const float*>(h0), static_cast<float*>(y),
           static_cast<float*>(hT), T, C, blk_c, vec};
  fn<<<grid_of(B, C, blk_c), threads, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// The shape ssm_scan_run gives a launch: its dynamic shared memory, the
// instance's static shared memory (cudaFuncGetAttributes) and the grid's
// blocks. Launches nothing.
int ssm_launch_shape(int n, int states, int bf16_params, int blk_c, int B,
                     int C, long long* dynamic_bytes, long long* static_bytes,
                     long long* blocks) {
  KernelFn fn = pick(n, states, bf16_params);
  if (fn == nullptr || blk_c <= 0 || C % blk_c != 0)
    return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid = grid_of(B, C, blk_c);
  *dynamic_bytes = (long long)dynamic_smem(n, blk_c);
  *static_bytes = (long long)attr.sharedSizeBytes;
  *blocks = (long long)grid.x * grid.y * grid.z;
  return 0;
}

// Registers a thread and local (spilled) bytes of one instance, as the
// compiler laid it out.
int ssm_func_attrs(int n, int states, int bf16_params, int* regs,
                   int* local_bytes) {
  KernelFn fn = pick(n, states, bf16_params);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  return 0;
}

}  // extern "C"
