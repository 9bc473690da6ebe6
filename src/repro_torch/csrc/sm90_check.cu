// Checks of the sm90.cuh building blocks on their own, for the tests and
// chip_smoke.py phase 2 (nothing on a model path calls these):
//   * sm90_wgmma_check: one 64 x N product, D = A B in f32, through the
//     header's wgmma wrappers and descriptors, A (64 x K bf16) K-major from
//     shared memory or from registers, B (K x N bf16) K-major or MN-major
//     from shared memory, both stored with the 128-byte swizzle by
//     sw128_offset;
//   * sm90_tma_check: one TMA box of a (B, S, heads, hd) bf16 tensor
//     through the header's tensor map and tma_load_rows, read back through
//     sw128_offset into a plain (rows, hd) tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int kAlign = 1024;

// mode 0: A smem, B K-major (bt is B^T, N x K row-major); mode 1: A from
// registers, B MN-major (b is K x N row-major); mode 2: A smem, B MN-major
template <int N, int K>
__global__ void __launch_bounds__(128)
    wgmma_check_kernel(int mode, const __nv_bfloat16* a,
                       const __nv_bfloat16* b, float* d, int lbo, int sbo) {
  extern __shared__ unsigned char smem_raw[];
  __nv_bfloat16* a_s = reinterpret_cast<__nv_bfloat16*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + kAlign - 1) &
      ~uintptr_t(kAlign - 1));
  __nv_bfloat16* b_s = a_s + 64 * K;
  const int tid = threadIdx.x;
  for (int i = tid; i < 64 * K; i += 128)
    a_s[sm90::sw128_offset(i / K, i % K, 64)] = a[i];
  for (int i = tid; i < N * K; i += 128) {
    if (mode == 0)          // b holds B^T: row n, column k
      b_s[sm90::sw128_offset(i / K, i % K, N)] = b[i];
    else                    // b holds B: row k, column n
      b_s[sm90::sw128_offset(i / N, i % N, K)] = b[i];
  }
  sm90::fence_proxy_async();
  __syncthreads();

  const int w = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;
  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  uint32_t ar[K / 16][4];
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    const __nv_bfloat16* r0 = a + (16 * w + g) * K + 16 * kk + 2 * t;
    const __nv_bfloat16* r1 = r0 + 8 * K;
    ar[kk][0] = *reinterpret_cast<const uint32_t*>(r0);
    ar[kk][1] = *reinterpret_cast<const uint32_t*>(r1);
    ar[kk][2] = *reinterpret_cast<const uint32_t*>(r0 + 8);
    ar[kk][3] = *reinterpret_cast<const uint32_t*>(r1 + 8);
  }
  sm90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    const uint64_t da = sm90::desc_kmajor(a_s, 64, kk);
    if (mode == 0) {
      sm90::wgmma_ss<0>(acc, da, sm90::desc_kmajor(b_s, N, kk), 1);
    } else {
      const uint64_t db = sm90::desc_sw128(b_s + kk * 16 * 64, lbo, sbo);
      if (mode == 1)
        sm90::wgmma_rs<1>(acc, ar[kk], db, 1);
      else
        sm90::wgmma_ss<1>(acc, da, db, 1);
    }
  }
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
  sm90::fence_regs(acc);
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int row = 16 * w + g, col = 8 * j + 2 * t;
    d[row * N + col] = acc[4 * j];
    d[row * N + col + 1] = acc[4 * j + 1];
    d[(row + 8) * N + col] = acc[4 * j + 2];
    d[(row + 8) * N + col + 1] = acc[4 * j + 3];
  }
}

template <int HD>
__global__ void __launch_bounds__(128)
    tma_check_kernel(const __grid_constant__ CUtensorMap map, int rows,
                     int head, int row0, int b, __nv_bfloat16* y) {
  extern __shared__ unsigned char smem_raw[];
  __nv_bfloat16* tile = reinterpret_cast<__nv_bfloat16*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + kAlign - 1) &
      ~uintptr_t(kAlign - 1));
  __shared__ uint64_t bar;
  if (threadIdx.x == 0) {
    sm90::mbar_init(&bar, 1);
    sm90::fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    sm90::mbar_expect_tx(&bar, rows * HD * 2);
    sm90::tma_load_rows<HD>(tile, &map, &bar, rows, head, row0, b);
  }
  sm90::mbar_wait(&bar, 0);
  for (int i = threadIdx.x; i < rows * HD; i += 128)
    y[i] = tile[sm90::sw128_offset(i / HD, i % HD, rows)];
}

}  // namespace

extern "C" {

// d (64 x n f32) = a (64 x k) b (k x n) on the default stream, synchronised;
// b as B^T (n x k) for mode 0. (n, k) in {32, 64, 128} x {64, 128}.
// lbo/sbo (bytes) describe B for modes 1 and 2. Returns a CUDA error or 0.
int sm90_wgmma_check(int mode, int n, int k, const void* a, const void* b,
                     void* d, int lbo, int sbo) {
  using Fn = void (*)(int, const __nv_bfloat16*, const __nv_bfloat16*, float*,
                      int, int);
  Fn fn = nullptr;
#define SM90_CHECK_CASE(N_, K_) \
  if (n == N_ && k == K_) fn = wgmma_check_kernel<N_, K_>;
  SM90_CHECK_CASE(32, 64)
  SM90_CHECK_CASE(64, 64)
  SM90_CHECK_CASE(128, 64)
  SM90_CHECK_CASE(32, 128)
  SM90_CHECK_CASE(64, 128)
  SM90_CHECK_CASE(128, 128)
#undef SM90_CHECK_CASE
  if (fn == nullptr || mode < 0 || mode > 2) return (int)cudaErrorInvalidValue;
  // an MN-major B row takes 128 bytes however narrow N is
  const int smem = (64 + (n < 64 ? 64 : n)) * k * 2 + kAlign;
  cudaError_t err =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  fn<<<1, 128, smem>>>(mode, static_cast<const __nv_bfloat16*>(a),
                       static_cast<const __nv_bfloat16*>(b),
                       static_cast<float*>(d), lbo, sbo);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)cudaDeviceSynchronize();
}

// y (rows x hd bf16) = x[b, row0:row0 + rows, head, :] through one TMA box
// of the 4-D map of x (element strides sb, ss, sh), synchronised.
int sm90_tma_check(const void* x, int B, int S, int heads, int hd,
                   long long sb, long long ss, long long sh, int rows,
                   int head, int row0, int b, void* y) {
  CUtensorMap map;
  int rc = sm90_host::encode_rows(&map, x, B, S, heads, hd, sb, ss, sh, rows);
  if (rc != 0) return rc;
  const int smem = rows * hd * 2 + kAlign;
  auto fn = hd == 64 ? tma_check_kernel<64> : tma_check_kernel<128>;
  if (hd != 64 && hd != 128) return (int)cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  fn<<<1, 128, smem>>>(map, rows, head, row0, b,
                       static_cast<__nv_bfloat16*>(y));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)cudaDeviceSynchronize();
}

}  // extern "C"
