// Paged decode attention for NVIDIA Hopper (sm_90a).
//
// One kernel body, three entry points, each replacing one pure-JAX version
// of src/repro/kernels/paged/paged.py:
//   paged_gather_run  -> paged_decode_gather (:123, loop _online_block_scan
//                        :85): one query a row over a bf16 pool;
//   paged_int8_run    -> paged_decode_int8 (:222): the same over an int8
//                        pool, each page times its f32 scale;
//   paged_verify_run  -> paged_decode_verify (:182, loop
//                        _online_block_scan_multi :138): Q queries a row,
//                        query j sees pos <= cache_len - Q + j; bf16 or int8.
// Contract (the wrapper, kernels/paged/paged_cuda.py, checks it):
//   q (B, Q, H, Hd) bf16 (rank 3 is Q = 1); pools (P, page, KvH, Hd) bf16
//   or int8 with kscale, vscale (P,) f32; table (B, npt) int32; cache_len
//   (B,) int32; out (B, Q, H, Hd) bf16. Per row and query the scores
//   q.k * Hd^-0.5 (the scale after the dot), masked to -1e30 (finite, as
//   the reference: a query that sees no position averages every gathered
//   v line), an online softmax in f32 over blocks of ppb pages, p kept in
//   f32 for the value product, out = acc / max(l, 1e-30) rounded once to
//   bf16.
//
// What bounds it on this card: bytes. Every K and V line a row's table
// names is read once a call: at qwen2-1.5b's decode (B=4, KvH=2, Hd=128,
// a context of 1024) 4.19 MB, 1.25 us at 3.35 TB/s; the operations (4 x
// B x Q x H x ctx x Hd FP32) are far below the FP32 peak at Q <= 4, so
// the CUDA cores, not the tensor cores, do them.
//
// Design (the TPU version is an XLA scan over gathered blocks, no
// pallas_call; a simple, right kernel first):
//   * one CTA of 128 threads per (kv head, row): it holds the G x Q query
//     rows of its group (q in f32 in shared memory) and walks the row's
//     pages in blocks of ppb pages. The block's page ids are read from
//     the table once and clamped to [0, P): the kernel never reads a page
//     out of range, whatever the table holds.
//   * a block's K and V lines of this kv head go to shared memory by
//     16-byte cp.async, each line padded by 16 bytes so that the
//     score loop's 16-byte reads of consecutive lines fall on distinct
//     banks. Then the scores (a thread a line, eight query rows at a time
//     in registers, the dot as an FMA chain over Hd), the masked max and
//     sum a warp a query row (fixed-order shuffles), and the value product
//     (a thread a column and eight query rows) on the CUDA cores.
//   * pages wholly past every query's last position are skipped: there
//     the reference's online step multiplies by exp(0) = 1 and adds exact
//     zeros, so skipping changes no bit. A row in which some query sees
//     nothing (cache_len < Q) walks every page, which gives that query
//     the reference's mean of all gathered v lines.
//   * nothing is summed across CTAs and every sum runs in a fixed order:
//     two launches give the same bits. ppb changes only the order of the
//     online rescale, as in the reference.
//   * 8 CTAs at qwen2's decode: a call is launch-bound and a CTA walks
//     its context alone. Splitting the page list over CTAs with a
//     fixed-order combine is the way to fill the card (not done here).
//
// Dynamic shared memory (paged_cuda.smem_bytes mirrors it):
//   f32: q Rp x Hd, acc R x Hd, scores Rp x span, m/l/corr 3 x R,
//        page scales 2 x ppb, page ids ppb (int)   -> rounded up to 16 B
//   then K and V, span lines of Hd x sizeof(KV) + 16 bytes each,
//   with R = G x Q, Rp = R rounded up to 8, span = ppb x page.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int RC = 8;                 // query rows held in registers at once
constexpr int ROW_PAD = 16;           // bytes after each staged K/V line
constexpr float NEG_INF = -1e30f;
constexpr size_t SMEM_LIMIT = 232448; // opt-in shared memory of one CTA

struct Params {
  const __nv_bfloat16* q;
  const void* kpool;
  const void* vpool;
  const float* kscale;
  const float* vscale;
  const int* table;
  const int* cache_len;
  __nv_bfloat16* out;
  int Q, H, KvH, Hd, P, page, npt, ppb;
  float scale;
};

__host__ __device__ inline int round_rows(int r) { return (r + RC - 1) / RC * RC; }

__host__ __device__ inline size_t float_region_bytes(int R, int Hd, int span,
                                                     int ppb) {
  const size_t floats = (size_t)round_rows(R) * Hd + (size_t)R * Hd +
                        (size_t)round_rows(R) * span + 3 * (size_t)R +
                        3 * (size_t)ppb;
  return (floats * 4 + 15) / 16 * 16;
}

__host__ __device__ inline size_t smem_bytes(int R, int Hd, int span, int ppb,
                                             int kv_bytes) {
  return float_region_bytes(R, Hd, span, ppb) +
         2 * (size_t)span * (Hd * kv_bytes + ROW_PAD);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// eight K values of a staged line from element d, as f32 (an int8 line
// times its page's scale, as the reference's astype(f32) * scale)
__device__ __forceinline__ void load8(const unsigned char* line, int d,
                                      float pscale, float* out,
                                      const __nv_bfloat16*) {
  const uint4 raw = *reinterpret_cast<const uint4*>(line + 2 * d);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(h[e]);
    out[2 * e] = f.x;
    out[2 * e + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const unsigned char* line, int d,
                                      float pscale, float* out,
                                      const int8_t*) {
  const uint2 raw = *reinterpret_cast<const uint2*>(line + d);
  const int8_t* v = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
  for (int e = 0; e < 8; ++e) out[e] = (float)v[e] * pscale;
}

__device__ __forceinline__ float load1(const unsigned char* line, int d,
                                       float, const __nv_bfloat16*) {
  return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(line)[d]);
}

__device__ __forceinline__ float load1(const unsigned char* line, int d,
                                       float pscale, const int8_t*) {
  return (float)reinterpret_cast<const int8_t*>(line)[d] * pscale;
}

template <typename KV>
__global__ void __launch_bounds__(THREADS)
    paged_decode_kernel(const Params p) {
  constexpr bool kInt8 = sizeof(KV) == 1;
  extern __shared__ __align__(16) unsigned char smem[];
  const int kh = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int Hd = p.Hd, G = p.H / p.KvH, R = G * p.Q, Rp = round_rows(R);
  const int span = p.ppb * p.page;
  const int row_bytes = Hd * (int)sizeof(KV) + ROW_PAD;
  const KV* tag = nullptr;

  float* qs = reinterpret_cast<float*>(smem);     // Rp x Hd
  float* acc = qs + (size_t)Rp * Hd;               // R x Hd
  float* sc = acc + (size_t)R * Hd;                // Rp x span
  float* m_s = sc + (size_t)Rp * span;             // R
  float* l_s = m_s + R;                            // R
  float* c_s = l_s + R;                            // R
  float* ksc = c_s + R;                            // ppb
  float* vsc = ksc + p.ppb;                        // ppb
  int* ids = reinterpret_cast<int*>(vsc + p.ppb);  // ppb
  unsigned char* ks = smem + float_region_bytes(R, Hd, span, p.ppb);
  unsigned char* vs = ks + (size_t)span * row_bytes;

  // query row r = j * G + g: query j of head kh * G + g
  for (int i = tid; i < Rp * Hd; i += THREADS) {
    const int r = i / Hd, d = i % Hd;
    float v = 0.f;
    if (r < R) {
      const int j = r / G, g = r % G;
      v = __bfloat162float(
          p.q[((size_t)(b * p.Q + j) * p.H + kh * G + g) * Hd + d]);
      acc[i] = 0.f;
    }
    qs[i] = v;
  }
  for (int r = tid; r < R; r += THREADS) {
    m_s[r] = NEG_INF;
    l_s[r] = 0.f;
  }

  // query j's last visible position is clen - Q + j
  const int clen = p.cache_len[b];
  int n_pages = p.npt;
  if (clen - p.Q >= 0) n_pages = min(p.npt, (clen - 1) / p.page + 1);
  const int n_blocks = (n_pages + p.ppb - 1) / p.ppb;
  const int chunks = Hd * (int)sizeof(KV) / 16;
  const size_t line_stride = (size_t)p.KvH * Hd * sizeof(KV);

  for (int bi = 0; bi < n_blocks; ++bi) {
    const int pg0 = bi * p.ppb;
    const int np = min(p.ppb, n_pages - pg0);
    const int lines = np * p.page;
    if (tid < np) {
      int pid = p.table[(size_t)b * p.npt + pg0 + tid];
      pid = min(max(pid, 0), p.P - 1);
      ids[tid] = pid;
      if (kInt8) {
        ksc[tid] = p.kscale[pid];
        vsc[tid] = p.vscale[pid];
      }
    }
    __syncthreads();
    for (int i = tid; i < lines * chunks; i += THREADS) {
      const int line = i / chunks, c = i % chunks;
      const size_t off = ((size_t)ids[line / p.page] * p.page +
                          line % p.page) * line_stride +
                         (size_t)kh * Hd * sizeof(KV) + (size_t)c * 16;
      cp_async16(ks + (size_t)line * row_bytes + c * 16,
                 static_cast<const unsigned char*>(p.kpool) + off);
      cp_async16(vs + (size_t)line * row_bytes + c * 16,
                 static_cast<const unsigned char*>(p.vpool) + off);
    }
    cp_async_wait_all();
    __syncthreads();

    // scores: a thread a line, RC query rows at a time
    for (int s = tid; s < lines; s += THREADS) {
      const unsigned char* kline = ks + (size_t)s * row_bytes;
      const float pscale = kInt8 ? ksc[s / p.page] : 1.f;
      const int pos = pg0 * p.page + s;
      for (int r0 = 0; r0 < R; r0 += RC) {
        float dot[RC];
#pragma unroll
        for (int rr = 0; rr < RC; ++rr) dot[rr] = 0.f;
        for (int d = 0; d < Hd; d += 8) {
          float kf[8];
          load8(kline, d, pscale, kf, tag);
#pragma unroll
          for (int rr = 0; rr < RC; ++rr) {
            const float4* qv =
                reinterpret_cast<const float4*>(qs + (size_t)(r0 + rr) * Hd + d);
            const float4 a = qv[0], c = qv[1];
            dot[rr] = fmaf(a.x, kf[0], dot[rr]);
            dot[rr] = fmaf(a.y, kf[1], dot[rr]);
            dot[rr] = fmaf(a.z, kf[2], dot[rr]);
            dot[rr] = fmaf(a.w, kf[3], dot[rr]);
            dot[rr] = fmaf(c.x, kf[4], dot[rr]);
            dot[rr] = fmaf(c.y, kf[5], dot[rr]);
            dot[rr] = fmaf(c.z, kf[6], dot[rr]);
            dot[rr] = fmaf(c.w, kf[7], dot[rr]);
          }
        }
#pragma unroll
        for (int rr = 0; rr < RC; ++rr) {
          const int r = r0 + rr;
          const int lim = clen - p.Q + r / G;
          sc[(size_t)r * span + s] = pos <= lim ? dot[rr] * p.scale : NEG_INF;
        }
      }
    }
    __syncthreads();

    // online softmax step: a warp a query row
    for (int r = warp; r < R; r += THREADS / 32) {
      float* row = sc + (size_t)r * span;
      float mx = NEG_INF;
      for (int s = lane; s < lines; s += 32) mx = fmaxf(mx, row[s]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int s = lane; s < lines; s += 32) {
        const float e = expf(row[s] - m_new);
        row[s] = e;
        sum += e;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        c_s[r] = corr;
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * corr + p v: a thread a column and RC query rows
    for (int it = tid; it < Rp / RC * Hd; it += THREADS) {
      const int d = it % Hd, r0 = it / Hd * RC;
      float pv[RC];
#pragma unroll
      for (int rr = 0; rr < RC; ++rr) pv[rr] = 0.f;
      for (int s = 0; s < lines; ++s) {
        const float pscale = kInt8 ? vsc[s / p.page] : 1.f;
        const float v = load1(vs + (size_t)s * row_bytes, d, pscale, tag);
#pragma unroll
        for (int rr = 0; rr < RC; ++rr)
          pv[rr] = fmaf(sc[(size_t)(r0 + rr) * span + s], v, pv[rr]);
      }
#pragma unroll
      for (int rr = 0; rr < RC; ++rr) {
        const int r = r0 + rr;
        if (r < R) acc[(size_t)r * Hd + d] = acc[(size_t)r * Hd + d] * c_s[r] + pv[rr];
      }
    }
    __syncthreads();
  }

  for (int i = tid; i < R * Hd; i += THREADS) {
    const int r = i / Hd, d = i % Hd, j = r / G, g = r % G;
    p.out[((size_t)(b * p.Q + j) * p.H + kh * G + g) * Hd + d] =
        __float2bfloat16_rn(acc[i] / fmaxf(l_s[r], 1e-30f));
  }
}

template <typename KV>
int launch(const void* q, const void* kpool, const void* vpool,
           const void* kscale, const void* vscale, const void* table,
           const void* cache_len, void* out, int B, int Q, int H, int KvH,
           int Hd, int P, int page, int npt, int ppb, float scale,
           void* stream) {
  const int kv_bytes = (int)sizeof(KV);
  if (B <= 0 || B > 65535 || Q <= 0 || KvH <= 0 || H % KvH != 0 ||
      Hd <= 0 || Hd % 16 != 0 || P <= 0 || page <= 0 || npt <= 0 ||
      ppb <= 0 || npt % ppb != 0 || (uintptr_t)kpool % 16 != 0 ||
      (uintptr_t)vpool % 16 != 0 ||
      (kv_bytes == 1 && (kscale == nullptr || vscale == nullptr)))
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes((H / KvH) * Q, Hd, ppb * page, ppb, kv_bytes);
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  // once an instance, at its first launch (never inside a graph capture
  // that follows a first call): every block may take the whole limit
  static const cudaError_t smem_set = cudaFuncSetAttribute(
      paged_decode_kernel<KV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_LIMIT);
  if (smem_set != cudaSuccess) return (int)smem_set;
  Params p{static_cast<const __nv_bfloat16*>(q),
           kpool,
           vpool,
           static_cast<const float*>(kscale),
           static_cast<const float*>(vscale),
           static_cast<const int*>(table),
           static_cast<const int*>(cache_len),
           static_cast<__nv_bfloat16*>(out),
           Q, H, KvH, Hd, P, page, npt, ppb, scale};
  dim3 grid(KvH, B);
  paged_decode_kernel<KV><<<grid, THREADS, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each entry point launches on `stream` and returns cudaGetLastError() (0
// when the launch was accepted); cudaErrorInvalidValue for a shape,
// alignment or block it does not take.

// paged_decode_gather: one query a row (Q = 1), bf16 pool.
int paged_gather_run(const void* q, const void* kpool, const void* vpool,
                     const void* table, const void* cache_len, void* out,
                     int B, int H, int KvH, int Hd, int P, int page, int npt,
                     int ppb, float scale, void* stream) {
  return launch<__nv_bfloat16>(q, kpool, vpool, nullptr, nullptr, table,
                               cache_len, out, B, 1, H, KvH, Hd, P, page, npt,
                               ppb, scale, stream);
}

// paged_decode_int8: one query a row (Q = 1), int8 pool with (P,) scales.
int paged_int8_run(const void* q, const void* kpool, const void* vpool,
                   const void* kscale, const void* vscale, const void* table,
                   const void* cache_len, void* out, int B, int H, int KvH,
                   int Hd, int P, int page, int npt, int ppb, float scale,
                   void* stream) {
  return launch<int8_t>(q, kpool, vpool, kscale, vscale, table, cache_len,
                        out, B, 1, H, KvH, Hd, P, page, npt, ppb, scale,
                        stream);
}

// paged_decode_verify: Q queries a row, a bf16 pool (kv_int8 = 0) or an
// int8 pool with (P,) scales (kv_int8 = 1).
int paged_verify_run(int kv_int8, const void* q, const void* kpool,
                     const void* vpool, const void* kscale,
                     const void* vscale, const void* table,
                     const void* cache_len, void* out, int B, int Q, int H,
                     int KvH, int Hd, int P, int page, int npt, int ppb,
                     float scale, void* stream) {
  if (kv_int8)
    return launch<int8_t>(q, kpool, vpool, kscale, vscale, table, cache_len,
                          out, B, Q, H, KvH, Hd, P, page, npt, ppb, scale,
                          stream);
  return launch<__nv_bfloat16>(q, kpool, vpool, nullptr, nullptr, table,
                               cache_len, out, B, Q, H, KvH, Hd, P, page, npt,
                               ppb, scale, stream);
}

// Dynamic shared memory a launch takes (what the wrapper's smem_bytes
// computes).
long long paged_smem_bytes(int R, int Hd, int span, int ppb, int kv_bytes) {
  return (long long)smem_bytes(R, Hd, span, ppb, kv_bytes);
}

// Registers a thread and local (spilled) bytes of the bf16 (kv_int8 = 0)
// or int8 instance, as the compiler laid it out.
int paged_func_attrs(int kv_int8, int* regs, int* local_bytes) {
  cudaFuncAttributes attr;
  const cudaError_t err =
      kv_int8 ? cudaFuncGetAttributes(&attr, paged_decode_kernel<int8_t>)
              : cudaFuncGetAttributes(&attr, paged_decode_kernel<__nv_bfloat16>);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  return 0;
}

}  // extern "C"
