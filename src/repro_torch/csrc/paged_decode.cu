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
//   (B,) int32; out (B, Q, H, Hd) bf16; Hd 32, 64 or 128. Per row and
//   query the scores q.k * Hd^-0.5 (the scale after the dot), masked to
//   -1e30 (finite, as the reference: a query that sees no position
//   averages every gathered v line), an online softmax and its
//   accumulation in f32, out = acc / max(l, 1e-30) rounded once to bf16.
//   Page ids are clamped to [0, P). Reruns are bit-equal.
//
// What bounds it on this card. At a long context, the loads: every K and
// V line a row's table names through its last query is read once (B=8 x
// 8,192: 67 MB, 20 us at 3.35 TB/s, more than the 50 MB L2); the ring
// streams them at ~2 TB/s (a loads-only build of this kernel takes 33 of
// the call's 35 us; PERF.md §6). An int8 pool halves the bytes, and
// there the arithmetic bounds it: widening each chunk to bf16 costs more
// than its tensor-core products. At qwen2-1.5b's decode (B=4, KvH=2,
// Hd=128, a context of 1,024: 4.19 MB, 1.25 us) the lines stay in L2 from
// call to call, and a call is latency: the launch, the page ids' load, one
// round trip for a split's pages, one chunk a warp, the merge, and the
// combine kernel. The operations (4 x Q x H x lines x Hd) are far below
// the tensor cores' rate.
//
// Design (the TPU version is an XLA scan over gathered blocks, no
// pallas_call):
//   * split-KV (flash-decoding). The grid is (splits, KvH, B x RG): a CTA
//     of 4 warps per (split, kv head, row, row group). It holds the
//     row group's 16 x MT query rows of the kv head's group (r = j x G + g,
//     MT = 1 up to 16 rows, 2 up to 32; RG = ceil(G Q / 16 MT)). Its pages
//     come from cache_len on the card: a row's live pages (through its last
//     query), or all npt where some query sees nothing, split s taking
//     [s n / S, (s + 1) n / S) of them; a split may be empty. The host
//     never reads cache_len, so a call can be captured in a CUDA graph.
//   * the split's page ids (clamped) are loaded first, q beside them; the
//     ids to shared memory, an int8 pool's page scales by cp.async in the
//     first stage's group. The pages stream through a ring of nst stages
//     (up to 3) of sp = min(ppb, ceil(npt / S)) pages: K and V lines by
//     16-byte cp.async, one commit group a stage, a thread stepping one
//     16-byte column down the lines without dividing; stage i + nst - 1
//     loads while stage i is scored, so up to two stages are in flight.
//     One __syncthreads a stage (after cp.async.wait_group nst - 2); lines
//     past the stage's pages are zero-filled. Lines are padded by 16 bytes,
//     so ldmatrix's eight 16-byte rows fall on distinct banks.
//   * each warp takes 16-line chunks of a stage in turn and keeps its own
//     (m, l, acc) in registers. S = Q K^T and O += P V run on the tensor
//     cores (mma.sync m16n8k16, bf16 in, f32 accumulate): q's fragments
//     (in registers at one row tile), K by ldmatrix, V by ldmatrix.trans.
//     An int8 chunk is first widened to bf16 in the warp's own shared
//     memory (-127..127 are exact in bf16); its K scale multiplies the
//     dot, its V scale p. Scores are kept in log2 units (the scale times
//     log2 e) so every exponential is exp2f. p enters the product as three
//     bf16 parts (P_PARTS: 8 + 8 + 8 bits of the f32 p, each part the
//     rounding of what the earlier ones left), so the value product is
//     the contract's f32 p times v. Masked lines score -1e30; lines
//     outside the stage -inf (they drop out). A chunk that leaves every
//     row's max in place skips the rescale of acc (its factor is exactly
//     1). Q = 1 (G rows of 16) runs on the tensor cores too: at qwen2's
//     decode the chunks are ~7% of a call (PERF.md §6).
//   * the CTA's warps merge in warp order through shared memory. With
//     S = 1 the CTA writes out. Otherwise it writes its partial (m, l,
//     acc) for its rows to the scratch `part` (the wrapper's torch.empty),
//     and paged_combine_kernel, launched as its programmatic dependent
//     (scheduled while the split kernel runs, waiting for its writes),
//     merges the splits in split order: M = max m_s, w_s = exp2(m_s - M),
//     out = sum acc_s w_s / max(sum l_s w_s, 1e-30). An empty split
//     writes m = -1e30, l = 0, acc = 0 and adds nothing; in a row that
//     sees nothing every m_s is -1e30, every w_s 1, and out is the mean
//     of all its lines. No atomics: every sum runs in a fixed order, and
//     two launches give the same bits.
//
// Dynamic shared memory (paged_cuda.smem_bytes mirrors plan()):
//   q tile      16 MT rows x (2 Hd + 16) bytes, bf16
//   meta        ceil(npt / S) page ids (+ two f32 scales each for int8),
//               rounded up to 16 bytes
//   cvt         int8 only: 4 warps x 2 x 16 lines x (2 Hd + 16) bytes
//   ring/merge  max(nst stages x 2 x lines x (Hd x sizeof(KV) + 16),
//                   4 warps x 16 MT rows x (Hd + 2) f32)
//   with lines = sp x page rounded up to 16, nst the most stages (<= 3, <=
//   what a split needs) that keep the whole within 232,448 bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int CH = 16;                // lines a warp takes at once
constexpr int ROW_PAD = 16;           // bytes after each staged row
constexpr int MAX_STAGES = 3;
constexpr float NEG_INF = -1e30f;    // a masked score, as the reference
constexpr unsigned MINUS_INF_BITS = 0xff800000u;  // a line outside the stage
constexpr size_t SMEM_LIMIT = 232448; // opt-in shared memory of one CTA
// bf16 parts p enters the value product as: three carry p's 24 bits, so
// the product is the f32 p times v of the contract
constexpr int P_PARTS = 3;

struct Plan {
  int mt, rg, sp, lines, nst, maxp;
  size_t meta_off, cvt_off, ring_off, stage_bytes, smem;
};

inline size_t round16(size_t x) { return (x + 15) / 16 * 16; }

// the launch's shape: row tiles, stage size, ring depth and the shared
// memory layout (nst = 0: one stage does not fit)
Plan plan(int R, int Hd, int page, int npt, int ppb, int splits,
          int kv_bytes) {
  Plan p{};
  p.mt = R <= 16 ? 1 : 2;
  p.rg = (R + 16 * p.mt - 1) / (16 * p.mt);
  p.maxp = (npt + splits - 1) / splits;
  p.sp = ppb < p.maxp ? ppb : p.maxp;
  p.lines = (p.sp * page + CH - 1) / CH * CH;
  const int need = (p.maxp + p.sp - 1) / p.sp;
  const size_t qrow = (size_t)Hd * 2 + ROW_PAD;
  p.stage_bytes = 2 * (size_t)p.lines * ((size_t)Hd * kv_bytes + ROW_PAD);
  p.meta_off = 16 * (size_t)p.mt * qrow;
  p.cvt_off = p.meta_off + round16((size_t)p.maxp * 4 * (kv_bytes == 1 ? 3 : 1));
  p.ring_off = p.cvt_off + (kv_bytes == 1 ? WARPS * 2 * CH * qrow : 0);
  const size_t merge = (size_t)WARPS * 16 * p.mt * (Hd + 2) * 4;
  p.nst = 0;
  for (int n = need < MAX_STAGES ? need : MAX_STAGES; n >= 1; --n) {
    const size_t ring = n * p.stage_bytes;
    if (p.ring_off + (ring > merge ? ring : merge) <= SMEM_LIMIT) {
      p.nst = n;
      break;
    }
  }
  const size_t ring = (p.nst > 0 ? p.nst : 1) * p.stage_bytes;
  p.smem = p.ring_off + (ring > merge ? ring : merge);
  return p;
}

struct Params {
  const __nv_bfloat16* q;
  const void* kpool;
  const void* vpool;
  const float* kscale;
  const float* vscale;
  const int* table;
  const int* cache_len;
  __nv_bfloat16* out;
  float* part;   // splits > 1: acc (B KvH S, R, Hd), then m, l (B KvH S, R, 2)
  int Q, H, KvH, R, P, page, npt, splits, sp, lines, nst, maxp, rg;
  unsigned meta_off, cvt_off, ring_off, stage_bytes;
  float scale;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, or 16 zero bytes where ok is false
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}

// 4 bytes global -> shared (an int8 page's scale)
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a b: m16n8k16, bf16 in, f32 accumulate
__device__ __forceinline__ void mma16816(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  const __nv_bfloat162 v = __halves2bfloat162(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

template <typename KV, int HD, int MT>
__global__ void __launch_bounds__(THREADS)
    paged_split_kernel(const Params p) {
  constexpr bool kInt8 = sizeof(KV) == 1;
  constexpr int QROW = HD * 2 + ROW_PAD;           // bytes of a bf16 row
  constexpr int LINE = HD * (int)sizeof(KV) + ROW_PAD;
  constexpr int CPL = HD * (int)sizeof(KV) / 16;   // 16-byte chunks a line
  constexpr int NT = HD / 8;                       // n-tiles of acc
  extern __shared__ __align__(16) unsigned char smem[];
  const int split = blockIdx.x, kh = blockIdx.y;
  const int b = blockIdx.z / p.rg, row0 = blockIdx.z % p.rg * 16 * MT;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c = lane % 4;
  const int G = p.H / p.KvH;
  const float outside = __uint_as_float(MINUS_INF_BITS);
  // scores in log2 units: exp(x) = exp2(x log2 e), so m, the merges and
  // the combine all take exp2
  const float qk_scale = p.scale * 1.4426950408889634f;
  // the combine kernel may be scheduled now; it waits for this grid
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  unsigned char* qs = smem;
  int* ids = reinterpret_cast<int*>(smem + p.meta_off);
  float* ksc = reinterpret_cast<float*>(ids + p.maxp);
  float* vsc = ksc + p.maxp;
  unsigned char* cvt = smem + p.cvt_off + (size_t)warp * 2 * CH * QROW;
  unsigned char* ring = smem + p.ring_off;

  // this split's pages [lo, lo + np) of the row
  const int clen = p.cache_len[b];
  int n_pages = p.npt;
  if (clen - p.Q >= 0) n_pages = min(p.npt, (clen - 1) / p.page + 1);
  const int lo = (int)((long long)split * n_pages / p.splits);
  const int np = (int)((long long)(split + 1) * n_pages / p.splits) - lo;
  const int n_st = (np + p.sp - 1) / p.sp;

  // the page ids (what the first copies wait for), then q, in flight
  // together; the ids and scales and q to shared memory, one barrier
  const int* row_ids = p.table + (size_t)b * p.npt + lo;
  const int pid0 = tid < np ? min(max(row_ids[tid], 0), p.P - 1) : 0;
  constexpr int QCH = (16 * MT * (HD / 8) + THREADS - 1) / THREADS;
  uint4 qv[QCH];
#pragma unroll
  for (int k = 0; k < QCH; ++k) {
    const int i = tid + k * THREADS, r = i / (HD / 8), row = row0 + r;
    qv[k] = make_uint4(0u, 0u, 0u, 0u);
    if (i < 16 * MT * (HD / 8) && row < p.R)
      qv[k] = *reinterpret_cast<const uint4*>(
          p.q + ((size_t)(b * p.Q + row / G) * p.H + kh * G + row % G) * HD +
          i % (HD / 8) * 8);
  }
  for (int i = tid; i < np; i += THREADS) {
    const int pid = i == tid ? pid0 : min(max(row_ids[i], 0), p.P - 1);
    ids[i] = pid;
    if (kInt8) {  // in stage 0's commit group: they land with its lines
      cp_async4(ksc + i, p.kscale + pid);
      cp_async4(vsc + i, p.vscale + pid);
    }
  }
#pragma unroll
  for (int k = 0; k < QCH; ++k) {
    const int i = tid + k * THREADS;
    if (i < 16 * MT * (HD / 8))
      *reinterpret_cast<uint4*>(qs + i / (HD / 8) * QROW + i % (HD / 8) * 16) =
          qv[k];
  }
  // the query j of each of this thread's rows (r = j G + g)
  int jrow[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      jrow[mt][h] = min(row0 + mt * 16 + g + 8 * h, p.R - 1) / G;
  __syncthreads();

  const size_t head_off = (size_t)kh * HD * sizeof(KV);
  const size_t line_stride = (size_t)p.KvH * HD * sizeof(KV);
  // stage st's K and V lines into its slot by 16-byte cp.async, one
  // commit group a stage. A thread keeps one 16-byte column of the line
  // (THREADS / CPL lines a pass) and steps its page and line in the page
  // without dividing; lines past the stage's pages up to the chunk's end
  // are zero-filled
  auto issue = [&](int st) {
    if (st < n_st) {
      unsigned char* ks = ring + (size_t)(st % p.nst) * p.stage_bytes;
      unsigned char* vs = ks + (size_t)p.lines * LINE;
      const int pg0 = st * p.sp;
      const int nl = min(p.sp, np - pg0) * p.page;
      const int nl_pad = (nl + CH - 1) / CH * CH;
      constexpr int STEP = THREADS / CPL;
      const int cc = tid % CPL;
      int line = tid / CPL, pi = line / p.page, off = line % p.page;
      const unsigned char* kpool = static_cast<const unsigned char*>(p.kpool);
      const unsigned char* vpool = static_cast<const unsigned char*>(p.vpool);
      for (; line < nl_pad; line += STEP) {
        const bool ok = line < nl;
        const size_t at = ok ? ((size_t)ids[pg0 + pi] * p.page + off) *
                                       line_stride + head_off + cc * 16
                             : 0;
        cp_async16(ks + line * LINE + cc * 16, kpool + at, ok);
        cp_async16(vs + line * LINE + cc * 16, vpool + at, ok);
        for (off += STEP; off >= p.page; off -= p.page) ++pi;
      }
    }
    cp_async_commit();
  };

  // one row tile: q's A fragments once, in registers
  unsigned qreg[MT == 1 ? HD / 16 : 1][4];
  if constexpr (MT == 1) {
#pragma unroll
    for (int t = 0; t < HD / 16; ++t)
      ldsm_x4(qreg[t], qs + (lane % 8 + 8 * ((lane / 8) % 2)) * QROW +
                           (16 * t + 8 * (lane / 16)) * 2);
  }

  float acc[MT][NT][4];
  float m_r[MT][2], l_r[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][n][e] = 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m_r[mt][h] = NEG_INF;
      l_r[mt][h] = 0.f;
    }
  }

  for (int st = 0; st < p.nst - 1; ++st) issue(st);
  for (int st = 0; st < n_st; ++st) {
    if (p.nst == 1) issue(st);
    if (p.nst == 3)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();
    if (p.nst > 1) issue(st + p.nst - 1);

    const unsigned char* ks = ring + (size_t)(st % p.nst) * p.stage_bytes;
    const unsigned char* vs = ks + (size_t)p.lines * LINE;
    const int pg0 = st * p.sp;
    const int nl = min(p.sp, np - pg0) * p.page;
    const int pos0 = (lo + pg0) * p.page;
    for (int l0 = warp * CH; l0 < nl; l0 += WARPS * CH) {
      const unsigned char* kb = ks + l0 * LINE;
      const unsigned char* vb = vs + l0 * LINE;
      int stride = LINE;
      if (kInt8) {
        // widen the chunk's K and V lines to bf16 in this warp's own rows
        __syncwarp();
        for (int u = lane; u < 2 * CH * (HD / 16); u += 32) {
          const int t = u / (CH * (HD / 16)), w = u % (CH * (HD / 16));
          const int line = w / (HD / 16), cc = w % (HD / 16);
          const uint4 raw = *reinterpret_cast<const uint4*>(
              (t ? vb : kb) + line * LINE + cc * 16);
          const int8_t* v8 = reinterpret_cast<const int8_t*>(&raw);
          unsigned o[8];
#pragma unroll
          for (int e = 0; e < 8; ++e)
            o[e] = pack_bf16(__float2bfloat16_rn((float)v8[2 * e]),
                             __float2bfloat16_rn((float)v8[2 * e + 1]));
          uint4* dst = reinterpret_cast<uint4*>(cvt + (t * CH + line) * QROW +
                                                cc * 32);
          dst[0] = make_uint4(o[0], o[1], o[2], o[3]);
          dst[1] = make_uint4(o[4], o[5], o[6], o[7]);
        }
        __syncwarp();
        kb = cvt;
        vb = cvt + CH * QROW;
        stride = QROW;
      }

      // s[mt][nt]: rows mt*16 + (g, g + 8) x lines l0 + nt*8 + (2c, 2c + 1)
      float s[MT][2][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[mt][nt][e] = 0.f;
      if constexpr (MT == 1) {
        // q's fragments from registers; odd k-steps into a second sum, so
        // two dependent chains of products a tile instead of one
        float s2[2][4] = {};
#pragma unroll
        for (int t = 0; t < HD / 16; ++t) {
          unsigned kf[4];
          ldsm_x4(kf, kb + (lane % 8 + 8 * (lane / 16)) * stride +
                          (16 * t + 8 * ((lane / 8) % 2)) * 2);
          float (&d)[2][4] = t % 2 ? s2 : s[0];
          mma16816(d[0], qreg[t], kf[0], kf[1]);
          mma16816(d[1], qreg[t], kf[2], kf[3]);
        }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[0][nt][e] += s2[nt][e];
      } else {
        // (two row tiles: a shorter unroll, so the loads hoisted ahead of
        // the products fit the registers)
#pragma unroll 4
        for (int t = 0; t < HD / 16; ++t) {
          unsigned kf[4];
          ldsm_x4(kf, kb + (lane % 8 + 8 * (lane / 16)) * stride +
                          (16 * t + 8 * ((lane / 8) % 2)) * 2);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            unsigned qf[4];
            ldsm_x4(qf, qs + (mt * 16 + lane % 8 + 8 * ((lane / 8) % 2)) *
                                 QROW + (16 * t + 8 * (lane / 16)) * 2);
            mma16816(s[mt][0], qf, kf[0], kf[1]);
            mma16816(s[mt][1], qf, kf[2], kf[3]);
          }
        }
      }

      // scale, mask, online softmax (a row's 4 lanes share it); an int8
      // line's scales by its page, at use
      auto page_of = [&](int nt, int e) {
        return pg0 + min(l0 + nt * 8 + 2 * c + e, nl - 1) / p.page;
      };
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float mx = outside;
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int line = l0 + nt * 8 + 2 * c + e;
              float x = s[mt][nt][2 * h + e];
              if (kInt8) x *= ksc[page_of(nt, e)];
              x *= qk_scale;
              x = pos0 + line <= clen - p.Q + jrow[mt][h] ? x : NEG_INF;
              x = line < nl ? x : outside;
              s[mt][nt][2 * h + e] = x;
              mx = fmaxf(mx, x);
            }
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          const float m_new = fmaxf(m_r[mt][h], mx);
          const float corr = exp2f(m_r[mt][h] - m_new);
          float sum = 0.f;
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float pe = exp2f(s[mt][nt][2 * h + e] - m_new);
              sum += pe;
              s[mt][nt][2 * h + e] = pe;
            }
          l_r[mt][h] = l_r[mt][h] * corr + sum;
          m_r[mt][h] = m_new;
          // a max that did not move leaves acc as it is (corr is exactly 1)
          if (!__all_sync(0xffffffffu, corr == 1.f)) {
#pragma unroll
            for (int n = 0; n < NT; ++n) {
              acc[mt][n][2 * h] *= corr;
              acc[mt][n][2 * h + 1] *= corr;
            }
          }
        }
      }

      // acc += p v, p as P_PARTS bf16 parts (an int8 line's V scale in p)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        unsigned ap[P_PARTS][4];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float p0 = s[mt][nt][2 * h], p1 = s[mt][nt][2 * h + 1];
            if (kInt8) {
              p0 *= vsc[page_of(nt, 0)];
              p1 *= vsc[page_of(nt, 1)];
            }
#pragma unroll
            for (int k = 0; k < P_PARTS; ++k) {
              const __nv_bfloat162 part = __floats2bfloat162_rn(p0, p1);
              ap[k][2 * nt + h] = *reinterpret_cast<const unsigned*>(&part);
              p0 -= __low2float(part);   // exact: the rest of p
              p1 -= __high2float(part);
            }
          }
#pragma unroll
        for (int dp = 0; dp < HD / 16; ++dp) {
          unsigned vf[4];
          ldsm_x4_trans(vf, vb + (lane % 8 + 8 * ((lane / 8) % 2)) * stride +
                                (16 * dp + 8 * (lane / 16)) * 2);
#pragma unroll
          for (int k = 0; k < P_PARTS; ++k) {
            mma16816(acc[mt][2 * dp], ap[k], vf[0], vf[1]);
            mma16816(acc[mt][2 * dp + 1], ap[k], vf[2], vf[3]);
          }
        }
      }
    }
    if (p.nst == 1) __syncthreads();
  }

  // l over the row's 4 lanes, then the warps merged in warp order
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l_r[mt][h] += __shfl_xor_sync(0xffffffffu, l_r[mt][h], 1);
      l_r[mt][h] += __shfl_xor_sync(0xffffffffu, l_r[mt][h], 2);
    }
  cp_async_wait<0>();
  __syncthreads();   // the ring is free: the merge area overlays it
  constexpr int MROW = HD + 2;
  float* mg = reinterpret_cast<float*>(ring);
  {
    float* mine = mg + (size_t)warp * 16 * MT * MROW;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float* row = mine + (mt * 16 + g + 8 * h) * MROW;
#pragma unroll
        for (int n = 0; n < NT; ++n)
          *reinterpret_cast<float2*>(row + 8 * n + 2 * c) =
              make_float2(acc[mt][n][2 * h], acc[mt][n][2 * h + 1]);
        if (c == 0) {
          row[HD] = m_r[mt][h];
          row[HD + 1] = l_r[mt][h];
        }
      }
  }
  __syncthreads();
  const int rows = min(16 * MT, p.R - row0);
  const size_t bks = ((size_t)b * p.KvH + kh) * p.splits + split;
  for (int i = tid; i < rows * (HD / 2); i += THREADS) {
    const int r = i / (HD / 2), d = 2 * (i % (HD / 2));
    float big = NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w)
      big = fmaxf(big, mg[((size_t)w * 16 * MT + r) * MROW + HD]);
    float den = 0.f, a0 = 0.f, a1 = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float* row = mg + ((size_t)w * 16 * MT + r) * MROW;
      const float wt = exp2f(row[HD] - big);
      den += row[HD + 1] * wt;
      a0 += row[d] * wt;
      a1 += row[d + 1] * wt;
    }
    const int rr = row0 + r;
    if (p.splits == 1) {
      den = fmaxf(den, 1e-30f);
      const int j = rr / G, gg = rr % G;
      *reinterpret_cast<__nv_bfloat162*>(
          p.out + ((size_t)(b * p.Q + j) * p.H + kh * G + gg) * HD + d) =
          __halves2bfloat162(__float2bfloat16_rn(a0 / den),
                             __float2bfloat16_rn(a1 / den));
    } else {
      *reinterpret_cast<float2*>(p.part + (bks * p.R + rr) * HD + d) =
          make_float2(a0, a1);
      if (d == 0) {
        float* ml = p.part + (size_t)gridDim.z / p.rg * p.KvH * p.splits *
                                 p.R * HD;
        *reinterpret_cast<float2*>(ml + (bks * p.R + rr) * 2) =
            make_float2(big, den);
      }
    }
  }
}

// out from the splits' partials, in split order: a warp per (row, kv
// head, query row), a lane per 4 columns. The largest m over the splits
// first (lanes over splits, a max tree: exact in any order), then the
// splits in order 0..S-1, eight partials' loads in flight at a time.
// Launched as a programmatic dependent of the split kernel: it may be
// resident early and waits here for that grid's writes.
constexpr int COMBINE_AHEAD = 8;

__global__ void __launch_bounds__(128)
    paged_combine_kernel(const float* part, __nv_bfloat16* out, int B, int Q,
                         int H, int KvH, int R, int Hd, int splits) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int lane = threadIdx.x % 32;
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  if (row >= B * KvH * R) return;
  const int r = row % R, bk = row / R;
  const bool on = 4 * lane < Hd;
  const float* acc_at = part + ((size_t)bk * splits * R + r) * Hd + 4 * lane;
  const float2* ml = reinterpret_cast<const float2*>(
                         part + (size_t)B * KvH * splits * R * Hd) +
                     (size_t)bk * splits * R + r;
  float big = NEG_INF;
  for (int s = lane; s < splits; s += 32) big = fmaxf(big, ml[(size_t)s * R].x);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    big = fmaxf(big, __shfl_xor_sync(0xffffffffu, big, o));
  float den = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s0 = 0; s0 < splits; s0 += COMBINE_AHEAD) {
    float4 a[COMBINE_AHEAD];
    float2 m_l[COMBINE_AHEAD];
#pragma unroll
    for (int k = 0; k < COMBINE_AHEAD; ++k) {
      const bool in = s0 + k < splits;
      a[k] = in && on ? *reinterpret_cast<const float4*>(
                            acc_at + (size_t)(s0 + k) * R * Hd)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
      m_l[k] = in ? ml[(size_t)(s0 + k) * R] : make_float2(NEG_INF, 0.f);
    }
#pragma unroll
    for (int k = 0; k < COMBINE_AHEAD; ++k) {
      if (s0 + k < splits) {
        const float wt = exp2f(m_l[k].x - big);
        den += m_l[k].y * wt;
        acc.x += a[k].x * wt;
        acc.y += a[k].y * wt;
        acc.z += a[k].z * wt;
        acc.w += a[k].w * wt;
      }
    }
  }
  if (!on) return;
  den = fmaxf(den, 1e-30f);
  const int G = H / KvH, b = bk / KvH, kh = bk % KvH, j = r / G, g = r % G;
  __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(
      out + ((size_t)(b * Q + j) * H + kh * G + g) * Hd + 4 * lane);
  o[0] = __halves2bfloat162(__float2bfloat16_rn(acc.x / den),
                            __float2bfloat16_rn(acc.y / den));
  o[1] = __halves2bfloat162(__float2bfloat16_rn(acc.z / den),
                            __float2bfloat16_rn(acc.w / den));
}

using KernelFn = void (*)(const Params);

// the instance for (KV, Hd, MT); the 227 KB shared-memory attribute is set
// once an instance, at its first use (never inside a graph capture that
// follows a first call)
template <typename KV, int HD, int MT>
KernelFn instance(cudaError_t* err) {
  static const cudaError_t set = cudaFuncSetAttribute(
      paged_split_kernel<KV, HD, MT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_LIMIT);
  *err = set;
  return paged_split_kernel<KV, HD, MT>;
}

KernelFn pick(int kv_bytes, int hd, int mt, cudaError_t* err) {
  *err = cudaSuccess;
  if (kv_bytes == 2) {
    if (hd == 32) return mt == 1 ? instance<__nv_bfloat16, 32, 1>(err)
                                 : instance<__nv_bfloat16, 32, 2>(err);
    if (hd == 64) return mt == 1 ? instance<__nv_bfloat16, 64, 1>(err)
                                 : instance<__nv_bfloat16, 64, 2>(err);
    if (hd == 128) return mt == 1 ? instance<__nv_bfloat16, 128, 1>(err)
                                  : instance<__nv_bfloat16, 128, 2>(err);
  } else {
    if (hd == 32) return mt == 1 ? instance<int8_t, 32, 1>(err)
                                 : instance<int8_t, 32, 2>(err);
    if (hd == 64) return mt == 1 ? instance<int8_t, 64, 1>(err)
                                 : instance<int8_t, 64, 2>(err);
    if (hd == 128) return mt == 1 ? instance<int8_t, 128, 1>(err)
                                  : instance<int8_t, 128, 2>(err);
  }
  *err = cudaErrorInvalidValue;
  return nullptr;
}

int launch(int kv_bytes, const void* q, const void* kpool, const void* vpool,
           const void* kscale, const void* vscale, const void* table,
           const void* cache_len, void* out, void* part, int B, int Q, int H,
           int KvH, int Hd, int P, int page, int npt, int ppb, int splits,
           float scale, void* stream) {
  if (B <= 0 || Q <= 0 || KvH <= 0 || H % KvH != 0 || H <= 0 ||
      (Hd != 32 && Hd != 64 && Hd != 128) || P <= 0 || page <= 0 || npt <= 0 ||
      ppb <= 0 || npt % ppb != 0 || splits <= 0 ||
      (uintptr_t)q % 16 != 0 || (uintptr_t)kpool % 16 != 0 ||
      (uintptr_t)vpool % 16 != 0 || (splits > 1 && part == nullptr) ||
      (kv_bytes == 1 && (kscale == nullptr || vscale == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int R = (H / KvH) * Q;
  const Plan pl = plan(R, Hd, page, npt, ppb, splits, kv_bytes);
  if (pl.nst == 0 || (long long)B * pl.rg > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
  const KernelFn fn = pick(kv_bytes, Hd, pl.mt, &err);
  if (err != cudaSuccess) return (int)err;
  Params p{static_cast<const __nv_bfloat16*>(q),
           kpool,
           vpool,
           static_cast<const float*>(kscale),
           static_cast<const float*>(vscale),
           static_cast<const int*>(table),
           static_cast<const int*>(cache_len),
           static_cast<__nv_bfloat16*>(out),
           static_cast<float*>(part),
           Q, H, KvH, R, P, page, npt, splits, pl.sp, pl.lines, pl.nst,
           pl.maxp, pl.rg,
           (unsigned)pl.meta_off, (unsigned)pl.cvt_off, (unsigned)pl.ring_off,
           (unsigned)pl.stage_bytes, scale};
  const cudaStream_t s = (cudaStream_t)stream;
  fn<<<dim3(splits, KvH, B * pl.rg), THREADS, pl.smem, s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const long long warps = (long long)B * KvH * R;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((warps + 3) / 4));
  cfg.blockDim = dim3(128);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, paged_combine_kernel,
                           static_cast<const float*>(part),
                           static_cast<__nv_bfloat16*>(out), B, Q, H, KvH, R,
                           Hd, splits);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each entry point launches on `stream` and returns cudaGetLastError() (0
// when the launches were accepted); cudaErrorInvalidValue for a shape,
// alignment or block it does not take. `part` is the f32 scratch of
// splits > 1 (B x KvH x splits x R x (Hd + 2) floats, R = H / KvH x Q);
// it may be null at splits = 1.

// paged_decode_gather: one query a row (Q = 1), bf16 pool.
int paged_gather_run(const void* q, const void* kpool, const void* vpool,
                     const void* table, const void* cache_len, void* out,
                     void* part, int B, int H, int KvH, int Hd, int P,
                     int page, int npt, int ppb, int splits, float scale,
                     void* stream) {
  return launch(2, q, kpool, vpool, nullptr, nullptr, table, cache_len, out,
                part, B, 1, H, KvH, Hd, P, page, npt, ppb, splits, scale,
                stream);
}

// paged_decode_int8: one query a row (Q = 1), int8 pool with (P,) scales.
int paged_int8_run(const void* q, const void* kpool, const void* vpool,
                   const void* kscale, const void* vscale, const void* table,
                   const void* cache_len, void* out, void* part, int B, int H,
                   int KvH, int Hd, int P, int page, int npt, int ppb,
                   int splits, float scale, void* stream) {
  return launch(1, q, kpool, vpool, kscale, vscale, table, cache_len, out,
                part, B, 1, H, KvH, Hd, P, page, npt, ppb, splits, scale,
                stream);
}

// paged_decode_verify: Q queries a row, a bf16 pool (kv_int8 = 0) or an
// int8 pool with (P,) scales (kv_int8 = 1).
int paged_verify_run(int kv_int8, const void* q, const void* kpool,
                     const void* vpool, const void* kscale,
                     const void* vscale, const void* table,
                     const void* cache_len, void* out, void* part, int B,
                     int Q, int H, int KvH, int Hd, int P, int page, int npt,
                     int ppb, int splits, float scale, void* stream) {
  return launch(kv_int8 ? 1 : 2, q, kpool, vpool, kscale, vscale, table,
                cache_len, out, part, B, Q, H, KvH, Hd, P, page, npt, ppb,
                splits, scale, stream);
}

// Dynamic shared memory of a launch (what the wrapper's smem_bytes
// computes; above 232,448 when not even one stage fits) and its ring's
// stages (0: it does not fit).
long long paged_smem_bytes(int R, int Hd, int page, int npt, int ppb,
                           int splits, int kv_bytes, int* stages) {
  const Plan pl = plan(R, Hd, page, npt, ppb, splits, kv_bytes);
  *stages = pl.nst;
  return (long long)pl.smem;
}

// Registers a thread and local (spilled) bytes of the instance for an
// int8 (kv_int8 = 1) or bf16 pool, head dim Hd and row_tiles 16-row tiles
// (row_tiles 0: the combine kernel).
int paged_func_attrs(int kv_int8, int Hd, int row_tiles, int* regs,
                     int* local_bytes) {
  cudaFuncAttributes attr;
  cudaError_t err;
  if (row_tiles == 0) {
    err = cudaFuncGetAttributes(&attr, paged_combine_kernel);
  } else {
    const KernelFn fn = pick(kv_int8 ? 1 : 2, Hd, row_tiles, &err);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncGetAttributes(&attr, fn);
  }
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  return 0;
}

// CTAs of a launch one SM holds at once (cudaOccupancyMaxActiveBlocksPer
// Multiprocessor at the launch's shared memory).
int paged_occupancy(int kv_int8, int R, int Hd, int page, int npt, int ppb,
                    int splits, int* blocks) {
  const Plan pl = plan(R, Hd, page, npt, ppb, splits, kv_int8 ? 1 : 2);
  if (pl.nst == 0) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  const KernelFn fn = pick(kv_int8 ? 1 : 2, Hd, pl.mt, &err);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, fn, THREADS, pl.smem);
}

}  // extern "C"
