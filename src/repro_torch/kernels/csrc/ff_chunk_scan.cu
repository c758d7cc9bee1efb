// Gated linear-attention scan (Mamba2 inclusive / RWKV6 exclusive with the
// bonus u) for the H100 (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ff_chunk_scan/kernel.py
// (build_program / _chunk_body / chunk_scan_ff): per bh row the recurrence
//   h_t = diag(exp(lw_t)) h_{t-1} + k_t (x) v_t
//   inclusive: y_t = q_t . h_t
//   exclusive: y_t = q_t . (h_{t-1} + diag(u) k_t (x) v_t)
// with the [N,P] state carried in f32 across chunks of L rows. On the TPU the
// grid walked (bh, chunk) words in order, four pipes streaming the q, k, v
// and log_w tiles, and kept the state in VMEM scratch across grid steps;
// blocks here run in no order, so a block owns a bh row (and a slice of P's
// columns) and walks the row's chunks in a loop, the state on chip.
//
// Numerics (the reference's decay-to-boundary factorization, kept so that
// every exponent is <= 0 and a strong decay underflows to 0 instead of
// overflowing): with cw the chunk's inclusive cumsum of lw and cq = cw
// (inclusive) or cw - lw (exclusive),
//   carried state:      (q_l e^{cq_l}) . h
//   earlier subtiles:   through the boundary b = the last row before the
//                       subtile, q_l e^{cq_l - cw_b} against k_s e^{cw_b -
//                       cw_s}
//   diagonal subtile:   sum_n q_l e^{min(cq_l - cw_s, 0)} k_s, masked
//                       s <= l (inclusive) or s < l (exclusive)
//   bonus:              (sum_n q_l u k_l) v_l
//   state update:       h = e^{cw_last} h + sum_l (k_l e^{cw_last - cw_l}) v_l
//
// Bound on this card: each input element is read once and each output
// written once, bh*s*(3n+2p) elements; the work per chunk is about
// 2*L*N*P*2 + L^2*(N+P) operations (reference ops.py:chunk_scan_cost), so
// at N = P = 64 it is bound by bytes (42 MB at rwkv6-7b's 4 x 256 tokens,
// about 12.5 us at the data sheet's 3.35 TB/s). What the bytes bound
// leaves out is the diagonal subtile's exact exponents: 16 x 16 / 2 x N
// of them per 16 rows, on the SM's 16 special-function lanes a clock.
//
// Two bodies; ops.py picks one from the types and shapes alone:
//
// ring_scan_kernel (q, k and v bfloat16, N in {16, 32, 64, 128}, P a
// multiple of 16, chunk a multiple of 16, subtile 16): one block per (bh
// row, slice of P's columns, ops.py _plan), four consumer warps for 64
// columns (one warp per 16) and one producer warp. The producer streams
// the row's rows 16 at a time (one subtile: q, k and log_w [16, N], v [16,
// cols]) through a ring_pipe.cuh ring of ``depth`` shared-memory stages,
// by 16-byte cp.async with zero fill past S (so rows past S read as zero,
// as the reference's padding gives), each stage in ``streams`` parts of
// its rows issued in turn, completing on the stage's full mbarrier. The
// kernel takes the ring's mbarriers and cp.async from ring_pipe.cuh but
// lays its stages out itself (rows padded by 16 bytes, not the bf16
// swizzle of the TMA users), so log_w arrives in its own type (f32 for
// Mamba2, bf16 for RWKV6) in the producer's stage area and the other
// users of the ring are untouched. At depth 1 the producer cannot fetch a
// word before the last one is released: the synchronous baseline. Per
// word the consumers
//   A  carry the chunk's cumsum over the 16 rows (in log2 units, one thread
//      a column; two roles of N threads each recompute it, so the cumsum
//      and every exponent after it is the same value in both) and write q
//      decayed from the boundary (qi), from the chunk start (qd = qi
//      e^{cw_b}) and k decayed to the subtile's end (ke) as bf16 tiles;
//   B  take the diagonal subtile's scores with exact pairwise exponents,
//      one thread for each of the 120 pairs below the diagonal (no masked
//      pair is computed, so none needs the clamp), eight more for the
//      diagonal itself (exponent 0, a dot product) or, exclusive, the
//      bonus; rounded to bf16;
//   C  per warp, its 16 columns on the tensor cores (mma.sync m16n8k16,
//      bf16 in, f32 accumulate): y = qd . h + qi . z + D . v (+ bonus), the
//      carried and the chunk's terms in two accumulator chains, then
//      z = e^{cw_e - cw_b} z + ke^T . v.
// z is the chunk's state at the subtile boundary (the sum over earlier
// subtiles of k_s e^{cw_b - cw_s} (x) v_s), so qi . z is the reference's
// earlier-subtile scores times v with the sum over s taken before the
// product over n: the same terms, the same exponents, no per-pair work.
// At a chunk's end h = e^{cw_last} h + z and z = 0. z lives in the
// consumer warps' registers in the accumulator layout, transposed (the
// warp's 16 columns by N), so that it feeds the next product as a B
// operand without a trip through shared memory; h, which changes once a
// chunk, is kept in f32 in shared memory in the same per-lane layout and
// as bf16 B operands in registers. Neither reaches device memory. The
// derived tiles are double-buffered by word, so a word takes two consumer
// barriers. The consumers' work is latency-bound (a word's three passes
// follow one another in a block), so the SM count and the blocks an SM
// holds set the time: _plan keeps a row's work in one block (splitting P
// repeats passes A and B in every slice, and measured slower), and the
// register cap below lets three blocks share an SM. Rounding: the
// decayed operands (qd, qi, ke), the diagonal scores and h and z as
// operands are rounded to bf16 once for their product; cumsums,
// exponents, sums and the carried h and z are f32.
// Exponents use ex2.approx on log2-scaled cumsums (relative error ~2^-22,
// under bf16's 2^-9).
//
// chunk_scan_kernel (every other case, f32 among them: the CUDA-core body
// of the first port): one block of 512 threads per (bh row, slice of P),
// walking the row's chunks, everything in f32 fmaf chains from shared
// memory, expf (not the fast approximation). Nothing of a chunk is held
// whole, its cumsum cw neither: shared memory grows as subtile x N and
// with the state N x p, never with the chunk, and ops.py splits P when one
// block cannot hold the state (N = P = 256 at any chunk runs as four
// slices of 64 columns). The cumsum is carried a subtile at a time: one
// thread a column adds the subtile's lw rows (read from L2) to the
// running sum it carries in an [N] vector, and where an earlier row's
// cumsum is needed again (the earlier subtiles' k decayed to the
// boundary, the state update) it is recomputed by the same additions in
// the same order, so every exponent is the bits of a whole-chunk cumsum.
// Per chunk:
//   * per subtile of rows: its cumsum (from the boundary row's, carried);
//     its q, k, v and q-side exponent cq staged (each
//     stream f32 or bf16 on its own, a row past S read as zero), the scaled
//     q tiles and the bonus; then the earlier subtiles of the chunk a block
//     of subtile rows at a time, their k decayed to the boundary as it is
//     staged (k and v re-read from L2), each block's scores and its terms
//     of the intra sums, carried in shared memory; then the diagonal block
//     by exact pairwise exponents, and the output rows;
//   * the state update, in passes over h of kThreads * kPer elements held
//     in registers, the chunk's k (decayed to its end by the cumsum
//     carried again) and v streamed again a subtile at a time; h itself is
//     overwritten only after the chunk's outputs have read it.
// Every output is one fmaf chain in a fixed order: the inter sum over N,
// the intra sum over the chunk's earlier rows in order, the bonus last.
// Row-indexed [*, N] tiles have a padded stride N+1 so that threads on
// consecutive rows hit distinct banks. ``depth`` and ``streams`` do not
// apply to this body.

#include "ring_pipe.cuh"

namespace {

using bf16 = __nv_bfloat16;

// ===========================================================================
// The CUDA-core body
// ===========================================================================

constexpr int kThreads = 512;
constexpr int kPer = 8;   // state elements a thread carries in one pass

// A stream element as f32, from a float or a bfloat16 array.
__device__ __forceinline__ float ld(const void* p, bool b16, long long i) {
  return b16 ? __bfloat162float(static_cast<const bf16*>(p)[i])
             : static_cast<const float*>(p)[i];
}

// The layout of the dynamic shared memory, in floats (mirrored by
// ops.py:smem_bytes), p being the block's slice of columns: the state
// [N, p]; per subtile (st rows) its cumsum, q, k, cq and the two scaled q
// tiles [st, N+1], a block of earlier k [st, N+1] (also the k rows of the
// state update), the subtile's v and a block of earlier v [st, p], the
// intra sums [st, p], the scores [st, st], the bonus per row; and six [N]
// vectors (the last row's cumsum and its decay, u, the cumsum carried to
// the subtile's boundary and past it, and one carried over earlier rows).
struct Smem {
  float *cs, *h, *qs, *ks, *cq, *qi, *qd, *kp, *vs, *vp, *ia, *sc, *cu,
      *cwl, *dl, *u, *cb, *cn, *cj;
};

__host__ __device__ inline long long smem_floats(int n, int p, int st) {
  const long long np = n + 1;
  return (long long)n * p + 7LL * st * np + 3LL * st * p +
         (long long)st * st + st + 6LL * n;
}

__device__ inline Smem carve(float* base, int n, int p, int st) {
  const int np = n + 1;
  Smem m;
  m.cs = base;
  m.h = m.cs + st * np;
  m.qs = m.h + n * p;
  m.ks = m.qs + st * np;
  m.cq = m.ks + st * np;
  m.qi = m.cq + st * np;
  m.qd = m.qi + st * np;
  m.kp = m.qd + st * np;
  m.vs = m.kp + st * np;
  m.vp = m.vs + st * p;
  m.ia = m.vp + st * p;
  m.sc = m.ia + st * p;
  m.cu = m.sc + st * st;
  m.cwl = m.cu + st;
  m.dl = m.cwl + n;
  m.u = m.dl + n;
  m.cb = m.u + n;
  m.cn = m.cb + n;
  m.cj = m.cn + n;
  return m;
}

enum : int { kQBf16 = 1, kKBf16 = 2, kVBf16 = 4, kWBf16 = 8, kUBf16 = 16 };

// p: this block's columns (blockIdx.y's slice); ldp: v's and out's row
// length.
__global__ void __launch_bounds__(kThreads)
    chunk_scan_kernel(const void* __restrict__ q, const void* __restrict__ k,
                      const void* __restrict__ v, const void* __restrict__ w,
                      const void* __restrict__ u, void* __restrict__ out,
                      int s, int n, int p, int ldp, int chunk, int st,
                      int inclusive, int types) {
  extern __shared__ float smem[];
  const Smem m = carve(smem, n, p, st);
  const int np = n + 1;
  const int tid = threadIdx.x;
  const long long bh = blockIdx.x;
  const long long qk_base = bh * s * n,
                  v_base = bh * s * ldp + (long long)blockIdx.y * p;
  const bool q16 = types & kQBf16, k16 = types & kKBf16, v16 = types & kVBf16,
             w16 = types & kWBf16, u16 = types & kUBf16;
  const bool has_u = u != nullptr;
  // row l (of the sequence) of a stream, zero past S
  auto qk_row = [&](const void* x, bool b16, int l, int c) {
    return l < s ? ld(x, b16, qk_base + (long long)l * n + c) : 0.0f;
  };
  auto v_row = [&](int l, int c) {
    return l < s ? ld(v, v16, v_base + (long long)l * ldp + c) : 0.0f;
  };
  auto lw_row = [&](int l, int c) {
    return l < s ? fminf(ld(w, w16, qk_base + (long long)l * n + c), 0.0f)
                 : 0.0f;
  };

  // The cumsum of rows l0 .. l0+st-1 into kp, one thread a column carrying
  // the running sum in run[c] (the cumsum of the row before l0) on to the
  // subtile's last row; then kp is rewritten in place element by element.
  auto cum_rows = [&](int l0, float* run) {
    for (int c = tid; c < n; c += kThreads) {
      float x = run[c];
      for (int r = 0; r < st; ++r) {
        x += lw_row(l0 + r, c);
        m.kp[r * np + c] = x;
      }
      run[c] = x;
    }
    __syncthreads();
  };

  for (int i = tid; i < n * p; i += kThreads) m.h[i] = 0.0f;
  if (has_u)
    for (int c = tid; c < n; c += kThreads) m.u[c] = ld(u, u16, bh * n + c);

  for (int c0 = 0; c0 < s; c0 += chunk) {
    // cb: the cumsum at the subtile's boundary row t0 - 1 (0 before the
    // chunk); cn: at the subtile's last row. They swap a subtile.
    float* cb = m.cb;
    float* cn = m.cn;
    for (int c = tid; c < n; c += kThreads) cb[c] = 0.0f;
    for (int t0 = 0; t0 < chunk; t0 += st) {
      const float* cwb = t0 ? cb : nullptr;
      // ---- the subtile's cumsum, one thread a column from the boundary's
      __syncthreads();
      for (int c = tid; c < n; c += kThreads) {
        float run = cb[c];
        for (int r = 0; r < st; ++r) {
          run += lw_row(c0 + t0 + r, c);
          m.cs[r * np + c] = run;
        }
        cn[c] = run;
      }
      __syncthreads();
      // ---- this subtile's rows: q, k, the q-side exponent, and q decayed
      //      from the chunk start and from the boundary
      for (int i = tid; i < st * n; i += kThreads) {
        const int r = i / n, c = i - r * n, l = c0 + t0 + r;
        const float qv = qk_row(q, q16, l, c);
        const float run = m.cs[r * np + c];
        const float e = inclusive ? run : run - lw_row(l, c);
        m.qs[r * np + c] = qv;
        m.ks[r * np + c] = qk_row(k, k16, l, c);
        m.cq[r * np + c] = e;
        m.qd[r * np + c] = qv * expf(e);
        m.qi[r * np + c] = qv * expf(e - (cwb ? cwb[c] : 0.0f));
      }
      for (int i = tid; i < st * p; i += kThreads) {
        const int r = i / p, c = i - r * p;
        m.vs[i] = v_row(c0 + t0 + r, c);
        m.ia[i] = 0.0f;
      }
      __syncthreads();
      if (has_u)
        for (int r = tid; r < st; r += kThreads) {
          float acc = 0.0f;
          for (int c = 0; c < n; ++c)
            acc = fmaf(m.qs[r * np + c] * m.u[c], m.ks[r * np + c], acc);
          m.cu[r] = acc;
        }

      // ---- the earlier subtiles of the chunk, a block of st rows at a
      //      time: k decayed to the boundary (the rows' cumsum carried
      //      again in cj), the scores by the boundary factorization, their
      //      terms of the intra sums
      for (int c = tid; c < n; c += kThreads) m.cj[c] = 0.0f;
      for (int j0 = 0; j0 < t0; j0 += st) {
        cum_rows(c0 + j0, m.cj);
        for (int i = tid; i < st * n; i += kThreads) {
          const int j = i / n, c = i - j * n;
          m.kp[j * np + c] = qk_row(k, k16, c0 + j0 + j, c) *
                             expf(cwb[c] - m.kp[j * np + c]);
        }
        for (int i = tid; i < st * p; i += kThreads) {
          const int j = i / p, c = i - j * p;
          m.vp[i] = v_row(c0 + j0 + j, c);
        }
        __syncthreads();
        for (int i = tid; i < st * st; i += kThreads) {
          const int r = i / st, j = i - r * st;
          const float* a = m.qi + r * np;
          const float* b = m.kp + j * np;
          float acc = 0.0f;
          for (int c = 0; c < n; ++c) acc = fmaf(a[c], b[c], acc);
          m.sc[i] = acc;
        }
        __syncthreads();
        for (int i = tid; i < st * p; i += kThreads) {
          const int r = i / p, c = i - r * p;
          float acc = m.ia[i];
          for (int j = 0; j < st; ++j)
            acc = fmaf(m.sc[r * st + j], m.vp[j * p + c], acc);
          m.ia[i] = acc;
        }
        __syncthreads();
      }

      // ---- the diagonal block: exact pairwise exponents, masked
      for (int i = tid; i < st * st; i += kThreads) {
        const int r = i / st, j = i - r * st;
        float acc = 0.0f;
        if (inclusive ? r >= j : r > j) {
          const float* ql = m.qs + r * np;
          const float* cql = m.cq + r * np;
          const float* cws = m.cs + j * np;
          const float* ks = m.ks + j * np;
          for (int c = 0; c < n; ++c)
            acc = fmaf(ql[c] * expf(fminf(cql[c] - cws[c], 0.0f)), ks[c],
                       acc);
        }
        m.sc[i] = acc;
      }
      __syncthreads();

      // ---- the subtile's output rows
      for (int i = tid; i < st * p; i += kThreads) {
        const int r = i / p, c = i - r * p, l = c0 + t0 + r;
        float inter = 0.0f;
        for (int e = 0; e < n; ++e)
          inter = fmaf(m.qd[r * np + e], m.h[e * p + c], inter);
        float intra = m.ia[i];
        for (int j = 0; j < st; ++j)
          intra = fmaf(m.sc[r * st + j], m.vs[j * p + c], intra);
        float y = inter + intra;
        if (has_u) y = fmaf(m.cu[r], m.vs[r * p + c], y);
        if (l < s) {
          const long long g = v_base + (long long)l * ldp + c;
          if (q16)
            static_cast<bf16*>(out)[g] = __float2bfloat16_rn(y);
          else
            static_cast<float*>(out)[g] = y;
        }
      }
      __syncthreads();
      float* const t = cb;
      cb = cn;
      cn = t;
    }
    // cb now holds the cumsum at the chunk's last row
    for (int c = tid; c < n; c += kThreads) {
      const float run = cb[c];
      m.cwl[c] = run;
      m.dl[c] = expf(run);
    }

    // ---- the state update: h = e^{cw_last} h + sum_l (k_l e^{cw_last -
    //      cw_l}) v_l, each element one chain over the chunk's rows
    for (int g0 = 0; g0 < n * p; g0 += kThreads * kPer) {
      float acc[kPer];
#pragma unroll
      for (int x = 0; x < kPer; ++x) acc[x] = 0.0f;
      __syncthreads();  // the previous pass is done with cj and cwl is set
      for (int c = tid; c < n; c += kThreads) m.cj[c] = 0.0f;
      for (int l0 = 0; l0 < chunk; l0 += st) {
        cum_rows(c0 + l0, m.cj);
        for (int i = tid; i < st * n; i += kThreads) {
          const int r = i / n, c = i - r * n;
          m.kp[r * np + c] = qk_row(k, k16, c0 + l0 + r, c) *
                             expf(m.cwl[c] - m.kp[r * np + c]);
        }
        for (int i = tid; i < st * p; i += kThreads) {
          const int r = i / p, c = i - r * p;
          m.vp[i] = v_row(c0 + l0 + r, c);
        }
        __syncthreads();
#pragma unroll
        for (int x = 0; x < kPer; ++x) {
          const int i = g0 + x * kThreads + tid;
          if (i < n * p) {
            const int e = i / p, c = i - e * p;
            float a = acc[x];
            for (int r = 0; r < st; ++r)
              a = fmaf(m.kp[r * np + e], m.vp[r * p + c], a);
            acc[x] = a;
          }
        }
        __syncthreads();
      }
#pragma unroll
      for (int x = 0; x < kPer; ++x) {
        const int i = g0 + x * kThreads + tid;
        if (i < n * p) m.h[i] = fmaf(m.dl[i / p], m.h[i], acc[x]);
      }
    }
    __syncthreads();
  }
}

// ===========================================================================
// The ring body
// ===========================================================================

constexpr int kRows = 16;        // rows of a ring word: one subtile
constexpr int kMaxWarps = 8;     // consumer warps, 16 columns each
constexpr int kDStride = 24;     // bf16 row stride of the diagonal scores
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Two f32 as one register of two bf16 (lo in the low half), rounded to
// nearest even.
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void ldsm(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(repro::ring::smem_addr(p)));
}

__device__ __forceinline__ void ldsm_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(repro::ring::smem_addr(p)));
}

// d += a (16 x 16, row) . b (16 x 8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void consumer_sync(int threads) {
  asm volatile("bar.sync 1, %0;" ::"r"(threads) : "memory");
}

// Byte offsets of the ring body's shared memory (mirrored by
// ops.py:ring_smem_bytes). A stage: q and k [16, N+8] bf16, v [16, cols+8]
// bf16, log_w [16, N+4] f32 or [16, N+8] bf16. A derived buffer (two, by
// word parity): qd, qi, ke [16, N+8] bf16, the cumsum [17, N+4] f32 (row
// 0 the value before the word), the diagonal scores [16, 24] bf16, the
// bonus [16] f32, the subtile's decay and the chunk's decay [N] f32. Then
// u [N], the cumsum carried between words [2, N], the carried state h in
// f32 (each consumer lane's accumulator fragments, [warps, N/8, 32, 4]),
// the full and empty mbarriers. The pads make ldmatrix rows and the
// diagonal's row-strided reads fall in distinct banks.
template <int N, typename LW>
struct Layout {
  static constexpr int NS = N + 8;
  static constexpr int CS = N + 4;
  static constexpr int WS = sizeof(LW) == 4 ? N + 4 : N + 8;
  int cols, vs, stage, o_k, o_v, o_w, buf, b_qi, b_ke, b_cw, b_d, b_cu,
      b_sd, b_hd;
  __host__ __device__ explicit Layout(int cols_) {
    cols = cols_;
    vs = cols + 8;
    o_k = kRows * NS * 2;
    o_v = 2 * o_k;
    o_w = o_v + kRows * vs * 2;
    stage = o_w + kRows * WS * int(sizeof(LW));
    b_qi = kRows * NS * 2;
    b_ke = 2 * b_qi;
    b_cw = 3 * b_qi;
    b_d = b_cw + (kRows + 1) * CS * 4;
    b_cu = b_d + kRows * kDStride * 2;
    b_sd = b_cu + kRows * 4;
    b_hd = b_sd + N * 4;
    buf = b_hd + N * 4;
  }
  __host__ __device__ size_t bytes(int depth) const {
    return size_t(depth) * stage + 2 * size_t(buf) + 3 * N * 4 +
           size_t(cols) / 16 * N * 64 + 16 * size_t(depth);
  }
};

// At most 128 registers a thread for N <= 64: the register file is split
// over the SM's four schedulers, 16K registers each, so three blocks of
// five warps (zamba2-2.7b's 320 rows on 132 SMs in one wave) need four
// warps of 128 to fit one scheduler. N = 128 takes 168, one block an SM.
template <int N, typename LW>
__global__ void __maxnreg__(N <= 64 ? 128 : 168)
    ring_scan_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const LW* __restrict__ w,
                     const void* __restrict__ u, int u16,
                     bf16* __restrict__ out, int s, int p, int chunk,
                     int inclusive, int depth, int streams) {
  using Lay = Layout<N, LW>;
  constexpr int NS = Lay::NS, CS = Lay::CS, WS = Lay::WS;
  extern __shared__ __align__(16) unsigned char ring_smem[];
  const int warps = blockDim.x / 32 - 1, cols = 16 * warps,
            nc = 32 * warps;
  const Lay lay(cols);
  unsigned char* stages = ring_smem;
  unsigned char* bufs = stages + size_t(depth) * lay.stage;
  float* us = reinterpret_cast<float*>(bufs + 2 * size_t(lay.buf));
  float* carry = us + N;
  float* hcs = carry + 2 * N;
  uint64_t* full = reinterpret_cast<uint64_t*>(hcs + warps * N * 16);
  uint64_t* empty = full + depth;
  const int tid = threadIdx.x;
  const long long row = blockIdx.x;
  const int p0 = blockIdx.y * cols;
  const int words = (s + kRows - 1) / kRows;
  const bool has_u = u != nullptr;

  if (tid == 0) {
    for (int d = 0; d < depth; ++d) {
      repro::ring::init(&full[d], 32);   // one per producer lane
      repro::ring::init(&empty[d], nc);  // one per consumer thread
    }
    repro::ring::fence_init();
  }
  // the masked diagonal scores stay 0 from here on
  for (int i = tid; i < 2 * lay.buf / 16; i += blockDim.x)
    reinterpret_cast<uint4*>(bufs)[i] = make_uint4(0, 0, 0, 0);
  if (has_u)
    for (int c = tid; c < N; c += blockDim.x)
      us[c] = u16 ? __bfloat162float(static_cast<const bf16*>(u)[row * N + c])
                  : static_cast<const float*>(u)[row * N + c];
  __syncthreads();

  if (tid >= nc) {
    // ---- the producer warp: word g is rows [16g, 16g+16) of every stream
    const int lane = tid - nc;
    constexpr int QC = N / 8, WC = N * int(sizeof(LW)) / 16,
                  WE = 16 / int(sizeof(LW));
    const int VC = cols / 8;
    const long long qk0 = row * s * N, v0 = row * s * p + p0;
    const int sub = (kRows + streams - 1) / streams;
    for (int g = 0; g < words; ++g) {
      const repro::ring::Slot sl(g, depth);
      repro::ring::wait(&empty[sl.stage], sl.phase ^ 1);
      unsigned char* st = stages + size_t(sl.stage) * lay.stage;
      for (int j = 0; j < streams && j * sub < kRows; ++j) {
        const int r0 = j * sub, rows = min(sub, kRows - r0);
        for (int i = lane; i < rows * QC; i += 32) {
          const int r = r0 + i / QC, c = i % QC, l = g * kRows + r;
          const bool ok = l < s;
          const long long off = qk0 + (long long)(ok ? l : 0) * N + c * 8;
          const int dst = (r * NS + c * 8) * 2;
          repro::ring::cp_async_16(st + dst, q + off, ok ? 16 : 0);
          repro::ring::cp_async_16(st + lay.o_k + dst, k + off, ok ? 16 : 0);
        }
        for (int i = lane; i < rows * VC; i += 32) {
          const int r = r0 + i / VC, c = i % VC, l = g * kRows + r;
          const bool ok = l < s;
          repro::ring::cp_async_16(
              st + lay.o_v + (r * lay.vs + c * 8) * 2,
              v + v0 + (long long)(ok ? l : 0) * p + c * 8, ok ? 16 : 0);
        }
        for (int i = lane; i < rows * WC; i += 32) {
          const int r = r0 + i / WC, c = i % WC, l = g * kRows + r;
          const bool ok = l < s;
          repro::ring::cp_async_16(
              st + lay.o_w + r * WS * int(sizeof(LW)) + c * 16,
              w + qk0 + (long long)(ok ? l : 0) * N + c * WE, ok ? 16 : 0);
        }
      }
      repro::ring::arrive_cp_async(&full[sl.stage]);
    }
    repro::ring::cp_async_wait_all();
    return;
  }

  // ---- the consumers
  const int wid = tid / 32, lane = tid % 32, gq = lane >> 2, tq = lane & 3;
  const int pw = 16 * wid;  // the warp's first column in the block's slice
  // z^T [16 columns, N] in f32 accumulator fragments; h^T the same in
  // shared memory (this lane's fragments, hcw[j]) and, as the products'
  // B operands, rounded to bf16 in registers (hb[kk][o])
  float hz[N / 8][4];
  uint32_t hb[N / 16][2][2];
  float4* hcw = reinterpret_cast<float4*>(hcs) + wid * (N / 8) * 32 + lane;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    hcw[j * 32] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int e = 0; e < 4; ++e) hz[j][e] = 0.0f;
  }
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int o = 0; o < 2; ++o) hb[kk][o][0] = hb[kk][o][1] = 0u;

  for (int g = 0; g < words; ++g) {
    const repro::ring::Slot sl(g, depth);
    const unsigned char* st = stages + size_t(sl.stage) * lay.stage;
    unsigned char* bf = bufs + size_t(g & 1) * lay.buf;
    const bf16* qs = reinterpret_cast<const bf16*>(st);
    const bf16* ks = reinterpret_cast<const bf16*>(st + lay.o_k);
    const bf16* vt = reinterpret_cast<const bf16*>(st + lay.o_v);
    const LW* ws = reinterpret_cast<const LW*>(st + lay.o_w);
    bf16* qd = reinterpret_cast<bf16*>(bf);
    bf16* qi = reinterpret_cast<bf16*>(bf + lay.b_qi);
    bf16* ke = reinterpret_cast<bf16*>(bf + lay.b_ke);
    float* cw = reinterpret_cast<float*>(bf + lay.b_cw);
    bf16* dt = reinterpret_cast<bf16*>(bf + lay.b_d);
    float* cu = reinterpret_cast<float*>(bf + lay.b_cu);
    float* sd = reinterpret_cast<float*>(bf + lay.b_sd);
    float* hd = reinterpret_cast<float*>(bf + lay.b_hd);
    const bool first = (g * kRows) % chunk == 0,
               last = ((g + 1) * kRows) % chunk == 0;
    repro::ring::wait(&full[sl.stage], sl.phase);

    // ---- A: the cumsum (log2 units) and the decayed q and k tiles; a
    //      thread loads its column's 16 rows before it stores anything
    for (int t = tid; t < 2 * N; t += nc) {
      const int n = t % N;
      const bool qside = t < N;
      const bf16* xs = qside ? qs : ks;
      const float c = first ? 0.0f : carry[(g & 1) * N + n];
      float x[kRows], run[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        x[r] = __bfloat162float(xs[r * NS + n]);
        run[r] = fminf(repro::to_f(ws[r * WS + n]), 0.0f) * kLog2e;
      }
      float acc = c;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        acc += run[r];
        run[r] = acc;
      }
      const float ce = run[kRows - 1];
      if (qside) {
        const float pb = ex2(c);
        cw[n] = c;
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float cq = inclusive ? run[r] : (r ? run[r - 1] : c);
          const float y = x[r] * ex2(cq - c);
          cw[(r + 1) * CS + n] = run[r];
          qi[r * NS + n] = __float2bfloat16_rn(y);
          qd[r * NS + n] = __float2bfloat16_rn(y * pb);
        }
        carry[((g + 1) & 1) * N + n] = ce;
      } else {
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          ke[r * NS + n] = __float2bfloat16_rn(x[r] * ex2(ce - run[r]));
        sd[n] = ex2(ce - c);
        if (last) hd[n] = ex2(ce);
      }
    }
    consumer_sync(nc);

    // ---- B: the diagonal subtile's scores: task t < 120 the strictly
    //      lower pair t = a (a - 1) / 2 + b, b < a; tasks 120..127 rows
    //      j and 15 - j: the diagonal pairs (inclusive) or the bonus
    for (int t = tid; t < 128; t += nc) {
      if (t < 120) {
        int a = int((1.0f + sqrtf(1.0f + 8.0f * t)) * 0.5f);
        if (a * (a - 1) / 2 > t) --a;
        if (a * (a + 1) / 2 <= t) ++a;
        const int b = t - a * (a - 1) / 2;
        const float* ea = cw + (inclusive ? a + 1 : a) * CS;
        const float* eb = cw + (b + 1) * CS;
        const bf16* qa = qs + a * NS;
        const bf16* kb = ks + b * NS;
        float acc0 = 0.0f, acc1 = 0.0f;  // two chains, summed at the end
#pragma unroll 4
        for (int n0 = 0; n0 < N; n0 += 8) {
          const uint4 qv = *reinterpret_cast<const uint4*>(qa + n0);
          const uint4 kv = *reinterpret_cast<const uint4*>(kb + n0);
          const float4 e0 = *reinterpret_cast<const float4*>(ea + n0);
          const float4 e1 = *reinterpret_cast<const float4*>(ea + n0 + 4);
          const float4 f0 = *reinterpret_cast<const float4*>(eb + n0);
          const float4 f1 = *reinterpret_cast<const float4*>(eb + n0 + 4);
          // b < a: the exponent is <= 0 without the clamp (a cumsum of
          // terms <= 0 does not rise, in f32 as well)
          const float ex[8] = {e0.x - f0.x, e0.y - f0.y, e0.z - f0.z,
                               e0.w - f0.w, e1.x - f1.x, e1.y - f1.y,
                               e1.z - f1.z, e1.w - f1.w};
          const __nv_bfloat162* q2 =
              reinterpret_cast<const __nv_bfloat162*>(&qv);
          const __nv_bfloat162* k2 =
              reinterpret_cast<const __nv_bfloat162*>(&kv);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float2 qf = __bfloat1622float2(q2[j]);
            const float2 kf = __bfloat1622float2(k2[j]);
            acc0 = fmaf(qf.x * ex2(ex[2 * j]), kf.x, acc0);
            acc1 = fmaf(qf.y * ex2(ex[2 * j + 1]), kf.y, acc1);
          }
        }
        dt[a * kDStride + b] = __float2bfloat16_rn(acc0 + acc1);
      } else if (inclusive || has_u) {
        // the diagonal pair (a, a) has exponent 0: a plain dot product;
        // exclusive masks it and takes the bonus sum_n q u k instead
#pragma unroll
        for (int side = 0; side < 2; ++side) {
          const int a = side ? 15 - (t - 120) : t - 120;
          float acc0 = 0.0f, acc1 = 0.0f;
#pragma unroll 2
          for (int n0 = 0; n0 < N; n0 += 8) {
            const uint4 qv = *reinterpret_cast<const uint4*>(qs + a * NS + n0);
            const uint4 kv = *reinterpret_cast<const uint4*>(ks + a * NS + n0);
            const float4 u0 = *reinterpret_cast<const float4*>(us + n0);
            const float4 u1 = *reinterpret_cast<const float4*>(us + n0 + 4);
            const float uu[8] = {u0.x, u0.y, u0.z, u0.w,
                                 u1.x, u1.y, u1.z, u1.w};
            const __nv_bfloat162* q2 =
                reinterpret_cast<const __nv_bfloat162*>(&qv);
            const __nv_bfloat162* k2 =
                reinterpret_cast<const __nv_bfloat162*>(&kv);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const float2 qf = __bfloat1622float2(q2[j]);
              const float2 kf = __bfloat1622float2(k2[j]);
              acc0 = fmaf(inclusive ? qf.x : qf.x * uu[2 * j], kf.x, acc0);
              acc1 = fmaf(inclusive ? qf.y : qf.y * uu[2 * j + 1], kf.y,
                          acc1);
            }
          }
          const float acc = acc0 + acc1;
          if (inclusive)
            dt[a * kDStride + a] = __float2bfloat16_rn(acc);
          else
            cu[a] = acc;
        }
      }
    }
    consumer_sync(nc);

    // ---- C: the warp's 16 columns on the tensor cores: the carried term
    //      (yh) and the chunk's own (yz) in two accumulator chains, the
    //      outputs, then the state z
    float yh[2][4], yz[2][4];
#pragma unroll
    for (int o = 0; o < 2; ++o)
#pragma unroll
      for (int e = 0; e < 4; ++e) yh[o][e] = yz[o][e] = 0.0f;
    const int ar = lane & 15, ac = (lane >> 4) * 8;               // A, x4
    const int br = (lane & 7) + ((lane >> 3) & 1) * 8, bc = ac;   // B, x4.t
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) {
      uint32_t a[4], a2[4];
      ldsm(a, qd + ar * NS + kk * 16 + ac);
      ldsm(a2, qi + ar * NS + kk * 16 + ac);
      mma(yh[0], a, hb[kk][0][0], hb[kk][0][1]);
      mma(yh[1], a, hb[kk][1][0], hb[kk][1][1]);
      mma(yz[0], a2, pack(hz[2 * kk][0], hz[2 * kk][1]),
          pack(hz[2 * kk + 1][0], hz[2 * kk + 1][1]));
      mma(yz[1], a2, pack(hz[2 * kk][2], hz[2 * kk][3]),
          pack(hz[2 * kk + 1][2], hz[2 * kk + 1][3]));
    }
    {
      uint32_t a[4], b[4];
      ldsm(a, dt + ar * kDStride + ac);
      ldsm_t(b, vt + br * lay.vs + pw + bc);
      mma(yz[0], a, b[0], b[1]);
      mma(yz[1], a, b[2], b[3]);
    }
    // the outputs: the carried term, the chunk's, the bonus cu[r] v[r, c]
#pragma unroll
    for (int o = 0; o < 2; ++o)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = gq + 8 * hr, c = pw + 8 * o + 2 * tq;
        float y0 = yh[o][2 * hr] + yz[o][2 * hr],
              y1 = yh[o][2 * hr + 1] + yz[o][2 * hr + 1];
        if (has_u) {
          const float cr = cu[r];
          y0 = fmaf(cr, __bfloat162float(vt[r * lay.vs + c]), y0);
          y1 = fmaf(cr, __bfloat162float(vt[r * lay.vs + c + 1]), y1);
        }
        const int l = g * kRows + r;
        if (l < s)
          *reinterpret_cast<__nv_bfloat162*>(out + (row * s + l) * p + p0 +
                                             c) = __floats2bfloat162_rn(y0,
                                                                        y1);
      }
    // z^T = z^T e^{cw_e - cw_b} + v^T . ke
    {
      uint32_t av[4];
      ldsm_t(av, vt + ((lane & 7) + (lane >> 4) * 8) * lay.vs + pw +
                     ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
        const float d0 = sd[8 * j + 2 * tq], d1 = sd[8 * j + 2 * tq + 1];
        hz[j][0] *= d0;
        hz[j][1] *= d1;
        hz[j][2] *= d0;
        hz[j][3] *= d1;
      }
#pragma unroll
      for (int jj = 0; jj < N / 16; ++jj) {
        uint32_t b[4];
        ldsm_t(b, ke + br * NS + jj * 16 + bc);
        mma(hz[2 * jj], av, b[0], b[1]);
        mma(hz[2 * jj + 1], av, b[2], b[3]);
      }
    }
    repro::ring::arrive(&empty[sl.stage]);
    if (last) {
      // the chunk's end: h = e^{cw_last} h + z, z = 0, and h's bf16
      // operands anew
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk) {
        float4 h2[2];
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const int j = 2 * kk + x;
          const float d0 = hd[8 * j + 2 * tq], d1 = hd[8 * j + 2 * tq + 1];
          float4 h = hcw[j * 32];
          h.x = fmaf(h.x, d0, hz[j][0]);
          h.y = fmaf(h.y, d1, hz[j][1]);
          h.z = fmaf(h.z, d0, hz[j][2]);
          h.w = fmaf(h.w, d1, hz[j][3]);
          hcw[j * 32] = h;
          h2[x] = h;
#pragma unroll
          for (int e = 0; e < 4; ++e) hz[j][e] = 0.0f;
        }
        hb[kk][0][0] = pack(h2[0].x, h2[0].y);
        hb[kk][0][1] = pack(h2[1].x, h2[1].y);
        hb[kk][1][0] = pack(h2[0].z, h2[0].w);
        hb[kk][1][1] = pack(h2[1].z, h2[1].w);
      }
    }
  }
}

// The kernel's attributes for a block of ``cols`` columns at ``depth``:
// its dynamic shared memory, and the largest shared-memory carveout, so
// that as many blocks as the registers allow share an SM.
template <int N, typename LW>
cudaError_t prepare(int cols, int depth, size_t* smem) {
  *smem = Layout<N, LW>(cols).bytes(depth);
  cudaError_t err = repro::allow_smem(ring_scan_kernel<N, LW>, *smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(ring_scan_kernel<N, LW>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <int N, typename LW>
cudaError_t launch_ring(const void* q, const void* k, const void* v,
                        const void* w, const void* u, int u16, void* out,
                        int bh, int s, int p, int chunk, int inclusive,
                        int slices, int depth, int streams,
                        cudaStream_t stream) {
  const int cols = p / slices;
  size_t smem;
  cudaError_t err = prepare<N, LW>(cols, depth, &smem);
  if (err != cudaSuccess) return err;
  ring_scan_kernel<N, LW><<<dim3(bh, slices), 32 * (cols / 16 + 1), smem,
                            stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const LW*>(w), u, u16,
      static_cast<bf16*>(out), s, p, chunk, inclusive, depth, streams);
  return cudaGetLastError();
}

template <int N, typename LW>
cudaError_t occupancy(int cols, int depth, int* blocks) {
  size_t smem;
  cudaError_t err = prepare<N, LW>(cols, depth, &smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, ring_scan_kernel<N, LW>, 32 * (cols / 16 + 1), smem);
}

template <typename LW>
cudaError_t launch_ring_n(int n, const void* q, const void* k, const void* v,
                          const void* w, const void* u, int u16, void* out,
                          int bh, int s, int p, int chunk, int inclusive,
                          int slices, int depth, int streams,
                          cudaStream_t stream) {
#define REPRO_RING_N(NN)                                                     \
  case NN:                                                                   \
    return launch_ring<NN, LW>(q, k, v, w, u, u16, out, bh, s, p, chunk,     \
                               inclusive, slices, depth, streams, stream);
  switch (n) {
    REPRO_RING_N(16)
    REPRO_RING_N(32)
    REPRO_RING_N(64)
    REPRO_RING_N(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef REPRO_RING_N
}

}  // namespace

// out [bh, s, p] (q's type) = the scan of q, k, w (log-decay) [bh, s, n] and
// v [bh, s, p], all contiguous; u [bh, n] or null (exclusive mode's bonus).
// ``types`` has bit 1 set if q is bfloat16 (else float32), 2 for k, 4 for v,
// 8 for w, 16 for u. ``chunk`` must be a multiple of ``subtile``; P is cut
// into ``slices`` blocks of p / slices columns each. The CUDA-core body.
extern "C" int ff_chunk_scan(const void* q, const void* k, const void* v,
                             const void* w, const void* u, void* out, int bh,
                             int s, int n, int p, int chunk, int subtile,
                             int inclusive, int types, int slices,
                             void* stream) {
  if (chunk < 1 || subtile < 1 || chunk % subtile != 0 || n < 1 || p < 1 ||
      slices < 1 || p % slices != 0)
    return cudaErrorInvalidValue;
  if (bh == 0 || s == 0) return 0;
  const int ps = p / slices;
  const size_t smem = sizeof(float) * smem_floats(n, ps, subtile);
  cudaError_t err = repro::allow_smem(chunk_scan_kernel, smem);
  if (err != cudaSuccess) return err;
  chunk_scan_kernel<<<dim3(bh, slices), kThreads, smem,
                      (cudaStream_t)stream>>>(q, k, v, w, u, out, s, n, ps, p,
                                              chunk, subtile, inclusive,
                                              types);
  return cudaGetLastError();
}

// The ring body: q, k, v bfloat16 (``types`` bits 1, 2 and 4 set), w
// float32 or bfloat16 (bit 8), u float32 or bfloat16 (bit 16) or null; n
// in {16, 32, 64, 128}, chunk a multiple of 16, p / slices a multiple of
// 16 of at most 128 columns; ``depth`` ring stages of 16 rows, each copied
// in ``streams`` parts. The subtile is 16.
extern "C" int ff_chunk_scan_ring(const void* q, const void* k, const void* v,
                                  const void* w, const void* u, void* out,
                                  int bh, int s, int n, int p, int chunk,
                                  int inclusive, int types, int slices,
                                  int depth, int streams, void* stream) {
  if ((types & (kQBf16 | kKBf16 | kVBf16)) != (kQBf16 | kKBf16 | kVBf16) ||
      chunk < kRows || chunk % kRows != 0 || slices < 1 || p % slices != 0 ||
      (p / slices) % 16 != 0 || p / slices > 16 * kMaxWarps || depth < 1 ||
      streams < 1)
    return cudaErrorInvalidValue;
  if (bh == 0 || s == 0) return 0;
  const int u16 = (types & kUBf16) != 0;
  return (types & kWBf16)
             ? launch_ring_n<bf16>(n, q, k, v, w, u, u16, out, bh, s, p,
                                   chunk, inclusive, slices, depth, streams,
                                   (cudaStream_t)stream)
             : launch_ring_n<float>(n, q, k, v, w, u, u16, out, bh, s, p,
                                    chunk, inclusive, slices, depth, streams,
                                    (cudaStream_t)stream);
}

// Blocks of the ring body that fit on one SM at once (registers, shared
// memory, threads), for ``cols`` columns a block at ``depth``; -1 on a
// shape the body does not take.
extern "C" int ff_chunk_scan_ring_occupancy(int n, int w16, int cols,
                                            int depth) {
  int blocks = -1;
  cudaError_t err = cudaErrorInvalidValue;
  if (cols < 16 || cols % 16 != 0 || cols > 16 * kMaxWarps || depth < 1)
    return -1;
#define REPRO_RING_OCC(NN)                                                   \
  case NN:                                                                   \
    err = w16 ? occupancy<NN, bf16>(cols, depth, &blocks)                    \
              : occupancy<NN, float>(cols, depth, &blocks);                  \
    break;
  switch (n) {
    REPRO_RING_OCC(16)
    REPRO_RING_OCC(32)
    REPRO_RING_OCC(64)
    REPRO_RING_OCC(128)
    default:
      break;
  }
#undef REPRO_RING_OCC
  return err == cudaSuccess ? blocks : -1;
}
