// Gated linear-attention scan (Mamba2 inclusive / RWKV6 exclusive with the
// bonus u) for the H100 (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ff_chunk_scan/kernel.py
// (build_program / _chunk_body / chunk_scan_ff): per bh row the recurrence
//   h_t = diag(exp(lw_t)) h_{t-1} + k_t (x) v_t
//   inclusive: y_t = q_t . h_t
//   exclusive: y_t = q_t . (h_{t-1} + diag(u) k_t (x) v_t)
// with the [N,P] state carried in f32 across chunks of L rows. On the TPU the
// grid walked (bh, chunk) words in order and kept the state in VMEM scratch
// across grid steps; blocks here run in no order, so one block owns one bh
// row and walks its chunks in a loop, the state in shared memory.
//
// Numerics (the reference's decay-to-boundary factorization, kept so that
// every exponent is <= 0 and a strong decay underflows to 0 instead of
// overflowing): with cw the chunk's inclusive cumsum of lw and cq = cw
// (inclusive) or cw - lw (exclusive),
//   carried state:      (q_l e^{cq_l}) . h
//   tile pair j < i:    (q_l e^{cq_l - cw_b}) . (k_s e^{cw_b - cw_s}),
//                       b = the last row before tile i
//   diagonal tile:      sum_n q_l e^{min(cq_l - cw_s, 0)} k_s, masked
//                       s <= l (inclusive) or s < l (exclusive)
//   bonus:              (sum_n q_l u k_l) v_l
//   state update:       h = e^{cw_last} h + sum_l (k_l e^{cw_last - cw_l}) v_l
// All of it in f32 FMAs, expf (not the fast approximation).
//
// Bound on this card: each input element is read once and each output
// written once, bh*s*(3n+2p) elements; the work per chunk is about
// 2*L*N*P*2 + L^2*(N+P) operations (reference ops.py:chunk_scan_cost), so
// at N = P = 64 it is bound by bytes (42 MB at rwkv6-7b's 4 x 256 tokens,
// about 12.5 us at the data sheet's 3.35 TB/s). This kernel does its
// products as scalar FMAs from shared memory with one block per row, so it
// is bound by shared-memory bandwidth, by its block barriers and by the
// rows' sequential chunks, far above that.
//
// Design: one block of 512 threads per bh row, walking the row's chunks.
// Nothing of a chunk is held whole except its cumsum cw, so shared memory
// grows as chunk x (N+1) once and otherwise as subtile x N, and every
// chunk the reference's autotuner tries (32, 128, 256) fits at N = P = 64
// (chunk 128 at N = P = 128 too). Per chunk:
//   * the cumsum: lw staged a subtile of rows at a time, one thread per
//     column carrying the running sum into cw;
//   * per subtile of rows: its q, k, v and q-side exponent cq staged (each
//     stream f32 or bf16 on its own, a row past S read as zero, which is
//     what the reference's padding gives), the scaled q tiles and the
//     bonus; then the earlier subtiles of the chunk a block of subtile rows
//     at a time, their k decayed to the boundary as it is staged (k and v
//     re-read from L2), each block's scores and its terms of the intra
//     sums, which are carried in shared memory; then the diagonal block by
//     exact pairwise exponents, and the output rows;
//   * the state update, in passes over h of kThreads * kPer elements held
//     in registers, the chunk's k (decayed to its end) and v streamed again
//     a subtile at a time; h itself is overwritten only after the chunk's
//     outputs have read it.
// Every output is the same fmaf chain, in the same order, as a kernel that
// holds the whole chunk: the inter sum over N, the intra sum over the
// chunk's earlier rows in order (carried across blocks), the bonus last;
// and every state element one chain over the chunk's rows in order.
// Row-indexed [*, N] tiles have a padded stride N+1 so that threads on
// consecutive rows hit distinct banks. The reference's depth and streams
// (its ring pipe) are not parameters of this kernel yet.

#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kPer = 8;   // state elements a thread carries in one pass

// A stream element as f32, from a float or a bfloat16 array.
__device__ __forceinline__ float ld(const void* p, bool bf16, long long i) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

// The layout of the dynamic shared memory, in floats (mirrored by
// ops.py:smem_bytes): the chunk's cumsum [chunk, N+1] and the state [N, P];
// per subtile (st rows) q, k, cq and the two scaled q tiles [st, N+1], a
// block of earlier k [st, N+1] (also the lw rows of the cumsum and the k
// rows of the state update), the subtile's v and a block of earlier v
// [st, P], the intra sums [st, P], the scores [st, st], the bonus per row;
// and three [N] vectors.
struct Smem {
  float *cw, *h, *qs, *ks, *cq, *qi, *qd, *kp, *vs, *vp, *ia, *sc, *cu,
      *cwl, *dl, *u;
};

__host__ __device__ inline long long smem_floats(int n, int p, int chunk,
                                                 int st) {
  const long long np = n + 1;
  return (long long)chunk * np + (long long)n * p + 6LL * st * np +
         3LL * st * p + (long long)st * st + st + 3LL * n;
}

__device__ inline Smem carve(float* base, int n, int p, int chunk, int st) {
  const int np = n + 1;
  Smem m;
  m.cw = base;
  m.h = m.cw + chunk * np;
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
  return m;
}

enum : int { kQBf16 = 1, kKBf16 = 2, kVBf16 = 4, kWBf16 = 8, kUBf16 = 16 };

__global__ void __launch_bounds__(kThreads)
    chunk_scan_kernel(const void* __restrict__ q, const void* __restrict__ k,
                      const void* __restrict__ v, const void* __restrict__ w,
                      const void* __restrict__ u, void* __restrict__ out,
                      int s, int n, int p, int chunk, int st, int inclusive,
                      int types) {
  extern __shared__ float smem[];
  const Smem m = carve(smem, n, p, chunk, st);
  const int np = n + 1;
  const int tid = threadIdx.x;
  const long long bh = blockIdx.x;
  const long long qk_base = bh * s * n, v_base = bh * s * p;
  const bool q16 = types & kQBf16, k16 = types & kKBf16, v16 = types & kVBf16,
             w16 = types & kWBf16, u16 = types & kUBf16;
  const bool has_u = u != nullptr;
  // row l (of the sequence) of a stream, zero past S
  auto qk_row = [&](const void* x, bool b16, int l, int c) {
    return l < s ? ld(x, b16, qk_base + (long long)l * n + c) : 0.0f;
  };
  auto v_row = [&](int l, int c) {
    return l < s ? ld(v, v16, v_base + (long long)l * p + c) : 0.0f;
  };
  auto lw_row = [&](int l, int c) {
    return l < s ? fminf(ld(w, w16, qk_base + (long long)l * n + c), 0.0f)
                 : 0.0f;
  };

  for (int i = tid; i < n * p; i += kThreads) m.h[i] = 0.0f;
  if (has_u)
    for (int c = tid; c < n; c += kThreads) m.u[c] = ld(u, u16, bh * n + c);

  for (int c0 = 0; c0 < s; c0 += chunk) {
    // ---- the cumsum, lw staged a subtile of rows at a time (into kp)
    for (int b0 = 0; b0 < chunk; b0 += st) {
      for (int i = tid; i < st * n; i += kThreads) {
        const int r = i / n, c = i - r * n;
        m.kp[r * np + c] = lw_row(c0 + b0 + r, c);
      }
      __syncthreads();
      for (int c = tid; c < n; c += kThreads) {
        float run = b0 ? m.cw[(b0 - 1) * np + c] : 0.0f;
        for (int r = 0; r < st; ++r) {
          run += m.kp[r * np + c];
          m.cw[(b0 + r) * np + c] = run;
        }
      }
      __syncthreads();
    }
    for (int c = tid; c < n; c += kThreads) {
      const float run = m.cw[(chunk - 1) * np + c];
      m.cwl[c] = run;
      m.dl[c] = expf(run);
    }

    for (int t0 = 0; t0 < chunk; t0 += st) {
      const float* cwb = t0 ? m.cw + (t0 - 1) * np : nullptr;
      // ---- this subtile's rows: q, k, the q-side exponent, and q decayed
      //      from the chunk start and from the boundary
      for (int i = tid; i < st * n; i += kThreads) {
        const int r = i / n, c = i - r * n, l = c0 + t0 + r;
        const float qv = qk_row(q, q16, l, c);
        const float run = m.cw[(t0 + r) * np + c];
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
      //      time: k decayed to the boundary, the scores by the boundary
      //      factorization, their terms of the intra sums
      for (int j0 = 0; j0 < t0; j0 += st) {
        for (int i = tid; i < st * n; i += kThreads) {
          const int j = i / n, c = i - j * n;
          m.kp[j * np + c] = qk_row(k, k16, c0 + j0 + j, c) *
                             expf(cwb[c] - m.cw[(j0 + j) * np + c]);
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
          const float* cws = m.cw + (t0 + j) * np;
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
          const long long g = v_base + (long long)l * p + c;
          if (q16)
            static_cast<__nv_bfloat16*>(out)[g] = __float2bfloat16_rn(y);
          else
            static_cast<float*>(out)[g] = y;
        }
      }
      __syncthreads();
    }

    // ---- the state update: h = e^{cw_last} h + sum_l (k_l e^{cw_last -
    //      cw_l}) v_l, each element one chain over the chunk's rows
    for (int g0 = 0; g0 < n * p; g0 += kThreads * kPer) {
      float acc[kPer];
#pragma unroll
      for (int x = 0; x < kPer; ++x) acc[x] = 0.0f;
      for (int l0 = 0; l0 < chunk; l0 += st) {
        for (int i = tid; i < st * n; i += kThreads) {
          const int r = i / n, c = i - r * n;
          m.kp[r * np + c] = qk_row(k, k16, c0 + l0 + r, c) *
                             expf(m.cwl[c] - m.cw[(l0 + r) * np + c]);
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

}  // namespace

// out [bh, s, p] (q's type) = the scan of q, k, w (log-decay) [bh, s, n] and
// v [bh, s, p], all contiguous; u [bh, n] or null (exclusive mode's bonus).
// ``types`` has bit 1 set if q is bfloat16 (else float32), 2 for k, 4 for v,
// 8 for w, 16 for u. ``chunk`` must be a multiple of ``subtile``.
extern "C" int ff_chunk_scan(const void* q, const void* k, const void* v,
                             const void* w, const void* u, void* out, int bh,
                             int s, int n, int p, int chunk, int subtile,
                             int inclusive, int types, void* stream) {
  if (chunk < 1 || subtile < 1 || chunk % subtile != 0 || n < 1 || p < 1)
    return cudaErrorInvalidValue;
  if (bh == 0 || s == 0) return 0;
  const size_t smem = sizeof(float) * smem_floats(n, p, chunk, subtile);
  cudaError_t err = repro::allow_smem(chunk_scan_kernel, smem);
  if (err != cudaSuccess) return err;
  chunk_scan_kernel<<<bh, kThreads, smem, (cudaStream_t)stream>>>(
      q, k, v, w, u, out, s, n, p, chunk, subtile, inclusive, types);
  return cudaGetLastError();
}
