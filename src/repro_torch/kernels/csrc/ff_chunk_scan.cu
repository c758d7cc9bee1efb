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
// about 12.5 us at the data sheet's 3.35 TB/s). This first kernel does its
// products as scalar FMAs from shared memory with one block per row, so it
// is bound by shared-memory bandwidth and by the rows' sequential chunks,
// far above that.
//
// Design: one block of 512 threads per bh row. Per chunk: the q/k/v/lw tile
// is staged in shared memory as f32 (each stream f32 or bf16 on its own, a
// row past S read as zero, which is what the reference's padding gives);
// one thread per column runs the cumsum; then per subtile of rows the scaled
// q and prefix k, the scores (prefix products and the exact diagonal) and
// the output rows; then the state update. Row-indexed [*, N] tiles have a
// padded stride N+1 so that threads on consecutive rows hit distinct banks.
// The reference's depth and streams (its ring pipe) are not parameters of
// this kernel yet.

#include "common.cuh"

namespace {

constexpr int kThreads = 512;

// A stream element as f32, from a float or a bfloat16 array.
__device__ __forceinline__ float ld(const void* p, bool bf16, long long i) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

// The layout of the dynamic shared memory, in floats (mirrored by
// ops.py:smem_bytes).
struct Smem {
  float *q, *k, *cw, *cq, *kb, *v, *h, *qi, *qd, *sc, *cu, *cwl, *dl, *u;
};

__host__ __device__ inline long long smem_floats(int n, int p, int chunk,
                                                 int subtile) {
  const long long np = n + 1;
  return 4 * chunk * np + (long long)(chunk - subtile) * np +
         (long long)chunk * p + (long long)n * p + 2 * subtile * np +
         (long long)subtile * chunk + chunk + 4 * n;
}

__device__ inline Smem carve(float* base, int n, int p, int chunk,
                             int subtile) {
  const int np = n + 1;
  Smem m;
  m.q = base;
  m.k = m.q + chunk * np;
  m.cw = m.k + chunk * np;
  m.cq = m.cw + chunk * np;
  m.kb = m.cq + chunk * np;
  m.v = m.kb + (chunk - subtile) * np;
  m.h = m.v + chunk * p;
  m.qi = m.h + n * p;
  m.qd = m.qi + subtile * np;
  m.sc = m.qd + subtile * np;
  m.cu = m.sc + subtile * chunk;
  m.cwl = m.cu + chunk;
  m.dl = m.cwl + n;
  m.u = m.dl + n;
  return m;
}

enum : int { kQBf16 = 1, kKBf16 = 2, kVBf16 = 4, kWBf16 = 8, kUBf16 = 16 };

__global__ void __launch_bounds__(kThreads)
    chunk_scan_kernel(const void* __restrict__ q, const void* __restrict__ k,
                      const void* __restrict__ v, const void* __restrict__ w,
                      const void* __restrict__ u, void* __restrict__ out,
                      int s, int n, int p, int chunk, int subtile,
                      int inclusive, int types) {
  extern __shared__ float smem[];
  const Smem m = carve(smem, n, p, chunk, subtile);
  const int np = n + 1;
  const int tid = threadIdx.x;
  const long long bh = blockIdx.x;
  const long long qk_base = bh * s * n, v_base = bh * s * p;
  const bool q16 = types & kQBf16, k16 = types & kKBf16, v16 = types & kVBf16,
             w16 = types & kWBf16, u16 = types & kUBf16;
  const bool has_u = u != nullptr;

  for (int i = tid; i < n * p; i += kThreads) m.h[i] = 0.0f;
  if (has_u)
    for (int c = tid; c < n; c += kThreads) m.u[c] = ld(u, u16, bh * n + c);

  for (int c0 = 0; c0 < s; c0 += chunk) {
    // ---- stage the chunk (rows past S read as zero: lw = 0, q = k = v = 0)
    for (int i = tid; i < chunk * n; i += kThreads) {
      const int l = i / n, c = i - l * n;
      const bool in = c0 + l < s;
      const long long g = qk_base + (long long)(c0 + l) * n + c;
      m.q[l * np + c] = in ? ld(q, q16, g) : 0.0f;
      m.k[l * np + c] = in ? ld(k, k16, g) : 0.0f;
      m.cq[l * np + c] = in ? fminf(ld(w, w16, g), 0.0f) : 0.0f;  // lw
    }
    for (int i = tid; i < chunk * p; i += kThreads) {
      const int l = i / p, c = i - l * p;
      m.v[i] = c0 + l < s ? ld(v, v16, v_base + (long long)(c0 + l) * p + c)
                          : 0.0f;
    }
    __syncthreads();

    // ---- the cumsum, one thread per column; the bonus per row
    for (int c = tid; c < n; c += kThreads) {
      float run = 0.0f;
      for (int l = 0; l < chunk; ++l) {
        const float lw = m.cq[l * np + c];
        run += lw;
        m.cw[l * np + c] = run;
        m.cq[l * np + c] = inclusive ? run : run - lw;
      }
      m.cwl[c] = run;
      m.dl[c] = expf(run);
    }
    if (has_u)
      for (int l = tid; l < chunk; l += kThreads) {
        float acc = 0.0f;
        for (int c = 0; c < n; ++c)
          acc = fmaf(m.q[l * np + c] * m.u[c], m.k[l * np + c], acc);
        m.cu[l] = acc;
      }
    __syncthreads();

    for (int t0 = 0; t0 < chunk; t0 += subtile) {
      const int width = t0 + subtile;            // score columns of this tile
      const float* cwb = t0 ? m.cw + (t0 - 1) * np : nullptr;
      // ---- q of this tile, decayed from the chunk start and from the
      //      boundary; the prefix k decayed to the boundary
      for (int i = tid; i < subtile * n; i += kThreads) {
        const int r = i / n, c = i - r * n, l = t0 + r;
        const float qv = m.q[l * np + c], e = m.cq[l * np + c];
        m.qd[r * np + c] = qv * expf(e);
        m.qi[r * np + c] = qv * expf(e - (cwb ? cwb[c] : 0.0f));
      }
      for (int i = tid; i < t0 * n; i += kThreads) {
        const int j = i / n, c = i - j * n;
        m.kb[j * np + c] = m.k[j * np + c] * expf(cwb[c] - m.cw[j * np + c]);
      }
      __syncthreads();

      // ---- scores: prefix columns by the boundary factorization, the
      //      diagonal tile by exact pairwise exponents
      for (int i = tid; i < subtile * width; i += kThreads) {
        const int r = i / width, j = i - r * width;
        float acc = 0.0f;
        if (j < t0) {
          const float* a = m.qi + r * np;
          const float* b = m.kb + j * np;
          for (int c = 0; c < n; ++c) acc = fmaf(a[c], b[c], acc);
        } else {
          const int jj = j - t0;
          if (inclusive ? r >= jj : r > jj) {
            const int l = t0 + r, sl = t0 + jj;
            const float* ql = m.q + l * np;
            const float* cql = m.cq + l * np;
            const float* cws = m.cw + sl * np;
            const float* ks = m.k + sl * np;
            for (int c = 0; c < n; ++c)
              acc = fmaf(ql[c] * expf(fminf(cql[c] - cws[c], 0.0f)), ks[c],
                         acc);
          }
        }
        m.sc[r * chunk + j] = acc;
      }
      __syncthreads();

      // ---- the tile's output rows
      for (int i = tid; i < subtile * p; i += kThreads) {
        const int r = i / p, c = i - r * p, l = t0 + r;
        float inter = 0.0f, intra = 0.0f;
        for (int e = 0; e < n; ++e)
          inter = fmaf(m.qd[r * np + e], m.h[e * p + c], inter);
        for (int j = 0; j < width; ++j)
          intra = fmaf(m.sc[r * chunk + j], m.v[j * p + c], intra);
        float y = inter + intra;
        if (has_u) y = fmaf(m.cu[l], m.v[l * p + c], y);
        if (c0 + l < s) {
          const long long g = v_base + (long long)(c0 + l) * p + c;
          if (q16)
            static_cast<__nv_bfloat16*>(out)[g] = __float2bfloat16_rn(y);
          else
            static_cast<float*>(out)[g] = y;
        }
      }
      __syncthreads();
    }

    // ---- the state update (k decayed to the chunk's end, into q's tile)
    for (int i = tid; i < chunk * n; i += kThreads) {
      const int l = i / n, c = i - l * n;
      m.q[l * np + c] = m.k[l * np + c] * expf(m.cwl[c] - m.cw[l * np + c]);
    }
    __syncthreads();
    for (int i = tid; i < n * p; i += kThreads) {
      const int e = i / p, c = i - e * p;
      float acc = 0.0f;
      for (int l = 0; l < chunk; ++l)
        acc = fmaf(m.q[l * np + e], m.v[l * p + c], acc);
      m.h[i] = fmaf(m.dl[e], m.h[i], acc);
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
