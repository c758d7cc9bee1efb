// The flash-attention body shared by the prefill kernel (ff_attention.cu)
// and the attention->projection launch (ff_attention_proj.cu).
//
// One block of kThreads computes the attention of one q tile of kBlockQ
// rows of head bh: an f32 online softmax over K/V tiles of kBlockKV rows
// staged in shared memory, tiles past the causal diagonal skipped, -1e30
// masking, p rounded to the V type before the PV product. Both kernels run
// this same code, so the tile they hold at the end is the same bits.
#pragma once

#include "common.cuh"

namespace repro {
namespace attn {

constexpr int kThreads = 128;
constexpr int kBlockQ = 32;   // = ff_attention/ops.py BLOCK_Q
constexpr int kBlockKV = 32;  // = ff_attention/ops.py BLOCK_KV (one per lane)

// Floats of shared memory the body needs at head dim d (a multiple of 4,
// so whatever a kernel places after it stays 16-byte aligned).
__host__ __device__ inline size_t smem_floats(int d) {
  const size_t n = size_t(kBlockQ) * d            // q tile
                   + size_t(kBlockKV) * (d + 1)   // k tile (row pad)
                   + size_t(kBlockKV) * d         // v tile
                   + size_t(kBlockQ) * kBlockKV   // scores / p
                   + size_t(kBlockQ) * d          // acc
                   + 3 * kBlockQ;                 // m, l, alpha
  return (n + 3) / 4 * 4;
}

struct Tile {
  float* q_s;
  float* k_s;
  float* v_s;
  float* p_s;
  float* acc;
  float* m_s;
  float* l_s;
  float* a_s;
};

__device__ inline Tile carve(float* smem, int d) {
  Tile t;
  t.q_s = smem;
  t.k_s = t.q_s + kBlockQ * d;
  t.v_s = t.k_s + kBlockKV * (d + 1);
  t.p_s = t.v_s + kBlockKV * d;
  t.acc = t.p_s + kBlockQ * kBlockKV;
  t.m_s = t.acc + kBlockQ * d;
  t.l_s = t.m_s + kBlockQ;
  t.a_s = t.l_s + kBlockQ;
  return t;
}

// Attention of q rows q0 .. q0+rows-1 of head bh: leaves the unnormalised
// acc and the row sums l in shared memory, after a block barrier.
template <typename T>
__device__ void attend(const Tile& t, const T* __restrict__ q,
                       const T* __restrict__ k, const T* __restrict__ v,
                       int bh, int q0, int rows, int s, int skv, int d,
                       int kv_groups, int causal, float scale) {
  float* q_s = t.q_s;
  float* k_s = t.k_s;
  float* v_s = t.v_s;
  float* p_s = t.p_s;
  float* acc = t.acc;
  float* m_s = t.m_s;
  float* l_s = t.l_s;
  float* a_s = t.a_s;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T* qb = q + (size_t(bh) * s + q0) * d;
  const T* kb = k + size_t(bh / kv_groups) * skv * d;
  const T* vb = v + size_t(bh / kv_groups) * skv * d;

  for (int i = tid; i < kBlockQ * d; i += kThreads) {
    q_s[i] = (i / d < rows) ? to_f(qb[i]) : 0.f;
    acc[i] = 0.f;
  }
  for (int r = tid; r < kBlockQ; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }

  int n_kv = (skv + kBlockKV - 1) / kBlockKV;
  if (causal) n_kv = min(n_kv, (q0 + rows - 1) / kBlockKV + 1);
  for (int kj = 0; kj < n_kv; ++kj) {
    const int kv0 = kj * kBlockKV;
    const int cols = min(kBlockKV, skv - kv0);
    __syncthreads();  // previous tile's readers are done with k_s/v_s/p_s
    for (int i = tid; i < kBlockKV * d; i += kThreads) {
      const int j = i / d, e = i - j * d;
      const bool ok = j < cols;
      k_s[j * (d + 1) + e] = ok ? to_f(kb[size_t(kv0 + j) * d + e]) : 0.f;
      v_s[i] = ok ? to_f(vb[size_t(kv0 + j) * d + e]) : 0.f;
    }
    __syncthreads();
    for (int i = tid; i < kBlockQ * kBlockKV; i += kThreads) {
      const int r = i / kBlockKV, j = i - r * kBlockKV;
      const float* qr = q_s + r * d;
      const float* kr = k_s + j * (d + 1);
      float acc_s = 0.f;
      for (int e = 0; e < d; ++e) acc_s = fmaf(qr[e], kr[e], acc_s);
      float sc = acc_s * scale;
      const int col = kv0 + j;
      if (col >= skv || (causal && col > q0 + r)) sc = kNegInf;
      p_s[i] = sc;
    }
    __syncthreads();
    for (int r = warp; r < kBlockQ; r += kThreads / 32) {
      const float sc = p_s[r * kBlockKV + lane];
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, warp_max(sc));
      const float p = expf(sc - m_new);
      const float sum = warp_sum(p);
      p_s[r * kBlockKV + lane] = to_f(from_f<T>(p));
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        l_s[r] = fmaf(l_s[r], alpha, sum);
        m_s[r] = m_new;
        a_s[r] = alpha;
      }
    }
    __syncthreads();
    for (int i = tid; i < kBlockQ * d; i += kThreads) {
      const int r = i / d, e = i - r * d;
      const float* pr = p_s + r * kBlockKV;
      float pv = 0.f;
      for (int j = 0; j < kBlockKV; ++j) pv = fmaf(pr[j], v_s[j * d + e], pv);
      acc[i] = fmaf(acc[i], a_s[r], pv);
    }
  }
  __syncthreads();
}

// Element i (row i / d) of the finished tile, rounded to T; a row that
// attended to nothing (l == 0) gives 0.
template <typename T>
__device__ __forceinline__ T out_elem(const Tile& t, int i, int d) {
  float l = t.l_s[i / d];
  l = (l == 0.f) ? 1.f : l;
  return from_f<T>(t.acc[i] / l);
}

}  // namespace attn
}  // namespace repro
