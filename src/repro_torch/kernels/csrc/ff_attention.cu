// Prefill flash attention (causal or not, GQA) for the H100 (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ff_attention/kernel.py
// (build_program / flash_attention_ff): q [BH,S,D], k/v [BKVH,Skv,D], q head
// bh reads KV head bh / kv_groups; f32 online softmax over K/V tiles, tiles
// past the causal diagonal skipped, -1e30 masking, a row with l == 0 gives 0,
// and p rounded to the V type before the PV product (kernel.py:90-91).
//
// Bound on this card: causal prefill does 2*BH*S^2*D operations over
// (2+2*BKVH/BH)*BH*S*D elements moved, so at the serving lengths
// (S <= a few hundred) it is bound by launch and latency, and at long S by
// the tensor cores (989 TFLOP/s bf16). This first kernel does the products
// with scalar FMAs from shared memory, so it is bound by shared-memory
// bandwidth, far from either roof.
//
// Design: one block of 128 threads per (bh, q tile of 32 rows), looping over
// K/V tiles of 32 rows staged in shared memory (the TPU's sequential grid
// axis kj becomes this loop; the running m, l and acc live in shared memory
// in f32). The TPU wrapper padded S to the block; here the ragged q and KV
// edges are masked in the kernel, so no padded copy is made. Faster designs
// (wgmma, TMA rings, warp specialisation) are for later work.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kBlockQ = 32;   // = ff_attention/ops.py BLOCK_Q
constexpr int kBlockKV = 32;  // = ff_attention/ops.py BLOCK_KV (one per lane)

size_t smem_bytes(int d) {
  return sizeof(float) *
         (size_t(kBlockQ) * d            // q tile
          + size_t(kBlockKV) * (d + 1)   // k tile (row pad: no bank clash)
          + size_t(kBlockKV) * d         // v tile
          + size_t(kBlockQ) * kBlockKV   // scores / p
          + size_t(kBlockQ) * d          // acc
          + 3 * kBlockQ);                // m, l, alpha
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out, int s,
                     int skv, int d, int kv_groups, int causal, float scale) {
  using repro::kNegInf;
  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + kBlockQ * d;
  float* v_s = k_s + kBlockKV * (d + 1);
  float* p_s = v_s + kBlockKV * d;
  float* acc = p_s + kBlockQ * kBlockKV;
  float* m_s = acc + kBlockQ * d;
  float* l_s = m_s + kBlockQ;
  float* a_s = l_s + kBlockQ;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBlockQ;
  const int rows = min(kBlockQ, s - q0);
  const T* qb = q + (size_t(bh) * s + q0) * d;
  const T* kb = k + size_t(bh / kv_groups) * skv * d;
  const T* vb = v + size_t(bh / kv_groups) * skv * d;

  for (int i = tid; i < kBlockQ * d; i += kThreads) {
    q_s[i] = (i / d < rows) ? repro::to_f(qb[i]) : 0.f;
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
      k_s[j * (d + 1) + e] =
          ok ? repro::to_f(kb[size_t(kv0 + j) * d + e]) : 0.f;
      v_s[i] = ok ? repro::to_f(vb[size_t(kv0 + j) * d + e]) : 0.f;
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
      const float m_new = fmaxf(m_prev, repro::warp_max(sc));
      const float p = expf(sc - m_new);
      const float sum = repro::warp_sum(p);
      p_s[r * kBlockKV + lane] = repro::to_f(repro::from_f<T>(p));
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
  T* ob = out + (size_t(bh) * s + q0) * d;
  for (int i = tid; i < rows * d; i += kThreads) {
    float l = l_s[i / d];
    l = (l == 0.f) ? 1.f : l;
    ob[i] = repro::from_f<T>(acc[i] / l);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int bh,
           int s, int skv, int d, int kv_groups, int causal, float scale,
           void* stream) {
  if (bh == 0 || s == 0) return 0;
  const size_t smem = smem_bytes(d);
  cudaError_t err = repro::allow_smem(attention_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((s + kBlockQ - 1) / kBlockQ, bh);
  attention_kernel<T><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), s, skv, d, kv_groups,
      causal, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int ff_attention_f32(const void* q, const void* k, const void* v,
                                void* out, int bh, int s, int skv, int d,
                                int kv_groups, int causal, float scale,
                                void* stream) {
  return launch<float>(q, k, v, out, bh, s, skv, d, kv_groups, causal, scale,
                       stream);
}

extern "C" int ff_attention_bf16(const void* q, const void* k, const void* v,
                                 void* out, int bh, int s, int skv, int d,
                                 int kv_groups, int causal, float scale,
                                 void* stream) {
  return launch<__nv_bfloat16>(q, k, v, out, bh, s, skv, d, kv_groups,
                               causal, scale, stream);
}
