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
// in f32). The body is ff_attention.cuh, shared with ff_attention_proj.cu.
// The TPU wrapper padded S to the block; here the ragged q and KV edges are
// masked in the kernel, so no padded copy is made. Faster designs (wgmma,
// TMA rings, warp specialisation) are for later work.

#include "ff_attention.cuh"

namespace {

using repro::attn::kBlockQ;
using repro::attn::kThreads;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out, int s,
                     int skv, int d, int kv_groups, int causal, float scale) {
  extern __shared__ float smem[];
  const repro::attn::Tile t = repro::attn::carve(smem, d);
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBlockQ;
  const int rows = min(kBlockQ, s - q0);
  repro::attn::attend<T>(t, q, k, v, bh, q0, rows, s, skv, d, kv_groups,
                         causal, scale);
  T* ob = out + (size_t(bh) * s + q0) * d;
  for (int i = threadIdx.x; i < rows * d; i += kThreads)
    ob[i] = repro::attn::out_elem<T>(t, i, d);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int bh,
           int s, int skv, int d, int kv_groups, int causal, float scale,
           void* stream) {
  if (bh == 0 || s == 0) return 0;
  const size_t smem = sizeof(float) * repro::attn::smem_floats(d);
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
