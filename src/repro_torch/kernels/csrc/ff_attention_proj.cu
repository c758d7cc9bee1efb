// Attention -> out-projection in one launch for the H100 (sm_90a):
// out[bh*S + i, :] = attention(q, k, v)[bh, i, :] @ w.
//
// Replaces the attention_proj StreamGraph of the reference
// (src/repro/models/layers.py build_attention_proj_graph, compiled by
// src/repro/core/graph.py _compile_chain into one pallas_call): the
// ff_attention output tile streamed through a VMEM ring into the ff_matmul
// consumer as its A operand, so the [BH, S, D] intermediate never reaches
// HBM.
//
// Bound on this card: q, k, v and w read once, the [BH*S, D_out] output
// written once; at serving widths (D 64, D_out 1024) the output dominates
// the bytes, so the fused edge saves only the intermediate's round trip.
//
// Design: one block of 128 threads per (bh, q tile of 32 rows). It runs
// the prefill kernel's body (ff_attention.cuh) over the K/V tiles, rounds
// the finished tile to the operand type where the reference graph writes
// it into its ring, keeps it in shared memory as the A operand, and walks
// D_out in 64-column tiles through the product body of ff_matmul.cuh, with
// w streamed from L2. Both bodies are the ones the standalone kernels run,
// and every output is one fmaf chain over D in order, so the result equals
// ff_attention followed by ff_matmul bit for bit.

#include "ff_attention.cuh"
#include "ff_matmul.cuh"

namespace {

using repro::attn::kBlockQ;
using repro::attn::kThreads;
constexpr int kBN = 64;
using ProjSlab = repro::mm::Slab<kBlockQ, kBN>;

size_t smem_bytes(int d) {
  return sizeof(float) * repro::attn::smem_floats(d) + sizeof(ProjSlab);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    attention_proj_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ w,
                          T* __restrict__ out, int s, int skv, int d,
                          int d_out, int causal, float scale) {
  extern __shared__ float smem[];
  const repro::attn::Tile t = repro::attn::carve(smem, d);
  ProjSlab& slab =
      *reinterpret_cast<ProjSlab*>(smem + repro::attn::smem_floats(d));
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBlockQ;
  const int rows = min(kBlockQ, s - q0);
  // one KV head per q head (kv_groups 1), as the reference graph's
  repro::attn::attend<T>(t, q, k, v, bh, q0, rows, s, skv, d, 1, causal,
                         scale);
  // the ring word: the attention tile in the operand type (the q tile's
  // shared memory is free again); rows past the ragged edge are 0
  float* a_s = t.q_s;
  for (int i = threadIdx.x; i < kBlockQ * d; i += kThreads)
    a_s[i] = (i / d < rows)
                 ? repro::to_f(repro::attn::out_elem<T>(t, i, d))
                 : 0.f;
  __syncthreads();
  auto load_a = [&](int r, int kk) -> float {
    return kk < d ? a_s[r * d + kk] : 0.f;
  };
  T* ob = out + (size_t(bh) * s + q0) * d_out;
  for (int n0 = 0; n0 < d_out; n0 += kBN) {
    float acc[repro::mm::kTM][repro::mm::kTN];
    repro::mm::product_tile<kBlockQ, kBN, kThreads>(acc, slab, load_a, w,
                                                    d_out, d, n0, d_out);
    repro::mm::store_tile<kBlockQ, kBN, kThreads>(acc, ob, d_out, rows, n0,
                                                  d_out);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* w,
           void* out, int bh, int s, int skv, int d, int d_out, int causal,
           float scale, void* stream) {
  if (bh == 0 || s == 0 || d_out == 0) return 0;
  const size_t smem = smem_bytes(d);
  cudaError_t err = repro::allow_smem(attention_proj_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((s + kBlockQ - 1) / kBlockQ, bh);
  attention_proj_kernel<T><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(w),
      static_cast<T*>(out), s, skv, d, d_out, causal, scale);
  return cudaGetLastError();
}

}  // namespace

#define REPRO_ATTENTION_PROJ_ENTRY(SUFFIX, T)                                 \
  extern "C" int ff_attention_proj_##SUFFIX(                                  \
      const void* q, const void* k, const void* v, const void* w, void* out,  \
      int bh, int s, int skv, int d, int d_out, int causal, float scale,      \
      void* stream) {                                                         \
    return launch<T>(q, k, v, w, out, bh, s, skv, d, d_out, causal, scale,    \
                     stream);                                                 \
  }

REPRO_ATTENTION_PROJ_ENTRY(f32, float)
REPRO_ATTENTION_PROJ_ENTRY(bf16, __nv_bfloat16)
