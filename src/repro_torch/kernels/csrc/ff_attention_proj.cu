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
// D_out in tiles, with w streamed from L2, through the product body that
// the standalone matmul runs on the same types (ff_matmul.cuh):
//   * bf16: the block is one warpgroup; the A tile is stored 128-byte
//     swizzled, padded from 32 to wgmma's 64 rows and to whole 64-deep k
//     slabs with zeros, and w is staged slab by slab (128 columns by 64
//     k, two buffers filled by cp.async) for wgmma m64n128k16, the
//     matmul's instruction shape: every output is the same chain of k16
//     steps in k order from 0.f as in the matmul, which never splits k
//     this small (ops.py _plan);
//   * f32: the CUDA-core body in 64-column tiles, every output one fmaf
//     chain over D in order.
// So the result equals ff_attention followed by ff_matmul bit for bit.

#include "ff_attention.cuh"
#include "ff_matmul.cuh"

#include <type_traits>

namespace {

namespace mm = repro::mm;
using repro::attn::kBlockQ;
using repro::attn::kThreads;
constexpr int kBN = 64;
using ProjSlab = mm::Slab<kBlockQ, kBN>;

template <typename T>
constexpr bool kTensorCores = std::is_same<T, __nv_bfloat16>::value;

// Shared memory after the attention body's: the f32 slab, or (bf16) the
// 1024-aligned A tile of whole k slabs and two B slabs.
template <typename T>
size_t smem_bytes(int d) {
  const size_t attn = sizeof(float) * repro::attn::smem_floats(d);
  if (!kTensorCores<T>) return attn + sizeof(ProjSlab);
  return attn + 1024 + size_t((d + mm::kWgK - 1) / mm::kWgK) * mm::kASlab +
         2 * mm::kBSlab;
}

// out[0:rows, :] = A @ w on the tensor cores, A the finished attention
// tile; ``tail`` is the shared memory past the attention body's.
__device__ void project_wgmma(const repro::attn::Tile& t, unsigned char* tail,
                              const __nv_bfloat16* __restrict__ w,
                              __nv_bfloat16* __restrict__ out, int rows,
                              int d, int d_out) {
  unsigned char* a_s =
      tail + ((1024 - (repro::ring::smem_addr(tail) & 1023)) & 1023);
  const int slabs = (d + mm::kWgK - 1) / mm::kWgK;
  const int width = slabs * mm::kWgK;
  unsigned char* b_s = a_s + slabs * mm::kASlab;
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
  // the ring word: the attention tile in bf16; rows past the tile's
  // ragged edge, rows 32..63 and k past d are 0
  for (int i = threadIdx.x; i < mm::kWgM * width; i += kThreads) {
    const int r = i / width, kk = i % width;
    *reinterpret_cast<__nv_bfloat16*>(
        a_s + (kk / mm::kWgK) * mm::kASlab +
        repro::ring::sw128(r, kk % mm::kWgK)) =
        (r < rows && kk < d)
            ? repro::attn::out_elem<__nv_bfloat16>(t, r * d + kk, d)
            : zero;
  }
  // the words of w: (128-column tile, 64-deep k slab), k innermost, into
  // two buffers, so the copy of word g+1 overlaps the products of word g;
  // 16-byte cp.async where w's rows allow it, element copies otherwise,
  // zeros past d and d_out
  const bool vec = reinterpret_cast<uintptr_t>(w) % 16 == 0 && d_out % 8 == 0;
  auto fetch = [&](int g, unsigned char* buf) {
    const int n0 = (g / slabs) * mm::kWgN, k0 = (g % slabs) * mm::kWgK;
    if (vec) {
      for (int e = threadIdx.x; e < mm::kWgK * mm::kWgN / 8; e += kThreads) {
        const int r = e / (mm::kWgN / 8), c = (e % (mm::kWgN / 8)) * 8;
        const int bytes =
            k0 + r < d ? max(0, min(16, 2 * (d_out - (n0 + c)))) : 0;
        repro::ring::cp_async_16(
            buf + (c >> 6) * mm::kBHalf + repro::ring::sw128(r, c & 63),
            bytes ? w + (long long)(k0 + r) * d_out + n0 + c : w, bytes);
      }
      repro::ring::cp_async_commit();
    } else {
      for (int e = threadIdx.x; e < mm::kWgK * mm::kWgN; e += kThreads) {
        const int r = e / mm::kWgN, c = e % mm::kWgN;
        *reinterpret_cast<__nv_bfloat16*>(buf + (c >> 6) * mm::kBHalf +
                                          repro::ring::sw128(r, c & 63)) =
            (k0 + r < d && n0 + c < d_out)
                ? w[(long long)(k0 + r) * d_out + n0 + c]
                : zero;
      }
    }
  };
  const int words = ((d_out + mm::kWgN - 1) / mm::kWgN) * slabs;
  float acc[mm::kWgAcc];
  fetch(0, b_s);
  for (int g = 0; g < words; ++g) {
    unsigned char* buf = b_s + (g & 1) * mm::kBSlab;
    const int s = g % slabs, n0 = (g / slabs) * mm::kWgN;
    if (vec) repro::ring::cp_async_wait_all();
    repro::ring::fence_async_smem();
    __syncthreads();   // word g landed; word g-1's products are done
    if (s == 0) {
#pragma unroll
      for (int i = 0; i < mm::kWgAcc; ++i) acc[i] = 0.f;
    }
    mm::wg_fence();
    mm::mma_slab(acc, repro::ring::smem_addr(a_s + s * mm::kASlab),
                 repro::ring::smem_addr(buf));
    mm::wg_commit();
    if (g + 1 < words) fetch(g + 1, b_s + ((g + 1) & 1) * mm::kBSlab);
    mm::wg_wait<0>(acc);
    if (s == slabs - 1)
      mm::store_frag(acc, out + n0, d_out, rows, d_out - n0);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    attention_proj_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ w,
                          T* __restrict__ out, int s, int skv, int d,
                          int d_out, int causal, float scale) {
  extern __shared__ float smem[];
  const repro::attn::Tile t = repro::attn::carve(smem, d);
  float* tail = smem + repro::attn::smem_floats(d);
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBlockQ;
  const int rows = min(kBlockQ, s - q0);
  // one KV head per q head (kv_groups 1), as the reference graph's
  repro::attn::attend<T>(t, q, k, v, bh, q0, rows, s, skv, d, 1, causal,
                         scale);
  T* ob = out + (size_t(bh) * s + q0) * d_out;
  if constexpr (kTensorCores<T>) {
    project_wgmma(t, reinterpret_cast<unsigned char*>(tail), w, ob, rows, d,
                  d_out);
  } else {
    ProjSlab& slab = *reinterpret_cast<ProjSlab*>(tail);
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
    for (int n0 = 0; n0 < d_out; n0 += kBN) {
      float acc[mm::kTM][mm::kTN];
      mm::product_tile<kBlockQ, kBN, kThreads>(acc, slab, load_a, w, d_out,
                                               d, n0, d_out);
      mm::store_tile<kBlockQ, kBN, kThreads>(acc, ob, d_out, rows, n0,
                                             d_out);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* w,
           void* out, int bh, int s, int skv, int d, int d_out, int causal,
           float scale, void* stream) {
  if (bh == 0 || s == 0 || d_out == 0) return 0;
  const size_t smem = smem_bytes<T>(d);
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
