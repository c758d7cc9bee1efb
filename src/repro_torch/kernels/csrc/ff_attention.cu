// Prefill flash attention (causal or not, GQA) for the H100 (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ff_attention/kernel.py
// (build_program / flash_attention_ff): q [BH,S,D], k/v [BKVH,Skv,D], q head
// bh reads KV head bh / kv_groups; f32 online softmax over K/V tiles, tiles
// past the causal diagonal skipped, -1e30 masking, a row with l == 0 gives 0,
// and p rounded to the V type before the PV product (kernel.py:90-91).
//
// Bound on this card: causal prefill does 2*BH*S^2*D operations over
// (2+2*BKVH/BH)*BH*S*D elements moved: at qwen's 4 x 256-token prefill
// (q/k/v [64,256,64]) 0.54 GFLOP over 8.4 MB, 2.5 us of HBM against 0.54
// us of tensor cores, so bytes bound it; at the serving lengths the
// launch and the latency of one KV tile's fill and products set the time;
// at long S the tensor cores (989 TFLOP/s bf16) do.
//
// Design (bf16; the body is ff_attention.cuh namespace wg): one block per
// (bh, q tile of 64 rows), one consumer warpgroup and one producer warp.
// The producer fills a ring_pipe.cuh ring of ``depth`` stages with K and V
// tiles of 64 rows by TMA (``streams`` boxes a tile; 3-D maps, so a head's
// ragged end is zero-filled), or with element copies where TMA cannot
// describe the tensor; the consumer runs QK^T and PV on wgmma with the
// online softmax in registers, and releases each stage when its PV is
// done. depth = 1 is the synchronous copy-then-compute baseline; at depth
// >= 2 the next tile's fill overlaps this tile's products. The TPU's
// sequential grid axis kj becomes the consumer's loop over the ring; the
// TPU wrapper padded S to the block, here the ragged q and KV edges are
// masked in the kernel, so no padded copy is made.
//
// f32 (no TF32; the body is namespace f32): the CUDA cores bound it, 67
// TFLOP/s (0.00804 ms at q/k/v [64,256,64]). One block per (bh, q tile of
// 64 rows), four consumer warps and one producer warp, which fills the
// same kind of ring with K and V tiles of 32 rows (TMA, ``streams`` boxes
// a tile, 128-byte swizzled 32-float slabs) or element copies. Each
// consumer thread computes a 4 x 4 block of scores and of each output
// slab from 16-byte shared loads (64 fmaf for every 8 of them). depth = 1
// is again the synchronous baseline.

#include "ff_attention.cuh"

namespace {

namespace ring = repro::ring;
namespace wg = repro::attn::wg;
namespace f32 = repro::attn::f32;

// ---------------------------------------------------------------------------
// f32: the ring pipe feeding the CUDA cores
// ---------------------------------------------------------------------------

template <int kSlabs>
__global__ void __launch_bounds__(f32::kThreads)
    attention_f32_kernel(const __grid_constant__ CUtensorMap map_q,
                         const __grid_constant__ CUtensorMap map_k,
                         const __grid_constant__ CUtensorMap map_v,
                         const f32::Args p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const f32::Ring rg = f32::carve(smem_raw, kSlabs, p.depth);
  f32::init(rg, p.depth);
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * f32::kBlockQ;
  const int rows = min(f32::kBlockQ, p.s - q0);
  const int n_kv = f32::kv_tiles(p, q0, rows);
  if (threadIdx.x >= f32::kConsumers) {
    f32::produce(p, &map_q, &map_k, &map_v, rg, kSlabs, bh, q0, n_kv);
    return;
  }
  float o[kSlabs][4][4], l[4];
  f32::attend<kSlabs>(p, rg, q0, n_kv, o, l);
  // the finished tile: four columns as one store where d allows
  const int t = threadIdx.x, c = f32::col_of(t);
  float* ob = p.out + (size_t(bh) * p.s + q0) * p.d;
  const bool vec = (p.d & 3) == 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = f32::row_of(t, i);
    if (r >= rows) continue;
#pragma unroll
    for (int x = 0; x < kSlabs; ++x) {
      const int col = 32 * x + 4 * c;
      float y[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) y[e] = f32::finish(o[x][i][e], l[i]);
      float* dst = ob + size_t(r) * p.d + col;
      if (vec && col < p.d) {
        *reinterpret_cast<float4*>(dst) = make_float4(y[0], y[1], y[2], y[3]);
      } else {
        for (int e = 0; e < 4 && col + e < p.d; ++e) dst[e] = y[e];
      }
    }
  }
}

template <int kSlabs>
int launch_f32_slabs(const f32::Args& p, const CUtensorMap& mq,
                     const CUtensorMap& mk, const CUtensorMap& mv, int bh,
                     size_t smem, cudaStream_t stream) {
  static const cudaError_t opted = cudaFuncSetAttribute(
      attention_f32_kernel<kSlabs>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, f32::kMaxSmem);
  if (opted != cudaSuccess) return opted;
  dim3 grid((p.s + f32::kBlockQ - 1) / f32::kBlockQ, bh);
  attention_f32_kernel<kSlabs><<<grid, f32::kThreads, smem, stream>>>(mq, mk,
                                                                      mv, p);
  return cudaGetLastError();
}

int launch_f32(const void* q, const void* k, const void* v, void* out, int bh,
               int s, int skv, int d, int kv_groups, int causal, float scale,
               int depth, int streams, void* stream) {
  if (bh == 0 || s == 0) return 0;
  const int slabs = (d + 31) / 32;
  if (d < 1 || slabs > f32::kMaxSlabs || depth < 1 || streams < 1 ||
      f32::kBlockKV % streams || f32::kBlockKV / streams < 8)
    return cudaErrorInvalidValue;
  const size_t smem = f32::smem_bytes(slabs, depth);
  if (smem > size_t(f32::kMaxSmem)) return cudaErrorInvalidValue;
  f32::Args p{static_cast<const float*>(q), static_cast<const float*>(k),
              static_cast<const float*>(v), nullptr,
              static_cast<float*>(out), s, skv, d, 0, kv_groups, causal,
              scale, depth, streams, f32::kElem, f32::kElem};
  CUtensorMap mq{}, mk{}, mv{};
  const int qbox = f32::kBlockQ / streams, kvbox = f32::kBlockKV / streams;
  if (ring::tma_ok_bytes(q, d, 4))
    p.q_copy = ring::encode_3d_typed(&mq, 4, q, d, s, bh, qbox) ? f32::kTma
                                                                 : -1;
  if (skv > 0 && ring::tma_ok_bytes(k, d, 4) && ring::tma_ok_bytes(v, d, 4))
    p.kv_copy =
        ring::encode_3d_typed(&mk, 4, k, d, skv, bh / kv_groups, kvbox) &&
                ring::encode_3d_typed(&mv, 4, v, d, skv, bh / kv_groups, kvbox)
            ? f32::kTma : -1;
  if (p.q_copy < 0 || p.kv_copy < 0) return cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (slabs) {
    case 1: return launch_f32_slabs<1>(p, mq, mk, mv, bh, smem, st);
    case 2: return launch_f32_slabs<2>(p, mq, mk, mv, bh, smem, st);
    case 3: return launch_f32_slabs<3>(p, mq, mk, mv, bh, smem, st);
    case 4: return launch_f32_slabs<4>(p, mq, mk, mv, bh, smem, st);
    case 5: return launch_f32_slabs<5>(p, mq, mk, mv, bh, smem, st);
    case 6: return launch_f32_slabs<6>(p, mq, mk, mv, bh, smem, st);
    case 7: return launch_f32_slabs<7>(p, mq, mk, mv, bh, smem, st);
    default: return launch_f32_slabs<8>(p, mq, mk, mv, bh, smem, st);
  }
}

// ---------------------------------------------------------------------------
// bf16: the ring pipe feeding wgmma
// ---------------------------------------------------------------------------

template <int kSlabs>
__global__ void __launch_bounds__(wg::kThreads,
                                  kSlabs == 1 ? 3 : (kSlabs == 2 ? 2 : 1))
    attention_wg_kernel(const __grid_constant__ CUtensorMap map_q,
                        const __grid_constant__ CUtensorMap map_k,
                        const __grid_constant__ CUtensorMap map_v,
                        const wg::Args p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const wg::Ring rg = wg::carve(smem_raw, kSlabs, p.depth);
  wg::init(rg, p.depth);
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * wg::kBlockQ;
  const int rows = min(wg::kBlockQ, p.s - q0);
  const int n_kv = wg::kv_tiles(p, q0, rows);
  if (threadIdx.x >= wg::kConsumers) {
    wg::produce(p, &map_q, &map_k, &map_v, rg, kSlabs, bh, q0, n_kv);
    return;
  }
  float o[kSlabs][32], l[2];
  wg::attend<kSlabs>(p, rg, q0, n_kv, o, l);
  // the finished tile: column pairs as one store where d is even
  const int t = threadIdx.x;
  __nv_bfloat16* ob = p.out + (size_t(bh) * p.s + q0) * p.d;
  const bool pairs = (p.d & 1) == 0;
#pragma unroll
  for (int c = 0; c < kSlabs; ++c)
#pragma unroll
    for (int j = 0; j < 32; j += 2) {
      const int r = wg::frag_row(t, j), col = 64 * c + wg::frag_col(t, j);
      if (r >= rows || col >= p.d) continue;
      const float x0 = wg::finish(o[c][j], l, j);
      const float x1 = wg::finish(o[c][j + 1], l, j + 1);
      __nv_bfloat16* dst = ob + size_t(r) * p.d + col;
      if (pairs) {
        *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(x0,
                                                                        x1);
      } else {
        dst[0] = __float2bfloat16_rn(x0);
        if (col + 1 < p.d) dst[1] = __float2bfloat16_rn(x1);
      }
    }
}

template <int kSlabs>
int launch_wg_slabs(const wg::Args& p, const CUtensorMap& mq,
                    const CUtensorMap& mk, const CUtensorMap& mv, int bh,
                    size_t smem, cudaStream_t stream) {
  static const cudaError_t opted = cudaFuncSetAttribute(
      attention_wg_kernel<kSlabs>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, wg::kMaxSmem);
  if (opted != cudaSuccess) return opted;
  dim3 grid((p.s + wg::kBlockQ - 1) / wg::kBlockQ, bh);
  attention_wg_kernel<kSlabs><<<grid, wg::kThreads, smem, stream>>>(mq, mk,
                                                                    mv, p);
  return cudaGetLastError();
}

int launch_wg(const void* q, const void* k, const void* v, void* out, int bh,
              int s, int skv, int d, int kv_groups, int causal, float scale,
              int depth, int streams, void* stream) {
  if (bh == 0 || s == 0) return 0;
  const int slabs = (d + 63) / 64;
  if (d < 1 || slabs > wg::kMaxSlabs || depth < 1 || streams < 1 ||
      wg::kBlockQ % streams || wg::kBlockQ / streams < 8)
    return cudaErrorInvalidValue;
  const size_t smem = wg::smem_bytes(slabs, depth);
  if (smem > size_t(wg::kMaxSmem)) return cudaErrorInvalidValue;
  const int box = wg::kBlockQ / streams;
  wg::Args p{static_cast<const __nv_bfloat16*>(q),
             static_cast<const __nv_bfloat16*>(k),
             static_cast<const __nv_bfloat16*>(v), nullptr,
             static_cast<__nv_bfloat16*>(out), s, skv, d, 0, kv_groups,
             causal, scale, depth, streams, wg::kElem, wg::kElem,
             wg::kElem};
  CUtensorMap mq{}, mk{}, mv{};
  if (ring::tma_ok(q, d))
    p.q_copy = ring::encode_3d(&mq, q, d, s, bh, box) ? wg::kTma : -1;
  if (skv > 0 && ring::tma_ok(k, d) && ring::tma_ok(v, d))
    p.kv_copy = ring::encode_3d(&mk, k, d, skv, bh / kv_groups, box) &&
                        ring::encode_3d(&mv, v, d, skv, bh / kv_groups, box)
                    ? wg::kTma : -1;
  if (p.q_copy < 0 || p.kv_copy < 0) return cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (slabs) {
    case 1: return launch_wg_slabs<1>(p, mq, mk, mv, bh, smem, st);
    case 2: return launch_wg_slabs<2>(p, mq, mk, mv, bh, smem, st);
    case 3: return launch_wg_slabs<3>(p, mq, mk, mv, bh, smem, st);
    default: return launch_wg_slabs<4>(p, mq, mk, mv, bh, smem, st);
  }
}

}  // namespace

// out [BH, S, D] = attention(q [BH, S, D], k/v [BH / kv_groups, Skv, D]),
// all contiguous. Both entries take the ring's depth and streams.
extern "C" int ff_attention_f32(const void* q, const void* k, const void* v,
                                void* out, int bh, int s, int skv, int d,
                                int kv_groups, int causal, float scale,
                                int depth, int streams, void* stream) {
  return launch_f32(q, k, v, out, bh, s, skv, d, kv_groups, causal, scale,
                    depth, streams, stream);
}

extern "C" int ff_attention_bf16(const void* q, const void* k, const void* v,
                                 void* out, int bh, int s, int skv, int d,
                                 int kv_groups, int causal, float scale,
                                 int depth, int streams, void* stream) {
  return launch_wg(q, k, v, out, bh, s, skv, d, kv_groups, causal, scale,
                   depth, streams, stream);
}
