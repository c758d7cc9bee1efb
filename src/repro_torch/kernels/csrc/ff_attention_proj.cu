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
// the bytes (33.5 MB of the 39.8 MB at q/k/v [64,256,64], about 0.012 ms
// at 3.35 TB/s), so the fused edge saves only the intermediate's round
// trip.
//
// Design (bf16): the prefill kernel's block and body (ff_attention.cuh
// namespace wg: one consumer warpgroup on a 64-row q tile, one producer
// warp filling a ring of ``depth`` K/V stages by TMA, QK^T and PV on
// wgmma). When the tile is finished, the consumers round it to bf16 where
// the reference graph writes it into its ring and store it, 128-byte
// swizzled and zero past d and past the tile's ragged rows, over the q
// tile's slabs, which is exactly the A tile of the projection: 64 real
// rows, wgmma's M. The producer goes on filling the same ring with the
// words of w, a 64-deep k slab by 128 columns each (TMA boxes, ``streams``
// a half, or element copies where w's rows are not 16-byte aligned), and
// the consumers run the standalone matmul's product body on them
// (ff_matmul.cuh mma_slab: wgmma m64n128k16, the matmul's only instruction
// shape, every output one chain of k16 steps in k order from 0.f; the
// matmul never splits k this small, ops.py _plan). So the result equals
// ff_attention followed by ff_matmul bit for bit. Each finished 64 x 128
// output tile goes out through the stage its last word of w arrived in,
// as whole 16-byte rows. Shared memory is the q tile and the ring alone
// (41 KB at D 64, depth 2), so several blocks share an SM.
//
// f32: the prefill kernel's f32 block and body (ff_attention.cuh
// namespace f32: four consumer warps on a 64-row q tile, the producer warp
// filling a ring of ``depth`` K/V stages), so the finished tile is
// ff_attention's bits; the consumers write it over the q tile, then run
// the standalone matmul's CUDA-core product (ff_matmul.cuh fma_slab, every
// output one fmaf chain over D in order) on 16-deep slabs of w that they
// stage themselves through the freed ring, synchronously, the next slab's
// values held in registers meanwhile. So the result equals ff_attention
// followed by ff_matmul bit for bit at any depth and streams.

#include "ff_attention.cuh"
#include "ff_matmul.cuh"

namespace {

namespace mm = repro::mm;
namespace ring = repro::ring;
namespace wg = repro::attn::wg;
namespace f32 = repro::attn::f32;

// ---------------------------------------------------------------------------
// f32: the attention body, then the projection from slabs of w staged in
// turn
// ---------------------------------------------------------------------------

constexpr int kWSlabK = 16;    // k rows of w a staged slab: [16, 128] f32
constexpr int kWPerThread = kWSlabK * mm::kWgN / f32::kConsumers;   // 16

template <int kSlabs>
__global__ void __launch_bounds__(f32::kThreads)
    attention_proj_f32_kernel(const __grid_constant__ CUtensorMap map_q,
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
  const int t = threadIdx.x;
  {
    float o[kSlabs][4][4], l[4];
    f32::attend<kSlabs>(p, rg, q0, n_kv, o, l);
    // the finished tile over the q tile's rows of this warp (which only
    // it read), zeros past d and the ragged rows: the projection's A
    const int c = f32::col_of(t);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = f32::row_of(t, i);
#pragma unroll
      for (int x = 0; x < kSlabs; ++x) {
        const int col = 32 * x + 4 * c;
        float y[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          y[e] = r < rows && col + e < p.d ? f32::finish(o[x][i][e], l[i])
                                           : 0.f;
        *reinterpret_cast<float4*>(rg.q + x * f32::kQSlab +
                                   ring::sw128_f32(r, 4 * c)) =
            make_float4(y[0], y[1], y[2], y[3]);
      }
    }
  }
  f32::consumers_sync();   // every row of A written, every stage consumed
  // The projection: 64 x 128 output tiles, each thread rows tm + 8 i and
  // mm::fma_slab's 8 columns; word g is k slab g % nk of column tile g /
  // nk, staged by the consumers into the first ring stage (free now)
  // while the next word's values wait in registers.
  float* wbuf = reinterpret_cast<float*>(rg.stages);
  const int lane = t & 31, tm = 2 * (t >> 5) + (lane >> 4), tn = lane & 15;
  const int nk = (p.d + kWSlabK - 1) / kWSlabK;
  const int words = (p.d_out + mm::kWgN - 1) / mm::kWgN * nk;
  float wr[kWPerThread];
  auto fetch = [&](int g) {
    const int n0 = (g / nk) * mm::kWgN, k0 = (g % nk) * kWSlabK;
#pragma unroll
    for (int u = 0; u < kWPerThread; ++u) {
      const int k = k0 + u, n = n0 + t;
      wr[u] = k < p.d && n < p.d_out ? p.w[(long long)k * p.d_out + n] : 0.f;
    }
  };
  float* ob = p.out + (size_t(bh) * p.s + q0) * p.d_out;
  float acc[mm::kFmaRows][mm::kFmaCols];
  fetch(0);
  for (int g = 0; g < words; ++g) {
    const int n0 = (g / nk) * mm::kWgN, k0 = (g % nk) * kWSlabK;
    if (k0 == 0) {
#pragma unroll
      for (int i = 0; i < mm::kFmaRows; ++i)
#pragma unroll
        for (int j = 0; j < mm::kFmaCols; ++j) acc[i][j] = 0.f;
    }
    f32::consumers_sync();   // the last word's readers are done
#pragma unroll
    for (int u = 0; u < kWPerThread; ++u) wbuf[u * mm::kWgN + t] = wr[u];
    f32::consumers_sync();
    if (g + 1 < words) fetch(g + 1);
    mm::fma_slab<kWSlabK / 4, mm::kFmaRows, mm::kFmaCols>(
        acc,
        [&](int i, int kc) {
          const int k = k0 + 4 * kc;
          return f32::lds4(rg.q + (k >> 5) * f32::kQSlab +
                           ring::sw128_f32(tm + 8 * i, k & 31));
        },
        [&](int kk, float (&bv)[mm::kFmaCols]) {
          const float* row = wbuf + kk * mm::kWgN;
          const float4 x = *reinterpret_cast<const float4*>(row + 4 * tn);
          const float4 y =
              *reinterpret_cast<const float4*>(row + 64 + 4 * tn);
          bv[0] = x.x; bv[1] = x.y; bv[2] = x.z; bv[3] = x.w;
          bv[4] = y.x; bv[5] = y.y; bv[6] = y.z; bv[7] = y.w;
        });
    if (k0 + kWSlabK >= p.d) {
      float* rows_out[mm::kFmaRows];
#pragma unroll
      for (int i = 0; i < mm::kFmaRows; ++i) {
        const int r = tm + 8 * i;
        rows_out[i] = r < rows ? ob + (long long)r * p.d_out : nullptr;
      }
      mm::store_fma<float, mm::kFmaRows, mm::kFmaCols>(acc, rows_out, tn, n0,
                                                       p.d_out,
                           (p.d_out & 3) == 0);
    }
  }
}

template <int kSlabs>
int launch_f32_slabs(const f32::Args& p, const CUtensorMap& mq,
                     const CUtensorMap& mk, const CUtensorMap& mv, int bh,
                     size_t smem, cudaStream_t stream) {
  static const cudaError_t opted = cudaFuncSetAttribute(
      attention_proj_f32_kernel<kSlabs>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, f32::kMaxSmem);
  if (opted != cudaSuccess) return opted;
  dim3 grid((p.s + f32::kBlockQ - 1) / f32::kBlockQ, bh);
  attention_proj_f32_kernel<kSlabs><<<grid, f32::kThreads, smem, stream>>>(
      mq, mk, mv, p);
  return cudaGetLastError();
}

int launch_f32(const void* q, const void* k, const void* v, const void* w,
               void* out, int bh, int s, int skv, int d, int d_out,
               int causal, float scale, int depth, int streams,
               void* stream) {
  if (bh == 0 || s == 0 || d_out == 0) return 0;
  const int slabs = (d + 31) / 32;
  if (d < 1 || slabs > f32::kMaxSlabs || depth < 1 || streams < 1 ||
      f32::kBlockKV % streams || f32::kBlockKV / streams < 8)
    return cudaErrorInvalidValue;
  const size_t smem = f32::smem_bytes(slabs, depth);
  if (smem > size_t(f32::kMaxSmem)) return cudaErrorInvalidValue;
  // one KV head per q head (kv_groups 1), as the reference graph's
  f32::Args p{static_cast<const float*>(q), static_cast<const float*>(k),
              static_cast<const float*>(v), static_cast<const float*>(w),
              static_cast<float*>(out), s, skv, d, d_out, 1, causal, scale,
              depth, streams, f32::kElem, f32::kElem};
  CUtensorMap mq{}, mk{}, mv{};
  const int qbox = f32::kBlockQ / streams, kvbox = f32::kBlockKV / streams;
  if (ring::tma_ok_bytes(q, d, 4))
    p.q_copy = ring::encode_3d_typed(&mq, 4, q, d, s, bh, qbox) ? f32::kTma
                                                                 : -1;
  if (skv > 0 && ring::tma_ok_bytes(k, d, 4) && ring::tma_ok_bytes(v, d, 4))
    p.kv_copy =
        ring::encode_3d_typed(&mk, 4, k, d, skv, bh, kvbox) &&
                ring::encode_3d_typed(&mv, 4, v, d, skv, bh, kvbox)
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
// bf16: the attention body, then the projection on the same ring
// ---------------------------------------------------------------------------

// The producer's words of w after the attention's: word i is k slab
// i % slabs of the 128-column tile i / slabs, in stage (g0 + i) % depth,
// laid out as ff_matmul.cu's B slab (two 64-column halves).
__device__ inline void produce_w(const wg::Args& p, const CUtensorMap* map_w,
                                 const wg::Ring& rg, int slabs, int g0,
                                 int words) {
  const int lane = threadIdx.x & 31;
  const int rows = 64 / p.streams;
  const bool elem = p.w_copy == wg::kElem;
  for (int i = 0; i < words; ++i) {
    const ring::Slot s(g0 + i, p.depth);
    ring::wait(&rg.empty[s.stage], s.phase ^ 1);
    unsigned char* b = rg.stages + size_t(s.stage) * rg.stage_bytes;
    uint64_t* bar = &rg.full[s.stage];
    const int n0 = (i / slabs) * mm::kWgN, k0 = (i % slabs) * mm::kWgK;
    if (lane == 0) {
      ring::arrive_expect_tx(bar, elem ? 0 : mm::kBSlab);
      if (!elem)
        for (int h = 0; h < 2; ++h)
          for (int j = 0; j < p.streams; ++j)
            ring::tma_load_2d(b + h * mm::kBHalf + j * rows * 128, map_w,
                              bar, n0 + 64 * h, k0 + j * rows);
    }
    if (elem)
      for (int e = lane; e < mm::kWgK * mm::kWgN; e += 32) {
        const int r = e / mm::kWgN, c = e % mm::kWgN;
        *reinterpret_cast<__nv_bfloat16*>(b + (c >> 6) * mm::kBHalf +
                                          ring::sw128(r, c & 63)) =
            (k0 + r < p.d && n0 + c < p.d_out)
                ? p.w[(long long)(k0 + r) * p.d_out + n0 + c]
                : __float2bfloat16_rn(0.f);
      }
    wg::filled(bar, elem);
  }
}

// Store the warpgroup's 64 x 128 accumulators to ``out`` (row stride ldo)
// as bf16 through ``buf`` (16 KB of shared memory whose products are
// done): the fragments rounded into rows of 16-byte chunks (chunk c of
// row r at c ^ (r % 8), so neither side conflicts on banks), then each
// row written out in 16-byte stores where ldo and out allow, rows >=
// ``rows`` and columns >= ``cols`` dropped. The same roundings as
// mm::store_frag, so the same bits; the buffer is free again once this
// thread returns.
__device__ inline void store_staged(const float (&d)[mm::kWgAcc],
                                    unsigned char* buf,
                                    __nv_bfloat16* __restrict__ out,
                                    long long ldo, int rows, int cols) {
  const int t = threadIdx.x;
  auto at = [&](int r, int c16) {
    return buf + r * 256 + ((c16 ^ (r & 7)) << 4);
  };
#pragma unroll
  for (int j = 0; j < mm::kWgAcc; j += 2) {
    const int r = mm::frag_row(t, j), c = mm::frag_col(t, j);
    *reinterpret_cast<__nv_bfloat162*>(at(r, c >> 3) + (c & 7) * 2) =
        __floats2bfloat162_rn(d[j], d[j + 1]);
  }
  wg::consumers_sync();
  const bool vec = ldo % 8 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  for (int e = t; e < mm::kWgM * 16; e += wg::kConsumers) {
    const int r = e >> 4, c16 = e & 15, c = c16 * 8;
    if (r >= rows || c >= cols) continue;
    const uint4 x = *reinterpret_cast<const uint4*>(at(r, c16));
    __nv_bfloat16* dst = out + r * ldo + c;
    if (vec && c + 8 <= cols) {
      *reinterpret_cast<uint4*>(dst) = x;
    } else {
      const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&x);
      for (int k = 0; k < 8 && c + k < cols; ++k) dst[k] = h[k];
    }
  }
  ring::fence_async_smem();   // before the producer's TMA refills buf
}

template <int kSlabs>
__global__ void __launch_bounds__(wg::kThreads,
                                  kSlabs == 1 ? 3 : (kSlabs == 2 ? 2 : 1))
    attention_proj_wg_kernel(const __grid_constant__ CUtensorMap map_q,
                             const __grid_constant__ CUtensorMap map_k,
                             const __grid_constant__ CUtensorMap map_v,
                             const __grid_constant__ CUtensorMap map_w,
                             const wg::Args p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const wg::Ring rg = wg::carve(smem_raw, kSlabs, p.depth);
  wg::init(rg, p.depth);
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * wg::kBlockQ;
  const int rows = min(wg::kBlockQ, p.s - q0);
  const int n_kv = wg::kv_tiles(p, q0, rows);
  const int words = (p.d_out + mm::kWgN - 1) / mm::kWgN * kSlabs;
  if (threadIdx.x >= wg::kConsumers) {
    wg::produce(p, &map_q, &map_k, &map_v, rg, kSlabs, bh, q0, n_kv);
    produce_w(p, &map_w, rg, kSlabs, n_kv, words);
    return;
  }
  {
    float o[kSlabs][32], l[2];
    wg::attend<kSlabs>(p, rg, q0, n_kv, o, l);
    // the ring word: the finished tile in bf16 over the q tile's slabs (the
    // projection's K-major A tile), zeros past d and the ragged rows
    const int t = threadIdx.x;
#pragma unroll
    for (int c = 0; c < kSlabs; ++c)
#pragma unroll
      for (int j = 0; j < 32; j += 2) {
        const int r = wg::frag_row(t, j), col = 64 * c + wg::frag_col(t, j);
        const bool live = r < rows;
        const float x0 = live && col < p.d ? wg::finish(o[c][j], l, j) : 0.f;
        const float x1 =
            live && col + 1 < p.d ? wg::finish(o[c][j + 1], l, j + 1) : 0.f;
        *reinterpret_cast<__nv_bfloat162*>(
            rg.q + c * wg::kSlabBytes + ring::sw128(r, col & 63)) =
            __floats2bfloat162_rn(x0, x1);
      }
  }
  ring::fence_async_smem();
  wg::consumers_sync();
  __nv_bfloat16* ob = p.out + (size_t(bh) * p.s + q0) * p.d_out;
  const uint32_t a = ring::smem_addr(rg.q);
  float acc[mm::kWgAcc];
  for (int i = 0; i < words; ++i) {
    const ring::Slot s(n_kv + i, p.depth);
    ring::wait(&rg.full[s.stage], s.phase);
    if (p.w_copy == wg::kElem) ring::fence_async_smem();
    const int sl = i % kSlabs, n0 = (i / kSlabs) * mm::kWgN;
    if (sl == 0) {
#pragma unroll
      for (int x = 0; x < mm::kWgAcc; ++x) acc[x] = 0.f;
    }
    unsigned char* stage = rg.stages + size_t(s.stage) * rg.stage_bytes;
    mm::wg_fence();
    mm::mma_slab(acc, a + sl * wg::kSlabBytes, ring::smem_addr(stage));
    mm::wg_commit();
    mm::wg_wait<0>(acc);
    if (sl == kSlabs - 1)
      store_staged(acc, stage, ob + n0, p.d_out, rows, p.d_out - n0);
    ring::arrive(&rg.empty[s.stage]);
  }
}

template <int kSlabs>
int launch_wg_slabs(const wg::Args& p, const CUtensorMap& mq,
                    const CUtensorMap& mk, const CUtensorMap& mv,
                    const CUtensorMap& mw, int bh, size_t smem,
                    cudaStream_t stream) {
  static const cudaError_t opted = cudaFuncSetAttribute(
      attention_proj_wg_kernel<kSlabs>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, wg::kMaxSmem);
  if (opted != cudaSuccess) return opted;
  dim3 grid((p.s + wg::kBlockQ - 1) / wg::kBlockQ, bh);
  attention_proj_wg_kernel<kSlabs><<<grid, wg::kThreads, smem, stream>>>(
      mq, mk, mv, mw, p);
  return cudaGetLastError();
}

int launch_wg(const void* q, const void* k, const void* v, const void* w,
              void* out, int bh, int s, int skv, int d, int d_out,
              int causal, float scale, int depth, int streams, void* stream) {
  if (bh == 0 || s == 0 || d_out == 0) return 0;
  const int slabs = (d + 63) / 64;
  if (d < 1 || slabs > wg::kMaxSlabs || depth < 1 || streams < 1 ||
      wg::kBlockQ % streams || wg::kBlockQ / streams < 8)
    return cudaErrorInvalidValue;
  const size_t smem = wg::smem_bytes(slabs, depth);
  if (smem > size_t(wg::kMaxSmem)) return cudaErrorInvalidValue;
  const int box = wg::kBlockQ / streams;
  wg::Args p{static_cast<const __nv_bfloat16*>(q),
             static_cast<const __nv_bfloat16*>(k),
             static_cast<const __nv_bfloat16*>(v),
             static_cast<const __nv_bfloat16*>(w),
             static_cast<__nv_bfloat16*>(out), s, skv, d, d_out, 1, causal,
             scale, depth, streams, wg::kElem, wg::kElem, wg::kElem};
  CUtensorMap mq{}, mk{}, mv{}, mw{};
  if (ring::tma_ok(q, d))
    p.q_copy = ring::encode_3d(&mq, q, d, s, bh, box) ? wg::kTma : -1;
  if (skv > 0 && ring::tma_ok(k, d) && ring::tma_ok(v, d))
    p.kv_copy = ring::encode_3d(&mk, k, d, skv, bh, box) &&
                        ring::encode_3d(&mv, v, d, skv, bh, box)
                    ? wg::kTma : -1;
  if (ring::tma_ok(w, d_out))
    p.w_copy = ring::encode(&mw, w, d_out, d, d_out, box) ? wg::kTma : -1;
  if (p.q_copy < 0 || p.kv_copy < 0 || p.w_copy < 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (slabs) {
    case 1: return launch_wg_slabs<1>(p, mq, mk, mv, mw, bh, smem, st);
    case 2: return launch_wg_slabs<2>(p, mq, mk, mv, mw, bh, smem, st);
    case 3: return launch_wg_slabs<3>(p, mq, mk, mv, mw, bh, smem, st);
    default: return launch_wg_slabs<4>(p, mq, mk, mv, mw, bh, smem, st);
  }
}

}  // namespace

// out [BH*S, D_out] = attention(q, k, v [BH, S|Skv, D]) @ w [D, D_out], all
// contiguous. Both entries take the ring's depth and streams.
extern "C" int ff_attention_proj_f32(const void* q, const void* k,
                                     const void* v, const void* w, void* out,
                                     int bh, int s, int skv, int d, int d_out,
                                     int causal, float scale, int depth,
                                     int streams, void* stream) {
  return launch_f32(q, k, v, w, out, bh, s, skv, d, d_out, causal, scale,
                    depth, streams, stream);
}

extern "C" int ff_attention_proj_bf16(const void* q, const void* k,
                                      const void* v, const void* w,
                                      void* out, int bh, int s, int skv,
                                      int d, int d_out, int causal,
                                      float scale, int depth, int streams,
                                      void* stream) {
  return launch_wg(q, k, v, w, out, bh, s, skv, d, d_out, causal, scale,
                   depth, streams, stream);
}
