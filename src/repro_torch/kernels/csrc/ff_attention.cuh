// The flash-attention bodies shared by the prefill kernel (ff_attention.cu)
// and the attention->projection launch (ff_attention_proj.cu). Both kernels
// run the same body on the same tile, so the tile they hold at the end is
// the same bits. Two bodies, chosen by the type:
//
// * bf16, namespace wg: the tensor cores behind the ring pipe. One block
//   is one consumer warpgroup (a q tile of kBlockQ = 64 rows, wgmma's M)
//   and one producer warp. The producer loads the q tile once and then
//   fills a ring_pipe.cuh ring of ``depth`` stages, each holding one K and
//   one V tile of kBlockKV = 64 rows, by TMA (``streams`` boxes a tile, 3-D
//   maps over [heads, rows, d], so rows past a head's end arrive as zeros
//   and never as the next head's), or by element copies where TMA cannot
//   describe the tensor (d not a multiple of 8, a base not 16-byte
//   aligned). d is padded to whole 64-column slabs of 128-byte swizzled
//   rows, zeros past d. The consumer runs S = Q K^T as wgmma m64n64k16
//   with both operands K-major in shared memory, masks (-1e30) and scales
//   S, runs the online softmax in registers (a row of the accumulator is
//   held by four threads, reduced with two shuffles), rescales the output
//   accumulator, rounds p to bf16 and repacks it in registers as the A
//   fragments of PV, which runs as wgmma m64n64k16 per d slab with V read
//   MN-major from the stage (the way ff_matmul.cuh reads B). acc, m and l
//   stay in f32; tiles past the causal diagonal are skipped; a row with
//   l == 0 gives 0.
// * f32, namespace f32: the CUDA cores (the library promises no TF32)
//   behind the same kind of ring. One block is four consumer warps (a q
//   tile of kBlockQ = 64 rows, 16 a warp) and one producer warp. The
//   producer loads the q tile once and fills a ring of ``depth`` stages,
//   each one K and one V tile of kBlockKV = 32 rows, by TMA (``streams``
//   boxes a tile, 3-D maps, 128-byte swizzled slabs of 32 floats, zeros
//   past d and past a head's rows) or by element copies where TMA cannot
//   describe the tensor (d not a multiple of 4, a base not 16-byte
//   aligned). The swizzle stands in for the row padding a CUDA-core body
//   would use against bank conflicts, which TMA cannot write. Each thread
//   computes 4 x 4 scores and keeps 4 rows x 4 columns of each slab of the
//   output in registers, reading q, K, p and V as 16-byte shared loads
//   that no two lanes of a quarter warp take from one bank (the q tile
//   stays in shared memory: at d = 256 a thread's rows would not fit its
//   registers). The arithmetic is the first port's f32 body's, term for
//   term (see attend), so the bits do not depend on depth or streams.
#pragma once

#include "common.cuh"
#include "ff_matmul.cuh"
#include "ring_pipe.cuh"

namespace repro {
namespace attn {

// ---------------------------------------------------------------------------
// f32: the ring pipe feeding the CUDA cores
// ---------------------------------------------------------------------------
namespace f32 {

constexpr int kBlockQ = 64;    // = ff_attention/ops.py BLOCK_Q[float32]
constexpr int kBlockKV = 32;   // = ff_attention/ops.py BLOCK_KV[float32]
constexpr int kWarps = 4;      // consumer warps, 16 q rows each
constexpr int kConsumers = 32 * kWarps;
constexpr int kThreads = kConsumers + 32;    // + one producer warp
constexpr int kQSlab = kBlockQ * 128;        // 64 rows x 32 floats
constexpr int kKVSlab = kBlockKV * 128;      // 32 rows x 32 floats
constexpr int kPBytes = kBlockQ * 128;       // p: 64 rows x 32 columns
constexpr int kMaxSmem = 232448;             // 227 KB a block
constexpr int kMaxSlabs = 8;                 // d <= 256

// How the producer fills a tile: TMA boxes, or element loads and stores.
enum Copy { kTma = 0, kElem = 1 };

struct Args {
  const float* q;   // [BH, S, D]
  const float* k;   // [BKVH, Skv, D]
  const float* v;
  const float* w;   // attention_proj: [D, D_out]
  float* out;
  int s, skv, d, d_out, kv_groups, causal;
  float scale;
  int depth, streams;
  int q_copy, kv_copy;
};

// Dynamic shared memory at ``slabs`` 32-column slabs of d and a ring of
// ``depth`` stages: 1024 bytes of alignment slack, the q tile, the p tile,
// the stages (a K and a V tile each), a full and an empty barrier a stage
// and the q tile's barrier. ops.py _smem_bytes computes the same.
__host__ __device__ constexpr size_t smem_bytes(int slabs, int depth) {
  return 1024 + size_t(slabs) * kQSlab + kPBytes +
         size_t(depth) * 2 * slabs * kKVSlab + 8 * (2 * size_t(depth) + 1);
}

struct Ring {
  unsigned char* q;        // the q tile: slabs of 64 x 32, swizzled
  unsigned char* p;        // p of the tile in flight: 64 x 32 (p_at)
  unsigned char* stages;   // stage i at stages + i * stage_bytes
  uint64_t* full;
  uint64_t* empty;
  uint64_t* q_full;
  int stage_bytes;
};

__device__ inline Ring carve(unsigned char* smem_raw, int slabs, int depth) {
  Ring r;
  r.q = smem_raw + ((1024 - (ring::smem_addr(smem_raw) & 1023)) & 1023);
  r.p = r.q + slabs * kQSlab;
  r.stages = r.p + kPBytes;
  r.stage_bytes = 2 * slabs * kKVSlab;
  r.full = reinterpret_cast<uint64_t*>(r.stages + size_t(depth) *
                                                      r.stage_bytes);
  r.empty = r.full + depth;
  r.q_full = r.empty + depth;
  return r;
}

// Thread 0 initialises the barriers; then the whole block syncs.
__device__ inline void init(const Ring& r, int depth) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < depth; ++s) {
      ring::init(&r.full[s], ring::kFullArrivals);
      ring::init(&r.empty[s], kWarps);   // one arrival a consumer warp
    }
    ring::init(r.q_full, ring::kFullArrivals);
    ring::fence_init();
  }
  __syncthreads();
}

// KV tiles a q tile at q0 (``rows`` live rows) reads: tiles past the causal
// diagonal are skipped.
__device__ __forceinline__ int kv_tiles(const Args& p, int q0, int rows) {
  int n = (p.skv + kBlockKV - 1) / kBlockKV;
  if (p.causal) n = min(n, (q0 + rows - 1) / kBlockKV + 1);
  return n;
}

// ``nrows`` rows from r0 of slice ``head`` of a [heads, total, d] tensor
// into ``dst`` as swizzled 32-column slabs of ``slab`` bytes, zeros past
// ``total`` and d: by the producer warp's TMA boxes (``streams`` a slab,
// lane 0 issues them) or by every lane's element copies.
__device__ __forceinline__ void fill(unsigned char* dst,
                                     const CUtensorMap* map, const float* src,
                                     int copy, uint64_t* bar, int head,
                                     int r0, int nrows, int total, int d,
                                     int slabs, int streams) {
  const int lane = threadIdx.x & 31;
  const int slab = nrows * 128;
  if (copy == kTma) {
    if (lane == 0) {
      const int rows = nrows / streams;
      for (int c = 0; c < slabs; ++c)
        for (int j = 0; j < streams; ++j)
          ring::tma_load_3d(dst + c * slab + j * rows * 128, map, bar, 32 * c,
                            r0 + j * rows, head);
    }
    return;
  }
  const float* base = src + size_t(head) * total * d;
  const int width = slabs * 32;
  for (int e = lane; e < nrows * width; e += 32) {
    const int r = e / width, c = e - r * width, row = r0 + r;
    *reinterpret_cast<float*>(dst + (c >> 5) * slab +
                              ring::sw128_f32(r, c & 31)) =
        (row < total && c < d) ? base[size_t(row) * d + c] : 0.f;
  }
}

// Close a word's fill: every producer lane's two arrivals (ring_pipe.cuh's
// count). The consumers read with ordinary loads, so no proxy fence.
__device__ __forceinline__ void filled(uint64_t* bar) {
  ring::arrive(bar);
  ring::arrive_cp_async(bar);
}

// The producer warp's words: the q tile of head bh at q0 on q_full, then
// the K and V tiles of KV head bh / kv_groups, word kj in stage kj % depth.
__device__ inline void produce(const Args& p, const CUtensorMap* map_q,
                               const CUtensorMap* map_k,
                               const CUtensorMap* map_v, const Ring& rg,
                               int slabs, int bh, int q0, int n_kv) {
  const int lane = threadIdx.x & 31;
  if (lane == 0)
    ring::arrive_expect_tx(rg.q_full, p.q_copy == kTma ? slabs * kQSlab : 0);
  fill(rg.q, map_q, p.q, p.q_copy, rg.q_full, bh, q0, kBlockQ, p.s, p.d,
       slabs, p.streams);
  filled(rg.q_full);
  const int kvh = bh / p.kv_groups;
  for (int kj = 0; kj < n_kv; ++kj) {
    const ring::Slot s(kj, p.depth);
    ring::wait(&rg.empty[s.stage], s.phase ^ 1);
    unsigned char* ks = rg.stages + size_t(s.stage) * rg.stage_bytes;
    uint64_t* bar = &rg.full[s.stage];
    if (lane == 0)
      ring::arrive_expect_tx(bar, p.kv_copy == kTma ? rg.stage_bytes : 0);
    const int kv0 = kj * kBlockKV;
    fill(ks, map_k, p.k, p.kv_copy, bar, kvh, kv0, kBlockKV, p.skv, p.d,
         slabs, p.streams);
    fill(ks + slabs * kKVSlab, map_v, p.v, p.kv_copy, bar, kvh, kv0,
         kBlockKV, p.skv, p.d, slabs, p.streams);
    filled(bar);
  }
}

// The consumer thread's place. Warp w owns q rows 16 w .. 16 w + 15 of the
// tile; lane = 8 k + 4 h + g (quarter warp k) holds score columns c + 8 j
// (c = 2 k + h, j = 0..3), output columns 32 x + 4 c .. 32 x + 4 c + 3 of
// each slab x, and rows 16 w + g + 4 ((i + k) % 4) in its slots i = 0..3.
// Rotating the rows by the quarter warp makes every 16-byte shared load
// one that no two quarters share (4 rows of q or p, 2 chunks of K or V a
// quarter), which costs shared memory 2 cycles where loads that every
// quarter repeats cost 4.
__device__ __forceinline__ int row_of(int t, int i) {
  return 16 * (t >> 5) + (t & 3) + 4 * ((i + ((t & 31) >> 3)) & 3);
}
__device__ __forceinline__ int col_of(int t) { return (t & 31) >> 2; }

__device__ __forceinline__ float4 lds4(const unsigned char* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Byte offset of p's (row r, column col) in the p tile: 128-byte rows,
// chunk col / 4 at col / 4 ^ 2 (r % 4), so that neither the stores of p
// nor its 16-byte loads meet on a bank.
__device__ __forceinline__ uint32_t p_at(int r, int col) {
  return r * 128 + ((((col >> 2) ^ ((r & 3) << 1)) & 7) << 4) +
         ((col & 3) << 2);
}

// A row's reduction over the 8 lanes that hold its 32 columns (lanes
// differing in bits 4, 3, 2), for all four slots at once: warp_sum's
// (common.cuh) butterfly term for term, then warp_max's. The columns of
// a lane's own 4 differ in bits 4 and 3 (j ^ 2, then j ^ 1) and are summed
// in the thread first; then bit 2 of the column (lane ^ 16, whose holder
// keeps the row two slots on), bit 1 (lane ^ 8, one slot on or back), bit
// 0 (lane ^ 4, the same slot). ``odd``: bit 3 of the lane.
template <bool kMax>
__device__ __forceinline__ void reduce_rows(float (&v)[4], bool odd) {
  auto op = [](float a, float b) { return kMax ? fmaxf(a, b) : a + b; };
  float u[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    u[i] = op(v[i], __shfl_xor_sync(0xffffffffu, v[(i + 2) & 3], 16));
#pragma unroll
  for (int i = 0; i < 4; ++i)
    v[i] = op(u[i], __shfl_xor_sync(0xffffffffu,
                                    odd ? u[(i + 3) & 3] : u[(i + 1) & 3],
                                    8));
#pragma unroll
  for (int i = 0; i < 4; ++i)
    v[i] = op(v[i], __shfl_xor_sync(0xffffffffu, v[i], 4));
}

// Sync the consumer warps alone (the producer warp may have left).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
}

// The consumers' attention of the q tile at q0 over n_kv KV tiles: leaves
// o (the unnormalised output, this thread's 4 rows x 4 columns of each
// slab) and the row sums l of its 4 rows. Per tile: S = Q K^T (each score
// one fmaf chain over d in order, then * scale), -1e30 masking, the online
// softmax (max and sum as warp_max / warp_sum give them), p to shared
// memory for the warp, then PV (one fmaf chain over the tile's 32 rows in
// order) into o = fmaf(o, alpha, pv); the stage is released after its PV.
// A warp whose rows precede every column of a tile (causal) skips it.
template <int kSlabs>
__device__ inline void attend(const Args& p, const Ring& rg, int q0,
                              int n_kv, float (&o)[kSlabs][4][4],
                              float (&l)[4]) {
  const int t = threadIdx.x, c = col_of(t);
  const bool odd = (t >> 3) & 1;
  float m[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
  }
#pragma unroll
  for (int x = 0; x < kSlabs; ++x)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[x][i][e] = 0.f;
  ring::wait(rg.q_full, 0);
  for (int kj = 0; kj < n_kv; ++kj) {
    const ring::Slot s(kj, p.depth);
    ring::wait(&rg.full[s.stage], s.phase);
    if (p.causal && kj * kBlockKV > q0 + 16 * (t >> 5) + 15) {
      // every score of the warp's rows is masked: the tile would leave m,
      // l and o as they are (p = 0, alpha = 1), so it is released unread
      __syncwarp();
      if ((t & 31) == 0) ring::arrive(&rg.empty[s.stage]);
      continue;
    }
    const unsigned char* ks = rg.stages + size_t(s.stage) * rg.stage_bytes;
    const unsigned char* vs = ks + kSlabs * kKVSlab;

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 1
    for (int x = 0; x < kSlabs; ++x)
#pragma unroll
      for (int ec = 0; ec < 8; ++ec) {
        float4 qv[4], kv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          qv[i] = lds4(rg.q + x * kQSlab + ring::sw128_f32(row_of(t, i),
                                                           4 * ec));
#pragma unroll
        for (int j = 0; j < 4; ++j)
          kv[j] = lds4(ks + x * kKVSlab + ring::sw128_f32(c + 8 * j, 4 * ec));
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              sc[i][j] = fmaf(mm::lane_of(qv[i], e), mm::lane_of(kv[j], e),
                              sc[i][j]);
      }

    // scale and mask, then the online softmax of the thread's 4 rows
    const int kv0 = kj * kBlockKV;
    float mx[4], sum[4], alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      mx[i] = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = kv0 + c + 8 * j;
        float x = sc[i][j] * p.scale;
        if (col >= p.skv || (p.causal && col > q0 + row_of(t, i)))
          x = kNegInf;
        sc[i][j] = x;
        mx[i] = fmaxf(mx[i], x);
      }
    }
    reduce_rows<true>(mx, odd);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float m_new = fmaxf(m[i], mx[i]);
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = expf(sc[i][j] - m_new);
      sum[i] = (sc[i][0] + sc[i][2]) + (sc[i][1] + sc[i][3]);
      alpha[i] = expf(m[i] - m_new);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<float*>(rg.p + p_at(row_of(t, i), c + 8 * j)) =
            sc[i][j];
    }
    reduce_rows<false>(sum, odd);
#pragma unroll
    for (int i = 0; i < 4; ++i) l[i] = fmaf(l[i], alpha[i], sum[i]);
    __syncwarp();   // the warp's p rows are written: only it reads them

#pragma unroll
    for (int x = 0; x < kSlabs; ++x) {
      float pv[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) pv[i][e] = 0.f;
#pragma unroll 2
      for (int jc = 0; jc < 8; ++jc) {
        float4 pr[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          pr[i] = lds4(rg.p + p_at(row_of(t, i), 4 * jc));
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int j = 4 * jc + jj;
          const float4 vv = lds4(vs + x * kKVSlab + ring::sw128_f32(j, 4 * c));
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float pj = mm::lane_of(pr[i], jj);
#pragma unroll
            for (int e = 0; e < 4; ++e)
              pv[i][e] = fmaf(pj, mm::lane_of(vv, e), pv[i][e]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          o[x][i][e] = fmaf(o[x][i][e], alpha[i], pv[i][e]);
    }
    __syncwarp();   // p and the stage are read before the next writes
    if ((t & 31) == 0) ring::arrive(&rg.empty[s.stage]);
  }
}

// The finished value: o / l, 0 for a row with l == 0.
__device__ __forceinline__ float finish(float o, float l) {
  return o / (l == 0.f ? 1.f : l);
}

}  // namespace f32

// ---------------------------------------------------------------------------
// bf16: the ring pipe feeding wgmma
// ---------------------------------------------------------------------------
namespace wg {

constexpr int kBlockQ = 64;    // = ff_attention/ops.py BLOCK_Q[bfloat16]
constexpr int kBlockKV = 64;   // = ff_attention/ops.py BLOCK_KV[bfloat16]
constexpr int kConsumers = 128;              // one warpgroup
constexpr int kThreads = kConsumers + 32;    // + one producer warp
constexpr int kSlabBytes = 64 * 64 * 2;      // 64 rows x 64 d, swizzled
constexpr int kMaxSmem = 232448;             // 227 KB a block
constexpr int kMaxSlabs = 4;                 // d <= 256

// How the producer fills a tile: TMA boxes, or element loads and stores.
enum Copy { kTma = 0, kElem = 1 };

struct Args {
  const __nv_bfloat16* q;   // [BH, S, D]
  const __nv_bfloat16* k;   // [BKVH, Skv, D]
  const __nv_bfloat16* v;
  const __nv_bfloat16* w;   // attention_proj: [D, D_out]
  __nv_bfloat16* out;
  int s, skv, d, d_out, kv_groups, causal;
  float scale;
  int depth, streams;
  int q_copy, kv_copy, w_copy;
};

// Dynamic shared memory at ``slabs`` 64-column slabs of d and a ring of
// ``depth`` stages: 1024 bytes of alignment slack, the q tile (later the
// projection's A tile), the stages (a K and a V tile each), a full and an
// empty barrier a stage and the q tile's barrier. ops.py _smem_bytes
// computes the same.
__host__ __device__ constexpr size_t smem_bytes(int slabs, int depth) {
  return 1024 + size_t(slabs) * kSlabBytes * (1 + 2 * size_t(depth)) +
         8 * (2 * size_t(depth) + 1);
}

struct Ring {
  unsigned char* q;        // the q tile: slabs of 64 x 64, K-major
  unsigned char* stages;   // stage i at stages + i * stage_bytes
  uint64_t* full;
  uint64_t* empty;
  uint64_t* q_full;
  int stage_bytes;
};

__device__ inline Ring carve(unsigned char* smem_raw, int slabs, int depth) {
  Ring r;
  r.q = smem_raw + ((1024 - (ring::smem_addr(smem_raw) & 1023)) & 1023);
  r.stages = r.q + slabs * kSlabBytes;
  r.stage_bytes = 2 * slabs * kSlabBytes;
  r.full = reinterpret_cast<uint64_t*>(r.stages + size_t(depth) *
                                                      r.stage_bytes);
  r.empty = r.full + depth;
  r.q_full = r.empty + depth;
  return r;
}

// Thread 0 initialises the barriers; then the whole block syncs.
__device__ inline void init(const Ring& r, int depth) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < depth; ++s) {
      ring::init(&r.full[s], ring::kFullArrivals);
      ring::init(&r.empty[s], kConsumers);
    }
    ring::init(r.q_full, ring::kFullArrivals);
    ring::fence_init();
  }
  __syncthreads();
}

// KV tiles a q tile at q0 (``rows`` live rows) reads: tiles past the causal
// diagonal are skipped.
__device__ __forceinline__ int kv_tiles(const Args& p, int q0, int rows) {
  int n = (p.skv + kBlockKV - 1) / kBlockKV;
  if (p.causal) n = min(n, (q0 + rows - 1) / kBlockKV + 1);
  return n;
}

// Rows r0 .. r0+63 of slice ``head`` of a [heads, nrows, d] tensor into
// ``dst`` as swizzled 64-column slabs, zeros past nrows and d: by the
// producer warp's TMA boxes (``streams`` per slab, lane 0 issues them) or
// by every lane's element copies.
__device__ __forceinline__ void fill(unsigned char* dst,
                                     const CUtensorMap* map,
                                     const __nv_bfloat16* src, int copy,
                                     uint64_t* bar, int head, int r0,
                                     int nrows, int d, int slabs,
                                     int streams) {
  const int lane = threadIdx.x & 31;
  if (copy == kTma) {
    if (lane == 0) {
      const int rows = kBlockQ / streams;
      for (int c = 0; c < slabs; ++c)
        for (int j = 0; j < streams; ++j)
          ring::tma_load_3d(dst + c * kSlabBytes + j * rows * 128, map, bar,
                            64 * c, r0 + j * rows, head);
    }
    return;
  }
  const __nv_bfloat16* base = src + size_t(head) * nrows * d;
  const int width = slabs * 64;
  for (int e = lane; e < kBlockQ * width; e += 32) {
    const int r = e / width, c = e - r * width, row = r0 + r;
    *reinterpret_cast<__nv_bfloat16*>(dst + (c >> 6) * kSlabBytes +
                                      ring::sw128(r, c & 63)) =
        (row < nrows && c < d) ? base[size_t(row) * d + c]
                               : __float2bfloat16_rn(0.f);
  }
}

// Close a word's fill: the element copies made visible to the async proxy,
// then every producer lane's two arrivals (ring_pipe.cuh's count).
__device__ __forceinline__ void filled(uint64_t* bar, bool elem) {
  if (elem) ring::fence_async_smem();
  ring::arrive(bar);
  ring::arrive_cp_async(bar);
}

// The producer warp's words of the attention: the q tile of head bh at q0
// on q_full, then the K and V tiles of KV head bh / kv_groups, word kj in
// stage kj % depth.
__device__ inline void produce(const Args& p, const CUtensorMap* map_q,
                               const CUtensorMap* map_k,
                               const CUtensorMap* map_v, const Ring& rg,
                               int slabs, int bh, int q0, int n_kv) {
  const int lane = threadIdx.x & 31;
  if (lane == 0)
    ring::arrive_expect_tx(rg.q_full,
                           p.q_copy == kTma ? slabs * kSlabBytes : 0);
  fill(rg.q, map_q, p.q, p.q_copy, rg.q_full, bh, q0, p.s, p.d, slabs,
       p.streams);
  filled(rg.q_full, p.q_copy == kElem);
  const int kvh = bh / p.kv_groups;
  for (int kj = 0; kj < n_kv; ++kj) {
    const ring::Slot s(kj, p.depth);
    ring::wait(&rg.empty[s.stage], s.phase ^ 1);
    unsigned char* ks = rg.stages + size_t(s.stage) * rg.stage_bytes;
    uint64_t* bar = &rg.full[s.stage];
    if (lane == 0)
      ring::arrive_expect_tx(bar, p.kv_copy == kTma ? rg.stage_bytes : 0);
    const int kv0 = kj * kBlockKV;
    fill(ks, map_k, p.k, p.kv_copy, bar, kvh, kv0, p.skv, p.d, slabs,
         p.streams);
    fill(ks + slabs * kSlabBytes, map_v, p.v, p.kv_copy, bar, kvh, kv0,
         p.skv, p.d, slabs, p.streams);
    filled(bar, p.kv_copy == kElem);
  }
}

// d += A (K-major) @ B^T, B [64 rows, k] K-major: m64n64k16 (S = Q K^T).
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t desc_a,
                                         uint64_t desc_b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// d += A @ B, A from registers (four b32 of two bf16 each, the m64k16
// fragment), B [k, 64 columns] MN-major: m64n64k16 (O += P V).
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// Tie accumulators to this point (after a wgmma wait), so nothing reads
// them earlier.
__device__ __forceinline__ void tie(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Accumulator j of thread t (0..127) of an m64n64 tile: row t/32*16 +
// (t%32)/4 + 8 * half(j), column (j/4)*8 + (t%4)*2 + j%2.
__device__ __forceinline__ int frag_half(int j) { return (j >> 1) & 1; }
__device__ __forceinline__ int frag_row(int t, int j) {
  return (t >> 5) * 16 + ((t & 31) >> 2) + 8 * frag_half(j);
}
__device__ __forceinline__ int frag_col(int t, int j) {
  return (j >> 2) * 8 + (t & 3) * 2 + (j & 1);
}

// Sync the consumer warpgroup alone (the producer warp may have left).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
}

// The consumer warpgroup's attention of the q tile at q0 over n_kv KV
// tiles: leaves o (the unnormalised output, d slab by slab, this thread's
// fragment) and the row sums l of the thread's two rows.
template <int kSlabs>
__device__ inline void attend(const Args& p, const Ring& rg, int q0,
                              int n_kv, float (&o)[kSlabs][32],
                              float (&l)[2]) {
  const int t = threadIdx.x;
  float m[2] = {kNegInf, kNegInf};
  l[0] = l[1] = 0.f;
#pragma unroll
  for (int c = 0; c < kSlabs; ++c)
#pragma unroll
    for (int j = 0; j < 32; ++j) o[c][j] = 0.f;
  ring::wait(rg.q_full, 0);
  if (p.q_copy == kElem) ring::fence_async_smem();
  const uint32_t qa = ring::smem_addr(rg.q);
  for (int kj = 0; kj < n_kv; ++kj) {
    const ring::Slot s(kj, p.depth);
    ring::wait(&rg.full[s.stage], s.phase);
    if (p.kv_copy == kElem) ring::fence_async_smem();
    const uint32_t ka =
        ring::smem_addr(rg.stages + size_t(s.stage) * rg.stage_bytes);
    const uint32_t va = ka + kSlabs * kSlabBytes;
    float sc[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) sc[j] = 0.f;
    mm::wg_fence();
#pragma unroll
    for (int c = 0; c < kSlabs; ++c)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss(sc, mm::wg_desc(qa + c * kSlabBytes + 32 * kk, 16, 1024),
                 mm::wg_desc(ka + c * kSlabBytes + 32 * kk, 16, 1024));
    mm::wg_commit();
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    tie(sc);

    // scale and mask; the row max over the tile (four threads a row)
    const int kv0 = kj * kBlockKV;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int row = q0 + frag_row(t, j), col = kv0 + frag_col(t, j);
      float x = sc[j] * p.scale;
      if (col >= p.skv || (p.causal && col > row)) x = kNegInf;
      sc[j] = x;
      mx[frag_half(j)] = fmaxf(mx[frag_half(j)], x);
    }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      alpha[h] = expf(m[h] - m_new);
      m[h] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      sc[j] = expf(sc[j] - m[frag_half(j)]);
      sum[frag_half(j)] += sc[j];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
      l[h] = fmaf(l[h], alpha[h], sum[h]);
    }
#pragma unroll
    for (int c = 0; c < kSlabs; ++c)
#pragma unroll
      for (int j = 0; j < 32; ++j) o[c][j] *= alpha[frag_half(j)];

    // p rounded to bf16, repacked as the A fragments of the four k16
    // steps (the accumulator's columns 16kk .. 16kk+15)
    uint32_t a[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int x = 0; x < 4; ++x)
        a[kk][x] = pack_bf16(sc[8 * kk + 2 * x], sc[8 * kk + 2 * x + 1]);
    mm::wg_fence();
#pragma unroll
    for (int c = 0; c < kSlabs; ++c)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs(o[c], a[kk],
                 mm::wg_desc(va + c * kSlabBytes + 2048 * kk, kSlabBytes,
                             1024));
    mm::wg_commit();
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
#pragma unroll
    for (int c = 0; c < kSlabs; ++c) tie(o[c]);
    ring::arrive(&rg.empty[s.stage]);
  }
}

// The finished value of accumulator j: o / l, 0 for a row with l == 0.
__device__ __forceinline__ float finish(float o, const float (&l)[2],
                                        int j) {
  const float d = l[frag_half(j)];
  return o / (d == 0.f ? 1.f : d);
}

}  // namespace wg

}  // namespace attn
}  // namespace repro
