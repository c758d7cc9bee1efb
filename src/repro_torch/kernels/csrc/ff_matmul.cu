// Tiled matmul C = A @ B for the H100 (sm_90a), with an optional row index
// on A: the library matmul and the MoE dispatch->expert launch.
//
// Replaces two TPU kernels:
//   * src/repro/kernels/ff_matmul/kernel.py build_program / matmul_ff:
//     C = A @ B, A [m,k] and B [k,n] each f32 or bf16, f32 accumulation,
//     k innermost, out dtype chosen by the caller (A's by default). Its A
//     and B tile streams are producer stages, each a ring pipe of
//     ``depth`` words, with ``streams`` concurrent sub-copies per word;
//   * the dispatch->expert edge of the moe_dispatch_ffn StreamGraph
//     (src/repro/models/moe.py build_moe_graph): the ff_gather producer
//     fused into the expert matmul's A stream, so the dispatched
//     [n_dispatch, d_model] buffer is never written to HBM.
//
// Bound on this card: 2*m*n*k operations over (m*k + k*n + m*n) elements
// moved. A 4096^3 product in bf16 (0.139 ms) and qwen's wi at 1024 rows
// (0.0119 ms) are bound by the tensor cores (989 TFLOP/s); the MoE
// dispatch (64 rows of d_model 2048 into d_ff 1408) by streaming B once
// (3.35 TB/s, 0.0019 ms), with 11 output tiles for 132 SMs. In f32 (no
// TF32) the CUDA cores bound all three (67 TFLOP/s: 2.051, 0.176 and
// 0.0055 ms).
//
// bf16 x bf16 (out bf16 or f32), wgmma_kernel: one block of two consumer
// warpgroups and one producer warp per 128 x 128 output tile. The A and B
// tiles of each 64-deep k slab are one word of a ring_pipe.cuh ring of
// ``depth`` stages (a runtime argument: 32 KB a stage, as many as fit in
// 227 KB); the producer fills a stage with TMA boxes (``streams`` boxes
// per tile, each of rows/streams rows), or, for a gathered A, with
// per-row 16-byte cp.async read through the row index (``streams``
// sub-copies of rows/streams rows issued in turn), or with element loads
// where a row stride is not a multiple of 16 bytes; the consumers run
// wgmma m64n128k16 on the landed stage (ff_matmul.cuh) and release it.
// depth = 1 is the synchronous copy-then-compute baseline; at depth <= 3
// (about 100 KB) two blocks share an SM, so one block's fill and store
// overlap the other's products. Where there
// are fewer output tiles than SMs, k is split over gridDim.z (ops.py
// _plan); each split writes an f32 partial to a workspace and
// reduce_kernel sums them in split order.
//
// f32 x f32 and the mixed f32/bf16 pairs, fma_ring_kernel: two consumer
// warpgroups on a 128 x 128 tile and four producer warps, on the same
// ring, in 32-deep k slabs: a stage is A [128, 32] and B [32, 128],
// each in its own type (32 KB in f32, 24 KB with one bf16 operand), filled
// as above (TMA boxes, per-row cp.async for a gathered A, element loads).
// The consumers run ff_matmul.cuh's fma_slab on the CUDA cores (no TF32):
// 8 x 8 outputs a thread in registers, A read as 16-byte runs along k and
// B as runs along a row, 64 fmaf for every 4 shared loads, so the
// products and not shared memory bound the body. k is never split.
// depth = 1 is the synchronous baseline here too; one block fills an SM.
//
// The only difference between a gathered and a plain launch is how the
// producer finds row r of A: m0 + r, or rows[m0 + r], read once into
// shared memory. A gathered row is an exact copy and the reduction order
// is the same (ff_matmul.cuh), so the gathered launch equals ff_gather
// followed by the plain launch bit for bit. The TPU wrapper padded m, n
// and k to its 128 blocks in HBM; here the ragged edges are masked (TMA's
// out-of-range fill, zero-filled cp.async, masked stores).

#include "ff_matmul.cuh"

namespace {

namespace mm = repro::mm;
namespace ring = repro::ring;

// Both bodies: one block of two consumer warpgroups and one producer warp
// per 128 x 128 output tile.
constexpr int kConsumers = 2;                       // warpgroups
constexpr int kTileM = kConsumers * mm::kWgM;       // 128
constexpr int kTileN = mm::kWgN;                    // 128
constexpr int kWgThreads = kConsumers * 128 + 32;   // + one producer warp
constexpr int kMaxSmem = 232448;                    // 227 KB a block

// How the producer fills a tile: TMA boxes, 16-byte cp.async per row
// (gathered rows), or element loads and stores.
enum Copy { kTma = 0, kAsync = 1, kElem = 2 };

// ---------------------------------------------------------------------------
// f32 and mixed pairs: the ring pipe feeding the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kFmaSlabK = 32;                       // k per slab
// producer warps: their lanes split a gathered tile's per-row copies
// (one warp's cp.async alone held the MoE dispatch to a third of its
// plain launch's rate)
constexpr int kFmaProducers = 4;
constexpr int kFmaThreads = kConsumers * 128 + 32 * kFmaProducers;
constexpr int kFmaFullArrivals = 1 + 2 * 32 * kFmaProducers;

// A stage: the A tile [128, 32] in A's type, then the B tile [32, 128] in
// B's. An f32 A tile is 128-byte swizzled (its rows are 128 bytes): a
// warp's two rows at one k chunk then fall on different banks. A bf16 A
// tile (64-byte rows) and both B tiles lie row-major: a half warp reads
// one run of a B row, which no swizzle would help.
template <typename TA, typename TB>
struct FmaStage {
  static constexpr int kA = kTileM * kFmaSlabK * int(sizeof(TA));
  static constexpr int kBytes = kA + kFmaSlabK * kTileN * int(sizeof(TB));
};

template <typename TA>
__device__ __forceinline__ uint32_t a_at(int r, int c) {
  if constexpr (sizeof(TA) == 4) {
    return ring::sw128_f32(r, c);
  } else {
    return r * kFmaSlabK * 2 + c * 2;
  }
}
template <typename TB>
__device__ __forceinline__ uint32_t b_at(int r, int c) {
  return (r * kTileN + c) * uint32_t(sizeof(TB));
}

// Dynamic shared memory of a ring of ``depth`` stages of ``stage`` bytes:
// 1024 bytes of alignment slack, the stages, full and empty barriers, the
// tile's row offsets. kernels/ff_matmul/ops.py _smem_bytes computes the
// same.
constexpr size_t fma_smem_bytes(int depth, int stage) {
  return 1024 + size_t(depth) * stage + 2 * 8 * size_t(depth) + 8 * kTileM;
}

struct FmaArgs {
  const void* a;
  const int32_t* rows;   // null: row r of the tile is m0 + r
  const void* b;
  void* c;
  int m, n, k;
  long long lda, ldb, ldc;
  int depth, streams;
  int a_copy, b_copy;
};

// The producer warp: word i is k slab i of the tile, in stage i % depth.
// A by TMA boxes (``streams`` a tile, each of 128 / streams rows), by
// per-row 16-byte cp.async through the row index, or by element loads; B
// by TMA boxes (``streams`` of 32 / streams k rows) or element loads. The
// per-row copies fill only the ``live`` rows the consumers keep (the
// tile's, below m): the rest of the A tile is never stored from.
template <typename TA, typename TB>
__device__ __forceinline__ void produce_fma(const FmaArgs& p,
                                            const CUtensorMap* map_a,
                                            const CUtensorMap* map_b,
                                            unsigned char* stages,
                                            uint64_t* full, uint64_t* empty,
                                            const long long* row_off, int m0,
                                            int n0, int words, int live) {
  using St = FmaStage<TA, TB>;
  constexpr int kChunk = 16 / int(sizeof(TA));     // A elements a cp.async
  constexpr int kRowChunks = kFmaSlabK / kChunk;
  // this thread's place among the producer warps' lanes
  const int pl = threadIdx.x - kConsumers * 128;
  const int a_rows = kTileM / p.streams, b_rows = kFmaSlabK / p.streams;
  const TA* a = static_cast<const TA*>(p.a);
  const TB* b = static_cast<const TB*>(p.b);
  for (int i = 0; i < words; ++i) {
    const ring::Slot s(i, p.depth);
    ring::wait(&empty[s.stage], s.phase ^ 1);
    unsigned char* sa = stages + size_t(s.stage) * St::kBytes;
    unsigned char* sb = sa + St::kA;
    uint64_t* bar = &full[s.stage];
    const int k0 = i * kFmaSlabK;
    if (pl == 0) {
      ring::arrive_expect_tx(bar, (p.a_copy == kTma ? St::kA : 0) +
                                      (p.b_copy == kTma ? St::kBytes - St::kA
                                                        : 0));
      if (p.a_copy == kTma)
        for (int j = 0; j < p.streams; ++j)
          ring::tma_load_2d(sa + j * a_rows * kFmaSlabK * sizeof(TA), map_a,
                            bar, k0, m0 + j * a_rows);
      if (p.b_copy == kTma)
        for (int j = 0; j < p.streams; ++j)
          ring::tma_load_2d(sb + b_at<TB>(j * b_rows, 0), map_b, bar, n0,
                            k0 + j * b_rows);
    }
    if (p.a_copy == kAsync) {
      for (int j = 0; j < p.streams; ++j)
        for (int e = pl; e < a_rows * kRowChunks; e += 32 * kFmaProducers) {
          const int r = j * a_rows + e / kRowChunks;
          if (r >= live) continue;
          const int c = (e % kRowChunks) * kChunk;
          const long long off = row_off[r];
          const int bytes = max(0, min(16, int(sizeof(TA)) * (p.k - (k0 + c))));
          ring::cp_async_16(sa + a_at<TA>(r, c), bytes ? a + off + k0 + c : a,
                            bytes);
        }
    } else if (p.a_copy == kElem) {
      for (int e = pl; e < live * kFmaSlabK; e += 32 * kFmaProducers) {
        const int r = e / kFmaSlabK, c = e % kFmaSlabK;
        *reinterpret_cast<TA*>(sa + a_at<TA>(r, c)) =
            k0 + c < p.k ? a[row_off[r] + k0 + c] : repro::from_f<TA>(0.f);
      }
    }
    if (p.b_copy == kElem) {
      for (int e = pl; e < kFmaSlabK * kTileN; e += 32 * kFmaProducers) {
        const int r = e / kTileN, c = e % kTileN;
        const bool ok = k0 + r < p.k && n0 + c < p.n;
        *reinterpret_cast<TB*>(sb + b_at<TB>(r, c)) =
            ok ? b[(long long)(k0 + r) * p.ldb + n0 + c]
               : repro::from_f<TB>(0.f);
      }
    }
    ring::arrive(bar);
    ring::arrive_cp_async(bar);
  }
}

// The consumers: thread t of the two warpgroups owns rows tm + 16 i (tm =
// 2 * warp + lane / 16) and the kC columns of mm::fma_slab (tn = lane %
// 16) of a 16 kR x 16 kC output tile at (m0, n0); each slab is released
// once its products are done. The producer fills the stage's A [128, 32]
// from m0 and B [32, 128] from n0 whatever the tile (zeros past the
// edges), so a 64 x 64 tile uses part of each. A warp releases a stage
// with one arrival (256 arrivals a slab cost more than a 64 x 64 tile's
// products).
template <typename TA, typename TB, typename TO, int kR, int kC>
__global__ void __launch_bounds__(kFmaThreads, 1)
    fma_ring_kernel(const __grid_constant__ CUtensorMap map_a,
                    const __grid_constant__ CUtensorMap map_b,
                    const FmaArgs p) {
  using St = FmaStage<TA, TB>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* stages =
      smem_raw + ((1024 - (ring::smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(stages + size_t(p.depth) * St::kBytes);
  uint64_t* empty = full + p.depth;
  long long* row_off = reinterpret_cast<long long*>(empty + p.depth);
  const int m0 = blockIdx.y * 16 * kR, n0 = blockIdx.x * 16 * kC;
  const int words = (p.k + kFmaSlabK - 1) / kFmaSlabK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < p.depth; ++s) {
      ring::init(&full[s], kFmaFullArrivals);
      ring::init(&empty[s], kConsumers * 4);   // one arrival a warp
    }
    ring::fence_init();
  }
  for (int r = threadIdx.x; r < kTileM; r += kFmaThreads) {
    const int row = m0 + r;
    row_off[r] = row < p.m ? (p.rows ? (long long)p.rows[row] : row) * p.lda
                           : -1;
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  if (warp >= kConsumers * 4) {
    produce_fma<TA, TB>(p, &map_a, &map_b, stages, full, empty, row_off, m0,
                        n0, words, min(16 * kR, p.m - m0));
    return;
  }
  const int tm = 2 * warp + (lane >> 4), tn = lane & 15;
  float acc[kR][kC];
#pragma unroll
  for (int i = 0; i < kR; ++i)
#pragma unroll
    for (int j = 0; j < kC; ++j) acc[i][j] = 0.f;
  for (int i = 0; i < words; ++i) {
    const ring::Slot s(i, p.depth);
    ring::wait(&full[s.stage], s.phase);
    const unsigned char* sa = stages + size_t(s.stage) * St::kBytes;
    const unsigned char* sb = sa + St::kA;
    mm::fma_slab<kFmaSlabK / 4, kR, kC>(
        acc,
        [&](int r, int kc) {
          return mm::lds4(reinterpret_cast<const TA*>(
              sa + a_at<TA>(tm + 16 * r, 4 * kc)));
        },
        [&](int kk, float (&bv)[kC]) {
          const TB* row = reinterpret_cast<const TB*>(sb + b_at<TB>(kk, 0));
#pragma unroll
          for (int h = 0; h < kC / 4; ++h) {
            const float4 x = mm::lds4(row + 64 * h + 4 * tn);
            bv[4 * h] = x.x;
            bv[4 * h + 1] = x.y;
            bv[4 * h + 2] = x.z;
            bv[4 * h + 3] = x.w;
          }
        });
    __syncwarp();   // the warp's reads of the stage are done
    if (lane == 0) ring::arrive(&empty[s.stage]);
  }
  TO* c = static_cast<TO*>(p.c);
  TO* rows_out[kR];
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int row = m0 + tm + 16 * i;
    rows_out[i] = row < p.m ? c + (long long)row * p.ldc : nullptr;
  }
  const bool vec = p.ldc % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(c) % (4 * sizeof(TO)) == 0;
  mm::store_fma<TO, kR, kC>(acc, rows_out, tn, n0, p.n, vec);
}

template <typename TA, typename TB, typename TO, int kR, int kC>
int launch_fma_tile(const CUtensorMap& map_a, const CUtensorMap& map_b,
                    const FmaArgs& p, size_t smem, cudaStream_t stream) {
  static const cudaError_t opted = cudaFuncSetAttribute(
      fma_ring_kernel<TA, TB, TO, kR, kC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (opted != cudaSuccess) return opted;
  dim3 grid((p.n + 16 * kC - 1) / (16 * kC), (p.m + 16 * kR - 1) / (16 * kR));
  fma_ring_kernel<TA, TB, TO, kR, kC><<<grid, kFmaThreads, smem, stream>>>(
      map_a, map_b, p);
  return cudaGetLastError();
}

// ``tile``: 128 (8 x 8 outputs a thread) or 64 (4 x 4), ops.py _plan's
// choice from the shapes and the SM count.
template <typename TA, typename TB, typename TO>
int launch_fma(const void* a, const void* rows, const void* b, void* c, int m,
               int n, int k, long long lda, long long ldb, long long ldc,
               int depth, int streams, int tile, void* stream) {
  if (m == 0 || n == 0) return 0;
  using St = FmaStage<TA, TB>;
  const size_t smem = fma_smem_bytes(depth, St::kBytes);
  if (depth < 1 || smem > kMaxSmem || streams < 1 || kTileM % streams ||
      kTileM / streams < 8 || kFmaSlabK % streams ||
      (tile != 128 && tile != 64))
    return cudaErrorInvalidValue;
  FmaArgs p{a, static_cast<const int32_t*>(rows), b, c, m, n, k, lda, ldb,
            ldc, depth, streams, kElem, kElem};
  CUtensorMap map_a{}, map_b{};
  if (k > 0) {
    if (ring::tma_ok_bytes(a, lda, sizeof(TA)))
      p.a_copy = rows ? kAsync
                      : (ring::encode_typed(&map_a, sizeof(TA), a, k, m, lda,
                                            kFmaSlabK, kTileM / streams,
                                            sizeof(TA) == 4)
                             ? kTma : -1);
    if (ring::tma_ok_bytes(b, ldb, sizeof(TB)))
      p.b_copy = ring::encode_typed(&map_b, sizeof(TB), b, n, k, ldb, kTileN,
                                    kFmaSlabK / streams, false)
                     ? kTma : -1;
    if (p.a_copy < 0 || p.b_copy < 0) return cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  return tile == 128
             ? launch_fma_tile<TA, TB, TO, 8, 8>(map_a, map_b, p, smem, st)
             : launch_fma_tile<TA, TB, TO, 4, 4>(map_a, map_b, p, smem, st);
}

// ---------------------------------------------------------------------------
// bf16 x bf16: the ring pipe feeding wgmma
// ---------------------------------------------------------------------------

constexpr int kSlabK = mm::kWgK;                    // 64
constexpr int kATile = kTileM * kSlabK * 2;         // 16 KB
constexpr int kStage = kATile + mm::kBSlab;         // 32 KB

// Dynamic shared memory of a ring of ``depth`` stages: the stages (1024-
// byte aligned, hence the slack), full and empty barriers, row offsets.
// kernels/ff_matmul/ops.py _smem_bytes computes the same.
constexpr size_t smem_bytes(int depth) {
  return 1024 + size_t(depth) * kStage + 2 * 8 * size_t(depth) +
         8 * kTileM;
}

struct Args {
  const __nv_bfloat16* a;
  const int32_t* rows;   // null: row r of the tile is m0 + r
  const __nv_bfloat16* b;
  void* c;
  float* ws;             // split > 1: [split, m, n] f32 partials
  int m, n, k;
  long long lda, ldb, ldc;
  int depth, streams, split;
  int a_copy, b_copy;
};

__device__ __forceinline__ void produce(const Args& p,
                                        const CUtensorMap* map_a,
                                        const CUtensorMap* map_b,
                                        unsigned char* stages,
                                        uint64_t* full, uint64_t* empty,
                                        const long long* row_off, int m0,
                                        int n0, int g0, int words) {
  const int lane = threadIdx.x & 31;
  const int a_rows = kTileM / p.streams, b_rows = kSlabK / p.streams;
  for (int i = 0; i < words; ++i) {
    const ring::Slot s(i, p.depth);
    ring::wait(&empty[s.stage], s.phase ^ 1);
    unsigned char* sa = stages + size_t(s.stage) * kStage;
    unsigned char* sb = sa + kATile;
    uint64_t* bar = &full[s.stage];
    const int k0 = (g0 + i) * kSlabK;
    if (lane == 0) {
      ring::arrive_expect_tx(bar, (p.a_copy == kTma ? kATile : 0) +
                                      (p.b_copy == kTma ? mm::kBSlab : 0));
      if (p.a_copy == kTma)
        for (int j = 0; j < p.streams; ++j)
          ring::tma_load_2d(sa + j * a_rows * 128, map_a, bar, k0,
                            m0 + j * a_rows);
      if (p.b_copy == kTma)
        for (int h = 0; h < 2; ++h)
          for (int j = 0; j < p.streams; ++j)
            ring::tma_load_2d(sb + h * mm::kBHalf + j * b_rows * 128, map_b,
                              bar, n0 + 64 * h, k0 + j * b_rows);
    }
    if (p.a_copy == kAsync) {
      // one 16-byte chunk (8 k) of one row per lane at a time
      for (int j = 0; j < p.streams; ++j)
        for (int e = lane; e < a_rows * 8; e += 32) {
          const int r = j * a_rows + e / 8, c = (e % 8) * 8;
          const long long off = row_off[r];
          const int bytes =
              off < 0 ? 0 : max(0, min(16, 2 * (p.k - (k0 + c))));
          ring::cp_async_16(sa + ring::sw128(r, c),
                            bytes ? p.a + off + k0 + c : p.a, bytes);
        }
    } else if (p.a_copy == kElem) {
      for (int e = lane; e < kTileM * kSlabK; e += 32) {
        const int r = e / kSlabK, c = e % kSlabK;
        const long long off = row_off[r];
        *reinterpret_cast<__nv_bfloat16*>(sa + ring::sw128(r, c)) =
            (off >= 0 && k0 + c < p.k) ? p.a[off + k0 + c]
                                       : __float2bfloat16_rn(0.f);
      }
    }
    if (p.b_copy == kElem) {
      for (int e = lane; e < kSlabK * kTileN; e += 32) {
        const int r = e / kTileN, c = e % kTileN;
        const bool ok = k0 + r < p.k && n0 + c < p.n;
        *reinterpret_cast<__nv_bfloat16*>(sb + (c >> 6) * mm::kBHalf +
                                          ring::sw128(r, c & 63)) =
            ok ? p.b[(long long)(k0 + r) * p.ldb + n0 + c]
               : __float2bfloat16_rn(0.f);
      }
    }
    if (p.a_copy == kElem || p.b_copy == kElem) ring::fence_async_smem();
    ring::arrive(bar);
    ring::arrive_cp_async(bar);
  }
}

template <typename TO>
__global__ void __launch_bounds__(kWgThreads, 1)
    wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                 const __grid_constant__ CUtensorMap map_b, const Args p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* stages =
      smem_raw + ((1024 - (ring::smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(stages + size_t(p.depth) *
                                                            kStage);
  uint64_t* empty = full + p.depth;
  long long* row_off = reinterpret_cast<long long*>(empty + p.depth);
  const int m0 = blockIdx.y * kTileM, n0 = blockIdx.x * kTileN;
  const int slabs = (p.k + kSlabK - 1) / kSlabK;
  const int g0 = int((long long)blockIdx.z * slabs / p.split);
  const int words = int((long long)(blockIdx.z + 1) * slabs / p.split) - g0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < p.depth; ++s) {
      ring::init(&full[s], ring::kFullArrivals);
      ring::init(&empty[s], kConsumers * 128);
    }
    ring::fence_init();
  }
  for (int r = threadIdx.x; r < kTileM; r += kWgThreads) {
    const int row = m0 + r;
    row_off[r] = row < p.m ? (p.rows ? (long long)p.rows[row] : row) * p.lda
                           : -1;
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  if (warp == kConsumers * 4) {
    produce(p, &map_a, &map_b, stages, full, empty, row_off, m0, n0, g0,
            words);
    return;
  }
  // warpgroup wg owns rows [row0, row0 + 64) of the tile
  const int wg = warp / 4;
  const int row0 = m0 + wg * mm::kWgM;
  const bool live = row0 < p.m;
  const bool fence = p.a_copy != kTma || p.b_copy != kTma;
  float acc[mm::kWgAcc];
#pragma unroll
  for (int i = 0; i < mm::kWgAcc; ++i) acc[i] = 0.f;
  for (int i = 0; i < words; ++i) {
    const ring::Slot s(i, p.depth);
    ring::wait(&full[s.stage], s.phase);
    if (fence) ring::fence_async_smem();   // cp.async / st.shared landed
    if (live) {
      const unsigned char* sa = stages + size_t(s.stage) * kStage;
      mm::wg_fence();
      mm::mma_slab(acc, ring::smem_addr(sa + wg * mm::kASlab),
                   ring::smem_addr(sa + kATile));
      mm::wg_commit();
    }
    if (p.depth == 1 || !live) {
      if (live) mm::wg_wait<0>(acc);
      ring::arrive(&empty[s.stage]);
    } else {
      // keep one slab's products in flight; release the slab before it
      mm::wg_wait<1>(acc);
      if (i > 0) ring::arrive(&empty[(i - 1) % p.depth]);
    }
  }
  if (!live) return;
  mm::wg_wait<0>(acc);
  const int rows = p.m - row0, cols = p.n - n0;
  if (p.split == 1)
    mm::store_frag(acc, static_cast<TO*>(p.c) + (long long)row0 * p.ldc + n0,
                   p.ldc, rows, cols);
  else
    mm::store_frag(acc,
                   p.ws + ((long long)blockIdx.z * p.m + row0) * p.n + n0,
                   (long long)p.n, rows, cols);
}

// c = sum over splits of ws[split], in split order 0, 1, 2, ...
template <typename TO>
__global__ void reduce_kernel(const float* __restrict__ ws,
                              TO* __restrict__ c, int m, int n, long long ldc,
                              int split) {
  const long long total = (long long)m * n;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       e < total; e += (long long)gridDim.x * blockDim.x) {
    float s = ws[e];
    for (int z = 1; z < split; ++z) s += ws[z * total + e];
    c[(e / n) * ldc + e % n] = repro::from_f<TO>(s);
  }
}

template <typename TO>
int launch_wgmma(const void* a, const void* rows, const void* b, void* c,
                 void* ws, int m, int n, int k, long long lda, long long ldb,
                 long long ldc, int depth, int streams, int split,
                 void* stream) {
  if (m == 0 || n == 0) return 0;
  const size_t smem = smem_bytes(depth);
  if (depth < 1 || smem > kMaxSmem || streams < 1 || kSlabK % streams ||
      kSlabK / streams < 8 || split < 1 || (split > 1 && !ws))
    return cudaErrorInvalidValue;
  Args p{static_cast<const __nv_bfloat16*>(a),
         static_cast<const int32_t*>(rows),
         static_cast<const __nv_bfloat16*>(b), c, static_cast<float*>(ws),
         m, n, k, lda, ldb, ldc, depth, streams, split, kElem, kElem};
  CUtensorMap map_a{}, map_b{};
  if (k > 0) {
    if (ring::tma_ok(a, lda))
      p.a_copy = rows ? kAsync
                      : (ring::encode(&map_a, a, k, m, lda, kTileM / streams)
                             ? kTma : -1);
    if (ring::tma_ok(b, ldb))
      p.b_copy = ring::encode(&map_b, b, n, k, ldb, kSlabK / streams)
                     ? kTma : -1;
    if (p.a_copy < 0 || p.b_copy < 0) return cudaErrorInvalidValue;
  }
  static const cudaError_t opted = cudaFuncSetAttribute(
      wgmma_kernel<TO>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxSmem);
  if (opted != cudaSuccess) return opted;
  dim3 grid((n + kTileN - 1) / kTileN, (m + kTileM - 1) / kTileM, split);
  wgmma_kernel<TO><<<grid, kWgThreads, smem, (cudaStream_t)stream>>>(
      map_a, map_b, p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || split == 1) return err;
  const long long total = (long long)m * n;
  const int blocks = int((total + 255) / 256 < 132 * 8 ? (total + 255) / 256
                                                       : 132 * 8);
  reduce_kernel<TO><<<blocks, 256, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(ws), static_cast<TO*>(c), m, n, ldc, split);
  return cudaGetLastError();
}

}  // namespace

// ff_matmul_fma_<A>_<B>_<out>: c[m,n] = a[m,k] @ b[k,n] on the CUDA cores
// through the ring, for every type pair but bf16 x bf16, gathered where
// ``rows`` is not null, in output tiles of ``tile`` x ``tile`` (128 or 64).
// ff_matmul_wgmma_<out>: bf16 x bf16 on the tensor
// cores through the ring, gathered where ``rows`` is not null, k split
// ``split`` ways (``ws``: [split, m, n] f32 when split > 1). Both take the
// ring's depth and streams. Operands have unit column stride and the
// given row strides.
#define REPRO_MATMUL_FMA_ENTRY(SA, TA, SB, TB, SO, TO)                        \
  extern "C" int ff_matmul_fma_##SA##_##SB##_##SO(                            \
      const void* a, const void* rows, const void* b, void* c, int m, int n,  \
      int k, long long lda, long long ldb, long long ldc, int depth,          \
      int streams, int tile, void* stream) {                                  \
    return launch_fma<TA, TB, TO>(a, rows, b, c, m, n, k, lda, ldb, ldc,      \
                                  depth, streams, tile, stream);              \
  }

#define REPRO_MATMUL_FMA_OUTS(SA, TA, SB, TB)                \
  REPRO_MATMUL_FMA_ENTRY(SA, TA, SB, TB, f32, float)         \
  REPRO_MATMUL_FMA_ENTRY(SA, TA, SB, TB, bf16, __nv_bfloat16)

REPRO_MATMUL_FMA_OUTS(f32, float, f32, float)
REPRO_MATMUL_FMA_OUTS(f32, float, bf16, __nv_bfloat16)
REPRO_MATMUL_FMA_OUTS(bf16, __nv_bfloat16, f32, float)

#define REPRO_MATMUL_WGMMA_ENTRY(SO, TO)                                     \
  extern "C" int ff_matmul_wgmma_##SO(                                        \
      const void* a, const void* rows, const void* b, void* c, void* ws,      \
      int m, int n, int k, long long lda, long long ldb, long long ldc,       \
      int depth, int streams, int split, void* stream) {                      \
    return launch_wgmma<TO>(a, rows, b, c, ws, m, n, k, lda, ldb, ldc, depth, \
                            streams, split, stream);                          \
  }

REPRO_MATMUL_WGMMA_ENTRY(f32, float)
REPRO_MATMUL_WGMMA_ENTRY(bf16, __nv_bfloat16)
