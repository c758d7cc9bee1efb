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
// (3.35 TB/s, 0.0019 ms), with 11 output tiles for 132 SMs.
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
// f32 x f32 and the mixed f32/bf16 pairs, fma_kernel: one block of 256
// threads per 64 x 64 output tile, the CUDA-core body of ff_matmul.cuh
// (no TF32; a register stage of prefetch; depth and streams do not apply).
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

// ---------------------------------------------------------------------------
// f32 and mixed pairs: the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kBM = 64, kBN = 64, kThreads = 256;

template <typename TA, typename TB, typename TO, bool Gather>
__global__ void __launch_bounds__(kThreads)
    fma_kernel(const TA* __restrict__ a, const TB* __restrict__ b,
               const int32_t* __restrict__ rows, TO* __restrict__ c, int m,
               int n, int k, long long lda, long long ldb, long long ldc) {
  __shared__ mm::Slab<kBM, kBN> slab;
  __shared__ long long row_off[kBM];
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int live = min(kBM, m - m0);
  for (int r = threadIdx.x; r < kBM; r += kThreads) {
    long long row = 0;
    if (r < live) row = Gather ? (long long)rows[m0 + r] : (long long)m0 + r;
    row_off[r] = row * lda;
  }
  __syncthreads();
  auto load_a = [&](int r, int kk) -> float {
    return (r < live && kk < k) ? repro::to_f(a[row_off[r] + kk]) : 0.f;
  };
  float acc[mm::kTM][mm::kTN];
  mm::product_tile<kBM, kBN, kThreads>(acc, slab, load_a, b, ldb, k, n0, n);
  mm::store_tile<kBM, kBN, kThreads>(acc, c + (long long)m0 * ldc, ldc, live,
                                     n0, n);
}

template <typename TA, typename TB, typename TO, bool Gather>
int launch_fma(const void* a, const void* b, const void* rows, void* c, int m,
               int n, int k, long long lda, long long ldb, long long ldc,
               void* stream) {
  if (m == 0 || n == 0) return 0;
  dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  fma_kernel<TA, TB, TO, Gather><<<grid, kThreads, 0,
                                   (cudaStream_t)stream>>>(
      static_cast<const TA*>(a), static_cast<const TB*>(b),
      static_cast<const int32_t*>(rows), static_cast<TO*>(c), m, n, k, lda,
      ldb, ldc);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 x bf16: the ring pipe feeding wgmma
// ---------------------------------------------------------------------------

constexpr int kConsumers = 2;                       // warpgroups
constexpr int kTileN = mm::kWgN;                    // 128
constexpr int kSlabK = mm::kWgK;                    // 64
constexpr int kWgThreads = kConsumers * 128 + 32;   // + one producer warp
constexpr int kMaxSmem = 232448;                    // 227 KB a block
constexpr int kTileM = kConsumers * mm::kWgM;       // 128
constexpr int kATile = kTileM * kSlabK * 2;         // 16 KB
constexpr int kStage = kATile + mm::kBSlab;         // 32 KB

// Dynamic shared memory of a ring of ``depth`` stages: the stages (1024-
// byte aligned, hence the slack), full and empty barriers, row offsets.
// kernels/ff_matmul/ops.py _smem_bytes computes the same.
constexpr size_t smem_bytes(int depth) {
  return 1024 + size_t(depth) * kStage + 2 * 8 * size_t(depth) +
         8 * kTileM;
}

// How the producer fills a tile: TMA boxes, 16-byte cp.async per row
// (gathered rows), or element loads and stores.
enum Copy { kTma = 0, kAsync = 1, kElem = 2 };

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

// ff_matmul_<A>_<B>_<out>: c[m,n] = a[m,k] @ b[k,n] on the CUDA cores, for
// every type pair but bf16 x bf16; ff_matmul_gather_f32: c[m,n] =
// a[rows[0:m], :] @ b[k,n], all f32. ff_matmul_wgmma_<out>: bf16 x bf16
// on the tensor cores through the ring, gathered where ``rows`` is not
// null, k split ``split`` ways (``ws``: [split, m, n] f32 when split > 1).
// Operands have unit column stride and the given row strides.
#define REPRO_MATMUL_ENTRY(SA, TA, SB, TB, SO, TO)                           \
  extern "C" int ff_matmul_##SA##_##SB##_##SO(                                \
      const void* a, const void* b, void* c, int m, int n, int k,             \
      long long lda, long long ldb, long long ldc, void* stream) {            \
    return launch_fma<TA, TB, TO, false>(a, b, nullptr, c, m, n, k, lda, ldb, \
                                         ldc, stream);                        \
  }

#define REPRO_MATMUL_OUTS(SA, TA, SB, TB)                \
  REPRO_MATMUL_ENTRY(SA, TA, SB, TB, f32, float)         \
  REPRO_MATMUL_ENTRY(SA, TA, SB, TB, bf16, __nv_bfloat16)

REPRO_MATMUL_OUTS(f32, float, f32, float)
REPRO_MATMUL_OUTS(f32, float, bf16, __nv_bfloat16)
REPRO_MATMUL_OUTS(bf16, __nv_bfloat16, f32, float)

extern "C" int ff_matmul_gather_f32(const void* a, const void* rows,
                                    const void* b, void* c, int m, int n,
                                    int k, long long lda, long long ldb,
                                    long long ldc, void* stream) {
  return launch_fma<float, float, float, true>(a, b, rows, c, m, n, k, lda,
                                               ldb, ldc, stream);
}

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
