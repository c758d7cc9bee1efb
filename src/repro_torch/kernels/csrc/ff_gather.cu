// Row gather out[i, :] = table[idx[i], :] for the H100 (sm_90a), on the
// ring pipe.
//
// Replaces the TPU kernel src/repro/kernels/ff_gather/kernel.py
// (build_program / gather_ff): the index stream scalar-prefetched, each
// pipe word a bundle of 8 * streams single-row DMAs issued through
// core/emitter.py GatherRingPipe ``depth - 1`` words ahead, so the ring
// keeps (depth - 1) * rows irregular reads in flight: the paper's
// irregular-access case. It serves embedding-style lookups, the MoE
// dispatch and combine, and the staged paged-decode baseline.
//
// Bound on this card: no arithmetic. Every distinct indexed row is read
// once, every output row written once and the index read once, so the
// least time is those bytes over 3.35 TB/s.
//
// Design: the reference's words, on Hopper's ring (ring_pipe.cuh).
//   * Words. A word is R = 8 * streams output rows (the reference's
//     _ROWS * streams) over a slab of the row: the whole row where
//     ``depth`` stages of R rows fit in 227 KB of shared memory, else the
//     row cut into the fewest equal slabs of 16-byte multiples that fit
//     (ops.py _plan; a depth at which not even a 2 KB slab fits raises).
//     Rows shorter than 2 KB take a multiple of R a word, enough to spread
//     the rows over the SMs in one word a block, up to the 16 KB stage
//     that 8 rows of 2 KB make: a stage pays one ring round trip however
//     few bytes it holds. The last bundle is ragged and masked, not
//     padded: its missing rows are neither read nor written.
//   * A persistent grid. One block an SM (at most one a word), each
//     walking words g = blockIdx.x + i * gridDim.x through its own ring
//     of ``depth`` stages (Slot(i, depth)). Without the walk a block would
//     get one word and ``depth`` could not act; with one block an SM the
//     ring is its SM's only memory-level parallelism, as the pipe is in
//     the paper (more blocks an SM would hide latency by occupancy
//     instead).
//   * Eight producer warps share each word's rows (warp j takes passes
//     j, j + 8, ... of them: one 2 KB row each at 8 rows a word). Each
//     loads the next word's indices into its lanes' registers while it
//     waits for this word's stage (the reference's scalar prefetch; the
//     first 64 rows of a word, later rows read theirs at the copy). For
//     each word a producer waits on empty[s], issues its rows as 16-byte
//     cp.async, lanes along a row (several short rows a pass), and
//     arrives on full[s] through cp.async.mbarrier.arrive once they
//     land. One warp's cp.async issue cannot fill the ring, whatever the
//     depth, as in ff_layer.cu; eight take a block to what the card's
//     memory gives this pattern. A row whose byte length or base
//     pointers are not multiples of 16 bytes takes the ring's third kind
//     of copy: element loads and shared-memory stores in the
//     largest unit of 8, 4 or 2 bytes that divides them, then a plain
//     arrive. The consumers read stages with ordinary loads, never
//     through the async proxy, so neither path needs a proxy fence.
//   * Four consumer warps wait on full[s], write the stage's rows to
//     ``out`` by the same lane mapping in 16-byte (or unit) stores, and
//     arrive on empty[s]. Stages are laid out here (rows padded to 16
//     bytes), not in the 128-byte swizzle that wgmma reads: a copy does
//     not use it.
// At depth 1 the producers cannot fetch word i+1 before word i is
// released: the synchronous copy-then-write baseline. The copy is an exact
// bit copy at every depth, streams and grid.
//
// What depth can and cannot hide here: it keeps up to depth - 1 words of
// row reads in flight while the consumers write the oldest, so it hides
// the device-memory latency of an irregular read (about a microsecond
// under load) as long as (depth - 1) * stage bytes per SM cover that
// latency times the SM's share of 3.35 TB/s (some 25 GB/s, so 25-50 KB:
// depth 3-4 at 16 KB stages). It cannot hide the launch's fixed cost, a
// grid with fewer words than SMs (each block then walks one word and has
// nothing to overlap), or the bytes themselves.
//
// Indices must lie in [0, rows of the table): the kernel does not check
// them (a device-side check would cost a host sync per call).

#include "ring_pipe.cuh"

namespace {

namespace ring = repro::ring;

constexpr int kWarps = 4;                      // consumer warps
constexpr int kConsumers = 32 * kWarps;
constexpr int kProducerWarps = 8;
constexpr int kProducers = 32 * kProducerWarps;
constexpr int kThreads = kConsumers + kProducers;
constexpr int kIdxRegs = 2;                    // prefetched rows: 32 each

struct Args {
  const unsigned char* table;   // [R, row_bytes]
  const int32_t* idx;           // [n]
  unsigned char* out;           // [n, row_bytes]
  long long row_bytes;
  int n, rows, slab, slabs, pitch, words, depth;
  size_t stage;                 // bytes: rows * pitch
};

// Word w: its first output row, rows, byte offset into the row and bytes.
struct Word {
  int r0, nr, len;
  long long off;
  __device__ __forceinline__ Word(const Args& a, int w) {
    const int bundle = w / a.slabs, sl = w - bundle * a.slabs;
    r0 = bundle * a.rows;
    nr = min(a.rows, a.n - r0);
    off = (long long)sl * a.slab;
    len = (int)min((long long)a.slab, a.row_bytes - off);
  }
};

// A warp's lanes over ``cu`` units of a row: lanes along one row, or
// several short rows a pass (rpp rows; lanes past rpp * cu idle).
struct Lanes {
  int rpp, rf, u0;
  bool idle;
  __device__ __forceinline__ Lanes(int cu, int lane) {
    if (cu <= 32) {
      rpp = 32 / cu, rf = lane / cu, u0 = lane % cu;
      idle = lane >= rpp * cu;
    } else {
      rpp = 1, rf = 0, u0 = lane, idle = false;
    }
  }
};

// The first kIdxRegs * 32 row indices of word w, row j * 32 + lane in
// ids[j].
__device__ __forceinline__ void fetch(const Args& a, int w, int lane,
                                      int (&ids)[kIdxRegs]) {
  const Word wd(a, w);
#pragma unroll
  for (int j = 0; j < kIdxRegs; ++j) {
    const int r = j * 32 + lane;
    ids[j] = r < wd.nr ? __ldg(a.idx + wd.r0 + r) : 0;
  }
}

template <typename U>
__device__ __forceinline__ void copy_unit(unsigned char* dst,
                                          const unsigned char* src) {
  if constexpr (sizeof(U) == 16)
    ring::cp_async_16(dst, src, 16);
  else
    *reinterpret_cast<U*>(dst) = __ldg(reinterpret_cast<const U*>(src));
}

// A producer warp: passes pw, pw + kProducerWarps, ... of each of the
// block's ``local`` words into stage i % depth. The next word's indices
// load while this one waits for its stage; rows past kIdxRegs * 32 read
// theirs at the copy.
template <typename U>
__device__ void produce(const Args& a, unsigned char* smem, uint64_t* full,
                        uint64_t* empty, int local) {
  constexpr int B = int(sizeof(U));
  const int lane = threadIdx.x & 31;
  const int pw = (threadIdx.x - kConsumers) >> 5;
  int nxt[kIdxRegs];
  if (local > 0) fetch(a, blockIdx.x, lane, nxt);
  for (int i = 0; i < local; ++i) {
    int cur[kIdxRegs];
#pragma unroll
    for (int j = 0; j < kIdxRegs; ++j) cur[j] = nxt[j];
    if (i + 1 < local)
      fetch(a, blockIdx.x + (i + 1) * gridDim.x, lane, nxt);
    const Word wd(a, blockIdx.x + i * gridDim.x);
    const int cu = wd.len / B;
    const Lanes L(cu, lane);
    const ring::Slot sl(i, a.depth);
    ring::wait(&empty[sl.stage], sl.phase ^ 1);
    unsigned char* st = smem + sl.stage * a.stage;
    for (int p = pw; p * L.rpp < wd.nr; p += kProducerWarps) {
      const int r = p * L.rpp + L.rf;
      int id = 0;
#pragma unroll
      for (int j = 0; j < kIdxRegs; ++j) {
        if (j * 32 >= wd.nr) break;   // the same for every lane
        const int x = __shfl_sync(0xffffffffu, cur[j], r & 31);
        if ((r >> 5) == j) id = x;
      }
      if (L.idle || r >= wd.nr) continue;
      if (r >= 32 * kIdxRegs) id = __ldg(a.idx + wd.r0 + r);
      const unsigned char* src = a.table + id * a.row_bytes + wd.off;
      unsigned char* dst = st + r * a.pitch;
#pragma unroll 4
      for (int u = L.u0; u < cu; u += 32)
        copy_unit<U>(dst + u * B, src + u * B);
    }
    if constexpr (B == 16)
      ring::arrive_cp_async(&full[sl.stage]);
    else
      ring::arrive(&full[sl.stage]);
  }
  ring::cp_async_wait_all();
}

// A consumer warp: passes warp, warp + kWarps, ... of each word's rows,
// from the stage to ``out``.
template <typename U>
__device__ void consume(const Args& a, unsigned char* smem, uint64_t* full,
                        uint64_t* empty, int local) {
  constexpr int B = int(sizeof(U));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = 0; i < local; ++i) {
    const Word wd(a, blockIdx.x + i * gridDim.x);
    const int cu = wd.len / B;
    const Lanes L(cu, lane);
    const ring::Slot sl(i, a.depth);
    ring::wait(&full[sl.stage], sl.phase);
    const unsigned char* st = smem + sl.stage * a.stage;
    for (int p = warp; p * L.rpp < wd.nr; p += kWarps) {
      const int r = p * L.rpp + L.rf;
      if (L.idle || r >= wd.nr) continue;
      const U* src = reinterpret_cast<const U*>(st + r * a.pitch);
      U* dst = reinterpret_cast<U*>(a.out + (long long)(wd.r0 + r) *
                                                a.row_bytes + wd.off);
#pragma unroll 4
      for (int u = L.u0; u < cu; u += 32) dst[u] = src[u];
    }
    ring::arrive(&empty[sl.stage]);
  }
}

template <typename U>
__global__ void __launch_bounds__(kThreads) ring_gather_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + a.depth * a.stage);
  uint64_t* empty = full + a.depth;
  if (threadIdx.x == 0) {
    for (int s = 0; s < a.depth; ++s) {
      ring::init(&full[s], kProducers);            // one per producer
      ring::init(&empty[s], kConsumers);           // one per consumer
    }
    ring::fence_init();
  }
  __syncthreads();
  // the block's words: blockIdx.x, blockIdx.x + gridDim.x, ... < words
  const int b = blockIdx.x, local =
      b < a.words ? (a.words - 1 - b) / (int)gridDim.x + 1 : 0;
  if (threadIdx.x >= kConsumers)
    produce<U>(a, smem, full, empty, local);
  else
    consume<U>(a, smem, full, empty, local);
}

template <typename U>
int launch(const Args& a, int grid, void* stream) {
  const size_t smem = a.depth * (a.stage + 16);   // stages, two mbarriers
  cudaError_t err = repro::allow_smem(ring_gather_kernel<U>, smem);
  if (err != cudaSuccess) return err;
  ring_gather_kernel<U>
      <<<grid, kThreads, smem, (cudaStream_t)stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// out[n, row_bytes] = table[idx[0:n], :] in words of ``rows`` output rows
// by ``slab`` bytes of a row (``slabs`` a row, each at ``pitch`` bytes a
// row in its stage), ``words`` in all, through a ring of ``depth`` stages
// on ``grid`` blocks (ops.py _plan), copied in units of ``unit`` bytes
// (16, 8, 4 or 2; row_bytes, both pointers and the slab must be multiples
// of it).
extern "C" int ff_gather(const void* table, const void* idx, void* out, int n,
                         long long row_bytes, int rows, int slab, int slabs,
                         int pitch, int words, int depth, int grid, int unit,
                         void* stream) {
  if (n <= 0 || row_bytes <= 0 || words <= 0) return 0;
  if (rows < 1 || depth < 1 || grid < 1 || slab < 1 || pitch < slab ||
      pitch % 16)
    return cudaErrorInvalidValue;
  Args a;
  a.table = static_cast<const unsigned char*>(table);
  a.idx = static_cast<const int32_t*>(idx);
  a.out = static_cast<unsigned char*>(out);
  a.row_bytes = row_bytes;
  a.n = n, a.rows = rows, a.slab = slab, a.slabs = slabs, a.pitch = pitch;
  a.words = words, a.depth = depth;
  a.stage = size_t(rows) * pitch;
  grid = grid < words ? grid : words;
  switch (unit) {
    case 16: return launch<uint4>(a, grid, stream);
    case 8: return launch<uint2>(a, grid, stream);
    case 4: return launch<uint32_t>(a, grid, stream);
    case 2: return launch<uint16_t>(a, grid, stream);
    default: return cudaErrorInvalidValue;
  }
}
