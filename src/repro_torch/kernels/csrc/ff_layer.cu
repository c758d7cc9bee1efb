// The decode layer's projections for the H100 (sm_90a): a matmul with an
// optional RMSNorm prologue and a q-bias + RoPE or residual epilogue, the
// SwiGLU gate/up projection, and the MLP tail (out-projection + residual ->
// RMSNorm + SwiGLU -> down-projection + residual) as one cooperative launch.
//
// Replaces the TPU kernels of src/repro/kernels/ff_layer/kernel.py
// (build_matmul_program, build_swiglu_program) and the fused chain
// oproj -> gateup -> down of the decode_layer StreamGraph
// (src/repro/models/layers.py build_decode_layer_graph, lowered as one
// pallas_call by src/repro/core/graph.py _compile_chain).
//
// Bound on this card: at decode a few rows (one per sequence) meet a whole
// weight matrix, about 2 operations per weight byte in bf16 (1 in f32), far
// under the ~295 the tensor cores need or the ~20 of the f32 cores, so
// every kernel here is bound by device memory: the least time is the
// weight bytes over 3.35 TB/s (qwen's qproj, 2 MB in bf16, 0.6 us). What
// keeps a kernel from it is latency: a cold read under load takes
// microseconds, so streaming at 3.35 TB/s needs tens of KB in flight on
// every SM, and the launch itself costs microseconds before any byte
// moves. The TPU kernels kept k and n whole because VMEM holds a whole
// weight; here the work is split so every SM streams.
//
// One body for both types (bf16 and f32, the template parameter T). The
// work unit is a tile of 64 output columns (a SwiGLU tile is the same 64
// columns of wg and of wu) times a split of k. ops.py _plan picks the
// split from (n, k) and the SM count alone, one item a block on every SM
// (qwen's qproj, oproj and down 16 x 8, gateup 44 x 3), whatever the type.
// A block of four consumer warps and four producer warps walks its k rows
// through a ring_pipe.cuh ring of ``depth`` 16 KB stages. A staged weight
// row is the tile's columns in 16-byte chunks (8 bf16 or 4 f32 columns a
// chunk): 128 or 256 bytes a matmul row, 256 or 512 a SwiGLU row, so a
// stage holds 128 or 64 bf16 rows and 64 or 32 f32 rows. The producers
// fill a stage with 16-byte cp.async per row chunk (``streams``
// sub-copies of the stage's rows issued in turn), or with element loads
// where a weight's base or row stride is not 16-byte aligned; the
// consumers wait on the stage, run an f32 fmaf loop of their rows against
// it and release it. One warp issuing cp.async cannot keep the stages
// filled, hence four producer warps (1-D bulk copies, cp.async.bulk, of
// 64- and 128-byte rows were slower still). The rows' RMSNorm is computed
// by every block over the whole of k (m x k values, small), and only the
// block's k-slice of the normalised rows is staged; splits start at
// multiples of 8 rows, so the slice loads 16 bytes at a time. Each split
// writes its f32 partial tile to a workspace the wrapper allocates; the
// last block of a tile to arrive (an atomic ticket after __threadfence)
// sums the partials in split order 0, 1, 2, ... and applies the epilogue.
// The tickets reset themselves, so no memset launch is needed. In the MLP
// tail only the consumers wait at the grid barrier between stages: the
// producers run on into the next stage's weights, which do not depend on
// the stage before. No wgmma (at m = 4 a 64-row tile would be 94%
// padding) and no tensor maps (their encoding per call costs more host
// time than these kernels' device time).
//
// Numerics follow the reference graph exactly where it rounds: the
// normalised rows are rounded to the input type before the product (the
// identity in f32), sums are f32, the product is rounded to the output
// type and the epilogue sees that rounded value (q-bias and RoPE in f32,
// rounded back; residual added in the output type); SwiGLU computes
// silu(g) * u in f32 and rounds once. Products are taken with explicit
// fmaf chains and fixed butterflies, and the epilogues with _rn
// intrinsics (no contraction), so the same inputs give the same bits
// wherever a tile is computed: a k-lane sums the rows of its split in
// order, the lanes and warps meet in a fixed order, and the splits are
// summed in split order, whatever the ring's depth or streams or the copy
// path. The MLP tail runs its three stages through the same device
// functions as the standalone kernels, with the same splits, and grid-wide
// barriers between them, so it equals the staged composition (matmul ->
// swiglu -> matmul) bit for bit. Its intermediates (h [m, d] and the
// SwiGLU activations [m, f]) sit in one scratch buffer the wrapper
// allocates; they stay in L2 at decode sizes.

#include "ring_pipe.cuh"

namespace {

using bf16 = __nv_bfloat16;
namespace ring = repro::ring;

enum Epilogue { kNone = 0, kRope = 1, kResidual = 2 };

constexpr int kRows = 4;                // activation rows a pass
constexpr int kConsumers = 128;         // four consumer warps, one row each
constexpr int kProducers = 128;         // four producer warps
constexpr int kRingThreads = kConsumers + kProducers;
constexpr int kStageBytes = 16384;      // one ring stage
constexpr int kTile = 64;               // output columns of a tile
constexpr int kMaxCols = 2 * kTile;     // SwiGLU: 64 columns of wg and wu
static_assert(kConsumers / 32 == kRows, "one consumer warp a row's norm");

// Columns of T in one 16-byte chunk: 8 bf16, 4 f32.
template <typename T>
constexpr int kVec = 16 / int(sizeof(T));

// Activations are read around the tail's grid barriers, where another
// block wrote them: load them at L2 (coherent), never through L1.
__device__ __forceinline__ float load_cg(const float* p) { return __ldcg(p); }
__device__ __forceinline__ float load_cg(const bf16* p) {
  return __bfloat162float(__ushort_as_bfloat16(
      __ldcg(reinterpret_cast<const unsigned short*>(p))));
}

template <typename T>
__device__ __forceinline__ float round_f(float x) {
  return repro::to_f(repro::from_f<T>(x));
}

// The kVec<T> values of one 16-byte chunk as f32.
template <typename T>
__device__ __forceinline__ void unpack16(const uint4& raw, float* o);
template <>
__device__ __forceinline__ void unpack16<bf16>(const uint4& raw, float* o) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(h[e]);
    o[2 * e] = f.x;
    o[2 * e + 1] = f.y;
  }
}
template <>
__device__ __forceinline__ void unpack16<float>(const uint4& raw, float* o) {
  o[0] = __uint_as_float(raw.x);
  o[1] = __uint_as_float(raw.y);
  o[2] = __uint_as_float(raw.z);
  o[3] = __uint_as_float(raw.w);
}

// kVec<T> values from p as f32, of which the first n (any int) are read
// and the rest are 0; one 16-byte load (at L2, as load_cg) where p is
// aligned.
template <typename T>
__device__ __forceinline__ void load_vec_cg(const T* p, int n, float* o) {
  constexpr int V = kVec<T>;
  if (n >= V && reinterpret_cast<uintptr_t>(p) % 16 == 0) {
    unpack16<T>(__ldcg(reinterpret_cast<const uint4*>(p)), o);
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) o[e] = e < n ? load_cg(p + e) : 0.f;
  }
}

template <typename T>
struct MatmulArgs {
  const T* a;          // [m, k] contiguous
  const T* b;          // [k, n], row stride ldb
  long long ldb;
  const float* nw;     // [k] RMSNorm weight, or null (no prologue)
  T* out;              // [m, n] contiguous
  int m, n, k;
  float eps;
  int epilogue;        // kNone | kRope | kResidual
  const T* bias;       // kRope: [n] q bias, or null
  const int32_t* pos;  // kRope: [m] positions
  const float* freqs;  // kRope: [hd / 2] theta ** (-j / half)
  int hd;              // kRope: head dim
  const T* res;        // kResidual: [m, n] contiguous
  int split;           // k split over this many blocks a tile
  float* ws;           // split > 1: the splits' f32 partial tiles
  unsigned* cnt;       // split > 1: a ticket a tile, left at 0
};

template <typename T>
struct SwigluArgs {
  const T* x;          // [m, k] contiguous
  const T* wg;         // [k, f], row stride ldw
  const T* wu;         // [k, f], row stride ldw
  long long ldw;
  const float* nw;     // [k] RMSNorm weight, or null
  T* out;              // [m, f] contiguous
  int m, f, k;
  float eps;
  int split;           // as MatmulArgs
  float* ws;
  unsigned* cnt;
};

// ``depth`` stages of the ring; each stage's copy in ``streams`` parts.
struct Pipe {
  int depth, streams;
};

// Per kind: the element type, 16-byte chunks a staged weight row holds (a
// matmul tile's 64 columns; a SwiGLU tile's 64 columns of wg then the same
// of wu), its activations, output columns, weight row stride.
template <typename A>
struct Kind;
template <typename T>
struct Kind<MatmulArgs<T>> {
  using Elem = T;
  static constexpr int chunks = kTile / kVec<T>;
  __device__ static const T* act(const MatmulArgs<T>& p) { return p.a; }
  __host__ __device__ static int cols(const MatmulArgs<T>& p) { return p.n; }
  __device__ static long long ld(const MatmulArgs<T>& p) { return p.ldb; }
};
template <typename T>
struct Kind<SwigluArgs<T>> {
  using Elem = T;
  static constexpr int chunks = kMaxCols / kVec<T>;
  __device__ static const T* act(const SwigluArgs<T>& p) { return p.x; }
  __host__ __device__ static int cols(const SwigluArgs<T>& p) { return p.f; }
  __device__ static long long ld(const SwigluArgs<T>& p) { return p.ldw; }
};

// First k row of split s of ``split``: s * k / split, rounded down to a
// multiple of 8 (16-byte aligned activation slices where k % 8 == 0).
__host__ __device__ __forceinline__ int split_lo(int k, int split, int s) {
  return s == split ? k : int((long long)s * k / split) & ~7;
}

template <typename A>
__host__ __device__ __forceinline__ int ring_tiles(const A& p) {
  return (Kind<A>::cols(p) + kTile - 1) / kTile;
}

// First column of chunk ch of matmul tile t, or -1 past the edge. With
// RoPE, the first half of the tile's chunks holds 32 columns of the first
// halves of heads and the second half the same columns of the second
// halves, so each rotation pair meets in one tile, 32 tile columns apart
// (a head of 64 is exactly one tile); otherwise the tile is 64 columns in
// order.
template <typename T>
__device__ __forceinline__ int mm_col(const MatmulArgs<T>& p, int t, int ch) {
  constexpr int V = kVec<T>, H = kTile / V / 2;  // chunks a half tile
  if (p.epilogue == kRope) {
    const int half = p.hd / 2, per_head = half / V;
    const int pair = t * H + ch % H;
    if (pair >= p.n / (2 * V)) return -1;
    const int head = pair / per_head;
    return head * p.hd + (pair - head * per_head) * V + (ch >= H ? half : 0);
  }
  const int c = t * kTile + ch * V;
  return c < p.n ? c : -1;
}

// Where chunk ch of tile t is read: the chunk's columns at weight row 0,
// and how many of its columns are in range (0: none, the chunk is zeros).
template <typename T>
struct ChunkSrc {
  const T* w;
  int valid;
};
template <typename T>
__device__ __forceinline__ ChunkSrc<T> chunk_src(const MatmulArgs<T>& p,
                                                 int t, int ch) {
  const int c = mm_col(p, t, ch);
  if (c < 0) return {p.b, 0};
  return {p.b + c, min(kVec<T>, p.n - c)};
}
template <typename T>
__device__ __forceinline__ ChunkSrc<T> chunk_src(const SwigluArgs<T>& p,
                                                 int t, int ch) {
  constexpr int V = kVec<T>, H = kTile / V;  // chunks of wg's columns
  const int c = t * kTile + ch % H * V;
  if (c >= p.f) return {p.wg, 0};
  return {(ch < H ? p.wg : p.wu) + c, min(V, p.f - c)};
}

// cp.async takes 16-byte aligned chunks: an aligned base and a row stride
// of whole chunks (ragged n is zero-filled by the copy's source size).
template <typename T>
__device__ __forceinline__ bool aligned16(const T* w, long long ld) {
  return reinterpret_cast<uintptr_t>(w) % 16 == 0 && ld % kVec<T> == 0;
}
template <typename T>
__device__ __forceinline__ bool ring_vec(const MatmulArgs<T>& p) {
  return aligned16(p.b, p.ldb);
}
template <typename T>
__device__ __forceinline__ bool ring_vec(const SwigluArgs<T>& p) {
  return aligned16(p.wg, p.ldw) && aligned16(p.wu, p.ldw);
}

// Dynamic shared memory: the ring's stages, their full and empty
// barriers, the block's k-slice of kRows activation rows, the per-warp
// and the block's sums, the rows' rsqrt, the last-block flag. The same for
// both types (the sums are f32 columns). kernels/ff_layer/ops.py
// _smem_bytes computes the same.
size_t ring_smem_bytes(int depth, int ks_max) {
  return size_t(depth) * kStageBytes + 16 * size_t(depth) +
         4 * (size_t(kRows) * ks_max +
              size_t(kConsumers / 32 + 1) * kRows * kMaxCols + kRows) +
         16;
}

struct RingSmem {
  unsigned char* stages;
  uint64_t* full;
  uint64_t* empty;
  float* rows;  // [kRows, ks] the split's slice of the (normalised) rows
  float* red;   // [warps, kRows, tile columns] per-warp sums
  float* tile;  // [kRows, tile columns] the block's sums
  float* rs;    // [kRows] row rsqrt
  int* flag;    // this block is the last of its tile
};

__device__ RingSmem ring_carve(unsigned char* raw, int depth, int ks_max) {
  constexpr int kSums = kRows * kMaxCols;
  RingSmem s;
  s.stages = raw;
  s.full = reinterpret_cast<uint64_t*>(raw + size_t(depth) * kStageBytes);
  s.empty = s.full + depth;
  s.rows = reinterpret_cast<float*>(s.empty + depth);
  s.red = s.rows + kRows * ks_max;
  s.tile = s.red + (kConsumers / 32) * kSums;
  s.rs = s.tile + kSums;
  s.flag = reinterpret_cast<int*>(s.rs + kRows);
  return s;
}

// The consumer warps' barrier (the producer warps run on their own).
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
}

// The producer warps: for each pass over the rows, the split's weight
// rows [k_lo, k_lo + ks) into consecutive ring words of R rows, each word
// in ``streams`` parts of R / streams rows issued in turn. Producer thread
// l copies chunk l % chunks of rows l / chunks, + kProducers / chunks, ...
// by 16-byte cp.async (zero-filled past n), or by element loads and stores
// where the weight's base or row stride is not 16-byte aligned, and
// arrives once a word on full[s]. One warp's cp.async cannot keep the
// stages filled, so four warps share the copy.
template <typename A>
__device__ void produce(const A& p, Pipe pp, const RingSmem& sm, int t,
                        int k_lo, int ks, int passes, bool vec, int& g) {
  using T = typename Kind<A>::Elem;
  constexpr int V = kVec<T>;
  constexpr int CH = Kind<A>::chunks, RB = CH * 16, R = kStageBytes / RB;
  const int lane = threadIdx.x - kConsumers;
  const long long ld = Kind<A>::ld(p);
  const ChunkSrc<T> src = chunk_src(p, t, lane % CH);
  const int words = (ks + R - 1) / R, sub = R / pp.streams;
  for (int pass = 0; pass < passes; ++pass) {
    for (int q = 0; q < words; ++q, ++g) {
      const ring::Slot s(g, pp.depth);
      ring::wait(&sm.empty[s.stage], s.phase ^ 1);
      const int rows = min(R, ks - q * R);
      unsigned char* dst =
          sm.stages + size_t(s.stage) * kStageBytes + (lane % CH) * 16;
      const T* w = src.w + (long long)(k_lo + q * R) * ld;
      for (int j = 0; j < pp.streams; ++j) {
        const int end = min((j + 1) * sub, rows);
        for (int r = j * sub + lane / CH; r < end; r += kProducers / CH) {
          if (vec) {
            ring::cp_async_16(dst + r * RB, src.valid ? w + r * ld : src.w,
                              int(sizeof(T)) * src.valid);
          } else {
            T* d = reinterpret_cast<T*>(dst + r * RB);
#pragma unroll
            for (int v = 0; v < V; ++v)
              d[v] = v < src.valid ? w[r * ld + v] : repro::from_f<T>(0.f);
          }
        }
      }
      if (vec)
        ring::arrive_cp_async(&sm.full[s.stage]);
      else
        ring::arrive(&sm.full[s.stage]);
    }
  }
}

// Rows r0 .. r0+kRows-1 of a [m, k] (contiguous) at columns [k_lo,
// k_lo+ks) into sm.rows as f32, through the RMSNorm when nw is given: the
// mean square over the whole row (warp w sums row r0+w; lane l takes the
// 16-byte groups from group l, 32 groups apart, in order, whatever the
// alignment), rsqrt(+eps), times the f32 weight, rounded to T (the
// reference's _rms). Rows past m are 0. These reads are latency, not
// bandwidth: every thread issues a batch of loads (32 values of its norm
// row, 16 of the slice, in either type) before it uses one, and where the
// rows are 16-byte aligned (k a multiple of a chunk; split_lo aligns the
// slice) the slice's first batch goes out beside the norm's.
template <typename T>
__device__ void stage_slice(const T* a, int m, int k, int r0, int k_lo,
                            int ks, const float* nw, float eps,
                            const RingSmem& sm) {
  constexpr int V = kVec<T>;
  constexpr int kGroups = 32 / V, kBatch = 8, kPer = 16 / V;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool vec = k % V == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0;
  const int per_row = ks / V, vtotal = vec ? kRows * per_row : 0;
  float x[kPer][V], w[kPer][V];
  auto load_batch = [&](int i0) {
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int i = i0 + u * kConsumers, r = i / per_row;
      const int j = k_lo + (i - r * per_row) * V;
      const bool live = i < vtotal && r0 + r < m;
      load_vec_cg(a + size_t(r0 + r) * k + j, live ? V : 0, x[u]);
#pragma unroll
      for (int e = 0; e < V; ++e)
        w[u][e] = live && nw != nullptr ? nw[j + e] : 0.f;
    }
  };
  auto store_batch = [&](int i0) {
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int i = i0 + u * kConsumers, r = i / per_row;
      if (i >= vtotal) break;
      float* dst = sm.rows + r * ks + (i - r * per_row) * V;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        float v = x[u][e];
        if (nw != nullptr && r0 + r < m)
          v = round_f<T>(__fmul_rn(__fmul_rn(v, sm.rs[r]), w[u][e]));
        dst[e] = v;
      }
    }
  };
  consumer_sync();  // the previous pass is done with the rows
  if (vec) load_batch(tid);
  if (nw != nullptr) {
    float ss = 0.f;
    if (r0 + warp < m) {
      const T* row = a + size_t(r0 + warp) * k;
      for (int j0 = lane * V; j0 < k; j0 += 32 * V * kGroups) {
        float y[kGroups][V];
#pragma unroll
        for (int u = 0; u < kGroups; ++u) {
          const int j = j0 + u * 32 * V;
          load_vec_cg(row + j, k - j, y[u]);
        }
#pragma unroll
        for (int u = 0; u < kGroups; ++u)
#pragma unroll
          for (int e = 0; e < V; ++e) ss = fmaf(y[u][e], y[u][e], ss);
      }
    }
    ss = repro::warp_sum(ss);
    if (lane == 0)
      sm.rs[warp] = rsqrtf(__fadd_rn(__fdiv_rn(ss, float(k)), eps));
    consumer_sync();
  }
  if (vec) {
    store_batch(tid);
    for (int i0 = tid + kPer * kConsumers; i0 < vtotal;
         i0 += kPer * kConsumers) {
      load_batch(i0);
      store_batch(i0);
    }
    consumer_sync();
    return;
  }
  const int total = kRows * ks;
  for (int i0 = tid; i0 < total; i0 += kConsumers * kBatch) {
    float xs[kBatch], ws[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * kConsumers, r = i / ks, j = i - r * ks;
      xs[u] = 0.f;
      ws[u] = 0.f;
      if (i < total && r0 + r < m) {
        xs[u] = load_cg(a + size_t(r0 + r) * k + k_lo + j);
        if (nw != nullptr) ws[u] = nw[k_lo + j];
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * kConsumers, r = i / ks;
      if (i >= total) break;
      float v = xs[u];
      if (nw != nullptr && r0 + r < m)
        v = round_f<T>(__fmul_rn(__fmul_rn(v, sm.rs[r]), ws[u]));
      sm.rows[i] = v;
    }
  }
  consumer_sync();
}

// One landed word: rows i0 .. i0+nrows-1 of the split. Thread (kl, cg)
// takes chunk cg of the rows i with i % KL == kl, in order (R is a
// multiple of KL, so that holds across words).
template <typename T, int CH>
__device__ __forceinline__ void consume_word(const unsigned char* stage,
                                             const float* rows, int ks,
                                             int i0, int nrows,
                                             float (&acc)[kRows][kVec<T>]) {
  constexpr int V = kVec<T>, RB = CH * 16, KL = kConsumers / CH;
  const int cg = threadIdx.x % CH, kl = threadIdx.x / CH;
  auto row = [&](int rr) {
    float w[V];
    unpack16<T>(*reinterpret_cast<const uint4*>(stage + rr * RB + cg * 16),
                w);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float x = rows[r * ks + i0 + rr];
#pragma unroll
      for (int v = 0; v < V; ++v) acc[r][v] = fmaf(x, w[v], acc[r][v]);
    }
  };
#pragma unroll 2
  for (int rr = kl; rr < nrows; rr += KL) row(rr);
}

// The k-lanes' sums into sm.tile [kRows, CH * V]: a butterfly over the
// k-lanes of a warp (none where a warp is one k-lane), then the four warps
// in order 0..3.
template <typename T, int CH>
__device__ void reduce_tile(float (&acc)[kRows][kVec<T>], const RingSmem& sm) {
  constexpr int V = kVec<T>, CW = CH * V;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int v = 0; v < V; ++v) {
      float x = acc[r][v];
#pragma unroll
      for (int o = CH; o < 32; o <<= 1)
        x += __shfl_xor_sync(0xffffffffu, x, o);
      acc[r][v] = x;
    }
  if (lane < CH) {
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int v = 0; v < V; ++v)
        sm.red[(warp * kRows + r) * CW + lane * V + v] = acc[r][v];
  }
  consumer_sync();
  for (int i = tid; i < kRows * CW; i += kConsumers) {
    float sum = 0.f;
    for (int w = 0; w < kConsumers / 32; ++w) sum += sm.red[w * kRows * CW + i];
    sm.tile[i] = sum;
  }
  consumer_sync();
}

// Rows r0 .. of matmul tile t from sm.tile: round to T, then q bias +
// RoPE (the pair partner sits 32 columns away in the tile) or the
// residual. A thread's two outputs load all their operands before either
// is computed (they are latency).
template <typename T>
__device__ void epilogue(const MatmulArgs<T>& p, int t, int r0,
                         const RingSmem& sm) {
  constexpr int V = kVec<T>, HC = kTile / 2;
  constexpr int E = kRows * kTile / kConsumers;
  float val[E], other[E], add0[E], add1[E], pos[E], freq[E];
  int col[E], row[E];
  bool live[E], second[E];
  const int half = p.hd / 2;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int i = threadIdx.x + e * kConsumers;
    const int r = i / kTile, c = i - r * kTile, ch = c / V;
    const int c0 = mm_col(p, t, ch);
    row[e] = r0 + r;
    col[e] = c0 + c - ch * V;
    live[e] = row[e] < p.m && c0 >= 0 && col[e] < p.n;
    second[e] = c >= HC;
    val[e] = round_f<T>(sm.tile[i]);
    other[e] = add0[e] = add1[e] = pos[e] = freq[e] = 0.f;
    if (!live[e]) continue;
    if (p.epilogue == kRope) {
      const int pcol = second[e] ? col[e] - half : col[e] + half;
      other[e] = round_f<T>(sm.tile[second[e] ? i - HC : i + HC]);
      if (p.bias != nullptr) {
        add0[e] = repro::to_f(p.bias[col[e]]);
        add1[e] = repro::to_f(p.bias[pcol]);
      }
      pos[e] = float(p.pos[row[e]]);
      freq[e] = p.freqs[(second[e] ? pcol : col[e]) % p.hd];
    } else if (p.epilogue == kResidual) {
      add0[e] = load_cg(p.res + size_t(row[e]) * p.n + col[e]);
    }
  }
#pragma unroll
  for (int e = 0; e < E; ++e) {
    if (!live[e]) continue;
    float v = val[e];
    if (p.epilogue == kRope) {
      float o = other[e];
      if (p.bias != nullptr) {
        v = __fadd_rn(v, add0[e]);
        o = __fadd_rn(o, add1[e]);
      }
      const float ang = __fmul_rn(pos[e], freq[e]);
      const float cs = cosf(ang), sn = sinf(ang);
      const float x1 = second[e] ? o : v, x2 = second[e] ? v : o;
      v = second[e] ? __fadd_rn(__fmul_rn(x1, sn), __fmul_rn(x2, cs))
                    : __fsub_rn(__fmul_rn(x1, cs), __fmul_rn(x2, sn));
    } else if (p.epilogue == kResidual) {
      v = __fadd_rn(v, add0[e]);
    }
    p.out[size_t(row[e]) * p.n + col[e]] = repro::from_f<T>(v);
  }
}

// Rows r0 .. of SwiGLU tile t: silu(g) * u in f32, rounded once.
template <typename T>
__device__ void epilogue(const SwigluArgs<T>& p, int t, int r0,
                         const RingSmem& sm) {
  for (int i = threadIdx.x; i < kRows * kTile; i += kConsumers) {
    const int r = i / kTile, c = i - r * kTile;
    const int row = r0 + r, col = t * kTile + c;
    if (row >= p.m || col >= p.f) continue;
    const float gv = sm.tile[r * kMaxCols + c];
    const float uv = sm.tile[r * kMaxCols + kTile + c];
    const float sig = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-gv)));
    p.out[size_t(row) * p.f + col] =
        repro::from_f<T>(__fmul_rn(__fmul_rn(gv, sig), uv));
  }
}

// After every split of tile t has written its partials: the block whose
// ticket comes last sums them in split order and applies the epilogue,
// and resets the ticket for the next launch.
template <typename A>
__device__ void finish_tile(const A& p, int t, const RingSmem& sm) {
  constexpr int CW = Kind<A>::chunks * kVec<typename Kind<A>::Elem>;
  const int S = p.split, tid = threadIdx.x;
  consumer_sync();  // every consumer's partials, then one fence for all
  if (tid == 0) {
    __threadfence();
    const unsigned ticket = atomicAdd(&p.cnt[t], 1u);
    const int last = ticket == unsigned(S - 1);
    if (last) {
      atomicExch(&p.cnt[t], 0u);
      __threadfence();  // the other splits' partials after their tickets
    }
    *sm.flag = last;
  }
  consumer_sync();
  if (!*sm.flag) return;
  constexpr int E = kRows * CW / kConsumers;
  const size_t stride = size_t(p.m) * CW;
  for (int r0 = 0; r0 < p.m; r0 += kRows) {
    // in split order, four splits' loads in flight at a time
    const float* w[E];
    float sum[E];
    bool live[E];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int i = tid + e * kConsumers, row = r0 + i / CW;
      live[e] = row < p.m;
      w[e] = p.ws + size_t(t) * S * stride + size_t(row) * CW + i % CW;
      sum[e] = live[e] ? __ldcg(w[e]) : 0.f;
    }
    for (int s = 1; s < S; s += 4) {
      float v[4][E];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int e = 0; e < E; ++e)
          v[u][e] = s + u < S && live[e] ? __ldcg(w[e] + (s + u) * stride)
                                         : 0.f;
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int e = 0; e < E; ++e)
          if (s + u < S) sum[e] += v[u][e];
    }
#pragma unroll
    for (int e = 0; e < E; ++e) sm.tile[tid + e * kConsumers] = sum[e];
    consumer_sync();
    epilogue(p, t, r0, sm);
    consumer_sync();
  }
}

// Every (tile, split) item of one kernel's output, grid-stride. ``g``
// counts ring words in both roles, so a launch may run several stages
// (the MLP tail) through one ring.
template <typename A>
__device__ void ring_stage(const A& p, Pipe pp, const RingSmem& sm, int& g) {
  using T = typename Kind<A>::Elem;
  constexpr int V = kVec<T>;
  constexpr int CH = Kind<A>::chunks, CW = CH * V;
  constexpr int R = kStageBytes / (CH * 16);
  const int S = p.split, tiles = ring_tiles(p);
  const int passes = (p.m + kRows - 1) / kRows;
  const bool producer = threadIdx.x >= kConsumers;
  const bool vec = ring_vec(p);
  for (int it = blockIdx.x; it < tiles * S; it += gridDim.x) {
    const int t = it % tiles, s = it / tiles;
    const int k_lo = split_lo(p.k, S, s);
    const int ks = split_lo(p.k, S, s + 1) - k_lo;
    if (producer) {
      produce(p, pp, sm, t, k_lo, ks, passes, vec, g);
      continue;
    }
    const int words = (ks + R - 1) / R;
    for (int r0 = 0; r0 < p.m; r0 += kRows) {
      stage_slice(Kind<A>::act(p), p.m, p.k, r0, k_lo, ks, p.nw, p.eps, sm);
      float acc[kRows][V];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int v = 0; v < V; ++v) acc[r][v] = 0.f;
      for (int q = 0; q < words; ++q, ++g) {
        const ring::Slot sl(g, pp.depth);
        ring::wait(&sm.full[sl.stage], sl.phase);
        consume_word<T, CH>(sm.stages + size_t(sl.stage) * kStageBytes,
                            sm.rows, ks, q * R, min(R, ks - q * R), acc);
        ring::arrive(&sm.empty[sl.stage]);
      }
      reduce_tile<T, CH>(acc, sm);
      if (S == 1) {
        epilogue(p, t, r0, sm);
        continue;
      }
      for (int i = threadIdx.x; i < kRows * CW; i += kConsumers) {
        const int row = r0 + i / CW;
        if (row < p.m)
          __stcg(p.ws + (size_t(t * S + s) * p.m + row) * CW + i % CW,
                 sm.tile[i]);
      }
    }
    if (S > 1) finish_tile(p, t, sm);
  }
}

__device__ RingSmem ring_setup(unsigned char* raw, Pipe pp, int ks_max) {
  const RingSmem sm = ring_carve(raw, pp.depth, ks_max);
  if (threadIdx.x == 0) {
    for (int s = 0; s < pp.depth; ++s) {
      ring::init(&sm.full[s], kProducers);  // one per producer thread
      ring::init(&sm.empty[s], kConsumers);
    }
    ring::fence_init();
  }
  __syncthreads();
  return sm;
}

template <typename T>
__global__ void __launch_bounds__(kRingThreads)
    ring_matmul_kernel(MatmulArgs<T> p, Pipe pp, int ks_max) {
  extern __shared__ __align__(128) unsigned char ring_smem[];
  const RingSmem sm = ring_setup(ring_smem, pp, ks_max);
  int g = 0;
  ring_stage(p, pp, sm, g);
}

template <typename T>
__global__ void __launch_bounds__(kRingThreads)
    ring_swiglu_kernel(SwigluArgs<T> p, Pipe pp, int ks_max) {
  extern __shared__ __align__(128) unsigned char ring_smem[];
  const RingSmem sm = ring_setup(ring_smem, pp, ks_max);
  int g = 0;
  ring_stage(p, pp, sm, g);
}

// The consumers' grid barrier between the MLP tail's stages. bar[0]
// counts arrivals and bar[1] is the barrier's generation; the last block
// to arrive resets the count (so the count is 0 again for the next
// launch) and moves the generation on. Every block is resident (a
// cooperative launch), so the wait ends.
__device__ void consumer_grid_sync(unsigned* bar) {
  consumer_sync();  // this block's outputs of the stage are written
  if (threadIdx.x == 0) {
    const unsigned gen = *reinterpret_cast<volatile unsigned*>(&bar[1]);
    __threadfence();
    if (atomicAdd(&bar[0], 1u) == gridDim.x - 1) {
      atomicExch(&bar[0], 0u);
      __threadfence();
      atomicAdd(&bar[1], 1u);
    } else {
      while (*reinterpret_cast<volatile unsigned*>(&bar[1]) == gen)
        __nanosleep(32);
    }
    __threadfence();  // the other blocks' outputs after the barrier
  }
  consumer_sync();
}

// The MLP tail on the ring: the three stages through one ring. Only the
// consumers wait at a grid barrier between stages (the next stage reads
// what this one wrote); the producers read nothing the stages write, so
// they run on into the next stage's weights, filling the stages the
// consumers release: the memory stage runs ahead across the boundary.
// oproj and down run through one inlined copy of the matmul stage: every
// SM fetches the kernel's code cold at each launch (other kernels run in
// between on a model's path), and with a copy for each stage the tail was
// slower than its three staged launches.
template <typename T>
__global__ void __launch_bounds__(kRingThreads)
    ring_mlp_tail_kernel(MatmulArgs<T> oproj, SwigluArgs<T> gateup,
                         MatmulArgs<T> down, Pipe pp, int ks_max,
                         unsigned* bar) {
  extern __shared__ __align__(128) unsigned char ring_smem[];
  const RingSmem sm = ring_setup(ring_smem, pp, ks_max);
  const bool consumer = threadIdx.x < kConsumers;
  int g = 0;
  for (int stage = 0; stage < 3; ++stage) {
    if (stage == 1) {
      ring_stage(gateup, pp, sm, g);
    } else {
      const MatmulArgs<T> mm = stage == 0 ? oproj : down;
      ring_stage(mm, pp, sm, g);
    }
    if (stage < 2 && consumer) consumer_grid_sync(bar);
  }
}

// The most k rows a split of k takes (split_lo's bounds).
int split_rows(int k, int split) {
  int most = 0;
  for (int s = 0; s < split; ++s)
    most = max(most, split_lo(k, split, s + 1) - split_lo(k, split, s));
  return most;
}

template <typename A, typename Kernel>
int launch_ring(Kernel kernel, const A& p, Pipe pp, void* stream) {
  if (p.m == 0 || Kind<A>::cols(p) == 0) return 0;
  const int ks_max = split_rows(p.k, p.split);
  const size_t smem = ring_smem_bytes(pp.depth, ks_max);
  cudaError_t err = repro::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  A a = p;
  Pipe q = pp;
  int kmax = ks_max;
  void* args[] = {&a, &q, &kmax};
  err = cudaLaunchKernel((const void*)kernel, dim3(ring_tiles(p) * p.split),
                         dim3(kRingThreads), args, smem,
                         (cudaStream_t)stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The cooperative grid: as many blocks as the most items of a stage, but
// no more than can be resident at once (more is refused at launch with
// cudaErrorCooperativeLaunchTooLarge).
template <typename T>
int launch_ring_tail(const MatmulArgs<T>& oproj, const SwigluArgs<T>& gateup,
                     const MatmulArgs<T>& down, Pipe pp, unsigned* bar,
                     void* stream) {
  if (oproj.m == 0) return 0;
  int ks_max = max(split_rows(oproj.k, oproj.split),
                   split_rows(gateup.k, gateup.split));
  ks_max = max(ks_max, split_rows(down.k, down.split));
  const size_t smem = ring_smem_bytes(pp.depth, ks_max);
  cudaError_t err = repro::allow_smem(ring_mlp_tail_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, ring_mlp_tail_kernel<T>, kRingThreads, smem);
  if (err != cudaSuccess) return err;
  int items = max(ring_tiles(oproj) * oproj.split,
                  ring_tiles(gateup) * gateup.split);
  items = max(items, ring_tiles(down) * down.split);
  int grid = min(per_sm * sms, items);
  if (grid < 1) grid = 1;  // nothing fits: let the launch report it
  err = repro::launch_cooperative(ring_mlp_tail_kernel<T>, grid,
                                  kRingThreads, smem, stream, oproj, gateup,
                                  down, pp, ks_max, bar);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The wrapper's ticket buffer (ops.py _tickets): words 0 and 1 are the
// MLP tail's grid barrier, the tiles' tickets follow.
constexpr int kBarrierWords = 2;
unsigned* tickets(void* cnt) {
  return cnt ? static_cast<unsigned*>(cnt) + kBarrierWords : nullptr;
}

template <typename T>
MatmulArgs<T> matmul_args(const void* a, const void* b, long long ldb,
                          const void* nw, void* out, int m, int n, int k,
                          float eps, int epilogue, const void* bias,
                          const void* pos, const void* freqs, int hd,
                          const void* res, int split, void* ws, void* cnt) {
  MatmulArgs<T> p;
  p.a = static_cast<const T*>(a);
  p.b = static_cast<const T*>(b);
  p.ldb = ldb;
  p.nw = static_cast<const float*>(nw);
  p.out = static_cast<T*>(out);
  p.m = m;
  p.n = n;
  p.k = k;
  p.eps = eps;
  p.epilogue = epilogue;
  p.bias = static_cast<const T*>(bias);
  p.pos = static_cast<const int32_t*>(pos);
  p.freqs = static_cast<const float*>(freqs);
  p.hd = hd;
  p.res = static_cast<const T*>(res);
  p.split = split;
  p.ws = static_cast<float*>(ws);
  p.cnt = tickets(cnt);
  return p;
}

template <typename T>
SwigluArgs<T> swiglu_args(const void* x, const void* wg, const void* wu,
                          long long ldw, const void* nw, void* out, int m,
                          int f, int k, float eps, int split, void* ws,
                          void* cnt) {
  SwigluArgs<T> p;
  p.x = static_cast<const T*>(x);
  p.wg = static_cast<const T*>(wg);
  p.wu = static_cast<const T*>(wu);
  p.ldw = ldw;
  p.nw = static_cast<const float*>(nw);
  p.out = static_cast<T*>(out);
  p.m = m;
  p.f = f;
  p.k = k;
  p.eps = eps;
  p.split = split;
  p.ws = static_cast<float*>(ws);
  p.cnt = tickets(cnt);
  return p;
}

}  // namespace

// Every entry takes the ring's depth and streams and each stage's k split
// with the split workspace and tickets (ops.py _ring), in both types.

#define REPRO_FF_LAYER_ENTRIES(SUFFIX, T)                                     \
  extern "C" int ff_layer_matmul_##SUFFIX(                                    \
      const void* a, const void* b, long long ldb, const void* nw, void* out, \
      int m, int n, int k, float eps, int epilogue, const void* bias,         \
      const void* pos, const void* freqs, int hd, const void* res,            \
      int depth, int streams, int split, void* ws, void* cnt,                 \
      void* stream) {                                                         \
    return launch_ring(                                                       \
        ring_matmul_kernel<T>,                                                \
        matmul_args<T>(a, b, ldb, nw, out, m, n, k, eps, epilogue, bias, pos, \
                       freqs, hd, res, split, ws, cnt),                       \
        Pipe{depth, streams}, stream);                                        \
  }                                                                           \
  extern "C" int ff_layer_swiglu_##SUFFIX(                                    \
      const void* x, const void* wg, const void* wu, long long ldw,           \
      const void* nw, void* out, int m, int f, int k, float eps, int depth,   \
      int streams, int split, void* ws, void* cnt, void* stream) {            \
    return launch_ring(ring_swiglu_kernel<T>,                                 \
                       swiglu_args<T>(x, wg, wu, ldw, nw, out, m, f, k, eps,  \
                                      split, ws, cnt),                        \
                       Pipe{depth, streams}, stream);                         \
  }                                                                           \
  extern "C" int ff_layer_mlp_tail_##SUFFIX(                                  \
      const void* a, const void* wo, long long ldwo, const void* x,           \
      const void* nw2, const void* wg, const void* wu, long long ldgu,        \
      const void* wo2, long long ldwo2, void* h, void* act, void* out, int m, \
      int hq, int d, int f, float eps, int depth, int streams, int split1,    \
      int split2, int split3, void* ws, void* cnt, void* stream) {            \
    return launch_ring_tail<T>(                                               \
        matmul_args<T>(a, wo, ldwo, nullptr, h, m, d, hq, eps, kResidual,     \
                       nullptr, nullptr, nullptr, 0, x, split1, ws, cnt),     \
        swiglu_args<T>(h, wg, wu, ldgu, nw2, act, m, f, d, eps, split2, ws,   \
                       cnt),                                                  \
        matmul_args<T>(act, wo2, ldwo2, nullptr, out, m, d, f, eps,           \
                       kResidual, nullptr, nullptr, nullptr, 0, h, split3,    \
                       ws, cnt),                                              \
        Pipe{depth, streams}, static_cast<unsigned*>(cnt), stream);           \
  }

REPRO_FF_LAYER_ENTRIES(f32, float)
REPRO_FF_LAYER_ENTRIES(bf16, __nv_bfloat16)
