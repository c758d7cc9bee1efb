// AdamW with global-norm clipping over every leaf of a parameter tree, for
// the H100 (sm_90a): one pass over the gradients for their norm, then one
// pass that updates the parameters and both moments in place.
//
// Replaces no Pallas kernel: it is the counterpart of the fusion XLA makes
// of the reference's update (src/repro/optim/adamw.py:60 update) inside its
// jitted train step (src/repro/launch/train.py:126). The port's plain
// version (kernels/adamw/ops.py adamw_ref) runs some twenty f32 passes over
// every leaf; this runs two launches over all of them.
//
// Bound on this card: bytes. Each parameter is read once (its own type), its
// gradient once (twice here: launch 1 for the norm, launch 2 for the
// update), both f32 moments read once, and the parameter and both moments
// written once: 28 bytes a parameter for f32 parameters and gradients, 32 as
// this kernel moves them, over 3.35 TB/s. The arithmetic, some twenty f32
// operations an element, is far below the card's rate.
//
// Design:
//   * One multi-tensor launch. The leaves travel in the launch's parameters
//     (Table, at most kMaxLeaves of them; the wrapper splits a larger tree
//     into groups, two launches each): pointers, sizes and each leaf's first
//     tile. Nothing is copied from the host and nothing allocated, so a
//     CUDA graph captures the launch as it is, the captured node keeping
//     the capture's pointers. A tile is kTile elements of one leaf; block
//     b walks tiles b, b + gridDim.x, ... and finds each tile's leaf by a
//     binary search over the leaves' first tiles.
//   * Launch 1 (adamw_sumsq): each thread sums the squares of its elements
//     in double, in a fixed order; each block reduces its threads in a
//     fixed order and writes one partial. No atomics: the result depends on
//     the grid alone, which depends on the tree's sizes and the SM count, so
//     a replay gives its eager step's norm bit for bit. Block 0 also adds
//     one to the step counter (the plain version's ``step.add_(1)``).
//   * On a mesh each rank runs both launches on its own shards. Between
//     them the wrapper sums the partials over the mesh (an all-reduce of
//     launch 1's output, which has one length on every rank), a leaf's
//     elements that several ranks hold counted on one of them (kNoNorm on
//     the others): every rank then derives the same norm.
//   * Launch 2 (adamw_apply): every block sums the partials in the same
//     fixed order (a few KB from L2) and derives, on the device from the
//     step counter, the clip scale, the learning rate (the plain version's
//     schedule) and both bias corrections: no host read. Then each element:
//     p and g read in their own types, the math in f32 with the plain
//     version's operations in its order, each rounded on its own
//     (__fmul_rn and friends: no FMA contraction), p, m and v written
//     back. Block 0 writes the norm and the learning rate (the metrics).
//   * Four-element loads and stores (16 bytes of f32, 8 of bf16) where the
//     leaf's four pointers allow them, single elements at a leaf's ragged
//     end. In a whole tile a thread issues the loads of all its kQuads
//     quads (256 bytes of f32) before it computes any: one quad at a time
//     left the card's memory half idle (23.9 ms against a 10.3 ms bound
//     at llama3.2-1b's 1.24e9 parameters, NVIDIA H100 80GB HBM3 at
//     700 W, chip_smoke.py's adamw line).
// Given the same clip scale the update equals the plain version's on the
// card bit for bit; the norm's sum is taken in another order (and in
// double), so a clipped step's scale may differ in its last bits.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kQuads = 4;               // quads (4 elements) a thread a tile
constexpr long long kTile = 4 * kQuads * kThreads;   // 4096 elements
constexpr int kMaxLeaves = 64;          // the Table stays under 4 KB

// kNoNorm: the leaf's shard is left out of launch 1's sum (on a mesh, a
// rank other than the first of the ranks holding the same elements)
enum : int { kPBf16 = 1, kGBf16 = 2, kVec = 4, kNoNorm = 8 };

struct Leaf {
  void* p;            // parameter, f32 or bf16 (flags)
  const void* g;      // gradient, f32 or bf16 (flags)
  float* m;           // first moment
  float* v;           // second moment
  long long n;        // elements
  int tile0;          // the leaf's first tile in the group's numbering
  int flags;
};

struct Table {
  int n_leaves;
  int tiles;          // tiles of every leaf of the group
  Leaf leaf[kMaxLeaves];
};

struct Hyper {
  float lr_peak, b1, b2, eps, weight_decay, clip_norm;
  float one_minus_b1, one_minus_b2;   // (1 - b) rounded once, as torch does
  int warmup;         // cfg.warmup_steps
  int warm_div;       // max(warmup, 1)
  int decay_div;      // max(total_steps - warmup, 1)
};

__device__ __forceinline__ int find_leaf(const Table& t, int tile) {
  int lo = 0, hi = t.n_leaves - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.leaf[mid].tile0 <= tile) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

__device__ __forceinline__ float load1(const void* base, long long i,
                                       bool bf16) {
  return bf16 ? __bfloat162float(
                    static_cast<const __nv_bfloat16*>(base)[i])
              : static_cast<const float*>(base)[i];
}

__device__ __forceinline__ void load4(const void* base, long long i,
                                      bool bf16, float (&x)[4]) {
  if (bf16) {
    const uint2 raw = *reinterpret_cast<const uint2*>(
        static_cast<const __nv_bfloat16*>(base) + i);
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int k = 0; k < 4; ++k) x[k] = __bfloat162float(h[k]);
  } else {
    const float4 raw =
        *reinterpret_cast<const float4*>(static_cast<const float*>(base) + i);
    x[0] = raw.x, x[1] = raw.y, x[2] = raw.z, x[3] = raw.w;
  }
}

__device__ __forceinline__ void store1(void* base, long long i, bool bf16,
                                       float x) {
  if (bf16)
    static_cast<__nv_bfloat16*>(base)[i] = __float2bfloat16_rn(x);
  else
    static_cast<float*>(base)[i] = x;
}

__device__ __forceinline__ void store4(void* base, long long i, bool bf16,
                                       const float (&x)[4]) {
  if (bf16) {
    uint2 raw;
    __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&raw);
#pragma unroll
    for (int k = 0; k < 4; ++k) h[k] = __float2bfloat16_rn(x[k]);
    *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(base) + i) = raw;
  } else {
    *reinterpret_cast<float4*>(static_cast<float*>(base) + i) =
        make_float4(x[0], x[1], x[2], x[3]);
  }
}

__device__ __forceinline__ double warp_sum_d(double x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// The block's sum of ``x`` in a fixed order; valid in thread 0.
__device__ __forceinline__ double block_sum(double x, double* red) {
  x = warp_sum_d(x);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  double s = 0.0;
  if (threadIdx.x == 0)
    for (int w = 0; w < kWarps; ++w) s += red[w];
  return s;
}

__global__ void __launch_bounds__(kThreads)
    adamw_sumsq_kernel(const __grid_constant__ Table t, double* partials,
                       int* step) {
  __shared__ double red[kWarps];
  if (step != nullptr && blockIdx.x == 0 && threadIdx.x == 0) *step += 1;
  double acc = 0.0;
  for (int tile = blockIdx.x; tile < t.tiles; tile += gridDim.x) {
    const Leaf& l = t.leaf[find_leaf(t, tile)];
    if (l.flags & kNoNorm) continue;
    const bool gb = l.flags & kGBf16, vec = l.flags & kVec;
    const long long base = (long long)(tile - l.tile0) * kTile;
    const long long end = min(base + kTile, l.n);
    for (long long i = base + 4 * threadIdx.x; i < end; i += 4 * kThreads) {
      if (vec && i + 4 <= end) {
        float x[4];
        load4(l.g, i, gb, x);
#pragma unroll
        for (int k = 0; k < 4; ++k) acc += (double)x[k] * (double)x[k];
      } else {
        for (long long j = i; j < i + 4 && j < end; ++j) {
          const double x = load1(l.g, j, gb);
          acc += x * x;
        }
      }
    }
  }
  const double s = block_sum(acc, red);
  if (threadIdx.x == 0) partials[blockIdx.x] = s;
}

// The plain version's schedule, operation for operation as PyTorch runs it
// on the card (a division by a host scalar is a product with its
// reciprocal there).
__device__ __forceinline__ float schedule(const Hyper& h, float s) {
  const float warm = __fmul_rn(s, __fdiv_rn(1.0f, (float)h.warm_div));
  float t = __fmul_rn(__fsub_rn(s, (float)h.warmup),
                      __fdiv_rn(1.0f, (float)h.decay_div));
  t = fminf(fmaxf(t, 0.0f), 1.0f);
  const float c = __fadd_rn(
      __fmul_rn(__fadd_rn(cosf(__fmul_rn(t, 3.14159265358979323846f)),
                          1.0f),
                0.45f),
      0.1f);
  return __fmul_rn(s < (float)h.warmup ? warm : c, h.lr_peak);
}

struct Scalars {
  float scale, lr, b1c, b2c;
};

__device__ __forceinline__ void update4(const Hyper& h, const Scalars& c,
                                        float (&p)[4], const float (&g)[4],
                                        float (&m)[4], float (&v)[4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float gs = __fmul_rn(g[k], c.scale);
    m[k] = __fadd_rn(__fmul_rn(m[k], h.b1), __fmul_rn(h.one_minus_b1, gs));
    v[k] = __fadd_rn(__fmul_rn(v[k], h.b2),
                     __fmul_rn(__fmul_rn(h.one_minus_b2, gs), gs));
    const float den =
        __fadd_rn(__fsqrt_rn(__fdiv_rn(v[k], c.b2c)), h.eps);
    const float u = __fadd_rn(__fdiv_rn(__fdiv_rn(m[k], c.b1c), den),
                              __fmul_rn(h.weight_decay, p[k]));
    p[k] = __fsub_rn(p[k], __fmul_rn(c.lr, u));
  }
}

__global__ void __launch_bounds__(kThreads)
    adamw_apply_kernel(const __grid_constant__ Table t,
                       const double* partials, int n_partials,
                       const int* step, Hyper h, float* gnorm_out,
                       float* lr_out) {
  __shared__ double red[kWarps];
  __shared__ Scalars sc;
  double acc = 0.0;
  for (int i = threadIdx.x; i < n_partials; i += kThreads) acc += partials[i];
  const double total = block_sum(acc, red);
  if (threadIdx.x == 0) {
    const float norm = __fsqrt_rn((float)total);
    // clamp(max_norm / (norm + 1e-9), max=1): a host scalar over a tensor
    // is its reciprocal times the scalar in PyTorch
    float scale =
        __fmul_rn(__fdiv_rn(1.0f, __fadd_rn(norm, 1e-9f)), h.clip_norm);
    scale = scale > 1.0f ? 1.0f : scale;
    const float s = (float)*step;
    Scalars c;
    c.scale = scale;
    c.lr = schedule(h, s);
    c.b1c = __fsub_rn(1.0f, powf(h.b1, s));
    c.b2c = __fsub_rn(1.0f, powf(h.b2, s));
    sc = c;
    if (blockIdx.x == 0 && gnorm_out != nullptr) {
      *gnorm_out = norm;
      *lr_out = c.lr;
    }
  }
  __syncthreads();
  const Scalars c = sc;
  for (int tile = blockIdx.x; tile < t.tiles; tile += gridDim.x) {
    const Leaf& l = t.leaf[find_leaf(t, tile)];
    const bool pb = l.flags & kPBf16, gb = l.flags & kGBf16,
               vec = l.flags & kVec;
    const long long base = (long long)(tile - l.tile0) * kTile;
    const long long end = min(base + kTile, l.n);
    if (vec && end - base == kTile) {
      // a whole tile: every quad's loads in flight before any arithmetic
      float p[kQuads][4], g[kQuads][4], m[kQuads][4], v[kQuads][4];
#pragma unroll
      for (int q = 0; q < kQuads; ++q) {
        const long long i = base + 4 * (threadIdx.x + q * kThreads);
        load4(l.p, i, pb, p[q]);
        load4(l.g, i, gb, g[q]);
        load4(l.m, i, false, m[q]);
        load4(l.v, i, false, v[q]);
      }
#pragma unroll
      for (int q = 0; q < kQuads; ++q) {
        const long long i = base + 4 * (threadIdx.x + q * kThreads);
        update4(h, c, p[q], g[q], m[q], v[q]);
        store4(l.p, i, pb, p[q]);
        store4(l.m, i, false, m[q]);
        store4(l.v, i, false, v[q]);
      }
      continue;
    }
    for (long long i = base + 4 * threadIdx.x; i < end; i += 4 * kThreads) {
      float p[4] = {0, 0, 0, 0}, g[4] = {0, 0, 0, 0}, m[4] = {0, 0, 0, 0},
            v[4] = {0, 0, 0, 0};
      if (vec && i + 4 <= end) {
        load4(l.p, i, pb, p);
        load4(l.g, i, gb, g);
        load4(l.m, i, false, m);
        load4(l.v, i, false, v);
        update4(h, c, p, g, m, v);
        store4(l.p, i, pb, p);
        store4(l.m, i, false, m);
        store4(l.v, i, false, v);
      } else {
        const int k_end = end - i < 4 ? (int)(end - i) : 4;
        for (int k = 0; k < k_end; ++k) {
          p[k] = load1(l.p, i + k, pb);
          g[k] = load1(l.g, i + k, gb);
          m[k] = l.m[i + k];
          v[k] = l.v[i + k];
        }
        update4(h, c, p, g, m, v);
        for (int k = 0; k < k_end; ++k) {
          store1(l.p, i + k, pb, p[k]);
          l.m[i + k] = m[k];
          l.v[i + k] = v[k];
        }
      }
    }
  }
}

}  // namespace

// Launch 1: one partial sum of squares a block into ``partials`` [grid];
// ``step`` (int32, or null) gains one.
extern "C" int adamw_sumsq(const void* table_ptr, double* partials,
                           int grid, int* step, void* stream) {
  const Table* table = static_cast<const Table*>(table_ptr);
  if (table->n_leaves < 1 || table->n_leaves > kMaxLeaves || grid < 1)
    return cudaErrorInvalidValue;
  adamw_sumsq_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      *table, partials, step);
  return cudaGetLastError();
}

// Launch 2: the update of every leaf of ``table`` from the ``n_partials``
// partial sums of every group's launch 1 and the step counter; the norm and
// the learning rate into ``gnorm`` and ``lr`` where they are not null.
extern "C" int adamw_apply(const void* table_ptr, const double* partials,
                           int n_partials, const int* step,
                           const void* hyper_ptr, float* gnorm, float* lr,
                           int grid, void* stream) {
  const Table* table = static_cast<const Table*>(table_ptr);
  const Hyper* hyper = static_cast<const Hyper*>(hyper_ptr);
  if (table->n_leaves < 1 || table->n_leaves > kMaxLeaves || grid < 1 ||
      n_partials < 1)
    return cudaErrorInvalidValue;
  adamw_apply_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      *table, partials, n_partials, step, *hyper, gnorm, lr);
  return cudaGetLastError();
}
