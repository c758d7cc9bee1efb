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
// weight matrix, about 2 operations per weight byte in bf16, far under the
// ~295 the tensor cores need, so every kernel here is bound by device
// memory: the least time is the weight bytes over 3.35 TB/s. The TPU
// kernels kept k and n whole because VMEM holds a whole weight; here each
// block owns one column tile over all rows (two groups of 16 bytes per
// k-row, one per thread column), walks k with 128 threads, and recomputes
// the rows' RMSNorm itself (rows x k values, small next to the tile's
// weights). Coalesced 16-byte weight loads and plain FMA loops; wgmma, TMA
// rings and split-k are for later work.
//
// Numerics follow the reference graph exactly where it rounds: the
// normalised rows are rounded to the input type before the product, sums
// are f32, the product is rounded to the output type and the epilogue sees
// that rounded value (q-bias and RoPE in f32, rounded back; residual added
// in the output type); SwiGLU computes silu(g) * u in f32 and rounds once.
// Products are taken with explicit fmaf chains and a fixed butterfly, and
// the epilogues with _rn intrinsics (no contraction), so the same inputs
// give the same bits wherever a tile is computed. The MLP tail runs its
// three stages through the same device functions as the standalone
// kernels, with grid-wide barriers between them, so it equals the staged
// composition (matmul -> swiglu -> matmul) bit for bit. Its intermediates
// (h [m, d] and the SwiGLU activations [m, f]) sit in one scratch buffer
// the wrapper allocates; they stay in L2 at decode sizes.

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kKThreads = kThreads / 2;  // threads along k; 2 column groups
constexpr int kRows = 4;                 // rows per pass over the weights

enum Epilogue { kNone = 0, kRope = 1, kResidual = 2 };

template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int n = 4;
  __device__ static void load(const float* p, float* o) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    o[0] = v.x;
    o[1] = v.y;
    o[2] = v.z;
    o[3] = v.w;
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int n = 8;
  __device__ static void load(const __nv_bfloat16* p, float* o) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      o[2 * i] = f.x;
      o[2 * i + 1] = f.y;
    }
  }
};

// Activations are read around the tail's grid barriers, where another
// block wrote them: load them at L2 (coherent), never through L1.
__device__ __forceinline__ float load_cg(const float* p) { return __ldcg(p); }
__device__ __forceinline__ float load_cg(const __nv_bfloat16* p) {
  return __bfloat162float(__ushort_as_bfloat16(
      __ldcg(reinterpret_cast<const unsigned short*>(p))));
}

template <typename T>
__device__ __forceinline__ float round_f(float x) {
  return repro::to_f(repro::from_f<T>(x));
}

// VEC columns of one weight row from ``col``; columns past n read as 0.
template <typename T>
__device__ __forceinline__ void load_cols(const T* row, int col, int n,
                                          bool vec, float* o) {
  constexpr int V = Vec<T>::n;
  if (vec && col + V <= n) {
    Vec<T>::load(row + col, o);
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v)
      o[v] = col + v < n ? repro::to_f(row[col + v]) : 0.f;
  }
}

template <typename T>
__host__ __device__ constexpr int tile_cols() {
  return 2 * Vec<T>::n;
}

size_t smem_floats(int k, int tn) {
  return size_t(kRows) * k              // staged (normalised) rows
         + size_t(kWarps) * kRows * tn  // per-warp partial sums
         + size_t(kRows) * tn           // the tile's sums
         + kRows;                       // row rsqrt
}

struct Smem {
  float* rows;
  float* red;
  float* tile;
  float* rs;
};

template <typename T>
__device__ Smem carve(float* smem, int k_max) {
  constexpr int TN = tile_cols<T>();
  Smem s;
  s.rows = smem;
  s.red = s.rows + kRows * k_max;
  s.tile = s.red + kWarps * kRows * TN;
  s.rs = s.tile + kRows * TN;
  return s;
}

// Rows r0 .. r0+kRows-1 of a [m, k] (contiguous) into shared memory as f32,
// through the RMSNorm when nw is given: f32 mean square, rsqrt(+eps), times
// the f32 weight, rounded to T (the reference's _rms). Rows past m are 0.
template <typename T>
__device__ void stage_rows(const T* a, int m, int k, int r0, const float* nw,
                           float eps, Smem s) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  __syncthreads();  // the previous pass is done with the staged rows
  if (nw != nullptr) {
    for (int r = warp; r < kRows; r += kWarps) {
      float ss = 0.f;
      if (r0 + r < m) {
        const T* row = a + size_t(r0 + r) * k;
        for (int j = lane; j < k; j += 32) {
          const float x = load_cg(row + j);
          ss = fmaf(x, x, ss);
        }
      }
      ss = repro::warp_sum(ss);
      if (lane == 0) s.rs[r] = rsqrtf(__fadd_rn(__fdiv_rn(ss, float(k)), eps));
    }
    __syncthreads();
  }
  for (int i = tid; i < kRows * k; i += kThreads) {
    const int r = i / k, j = i - r * k;
    float x = 0.f;
    if (r0 + r < m) {
      x = load_cg(a + size_t(r0 + r) * k + j);
      if (nw != nullptr)
        x = round_f<T>(__fmul_rn(__fmul_rn(x, s.rs[r]), nw[j]));
    }
    s.rows[i] = x;
  }
  __syncthreads();
}

// The staged rows against columns [c0, c0+V) of w0 and [c1, c1+V) of w1
// (column group 0 and 1): s.tile[r * TN + g * V + v] = f32 sum over k.
// Thread (kl, g) sums k = kl, kl+128, ... in order; the 16 k-lanes of a
// warp meet in a butterfly, the 8 warps in order 0..7.
template <typename T>
__device__ void dot_tile(int k, const T* w0, const T* w1, long long ldw,
                         int c0, int c1, int n, bool vec, Smem s) {
  constexpr int V = Vec<T>::n, TN = tile_cols<T>();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = tid & 1, kl = tid >> 1;
  const T* w = g ? w1 : w0;
  const int col = g ? c1 : c0;
  float acc[kRows][V];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int v = 0; v < V; ++v) acc[r][v] = 0.f;
  for (int j = kl; j < k; j += kKThreads) {
    float b[V];
    load_cols(w + j * ldw, col, n, vec, b);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float x = s.rows[r * k + j];
#pragma unroll
      for (int v = 0; v < V; ++v) acc[r][v] = fmaf(x, b[v], acc[r][v]);
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int v = 0; v < V; ++v) {
      float x = acc[r][v];
#pragma unroll
      for (int o = 2; o < 32; o <<= 1)
        x += __shfl_xor_sync(0xffffffffu, x, o);
      acc[r][v] = x;
    }
  if (lane < 2) {
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int v = 0; v < V; ++v)
        s.red[(warp * kRows + r) * TN + lane * V + v] = acc[r][v];
  }
  __syncthreads();
  for (int i = tid; i < kRows * TN; i += kThreads) {
    float sum = 0.f;
    for (int w8 = 0; w8 < kWarps; ++w8) sum += s.red[w8 * kRows * TN + i];
    s.tile[i] = sum;
  }
  __syncthreads();
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
};

template <typename T>
__device__ __forceinline__ bool vec_ok(const T* p, long long ld, int n) {
  constexpr int V = Vec<T>::n;
  return n % V == 0 && ld % V == 0 &&
         reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T>
__host__ __device__ __forceinline__ int matmul_tiles(
    const MatmulArgs<T>& p) {
  constexpr int TN = tile_cols<T>();
  return (p.n + TN - 1) / TN;
}

// Column tile t: with RoPE, group 0 holds head columns [j, j+V) of the
// first half and group 1 the same columns of the second half, so each
// rotation pair meets in one block; otherwise the tile is 2V columns.
template <typename T>
__device__ __forceinline__ void matmul_cols(const MatmulArgs<T>& p, int t,
                                            int* c0, int* c1) {
  constexpr int V = Vec<T>::n;
  if (p.epilogue == kRope) {
    const int half = p.hd / 2, per_head = half / V;
    const int head = t / per_head, j = (t - head * per_head) * V;
    *c0 = head * p.hd + j;
    *c1 = *c0 + half;
  } else {
    *c0 = t * 2 * V;
    *c1 = *c0 + V;
  }
}

template <typename T>
__device__ void matmul_body(const MatmulArgs<T>& p, int k_max, int first,
                            int step, float* smem) {
  constexpr int V = Vec<T>::n, TN = tile_cols<T>();
  const Smem s = carve<T>(smem, k_max);
  const bool vec = vec_ok(p.b, p.ldb, p.n);
  const int n_tiles = matmul_tiles(p);
  if (first >= n_tiles) return;
  for (int r0 = 0; r0 < p.m; r0 += kRows) {
    stage_rows(p.a, p.m, p.k, r0, p.nw, p.eps, s);
    for (int t = first; t < n_tiles; t += step) {
      int c0, c1;
      matmul_cols(p, t, &c0, &c1);
      dot_tile(p.k, p.b, p.b, p.ldb, c0, c1, p.n, vec, s);
      for (int i = threadIdx.x; i < kRows * TN; i += kThreads) {
        const int r = i / TN, c = i - r * TN, g = c / V, v = c - g * V;
        const int row = r0 + r, col = (g ? c1 : c0) + v;
        if (row >= p.m || col >= p.n) continue;
        float val = round_f<T>(s.tile[i]);
        if (p.epilogue == kRope) {
          // the pair partner sits V columns away in the other group
          const int pc = g ? c - V : c + V;
          const int pcol = (g ? c0 : c1) + v;
          float other = round_f<T>(s.tile[r * TN + pc]);
          if (p.bias != nullptr) {
            val = __fadd_rn(val, repro::to_f(p.bias[col]));
            other = __fadd_rn(other, repro::to_f(p.bias[pcol]));
          }
          const int j = (c0 - (c0 / p.hd) * p.hd) + v;
          const float ang = __fmul_rn(float(p.pos[row]), p.freqs[j]);
          const float cs = cosf(ang), sn = sinf(ang);
          const float x1 = g ? other : val, x2 = g ? val : other;
          val = g ? __fadd_rn(__fmul_rn(x1, sn), __fmul_rn(x2, cs))
                  : __fsub_rn(__fmul_rn(x1, cs), __fmul_rn(x2, sn));
        } else if (p.epilogue == kResidual) {
          val = __fadd_rn(val, load_cg(p.res + size_t(row) * p.n + col));
        }
        p.out[size_t(row) * p.n + col] = repro::from_f<T>(val);
      }
    }
  }
}

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
};

template <typename T>
__host__ __device__ __forceinline__ int swiglu_tiles(
    const SwigluArgs<T>& p) {
  constexpr int V = Vec<T>::n;
  return (p.f + V - 1) / V;
}

// Tile t: gate columns [tV, tV+V) in group 0, the same up columns in
// group 1; out = silu(g) * u in f32, rounded once.
template <typename T>
__device__ void swiglu_body(const SwigluArgs<T>& p, int k_max, int first,
                            int step, float* smem) {
  constexpr int V = Vec<T>::n, TN = tile_cols<T>();
  const Smem s = carve<T>(smem, k_max);
  const bool vec = vec_ok(p.wg, p.ldw, p.f) && vec_ok(p.wu, p.ldw, p.f);
  const int n_tiles = swiglu_tiles(p);
  if (first >= n_tiles) return;
  for (int r0 = 0; r0 < p.m; r0 += kRows) {
    stage_rows(p.x, p.m, p.k, r0, p.nw, p.eps, s);
    for (int t = first; t < n_tiles; t += step) {
      const int c0 = t * V;
      dot_tile(p.k, p.wg, p.wu, p.ldw, c0, c0, p.f, vec, s);
      for (int i = threadIdx.x; i < kRows * V; i += kThreads) {
        const int r = i / V, v = i - r * V;
        const int row = r0 + r, col = c0 + v;
        if (row >= p.m || col >= p.f) continue;
        const float gv = s.tile[r * TN + v], uv = s.tile[r * TN + V + v];
        const float sig = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-gv)));
        p.out[size_t(row) * p.f + col] =
            repro::from_f<T>(__fmul_rn(__fmul_rn(gv, sig), uv));
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    matmul_kernel(MatmulArgs<T> p) {
  extern __shared__ float smem[];
  matmul_body(p, p.k, blockIdx.x, gridDim.x, smem);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    swiglu_kernel(SwigluArgs<T> p) {
  extern __shared__ float smem[];
  swiglu_body(p, p.k, blockIdx.x, gridDim.x, smem);
}

// The three stages of the MLP tail, each over all tiles of its output
// (grid-stride), with grid-wide barriers between them: every block sees
// the whole of h before stage 2 and the whole activation before stage 3.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    mlp_tail_kernel(MatmulArgs<T> oproj, SwigluArgs<T> gateup,
                    MatmulArgs<T> down, int k_max) {
  extern __shared__ float smem[];
  cg::grid_group grid = cg::this_grid();
  matmul_body(oproj, k_max, blockIdx.x, gridDim.x, smem);
  grid.sync();
  swiglu_body(gateup, k_max, blockIdx.x, gridDim.x, smem);
  grid.sync();
  matmul_body(down, k_max, blockIdx.x, gridDim.x, smem);
}

template <typename T>
int launch_matmul(const MatmulArgs<T>& p, void* stream) {
  constexpr int TN = tile_cols<T>();
  if (p.m == 0 || p.n == 0) return 0;
  const size_t smem = sizeof(float) * smem_floats(p.k, TN);
  cudaError_t err = repro::allow_smem(matmul_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  matmul_kernel<T><<<matmul_tiles(p), kThreads, smem,
                     (cudaStream_t)stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
int launch_swiglu(const SwigluArgs<T>& p, void* stream) {
  constexpr int TN = tile_cols<T>();
  if (p.m == 0 || p.f == 0) return 0;
  const size_t smem = sizeof(float) * smem_floats(p.k, TN);
  cudaError_t err = repro::allow_smem(swiglu_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  swiglu_kernel<T><<<swiglu_tiles(p), kThreads, smem,
                     (cudaStream_t)stream>>>(p);
  return cudaGetLastError();
}

// The cooperative grid: as many blocks as the most tiles of a stage, but
// no more than can be resident at once (more is refused at launch with
// cudaErrorCooperativeLaunchTooLarge).
template <typename T>
int launch_tail(const MatmulArgs<T>& oproj, const SwigluArgs<T>& gateup,
                const MatmulArgs<T>& down, void* stream) {
  constexpr int TN = tile_cols<T>();
  if (oproj.m == 0) return 0;
  int k_max = oproj.k > gateup.k ? oproj.k : gateup.k;
  k_max = k_max > down.k ? k_max : down.k;
  const size_t smem = sizeof(float) * smem_floats(k_max, TN);
  cudaError_t err = repro::allow_smem(mlp_tail_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, mlp_tail_kernel<T>, kThreads, smem);
  if (err != cudaSuccess) return err;
  int tiles = matmul_tiles(oproj);
  const int t2 = swiglu_tiles(gateup), t3 = matmul_tiles(down);
  tiles = tiles > t2 ? tiles : t2;
  tiles = tiles > t3 ? tiles : t3;
  int grid = per_sm * sms;
  grid = grid < tiles ? grid : tiles;
  if (grid < 1) grid = 1;  // nothing fits: let the launch report it
  MatmulArgs<T> a1 = oproj, a3 = down;
  SwigluArgs<T> a2 = gateup;
  void* args[] = {&a1, &a2, &a3, &k_max};
  err = cudaLaunchCooperativeKernel((const void*)mlp_tail_kernel<T>,
                                    dim3(grid), dim3(kThreads), args, smem,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T>
MatmulArgs<T> matmul_args(const void* a, const void* b, long long ldb,
                          const void* nw, void* out, int m, int n, int k,
                          float eps, int epilogue, const void* bias,
                          const void* pos, const void* freqs, int hd,
                          const void* res) {
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
  return p;
}

template <typename T>
SwigluArgs<T> swiglu_args(const void* x, const void* wg, const void* wu,
                          long long ldw, const void* nw, void* out, int m,
                          int f, int k, float eps) {
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
  return p;
}

}  // namespace

#define REPRO_FF_LAYER_ENTRIES(SUFFIX, T)                                     \
  extern "C" int ff_layer_matmul_##SUFFIX(                                    \
      const void* a, const void* b, long long ldb, const void* nw, void* out, \
      int m, int n, int k, float eps, int epilogue, const void* bias,         \
      const void* pos, const void* freqs, int hd, const void* res,            \
      void* stream) {                                                         \
    return launch_matmul(matmul_args<T>(a, b, ldb, nw, out, m, n, k, eps,     \
                                        epilogue, bias, pos, freqs, hd, res), \
                         stream);                                             \
  }                                                                           \
  extern "C" int ff_layer_swiglu_##SUFFIX(                                    \
      const void* x, const void* wg, const void* wu, long long ldw,           \
      const void* nw, void* out, int m, int f, int k, float eps,              \
      void* stream) {                                                         \
    return launch_swiglu(                                                     \
        swiglu_args<T>(x, wg, wu, ldw, nw, out, m, f, k, eps), stream);       \
  }                                                                           \
  extern "C" int ff_layer_mlp_tail_##SUFFIX(                                  \
      const void* a, const void* wo, long long ldwo, const void* x,           \
      const void* nw2, const void* wg, const void* wu, long long ldgu,        \
      const void* wo2, long long ldwo2, void* h, void* act, void* out, int m, \
      int hq, int d, int f, float eps, void* stream) {                        \
    return launch_tail(                                                       \
        matmul_args<T>(a, wo, ldwo, nullptr, h, m, d, hq, eps, kResidual,     \
                       nullptr, nullptr, nullptr, 0, x),                      \
        swiglu_args<T>(h, wg, wu, ldgu, nw2, act, m, f, d, eps),              \
        matmul_args<T>(act, wo2, ldwo2, nullptr, out, m, d, f, eps,           \
                       kResidual, nullptr, nullptr, nullptr, 0, h),           \
        stream);                                                              \
  }

REPRO_FF_LAYER_ENTRIES(f32, float)
REPRO_FF_LAYER_ENTRIES(bf16, __nv_bfloat16)
