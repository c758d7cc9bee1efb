// Tiled matmul C = A @ B for the H100 (sm_90a), with an optional row index
// on A: the library matmul and the MoE dispatch->expert launch.
//
// Replaces two TPU kernels:
//   * src/repro/kernels/ff_matmul/kernel.py build_program / matmul_ff:
//     C = A @ B, A [m,k] and B [k,n] each f32 or bf16, f32 accumulation,
//     k innermost, out dtype chosen by the caller (A's by default);
//   * the dispatch->expert edge of the moe_dispatch_ffn StreamGraph
//     (src/repro/models/moe.py build_moe_graph): the ff_gather producer
//     fused into the expert matmul's A stream, so the dispatched
//     [n_dispatch, d_model] buffer is never written to HBM.
//
// Bound on this card: 2*m*n*k operations over (m*k + k*n + m*n) elements
// moved. A square 4096 product in bf16 is bound by the tensor cores
// (989 TFLOP/s); this first kernel multiplies with f32 FMAs on the CUDA
// cores (67 TFLOP/s at most), and f32 operands stay f32 (no TF32). A
// dispatch of a few dozen rows is bound by streaming B once (3.35 TB/s),
// with few enough output tiles that most SMs idle.
//
// Design: one block of 256 threads per 64 x 64 output tile, the product
// body of ff_matmul.cuh (two-stage register pipe over k slabs of 16). The
// only difference between the two instantiations is how the block finds
// row r of A: m0 + r, or rows[m0 + r] read once into shared memory. A
// gathered row is an exact copy, so the Gather launch equals ff_gather
// followed by the plain launch bit for bit. The TPU wrapper padded m, n
// and k to its 128 blocks in HBM; here the ragged edges are masked.

#include "ff_matmul.cuh"

namespace {

constexpr int kBM = 64, kBN = 64, kThreads = 256;

template <typename TA, typename TB, typename TO, bool Gather>
__global__ void __launch_bounds__(kThreads)
    matmul_kernel(const TA* __restrict__ a, const TB* __restrict__ b,
                  const int32_t* __restrict__ rows, TO* __restrict__ c,
                  int m, int n, int k, long long lda, long long ldb,
                  long long ldc) {
  __shared__ repro::mm::Slab<kBM, kBN> slab;
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
  float acc[repro::mm::kTM][repro::mm::kTN];
  repro::mm::product_tile<kBM, kBN, kThreads>(acc, slab, load_a, b, ldb, k,
                                              n0, n);
  repro::mm::store_tile<kBM, kBN, kThreads>(acc, c + (long long)m0 * ldc, ldc,
                                            live, n0, n);
}

template <typename TA, typename TB, typename TO, bool Gather>
int launch(const void* a, const void* b, const void* rows, void* c, int m,
           int n, int k, long long lda, long long ldb, long long ldc,
           void* stream) {
  if (m == 0 || n == 0) return 0;
  dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  matmul_kernel<TA, TB, TO, Gather><<<grid, kThreads, 0,
                                      (cudaStream_t)stream>>>(
      static_cast<const TA*>(a), static_cast<const TB*>(b),
      static_cast<const int32_t*>(rows), static_cast<TO*>(c), m, n, k, lda,
      ldb, ldc);
  return cudaGetLastError();
}

}  // namespace

// ff_matmul_<A>_<B>_<out>: c[m,n] = a[m,k] @ b[k,n] for every type triple;
// ff_matmul_gather_<T>: c[m,n] = a[rows[0:m], :] @ b[k,n], all of type T
// (the MoE dispatch's tokens, weight and output share one type).
// Operands have unit column stride and the given row strides.
#define REPRO_MATMUL_ENTRY(SA, TA, SB, TB, SO, TO)                           \
  extern "C" int ff_matmul_##SA##_##SB##_##SO(                                \
      const void* a, const void* b, void* c, int m, int n, int k,             \
      long long lda, long long ldb, long long ldc, void* stream) {            \
    return launch<TA, TB, TO, false>(a, b, nullptr, c, m, n, k, lda, ldb,     \
                                     ldc, stream);                            \
  }

#define REPRO_MATMUL_OUTS(SA, TA, SB, TB)                \
  REPRO_MATMUL_ENTRY(SA, TA, SB, TB, f32, float)         \
  REPRO_MATMUL_ENTRY(SA, TA, SB, TB, bf16, __nv_bfloat16)

REPRO_MATMUL_OUTS(f32, float, f32, float)
REPRO_MATMUL_OUTS(f32, float, bf16, __nv_bfloat16)
REPRO_MATMUL_OUTS(bf16, __nv_bfloat16, f32, float)
REPRO_MATMUL_OUTS(bf16, __nv_bfloat16, bf16, __nv_bfloat16)

#define REPRO_MATMUL_GATHER_ENTRY(S, T)                                      \
  extern "C" int ff_matmul_gather_##S(                                        \
      const void* a, const void* rows, const void* b, void* c, int m, int n,  \
      int k, long long lda, long long ldb, long long ldc, void* stream) {     \
    return launch<T, T, T, true>(a, b, rows, c, m, n, k, lda, ldb, ldc,       \
                                 stream);                                     \
  }

REPRO_MATMUL_GATHER_ENTRY(f32, float)
REPRO_MATMUL_GATHER_ENTRY(bf16, __nv_bfloat16)
