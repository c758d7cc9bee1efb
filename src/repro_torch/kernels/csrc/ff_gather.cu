// Row gather out[i, :] = table[idx[i], :] for the H100 (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ff_gather/kernel.py
// (build_program / gather_ff): the index stream scalar-prefetched, each
// pipe word a bundle of 8 * streams single-row DMAs. It serves the MoE
// combine, embedding-style lookups and the staged paged-decode baseline.
//
// Bound on this card: no arithmetic; every distinct indexed row is read
// once and every output row written once, so the least time is those bytes
// (plus the index) over 3.35 TB/s.
//
// Design: one block of 8 warps per bundle of 8 rows, one warp per row. The
// bundle's row indices are read once into shared memory; each warp then
// copies its row in units of 16 bytes where the row length and both base
// pointers allow it (else 8, 4 or 2 bytes), 32 units in flight per pass.
// The copy is an exact bit copy whatever the element type. The TPU wrapper
// padded n to its 8 * streams-row bundle; here the last bundle is ragged.
// Indices must lie in [0, R): the kernel does not check them (a device-side
// check would cost a host sync per call).

#include "common.cuh"

namespace {

constexpr int kRows = 8;                 // rows per block (one per warp)
constexpr int kThreads = 32 * kRows;

template <typename U>
__global__ void __launch_bounds__(kThreads)
    gather_kernel(const U* __restrict__ table, const int32_t* __restrict__ idx,
                  U* __restrict__ out, int n, long long units) {
  __shared__ int32_t rows[kRows];
  const int r0 = blockIdx.x * kRows;
  if (threadIdx.x < kRows && r0 + threadIdx.x < n)
    rows[threadIdx.x] = idx[r0 + threadIdx.x];
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (r0 + warp >= n) return;
  const U* src = table + (long long)rows[warp] * units;
  U* dst = out + (long long)(r0 + warp) * units;
#pragma unroll 4
  for (long long u = lane; u < units; u += 32) dst[u] = src[u];
}

template <typename U>
int launch(const void* table, const void* idx, void* out, int n,
           long long row_bytes, void* stream) {
  if (n == 0 || row_bytes == 0) return 0;
  gather_kernel<U><<<(n + kRows - 1) / kRows, kThreads, 0,
                     (cudaStream_t)stream>>>(
      static_cast<const U*>(table), static_cast<const int32_t*>(idx),
      static_cast<U*>(out), n, row_bytes / (long long)sizeof(U));
  return cudaGetLastError();
}

}  // namespace

// out[n, row_bytes] = table[idx[0:n], :] in copy units of ``unit`` bytes
// (16, 8, 4 or 2; row_bytes and both pointers must be multiples of it).
extern "C" int ff_gather(const void* table, const void* idx, void* out, int n,
                         long long row_bytes, int unit, void* stream) {
  switch (unit) {
    case 16: return launch<uint4>(table, idx, out, n, row_bytes, stream);
    case 8: return launch<uint2>(table, idx, out, n, row_bytes, stream);
    case 4: return launch<uint32_t>(table, idx, out, n, row_bytes, stream);
    case 2: return launch<uint16_t>(table, idx, out, n, row_bytes, stream);
    default: return cudaErrorInvalidValue;
  }
}
