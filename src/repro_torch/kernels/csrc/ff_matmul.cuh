// The tiled product shared by the library matmul, the MoE dispatch->expert
// launch (both in ff_matmul.cu) and the attention->projection launch
// (ff_attention_proj.cu).
//
// One block computes one BM x BN output tile: it walks k in slabs of kBK,
// stages each slab of A and B in shared memory as f32, and each thread
// accumulates kTM x kTN outputs in registers with fmaf. The next slab is
// loaded into registers while the current one is multiplied (a two-stage
// pipe: the copy of word g+1 overlaps the compute of word g).
//
// Reduction order: every output is one fmaf chain over k = 0, 1, ..., K-1
// from 0.f, whatever BM, BN and the block's place in the grid. So two
// launches that multiply the same operand values give the same bits, even
// when one of them reads A from shared memory and the other from HBM: this
// is what makes the fused launches equal their staged compositions. Ragged
// m, n and k are masked (out-of-range operands read as 0, out-of-range
// outputs are not stored), not padded in HBM.
#pragma once

#include "common.cuh"

namespace repro {
namespace mm {

constexpr int kTM = 4;    // output rows per thread
constexpr int kTN = 4;    // output columns per thread
constexpr int kBK = 16;   // k rows per shared-memory slab

// One slab of A (transposed: a[kk][r], padded against bank conflicts on
// the transposing stores) and of B.
template <int BM, int BN>
struct alignas(16) Slab {
  float a[kBK][BM + 4];
  float b[kBK][BN];
};

// acc += A[rows of this tile, :] @ B[:, n0:n0+BN], k = 0..K-1 in order.
// ``load_a(r, kk)`` returns A's element (tile row r, column kk) as f32,
// or 0 where r or kk is out of range; B is [K, N] with row stride ldb.
// Every thread of the block must call this; it begins and ends with the
// slab free for reuse.
template <int BM, int BN, int Threads, typename LoadA, typename TB>
__device__ __forceinline__ void product_tile(
    float (&acc)[kTM][kTN], Slab<BM, BN>& s, LoadA load_a,
    const TB* __restrict__ b, long long ldb, int k, int n0, int n) {
  static_assert((BM / kTM) * (BN / kTN) == Threads, "one thread per 4x4");
  static_assert((BM * kBK) % Threads == 0 && (BN * kBK) % Threads == 0,
                "whole slabs per thread");
  constexpr int kA = BM * kBK / Threads;   // A elements per thread per slab
  constexpr int kB = BN * kBK / Threads;   // B elements per thread per slab
  const int tid = threadIdx.x;
  const int ty = tid / (BN / kTN), tx = tid % (BN / kTN);
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  float ra[kA], rb[kB];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int u = 0; u < kA; ++u) {
      const int e = tid + u * Threads;
      const int r = e / kBK, kk = e % kBK;   // consecutive threads: along k
      ra[u] = load_a(r, k0 + kk);
    }
#pragma unroll
    for (int u = 0; u < kB; ++u) {
      const int e = tid + u * Threads;
      const int kk = e / BN, c = e % BN;     // consecutive threads: along n
      const bool ok = k0 + kk < k && n0 + c < n;
      rb[u] = ok ? to_f(b[(long long)(k0 + kk) * ldb + n0 + c]) : 0.f;
    }
  };

  const int slabs = (k + kBK - 1) / kBK;
  fetch(0);
  for (int t = 0; t < slabs; ++t) {
#pragma unroll
    for (int u = 0; u < kA; ++u) {
      const int e = tid + u * Threads;
      s.a[e % kBK][e / kBK] = ra[u];
    }
#pragma unroll
    for (int u = 0; u < kB; ++u) {
      const int e = tid + u * Threads;
      s.b[e / BN][e % BN] = rb[u];
    }
    __syncthreads();
    if (t + 1 < slabs) fetch((t + 1) * kBK);
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&s.a[kk][ty * kTM]);
      const float4 bv = *reinterpret_cast<const float4*>(&s.b[kk][tx * kTN]);
      const float a4[kTM] = {av.x, av.y, av.z, av.w};
      const float b4[kTN] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a4[i], b4[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// Store a thread's outputs of the tile whose row 0 is ``out`` (row stride
// ldo), rounded to TO; rows >= ``rows`` and columns >= n are dropped.
template <int BM, int BN, int Threads, typename TO>
__device__ __forceinline__ void store_tile(const float (&acc)[kTM][kTN],
                                           TO* __restrict__ out,
                                           long long ldo, int rows, int n0,
                                           int n) {
  const int tid = threadIdx.x;
  const int ty = tid / (BN / kTN), tx = tid % (BN / kTN);
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int r = ty * kTM + i;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int c = n0 + tx * kTN + j;
      if (c < n) out[(long long)r * ldo + c] = from_f<TO>(acc[i][j]);
    }
  }
}

}  // namespace mm
}  // namespace repro
