// The tiled products shared by the library matmul, the MoE dispatch->
// expert launch (both in ff_matmul.cu) and the attention->projection
// launch (ff_attention_proj.cu): the consumer stage of the reference's
// ff_matmul (src/repro/kernels/ff_matmul/kernel.py build_program, an MXU
// dot over the landed A and B tiles accumulating in f32). On this card a
// bf16 product is bound by the tensor cores (989 TFLOP/s) once it does
// more than about 295 operations a byte moved, else by HBM (3.35 TB/s);
// ff_matmul.cu's note gives the bound of each shape it serves. The body
// sees one landed slab at a time: how many slabs are in flight (``depth``)
// and how each tile copy is split (``streams``) belong to the ring that
// feeds it (ring_pipe.cuh) and change when a slab lands, never what is
// summed. Two bodies, chosen by the operand types:
//
// * bf16 x bf16 (either output type): the tensor cores. A consumer
//   warpgroup multiplies a 64-row A tile by a 128-column B tile with
//   wgmma.mma_async m64n128k16, both operands in 128-byte-swizzled shared
//   memory (ring_pipe.cuh), walking k in slabs of kWgK = 64 (four k16
//   steps a slab) and accumulating in f32 registers. The only instruction
//   shape is m64n128k16, in every kernel that uses this body.
// * f32 x f32 and the mixed f32/bf16 pairs: the CUDA cores (no TF32, as
//   the library matmul promises), fma_slab below. Each thread holds 8 x 8
//   outputs in registers and walks the landed slab (each operand in its
//   own type) 4 k at a time: its 8 rows of A as 16-byte runs along k, then
//   for each of the 4 k its 8 columns of B, 64 fmaf. The library matmul
//   feeds it from the same kind of ring as the tensor cores (ff_matmul.cu
//   fma_ring_kernel); the attention->projection launch from slabs it
//   stages itself.
//
// Reduction order, and with it the bit-for-bit contract between a fused
// launch and its staged composition:
// * bf16: every output is one chain of wgmma k16 steps over k in order
//   from 0.f, through whole slabs of 64 (a ragged k's tail and anything
//   past it multiply zeros); where a launch splits k, each split is such
//   a chain over its slabs and the splits' partials are summed in split
//   order 0, 1, 2, ... by a second launch. The split depends on (m, n, k)
//   and the types alone (ops.py _plan). So the result does not depend on
//   the tile's place in the grid, on the ring's depth or streams, or on
//   whether A arrived by TMA, by cp.async, by element loads or through a
//   row index.
// * f32 and mixed: every output is one fmaf chain over k = 0, 1, ..., K-1
//   from 0.f (then k past K, where both operands are 0), whatever the
//   tile, the slab depth, the ring and the block's place in the grid.
// Either way two launches that multiply the same operand values give the
// same bits, even when one reads A from shared memory and the other from
// HBM: that makes the fused launches equal their staged compositions.
// Ragged m, n and k are masked (operands past the edge read as 0, outputs
// past it are not stored), not padded in HBM.
#pragma once

#include "common.cuh"
#include "ring_pipe.cuh"

namespace repro {
namespace mm {

// ---------------------------------------------------------------------------
// f32 and mixed pairs on the CUDA cores
// ---------------------------------------------------------------------------

// A thread's outputs: kR rows (the caller's) by kC columns of a tile
// 16 kC columns wide, columns 4 tn .. 4 tn + 3 (and, at kC = 8, 64 + 4 tn
// .. 64 + 4 tn + 3) for tn = lane % 16, so that a half warp reads one
// 256-byte run of a B row. 8 x 8 is the library matmul's and the
// projection's tile; 4 x 4 the matmul's tile for grids too small to fill
// the card.
constexpr int kFmaRows = 8;
constexpr int kFmaCols = 8;

__device__ __forceinline__ float lane_of(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// acc[i][j] += A[row i][k] * B[k][column j] for k = 0 .. 4 * kChunks - 1
// of the landed slab, in order, one fmaf each. ``a4(i, kc)`` returns the
// thread's row i at k = 4 kc .. 4 kc + 3 as a float4 (one 16-byte shared
// load in f32, 8 bytes in bf16); ``b8(k, b)`` fills b with row k of B at
// the thread's kC columns. A's chunks are read once for 4 k steps, B's
// row once for the kR rows: at 8 x 8, 64 fmaf for every 4 shared loads.
template <int kChunks, int kR, int kC, typename A4, typename B8>
__device__ __forceinline__ void fma_slab(float (&acc)[kR][kC], A4 a4,
                                         B8 b8) {
#pragma unroll
  for (int kc = 0; kc < kChunks; ++kc) {
    float4 a[kR];
#pragma unroll
    for (int i = 0; i < kR; ++i) a[i] = a4(i, kc);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float b[kC];
      b8(4 * kc + kk, b);
#pragma unroll
      for (int i = 0; i < kR; ++i) {
        const float x = lane_of(a[i], kk);
#pragma unroll
        for (int j = 0; j < kC; ++j) acc[i][j] = fmaf(x, b[j], acc[i][j]);
      }
    }
  }
}

// Four elements of a shared-memory row as floats: one 16-byte load in f32,
// one 8-byte load in bf16.
__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 lds4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  const float2 a = __bfloat1622float2(lo), b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}

// Store a thread's kR x kC outputs: row i at ``rows_out[i]`` (null: past
// the edge), columns n0 + 4 tn + j (and n0 + 64 + 4 tn + j), rounded to
// TO, columns >= n dropped; four at once where ``vec`` (the row stride and
// the base keep 4 elements aligned).
template <typename TO, int kR, int kC>
__device__ __forceinline__ void store_fma(const float (&acc)[kR][kC],
                                          TO* const* rows_out, int tn,
                                          int n0, int n, bool vec) {
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    if (!rows_out[i]) continue;
#pragma unroll
    for (int h = 0; h < kC / 4; ++h) {
      const int c = n0 + 64 * h + 4 * tn;
      TO* p = rows_out[i] + c;
      const float* x = &acc[i][4 * h];
      if (vec && c + 4 <= n) {
        if constexpr (sizeof(TO) == 4) {
          *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
        } else {
          __nv_bfloat162 v[2] = {__floats2bfloat162_rn(x[0], x[1]),
                                 __floats2bfloat162_rn(x[2], x[3])};
          *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(v);
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c + j < n) p[j] = from_f<TO>(x[j]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 x bf16 on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kWgM = 64;     // A rows per consumer warpgroup
constexpr int kWgN = 128;    // B columns per wgmma (the one N width)
constexpr int kWgK = 64;     // k per slab: one 128-byte swizzled row
constexpr int kWgAcc = 64;   // f32 accumulators per thread (64 x 128 / 128)
constexpr int kASlab = kWgM * kWgK * 2;    // bytes of a 64 x 64 A slab
constexpr int kBHalf = kWgK * 64 * 2;      // bytes of a 64 k x 64 n half
constexpr int kBSlab = 2 * kBHalf;         // bytes of a 64 x 128 B slab

// wgmma shared-memory descriptor, 128-byte swizzle; offsets in bytes.
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr, uint32_t lbo,
                                            uint32_t sbo) {
  return uint64_t((addr & 0x3FFFF) >> 4) |
         (uint64_t((lbo >> 4) & 0x3FFF) << 16) |
         (uint64_t((sbo >> 4) & 0x3FFF) << 32) | (uint64_t(1) << 62);
}

// d += A (K-major) @ B (MN-major, imm-trans-b), m64n128k16, bf16 in, f32.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[kWgAcc],
                                                 uint64_t desc_a,
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// Wait until at most N committed groups are in flight; the accumulators
// are then tied to this point, so nothing reads them earlier.
template <int N>
__device__ __forceinline__ void wg_wait(float (&d)[kWgAcc]) {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
#pragma unroll
  for (int i = 0; i < kWgAcc; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Issue one slab: d += A_slab @ B_slab as four k16 steps in k order. A is
// a 64 x 64 K-major swizzled tile at shared address ``a`` (8-row groups
// 1024 bytes apart; a k16 step moves 32 bytes along the row); B is two
// 64 k x 64 n swizzled halves at ``b`` and ``b`` + kBHalf (8-row groups
// 1024 bytes apart, the halves kBHalf apart; a k16 step moves 16 rows).
// Call between wg_fence() and wg_commit().
__device__ __forceinline__ void mma_slab(float (&d)[kWgAcc], uint32_t a,
                                         uint32_t b) {
#pragma unroll
  for (int j = 0; j < kWgK / 16; ++j)
    wgmma_m64n128k16(d, wg_desc(a + 32 * j, 16, 1024),
                     wg_desc(b + 2048 * j, kBHalf, 1024));
}

// Row and column (in the warpgroup's 64 x 128 tile) of accumulator j of
// thread t (0..127 of the warpgroup).
__device__ __forceinline__ int frag_row(int t, int j) {
  return (t >> 5) * 16 + ((t & 31) >> 2) + ((j >> 1) & 1) * 8;
}
__device__ __forceinline__ int frag_col(int t, int j) {
  return (j >> 2) * 8 + (t & 3) * 2 + (j & 1);
}

// Store a warpgroup's 64 x 128 accumulators to ``out`` (row stride ldo),
// rounded to TO; rows >= ``rows`` and columns >= ``cols`` are dropped.
// Adjacent column pairs go out as one store where ldo is even.
template <typename TO>
__device__ __forceinline__ void store_frag(const float (&d)[kWgAcc],
                                           TO* __restrict__ out,
                                           long long ldo, int rows,
                                           int cols) {
  const int t = threadIdx.x & 127;
  const bool pairs = (ldo & 1) == 0;
#pragma unroll
  for (int j = 0; j < kWgAcc; j += 2) {
    const int r = frag_row(t, j), c = frag_col(t, j);
    if (r >= rows || c >= cols) continue;
    TO* p = out + (long long)r * ldo + c;
    if (pairs && c + 1 < cols) {
      if constexpr (sizeof(TO) == 4) {
        *reinterpret_cast<float2*>(p) = make_float2(d[j], d[j + 1]);
      } else {
        *reinterpret_cast<__nv_bfloat162*>(p) =
            __floats2bfloat162_rn(d[j], d[j + 1]);
      }
    } else {
      p[0] = from_f<TO>(d[j]);
      if (c + 1 < cols) p[1] = from_f<TO>(d[j + 1]);
    }
  }
}

}  // namespace mm
}  // namespace repro
