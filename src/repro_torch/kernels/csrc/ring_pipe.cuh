// The ring pipe on Hopper: the port of the reference's RingPipe and
// GatherRingPipe (src/repro/core/emitter.py, lowered by
// src/repro/core/program.py compile_program), the VMEM ring of ``depth``
// words fed by async DMAs that joins a kernel's memory stage to its
// compute stage.
//
// Here the ring is ``depth`` stages of dynamic shared memory, each with a
// ``full`` and an ``empty`` mbarrier. One producer warp waits on
// empty[s], then fills stage s and arrives on full[s]; the consumers wait
// on full[s], compute, and arrive on empty[s]. Word g lives in stage
// g % depth, in phase (g / depth) & 1, so the producer runs up to
// ``depth`` words ahead of the consumers. At depth 1 it cannot fetch word
// g+1 before word g is released: the synchronous copy-then-compute
// baseline of the reference's Pipe (src/repro/core/pipe.py).
//
// A stage is filled by up to three kinds of copies, all completing on
// full[s]:
//   * TMA boxes (cp.async.bulk.tensor, one elected lane, counted by
//     mbarrier.arrive.expect_tx): a tile whose base is 16-byte aligned and
//     whose row stride is a multiple of 16 bytes. ``streams`` splits each
//     tile copy into that many boxes of rows/streams rows;
//   * per-row cp.async of 16 bytes with zero fill (every lane, tracked by
//     cp.async.mbarrier.arrive.noinc): the rows of a gathered tile, which
//     TMA cannot address, when they are 16-byte aligned;
//   * element loads and shared-memory stores (every lane, then a proxy
//     fence and mbarrier.arrive): anything else (row strides that are not
//     a multiple of 16 bytes, such as k = 70 in bf16).
// So full[s] expects 1 + 2 * 32 arrivals a phase (the elected lane's
// expect_tx, and from every lane one cp.async-tracked and one plain
// arrival), whatever mix of copies the stage took, plus the TMA bytes.
//
// Whatever the copy, a stage ends up holding the same bytes: the tile's
// elements in the swizzled layout below, zeros past the tensor's edges.
// So what the consumers compute does not depend on depth, streams or the
// copy path (the bit-for-bit contract of ff_matmul.cuh). The ring bounds
// nothing itself: it has to hide each stage's copy latency behind the
// compute of the stages before it, and its users' notes give their
// bounds. The bf16 bodies' tiles use the swizzled layout and maps below;
// the f32 bodies of ff_matmul and ff_attention (ff_matmul.cuh,
// ff_attention.cuh) take the same layout in rows of 32 floats where their
// CUDA-core consumers would otherwise conflict on banks, and row-major
// boxes (encode_typed) where they would not. ff_chunk_scan.cu takes only
// the barriers, Slot and cp.async and lays its stages out itself (f32 rows
// among them); so do ff_decode_attention.cu and ff_gather.cu (gathered
// rows of any type).
//
// Tiles are stored as the 128-byte swizzle that TMA's SWIZZLE_128B writes
// and wgmma's 128B layout reads: a tile of rows of 128 bytes (64 bf16 or
// 32 f32), where the 16-byte chunk c of row r sits at chunk c ^ (r % 8),
// in 1024-byte aligned atoms of 8 rows; a box of such a tile is at least
// one atom (8 rows).
#pragma once

#include <cuda.h>

#include "common.cuh"

namespace repro {
namespace ring {

constexpr int kProducerLanes = 32;
constexpr int kFullArrivals = 1 + 2 * kProducerLanes;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// Make the barriers' initialisation visible to the async proxy (TMA).
__device__ __forceinline__ void fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// Order this thread's generic-proxy shared-memory accesses before later
// async-proxy ones (wgmma reading a tile written by st.shared/cp.async).
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void arrive_expect_tx(uint64_t* bar,
                                                 uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// One arrival on ``bar`` once every cp.async this thread issued so far
// has landed (the barrier's expected count already includes it).
__device__ __forceinline__ void arrive_cp_async(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// 2-D TMA box: columns from c0, rows from r0 of the tensor map, into
// ``dst``; completes ``bytes`` (the full box) on ``bar``. Out-of-range
// elements arrive as zeros.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int r0) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(r0)
      : "memory");
}

// 3-D TMA box: columns from c0, rows from r0, of slice z (a head) of the
// tensor map; rows past the slice's end arrive as zeros, never the next
// slice's.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int r0,
                                            int z) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(r0), "r"(z)
      : "memory");
}

// 16 bytes from ``src`` into ``dst``, of which the first ``src_bytes``
// (0..16) are read and the rest filled with zeros.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// Close this thread's cp.async copies into a group / wait for all of them.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// Byte offset of bf16 element (r, c), c < 64, in a 128-byte swizzled tile.
__host__ __device__ __forceinline__ uint32_t sw128(int r, int c) {
  return r * 128 + ((((c >> 3) ^ r) & 7) << 4) + ((c & 7) << 1);
}

// Byte offset of f32 element (r, c), c < 32, in a 128-byte swizzled tile
// (rows of 32 floats: the 4-float chunk c / 4 of row r at c / 4 ^ r % 8).
__host__ __device__ __forceinline__ uint32_t sw128_f32(int r, int c) {
  return r * 128 + ((((c >> 2) ^ r) & 7) << 4) + ((c & 3) << 2);
}

// Word g of a ring of ``depth`` stages: its stage and mbarrier phase.
struct Slot {
  int stage;
  uint32_t phase;
  __device__ __forceinline__ Slot(int g, int depth)
      : stage(g % depth), phase((g / depth) & 1) {}
};

// ---------------------------------------------------------------------------
// Host side: tensor maps for the TMA copies. cuTensorMapEncodeTiled lives
// in libcuda, not in the runtime; it is found through the runtime's
// entry-point query, so nothing links against libcuda. Maps are encoded on
// every call.
// ---------------------------------------------------------------------------

using EncodeTiled = decltype(&cuTensorMapEncodeTiled);

inline EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q);
#endif
    if (err != cudaSuccess || q != cudaDriverEntryPointSuccess)
      f = nullptr;
    return reinterpret_cast<EncodeTiled>(f);
  }();
  return fn;
}

// TMA can describe a tensor of ``elem``-byte elements with this base and
// row stride (elements).
inline bool tma_ok_bytes(const void* p, long long ld, int elem) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && (ld * elem) % 16 == 0;
}
inline bool tma_ok(const void* p, long long ld) {   // bf16
  return tma_ok_bytes(p, ld, 2);
}

inline CUtensorMapDataType tma_type(int elem) {
  return elem == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                   : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}

// A [rows, cols] tensor of f32 (elem 4) or bf16 (elem 2) with row stride
// ld, read in boxes of box_cols x box_rows, zeros past the edges; with
// ``swizzle`` in the 128-byte swizzle (box_cols * elem must be 128), else
// row-major as it lies in memory.
inline bool encode_typed(CUtensorMap* map, int elem, const void* base,
                         int cols, int rows, long long ld, int box_cols,
                         int box_rows, bool swizzle) {
  EncodeTiled fn = encoder();
  if (!fn) return false;
  cuuint64_t dims[2] = {cuuint64_t(cols), cuuint64_t(rows)};
  cuuint64_t strides[1] = {cuuint64_t(ld) * elem};
  cuuint32_t box[2] = {cuuint32_t(box_cols), cuuint32_t(box_rows)};
  cuuint32_t unit[2] = {1, 1};
  return fn(map, tma_type(elem), 2, const_cast<void*>(base), dims, strides,
            box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A [rows, cols] bf16 tensor with row stride ld, read in 128-byte swizzled
// boxes of 64 columns by box_rows rows, zeros past the edges.
inline bool encode(CUtensorMap* map, const void* base, int cols, int rows,
                   long long ld, int box_rows) {
  return encode_typed(map, 2, base, cols, rows, ld, 64, box_rows, true);
}

// A contiguous [slices, rows, cols] tensor of f32 (elem 4) or bf16 (elem
// 2) (attention's heads), read in 128-byte swizzled boxes of 128 bytes of
// columns by box_rows rows of one slice, zeros past each slice's rows and
// past the columns.
inline bool encode_3d_typed(CUtensorMap* map, int elem, const void* base,
                            int cols, int rows, int slices, int box_rows) {
  EncodeTiled fn = encoder();
  if (!fn) return false;
  cuuint64_t dims[3] = {cuuint64_t(cols), cuuint64_t(rows),
                        cuuint64_t(slices)};
  cuuint64_t strides[2] = {cuuint64_t(cols) * elem,
                           cuuint64_t(cols) * elem * cuuint64_t(rows)};
  cuuint32_t box[3] = {cuuint32_t(128 / elem), cuuint32_t(box_rows), 1};
  cuuint32_t unit[3] = {1, 1, 1};
  return fn(map, tma_type(elem), 3, const_cast<void*>(base), dims, strides,
            box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}
inline bool encode_3d(CUtensorMap* map, const void* base, int cols, int rows,
                      int slices, int box_rows) {   // bf16
  return encode_3d_typed(map, 2, base, cols, rows, slices, box_rows);
}

}  // namespace ring
}  // namespace repro
