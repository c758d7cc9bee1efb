// Gated linear-attention scan (Mamba2 inclusive / RWKV6 exclusive with the
// bonus u) for the H100 (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ff_chunk_scan/kernel.py
// (build_program / _chunk_body / chunk_scan_ff): per bh row the recurrence
//   h_t = diag(exp(lw_t)) h_{t-1} + k_t (x) v_t
//   inclusive: y_t = q_t . h_t
//   exclusive: y_t = q_t . (h_{t-1} + diag(u) k_t (x) v_t)
// with the [N,P] state carried in f32. On the TPU the grid walked (bh,
// chunk) words in order, four pipes streaming the q, k, v and log_w tiles,
// and kept the state in VMEM scratch across grid steps; blocks here run in
// no order, so a block owns a bh row (and a slice of P's columns) and
// walks the row's rows in a loop, the state on chip. Both bodies stream the
// row 16 rows at a time (a word: q, k and log_w [16, N], v [16, cols])
// through a ring_pipe.cuh ring of ``depth`` shared-memory stages filled by
// one producer warp, each stage in ``streams`` parts of its rows issued in
// turn and completing on the stage's full mbarrier; rows past S arrive as
// zeros, as the reference's padding gives. At depth 1 the producer cannot
// fetch a word before the last one is released: the synchronous
// copy-then-compute baseline. The kernels take the ring's mbarriers, Slot
// and cp.async from ring_pipe.cuh and lay their stages out themselves, so
// each stream arrives in its own type and the ring's other users are
// untouched. Neither body's arithmetic depends on depth or streams: the
// same bits at every setting.
//
// Numerics (the reference's decay-to-boundary factorization, kept so that
// every decay factor is e^x with x <= 0 and a strong decay underflows to 0
// instead of overflowing): with cw the cumsum of lw from a boundary b and
// cq = cw (inclusive) or cw - lw (exclusive),
//   carried state:  (q_l e^{cq_l}) . h_b
//   earlier rows s: q_l e^{cq_l - cw_s} . k_s, masked s <= l (inclusive)
//                   or s < l (exclusive)
//   bonus:          (sum_n q_l u k_l) v_l
//   state update:   h_e = e^{cw_e} h_b + sum_s (k_s e^{cw_e - cw_s}) v_s
//
// Bound on this card: each input element is read once and each output
// written once, bh*s*(3n+2p) elements; the work is about 2*N*P*2 operations
// a row (the carried state's product and the update), so bf16 at N = P =
// 64 is bound by bytes (42 MB at rwkv6-7b's 4 x 256 tokens, about 12.5 us
// at the data sheet's 3.35 TB/s) and f32 at N = P = 256 by the 67 TFLOP/s
// of f32 outside the tensor cores. ops.py picks a body from the types and
// shapes alone:
//
// ring_scan_kernel (q, k and v bfloat16, N in {16, 32, 64, 128}, P a
// multiple of 16, chunk a multiple of 16, subtile 16): the tensor-core
// body. One block per (bh row, slice of P's columns, ops.py _plan), four
// consumer warps for 64 columns (one warp per 16) and one producer warp
// copying by 16-byte cp.async with zero fill past S. Its stages: rows
// padded by 16 bytes, not the bf16 swizzle of the TMA users, log_w in its
// own type (f32 for Mamba2, bf16 for RWKV6). Per word the consumers
//   A  carry the chunk's cumsum over the 16 rows (in log2 units, one thread
//      a column; two roles of N threads each recompute it, so the cumsum
//      and every exponent after it is the same value in both) and write q
//      decayed from the boundary (qi), from the chunk start (qd = qi
//      e^{cw_b}) and k decayed to the subtile's end (ke) as bf16 tiles;
//   B  take the diagonal subtile's scores with exact pairwise exponents,
//      one thread for each of the 120 pairs below the diagonal (no masked
//      pair is computed, so none needs the clamp), eight more for the
//      diagonal itself (exponent 0, a dot product) or, exclusive, the
//      bonus; rounded to bf16;
//   C  per warp, its 16 columns on the tensor cores (mma.sync m16n8k16,
//      bf16 in, f32 accumulate): y = qd . h + qi . z + D . v (+ bonus), the
//      carried and the chunk's terms in two accumulator chains, then
//      z = e^{cw_e - cw_b} z + ke^T . v.
// z is the chunk's state at the subtile boundary (the sum over earlier
// subtiles of k_s e^{cw_b - cw_s} (x) v_s), so qi . z is the reference's
// earlier-subtile scores times v with the sum over s taken before the
// product over n: the same terms, the same exponents, no per-pair work.
// At a chunk's end h = e^{cw_last} h + z and z = 0. z lives in the
// consumer warps' registers in the accumulator layout, transposed (the
// warp's 16 columns by N), so that it feeds the next product as a B
// operand without a trip through shared memory; h, which changes once a
// chunk, is kept in f32 in shared memory in the same per-lane layout and
// as bf16 B operands in registers. Neither reaches device memory. The
// derived tiles are double-buffered by word, so a word takes two consumer
// barriers. The consumers' work is latency-bound (a word's three passes
// follow one another in a block), so the SM count and the blocks an SM
// holds set the time: _plan keeps a row's work in one block (splitting P
// repeats passes A and B in every slice, and measured slower), and the
// register cap below lets three blocks share an SM. Rounding: the
// decayed operands (qd, qi, ke), the diagonal scores and h and z as
// operands are rounded to bf16 once for their product; cumsums,
// exponents, sums and the carried h and z are f32.
// Exponents use ex2.approx on log2-scaled cumsums (relative error ~2^-22,
// under bf16's 2^-9).
//
// f32_ring_scan_kernel (every other call: f32 or mixed streams, any N up to
// what shared memory holds, any P, chunk and subtile): the CUDA-core body,
// f32 arithmetic throughout (fmaf, no bf16 or TF32 rounding). One block per
// (bh row, slice of at most 32 of P's columns, ops.py _f32_plan): W
// consumer warps and one producer warp. Each stream arrives in its own
// type: by 16-byte cp.async where its base and row stride are 16-byte
// aligned, else (an odd N or P) by element loads and shared-memory stores.
// The state is carried at every 4-row boundary of a word (the reference's
// factorization with 4-row chunks): the chunk and subtile the caller
// names change only the reference's order of summation, and this body
// takes any of them with the same bits. The decay of a row is a_t =
// e^{min(lw_t, 0)} (one ex2.approx an element of log_w) and every factor of
// the factorization is a product of such a's (each <= 1): over a block of
// rows b..e, qd_l = q_l a_b..a_l (inclusive; a_b..a_{l-1} exclusive), ke_s
// = k_s a_{s+1}..a_e, sd = a_b..a_e, and the pair factor of (l, s) the a's
// between them. No pairwise exponent is taken, and no earlier word is
// read again. Per word the consumers
//   AB one thread a state row n (looping where N > 32 W): loads its column
//      of q, k and log_w, takes the 16 decays, writes qd, ke [16, N], sd
//      [4, N] and the word's correction cr [N] (below) to shared memory in
//      f32, and sums for each 4-row block
//      the 10 pair scores (s <= l: inclusive q_l . k_s with the factor
//      between them, exclusive s < l and the bonus q_l u k_l on the
//      diagonal) over its rows; the 40 sums are reduced over the warp by
//      butterflies of 16 (16 shuffles each) and left per warp in shared
//      memory;
//   C1 a thread carries the state's rows [n0, n0 + NT) of 4 columns in
//      registers (NT = 1..16 from N, a template parameter): the 8 lanes of
//      a quarter-warp share their rows (so their loads of qd, ke and sd
//      broadcast) and split the 32 columns, the warp's 4 quarters and the
//      W warps split the rows. For each 4-row block a thread adds its
//      partial outputs qd_l . h over its rows for its 4 columns (16 values,
//      each loaded value used 4 times), sums them over the warp's quarters
//      by two butterfly folds and stores its row of them per warp; then
//      h = sd h + sum_s ke_s v_s; after the word's four blocks h = h + cr
//      h. 40 threads sum the pair scores over the warps;
//   C2 every output is the sum of the W partials in warp order, then its
//      block's pair scores times v in row order, stored in q's type.
// The correction: sd, a product of four rounded ex2's, is off e^{sum lw}
// by up to a few ulp, the same few for the same decays; carried from block
// to block that error would grow with the rows a state remembers (S/4
// roundings at a decay near 1, constant over time: past the f32 tolerance
// at S = 4096, lw = -1e-4). So AB also takes cr = X - ln(sd_0 sd_1 sd_2
// sd_3), X the sum of the word's 16 clamped log_w, the log by
// log1pf of the product less one (built as q + s + q s from s = sd - 1,
// exact while sd >= 1/2, so no rounding near 1 swamps it), and C1 scales
// the state by 1 + cr once a word: the carried decay is then e^X to 2e-9
// a word, whatever S. cr is 0 where the word decays below 1/2: the state
// forgets half of itself each word there, and the roundings cannot build
// up. A row of the word's own contributions takes that word's few ulp
// once.
// The sums' order is fixed by the block's shape alone. A word takes two
// consumer barriers (after AB and after C1): AB of the next word writes
// only what C1 has finished reading. The state never leaves the chip.
// With a non-null ``clocks`` thread 0 adds the clock64 cycles it spends
// waiting on the full barrier and in AB, C1 and C2 into four counters a
// block (the passes' times apart; ops.py passes null).

#include "ring_pipe.cuh"

namespace {

using bf16 = __nv_bfloat16;

// ``types`` bits: the stream is bfloat16 (else float32)
enum : int { kQBf16 = 1, kKBf16 = 2, kVBf16 = 4, kWBf16 = 8, kUBf16 = 16 };

// ===========================================================================
// The tensor-core ring body
// ===========================================================================

constexpr int kRows = 16;        // rows of a ring word: one subtile
constexpr int kMaxWarps = 8;     // consumer warps, 16 columns each
constexpr int kDStride = 24;     // bf16 row stride of the diagonal scores
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Two f32 as one register of two bf16 (lo in the low half), rounded to
// nearest even.
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void ldsm(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(repro::ring::smem_addr(p)));
}

__device__ __forceinline__ void ldsm_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(repro::ring::smem_addr(p)));
}

// d += a (16 x 16, row) . b (16 x 8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void consumer_sync(int threads) {
  asm volatile("bar.sync 1, %0;" ::"r"(threads) : "memory");
}

// Byte offsets of the ring body's shared memory (mirrored by
// ops.py:ring_smem_bytes). A stage: q and k [16, N+8] bf16, v [16, cols+8]
// bf16, log_w [16, N+4] f32 or [16, N+8] bf16. A derived buffer (two, by
// word parity): qd, qi, ke [16, N+8] bf16, the cumsum [17, N+4] f32 (row
// 0 the value before the word), the diagonal scores [16, 24] bf16, the
// bonus [16] f32, the subtile's decay and the chunk's decay [N] f32. Then
// u [N], the cumsum carried between words [2, N], the carried state h in
// f32 (each consumer lane's accumulator fragments, [warps, N/8, 32, 4]),
// the full and empty mbarriers. The pads make ldmatrix rows and the
// diagonal's row-strided reads fall in distinct banks.
template <int N, typename LW>
struct Layout {
  static constexpr int NS = N + 8;
  static constexpr int CS = N + 4;
  static constexpr int WS = sizeof(LW) == 4 ? N + 4 : N + 8;
  int cols, vs, stage, o_k, o_v, o_w, buf, b_qi, b_ke, b_cw, b_d, b_cu,
      b_sd, b_hd;
  __host__ __device__ explicit Layout(int cols_) {
    cols = cols_;
    vs = cols + 8;
    o_k = kRows * NS * 2;
    o_v = 2 * o_k;
    o_w = o_v + kRows * vs * 2;
    stage = o_w + kRows * WS * int(sizeof(LW));
    b_qi = kRows * NS * 2;
    b_ke = 2 * b_qi;
    b_cw = 3 * b_qi;
    b_d = b_cw + (kRows + 1) * CS * 4;
    b_cu = b_d + kRows * kDStride * 2;
    b_sd = b_cu + kRows * 4;
    b_hd = b_sd + N * 4;
    buf = b_hd + N * 4;
  }
  __host__ __device__ size_t bytes(int depth) const {
    return size_t(depth) * stage + 2 * size_t(buf) + 3 * N * 4 +
           size_t(cols) / 16 * N * 64 + 16 * size_t(depth);
  }
};

// At most 128 registers a thread for N <= 64: the register file is split
// over the SM's four schedulers, 16K registers each, so three blocks of
// five warps (zamba2-2.7b's 320 rows on 132 SMs in one wave) need four
// warps of 128 to fit one scheduler. N = 128 takes 168, one block an SM.
template <int N, typename LW>
__global__ void __maxnreg__(N <= 64 ? 128 : 168)
    ring_scan_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const LW* __restrict__ w,
                     const void* __restrict__ u, int u16,
                     bf16* __restrict__ out, int s, int p, int chunk,
                     int inclusive, int depth, int streams) {
  using Lay = Layout<N, LW>;
  constexpr int NS = Lay::NS, CS = Lay::CS, WS = Lay::WS;
  extern __shared__ __align__(16) unsigned char ring_smem[];
  const int warps = blockDim.x / 32 - 1, cols = 16 * warps,
            nc = 32 * warps;
  const Lay lay(cols);
  unsigned char* stages = ring_smem;
  unsigned char* bufs = stages + size_t(depth) * lay.stage;
  float* us = reinterpret_cast<float*>(bufs + 2 * size_t(lay.buf));
  float* carry = us + N;
  float* hcs = carry + 2 * N;
  uint64_t* full = reinterpret_cast<uint64_t*>(hcs + warps * N * 16);
  uint64_t* empty = full + depth;
  const int tid = threadIdx.x;
  const long long row = blockIdx.x;
  const int p0 = blockIdx.y * cols;
  const int words = (s + kRows - 1) / kRows;
  const bool has_u = u != nullptr;

  if (tid == 0) {
    for (int d = 0; d < depth; ++d) {
      repro::ring::init(&full[d], 32);   // one per producer lane
      repro::ring::init(&empty[d], nc);  // one per consumer thread
    }
    repro::ring::fence_init();
  }
  // the masked diagonal scores stay 0 from here on
  for (int i = tid; i < 2 * lay.buf / 16; i += blockDim.x)
    reinterpret_cast<uint4*>(bufs)[i] = make_uint4(0, 0, 0, 0);
  if (has_u)
    for (int c = tid; c < N; c += blockDim.x)
      us[c] = u16 ? __bfloat162float(static_cast<const bf16*>(u)[row * N + c])
                  : static_cast<const float*>(u)[row * N + c];
  __syncthreads();

  if (tid >= nc) {
    // ---- the producer warp: word g is rows [16g, 16g+16) of every stream
    const int lane = tid - nc;
    constexpr int QC = N / 8, WC = N * int(sizeof(LW)) / 16,
                  WE = 16 / int(sizeof(LW));
    const int VC = cols / 8;
    const long long qk0 = row * s * N, v0 = row * s * p + p0;
    const int sub = (kRows + streams - 1) / streams;
    for (int g = 0; g < words; ++g) {
      const repro::ring::Slot sl(g, depth);
      repro::ring::wait(&empty[sl.stage], sl.phase ^ 1);
      unsigned char* st = stages + size_t(sl.stage) * lay.stage;
      for (int j = 0; j < streams && j * sub < kRows; ++j) {
        const int r0 = j * sub, rows = min(sub, kRows - r0);
        for (int i = lane; i < rows * QC; i += 32) {
          const int r = r0 + i / QC, c = i % QC, l = g * kRows + r;
          const bool ok = l < s;
          const long long off = qk0 + (long long)(ok ? l : 0) * N + c * 8;
          const int dst = (r * NS + c * 8) * 2;
          repro::ring::cp_async_16(st + dst, q + off, ok ? 16 : 0);
          repro::ring::cp_async_16(st + lay.o_k + dst, k + off, ok ? 16 : 0);
        }
        for (int i = lane; i < rows * VC; i += 32) {
          const int r = r0 + i / VC, c = i % VC, l = g * kRows + r;
          const bool ok = l < s;
          repro::ring::cp_async_16(
              st + lay.o_v + (r * lay.vs + c * 8) * 2,
              v + v0 + (long long)(ok ? l : 0) * p + c * 8, ok ? 16 : 0);
        }
        for (int i = lane; i < rows * WC; i += 32) {
          const int r = r0 + i / WC, c = i % WC, l = g * kRows + r;
          const bool ok = l < s;
          repro::ring::cp_async_16(
              st + lay.o_w + r * WS * int(sizeof(LW)) + c * 16,
              w + qk0 + (long long)(ok ? l : 0) * N + c * WE, ok ? 16 : 0);
        }
      }
      repro::ring::arrive_cp_async(&full[sl.stage]);
    }
    repro::ring::cp_async_wait_all();
    return;
  }

  // ---- the consumers
  const int wid = tid / 32, lane = tid % 32, gq = lane >> 2, tq = lane & 3;
  const int pw = 16 * wid;  // the warp's first column in the block's slice
  // z^T [16 columns, N] in f32 accumulator fragments; h^T the same in
  // shared memory (this lane's fragments, hcw[j]) and, as the products'
  // B operands, rounded to bf16 in registers (hb[kk][o])
  float hz[N / 8][4];
  uint32_t hb[N / 16][2][2];
  float4* hcw = reinterpret_cast<float4*>(hcs) + wid * (N / 8) * 32 + lane;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    hcw[j * 32] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int e = 0; e < 4; ++e) hz[j][e] = 0.0f;
  }
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int o = 0; o < 2; ++o) hb[kk][o][0] = hb[kk][o][1] = 0u;

  for (int g = 0; g < words; ++g) {
    const repro::ring::Slot sl(g, depth);
    const unsigned char* st = stages + size_t(sl.stage) * lay.stage;
    unsigned char* bf = bufs + size_t(g & 1) * lay.buf;
    const bf16* qs = reinterpret_cast<const bf16*>(st);
    const bf16* ks = reinterpret_cast<const bf16*>(st + lay.o_k);
    const bf16* vt = reinterpret_cast<const bf16*>(st + lay.o_v);
    const LW* ws = reinterpret_cast<const LW*>(st + lay.o_w);
    bf16* qd = reinterpret_cast<bf16*>(bf);
    bf16* qi = reinterpret_cast<bf16*>(bf + lay.b_qi);
    bf16* ke = reinterpret_cast<bf16*>(bf + lay.b_ke);
    float* cw = reinterpret_cast<float*>(bf + lay.b_cw);
    bf16* dt = reinterpret_cast<bf16*>(bf + lay.b_d);
    float* cu = reinterpret_cast<float*>(bf + lay.b_cu);
    float* sd = reinterpret_cast<float*>(bf + lay.b_sd);
    float* hd = reinterpret_cast<float*>(bf + lay.b_hd);
    const bool first = (g * kRows) % chunk == 0,
               last = ((g + 1) * kRows) % chunk == 0;
    repro::ring::wait(&full[sl.stage], sl.phase);

    // ---- A: the cumsum (log2 units) and the decayed q and k tiles; a
    //      thread loads its column's 16 rows before it stores anything
    for (int t = tid; t < 2 * N; t += nc) {
      const int n = t % N;
      const bool qside = t < N;
      const bf16* xs = qside ? qs : ks;
      const float c = first ? 0.0f : carry[(g & 1) * N + n];
      float x[kRows], run[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        x[r] = __bfloat162float(xs[r * NS + n]);
        run[r] = fminf(repro::to_f(ws[r * WS + n]), 0.0f) * kLog2e;
      }
      float acc = c;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        acc += run[r];
        run[r] = acc;
      }
      const float ce = run[kRows - 1];
      if (qside) {
        const float pb = ex2(c);
        cw[n] = c;
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float cq = inclusive ? run[r] : (r ? run[r - 1] : c);
          const float y = x[r] * ex2(cq - c);
          cw[(r + 1) * CS + n] = run[r];
          qi[r * NS + n] = __float2bfloat16_rn(y);
          qd[r * NS + n] = __float2bfloat16_rn(y * pb);
        }
        carry[((g + 1) & 1) * N + n] = ce;
      } else {
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          ke[r * NS + n] = __float2bfloat16_rn(x[r] * ex2(ce - run[r]));
        sd[n] = ex2(ce - c);
        if (last) hd[n] = ex2(ce);
      }
    }
    consumer_sync(nc);

    // ---- B: the diagonal subtile's scores: task t < 120 the strictly
    //      lower pair t = a (a - 1) / 2 + b, b < a; tasks 120..127 rows
    //      j and 15 - j: the diagonal pairs (inclusive) or the bonus
    for (int t = tid; t < 128; t += nc) {
      if (t < 120) {
        int a = int((1.0f + sqrtf(1.0f + 8.0f * t)) * 0.5f);
        if (a * (a - 1) / 2 > t) --a;
        if (a * (a + 1) / 2 <= t) ++a;
        const int b = t - a * (a - 1) / 2;
        const float* ea = cw + (inclusive ? a + 1 : a) * CS;
        const float* eb = cw + (b + 1) * CS;
        const bf16* qa = qs + a * NS;
        const bf16* kb = ks + b * NS;
        float acc0 = 0.0f, acc1 = 0.0f;  // two chains, summed at the end
#pragma unroll 4
        for (int n0 = 0; n0 < N; n0 += 8) {
          const uint4 qv = *reinterpret_cast<const uint4*>(qa + n0);
          const uint4 kv = *reinterpret_cast<const uint4*>(kb + n0);
          const float4 e0 = *reinterpret_cast<const float4*>(ea + n0);
          const float4 e1 = *reinterpret_cast<const float4*>(ea + n0 + 4);
          const float4 f0 = *reinterpret_cast<const float4*>(eb + n0);
          const float4 f1 = *reinterpret_cast<const float4*>(eb + n0 + 4);
          // b < a: the exponent is <= 0 without the clamp (a cumsum of
          // terms <= 0 does not rise, in f32 as well)
          const float ex[8] = {e0.x - f0.x, e0.y - f0.y, e0.z - f0.z,
                               e0.w - f0.w, e1.x - f1.x, e1.y - f1.y,
                               e1.z - f1.z, e1.w - f1.w};
          const __nv_bfloat162* q2 =
              reinterpret_cast<const __nv_bfloat162*>(&qv);
          const __nv_bfloat162* k2 =
              reinterpret_cast<const __nv_bfloat162*>(&kv);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float2 qf = __bfloat1622float2(q2[j]);
            const float2 kf = __bfloat1622float2(k2[j]);
            acc0 = fmaf(qf.x * ex2(ex[2 * j]), kf.x, acc0);
            acc1 = fmaf(qf.y * ex2(ex[2 * j + 1]), kf.y, acc1);
          }
        }
        dt[a * kDStride + b] = __float2bfloat16_rn(acc0 + acc1);
      } else if (inclusive || has_u) {
        // the diagonal pair (a, a) has exponent 0: a plain dot product;
        // exclusive masks it and takes the bonus sum_n q u k instead
#pragma unroll
        for (int side = 0; side < 2; ++side) {
          const int a = side ? 15 - (t - 120) : t - 120;
          float acc0 = 0.0f, acc1 = 0.0f;
#pragma unroll 2
          for (int n0 = 0; n0 < N; n0 += 8) {
            const uint4 qv = *reinterpret_cast<const uint4*>(qs + a * NS + n0);
            const uint4 kv = *reinterpret_cast<const uint4*>(ks + a * NS + n0);
            const float4 u0 = *reinterpret_cast<const float4*>(us + n0);
            const float4 u1 = *reinterpret_cast<const float4*>(us + n0 + 4);
            const float uu[8] = {u0.x, u0.y, u0.z, u0.w,
                                 u1.x, u1.y, u1.z, u1.w};
            const __nv_bfloat162* q2 =
                reinterpret_cast<const __nv_bfloat162*>(&qv);
            const __nv_bfloat162* k2 =
                reinterpret_cast<const __nv_bfloat162*>(&kv);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const float2 qf = __bfloat1622float2(q2[j]);
              const float2 kf = __bfloat1622float2(k2[j]);
              acc0 = fmaf(inclusive ? qf.x : qf.x * uu[2 * j], kf.x, acc0);
              acc1 = fmaf(inclusive ? qf.y : qf.y * uu[2 * j + 1], kf.y,
                          acc1);
            }
          }
          const float acc = acc0 + acc1;
          if (inclusive)
            dt[a * kDStride + a] = __float2bfloat16_rn(acc);
          else
            cu[a] = acc;
        }
      }
    }
    consumer_sync(nc);

    // ---- C: the warp's 16 columns on the tensor cores: the carried term
    //      (yh) and the chunk's own (yz) in two accumulator chains, the
    //      outputs, then the state z
    float yh[2][4], yz[2][4];
#pragma unroll
    for (int o = 0; o < 2; ++o)
#pragma unroll
      for (int e = 0; e < 4; ++e) yh[o][e] = yz[o][e] = 0.0f;
    const int ar = lane & 15, ac = (lane >> 4) * 8;               // A, x4
    const int br = (lane & 7) + ((lane >> 3) & 1) * 8, bc = ac;   // B, x4.t
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) {
      uint32_t a[4], a2[4];
      ldsm(a, qd + ar * NS + kk * 16 + ac);
      ldsm(a2, qi + ar * NS + kk * 16 + ac);
      mma(yh[0], a, hb[kk][0][0], hb[kk][0][1]);
      mma(yh[1], a, hb[kk][1][0], hb[kk][1][1]);
      mma(yz[0], a2, pack(hz[2 * kk][0], hz[2 * kk][1]),
          pack(hz[2 * kk + 1][0], hz[2 * kk + 1][1]));
      mma(yz[1], a2, pack(hz[2 * kk][2], hz[2 * kk][3]),
          pack(hz[2 * kk + 1][2], hz[2 * kk + 1][3]));
    }
    {
      uint32_t a[4], b[4];
      ldsm(a, dt + ar * kDStride + ac);
      ldsm_t(b, vt + br * lay.vs + pw + bc);
      mma(yz[0], a, b[0], b[1]);
      mma(yz[1], a, b[2], b[3]);
    }
    // the outputs: the carried term, the chunk's, the bonus cu[r] v[r, c]
#pragma unroll
    for (int o = 0; o < 2; ++o)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = gq + 8 * hr, c = pw + 8 * o + 2 * tq;
        float y0 = yh[o][2 * hr] + yz[o][2 * hr],
              y1 = yh[o][2 * hr + 1] + yz[o][2 * hr + 1];
        if (has_u) {
          const float cr = cu[r];
          y0 = fmaf(cr, __bfloat162float(vt[r * lay.vs + c]), y0);
          y1 = fmaf(cr, __bfloat162float(vt[r * lay.vs + c + 1]), y1);
        }
        const int l = g * kRows + r;
        if (l < s)
          *reinterpret_cast<__nv_bfloat162*>(out + (row * s + l) * p + p0 +
                                             c) = __floats2bfloat162_rn(y0,
                                                                        y1);
      }
    // z^T = z^T e^{cw_e - cw_b} + v^T . ke
    {
      uint32_t av[4];
      ldsm_t(av, vt + ((lane & 7) + (lane >> 4) * 8) * lay.vs + pw +
                     ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
        const float d0 = sd[8 * j + 2 * tq], d1 = sd[8 * j + 2 * tq + 1];
        hz[j][0] *= d0;
        hz[j][1] *= d1;
        hz[j][2] *= d0;
        hz[j][3] *= d1;
      }
#pragma unroll
      for (int jj = 0; jj < N / 16; ++jj) {
        uint32_t b[4];
        ldsm_t(b, ke + br * NS + jj * 16 + bc);
        mma(hz[2 * jj], av, b[0], b[1]);
        mma(hz[2 * jj + 1], av, b[2], b[3]);
      }
    }
    repro::ring::arrive(&empty[sl.stage]);
    if (last) {
      // the chunk's end: h = e^{cw_last} h + z, z = 0, and h's bf16
      // operands anew
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk) {
        float4 h2[2];
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const int j = 2 * kk + x;
          const float d0 = hd[8 * j + 2 * tq], d1 = hd[8 * j + 2 * tq + 1];
          float4 h = hcw[j * 32];
          h.x = fmaf(h.x, d0, hz[j][0]);
          h.y = fmaf(h.y, d1, hz[j][1]);
          h.z = fmaf(h.z, d0, hz[j][2]);
          h.w = fmaf(h.w, d1, hz[j][3]);
          hcw[j * 32] = h;
          h2[x] = h;
#pragma unroll
          for (int e = 0; e < 4; ++e) hz[j][e] = 0.0f;
        }
        hb[kk][0][0] = pack(h2[0].x, h2[0].y);
        hb[kk][0][1] = pack(h2[1].x, h2[1].y);
        hb[kk][1][0] = pack(h2[0].z, h2[0].w);
        hb[kk][1][1] = pack(h2[1].z, h2[1].w);
      }
    }
  }
}

// The kernel's attributes for a block of ``cols`` columns at ``depth``:
// its dynamic shared memory, and the largest shared-memory carveout, so
// that as many blocks as the registers allow share an SM.
template <int N, typename LW>
cudaError_t prepare(int cols, int depth, size_t* smem) {
  *smem = Layout<N, LW>(cols).bytes(depth);
  cudaError_t err = repro::allow_smem(ring_scan_kernel<N, LW>, *smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(ring_scan_kernel<N, LW>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <int N, typename LW>
cudaError_t launch_ring(const void* q, const void* k, const void* v,
                        const void* w, const void* u, int u16, void* out,
                        int bh, int s, int p, int chunk, int inclusive,
                        int slices, int depth, int streams,
                        cudaStream_t stream) {
  const int cols = p / slices;
  size_t smem;
  cudaError_t err = prepare<N, LW>(cols, depth, &smem);
  if (err != cudaSuccess) return err;
  ring_scan_kernel<N, LW><<<dim3(bh, slices), 32 * (cols / 16 + 1), smem,
                            stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const LW*>(w), u, u16,
      static_cast<bf16*>(out), s, p, chunk, inclusive, depth, streams);
  return cudaGetLastError();
}

template <int N, typename LW>
cudaError_t occupancy(int cols, int depth, int* blocks) {
  size_t smem;
  cudaError_t err = prepare<N, LW>(cols, depth, &smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, ring_scan_kernel<N, LW>, 32 * (cols / 16 + 1), smem);
}

template <typename LW>
cudaError_t launch_ring_n(int n, const void* q, const void* k, const void* v,
                          const void* w, const void* u, int u16, void* out,
                          int bh, int s, int p, int chunk, int inclusive,
                          int slices, int depth, int streams,
                          cudaStream_t stream) {
#define REPRO_RING_N(NN)                                                     \
  case NN:                                                                   \
    return launch_ring<NN, LW>(q, k, v, w, u, u16, out, bh, s, p, chunk,     \
                               inclusive, slices, depth, streams, stream);
  switch (n) {
    REPRO_RING_N(16)
    REPRO_RING_N(32)
    REPRO_RING_N(64)
    REPRO_RING_N(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef REPRO_RING_N
}

// ===========================================================================
// The CUDA-core ring body (f32 arithmetic)
// ===========================================================================

constexpr int kBlk = 4;                          // rows between boundaries
constexpr int kBlks = kRows / kBlk;              // 4-row blocks a word
constexpr int kPairs = kBlk * (kBlk + 1) / 2;    // (l, s <= l) a block: 10
constexpr int kScores = kBlks * kPairs;          // 40 a word
constexpr int kRed = 48;     // the scores padded to three butterflies of 16
constexpr int kLanes = 32;   // columns of a block
constexpr int kCT = 4;       // columns a consumer thread
constexpr int kCG = kLanes / kCT;  // column groups: the lanes of a quarter
constexpr int kNQ = 32 / kCG;      // state-row groups a warp: its quarters

// The state rows a consumer thread carries at state width N (a template
// parameter of the body), for each of its 4 columns: four warps up to N =
// 128, eight up to 256, then 16 rows a thread.
__host__ __device__ constexpr int f32_nt(int n) {
  return n <= 16 ? 1 : n <= 32 ? 2 : n <= 64 ? 4 : n <= 256 ? 8 : 16;
}

// Byte offsets of the CUDA-core body's shared memory (mirrored by
// ops.py:f32_ring_smem_bytes). A stage: q, k and log_w [16, NS] and v [16,
// CS], each in its own type (NS, CS: N and the block's columns rounded up
// to 8, so every row starts 16-byte aligned). Then, in f32: qd and ke [16,
// NP], sd [4, NP], the word's decay correction [NP] and u [NP] (NP = 4 NT
// W, the consumers' state rows; zeros past N), the warps' pair scores [W,
// 48] and their sums [48], the warps' partial outputs [W, 16, 32]; the full
// and empty mbarriers last.
struct F32Layout {
  int ns, cs, np, warps, o_k, o_w, o_v, stage, derived;
  __host__ __device__ F32Layout(int n, int cols, int types, int nt) {
    ns = (n + 7) / 8 * 8;
    cs = (cols + 7) / 8 * 8;
    warps = (n + kNQ * nt - 1) / (kNQ * nt);
    np = warps * kNQ * nt;
    o_k = kRows * ns * (types & kQBf16 ? 2 : 4);
    o_w = o_k + kRows * ns * (types & kKBf16 ? 2 : 4);
    o_v = o_w + kRows * ns * (types & kWBf16 ? 2 : 4);
    stage = o_v + kRows * cs * (types & kVBf16 ? 2 : 4);
    derived = 4 * ((2 * kRows + kBlks + 2) * np + kRed * warps + kRed +
                   kRows * kLanes * warps);
  }
  __host__ __device__ size_t bytes(int depth) const {
    return size_t(depth) * stage + derived + 16 * size_t(depth);
  }
};

// Element i of a staged tile as f32: a float, or a bfloat16 where ``b16``
// (ALL32: every stream is float32, nothing to test).
template <bool ALL32>
__device__ __forceinline__ float st_ld(const unsigned char* t, bool b16,
                                       int i) {
  if (!ALL32 && b16)
    return __bfloat162float(reinterpret_cast<const bf16*>(t)[i]);
  return reinterpret_cast<const float*>(t)[i];
}

// NT consecutive floats from shared memory (16-, 8- or 4-byte aligned as
// NT is a multiple of 4, 2 or 1), in the widest loads that take them.
template <int NT>
__device__ __forceinline__ void lds_nt(float (&x)[NT], const float* p) {
  if constexpr (NT % 4 == 0) {
#pragma unroll
    for (int e = 0; e < NT / 4; ++e) {
      const float4 t = reinterpret_cast<const float4*>(p)[e];
      x[4 * e] = t.x;
      x[4 * e + 1] = t.y;
      x[4 * e + 2] = t.z;
      x[4 * e + 3] = t.w;
    }
  } else if constexpr (NT == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    x[0] = t.x;
    x[1] = t.y;
  } else {
    x[0] = p[0];
  }
}

// One step of a warp butterfly that sums 2 CNT values over the lanes that
// differ in bit ``off``: the lane with that bit clear keeps the first CNT
// (in x[0, CNT)), the other the last CNT, each adding its partner's.
template <int CNT, int N>
__device__ __forceinline__ void fold(float (&x)[N], int lane, int off) {
  const bool up = lane & off;
#pragma unroll
  for (int i = 0; i < CNT; ++i) {
    const float keep = up ? x[i + CNT] : x[i];
    const float send = up ? x[i] : x[i + CNT];
    x[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
  }
}

// Rows [r0, r0 + rows) of a word's tile: ``ncols`` elements of ``e`` bytes
// a row, row l of the sequence at byte ``l * ld * e`` of ``src``, into
// ``dst`` (row stride ``ds`` elements); rows at or past s are zeros. By
// 16-byte cp.async (a row's last chunk partial, zero-filled) where
// ``vec``, else by element loads and shared-memory stores.
__device__ __forceinline__ void copy_rows(unsigned char* dst,
                                          const unsigned char* src, int e,
                                          long long ld, int ncols, int ds,
                                          int l0, int r0, int rows, int s,
                                          bool vec, int lane) {
  const int rb = ncols * e, chunks = (rb + 15) / 16;
  for (int r = r0; r < r0 + rows; ++r) {
    const int l = l0 + r;
    const bool ok = l < s;
    const unsigned char* sr = src + (ok ? l : 0) * ld * e;
    unsigned char* dr = dst + r * ds * e;
    if (vec) {
      for (int c = lane; c < chunks; c += 32)
        repro::ring::cp_async_16(dr + c * 16, sr + c * 16,
                                 ok ? min(16, rb - c * 16) : 0);
    } else if (e == 2) {
      for (int c = lane; c < ncols; c += 32)
        reinterpret_cast<bf16*>(dr)[c] =
            ok ? reinterpret_cast<const bf16*>(sr)[c]
               : __float2bfloat16_rn(0.0f);
    } else {
      for (int c = lane; c < ncols; c += 32)
        reinterpret_cast<float*>(dr)[c] =
            ok ? reinterpret_cast<const float*>(sr)[c] : 0.0f;
    }
  }
}

// p: v's and out's row length; cols: the columns of a slice (blockIdx.y's
// are [y cols, min(p, (y + 1) cols))).
// The streams a word takes by TMA (``tma`` bits, kTmaQ..kTmaV), ``box``
// rows a box, ``tx`` bytes a word; the others by cp.async or elements.
enum : int { kTmaQ = 1, kTmaK = 2, kTmaW = 4, kTmaV = 8 };

// The threads a block of the f32 body may take: W consumer warps and the
// producer. NT = 8 covers N up to 256 (8 warps); NT = 16 up to 784 (bf16
// streams; f32 to 576), past which not one stage fits: 13 warps. A bound
// of 14 warps leaves ptxas 128 registers a thread (17 would leave 96).
template <int NT>
constexpr int f32_threads() {
  return NT == 16 ? 448 : 288;
}

template <int NT, bool ALL32>
__global__ void __launch_bounds__(f32_threads<NT>())
    f32_ring_scan_kernel(const __grid_constant__ CUtensorMap map_q,
                         const __grid_constant__ CUtensorMap map_k,
                         const __grid_constant__ CUtensorMap map_w,
                         const __grid_constant__ CUtensorMap map_v,
                         const void* __restrict__ q,
                         const void* __restrict__ k,
                         const void* __restrict__ v,
                         const void* __restrict__ w,
                         const void* __restrict__ u, void* __restrict__ out,
                         int s, int n, int p, int cols, int inclusive,
                         int types, int depth, int streams, int tma, int box,
                         int tx, long long* __restrict__ clocks) {
  const F32Layout lay(n, cols, types, NT);
  const int nc = 32 * lay.warps, np = lay.np;
  extern __shared__ __align__(1024) unsigned char f32_smem[];
  unsigned char* stages = f32_smem;
  float* qd = reinterpret_cast<float*>(stages + size_t(depth) * lay.stage);
  float* ke = qd + kRows * np;
  float* sd = ke + kRows * np;
  float* cr = sd + kBlks * np;
  float* us = cr + np;
  float* red = us + np;
  float* dsum = red + kRed * lay.warps;
  float* ypart = dsum + kRed;
  uint64_t* full =
      reinterpret_cast<uint64_t*>(ypart + kRows * kLanes * lay.warps);
  uint64_t* empty = full + depth;
  const int tid = threadIdx.x;
  const long long row = blockIdx.x;
  const int p0 = blockIdx.y * cols, ccols = min(cols, p - p0);
  const int words = (s + kRows - 1) / kRows;
  const bool q16 = types & kQBf16, k16 = types & kKBf16,
             v16 = types & kVBf16, w16 = types & kWBf16;

  if (tid == 0) {
    for (int d = 0; d < depth; ++d) {
      // the TMA lane's expect_tx, and every producer lane twice a word:
      // once when its cp.async copies land, once after its element stores
      repro::ring::init(&full[d], repro::ring::kFullArrivals);
      repro::ring::init(&empty[d], nc);  // one per consumer thread
    }
    repro::ring::fence_init();
  }
  for (int i = tid; i < np; i += blockDim.x) {
    float x = 0.0f;
    if (u != nullptr && i < n)
      x = types & kUBf16
              ? __bfloat162float(static_cast<const bf16*>(u)[row * n + i])
              : static_cast<const float*>(u)[row * n + i];
    us[i] = x;
  }
  __syncthreads();

  if (tid >= nc) {
    // ---- the producer warp: word g is rows [16g, 16g+16) of every stream
    const int lane = tid - nc;
    const int eq = q16 ? 2 : 4, ek = k16 ? 2 : 4, ew = w16 ? 2 : 4,
              ev = v16 ? 2 : 4;
    const auto* qg = static_cast<const unsigned char*>(q) + row * s * n * eq;
    const auto* kg = static_cast<const unsigned char*>(k) + row * s * n * ek;
    const auto* wg = static_cast<const unsigned char*>(w) + row * s * n * ew;
    const auto* vg =
        static_cast<const unsigned char*>(v) + (row * s * p + p0) * ev;
    auto vec = [](const void* base, long long ld, int e) {
      return reinterpret_cast<uintptr_t>(base) % 16 == 0 && ld * e % 16 == 0;
    };
    const bool vq = vec(q, n, eq), vk = vec(k, n, ek), vw = vec(w, n, ew),
               vv = vec(vg, p, ev);
    const int sub = (kRows + streams - 1) / streams;
    for (int g = 0; g < words; ++g) {
      const repro::ring::Slot sl(g, depth);
      repro::ring::wait(&empty[sl.stage], sl.phase ^ 1);
      unsigned char* st = stages + size_t(sl.stage) * lay.stage;
      uint64_t* bar = &full[sl.stage];
      if (lane == 0) repro::ring::arrive_expect_tx(bar, tx);
      for (int j = 0; j < streams && j * sub < kRows; ++j) {
        const int r0 = j * sub, rows = min(sub, kRows - r0), l0 = g * kRows;
        if (lane == 0)  // boxes of ``box`` rows; rows past S arrive as 0
          for (int r = r0; r < r0 + rows; r += box) {
            if (tma & kTmaQ)
              repro::ring::tma_load_3d(st + r * lay.ns * eq, &map_q, bar, 0,
                                       l0 + r, int(row));
            if (tma & kTmaK)
              repro::ring::tma_load_3d(st + lay.o_k + r * lay.ns * ek,
                                       &map_k, bar, 0, l0 + r, int(row));
            if (tma & kTmaW)
              repro::ring::tma_load_3d(st + lay.o_w + r * lay.ns * ew,
                                       &map_w, bar, 0, l0 + r, int(row));
            if (tma & kTmaV)
              repro::ring::tma_load_3d(st + lay.o_v + r * lay.cs * ev,
                                       &map_v, bar, p0, l0 + r, int(row));
          }
        if (!(tma & kTmaQ))
          copy_rows(st, qg, eq, n, n, lay.ns, l0, r0, rows, s, vq, lane);
        if (!(tma & kTmaK))
          copy_rows(st + lay.o_k, kg, ek, n, n, lay.ns, l0, r0, rows, s, vk,
                    lane);
        if (!(tma & kTmaW))
          copy_rows(st + lay.o_w, wg, ew, n, n, lay.ns, l0, r0, rows, s, vw,
                    lane);
        if (!(tma & kTmaV))
          copy_rows(st + lay.o_v, vg, ev, p, ccols, lay.cs, l0, r0, rows, s,
                    vv, lane);
      }
      repro::ring::arrive_cp_async(bar);
      repro::ring::arrive(bar);
    }
    repro::ring::cp_async_wait_all();
    return;
  }

  // ---- the consumers: lane = (nq, cg), nq = lane / 8 the quarter-warp;
  //      the thread carries state rows [n0, n0 + NT) of columns [c0, c0 +
  //      4), n0 = (4 wid + nq) NT, c0 = 4 cg
  const int wid = tid / 32, lane = tid % 32, nq = lane / kCG,
            cg = lane % kCG, n0 = (kNQ * wid + nq) * NT, c0 = kCT * cg;
  float h[NT][kCT];
#pragma unroll
  for (int e = 0; e < NT; ++e)
#pragma unroll
    for (int cc = 0; cc < kCT; ++cc) h[e][cc] = 0.0f;
  const bool prof = clocks != nullptr && tid == 0;
  long long t0 = prof ? clock64() : 0, spent[4] = {0, 0, 0, 0};
  auto tick = [&](int i) {
    if (prof) {
      const long long t = clock64();
      spent[i] += t - t0;
      t0 = t;
    }
  };

  for (int g = 0; g < words; ++g) {
    const repro::ring::Slot sl(g, depth);
    const unsigned char* sq = stages + size_t(sl.stage) * lay.stage;
    const unsigned char *sk = sq + lay.o_k, *sw = sq + lay.o_w,
                        *sv = sq + lay.o_v;
    repro::ring::wait(&full[sl.stage], sl.phase);
    tick(0);

    // ---- AB: a thread a state row c: the decays, qd, ke, sd, and each
    //      4-row block's 10 pair scores summed over the thread's rows
    float acc[kRed / 16][16];
#pragma unroll
    for (int i = 0; i < kRed; ++i) acc[i / 16][i % 16] = 0.0f;
    for (int c = tid; c < np; c += nc) {
      if (c >= n) {  // past N: rows of the state that stay zero
#pragma unroll
        for (int r = 0; r < kRows; ++r) qd[r * np + c] = ke[r * np + c] = 0.0f;
#pragma unroll
        for (int j = 0; j < kBlks; ++j) sd[j * np + c] = 0.0f;
        cr[c] = 0.0f;
        continue;
      }
      const float uc = us[c];
      // the column's 16 rows first: the stores below may alias the stage
      float q_c[kRows], k_c[kRows], a_c[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int x = r * lay.ns + c;
        q_c[r] = st_ld<ALL32>(sq, q16, x);
        k_c[r] = st_ld<ALL32>(sk, k16, x);
        a_c[r] = st_ld<ALL32>(sw, w16, x);
      }
      // the row decays, and the word's log-decay X (for the correction
      // below)
      float lsum = 0.0f;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float lw = fminf(a_c[r], 0.0f);
        lsum += lw;
        a_c[r] = ex2(lw * kLog2e);
      }
      float pm1 = 0.0f;  // sd_0 .. sd_j less one, kept exact
#pragma unroll
      for (int j = 0; j < kBlks; ++j) {
        const float* qv = q_c + j * kBlk;
        const float* kv = k_c + j * kBlk;
        const float* av = a_c + j * kBlk;
        // q decayed from the block's start, k to its end, the block's decay
        float pr = 1.0f, sf = 1.0f;
#pragma unroll
        for (int i = 0; i < kBlk; ++i) {
          const int r = j * kBlk + i;
          if (inclusive) pr *= av[i];
          qd[r * np + c] = qv[i] * pr;
          if (!inclusive) pr *= av[i];
        }
        sd[j * np + c] = pr;
        const float s1 = pr - 1.0f;  // exact for pr >= 1/2
        pm1 = fmaf(pm1, s1, pm1 + s1);
#pragma unroll
        for (int i = kBlk - 1; i >= 0; --i) {
          ke[(j * kBlk + i) * np + c] = kv[i] * sf;
          sf *= av[i];
        }
        // pair (l, s), s <= l: inclusive q_l a_{s+1}..a_l k_s; exclusive
        // q_l a_{s+1}..a_{l-1} k_s below the diagonal and q_l u k_l on it
#pragma unroll
        for (int i = 0; i < kBlk; ++i) {
          const int a = j * kPairs + i * (i + 1) / 2;
          float& d = acc[(a + i) / 16][(a + i) % 16];
          d = fmaf(inclusive ? qv[i] : qv[i] * uc, kv[i], d);
          float f = inclusive ? av[i] : 1.0f;
#pragma unroll
          for (int s2 = i - 1; s2 >= 0; --s2) {
            float& e = acc[(a + s2) / 16][(a + s2) % 16];
            e = fmaf(qv[i] * f, kv[s2], e);
            f *= av[s2];
          }
        }
      }
      // the carried state's decay over the word made exact: C1 scales h by
      // 1 + cr after the word's four blocks, cr = X - ln(sd_0..sd_3) (a
      // few ulp: 1 + cr is e^cr to ~1e-11), so the roundings of sd (and
      // of ex2) do not compound from word to word; 0 where the word
      // decays below 1/2 (its roundings cannot build up there)
      cr[c] = pm1 > -0.5f ? lsum - log1pf(pm1) : 0.0f;
    }
    // the warp's sums: after the folds at 16, 8, 4 and 2 lane L holds value
    // 8 L4 + 4 L3 + 2 L2 + L1 (L by bits) of each group of 16, summed over
    // the 16 lanes that share bit 0; after offset 1 over all 32
#pragma unroll
    for (int grp = 0; grp < kRed / 16; ++grp) {
      fold<8>(acc[grp], lane, 16);
      fold<4>(acc[grp], lane, 8);
      fold<2>(acc[grp], lane, 4);
      fold<1>(acc[grp], lane, 2);
      acc[grp][0] += __shfl_xor_sync(0xffffffffu, acc[grp][0], 1);
      if (!(lane & 1))
        red[wid * kRed + 16 * grp + ((lane >> 1) & 15)] = acc[grp][0];
    }
    consumer_sync(nc);
    tick(1);

    // ---- C1: the pair scores summed over the warps; per 4-row block this
    //      thread's partial outputs over its state rows (summed over the
    //      warp's four quarters by two folds, then stored per warp), and
    //      its state carried to the block's end
    for (int i = tid; i < kScores; i += nc) {  // one warp at N <= 16
      float x = 0.0f;
      for (int w2 = 0; w2 < lay.warps; ++w2) x += red[w2 * kRed + i];
      dsum[i] = x;
    }
#pragma unroll
    for (int j = 0; j < kBlks; ++j) {
      float y[kBlk * kCT];  // row i, column cc at i * 4 + cc
#pragma unroll
      for (int i = 0; i < kBlk; ++i) {
        float x[NT];
        lds_nt(x, qd + (j * kBlk + i) * np + n0);
#pragma unroll
        for (int cc = 0; cc < kCT; ++cc) {
          float t = 0.0f;
#pragma unroll
          for (int e = 0; e < NT; ++e) t = fmaf(x[e], h[e][cc], t);
          y[i * kCT + cc] = t;
        }
      }
      // rows 2 L4 + L3 = nq of the block, summed over the four quarters
      fold<8>(y, lane, 16);
      fold<4>(y, lane, 8);
      *reinterpret_cast<float4*>(
          ypart + (wid * kRows + j * kBlk + nq) * kLanes + c0) =
          make_float4(y[0], y[1], y[2], y[3]);
      float x[NT];
      lds_nt(x, sd + j * np + n0);
#pragma unroll
      for (int e = 0; e < NT; ++e)
#pragma unroll
        for (int cc = 0; cc < kCT; ++cc) h[e][cc] *= x[e];
#pragma unroll
      for (int i = 0; i < kBlk; ++i) {
        const int r = j * kBlk + i;
        // columns past the slice's hold finite values or stale shared
        // memory; every sum below stays within a column, and C2 stores
        // only the slice's
        float vv[kCT];
        if constexpr (ALL32) {
          const float4 t =
              *reinterpret_cast<const float4*>(sv + (r * lay.cs + c0) * 4);
          vv[0] = t.x;
          vv[1] = t.y;
          vv[2] = t.z;
          vv[3] = t.w;
        } else {
#pragma unroll
          for (int cc = 0; cc < kCT; ++cc)
            vv[cc] = st_ld<ALL32>(sv, v16, r * lay.cs + c0 + cc);
        }
        lds_nt(x, ke + r * np + n0);
#pragma unroll
        for (int e = 0; e < NT; ++e)
#pragma unroll
          for (int cc = 0; cc < kCT; ++cc)
            h[e][cc] = fmaf(x[e], vv[cc], h[e][cc]);
      }
    }
    {  // the word's decay made exact (AB's cr)
      float x[NT];
      lds_nt(x, cr + n0);
#pragma unroll
      for (int e = 0; e < NT; ++e)
#pragma unroll
        for (int cc = 0; cc < kCT; ++cc)
          h[e][cc] = fmaf(h[e][cc], x[e], h[e][cc]);
    }
    consumer_sync(nc);
    tick(2);

    // ---- C2: the outputs: the warps' partials in order, then the block's
    //      pair scores times v in row order
    for (int o = tid; o < kRows * kLanes; o += nc) {
      const int r = o / kLanes, c = o % kLanes, l = g * kRows + r;
      if (c >= ccols || l >= s) continue;
      // the warps' partials loaded together, summed in a fixed tree
      constexpr int kW = NT == 16 ? 16 : 8;
      float part[kW];
#pragma unroll
      for (int w2 = 0; w2 < kW; ++w2)
        part[w2] = w2 < lay.warps ? ypart[(w2 * kRows + r) * kLanes + c]
                                  : 0.0f;
#pragma unroll
      for (int half = kW / 2; half >= 1; half /= 2)
#pragma unroll
        for (int w2 = 0; w2 < half; ++w2) part[w2] += part[w2 + half];
      float y = part[0];
      const int j = r / kBlk, i = r % kBlk;
      const float* d = dsum + j * kPairs + i * (i + 1) / 2;
      float dv[kBlk];
#pragma unroll
      for (int s2 = 0; s2 < kBlk; ++s2)
        dv[s2] = s2 <= i ? d[s2] * st_ld<ALL32>(
                               sv, v16, (j * kBlk + s2) * lay.cs + c)
                         : 0.0f;
#pragma unroll
      for (int s2 = 0; s2 < kBlk; ++s2) y += dv[s2];
      const long long gi = (row * s + l) * p + p0 + c;
      if (q16)
        static_cast<bf16*>(out)[gi] = __float2bfloat16_rn(y);
      else
        static_cast<float*>(out)[gi] = y;
    }
    tick(3);
    repro::ring::arrive(&empty[sl.stage]);
  }
  if (prof)
    for (int i = 0; i < 4; ++i)
      clocks[(blockIdx.y * (long long)gridDim.x + blockIdx.x) * 4 + i] =
          spent[i];
}

template <int NT, bool ALL32>
cudaError_t f32_prepare(int n, int cols, int types, int depth, size_t* smem) {
  *smem = F32Layout(n, cols, types, NT).bytes(depth);
  cudaError_t err = repro::allow_smem(f32_ring_scan_kernel<NT, ALL32>, *smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(f32_ring_scan_kernel<NT, ALL32>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

struct F32Args {
  const void *q, *k, *v, *w, *u;
  void* out;
  int bh, s, n, p, cols, inclusive, types, depth, streams;
  long long* clocks;
  cudaStream_t stream;
};

// A contiguous [bh, s, cols] tensor of ``elem``-byte elements read in
// boxes of ``box_cols`` x ``box_rows`` rows of one bh row, row-major as it
// lies in memory; rows past s (and columns past cols) arrive as zeros.
bool encode_rows(CUtensorMap* map, int elem, const void* base, int cols,
                 int s, int bh, int box_cols, int box_rows) {
  const repro::ring::EncodeTiled fn = repro::ring::encoder();
  if (!fn) return false;
  const cuuint64_t dims[3] = {cuuint64_t(cols), cuuint64_t(s),
                              cuuint64_t(bh)};
  const cuuint64_t strides[2] = {cuuint64_t(cols) * elem,
                                 cuuint64_t(cols) * elem * cuuint64_t(s)};
  const cuuint32_t boxd[3] = {cuuint32_t(box_cols), cuuint32_t(box_rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map, repro::ring::tma_type(elem), 3, const_cast<void*>(base), dims,
            strides, boxd, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int NT, bool ALL32>
cudaError_t f32_launch(const F32Args& a) {
  size_t smem;
  cudaError_t err = f32_prepare<NT, ALL32>(a.n, a.cols, a.types, a.depth,
                                           &smem);
  if (err != cudaSuccess) return err;
  const F32Layout lay(a.n, a.cols, a.types, NT);
  if (32 * (lay.warps + 1) > f32_threads<NT>()) return cudaErrorInvalidValue;
  const int slices = (a.p + a.cols - 1) / a.cols;
  // TMA where a box spans a whole row of q, k, log_w (N a multiple of 8 up
  // to 256, so their stage rows are N wide) or the slice's CS columns of v,
  // the tensor is 16-byte aligned and every box lands 128-byte aligned
  const int box = kRows % a.streams == 0 ? kRows / a.streams : 1;
  CUtensorMap maps[4] = {};
  int tma = 0, tx = 0;
  const void* base[4] = {a.q, a.k, a.w, a.v};
  const int bits[4] = {kQBf16, kKBf16, kWBf16, kVBf16};
  for (int i = 0; i < 4; ++i) {
    const int e = a.types & bits[i] ? 2 : 4;
    const int cols = i < 3 ? a.n : a.p, bc = i < 3 ? a.n : lay.cs;
    const bool ok = (i < 3 ? a.n % 8 == 0 && a.n <= 256 : lay.cs <= 256) &&
                    reinterpret_cast<uintptr_t>(base[i]) % 16 == 0 &&
                    cols * e % 16 == 0 && box * bc * e % 128 == 0 &&
                    encode_rows(&maps[i], e, base[i], cols, a.s, a.bh, bc,
                                box);
    if (ok) {
      tma |= 1 << i;
      tx += kRows * bc * e;
    }
  }
  f32_ring_scan_kernel<NT, ALL32><<<dim3(a.bh, slices), 32 * (lay.warps + 1),
                                    smem, a.stream>>>(
      maps[0], maps[1], maps[2], maps[3], a.q, a.k, a.v, a.w, a.u, a.out,
      a.s, a.n, a.p, a.cols, a.inclusive, a.types, a.depth, a.streams, tma,
      box, tx, a.clocks);
  return cudaGetLastError();
}

template <int NT, bool ALL32>
cudaError_t f32_occupancy(int n, int cols, int types, int depth,
                          int* blocks) {
  size_t smem;
  cudaError_t err = f32_prepare<NT, ALL32>(n, cols, types, depth, &smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, f32_ring_scan_kernel<NT, ALL32>,
      32 * (F32Layout(n, cols, types, NT).warps + 1), smem);
}

// The body's instance for N and the streams' types.
template <int NT>
cudaError_t f32_launch_t(const F32Args& a) {
  return (a.types & (kQBf16 | kKBf16 | kVBf16 | kWBf16)) == 0
             ? f32_launch<NT, true>(a)
             : f32_launch<NT, false>(a);
}

cudaError_t f32_launch_any(const F32Args& a) {
  switch (f32_nt(a.n)) {
    case 1: return f32_launch_t<1>(a);
    case 2: return f32_launch_t<2>(a);
    case 4: return f32_launch_t<4>(a);
    case 8: return f32_launch_t<8>(a);
    default: return f32_launch_t<16>(a);
  }
}

template <int NT>
cudaError_t f32_occupancy_t(int n, int cols, int types, int depth,
                            int* blocks) {
  return (types & (kQBf16 | kKBf16 | kVBf16 | kWBf16)) == 0
             ? f32_occupancy<NT, true>(n, cols, types, depth, blocks)
             : f32_occupancy<NT, false>(n, cols, types, depth, blocks);
}

cudaError_t f32_occupancy_any(int n, int cols, int types, int depth,
                              int* blocks) {
  switch (f32_nt(n)) {
    case 1: return f32_occupancy_t<1>(n, cols, types, depth, blocks);
    case 2: return f32_occupancy_t<2>(n, cols, types, depth, blocks);
    case 4: return f32_occupancy_t<4>(n, cols, types, depth, blocks);
    case 8: return f32_occupancy_t<8>(n, cols, types, depth, blocks);
    default: return f32_occupancy_t<16>(n, cols, types, depth, blocks);
  }
}

// The body takes N whose warps fit its block: at most 16 of 64 state rows
// (16 a thread) past N = 256; the slice's columns are at most 32.
bool f32_takes(int n, int cols) {
  return n >= 1 && n <= 16 * kNQ * 16 && cols >= 1 && cols <= kLanes;
}

}  // namespace

// The f32 ring body: out [bh, s, p] (q's type) = the scan of q, k, w
// (log-decay) [bh, s, n] and v [bh, s, p], all contiguous; u [bh, n] or
// null (exclusive mode's bonus). ``types`` has bit 1 set if q is bfloat16
// (else float32), 2 for k, 4 for v, 8 for w, 16 for u. P is cut into
// slices of ``cols`` <= 32 columns (the last one may be narrower); ``depth``
// ring stages of 16 rows, each copied in ``streams`` parts. Any chunk and
// subtile give these bits, so neither is an argument. ``clocks`` null, or
// 4 counters a block (see the file's note).
extern "C" int ff_chunk_scan_f32_ring(const void* q, const void* k,
                                      const void* v, const void* w,
                                      const void* u, void* out, int bh, int s,
                                      int n, int p, int cols, int inclusive,
                                      int types, int depth, int streams,
                                      long long* clocks, void* stream) {
  if (!f32_takes(n, cols) || p < 1 || depth < 1 || streams < 1)
    return cudaErrorInvalidValue;
  if (bh == 0 || s == 0) return 0;
  return f32_launch_any(F32Args{q, k, v, w, u, out, bh, s, n, p, cols,
                                inclusive, types, depth, streams, clocks,
                                (cudaStream_t)stream});
}

// Blocks of the f32 ring body that fit on one SM at once (registers,
// shared memory, threads), for ``cols`` columns a block at ``depth``; -1
// on a shape the body does not take.
extern "C" int ff_chunk_scan_f32_ring_occupancy(int n, int types, int cols,
                                                int depth) {
  int blocks = -1;
  if (!f32_takes(n, cols) || depth < 1) return -1;
  return f32_occupancy_any(n, cols, types, depth, &blocks) == cudaSuccess
             ? blocks
             : -1;
}

// The ring body: q, k, v bfloat16 (``types`` bits 1, 2 and 4 set), w
// float32 or bfloat16 (bit 8), u float32 or bfloat16 (bit 16) or null; n
// in {16, 32, 64, 128}, chunk a multiple of 16, p / slices a multiple of
// 16 of at most 128 columns; ``depth`` ring stages of 16 rows, each copied
// in ``streams`` parts. The subtile is 16.
extern "C" int ff_chunk_scan_ring(const void* q, const void* k, const void* v,
                                  const void* w, const void* u, void* out,
                                  int bh, int s, int n, int p, int chunk,
                                  int inclusive, int types, int slices,
                                  int depth, int streams, void* stream) {
  if ((types & (kQBf16 | kKBf16 | kVBf16)) != (kQBf16 | kKBf16 | kVBf16) ||
      chunk < kRows || chunk % kRows != 0 || slices < 1 || p % slices != 0 ||
      (p / slices) % 16 != 0 || p / slices > 16 * kMaxWarps || depth < 1 ||
      streams < 1)
    return cudaErrorInvalidValue;
  if (bh == 0 || s == 0) return 0;
  const int u16 = (types & kUBf16) != 0;
  return (types & kWBf16)
             ? launch_ring_n<bf16>(n, q, k, v, w, u, u16, out, bh, s, p,
                                   chunk, inclusive, slices, depth, streams,
                                   (cudaStream_t)stream)
             : launch_ring_n<float>(n, q, k, v, w, u, u16, out, bh, s, p,
                                    chunk, inclusive, slices, depth, streams,
                                    (cudaStream_t)stream);
}

// Blocks of the ring body that fit on one SM at once (registers, shared
// memory, threads), for ``cols`` columns a block at ``depth``; -1 on a
// shape the body does not take.
extern "C" int ff_chunk_scan_ring_occupancy(int n, int w16, int cols,
                                            int depth) {
  int blocks = -1;
  cudaError_t err = cudaErrorInvalidValue;
  if (cols < 16 || cols % 16 != 0 || cols > 16 * kMaxWarps || depth < 1)
    return -1;
#define REPRO_RING_OCC(NN)                                                   \
  case NN:                                                                   \
    err = w16 ? occupancy<NN, bf16>(cols, depth, &blocks)                    \
              : occupancy<NN, float>(cols, depth, &blocks);                  \
    break;
  switch (n) {
    REPRO_RING_OCC(16)
    REPRO_RING_OCC(32)
    REPRO_RING_OCC(64)
    REPRO_RING_OCC(128)
    default:
      break;
  }
#undef REPRO_RING_OCC
  return err == cudaSuccess ? blocks : -1;
}
