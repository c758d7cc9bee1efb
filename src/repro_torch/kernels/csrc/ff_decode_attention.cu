// Decode attention, contiguous cache and paged pool, from one kernel body,
// for the H100 (sm_90a).
//
// Replaces two TPU kernels:
//   * src/repro/kernels/ff_decode_attention/kernel.py build_program /
//     decode_attention_ff: one query token against cache k/v [B,KVH,S,D]
//     with a lengths[B] prefix mask;
//   * the paged_decode_attention StreamGraph of
//     src/repro/runtime/paged_kv.py (build_paged_decode_graph): the
//     ff_gather block-table producer fused into
//     ff_decode_attention/kernel.py build_paged_program, reading a pool
//     [nb,2,page,KVH,D] through block_tables[B,n_pages].
//
// Bound on this card: every live K/V byte (the lengths prefix) is read once
// and used for 4*G operations per element pair, about 2 operations a byte
// at G = 1, so decode is bound by device memory (3.35 TB/s): the least time
// is the live KV bytes plus q and out over that rate. What keeps a kernel
// from it is latency: a row's K/V is a chain of pages, and at the serve
// shape there are only B*KVH = 64 (b, kv head) rows for 132 SMs.
//
// Design, against each cause:
//   * Bytes in flight. K/V arrive through a ring_pipe.cuh ring of ``depth``
//     shared-memory stages, each a word of R cache rows of K and of V in
//     the cache's own type (bf16 stays bf16; rows padded to 16 bytes). R
//     is 64, 32 or 16, the most whose stage fits 16 KB (ops.py
//     _word_rows: 64 at qwen's head dim 64 in bf16), never a function of
//     block_kv or the page. One producer warp issues a word's rows as
//     16-byte cp.async copies (element copies where a base or row stride
//     is not 16-byte aligned), ``streams`` parts of its rows in turn, all
//     completing on the stage's full mbarrier, and runs up to ``depth``
//     words ahead of the consumers. At depth 1 it cannot fetch a word
//     before the last one is released: the synchronous baseline of the
//     reference's Pipe. Rows past the live prefix are zero-filled, not
//     read.
//   * Parallelism. A row's live words are split over up to ``split`` blocks
//     (ops.py _plan, from B, KVH, D, the type, S and the SM count: the same
//     for both layouts). A row uses min(split, max(1, words / min_words))
//     splits, min_words being 128 rows, so a short row runs in one block;
//     split j takes words [j*w/u, (j+1)*w/u). Each split keeps its own m,
//     l and acc; the last split of a row to finish (a self-resetting
//     ticket a row, as ff_layer.cu) sums the splits' partials in ascending
//     split order from a workspace the wrapper allocates. Splits past the
//     used ones exit at once: skipped, never merged.
//   * Every warp busy. Each of the four consumer warps owns R/4 rows of
//     every word and keeps its own online-softmax state (m, l, acc per
//     query row): 8 lanes a row take the scores across D (16-byte loads,
//     a butterfly over the 8 lanes), R/16 rows a lane, so the word's
//     scores are independent chains; the max and the sum over the warp's
//     rows are butterflies, one state update a word, and P.V runs with the
//     lanes across D (pairs of elements). The warps' states are combined
//     in warp order when the split ends. No block-wide barrier runs inside
//     the word loop. Measured on the H100 (PERF.md, rows 2-3): the per-word
//     chain of a consumer warp and the fixed cost of a block (launch,
//     q, the combine) bound the kernel well before the bytes do, so a
//     word of 64 rows amortises the chain that a word of 16 paid 4 times.
//   * Paged: the producer holds the row's block-table entries 32 pages at
//     a time in its lanes' registers and loads the next 32 before they are
//     needed, so no copy waits on a dependent table read (pages of fewer
//     than 2 rows read the entries past the window from the table); the
//     first 64 entries are read at the block's start, beside the length.
//     Sentinel entries (>= n_blocks) are clipped to a real block; the rows
//     they would give lie past lengths and are zero-filled.
//
// Numerics: scores, exponents and sums in f32, p rounded to the cache's
// type before P.V (as the reference), l summed from the unrounded p.
// Rows past the live prefix get p = 0 directly. The words and splits
// reorder the f32 sums against the plain version's tile loop (held to it
// at 2e-4 f32 and 2e-2 bf16). Bit for bit: the two instantiations differ
// only in how the producer forms a row's address, so at block_kv == page
// and S == n_pages * page they read the same bytes into the same stages,
// split the same way and sum in the same order; nothing the consumers
// compute depends on when a word lands, so depth and streams never change
// a bit. A row with lengths == 0 gives exactly 0; a length past the cache
// attends to the whole cache.

#include "ring_pipe.cuh"

namespace {

namespace ring = repro::ring;

constexpr int kWarps = 4;                      // consumer warps
constexpr int kConsumers = 32 * kWarps;
constexpr int kThreads = kConsumers + 32;      // and one producer warp
constexpr int kRowLanes = 8;                   // lanes a row's scores
constexpr int kPassRows = 32 / kRowLanes;      // a warp's rows a pass
constexpr int kMinRows = 128;                  // ops.py _MIN_SPLIT_ROWS
constexpr int kMaxD = 256;
constexpr int kBatch = 8;                      // partials read at a time

// The dynamic shared memory (mirrored by ops.py smem_bytes): the stages,
// each K then V [rows, dp] in T; q [G, dp] f32; each warp's acc [G, dp],
// m [G] and l [G] in f32; the full and empty mbarriers; a flag.
struct Layout {
  int dp;                // row pitch in elements: D rounded up to 16 bytes
  size_t stage, o_q, o_acc, o_m, o_bar, total;
  __host__ __device__ Layout(int d, int group, int depth, int item,
                             int rows) {
    const int e = 16 / item;
    dp = (d + e - 1) / e * e;
    stage = size_t(2) * rows * dp * item;
    o_q = depth * stage;
    o_acc = o_q + size_t(group) * dp * 4;
    o_m = o_acc + size_t(kWarps) * group * dp * 4;
    o_bar = (o_m + size_t(2) * kWarps * group * 4 + 7) / 8 * 8;
    total = o_bar + size_t(2) * depth * 8 + 16;
  }
};

template <typename T>
struct Args {
  const T* q;                  // [B, KVH*G, D]
  const T* k;                  // cache [B,KVH,S,D] (strided) | pool
  const T* v;                  // cache [B,KVH,S,D] (strided) | pool + page
  const int32_t* lengths;      // [B]
  const int32_t* tables;       // [B, n_pages] (paged only)
  T* out;                      // [B, KVH*G, D]
  float* ws;                   // [B*KVH, split, G*(D+2)] f32 (split > 1)
  unsigned* tickets;           // [B*KVH], left at 0
  int kvh, group, d, s, page, n_pages, n_blocks;
  int split, depth, streams, vec;
  long long k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;   // elements
  float scale;
};

// A 16-byte chunk of T as f32; two elements of T as f32.
__device__ __forceinline__ void widen(const float* p, float* o) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  o[0] = x.x, o[1] = x.y, o[2] = x.z, o[3] = x.w;
}
__device__ __forceinline__ void widen(const __nv_bfloat16* p, float* o) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x, o[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ float2 pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// Block-table entry p of row b, clipped to a real block (a sentinel's rows
// lie past the length); 0 past the table (only rows past the cache ask).
template <typename T>
__device__ __forceinline__ int table_entry(const Args<T>& a, int b, int p) {
  if (p >= a.n_pages) return 0;
  return min(max(__ldg(a.tables + (long long)b * a.n_pages + p), 0),
             a.n_blocks - 1);
}

// The producer warp: the split's words [w_lo, w_lo + n), each its R cache
// rows of K and V into stage g % depth.
template <typename T, bool Paged, int R>
__device__ void produce(const Args<T>& a, const Layout& lay,
                        unsigned char* smem, uint64_t* full, uint64_t* empty,
                        int b, int h, int w_lo, int n, int live_rows,
                        int first, int second) {
  constexpr int E = 16 / int(sizeof(T));
  const int lane = threadIdx.x - kConsumers;
  const int dp = lay.dp, C = dp / E, D = a.d;
  const int sub = (R + a.streams - 1) / a.streams;
  // a lane's copies: chunks c_lane, c_lane + 32, ... of rows r_first,
  // r_first + rpp, ... of every word (C <= 32: rpp rows a pass, the lanes
  // past rpp * C idle; C > 32: every lane on every row)
  const int rpp = C <= 32 ? 32 / C : 1;
  const int c_lane = C <= 32 ? lane % C : lane;
  const int r_first = C <= 32 ? lane / C : 0;
  const bool idle = C <= 32 && lane >= rpp * C;
  const T* kb;
  const T* vb;
  long long k_rs, v_rs, page_elems = 0;
  if constexpr (Paged) {
    page_elems = (long long)a.page * a.kvh * D;
    kb = a.k + (long long)h * D;
    vb = kb + page_elems;
    k_rs = v_rs = (long long)a.kvh * D;
  } else {
    kb = a.k + b * a.k_sb + h * a.k_sh;
    vb = a.v + b * a.v_sb + h * a.v_sh;
    k_rs = a.k_ss;
    v_rs = a.v_ss;
  }
  // paged: the block-table entries of pages [base, base + 64), lane i
  // holding base + i in cur and base + 32 + i in nxt; those of pages 0-63
  // came with the length (``first``, ``second``)
  auto entry = [&](int p) { return table_entry(a, b, p); };
  int base = 0, cur = first, nxt = second;
  if constexpr (Paged) {
    base = w_lo * R / a.page;
    if (base) {
      cur = entry(base + lane);
      nxt = entry(base + 32 + lane);
    }
  }
  for (int g = 0; g < n; ++g) {
    const int r0 = (w_lo + g) * R;
    // paged: lane i holds the pool offset of the word's row i (and of row
    // i + 32 in off_hi), from the window or, past it, the table itself
    long long off_lo = 0, off_hi = 0;
    if constexpr (Paged) {
      while (r0 / a.page >= base + 32) {
        base += 32;
        cur = nxt;
        nxt = entry(base + 32 + lane);
      }
#pragma unroll
      for (int half = 0; half < (R + 31) / 32; ++half) {
        const int r = r0 + min(half * 32 + lane, R - 1), pg = r / a.page;
        const int x = __shfl_sync(0xffffffffu, cur, (pg - base) & 31);
        const int y = __shfl_sync(0xffffffffu, nxt, (pg - base) & 31);
        const int blk = pg - base < 32 ? x : pg - base < 64 ? y : entry(pg);
        const long long o = blk * 2 * page_elems +
                            (long long)(r - pg * a.page) * k_rs;
        (half ? off_hi : off_lo) = o;
      }
    }
    const ring::Slot sl(g, a.depth);
    ring::wait(&empty[sl.stage], sl.phase ^ 1);
    T* ks = reinterpret_cast<T*>(smem + sl.stage * lay.stage);
    T* vs = ks + R * dp;
    for (int j = 0; j < a.streams && j * sub < R; ++j) {
      const int ra = j * sub, rb = min(ra + sub, R);
      // the passes that hold part j's rows (the same for every lane:
      // r_first < rpp)
      for (int t = ra / rpp; t * rpp < rb; ++t) {
        const int r = r_first + t * rpp;
        long long ko, vo;
        if constexpr (Paged) {
          const long long lo = __shfl_sync(0xffffffffu, off_lo, r & 31);
          const long long hi = __shfl_sync(0xffffffffu, off_hi, r & 31);
          ko = vo = r < 32 ? lo : hi;
        } else {
          ko = (long long)(r0 + r) * k_rs;
          vo = (long long)(r0 + r) * v_rs;
        }
        if (idle || r < ra || r >= rb) continue;
        const bool ok = r0 + r < live_rows;
        for (int c = c_lane; c < C; c += 32) {
          const T* ksrc = kb + (ok ? ko : 0) + c * E;
          const T* vsrc = vb + (ok ? vo : 0) + c * E;
          T* kd = ks + r * dp + c * E;
          T* vd = vs + r * dp + c * E;
          if (a.vec) {
            ring::cp_async_16(kd, ksrc, ok ? 16 : 0);
            ring::cp_async_16(vd, vsrc, ok ? 16 : 0);
          } else {
#pragma unroll
            for (int e = 0; e < E; ++e) {
              const bool in = ok && c * E + e < D;
              kd[e] = in ? ksrc[e] : repro::from_f<T>(0.f);
              vd[e] = in ? vsrc[e] : repro::from_f<T>(0.f);
            }
          }
        }
      }
    }
    if (a.vec)
      ring::arrive_cp_async(&full[sl.stage]);
    else
      ring::arrive(&full[sl.stage]);
  }
  ring::cp_async_wait_all();
}

// A consumer warp: its R/4 rows of each word, in kSub passes of 4 rows
// (lane i on row i/8 of a pass, chunks i%8, i%8 + 8, ... of D), its own m,
// l and acc: one online-softmax update a word.
template <typename T, int R>
__device__ void consume(const Args<T>& a, const Layout& lay,
                        unsigned char* smem, uint64_t* full, uint64_t* empty,
                        int w_lo, int n, int live_rows) {
  constexpr int E = 16 / int(sizeof(T));
  constexpr int kChunks = kMaxD / E / kRowLanes;   // a lane's, at most
  constexpr int RW = R / kWarps, kSub = RW / kPassRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int jr = lane / kRowLanes, c0 = lane % kRowLanes;
  const int G = a.group, dp = lay.dp, C = dp / E;
  const float* qs = reinterpret_cast<const float*>(smem + lay.o_q);
  float* acc = reinterpret_cast<float*>(smem + lay.o_acc) + warp * G * dp;
  float* ms = reinterpret_cast<float*>(smem + lay.o_m) + warp * G;
  float* ls = ms + kWarps * G;
  for (int g = 0; g < n; ++g) {
    const ring::Slot sl(g, a.depth);
    ring::wait(&full[sl.stage], sl.phase);
    const T* ks = reinterpret_cast<const T*>(smem + sl.stage * lay.stage) +
                  warp * RW * dp;
    const T* vs = ks + R * dp;
    const int live = live_rows - ((w_lo + g) * R + warp * RW);
    if (live > 0) {                  // the warp has a live row in this word
      for (int gq = 0; gq < G; ++gq) {
        const float* qr = qs + gq * dp;
        // this lane's partial dot of each pass's row, then its 8 lanes'
        float sc[kSub];
#pragma unroll
        for (int i = 0; i < kSub; ++i) sc[i] = 0.f;
#pragma unroll
        for (int t = 0; t < kChunks; ++t) {
          const int ch = c0 + t * kRowLanes;
          if (ch < C) {
            float qv[E];
#pragma unroll
            for (int e0 = 0; e0 < E; e0 += 4) widen(qr + ch * E + e0, qv + e0);
#pragma unroll
            for (int i = 0; i < kSub; ++i) {
              float kv[E];
              widen(ks + (jr + i * kPassRows) * dp + ch * E, kv);
#pragma unroll
              for (int e = 0; e < E; ++e) sc[i] = fmaf(qv[e], kv[e], sc[i]);
            }
          }
        }
        float mx = repro::kNegInf;
#pragma unroll
        for (int i = 0; i < kSub; ++i) {
#pragma unroll
          for (int o = kRowLanes / 2; o > 0; o >>= 1)
            sc[i] += __shfl_xor_sync(0xffffffffu, sc[i], o);
          sc[i] *= a.scale;
          if (jr + i * kPassRows < live) mx = fmaxf(mx, sc[i]);
        }
#pragma unroll
        for (int o = kRowLanes; o < 32; o <<= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float m_prev = ms[gq];
        const float m_new = fmaxf(m_prev, mx);
        float sum = 0.f, pr[kSub];
#pragma unroll
        for (int i = 0; i < kSub; ++i) {
          const float p =
              jr + i * kPassRows < live ? expf(sc[i] - m_new) : 0.f;
          sum += p;
          pr[i] = repro::to_f(repro::from_f<T>(p));
        }
#pragma unroll
        for (int o = kRowLanes; o < 32; o <<= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, o);
        // p of the warp's rows in row order (pass i, row j: row j + 4i)
        float pj[RW];
#pragma unroll
        for (int i = 0; i < kSub; ++i)
#pragma unroll
          for (int j = 0; j < kPassRows; ++j)
            pj[i * kPassRows + j] =
                __shfl_sync(0xffffffffu, pr[i], j * kRowLanes);
        const float alpha = expf(m_prev - m_new);
        float* ar = acc + gq * dp;
        for (int e = 2 * lane; e < dp; e += 64) {
          float2 pv = make_float2(0.f, 0.f);
#pragma unroll
          for (int r = 0; r < RW; ++r) {
            const float2 vv = pair(vs + r * dp + e);
            pv.x = fmaf(pj[r], vv.x, pv.x);
            pv.y = fmaf(pj[r], vv.y, pv.y);
          }
          float2 av = *reinterpret_cast<float2*>(ar + e);
          av.x = fmaf(av.x, alpha, pv.x);
          av.y = fmaf(av.y, alpha, pv.y);
          *reinterpret_cast<float2*>(ar + e) = av;
        }
        __syncwarp();                // every lane has read m and l
        if (lane == 0) {
          ms[gq] = m_new;
          ls[gq] = fmaf(ls[gq], alpha, sum);
        }
        __syncwarp();
      }
    }
    ring::arrive(&empty[sl.stage]);
  }
}

template <typename T, bool Paged, int R>
__global__ void __launch_bounds__(kThreads) ring_decode_kernel(
    const Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int bh = blockIdx.x / a.split, sp = blockIdx.x - bh * a.split;
  const int b = bh / a.kvh, h = bh - b * a.kvh;
  const int G = a.group, D = a.d;
  const int length = a.lengths[b];
  // paged: the producer's first table window is read with the length
  int first = 0, second = 0;
  if constexpr (Paged) {
    if (tid >= kConsumers) {
      first = table_entry(a, b, tid - kConsumers);
      second = table_entry(a, b, tid - kConsumers + 32);
    }
  }
  // q is staged while the length is in flight
  const Layout lay(D, G, a.depth, int(sizeof(T)), R);
  const int dp = lay.dp;
  float* qs = reinterpret_cast<float*>(smem + lay.o_q);
  const T* qb = a.q + (long long)bh * G * D;
  for (int i = tid; i < G * dp; i += kThreads) {
    const int g = i / dp, e = i - g * dp;
    qs[i] = e < D ? repro::to_f(qb[g * D + e]) : 0.f;
  }
  const int live_rows = min(max(length, 0), a.s);
  const int words = (live_rows + R - 1) / R;
  const int min_words = (kMinRows + R - 1) / R;
  const int used = words ? min(a.split, max(1, words / min_words)) : 0;
  T* ob = a.out + (long long)bh * G * D;
  if (sp >= max(used, 1)) return;    // a split with no live word
  if (used == 0) {                   // lengths == 0: exactly 0
    for (int i = tid; i < G * D; i += kThreads) ob[i] = repro::from_f<T>(0.f);
    return;
  }
  const int w_lo = sp * words / used, n = (sp + 1) * words / used - w_lo;

  float* acc = reinterpret_cast<float*>(smem + lay.o_acc);
  float* ms = reinterpret_cast<float*>(smem + lay.o_m);
  float* ls = ms + kWarps * G;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + lay.o_bar);
  uint64_t* empty = full + a.depth;
  int* flag = reinterpret_cast<int*>(empty + a.depth);
  for (int i = tid; i < kWarps * G * dp; i += kThreads) acc[i] = 0.f;
  for (int i = tid; i < kWarps * G; i += kThreads) {
    ms[i] = repro::kNegInf;
    ls[i] = 0.f;
  }
  if (tid == 0) {
    for (int s = 0; s < a.depth; ++s) {
      ring::init(&full[s], ring::kProducerLanes);  // one per producer lane
      ring::init(&empty[s], kConsumers);           // one per consumer
    }
    ring::fence_init();
  }
  __syncthreads();
  if (tid >= kConsumers)
    produce<T, Paged, R>(a, lay, smem, full, empty, b, h, w_lo, n,
                         live_rows, first, second);
  else
    consume<T, R>(a, lay, smem, full, empty, w_lo, n, live_rows);
  __syncthreads();

  // the warps' states in warp order: this split's m, l and acc
  const size_t stride = size_t(G) * (D + 2);
  float* part = a.ws + ((long long)bh * a.split + sp) * stride;
  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D, e = i - g * D;
    float m = repro::kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) m = fmaxf(m, ms[w * G + g]);
    float l = 0.f, x = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wt = expf(ms[w * G + g] - m);
      l = fmaf(ls[w * G + g], wt, l);
      x = fmaf(acc[(w * G + g) * dp + e], wt, x);
    }
    if (used == 1) {
      ob[i] = repro::from_f<T>(x / l);
    } else {
      if (e == 0) {
        part[g] = m;
        part[G + g] = l;
      }
      part[2 * G + i] = x;
    }
  }
  if (used == 1) return;

  // the last split of the row to finish sums the partials in split order;
  // one fence for the block's partials, after the barrier orders them
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    const unsigned ticket = atomicAdd(&a.tickets[bh], 1u);
    const int last = ticket == unsigned(used - 1);
    if (last) {
      atomicExch(&a.tickets[bh], 0u);
      __threadfence();               // the other splits' partials
    }
    *flag = last;
  }
  __syncthreads();
  if (!*flag) return;
  const float* row = a.ws + (long long)bh * a.split * stride;
  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D;
    // kBatch splits' loads in flight at a time
    float m = repro::kNegInf;
    for (int s0 = 0; s0 < used; s0 += kBatch) {
      float v[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j)
        v[j] = s0 + j < used ? __ldcg(row + (s0 + j) * stride + g)
                             : repro::kNegInf;
#pragma unroll
      for (int j = 0; j < kBatch; ++j) m = fmaxf(m, v[j]);
    }
    float l = 0.f, x = 0.f;
    for (int s0 = 0; s0 < used; s0 += kBatch) {
      float vm[kBatch], vl[kBatch], vx[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const float* ps = row + (s0 + j) * stride;
        const bool in = s0 + j < used;
        vm[j] = in ? __ldcg(ps + g) : repro::kNegInf;
        vl[j] = in ? __ldcg(ps + G + g) : 0.f;
        vx[j] = in ? __ldcg(ps + 2 * G + i) : 0.f;
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        if (s0 + j < used) {
          const float wt = expf(vm[j] - m);
          l = fmaf(vl[j], wt, l);
          x = fmaf(vx[j], wt, x);
        }
      }
    }
    ob[i] = repro::from_f<T>(x / l);
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T, bool Paged, int R>
int launch_rows(const Args<T>& a, int b, void* stream) {
  const size_t smem = Layout(a.d, a.group, a.depth, int(sizeof(T)), R).total;
  cudaError_t err = repro::allow_smem(ring_decode_kernel<T, Paged, R>, smem);
  if (err != cudaSuccess) return err;
  ring_decode_kernel<T, Paged, R>
      <<<b * a.kvh * a.split, kThreads, smem, (cudaStream_t)stream>>>(a);
  return cudaGetLastError();
}

// Blocks of ring_decode_kernel<T, Paged, R> that one SM holds at once
// (registers, shared memory, threads) with a ring of ``depth`` stages.
template <typename T, bool Paged, int R>
int occupancy_rows(int d, int group, int depth) {
  const size_t smem = Layout(d, group, depth, int(sizeof(T)), R).total;
  cudaError_t err = repro::allow_smem(ring_decode_kernel<T, Paged, R>, smem);
  int blocks = -1;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, ring_decode_kernel<T, Paged, R>, kThreads, smem);
  return err == cudaSuccess ? blocks : -1;
}

template <typename T, bool Paged>
int occupancy(int rows, int d, int group, int depth) {
  switch (rows) {
    case 16: return occupancy_rows<T, Paged, 16>(d, group, depth);
    case 32: return occupancy_rows<T, Paged, 32>(d, group, depth);
    case 64: return occupancy_rows<T, Paged, 64>(d, group, depth);
  }
  return -1;
}

// ``rows``: the cache rows of a ring word, 16, 32 or 64 (ops.py
// _word_rows: as many as keep a stage within 16 KB).
template <typename T, bool Paged>
int launch(const Args<T>& a, int b, int rows, void* stream) {
  if (b * a.kvh == 0) return 0;
  switch (rows) {
    case 16: return launch_rows<T, Paged, 16>(a, b, stream);
    case 32: return launch_rows<T, Paged, 32>(a, b, stream);
    case 64: return launch_rows<T, Paged, 64>(a, b, stream);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
Args<T> args(const void* q, const void* lengths, void* out, int kvh,
             int group, int d, float scale, int depth, int streams,
             int split, void* ws, void* tickets) {
  Args<T> a{};
  a.q = static_cast<const T*>(q);
  a.lengths = static_cast<const int32_t*>(lengths);
  a.out = static_cast<T*>(out);
  a.ws = static_cast<float*>(ws);
  a.tickets = static_cast<unsigned*>(tickets);
  a.kvh = kvh, a.group = group, a.d = d, a.scale = scale;
  a.depth = depth, a.streams = streams, a.split = split;
  return a;
}

template <typename T>
int contiguous(const void* q, const void* k, const void* v,
               const void* lengths, void* out, int b, int kvh, int group,
               int d, int s, long long k_sb, long long k_sh, long long k_ss,
               long long v_sb, long long v_sh, long long v_ss, float scale,
               int depth, int streams, int split, int rows, void* ws,
               void* tickets, void* stream) {
  Args<T> a = args<T>(q, lengths, out, kvh, group, d, scale, depth, streams,
                      split, ws, tickets);
  a.k = static_cast<const T*>(k);
  a.v = static_cast<const T*>(v);
  a.s = s;
  a.k_sb = k_sb, a.k_sh = k_sh, a.k_ss = k_ss;
  a.v_sb = v_sb, a.v_sh = v_sh, a.v_ss = v_ss;
  const long long bytes = sizeof(T);
  a.vec = aligned16(k) && aligned16(v) && (d * bytes) % 16 == 0 &&
          (k_sb * bytes) % 16 == 0 && (k_sh * bytes) % 16 == 0 &&
          (k_ss * bytes) % 16 == 0 && (v_sb * bytes) % 16 == 0 &&
          (v_sh * bytes) % 16 == 0 && (v_ss * bytes) % 16 == 0;
  return launch<T, false>(a, b, rows, stream);
}

template <typename T>
int paged(const void* q, const void* pool, const void* tables,
          const void* lengths, void* out, int b, int kvh, int group, int d,
          int page, int n_pages, int n_blocks, float scale, int depth,
          int streams, int split, int rows, void* ws, void* tickets,
          void* stream) {
  Args<T> a = args<T>(q, lengths, out, kvh, group, d, scale, depth, streams,
                      split, ws, tickets);
  a.k = a.v = static_cast<const T*>(pool);
  a.tables = static_cast<const int32_t*>(tables);
  a.page = page, a.n_pages = n_pages, a.n_blocks = n_blocks;
  a.s = page * n_pages;
  a.vec = aligned16(pool) && (d * sizeof(T)) % 16 == 0;
  return launch<T, true>(a, b, rows, stream);
}

}  // namespace

#define REPRO_DECODE_ENTRIES(SUFFIX, T)                                       \
  extern "C" int ff_decode_attention_##SUFFIX(                                \
      const void* q, const void* k, const void* v, const void* lengths,       \
      void* out, int b, int kvh, int group, int d, int s, long long k_sb,     \
      long long k_sh, long long k_ss, long long v_sb, long long v_sh,         \
      long long v_ss, float scale, int depth, int streams, int split,         \
      int rows, void* ws, void* tickets, void* stream) {                      \
    return contiguous<T>(q, k, v, lengths, out, b, kvh, group, d, s, k_sb,    \
                         k_sh, k_ss, v_sb, v_sh, v_ss, scale, depth, streams, \
                         split, rows, ws, tickets, stream);                   \
  }                                                                           \
  extern "C" int ff_paged_decode_attention_##SUFFIX(                          \
      const void* q, const void* pool, const void* tables,                    \
      const void* lengths, void* out, int b, int kvh, int group, int d,       \
      int page, int n_pages, int n_blocks, float scale, int depth,            \
      int streams, int split, int rows, void* ws, void* tickets,              \
      void* stream) {                                                         \
    return paged<T>(q, pool, tables, lengths, out, b, kvh, group, d, page,    \
                    n_pages, n_blocks, scale, depth, streams, split, rows,    \
                    ws, tickets, stream);                                     \
  }

REPRO_DECODE_ENTRIES(f32, float)
REPRO_DECODE_ENTRIES(bf16, __nv_bfloat16)

// Blocks of the decode kernel (paged or contiguous, bf16 or f32, words of
// ``rows`` cache rows) one SM holds at once at ``depth``; -1 on a shape
// the kernel does not take.
extern "C" int ff_decode_attention_occupancy(int w16, int paged, int rows,
                                             int d, int group, int depth) {
  if (depth < 1 || d < 1 || d > kMaxD || group < 1) return -1;
  if (w16)
    return paged ? occupancy<__nv_bfloat16, true>(rows, d, group, depth)
                 : occupancy<__nv_bfloat16, false>(rows, d, group, depth);
  return paged ? occupancy<float, true>(rows, d, group, depth)
               : occupancy<float, false>(rows, d, group, depth);
}
