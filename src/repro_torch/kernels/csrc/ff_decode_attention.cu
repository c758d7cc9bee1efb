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
// and used for 4*G operations per element pair, so decode is bound by
// device memory (3.35 TB/s): the least time is the live KV bytes plus q and
// out over that rate. This first kernel runs one block per (b, kv head):
// at 4 slots x 16 KV heads that is 64 blocks for 132 SMs, and each block
// walks its tiles one after the other, so it is bound by latency, not by
// bandwidth. Split-KV and TMA rings are for later work.
//
// Design: the only difference between the two instantiations is how tile
// kj's K/V row pointer is formed: a strided offset into the contiguous cache
// (which may be a transposed view of the serving cache [B,S,KVH,D]: no copy)
// or pool[clip(block_tables[b,kj])]. The tile order, the skip rule
// (kv_start >= length), the in-tile reduction order and the f32
// accumulation are the same code, so at block_kv == page the paged result
// equals the contiguous one bit for bit, as it does in the reference. The
// TPU kernel padded the query group to 8 rows (a sublane granule); here the
// G query heads of a KV head are processed as they are. A sentinel table
// entry (>= n_blocks) is clipped to a real block and its rows are masked by
// lengths; a row with lengths == 0 runs no tile and gives exactly 0.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;

size_t smem_bytes(int group, int d, int block_kv) {
  return sizeof(float) *
         (size_t(group) * d                // q
          + size_t(block_kv) * (d + 1)     // k tile (row pad: no bank clash)
          + size_t(block_kv) * d           // v tile
          + size_t(group) * block_kv       // scores / p
          + size_t(group) * d              // acc
          + 3 * size_t(group));            // m, l, alpha
}

template <typename T, bool Paged>
__global__ void __launch_bounds__(kThreads) decode_kernel(
    const T* __restrict__ q,           // [B, KVH*G, D]
    const T* __restrict__ k,           // cache [B,KVH,S,D] (strided) | pool
    const T* __restrict__ v,           // cache [B,KVH,S,D] (strided) | pool
    const int32_t* __restrict__ lengths,  // [B]
    const int32_t* __restrict__ tables,   // [B, n_tiles] (paged only)
    T* __restrict__ out,               // [B, KVH*G, D]
    int kvh, int group, int d, int block_kv, int n_tiles, int n_blocks,
    long long k_sb, long long k_sh, long long k_ss, long long v_sb,
    long long v_sh, long long v_ss, float scale) {
  using repro::kNegInf;
  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + group * d;
  float* v_s = k_s + block_kv * (d + 1);
  float* p_s = v_s + block_kv * d;
  float* acc = p_s + group * block_kv;
  float* m_s = acc + group * d;
  float* l_s = m_s + group;
  float* a_s = l_s + group;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.x;
  const int b = bh / kvh, h = bh - b * kvh;
  const int length = lengths[b];
  const T* qb = q + size_t(bh) * group * d;

  for (int i = tid; i < group * d; i += kThreads) {
    q_s[i] = repro::to_f(qb[i]);
    acc[i] = 0.f;
  }
  for (int g = tid; g < group; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }

  // tiles with kv_start >= length are skipped (a length past the cache
  // attends to the whole cache)
  const int live =
      length <= 0 ? 0 : min(n_tiles, (length + block_kv - 1) / block_kv);
  for (int kj = 0; kj < live; ++kj) {
    const int kv_start = kj * block_kv;
    const T* kt;
    const T* vt;
    long long k_rs, v_rs;
    if constexpr (Paged) {
      int blk = tables[size_t(b) * n_tiles + kj];
      blk = min(max(blk, 0), n_blocks - 1);
      const size_t page_elems = size_t(block_kv) * kvh * d;
      kt = k + size_t(blk) * 2 * page_elems + size_t(h) * d;
      vt = kt + page_elems;
      k_rs = v_rs = (long long)kvh * d;
    } else {
      kt = k + b * k_sb + h * k_sh + kv_start * k_ss;
      vt = v + b * v_sb + h * v_sh + kv_start * v_ss;
      k_rs = k_ss;
      v_rs = v_ss;
    }
    __syncthreads();  // previous tile's readers are done with the tiles
    for (int i = tid; i < block_kv * d; i += kThreads) {
      const int j = i / d, e = i - j * d;
      k_s[j * (d + 1) + e] = repro::to_f(kt[j * k_rs + e]);
      v_s[i] = repro::to_f(vt[j * v_rs + e]);
    }
    __syncthreads();
    for (int i = tid; i < group * block_kv; i += kThreads) {
      const int g = i / block_kv, j = i - g * block_kv;
      const float* qr = q_s + g * d;
      const float* kr = k_s + j * (d + 1);
      float dot = 0.f;
      for (int e = 0; e < d; ++e) dot = fmaf(qr[e], kr[e], dot);
      float sc = dot * scale;
      if (kv_start + j >= length) sc = kNegInf;
      p_s[i] = sc;
    }
    __syncthreads();
    for (int g = warp; g < group; g += kThreads / 32) {
      float* pr = p_s + g * block_kv;
      float mx = kNegInf;
      for (int j = lane; j < block_kv; j += 32) mx = fmaxf(mx, pr[j]);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, repro::warp_max(mx));
      float sum = 0.f;
      for (int j = lane; j < block_kv; j += 32) {
        const float p = expf(pr[j] - m_new);
        sum += p;
        pr[j] = repro::to_f(repro::from_f<T>(p));
      }
      sum = repro::warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        l_s[g] = fmaf(l_s[g], alpha, sum);
        m_s[g] = m_new;
        a_s[g] = alpha;
      }
    }
    __syncthreads();
    for (int i = tid; i < group * d; i += kThreads) {
      const int g = i / d, e = i - g * d;
      const float* pr = p_s + g * block_kv;
      float pv = 0.f;
      for (int j = 0; j < block_kv; ++j) pv = fmaf(pr[j], v_s[j * d + e], pv);
      acc[i] = fmaf(acc[i], a_s[g], pv);
    }
  }
  __syncthreads();
  T* ob = out + size_t(bh) * group * d;
  for (int i = tid; i < group * d; i += kThreads) {
    float l = l_s[i / d];
    l = (l == 0.f) ? 1.f : l;
    ob[i] = repro::from_f<T>(acc[i] / l);
  }
}

template <typename T, bool Paged>
int launch(const void* q, const void* k, const void* v, const void* lengths,
           const void* tables, void* out, int b, int kvh, int group, int d,
           int block_kv, int n_tiles, int n_blocks, long long k_sb,
           long long k_sh, long long k_ss, long long v_sb, long long v_sh,
           long long v_ss, float scale, void* stream) {
  if (b * kvh == 0) return 0;
  const size_t smem = smem_bytes(group, d, block_kv);
  cudaError_t err = repro::allow_smem(decode_kernel<T, Paged>, smem);
  if (err != cudaSuccess) return err;
  decode_kernel<T, Paged><<<b * kvh, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int32_t*>(lengths),
      static_cast<const int32_t*>(tables), static_cast<T*>(out), kvh, group,
      d, block_kv, n_tiles, n_blocks, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
      scale);
  return cudaGetLastError();
}

}  // namespace

#define REPRO_DECODE_ENTRIES(SUFFIX, T)                                       \
  extern "C" int ff_decode_attention_##SUFFIX(                                \
      const void* q, const void* k, const void* v, const void* lengths,       \
      void* out, int b, int kvh, int group, int d, int block_kv,              \
      int n_tiles, long long k_sb, long long k_sh, long long k_ss,            \
      long long v_sb, long long v_sh, long long v_ss, float scale,            \
      void* stream) {                                                         \
    return launch<T, false>(q, k, v, lengths, nullptr, out, b, kvh, group,    \
                            d, block_kv, n_tiles, 1, k_sb, k_sh, k_ss, v_sb,  \
                            v_sh, v_ss, scale, stream);                       \
  }                                                                           \
  extern "C" int ff_paged_decode_attention_##SUFFIX(                          \
      const void* q, const void* pool, const void* tables,                    \
      const void* lengths, void* out, int b, int kvh, int group, int d,       \
      int page, int n_pages, int n_blocks, float scale, void* stream) {       \
    return launch<T, true>(q, pool, pool, lengths, tables, out, b, kvh,       \
                           group, d, page, n_pages, n_blocks, 0, 0, 0, 0, 0,  \
                           0, scale, stream);                                 \
  }

REPRO_DECODE_ENTRIES(f32, float)
REPRO_DECODE_ENTRIES(bf16, __nv_bfloat16)
