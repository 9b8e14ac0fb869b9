// Paged-attention decode read (s = 1) for Hopper, bf16 KV pool.
//
// Replaces the TPU kernel seldon_core_tpu/ops/paged_attention.py
// (paged_attention, Pallas body _kernel): decode attention over a paged KV
// pool addressed through per-sequence block tables, online softmax in f32.
//
// What bounds it on the card: bytes. Each (sequence, kv head) streams the K
// and V rows of every page its block table names once, and does ~4 flops per
// loaded element — far below the ~295 flops/byte of an H100's bf16 balance
// point. Design, and what it does about that:
//   * one block per (kv head, sequence), 128 threads. The block walks its
//     block-table row page by page (the loop replaces the TPU's sequential
//     grid axis) and keeps the running max, normaliser and weighted-value
//     accumulator of its G = h / kvh query heads in shared memory, so K/V
//     bytes are read exactly once per kv head no matter how many query heads
//     share it (GQA);
//   * the block reads its own block-table row and query position (the TPU
//     prefetched them as scalars), and walks only the pages up to the query
//     position's page — the bytes this step's data needs, not the table's
//     provisioned length;
//   * K rows are read one warp per key (each lane HD/32 elements, the warp
//     covering the contiguous row), V rows one thread per output element
//     (consecutive threads on consecutive addresses);
//   * masking is exactly the reference's: a key attends iff pos <= qpos, and
//     a masked logit is -FLT_MAX (finfo(float32).min), never -inf, so a row
//     with nothing to attend (an all-NULL_PAGE table) averages V and stays
//     finite instead of producing exp(-inf - -inf) = NaN.
// No split across blocks, no TMA/wgmma: a simple kernel that is right first.
//
// Built with nvcc into a shared library with a plain C interface and loaded
// with ctypes (ops/_build.py); pointers and the stream arrive as void*.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
paged_attention_decode_kernel(const __nv_bfloat16* __restrict__ q,      // [b, h, HD]
                              const __nv_bfloat16* __restrict__ k_pool, // [P, ps, kvh, HD]
                              const __nv_bfloat16* __restrict__ v_pool, // [P, ps, kvh, HD]
                              const int32_t* __restrict__ pos_pool,     // [P, ps]
                              const int32_t* __restrict__ block_tables, // [b, n_pages]
                              const int32_t* __restrict__ qpos,         // [b]
                              __nv_bfloat16* __restrict__ out,          // [b, h, HD]
                              int h, int kvh, int ps, int n_pages, float scale) {
  constexpr int kPerLane = HD / 32;
  const int kv_head = blockIdx.x;
  const int seq = blockIdx.y;
  const int G = h / kvh;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  extern __shared__ float smem[];
  float* q_s = smem;                // [G][HD]
  float* acc_s = q_s + G * HD;      // [G][HD]
  float* p_s = acc_s + G * HD;      // [G][ps] logits, then probabilities
  float* m_s = p_s + G * ps;        // [G] running max
  float* l_s = m_s + G;             // [G] running normaliser
  float* alpha_s = l_s + G;         // [G] rescale of this page

  const int head0 = kv_head * G;
  for (int e = tid; e < G * HD; e += kThreads) {
    q_s[e] = __bfloat162float(q[((size_t)seq * h + head0) * HD + e]);
    acc_s[e] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = -FLT_MAX;
    l_s[g] = 0.f;
  }
  const int qp = qpos[seq];
  const int32_t* bt_row = block_tables + (size_t)seq * n_pages;
  // Page j of a sequence holds positions [j*ps, (j+1)*ps) or PAD_POS (the
  // batcher resets a page's positions when it hands the page out), so no
  // page past the query position's page has a key to attend: stop there.
  // At least one page is read, so a row with nothing to attend still
  // averages V (as the reference's all-masked softmax does) instead of
  // dividing by zero.
  const int last = max(1, min(n_pages, qp / ps + 1));
  __syncthreads();

  for (int j = 0; j < last; ++j) {
    const size_t page = (size_t)bt_row[j];
    // 1. masked, scaled logits of this page's keys for every query head
    for (int t = warp; t < ps; t += kWarps) {
      const __nv_bfloat16* krow = k_pool + ((page * ps + t) * kvh + kv_head) * HD;
      float kr[kPerLane];
#pragma unroll
      for (int r = 0; r < kPerLane; ++r) kr[r] = __bfloat162float(krow[lane + 32 * r]);
      const bool attend = pos_pool[page * ps + t] <= qp;
      for (int g = 0; g < G; ++g) {
        float dot = 0.f;
#pragma unroll
        for (int r = 0; r < kPerLane; ++r) dot += q_s[g * HD + lane + 32 * r] * kr[r];
        dot = warp_sum(dot);
        if (lane == 0) p_s[g * ps + t] = attend ? dot * scale : -FLT_MAX;
      }
    }
    __syncthreads();
    // 2. online-softmax update of each head's max and normaliser
    for (int g = warp; g < G; g += kWarps) {
      float mx = -FLT_MAX;
      for (int t = lane; t < ps; t += 32) mx = fmaxf(mx, p_s[g * ps + t]);
      mx = warp_max(mx);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = lane; t < ps; t += 32) {
        const float p = expf(p_s[g * ps + t] - m_new);
        p_s[g * ps + t] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        alpha_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();
    // 3. rescale the accumulator and add this page's probability-weighted V
    for (int e = tid; e < G * HD; e += kThreads) {
      const int g = e / HD;
      const int d = e % HD;
      const float* p = p_s + g * ps;
      const __nv_bfloat16* vcol = v_pool + (page * ps * kvh + kv_head) * HD + d;
      float a = acc_s[e] * alpha_s[g];
      for (int t = 0; t < ps; ++t) a += p[t] * __bfloat162float(vcol[(size_t)t * kvh * HD]);
      acc_s[e] = a;
    }
    __syncthreads();
  }

  for (int e = tid; e < G * HD; e += kThreads) {
    const int g = e / HD;
    out[((size_t)seq * h + head0) * HD + e] = __float2bfloat16(acc_s[e] / l_s[g]);
  }
}

template <int HD>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool, const void* pos_pool,
                   const void* block_tables, const void* qpos, void* out, int b, int h, int kvh,
                   int ps, int n_pages, float scale, cudaStream_t stream) {
  const int G = h / kvh;
  const size_t smem = sizeof(float) * ((size_t)2 * G * HD + (size_t)G * ps + 3 * (size_t)G);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(paged_attention_decode_kernel<HD>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid(kvh, b);
  paged_attention_decode_kernel<HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k_pool),
      static_cast<const __nv_bfloat16*>(v_pool), static_cast<const int32_t*>(pos_pool),
      static_cast<const int32_t*>(block_tables), static_cast<const int32_t*>(qpos),
      static_cast<__nv_bfloat16*>(out), h, kvh, ps, n_pages, scale);
  return cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launch (0 = success). Shapes are checked by
// the Python wrapper; this entry point only rejects an unsupported head dim.
extern "C" int paged_attention_decode_bf16(const void* q, const void* k_pool, const void* v_pool,
                                           const void* pos_pool, const void* block_tables,
                                           const void* qpos, void* out, int b, int h, int kvh,
                                           int hd, int ps, int n_pages, float scale,
                                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32:
      return launch<32>(q, k_pool, v_pool, pos_pool, block_tables, qpos, out, b, h, kvh, ps,
                        n_pages, scale, s);
    case 64:
      return launch<64>(q, k_pool, v_pool, pos_pool, block_tables, qpos, out, b, h, kvh, ps,
                        n_pages, scale, s);
    case 128:
      return launch<128>(q, k_pool, v_pool, pos_pool, block_tables, qpos, out, b, h, kvh, ps,
                         n_pages, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
