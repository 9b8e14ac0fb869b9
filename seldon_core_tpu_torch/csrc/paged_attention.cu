// Paged-attention decode read (s = 1) for Hopper, bf16 or int8 KV pool.
//
// Replaces the TPU kernel seldon_core_tpu/ops/paged_attention.py
// (paged_attention, Pallas body _kernel, both branches): decode attention
// over a paged KV pool addressed through per-sequence block tables, masked
// softmax in f32. The int8 pool (the 5-tuple: int8 K/V plus a float32 scale
// per position and kv head) is read as int8 and scaled once per key: the
// key's scale multiplies its dot product (s_k * (q . k_q)) and the value's
// scale the key's probability (p * s_v), which is the Pallas body's
// kq.astype(f32) * ks up to float32 rounding order.
//
// What bounds it on the card: bytes. Each (sequence, kv head) streams the K
// and V rows of every page its block table names up to the query's page,
// once, and does ~4 flops per loaded element — far below the ~295
// flops/byte of an H100's bf16 balance point. Design, and what it does about
// that:
//   * split over key chunks: the grid is (kv heads x head tiles, sequences,
//     S). A chunk is `chunk` keys of one page (a divisor of the page size);
//     CTA s of a row takes the s-th of S equal contiguous ranges of the
//     chunks its row walks (pages 0 .. max(1, min(n_pages, qpos / ps + 1))
//     - 1, read from qpos on the card), so short and long rows alike spread
//     over S CTAs and a decode batch of a few sequences still fills 132
//     SMs. S comes from the host's plan (ops/paged_attention._split_plan),
//     a function of shapes only: the host never reads a position. A CTA
//     whose range is empty (S more than the walked chunks) writes an empty
//     partial;
//   * combine in the same launch: with S > 1 each CTA writes its partial
//     (running max m, normaliser l, unnormalised accumulator acc[G][HD], all
//     f32, in base 2) to a workspace, fences, and bumps a per-(sequence, kv
//     head, head tile) counter; the CTA that arrives last merges the S
//     partials by log-sum-exp, writes out in bf16 and resets the counter to
//     0, so the counters are zero between launches and one call is one
//     launch. With S == 1 the CTA writes out directly;
//   * 16-byte loads: every K and V row is copied as 16-byte cp.async
//     vectors (through L1 for a bf16 pool, around it for int8: each was
//     faster so), HD/8 lanes per bf16 row and HD/16 per int8 row, so one warp
//     instruction covers 32 / lanes-per-row keys; a dot product is reduced
//     with shuffles inside its lane group. int8 codes become floats by byte
//     permutation (2^23 + u - (2^23 + 128)), exact and off the conversion
//     unit;
//   * bytes in flight without registers: each warp streams its share of the
//     CTA's keys (units of 32/lanes-per-row x 4 keys, dealt round robin over
//     the four warps) through its own ring of 3 shared-memory slots, two
//     units ahead of the one it computes; every lane copies the K and V
//     bytes it later reads itself, so the key loop has no block-wide
//     barrier. Each warp runs its own online softmax, keeping acc for its 8
//     or 16 dims of a key row in registers; the lane groups and then the
//     warps are merged once per CTA, through shuffles and shared memory;
//   * GQA: a CTA serves a head tile of GT = min(8, next power of two >= G)
//     query heads of one kv head, so up to G = 8 each K and V byte is read
//     once per kv head for all G query heads (G > 8 takes ceil(G / 8) head
//     tiles);
//   * masking is exactly the reference's: a key attends iff pos <= qpos, and
//     a masked logit is -FLT_MAX (finfo(float32).min), never -inf, so a row
//     with nothing to attend (an all-NULL_PAGE table) averages V over the
//     keys it walks and stays finite. The merge keeps that: an empty split
//     (m = -FLT_MAX, l = 0) adds nothing, a walked but fully masked one
//     (m = -FLT_MAX, l = its key count) counts its keys with weight 1 while
//     no split holds a real logit, and weight 0 once one does;
//   * one templated body for both pools: the pool type (Bf16Pool / Int8Pool)
//     supplies the 16-byte loads, the unpacking and the per-key scales;
//   * partial mode, for a pool whose sequence pages are spread over 'seq'
//     ranks (models/sharded.py): a rank's table holds global page indices
//     offset, offset + stride, ... of each sequence, so the walk stops after
//     the pages up to the query's page among those, none where the rank
//     holds no page of the row (every CTA empty: m = -FLT_MAX, l = 0, which
//     merges to nothing). Instead of bf16 out it writes each (row, head)'s
//     unnormalised f32 accumulator and (m, l), m in natural-log units, the
//     state the in-launch combine already holds, for
//     parallel/collectives.softmax_merge to combine the ranks. With stride 1,
//     offset 0 and no partial buffers the launch is the one-rank read.
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
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Asynchronous global -> shared copies (cp.async); src_size 0 writes zeros
// and reads nothing. kL1: through L1 (.ca) or around it (.cg).
template <bool kL1>
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (kL1) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
                 "r"(valid ? 16 : 0));
  } else {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
                 "r"(valid ? 16 : 0));
  }
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// K/V rows of the pool: row = (page * ps + t) * kvh + kv_head, HD elements;
// an int8 pool's scales are [P, ps, kvh] floats, one per row. kCopyViaL1
// picks the copy's cache path: timed in turns on an H100, copying through
// L1 made the bf16 pool 8-14 % faster and the int8 pool 0-11 % slower.
struct Bf16Pool {
  static constexpr int kPerVec = 8;  // elements per 16-byte vector
  static constexpr bool kScaled = false;
  static constexpr bool kCopyViaL1 = true;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  template <int HD>
  __device__ __forceinline__ const void* key_row(size_t row) const { return k + row * HD; }
  template <int HD>
  __device__ __forceinline__ const void* value_row(size_t row) const { return v + row * HD; }
  // bf16 -> f32 is the high half of the f32's bits
  static __device__ __forceinline__ void unpack(const uint4& r, float (&f)[kPerVec]) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

struct Int8Pool {
  static constexpr int kPerVec = 16;
  static constexpr bool kScaled = true;
  static constexpr bool kCopyViaL1 = false;
  const int8_t* k;
  const float* k_scale;  // [P, ps, kvh]: one scale per row
  const int8_t* v;
  const float* v_scale;
  template <int HD>
  __device__ __forceinline__ const void* key_row(size_t row) const { return k + row * HD; }
  template <int HD>
  __device__ __forceinline__ const void* value_row(size_t row) const { return v + row * HD; }
  // int8 x -> f32: flip the sign bit (u = x + 128), put u under the
  // exponent of 2^23 and subtract 2^23 + 128. Exact.
  static __device__ __forceinline__ void unpack(const uint4& r, float (&f)[kPerVec]) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t u = w[i] ^ 0x80808080u;
#pragma unroll
      for (int b = 0; b < 4; ++b)
        f[4 * i + b] = __uint_as_float(__byte_perm(u, 0x4b000000u, 0x7650 + b)) - 8388736.f;
    }
  }
};

// keys per lane per unit, and the slots of each warp's ring (units in
// flight: kStages - 1 ahead of the one computed). 4 and 3 were the fastest
// of (2, 6), (4, 3), (4, 4), (8, 3) at the six shapes of chip_smoke.py's
// K1 rows on an H100.
constexpr int kKeysPerLane = 4;
constexpr int kStages = 3;

// One ring slot: a unit of W keys' K rows, V rows (ROWB bytes each), then
// their positions and (int8 pool) K and V scales, 4 bytes each.
template <int W, int ROWB>
struct StageLayout {
  static constexpr int kBytes = 2 * W * ROWB + 3 * W * 4;
  static __device__ __forceinline__ int k(int key) { return key * ROWB; }
  static __device__ __forceinline__ int v(int key) { return (W + key) * ROWB; }
  static __device__ __forceinline__ int pos(int key) { return 2 * W * ROWB + key * 4; }
  static __device__ __forceinline__ int ks(int key) { return 2 * W * ROWB + (W + key) * 4; }
  static __device__ __forceinline__ int vs(int key) { return 2 * W * ROWB + (2 * W + key) * 4; }
};

// Workspace of a launch with S > 1, per (sequence, kv head, head tile)
// "pair" and split: acc [pairs][S][GT][HD] floats, then (m, l) [pairs][S][GT].
template <int HD, int GT>
struct Workspace {
  float* base;
  int pairs, splits;
  __device__ __forceinline__ float* acc(int pair, int s) const {
    return base + ((size_t)pair * splits + s) * GT * HD;
  }
  __device__ __forceinline__ float2* ml(int pair, int s) const {
    return reinterpret_cast<float2*>(base + (size_t)pairs * splits * GT * HD) +
           ((size_t)pair * splits + s) * GT;
  }
};

template <int HD, class Pool, int GT>
__global__ void __launch_bounds__(kThreads)
paged_attention_decode_kernel(const __nv_bfloat16* __restrict__ q,      // [b, h, HD]
                              const Pool pool,                          // K/V [P, ps, kvh, HD]
                              const int32_t* __restrict__ pos_pool,     // [P, ps]
                              const int32_t* __restrict__ block_tables, // [b, n_pages]
                              const int32_t* __restrict__ qpos,         // [b]
                              __nv_bfloat16* __restrict__ out,          // [b, h, HD]
                              float* __restrict__ workspace,            // S > 1 only
                              unsigned int* __restrict__ counters,      // [pairs], S > 1 only
                              float* __restrict__ part_acc,             // [b, h, HD], partial
                              float2* __restrict__ part_ml,             // [b, h], partial
                              int h, int kvh, int ps, int n_pages, int chunk, float scale,
                              int stride, int offset) {
  constexpr int E = Pool::kPerVec;      // elements per lane per row
  constexpr int LPK = HD / E;           // lanes per key row
  constexpr int KPW = 32 / LPK;         // keys per warp load instruction
  constexpr int W = KPW * kKeysPerLane;  // keys per warp per unit
  constexpr int ROWB = LPK * 16;        // bytes of one K or V row
  constexpr bool kQRegs = GT * E <= 32; // q fragment in registers, else read from smem
  static_assert(LPK >= 1 && LPK <= 32 && 32 % LPK == 0, "head dim");
  using Stage = StageLayout<W, ROWB>;

  const int G = h / kvh;
  const int n_ht = (G + GT - 1) / GT;
  const int kv_head = blockIdx.x / n_ht;
  const int ht = blockIdx.x % n_ht;
  const int seq = blockIdx.y;
  const int split = blockIdx.z;
  const int S = gridDim.z;
  const int head0 = kv_head * G + ht * GT;
  const int gv = min(GT, G - ht * GT);  // live heads of this tile
  const int pair = (seq * kvh + kv_head) * n_ht + ht;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int grp = lane / LPK;  // which key of a load instruction
  const int sub = lane % LPK;  // which 16 bytes of the row

  // dynamic shared memory: each warp's ring of kStages units during the
  // key loop, then the warps' accumulators [kWarps][GT][HD] floats
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(16) float q_s[GT][HD];
  __shared__ float wm_s[kWarps][GT];
  __shared__ float wl_s[kWarps][GT];
  __shared__ int last_s;
  float(*wacc_s)[GT][HD] = reinterpret_cast<float(*)[GT][HD]>(smem);

  // Page j of a sequence holds positions [j*ps, (j+1)*ps) or PAD_POS (the
  // batcher resets a page's positions when it hands the page out), so no
  // page past the query position's page has a key to attend: stop there.
  // Table entry i is the sequence's page offset + i * stride. Outside
  // partial mode at least one page is read, so a row with nothing to attend
  // still averages V (as the reference's all-masked softmax does).
  const int qp = qpos[seq];
  const int gp = qp / ps;
  int last_page = gp >= offset ? min(n_pages, (gp - offset) / stride + 1) : 0;
  if (part_acc == nullptr) last_page = max(1, last_page);
  const int n_chunks = last_page * (ps / chunk);
  const int per = (n_chunks + S - 1) / S;
  const int c0 = split * per;
  const int c1 = min(n_chunks, c0 + per);
  const bool walked = c0 < n_chunks;

  // per-warp online softmax state (base 2): max, normaliser, accumulator
  float m[GT], l[GT], acc[GT][E];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    m[g] = -FLT_MAX;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
  }

  if (walked) {
    // q of the tile's heads, times the softmax scale and log2(e)
    for (int e = tid; e < GT * HD; e += kThreads) {
      const int g = e / HD;
      q_s[g][e % HD] = g < gv ? __bfloat162float(q[((size_t)seq * h + head0) * HD + e]) *
                                    (scale * kLog2e)
                              : 0.f;
    }

    // The CTA's keys [kb, ke) are dealt to the warps in units of W keys,
    // round robin: unit u covers keys kb + u*W ... (a unit may span pages
    // when the page is small). Each warp streams its units through its own
    // ring of kStages shared-memory slots with cp.async, kStages - 1 units
    // ahead of the one it computes; every lane copies the 16 bytes of K and
    // V it later reads itself. Each warp keeps the page ids of a window of
    // 32 pages in a register (lane i holds page wbase + i) and reads a
    // key's page by shuffle.
    const int32_t* bt_row = block_tables + (size_t)seq * n_pages;
    const int kb = c0 * chunk;
    const int ke = c1 * chunk;
    const int n_units = (ke - kb + W - 1) / W;
    const int my_units = warp < n_units ? (n_units - warp + kWarps - 1) / kWarps : 0;
    const int ps_shift = (ps & (ps - 1)) == 0 ? __ffs(ps) - 1 : -1;
    int wbase = kb / ps;
    int window = wbase + lane < n_pages ? __ldg(bt_row + wbase + lane) : 0;
    unsigned char* ring = smem + (size_t)warp * kStages * Stage::kBytes;

    // copy this warp's k-th unit into ring slot k % kStages
    auto issue = [&](int k) {
      unsigned char* slot = ring + (k % kStages) * Stage::kBytes;
      const int j0 = kb + (warp + k * kWarps) * W;
      if ((min(j0 + W, ke) - 1) / ps - wbase >= 32) {  // past the window: slide it
        wbase = j0 / ps;
        window = wbase + lane < n_pages ? __ldg(bt_row + wbase + lane) : 0;
      }
#pragma unroll
      for (int i = 0; i < kKeysPerLane; ++i) {
        const int key = i * KPW + grp;  // the key's index in the unit
        const int j = j0 + key;
        const bool valid = j < ke;
        const int pi = ps_shift >= 0 ? j >> ps_shift : j / ps;
        const int widx = pi - wbase;
        int page_id = __shfl_sync(0xffffffffu, window, widx & 31);
        if (valid && (unsigned)widx >= 32u) page_id = __ldg(bt_row + pi);  // > 32 pages
        const size_t prow = valid ? (size_t)page_id * ps + (j - pi * ps) : 0;
        const size_t row = prow * kvh + kv_head;
        cp_async16<Pool::kCopyViaL1>(slot + Stage::k(key) + sub * 16,
                   static_cast<const unsigned char*>(pool.template key_row<HD>(row)) + sub * 16,
                   valid);
        cp_async16<Pool::kCopyViaL1>(slot + Stage::v(key) + sub * 16,
                   static_cast<const unsigned char*>(pool.template value_row<HD>(row)) +
                       sub * 16,
                   valid);
        if (sub == 0) {
          cp_async4(slot + Stage::pos(key), pos_pool + prow, valid);
          if constexpr (Pool::kScaled) {
            cp_async4(slot + Stage::ks(key), pool.k_scale + row, valid);
            cp_async4(slot + Stage::vs(key), pool.v_scale + row, valid);
          }
        }
      }
    };

#pragma unroll
    for (int k = 0; k < kStages - 1; ++k) {
      if (k < my_units) issue(k);
      cp_async_commit();
    }
    __syncthreads();  // q_s
    float qr[kQRegs ? GT : 1][kQRegs ? E : 1];
    if constexpr (kQRegs) {
#pragma unroll
      for (int g = 0; g < GT; ++g)
#pragma unroll
        for (int e = 0; e < E; ++e) qr[g][e] = q_s[g][sub * E + e];
    }

    for (int k = 0; k < my_units; ++k) {
      if (k + kStages - 1 < my_units) issue(k + kStages - 1);
      cp_async_commit();
      cp_async_wait<kStages - 1>();  // this lane's copies of unit k have landed
      __syncwarp();                  // and the other lanes' (positions, scales)
      const unsigned char* slot = ring + (k % kStages) * Stage::kBytes;
      const int j0 = kb + (warp + k * kWarps) * W;
      bool valid[kKeysPerLane];
      int pos[kKeysPerLane];
      float ksc[kKeysPerLane], vsc[kKeysPerLane];
#pragma unroll
      for (int i = 0; i < kKeysPerLane; ++i) {
        const int key = i * KPW + grp;
        valid[i] = j0 + key < ke;
        pos[i] = *reinterpret_cast<const int*>(slot + Stage::pos(key));
        ksc[i] = Pool::kScaled ? *reinterpret_cast<const float*>(slot + Stage::ks(key)) : 1.f;
        vsc[i] = Pool::kScaled ? *reinterpret_cast<const float*>(slot + Stage::vs(key)) : 1.f;
      }
      // partial dot products over this lane's E dims, then the lane group
      float dot[kKeysPerLane][GT];
#pragma unroll
      for (int i = 0; i < kKeysPerLane; ++i) {
        float kf[E];
        Pool::unpack(*reinterpret_cast<const uint4*>(slot + Stage::k(i * KPW + grp) + sub * 16),
                     kf);
#pragma unroll
        for (int g = 0; g < GT; ++g) {
          float d = 0.f;
          if constexpr (kQRegs) {
#pragma unroll
            for (int e = 0; e < E; ++e) d = fmaf(qr[g][e], kf[e], d);
          } else {
            const float4* qv = reinterpret_cast<const float4*>(&q_s[g][sub * E]);
#pragma unroll
            for (int e4 = 0; e4 < E / 4; ++e4) {
              const float4 x = qv[e4];
              d = fmaf(x.x, kf[4 * e4], d);
              d = fmaf(x.y, kf[4 * e4 + 1], d);
              d = fmaf(x.z, kf[4 * e4 + 2], d);
              d = fmaf(x.w, kf[4 * e4 + 3], d);
            }
          }
          dot[i][g] = d;
        }
      }
#pragma unroll
      for (int i = 0; i < kKeysPerLane; ++i)
#pragma unroll
        for (int g = 0; g < GT; ++g)
#pragma unroll
          for (int o = LPK / 2; o >= 1; o /= 2)
            dot[i][g] += __shfl_xor_sync(0xffffffffu, dot[i][g], o);
      // masked logits; the unit's max over every lane group; online update
      float pv[kKeysPerLane][GT];
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        float lg[kKeysPerLane];
        float tm = -FLT_MAX;
#pragma unroll
        for (int i = 0; i < kKeysPerLane; ++i) {
          lg[i] = pos[i] <= qp ? dot[i][g] * ksc[i] : -FLT_MAX;
          if (valid[i]) tm = fmaxf(tm, lg[i]);
        }
#pragma unroll
        for (int o = LPK; o < 32; o *= 2) tm = fmaxf(tm, __shfl_xor_sync(0xffffffffu, tm, o));
        const float m_new = fmaxf(m[g], tm);
        float psum = 0.f;
#pragma unroll
        for (int i = 0; i < kKeysPerLane; ++i) {
          const float p = valid[i] ? exp2f(lg[i] - m_new) : 0.f;
          psum += p;
          pv[i][g] = p * vsc[i];
        }
        if (m_new != m[g]) {  // warp-uniform: rescale only when the max moved
          const float alpha = exp2f(m[g] - m_new);
          l[g] *= alpha;
#pragma unroll
          for (int e = 0; e < E; ++e) acc[g][e] *= alpha;
          m[g] = m_new;
        }
        l[g] += psum;
      }
#pragma unroll
      for (int i = 0; i < kKeysPerLane; ++i) {
        float vf[E];
        Pool::unpack(*reinterpret_cast<const uint4*>(slot + Stage::v(i * KPW + grp) + sub * 16),
                     vf);
#pragma unroll
        for (int g = 0; g < GT; ++g)
#pragma unroll
          for (int e = 0; e < E; ++e) acc[g][e] = fmaf(pv[i][g], vf[e], acc[g][e]);
      }
      __syncwarp();  // every lane is done with the slot before it is refilled
    }
    cp_async_wait<0>();
    __syncthreads();  // the rings are free: the accumulators take their place
    // sum the lane groups of the warp (same dims, other keys; m is uniform
    // across the warp), then hand the warp's state to shared memory
#pragma unroll
    for (int o = LPK; o < 32; o *= 2)
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        l[g] += __shfl_xor_sync(0xffffffffu, l[g], o);
#pragma unroll
        for (int e = 0; e < E; ++e) acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], o);
      }
    if (grp == 0) {
#pragma unroll
      for (int g = 0; g < GT; ++g)
#pragma unroll
        for (int e = 0; e < E; ++e) wacc_s[warp][g][sub * E + e] = acc[g][e];
    }
    if (lane == 0) {
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        wm_s[warp][g] = m[g];
        wl_s[warp][g] = l[g];
      }
    }
    __syncthreads();
  }

  // merge the warps (an empty CTA's state stays empty: m = -FLT_MAX, l = 0)
  const Workspace<HD, GT> ws{workspace, (int)(gridDim.x * gridDim.y), S};
  for (int e = tid; e < GT * HD; e += kThreads) {
    const int g = e / HD;
    const int d = e % HD;
    float M = -FLT_MAX, L = 0.f, A = 0.f;
    if (walked) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) M = fmaxf(M, wm_s[w][g]);
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float s = exp2f(wm_s[w][g] - M);
        L = fmaf(wl_s[w][g], s, L);
        A = fmaf(wacc_s[w][g][d], s, A);
      }
    }
    if (S == 1) {
      const size_t row = (size_t)seq * h + head0 + g;
      if (g >= gv) continue;
      if (part_acc != nullptr) {
        part_acc[row * HD + d] = A;
        if (d == 0) part_ml[row] = make_float2(M * kLn2, L);
      } else {
        out[row * HD + d] = __float2bfloat16(A / L);
      }
    } else {
      ws.acc(pair, split)[e] = A;
      if (d == 0) ws.ml(pair, split)[g] = make_float2(M, L);
    }
  }
  if (S == 1) return;

  // last CTA of the pair merges the S partials: each CTA's stores are made
  // visible device-wide before its arrival is counted; the last arrival
  // sees every other CTA's stores after its own fence, and reads them from
  // L2 (ld.cg), never a stale L1 line
  __threadfence();
  __syncthreads();
  if (tid == 0) last_s = atomicAdd(counters + pair, 1u) == (unsigned int)(S - 1);
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  for (int e = tid; e < GT * HD; e += kThreads) {
    const int g = e / HD;
    if (g >= gv) continue;
    float M = -FLT_MAX;
    for (int s = 0; s < S; ++s) M = fmaxf(M, __ldcg(ws.ml(pair, s) + g).x);
    float L = 0.f, A = 0.f;
    for (int s = 0; s < S; ++s) {
      const float2 ml = __ldcg(ws.ml(pair, s) + g);
      const float w = exp2f(ml.x - M);
      L = fmaf(ml.y, w, L);
      A = fmaf(__ldcg(ws.acc(pair, s) + e), w, A);
    }
    const size_t row = (size_t)seq * h + head0 + g;
    if (part_acc != nullptr) {
      part_acc[row * HD + e % HD] = A;
      if (e % HD == 0) part_ml[row] = make_float2(M * kLn2, L);
    } else {
      out[row * HD + e % HD] = __float2bfloat16(A / L);
    }
  }
  if (tid == 0) counters[pair] = 0u;  // zero again for the next launch
}

template <int HD, class Pool, int GT>
cudaError_t launch(const void* q, const Pool& pool, const void* pos_pool,
                   const void* block_tables, const void* qpos, void* out, int b, int h, int kvh,
                   int ps, int n_pages, float scale, int splits, int chunk, void* workspace,
                   void* counters, int stride, int offset, void* part_acc, void* part_ml,
                   cudaStream_t stream) {
  constexpr int LPK = HD / Pool::kPerVec;
  using Stage = StageLayout<(32 / LPK) * kKeysPerLane, LPK * 16>;
  constexpr int kRings = kWarps * kStages * Stage::kBytes;
  constexpr int kAccs = kWarps * GT * HD * (int)sizeof(float);
  constexpr int kSmem = kRings > kAccs ? kRings : kAccs;
  auto kernel = paged_attention_decode_kernel<HD, Pool, GT>;
  static unsigned sized = 0;  // devices whose attribute is set, one bit each
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 32 || !(sized >> dev & 1u)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return err;
    if (dev < 32) sized |= 1u << dev;
  }
  const int n_ht = (h / kvh + GT - 1) / GT;
  dim3 grid(kvh * n_ht, b, splits);
  kernel<<<grid, kThreads, kSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), pool, static_cast<const int32_t*>(pos_pool),
      static_cast<const int32_t*>(block_tables), static_cast<const int32_t*>(qpos),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(workspace),
      static_cast<unsigned int*>(counters), static_cast<float*>(part_acc),
      static_cast<float2*>(part_ml), h, kvh, ps, n_pages, chunk, scale, stride, offset);
  return cudaGetLastError();
}

template <int HD, class Pool>
cudaError_t launch_gt(int head_tile, const void* q, const Pool& pool, const void* pos_pool,
                      const void* block_tables, const void* qpos, void* out, int b, int h,
                      int kvh, int ps, int n_pages, float scale, int splits, int chunk,
                      void* workspace, void* counters, int stride, int offset, void* part_acc,
                      void* part_ml, cudaStream_t s) {
#define PA_LAUNCH(GT)                                                                     \
  launch<HD, Pool, GT>(q, pool, pos_pool, block_tables, qpos, out, b, h, kvh, ps, n_pages, \
                       scale, splits, chunk, workspace, counters, stride, offset, part_acc, \
                       part_ml, s)
  switch (head_tile) {
    case 1: return PA_LAUNCH(1);
    case 2: return PA_LAUNCH(2);
    case 4: return PA_LAUNCH(4);
    case 8: return PA_LAUNCH(8);
    default: return cudaErrorInvalidValue;
  }
#undef PA_LAUNCH
}

// Shapes and dtypes are checked by the Python wrapper; here only what would
// make the launch itself wrong is rejected: an unsupported head dim or head
// tile, a chunk that does not divide the page, S < 1, S > 1 without a
// workspace and counters, a stride < 1 or offset outside [0, stride), or
// only one of the two partial outputs.
template <class Pool>
int launch_hd(int hd, const void* q, const Pool& pool, const void* pos_pool,
              const void* block_tables, const void* qpos, void* out, int b, int h, int kvh,
              int ps, int n_pages, float scale, int splits, int chunk, int head_tile,
              void* workspace, void* counters, int stride, int offset, void* part_acc,
              void* part_ml, void* stream) {
  if (kvh < 1 || h % kvh || ps < 1 || chunk < 1 || ps % chunk || splits < 1 ||
      (splits > 1 && (workspace == nullptr || counters == nullptr)) || stride < 1 ||
      offset < 0 || offset >= stride || (part_acc == nullptr) != (part_ml == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
#define PA_HD(HD)                                                                           \
  case HD:                                                                                  \
    return launch_gt<HD>(head_tile, q, pool, pos_pool, block_tables, qpos, out, b, h, kvh, ps, \
                         n_pages, scale, splits, chunk, workspace, counters, stride, offset,  \
                         part_acc, part_ml, s);
    PA_HD(32)
    PA_HD(64)
    PA_HD(128)
#undef PA_HD
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Each entry point returns the cudaError_t of the launch (0 = success).
// splits: S, the CTAs per (sequence, kv head, head tile); chunk: keys per
// chunk (divides ps); head_tile: query heads per CTA (1, 2, 4 or 8);
// workspace: pairs * S * head_tile * (hd + 2) floats and counters: pairs
// zeroed uint32 (pairs = b * kvh * ceil(h / kvh / head_tile)), both unused
// when S == 1. stride / offset: the global page indices a table entry
// names (1 / 0 for a whole table); part_acc ([b, h, hd] f32) and part_ml
// ([b, h] float2: m, l): the partial mode's outputs, out unused (both null:
// the bf16 out).
extern "C" int paged_attention_decode_bf16(const void* q, const void* k_pool, const void* v_pool,
                                           const void* pos_pool, const void* block_tables,
                                           const void* qpos, void* out, int b, int h, int kvh,
                                           int hd, int ps, int n_pages, float scale, int splits,
                                           int chunk, int head_tile, void* workspace,
                                           void* counters, int stride, int offset, void* part_acc,
                                           void* part_ml, void* stream) {
  const Bf16Pool pool{static_cast<const __nv_bfloat16*>(k_pool),
                      static_cast<const __nv_bfloat16*>(v_pool)};
  return launch_hd(hd, q, pool, pos_pool, block_tables, qpos, out, b, h, kvh, ps, n_pages, scale,
                   splits, chunk, head_tile, workspace, counters, stride, offset, part_acc,
                   part_ml, stream);
}

extern "C" int paged_attention_decode_int8(const void* q, const void* k_pool, const void* k_scale,
                                           const void* v_pool, const void* v_scale,
                                           const void* pos_pool, const void* block_tables,
                                           const void* qpos, void* out, int b, int h, int kvh,
                                           int hd, int ps, int n_pages, float scale, int splits,
                                           int chunk, int head_tile, void* workspace,
                                           void* counters, int stride, int offset, void* part_acc,
                                           void* part_ml, void* stream) {
  const Int8Pool pool{static_cast<const int8_t*>(k_pool), static_cast<const float*>(k_scale),
                      static_cast<const int8_t*>(v_pool), static_cast<const float*>(v_scale)};
  return launch_hd(hd, q, pool, pos_pool, block_tables, qpos, out, b, h, kvh, ps, n_pages, scale,
                   splits, chunk, head_tile, workspace, counters, stride, offset, part_acc,
                   part_ml, stream);
}
