// Int8 weight-only matmul (W8A16 GEMM) at decode on Hopper:
//   out[M, N] = (x[M, K] @ q[K, N]) * scale[N]
// x bf16, q int8, scale float32, out bf16 or float32, float32 accumulation.
// The wrapper (ops/int8_matmul.py) sends every product here that the prefill
// kernel (csrc/int8_matmul_wgmma.cu) does not take: every M < 64 (a decode
// step's 8 serving slots), and any M where TMA cannot address the operands.
//
// Replaces the TPU kernel seldon_core_tpu/ops/pallas_int8.py:87-139
// (int8_matmul, Pallas body _kernel) at decode: the weight crosses device
// memory as int8 and is dequantized next to the matrix unit.
//
// Numerics. The TPU kernel dequantizes its weight tile, w_kn = q_kn * s_n,
// and accumulates sum_k x_k w_kn. Here each int8 code is converted to bf16
// (exact: every int8 value is a bf16 value), multiplied on the tensor cores
// with float32 accumulation, and the scale is applied once in the epilogue:
// s_n * sum_k x_k q_kn. The scale belongs to the output column n, so it
// factors out of the sum over k: the two agree up to float32 rounding (the
// TPU form rounds every product q_kn * s_n, this one the final product
// once) and the order of summation. That order is fixed (no atomics): two
// calls on the same inputs give the same bits.
//
// What bounds it on the card: bytes. The K x N int8 weight is nearly every
// byte the call moves, at 2 * M flops per weight byte (16 at M = 8), far
// below the ~295 flops/byte of the H100's bf16 balance point. To stream it
// at the memory's rate every SM must keep ~20 KB in flight (3.35 TB/s times
// the DRAM latency, over 132 SMs), in long runs, and must spend few
// instructions per byte. Design, and what each part does about that:
//   * one launch, no workspace: a CTA owns a strip of BN = 128 or 256 output
//     columns, a tile of 8 or 16 rows of x, and one split of K. The S splits
//     of a strip (S <= 8) form one thread block cluster; each CTA leaves its
//     float32 partial tile in its own shared memory, and after the cluster
//     barrier every CTA sums a share of the tile over the S partials through
//     distributed shared memory, in rank order, scales and writes it. A
//     second barrier keeps each CTA's shared memory alive until every rank
//     has read it. The wrapper picks BN, S and the steps per split from the
//     shapes alone (ops/int8_matmul.py, _decode_plan);
//   * long runs, many bytes in flight: a stage is 16 KB of weight (BK = 128
//     rows of 128 columns, or 64 rows of 256: each row a 128- or 256-byte
//     run) plus x's [rows, BK] slice, copied with 16-byte cp.async.cg by
//     all 256 threads (neighbouring threads on neighbouring chunks of a
//     row) into a ring of kStages stages: kStages - 1 (48 KB) are in flight
//     while one is multiplied, and two CTAs fit on an SM. x is read once per
//     CTA, through the same ring; the strip's scales are fetched with the
//     first stage, so the epilogue waits on no load. (One producer warp
//     feeding consumer warps through mbarriers, and the bulk-copy engine
//     row by row, were both slower here: PERF.md);
//   * dequantized in registers, multiplied on tensor cores, no bf16 copy of
//     the weight anywhere: the product is computed transposed,
//     out^T = q^T x^T, with mma.sync m16n8k16 (bf16 in, float32 out). The
//     weight is the A operand (16 output columns x 16 k), x the B operand
//     (16 k x 8 rows of x): M = 8 fills the n = 8 side exactly, and a
//     16-row tile is two B fragments. Each warp takes one 16-deep slice of
//     a 128-column slab per stage. Its lane (g = lane / 4, t = lane % 4)
//     reads 16 bytes (16 columns) from each of the slice's rows 2t, 2t+1,
//     2t+8, 2t+9 (conflict-free: rows are padded by 16 bytes), and a byte
//     permute puts each code under a float32 magic exponent; one subtract
//     makes it exact and the high halves of two floats form the bf16 pair
//     (k, k+1) that the fragment wants: ~2.5 instructions a value;
//   * the column interleave: fragment f's row r is the slab's column
//     16 * (r % 8) + 2 * f + r / 8 (the byte order of a lane's 16-byte
//     load), so the accumulators hold columns in that order. Each warp
//     stores them in register order; the sum over the CTA's warps reads
//     them back at the natural column and writes the CTA's partial tile in
//     natural order, which the cluster merge reads with 16-byte loads;
//   * ragged edges are masked: rows past M, columns past N and depth past K
//     arrive as zeros (cp.async's zero fill) and only in-range outputs are
//     written. 16-byte copies need N % 16 == 0 and K % 8 == 0 (and 16-byte
//     aligned bases); otherwise an instantiation with masked scalar loads
//     runs, synchronously, through the same ring and the same arithmetic.
//
// Built with nvcc into a shared library with a plain C interface and loaded
// with ctypes (ops/_build.py); pointers and the stream arrive as void*.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 4;             // ring depth: kStages - 1 stages in flight
constexpr int kStageBytes = 16384;     // weight bytes per stage: BK * BN
constexpr int kSlab = 128;             // output columns per warp (16 per lane-group load)
constexpr int kMaxSplits = 8;          // portable cluster size
constexpr int kPartLd = 33;            // floats per register row of a warp's partial

// What depends on the strip width BN and the number NF of 8-row x fragments
template <int BN, int NF>
struct Tile {
  static constexpr int BK = kStageBytes / BN;         // K rows per stage: 128 or 64
  static constexpr int MT = 8 * NF;                   // rows of x per CTA
  static constexpr int CG = BN / kSlab;               // column slabs per strip
  static constexpr int KG = kWarps / CG;              // warps per slab = 16-deep slices per stage
  static_assert(KG * 16 == BK, "every warp takes one 16-deep slice of every stage");
  static constexpr int W_LD = BN + 16;                // bytes per weight row in shared memory
  static constexpr int X_LD = BK + 8;                 // bf16 per x row in shared memory
  static constexpr int W_STAGE = BK * W_LD;
  static constexpr int STAGE = W_STAGE + MT * X_LD * 2;
  static_assert(STAGE % 16 == 0, "16-byte aligned stages");
  static constexpr int REGS = NF * 8 * 4;             // accumulators per lane
  static constexpr int WARP_PART = REGS * kPartLd;    // floats of one warp's partial
  static constexpr int CTA_PART = kWarps * WARP_PART * 4;  // byte offset of the CTA's partial
  static constexpr int SMEM_RING = kStages * STAGE;
  static constexpr int SMEM_EPI = CTA_PART + MT * BN * 4;
  static constexpr int SMEM = SMEM_RING > SMEM_EPI ? SMEM_RING : SMEM_EPI;
};

// Asynchronous global -> shared copies; src_size 0 writes zeros and reads
// nothing
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One stage: the weight rows [k0, k0 + BK) of columns [n0, n0 + BN), and
// x's rows [m0, m0 + MT) at the same depth, zeros outside [M, K] x [K, N].
template <int BN, int NF, bool kVec>
__device__ __forceinline__ void load_stage(uint8_t* st, const __nv_bfloat16* __restrict__ x,
                                           const int8_t* __restrict__ q, int M, int N, int K,
                                           int m0, int n0, int k0) {
  using T = Tile<BN, NF>;
  constexpr int kRowChunks = BN / 16;
  for (int c = threadIdx.x; c < T::BK * kRowChunks; c += kThreads) {
    const int r = c / kRowChunks;
    const int gk = k0 + r;
    const int gn = n0 + (c % kRowChunks) * 16;
    uint8_t* dst = st + r * T::W_LD + (c % kRowChunks) * 16;
    if constexpr (kVec) {
      const bool ok = gk < K && gn < N;  // N % 16 == 0: all 16 in range or none
      cp_async16(dst, ok ? q + (size_t)gk * N + gn : q, ok);
    } else {
      uint32_t w[4] = {0u, 0u, 0u, 0u};
      if (gk < K) {
        const uint8_t* src = reinterpret_cast<const uint8_t*>(q) + (size_t)gk * N + gn;
#pragma unroll
        for (int e = 0; e < 16; ++e)
          if (gn + e < N) w[e / 4] |= static_cast<uint32_t>(src[e]) << (8 * (e % 4));
      }
      *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
  constexpr int kXChunks = T::BK / 8;
  for (int c = threadIdx.x; c < T::MT * kXChunks; c += kThreads) {
    const int r = c / kXChunks;
    const int gm = m0 + r;
    const int gk = k0 + (c % kXChunks) * 8;
    uint8_t* dst = st + T::W_STAGE + (r * T::X_LD + (c % kXChunks) * 8) * 2;
    if constexpr (kVec) {
      const bool ok = gm < M && gk < K;  // K % 8 == 0: all 8 in range or none
      cp_async16(dst, ok ? x + (size_t)gm * K + gk : x, ok);
    } else {
      uint32_t w[4] = {0u, 0u, 0u, 0u};
      if (gm < M) {
        const uint16_t* src = reinterpret_cast<const uint16_t*>(x) + (size_t)gm * K + gk;
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (gk + e < K) w[e / 2] |= static_cast<uint32_t>(src[e]) << (16 * (e % 2));
      }
      *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// Byte ``sel`` of ``biased`` (an int8 code + 128) as an exact float32: the
// byte under the exponent of 2^23, less 2^23 + 128.
template <int sel>
__device__ __forceinline__ float code(uint32_t biased) {
  return __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7540 | sel)) - 8388736.f;
}
// Two exact float32 values (integers of at most 8 bits) as a bf16 pair: their
// high halves, lo in the low half.
__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Fragments f = 2j and 2j + 1 from word j of the four rows' 16-byte loads
// (r0, r1: k = 2t, 2t + 1; r2, r3: k = 2t + 8, 2t + 9). Fragment f's row g
// is byte 2 * (f % 2) of the word, its row g + 8 the byte after it.
template <int NF, int j>
__device__ __forceinline__ void mma_word(float (&acc)[NF][8][4], uint32_t w0, uint32_t w1,
                                         uint32_t w2, uint32_t w3,
                                         const uint32_t (&b)[NF][2]) {
  w0 ^= 0x80808080u;
  w1 ^= 0x80808080u;
  w2 ^= 0x80808080u;
  w3 ^= 0x80808080u;
  const uint32_t a[2][4] = {
      {bf16_pair(code<0>(w0), code<0>(w1)), bf16_pair(code<1>(w0), code<1>(w1)),
       bf16_pair(code<0>(w2), code<0>(w3)), bf16_pair(code<1>(w2), code<1>(w3))},
      {bf16_pair(code<2>(w0), code<2>(w1)), bf16_pair(code<3>(w0), code<3>(w1)),
       bf16_pair(code<2>(w2), code<2>(w3)), bf16_pair(code<3>(w2), code<3>(w3))}};
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int nf = 0; nf < NF; ++nf)
      mma_bf16(acc[nf][2 * j + h], a[h][0], a[h][1], a[h][2], a[h][3], b[nf][0], b[nf][1]);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// grid (S splits, M tiles, N strips), clusters of (S, 1, 1): blockIdx.x is
// both the split and the rank in the cluster.
template <int BN, int NF, bool kVec, typename OutT>
__global__ void __launch_bounds__(kThreads, 2)
int8_matmul_decode_kernel(const __nv_bfloat16* __restrict__ x,  // [M, K]
                          const int8_t* __restrict__ q,         // [K, N]
                          const float* __restrict__ scale,      // [N]
                          OutT* __restrict__ out,               // [M, N]
                          int M, int N, int K, int steps_per_split) {
  using T = Tile<BN, NF>;
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ float sscale[BN];  // the strip's scales, fetched with the first stage
  const int split = blockIdx.x;
  const int splits = gridDim.x;
  const int m0 = blockIdx.y * T::MT;
  const int n0 = blockIdx.z * BN;
  const int k_steps = (K + T::BK - 1) / T::BK;
  const int kt0 = split * steps_per_split;
  const int n_steps = max(0, min(steps_per_split, k_steps - kt0));
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int slab = warp % T::CG;
  const int kg = warp / T::CG;

  float acc[NF][8][4];
#pragma unroll
  for (int nf = 0; nf < NF; ++nf)
#pragma unroll
    for (int f = 0; f < 8; ++f)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[nf][f][c] = 0.f;

  if (threadIdx.x < BN)
    cp_async4(&sscale[threadIdx.x], scale + min(n0 + (int)threadIdx.x, N - 1),
              n0 + (int)threadIdx.x < N);
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_steps)
      load_stage<BN, NF, kVec>(smem + i * T::STAGE, x, q, M, N, K, m0, n0, (kt0 + i) * T::BK);
    cp_async_commit();
  }
  for (int s = 0; s < n_steps; ++s) {
    cp_async_wait<kStages - 2>();  // this thread's copies of stage s have landed
    __syncthreads();               // everyone's have, and stage s - 1's slot is free
    const int next = s + kStages - 1;
    if (next < n_steps)
      load_stage<BN, NF, kVec>(smem + (next % kStages) * T::STAGE, x, q, M, N, K, m0, n0,
                               (kt0 + next) * T::BK);
    cp_async_commit();

    const uint8_t* st = smem + (s % kStages) * T::STAGE;
    const uint8_t* w = st + (kg * 16 + 2 * t) * T::W_LD + slab * kSlab + g * 16;
    const uint4 r0 = *reinterpret_cast<const uint4*>(w);
    const uint4 r1 = *reinterpret_cast<const uint4*>(w + T::W_LD);
    const uint4 r2 = *reinterpret_cast<const uint4*>(w + 8 * T::W_LD);
    const uint4 r3 = *reinterpret_cast<const uint4*>(w + 9 * T::W_LD);
    const __nv_bfloat16* xs = reinterpret_cast<const __nv_bfloat16*>(st + T::W_STAGE);
    uint32_t b[NF][2];
#pragma unroll
    for (int nf = 0; nf < NF; ++nf) {
      const __nv_bfloat16* xr = xs + (nf * 8 + g) * T::X_LD + kg * 16 + 2 * t;
      b[nf][0] = *reinterpret_cast<const uint32_t*>(xr);
      b[nf][1] = *reinterpret_cast<const uint32_t*>(xr + 8);
    }
    mma_word<NF, 0>(acc, r0.x, r1.x, r2.x, r3.x, b);
    mma_word<NF, 1>(acc, r0.y, r1.y, r2.y, r3.y, b);
    mma_word<NF, 2>(acc, r0.z, r1.z, r2.z, r3.z, b);
    mma_word<NF, 3>(acc, r0.w, r1.w, r2.w, r3.w, b);
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: the epilogue reuses it

  // each warp's accumulators in register order: row (nf, f, c), column lane
  float* part = reinterpret_cast<float*>(smem) + warp * T::WARP_PART;
#pragma unroll
  for (int nf = 0; nf < NF; ++nf)
#pragma unroll
    for (int f = 0; f < 8; ++f)
#pragma unroll
      for (int c = 0; c < 4; ++c) part[((nf * 8 + f) * 4 + c) * kPartLd + lane] = acc[nf][f][c];
  __syncthreads();
  // the CTA's partial [MT, BN] in natural column order: the slab's warps
  // summed in order; column n of a slab is fragment f = (n % 16) / 2 at row
  // n / 16 + 8 * (n % 2) (undoing the interleave), held by lane
  // 4 * (n / 16) + (m % 8) / 2 in register c = m % 2 + 2 * (n % 2)
  float* cta = reinterpret_cast<float*>(smem + T::CTA_PART);
  for (int e = threadIdx.x; e < T::MT * BN; e += kThreads) {
    const int m = e / BN;
    const int n = e % BN;
    const int nn = n % kSlab;
    const int f = (nn % 16) / 2;
    const int hi = nn % 2;
    const int row = ((m / 8 * 8 + f) * 4 + m % 2 + 2 * hi) * kPartLd + 4 * (nn / 16) + (m % 8) / 2;
    const float* p = reinterpret_cast<const float*>(smem) + (n / kSlab) * T::WARP_PART + row;
    float sum = p[0];
#pragma unroll
    for (int k = 1; k < T::KG; ++k) sum += p[k * T::CG * T::WARP_PART];
    cta[e] = sum;
  }

  // the cluster's merge: every rank sums its share of the tile over the S
  // partials, in rank order, scales and writes it
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  constexpr int kQuads = T::MT * BN / 4;
  const int lo = split * kQuads / splits;
  const int hi = (split + 1) * kQuads / splits;
  for (int i = lo + threadIdx.x; i < hi; i += kThreads) {
    float4 sum = reinterpret_cast<const float4*>(cluster.map_shared_rank(cta, 0))[i];
    for (int r = 1; r < splits; ++r) {
      const float4 v = reinterpret_cast<const float4*>(cluster.map_shared_rank(cta, r))[i];
      sum.x += v.x;
      sum.y += v.y;
      sum.z += v.z;
      sum.w += v.w;
    }
    const int gm = m0 + 4 * i / BN;
    const int gn = n0 + 4 * i % BN;
    if (gm < M) {
      const float v[4] = {sum.x, sum.y, sum.z, sum.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (gn + e < N) put(out + (size_t)gm * N + gn + e, v[e] * sscale[gn - n0 + e]);
    }
  }
  cluster.sync();  // no CTA leaves while another may still read its partial
}

template <int BN, int NF, bool kVec, typename OutT>
cudaError_t launch(const void* x, const void* q, const void* scale, void* out, int M, int N,
                   int K, int splits, int steps_per_split, cudaStream_t stream) {
  using T = Tile<BN, NF>;
  auto kernel = int8_matmul_decode_kernel<BN, NF, kVec, OutT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, (M + T::MT - 1) / T::MT, (N + BN - 1) / BN);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = T::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const __nv_bfloat16*>(x),
                           static_cast<const int8_t*>(q), static_cast<const float*>(scale),
                           static_cast<OutT*>(out), M, N, K, steps_per_split);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <int BN, bool kVec, typename OutT>
cudaError_t launch_rows(const void* x, const void* q, const void* scale, void* out, int M,
                        int N, int K, int splits, int steps_per_split, cudaStream_t stream) {
  return M <= 8 ? launch<BN, 1, kVec, OutT>(x, q, scale, out, M, N, K, splits,
                                           steps_per_split, stream)
                : launch<BN, 2, kVec, OutT>(x, q, scale, out, M, N, K, splits,
                                           steps_per_split, stream);
}

template <int BN>
cudaError_t launch_width(const void* x, const void* q, const void* scale, void* out, int M,
                         int N, int K, int out_f32, int splits, int steps_per_split,
                         cudaStream_t stream) {
  const bool vec = N % 16 == 0 && K % 8 == 0 && aligned16(x) && aligned16(q);
  if (out_f32)
    return vec ? launch_rows<BN, true, float>(x, q, scale, out, M, N, K, splits,
                                              steps_per_split, stream)
               : launch_rows<BN, false, float>(x, q, scale, out, M, N, K, splits,
                                               steps_per_split, stream);
  return vec ? launch_rows<BN, true, __nv_bfloat16>(x, q, scale, out, M, N, K, splits,
                                                    steps_per_split, stream)
             : launch_rows<BN, false, __nv_bfloat16>(x, q, scale, out, M, N, K, splits,
                                                     steps_per_split, stream);
}

}  // namespace

// Returns the cudaError_t of the one launch (0 = success). Shapes and types
// are checked by the Python wrapper. ``bn`` (128 or 256) is the strip width,
// ``splits`` (1-8) the cluster size, and every split but the last covers
// ``steps_per_split`` stages of 16384 / bn rows of K.
extern "C" int int8_matmul_bf16(const void* x, const void* q, const void* scale, void* out,
                                int M, int N, int K, int out_f32, int bn, int splits,
                                int steps_per_split, void* stream) {
  if (M <= 0 || N <= 0 || K < 0 || (bn != 128 && bn != 256) || splits < 1 ||
      splits > kMaxSplits || steps_per_split < 1 || (M + 15) / 16 > 65535 ||
      (N + bn - 1) / bn > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bn == 256 ? (int)launch_width<256>(x, q, scale, out, M, N, K, out_f32, splits,
                                            steps_per_split, s)
                   : (int)launch_width<128>(x, q, scale, out, M, N, K, out_f32, splits,
                                            steps_per_split, s);
}
