// Int8 weight-only matmul (W8A16 GEMM) for Hopper:
//   out[M, N] = (x[M, K] @ q[K, N]) * scale[N]
// x bf16, q int8, scale float32, out bf16 or float32, float32 accumulation.
//
// Replaces the TPU kernel seldon_core_tpu/ops/pallas_int8.py (int8_matmul,
// Pallas body _kernel): the weight crosses device memory as int8 and is
// dequantized next to the matrix unit.
//
// Numerics. The TPU kernel dequantizes its weight tile, w_kn = q_kn * s_n,
// and accumulates sum_k x_k w_kn. Here the int8 tile is converted to bf16
// (exact: every int8 value is a bf16 value), multiplied on the tensor cores
// with float32 accumulation, and the scale is applied once in the epilogue:
// s_n * sum_k x_k q_kn. The scale belongs to the output column n, so it
// factors out of the sum over k: the two agree up to float32 rounding (the
// TPU form rounds every product q_kn * s_n, this one the final product
// once) and the order of summation.
//
// What bounds it on the card: at decode (M = 8 serving slots) bytes. The
// K x N int8 weight is nearly every byte the call moves, at 2 * M flops per
// weight byte, far below the ~295 flops/byte of the H100's bf16 balance
// point. At a 256-token prefill chunk it is 512 flops per weight byte:
// the tensor-core operations. Design, and what it does about that:
//   * one tile shape: a block of 4 warps owns a 16 x 32 output tile.
//     blockIdx.x walks the M tiles (fastest, so the blocks that share a
//     weight tile run side by side and the weight leaves device memory
//     once), blockIdx.y the N tiles;
//   * K advances 128 at a time. Each thread loads its share of the NEXT
//     step's x and q tiles into registers (16-byte loads, neighbouring
//     threads on neighbouring addresses) while the warps multiply the
//     current step out of shared memory; q is converted to bf16 on its way
//     into shared memory, so the tensor cores (wmma bf16 m16n16k16) see a
//     plain bf16 tile and no bf16 copy of the weight ever exists in device
//     memory;
//   * the four warps split each step's eight 16-deep slices between them
//     (two each) and sum their partial tiles through shared memory at the
//     end;
//   * split-K: at decode the output tiles alone are about one block per SM,
//     too few loads in flight to stream the weight, so blockIdx.z cuts the
//     K range; each split writes its float32 partial to a workspace and a
//     second small kernel sums the splits, scales and casts. The wrapper
//     (ops/int8_matmul.py) picks the split count; one split writes the
//     output directly;
//   * ragged edges are masked: rows past M, columns past N and depth past K
//     load as zeros and only in-range outputs are written. 16-byte loads
//     need N % 16 == 0 and K % 8 == 0 (and aligned bases); otherwise an
//     instantiation with scalar loads runs.
// No TMA, no wgmma, no multi-stage ring: a simple kernel that is right first.
//
// Built with nvcc into a shared library with a plain C interface and loaded
// with ctypes (ops/_build.py); pointers and the stream arrive as void*.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

namespace {

using namespace nvcuda;

constexpr int BM = 16;
constexpr int BN = 32;
constexpr int BK = 128;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int XS_LD = BK + 8;  // bf16 per shared row of the x tile (padded against bank conflicts)
constexpr int WS_LD = BN + 8;  // bf16 per shared row of the weight tile
constexpr int kXVecs = BM * BK / 8 / kThreads;   // 16-byte x chunks (8 bf16) per thread
constexpr int kWVecs = BK * BN / 16 / kThreads;  // 16-byte q chunks (16 int8) per thread
static_assert(kXVecs * kThreads * 8 == BM * BK, "x tile is split evenly");
static_assert(kWVecs * kThreads * 16 == BK * BN, "q tile is split evenly");
static_assert((BK / 16) % kWarps == 0, "every warp takes the same number of k slices");

__device__ __forceinline__ uint32_t bf16_pair(uint32_t lo, uint32_t hi) {
  // two int8 codes (low 8 bits of lo / hi) -> two bf16 values, lo first
  const __nv_bfloat162 p = __floats2bfloat162_rn(static_cast<float>(static_cast<int8_t>(lo & 0xffu)),
                                                 static_cast<float>(static_cast<int8_t>(hi & 0xffu)));
  return *reinterpret_cast<const uint32_t*>(&p);
}

// The x and q tiles of the K step starting at k0 into registers (zeros
// outside [M, K] x [K, N]).
template <bool kVec>
__device__ __forceinline__ void load_tile(const __nv_bfloat16* __restrict__ x,
                                          const int8_t* __restrict__ q, int M, int N, int K,
                                          int m0, int n0, int k0, uint4 (&xr)[kXVecs],
                                          uint4 (&wr)[kWVecs]) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < kXVecs; ++i) {
    const int c = tid + i * kThreads;
    const int gm = m0 + c / (BK / 8);
    const int gk = k0 + (c % (BK / 8)) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (gm < M) {
      const __nv_bfloat16* src = x + (size_t)gm * K + gk;
      if (kVec) {
        if (gk < K) v = *reinterpret_cast<const uint4*>(src);  // K % 8 == 0: all 8 in range
      } else {
        const uint16_t* s16 = reinterpret_cast<const uint16_t*>(src);
        uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (gk + e < K) w[e / 2] |= static_cast<uint32_t>(s16[e]) << (16 * (e % 2));
        v = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
    xr[i] = v;
  }
#pragma unroll
  for (int i = 0; i < kWVecs; ++i) {
    const int c = tid + i * kThreads;
    const int gk = k0 + c / (BN / 16);
    const int gn = n0 + (c % (BN / 16)) * 16;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (gk < K) {
      const int8_t* src = q + (size_t)gk * N + gn;
      if (kVec) {
        if (gn < N) v = *reinterpret_cast<const uint4*>(src);  // N % 16 == 0: all 16 in range
      } else {
        const uint8_t* s8 = reinterpret_cast<const uint8_t*>(src);
        uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int e = 0; e < 16; ++e)
          if (gn + e < N) w[e / 4] |= static_cast<uint32_t>(s8[e]) << (8 * (e % 4));
        v = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
    wr[i] = v;
  }
}

// Registers -> shared memory; the int8 codes become bf16 on the way.
__device__ __forceinline__ void store_tile(__nv_bfloat16* xs, __nv_bfloat16* ws,
                                           const uint4 (&xr)[kXVecs],
                                           const uint4 (&wr)[kWVecs]) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < kXVecs; ++i) {
    const int c = tid + i * kThreads;
    *reinterpret_cast<uint4*>(xs + (c / (BK / 8)) * XS_LD + (c % (BK / 8)) * 8) = xr[i];
  }
#pragma unroll
  for (int i = 0; i < kWVecs; ++i) {
    const int c = tid + i * kThreads;
    const uint32_t w[4] = {wr[i].x, wr[i].y, wr[i].z, wr[i].w};
    uint32_t o[8];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      o[2 * j] = bf16_pair(w[j], w[j] >> 8);
      o[2 * j + 1] = bf16_pair(w[j] >> 16, w[j] >> 24);
    }
    __nv_bfloat16* dst = ws + (c / (BN / 16)) * WS_LD + (c % (BN / 16)) * 16;
    *reinterpret_cast<uint4*>(dst) = make_uint4(o[0], o[1], o[2], o[3]);
    *reinterpret_cast<uint4*>(dst + 8) = make_uint4(o[4], o[5], o[6], o[7]);
  }
}

__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <bool kVec, bool kSplit, typename OutT>
__global__ void __launch_bounds__(kThreads)
int8_matmul_kernel(const __nv_bfloat16* __restrict__ x,  // [M, K]
                   const int8_t* __restrict__ q,         // [K, N]
                   const float* __restrict__ scale,      // [N]
                   OutT* __restrict__ out,               // [M, N]          (one split)
                   float* __restrict__ partial,          // [splits, M, N]  (split-K)
                   int M, int N, int K, int k_tiles_per_split) {
  __shared__ __align__(32) uint16_t xs_raw[BM * XS_LD];
  __shared__ __align__(32) uint16_t ws_raw[BK * WS_LD];
  __shared__ __align__(32) float cs[kWarps * BM * BN];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(xs_raw);
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(ws_raw);

  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int k_tiles = (K + BK - 1) / BK;
  const int kt0 = blockIdx.z * k_tiles_per_split;
  const int kt1 = min(kt0 + k_tiles_per_split, k_tiles);
  const int warp = threadIdx.x / 32;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[BN / 16];
#pragma unroll
  for (int f = 0; f < BN / 16; ++f) wmma::fill_fragment(acc[f], 0.f);

  uint4 xr[kXVecs];
  uint4 wr[kWVecs];
  if (kt0 < kt1) {
    load_tile<kVec>(x, q, M, N, K, m0, n0, kt0 * BK, xr, wr);
    store_tile(xs, ws, xr, wr);
  }
  __syncthreads();
  for (int kt = kt0; kt < kt1; ++kt) {
    const bool more = kt + 1 < kt1;
    // the next step's loads are in flight during this step's products
    if (more) load_tile<kVec>(x, q, M, N, K, m0, n0, (kt + 1) * BK, xr, wr);
#pragma unroll
    for (int s = warp; s < BK / 16; s += kWarps) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::load_matrix_sync(a, xs + s * 16, XS_LD);
#pragma unroll
      for (int f = 0; f < BN / 16; ++f) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
        wmma::load_matrix_sync(b, ws + s * 16 * WS_LD + f * 16, WS_LD);
        wmma::mma_sync(acc[f], a, b, acc[f]);
      }
    }
    __syncthreads();
    if (more) {
      store_tile(xs, ws, xr, wr);
      __syncthreads();
    }
  }

  // sum the four warps' partial tiles; scale per output column (or hand the
  // raw split sum to the reduction)
#pragma unroll
  for (int f = 0; f < BN / 16; ++f)
    wmma::store_matrix_sync(cs + warp * BM * BN + f * 16, acc[f], BN, wmma::mem_row_major);
  __syncthreads();
  for (int e = threadIdx.x; e < BM * BN; e += kThreads) {
    const int gm = m0 + e / BN;
    const int gn = n0 + e % BN;
    if (gm >= M || gn >= N) continue;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += cs[w * BM * BN + e];
    if (kSplit) {
      partial[((size_t)blockIdx.z * M + gm) * N + gn] = sum;
    } else {
      put(out + (size_t)gm * N + gn, sum * scale[gn]);
    }
  }
}

template <typename OutT>
__global__ void splitk_reduce_kernel(const float* __restrict__ partial,
                                     const float* __restrict__ scale, OutT* __restrict__ out,
                                     int M, int N, int splits) {
  const size_t mn = (size_t)M * N;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < mn;
       i += (size_t)gridDim.x * blockDim.x) {
    float sum = 0.f;
    for (int s = 0; s < splits; ++s) sum += partial[(size_t)s * mn + i];
    put(out + i, sum * scale[i % N]);
  }
}

template <bool kVec, typename OutT>
cudaError_t launch(const void* x, const void* q, const void* scale, void* out, void* partial,
                   int M, int N, int K, int splits, int k_tiles_per_split, cudaStream_t stream) {
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN, splits);
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* qp = static_cast<const int8_t*>(q);
  const auto* sp = static_cast<const float*>(scale);
  auto* op = static_cast<OutT*>(out);
  if (splits == 1) {
    int8_matmul_kernel<kVec, false, OutT><<<grid, kThreads, 0, stream>>>(
        xp, qp, sp, op, nullptr, M, N, K, k_tiles_per_split);
    return cudaGetLastError();
  }
  auto* pp = static_cast<float*>(partial);
  int8_matmul_kernel<kVec, true, OutT><<<grid, kThreads, 0, stream>>>(xp, qp, sp, op, pp, M, N,
                                                                       K, k_tiles_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t mn = (size_t)M * N;
  const int blocks = (int)((mn + 255) / 256 < 4096 ? (mn + 255) / 256 : 4096);
  splitk_reduce_kernel<OutT><<<blocks, 256, 0, stream>>>(pp, sp, op, M, N, splits);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

// Returns the cudaError_t of the launches (0 = success). Shapes and types
// are checked by the Python wrapper; ``partial`` is a float32 [splits, M, N]
// workspace when splits > 1 (else unused) and every split but the last
// covers ``k_tiles_per_split`` steps of BK (128).
extern "C" int int8_matmul_bf16(const void* x, const void* q, const void* scale, void* out,
                                void* partial, int M, int N, int K, int out_f32, int splits,
                                int k_tiles_per_split, void* stream) {
  if (M <= 0 || N <= 0 || K < 0 || splits < 1 || k_tiles_per_split < 1 ||
      (splits > 1 && partial == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = N % 16 == 0 && K % 8 == 0 && aligned16(x) && aligned16(q);
  if (out_f32) {
    return vec ? launch<true, float>(x, q, scale, out, partial, M, N, K, splits,
                                     k_tiles_per_split, s)
               : launch<false, float>(x, q, scale, out, partial, M, N, K, splits,
                                      k_tiles_per_split, s);
  }
  return vec ? launch<true, __nv_bfloat16>(x, q, scale, out, partial, M, N, K, splits,
                                           k_tiles_per_split, s)
             : launch<false, __nv_bfloat16>(x, q, scale, out, partial, M, N, K, splits,
                                            k_tiles_per_split, s);
}
