// Int8 weight-only matmul (W8A16 GEMM) for prefill chunks on Hopper:
//   out[M, N] = (x[M, K] @ q[K, N]) * scale[N]
// x bf16, q int8, scale float32, out bf16 or float32, float32 accumulation.
// The wrapper (ops/int8_matmul.py) sends every product with M >= 64 whose
// operands TMA can address here; decode (M < 64) keeps csrc/int8_matmul.cu.
//
// Replaces the TPU kernel seldon_core_tpu/ops/pallas_int8.py:87-139
// (int8_matmul, Pallas body _kernel) at prefill: the weight crosses device
// memory as int8 and is dequantized next to the matrix unit.
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
// What bounds it on the card. One weight byte feeds 2 * M flops. At M = 128
// that is 256 flops per weight byte, under the H100's ~295 (989 TFLOP/s over
// 3.35 TB/s): the product is bound by bytes, the int8 weight read once. At
// M = 256 it is 512 flops per byte: bound by the tensor-core operations.
// Design, and what it does about each:
//   * operands in their serving layouts: x [M, K] row-major is wgmma's
//     K-major A; q [K, N] row-major (N contiguous) is read as it is, never
//     repacked, since decode reads the same bytes and a second copy would
//     double the weight that int8 serving exists to halve;
//   * TMA ring: one producer thread keeps kStages stages of the x tile
//     (BM x BK bf16, 128-byte swizzle) and the int8 q tile (BK x BN bytes)
//     in flight, each stage guarded by a full and an empty mbarrier. Rows
//     past M and depth past K arrive as zeros (TMA's out-of-bounds fill),
//     so ragged edges need no masks in the main loop. Enough bytes stay in
//     flight per SM to stream the weight at the memory's rate (bytes bound);
//   * conversion next to the tensor cores: the two consumer warpgroups turn
//     the landed int8 stage into a bf16 tile in shared memory (a byte
//     permute into a float32 with a magic exponent, one subtract, and the
//     high halves of two floats packed as a bf16 pair: about 2.5
//     instructions per value, exact), written in the MN-major 128-byte
//     swizzled layout that wgmma reads with its transpose bit set. Then
//     fence.proxy.async and a named barrier, so wgmma never reads a stale
//     tile. Three bf16 buffers rotate: stage i+1 converts while the tensor
//     cores multiply stage i, and a buffer is rewritten only after both
//     warpgroups' products that read it have retired;
//   * wgmma.mma_async m64nBNk16 (bf16 in, float32 accumulate), one 64-row
//     half of the 128 x BN tile per consumer warpgroup, four per 64-deep
//     stage. BN is 128 or 256: the wider tile brings in half the x bytes
//     per weight byte and reads each A slice from shared memory once per
//     256 columns (operations bound: the tensor cores run at their own rate
//     while the ring and the conversion keep them fed), the narrower one
//     gives twice the CTAs to stream the weight (bytes bound);
//   * split-K: at M = 128 the output tiles are fewer than the 132 SMs (32
//     of 128 x 128 for N = 4096), so blockIdx.z cuts the K range, each
//     split writes float32 partials and a second small kernel sums, scales
//     and casts. One split scales and stores directly. The wrapper picks
//     the width and the split (ops/int8_matmul.py, _wgmma_plan).
// Requirements (checked by the wrapper, and again here): K % 8 == 0 and
// N % 16 == 0 (TMA's 16-byte row strides), 16-byte aligned x and q.
//
// Built with nvcc into a shared library with a plain C interface and loaded
// with ctypes (ops/_build.py). The tensor maps are encoded on the host with
// cuTensorMapEncodeTiled, a libcuda symbol fetched through the runtime's
// entry-point query, so the library links against nothing but cudart.

#include "hopper_wgmma.cuh"

namespace {

constexpr int BM = 128;                  // rows per CTA: one 64-row half per consumer warpgroup
constexpr int BK = 64;                   // depth per stage: one 128-byte swizzle row of bf16
constexpr int kStages = 4;               // TMA ring depth
constexpr int kBBufs = 3;                // bf16 weight tiles in rotation
constexpr int kConsumers = 256;          // two warpgroups
constexpr int kThreads = kConsumers + 32;  // + one producer warp
constexpr int X_STAGE = BM * BK * 2;     // bytes of one x stage
constexpr int B_ATOM = BK * 128;         // one 64-column MN-major atom column of the bf16 tile

// What depends on the tile's width BN (output columns per CTA): 128, or
// 256 where operations bound the product (the wrapper picks).
template <int BN>
struct Tile {
  static constexpr int Q_STAGE = BK * BN;      // bytes of one int8 q stage
  static constexpr int B_BUF = BK * BN * 2;    // bytes of one bf16 weight tile
  static constexpr int kSmemBytes =
      kStages * (X_STAGE + Q_STAGE) + kBBufs * B_BUF + 2 * kStages * 8 + 1024;  // + alignment
  static constexpr int kAccRegs = BN / 2;      // float32 accumulators per thread (64 x BN / 128)
  static constexpr int kChunks = Q_STAGE / 16 / kConsumers;  // 16-byte q chunks per consumer
  static_assert(kChunks * 16 * kConsumers == Q_STAGE, "the q stage splits evenly");
  static_assert(kSmemBytes <= 232448, "fits one SM's shared memory");
};

// four int8 codes (one byte each of w) -> two bf16 pairs, byte 0 first.
// Each byte b (offset by 128) becomes the float32 2^23 + 128 + v by a
// byte permute under a magic exponent; one subtract leaves v exactly, and
// v's float32 bits below bf16's 7-bit mantissa are zero, so the high half
// of the float IS the bf16 value.
__device__ __forceinline__ void int8x4_to_bf16x4(uint32_t w, uint32_t& lo, uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650)) - 8388736.f;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651)) - 8388736.f;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7652)) - 8388736.f;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7653)) - 8388736.f;
  lo = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
  hi = __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632);
}

// One landed int8 stage (BK rows of BN bytes, row-major) -> the bf16 tile
// in the MN-major 128-byte swizzled layout: 64-column atoms of BK rows x
// 128 bytes, 16-byte chunk c of row k stored at chunk c ^ (k % 8). Consumer
// ``ct`` converts chunks ct, ct + 256, ... (16 codes each).
template <int BN>
__device__ __forceinline__ void convert_stage(const uint8_t* qs, uint8_t* bt, int ct) {
#pragma unroll
  for (int r = 0; r < Tile<BN>::kChunks; ++r) {
    const int c = ct + r * kConsumers;
    const int k = c / (BN / 16);
    const int nc = c % (BN / 16);  // 16-column group: columns 16 nc .. 16 nc + 15
    const uint4 v = *reinterpret_cast<const uint4*>(qs + c * 16);
    uint4 a, b;
    int8x4_to_bf16x4(v.x, a.x, a.y);
    int8x4_to_bf16x4(v.y, a.z, a.w);
    int8x4_to_bf16x4(v.z, b.x, b.y);
    int8x4_to_bf16x4(v.w, b.z, b.w);
    uint8_t* row = bt + (nc / 4) * B_ATOM + k * 128;
    uint8_t* pa = row + ((((nc % 4) * 2) ^ (k % 8)) * 16);
    uint8_t* pb = row + ((((nc % 4) * 2 + 1) ^ (k % 8)) * 16);
    // the upper four threads of a quarter warp store their second chunk
    // first, so each store instruction's eight chunks land on distinct banks
    const bool swap = (nc & 4) != 0;
    *reinterpret_cast<uint4*>(swap ? pb : pa) = swap ? b : a;
    *reinterpret_cast<uint4*>(swap ? pa : pb) = swap ? a : b;
  }
}

__device__ __forceinline__ void put2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void put2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <int BN, bool kSplit, typename OutT>
__global__ void __launch_bounds__(kThreads, 1)
int8_matmul_wgmma_kernel(const __grid_constant__ CUtensorMap tmap_x,  // x [M, K] bf16
                         const __grid_constant__ CUtensorMap tmap_q,  // q [K, N] int8
                         const float* __restrict__ scale,             // [N]
                         OutT* __restrict__ out,                      // [M, N]          (one split)
                         float* __restrict__ partial,                 // [splits, M, N]  (split-K)
                         int M, int N, int K, int steps_per_split) {
  extern __shared__ uint8_t smem_raw[];
  // swizzled tiles need 1024-byte aligned bases
  uint8_t* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  uint8_t* xs = smem;                                  // kStages x [BM][BK] bf16, swizzled
  using T = Tile<BN>;
  uint8_t* qs = xs + kStages * X_STAGE;                   // kStages x [BK][BN] int8
  uint8_t* bs = qs + kStages * T::Q_STAGE;                // kBBufs x bf16 weight tile
  const uint32_t bar = smem_u32(bs + kBBufs * T::B_BUF);  // full[s], then empty[s]
  const uint32_t xs_u = smem_u32(xs);
  const uint32_t qs_u = smem_u32(qs);
  const uint32_t bs_u = smem_u32(bs);

  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int k_steps = (K + BK - 1) / BK;
  const int kt0 = blockIdx.z * steps_per_split;
  const int n_steps = max(0, min(steps_per_split, k_steps - kt0));
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar + 8 * s, 1);                                // the producer's expect_tx
      mbar_init(bar + 8 * (kStages + s), kConsumers / 32);      // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers / 32) {
    // producer: one thread keeps the ring full
    if (lane == 0) {
      for (int i = 0; i < n_steps; ++i) {
        const int s = i % kStages;
        if (i >= kStages) mbar_wait(bar + 8 * (kStages + s), ((i / kStages) - 1) & 1);
        mbar_expect_tx(bar + 8 * s, X_STAGE + T::Q_STAGE);
        const int k0 = (kt0 + i) * BK;
        tma_load(xs_u + s * X_STAGE, &tmap_x, k0, m0, bar + 8 * s);
        tma_load(qs_u + s * T::Q_STAGE, &tmap_q, n0, k0, bar + 8 * s);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows m0 + 64 wg .. m0 + 64 wg + 63
  const int wg = warp / 4;
  const int ct = threadIdx.x;
  float acc[T::kAccRegs];
#pragma unroll
  for (int i = 0; i < T::kAccRegs; ++i) acc[i] = 0.f;

  for (int i = 0; i < n_steps; ++i) {
    const int s = i % kStages;
    const int b = i % kBBufs;
    mbar_wait(bar + 8 * s, (i / kStages) & 1);
    convert_stage<BN>(qs + s * T::Q_STAGE, bs + b * T::B_BUF, ct);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
    fence_acc(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      // A: K-major, 8-row groups 1024 bytes apart, 32 bytes per 16-deep slice
      const uint64_t da = smem_desc(xs_u + s * X_STAGE + wg * 64 * 128 + kk * 32, 16, 1024);
      // B: MN-major, 64-column atoms B_ATOM apart (LBO), 8-deep row groups
      // 1024 bytes apart (SBO), 16 rows of 128 bytes per slice
      const uint64_t db = smem_desc(bs_u + b * T::B_BUF + kk * 16 * 128, B_ATOM, 1024);
      wgmma(acc, da, db);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    // the previous stage's products have retired: release its x and q
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    fence_acc(acc);
    if (i > 0 && lane == 0) mbar_arrive(bar + 8 * (kStages + (i - 1) % kStages));
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_acc(acc);

  // accumulator layout of m64nNk16: register 4 j + 2 h + e holds row
  // 16 (warp % 4) + lane / 4 + 8 h, column 8 j + 2 (lane % 4) + e
  const int row0 = m0 + wg * 64 + (warp % 4) * 16 + lane / 4;
  const int col0 = n0 + (lane % 4) * 2;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = col0 + j * 8;
    if (col >= N) continue;  // N and col are even: col + 1 < N too
    float s0 = 1.f, s1 = 1.f;
    if (!kSplit) {
      s0 = scale[col];
      s1 = scale[col + 1];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row >= M) continue;
      const float v0 = acc[4 * j + 2 * h];
      const float v1 = acc[4 * j + 2 * h + 1];
      if (kSplit) {
        put2(partial + ((size_t)blockIdx.z * M + row) * N + col, v0, v1);
      } else {
        put2(out + (size_t)row * N + col, v0 * s0, v1 * s1);
      }
    }
  }
}

__device__ __forceinline__ void put4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
__device__ __forceinline__ void put4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&a);
  u.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

// Sum the splits' float32 partials, scale per column and cast, four
// columns per thread (N % 16 == 0 keeps a group of four inside one row).
template <typename OutT>
__global__ void splitk_reduce4_kernel(const float4* __restrict__ partial,
                                      const float* __restrict__ scale, OutT* __restrict__ out,
                                      int M, int N, int splits) {
  const size_t mn4 = (size_t)M * N / 4;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < mn4;
       i += (size_t)gridDim.x * blockDim.x) {
    float4 acc = partial[i];
    for (int s = 1; s < splits; ++s) {
      const float4 p = partial[(size_t)s * mn4 + i];
      acc.x += p.x;
      acc.y += p.y;
      acc.z += p.z;
      acc.w += p.w;
    }
    const int n = (int)((i * 4) % (size_t)N);
    acc.x *= scale[n];
    acc.y *= scale[n + 1];
    acc.z *= scale[n + 2];
    acc.w *= scale[n + 3];
    put4(out + i * 4, acc);
  }
}

template <int BN, typename OutT>
cudaError_t launch(const CUtensorMap& tx, const CUtensorMap& tq, const void* scale, void* out,
                   void* partial, int M, int N, int K, int splits, int steps_per_split,
                   cudaStream_t stream) {
  constexpr int kSmemBytes = Tile<BN>::kSmemBytes;
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN, splits);
  const auto* sp = static_cast<const float*>(scale);
  auto* op = static_cast<OutT*>(out);
  auto* pp = static_cast<float*>(partial);
  cudaError_t err;
  if (splits == 1) {
    err = cudaFuncSetAttribute(int8_matmul_wgmma_kernel<BN, false, OutT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return err;
    int8_matmul_wgmma_kernel<BN, false, OutT><<<grid, kThreads, kSmemBytes, stream>>>(
        tx, tq, sp, op, nullptr, M, N, K, steps_per_split);
    return cudaGetLastError();
  }
  err = cudaFuncSetAttribute(int8_matmul_wgmma_kernel<BN, true, OutT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  int8_matmul_wgmma_kernel<BN, true, OutT><<<grid, kThreads, kSmemBytes, stream>>>(
      tx, tq, sp, op, pp, M, N, K, steps_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t mn4 = (size_t)M * N / 4;
  const int blocks = (int)((mn4 + 255) / 256 < 4096 ? (mn4 + 255) / 256 : 4096);
  splitk_reduce4_kernel<OutT><<<blocks, 256, 0, stream>>>(static_cast<const float4*>(partial),
                                                          sp, op, M, N, splits);
  return cudaGetLastError();
}

template <int BN>
cudaError_t run(const void* x, const void* q, const void* scale, void* out, void* partial, int M,
                int N, int K, int out_f32, int splits, int steps_per_split, cudaStream_t s) {
  CUtensorMap tx, tq;
  if (!encode_2d(&tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, M, K, (uint64_t)K * 2, BM, BK,
                 CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode_2d(&tq, CU_TENSOR_MAP_DATA_TYPE_UINT8, q, K, N, (uint64_t)N, BK, BN,
                 CU_TENSOR_MAP_SWIZZLE_NONE))
    return cudaErrorInvalidValue;
  return out_f32 ? launch<BN, float>(tx, tq, scale, out, partial, M, N, K, splits,
                                     steps_per_split, s)
                 : launch<BN, __nv_bfloat16>(tx, tq, scale, out, partial, M, N, K, splits,
                                             steps_per_split, s);
}

}  // namespace

// Returns the cudaError_t of the launches (0 = success). Shapes and types
// are checked by the Python wrapper; ``bn`` is the tile's width (128 or
// 256); ``partial`` is a float32 [splits, M, N] workspace when splits > 1
// (else unused) and every split but the last covers ``steps_per_split``
// steps of BK (64). A tensor map that cannot be encoded returns
// cudaErrorInvalidValue; nothing runs then.
extern "C" int int8_matmul_wgmma_bf16(const void* x, const void* q, const void* scale, void* out,
                                      void* partial, int M, int N, int K, int out_f32,
                                      int splits, int steps_per_split, int bn, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || N % 16 != 0 || K % 8 != 0 || !aligned16(x) ||
      !aligned16(q) || splits < 1 || steps_per_split < 1 || (splits > 1 && partial == nullptr) ||
      (bn != 128 && bn != 256))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bn == 256 ? (int)run<256>(x, q, scale, out, partial, M, N, K, out_f32, splits,
                                   steps_per_split, s)
                   : (int)run<128>(x, q, scale, out, partial, M, N, K, out_f32, splits,
                                   steps_per_split, s);
}

