// Folded-BN ResNet identity bottleneck block on Hopper as three implicit
// GEMMs over the whole batch's pixels, flattened as [M = B*H*W, channels]:
//   conv 1:  y1  = bf16(relu(x . w1 + b1))                 [M, C] x [C, F]
//   conv 2:  y2  = bf16(relu(conv3x3_SAME(y1) . w2 + b2))  [M, 9F] x [9F, F], implicit
//   conv 3:  out = relu(bf16(y2 . w3 + b3) + x)            [M, F] x [F, C]
// x, y1, y2 and out NHWC bf16; w1 [C, F], w2 [9F, F] (the HWIO 3x3 kernel
// flattened tap-major: row (3*kh + kw)*F + ci), w3 [F, C] bf16; the biases
// float32. Every product sums bf16 products in float32 and rounds once,
// after its bias, at the hand-offs of the plain version
// (ops/fused_resnet.py identity_chain_ref). One kernel, templated on which conv it computes;
// the wrapper launches it three times per block (plus a reduce where it
// splits K), with y1 and y2 in bf16 workspaces shared by the chain's blocks.
//
// Replaces the TPU kernel seldon_core_tpu/ops/fused_resnet.py
// (fused_identity_chain, Pallas body _chain_kernel). A fused design that
// keeps a band of one image's y1 and y2 in shared memory streams every
// weight of the block from L2 for its 49 to 112 pixels, on steps whose
// fixed cost (per-copy address arithmetic, block barriers, one step in
// flight) dwarfs their products; this one reuses each weight over 128
// pixels and pays for y1 and y2 crossing device memory instead.
//
// What bounds it on the card. One block does 2*M*(2CF + 9F^2) flops: 56
// GFLOP at every ResNet-50 stage at B = 128, 0.057 ms at 989 TFLOP/s. The
// fused ideal moves x in and out once (411 MB at 56x56x256, bytes bound);
// this design also writes and reads back y1 and y2 (M x F bf16 each), 822
// MB per block at 56x56 and 411 at 28x28, its own floor of 0.25 and 0.12
// ms a block there. At 14x14 and 7x7 y1 and y2 stay in the 50 MB L2 and
// the products bound it (operations). Design, and what it does about each:
//   * tiles of 128 pixel rows x BN output columns (BN 64, 128 or 256 with
//     BN | N), 64 deep: a weight element fetched into shared memory serves
//     128 pixels, and a CTA reads only its BN columns of the weight;
//   * a TMA ring: one producer thread keeps up to 4 stages of the A tile
//     (128 rows x 64 bf16, 128-byte swizzle) and the B tile (64 rows of the
//     [K, N] row-major weight, BN/64 boxes of 64 columns in the MN-major
//     128-byte swizzle) in flight, each stage guarded by a full and an empty
//     mbarrier. TMA computes every address, fills rows past M and before 0
//     with zeros, and no thread divides by W in the loop;
//   * two consumer warpgroups run wgmma.mma_async m64nBNk16 (bf16 in,
//     float32 accumulate; B read with the transpose bit), one 64-row half of
//     the tile each, four per stage, one stage in flight behind the next;
//   * conv 2 without an im2col tensor: its K loop runs over 9 taps x F/64.
//     For tap (dh, dw) the A tile is rows p0 + dh*W + dw ... + 127 of y1
//     seen as [M, F]: one 2D TMA box. A row whose tap lies outside its own
//     image (a column that wraps to the neighbouring row, a row above or
//     below that crosses into the neighbouring image) is zeroed in shared
//     memory before the product: the TPU kernel's seam and wrap masks for
//     images stacked along the flattened axis. Each row's (h, w) and its
//     nine tap bits are computed once per tile; a warpgroup zeroes, fences
//     (fence.proxy.async) and meets at its own named barrier only on the
//     taps where one of its 64 rows needs it;
//   * the epilogue from wgmma's registers: bias, relu and the rounding to
//     bf16 are applied to the accumulators, which go through a bf16 staging
//     tile in the drained ring (rows padded by 16 bytes: no bank conflicts)
//     so that every thread stores 16 bytes, and conv 3 reads its residual x
//     16 bytes at a time there. conv 3 may write in place over x: each
//     element of x is read once, by the thread that then writes it;
//   * split-K for small grids (B = 8 at 7x7 gives 4 row tiles): blockIdx.z
//     cuts the K range, each split writes float32 partials and a second
//     small kernel sums them and applies the same epilogue. The wrapper
//     picks the width and the split (ops/fused_resnet.py, _k3_plan).
// Requirements (checked by the wrapper, and again here): the A width and N
// multiples of 64, BN | N, 16-byte aligned operands.
//
// Built with nvcc into a shared library with a plain C interface and loaded
// with ctypes (ops/_build.py). The tensor maps are encoded on the host with
// cuTensorMapEncodeTiled, a libcuda symbol fetched through the runtime's
// entry-point query, so the library links against nothing but cudart.

#include <mutex>

#include "hopper_wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int BM = 128;                    // pixel rows per CTA: one 64-row half per warpgroup
constexpr int BK = 64;                     // depth per stage: one 128-byte swizzle row of bf16
constexpr int kConsumers = 256;            // two warpgroups
constexpr int kThreads = kConsumers + 32;  // + one producer warp
constexpr int A_STAGE = BM * BK * 2;       // bytes of one A stage
constexpr int B_ATOM = BK * 128;           // one 64-column MN-major atom of a B stage

// What depends on the tile's width BN. Below 256 two CTAs share an SM
// (96 KB of ring each), so one CTA's epilogue overlaps the other's loads.
template <int BN>
struct Tile {
  static constexpr int B_STAGE = BK * BN * 2;
  static constexpr int STAGE = A_STAGE + B_STAGE;
  static constexpr int kMaxStages = BN == 128 ? 3 : 4;
  static constexpr int kMinBlocks = BN == 256 ? 1 : 2;
  static constexpr int kOutLd = BN + 8;  // bf16 per row of the epilogue's staging tile
  static constexpr int kOutBytes = BM * kOutLd * 2;
  static constexpr int kAcc = BN / 2;    // float32 accumulators per thread (64 x BN / 128)
};

// Bytes before the barriers: the ring of ``stages`` stages, which the
// epilogue reuses as its staging tile once drained.
template <int BN>
__host__ __device__ inline int ring_bytes(int stages) {
  const int ring = stages * Tile<BN>::STAGE;
  return ring > Tile<BN>::kOutBytes ? ring : Tile<BN>::kOutBytes;
}

template <int BN>
inline int smem_bytes(int stages) {
  // + full and empty barriers, two mask words, and the 1024-byte alignment
  return ring_bytes<BN>(stages) + 2 * Tile<BN>::kMaxStages * 8 + 8 + 1024;
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

__device__ __forceinline__ void unpack8(uint4 u, float (&v)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const __nv_bfloat162 p = *reinterpret_cast<const __nv_bfloat162*>(&w[j]);
    v[2 * j] = __low2float(p);
    v[2 * j + 1] = __high2float(p);
  }
}

__device__ __forceinline__ uint4 pack8(const float (&v)[8]) {
  return make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]), pack2(v[6], v[7]));
}

// relu(y + x) of eight bf16 pairs, rounded to bf16: conv 3's residual.
__device__ __forceinline__ uint4 add_relu8(uint4 y, uint4 x) {
  float a[8], b[8];
  unpack8(y, a);
  unpack8(x, b);
#pragma unroll
  for (int e = 0; e < 8; ++e) a[e] = fmaxf(a[e] + b[e], 0.f);
  return pack8(a);
}

// Tap bits of one output pixel: bit 3*(dh + 1) + (dw + 1) is set when the
// pixel's tap (dh, dw) lies inside its own image.
__device__ __forceinline__ uint32_t tap_bits(int p, int H, int W) {
  const int w = p % W;
  const int h = (p / W) % H;
  uint32_t bits = 0;
#pragma unroll
  for (int dh = -1; dh <= 1; ++dh)
#pragma unroll
    for (int dw = -1; dw <= 1; ++dw)
      if (h + dh >= 0 && h + dh < H && w + dw >= 0 && w + dw < W)
        bits |= 1u << (3 * (dh + 1) + (dw + 1));
  return bits;
}

// One conv of the block over a 128-row tile and BN columns, K steps
// [z * per, min((z + 1) * per, steps)) of split z = blockIdx.z. A is
// [M, ka] (conv 2: y1, read once per tap), B the [K, N] weight. One split
// writes bf16 ``out`` through the conv's epilogue; several write float32
// ``partial`` [splits, M, N] for split_reduce_kernel.
template <int STAGE, int BN>
__global__ void __launch_bounds__(kThreads, Tile<BN>::kMinBlocks)
conv_gemm_kernel(const __grid_constant__ CUtensorMap tmap_a,  // A [M, ka] bf16
                 const __grid_constant__ CUtensorMap tmap_b,  // B [K, N] bf16
                 const float* __restrict__ bias,              // [N]
                 const bf16* resid,                           // conv 3: x [M, N]; may alias out
                 bf16* out,                                   // [M, N]
                 float* __restrict__ partial,                 // [splits, M, N] (split-K)
                 int M, int N, int ka, int H, int W, int steps, int per, int stages) {
  using T = Tile<BN>;
  extern __shared__ uint8_t smem_raw[];
  // swizzled tiles need 1024-byte aligned bases
  uint8_t* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const uint32_t ring_u = smem_u32(smem);                   // stage s: A, then B
  const uint32_t bar = ring_u + ring_bytes<BN>(stages);     // full[s], then empty[s]
  uint32_t* wg_bits = reinterpret_cast<uint32_t*>(smem + ring_bytes<BN>(stages) +
                                                  2 * T::kMaxStages * 8);

  const int n0 = blockIdx.x * BN;  // column tiles vary fastest: the CTAs that share an A
  const int m0 = blockIdx.y * BM;  // tile run together and read it from device memory once
  const int kt0 = blockIdx.z * per;
  const int n_steps = max(0, min(per, steps - kt0));
  const int kc = ka / BK;  // steps per tap
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(bar + 8 * s, 1);                              // the producer's expect_tx
      mbar_init(bar + 8 * (T::kMaxStages + s), kConsumers / 32);  // one arrival per consumer warp
    }
    wg_bits[0] = wg_bits[1] = 0x1FFu;
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // conv 2: consumer thread t owns half of tile row t / 2 (warpgroup t / 128
  // owns rows 64 (t / 128) ... + 63). Its tap bits, and per warpgroup the
  // taps every one of its rows keeps (rows past M keep all: discarded).
  uint32_t bits = 0x1FFu;
  if (STAGE == 2 && threadIdx.x < kConsumers) {
    const int p = m0 + threadIdx.x / 2;
    if (p < M) bits = tap_bits(p, H, W);
    atomicAnd(&wg_bits[threadIdx.x / 128], bits);
  }
  __syncthreads();

  if (warp == kConsumers / 32) {
    // producer: one thread keeps the ring full
    if (lane == 0) {
      for (int i = 0; i < n_steps; ++i) {
        const int s = i % stages;
        if (i >= stages) mbar_wait(bar + 8 * (T::kMaxStages + s), ((i / stages) - 1) & 1);
        mbar_expect_tx(bar + 8 * s, T::STAGE);
        const int t = kt0 + i;  // K step: rows t * BK ... of B
        int a_row = m0, a_col = t * BK;
        if (STAGE == 2) {       // tap t / kc, channels (t % kc) * BK ...
          const int tap = t / kc;
          a_row = m0 + (tap / 3 - 1) * W + (tap % 3 - 1);
          a_col = (t % kc) * BK;
        }
        const uint32_t dst = ring_u + s * T::STAGE;
        tma_load(dst, &tmap_a, a_col, a_row, bar + 8 * s);
#pragma unroll
        for (int a = 0; a < BN / 64; ++a)
          tma_load(dst + A_STAGE + a * B_ATOM, &tmap_b, n0 + 64 * a, t * BK, bar + 8 * s);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows m0 + 64 wg .. m0 + 64 wg + 63
  const int wg = warp / 4;
  const int ct = threadIdx.x;
  const uint32_t wg_keep = wg_bits[wg];
  float acc[T::kAcc];
#pragma unroll
  for (int i = 0; i < T::kAcc; ++i) acc[i] = 0.f;

  for (int i = 0; i < n_steps; ++i) {
    const int s = i % stages;
    const uint32_t a_u = ring_u + s * T::STAGE;
    mbar_wait(bar + 8 * s, (i / stages) & 1);
    if (STAGE == 2) {
      const int tap = (kt0 + i) / kc;
      if (!((wg_keep >> tap) & 1u)) {
        // a row of this warpgroup takes the tap from outside its image:
        // zero those rows (128 bytes each, wherever the swizzle put the
        // chunks), then publish the writes to wgmma's proxy
        if (!((bits >> tap) & 1u)) {
          uint4* row = reinterpret_cast<uint4*>(smem + s * T::STAGE + (ct / 2) * 128 +
                                                (ct % 2) * 64);
#pragma unroll
          for (int c = 0; c < 4; ++c) row[c] = make_uint4(0u, 0u, 0u, 0u);
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
      }
    }
    fence_acc(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      // A: K-major, 8-row groups 1024 bytes apart, 32 bytes per 16-deep slice
      const uint64_t da = smem_desc(a_u + wg * 64 * 128 + kk * 32, 16, 1024);
      // B: MN-major, 64-column atoms B_ATOM apart (LBO), 8-deep row groups
      // 1024 bytes apart (SBO), 16 rows of 128 bytes per slice
      const uint64_t db = smem_desc(a_u + A_STAGE + kk * 16 * 128, B_ATOM, 1024);
      wgmma(acc, da, db);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    // the previous stage's products have retired: release it
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    fence_acc(acc);
    if (i > 0 && lane == 0) mbar_arrive(bar + 8 * (T::kMaxStages + (i - 1) % stages));
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_acc(acc);

  // accumulator layout of m64nNk16: register 4 j + 2 h + e holds row
  // 16 (warp % 4) + lane / 4 + 8 h, column 8 j + 2 (lane % 4) + e
  const int r0 = wg * 64 + (warp % 4) * 16 + lane / 4;
  const int c0 = (lane % 4) * 2;
  if (gridDim.z > 1) {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + r0 + 8 * h;
        if (row < M)
          *reinterpret_cast<float2*>(partial + ((size_t)blockIdx.z * M + row) * N + n0 + 8 * j +
                                     c0) = make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    return;
  }

  // both warpgroups' products have retired: the ring becomes the staging tile
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
  bf16* ot = reinterpret_cast<bf16*>(smem);  // [BM][kOutLd]
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = 8 * j + c0;
    const float bb0 = __ldg(bias + n0 + col);
    const float bb1 = __ldg(bias + n0 + col + 1);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v0 = acc[4 * j + 2 * h] + bb0;
      float v1 = acc[4 * j + 2 * h + 1] + bb1;
      if (STAGE != 3) {
        v0 = fmaxf(v0, 0.f);
        v1 = fmaxf(v1, 0.f);
      }
      *reinterpret_cast<uint32_t*>(ot + (r0 + 8 * h) * T::kOutLd + col) = pack2(v0, v1);
    }
  }
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
  // 16 bytes a thread, BN / 8 threads along a row
#pragma unroll 4
  for (int c = ct; c < BM * BN / 8; c += kConsumers) {
    const int row = c / (BN / 8);
    const int col = (c % (BN / 8)) * 8;
    const int p = m0 + row;
    if (p >= M) continue;
    uint4 v = *reinterpret_cast<const uint4*>(ot + row * T::kOutLd + col);
    const size_t g = (size_t)p * N + n0 + col;
    if (STAGE == 3) v = add_relu8(v, *reinterpret_cast<const uint4*>(resid + g));
    *reinterpret_cast<uint4*>(out + g) = v;
  }
}

// Sum the splits' float32 partials and apply conv STAGE's epilogue, eight
// columns per thread (N % 64 == 0 keeps a group inside one row).
template <int STAGE>
__global__ void split_reduce_kernel(const float4* __restrict__ partial,
                                    const float* __restrict__ bias, const bf16* resid, bf16* out,
                                    int M, int N, int splits) {
  const size_t mn8 = (size_t)M * N / 8;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < mn8;
       i += (size_t)gridDim.x * blockDim.x) {
    float4 lo = partial[2 * i];
    float4 hi = partial[2 * i + 1];
    for (int s = 1; s < splits; ++s) {
      const float4 a = partial[2 * ((size_t)s * mn8 + i)];
      const float4 b = partial[2 * ((size_t)s * mn8 + i) + 1];
      lo.x += a.x; lo.y += a.y; lo.z += a.z; lo.w += a.w;
      hi.x += b.x; hi.y += b.y; hi.z += b.z; hi.w += b.w;
    }
    const int n = (int)((i * 8) % (size_t)N);
    float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      v[e] += __ldg(bias + n + e);
      if (STAGE != 3) v[e] = fmaxf(v[e], 0.f);
    }
    uint4 o = pack8(v);
    if (STAGE == 3) o = add_relu8(o, reinterpret_cast<const uint4*>(resid)[i]);
    reinterpret_cast<uint4*>(out)[i] = o;
  }
}

// A 2-D row-major bf16 [rows, cols] tensor, boxes of box_rows x 64 columns
// (128 bytes) in the 128-byte swizzle; out-of-bounds elements read as zero.
bool encode_bf16(CUtensorMap* map, const void* base, uint64_t rows, uint64_t cols,
                 uint32_t box_rows) {
  return encode_2d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, base, rows, cols, cols * 2, box_rows,
                   64, CU_TENSOR_MAP_SWIZZLE_128B);
}

struct Args {
  const void* a;
  const void* w;
  const void* bias;
  const void* resid;
  void* out;
  void* partial;
  int M, H, W, ka, n, splits, per, steps;
};

// Raise conv_gemm_kernel<STAGE, BN>'s dynamic shared-memory limit to the
// deepest ring's size, once per device. The limit is the function's, shared
// by every host thread: set per launch to the plan's own ring, a thread
// launching a shallower ring lowered it under another's deeper one between
// that one's set and its launch (cudaErrorInvalidValue under concurrent
// forwards). Set once, under a lock, no set ever overlaps a launch.
template <int STAGE, int BN>
cudaError_t size_once() {
  static std::mutex mu;
  static uint64_t sized = 0;  // devices whose limit is set, one bit each; under mu
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(mu);
  if (sized >> dev & 1u) return cudaSuccess;
  err = cudaFuncSetAttribute(conv_gemm_kernel<STAGE, BN>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes<BN>(Tile<BN>::kMaxStages));
  if (err == cudaSuccess) sized |= 1ull << dev;
  return err;
}

template <int STAGE, int BN>
cudaError_t launch(const Args& g, cudaStream_t stream) {
  CUtensorMap ta, tb;
  if (!encode_bf16(&ta, g.a, g.M, g.ka, BM) ||
      !encode_bf16(&tb, g.w, (uint64_t)g.steps * BK, g.n, BK))
    return cudaErrorInvalidValue;
  const int stages = g.per < Tile<BN>::kMaxStages ? g.per : Tile<BN>::kMaxStages;
  const int smem = smem_bytes<BN>(stages);
  cudaError_t err = size_once<STAGE, BN>();
  if (err != cudaSuccess) return err;
  const dim3 grid(g.n / BN, (g.M + BM - 1) / BM, g.splits);
  conv_gemm_kernel<STAGE, BN><<<grid, kThreads, smem, stream>>>(
      ta, tb, static_cast<const float*>(g.bias), static_cast<const bf16*>(g.resid),
      static_cast<bf16*>(g.out), static_cast<float*>(g.partial), g.M, g.n, g.ka, g.H, g.W,
      g.steps, g.per, stages);
  err = cudaGetLastError();
  if (err != cudaSuccess || g.splits == 1) return err;
  const size_t mn8 = (size_t)g.M * g.n / 8;
  const int blocks = (int)((mn8 + 255) / 256 < 4096 ? (mn8 + 255) / 256 : 4096);
  split_reduce_kernel<STAGE><<<blocks, 256, 0, stream>>>(
      static_cast<const float4*>(g.partial), static_cast<const float*>(g.bias),
      static_cast<const bf16*>(g.resid), static_cast<bf16*>(g.out), g.M, g.n, g.splits);
  return cudaGetLastError();
}

template <int STAGE>
cudaError_t launch_bn(const Args& g, int bn, cudaStream_t s) {
  return bn == 64 ? launch<STAGE, 64>(g, s)
                  : bn == 128 ? launch<STAGE, 128>(g, s) : launch<STAGE, 256>(g, s);
}

}  // namespace

// One conv of an identity block over M = B*H*W pixels. ``stage`` 1: a = x
// [M, ka = C], w = w1 [C, n = F]; 2: a = y1 [M, ka = F], w = w2 [9F, n = F];
// 3: a = y2 [M, ka = F], w = w3 [F, n = C], resid = x (``out`` may be x).
// ``bn`` the tile's width (64, 128 or 256, dividing n); K is cut into
// ``splits`` of ``per`` 64-deep steps, none empty, with ``partial`` a
// float32 [splits, M, n] workspace when splits > 1 (else unused). Returns
// the cudaError_t of the launches (0 = success); cudaErrorInvalidValue for
// what the kernel does not take or a tensor map that cannot be encoded,
// and nothing runs then. Types and shapes are checked by the Python
// wrapper (ops/fused_resnet.py).
extern "C" int fused_resnet_conv_bf16(int stage, const void* a, const void* w, const void* bias,
                                      const void* resid, void* out, void* partial, int M, int H,
                                      int W, int ka, int n, int bn, int splits, int per,
                                      void* stream) {
  if (stage < 1 || stage > 3 || M <= 0 || (M + BM - 1) / BM > 65535 || H <= 0 || W <= 0 ||
      ka <= 0 || ka % BK || n <= 0 || (bn != 64 && bn != 128 && bn != 256) || n % bn ||
      !aligned16(a) || !aligned16(w) || !aligned16(out) || (stage == 3 && !aligned16(resid)) ||
      splits < 1 || per < 1)
    return (int)cudaErrorInvalidValue;
  Args g{a, w, bias, resid, out, partial, M, H, W, ka, n, splits, per,
         (stage == 2 ? 9 : 1) * (ka / BK)};
  if ((long long)splits * per < g.steps || (long long)(splits - 1) * per >= g.steps ||
      (splits > 1 && (partial == nullptr || !aligned16(partial))))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(stage == 1 ? launch_bn<1>(g, bn, s)
                          : stage == 2 ? launch_bn<2>(g, bn, s) : launch_bn<3>(g, bn, s));
}
