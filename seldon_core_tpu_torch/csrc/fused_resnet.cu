// Folded-BN identity bottleneck block of ResNet for Hopper, one block per
// launch:
//   y1  = bf16(relu(x . w1 + b1))                 1x1 reduce,  C -> F
//   y2  = bf16(relu(conv3x3_SAME(y1) . w2 + b2))  3x3,         F -> F
//   out = relu(bf16(y2 . w3 + b3) + x)            1x1 expand,  F -> C, residual in bf16
// x and out NHWC bf16 [B, H, W, C]; w1 [C, F], w2 [9F, F] (the HWIO 3x3
// kernel flattened tap-major: row (3*kh + kw)*F + ci), w3 [F, C] bf16; the
// biases float32. Every product runs on bf16 operands with float32
// accumulation, and each bias is added to the float32 sum before its one
// rounding to bf16 — the numerics of the TPU kernel.
//
// Replaces the TPU kernel seldon_core_tpu/ops/fused_resnet.py
// (fused_identity_chain, Pallas body _chain_kernel), which keeps a whole
// 56x56x256 image and its block's intermediates in VMEM. An H100 SM has 227
// KB of shared memory, so here a block of threads (CTA) owns one band of TH
// output rows of one image:
//   * stage 1 computes y1 for the band plus one halo row above and below
//     into shared memory. Halo rows outside the image, and the left and
//     right pad columns, are ZERO: SAME padding pads y1, the 3x3 conv's
//     input, not x (a 1x1 conv of a zero-padded x would give relu(b1) there);
//   * stage 2 stages the im2col taps of y1 from shared memory and multiplies
//     them by w2 into y2, also in shared memory;
//   * stage 3 multiplies y2 by w3 and adds b3 and the residual x read from
//     device memory, writing the band of out.
// The band height TH is the longest that fits (stage-1 pixels in 256
// fragment rows, the CTA in 227 KB), evened out over the bands: 56x56
// TH = 2, 28x28 TH = 7, 14x14 TH = 7, 7x7 TH = 7, one CTA of 141 to 230 KB
// per SM. A longer band streams the weights from L2 for more pixels;
// neighbouring bands recompute y1's halo rows (a quarter more 1x1-reduce
// work at TH = 2). At B = 128 on the card, the longest band took half
// (28x28) to two fifths (14x14) of TH = 2's time.
//
// Every stage is one GEMM on tensor cores (wmma bf16 m16n16k16, float32
// accumulators): the output is walked in chunks of 64 columns; each chunk
// accumulates over K in steps of 64, with the weight tile streamed from
// device memory (it stays in L2: a whole block's weights are at most 8.9 MB
// at F = 512) and the activation tile staged in shared memory. Two buffers
// of each: cp.async copies the tiles of the next step while this one
// multiplies (a fifth off at 28x28, 14x14 and 7x7 on the card). 8 warps; warp
// w owns column fragment w % 4 of the chunk and every second 16-row tile
// from w / 4, so one B fragment load serves up to 8 products. Rows past the
// stage's pixel count are padded to the 16-row fragment and discarded (the
// 7x7 tile: 49 pixels in 4 fragments).
//
// What bounds it on the card: one block at B = 128 does 2*B*H*W*(2CF + 9F^2)
// = 56 GFLOP at every ResNet-50 stage (0.057 ms at 989 TFLOP/s), against
// one read and one write of x: 411 MB at 56x56x256 (0.123 ms at 3.35 TB/s,
// bytes bound), half that at 28x28x512 (about balanced), and operations
// bound at 14x14 and 7x7. This simple kernel is far from either bound:
// counting cycles around the phases of a step on the card put almost none
// in waiting at the barrier for copies, most in issuing the copies and in
// the wmma loads and products. A 64-deep step is too small for its fixed
// cost: TMA, wgmma on larger tiles, and all blocks of a chain in one launch
// are later work.
//
// The output must not alias x: other CTAs read x's halo rows.
//
// Built with nvcc into a shared library with a plain C interface and loaded
// with ctypes (ops/_build.py); pointers and the stream arrive as void*.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int KC = 64;                          // depth of one staged K step
constexpr int NC = 64;                          // width of one output column chunk
constexpr int kColFrags = NC / 16;              // column fragments per chunk
constexpr int kRowGroups = kWarps / kColFrags;  // warps sharing a column fragment
constexpr int kMaxTiles = 16;                   // 16-row tiles per stage: <= 256 pixels
constexpr int kMaxFrags = kMaxTiles / kRowGroups;
constexpr int LDA = KC + 8;  // bf16 per staged activation row (padded against bank conflicts)
constexpr int LDB = NC + 8;  // bf16 per staged weight row
constexpr size_t kMaxSmem = 232448;  // what one block may use on sm_90
static_assert(kWarps % kColFrags == 0, "warps split evenly over column fragments");

__host__ __device__ inline size_t align128(size_t v) { return (v + 127) & ~static_cast<size_t>(127); }

// Shared-memory layout of one CTA, the same on host and device.
struct Layout {
  int m1_tiles;  // 16-row tiles of stage 1: (TH + 2) * W pixels
  int m2_tiles;  // 16-row tiles of stages 2 and 3: TH * W pixels
  int a_stride;   // bf16 elements of one staged activation buffer
  size_t y1, y2, a, b, scratch, total;
};

__host__ __device__ inline Layout layout(int W, int F, int TH) {
  Layout L;
  L.m1_tiles = ((TH + 2) * W + 15) / 16;
  L.m2_tiles = (TH * W + 15) / 16;
  const size_t ld = static_cast<size_t>(F) + 8;
  const int a_tiles = L.m1_tiles > L.m2_tiles ? L.m1_tiles : L.m2_tiles;
  size_t off = 0;
  L.y1 = off;  // (TH + 2) x (W + 2) pixels of y1, zero-padded on every side
  off = align128(off + static_cast<size_t>(TH + 2) * (W + 2) * ld * 2);
  L.y2 = off;  // m2_tiles * 16 pixels of y2
  off = align128(off + static_cast<size_t>(L.m2_tiles) * 16 * ld * 2);
  L.a_stride = a_tiles * 16 * LDA;
  L.a = off;   // two staged activation tiles: rows x KC each
  off = align128(off + 2 * static_cast<size_t>(L.a_stride) * 2);
  L.b = off;   // two staged weight tiles: KC x NC each
  off = align128(off + 2 * static_cast<size_t>(KC) * LDB * 2);
  L.scratch = off;  // one 16 x 16 float32 tile per warp for the epilogue
  off = align128(off + static_cast<size_t>(kWarps) * 256 * 4);
  L.total = off;
  return L;
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

__device__ __forceinline__ uint4 pack8(const float (&v)[8]) {
  return make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]), pack2(v[6], v[7]));
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

__device__ __forceinline__ float round_bf16(float v) { return __bfloat162float(__float2bfloat16(v)); }

// 16 bytes from device memory to shared memory without passing through
// registers (cp.async, L2 only); ``src_bytes`` = 0 writes zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most the most recent group of this thread's copies is in
// flight.
__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Start copying the weight tile w[k0 : k0 + KC, n0 : n0 + NC] of a
// row-major [K, N] weight into shared memory.
__device__ __forceinline__ void stage_weights(bf16* bs, const bf16* __restrict__ w, int N, int n0,
                                              int k0) {
  for (int c = threadIdx.x; c < KC * NC / 8; c += kThreads) {
    const int k = c / (NC / 8);
    const int n = (c % (NC / 8)) * 8;
    cp_async16(bs + k * LDB + n, w + static_cast<size_t>(k0 + k) * N + n0 + n, 16);
  }
}

// One stage's GEMM: out[M, N] = A[M, K] . w[K, N], M = m_tiles * 16 rows,
// as a sequence of steps (output chunk of NC columns, K step of KC) over
// two buffers: the tiles of step s + 1 are copied in while step s
// multiplies. ``stage_a(as, k0)`` puts the A tile of the K step at k0 into
// ``as`` (row stride LDA) — by cp.async, or by plain copies that the next
// barrier publishes; when ``a_direct`` is set, A is read from it instead
// (row stride ``lda_direct``). ``epi(row, col, v)`` receives 8 consecutive
// float32 sums of one output row once a chunk's K range is done.
template <class StageA, class Epilogue>
__device__ __forceinline__ void block_gemm(int m_tiles, int N, int K, const bf16* __restrict__ w,
                                           bf16* as, int a_stride, bf16* bs, float* scratch,
                                           const bf16* a_direct, int lda_direct, StageA stage_a,
                                           Epilogue epi) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int cf = warp % kColFrags;
  const int rg = warp / kColFrags;
  const int lda = a_direct ? lda_direct : LDA;
  const int ksteps = K / KC;
  const int steps = (N / NC) * ksteps;
  auto fetch = [&](int s) {
    const int buf = s & 1;
    if (!a_direct) stage_a(as + buf * a_stride, (s % ksteps) * KC);
    stage_weights(bs + buf * KC * LDB, w, N, (s / ksteps) * NC, (s % ksteps) * KC);
  };
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kMaxFrags];
#pragma unroll
  for (int i = 0; i < kMaxFrags; ++i) wmma::fill_fragment(acc[i], 0.f);
  __syncthreads();  // the previous stage's results are visible and its buffers free
  fetch(0);
  cp_async_commit();
  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps) fetch(s + 1);
    cp_async_commit();  // (empty on the last step: the wait below stays uniform)
    cp_async_wait_prev();
    __syncthreads();  // step s's tiles have landed for every thread
    const int buf = s & 1;
    const bf16* a_base = a_direct ? a_direct + (s % ksteps) * KC : as + buf * a_stride;
    const bf16* b_base = bs + buf * KC * LDB;
#pragma unroll
    for (int kk = 0; kk < KC / 16; ++kk) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfrag;
      wmma::load_matrix_sync(bfrag, b_base + kk * 16 * LDB + cf * 16, LDB);
#pragma unroll
      for (int i = 0; i < kMaxFrags; ++i) {
        const int mt = rg + i * kRowGroups;
        if (mt < m_tiles) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> afrag;
          wmma::load_matrix_sync(afrag, a_base + mt * 16 * lda + kk * 16, lda);
          wmma::mma_sync(acc[i], afrag, bfrag, acc[i]);
        }
      }
    }
    if (s % ksteps == ksteps - 1) {
      // epilogue of the chunk: each fragment through the warp's scratch
      // tile; lane l takes row l / 2, columns (l % 2) * 8 ... + 8
      const int n0 = (s / ksteps) * NC;
#pragma unroll
      for (int i = 0; i < kMaxFrags; ++i) {
        const int mt = rg + i * kRowGroups;
        if (mt < m_tiles) {
          wmma::store_matrix_sync(scratch, acc[i], 16, wmma::mem_row_major);
          __syncwarp();
          const int r = lane / 2;
          const int c = (lane % 2) * 8;
          float v[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] = scratch[r * 16 + c + e];
          epi(mt * 16 + r, n0 + cf * 16 + c, v);
          __syncwarp();
        }
        wmma::fill_fragment(acc[i], 0.f);
      }
    }
    __syncthreads();  // every warp is done with buffer `buf` before step s + 2 refills it
  }
}

__global__ void __launch_bounds__(kThreads)
identity_block_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                      const float* __restrict__ b1, const bf16* __restrict__ w2,
                      const float* __restrict__ b2, const bf16* __restrict__ w3,
                      const float* __restrict__ b3, bf16* __restrict__ out, int H, int W, int C,
                      int F, int TH) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = layout(W, F, TH);
  bf16* y1 = reinterpret_cast<bf16*>(smem + L.y1);
  bf16* y2 = reinterpret_cast<bf16*>(smem + L.y2);
  bf16* as = reinterpret_cast<bf16*>(smem + L.a);
  bf16* bs = reinterpret_cast<bf16*>(smem + L.b);
  float* scratch = reinterpret_cast<float*>(smem + L.scratch) + (threadIdx.x / 32) * 256;

  const int h0 = blockIdx.x * TH;                                  // first output row of the band
  const size_t img = static_cast<size_t>(blockIdx.y) * H * W;      // first pixel of the image
  const int ld = F + 8;
  const int W2 = W + 2;
  const int M1 = (TH + 2) * W;
  const int M2 = TH * W;

  // zero y1 (its pad columns stay zero) and y2 (its padding rows feed
  // stage 3's discarded rows); the first stage's barrier publishes it
  for (size_t o = threadIdx.x * 16; o < L.a - L.y1; o += kThreads * 16)
    *reinterpret_cast<uint4*>(smem + L.y1 + o) = make_uint4(0u, 0u, 0u, 0u);

  // --- stage 1: y1 over the band and its halo rows (A = x from device memory)
  block_gemm(
      L.m1_tiles, F, C, w1, as, L.a_stride, bs, scratch, nullptr, 0,
      [&](bf16* a, int k0) {
        for (int c = threadIdx.x; c < L.m1_tiles * 16 * (KC / 8); c += kThreads) {
          const int m = c / (KC / 8);
          const int kc = (c % (KC / 8)) * 8;
          const bf16* src = x;
          int bytes = 0;  // zeros for padding rows and rows outside the image
          if (m < M1) {
            const int row = h0 - 1 + m / W;
            if (row >= 0 && row < H) {
              src = x + (img + static_cast<size_t>(row) * W + m % W) * C + k0 + kc;
              bytes = 16;
            }
          }
          cp_async16(a + m * LDA + kc, src, bytes);
        }
      },
      [&](int m, int n, float (&v)[8]) {
        if (m >= M1) return;
        const int lr = m / W;
        const int row = h0 - 1 + lr;
        float o[8];
        if (row >= 0 && row < H) {
#pragma unroll
          for (int e = 0; e < 8; ++e) o[e] = fmaxf(v[e] + __ldg(b1 + n + e), 0.f);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) o[e] = 0.f;  // SAME padding of y1
        }
        *reinterpret_cast<uint4*>(y1 + static_cast<size_t>(lr * W2 + m % W + 1) * ld + n) = pack8(o);
      });

  // --- stage 2: y2 = 3x3 conv of y1 (A = im2col taps staged from y1)
  block_gemm(
      L.m2_tiles, F, 9 * F, w2, as, L.a_stride, bs, scratch, nullptr, 0,
      [&](bf16* a, int k0) {
        const int tap = k0 / F;  // KC divides F: a K step never straddles two taps
        const int c0 = k0 % F;
        const int dr = tap / 3;  // y1 row offset: y1's row 0 is image row h0 - 1
        const int dc = tap % 3;  // y1 column offset: y1's column 0 is image column -1
        for (int c = threadIdx.x; c < L.m2_tiles * 16 * (KC / 8); c += kThreads) {
          const int m = c / (KC / 8);
          const int kc = (c % (KC / 8)) * 8;
          uint4 v = make_uint4(0u, 0u, 0u, 0u);
          if (m < M2)
            v = *reinterpret_cast<const uint4*>(
                y1 + static_cast<size_t>((m / W + dr) * W2 + m % W + dc) * ld + c0 + kc);
          *reinterpret_cast<uint4*>(a + m * LDA + kc) = v;
        }
      },
      [&](int m, int n, float (&v)[8]) {
        if (m >= M2) return;
        float o[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) o[e] = fmaxf(v[e] + __ldg(b2 + n + e), 0.f);
        *reinterpret_cast<uint4*>(y2 + static_cast<size_t>(m) * ld + n) = pack8(o);
      });

  // --- stage 3: out = relu(bf16(y2 . w3 + b3) + x) (A = y2 in place)
  block_gemm(
      L.m2_tiles, C, F, w3, as, L.a_stride, bs, scratch, y2, ld, [](bf16*, int) {},
      [&](int m, int n, float (&v)[8]) {
        if (m >= M2 || h0 + m / W >= H) return;
        const size_t p = (img + static_cast<size_t>(h0 + m / W) * W + m % W) * C + n;
        float xr[8], o[8];
        unpack8(__ldg(reinterpret_cast<const uint4*>(x + p)), xr);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          o[e] = fmaxf(round_bf16(v[e] + __ldg(b3 + n + e)) + xr[e], 0.f);
        *reinterpret_cast<uint4*>(out + p) = pack8(o);
      });
}

// How a (H, W, F) block is cut into bands: the fewest bands whose stage-1
// pixels fit 256 fragment rows and whose CTA fits the shared memory a
// block may use, each as short as that count allows (the last band wastes
// the least).
struct Plan {
  int th;
  size_t smem;
};

Plan plan(int H, int W, int F) {
  int longest = 0;
  for (int th = 1; th <= H; ++th)
    if ((th + 2) * W <= kMaxTiles * 16 && layout(W, F, th).total <= kMaxSmem) longest = th;
  if (longest == 0) return {0, 0};
  const int bands = (H + longest - 1) / longest;
  const int th = (H + bands - 1) / bands;
  return {th, layout(W, F, th).total};
}

cudaError_t launch(const Plan& p, const void* x, const void* w1, const void* b1, const void* w2,
                   const void* b2, const void* w3, const void* b3, void* out, int B, int H,
                   int W, int C, int F, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(identity_block_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(p.smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((H + p.th - 1) / p.th, B);
  identity_block_kernel<<<grid, kThreads, p.smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w1), static_cast<const float*>(b1),
      static_cast<const bf16*>(w2), static_cast<const float*>(b2), static_cast<const bf16*>(w3),
      static_cast<const float*>(b3), static_cast<bf16*>(out), H, W, C, F, p.th);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

// One identity block, x -> out (which must not alias x). Returns the
// cudaError_t of the launch (0 = success); cudaErrorInvalidValue for a shape
// the kernel does not take: C and F multiples of 64, a band of one row and
// its halo rows within 256 fragment rows (W <= 85) and one CTA's shared
// memory, 16-byte aligned pointers. Types and shapes are checked by the Python wrapper
// (ops/fused_resnet.py).
extern "C" int fused_identity_block_bf16(const void* x, const void* w1, const void* b1,
                                         const void* w2, const void* b2, const void* w3,
                                         const void* b3, void* out, int B, int H, int W, int C,
                                         int F, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || F <= 0 || C % KC || F % KC || C % NC ||
      F % NC || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* ptrs[4] = {x, w1, w2, w3};
  for (const void* p : ptrs)
    if (!aligned16(p)) return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned16(out)) return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = plan(H, W, F);
  if (p.th == 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch(p, x, w1, b1, w2, b2, w3, b3, out, B, H, W, C, F,
                                 static_cast<cudaStream_t>(stream)));
}

// The band height the kernel uses at (H, W, F), 0 when it takes no such shape.
extern "C" int fused_identity_block_band_rows(int H, int W, int F) { return plan(H, W, F).th; }
