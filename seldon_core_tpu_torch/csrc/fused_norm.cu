// Fused residual add + RMSNorm on Hopper:
//   y = x + h                      (in the model dtype: a float32 add, rounded once)
//   o = y * rsqrt(mean(y^2) + eps) * w   (float32, rounded once to the model dtype)
// x, h, y, o: [rows, d] in bf16, f16 or float32; w: [d] in float32, bf16 or f16.
//
// Replaces the TPU kernel seldon_core_tpu/ops/fused_norm.py:137
// (fused_residual_rmsnorm, Pallas body _kernel:43): each transformer block
// runs x = x + h and then rms_norm(x); fused, the activation crosses device
// memory once each way.
//
// What bounds it on the card: neither bytes nor operations at the served
// shapes. [8, 4096] bf16 moves 270 KB (0.08 us at 3.35 TB/s) and does ~5
// flops an element; a call costs its latency: the launch after the previous
// kernel drains, one round trip to memory for x, h and w, the reduction
// across the row, the stores, and on the host its enqueue (the served
// decode step is host-bound). Design, and what each part does about that:
//   * one launch per call, one CTA per row, T threads (a multiple of 32, at
//     most 512) each holding SLOTS 16-byte vectors of x, h and w: at the
//     served width 256 threads x 2 slots (the wrapper's plan, fitted to
//     chip_smoke.py --k2-sweep). Every load of a chunk is issued before any
//     arithmetic; y and o are written 16 bytes at a time. The row's sum of
//     squares: each thread in order, a warp's xor shuffle tree, then the
//     same tree over the warps' sums, so two calls give the same bits;
//   * any d up to 2^30: a row wider than T x SLOTS vectors is walked in
//     chunks of that many. Each chunk's y is stored as it is summed; the last
//     chunk stays in registers for the output pass, and the earlier ones are
//     read back (y from this thread's own stores, and w). At d = 4096 a row
//     is one chunk (bf16 up to 16,384 and float32 up to 8,192 by default);
//   * a ragged d (d % (16 / sizeof(x)) != 0) or a base that is not 16-byte
//     aligned takes the scalar instantiation of the same kernel: the same
//     slots and arithmetic, one element per access, masked at d;
//   * the numerics of the JAX package: y is x + h rounded once to the model
//     dtype (a bf16/f16 pair in one add.rn: the exact sum rounded once,
//     bit-equal to PyTorch's and XLA's add); the sum of squares, the
//     division by the true d, rsqrt and the two multiplies are float32, with
//     one rounding at the end. Products and sums are __fmul_rn / __fadd_rn,
//     so no multiply-add is contracted: ops/fused_norm
//     .fused_residual_rmsnorm_emulated walks the same order on the CPU.
//
// The wrapper (ops/fused_norm.py) picks the threads, slots and chunks
// (_launch_plan).
//
// Built with nvcc into a shared library with a plain C interface and loaded
// with ctypes (ops/_build.py); pointers and the stream arrive as void*.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxSlots = 4;       // 16-byte vectors of x a thread holds (1, 2 or 4)
constexpr int kMaxThreads = 512;   // threads per CTA (one row)
constexpr int kMaxWarps = kMaxThreads / 32;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }

// N values of T in registers, aligned for one vector access (two for 32 bytes)
template <typename T, int N>
struct alignas(sizeof(T) * N >= 16 ? 16 : sizeof(T) * N) Pack {
  T v[N];
};

template <typename T, int N>
__device__ __forceinline__ void load_vec(Pack<T, N>& dst, const T* src) {
  constexpr int kBytes = sizeof(T) * N;
  static_assert(kBytes == 8 || kBytes == 16 || kBytes == 32, "8-, 16- or 32-byte packs");
  if constexpr (kBytes == 32) {
    reinterpret_cast<uint4*>(&dst)[0] = reinterpret_cast<const uint4*>(src)[0];
    reinterpret_cast<uint4*>(&dst)[1] = reinterpret_cast<const uint4*>(src)[1];
  } else if constexpr (kBytes == 16) {
    *reinterpret_cast<uint4*>(&dst) = *reinterpret_cast<const uint4*>(src);
  } else {
    *reinterpret_cast<uint2*>(&dst) = *reinterpret_cast<const uint2*>(src);
  }
}

template <typename T, int N>
__device__ __forceinline__ void store_vec(T* dst, const Pack<T, N>& src) {
  static_assert(sizeof(T) * N == 16, "16-byte stores");
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(&src);
}

// Columns c0.. of a slot, masked at d (the scalar instantiation): the
// elements past d keep what dst held (zeros)
template <typename T, int N>
__device__ __forceinline__ void load_masked(Pack<T, N>& dst, const T* src, int c0, int d) {
#pragma unroll
  for (int e = 0; e < N; ++e)
    if (c0 + e < d) dst.v[e] = src[e];
}

template <typename T, int N, bool kVec>
__device__ __forceinline__ void load(Pack<T, N>& dst, const T* src, int c0, int d) {
  if constexpr (kVec)
    load_vec(dst, src);
  else
    load_masked(dst, src, c0, d);
}

template <typename T, int N, bool kVec>
__device__ __forceinline__ void store(T* dst, const Pack<T, N>& src, int c0, int d) {
  if constexpr (kVec) {
    store_vec(dst, src);
  } else {
#pragma unroll
    for (int e = 0; e < N; ++e)
      if (c0 + e < d) dst[e] = src.v[e];
  }
}

// y = x + h rounded once to the model dtype, in place in x: a 16-bit pair
// in one add.rn.{bf16,f16}x2 (the exact sum rounded once, as a float32 add
// rounded to 16 bits gives)
__device__ __forceinline__ void add_round(Pack<float, 4>& x, const Pack<float, 4>& h) {
#pragma unroll
  for (int e = 0; e < 4; ++e) x.v[e] = __fadd_rn(x.v[e], h.v[e]);
}
__device__ __forceinline__ void add_round(Pack<__nv_bfloat16, 8>& x,
                                          const Pack<__nv_bfloat16, 8>& h) {
  auto* a = reinterpret_cast<__nv_bfloat162*>(x.v);
  const auto* b = reinterpret_cast<const __nv_bfloat162*>(h.v);
#pragma unroll
  for (int k = 0; k < 4; ++k) a[k] = __hadd2(a[k], b[k]);
}
__device__ __forceinline__ void add_round(Pack<__half, 8>& x, const Pack<__half, 8>& h) {
  auto* a = reinterpret_cast<__half2*>(x.v);
  const auto* b = reinterpret_cast<const __half2*>(h.v);
#pragma unroll
  for (int k = 0; k < 4; ++k) a[k] = __hadd2(a[k], b[k]);
}

// two float32 values rounded to the model dtype into p[0], p[1]
__device__ __forceinline__ void put2(float* p, float a, float b) {
  p[0] = a;
  p[1] = b;
}
__device__ __forceinline__ void put2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void put2(__half* p, float a, float b) {
  *reinterpret_cast<__half2*>(p) = __floats2half2_rn(a, b);
}

// The xor tree of a warp: every lane ends with the same bits
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m >= 1; m /= 2) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, m));
  return v;
}

// grid (rows), block (T). Slot i of thread t in chunk k holds the row's
// 16-byte vector (k * SLOTS + i) * T + t, if that lies in the row; a slot
// outside holds zeros, which add nothing to the sum of squares, and stores
// nothing.
template <typename XT, typename WT, int SLOTS, bool kVec>
__global__ void __launch_bounds__(kMaxThreads)
fused_residual_rmsnorm_kernel(const XT* __restrict__ x, const XT* __restrict__ h,
                              const WT* __restrict__ w, XT* __restrict__ y,
                              XT* __restrict__ o, int d, int chunks, float eps) {
  constexpr int VEC = 16 / sizeof(XT);
  __shared__ float warp_sums[kMaxWarps];
  const int t = threadIdx.x;
  const int T = blockDim.x;
  const int nvec = (d + VEC - 1) / VEC;
  const size_t base = static_cast<size_t>(blockIdx.x) * d;
  Pack<XT, VEC> xv[SLOTS];
  Pack<WT, VEC> wv[SLOTS];
  bool ok[SLOTS];
  int c0[SLOTS];
  auto slots_of = [&](int k) {
#pragma unroll
    for (int i = 0; i < SLOTS; ++i) {
      const int v = (k * SLOTS + i) * T + t;
      ok[i] = v < nvec;
      c0[i] = v * VEC;
      xv[i] = {};
      wv[i] = {};
    }
  };

  // the residual add in the model dtype, y stored, the thread's sum of
  // squares in chunk order, then slot order, then element order
  float ss = 0.f;
  for (int k = 0; k < chunks; ++k) {
    slots_of(k);
    Pack<XT, VEC> hv[SLOTS] = {};
    // every load of the chunk before any arithmetic
#pragma unroll
    for (int i = 0; i < SLOTS; ++i) {
      if (!ok[i]) continue;
      load<XT, VEC, kVec>(xv[i], x + base + c0[i], c0[i], d);
      load<XT, VEC, kVec>(hv[i], h + base + c0[i], c0[i], d);
      load<WT, VEC, kVec>(wv[i], w + c0[i], c0[i], d);
    }
#pragma unroll
    for (int i = 0; i < SLOTS; ++i) {
      add_round(xv[i], hv[i]);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float yf = to_f(xv[i].v[e]);
        ss = __fadd_rn(ss, __fmul_rn(yf, yf));
      }
      if (ok[i]) store<XT, VEC, kVec>(y + base + c0[i], xv[i], c0[i], d);
    }
  }

  // the row's sum: the warp's xor tree, then the xor tree over the warps'
  // sums (zero past the last warp); every thread reads the same bits
  ss = warp_sum(ss);
  const int lane = t % 32;
  if (lane == 0) warp_sums[t / 32] = ss;
  __syncthreads();
  const float total = warp_sum(lane < T / 32 ? warp_sums[lane] : 0.f);
  const float inv = rsqrtf(__fadd_rn(__fdiv_rn(total, static_cast<float>(d)), eps));

  // o, last chunk first: it is still in registers; an earlier chunk's y is
  // read back from this thread's own stores, and its w again
  for (int k = chunks - 1; k >= 0; --k) {
    if (k != chunks - 1) {
      slots_of(k);
#pragma unroll
      for (int i = 0; i < SLOTS; ++i) {
        if (!ok[i]) continue;
        load<XT, VEC, kVec>(xv[i], y + base + c0[i], c0[i], d);
        load<WT, VEC, kVec>(wv[i], w + c0[i], c0[i], d);
      }
    }
#pragma unroll
    for (int i = 0; i < SLOTS; ++i) {
      if (!ok[i]) continue;
      Pack<XT, VEC> ov;
#pragma unroll
      for (int e = 0; e < VEC; e += 2)
        put2(&ov.v[e], __fmul_rn(__fmul_rn(to_f(xv[i].v[e]), inv), to_f(wv[i].v[e])),
             __fmul_rn(__fmul_rn(to_f(xv[i].v[e + 1]), inv), to_f(wv[i].v[e + 1])));
      store<XT, VEC, kVec>(o + base + c0[i], ov, c0[i], d);
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

template <typename XT, typename WT, int SLOTS, bool kVec>
cudaError_t launch_as(const void* x, const void* h, const void* w, void* y, void* o, int rows,
                      int d, float eps, int threads, int chunks, cudaStream_t stream) {
  fused_residual_rmsnorm_kernel<XT, WT, SLOTS, kVec><<<rows, threads, 0, stream>>>(
      static_cast<const XT*>(x), static_cast<const XT*>(h), static_cast<const WT*>(w),
      static_cast<XT*>(y), static_cast<XT*>(o), d, chunks, eps);
  return cudaGetLastError();
}

template <typename XT, typename WT, bool kVec>
cudaError_t launch_slots(const void* x, const void* h, const void* w, void* y, void* o,
                         int rows, int d, float eps, int threads, int slots, int chunks,
                         cudaStream_t stream) {
  switch (slots) {
    case 1:
      return launch_as<XT, WT, 1, kVec>(x, h, w, y, o, rows, d, eps, threads, chunks, stream);
    case 2:
      return launch_as<XT, WT, 2, kVec>(x, h, w, y, o, rows, d, eps, threads, chunks, stream);
    case 4:
      return launch_as<XT, WT, 4, kVec>(x, h, w, y, o, rows, d, eps, threads, chunks, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename XT, typename WT>
cudaError_t launch_w(const void* x, const void* h, const void* w, void* y, void* o, int rows,
                     int d, float eps, int threads, int slots, int chunks, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(XT);
  const bool vec = d % VEC == 0 && aligned16(x) && aligned16(h) && aligned16(w) &&
                   aligned16(y) && aligned16(o);
  return vec ? launch_slots<XT, WT, true>(x, h, w, y, o, rows, d, eps, threads, slots, chunks,
                                          stream)
             : launch_slots<XT, WT, false>(x, h, w, y, o, rows, d, eps, threads, slots, chunks,
                                           stream);
}

template <typename XT>
cudaError_t launch_x(const void* x, const void* h, const void* w, void* y, void* o, int rows,
                     int d, float eps, int w_dtype, int threads, int slots, int chunks,
                     cudaStream_t stream) {
  switch (w_dtype) {
    case 0:
      return launch_w<XT, float>(x, h, w, y, o, rows, d, eps, threads, slots, chunks, stream);
    case 1:
      return launch_w<XT, __nv_bfloat16>(x, h, w, y, o, rows, d, eps, threads, slots, chunks,
                                         stream);
    case 2:
      return launch_w<XT, __half>(x, h, w, y, o, rows, d, eps, threads, slots, chunks, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns the cudaError_t of the one launch (0 = success). Shapes and types
// are checked by the Python wrapper. ``params``: rows, d, the dtype codes of
// x and w (0 float32, 1 bf16, 2 f16), threads, slots, chunks. One CTA of
// ``threads`` (a multiple of 32, at most 512) a row, each thread holding
// ``slots`` (1, 2 or 4) 16-byte vectors of each of ``chunks`` chunks, which
// together cover the row.
extern "C" int fused_residual_rmsnorm(const void* x, const void* h, const void* w, void* y,
                                      void* o, float eps, const int* params, void* stream) {
  const int rows = params[0], d = params[1], x_dtype = params[2], w_dtype = params[3];
  const int threads = params[4], slots = params[5], chunks = params[6];
  const int vec = x_dtype == 0 ? 4 : 8;
  if (rows <= 0 || d <= 0 || d > (1 << 30) || threads < 32 || threads > kMaxThreads ||
      threads % 32 != 0 || (slots != 1 && slots != 2 && slots != kMaxSlots) || chunks < 1 ||
      static_cast<long long>(threads) * slots * chunks < (d + vec - 1) / vec)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (x_dtype) {
    case 0:
      return static_cast<int>(
          launch_x<float>(x, h, w, y, o, rows, d, eps, w_dtype, threads, slots, chunks, s));
    case 1:
      return static_cast<int>(launch_x<__nv_bfloat16>(x, h, w, y, o, rows, d, eps, w_dtype,
                                                      threads, slots, chunks, s));
    case 2:
      return static_cast<int>(
          launch_x<__half>(x, h, w, y, o, rows, d, eps, w_dtype, threads, slots, chunks, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
