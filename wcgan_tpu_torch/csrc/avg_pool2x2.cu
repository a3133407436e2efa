// K4: the 2x2 average pool of D's down-sampling blocks (stride 2, no
// padding), forward and backward, on NHWC memory (channels_last).
//
// Replaces no TPU kernel: the JAX package pools with a reshape and a mean
// (wcgan_tpu/models/layers.py::downsample_avg), which XLA fuses. Here it
// replaces ATen's avg_pool2d_out_cuda_frame_nhwc and
// avg_pool2d_backward_out_cuda_frame_nhwc, which run one thread per element,
// recover (n, h, w, c) from the flat index with 64-bit divisions and moduli
// and the window's bounds with more, and move 2 bytes: bound by
// instructions, at ~6 % of the card's memory rate on D's pools.
//
// What bounds it: HBM bytes. A forward reads every input element once and
// writes a quarter as many; a backward reads the quarter and writes the
// whole. At 3.35 TB/s the pools of one 64x64 training step (563 M elements
// each way, bf16) take at least ~0.42 ms a direction. The design:
// - One thread per 16 bytes of one output pixel's channels (8 bf16 or 4
//   float32): four 16-byte loads, one 16-byte store (forward), or one load
//   and four stores (backward). Rows whose channels are not a multiple of
//   16 bytes (the optimized block's 3-channel image) or that are not
//   16-byte aligned take the same kernel one element a thread.
// - No division: the grid's x is the output row (n * H/2 + i, which is
//   input row 2 (n * H/2 + i) because H is even), y the output column, z a
//   slice of the channels; the thread's offsets are products in 32 bits
//   but for the row's base.
// - 256 threads a block, 8 blocks an SM: 2,048 threads each with 64 bytes
//   in flight on 132 SMs, ~17 MB, far above the ~2 MB the card's latency
//   needs at its rate.
// Arithmetic, so that both are bit-equal to ATen's kernels: the forward
// sums ((((0 + x[2i,2j]) + x[2i,2j+1]) + x[2i+1,2j]) + x[2i+1,2j+1]) in
// float32 (ATen's order, from 0, so that four -0 give +0), divides by 4
// (times 0.25, exact) and rounds once to the output type; the backward
// writes 0 + g * 0.25 in float32, rounded once, to the four inputs of g's
// window (windows of stride 2 do not overlap, so each input has one).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename T, int N>
struct alignas(sizeof(T) * N) Pack {
  T v[N];
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x (rows * 2, 2 * wo, c) -> y (rows, wo, c), N channels a thread.
template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
    avg_pool2x2_fwd(const T* __restrict__ x, T* __restrict__ y, int wo,
                    int c) {
  const int j = blockIdx.y * blockDim.y + threadIdx.y;
  const int cv = (blockIdx.z * blockDim.x + threadIdx.x) * N;
  if (j >= wo || cv >= c) return;
  const int row_in = 2 * wo * c;  // elements of one input row
  const T* p = x + static_cast<size_t>(blockIdx.x) * 2 * row_in + 2 * j * c
               + cv;
  using P = Pack<T, N>;
  const P a = *reinterpret_cast<const P*>(p);
  const P b = *reinterpret_cast<const P*>(p + c);
  const P d = *reinterpret_cast<const P*>(p + row_in);
  const P e = *reinterpret_cast<const P*>(p + row_in + c);
  P out;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    float s = 0.f;
    s += to_float(a.v[k]);
    s += to_float(b.v[k]);
    s += to_float(d.v[k]);
    s += to_float(e.v[k]);
    out.v[k] = from_float<T>(s * 0.25f);
  }
  *reinterpret_cast<P*>(y + static_cast<size_t>(blockIdx.x) * wo * c
                        + j * c + cv) = out;
}

// g (rows, wo, c) -> dx (rows * 2, 2 * wo, c), N channels a thread.
template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
    avg_pool2x2_bwd(const T* __restrict__ g, T* __restrict__ dx, int wo,
                    int c) {
  const int j = blockIdx.y * blockDim.y + threadIdx.y;
  const int cv = (blockIdx.z * blockDim.x + threadIdx.x) * N;
  if (j >= wo || cv >= c) return;
  using P = Pack<T, N>;
  const P a = *reinterpret_cast<const P*>(
      g + static_cast<size_t>(blockIdx.x) * wo * c + j * c + cv);
  P out;
#pragma unroll
  for (int k = 0; k < N; ++k)
    out.v[k] = from_float<T>(0.f + to_float(a.v[k]) * 0.25f);
  const int row_in = 2 * wo * c;
  T* p = dx + static_cast<size_t>(blockIdx.x) * 2 * row_in + 2 * j * c + cv;
  *reinterpret_cast<P*>(p) = out;
  *reinterpret_cast<P*>(p + c) = out;
  *reinterpret_cast<P*>(p + row_in) = out;
  *reinterpret_cast<P*>(p + row_in + c) = out;
}

template <typename T, int N>
cudaError_t launch(bool backward, const void* src, void* dst, int rows,
                   int wo, int c, cudaStream_t stream) {
  const int vecs = c / N;  // threads across a pixel's channels
  const int bx = vecs < kThreads ? vecs : kThreads;
  int by = kThreads / bx;
  if (by > wo) by = wo;
  const dim3 block(bx, by);
  const dim3 grid(rows, (wo + by - 1) / by, (vecs + bx - 1) / bx);
  if (backward)
    avg_pool2x2_bwd<T, N><<<grid, block, 0, stream>>>(
        static_cast<const T*>(src), static_cast<T*>(dst), wo, c);
  else
    avg_pool2x2_fwd<T, N><<<grid, block, 0, stream>>>(
        static_cast<const T*>(src), static_cast<T*>(dst), wo, c);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(bool backward, const void* src, void* dst, int rows,
                     int wo, int c, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const bool aligned = (reinterpret_cast<uintptr_t>(src) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(dst) % 16 == 0);
  if (c % kVec == 0 && aligned)
    return launch<T, kVec>(backward, src, dst, rows, wo, c, stream);
  return launch<T, 1>(backward, src, dst, rows, wo, c, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. backward 0: src is x (N, H, W, C) in
// NHWC memory with H = 2 * rows / N and W = 2 * wo, dst y (N, H/2, W/2, C);
// backward 1: src is g of y's shape, dst dx of x's. rows = N * H/2; every
// tensor dense, 2 * W * C < 2^31 (two input rows index in 32 bits).
// Enqueues on `stream` and does not synchronise. Returns the launch's
// cudaError_t (0 when it was accepted).
int wcgan_avg_pool2x2(int backward, const void* src, int dtype, int rows,
                      int wo, int c, void* dst, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows < 1 || wo < 1 || c < 1 ||
      static_cast<int64_t>(4) * wo * c >= (int64_t(1) << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return static_cast<int>(
        dispatch<float>(backward != 0, src, dst, rows, wo, c, s));
  if (dtype == 1)
    return static_cast<int>(
        dispatch<__nv_bfloat16>(backward != 0, src, dst, rows, wo, c, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
