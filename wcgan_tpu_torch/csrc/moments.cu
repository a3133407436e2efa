// K1: mean and divide-by-R covariance of the rows of x (R, C), for Hopper.
//
// Replaces the TPU kernel wcgan_tpu/ops/pallas_wc.py::_moments_kernel
// (launched by _moments_pallas). It computes the same thing: the column
// mean of x, then the two-pass CENTERED Gram sum_r (x_r - mu)(x_r - mu)^T / R,
// accumulated in float32 for float32 and bfloat16 input, tail rows masked.
// The one-pass form E[xx^T] - mu mu^T cancels catastrophically when
// |mu| >> sigma, so mu is final before any product is taken.
//
// What bounds it on an H100: the Gram is 2*R*C^2 flops against R*C*itemsize
// bytes, about 128 flops per byte at C=256 in bfloat16, so plain FP32 FFMA
// (67 TFLOP/s) is the ceiling rather than HBM (3.35 TB/s). Tensor cores are
// not used: the whitening path keeps true float32 (TF32 keeps ~3 digits and
// the gate against the plain float32 version is 1e-4).
//
// What the design does about it:
// - The TPU grid runs in order and carries the row sum and the C x C
//   accumulator in VMEM across steps. Hopper blocks run in parallel and in
//   no order, so the reduction is split into four launches, each finished
//   before the next starts (same stream): per-chunk column sums, the mean,
//   per-(chunk, tile pair) partial centered Grams, and a fixed-order reduce
//   over chunks. No atomics: the result is the same from run to run.
// - The C x C float32 accumulator (256 KB at C=256) does not fit in a
//   block's 227 KB of shared memory. The output is cut into 128 x 128 tiles
//   held in registers, 8 x 8 per thread (256 threads): 64 FFMA per 4
//   shared-memory loads, so the FMA pipes rather than shared memory set
//   the pace. Only tiles on or above the diagonal are computed (3 of 4 at
//   C=256) and the reduce mirrors them, so the result is exactly symmetric.
// - Filling 132 SMs: the rows are split into chunks sized so that the Gram
//   launch has about kTargetBlocks blocks (two waves at two blocks per SM):
//   at C=256, 176 chunks x 3 tile pairs. Consecutive blocks share a chunk,
//   so the rows they re-read hit in L2. The column sums use short fixed
//   chunks of kSumRows rows, ~1,000 blocks at R=131,072: a bfloat16 row of
//   a warp is only 64 bytes, so many loads must be in flight.
// - Rows are staged through shared memory as float32, centered on load
//   (bfloat16 is converted there); columns past C and rows past R load 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 128;         // edge of an output tile
constexpr int kHalf = kTile / 2;   // a thread's 8 rows/cols: 2 runs of 4
constexpr int kThreads = 256;      // 16 x 16 threads, 8 x 8 outputs each
constexpr int kStageRows = 16;     // rows staged in shared memory at a time
constexpr int kTargetBlocks = 528; // Gram blocks aimed for: 4 per SM
constexpr int kSumThreads = 256;   // columns per block in the column sums
constexpr int kSumRows = 128;      // rows per block in the column sums
constexpr int kMeanCols = 32;      // columns per block in the mean reduce
constexpr int kMeanLanes = 8;      // chunk lanes per column in that reduce

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__host__ __device__ __forceinline__ int num_tiles(int cols) {
  return (cols + kTile - 1) / kTile;
}
__host__ __device__ __forceinline__ int num_pairs(int cols) {
  return num_tiles(cols) * (num_tiles(cols) + 1) / 2;
}
__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

// Tile pair p, counted row by row over ti <= tj, -> (ti, tj).
__device__ __forceinline__ void pair_tiles(int p, int tiles, int* ti,
                                           int* tj) {
  int i = 0;
  while (p >= tiles - i) {
    p -= tiles - i;
    ++i;
  }
  *ti = i;
  *tj = i + p;
}

// Rows per Gram chunk: a whole number of stages, at least one, and few
// enough chunks for the Gram launch's grid.y limit of 65535.
int64_t chunk_rows_for(int64_t rows, int cols) {
  int64_t chunks = kTargetBlocks / num_pairs(cols);
  if (chunks < 1) chunks = 1;
  int64_t chunk = (rows + chunks - 1) / chunks;
  const int64_t min_chunk = (rows + 65534) / 65535;
  if (chunk < min_chunk) chunk = min_chunk;
  return (chunk + kStageRows - 1) / kStageRows * kStageRows;
}
int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

// Launch 1: partial[s, c] = sum of x[r, c] over rows s*kSumRows ... + kSumRows.
template <typename T>
__global__ void __launch_bounds__(kSumThreads)
col_partial_sums(const T* __restrict__ x, int64_t rows, int cols,
                 float* __restrict__ partial) {
  const int c = blockIdx.y * kSumThreads + threadIdx.x;
  if (c >= cols) return;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * kSumRows;
  const int64_t r1 = min64(rows, r0 + kSumRows);
  // Eight interleaved sums: eight loads in flight, smaller rounding.
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  int64_t r = r0;
  for (; r + 8 <= r1; r += 8) {
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[k] += to_f32(x[(r + k) * cols + c]);
  }
  for (; r < r1; ++r) acc[0] += to_f32(x[r * cols + c]);
  partial[static_cast<int64_t>(blockIdx.x) * cols + c] =
      ((acc[0] + acc[1]) + (acc[2] + acc[3])) +
      ((acc[4] + acc[5]) + (acc[6] + acc[7]));
}

// Launch 2: mean[c] = sum over chunks / rows. kMeanLanes lanes per column
// each sum every kMeanLanes-th chunk, then one lane adds the lanes in
// order: deterministic.
__global__ void __launch_bounds__(kMeanCols * kMeanLanes)
finalize_mean(const float* __restrict__ partial, int64_t chunks, int cols,
              float inv_rows, float* __restrict__ mean) {
  __shared__ float lane_sums[kMeanLanes][kMeanCols];
  const int col = threadIdx.x % kMeanCols;
  const int lane = threadIdx.x / kMeanCols;
  const int c = blockIdx.x * kMeanCols + col;
  float acc = 0.f;
  if (c < cols) {
#pragma unroll 4
    for (int64_t s = lane; s < chunks; s += kMeanLanes)
      acc += partial[s * cols + c];
  }
  lane_sums[lane][col] = acc;
  __syncthreads();
  if (lane == 0 && c < cols) {
    float total = 0.f;
#pragma unroll
    for (int l = 0; l < kMeanLanes; ++l) total += lane_sums[l][col];
    mean[c] = total * inv_rows;
  }
}

// Launch 3: ws[s, p] = sum over the rows of chunk s of the centered outer
// product restricted to tile pair p = (ti, tj), ti <= tj.
// grid = (pairs, chunks); pairs vary fastest so a chunk stays in L2.
// Thread (tx, ty) owns rows {ty*4 .. +3} and {64 + ty*4 .. +3} and the same
// columns from tx: two runs of four keep its float4 shared loads free of
// bank conflicts.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
centered_gram_partial(const T* __restrict__ x, const float* __restrict__ mean,
                      int64_t rows, int cols, int64_t chunk_rows,
                      float* __restrict__ ws) {
  __shared__ __align__(16) float sa[kStageRows][kTile];
  __shared__ __align__(16) float sb[kStageRows][kTile];
  __shared__ float mean_a[kTile];
  __shared__ float mean_b[kTile];

  int ti, tj;
  pair_tiles(blockIdx.x, num_tiles(cols), &ti, &tj);
  const int ca0 = ti * kTile;
  const int cb0 = tj * kTile;

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  if (tid < kTile) {
    mean_a[tid] = (ca0 + tid < cols) ? mean[ca0 + tid] : 0.f;
  } else {
    const int k = tid - kTile;
    mean_b[k] = (cb0 + k < cols) ? mean[cb0 + k] : 0.f;
  }
  __syncthreads();

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int64_t r0 = static_cast<int64_t>(blockIdx.y) * chunk_rows;
  const int64_t r1 = min64(rows, r0 + chunk_rows);
  for (int64_t rs = r0; rs < r1; rs += kStageRows) {
#pragma unroll
    for (int k = 0; k < kStageRows * kTile / kThreads; ++k) {
      const int idx = k * kThreads + tid;
      const int rr = idx / kTile;
      const int cc = idx % kTile;
      const int64_t r = rs + rr;
      float va = 0.f;
      float vb = 0.f;
      if (r < r1) {
        const T* row = x + r * cols;
        if (ca0 + cc < cols) va = to_f32(row[ca0 + cc]) - mean_a[cc];
        if (cb0 + cc < cols) vb = to_f32(row[cb0 + cc]) - mean_b[cc];
      }
      sa[rr][cc] = va;
      sb[rr][cc] = vb;
    }
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < kStageRows; ++rr) {
      const float4 a0 = *reinterpret_cast<const float4*>(&sa[rr][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&sa[rr][kHalf + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&sb[rr][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&sb[rr][kHalf + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* out = ws + (static_cast<int64_t>(blockIdx.y) * gridDim.x + blockIdx.x)
                        * (kTile * kTile);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = (i < 4 ? 0 : kHalf) + ty * 4 + (i % 4);
    *reinterpret_cast<float4*>(&out[row * kTile + tx * 4]) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(&out[row * kTile + kHalf + tx * 4]) =
        make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
}

// Launch 4: cov = (sum over chunks, in order, of ws) / rows, mirrored below
// the diagonal. One thread per element of the upper tile pairs.
__global__ void __launch_bounds__(kThreads)
reduce_gram(const float* __restrict__ ws, int64_t chunks, int cols,
            float inv_rows, float* __restrict__ cov) {
  const int pairs = num_pairs(cols);
  const int64_t e = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= static_cast<int64_t>(pairs) * kTile * kTile) return;
  const int li = static_cast<int>(e % (kTile * kTile)) / kTile;
  const int lj = static_cast<int>(e % kTile);
  int ti, tj;
  pair_tiles(static_cast<int>(e / (kTile * kTile)), num_tiles(cols), &ti,
             &tj);
  const int i = ti * kTile + li;
  const int j = tj * kTile + lj;
  if (i >= cols || j >= cols) return;
  const int64_t stride = static_cast<int64_t>(pairs) * kTile * kTile;
  float acc = 0.f;
  for (int64_t s = 0; s < chunks; ++s) acc += ws[s * stride + e];
  acc *= inv_rows;
  cov[static_cast<int64_t>(i) * cols + j] = acc;
  if (ti != tj) cov[static_cast<int64_t>(j) * cols + i] = acc;
}

template <typename T>
cudaError_t launch(const T* x, int64_t rows, int cols, float* mean, float* cov,
                   float* workspace, cudaStream_t stream) {
  const int64_t chunk_rows = chunk_rows_for(rows, cols);
  const int64_t chunks = ceil_div(rows, chunk_rows);
  const int64_t sum_chunks = ceil_div(rows, kSumRows);
  const int pairs = num_pairs(cols);
  const float inv_rows = 1.0f / static_cast<float>(rows);
  // The Gram partials come first: their float4 stores need 16-byte
  // alignment, which the caller's allocation gives and chunks * cols may not.
  float* gram_partial = workspace;                      // [chunks, pairs, T, T]
  float* col_partial = workspace + chunks * pairs * kTile * kTile;

  col_partial_sums<T><<<dim3(static_cast<unsigned>(sum_chunks),
                             ceil_div(cols, kSumThreads)),
                        kSumThreads, 0, stream>>>(x, rows, cols, col_partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  finalize_mean<<<ceil_div(cols, kMeanCols), kMeanCols * kMeanLanes, 0,
                  stream>>>(col_partial, sum_chunks, cols, inv_rows, mean);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  centered_gram_partial<T><<<dim3(pairs, static_cast<unsigned>(chunks)),
                             kThreads, 0, stream>>>(x, mean, rows, cols,
                                                    chunk_rows, gram_partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t elems = static_cast<int64_t>(pairs) * kTile * kTile;
  reduce_gram<<<static_cast<unsigned>(ceil_div(elems, kThreads)), kThreads, 0,
                stream>>>(gram_partial, chunks, cols, inv_rows, cov);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Floats of scratch the caller allocates for one call at (rows, cols).
int64_t wcgan_moments_workspace_floats(int64_t rows, int cols) {
  const int64_t chunks = ceil_div(rows, chunk_rows_for(rows, cols));
  return chunks * static_cast<int64_t>(num_pairs(cols)) * kTile * kTile +
         ceil_div(rows, kSumRows) * cols;
}

// dtype: 0 = float32, 1 = bfloat16. x is (rows, cols) row-major and
// contiguous; mean (cols,), cov (cols, cols) and workspace are float32.
// Enqueues on `stream` and does not synchronise. Returns the cudaError_t of
// the first launch that failed, 0 when all four were accepted.
int wcgan_moments(const void* x, int dtype, int64_t rows, int cols,
                  float* mean, float* cov, float* workspace, void* stream) {
  if (rows < 1 || cols < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(launch(static_cast<const float*>(x), rows, cols,
                                   mean, cov, workspace, s));
  if (dtype == 1)
    return static_cast<int>(launch(static_cast<const __nv_bfloat16*>(x), rows,
                                   cols, mean, cov, workspace, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
