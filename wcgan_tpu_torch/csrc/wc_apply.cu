// K2: the whole stats-given WC layer, out = x (Gamma W)^T + beta - mu (Gamma W)^T
// with W = cov^{-1/2} by coupled Newton-Schulz, for Hopper.
//
// Replaces the TPU kernel wcgan_tpu/ops/pallas_wc.py::_wc_apply_kernel
// (launched by whiten_color_apply). It computes the same thing: the SPD
// jitter eps*mean_diag + 2*neg_diag + 1e-12 (ops/whiten.py::_spd_jitter),
// the trace or Frobenius normalization, ns_iters coupled Newton-Schulz steps
// (T = 1.5 I - 0.5 Z Y; Y <- Y T; Z <- T Z), W = Z / sqrt(s), the fold
// M = Gamma W and bias = beta - mu M^T, then out = x M^T + bias on every
// row, accumulated in float32 for float32 and bfloat16 rows and written in
// x's dtype. Every product is true float32 FFMA: under reduced-precision
// passes Newton-Schulz plateaus near 2e-2 (pallas_wc.py:228-231), so no
// tensor core (TF32) is used anywhere.
//
// What bounds it on an H100:
// - The setup is 3*ns_iters dependent C x C float32 products: 45 at the
//   default, 1.5 GFLOP at C=256 and 12 GFLOP at C=512. Each product needs
//   the one before it, so it is bound by latency and by how many SMs one
//   product can occupy, not by the card's 67 TFLOP/s FP32 peak. One block
//   (one SM, ~0.5 TFLOP/s) would take ~3 ms per call at C=256.
// - The row apply is 2*R*C^2 flops against R*C*itemsize*2 bytes: at the
//   sampling batch 256 (R=262,144, C=256) 34 GFLOP and 256 MiB (bf16), so
//   the FP32 FFMA pipes (>= 0.5 ms) bound it, not HBM (~0.08 ms).
//
// What the design does about it:
// - The TPU kernel does the setup once in grid step 0 and relies on its
//   sequential grid. Hopper blocks run in parallel and in no order, so the
//   setup and the apply are stream-ordered launches behind one C entry:
//   (1) one block reduces the diagonal and the norm to the jitter and s;
//   (2) Y0 = (cov + jitter I)/s and Z0 = I, elementwise;
//   (3) per Newton-Schulz step two launches: T = 1.5 I - 0.5 Z Y, then
//       Y' = Y T and Z' = T Z together (blockIdx.z picks the product);
//   (4) M^T = (Gamma Z / sqrt(s))^T, one more product;
//   (5) bias = beta - mu M^T;
//   (6) the row apply. It starts only after M^T and the bias are final,
//       which the stream order guarantees.
//   One launch per product was chosen over one cooperative launch with
//   grid-wide barriers: it is simpler, needs no co-residency limit on the
//   grid, and the ~35 launches of a call are queued by one C call (the
//   plain PyTorch version dispatches ~50 operators from Python).
// - Each C x C product is spread over the SMs as 32 x 32 output tiles
//   (2 x 2 per thread): 64 blocks per product at C=256, 128 for the paired
//   Y/Z update. Y, Z and T live in the workspace (256 KB each at C=256),
//   which stays in the 50 MB L2.
// - The row apply is a tiled FFMA GEMM: 128 x 128 output tiles, 8 x 8 per
//   thread in registers (64 FFMA per 4 shared-memory loads), x staged in
//   shared memory 16 columns at a time as float32 (bf16 converted on load),
//   M^T staged beside it. Rows past R and columns past C load 0 and are
//   not stored, so any R and any C up to kMaxCols work.
// A faster apply (tensor cores with a 3xTF32 split, wgmma) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxCols = 512;      // the widest WC layer of the G presets
constexpr int kScalars = 4;        // [jitter, s, -, -] at the workspace head
constexpr int kReduceThreads = 1024;
constexpr int kInitThreads = 256;
constexpr int kNsTile = 32;        // C x C products: 32 x 32 output tiles
constexpr int kNsThreads = 256;    // 16 x 16 threads, 2 x 2 outputs each
constexpr int kBiasThreads = 128;
constexpr int kTile = 128;         // row apply: 128 x 128 output tiles
constexpr int kHalf = kTile / 2;   // a thread's 8 rows/cols: 2 runs of 4
constexpr int kThreads = 256;      // 16 x 16 threads, 8 x 8 outputs each
constexpr int kStage = 16;         // columns of x staged at a time

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

// Sum and min over a block; every thread gets the results.
__device__ void block_sum_min(float* sum, float* mn) {
  __shared__ float part_sum[kReduceThreads / 32];
  __shared__ float part_min[kReduceThreads / 32];
  float s = *sum;
  float m = *mn;
#pragma unroll
  for (int off = 16; off > 0; off /= 2) {
    s += __shfl_down_sync(0xffffffffu, s, off);
    m = fminf(m, __shfl_down_sync(0xffffffffu, m, off));
  }
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) {
    part_sum[warp] = s;
    part_min[warp] = m;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < static_cast<int>(blockDim.x) / 32; ++w) {
      part_sum[0] += part_sum[w];
      part_min[0] = fminf(part_min[0], part_min[w]);
    }
  }
  __syncthreads();
  *sum = part_sum[0];
  *mn = part_min[0];
  __syncthreads();  // the buffers are reused by the next call
}

// Launch 1 (one block): scal[0] = the SPD jitter, scal[1] = s, the trace
// (scaling 0) or the Frobenius norm (scaling 1) of a = cov + jitter I.
__global__ void __launch_bounds__(kReduceThreads)
jitter_and_scale(const float* __restrict__ cov, int cols, float eps,
                 int scaling, float* __restrict__ scal) {
  float trace = 0.f;
  float min_diag = INFINITY;
  for (int i = threadIdx.x; i < cols; i += blockDim.x) {
    const float d = cov[static_cast<int64_t>(i) * cols + i];
    trace += d;
    min_diag = fminf(min_diag, d);
  }
  block_sum_min(&trace, &min_diag);
  const float mean_diag = fmaxf(trace / static_cast<float>(cols), 0.f);
  const float neg_diag = fmaxf(-min_diag, 0.f);
  const float jitter = eps * mean_diag + 2.f * neg_diag + 1e-12f;

  float acc = 0.f;
  float unused = 0.f;
  if (scaling == 0) {
    for (int i = threadIdx.x; i < cols; i += blockDim.x)
      acc += cov[static_cast<int64_t>(i) * cols + i] + jitter;
  } else {
    const int64_t elems = static_cast<int64_t>(cols) * cols;
    for (int64_t e = threadIdx.x; e < elems; e += blockDim.x) {
      const float a = cov[e] + ((e / cols == e % cols) ? jitter : 0.f);
      acc = fmaf(a, a, acc);
    }
  }
  block_sum_min(&acc, &unused);
  if (threadIdx.x == 0) {
    scal[0] = jitter;
    scal[1] = scaling == 0 ? acc : sqrtf(acc);
  }
}

// Launch 2: Y0 = (cov + jitter I) / s, Z0 = I.
__global__ void __launch_bounds__(kInitThreads)
ns_init(const float* __restrict__ cov, const float* __restrict__ scal,
        int cols, float* __restrict__ y, float* __restrict__ z) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * kInitThreads +
                    threadIdx.x;
  if (e >= static_cast<int64_t>(cols) * cols) return;
  const bool diag = e / cols == e % cols;
  y[e] = (cov[e] + (diag ? scal[0] : 0.f)) / scal[1];
  z[e] = diag ? 1.f : 0.f;
}

// One C x C product out = alpha * (a b) [/ sqrt(s)] + diag * I, row-major,
// stored transposed when `transpose_out`.
struct Product {
  const float* a;
  const float* b;
  float* out;
  float alpha;
  float diag;
};
struct Products {
  Product p[2];
};

// Launches 3 and 4: grid (tiles, tiles, products); blockIdx.z picks the
// product, so Y' = Y T and Z' = T Z share one launch. Thread (tx, ty) owns
// rows {ty, ty + 16} and columns {tx, tx + 16} of the block's tile.
__global__ void __launch_bounds__(kNsThreads)
square_products(Products jobs, int cols, const float* __restrict__ scal,
                int divide_by_sqrt_s, int transpose_out) {
  __shared__ float sa[kNsTile][kNsTile + 1];
  __shared__ float sb[kNsTile][kNsTile + 1];
  const Product job = jobs.p[blockIdx.z];
  const int r0 = blockIdx.y * kNsTile;
  const int c0 = blockIdx.x * kNsTile;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  float acc[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
  for (int k0 = 0; k0 < cols; k0 += kNsTile) {
#pragma unroll
    for (int q = 0; q < kNsTile * kNsTile / kNsThreads; ++q) {
      const int idx = q * kNsThreads + tid;
      const int rr = idx / kNsTile;
      const int kk = idx % kNsTile;
      sa[rr][kk] = (r0 + rr < cols && k0 + kk < cols)
                       ? job.a[static_cast<int64_t>(r0 + rr) * cols + k0 + kk]
                       : 0.f;
      sb[rr][kk] = (k0 + rr < cols && c0 + kk < cols)
                       ? job.b[static_cast<int64_t>(k0 + rr) * cols + c0 + kk]
                       : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kNsTile; ++k) {
      const float a0 = sa[ty][k];
      const float a1 = sa[ty + 16][k];
      const float b0 = sb[k][tx];
      const float b1 = sb[k][tx + 16];
      acc[0][0] = fmaf(a0, b0, acc[0][0]);
      acc[0][1] = fmaf(a0, b1, acc[0][1]);
      acc[1][0] = fmaf(a1, b0, acc[1][0]);
      acc[1][1] = fmaf(a1, b1, acc[1][1]);
    }
    __syncthreads();
  }
  const float root_s = divide_by_sqrt_s ? sqrtf(scal[1]) : 1.f;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int row = r0 + ty + 16 * i;
      const int col = c0 + tx + 16 * j;
      if (row >= cols || col >= cols) continue;
      float v = job.alpha * acc[i][j];
      if (divide_by_sqrt_s) v = v / root_s;
      if (row == col) v += job.diag;
      const int64_t at = transpose_out
                             ? static_cast<int64_t>(col) * cols + row
                             : static_cast<int64_t>(row) * cols + col;
      job.out[at] = v;
    }
  }
}

// Launch 5: bias[j] = beta[j] - sum_k mean[k] M^T[k, j].
__global__ void __launch_bounds__(kBiasThreads)
fold_bias(const float* __restrict__ mt, const float* __restrict__ mean,
          const float* __restrict__ beta, int cols,
          float* __restrict__ bias) {
  const int j = blockIdx.x * kBiasThreads + threadIdx.x;
  if (j >= cols) return;
  float acc = 0.f;
  for (int k = 0; k < cols; ++k)
    acc = fmaf(mean[k], mt[static_cast<int64_t>(k) * cols + j], acc);
  bias[j] = beta[j] - acc;
}

// Launch 6: out = x M^T + bias. grid = (row tiles, column tiles). Thread
// (tx, ty) owns rows {ty*4 .. +3} and {64 + ty*4 .. +3} of the tile and the
// same columns from tx: two runs of four keep its float4 shared loads free
// of bank conflicts. sa is padded so that the transposed stores of x spread
// over the banks.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
rows_apply(const T* __restrict__ x, int64_t rows, int cols,
           const float* __restrict__ mt, const float* __restrict__ bias,
           T* __restrict__ out) {
  __shared__ __align__(16) float sa[kStage][kTile + 4];
  __shared__ __align__(16) float sb[kStage][kTile];
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * kTile;
  const int c0 = blockIdx.y * kTile;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < cols; k0 += kStage) {
    // x: 128 rows x 16 columns; a warp reads 2 rows x 16 columns.
#pragma unroll
    for (int q = 0; q < kTile * kStage / kThreads; ++q) {
      const int kk = tid % kStage;
      const int rr = tid / kStage + q * (kThreads / kStage);
      const int64_t r = r0 + rr;
      const int k = k0 + kk;
      sa[kk][rr] = (r < rows && k < cols) ? to_f32(x[r * cols + k]) : 0.f;
    }
    // M^T: 16 rows (k) x 128 columns; a warp reads 32 consecutive columns.
#pragma unroll
    for (int q = 0; q < kTile * kStage / kThreads; ++q) {
      const int jj = tid % kTile;
      const int kk = tid / kTile + q * (kThreads / kTile);
      const int k = k0 + kk;
      const int j = c0 + jj;
      sb[kk][jj] = (k < cols && j < cols)
                       ? mt[static_cast<int64_t>(k) * cols + j]
                       : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kStage; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&sa[kk][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&sa[kk][kHalf + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&sb[kk][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&sb[kk][kHalf + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  float bias_v[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = c0 + (j < 4 ? 0 : kHalf) + tx * 4 + j % 4;
    bias_v[j] = col < cols ? bias[col] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int64_t row = r0 + (i < 4 ? 0 : kHalf) + ty * 4 + i % 4;
    if (row >= rows) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = c0 + (j < 4 ? 0 : kHalf) + tx * 4 + j % 4;
      if (col < cols) store(&out[row * cols + col], acc[i][j] + bias_v[j]);
    }
  }
}

int64_t setup_floats(int cols) {
  return kScalars + 5 * static_cast<int64_t>(cols) * cols;
}

// Launches 1-5: mt = (Gamma W)^T and bias from (mean, cov, gamma, beta).
// workspace holds setup_floats(cols) floats.
cudaError_t launch_setup(const float* mean, const float* cov,
                         const float* gamma, const float* beta, int cols,
                         int ns_iters, float eps, int scaling, float* mt,
                         float* bias, float* workspace, cudaStream_t stream) {
  const int64_t cc = static_cast<int64_t>(cols) * cols;
  float* scal = workspace;
  float* y[2] = {workspace + kScalars, workspace + kScalars + cc};
  float* z[2] = {workspace + kScalars + 2 * cc, workspace + kScalars + 3 * cc};
  float* t = workspace + kScalars + 4 * cc;

  jitter_and_scale<<<1, kReduceThreads, 0, stream>>>(cov, cols, eps, scaling,
                                                     scal);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ns_init<<<static_cast<unsigned>(ceil_div(cc, kInitThreads)), kInitThreads, 0,
            stream>>>(cov, scal, cols, y[0], z[0]);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const unsigned tiles = static_cast<unsigned>(ceil_div(cols, kNsTile));
  int cur = 0;
  for (int it = 0; it < ns_iters; ++it) {
    Products step_t = {};
    step_t.p[0] = {z[cur], y[cur], t, -0.5f, 1.5f};
    square_products<<<dim3(tiles, tiles, 1), kNsThreads, 0, stream>>>(
        step_t, cols, scal, 0, 0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    Products step_yz = {};
    step_yz.p[0] = {y[cur], t, y[1 - cur], 1.f, 0.f};
    step_yz.p[1] = {t, z[cur], z[1 - cur], 1.f, 0.f};
    square_products<<<dim3(tiles, tiles, 2), kNsThreads, 0, stream>>>(
        step_yz, cols, scal, 0, 0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    cur = 1 - cur;
  }

  Products fold = {};
  fold.p[0] = {gamma, z[cur], mt, 1.f, 0.f};
  square_products<<<dim3(tiles, tiles, 1), kNsThreads, 0, stream>>>(
      fold, cols, scal, 1, 1);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  fold_bias<<<static_cast<unsigned>(ceil_div(cols, kBiasThreads)),
              kBiasThreads, 0, stream>>>(mt, mean, beta, cols, bias);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_rows(const T* x, int64_t rows, int cols, const float* mt,
                        const float* bias, T* out, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(ceil_div(rows, kTile)),
                  static_cast<unsigned>(ceil_div(cols, kTile)));
  rows_apply<T><<<grid, kThreads, 0, stream>>>(x, rows, cols, mt, bias, out);
  return cudaGetLastError();
}

cudaError_t launch_rows_dtype(const void* x, int dtype, int64_t rows,
                              int cols, const float* mt, const float* bias,
                              void* out, cudaStream_t stream) {
  if (dtype == 0)
    return launch_rows(static_cast<const float*>(x), rows, cols, mt, bias,
                       static_cast<float*>(out), stream);
  return launch_rows(static_cast<const __nv_bfloat16*>(x), rows, cols, mt,
                     bias, static_cast<__nv_bfloat16*>(out), stream);
}

bool setup_args_ok(int cols, int ns_iters, int scaling) {
  return cols >= 1 && cols <= kMaxCols && ns_iters >= 0 &&
         (scaling == 0 || scaling == 1);
}

bool rows_args_ok(int dtype, int64_t rows, int cols) {
  return rows >= 1 && cols >= 1 && cols <= kMaxCols &&
         (dtype == 0 || dtype == 1) &&
         ceil_div(rows, kTile) <= 0x7fffffff;
}

}  // namespace

extern "C" {

int wcgan_wc_max_cols() { return kMaxCols; }

// Floats of scratch the caller allocates for one call at width `cols`.
int64_t wcgan_wc_apply_workspace_floats(int cols) {
  return setup_floats(cols) + static_cast<int64_t>(cols) * cols + cols;
}

// The setup alone (launches 1-5): mt = (Gamma W)^T (cols, cols) and bias
// (cols,), float32, from float32 mean (cols,), cov, gamma (cols, cols) and
// beta (cols,). scaling: 0 = trace, 1 = Frobenius. Enqueues on `stream`
// and does not synchronise; returns the cudaError_t of the first launch
// that failed, 0 when all were accepted.
int wcgan_wc_setup(const float* mean, const float* cov, const float* gamma,
                   const float* beta, int cols, int ns_iters, float eps,
                   int scaling, float* mt, float* bias, float* workspace,
                   void* stream) {
  if (!setup_args_ok(cols, ns_iters, scaling))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_setup(mean, cov, gamma, beta, cols, ns_iters,
                                       eps, scaling, mt, bias, workspace,
                                       static_cast<cudaStream_t>(stream)));
}

// The whole layer: out (rows, cols) = x M^T + bias with M and bias from the
// setup. dtype: 0 = float32, 1 = bfloat16, for x and out alike; x and out
// are row-major and contiguous. Same stream and error contract as above.
int wcgan_whiten_color_apply(const void* x, int dtype, int64_t rows,
                             int cols, const float* mean, const float* cov,
                             const float* gamma, const float* beta,
                             int ns_iters, float eps, int scaling, void* out,
                             float* workspace, void* stream) {
  if (!setup_args_ok(cols, ns_iters, scaling) ||
      !rows_args_ok(dtype, rows, cols))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* mt = workspace + setup_floats(cols);
  float* bias = mt + static_cast<int64_t>(cols) * cols;
  cudaError_t err = launch_setup(mean, cov, gamma, beta, cols, ns_iters, eps,
                                 scaling, mt, bias, workspace, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      launch_rows_dtype(x, dtype, rows, cols, mt, bias, out, s));
}

}  // extern "C"
