// K2: the whole stats-given WC layer, out = x (Gamma W)^T + beta - mu (Gamma W)^T
// with W = cov^{-1/2} by coupled Newton-Schulz, for Hopper (sm_90a).
//
// Replaces the TPU kernel wcgan_tpu/ops/pallas_wc.py:195 _wc_apply_kernel
// (launched by whiten_color_apply, pallas_call :306). It computes the same
// thing: the SPD jitter eps*mean_diag + 2*neg_diag + 1e-12
// (ops/whiten.py::_spd_jitter), the trace or Frobenius normalization,
// ns_iters coupled Newton-Schulz steps (T = 1.5 I - 0.5 Z Y; Y <- Y T;
// Z <- T Z), W = Z / sqrt(s), the fold M = Gamma W and bias = beta - mu M^T,
// then out = x M^T + bias on every row, in float32, rounded once to x's
// dtype.
//
// What bounds it on an H100 (SXM, 700 W). The 7 calls of one batch-256
// generate() forward of G 256x3 (C = 256, bf16 rows, sum of R = 692,224)
// read x and write out once: 709 MB, 0.213 ms at 3.35 TB/s. Their 1.01e11
// flop (2RC^2 rows, 45 x 2C^3 setup) take 0.102 ms at the bf16
// tensor-core rate, so the bound is bytes. Two things stand between K2 and
// it:
// - The setup is a chain of 32 dependent stages (Y0/T0, Y1, a T and a
//   Y/Z stage per further Newton-Schulz step, the fold, the bias; the
//   Frobenius scaling adds one) of only 1.5 GFLOP at C = 256. Each stage
//   waits for the one before, so its cost is the time one stage takes to
//   start, load its operands from L2 and finish, not the FFMA rate. The
//   products stay in true float32 FFMA: the Pallas kernel pins HIGHEST
//   (pallas_wc.py:232) whatever --whitening_precision says, since under
//   single-pass reduced precision Newton-Schulz plateaus near 2e-2
//   (pallas_wc.py:228-231). The port's 'high' runs the other whitening
//   products as bf16x3 (K3, mm_bf16x3.cu); none of them is here.
// - The row apply is 2RC^2 flop per call; in float32 on the FFMA pipes
//   (67 TFLOP/s) the 7 calls need at least 1.35 ms, six times the bound.
//
// What the design does about it: two launches per call.
// (1) ns_setup: one persistent cooperative launch (cudaLaunchCooperative-
//     Kernel; every block co-resident, or the launch fails and the wrapper
//     raises) whose blocks pass grid-wide barriers (cooperative_groups
//     grid.sync) between the dependent stages, in place of one launch per
//     stage. A C x C product is cut into 32 x 32 output tiles (128 blocks at
//     C = 256 for the paired Y/Z stage); a stage of one product (T, Y1, the
//     fold) has half the tiles and cuts them 16 x 32 instead, so that as
//     many blocks work. A block's four 64-thread groups each take a slice of
//     K (4 x 4 outputs a thread): a group's lane 0 copies its slice of the
//     A rows and B columns by TMA, 32 x 32 float32 boxes in the 128-byte
//     swizzle (so that the float4 reads of a warp hit distinct banks), onto
//     the group's mbarrier; TMA reads L2, never a stale L1 line of the Y, Z
//     and T buffers that other SMs rewrite between stages (256 KB each at
//     C = 256). The groups' partial tiles are added in a fixed order. The
//     first step needs no product for T0 = 1.5 I - 0.5 Y0 and Z1 = T0, and
//     the last skips the Y it would not use. The fold writes M^T in float32
//     (the float32 row apply and whiten_color_fold_cuda read it) and M as
//     three bf16 pieces, M = hi + mid + lo (each the rounded remainder of
//     the one before: exact to float32), straight into the swizzled layout
//     the row apply copies into shared memory. A stage costs about 4 us
//     (chip_smoke.py prints it). Measured and not kept: cp.async copies
//     (4,096 of 16 bytes a block), more or fewer threads, finer copy parts,
//     a barrier on per-block flags, one on a counter with release/acquire
//     atomics (no faster than grid.sync).
// (2) rows_apply_bf16: out = x M^T + bias on the tensor cores. A bf16 x is
//     exact in bf16, so x is never converted: the TMA unit copies 128-row x
//     32-column boxes in the 64-byte swizzle through a 4-stage mbarrier
//     ring, and wgmma (m64nNk16 bf16, float32 accumulators) reads them as
//     they land. Each block keeps one N-column slice of all three pieces
//     resident in shared memory (192 KB at C = 256, N = 128: too little room
//     is left for 64-column x stages in a deep ring), copied once per block
//     by the TMA unit from L2, and walks row tiles; the blocks of the C / N
//     slices of a row tile run side by side, so x comes from HBM about once
//     and from L2 C / N times. Per 16-wide k step the pieces go in smallest
//     first (lo, mid, hi) into one accumulator; the bias is added in float32
//     and the sum rounded once to bf16. The whole K (256) runs in one
//     accumulator chain of 48 wgmma steps. Two consumer warpgroups (64 rows
//     each) and one producer warp; the four lanes of a quad trade their
//     results so that each stores 16 bytes. Measured and not kept: the two
//     warpgroups taking turns at the tensor cores on 64-row tiles of their
//     own (slower at large R), 64-column x stages in a 2-stage ring, 4-byte
//     stores, a barrier per K chunk of the pieces' copy (slower).
// Float32 rows are off the sampling path and keep the FFMA row apply
// (rows_apply_f32, 128 x 128 tiles, 8 x 8 outputs a thread) on M^T: true
// float32, as the plain version.
//
// Shapes taken: 8 <= C <= 512 with C % 8 == 0 (the TMA row stride of bf16
// rows is a multiple of 16 bytes), 1 <= R < 2^31. Rows past R and columns
// past C load 0 and are not stored. At C <= 64 the slice is 64 columns, at
// C <= 256 128 and above that 64 (the resident pieces stay within 192 KB).

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kMinCols = 8;
constexpr int kMaxCols = 512;        // the widest WC layer of the G presets
constexpr int kMaxSmem = 232448;     // dynamic shared memory a block may use
// The setup.
constexpr int kSetupThreads = 256;   // 4 groups of 64, a slice of K each
constexpr int kNsTile = 32;          // 32 x 32 output tiles
constexpr int kMaxSetupGrid = 1024;  // bound on its blocks (and partials)
// The bf16 row apply.
constexpr int kRowTile = 128;        // rows per tile: 2 warpgroups x 64
constexpr int kKChunk = 64;          // K per piece chunk: a 128-byte row
constexpr int kXChunk = 32;          // K per x stage: a 64-byte row
constexpr int kStageBytes = kRowTile * kXChunk * 2;
constexpr int kPieces = 3;
constexpr int kMaxStages = 4;
constexpr int kConsumers = 256;
constexpr int kApplyThreads = kConsumers + 32;  // + the producer warp
// The float32 row apply.
constexpr int kTile = 128;           // 128 x 128 output tiles
constexpr int kHalf = kTile / 2;     // a thread's 8 rows/cols: 2 runs of 4
constexpr int kThreads = 256;        // 16 x 16 threads, 8 x 8 outputs each
constexpr int kStage = 16;           // columns of x staged at a time

__host__ __device__ __forceinline__ int64_t ceil_div(int64_t a, int64_t b) {
  return (a + b - 1) / b;
}
__host__ __device__ __forceinline__ int64_t round_up(int64_t a, int64_t b) {
  return ceil_div(a, b) * b;
}

// Where everything lives in the caller's float32 workspace, and the cuts.
struct Layout {
  int tiles;    // 32-wide tiles of the setup's products
  int kchunks;  // 64-wide K chunks of the row apply
  int slice_n;  // N: output columns a row-apply block keeps resident
  int slices;
  // float offsets, each 1 KB aligned
  int64_t partials, y0, y1, z0, z1, t, mt, bias, pieces, total;
};

__host__ __device__ Layout layout_for(int cols) {
  Layout l;
  l.tiles = static_cast<int>(ceil_div(cols, kNsTile));
  l.kchunks = static_cast<int>(ceil_div(cols, kKChunk));
  l.slice_n = cols <= 64 ? 64 : (cols <= 256 ? 128 : 64);
  l.slices = static_cast<int>(ceil_div(cols, l.slice_n));
  const int64_t cc = static_cast<int64_t>(cols) * cols;
  int64_t at = 0;
  auto take = [&at](int64_t floats) {
    const int64_t here = at;
    at += round_up(floats, 256);
    return here;
  };
  l.partials = take(kMaxSetupGrid);
  l.y0 = take(cc);
  l.y1 = take(cc);
  l.z0 = take(cc);
  l.z1 = take(cc);
  l.t = take(cc);
  l.mt = take(cc);
  l.bias = take(cols);
  // kPieces bf16 pieces of slices * slice_n rows (output columns) by
  // kchunks * 64 K, zero-padded: [slice][piece][kchunk][row][64], each
  // 128-byte row in the 128-byte swizzle (16-byte chunk j of row r at
  // position j ^ (r % 8)), as wgmma reads a K-major operand.
  l.pieces = take(static_cast<int64_t>(kPieces) * l.slices * l.slice_n *
                  l.kchunks * kKChunk / 2);
  l.total = at;
  return l;
}

__device__ __forceinline__ int64_t piece_index(const Layout& l, int p, int n,
                                               int k) {
  const int s = n / l.slice_n;
  const int r = n % l.slice_n;
  const int kk = k % kKChunk;
  const int64_t chunk =
      (static_cast<int64_t>(s) * kPieces + p) * l.kchunks + k / kKChunk;
  return chunk * l.slice_n * kKChunk + r * kKChunk +
         (((kk / 8) ^ (r % 8)) * 8) + kk % 8;
}

// --- the setup --------------------------------------------------------------

// Sum and min over a block; every thread gets the results.
__device__ void block_sum_min(float* sum, float* mn) {
  __shared__ float part_sum[kSetupThreads / 32];
  __shared__ float part_min[kSetupThreads / 32];
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
    for (int w = 1; w < kSetupThreads / 32; ++w) {
      part_sum[0] += part_sum[w];
      part_min[0] = fminf(part_min[0], part_min[w]);
    }
  }
  __syncthreads();
  *sum = part_sum[0];
  *mn = part_min[0];
  __syncthreads();  // the buffers are reused by the next call
}

// The C x C matrices of the setup, by index: TMA reads them through one
// tensor map each.
enum Matrix { kY0, kY1, kZ0, kZ1, kT, kGamma, kMatrices };

struct Maps {
  CUtensorMap m[kMatrices];
};

// One C x C product of a stage: out = alpha (a b) + diag I, row-major.
struct Job {
  int a;
  int b;
  float* out;
  float alpha;
  float diag;
};

constexpr int kPart = 32;                    // K per TMA box: 128 bytes
constexpr int kPartFloats = kNsTile * kPart;  // a 32 x 32 box
// A group of 64 threads (8 x 8, 4 x 4 outputs each) per slice of K, of a
// whole number of parts; at small C the last groups have none.
constexpr int kGroups = kSetupThreads / 64;

__host__ __device__ __forceinline__ int setup_slice(int cols) {
  return static_cast<int>(
      round_up(ceil_div(round_up(cols, kPart), kGroups), kPart));
}

// The parts (A box, then B box, each in the 128-byte swizzle), the groups'
// partial tiles, one mbarrier per group.
__host__ __device__ __forceinline__ int setup_smem_bytes(int cols) {
  const int parts = static_cast<int>(ceil_div(cols, kPart));
  return parts * 2 * kPartFloats * 4 + kGroups * kNsTile * kNsTile * 4 +
         kGroups * 8;
}

// acc[i][j] += sum over k of A[ty + 8i][k] B[k][4tx + j] over one part,
// k in order, for the kRows / 8 rows ty + 8i of a kRows-row tile. Both
// boxes are in the 128-byte swizzle (16-byte chunk c of row r at
// c ^ (r % 8)): the rows of a warp's A loads and the eight column groups of
// its B loads fall on distinct banks.
template <int kRows>
__device__ __forceinline__ void mac_part(float (&acc)[kRows / 8][4],
                                         const float* __restrict__ sa,
                                         const float* __restrict__ sb, int tx,
                                         int ty) {
#pragma unroll
  for (int k = 0; k < kPart; k += 4) {
    float4 a[kRows / 8], b[4];
#pragma unroll
    for (int i = 0; i < kRows / 8; ++i)
      a[i] = *reinterpret_cast<const float4*>(
          &sa[(ty + 8 * i) * kPart + (((k >> 2) ^ ty) << 2)]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      b[kk] = *reinterpret_cast<const float4*>(
          &sb[(k + kk) * kNsTile + ((tx ^ ((k + kk) & 7)) << 2)]);
#pragma unroll
    for (int i = 0; i < kRows / 8; ++i) {
      const float av[4] = {a[i].x, a[i].y, a[i].z, a[i].w};
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float bv[4] = {b[kk].x, b[kk].y, b[kk].z, b[kk].w};
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[kk], bv[j], acc[i][j]);
      }
    }
  }
}

// The kRows x 32 tiles of `njobs` (1 or 2) products, spread over the grid.
// Each group copies its slice of the tile's A rows and B columns by TMA (one
// box per part and operand: A through `amaps`, whose boxes are kRows high,
// B through `bmaps`,
// completing on the group's mbarrier; `phase` counts the tiles this block
// has run) and multiplies it; the slices' sums are added in order. With
// `fold`, the result M = (a b) / root_s goes to M^T (float32) and to the
// bf16 pieces instead of job.out.
template <int kRows>
__device__ void products(const Maps& amaps, const Maps& bmaps, Job j0,
                         Job j1, int njobs,
                         int cols, const Layout& l, uint8_t* __restrict__ smem,
                         uint32_t& phase, bool fold, float root_s,
                         float* __restrict__ mt,
                         __nv_bfloat16* __restrict__ pieces) {
  const int tid = threadIdx.x;
  const int q = tid / 64;  // this thread's group: a slice of K
  const int lt = tid % 64;
  const int tx = lt % 8;
  const int ty = lt / 8;
  const int parts = static_cast<int>(ceil_div(cols, kPart));
  const int p0 = q * (setup_slice(cols) / kPart);
  const int p1 = min(p0 + setup_slice(cols) / kPart, parts);
  float* boxes = reinterpret_cast<float*>(smem);
  float* red = boxes + parts * 2 * kPartFloats;  // [kGroups][32][32]
  uint64_t* bar = reinterpret_cast<uint64_t*>(red + kGroups * kNsTile *
                                              kNsTile);
  const int per_job = l.tiles * (kNsTile / kRows) * l.tiles;
  for (int t = blockIdx.x; t < njobs * per_job; t += gridDim.x, ++phase) {
    const Job job = t < per_job ? j0 : j1;
    const int tile = t % per_job;
    const int r0 = tile / l.tiles * kRows;
    const int c0 = tile % l.tiles * kNsTile;
    if (lt == 0 && p0 < p1) {
      // The matrices were written through the generic proxy before the
      // grid barrier; TMA reads through the async proxy.
      fence_proxy_async_global();
      mbar_arrive_expect_tx(&bar[q],
                            (p1 - p0) * (kRows + kNsTile) * kPart * 4);
      for (int p = p0; p < p1; ++p) {
        float* box = boxes + p * 2 * kPartFloats;
        tma_load_2d(box, &amaps.m[job.a], p * kPart, r0, &bar[q]);
        tma_load_2d(box + kPartFloats, &bmaps.m[job.b], c0, p * kPart,
                    &bar[q]);
      }
    }
    float acc[kRows / 8][4];
#pragma unroll
    for (int i = 0; i < kRows / 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    if (p0 < p1) {
      mbar_wait(&bar[q], phase & 1);
      for (int p = p0; p < p1; ++p) {
        const float* box = boxes + p * 2 * kPartFloats;
        mac_part<kRows>(acc, box, box + kPartFloats, tx, ty);
      }
    }
#pragma unroll
    for (int i = 0; i < kRows / 8; ++i)
      *reinterpret_cast<float4*>(
          &red[(q * kRows + ty + 8 * i) * kNsTile + tx * 4]) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    __syncthreads();
    const int row = tid / 8;
    const int col = tid % 8 * 4;
    const int r = r0 + row;
    const int c = c0 + col;
    // 8 threads a row, 4 outputs each; cols % 8 == 0: all four or none.
    if (tid < kRows * kNsTile / 4 && r < cols && c < cols) {
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[j] = red[row * kNsTile + col + j];
#pragma unroll
        for (int g = 1; g < kGroups; ++g)
          v[j] += red[(g * kRows + row) * kNsTile + col + j];
      }
      if (!fold) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          v[j] = fmaf(job.alpha, v[j], r == c + j ? job.diag : 0.f);
        *reinterpret_cast<float4*>(&job.out[static_cast<int64_t>(r) * cols +
                                            c]) =
            make_float4(v[0], v[1], v[2], v[3]);
        fence_proxy_async_global();  // the next stage reads it by TMA
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float m = v[j] / root_s;  // M[r][c + j]
          mt[static_cast<int64_t>(c + j) * cols + r] = m;
          const __nv_bfloat16 hi = __float2bfloat16_rn(m);
          const float rest = m - __bfloat162float(hi);  // exact
          const __nv_bfloat16 mid = __float2bfloat16_rn(rest);
          const __nv_bfloat16 lo =
              __float2bfloat16_rn(rest - __bfloat162float(mid));
          pieces[piece_index(l, 0, r, c + j)] = hi;
          pieces[piece_index(l, 1, r, c + j)] = mid;
          pieces[piece_index(l, 2, r, c + j)] = lo;
        }
      }
    }
    __syncthreads();  // `red` is rewritten by the next tile
  }
}

struct SetupArgs {
  const float* mean;
  const float* cov;
  const float* gamma;
  const float* beta;
  float* ws;
  int cols;
  int ns_iters;
  float eps;
  int scaling;  // 0 trace, 1 Frobenius
};

// Launch 1, cooperative: the workspace's M^T, bias and pieces from
// (mean, cov, gamma, beta). Every grid.sync() separates two dependent
// stages; data written by another block is read by TMA or through L2 only
// (__ldcg), never from a stale L1 line.
__global__ void __launch_bounds__(kSetupThreads)
ns_setup(const SetupArgs g, const __grid_constant__ Maps maps,
         const __grid_constant__ Maps maps16) {
  // 1,024-byte aligned for the 128-byte swizzle.
  extern __shared__ __align__(1024) uint8_t smem[];
  __shared__ float s_shared;
  cg::grid_group grid = cg::this_grid();
  const int cols = g.cols;
  const Layout l = layout_for(cols);
  const int64_t cc = static_cast<int64_t>(cols) * cols;
  const int tid = threadIdx.x;
  const int64_t gtid = static_cast<int64_t>(blockIdx.x) * kSetupThreads + tid;
  const int64_t gstride = static_cast<int64_t>(gridDim.x) * kSetupThreads;
  // Y and Z ping-pong between two buffers each: (y, z) hold the current
  // iterate, (y_next, z_next) take the next.
  int y = kY0;
  int y_next = kY1;
  int z = kZ1;
  int z_next = kZ0;
  float* const mat[kT + 1] = {g.ws + l.y0, g.ws + l.y1, g.ws + l.z0,
                              g.ws + l.z1, g.ws + l.t};
  float* mt = g.ws + l.mt;
  if (tid == 0) {
    for (int q = 0; q < kGroups; ++q)
      mbar_init(reinterpret_cast<uint64_t*>(
                    smem + setup_smem_bytes(cols) - kGroups * 8) + q, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  __nv_bfloat16* pieces = reinterpret_cast<__nv_bfloat16*>(g.ws + l.pieces);
  uint32_t phase = 0;
  // A stage of one product has half the tiles of a paired one: there
  // 16-row tiles (A boxes from maps16) keep twice the blocks busy, when the
  // grid has them.
  auto run = [&](Job j0, Job j1, int njobs, bool fold, float root_s) {
    if (2 * njobs * l.tiles * l.tiles <= static_cast<int>(gridDim.x))
      products<16>(maps16, maps, j0, j1, njobs, cols, l, smem, phase, fold,
                   root_s, mt, pieces);
    else
      products<32>(maps, maps, j0, j1, njobs, cols, l, smem, phase, fold,
                   root_s, mt, pieces);
  };

  // The jitter and the trace, in every block alike (C values).
  float trace = 0.f;
  float min_diag = INFINITY;
  for (int i = tid; i < cols; i += kSetupThreads) {
    const float d = g.cov[static_cast<int64_t>(i) * cols + i];
    trace += d;
    min_diag = fminf(min_diag, d);
  }
  block_sum_min(&trace, &min_diag);
  const float mean_diag = fmaxf(trace / static_cast<float>(cols), 0.f);
  const float jitter = g.eps * mean_diag + 2.f * fmaxf(-min_diag, 0.f) +
                       1e-12f;
  float acc = 0.f;
  float unused = 0.f;
  float s;
  if (g.scaling == 0) {
    for (int i = tid; i < cols; i += kSetupThreads)
      acc += g.cov[static_cast<int64_t>(i) * cols + i] + jitter;
    block_sum_min(&acc, &unused);
    s = acc;
  } else {  // stage: per-block partial sums of squares, added in order
    for (int64_t e = gtid; e < cc; e += gstride) {
      const float a = g.cov[e] + (e / cols == e % cols ? jitter : 0.f);
      acc = fmaf(a, a, acc);
    }
    block_sum_min(&acc, &unused);
    if (tid == 0) g.ws[l.partials + blockIdx.x] = acc;
    grid.sync();
    if (tid == 0) {
      float total = 0.f;
      for (unsigned b = 0; b < gridDim.x; ++b)
        total += __ldcg(&g.ws[l.partials + b]);
      s_shared = sqrtf(total);
    }
    __syncthreads();
    s = s_shared;
  }

  // Stage: Y0 = (cov + jitter I) / s and Z1 = T0 = 1.5 I - 0.5 Y0 (Z0 = I,
  // so Z0 Y0 = Y0 and T0 Z0 = T0 exactly), or Z = I without steps; zero
  // the pieces (the fold writes the live ones).
  for (int64_t e = gtid; e < cc; e += gstride) {
    const bool diag = e / cols == e % cols;
    const float y0 = (g.cov[e] + (diag ? jitter : 0.f)) / s;
    mat[kY0][e] = y0;
    mat[kZ1][e] = g.ns_iters > 0 ? fmaf(-0.5f, y0, diag ? 1.5f : 0.f)
                                 : (diag ? 1.f : 0.f);
  }
  fence_proxy_async_global();
  const int64_t piece_vecs = (l.total - l.pieces) / 4;
  for (int64_t i = gtid; i < piece_vecs; i += gstride)
    reinterpret_cast<uint4*>(pieces)[i] = make_uint4(0u, 0u, 0u, 0u);
  grid.sync();

  if (g.ns_iters >= 2) {  // Y1 = Y0 T0 (step 1 alone needs no Y1)
    run({y, z, mat[y_next], 1.f, 0.f}, {}, 1, false, 1.f);
    grid.sync();
    const int swap = y;
    y = y_next;
    y_next = swap;
  }
  for (int it = 1; it < g.ns_iters; ++it) {
    run({z, y, mat[kT], -0.5f, 1.5f}, {}, 1, false, 1.f);
    grid.sync();
    // Z' = T Z, and Y' = Y T unless this is the last step.
    run({kT, z, mat[z_next], 1.f, 0.f}, {y, kT, mat[y_next], 1.f, 0.f},
        it + 1 < g.ns_iters ? 2 : 1, false, 1.f);
    grid.sync();
    int swap = y;
    y = y_next;
    y_next = swap;
    swap = z;
    z = z_next;
    z_next = swap;
  }

  // Stage: M = Gamma Z / sqrt(s) -> M^T and the pieces.
  run({kGamma, z, nullptr, 1.f, 0.f}, {}, 1, true, sqrtf(s));
  grid.sync();

  // Stage: bias = beta - mu M^T.
  for (int64_t j = gtid; j < cols; j += gstride) {
    float dot = 0.f;
    for (int k = 0; k < cols; ++k)
      dot = fmaf(g.mean[k], __ldcg(&mt[static_cast<int64_t>(k) * cols + j]),
                 dot);
    g.ws[l.bias + j] = g.beta[j] - dot;
  }
}

// --- the bf16 row apply -----------------------------------------------------

// d (64 x 128, this warpgroup's fragment) += A (64 x 16) B (16 x 128),
// bf16 operands K-major in shared memory, float32 accumulators; d is
// replaced instead when `accumulate` is 0.
__device__ __forceinline__ void wgmma_bf16(float (&d)[64], uint64_t da,
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, "
      "0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64, this warpgroup's fragment) += A (64 x 16) B (16 x 64),
// bf16 operands K-major in shared memory, float32 accumulators; d is
// replaced instead when `accumulate` is 0.
__device__ __forceinline__ void wgmma_bf16(float (&d)[32], uint64_t da,
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// A 4 x 4 transpose of 32-bit values across each quad of lanes: afterwards
// lane q holds in v[k] what lane k held in v[q]. Two butterfly rounds of
// two shuffles.
__device__ __forceinline__ void quad_transpose(uint32_t (&v)[4], int quad) {
  const bool hi2 = quad & 2;
  uint32_t t0 = __shfl_xor_sync(0xffffffffu, hi2 ? v[0] : v[2], 2);
  uint32_t t1 = __shfl_xor_sync(0xffffffffu, hi2 ? v[1] : v[3], 2);
  if (hi2) {
    v[0] = t0;
    v[1] = t1;
  } else {
    v[2] = t0;
    v[3] = t1;
  }
  const bool hi1 = quad & 1;
  t0 = __shfl_xor_sync(0xffffffffu, hi1 ? v[0] : v[1], 1);
  t1 = __shfl_xor_sync(0xffffffffu, hi1 ? v[2] : v[3], 1);
  if (hi1) {
    v[0] = t0;
    v[2] = t1;
  } else {
    v[1] = t0;
    v[3] = t1;
  }
}

// Launch 2 for bf16 rows: out = x M^T + bias. Block b keeps slice
// b % slices (N output columns) of the pieces in shared memory and walks
// row tiles b / slices, + groups, ... Warp 8 is the producer: lane 0 copies
// the pieces once, then keeps TMA loads of x (128 rows x 32 columns a
// stage) in flight through the ring. Warpgroup w (threads 128w ..) owns
// rows 64w .. 64w + 63 of each tile.
template <int N>
__global__ void __launch_bounds__(kApplyThreads, 1)
rows_apply_bf16(const __grid_constant__ CUtensorMap xmap,
                const __nv_bfloat16* __restrict__ pieces,
                const float* __restrict__ bias, int64_t rows, int cols,
                int kchunks, int slices, int stages,
                __nv_bfloat16* __restrict__ out) {
  // 1,024-byte aligned for the 128-byte swizzle, and taken as it is (an
  // integer align-up would turn every shared access generic).
  extern __shared__ __align__(1024) uint8_t base[];
  const int piece_bytes = kchunks * N * 128;
  uint8_t* resident = base;  // [piece][kchunk][N rows of 128 bytes]
  uint8_t* ring = base + kPieces * piece_bytes;
  float* bias_s = reinterpret_cast<float*>(ring + stages * kStageBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(bias_s + N);
  uint64_t* empty = full + stages;
  uint64_t* resident_full = empty + stages;

  const int slice = blockIdx.x % slices;
  const int64_t group = blockIdx.x / slices;
  const int64_t groups = gridDim.x / slices;
  const int64_t row_tiles = ceil_div(rows, kRowTile);
  const int xchunks = kchunks * (kKChunk / kXChunk);
  const int tid = threadIdx.x;
  for (int j = tid; j < N; j += kApplyThreads) {
    const int c = slice * N + j;
    bias_s[j] = c < cols ? bias[c] : 0.f;
  }
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);  // one arrival per consumer warpgroup
    }
    mbar_init(resident_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {  // the producer warp
    if (tid == kConsumers) {
      mbar_arrive_expect_tx(resident_full, kPieces * piece_bytes);
      for (int p = 0; p < kPieces; ++p)
        bulk_load(resident + p * piece_bytes,
                  pieces + (static_cast<int64_t>(slice) * kPieces + p) *
                               kchunks * N * kKChunk,
                  piece_bytes, resident_full);
      int64_t it = 0;
      for (int64_t tile = group; tile < row_tiles; tile += groups) {
        for (int kx = 0; kx < xchunks; ++kx, ++it) {
          const int slot = static_cast<int>(it % stages);
          if (it >= stages)
            mbar_wait(&empty[slot], ((it / stages) & 1) ^ 1);
          mbar_arrive_expect_tx(&full[slot], kStageBytes);
          tma_load_2d(ring + slot * kStageBytes, &xmap, kx * kXChunk,
                      static_cast<int>(tile * kRowTile), &full[slot]);
        }
      }
    }
    return;
  }

  const int wg = tid / 128;
  const int lane = tid % 32;
  float acc[N / 2];
  mbar_wait(resident_full, 0);
  int64_t it = 0;
  for (int64_t tile = group; tile < row_tiles; tile += groups) {
    int prev_slot = -1;
    for (int kx = 0; kx < xchunks; ++kx, ++it) {
      const int slot = static_cast<int>(it % stages);
      mbar_wait(&full[slot], (it / stages) & 1);
      const uint64_t da =
          operand_desc_sw64(ring + slot * kStageBytes + wg * 64 * 64);
      // This stage's K within the piece chunk kx / 2, in 32-byte steps.
      const int kstep = kx % (kKChunk / kXChunk) * (kXChunk / 16);
      wgmma_fence();
#pragma unroll
      for (int k16 = 0; k16 < kXChunk / 16; ++k16) {
#pragma unroll
        for (int p = kPieces - 1; p >= 0; --p) {  // lo, mid, hi
          const uint64_t db = operand_desc(
              resident + p * piece_bytes + kx / (kKChunk / kXChunk) * N * 128);
          wgmma_bf16(acc, da + 2 * k16, db + 2 * (kstep + k16),
                     (kx | k16 | (kPieces - 1 - p)) != 0);
        }
      }
      wgmma_commit();
      // The stage before this one is done: its slot goes back.
      wgmma_wait<1>();
      if (prev_slot >= 0 && tid % 128 == 0) mbar_arrive(&empty[prev_slot]);
      prev_slot = slot;
    }
    wgmma_wait<0>();
    if (tid % 128 == 0) mbar_arrive(&empty[prev_slot]);

    // Fragment of m64nN: warp w4 of the warpgroup holds rows 16*w4 + lane/4
    // (+8); acc[4i .. 4i+3] are columns 8i + 2*(lane%4) (+1) of those rows.
    // The four lanes of a quad trade values so that each holds 8 whole
    // columns: one 16-byte store, 64 contiguous bytes a row per quad.
    const int quad = lane % 4;
    const int64_t row0 =
        tile * kRowTile + wg * 64 + (tid % 128) / 32 * 16 + lane / 4;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t row = row0 + 8 * h;
#pragma unroll
      for (int j = 0; j < N / 32; ++j) {
        uint32_t v[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int i = 4 * j + k;
          const int cl = 8 * i + 2 * quad;
          const __nv_bfloat162 pair = __floats2bfloat162_rn(
              acc[4 * i + 2 * h] + bias_s[cl],
              acc[4 * i + 2 * h + 1] + bias_s[cl + 1]);
          v[k] = *reinterpret_cast<const uint32_t*>(&pair);
        }
        quad_transpose(v, quad);  // now columns 8 (4j + quad) .. + 7
        const int c = slice * N + 8 * (4 * j + quad);
        if (row < rows && c < cols)  // cols % 8 == 0: all 8 or none
          *reinterpret_cast<uint4*>(&out[row * cols + c]) =
              make_uint4(v[0], v[1], v[2], v[3]);
      }
    }
  }
}

// --- the float32 row apply --------------------------------------------------

// Launch 2 for float32 rows: out = x M^T + bias with M^T (mt) from the
// setup, FFMA. grid = (row tiles, column tiles). Thread (tx, ty) owns rows
// {ty*4 .. +3} and {64 + ty*4 .. +3} of the tile and the same columns from
// tx: two runs of four keep its float4 shared loads free of bank
// conflicts. sa is padded so that the transposed stores of x spread over
// the banks.
__global__ void __launch_bounds__(kThreads, 2)
rows_apply_f32(const float* __restrict__ x, int64_t rows, int cols,
               const float* __restrict__ mt, const float* __restrict__ bias,
               float* __restrict__ out) {
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
      sa[kk][rr] = (r < rows && k < cols) ? x[r * cols + k] : 0.f;
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
      if (col < cols) out[row * cols + col] = acc[i][j] + bias_v[j];
    }
  }
}

// --- host side --------------------------------------------------------------

cudaError_t sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

// Launch 1. The grid is as many blocks as fit on the card at once (at most
// the largest stage's tile count), launched cooperatively: if they cannot
// all be resident the launch fails, and nothing else runs.
cudaError_t launch_setup(const float* mean, const float* cov,
                         const float* gamma, const float* beta, int cols,
                         int ns_iters, float eps, int scaling, float* ws,
                         cudaStream_t stream) {
  const Layout l = layout_for(cols);
  const int smem = setup_smem_bytes(cols);
  // The opt-in above 48 KB belongs to the current device: set every call.
  cudaError_t err = cudaFuncSetAttribute(
      ns_setup, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ns_setup,
                                                      kSetupThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  int grid = per_sm * sms;
  if (grid > 2 * l.tiles * l.tiles) grid = 2 * l.tiles * l.tiles;
  if (grid > kMaxSetupGrid) grid = kMaxSetupGrid;
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const float* matrices[kMatrices] = {ws + l.y0, ws + l.y1, ws + l.z0,
                                      ws + l.z1, ws + l.t, gamma};
  // Each matrix twice: boxes of 32 x 32 and of 32 columns x 16 rows.
  Maps maps, maps16;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(cols)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 4};
  const cuuint32_t elem_strides[2] = {1, 1};
  for (int i = 0; i < 2 * kMatrices; ++i) {
    const cuuint32_t box[2] = {kPart,
                               static_cast<cuuint32_t>(i < kMatrices ? kNsTile
                                                                     : 16)};
    CUtensorMap* map = i < kMatrices ? &maps.m[i] : &maps16.m[i - kMatrices];
    if (encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
               const_cast<float*>(matrices[i % kMatrices]), dims, strides,
               box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
               CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return cudaErrorInvalidValue;
  }
  SetupArgs args = {mean, cov, gamma, beta, ws, cols, ns_iters, eps, scaling};
  void* params[] = {&args, &maps, &maps16};
  return cudaLaunchCooperativeKernel(reinterpret_cast<void*>(ns_setup),
                                     dim3(grid), dim3(kSetupThreads), params,
                                     static_cast<size_t>(smem), stream);
}

template <int N>
cudaError_t launch_rows_bf16(const __nv_bfloat16* x, int64_t rows, int cols,
                             const float* ws, __nv_bfloat16* out,
                             cudaStream_t stream) {
  const Layout l = layout_for(cols);
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap xmap;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {kXChunk, kRowTile};
  const cuuint32_t elem_strides[2] = {1, 1};
  if (encode(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
             const_cast<__nv_bfloat16*>(x), dims, strides, box, elem_strides,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  const int resident = kPieces * l.kchunks * N * 128;
  int stages = (kMaxSmem - resident - N * 4 - 8 * (2 * kMaxStages + 1)) /
               kStageBytes;
  if (stages > kMaxStages) stages = kMaxStages;
  if (stages < 2) return cudaErrorInvalidConfiguration;
  const int smem = resident + stages * kStageBytes + N * 4 +
                   8 * (2 * stages + 1);
  cudaError_t err = cudaFuncSetAttribute(
      rows_apply_bf16<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  int64_t groups = sms / l.slices;
  if (groups < 1) groups = 1;
  const int64_t row_tiles = ceil_div(rows, kRowTile);
  if (groups > row_tiles) groups = row_tiles;
  rows_apply_bf16<N>
      <<<static_cast<unsigned>(groups * l.slices), kApplyThreads, smem,
         stream>>>(xmap,
                   reinterpret_cast<const __nv_bfloat16*>(ws + l.pieces),
                   ws + l.bias, rows, cols, l.kchunks, l.slices, stages, out);
  return cudaGetLastError();
}

// Launch 2, from a workspace the setup has filled.
cudaError_t launch_rows(const void* x, int dtype, int64_t rows, int cols,
                        const float* ws, void* out, cudaStream_t stream) {
  const Layout l = layout_for(cols);
  if (dtype == 0) {
    const dim3 grid(static_cast<unsigned>(ceil_div(rows, kTile)),
                    static_cast<unsigned>(ceil_div(cols, kTile)));
    rows_apply_f32<<<grid, kThreads, 0, stream>>>(
        static_cast<const float*>(x), rows, cols, ws + l.mt, ws + l.bias,
        static_cast<float*>(out));
    return cudaGetLastError();
  }
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  if (l.slice_n == 128)
    return launch_rows_bf16<128>(xb, rows, cols, ws, ob, stream);
  return launch_rows_bf16<64>(xb, rows, cols, ws, ob, stream);
}

bool cols_ok(int cols) {
  return cols >= kMinCols && cols <= kMaxCols && cols % 8 == 0;
}

bool setup_args_ok(int cols, int ns_iters, int scaling) {
  return cols_ok(cols) && ns_iters >= 0 && (scaling == 0 || scaling == 1);
}

bool rows_args_ok(const void* x, int dtype, int64_t rows, int cols) {
  return rows >= 1 && rows <= INT32_MAX && cols_ok(cols) &&
         (dtype == 0 || dtype == 1) &&
         reinterpret_cast<uintptr_t>(x) % 16 == 0;
}

}  // namespace

extern "C" {

// Floats of scratch the caller allocates for one call at width `cols`
// (16-byte aligned), and where the setup leaves M^T (cols, cols) and the
// bias (cols,) in it.
int64_t wcgan_wc_apply_workspace_floats(int cols) {
  return layout_for(cols).total;
}
int64_t wcgan_wc_mt_offset(int cols) { return layout_for(cols).mt; }
int64_t wcgan_wc_bias_offset(int cols) { return layout_for(cols).bias; }

// Launch 1 alone: M^T, bias and the bf16 pieces of M into `workspace` from
// float32 mean (cols,), cov, gamma (cols, cols) and beta (cols,). scaling:
// 0 = trace, 1 = Frobenius. Enqueues on `stream` and does not synchronise;
// returns the cudaError_t of the launch (cudaErrorCooperativeLaunchTooLarge
// when the grid cannot be co-resident), 0 when it was accepted.
int wcgan_wc_setup(const float* mean, const float* cov, const float* gamma,
                   const float* beta, int cols, int ns_iters, float eps,
                   int scaling, float* workspace, void* stream) {
  if (!setup_args_ok(cols, ns_iters, scaling))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_setup(mean, cov, gamma, beta, cols, ns_iters,
                                       eps, scaling, workspace,
                                       static_cast<cudaStream_t>(stream)));
}

// Launch 2 alone: out = x M^T + bias from a workspace launch 1 filled.
// dtype: 0 = float32, 1 = bfloat16, for x and out alike; x and out are
// row-major, contiguous and 16-byte aligned. Same stream and error
// contract as above.
int wcgan_wc_rows(const void* x, int dtype, int64_t rows, int cols,
                  const float* workspace, void* out, void* stream) {
  if (!rows_args_ok(x, dtype, rows, cols))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_rows(x, dtype, rows, cols, workspace, out,
                                      static_cast<cudaStream_t>(stream)));
}

// The whole layer: launch 1, then launch 2 on the same stream.
int wcgan_whiten_color_apply(const void* x, int dtype, int64_t rows,
                             int cols, const float* mean, const float* cov,
                             const float* gamma, const float* beta,
                             int ns_iters, float eps, int scaling, void* out,
                             float* workspace, void* stream) {
  if (!setup_args_ok(cols, ns_iters, scaling) ||
      !rows_args_ok(x, dtype, rows, cols))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_setup(mean, cov, gamma, beta, cols, ns_iters, eps,
                                 scaling, workspace, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_rows(x, dtype, rows, cols, workspace, out,
                                      s));
}

}  // extern "C"
