// K1: mean and divide-by-R covariance of the rows of x (R, C), for Hopper.
//
// Replaces the TPU kernel wcgan_tpu/ops/pallas_wc.py::_moments_kernel
// (launched by _moments_pallas). It computes the same thing: the column
// mean of x, then the two-pass CENTERED Gram sum_r (x_r - mu)(x_r - mu)^T / R,
// accumulated in float32 for float32 and bfloat16 input, rows past R masked
// to 0 after centering. The one-pass form E[xx^T] - mu mu^T cancels
// catastrophically when |mu| >> sigma, so mu is final before any product.
//
// What bounds it on an H100 (SXM, 700 W), over the 42 calls of one training
// outer step of G 256x3 (C = 256, bf16 rows, sum of R = 1,211,392): the
// symmetric Gram is R*C*(C+1) = 7.97e10 flop and the input is 620 MB, so
//   - 1.19 ms on the float32 FFMA pipes (67 TFLOP/s),
//   - 0.48 ms on the tensor cores as 3xTF32 (3 x 7.97e10 at 495 TFLOP/s):
//     the floor of the emulation chosen here, not of the function,
//   - 0.19 ms from HBM (3.35 TB/s): the bound, since the same flop at the
//     bf16 tensor-core rate (989 TFLOP/s, the input's type) is 0.08 ms.
// 3xTF32 was chosen over bf16x3 (hi, lo in bf16, 0.24 ms floor) for its
// margin under the 1e-4 gate in a CPU emulation: about 60x (1.6e-6 from
// float64) against about 3x for bf16x3 (3.4e-5, one case). bf16x3 has not
// been built or held to the gates on the card.
// What the design does about each:
// - FFMA: the Gram runs on the tensor cores. 1-pass TF32 (10-bit mantissa)
//   misses the 1e-4 gate against plain float32 (1.3e-4 on bf16-rounded
//   correlated rows, tests/test_torch_moments.py), so each centered value v
//   is split into hi = tf32(v) and lo = tf32(v - hi) and the tile takes
//   hi.hi + hi.lo + lo.hi (lo.lo dropped, ~2^-22 relative) with
//   wgmma.mma_async m64n128k8 .tf32 into float32 register accumulators:
//   about 22 bits, as the JAX package's own Precision.HIGH matmuls.
// - Tensor-core floor: operands are staged so that the products never wait
//   on memory. A producer warp keeps TMA loads (cp.async.bulk.tensor, a 2-D
//   tensor map over x) in flight into a kStages ring guarded by mbarriers.
//   tf32 wgmma reads K-major operands only and x is row-major (C
//   contiguous, R the reduction), so the two consumer warpgroups convert
//   each staged tile into the operand layout themselves: float32, minus mu,
//   rows past the range zeroed (TMA fills rows past R with 0, which would
//   become -mu), split into hi/lo, and stored K-major in the 128-byte
//   swizzle that wgmma reads. The operands are double buffered: stage s is
//   converted and stored while the products of stage s-1 run. On a
//   diagonal tile pair (ti = tj), A and B are the same buffers. The
//   tensor core's float32 accumulation is biased over long chains, so each
//   stage's products start from 0 and are added to the block's total with
//   ordinary float32 adds.
// - HBM: the mean pass reads x once (vectorised, ~2.6 TB/s on the card);
//   the Gram reads each row once per tile pair that needs it (twice at
//   C = 256: pairs (0,0), (0,1), (1,1) share the rows, and their blocks
//   run together, so the second read mostly hits L2). The split-R
//   workspace is one 128 x 128 float32 partial per block: a grid of about
//   one block per SM (kTargetBlocks) walks (tile pair, R-range) items, one
//   per block, with as many ranges as fill the SMs and at least
//   kMinSplitRows rows each. At C = 256: R = 1,024, 8 ranges x 3 pairs,
//   1,572,864 bytes of partials + 131,072 of column sums (input 524,288
//   in bf16: the partials stay in L2); R = 131,072, 44 x 3, 8,650,752 +
//   524,288 bytes (input 67,108,864). The previous FFMA kernel wrote
//   12.6 MB and 34.6 MB there.
//
// What holds it back (scripts/k1_variants.py times variants of this file
// on the card; PERF.md): at R = 131,072 the Gram launch takes ~163 us
// against 78 us for its tensor-core work at peak, unthrottled (1,980 MHz,
// ~600 W). The conversion does not overlap the products: each of its
// parts (shared loads, stores) adds its own time to theirs, about one
// cycle per shared-memory wavefront. A deeper ring, one empty arrival per
// warp and cvt.rna rounding did not help; converter warpgroups of their
// own, interleaving the conversion with the k8 steps, two products on
// diagonal tiles and A-operands from registers were slower. At R <= 8,192
// the four launches' fixed costs dominate (~20 us a call).
//
// Launches, stream-ordered, no atomics, identical from run to run:
// per-chunk column sums, the mean, the tf32x3 Gram partials, and a
// fixed-order reduce over R-ranges that takes the upper triangle of every
// tile and mirrors it, so cov equals cov^T exactly.
//
// Shapes taken: any R >= 1 below 2^31 and any C whose row is a multiple of
// 16 bytes (TMA's stride rule): C % 4 == 0 in float32, C % 8 == 0 in
// bfloat16. Columns past C are zero-padded in shared memory.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 128;          // edge of an output tile: M = N = 128
constexpr int kStageRows = 32;      // rows of x per stage: K = 32 tf32, one
                                    // 128-byte swizzle row of an operand
constexpr int kStages = 3;          // depth of the TMA ring
constexpr int kConsumers = 256;     // 2 warpgroups, 64 output rows each
constexpr int kThreads = kConsumers + 32;  // + the producer warp
constexpr int kOperandBytes = kTile * kStageRows * 4;  // 16 KB per operand
constexpr int kTargetBlocks = 132;  // SMs of an H100 SXM
constexpr int kMinSplitRows = 128;  // at least 4 stages per R-range
constexpr int kSumThreads = 256;    // 8 warps of rows in the column sums
constexpr int kSumBlocks = 256;     // column-sum blocks aimed for
constexpr int kMaxSumRows = 256;    // rows per column-sum block, at most
constexpr int kMeanCols = 8;        // columns per block in the mean reduce
constexpr int kMeanLanes = 32;      // chunk lanes per column in that reduce
constexpr int kReduceThreads = 256;

template <typename T>
__host__ __device__ constexpr int raw_stage_bytes() {
  return 2 * kStageRows * kTile * sizeof(T);
}
// 2 sets of 4 operands (hi/lo of A and B), the ring, mu of both tiles, the
// barriers: 230,448 bytes in float32 (of 232,448), 181,296 in bfloat16.
template <typename T>
__host__ __device__ constexpr int gram_smem_bytes() {
  return 8 * kOperandBytes + kStages * raw_stage_bytes<T>() + 2 * kTile * 4 +
         2 * kStages * 8;
}

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
__host__ __device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}
__host__ __device__ __forceinline__ int64_t ceil_div(int64_t a, int64_t b) {
  return (a + b - 1) / b;
}

// Tile pair p, counted row by row over ti <= tj, -> (ti, tj).
__host__ __device__ __forceinline__ void pair_tiles(int p, int tiles, int* ti,
                                                    int* tj) {
  int i = 0;
  while (p >= tiles - i) {
    p -= tiles - i;
    ++i;
  }
  *ti = i;
  *tj = i + p;
}

// The Gram launch's plan: `splits` R-ranges of `split_rows` rows (a whole
// number of stages) for each of `pairs` tile pairs, one block per item:
// as many ranges as fill the SMs once, each at least kMinSplitRows long.
// Measured on the card and not kept: capping the partials at the bytes of
// x (the call at R = 1,024 twice as slow, 16 stages a block;
// scripts/k1_variants.py), and giving off-diagonal pairs, which convert
// two column tiles a stage, more ranges than diagonal ones (no faster).
struct Plan {
  int pairs;
  int64_t splits;
  int64_t split_rows;
};

Plan plan_for(int64_t rows, int cols) {
  Plan p;
  p.pairs = num_pairs(cols);
  int64_t splits = min64(kTargetBlocks / p.pairs,
                         ceil_div(rows, kMinSplitRows));
  if (splits < 1) splits = 1;
  p.split_rows = ceil_div(ceil_div(rows, splits), kStageRows) * kStageRows;
  p.splits = ceil_div(rows, p.split_rows);
  return p;
}

// --- PTX wrappers: mbarrier, TMA, wgmma --------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// Returns once the phase of parity `parity` of `bar` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// One 2-D box of x, {col, row} its first element, into shared memory; the
// bytes land on `bar`'s transaction count. Out-of-range elements read 0.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int col, int row, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row),
      "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void named_barrier_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// v rounded to tf32 (10 mantissa bits), to nearest with ties away from 0,
// as cvt.rna.tf32.f32 rounds, low 13 bits zero; two integer operations
// (cvt.rna measured 10% slower in the whole kernel). Finite v only.
__device__ __forceinline__ float tf32_round(float v) {
  return __uint_as_float((__float_as_uint(v) + 0x1000u) & 0xffffe000u);
}

// Descriptor of a K-major operand in the 128-byte swizzle: rows of 128
// bytes (32 tf32 along K), groups of 8 rows 1,024 bytes apart (SBO).
__device__ __forceinline__ uint64_t operand_desc(const void* p) {
  const uint64_t addr = smem_addr(p);
  return ((addr & 0x3ffff) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// d (64 x 128, this warpgroup's fragment) = A (64 x 8) B (8 x 128)
// + (accumulate ? d : 0), tf32.
__device__ __forceinline__ void wgmma_m64n128k8(float (&d)[64], uint64_t da,
                                                uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1;\n}\n"
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

// --- the launches ----------------------------------------------------------

// Rows per column-sum block: about kSumBlocks blocks, a multiple of the 8
// row lanes, at most kMaxSumRows.
int64_t sum_rows_for(int64_t rows) {
  const int64_t r = ceil_div(ceil_div(rows, kSumBlocks), 8) * 8;
  return r < kMaxSumRows ? r : kMaxSumRows;
}

// Launch 1: partial[s, c] = sum of x[r, c] over rows s*sum_rows ... + sum_rows.
// Warp w sums rows w, w + 8, ...; lane l the kVec columns of 16-byte group
// blockIdx.y * 32 + l, so a warp reads 512 contiguous bytes of a row. The
// 8 warps' sums are added in order: deterministic.
template <typename T>
__global__ void __launch_bounds__(kSumThreads)
col_partial_sums(const T* __restrict__ x, int64_t rows, int cols,
                 int64_t sum_rows, float* __restrict__ partial) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kWarps = kSumThreads / 32;
  __shared__ float warp_sums[kWarps][32 * kVec];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int c0 = (blockIdx.y * 32 + lane) * kVec;
  float acc[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) acc[j] = 0.f;
  if (c0 < cols) {
    const int64_t r1 =
        min64(rows, static_cast<int64_t>(blockIdx.x + 1) * sum_rows);
#pragma unroll 4
    for (int64_t r = static_cast<int64_t>(blockIdx.x) * sum_rows + warp;
         r < r1; r += kWarps) {
      const uint4 v = *reinterpret_cast<const uint4*>(x + r * cols + c0);
      const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
      for (int j = 0; j < kVec; ++j) acc[j] += to_f32(e[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < kVec; ++j) warp_sums[warp][lane * kVec + j] = acc[j];
  __syncthreads();
  if (warp == 0 && c0 < cols) {
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      float total = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) total += warp_sums[w][lane * kVec + j];
      partial[static_cast<int64_t>(blockIdx.x) * cols + c0 + j] = total;
    }
  }
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

// Launch 3: ws[b] = the centered Gram of tile pair (ti, tj) over R-range q,
// block b = q * pairs + p (the pairs of one range are neighbours, so the
// rows they share are read from HBM about once).
//
// Threads 0-255 are the consumers (warpgroup w owns output rows 64w..64w+63
// of the tile); warp 8 is the producer, whose lane 0 issues the TMA loads.
// Consumer thread t converts column c = t % 128 of the tile, 4-row chunks
// kc = t / 128 + {0, 2, 4, 6} of the stage: one 16-byte swizzled store per
// chunk and operand, free of bank conflicts. The operands are double
// buffered: stage s is converted into set s % 2 while the products of
// stage s - 1 run on set (s - 1) % 2.
//
// The tensor core's float32 accumulation is biased over long chains (the
// error grows with the rows per block; scripts/k1_variants.py measures it
// without the restart). So each stage's products start from 0 in `part`
// (32 rows, magnitude ~32 |v|^2), and `part` is added to `total` with
// float32 FADDs, rounded to nearest.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
centered_gram_tf32x3(const __grid_constant__ CUtensorMap xmap,
                     const float* __restrict__ mean, int64_t rows, int cols,
                     int box_cols, int64_t split_rows, int pairs,
                     float* __restrict__ ws) {
  // 1,024-byte aligned for the 128-byte swizzle; taken as it is (no
  // align-up through an integer), so the compiler keeps the shared address
  // space and the accesses below are LDS/STS, not generic loads and stores.
  extern __shared__ __align__(1024) uint8_t base[];
  uint8_t* operands = base;  // 2 sets of: hi A, lo A, hi B, lo B
  T* raw = reinterpret_cast<T*>(base + 8 * kOperandBytes);
  float* mu = reinterpret_cast<float*>(base + 8 * kOperandBytes +
                                       kStages * raw_stage_bytes<T>());
  uint64_t* full = reinterpret_cast<uint64_t*>(mu + 2 * kTile);
  uint64_t* empty = full + kStages;

  int ti, tj;
  pair_tiles(blockIdx.x % pairs, num_tiles(cols), &ti, &tj);
  const int64_t r0 = static_cast<int64_t>(blockIdx.x / pairs) * split_rows;
  const bool diag = ti == tj;
  const int64_t r1 = min64(rows, r0 + split_rows);
  const int stages = static_cast<int>(ceil_div(r1 - r0, kStageRows));
  const int tid = threadIdx.x;

  for (int k = tid; k < 2 * kTile; k += kThreads) {
    const int c = (k < kTile ? ti : tj) * kTile + k % kTile;
    mu[k] = c < cols ? mean[c] : 0.f;  // padded columns center to 0
  }
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // Raw stage `slot`, tile 0 (columns of ti) or 1 (columns of tj): a
  // kStageRows x box_cols row-major box as TMA writes it.
  auto raw_tile = [&](int slot, int which) {
    return raw + (slot * 2 + which) * kStageRows * kTile;
  };

  if (tid >= kConsumers) {  // the producer warp
    if (tid == kConsumers) {
      const uint32_t bytes = (diag ? 1 : 2) * kStageRows * box_cols *
                             static_cast<uint32_t>(sizeof(T));
      for (int s = 0; s < stages; ++s) {
        const int slot = s % kStages;
        if (s >= kStages) mbar_wait(&empty[slot], ((s / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[slot], bytes);
        const int row = static_cast<int>(r0) + s * kStageRows;
        tma_load_2d(raw_tile(slot, 0), &xmap, ti * kTile, row, &full[slot]);
        if (!diag)
          tma_load_2d(raw_tile(slot, 1), &xmap, tj * kTile, row, &full[slot]);
      }
    }
    return;
  }

  const int wg = tid / 128;
  const int c = tid % 128;
  const int kc0 = tid / 128;
  const bool col_live = c < box_cols;
  const float mu_a = mu[c];
  const float mu_b = mu[kTile + c];
  // Operand `which` (0 hi A, 1 lo A, 2 hi B, 3 lo B) of set `set`; on a
  // diagonal pair B is A.
  auto operand = [&](int set, int which) {
    return operands +
           (set * 4 + (diag ? which % 2 : which)) * kOperandBytes;
  };

  float total[64], part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) total[i] = part[i] = 0.f;

  for (int s = 0; s < stages; ++s) {
    const int slot = s % kStages;
    const int set = s % 2;
    mbar_wait(&full[slot], (s / kStages) & 1);
    const int64_t row0 = r0 + static_cast<int64_t>(s) * kStageRows;
    const T* ra = raw_tile(slot, 0);
    const T* rb = raw_tile(slot, 1);
    // Convert, center, mask, split, store: while the products of stage
    // s - 1 run. Set `set` was last read by stage s - 2, which every
    // warpgroup waited for before the barrier of stage s - 1.
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int kc = kc0 + 2 * q;
      const int off = c * 128 + ((kc ^ (c & 7)) << 4);
      float h[2][4], l[2][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = kc * 4 + i;
        const bool live = col_live && row0 + k < r1;
        const float va = live ? to_f32(ra[k * box_cols + c]) - mu_a : 0.f;
        h[0][i] = tf32_round(va);
        l[0][i] = tf32_round(va - h[0][i]);
        if (!diag) {
          const float vb =
              live ? to_f32(rb[k * box_cols + c]) - mu_b : 0.f;
          h[1][i] = tf32_round(vb);
          l[1][i] = tf32_round(vb - h[1][i]);
        }
      }
      *reinterpret_cast<float4*>(operand(set, 0) + off) =
          make_float4(h[0][0], h[0][1], h[0][2], h[0][3]);
      *reinterpret_cast<float4*>(operand(set, 1) + off) =
          make_float4(l[0][0], l[0][1], l[0][2], l[0][3]);
      if (!diag) {
        *reinterpret_cast<float4*>(operand(set, 2) + off) =
            make_float4(h[1][0], h[1][1], h[1][2], h[1][3]);
        *reinterpret_cast<float4*>(operand(set, 3) + off) =
            make_float4(l[1][0], l[1][1], l[1][2], l[1][3]);
      }
    }
    mbar_arrive(&empty[slot]);  // the raw stage is free for the producer
    // The generic-proxy stores become visible to wgmma (async proxy).
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    wgmma_wait_all();  // this warpgroup's stage s - 1
#pragma unroll
    for (int i = 0; i < 64; ++i) total[i] += part[i];
    named_barrier_sync(1, kConsumers);  // set `set` complete
    // This warpgroup's 64 rows of A; all 128 rows of B. +32 bytes per k8
    // step inside the swizzled 128-byte row.
    const uint64_t d_hi_a = operand_desc(operand(set, 0) + wg * 64 * 128);
    const uint64_t d_lo_a = operand_desc(operand(set, 1) + wg * 64 * 128);
    const uint64_t d_hi_b = operand_desc(operand(set, 2));
    const uint64_t d_lo_b = operand_desc(operand(set, 3));
    wgmma_fence();
#pragma unroll
    for (int k8 = 0; k8 < kStageRows / 8; ++k8) {
      wgmma_m64n128k8(part, d_hi_a + 2 * k8, d_lo_b + 2 * k8, k8 > 0);
      wgmma_m64n128k8(part, d_lo_a + 2 * k8, d_hi_b + 2 * k8, 1);
      wgmma_m64n128k8(part, d_hi_a + 2 * k8, d_hi_b + 2 * k8, 1);
    }
    wgmma_commit();
  }
  wgmma_wait_all();
#pragma unroll
  for (int i = 0; i < 64; ++i) total[i] += part[i];

  // Fragment of m64nN: warp w4 of the warpgroup holds rows 16*w4 + lane/4
  // (+8); total[4i .. 4i+3] are columns 8i + 2*(lane%4) (+1) of those rows.
  float* out = ws + static_cast<int64_t>(blockIdx.x) * kTile * kTile;
  const int lane = tid % 32;
  const int row = wg * 64 + (tid % 128) / 32 * 16 + lane / 4;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int col = 8 * i + 2 * (lane % 4);
    *reinterpret_cast<float2*>(&out[row * kTile + col]) =
        make_float2(total[4 * i], total[4 * i + 1]);
    *reinterpret_cast<float2*>(&out[(row + 8) * kTile + col]) =
        make_float2(total[4 * i + 2], total[4 * i + 3]);
  }
}

// Launch 4: cov = (sum over R-ranges, in order, of ws) / rows, for every
// element on or above the diagonal, written to (i, j) and (j, i). The
// lower half of a diagonal tile (computed with hi.lo and lo.hi swapped,
// so not bitwise equal to the upper) is not read.
__global__ void __launch_bounds__(kReduceThreads)
reduce_gram(const float* __restrict__ ws, int64_t splits, int cols,
            float inv_rows, float* __restrict__ cov) {
  const int pairs = num_pairs(cols);
  const int64_t e =
      static_cast<int64_t>(blockIdx.x) * kReduceThreads + threadIdx.x;
  if (e >= static_cast<int64_t>(pairs) * kTile * kTile) return;
  const int li = static_cast<int>(e % (kTile * kTile)) / kTile;
  const int lj = static_cast<int>(e % kTile);
  int ti, tj;
  pair_tiles(static_cast<int>(e / (kTile * kTile)), num_tiles(cols), &ti,
             &tj);
  if (ti == tj && li > lj) return;
  const int i = ti * kTile + li;
  const int j = tj * kTile + lj;
  if (i >= cols || j >= cols) return;
  const int64_t stride = static_cast<int64_t>(pairs) * kTile * kTile;
  float acc = 0.f;
  for (int64_t s = 0; s < splits; ++s) acc += ws[s * stride + e];
  acc *= inv_rows;
  cov[static_cast<int64_t>(i) * cols + j] = acc;
  cov[static_cast<int64_t>(j) * cols + i] = acc;
}

// --- host side -------------------------------------------------------------

using EncodeTiledFn = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime (so the
// library needs no link against libcuda). Null if the driver lacks it.
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &q);
#endif
    return q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

template <typename T>
cudaError_t launch(const T* x, int64_t rows, int cols, float* mean, float* cov,
                   float* workspace, cudaStream_t stream) {
  const Plan plan = plan_for(rows, cols);
  const int64_t sum_rows = sum_rows_for(rows);
  const int64_t sum_chunks = ceil_div(rows, sum_rows);
  const float inv_rows = 1.0f / static_cast<float>(rows);
  const int box_cols = cols < kTile ? cols : kTile;
  // The Gram partials come first: their float2 stores need 8-byte
  // alignment, which the caller's allocation gives.
  float* gram_partial = workspace;  // [splits * pairs, kTile, kTile]
  float* col_partial =
      workspace + plan.splits * plan.pairs * kTile * kTile;

  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap xmap;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * sizeof(T)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols), kStageRows};
  const cuuint32_t elem_strides[2] = {1, 1};
  if (encode(&xmap,
             sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                            : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
             2, const_cast<T*>(x), dims, strides, box, elem_strides,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  // Above 48 KB of dynamic shared memory a kernel must opt in. The
  // attribute belongs to the current device, so it is set on every call
  // (it costs far less than a launch), not once per process.
  cudaError_t smem_opt_in = cudaFuncSetAttribute(
      centered_gram_tf32x3<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      gram_smem_bytes<T>());
  if (smem_opt_in != cudaSuccess) return smem_opt_in;

  col_partial_sums<T><<<dim3(static_cast<unsigned>(sum_chunks),
                             ceil_div(cols, 32 * (16 / sizeof(T)))),
                        kSumThreads, 0, stream>>>(x, rows, cols, sum_rows,
                                                  col_partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  finalize_mean<<<ceil_div(cols, kMeanCols), kMeanCols * kMeanLanes, 0,
                  stream>>>(col_partial, sum_chunks, cols, inv_rows, mean);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  centered_gram_tf32x3<T>
      <<<static_cast<unsigned>(plan.splits * plan.pairs), kThreads,
         gram_smem_bytes<T>(), stream>>>(xmap, mean, rows, cols, box_cols,
                                         plan.split_rows, plan.pairs,
                                         gram_partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t elems = static_cast<int64_t>(plan.pairs) * kTile * kTile;
  reduce_gram<<<static_cast<unsigned>(ceil_div(elems, kReduceThreads)),
                kReduceThreads, 0, stream>>>(gram_partial, plan.splits, cols,
                                             inv_rows, cov);
  return cudaGetLastError();
}

bool shape_ok(const void* x, int64_t rows, int cols, int itemsize) {
  return rows >= 1 && rows <= INT32_MAX && cols >= 1 &&
         (static_cast<int64_t>(cols) * itemsize) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(x) % 16 == 0;
}

}  // namespace

extern "C" {

// Floats of scratch the caller allocates for one call at (rows, cols): the
// Gram partials, then the column sums.
int64_t wcgan_moments_workspace_floats(int64_t rows, int cols) {
  const Plan plan = plan_for(rows, cols);
  return plan.splits * plan.pairs * kTile * kTile +
         ceil_div(rows, sum_rows_for(rows)) * cols;
}

// dtype: 0 = float32, 1 = bfloat16. x is (rows, cols) row-major and
// contiguous, 16-byte aligned, with cols * itemsize a multiple of 16; mean
// (cols,), cov (cols, cols) and workspace are float32. Enqueues on
// `stream` and does not synchronise. Returns the cudaError_t of the first
// step that failed, 0 when all four launches were accepted.
int wcgan_moments(const void* x, int dtype, int64_t rows, int cols,
                  float* mean, float* cov, float* workspace, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && shape_ok(x, rows, cols, 4))
    return static_cast<int>(launch(static_cast<const float*>(x), rows, cols,
                                   mean, cov, workspace, s));
  if (dtype == 1 && shape_ok(x, rows, cols, 2))
    return static_cast<int>(launch(static_cast<const __nv_bfloat16*>(x), rows,
                                   cols, mean, cov, workspace, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
