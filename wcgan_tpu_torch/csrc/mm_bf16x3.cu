// K3: C = alpha op(A) op(B) + beta I in float32, the product as three bf16
// tensor-core products (the "bf16x3" emulation of a float32 product), for
// Hopper (sm_90a).
//
// It replaces no Pallas kernel. It is the port's counterpart of XLA's
// Precision.HIGH on the TPU, which the JAX package's default whitening
// precision runs (wcgan_tpu/ops/whiten.py:48, --whitening_precision high):
// every whitening-path float32 product done as 3 bf16 passes,
//   a b ~= a_lo b_hi + a_hi b_lo + a_hi b_hi,
//   a_hi = bf16(a), a_lo = bf16(a - a_hi),
// with float32 accumulation (about 16 bits of each operand kept). PyTorch
// has no such mode on CUDA: its 'high' float32 matmul precision is TF32
// (10 bits), and a bf16 torch.matmul rounds each product to bf16.
//
// Inputs are float32, each "as given" or "transposed" (a flag and a leading
// dimension per operand, so that autograd's transposed products launch no
// copy); the output is float32, row-major and contiguous. Any M, N, K:
// rows, columns and depth past the edges load 0 and are not stored. The
// epilogue is out_ij = fmaf(alpha, sum_ij, i == j ? beta : 0) (alpha * sum
// when beta is 0), so that Newton-Schulz's T = 1.5 I - 0.5 Z Y is one
// launch (alpha = -0.5, beta = 1.5): alpha is a power of two there, so
// alpha * sum is exact and T has the bits of the product followed by
// 1.5 * I - 0.5 * P in float32.
//
// What bounds it on an H100 (SXM, 700 W). The whitening's C x C products
// are small: at C = 256 one moves 786 KB (A, B read once, C written once:
// 0.23 us at 3.35 TB/s) and does 1.0e8 flop (three bf16 products of 2 C^3:
// 0.10 us at 989 TFLOP/s). Such a product is bound by latency (the launch,
// the first loads from L2, the chain over K), and the 2,499 products of
// one headline step under 'high' run back to back, each waiting for the
// one before. The row products (R x C x C, R up to 131,072, K1's backward
// and float32 whiten_apply) are bound by bytes: 268 MB at R = 131,072,
// C = 256, 0.080 ms.
//
// The design: one launch a product, two paths picked by the shape, no
// workspace, no atomics, every sum in a fixed order, so two calls give the
// same bits. A third entry point (path 3, mm_bf16x3_ns) runs a whole
// Newton-Schulz iteration's 44 products in one launch, each with path 1's
// arithmetic.
// 1. mma.sync, K split over a thread-block cluster where K is long
//    (mm_bf16x3_splitk), for every product whose 128 x 128 tiles would
//    not fill the card (every C x C product at C = 64 ... 512, the bias's
//    1 x C x C, the plain covariance's C x R x C). Output tiles are 32 x 32
//    (four warps, each 16 x 16) or 64 x 64 (eight warps, each 32 x 16)
//    where there are 64 such tiles or more. Where a CTA would walk more
//    than 8 K tiles of 32 (C = 512; K = R), a cluster of `split` CTAs (2,
//    4 or 8) shares one tile, each CTA a slab of K, as many as keep the
//    grid within one wave (two 32 x 32 CTAs an SM, one 64 x 64) or, where
//    K is long, up to 8: at C = 512, 64 tiles x 2 CTAs each walk 256 of K.
//    At C <= 256 K is not split: there the cluster's reduction cost more
//    (~1.6-1.9 us a product) than the shorter walk saved (C = 256: 6.89 us
//    split over 4 CTAs, 6.66 us not split; C = 512: 14.08 against 18.88;
//    scripts/k3_variants.py, PERF.md). A CTA issues cp.async copies of
//    its slab (16-byte copies where the operand's rows lie on 16-byte
//    boundaries, else 4-byte ones; the ragged edge zero-filled by the
//    copy) 4 tiles deep (2 for 64 x 64); TMA would need 16-byte-aligned
//    rows, which offset views do not have. The warps split each staged
//    float32 fragment in registers (cvt.rn.bf16x2 on pairs) and run
//    mma.sync m16n8k16 (bf16 in, float32 accumulators). Per 32-deep K tile
//    the three terms go into a fresh accumulator, smallest first (a_lo
//    b_hi, a_hi b_lo, a_hi b_hi), which is then added to the running sum
//    with Kahan's compensation: the tensor core's own float32 sums
//    truncate, and an uncompensated sum of K / 32 tiles drifts where K is
//    long (K = R: 4,096 tiles at R = 131,072); at K = C the compensation
//    costs a few FADDs a tile and is kept for one code path. In a cluster
//    each CTA writes its partial tile (sum minus compensation) to its own
//    shared memory; after a cluster barrier CTA r sums rows r * BM / split
//    ... of the tile over the cluster's partials through distributed
//    shared memory, in rank order, applies the epilogue and stores them; a
//    second barrier keeps every partial alive until it has been read.
//    Measured and not kept: the other CTAs pushing their partials into the
//    leader's shared memory (scalar stores and a remote mbarrier arrival:
//    9.42 us at C = 256 split over 4; st.async: 6.86 us), in place of the
//    two barriers.
// 2. wgmma on a TMA ring (mm_bf16x3_rows), for products whose 128-row
//    tiles fill the card and whose K is at most 512 (the R x C x C row
//    products). A persistent grid: CTA b keeps one slice of BN output
//    columns (128 where K <= 256, else 64) and walks row tiles b / slices,
//    + groups, ... Its producer warp keeps TMA loads of 128 x 32 float32
//    tiles of A (in the 128-byte swizzle: as given one 32 x 128 box, A
//    transposed four 32 x 32 boxes) in flight through a 3-stage mbarrier
//    ring. At the start the 256 consumer threads split the CTA's slice of B
//    into bf16 hi / lo pieces, K-major in the 128-byte swizzle, resident
//    for the whole launch (128 KB). Each consumer warpgroup (64 rows) splits
//    its rows of every stage once into hi / lo pieces, K-major in the
//    64-byte swizzle, double-buffered (both raw layouts read free of bank
//    conflicts), and issues the three wgmma m64nBNk16 terms per k16 step,
//    smallest first, into a fresh accumulator per 32-deep stage, added to
//    the tile's float32 sum (plain FADDs: at most 16 stages, K <= 512).
//    The tile is stored from registers with the epilogue while the
//    producer's loads of the next tile are already in flight. The two
//    column slices of a row tile run on neighbouring CTAs, so A comes from
//    HBM about once.
// A non-finite input gives a non-finite output where the float32 product
// would: inf splits into hi = inf, lo = inf - inf = NaN.
// Measured and not kept: programmatic dependent launch (each kernel
// waiting in griddepcontrol.wait, the launch letting it start while the
// one before drains): the captured step ran up to 2.8 % faster, but each
// kernel's traced span then holds its wait (scripts/k3_variants.py's
// pdl). PERF.md holds this design's numbers beside the previous one's
// (one CTA a tile walking all of K at every shape, the epilogue as three
// elementwise launches).

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

namespace cg = cooperative_groups;

// --- the split-K path -------------------------------------------------------
constexpr int kBK = 32;       // depth of a K tile
constexpr int kSPad = 4;      // floats of padding a staged row
constexpr int kMaxSplit = 8;  // CTAs a cluster, the portable limit
constexpr int kSplitTiles = 8;  // K tiles a CTA walks before K is split
// --- the row path -----------------------------------------------------------
constexpr int kRowTile = 128;           // rows a tile: 2 warpgroups x 64
constexpr int kStageK = 32;             // K a stage
constexpr int kRowStages = 3;           // depth of the TMA ring
constexpr int kRowConsumers = 256;
constexpr int kRowThreads = kRowConsumers + 32;  // + the producer warp
constexpr int kRawBytes = kRowTile * kStageK * 4;    // a float32 stage
constexpr int kPieceBytes = kRowTile * kStageK * 2;  // one bf16 piece of it
constexpr int kMaxRowK = 512;
constexpr int kMaxDevices = 64;

__host__ __device__ __forceinline__ int64_t ceil_div(int64_t a, int64_t b) {
  return (a + b - 1) / b;
}

// The epilogue: alpha * sum, plus beta on the diagonal. fmaf rounds once,
// so with alpha a power of two it equals beta * I + alpha * sum rounded.
__device__ __forceinline__ float finish(float sum, float alpha, float beta,
                                        int64_t row, int64_t col) {
  return beta == 0.f ? alpha * sum
                     : fmaf(alpha, sum, row == col ? beta : 0.f);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// An asynchronous 4-byte copy to shared memory; 0 when !ok (src is then
// not read).
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// An asynchronous 16-byte copy of `bytes` (0 to 16) bytes, the rest of the
// 16 filled with 0.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The bf16 pieces of (x0, x1), each pair packed low half first:
// hi = bf16(x), lo = bf16(x - hi), rounded to nearest even.
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const __nv_bfloat162 l =
      __floats2bfloat162_rn(x0 - __low2float(h), x1 - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// The pieces of 8 consecutive values, as two 16-byte chunks of 8 bf16.
__device__ __forceinline__ void split8(const float (&v)[8], uint4& hi,
                                       uint4& lo) {
  split2(v[0], v[1], hi.x, lo.x);
  split2(v[2], v[3], hi.y, lo.y);
  split2(v[4], v[5], hi.z, lo.z);
  split2(v[6], v[7], hi.w, lo.w);
}

// A BR x kBK float32 tile of op(X) staged as it lies in memory: rows of K
// when KContiguous (A as given, B transposed), else kBK rows of BR, each
// padded by kSPad floats.
template <int BR, bool KContiguous>
struct Staged {
  static constexpr int kFloats =
      KContiguous ? BR * (kBK + kSPad) : kBK * (BR + kSPad);
  __device__ __forceinline__ static int at(int r, int kk) {
    return KContiguous ? r * (kBK + kSPad) + kk : kk * (BR + kSPad) + r;
  }
  // Tile coordinates of element e of a thread's walk, along the
  // contiguous direction so that a warp's copies cover 128 bytes.
  __device__ __forceinline__ static void coord(int e, int& r, int& kk) {
    if (KContiguous) {
      r = e / kBK;
      kk = e % kBK;
    } else {
      r = e % BR;
      kk = e / BR;
    }
  }
};

// Path 1. C (m, n) = alpha op(A) (m, k) op(B) (k, n) + beta I. op(A)[i][l]
// is a[i * lda + l], or a[l * lda + i] when TA; op(B)[l][j] is
// b[l * ldb + j], or b[j * ldb + l] when TB. Grid (split x row tiles,
// column tiles), clusters of `split` CTAs along x: CTA rank r of a cluster
// takes K in [r * k_slab, (r + 1) * k_slab). A BM x BN tile a cluster, its
// warps WARPS_M x WARPS_N over it, STAGES K tiles in flight.
template <int BM, int BN, int WARPS_M, int WARPS_N, int STAGES, bool TA,
          bool TB>
__global__ void __launch_bounds__(32 * WARPS_M * WARPS_N, 1)
    mm_bf16x3_splitk(const float* __restrict__ a, int64_t lda,
                     const float* __restrict__ b, int64_t ldb,
                     float* __restrict__ c, int m, int n, int k, int split,
                     int k_slab, bool vec_a, bool vec_b, float alpha,
                     float beta) {
  constexpr int kThreads = 32 * WARPS_M * WARPS_N;
  constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;  // a warp's share
  constexpr int MT = WM / 16, NT = WN / 8;  // its m16 and n8 fragments
  using SA = Staged<BM, !TA>;
  using SB = Staged<BN, TB>;
  __shared__ __align__(16) float sa[STAGES][SA::kFloats];
  __shared__ __align__(16) float sb[STAGES][SB::kFloats];
  static_assert(STAGES * SA::kFloats >= BM * (BN + 1),
                "the partial tile lives where op(A) was staged");

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp / WARPS_N) * WM, wn = (warp % WARPS_N) * WN;
  const int rank = static_cast<int>(blockIdx.x % split);
  const int64_t m0 = static_cast<int64_t>(blockIdx.x / split) * BM;
  const int64_t n0 = static_cast<int64_t>(blockIdx.y) * BN;
  const int64_t k_lo = static_cast<int64_t>(rank) * k_slab;
  const int64_t k_hi = k_lo + k_slab < k ? k_lo + k_slab : k;

  // Copy K tile kt of this CTA's slab of op(A) and op(B) into stage
  // kt % STAGES: in 16-byte chunks along the contiguous direction where
  // the operand's rows are 16-byte aligned (vec_a, vec_b), else element by
  // element; depth past the slab reads 0.
  auto issue = [&](int kt) {
    const int s = kt % STAGES;
    const int64_t k0 = k_lo + static_cast<int64_t>(kt) * kBK;
    if (vec_a) {
#pragma unroll
      for (int i = 0; i < BM * kBK / 4 / kThreads; ++i) {
        int r, kk;
        SA::coord((tid + i * kThreads) * 4, r, kk);
        const int64_t gm = m0 + r, gk = k0 + kk;
        const int64_t left = TA ? (gk < k_hi ? m - gm : 0)
                                : (gm < m ? k_hi - gk : 0);
        const int valid = static_cast<int>(left < 0 ? 0 : (left > 4 ? 4 : left));
        cp_async16(&sa[s][SA::at(r, kk)],
                   valid ? (TA ? a + gk * lda + gm : a + gm * lda + gk) : a,
                   4 * valid);
      }
    } else {
#pragma unroll
      for (int i = 0; i < BM * kBK / kThreads; ++i) {
        int r, kk;
        SA::coord(tid + i * kThreads, r, kk);
        const int64_t gm = m0 + r, gk = k0 + kk;
        const bool ok = gm < m && gk < k_hi;
        cp_async4(&sa[s][SA::at(r, kk)],
                  ok ? (TA ? a + gk * lda + gm : a + gm * lda + gk) : a, ok);
      }
    }
    if (vec_b) {
#pragma unroll
      for (int i = 0; i < BN * kBK / 4 / kThreads; ++i) {
        int r, kk;
        SB::coord((tid + i * kThreads) * 4, r, kk);
        const int64_t gn = n0 + r, gk = k0 + kk;
        const int64_t left = TB ? (gn < n ? k_hi - gk : 0)
                                : (gk < k_hi ? n - gn : 0);
        const int valid = static_cast<int>(left < 0 ? 0 : (left > 4 ? 4 : left));
        cp_async16(&sb[s][SB::at(r, kk)],
                   valid ? (TB ? b + gn * ldb + gk : b + gk * ldb + gn) : b,
                   4 * valid);
      }
    } else {
#pragma unroll
      for (int i = 0; i < BN * kBK / kThreads; ++i) {
        int r, kk;
        SB::coord(tid + i * kThreads, r, kk);
        const int64_t gn = n0 + r, gk = k0 + kk;
        const bool ok = gn < n && gk < k_hi;
        cp_async4(&sb[s][SB::at(r, kk)],
                  ok ? (TB ? b + gn * ldb + gk : b + gk * ldb + gn) : b, ok);
      }
    }
  };

  // The running sum over K tiles and its Kahan compensation.
  float acc[MT][NT][4], comp[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = comp[i][j][q] = 0.f;

  const int tiles =
      k_hi > k_lo ? static_cast<int>(ceil_div(k_hi - k_lo, kBK)) : 0;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < tiles) issue(s);
    cp_async_commit();
  }
  for (int kt = 0; kt < tiles; ++kt) {
    cp_async_wait<STAGES - 2>();  // tile kt has landed, for this thread
    __syncthreads();              // for every thread; stage kt - 1 is free
    if (kt + STAGES - 1 < tiles) issue(kt + STAGES - 1);
    cp_async_commit();
    const float* ta = sa[kt % STAGES];
    const float* tb = sb[kt % STAGES];
    float part[MT][NT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) part[i][j][q] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 16) {
      // Fragments (PTX m16n8k16): A rows g, g + 8 and columns 2t, 2t + 1,
      // 2t + 8, 2t + 9; B rows (K) 2t, 2t + 1, 2t + 8, 2t + 9 of column g.
      uint32_t ahi[MT][4], alo[MT][4], bhi[NT][2], blo[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int r = wm + i * 16 + g;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int rr = r + (q & 1) * 8, kk = ks + 2 * t + (q >> 1) * 8;
          split2(ta[SA::at(rr, kk)], ta[SA::at(rr, kk + 1)], ahi[i][q],
                 alo[i][q]);
        }
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int r = wn + j * 8 + g;
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int kk = ks + 2 * t + q * 8;
          split2(tb[SB::at(r, kk)], tb[SB::at(r, kk + 1)], bhi[j][q],
                 blo[j][q]);
        }
      }
      // Smallest first: a_lo b_hi, a_hi b_lo, then a_hi b_hi.
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          mma_bf16(part[i][j], alo[i], bhi[j]);
          mma_bf16(part[i][j], ahi[i], blo[j]);
          mma_bf16(part[i][j], ahi[i], bhi[j]);
        }
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float y = part[i][j][q] - comp[i][j][q];
          const float sum = acc[i][j][q] + y;
          comp[i][j][q] = (sum - acc[i][j][q]) - y;
          acc[i][j][q] = sum;
        }
  }
  cp_async_wait<0>();

  // Fragment (i, j): rows g and g + 8, columns 2t and 2t + 1 (local).
  if (split == 1) {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int64_t row = m0 + wm + i * 16 + g + (q >> 1) * 8;
          const int64_t col = n0 + wn + j * 8 + 2 * t + (q & 1);
          if (row < m && col < n)
            c[row * n + col] = finish(acc[i][j][q] - comp[i][j][q], alpha,
                                      beta, row, col);
        }
    return;
  }

  // The cluster's partials, summed in rank order through distributed
  // shared memory: CTA r finishes rows r * BM / split ... of the tile.
  __syncthreads();  // every warp is done with the staged tiles
  float* partial = &sa[0][0];  // BM x (BN + 1)
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int row = wm + i * 16 + g + (q >> 1) * 8;
        const int col = wn + j * 8 + 2 * t + (q & 1);
        partial[row * (BN + 1) + col] = acc[i][j][q] - comp[i][j][q];
      }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int rows = BM / split;
  for (int e = tid; e < rows * BN; e += kThreads) {
    const int lr = rank * rows + e / BN, lc = e % BN;
    const int at = lr * (BN + 1) + lc;
    float v = *cluster.map_shared_rank(partial + at, 0);
    for (int r = 1; r < split; ++r) v += *cluster.map_shared_rank(partial + at, r);
    const int64_t row = m0 + lr, col = n0 + lc;
    if (row < m && col < n) c[row * n + col] = finish(v, alpha, beta, row, col);
  }
  cluster.sync();  // every partial stays until the cluster has read it
}

// Path 2. C (m, n) = alpha op(A) (m, k) B' + beta I, k <= 512, with op(B)
// read by the consumers once (b[l * ldb + j], or b[j * ldb + l] when tb)
// and op(A) by TMA (amap: over A (m rows of k) as given, over the stored
// (k, m) when TA). Block b keeps column slice b % slices (BN columns) and
// walks row tiles b / slices, + groups, ...
template <bool TA, int BN>
__global__ void __launch_bounds__(kRowThreads, 1)
    mm_bf16x3_rows(const __grid_constant__ CUtensorMap amap,
                   const float* __restrict__ b, int64_t ldb, bool tb,
                   float* __restrict__ c, int m, int n, int k, int kchunks,
                   int slices, float alpha, float beta) {
  // 1,024-byte aligned for the 128-byte swizzle, and taken as it is (an
  // integer align-up would turn every shared access generic).
  extern __shared__ __align__(1024) uint8_t base[];
  const int piece_bytes = kchunks * BN * 128;
  uint8_t* bres = base;  // [hi, lo][kchunk][BN rows of 128 bytes]
  uint8_t* ring = base + 2 * piece_bytes;  // [stage][128 x 32 float32]
  uint8_t* aops = ring + kRowStages * kRawBytes;  // [set][hi, lo][128 x 64 B]
  uint64_t* full = reinterpret_cast<uint64_t*>(aops + 4 * kPieceBytes);
  uint64_t* empty = full + kRowStages;

  const int slice = static_cast<int>(blockIdx.x % slices);
  const int64_t group = blockIdx.x / slices;
  const int64_t groups = gridDim.x / slices;
  const int64_t row_tiles = ceil_div(m, kRowTile);
  const int kstages = static_cast<int>(ceil_div(k, kStageK));
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kRowStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kRowConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= kRowConsumers) {  // the producer warp
    if (tid == kRowConsumers) {
      int64_t it = 0;
      for (int64_t tile = group; tile < row_tiles; tile += groups) {
        const int row0 = static_cast<int>(tile * kRowTile);
        for (int s = 0; s < kstages; ++s, ++it) {
          const int slot = static_cast<int>(it % kRowStages);
          if (it >= kRowStages)
            mbar_wait(&empty[slot], ((it / kRowStages) & 1) ^ 1);
          mbar_arrive_expect_tx(&full[slot], kRawBytes);
          uint8_t* dst = ring + slot * kRawBytes;
          if (TA) {
            for (int q = 0; q < kRowTile / 32; ++q)
              tma_load_2d(dst + q * 4096, &amap, row0 + 32 * q, s * kStageK,
                          &full[slot]);
          } else {
            tma_load_2d(dst, &amap, s * kStageK, row0, &full[slot]);
          }
        }
      }
    }
    return;
  }

  // B's slice, split once: 16-byte chunk kc8 (8 values of K) of output
  // column nl goes to row nl of K chunk kc8 / 8, swizzled.
  for (int i = tid; i < BN * kchunks * 8; i += kRowConsumers) {
    const int nl = i % BN, kc8 = i / BN;
    const int64_t col = static_cast<int64_t>(slice) * BN + nl;
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int64_t kk = static_cast<int64_t>(kc8) * 8 + j;
      v[j] = col < n && kk < k ? (tb ? b[col * ldb + kk] : b[kk * ldb + col])
                               : 0.f;
    }
    uint4 hi, lo;
    split8(v, hi, lo);
    const int off = (kc8 / 8) * BN * 128 + nl * 128 + (((kc8 % 8) ^ (nl & 7)) << 4);
    *reinterpret_cast<uint4*>(bres + off) = hi;
    *reinterpret_cast<uint4*>(bres + piece_bytes + off) = lo;
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  named_barrier_sync(1, kRowConsumers);

  const int wg = tid / 128;  // rows 64 wg ... of each tile
  const int wt = tid % 128;
  const int lane = tid % 32;
  // The tile's sum, and the products of the stage in flight (0 before a
  // tile's first stage, so that each stage adds them unconditionally).
  float total[BN / 2], part[BN / 2];
  int64_t it = 0;
  for (int64_t tile = group; tile < row_tiles; tile += groups) {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) total[i] = part[i] = 0.f;
    for (int s = 0; s < kstages; ++s, ++it) {
      const int slot = static_cast<int>(it % kRowStages);
      uint8_t* hi_op = aops + (it & 1) * 2 * kPieceBytes;
      uint8_t* lo_op = hi_op + kPieceBytes;
      mbar_wait(&full[slot], (it / kRowStages) & 1);
      // This warpgroup's 64 rows, as (row, 8-deep chunk) items: read from
      // the raw stage in the 128-byte swizzle TMA wrote, split, stored
      // K-major in the 64-byte swizzle (chunk ^ (row / 2) % 4).
      const uint8_t* raw = ring + slot * kRawBytes;
#pragma unroll 1
      for (int q = 0; q < 2; ++q) {
        const int i = wt + q * 128;
        float v[8];
        int r, cc;
        if (TA) {  // [4][32 k][32 m] boxes: lanes walk rows
          r = wg * 64 + i % 64;
          cc = i / 64;
          const uint8_t* box = raw + (r / 32) * 4096;
          const int mm = r % 32;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int kk = 8 * cc + j;
            v[j] = *reinterpret_cast<const float*>(
                box + kk * 128 + (((mm >> 2) ^ (kk & 7)) << 4) + (mm & 3) * 4);
          }
        } else {   // [128 m][32 k]: lanes walk chunks, then rows
          r = wg * 64 + i / 4;
          cc = i % 4;
          const uint8_t* row = raw + r * 128;
          const float4 x0 = *reinterpret_cast<const float4*>(
              row + (((2 * cc) ^ (r & 7)) << 4));
          const float4 x1 = *reinterpret_cast<const float4*>(
              row + (((2 * cc + 1) ^ (r & 7)) << 4));
          v[0] = x0.x; v[1] = x0.y; v[2] = x0.z; v[3] = x0.w;
          v[4] = x1.x; v[5] = x1.y; v[6] = x1.z; v[7] = x1.w;
        }
        uint4 hi, lo;
        split8(v, hi, lo);
        const int off = r * 64 + ((cc ^ ((r >> 1) & 3)) << 4);
        *reinterpret_cast<uint4*>(hi_op + off) = hi;
        *reinterpret_cast<uint4*>(lo_op + off) = lo;
      }
      mbar_arrive(&empty[slot]);  // the raw stage is free for the producer
      // The generic-proxy stores become visible to wgmma (async proxy).
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      wgmma_wait<0>();  // this warpgroup's stage before: its set is free
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) total[i] += part[i];
      named_barrier_sync(2 + wg, 128);  // this warpgroup's pieces complete
      const uint64_t da_hi = operand_desc_sw64(hi_op + wg * 64 * 64);
      const uint64_t da_lo = operand_desc_sw64(lo_op + wg * 64 * 64);
      const uint64_t db_hi = operand_desc(bres + (s / 2) * BN * 128);
      const uint64_t db_lo = operand_desc(bres + piece_bytes + (s / 2) * BN * 128);
      const int kb = (s % 2) * 2;  // this stage's 32-byte steps in the row
      wgmma_fence();
#pragma unroll
      for (int k16 = 0; k16 < kStageK / 16; ++k16) {
        wgmma_bf16(part, da_lo + 2 * k16, db_hi + 2 * (kb + k16), k16 > 0);
        wgmma_bf16(part, da_hi + 2 * k16, db_lo + 2 * (kb + k16), 1);
        wgmma_bf16(part, da_hi + 2 * k16, db_hi + 2 * (kb + k16), 1);
      }
      wgmma_commit();
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) total[i] += part[i];

    // Fragment of m64nBN: warp w4 of the warpgroup holds rows 16 w4 +
    // lane / 4 (+ 8); total[4i .. 4i + 3] are columns 8i + 2 (lane % 4)
    // (+ 1) of those rows.
    const int64_t row0 = tile * kRowTile + wg * 64 + (wt / 32) * 16 + lane / 4;
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      const int64_t col = static_cast<int64_t>(slice) * BN + 8 * i + 2 * (lane % 4);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int64_t row = row0 + 8 * h;
        if (row < m && col < n)  // n is even: both columns or neither
          *reinterpret_cast<float2*>(&c[row * n + col]) = make_float2(
              finish(total[4 * i + 2 * h], alpha, beta, row, col),
              finish(total[4 * i + 2 * h + 1], alpha, beta, row, col + 1));
      }
    }
  }
}

// Path 3. A whole coupled Newton-Schulz inverse square root in one
// cooperative launch (mm_bf16x3_ns): from A (C x C, float32), Y_0 = A and
// Z_0 = I, each of `iters` iterations T = 1.5 I - 0.5 Z Y, Y <- Y T,
// Z <- T Z (the last Y skipped: Z does not read it); Z out in float32;
// C = 64, 128 or 256, the widths the configurations whiten at.
// Every product is computed element by element as path 1 computes it at
// C <= 256 (32 x 32 tiles, four warps of 16 x 16, K not split): the same
// mma.sync fragments in the same order, a fresh accumulator a 32-deep K
// tile, Kahan's compensation over the tiles in K order, the same epilogue.
// So Z has the bits of the chain of 44 path-1 launches it replaces,
// whatever the grid. What the launch saves is the chain's latency: each of
// those launches waits for the one before, and at C = 256 one takes
// ~5.5 us in a graph where its bytes take 0.23 us.
// The design: every block co-resident (cudaLaunchCooperativeKernel), a
// grid-wide barrier between dependent stages, two stages an iteration: T
// (C^2 / 1,024 tiles), then Y T and T Z side by side (twice the tiles;
// both read T). The matrices live in a workspace in L2, each as its bf16
// pieces, hi and lo, as stored and transposed: a stage's epilogue splits
// its output once, and every tile that reads it copies the pieces
// (cp.async.cg, through L2, never a stale L1 line) with no conversion. A
// block has two groups of four warps; each copies and multiplies one half
// of K (both operands, a K tile per commit group, each multiplied as it
// lands), the second hands its K tiles' sums to the first through shared
// memory, and the first adds them in K order. The operand of a block's
// Y T or T Z tile that the T stage does not write (Y or Z) is copied
// before the barrier that ends the T stage.
// Measured and not kept (PERF.md): in place of the barriers, counts of
// the tiles done in each row and column block that a tile polls for
// (atomics, or a flag a warp; with and without back-off: as fast at
// C = 256); TMA bulk copies in place of cp.async (slower: the proxy
// fences); one group of four warps over all of K (10 % slower), or four
// groups on a quarter each (13 % slower).
constexpr int kNsThreads = 256;  // two groups of four warps
constexpr int kNsPad = 8;        // bf16 of padding a staged row
constexpr int kNsWidths = 3;     // C = 64, 128, 256 (KT = 2, 4, 8 K tiles)
constexpr int kNsMatrices = 5;   // Y twice, Z twice, T

// One matrix of the iteration as its bf16 pieces, C x C each: hi and lo as
// stored (row-major), and their transposes (a right operand's columns).
struct Pieces {
  __nv_bfloat16* hi;
  __nv_bfloat16* lo;
  __nv_bfloat16* hi_t;
  __nv_bfloat16* lo_t;
};

__device__ __forceinline__ Pieces pieces_at(__nv_bfloat16* ws, int index,
                                            int64_t cc) {
  __nv_bfloat16* p = ws + index * 4 * cc;
  return {p, p + cc, p + 2 * cc, p + 3 * cc};
}

// cp.async.wait_group with a count known once the loop is unrolled.
__device__ __forceinline__ void cp_async_wait_n(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    default: cp_async_wait<3>(); break;
  }
}

// K tile kt of one operand of a tile into its staged rows (C + kNsPad
// wide), one 16-byte chunk of each piece for each of 128 threads (`i`):
// the left operand's rows r0 ... r0 + 31 (as stored), or the right
// operand's columns r0 ... (its transposes' rows).
template <int KT>
__device__ __forceinline__ void ns_issue(uint8_t* smem, bool left,
                                         const Pieces& x, int r0, int kt,
                                         int i) {
  constexpr int C = 32 * KT, LD = C + kNsPad;
  __nv_bfloat16* s_hi = reinterpret_cast<__nv_bfloat16*>(smem) +
                        (left ? 0 : 2 * 32 * LD);
  const int r = i / 4, chunk = i % 4;
  const int64_t src = static_cast<int64_t>(r0 + r) * C + kt * 32 + chunk * 8;
  const int dst = r * LD + kt * 32 + chunk * 8;
  cp_async16(s_hi + dst, (left ? x.hi : x.hi_t) + src, 16);
  cp_async16(s_hi + 32 * LD + dst, (left ? x.lo : x.lo_t) + src, 16);
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// The pieces of the pair (x0, x1) at (row, col), (row, col + 1) of `out`,
// as stored and transposed.
__device__ __forceinline__ void ns_store_pair(const Pieces& out, int c,
                                              int row, int col, float x0,
                                              float x1) {
  uint32_t hi, lo;
  split2(x0, x1, hi, lo);
  const int64_t at = static_cast<int64_t>(row) * c + col;
  *reinterpret_cast<uint32_t*>(out.hi + at) = hi;
  *reinterpret_cast<uint32_t*>(out.lo + at) = lo;
  const int64_t at_t = static_cast<int64_t>(col) * c + row;
  uint16_t* hi_t = reinterpret_cast<uint16_t*>(out.hi_t);
  uint16_t* lo_t = reinterpret_cast<uint16_t*>(out.lo_t);
  hi_t[at_t] = static_cast<uint16_t>(hi);
  hi_t[at_t + c] = static_cast<uint16_t>(hi >> 16);
  lo_t[at_t] = static_cast<uint16_t>(lo);
  lo_t[at_t + c] = static_cast<uint16_t>(lo >> 16);
}

// Output tile (tm, tn) of alpha A B + beta I from the pieces of A and B,
// into `out`'s pieces or, where `out32` is set, as float32. Group 0 of
// the block takes K tiles 0 ... H - 1, group 1 the other H. `issued`: 0,
// or the operand ns_prefetch has copied already (1 A, 2 B).
template <int KT>
__device__ void ns_tile(const Pieces& a, const Pieces& b, int tm, int tn,
                        float alpha, float beta, const Pieces& out,
                        float* out32, uint8_t* smem, int issued) {
  static_assert(KT % 2 == 0, "two groups on equal halves of K");
  constexpr int C = 32 * KT, LD = C + kNsPad, H = KT / 2;
  const __nv_bfloat16* sa_hi = reinterpret_cast<__nv_bfloat16*>(smem);
  const __nv_bfloat16* sa_lo = sa_hi + 32 * LD;
  const __nv_bfloat16* sb_hi = sa_lo + 32 * LD;
  const __nv_bfloat16* sb_lo = sb_hi + 32 * LD;
  float* handed = reinterpret_cast<float*>(smem + 4 * 32 * LD * 2);
  const int m0 = tm * 32, n0 = tn * 32;
  const int tid = threadIdx.x, group = tid / 128, gi = tid % 128;
  const int lane = tid & 31, warp = gi >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp / 2) * 16, wn = (warp % 2) * 16;
  const int k_lo = group == 0 ? 0 : H;
  __syncthreads();  // the last tile's sums are read
  // Every thread commits H groups here (after ns_prefetch's H), so that
  // its K tile i of both operands has landed once at most H - 1 - i are
  // left.
#pragma unroll
  for (int i = 0; i < H; ++i) {
    if (issued != 1) ns_issue<KT>(smem, true, a, m0, k_lo + i, gi);
    if (issued != 2) ns_issue<KT>(smem, false, b, n0, k_lo + i, gi);
    cp_async_commit();
  }

  float acc[2][4], comp[2][4];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[j][q] = comp[j][q] = 0.f;
  auto kahan = [&](const float (&part)[2][4]) {
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float y = part[j][q] - comp[j][q];
        const float sum = acc[j][q] + y;
        comp[j][q] = (sum - acc[j][q]) - y;
        acc[j][q] = sum;
      }
  };
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const int kt = k_lo + i;
    cp_async_wait_n(H - 1 - i);
    named_barrier_sync(1 + group, 128);
    float part[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) part[j][q] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 16) {
      // Path 1's fragments (PTX m16n8k16), the pieces read as they lie.
      const int k0 = kt * kBK + ks + 2 * t;
      uint32_t ahi[4], alo[4], bhi[2][2], blo[2][2];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int at = (wm + g + (q & 1) * 8) * LD + k0 + (q >> 1) * 8;
        ahi[q] = lds32(sa_hi + at);
        alo[q] = lds32(sa_lo + at);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int at = (wn + j * 8 + g) * LD + k0 + q * 8;
          bhi[j][q] = lds32(sb_hi + at);
          blo[j][q] = lds32(sb_lo + at);
        }
      // Smallest first: a_lo b_hi, a_hi b_lo, then a_hi b_hi.
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        mma_bf16(part[j], alo, bhi[j]);
        mma_bf16(part[j], ahi, blo[j]);
        mma_bf16(part[j], ahi, bhi[j]);
      }
    }
    if (group == 0) {
      kahan(part);
    } else {
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          handed[(i * 8 + j * 4 + q) * 128 + gi] = part[j][q];
    }
  }
  __syncthreads();  // the second half's sums handed over; staging free
  if (group != 0) return;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    float part[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        part[j][q] = handed[(i * 8 + j * 4 + q) * 128 + gi];
    kahan(part);
  }

  // Fragment j: rows g and g + 8 (h), columns 2t and 2t + 1.
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm + g + h * 8, col = n0 + wn + j * 8 + 2 * t;
      const float v0 = finish(acc[j][2 * h] - comp[j][2 * h], alpha, beta,
                              row, col);
      const float v1 = finish(acc[j][2 * h + 1] - comp[j][2 * h + 1], alpha,
                              beta, row, col + 1);
      if (out32 != nullptr)
        *reinterpret_cast<float2*>(out32 + static_cast<int64_t>(row) * C +
                                   col) = make_float2(v0, v1);
      else
        ns_store_pair(out, C, row, col, v0, v1);
    }
}

// This thread's group's half of K of one operand of a tile, a commit group
// a K tile, before the tile's ns_tile: the left operand's rows r0 ..., or
// the right operand's columns r0 ....
template <int KT>
__device__ __forceinline__ void ns_prefetch(uint8_t* smem, bool left,
                                            const Pieces& x, int r0) {
  constexpr int H = KT / 2;
  const int group = threadIdx.x / 128, gi = threadIdx.x % 128;
  const int k_lo = group == 0 ? 0 : H;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    ns_issue<KT>(smem, left, x, r0, k_lo + i, gi);
    cp_async_commit();
  }
}

// z (C x C) = the iteration's Z after `iters` (>= 1) iterations from a
// (C x C, row-major), C = 32 KT. ws: kNsMatrices x 4 x C x C bf16.
template <int KT>
__global__ void __launch_bounds__(kNsThreads, 1)
    mm_bf16x3_ns(const float* __restrict__ a, __nv_bfloat16* ws,
                 float* __restrict__ z, int iters) {
  constexpr int C = 32 * KT, TT = KT * KT;
  constexpr int64_t cc = static_cast<int64_t>(C) * C;
  extern __shared__ __align__(16) uint8_t ns_smem[];
  cg::grid_group grid = cg::this_grid();
  Pieces y = pieces_at(ws, 0, cc), y_next = pieces_at(ws, 1, cc);
  Pieces zp = pieces_at(ws, 2, cc), z_next = pieces_at(ws, 3, cc);
  const Pieces tp = pieces_at(ws, 4, cc);

  // Y_0 = A and Z_0 = I, as pieces.
  const int64_t gstride = static_cast<int64_t>(gridDim.x) * kNsThreads;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * kNsThreads +
                   threadIdx.x;
       e < cc / 2; e += gstride) {
    const int row = static_cast<int>(e / (C / 2));
    const int col = static_cast<int>(2 * (e % (C / 2)));
    ns_store_pair(y, C, row, col, a[row * C + col], a[row * C + col + 1]);
    ns_store_pair(zp, C, row, col, row == col ? 1.f : 0.f,
                  row == col + 1 ? 1.f : 0.f);
  }
  grid.sync();

  for (int it = 0; it < iters; ++it) {
    const bool last = it == iters - 1;
    // T = 1.5 I - 0.5 Z Y.
    for (int job = blockIdx.x; job < TT; job += gridDim.x)
      ns_tile<KT>(zp, y, job / KT, job % KT, -0.5f, 1.5f, tp, nullptr,
                  ns_smem, 0);
    // T Z (the first TT jobs), then Y T (none in the last iteration); the
    // operand of this block's first one that T does not write, now.
    const int jobs = last ? TT : 2 * TT;
    int issued = 0;
    if (static_cast<int>(blockIdx.x) < jobs) {
      const int job = blockIdx.x;
      __syncthreads();  // the T tile's staging is free
      if (job < TT) {
        ns_prefetch<KT>(ns_smem, false, zp, (job % KT) * 32);
        issued = 2;
      } else {
        ns_prefetch<KT>(ns_smem, true, y, ((job - TT) / KT) * 32);
        issued = 1;
      }
    }
    grid.sync();
    for (int job = blockIdx.x; job < jobs; job += gridDim.x) {
      const int tm = (job % TT) / KT, tn = job % KT;
      const int pre = job == static_cast<int>(blockIdx.x) ? issued : 0;
      if (job < TT)
        ns_tile<KT>(tp, zp, tm, tn, 1.f, 0.f, z_next, last ? z : nullptr,
                    ns_smem, pre);
      else
        ns_tile<KT>(y, tp, tm, tn, 1.f, 0.f, y_next, nullptr, ns_smem, pre);
    }
    const Pieces y_old = y, z_old = zp;
    y = y_next;
    y_next = y_old;
    zp = z_next;
    z_next = z_old;
    if (!last) grid.sync();
  }
}

// --- host side -------------------------------------------------------------

// Dynamic shared memory of the fused Newton-Schulz launch: both operands'
// pieces, 32 rows of C + kNsPad each, then the second group's K-tile sums
// (32 x 32 floats each).
constexpr int ns_smem_bytes(int kt) {
  return 4 * 32 * (32 * kt + kNsPad) * 2 + (kt / 2) * 32 * 32 * 4;
}

// Dynamic shared memory of the row path: B's two pieces, the ring, two
// sets of A's two pieces, the barriers.
int rows_smem_bytes(int kchunks, int bn) {
  return 2 * kchunks * bn * 128 + kRowStages * kRawBytes + 4 * kPieceBytes +
         2 * kRowStages * 8;
}
constexpr int kRowsMaxSmem = 2 * 4 * 128 * 128 + kRowStages * kRawBytes +
                             4 * kPieceBytes + 2 * kRowStages * 8;
static_assert(kRowsMaxSmem <= 232448, "the row path's shared memory");

struct DeviceInfo {
  bool ready = false;
  int sms = 0;
  // The fused Newton-Schulz launch's grid at C = 64, 128, 256: its largest
  // stage's tiles, or as many blocks as the card holds at once.
  int ns_grid[kNsWidths] = {};
};
DeviceInfo g_devices[kMaxDevices];

// Once per device, outside any capture when called at load: the row and
// fused Newton-Schulz kernels' opt-in to more than 48 KB of dynamic shared
// memory, the device's SM count and the fused launch's grids.
cudaError_t prepare(DeviceInfo** out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  DeviceInfo& d = g_devices[dev];
  if (!d.ready) {
    err = cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    const void* kernels[] = {
        reinterpret_cast<const void*>(mm_bf16x3_rows<false, 128>),
        reinterpret_cast<const void*>(mm_bf16x3_rows<true, 128>),
        reinterpret_cast<const void*>(mm_bf16x3_rows<false, 64>),
        reinterpret_cast<const void*>(mm_bf16x3_rows<true, 64>)};
    for (const void* kernel : kernels) {
      err = cudaFuncSetAttribute(kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kRowsMaxSmem);
      if (err != cudaSuccess) return err;
    }
    const void* ns_kernels[kNsWidths] = {
        reinterpret_cast<const void*>(mm_bf16x3_ns<2>),
        reinterpret_cast<const void*>(mm_bf16x3_ns<4>),
        reinterpret_cast<const void*>(mm_bf16x3_ns<8>)};
    for (int w = 0; w < kNsWidths; ++w) {
      const int kt = 2 << w;
      err = cudaFuncSetAttribute(ns_kernels[w],
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 ns_smem_bytes(kt));
      if (err != cudaSuccess) return err;
      int per_sm = 0;
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, ns_kernels[w], kNsThreads, ns_smem_bytes(kt));
      if (err != cudaSuccess) return err;
      d.ns_grid[w] = per_sm * d.sms < 2 * kt * kt ? per_sm * d.sms
                                                  : 2 * kt * kt;
    }
    d.ready = true;
  }
  if (out != nullptr) *out = &d;
  return cudaSuccess;
}

// The path for a shape: the row path (wgmma, TMA) where its 128-row tiles
// fill the card, K fits resident B (<= 512), N is even and A's rows lie on
// 16-byte boundaries (TMA's rule); else the split-K path, whose tile edge
// and cluster size follow the tile count and K.
struct Plan {
  bool rows;
  int tile;   // split-K: 32 or 64; rows: BN
  int split;  // split-K: CTAs a cluster
};

Plan plan_for(const float* a, int64_t lda, int m, int n, int k, int sms) {
  Plan p{};
  const int bn = k <= 256 ? 128 : 64;
  const bool tma_ok = reinterpret_cast<uintptr_t>(a) % 16 == 0 && lda % 4 == 0;
  if (tma_ok && k >= 16 && k <= kMaxRowK && n % 2 == 0 &&
      ceil_div(m, kRowTile) * ceil_div(n, bn) >= sms) {
    p.rows = true;
    p.tile = bn;
    p.split = 1;
    return p;
  }
  p.rows = false;
  const int64_t tiles64 = ceil_div(m, 64) * ceil_div(n, 64);
  p.tile = tiles64 >= 64 ? 64 : 32;
  const int64_t tiles = p.tile == 64 ? tiles64 : ceil_div(m, 32) * ceil_div(n, 32);
  // K is split only where a CTA would walk more than kSplitTiles K tiles
  // (C = 512, K = R): at C <= 256 the cluster's reduction costs more than
  // the shorter walk saves. Then as many CTAs a tile as keep the grid
  // within one wave (one 64 x 64 CTA an SM, two 32 x 32 ones) or, where K
  // is long, up to the cluster limit.
  const int64_t wave = p.tile == 64 ? sms : 2 * sms;
  p.split = 1;
  while (p.split < kMaxSplit && k > kSplitTiles * kBK * p.split &&
         (tiles * 2 * p.split <= wave || k >= 64 * kBK * 2 * p.split))
    p.split *= 2;
  return p;
}

template <typename Kernel, typename... Args>
cudaError_t launch_ex(Kernel kernel, dim3 grid, dim3 block, int smem,
                      cudaStream_t stream, int cluster, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  cudaLaunchAttribute attrs[1];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = static_cast<unsigned>(cluster);
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

template <int BM, int BN, int WARPS_M, int WARPS_N, int STAGES>
cudaError_t launch_splitk(const float* a, bool ta, int64_t lda,
                          const float* b, bool tb, int64_t ldb, float* c,
                          int m, int n, int k, int split, float alpha,
                          float beta, cudaStream_t stream) {
  const dim3 block(32 * WARPS_M * WARPS_N);
  // 16-byte copies need every row (column, transposed) of the operand on a
  // 16-byte boundary.
  const bool va = reinterpret_cast<uintptr_t>(a) % 16 == 0 && lda % 4 == 0;
  const bool vb = reinterpret_cast<uintptr_t>(b) % 16 == 0 && ldb % 4 == 0;
  const dim3 grid(static_cast<unsigned>(split * ceil_div(m, BM)),
                  static_cast<unsigned>(ceil_div(n, BN)));
  const int k_slab = static_cast<int>(ceil_div(ceil_div(k, split), kBK) * kBK);
  if (ta && tb)
    return launch_ex(mm_bf16x3_splitk<BM, BN, WARPS_M, WARPS_N, STAGES, true, true>,
                     grid, block, 0, stream, split, a, lda, b, ldb, c, m, n,
                     k, split, k_slab, va, vb, alpha, beta);
  if (ta)
    return launch_ex(mm_bf16x3_splitk<BM, BN, WARPS_M, WARPS_N, STAGES, true, false>,
                     grid, block, 0, stream, split, a, lda, b, ldb, c, m, n,
                     k, split, k_slab, va, vb, alpha, beta);
  if (tb)
    return launch_ex(mm_bf16x3_splitk<BM, BN, WARPS_M, WARPS_N, STAGES, false, true>,
                     grid, block, 0, stream, split, a, lda, b, ldb, c, m, n,
                     k, split, k_slab, va, vb, alpha, beta);
  return launch_ex(mm_bf16x3_splitk<BM, BN, WARPS_M, WARPS_N, STAGES, false, false>,
                   grid, block, 0, stream, split, a, lda, b, ldb, c, m, n, k,
                   split, k_slab, va, vb, alpha, beta);
}

template <bool TA, int BN>
cudaError_t launch_rows(const float* a, int64_t lda, const float* b, bool tb,
                        int64_t ldb, float* c, int m, int n, int k, int sms,
                        float alpha, float beta, cudaStream_t stream) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  // As given: {K, M} in 32 x 128 boxes; transposed: the stored {M, K} in
  // 32 x 32 boxes. Rows 128 bytes wide, in the 128-byte swizzle.
  CUtensorMap amap;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(TA ? m : k),
                              static_cast<cuuint64_t>(TA ? k : m)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(lda) * 4};
  const cuuint32_t box[2] = {32, TA ? 32u : static_cast<cuuint32_t>(kRowTile)};
  const cuuint32_t elem_strides[2] = {1, 1};
  if (encode(&amap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(a),
             dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  const int kchunks = static_cast<int>(ceil_div(k, 64));
  const int slices = static_cast<int>(ceil_div(n, BN));
  int64_t groups = sms / slices > 0 ? sms / slices : 1;
  const int64_t row_tiles = ceil_div(m, kRowTile);
  if (groups > row_tiles) groups = row_tiles;
  return launch_ex(mm_bf16x3_rows<TA, BN>,
                   dim3(static_cast<unsigned>(groups * slices)),
                   dim3(kRowThreads), rows_smem_bytes(kchunks, BN), stream, 1,
                   amap, b, ldb, tb, c, m, n, k, kchunks, slices, alpha, beta);
}

template <int KT>
cudaError_t launch_ns(const float* a, __nv_bfloat16* ws, float* z, int iters,
                      int grid, cudaStream_t stream) {
  if (grid < 1) return cudaErrorCooperativeLaunchTooLarge;
  void* params[] = {&a, &ws, &z, &iters};
  return cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(mm_bf16x3_ns<KT>), dim3(grid),
      dim3(kNsThreads), params, static_cast<size_t>(ns_smem_bytes(KT)),
      stream);
}

}  // namespace

extern "C" {

// Sets the row kernels' shared-memory opt-in on the current device; the
// wrapper calls it when the library loads, and wcgan_mm_bf16x3 on a device
// it has not seen. Returns a cudaError_t.
int wcgan_mm_bf16x3_prepare() { return static_cast<int>(prepare(nullptr)); }

// The path wcgan_mm_bf16x3 takes for these arguments on the current device:
// out[0] = 1 for the row path (wgmma, TMA), 0 for split-K; out[1] its tile
// (split-K: BM = BN) or column slice (rows: BN); out[2] the CTAs a cluster.
int wcgan_mm_bf16x3_plan(const float* a, int64_t lda, int m, int n, int k,
                         int* out) {
  DeviceInfo* d = nullptr;
  const cudaError_t err = prepare(&d);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Plan p = plan_for(a, lda, m, n, k, d->sms);
  out[0] = p.rows ? 1 : 0;
  out[1] = p.tile;
  out[2] = p.split;
  return 0;
}

// c (m, n) = alpha op(a) (m, k) op(b) (k, n) + beta I, all float32; c
// row-major and contiguous. trans_a: a is stored (k, m) with leading
// dimension lda, else (m, k); trans_b: b is stored (n, k) with leading
// dimension ldb, else (k, n). 1 <= m, n < 2^31 (n / 32 blocks < 65,536),
// 0 <= k < 2^31. Enqueues on `stream`; returns the launch's cudaError_t.
int wcgan_mm_bf16x3(const float* a, int trans_a, int64_t lda, const float* b,
                    int trans_b, int64_t ldb, float* c, int m, int n, int k,
                    float alpha, float beta, cudaStream_t stream) {
  if (m < 1 || n < 1 || k < 0 || ceil_div(n, 32) > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  DeviceInfo* d = nullptr;
  cudaError_t err = prepare(&d);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool ta = trans_a != 0, tb = trans_b != 0;
  const Plan p = plan_for(a, lda, m, n, k, d->sms);
  if (p.rows && p.tile == 128)
    err = ta ? launch_rows<true, 128>(a, lda, b, tb, ldb, c, m, n, k, d->sms,
                                      alpha, beta, stream)
             : launch_rows<false, 128>(a, lda, b, tb, ldb, c, m, n, k,
                                       d->sms, alpha, beta, stream);
  else if (p.rows)
    err = ta ? launch_rows<true, 64>(a, lda, b, tb, ldb, c, m, n, k, d->sms,
                                     alpha, beta, stream)
             : launch_rows<false, 64>(a, lda, b, tb, ldb, c, m, n, k, d->sms,
                                      alpha, beta, stream);
  else if (p.tile == 64)
    err = launch_splitk<64, 64, 2, 4, 2>(a, ta, lda, b, tb, ldb, c, m, n, k,
                                         p.split, alpha, beta, stream);
  else
    err = launch_splitk<32, 32, 2, 2, 4>(a, ta, lda, b, tb, ldb, c, m, n, k,
                                         p.split, alpha, beta, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Bytes of the fused Newton-Schulz launch's workspace at width c.
int64_t wcgan_mm_bf16x3_ns_workspace_bytes(int c) {
  return static_cast<int64_t>(kNsMatrices) * 4 * c * c * 2;
}

// z (c x c) = Z after `iters` coupled Newton-Schulz iterations from a
// (c x c), both float32, row-major and contiguous, in one cooperative
// launch, bit-equal to the chain of wcgan_mm_bf16x3 calls (T with alpha
// -0.5 and beta 1.5, then Y T and T Z). c 64, 128 or 256; iters >= 1;
// ws wcgan_mm_bf16x3_ns_workspace_bytes(c) bytes, 16-byte aligned.
// Enqueues on `stream`; returns the launch's cudaError_t.
int wcgan_mm_bf16x3_ns(const float* a, int c, int iters, void* ws, float* z,
                       cudaStream_t stream) {
  if ((c != 64 && c != 128 && c != 256) || iters < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  DeviceInfo* d = nullptr;
  cudaError_t err = prepare(&d);
  if (err != cudaSuccess) return static_cast<int>(err);
  __nv_bfloat16* w = static_cast<__nv_bfloat16*>(ws);
  if (c == 64)
    err = launch_ns<2>(a, w, z, iters, d->ns_grid[0], stream);
  else if (c == 128)
    err = launch_ns<4>(a, w, z, iters, d->ns_grid[1], stream);
  else
    err = launch_ns<8>(a, w, z, iters, d->ns_grid[2], stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
