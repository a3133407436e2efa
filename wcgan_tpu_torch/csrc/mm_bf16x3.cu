// K3: C = op(A) op(B) in float32 as three bf16 tensor-core products (the
// "bf16x3" emulation of a float32 product), for Hopper (sm_90a).
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
// rows, columns and depth past the edges load 0 and are not stored.
//
// What bounds it on an H100 (SXM, 700 W). The whitening's products are
// small: at C = 256 a Newton-Schulz product moves 786 KB (A, B read once, C
// written once: 0.23 us at 3.35 TB/s) and does 1.0e8 flop (three bf16
// products of 2 C^3: 0.10 us at 989 TFLOP/s). Neither is what it takes:
// such a product is bound by latency (the launch, the first loads from L2,
// the accumulator chain over K), and the 2,499 products of one headline
// step under 'high' run back to back, each waiting for the one before. The
// row products (R x C x C, R up to 131,072, K1's backward and float32
// whiten_apply) are bound by bytes: 268 MB at R = 131,072, C = 256.
//
// What the design does about it, kept simple (one launch a product, no
// workspace, no atomics: two calls give the same bits):
// - Output tiles are 64 x 64 (eight warps, each 32 x 16), or 32 x 32
//   (four warps, each 16 x 16) where 64 x 64 would give fewer blocks than
//   the card has SMs (every product at C <= 512), so that a small product
//   spreads over more SMs. The warps run mma.sync m16n8k16 (bf16 in,
//   float32 accumulators).
// - K is walked in 32-deep tiles, staged as float32 in shared memory by
//   cp.async, 4 tiles in flight (2 for the 64 x 64 tiles, within the 48 KB
//   of static shared memory), so that the loads of later tiles overlap the
//   products of this one. A warp copies 128 consecutive bytes: 16-byte
//   copies where the operand's rows lie on 16-byte boundaries (every
//   operand of the path), 4-byte copies otherwise; the ragged edge is
//   zero-filled by the copy itself.
// - The split is done in registers as each warp reads its fragments from
//   the staged float32 tile (cvt.rn.bf16x2 on pairs), so A and B are read
//   from memory once, as float32, and no bf16 copy is stored.
// - Per K tile the three terms go into a fresh accumulator, smallest first
//   (a_lo b_hi, a_hi b_lo, then a_hi b_hi, each 16-deep step), which is
//   then added to the running sum in float32 FADDs with Kahan's
//   compensation: the tensor core's own float32 sums truncate, and a chain
//   over all of K would drift (the 32-row stages of K1 restart theirs for
//   the same reason); an uncompensated running sum of K / 32 tiles drifts
//   too where K is long (the plain covariance, K = R: 4,096 tiles at
//   R = 131,072), where float32's own sums drift.
// - A non-finite input gives a non-finite output where the float32 product
//   would: inf splits into hi = inf, lo = inf - inf = NaN.
// Measured and not kept: a first version that prefetched one tile into
// registers and stored the bf16 pieces to shared memory (8.3 us at
// C = 256 and 0.79 ms at R = 131,072 in chip_smoke.py's high phase, where
// torch.matmul in float32 took 8.1 us and 0.38 ms; PERF.md has this
// one's). A C x C product stays bound by latency. TMA rings, wgmma,
// persistence, more blocks per SM for the row products and fusing
// Newton-Schulz's 1.5 I - 0.5 Z Y epilogue are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBK = 32;    // depth of a K tile
constexpr int kSPad = 4;   // floats of padding a staged row
constexpr int kSms = 132;

__host__ __device__ __forceinline__ int64_t ceil_div(int64_t a, int64_t b) {
  return (a + b - 1) / b;
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
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
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

// C (m, n) = op(A) (m, k) op(B) (k, n). op(A)[i][l] is a[i * lda + l], or
// a[l * lda + i] when TA; op(B)[l][j] is b[l * ldb + j], or b[j * ldb + l]
// when TB. A BM x BN tile a block, its warps WARPS_M x WARPS_N over it,
// STAGES K tiles in flight.
template <int BM, int BN, int WARPS_M, int WARPS_N, int STAGES, bool TA,
          bool TB>
__global__ void __launch_bounds__(32 * WARPS_M * WARPS_N)
    mm_bf16x3_kernel(const float* __restrict__ a, int64_t lda,
                     const float* __restrict__ b, int64_t ldb,
                     float* __restrict__ c, int m, int n, int k,
                     bool vec_a, bool vec_b) {
  constexpr int kThreads = 32 * WARPS_M * WARPS_N;
  constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;  // a warp's share
  constexpr int MT = WM / 16, NT = WN / 8;  // its m16 and n8 fragments
  using SA = Staged<BM, !TA>;
  using SB = Staged<BN, TB>;
  __shared__ __align__(16) float sa[STAGES][SA::kFloats];
  __shared__ __align__(16) float sb[STAGES][SB::kFloats];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp / WARPS_N) * WM, wn = (warp % WARPS_N) * WN;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * BM;
  const int64_t n0 = static_cast<int64_t>(blockIdx.y) * BN;

  // Copy K tile kt of op(A) and op(B) into stage kt % STAGES: in 16-byte
  // chunks along the contiguous direction where the operand's rows are
  // 16-byte aligned (vec_a, vec_b), else element by element.
  auto issue = [&](int kt) {
    const int s = kt % STAGES;
    const int64_t k0 = static_cast<int64_t>(kt) * kBK;
    if (vec_a) {
#pragma unroll
      for (int i = 0; i < BM * kBK / 4 / kThreads; ++i) {
        int r, kk;
        SA::coord((tid + i * kThreads) * 4, r, kk);
        const int64_t gm = m0 + r, gk = k0 + kk;
        const int64_t left = TA ? (gk < k ? m - gm : 0)
                                : (gm < m ? k - gk : 0);
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
        const bool ok = gm < m && gk < k;
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
        const int64_t left = TB ? (gn < n ? k - gk : 0)
                                : (gk < k ? n - gn : 0);
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
        const bool ok = gn < n && gk < k;
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

  const int tiles = static_cast<int>(ceil_div(k, kBK));
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

  // Fragment (i, j): rows g and g + 8, columns 2t and 2t + 1.
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int64_t row = m0 + wm + i * 16 + g + (q >> 1) * 8;
        const int64_t col = n0 + wn + j * 8 + 2 * t + (q & 1);
        if (row < m && col < n) c[row * n + col] = acc[i][j][q];
      }
    }
  }
}

template <int BM, int BN, int WARPS_M, int WARPS_N, int STAGES>
void launch(const float* a, bool ta, int64_t lda, const float* b, bool tb,
            int64_t ldb, float* c, int m, int n, int k,
            cudaStream_t stream) {
  constexpr int threads = 32 * WARPS_M * WARPS_N;
  // 16-byte copies need every row (column, transposed) of the operand on a
  // 16-byte boundary.
  const bool va = reinterpret_cast<uintptr_t>(a) % 16 == 0 && lda % 4 == 0;
  const bool vb = reinterpret_cast<uintptr_t>(b) % 16 == 0 && ldb % 4 == 0;
  const dim3 grid(static_cast<unsigned>(ceil_div(m, BM)),
                  static_cast<unsigned>(ceil_div(n, BN)));
  if (ta && tb)
    mm_bf16x3_kernel<BM, BN, WARPS_M, WARPS_N, STAGES, true, true>
        <<<grid, threads, 0, stream>>>(a, lda, b, ldb, c, m, n, k, va, vb);
  else if (ta)
    mm_bf16x3_kernel<BM, BN, WARPS_M, WARPS_N, STAGES, true, false>
        <<<grid, threads, 0, stream>>>(a, lda, b, ldb, c, m, n, k, va, vb);
  else if (tb)
    mm_bf16x3_kernel<BM, BN, WARPS_M, WARPS_N, STAGES, false, true>
        <<<grid, threads, 0, stream>>>(a, lda, b, ldb, c, m, n, k, va, vb);
  else
    mm_bf16x3_kernel<BM, BN, WARPS_M, WARPS_N, STAGES, false, false>
        <<<grid, threads, 0, stream>>>(a, lda, b, ldb, c, m, n, k, va, vb);
}

}  // namespace

extern "C" {

// c (m, n) = op(a) (m, k) op(b) (k, n), all float32; c row-major and
// contiguous. trans_a: a is stored (k, m) with leading dimension lda, else
// (m, k); trans_b: b is stored (n, k) with leading dimension ldb, else
// (k, n). 1 <= m, n < 2^31 (n / 32 blocks < 65,536), 0 <= k < 2^31.
// Enqueues on `stream`; returns the launch's cudaError_t.
int wcgan_mm_bf16x3(const float* a, int trans_a, int64_t lda, const float* b,
                    int trans_b, int64_t ldb, float* c, int m, int n, int k,
                    cudaStream_t stream) {
  if (m < 1 || n < 1 || k < 0 || ceil_div(n, 32) > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (ceil_div(m, 64) * ceil_div(n, 64) >= kSms)
    launch<64, 64, 2, 4, 2>(a, trans_a != 0, lda, b, trans_b != 0, ldb, c, m,
                            n, k, stream);
  else
    launch<32, 32, 2, 2, 4>(a, trans_a != 0, lda, b, trans_b != 0, ldb, c, m,
                            n, k, stream);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
