// Whole-formula elliptic-curve kernels for Hopper (sm_90a): point op, bucket
// column, fold, window combine.
//
// Replaces the JAX package's Pallas TPU kernels in
// `manta_tpu/ops/pallas/point_kernels.py`:
//   - `_point_op` (public `fused_add` / `fused_madd` / `fused_double`): one
//     whole Jacobian add (add-2007-bl), mixed add (madd-2007-bl, Z2 in {0, 1})
//     or double (dbl-2009-l) per lane, with the edge dispatch of
//     `CurveOps._add_dispatch`;
//   - `_column_call` (public `accumulate_columns`): per lane, for k < K,
//     acc = q[k] if head[k] else madd(acc, q[k]), q = infinity where qinf[k],
//     acc written after every step;
//   - `_fold_call` (public `fold_columns`): per lane,
//     A = q[k] if head[k] else add(A, q[k]); B = add(B, A). The TPU kernel
//     writes both streams; this one writes the A stream and, where the caller
//     asks for it, B's last row, the only row of B that the MSM reads
//     (`manta_tpu/ops/msm.py` reads the same rows).
// The combine kernel takes over the point-op launches of the MSM's last
// steps on the fold path (`_weighted_fold_fused`'s window sums and the Horner
// loop over windows of `msm`, about 270 single-lane launches an MSM): the
// TPU program runs those as `_point_op` calls too.
//
// What it computes is bit for bit what the plain versions compute: the field
// ops are `FieldOps<F>` (field_ops.cuh), and every formula of point_ops.cuh
// runs the same field operations on the same operands as
// `manta_tpu_torch/ops/curve.py` (CurveOps.double / add / madd, Fq2Ops.mul /
// sqr), so the lazy [0, 2p) values agree. Fq2 multiplication is Karatsuba-3 (t0 = a0 b0, t1 = a1 b1,
// s = (a0 + a1)(b0 + b1); c0 = t0 − t1, c1 = (s − t0) − t1); squaring is
// (a0 + a1)(a0 − a1) and 2·a0 a1. The TPU kernels compute BLS12-381 Fq in
// 12-bit limbs inside; this kernel uses 32-bit words, which give the same
// integers (Montgomery with R = 2^(16·L) either way). The fold kernel adds
// in another order than the TPU kernel (below), so its Jacobian coordinates
// differ from the JAX package's; the points are the same, and its plain
// versions (`point_kernels.PLAIN`) add in its order.
//
// Design: a point lives in registers as 32-bit words. Coordinates stay
// limb-major (..., L, lanes) int32 at the boundary, so neighbouring threads
// load and store neighbouring words. Any lane count: the tail block is masked
// (the TPU kernels' padding to 128 lanes is not needed). The edge dispatch is
// a per-thread branch: the doubling is computed only in a thread whose lane
// needs it, and the host never waits for the device.
//   - Point op and column: one thread per lane; the column keeps its
//     accumulator in registers across all K steps (the TPU kernels carry it
//     in VMEM scratch across a sequential grid axis).
//   - Fold: a segmented scan (`fold_group`). One thread per lane walking K
//     dependent steps of two complete additions is all latency at the MSM's
//     level-2 shapes (K = 128 over 20 or 40 lanes: one or two warps on the
//     card, 6.5 ms for G1 and 21 ms for G2, against bounds under a
//     microsecond). Here fold_threads(K) threads of one warp share a lane
//     (32 at K = 128, 8 at K = 32, 1 at K < 8): each folds a chunk of 4 to 8
//     steps, the chunk totals are scanned by warp shuffles in log2 T levels,
//     each thread folds its chunk again from the carried total, and B is the
//     pairwise sum of the threads' sums of A. At K = 128 the dependent chain is
//     4 + 5 + 8 + 5 additions instead of 256. A fold's stream (31 MB at most,
//     G2 weighted level 1) was just written by the kernel before it and fits
//     the 50 MB L2, so a step's loads, all in flight together, take well
//     under the microseconds of its addition: no prefetch is issued.
//   - Combine: one block. One launch replaces ~270, each of which cost the
//     host 0.07-0.11 ms to issue. Its time is one chain of ~250 dependent
//     doublings and ~20 additions: on one thread that took 2.1 ms for G1
//     and 10.4 ms for G2 (H100 80GB HBM3, 700 W). So each formula runs
//     spread over the 32 lanes of a warp (`warp_double_to`, `warp_add_to`):
//     every round of its products whose operands are ready is one base-field
//     product per lane, gathered by shuffles — a doubling is 3 rounds instead
//     of 7 products (G1) or 16 (G2), an addition 5 instead of 16 or 44. The
//     8 warps of the block compute the window sums, one window each in turn,
//     into shared memory; warp 0 then runs the Horner chain.
//   - The fold and combine kernels call each formula out of line (`add_to`,
//     `double_to`, `warp_add_to`, `warp_double_to`), so each object compiles
//     it once.
//
// Bound on the H100 (3.35 TB/s HBM; 67 T 32-bit multiply-adds/s, the card's
// non-tensor rate, as the ceiling for integer work). A BN254 G1 mixed add is
// 11 Montgomery products of S = 8 words, 2·S² + S = 136 multiply-adds each
// (a complete add 16, a doubling 7). The column kernel at K = 128 over 10240
// lanes (one G1 MSM of the production prover, 20 windows of 512 lanes) reads
// px, py and writes ox, oy, oz: 5 × 84 MB = 420 MB, 125 µs by bytes, against
// 1.3 M mixed adds = 2.0 G multiply-adds = 3.9 G operations, 58 µs; it is
// bound by bytes because it writes the accumulator after every step, as the
// TPU kernel does. At these lane counts it runs a few warps per SM, each
// thread a chain of dependent products, so expect latency, not either bound,
// to set its time. The fold's least work is K additions for A (fewer where a
// head starts a run) and K for B per lane, and its bytes q and A (6 streams)
// plus B's row: at the G1 level-2 shape (128, 16, 20) 2 × 2560 additions =
// 22 M operations, 0.33 µs, and 1 MB, 0.3 µs. The scan's extra additions
// (about 3K per lane at K = 128) are not in the bound. The combine's least
// work is its ~250 doublings and ~40 additions, 0.06 µs of operations for G1:
// its time is the chain's latency.
//
// Built with `-DMANTA_CURVE=` 0 BN254 G1, 1 BN254 G2, 2 BLS12-381 G1,
// 3 BLS12-381 G2 and `-DMANTA_KERNEL=` 0 add, 1 madd, 2 double, 3 column,
// 4 fold, 5 combine: one object per kernel and curve, compiled in parallel,
// and one shared library per curve that links its six objects.

#include "point_ops.cuh"

namespace {

using namespace manta;

constexpr int kPointThreads = 128;
// The column kernel runs one long dependent chain per thread over ~10^4
// lanes: one warp per block spreads those lanes over every SM.
constexpr int kColumnThreads = 32;
// One warp per block of the fold kernel, so that a lane's threads share a warp.
constexpr int kFoldThreads = 32;
// The combine kernel's one block: 8 warps share the windows' sums, then one
// runs the Horner chain. At most 64 windows (the MSM's fold path needs
// 2·W <= 128).
constexpr int kCombineThreads = 256;
constexpr int kMaxWindows = 64;

template <class C, int WHICH>
__global__ void __launch_bounds__(kPointThreads)
    point_kernel(const int32_t* __restrict__ px, const int32_t* __restrict__ py,
                 const int32_t* __restrict__ pz, const int32_t* __restrict__ qx,
                 const int32_t* __restrict__ qy, const int32_t* __restrict__ qz,
                 int32_t* __restrict__ ox, int32_t* __restrict__ oy, int32_t* __restrict__ oz,
                 int64_t n) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * kPointThreads + threadIdx.x;
  if (j < n) point_lane<C, WHICH>(px, py, pz, qx, qy, qz, ox, oy, oz, n, j);
}

template <class C>
__global__ void __launch_bounds__(kColumnThreads)
    column_kernel(const int32_t* __restrict__ px, const int32_t* __restrict__ py,
                  const int32_t* __restrict__ qinf, const int32_t* __restrict__ head,
                  int32_t* __restrict__ ox, int32_t* __restrict__ oy, int32_t* __restrict__ oz,
                  int steps, int64_t lanes) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * kColumnThreads + threadIdx.x;
  if (j < lanes) column_lane<C>(px, py, qinf, head, ox, oy, oz, steps, lanes, j);
}

template <class C>
__global__ void __launch_bounds__(kFoldThreads)
    fold_kernel(const int32_t* __restrict__ qx, const int32_t* __restrict__ qy,
                const int32_t* __restrict__ qz, const int32_t* __restrict__ head,
                int32_t* __restrict__ ax, int32_t* __restrict__ ay, int32_t* __restrict__ az,
                int32_t* __restrict__ bx, int32_t* __restrict__ by, int32_t* __restrict__ bz,
                int steps, int64_t lanes, int width) {
  const int t = threadIdx.x % width;
  const int64_t j =
      static_cast<int64_t>(blockIdx.x) * (kFoldThreads / width) + threadIdx.x / width;
  fold_group<C>(qx, qy, qz, head, ax, ay, az, bx, by, bz, steps, lanes, j, t, width, j < lanes);
}

template <class C>
__global__ void __launch_bounds__(kCombineThreads)
    combine_kernel(const int32_t* __restrict__ ax, const int32_t* __restrict__ ay,
                   const int32_t* __restrict__ az, const int32_t* __restrict__ bx,
                   const int32_t* __restrict__ by, const int32_t* __restrict__ bz,
                   int32_t* __restrict__ ox, int32_t* __restrict__ oy, int32_t* __restrict__ oz,
                   int windows, int doublings, int window_bits) {
  __shared__ Pt<C> sums[kMaxWindows];
  combine_block<C>(ax, ay, az, bx, by, bz, ox, oy, oz, windows, doublings, window_bits, sums,
                   threadIdx.x, kCombineThreads);
}

#ifndef MANTA_CURVE
#error "build with -DMANTA_CURVE=0..3 (BN254 G1, BN254 G2, BLS12-381 G1, BLS12-381 G2)"
#elif MANTA_CURVE == 0
using Curve = Base<Bn254Fq>;
#elif MANTA_CURVE == 1
using Curve = Ext<Bn254Fq>;
#elif MANTA_CURVE == 2
using Curve = Base<Bls12381Fq>;
#elif MANTA_CURVE == 3
using Curve = Ext<Bls12381Fq>;
#else
#error "MANTA_CURVE must be 0..3"
#endif

[[maybe_unused]] inline dim3 grid_for(int64_t lanes, int threads) {
  return dim3(static_cast<unsigned>((lanes + threads - 1) / threads));
}

[[maybe_unused]] inline bool too_many_blocks(int64_t lanes, int threads) {
  return (lanes + threads - 1) / threads > 0x7fffffffLL;
}

template <int WHICH>
int launch_point(const void* px, const void* py, const void* pz, const void* qx,
                 const void* qy, const void* qz, void* ox, void* oy, void* oz, long long n,
                 void* stream) {
  if (n <= 0) return 0;
  if (too_many_blocks(n, kPointThreads)) return static_cast<int>(cudaErrorInvalidConfiguration);
  point_kernel<Curve, WHICH><<<grid_for(n, kPointThreads), kPointThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(px), static_cast<const int32_t*>(py),
      static_cast<const int32_t*>(pz), static_cast<const int32_t*>(qx),
      static_cast<const int32_t*>(qy), static_cast<const int32_t*>(qz),
      static_cast<int32_t*>(ox), static_cast<int32_t*>(oy), static_cast<int32_t*>(oz), n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One kernel per object file, so that the objects of a curve compile in
// parallel (`ops/kernels/build.py`); the curve's shared library links all
// six. Each launcher returns the launch's cudaError_t (0 on success).
#ifndef MANTA_KERNEL
#error "build with -DMANTA_KERNEL=0..5 (add, madd, double, column, fold, combine)"
#elif MANTA_KERNEL <= 2
// Every coordinate a contiguous (*E, n) int32 array; double ignores q.
#define MANTA_POINT_LAUNCHER(name, which)                                                    \
  extern "C" int name(const void* px, const void* py, const void* pz, const void* qx,        \
                      const void* qy, const void* qz, void* ox, void* oy, void* oz,          \
                      long long n, void* stream) {                                            \
    return launch_point<which>(px, py, pz, qx, qy, qz, ox, oy, oz, n, stream);               \
  }
#if MANTA_KERNEL == 0
MANTA_POINT_LAUNCHER(manta_point_add, kAdd)
#elif MANTA_KERNEL == 1
MANTA_POINT_LAUNCHER(manta_point_madd, kMadd)
#else
MANTA_POINT_LAUNCHER(manta_point_double, kDouble)
#endif
#elif MANTA_KERNEL == 3
// px, py -> ox, oy, oz: (K, *E, R) int32; qinf, head: (K, R) int32.
extern "C" int manta_accumulate_columns(const void* px, const void* py, const void* qinf,
                                        const void* head, void* ox, void* oy, void* oz,
                                        int steps, long long lanes, void* stream) {
  if (lanes <= 0 || steps <= 0) return 0;
  if (too_many_blocks(lanes, kColumnThreads)) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  column_kernel<Curve><<<grid_for(lanes, kColumnThreads), kColumnThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(px), static_cast<const int32_t*>(py),
      static_cast<const int32_t*>(qinf), static_cast<const int32_t*>(head),
      static_cast<int32_t*>(ox), static_cast<int32_t*>(oy), static_cast<int32_t*>(oz), steps,
      lanes);
  return static_cast<int>(cudaGetLastError());
}
#elif MANTA_KERNEL == 4
// qx, qy, qz -> ax, ay, az: (K, *E, R) int32; head: (K, R); bx, by, bz: (*E, R),
// or all three null for no B.
extern "C" int manta_fold_columns(const void* qx, const void* qy, const void* qz,
                                  const void* head, void* ax, void* ay, void* az, void* bx,
                                  void* by, void* bz, int steps, long long lanes,
                                  void* stream) {
  if (lanes <= 0 || steps <= 0) return 0;
  const int width = fold_threads(steps);
  const int per_block = kFoldThreads / width;
  if (too_many_blocks(lanes, per_block)) return static_cast<int>(cudaErrorInvalidConfiguration);
  fold_kernel<Curve><<<grid_for(lanes, per_block), kFoldThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(qx), static_cast<const int32_t*>(qy),
      static_cast<const int32_t*>(qz), static_cast<const int32_t*>(head),
      static_cast<int32_t*>(ax), static_cast<int32_t*>(ay), static_cast<int32_t*>(az),
      static_cast<int32_t*>(bx), static_cast<int32_t*>(by), static_cast<int32_t*>(bz), steps,
      lanes, width);
  return static_cast<int>(cudaGetLastError());
}
#elif MANTA_KERNEL == 5
// ax, ay, az, bx, by, bz: (*E, 2·windows) int32 -> ox, oy, oz: (*E, 1).
extern "C" int manta_combine_windows(const void* ax, const void* ay, const void* az,
                                     const void* bx, const void* by, const void* bz, void* ox,
                                     void* oy, void* oz, int windows, int doublings,
                                     int window_bits, void* stream) {
  if (windows < 1 || windows > kMaxWindows || doublings < 0 || window_bits < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  combine_kernel<Curve><<<1, kCombineThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(ax), static_cast<const int32_t*>(ay),
      static_cast<const int32_t*>(az), static_cast<const int32_t*>(bx),
      static_cast<const int32_t*>(by), static_cast<const int32_t*>(bz),
      static_cast<int32_t*>(ox), static_cast<int32_t*>(oy), static_cast<int32_t*>(oz), windows,
      doublings, window_bits);
  return static_cast<int>(cudaGetLastError());
}
#else
#error "MANTA_KERNEL must be 0..5"
#endif
