// Whole-formula elliptic-curve kernels for Hopper (sm_90a): point op, bucket
// column, fold, window combine, bucket merge, chain.
//
// Replaces the JAX package's Pallas TPU kernels in
// `manta_tpu/ops/pallas/point_kernels.py`:
//   - `_point_op` (public `fused_add` / `fused_madd` / `fused_double`): one
//     whole Jacobian add (add-2007-bl), mixed add (madd-2007-bl, Z2 in {0, 1})
//     or double (dbl-2009-l) per lane, with the edge dispatch of
//     `CurveOps._add_dispatch`;
//   - `_column_call` (public `accumulate_buckets`): per lane, for k < K,
//     acc = q[k] if head[k] else madd(acc, q[k]), q = infinity where qinf[k].
//     The TPU kernel writes acc after every step, a (K, *E, R) stream of
//     which the MSM keeps the run ends (`msm._run_ends_compact` and a
//     scatter); this one writes acc only at a run end, straight into its
//     bucket (`slot[k]` = w·num_buckets + digit, or −1), and the last acc;
//   - `_fold_call` (public `fold_columns`): per lane,
//     A = q[k] if head[k] else add(A, q[k]); B = add(B, A). The TPU kernel
//     writes both streams; this one writes the A stream and, where the caller
//     asks for it, B's last row, the only row of B that the MSM reads
//     (`manta_tpu/ops/msm.py` reads the same rows).
// The combine kernel takes over the point-op launches of the MSM's last
// steps on the fold path (`_weighted_fold_fused`'s window sums and the Horner
// loop over windows of `msm`, about 270 single-lane launches an MSM), the
// merge kernel the two dense point-op additions that add the fold's trailing
// partials into the buckets (`buckets + b1 + b2` over W·num_buckets lanes, of
// which the partials hit at most W·R + W·128), and the chain kernel (public
// `fused_double_add`) the MSM's chains of doublings and an addition off the
// fold path (Horner's rule and the weighted reductions' two doubling runs,
// about 265 single-lane launches an MSM, each costing the host 0.07-0.08 ms
// to issue): the TPU program runs all three as `_point_op` calls too.
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
// versions (`point_kernels.PLAIN`) add in its order. The bucket column keeps
// each lane's chunk and order of steps, so its buckets are the JAX
// package's, bit for bit.
//
// Design: a point lives in registers as 32-bit words. Coordinates stay
// limb-major (..., L, lanes) int32 at the boundary, so neighbouring threads
// load and store neighbouring words. Any lane count: the tail block is masked
// (the TPU kernels' padding to 128 lanes is not needed). The edge dispatch is
// a branch of the thread or group: the doubling is computed only where a
// lane needs it, and the host never waits for the device.
//   - Point op: G1 on a group of 2 threads a lane (`point_group`), each
//     formula's rounds of products spread over the group as in the bucket
//     column; G2 on one thread a lane (`point_lane`). Timed at 20·4097 lanes
//     (H100 80GB HBM3, 700 W): the G1 addition of the MSM off the fold path
//     took 0.117 ms on one thread a lane, 0.077 on 2 and 0.100 on 4; on
//     generic lanes the three were 0.078, 0.078 and 0.095 ms. The G2
//     addition took 0.499 ms on one thread a lane, 0.682 on 2 and 0.648 on 4
//     on generic lanes: at that lane count one thread a lane already fills
//     the card, and a group repeats the formula's Fq2 additions in every
//     thread and shuffles each 8-word product to all of them, which costs
//     more than it hides. `-DMANTA_POINT_GROUP=` builds the point op with
//     another G (1, 2 or 4) for timing the choices.
//   - Bucket column: one thread per lane ran 128 dependent mixed additions
//     over the production prover's 10240 lanes (20 windows of 512): 320
//     warps on 132 SMs, 2-3 warps an SM, all latency (1.83 ms for G1,
//     9.22 ms for G2, H100 80GB HBM3, 700 W), and wrote a 0.25-0.50 GB
//     stream an MSM. Here a group of G threads of a warp runs each lane
//     (`group_madd_to`): each round of the formula's products is spread over
//     the group, one base product a thread, gathered by shuffles, so a step
//     is 6 rounds (G1, G = 2) or 8 (G2, G = 4) instead of 11 or 29 products
//     in a row, with G times the threads in flight. G is small because the
//     kernel is then bound by issuing the arithmetic: every thread of a
//     group repeats the formula's additions, and a round that leaves a
//     thread idle still costs the warp its issue slot, so at G = 4 (G1) or
//     8 (G2) the kernel took 1.98 and 8.15 ms (H100 80GB HBM3, 700 W). Only
//     run ends and the last step are written. Each thread loads its step's
//     point itself (the words a group reads are the same, a warp's groups
//     read neighbouring lanes): staging each step's slab through shared
//     memory with `cp.async` and two block barriers a step gained nothing.
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
//     spread over the 32 lanes of a warp (`group_double_to`, `group_add_to`):
//     a doubling is 3 rounds of products instead of 7 products (G1) or 16
//     (G2), an addition 5 instead of 16 or 44. The 8 warps of the block
//     compute the window sums, one window each in turn, into shared memory;
//     warp 0 then runs the Horner chain.
//   - Merge: one group of G threads (as the bucket column's) per trailing
//     partial of the fold's two levels (W·R + W·128 groups, those of a dead
//     key idle), each running its bucket's two complete additions spread
//     over the group, in place;
//     the buckets no partial hits only have their infinity made canonical,
//     as the dense additions would (blocks after the groups' blocks, one
//     thread a bucket). The wrapper builds the inverse index slot -> entry.
//   - Chain: one warp a chain (`double_add_warp`), each formula spread over
//     its 32 lanes, as the combine's Horner chain (`double_add_chain`, shared
//     by both): one launch for all chains of a call.
//   - The point op, fold, combine, chain, bucket column and merge kernels
//     call each formula out of line (`add_to`, `double_to`, `group_*_to`), so
//     each object compiles it once.
//
// Bound on the H100 (3.35 TB/s HBM; 67 T 32-bit multiply-adds/s, the card's
// non-tensor rate, as the ceiling for integer work). A BN254 G1 mixed add is
// 11 Montgomery products of S = 8 words, 2·S² + S = 136 multiply-adds each
// (a complete add 16, a doubling 7). The bucket column at K = 128 over 10240
// lanes (one G1 MSM of the production prover, 20 windows of 512 lanes) reads
// px, py (168 MB) and the three masks (16 MB) and writes at most 20·4097 run
// ends and 10240 last accumulators (18 MB): 202 MB, 60 µs by bytes, against
// 1.3 M mixed adds = 2.0 G multiply-adds = 3.9 G operations, 58 µs (the
// TPU kernel's stream made it 420 MB). The fold's least work is K additions
// for A (fewer where a head starts a run) and K for B per lane, and its bytes
// q and A (6 streams) plus B's row: at the G1 level-2 shape (128, 16, 20)
// 2 × 2560 additions = 22 M operations, 0.33 µs, and 1 MB, 0.3 µs. The
// scan's extra additions (about 3K per lane at K = 128) are not in the
// bound. The combine's least work is its ~250 doublings and ~40 additions,
// 0.06 µs of operations for G1: its time is the chain's latency. The merge's
// is at most 12800 complete additions a G1 MSM (28 M operations, 0.4 µs)
// and the buckets they touch.
//
// Built with `-DMANTA_CURVE=` 0 BN254 G1, 1 BN254 G2, 2 BLS12-381 G1,
// 3 BLS12-381 G2 and `-DMANTA_KERNEL=` 0 add and merge, 1 madd, 2 double,
// 3 bucket column, 4 fold, 5 combine and chain: one object per kernel and
// curve (the merge kernel shares the add kernel's, the chain kernel the
// combine's), compiled in parallel, and one shared library per curve that
// links its six objects.

#include "point_ops.cuh"

namespace {

using namespace manta;

// The point-op, bucket column and merge kernels: 4 warps a block, a group of
// threads a lane (kPointGroup, kGroupThreads).
constexpr int kPointThreads = 128;
constexpr int kBucketThreads = 128;
// One warp per block of the fold kernel, so that a lane's threads share a warp.
constexpr int kFoldThreads = 32;
// The combine kernel's one block: 8 warps share the windows' sums, then one
// runs the Horner chain. At most 64 windows (the MSM's fold path needs
// 2·W <= 128).
constexpr int kCombineThreads = 256;
constexpr int kMaxWindows = 64;
// The chain kernel: 4 warps a block, a warp a chain.
constexpr int kChainThreads = 128;

// G threads a lane (G = 1: one thread, the formulas inline).
template <class C, int WHICH, int G>
__global__ void __launch_bounds__(kPointThreads)
    point_kernel(const int32_t* __restrict__ px, const int32_t* __restrict__ py,
                 const int32_t* __restrict__ pz, const int32_t* __restrict__ qx,
                 const int32_t* __restrict__ qy, const int32_t* __restrict__ qz,
                 int32_t* __restrict__ ox, int32_t* __restrict__ oy, int32_t* __restrict__ oz,
                 int64_t n) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * (kPointThreads / G) + threadIdx.x / G;
  if constexpr (G == 1) {
    if (j < n) point_lane<C, WHICH>(px, py, pz, qx, qy, qz, ox, oy, oz, n, j);
  } else {
    point_group<C, WHICH, G>(px, py, pz, qx, qy, qz, ox, oy, oz, n, j,
                             Group<G>(threadIdx.x % 32));
  }
}

template <class C, int G>
__global__ void __launch_bounds__(kBucketThreads)
    bucket_column_kernel(const int32_t* __restrict__ px, const int32_t* __restrict__ py,
                         const int32_t* __restrict__ qinf, const int32_t* __restrict__ head,
                         const int32_t* __restrict__ slot, int32_t* __restrict__ bx,
                         int32_t* __restrict__ by, int32_t* __restrict__ bz,
                         int32_t* __restrict__ ax, int32_t* __restrict__ ay,
                         int32_t* __restrict__ az, int steps, int64_t lanes, int64_t num_slots) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * (kBucketThreads / G) + threadIdx.x / G;
  bucket_column_group<C, G>(px, py, qinf, head, slot, bx, by, bz, ax, ay, az, steps, lanes,
                            num_slots, j, Group<G>(threadIdx.x % 32));
}

// Blocks below `group_blocks`: one group of G threads per merge entry;
// blocks from `group_blocks` on: one thread per bucket (`merge_untouched`).
template <class C, int G>
__global__ void __launch_bounds__(kBucketThreads)
    merge_kernel(int32_t* __restrict__ ax, int32_t* __restrict__ ay, int32_t* __restrict__ az,
                 const int32_t* __restrict__ v1x, const int32_t* __restrict__ v1y,
                 const int32_t* __restrict__ v1z, const int32_t* __restrict__ key1,
                 const int32_t* __restrict__ v2x, const int32_t* __restrict__ v2y,
                 const int32_t* __restrict__ v2z, const int32_t* __restrict__ key2,
                 const int32_t* __restrict__ inv1, const int32_t* __restrict__ inv2, int64_t n1,
                 int64_t n2, int64_t num_slots, int64_t group_blocks) {
  const int64_t block = blockIdx.x;
  if (block < group_blocks) {
    const int64_t e = block * (kBucketThreads / G) + threadIdx.x / G;
    merge_group<C, G>(ax, ay, az, v1x, v1y, v1z, key1, v2x, v2y, v2z, key2, inv1, inv2, n1, n2,
                      num_slots, e, Group<G>(threadIdx.x % 32));
  } else {
    merge_untouched<C>(ax, ay, az, inv1, inv2, num_slots,
                       (block - group_blocks) * kBucketThreads + threadIdx.x);
  }
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

template <class C>
__global__ void __launch_bounds__(kChainThreads)
    chain_kernel(const int32_t* __restrict__ ix, const int32_t* __restrict__ iy,
                 const int32_t* __restrict__ iz, const int32_t* __restrict__ wx,
                 const int32_t* __restrict__ wy, const int32_t* __restrict__ wz,
                 int32_t* __restrict__ ox, int32_t* __restrict__ oy, int32_t* __restrict__ oz,
                 int64_t n, int steps, int doublings, int chain_first) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * (kChainThreads / 32) + threadIdx.x / 32;
  double_add_warp<C>(ix, iy, iz, wx, wy, wz, ox, oy, oz, n, steps, doublings, chain_first != 0, j,
                     Group<32>(threadIdx.x % 32));
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

// threads of a lane in the bucket column and the merge: 2 for G1, 4 for G2
// (the fastest of 1 to 16 for the bucket column on the card)
constexpr int kGroupThreads = WarpProducts<Curve>::kMul == 1 ? 2 : 4;
// threads of a lane in the point op: 2 for G1, 1 for G2 (the fastest of 1, 2
// and 4 on the card at the bucket-merge shape, on generic lanes too; see the
// header), unless built with another
#ifdef MANTA_POINT_GROUP
constexpr int kPointGroup = MANTA_POINT_GROUP;
#else
constexpr int kPointGroup = WarpProducts<Curve>::kMul == 1 ? 2 : 1;
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
  constexpr int per_block = kPointThreads / kPointGroup;
  if (too_many_blocks(n, per_block)) return static_cast<int>(cudaErrorInvalidConfiguration);
  point_kernel<Curve, WHICH, kPointGroup><<<grid_for(n, per_block), kPointThreads, 0,
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
#error "build with -DMANTA_KERNEL=0..5 (add and merge, madd, double, bucket column, fold, combine and chain)"
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
// a, in place: (*E, num_slots) int32; v1: (*E, n1), key1: (n1); v2: (*E, n2),
// key2: (n2); inv1, inv2: (num_slots) int32. See `merge_group`.
extern "C" int manta_merge_buckets(void* ax, void* ay, void* az, const void* v1x,
                                   const void* v1y, const void* v1z, const void* key1,
                                   const void* v2x, const void* v2y, const void* v2z,
                                   const void* key2, const void* inv1, const void* inv2,
                                   long long n1, long long n2, long long num_slots,
                                   void* stream) {
  if (n1 < 0 || n2 < 0 || num_slots < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (num_slots == 0) return 0;
  constexpr int per_block = kBucketThreads / kGroupThreads;
  const long long group_blocks = (n1 + n2 + per_block - 1) / per_block;
  const long long blocks = group_blocks + (num_slots + kBucketThreads - 1) / kBucketThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  merge_kernel<Curve, kGroupThreads><<<dim3(static_cast<unsigned>(blocks)), kBucketThreads, 0,
                                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(ax), static_cast<int32_t*>(ay), static_cast<int32_t*>(az),
      static_cast<const int32_t*>(v1x), static_cast<const int32_t*>(v1y),
      static_cast<const int32_t*>(v1z), static_cast<const int32_t*>(key1),
      static_cast<const int32_t*>(v2x), static_cast<const int32_t*>(v2y),
      static_cast<const int32_t*>(v2z), static_cast<const int32_t*>(key2),
      static_cast<const int32_t*>(inv1), static_cast<const int32_t*>(inv2), n1, n2, num_slots,
      group_blocks);
  return static_cast<int>(cudaGetLastError());
}
#elif MANTA_KERNEL == 1
MANTA_POINT_LAUNCHER(manta_point_madd, kMadd)
#else
MANTA_POINT_LAUNCHER(manta_point_double, kDouble)
#endif
#elif MANTA_KERNEL == 3
// px, py: (K, *E, R) int32; qinf, head, slot: (K, R) int32 -> bx, by, bz:
// (*E, num_slots), written at the slots >= 0 only (the caller fills them
// first); ax, ay, az: (*E, R), the last step's accumulator.
extern "C" int manta_accumulate_buckets(const void* px, const void* py, const void* qinf,
                                        const void* head, const void* slot, void* bx, void* by,
                                        void* bz, void* ax, void* ay, void* az, int steps,
                                        long long lanes, long long num_slots, void* stream) {
  if (lanes <= 0 || steps <= 0) return 0;
  constexpr int per_block = kBucketThreads / kGroupThreads;
  if (too_many_blocks(lanes, per_block)) return static_cast<int>(cudaErrorInvalidConfiguration);
  bucket_column_kernel<Curve, kGroupThreads><<<grid_for(lanes, per_block), kBucketThreads, 0,
                                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(px), static_cast<const int32_t*>(py),
      static_cast<const int32_t*>(qinf), static_cast<const int32_t*>(head),
      static_cast<const int32_t*>(slot), static_cast<int32_t*>(bx), static_cast<int32_t*>(by),
      static_cast<int32_t*>(bz), static_cast<int32_t*>(ax), static_cast<int32_t*>(ay),
      static_cast<int32_t*>(az), steps, lanes, num_slots);
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
// init ix, iy, iz and out ox, oy, oz: (*E, n) int32; addends wx, wy, wz:
// (steps, *E, n). See `double_add_warp`.
extern "C" int manta_double_add(const void* ix, const void* iy, const void* iz, const void* wx,
                                const void* wy, const void* wz, void* ox, void* oy, void* oz,
                                long long n, int steps, int doublings, int chain_first,
                                void* stream) {
  if (n <= 0) return 0;
  if (steps < 0 || doublings < 0) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int per_block = kChainThreads / 32;
  if (too_many_blocks(n, per_block)) return static_cast<int>(cudaErrorInvalidConfiguration);
  chain_kernel<Curve><<<grid_for(n, per_block), kChainThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(ix), static_cast<const int32_t*>(iy),
      static_cast<const int32_t*>(iz), static_cast<const int32_t*>(wx),
      static_cast<const int32_t*>(wy), static_cast<const int32_t*>(wz),
      static_cast<int32_t*>(ox), static_cast<int32_t*>(oy), static_cast<int32_t*>(oz), n, steps,
      doublings, chain_first);
  return static_cast<int>(cudaGetLastError());
}
#else
#error "MANTA_KERNEL must be 0..5"
#endif
