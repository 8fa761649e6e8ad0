// Whole-formula elliptic-curve kernels for Hopper (sm_90a): point op, bucket
// column, fold.
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
//     A = q[k] if head[k] else add(A, q[k]); B = add(B, A); both written.
//
// What it computes is bit for bit what the plain versions compute: the field
// ops are `FieldOps<F>` (field_ops.cuh), and every formula of point_ops.cuh
// runs the same field operations on the same operands as
// `manta_tpu_torch/ops/curve.py` (CurveOps.double / add / madd, Fq2Ops.mul /
// sqr), so the lazy [0, 2p) values agree. Fq2 multiplication is Karatsuba-3 (t0 = a0 b0, t1 = a1 b1,
// s = (a0 + a1)(b0 + b1); c0 = t0 − t1, c1 = (s − t0) − t1); squaring is
// (a0 + a1)(a0 − a1) and 2·a0 a1. The TPU kernels compute BLS12-381 Fq in
// 12-bit limbs inside; this kernel uses 32-bit words, which give the same
// integers (Montgomery with R = 2^(16·L) either way).
//
// Design: one thread per lane. A point lives in registers as 32-bit words;
// the column and fold kernels keep their accumulators in registers across
// all K steps (the TPU kernels carry them in VMEM scratch across a
// sequential grid axis). Coordinates stay limb-major (..., L, lanes) int32 at
// the boundary, so neighbouring threads load and store neighbouring words.
// Any lane count: the tail block is masked (the TPU kernels' padding to 128
// lanes is not needed). The edge dispatch is a per-thread branch: the
// doubling is computed only in a thread whose lane needs it, and the host
// never waits for the device. The fold kernel runs its two complete additions
// through one loop of two turns, so the add formula is compiled once.
//
// Bound on the H100 (3.35 TB/s HBM; 67 T 32-bit multiply-adds/s, the card's
// non-tensor rate, as the ceiling for integer work). A BN254 G1 mixed add is
// 11 Montgomery products of S = 8 words, 2·S² + S = 136 multiply-adds each.
// The column kernel at K = 128 over 10240 lanes (one G1 MSM of the
// production prover, 20 windows of 512 lanes) reads px, py and writes ox,
// oy, oz: 5 × 84 MB = 420 MB, 125 µs by bytes, against 1.3 M mixed adds =
// 2.0 G multiply-adds = 3.9 G operations, 58 µs; it is bound by bytes because
// it writes the accumulator after every step, as the TPU kernel does. At
// these lane counts it runs a few warps per SM, each thread a chain of
// dependent products, so expect latency, not either bound, to set its time;
// splitting a lane's products across threads, or writing only the run
// ends, would address that.
//
// Built with `-DMANTA_CURVE=` 0 BN254 G1, 1 BN254 G2, 2 BLS12-381 G1,
// 3 BLS12-381 G2 and `-DMANTA_KERNEL=` 0 add, 1 madd, 2 double, 3 column,
// 4 fold: one object per kernel and curve, compiled in parallel, and one
// shared library per curve that links its five objects.

#include "point_ops.cuh"

namespace {

using namespace manta;

constexpr int kPointThreads = 128;
// The column and fold kernels run one long dependent chain per thread over
// ~10^4 lanes: one warp per block spreads those lanes over every SM.
constexpr int kColumnThreads = 32;

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
__global__ void __launch_bounds__(kColumnThreads)
    fold_kernel(const int32_t* __restrict__ qx, const int32_t* __restrict__ qy,
                const int32_t* __restrict__ qz, const int32_t* __restrict__ head,
                int32_t* __restrict__ ax, int32_t* __restrict__ ay, int32_t* __restrict__ az,
                int32_t* __restrict__ bx, int32_t* __restrict__ by, int32_t* __restrict__ bz,
                int steps, int64_t lanes) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * kColumnThreads + threadIdx.x;
  if (j < lanes) fold_lane<C>(qx, qy, qz, head, ax, ay, az, bx, by, bz, steps, lanes, j);
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

inline dim3 grid_for(int64_t lanes, int threads) {
  return dim3(static_cast<unsigned>((lanes + threads - 1) / threads));
}

inline bool too_many_blocks(int64_t lanes, int threads) {
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
// five. Each launcher returns the launch's cudaError_t (0 on success).
#ifndef MANTA_KERNEL
#error "build with -DMANTA_KERNEL=0..4 (add, madd, double, column, fold)"
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
// qx, qy, qz -> (ax, ay, az), (bx, by, bz): (K, *E, R) int32; head: (K, R).
extern "C" int manta_fold_columns(const void* qx, const void* qy, const void* qz,
                                  const void* head, void* ax, void* ay, void* az, void* bx,
                                  void* by, void* bz, int steps, long long lanes,
                                  void* stream) {
  if (lanes <= 0 || steps <= 0) return 0;
  if (too_many_blocks(lanes, kColumnThreads)) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  fold_kernel<Curve><<<grid_for(lanes, kColumnThreads), kColumnThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(qx), static_cast<const int32_t*>(qy),
      static_cast<const int32_t*>(qz), static_cast<const int32_t*>(head),
      static_cast<int32_t*>(ax), static_cast<int32_t*>(ay), static_cast<int32_t*>(az),
      static_cast<int32_t*>(bx), static_cast<int32_t*>(by), static_cast<int32_t*>(bz), steps,
      lanes);
  return static_cast<int>(cudaGetLastError());
}
#else
#error "MANTA_KERNEL must be 0..4"
#endif
