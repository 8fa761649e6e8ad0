// RNS curve kernels for Hopper (sm_90a): point op, bucket column, hybrid
// (limb-input) bucket column, and the combine of the MSM's last steps.
//
// Replaces the JAX package's Pallas TPU kernels in
// `manta_tpu/ops/pallas/rns_kernels.py`:
//   - `_rns_point_op` (public `RnsFusedCurveOps.add / madd / double`): one
//     whole add, mixed add or double per lane through the bound-annotated
//     formulas of `RnsCurveOps`, with the edge dispatch of `_add_dispatch`;
//   - `_rns_column_call` (public `rns_accumulate_columns`): per lane, for
//     k < K, acc = q[k] if head[k] else madd(acc, q[k]), q = (x, y, 1) or
//     infinity where qinf[k], the accumulator written after every step;
//   - `_hybrid_column_call` (public `hybrid_accumulate_buckets`): the same
//     loop with the points given as 16-bit Montgomery limbs, each step's q
//     converted to RNS (`from_limbs`: the residues of the limb value, then
//     one RNS product by M1²·2^(−16 L)). The TPU kernel writes the
//     accumulator after every step, a (K, *E, R) stream of which the MSM
//     keeps the run ends; this one writes it only at a run end, straight
//     into its bucket (`slot[k]` = w·num_buckets + digit, or −1), and the
//     last accumulator.
// The combine kernel (public `rns_double_add`) runs the chains of doublings
// and additions that the TPU program runs as `_rns_point_op` launches, one
// lane at a time: Horner's rule over the windows (c doublings and an
// addition a window) and the two weighted reductions' doubling runs, about
// 265 launches an MSM.
// Also a launcher of the zero test alone (`manta_rns_is_zero`), so that the
// table-free test can be held against the zero-class table on the card.
//
// The arithmetic is rns_ops.cuh (its header says why the residues are the
// JAX kernels' bit for bit, and how the zero test replaces the 2^13-row
// table). One block serves 8 lanes with one thread per channel; the column
// kernels keep the accumulator in registers across the K steps, where the
// TPU kernels carry it in VMEM scratch across a sequential grid axis. Any
// lane count: the last block's missing lanes read zeros and store nothing
// (the TPU kernels' padding to 128 or 512 lanes is not needed).
//
// Bound on the H100 (3.35 TB/s HBM; 67 T 32-bit integer operations/s, the
// non-tensor rate). An RNS product on BN254 (k1 = k2 = 25, Kt = 51) is
// (k2+1)·k1 multiply-adds of the first base extension and k1·k2 + k2 of the
// second, ~2.6 k operations, plus ~4 operations for each of ~230 channel
// modular products: ~4.4 k operations, ~10 × the integer work of a 32-bit
// CIOS product in `point_kernels.cu`. The hybrid bucket column at K = 128
// over 20 · 512 lanes (one G1 MSM of the production prover) reads the limb
// points (168 MB) and writes the run ends and the last step (~6 MB), against
// ~1.3 M mixed adds × 11 products × 4.4 k operations ≈ 6·10^10 operations,
// 0.9 ms: bound by operations. Barriers pace these kernels: with two a
// product they ran at 8–10 % of the bound. So the formulas run their products
// in rounds (rns_ops.cuh), 11 barriers a mixed addition instead of ~29, and
// the hybrid column converts the next step's point inside the current
// step's first round, its limbs staged two steps ahead with cp.async.
//
// Shared memory grows with NB, the base products a round's pass holds (5 for
// G1, the complete addition's first round; 12 for G2, a mixed addition's
// first round with the hybrid column's conversion products, so a G2 complete
// addition's 20-product first round runs in two passes): the blocks take it
// as dynamic shared memory, above the static 48 KB on BLS12-381 G2.
//
// Occupancy. A block's phases alternate between its B1 and its B2 ∪ r
// threads, and each waits on shared-memory loads, so a block alone leaves an
// SM idle much of the time: more blocks an SM hide it. Rounds keep more
// products live than one product at a time did (BN254 G1's hybrid column
// rose to ~120 registers, one block an SM), so the BN254 kernels are built
// for 3 (G1) or 2 (G2) blocks an SM (`kMinBlocks`, at the price of a few
// spilled registers), and BN254 G2 reads its extension operands a word at a
// time (`VEC` false), which needs fewer registers than four at a time:
// both chosen by timing the variants on the card. The combine kernel, one
// block a chain, is not built for more blocks; on BN254 G2 it runs its
// rounds in passes of 4 base products, which spill less and were faster
// there than passes of 12.
//
// Built with `-DMANTA_CURVE=` 0 BN254 G1, 1 BN254 G2, 2 BLS12-381 G1,
// 3 BLS12-381 G2 and `-DMANTA_KERNEL=` 0 add, 1 madd, 2 double (with the
// zero-test launcher), 3 column, 4 hybrid bucket column, 5 combine: one
// object per kernel and curve, compiled in parallel, one shared library per
// curve.

#include "rns_ops.cuh"

namespace {

using namespace manta_rns;

#ifndef MANTA_CURVE
#error "build with -DMANTA_CURVE=0..3 (BN254 G1, BN254 G2, BLS12-381 G1, BLS12-381 G2)"
#elif MANTA_CURVE == 0
using D = Bn254;
constexpr int NB = 5;
[[maybe_unused]] constexpr int kMinBlocks = 3;
using O = BaseOps<D, NB>;
#elif MANTA_CURVE == 1
using D = Bn254;
constexpr int NB = MANTA_KERNEL == 5 ? 4 : 12;  // the combine: see "Occupancy" above
[[maybe_unused]] constexpr int kMinBlocks = 2;
using O = Fq2Ops<D, NB, false>;
#elif MANTA_CURVE == 2
using D = Bls12381;
constexpr int NB = 5;
[[maybe_unused]] constexpr int kMinBlocks = 1;
using O = BaseOps<D, NB>;
#elif MANTA_CURVE == 3
using D = Bls12381;
constexpr int NB = 12;
[[maybe_unused]] constexpr int kMinBlocks = 1;
using O = Fq2Ops<D, NB>;
#else
#error "MANTA_CURVE must be 0..3"
#endif

using S = Shared<D, NB>;

// The block's shared memory, dynamic (its size is sizeof(S)).
__device__ __forceinline__ S& shared_block() {
  extern __shared__ __align__(16) unsigned char smem[];
  return *reinterpret_cast<S*>(smem);
}

// only the kernel of this object (MANTA_KERNEL) is compiled into it
#if MANTA_KERNEL <= 2
template <int WHICH>
__global__ void __launch_bounds__(D::threads, kMinBlocks)
    point_kernel(const int32_t* __restrict__ table, const int32_t* __restrict__ px,
                 const int32_t* __restrict__ py, const int32_t* __restrict__ pz,
                 const int32_t* __restrict__ qx, const int32_t* __restrict__ qy,
                 const int32_t* __restrict__ qz, int32_t* __restrict__ ox,
                 int32_t* __restrict__ oy, int32_t* __restrict__ oz, int64_t n) {
  point_block<D, NB, O, WHICH>(shared_block(), table, px, py, pz, qx, qy, qz, ox, oy, oz, n);
}
#endif

#if MANTA_KERNEL == 3
__global__ void __launch_bounds__(D::threads, kMinBlocks)
    column_kernel(const int32_t* __restrict__ table, const int32_t* __restrict__ px,
                  const int32_t* __restrict__ py, const int32_t* __restrict__ qinf,
                  const int32_t* __restrict__ head, int32_t* __restrict__ ox,
                  int32_t* __restrict__ oy, int32_t* __restrict__ oz, int steps, int64_t lanes) {
  column_block<D, NB, O>(shared_block(), table, px, py, qinf, head, ox, oy, oz, steps, lanes);
}
#endif

#if MANTA_KERNEL == 4
__global__ void __launch_bounds__(D::threads, kMinBlocks)
    hybrid_bucket_kernel(const int32_t* __restrict__ table, const int32_t* __restrict__ px,
                         const int32_t* __restrict__ py, const int32_t* __restrict__ qinf,
                         const int32_t* __restrict__ head, const int32_t* __restrict__ slot,
                         int32_t* __restrict__ bx, int32_t* __restrict__ by,
                         int32_t* __restrict__ bz, int32_t* __restrict__ ax,
                         int32_t* __restrict__ ay, int32_t* __restrict__ az, int steps,
                         int64_t lanes, int64_t num_slots) {
  hybrid_bucket_block<D, NB, O>(shared_block(), table, px, py, qinf, head, slot, bx, by, bz, ax,
                                ay, az, steps, lanes, num_slots);
}
#endif

#if MANTA_KERNEL == 5
__global__ void __launch_bounds__(D::threads)
    combine_kernel(const int32_t* __restrict__ table, const int32_t* __restrict__ ix,
                   const int32_t* __restrict__ iy, const int32_t* __restrict__ iz,
                   const int32_t* __restrict__ wx, const int32_t* __restrict__ wy,
                   const int32_t* __restrict__ wz, int32_t* __restrict__ ox,
                   int32_t* __restrict__ oy, int32_t* __restrict__ oz, int64_t n, int steps,
                   int doublings, int chain_first) {
  combine_block<D, NB, O>(shared_block(), table, ix, iy, iz, wx, wy, wz, ox, oy, oz, n, steps,
                          doublings, chain_first != 0);
}
#endif

#if MANTA_KERNEL == 2
__global__ void __launch_bounds__(D::threads)
    zero_kernel(const int32_t* __restrict__ table, const int32_t* __restrict__ a,
                int32_t* __restrict__ out, int64_t n) {
  zero_block<D, NB>(shared_block(), table, a, out, n);
}
#endif

inline dim3 grid_for(int64_t lanes) {
  return dim3(static_cast<unsigned>((lanes + kLanes - 1) / kLanes));
}

// 0 when the launch can go ahead, else the cudaError_t to return: the table
// must be this curve field's, the grid must fit, and the kernel must be
// allowed sizeof(S) bytes of dynamic shared memory (asked once a kernel).
template <auto kernel>
int refuse(long long lanes, long long table_words) {
  if (table_words != D::kWords) return static_cast<int>(cudaErrorInvalidValue);
  if ((lanes + kLanes - 1) / kLanes > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  static const int allowed = static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(sizeof(S))));
  return allowed;
}

#if MANTA_KERNEL <= 2
template <int WHICH>
int launch_point(const void* table, const void* px, const void* py, const void* pz,
                 const void* qx, const void* qy, const void* qz, void* ox, void* oy, void* oz,
                 long long n, long long table_words, void* stream) {
  if (n <= 0) return 0;
  if (const int err = refuse<point_kernel<WHICH>>(n, table_words)) return err;
  point_kernel<WHICH><<<grid_for(n), D::threads, sizeof(S), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(table), static_cast<const int32_t*>(px),
      static_cast<const int32_t*>(py), static_cast<const int32_t*>(pz),
      static_cast<const int32_t*>(qx), static_cast<const int32_t*>(qy),
      static_cast<const int32_t*>(qz), static_cast<int32_t*>(ox), static_cast<int32_t*>(oy),
      static_cast<int32_t*>(oz), n);
  return static_cast<int>(cudaGetLastError());
}
#endif

}  // namespace

// Each launcher returns the launch's cudaError_t (0 on success); every
// coordinate is a contiguous int32 array, `table` the curve field's constant
// table of `table_words` words (`rns_kernels.py::device_table`).
#ifndef MANTA_KERNEL
#error "build with -DMANTA_KERNEL=0..5 (add, madd, double, column, hybrid bucket column, combine)"
#elif MANTA_KERNEL <= 2
#define MANTA_RNS_POINT_LAUNCHER(name, which)                                                 \
  extern "C" int name(const void* table, const void* px, const void* py, const void* pz,      \
                      const void* qx, const void* qy, const void* qz, void* ox, void* oy,     \
                      void* oz, long long n, long long table_words, void* stream) {           \
    return launch_point<which>(table, px, py, pz, qx, qy, qz, ox, oy, oz, n, table_words,     \
                               stream);                                                        \
  }
#if MANTA_KERNEL == 0
MANTA_RNS_POINT_LAUNCHER(manta_rns_point_add, kAdd)
#elif MANTA_KERNEL == 1
MANTA_RNS_POINT_LAUNCHER(manta_rns_point_madd, kMadd)
#else
MANTA_RNS_POINT_LAUNCHER(manta_rns_point_double, kDouble)
extern "C" int manta_rns_is_zero(const void* table, const void* a, void* out, long long n,
                                 long long table_words, void* stream) {
  if (n <= 0) return 0;
  if (const int err = refuse<zero_kernel>(n, table_words)) return err;
  zero_kernel<<<grid_for(n), D::threads, sizeof(S), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(table), static_cast<const int32_t*>(a),
      static_cast<int32_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
#endif
#elif MANTA_KERNEL == 3
// px, py: (K, *E, R) residues; qinf, head: (K, R); ox, oy, oz: (K, *E, R)
// residues.
extern "C" int manta_rns_accumulate_columns(const void* table, const void* px, const void* py,
                                            const void* qinf, const void* head, void* ox,
                                            void* oy, void* oz, int steps, long long lanes,
                                            long long table_words, void* stream) {
  if (lanes <= 0 || steps <= 0) return 0;
  if (const int err = refuse<column_kernel>(lanes, table_words)) return err;
  column_kernel<<<grid_for(lanes), D::threads, sizeof(S), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(table), static_cast<const int32_t*>(px),
      static_cast<const int32_t*>(py), static_cast<const int32_t*>(qinf),
      static_cast<const int32_t*>(head), static_cast<int32_t*>(ox), static_cast<int32_t*>(oy),
      static_cast<int32_t*>(oz), steps, lanes);
  return static_cast<int>(cudaGetLastError());
}
#elif MANTA_KERNEL == 4
// px, py: (K, *E(L), R) limbs; qinf, head, slot: (K, R); bx, by, bz:
// (*E(Kt), num_slots) buckets (infinity where no run ends: the caller's);
// ax, ay, az: (*E(Kt), R) the last step.
extern "C" int manta_rns_hybrid_buckets(const void* table, const void* px, const void* py,
                                        const void* qinf, const void* head, const void* slot,
                                        void* bx, void* by, void* bz, void* ax, void* ay, void* az,
                                        int steps, long long lanes, long long num_slots,
                                        long long table_words, void* stream) {
  if (lanes <= 0 || steps <= 0) return 0;
  if (const int err = refuse<hybrid_bucket_kernel>(lanes, table_words)) return err;
  hybrid_bucket_kernel<<<grid_for(lanes), D::threads, sizeof(S),
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(table), static_cast<const int32_t*>(px),
      static_cast<const int32_t*>(py), static_cast<const int32_t*>(qinf),
      static_cast<const int32_t*>(head), static_cast<const int32_t*>(slot),
      static_cast<int32_t*>(bx), static_cast<int32_t*>(by), static_cast<int32_t*>(bz),
      static_cast<int32_t*>(ax), static_cast<int32_t*>(ay), static_cast<int32_t*>(az), steps,
      lanes, num_slots);
  return static_cast<int>(cudaGetLastError());
}
#elif MANTA_KERNEL == 5
// init ix, iy, iz and out ox, oy, oz: (*E(Kt), n); addends wx, wy, wz:
// (steps, *E(Kt), n).
extern "C" int manta_rns_double_add(const void* table, const void* ix, const void* iy,
                                    const void* iz, const void* wx, const void* wy, const void* wz,
                                    void* ox, void* oy, void* oz, long long n, int steps,
                                    int doublings, int chain_first, long long table_words,
                                    void* stream) {
  if (n <= 0) return 0;
  if (steps < 0 || doublings < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (const int err = refuse<combine_kernel>(n, table_words)) return err;
  combine_kernel<<<grid_for(n), D::threads, sizeof(S), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(table), static_cast<const int32_t*>(ix),
      static_cast<const int32_t*>(iy), static_cast<const int32_t*>(iz),
      static_cast<const int32_t*>(wx), static_cast<const int32_t*>(wy),
      static_cast<const int32_t*>(wz), static_cast<int32_t*>(ox), static_cast<int32_t*>(oy),
      static_cast<int32_t*>(oz), n, steps, doublings, chain_first);
  return static_cast<int>(cudaGetLastError());
}
#else
#error "MANTA_KERNEL must be 0..5"
#endif
