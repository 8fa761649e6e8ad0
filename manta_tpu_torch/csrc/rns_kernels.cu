// RNS curve kernels for Hopper (sm_90a): point op, bucket column, hybrid
// (limb-input) bucket column.
//
// Replaces the JAX package's Pallas TPU kernels in
// `manta_tpu/ops/pallas/rns_kernels.py`:
//   - `_rns_point_op` (public `RnsFusedCurveOps.add / madd / double`): one
//     whole add, mixed add or double per lane through the bound-annotated
//     formulas of `RnsCurveOps`, with the edge dispatch of `_add_dispatch`;
//   - `_rns_column_call` (public `rns_accumulate_columns`): per lane, for
//     k < K, acc = q[k] if head[k] else madd(acc, q[k]), q = (x, y, 1) or
//     infinity where qinf[k], the accumulator written after every step;
//   - `_hybrid_column_call` (public `hybrid_accumulate_columns`): the same
//     loop with the points given as 16-bit Montgomery limbs, each step's q
//     converted to RNS (`from_limbs`: the residues of the limb value, then
//     one RNS product by M1²·2^(−16 L)).
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
// modular products: ~3.5 k operations, against 2·8² + 8 word products for a
// 32-bit CIOS product, ~10 × the integer work of `point_kernels.cu`. The
// column kernel at K = 128 over 20 · 512 lanes (one G1 MSM of the production
// prover) writes the accumulator after every step: 3 × 128 × 51 × 10240 ×
// 4 B = 0.8 GB, 0.24 ms of bytes, against ~1.3 M mixed adds × 11 products
// × 3.5 k operations = ~5·10^10 operations, 0.7 ms: bound by operations.
// Expect the barriers (two per product, two per zero test) and one block
// per 8 lanes to set its time, not either bound; fewer barriers per formula
// and int8 tensor-core products for the extensions (6-bit digits fit) are
// the later speed steps.
//
// Built with `-DMANTA_CURVE=` 0 BN254 G1, 1 BN254 G2, 2 BLS12-381 G1,
// 3 BLS12-381 G2 and `-DMANTA_KERNEL=` 0 add, 1 madd, 2 double (with the
// zero-test launcher), 3 column, 4 hybrid column: one object per kernel and
// curve, compiled in parallel, one shared library per curve.

#include "rns_ops.cuh"

namespace {

using namespace manta_rns;

#ifndef MANTA_CURVE
#error "build with -DMANTA_CURVE=0..3 (BN254 G1, BN254 G2, BLS12-381 G1, BLS12-381 G2)"
#elif MANTA_CURVE == 0
using D = Bn254;
constexpr int NB = 2;
using O = BaseOps<D, NB>;
#elif MANTA_CURVE == 1
using D = Bn254;
constexpr int NB = 4;
using O = Fq2Ops<D, NB>;
#elif MANTA_CURVE == 2
using D = Bls12381;
constexpr int NB = 2;
using O = BaseOps<D, NB>;
#elif MANTA_CURVE == 3
using D = Bls12381;
constexpr int NB = 4;
using O = Fq2Ops<D, NB>;
#else
#error "MANTA_CURVE must be 0..3"
#endif

using S = Shared<D, NB>;

// only the kernel of this object (MANTA_KERNEL) is compiled into it
#if MANTA_KERNEL <= 2
template <int WHICH>
__global__ void __launch_bounds__(D::threads)
    point_kernel(const int32_t* __restrict__ table, const int32_t* __restrict__ px,
                 const int32_t* __restrict__ py, const int32_t* __restrict__ pz,
                 const int32_t* __restrict__ qx, const int32_t* __restrict__ qy,
                 const int32_t* __restrict__ qz, int32_t* __restrict__ ox,
                 int32_t* __restrict__ oy, int32_t* __restrict__ oz, int64_t n) {
  __shared__ S sh;
  point_block<D, NB, O, WHICH>(sh, table, px, py, pz, qx, qy, qz, ox, oy, oz, n);
}
#endif

#if MANTA_KERNEL == 3
__global__ void __launch_bounds__(D::threads)
    column_kernel(const int32_t* __restrict__ table, const int32_t* __restrict__ px,
                  const int32_t* __restrict__ py, const int32_t* __restrict__ qinf,
                  const int32_t* __restrict__ head, int32_t* __restrict__ ox,
                  int32_t* __restrict__ oy, int32_t* __restrict__ oz, int steps, int64_t lanes) {
  __shared__ S sh;
  column_block<D, NB, O>(sh, table, px, py, qinf, head, ox, oy, oz, steps, lanes);
}
#endif

#if MANTA_KERNEL == 4
__global__ void __launch_bounds__(D::threads)
    hybrid_kernel(const int32_t* __restrict__ table, const int32_t* __restrict__ px,
                  const int32_t* __restrict__ py, const int32_t* __restrict__ qinf,
                  const int32_t* __restrict__ head, int32_t* __restrict__ ox,
                  int32_t* __restrict__ oy, int32_t* __restrict__ oz, int steps, int64_t lanes) {
  __shared__ S sh;
  hybrid_block<D, NB, O>(sh, table, px, py, qinf, head, ox, oy, oz, steps, lanes);
}
#endif

#if MANTA_KERNEL == 2
__global__ void __launch_bounds__(D::threads)
    zero_kernel(const int32_t* __restrict__ table, const int32_t* __restrict__ a,
                int32_t* __restrict__ out, int64_t n) {
  __shared__ S sh;
  zero_block<D, NB>(sh, table, a, out, n);
}
#endif

inline dim3 grid_for(int64_t lanes) {
  return dim3(static_cast<unsigned>((lanes + kLanes - 1) / kLanes));
}

// 0 when the launch can go ahead, else the cudaError_t to return
inline int refuse(long long lanes, long long table_words) {
  if (table_words != D::kWords) return static_cast<int>(cudaErrorInvalidValue);
  if ((lanes + kLanes - 1) / kLanes > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  return 0;
}

#if MANTA_KERNEL <= 2
template <int WHICH>
int launch_point(const void* table, const void* px, const void* py, const void* pz,
                 const void* qx, const void* qy, const void* qz, void* ox, void* oy, void* oz,
                 long long n, long long table_words, void* stream) {
  if (n <= 0) return 0;
  if (const int err = refuse(n, table_words)) return err;
  point_kernel<WHICH><<<grid_for(n), D::threads, 0, static_cast<cudaStream_t>(stream)>>>(
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
#error "build with -DMANTA_KERNEL=0..4 (add, madd, double, column, hybrid column)"
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
  if (const int err = refuse(n, table_words)) return err;
  zero_kernel<<<grid_for(n), D::threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(table), static_cast<const int32_t*>(a),
      static_cast<int32_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
#endif
#elif MANTA_KERNEL <= 4
// px, py: (K, *E, R) residues (column) or limbs (hybrid); qinf, head: (K, R);
// ox, oy, oz: (K, *E, R) residues.
#if MANTA_KERNEL == 3
#define MANTA_RNS_COLUMN_NAME manta_rns_accumulate_columns
#define MANTA_RNS_COLUMN_KERNEL column_kernel
#else
#define MANTA_RNS_COLUMN_NAME manta_rns_hybrid_columns
#define MANTA_RNS_COLUMN_KERNEL hybrid_kernel
#endif
extern "C" int MANTA_RNS_COLUMN_NAME(const void* table, const void* px, const void* py,
                                     const void* qinf, const void* head, void* ox, void* oy,
                                     void* oz, int steps, long long lanes, long long table_words,
                                     void* stream) {
  if (lanes <= 0 || steps <= 0) return 0;
  if (const int err = refuse(lanes, table_words)) return err;
  MANTA_RNS_COLUMN_KERNEL<<<grid_for(lanes), D::threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(table), static_cast<const int32_t*>(px),
      static_cast<const int32_t*>(py), static_cast<const int32_t*>(qinf),
      static_cast<const int32_t*>(head), static_cast<int32_t*>(ox), static_cast<int32_t*>(oy),
      static_cast<int32_t*>(oz), steps, lanes);
  return static_cast<int>(cudaGetLastError());
}
#else
#error "MANTA_KERNEL must be 0..4"
#endif
