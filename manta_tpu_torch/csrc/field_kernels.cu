// Elementwise Montgomery field kernels (mul / add / sub) for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel
// `manta_tpu/ops/pallas/field_kernels.py::_binary_op` (the pallas_call built
// there, with the bodies `_mul_kernel`, `_add_kernel`, `_sub_kernel` and the
// public `mont_mul` / `add` / `sub`).
//
// What it computes, lane by lane over (L, n) limb-major arrays of 16-bit
// limbs held in int32 (limbs must be < 2^16), with R = 2^(16·L):
//   mul: a·b·R^-1 with NO final subtract (lazy output < 2p for inputs < 2p);
//   add: a + b, minus 2p when the sum is >= 2p or carries out of 16·L bits;
//   sub: a − b, plus 2p when it borrows.
// The results are the same integers, bit for bit, as the 16-bit-limb JAX
// functions: Montgomery reduction without a final subtract returns the one
// value (T + M·p)/R mod R with M ≡ −T·p^-1 (mod R), 0 <= M < R, whatever
// the digit size of the reduction loop. So the loop here uses 32-bit words
// with n0' = −p^-1 mod 2^32 (not the JAX package's 16-bit n0_inv). For an
// odd limb count (BLS12-381 Fr, L = 17) the last reduction step is a 16-bit
// one, so that the total shift is still exactly 16·L bits.
//
// Design: one thread per lane, the value in registers as L/2 32-bit words.
// Limb k of lane j sits at k·n + j, so neighbouring threads load and store
// neighbouring 4-byte words (coalesced). CIOS Montgomery with 32×32→64-bit
// products. Any n: the tail block is masked. The TPU kernel's rule that n be a
// multiple of 256 does not apply.
//
// Bound on the H100 (3.35 TB/s HBM; 67 TFLOP/s is the card's non-tensor rate,
// used as the ceiling for 32-bit integer multiply-adds): per lane the kernel
// reads 2·L·4 bytes and writes L·4 bytes. At L = 16 that is 192 B a lane, so
// n = 826224 (the prover's largest row-evaluation multiply) moves 159 MB,
// 47 µs at the memory rate; mul adds 2·S² + S 32-bit multiply-adds a lane
// (S = L/2 words: 136 at L = 16), about 3 µs at the ceiling above. All three
// ops are bound by bytes, and the design does nothing cleverer than keep the
// value in registers and the accesses coalesced. At the MSM's 512 or 1024
// lanes a launch costs more than the work (a few µs of launch against
// nanoseconds of memory traffic): the fused point kernels that keep a whole
// curve formula in one launch are the answer to that, not this kernel.

#include "field_ops.cuh"

namespace {

using namespace manta;

enum Op : int { kMul = 0, kAdd = 1, kSub = 2 };

constexpr int kThreads = 256;

template <class F, int OP>
__global__ void __launch_bounds__(kThreads)
    binary_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                  int32_t* __restrict__ out, int64_t n) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (j >= n) return;
  using O = FieldOps<F>;
  uint32_t x[O::S], y[O::S], r[O::S];
  O::load(a, n, j, x);
  O::load(b, n, j, y);
  if constexpr (OP == kMul) {
    O::mul(x, y, r);
  } else if constexpr (OP == kAdd) {
    O::add(x, y, r);
  } else {
    O::sub(x, y, r);
  }
  O::store(out, n, j, r);
}

template <class F>
cudaError_t launch(int op, const int32_t* a, const int32_t* b, int32_t* out, int64_t n,
                   cudaStream_t stream) {
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const dim3 grid(static_cast<unsigned>(blocks));
  switch (op) {
    case kMul:
      binary_kernel<F, kMul><<<grid, kThreads, 0, stream>>>(a, b, out, n);
      break;
    case kAdd:
      binary_kernel<F, kAdd><<<grid, kThreads, 0, stream>>>(a, b, out, n);
      break;
    case kSub:
      binary_kernel<F, kSub><<<grid, kThreads, 0, stream>>>(a, b, out, n);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// field: 0 = BN254 Fr, 1 = BN254 Fq, 2 = BLS12-381 Fr, 3 = BLS12-381 Fq.
// op: 0 = mul, 1 = add, 2 = sub. a, b, out: (L, n) int32, contiguous.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int manta_field_binary(int field, int op, const void* a, const void* b, void* out,
                                  long long n, void* stream) {
  if (n <= 0) return 0;
  const auto* pa = static_cast<const int32_t*>(a);
  const auto* pb = static_cast<const int32_t*>(b);
  auto* po = static_cast<int32_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  switch (field) {
    case 0: return launch<Bn254Fr>(op, pa, pb, po, n, st);
    case 1: return launch<Bn254Fq>(op, pa, pb, po, n, st);
    case 2: return launch<Bls12381Fr>(op, pa, pb, po, n, st);
    case 3: return launch<Bls12381Fq>(op, pa, pb, po, n, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
