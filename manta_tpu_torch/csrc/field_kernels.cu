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

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// Field constants: modulus p and 2p as little-endian 32-bit words, and
// n0' = −p^-1 mod 2^32. The CPU tests parse these tables and check them
// against `manta_tpu_torch/fields.py`.
struct Bn254Fr {
  static constexpr int kLimbs = 16;
  static constexpr uint32_t kN0 = 0xefffffffu;
  __device__ __forceinline__ static uint32_t p(int i) {
    constexpr uint32_t v[8] = {0xf0000001u, 0x43e1f593u, 0x79b97091u, 0x2833e848u,
                               0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u};
    return v[i];
  }
  __device__ __forceinline__ static uint32_t p2(int i) {
    constexpr uint32_t v[8] = {0xe0000002u, 0x87c3eb27u, 0xf372e122u, 0x5067d090u,
                               0x0302b0bau, 0x70a08b6du, 0xc2634053u, 0x60c89ce5u};
    return v[i];
  }
};

struct Bn254Fq {
  static constexpr int kLimbs = 16;
  static constexpr uint32_t kN0 = 0xe4866389u;
  __device__ __forceinline__ static uint32_t p(int i) {
    constexpr uint32_t v[8] = {0xd87cfd47u, 0x3c208c16u, 0x6871ca8du, 0x97816a91u,
                               0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u};
    return v[i];
  }
  __device__ __forceinline__ static uint32_t p2(int i) {
    constexpr uint32_t v[8] = {0xb0f9fa8eu, 0x7841182du, 0xd0e3951au, 0x2f02d522u,
                               0x0302b0bbu, 0x70a08b6du, 0xc2634053u, 0x60c89ce5u};
    return v[i];
  }
};

struct Bls12381Fr {
  static constexpr int kLimbs = 17;
  static constexpr uint32_t kN0 = 0xffffffffu;
  __device__ __forceinline__ static uint32_t p(int i) {
    constexpr uint32_t v[9] = {0x00000001u, 0xffffffffu, 0xfffe5bfeu, 0x53bda402u, 0x09a1d805u,
                               0x3339d808u, 0x299d7d48u, 0x73eda753u, 0x00000000u};
    return v[i];
  }
  __device__ __forceinline__ static uint32_t p2(int i) {
    constexpr uint32_t v[9] = {0x00000002u, 0xfffffffeu, 0xfffcb7fdu, 0xa77b4805u, 0x1343b00au,
                               0x6673b010u, 0x533afa90u, 0xe7db4ea6u, 0x00000000u};
    return v[i];
  }
};

struct Bls12381Fq {
  static constexpr int kLimbs = 24;
  static constexpr uint32_t kN0 = 0xfffcfffdu;
  __device__ __forceinline__ static uint32_t p(int i) {
    constexpr uint32_t v[12] = {0xffffaaabu, 0xb9feffffu, 0xb153ffffu, 0x1eabfffeu,
                                0xf6b0f624u, 0x6730d2a0u, 0xf38512bfu, 0x64774b84u,
                                0x434bacd7u, 0x4b1ba7b6u, 0x397fe69au, 0x1a0111eau};
    return v[i];
  }
  __device__ __forceinline__ static uint32_t p2(int i) {
    constexpr uint32_t v[12] = {0xffff5556u, 0x73fdffffu, 0x62a7ffffu, 0x3d57fffdu,
                                0xed61ec48u, 0xce61a541u, 0xe70a257eu, 0xc8ee9709u,
                                0x869759aeu, 0x96374f6cu, 0x72ffcd34u, 0x340223d4u};
    return v[i];
  }
};

enum Op : int { kMul = 0, kAdd = 1, kSub = 2 };

template <class F>
struct FieldOps {
  static constexpr int L = F::kLimbs;
  static constexpr int S = (L + 1) / 2;  // 32-bit words
  static constexpr bool kOdd = (L & 1) != 0;
  // the top word holds only 16 bits of the value when L is odd
  static constexpr uint32_t kTopMask = kOdd ? 0xffffu : 0xffffffffu;

  __device__ __forceinline__ static void load(const int32_t* __restrict__ src, int64_t n,
                                              int64_t j, uint32_t (&w)[S]) {
#pragma unroll
    for (int k = 0; k < S; ++k) {
      const uint32_t lo = static_cast<uint32_t>(src[(2 * k) * n + j]);
      const uint32_t hi =
          (2 * k + 1 < L) ? static_cast<uint32_t>(src[(2 * k + 1) * n + j]) : 0u;
      w[k] = lo | (hi << 16);
    }
  }

  __device__ __forceinline__ static void store(int32_t* __restrict__ dst, int64_t n, int64_t j,
                                               const uint32_t (&w)[S]) {
#pragma unroll
    for (int k = 0; k < S; ++k) {
      dst[(2 * k) * n + j] = static_cast<int32_t>(w[k] & 0xffffu);
      if (2 * k + 1 < L) dst[(2 * k + 1) * n + j] = static_cast<int32_t>(w[k] >> 16);
    }
  }

  // r = a + b, minus 2p when the 16·L-bit sum carries out or is >= 2p.
  __device__ __forceinline__ static void add(const uint32_t (&a)[S], const uint32_t (&b)[S],
                                             uint32_t (&r)[S]) {
    uint32_t s[S], d[S];
    uint64_t c = 0;
#pragma unroll
    for (int k = 0; k < S; ++k) {
      const uint64_t v = static_cast<uint64_t>(a[k]) + b[k] + c;
      s[k] = static_cast<uint32_t>(v);
      c = v >> 32;
    }
    uint32_t carry = static_cast<uint32_t>(c);
    if (kOdd) {
      carry = s[S - 1] >> 16;
      s[S - 1] &= 0xffffu;
    }
    uint64_t br = 0;
#pragma unroll
    for (int k = 0; k < S; ++k) {
      const uint64_t v = static_cast<uint64_t>(s[k]) - F::p2(k) - br;
      d[k] = static_cast<uint32_t>(v);
      br = v >> 63;
    }
    d[S - 1] &= kTopMask;
    const bool ge = (br == 0) || (carry != 0);
#pragma unroll
    for (int k = 0; k < S; ++k) r[k] = ge ? d[k] : s[k];
  }

  // r = a − b, plus 2p (mod 2^(16·L)) when it borrows.
  __device__ __forceinline__ static void sub(const uint32_t (&a)[S], const uint32_t (&b)[S],
                                             uint32_t (&r)[S]) {
    uint32_t d[S], e[S];
    uint64_t br = 0;
#pragma unroll
    for (int k = 0; k < S; ++k) {
      const uint64_t v = static_cast<uint64_t>(a[k]) - b[k] - br;
      d[k] = static_cast<uint32_t>(v);
      br = v >> 63;
    }
    d[S - 1] &= kTopMask;
    uint64_t c = 0;
#pragma unroll
    for (int k = 0; k < S; ++k) {
      const uint64_t v = static_cast<uint64_t>(d[k]) + F::p2(k) + c;
      e[k] = static_cast<uint32_t>(v);
      c = v >> 32;
    }
    e[S - 1] &= kTopMask;
#pragma unroll
    for (int k = 0; k < S; ++k) r[k] = br ? e[k] : d[k];
  }

  // r = a·b·2^(−16·L) mod 2^(16·L), CIOS over 32-bit words, no final subtract.
  __device__ __forceinline__ static void mul(const uint32_t (&a)[S], const uint32_t (&b)[S],
                                             uint32_t (&r)[S]) {
    uint32_t t[S + 2];
#pragma unroll
    for (int k = 0; k < S + 2; ++k) t[k] = 0;
#pragma unroll
    for (int i = 0; i < S; ++i) {
      // t += a·b[i]
      uint64_t c = 0;
#pragma unroll
      for (int k = 0; k < S; ++k) {
        const uint64_t v = static_cast<uint64_t>(a[k]) * b[i] + t[k] + c;
        t[k] = static_cast<uint32_t>(v);
        c = v >> 32;
      }
      uint64_t v = static_cast<uint64_t>(t[S]) + c;
      t[S] = static_cast<uint32_t>(v);
      t[S + 1] = static_cast<uint32_t>(v >> 32);
      if (kOdd && i == S - 1) {
        // last step of an odd limb count: reduce by 2^16 only
        const uint32_t m = (t[0] * F::kN0) & 0xffffu;
        c = 0;
#pragma unroll
        for (int k = 0; k < S; ++k) {
          const uint64_t w = static_cast<uint64_t>(m) * F::p(k) + t[k] + c;
          t[k] = static_cast<uint32_t>(w);
          c = w >> 32;
        }
        v = static_cast<uint64_t>(t[S]) + c;
        t[S] = static_cast<uint32_t>(v);
        t[S + 1] += static_cast<uint32_t>(v >> 32);
#pragma unroll
        for (int k = 0; k < S; ++k) r[k] = __funnelshift_r(t[k], t[k + 1], 16);
        r[S - 1] &= 0xffffu;
      } else {
        // t = (t + m·p) / 2^32
        const uint32_t m = t[0] * F::kN0;
        c = (static_cast<uint64_t>(m) * F::p(0) + t[0]) >> 32;
#pragma unroll
        for (int k = 1; k < S; ++k) {
          const uint64_t w = static_cast<uint64_t>(m) * F::p(k) + t[k] + c;
          t[k - 1] = static_cast<uint32_t>(w);
          c = w >> 32;
        }
        v = static_cast<uint64_t>(t[S]) + c;
        t[S - 1] = static_cast<uint32_t>(v);
        t[S] = t[S + 1] + static_cast<uint32_t>(v >> 32);
      }
    }
    if (!kOdd) {
#pragma unroll
      for (int k = 0; k < S; ++k) r[k] = t[k];  // t[S] falls off: mod 2^(16·L)
    }
  }
};

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
