// Montgomery field arithmetic over 32-bit words, shared by the CUDA kernels
// of `manta_tpu_torch` (`field_kernels.cu`, `point_kernels.cu`).
//
// Values are the JAX package's limb-major 16-bit limbs (int32 at the
// boundary, limbs < 2^16) packed two to a 32-bit word in registers, in
// Montgomery form with R = 2^(16·L) and lazy in [0, 2p). `FieldOps<F>` gives
// the same integers, bit for bit, as the 16-bit-limb JAX functions
// (`manta_tpu/ops/field_ops.py`, and the in-kernel ops of
// `manta_tpu/ops/pallas/field_kernels.py` / `point_kernels.py`):
//   mul: a·b·R^-1 with NO final subtract (lazy output < 2p for inputs < 2p);
//   add: a + b, minus 2p when the sum is >= 2p or carries out of 16·L bits;
//   sub: a − b, plus 2p when it borrows.
// Montgomery reduction without a final subtract returns the one value
// (T + M·p)/R mod R with M ≡ −T·p^-1 (mod R), 0 <= M < R, whatever the
// digit size of the reduction loop. So the loop here uses 32-bit words with
// n0' = −p^-1 mod 2^32 (not the JAX package's 16-bit n0_inv). For an odd
// limb count (BLS12-381 Fr, L = 17) the last reduction step is a 16-bit one,
// so that the total shift is still exactly 16·L bits.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace manta {

// Field constants: modulus p, 2p and the Montgomery one R mod p as
// little-endian 32-bit words, and n0' = −p^-1 mod 2^32. The CPU tests parse
// these tables and check them against `manta_tpu_torch/fields.py`.
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
  __device__ __forceinline__ static uint32_t one(int i) {
    constexpr uint32_t v[8] = {0x4ffffffbu, 0xac96341cu, 0x9f60cd29u, 0x36fc7695u,
                                0x7879462eu, 0x666ea36fu, 0x9a07df2fu, 0x0e0a77c1u};
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
  __device__ __forceinline__ static uint32_t one(int i) {
    constexpr uint32_t v[8] = {0xc58f0d9du, 0xd35d438du, 0xf5c70b3du, 0x0a78eb28u,
                                0x7879462cu, 0x666ea36fu, 0x9a07df2fu, 0x0e0a77c1u};
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
  __device__ __forceinline__ static uint32_t one(int i) {
    constexpr uint32_t v[9] = {0xfffdcab0u, 0x0002354fu, 0x9f797550u, 0x49c22013u, 0xcba8bc84u,
                                0x5422c03au, 0x69488061u, 0x43712b2au, 0x00000000u};
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
  __device__ __forceinline__ static uint32_t one(int i) {
    constexpr uint32_t v[12] = {0x0002fffdu, 0x76090000u, 0xc40c0002u, 0xebf4000bu,
                                0x53c758bau, 0x5f489857u, 0x70525745u, 0x77ce5853u,
                                0xa256ec6du, 0x5c071a97u, 0xfa80e493u, 0x15f65ec3u};
    return v[i];
  }
};

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

}  // namespace manta
