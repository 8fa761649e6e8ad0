// RNS field and curve arithmetic as device functions for the kernels of
// `rns_kernels.cu`, channels across threads.
//
// A field element is the residue vector of the JAX package's RNS form
// (`manta_tpu/ops/rns.py`): residues of x·M1 (+ a lazy multiple of p) modulo
// k1 12-bit primes of B1, k2 of B2 and one redundant prime m_r, Kt = k1 + k2
// + 1 channels, each residue canonical in [0, m). The JAX kernels
// (`manta_tpu/ops/pallas/rns_kernels.py`, `_KernelRnsOps`) compute in exact
// float32: Barrett steps by a float reciprocal, base extensions as 6-bit
// digit-split float matrix products, the zero test as one product against a
// 2^13-row table. Here everything is 32-bit integer arithmetic: residues are
// < 2^12, so a channel product is < 2^24 and an extension sum of <= 37
// products is < 2^30, exact in uint32; `x mod m` is a Barrett step with
// minv = floor(2^32 / m) (`reduce`). Every step returns the canonical
// residue, as every float step of the JAX kernel does, so the outputs are the
// JAX kernel's residues bit for bit.
//
// Layout. One thread per (lane, channel): a block holds kLanes = 8 lanes and
// Kp = Kt rounded up to a multiple of 4 channels, thread t = c·8 + l, so a
// warp holds 4 channels of 8 neighbouring lanes, and each channel's 8
// residues are one 32-byte sector of the channels-major (Kt, n) arrays. A
// coordinate is one register per thread (two for Fq2). Each channel's
// products are independent; three steps cross channels, through shared
// memory:
//   - the two base extensions: sigma (B1) -> B2 ∪ {m_r} by the constant
//     (k2+1)×k1 matrix A1, and sigma2 (B2) -> B1 by the k1×k2 matrix A2 and
//     the A2r row, the matrices held in shared memory;
//   - the Shenoy α from the redundant channel: every B1 thread computes the
//     A2r sum itself, so α needs no extra barrier;
//   - the zero test (below).
// A product costs two barriers; `mul_n` runs up to 4 independent products
// through the same two (the four base products of an Fq2 product).
//
// The zero test needs no table. The JAX kernel asks whether the residue
// vector equals k·p for some k < 2^13. Here k0 = x·p^-1 mod m_a·m_b is
// recovered from channels 0 and 1 by CRT (m_a·m_b > 2^13), and the value is
// zero iff k0 < 2^13 and every channel equals (k0·p) mod m_i: a residue
// vector fixes the integer modulo M1·M2·m_r, so this holds exactly when a
// table row matches. The per-lane AND over channels is a warp vote and a
// word per warp in shared memory.
//
// Nothing here launches: a host C++ harness can include this header with the
// CUDA built-ins defined for CPU threads and run whole blocks on the CPU.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace manta_rns {

constexpr int kLanes = 8;             // lanes of a block: one 32-byte sector
constexpr uint32_t kZeroClasses = 8192;  // the JAX kernel's zero-class rows

// Compile-time shape of one base field's RNS, and the layout of the int32
// constant table that `ops/kernels/rns_kernels.py::device_table` builds.
template <int K1, int K2, int L>
struct Dims {
  static constexpr int k1 = K1;
  static constexpr int k2 = K2;
  static constexpr int kt = K1 + K2 + 1;
  static constexpr int kp = (kt + 3) / 4 * 4;  // whole warps of 4 channels
  static constexpr int limbs = L;
  static constexpr int threads = kp * kLanes;
  static constexpr int warps = threads / 32;
  // per-channel rows of kp words (see `Row`), then A1 ((k2+1) rows of k1),
  // then A2 (k1 rows of k2) and the A2r row, then the limb table (kp rows of
  // L: 2^(16 i) mod m), then the scalars (see `Scalar`)
  static constexpr int kRows = 20;
  static constexpr int kA1 = kRows * kp;
  static constexpr int kA2 = kA1 + (K2 + 1) * K1;
  static constexpr int kT = kA2 + (K1 + 1) * K2;
  static constexpr int kScalars = kT + kp * L;
  static constexpr int kWords = kScalars + 8;
};

using Bn254 = Dims<25, 25, 16>;      // BN254 Fq
using Bls12381 = Dims<37, 37, 24>;   // BLS12-381 Fq

enum Row {
  kM = 0,     // modulus of the channel
  kMinv,      // floor(2^32 / m)
  kNegPInv1,  // B1: −p^-1 mod m
  kW1,        // B1: (M1/m)^-1 mod m
  kP2r,       // B2 ∪ r: p mod m
  kM1Inv2r,   // B2 ∪ r: M1^-1 mod m
  kW2,        // B2: (M2/m)^-1 mod m
  kM2Mod1,    // B1: M2 mod m
  kOne,       // residues of the encoded 1 (M1 mod p)
  kPmod,      // p mod m (zero test)
  kOff5,      // 2^k·p mod m for k = 5..13: rows kOff5 .. kOff5 + 8
  kConvk = 19,  // residues of M1^2·2^(−16 L) mod p (limb -> RNS)
};

enum Scalar { kMr = 0, kMinvR, kM2InvR, kPinvA, kPinvB, kMaInvB };

enum Role { kB1 = 0, kB2, kRed, kPad };

// x mod m for x < 2^32: q = floor(x·minv / 2^32) is floor(x/m) or one less.
__device__ __forceinline__ uint32_t reduce(uint32_t x, uint32_t m, uint32_t minv) {
  const uint32_t q = __umulhi(x, minv);
  const uint32_t r = x - q * m;
  return r >= m ? r - m : r;
}

// Shared memory of one block. NB: the most products `mul_n` runs at once.
template <class D, int NB>
struct Shared {
  int32_t table[D::kWords];
  uint32_t sig[NB][D::k1][kLanes];
  uint32_t sig2[NB][D::k2][kLanes];
  uint32_t outr[NB][kLanes];
  uint32_t zr[2][2][kLanes];  // channels 0 and 1 of up to two components
  uint32_t vote[D::warps];
  int32_t limbs[2][2][D::limbs][kLanes];  // hybrid: x, y limbs of <= 2 components
};

// The thread's channel, lane, role and per-channel constants.
template <class D, int NB>
struct Ctx {
  using Sh = Shared<D, NB>;
  Sh& sh;
  int c, l, role;
  uint32_t m, minv;

  __device__ Ctx(Sh& s, int t) : sh(s), c(t / kLanes), l(t % kLanes) {
    role = c < D::k1 ? kB1 : c < D::k1 + D::k2 ? kB2 : c == D::kt - 1 ? kRed : kPad;
    m = row(kM);
    minv = row(kMinv);
  }
  __device__ __forceinline__ uint32_t row(int r) const {
    return static_cast<uint32_t>(sh.table[r * D::kp + c]);
  }
  __device__ __forceinline__ uint32_t scalar(int s) const {
    return static_cast<uint32_t>(sh.table[D::kScalars + s]);
  }
  __device__ __forceinline__ uint32_t mod(uint32_t x) const { return reduce(x, m, minv); }
  __device__ __forceinline__ uint32_t mulmod(uint32_t a, uint32_t b) const {
    return reduce(a * b, m, minv);
  }

  // -- RNS Montgomery products: N independent ones, two barriers --
  template <int N>
  __device__ void mul_n(const uint32_t (&a)[N], const uint32_t (&b)[N], uint32_t (&out)[N]) {
    static_assert(N <= NB, "more products than the shared buffers hold");
    uint32_t t[N];
#pragma unroll
    for (int n = 0; n < N; ++n) t[n] = mulmod(a[n], b[n]);
    if (role == kB1) {
      const uint32_t npi = row(kNegPInv1), w1 = row(kW1);
#pragma unroll
      for (int n = 0; n < N; ++n) sh.sig[n][c][l] = mulmod(mulmod(t[n], npi), w1);
    }
    __syncthreads();
    if (role == kB2 || role == kRed) {
      // ext1 without the α correction: m̂ = sum_i A1[c][i]·sigma_i mod m
      const int32_t* arow = sh.table + D::kA1 + (c - D::k1) * D::k1;
      const uint32_t pm = row(kP2r), minv1 = row(kM1Inv2r);
#pragma unroll
      for (int n = 0; n < N; ++n) {
        uint32_t s = 0;
#pragma unroll 5
        for (int i = 0; i < D::k1; ++i) s += static_cast<uint32_t>(arow[i]) * sh.sig[n][i][l];
        uint32_t u = t[n] + mulmod(mod(s), pm);
        u = u >= m ? u - m : u;
        out[n] = mulmod(u, minv1);
      }
      if (role == kB2) {
        const uint32_t w2 = row(kW2);
#pragma unroll
        for (int n = 0; n < N; ++n) sh.sig2[n][c - D::k1][l] = mulmod(out[n], w2);
      } else {
#pragma unroll
        for (int n = 0; n < N; ++n) sh.outr[n][l] = out[n];
      }
    }
    __syncthreads();
    if (role == kB1) {
      // ext2 (Shenoy): sum_j A2[c][j]·sigma2_j, α from the redundant channel
      const int32_t* arow = sh.table + D::kA2 + c * D::k2;
      const int32_t* rrow = sh.table + D::kA2 + D::k1 * D::k2;
      const uint32_t mr = scalar(kMr), minvr = scalar(kMinvR), m2invr = scalar(kM2InvR);
      const uint32_t m2mod = row(kM2Mod1);
#pragma unroll
      for (int n = 0; n < N; ++n) {
        uint32_t s = 0, sr = 0;
#pragma unroll 5
        for (int j = 0; j < D::k2; ++j) {
          const uint32_t x = sh.sig2[n][j][l];
          s += static_cast<uint32_t>(arow[j]) * x;
          sr += static_cast<uint32_t>(rrow[j]) * x;
        }
        uint32_t d = reduce(sr, mr, minvr) + mr - sh.outr[n][l];
        d = d >= mr ? d - mr : d;
        const uint32_t alpha = reduce(d * m2invr, mr, minvr);
        const uint32_t corr = mulmod(alpha, m2mod);
        const uint32_t o = mod(s);
        out[n] = o >= corr ? o - corr : o + m - corr;
      }
    }
    if (role == kPad) {
#pragma unroll
      for (int n = 0; n < N; ++n) out[n] = 0u;
    }
  }

  // -- per-channel ops (canonical residues in, canonical out) --
  __device__ __forceinline__ uint32_t add(uint32_t a, uint32_t b) const {
    const uint32_t s = a + b;
    return s >= m ? s - m : s;
  }
  // a − b + 2^k·p, k = 5..13
  __device__ __forceinline__ uint32_t sub_k(uint32_t a, uint32_t b, int k) const {
    uint32_t x = a + row(kOff5 + k - 5) + (m - b);
    x = x >= m ? x - m : x;
    return x >= m ? x - m : x;
  }

  // -- the per-lane AND over the lane's channel threads (one barrier) --
  __device__ bool lane_all(bool ok) {
    unsigned fail = __ballot_sync(0xffffffffu, !ok);
    fail |= fail >> 16;
    fail |= fail >> 8;
    if ((threadIdx.x & 31) == 0) sh.vote[threadIdx.x >> 5] = fail & 0xffu;
    __syncthreads();
    unsigned all = 0;
#pragma unroll
    for (int w = 0; w < D::warps; ++w) all |= sh.vote[w];
    return !((all >> l) & 1u);
  }

  // value ≡ 0 (mod p) for every one of N components (two barriers)
  template <int N>
  __device__ bool is_zero(const uint32_t (&a)[N]) {
    if (c < 2) {
#pragma unroll
      for (int n = 0; n < N; ++n) sh.zr[n][c][l] = a[n];
    }
    __syncthreads();
    bool ok = true;
    if (role != kPad) {
      const uint32_t ma = static_cast<uint32_t>(sh.table[kM * D::kp]);
      const uint32_t mb = static_cast<uint32_t>(sh.table[kM * D::kp + 1]);
      const uint32_t minva = static_cast<uint32_t>(sh.table[kMinv * D::kp]);
      const uint32_t minvb = static_cast<uint32_t>(sh.table[kMinv * D::kp + 1]);
      const uint32_t pinva = scalar(kPinvA), pinvb = scalar(kPinvB), mainvb = scalar(kMaInvB);
      const uint32_t pm = row(kPmod);
#pragma unroll
      for (int n = 0; n < N; ++n) {
        // k0 = x·p^-1 mod m_a·m_b by Garner: k_a + m_a·((k_b − k_a)·m_a^-1 mod m_b)
        const uint32_t ka = reduce(sh.zr[n][0][l] * pinva, ma, minva);
        const uint32_t kb = reduce(sh.zr[n][1][l] * pinvb, mb, minvb);
        const uint32_t ka_b = ka >= mb ? ka - mb : ka;  // ka < m_a < 2·m_b
        uint32_t d = kb + mb - ka_b;
        d = d >= mb ? d - mb : d;
        const uint32_t k0 = ka + ma * reduce(d * mainvb, mb, minvb);
        ok = ok && k0 < kZeroClasses && a[n] == mulmod(mod(k0), pm);
      }
    }
    return lane_all(ok);
  }
};

// -- coordinate types: one residue (G1), or two for Fq2 (G2) --

template <class D, int NB>
struct BaseOps {
  using X = Ctx<D, NB>;
  using V = uint32_t;
  static constexpr int kComps = 1;
  __device__ static V mul(X& x, V a, V b) {
    uint32_t in_a[1] = {a}, in_b[1] = {b}, out[1];
    x.mul_n(in_a, in_b, out);
    return out[0];
  }
  __device__ static V sqr(X& x, V a) { return mul(x, a, a); }
  __device__ static V add(const X& x, V a, V b) { return x.add(a, b); }
  __device__ static V sub_k(const X& x, V a, V b, int k) { return x.sub_k(a, b, k); }
  __device__ static bool is_zero(X& x, V a) {
    uint32_t in[1] = {a};
    return x.is_zero(in);
  }
  __device__ static V zero(const X&) { return 0u; }
  __device__ static V one(const X& x) { return x.row(kOne); }
  __device__ static uint32_t comp(V a, int) { return a; }
  __device__ static V make(const uint32_t* a) { return a[0]; }
};

// Fq[u]/(u^2 + 1), as `_KernelRnsFq2Ops`: schoolbook product (four base
// products, c0 = sub_k(a0 b0, a1 b1, 6), c1 = a0 b1 + a1 b0), and every
// requested sub_k offset raised by one (components run one bit wider).
template <class D, int NB>
struct Fq2Ops {
  using X = Ctx<D, NB>;
  struct V {
    uint32_t c0, c1;
  };
  static constexpr int kComps = 2;
  __device__ static V mul(X& x, V a, V b) {
    uint32_t in_a[4] = {a.c0, a.c1, a.c0, a.c1}, in_b[4] = {b.c0, b.c1, b.c1, b.c0}, t[4];
    x.mul_n(in_a, in_b, t);
    return V{x.sub_k(t[0], t[1], 6), x.add(t[2], t[3])};
  }
  __device__ static V sqr(X& x, V a) { return mul(x, a, a); }
  __device__ static V add(const X& x, V a, V b) { return V{x.add(a.c0, b.c0), x.add(a.c1, b.c1)}; }
  __device__ static V sub_k(const X& x, V a, V b, int k) {
    return V{x.sub_k(a.c0, b.c0, k + 1), x.sub_k(a.c1, b.c1, k + 1)};
  }
  __device__ static bool is_zero(X& x, V a) {
    uint32_t in[2] = {a.c0, a.c1};
    return x.is_zero(in);
  }
  __device__ static V zero(const X&) { return V{0u, 0u}; }
  __device__ static V one(const X& x) { return V{x.row(kOne), 0u}; }
  __device__ static uint32_t comp(V a, int i) { return i ? a.c1 : a.c0; }
  __device__ static V make(const uint32_t* a) { return V{a[0], a[1]}; }
};

template <class O>
struct Point {
  typename O::V x, y, z;
};

template <class O>
__device__ __forceinline__ Point<O> select(bool m, const Point<O>& a, const Point<O>& b) {
  return m ? a : b;
}

// The bound-annotated formulas of `RnsCurveOps` (manta_tpu_torch/ops/curve.py,
// the JAX package's `curve.py::RnsCurveOps`), op for op, with the sub_k
// offsets literal for literal, and the edge dispatch of `_add_dispatch`.
template <class O>
struct Formulas {
  using X = typename O::X;
  using V = typename O::V;
  using P = Point<O>;

  __device__ static V dbl_raw(const X& x, V a) { return O::add(x, a, a); }

  __device__ static P dbl(X& x, const P& p) {
    const V a = O::sqr(x, p.x);
    const V b = O::sqr(x, p.y);
    const V c = O::sqr(x, b);
    const V t = O::sqr(x, O::add(x, p.x, b));
    const V d = dbl_raw(x, O::sub_k(x, O::sub_k(x, t, a, 6), c, 6));
    const V e = O::add(x, O::add(x, a, a), a);
    const V f = O::sqr(x, e);
    const V x3 = O::sub_k(x, f, dbl_raw(x, d), 10);
    const V c8 = dbl_raw(x, dbl_raw(x, dbl_raw(x, c)));
    const V y3 = O::sub_k(x, O::mul(x, e, O::sub_k(x, d, x3, 11)), c8, 9);
    const V z3 = O::mul(x, dbl_raw(x, p.y), p.z);
    return P{x3, y3, z3};
  }

  __device__ static P dispatch(X& x, const P& p, const P& q, const P& generic, bool h_zero,
                               bool r_zero) {
    const bool p_inf = O::is_zero(x, p.z);
    const bool q_inf = O::is_zero(x, q.z);
    const bool either = p_inf || q_inf;
    const bool is_dbl = h_zero && r_zero && !either;
    const bool is_inf = h_zero && !r_zero && !either;
    P d = p;
    // block-uniform: the doubling's barriers are reached by every thread
    if (__syncthreads_or(is_dbl)) d = dbl(x, p);
    const P inf{O::zero(x), O::one(x), O::zero(x)};
    P out = select(is_dbl, d, generic);
    out = select(is_inf, inf, out);
    out = select(q_inf, p, out);
    return select(p_inf, q, out);
  }

  __device__ static P add(X& x, const P& p, const P& q) {
    const V z1z1 = O::sqr(x, p.z);
    const V z2z2 = O::sqr(x, q.z);
    const V u1 = O::mul(x, p.x, z2z2);
    const V u2 = O::mul(x, q.x, z1z1);
    const V s1 = O::mul(x, O::mul(x, p.y, q.z), z2z2);
    const V s2 = O::mul(x, O::mul(x, q.y, p.z), z1z1);
    const V h = O::sub_k(x, u2, u1, 6);
    const V rr = O::sub_k(x, s2, s1, 6);
    const bool h_zero = O::is_zero(x, h);
    const bool r_zero = O::is_zero(x, rr);
    const V i = O::sqr(x, dbl_raw(x, h));
    const V j = O::mul(x, h, i);
    const V r2 = dbl_raw(x, rr);
    const V v = O::mul(x, u1, i);
    const V x3 = O::sub_k(x, O::sub_k(x, O::sqr(x, r2), j, 6), dbl_raw(x, v), 7);
    const V y3 = O::sub_k(x, O::mul(x, r2, O::sub_k(x, v, x3, 9)),
                          dbl_raw(x, O::mul(x, s1, j)), 7);
    const V z3 = O::mul(x, O::mul(x, dbl_raw(x, p.z), q.z), h);
    return dispatch(x, p, q, P{x3, y3, z3}, h_zero, r_zero);
  }

  __device__ static P madd(X& x, const P& p, const P& q) {
    const V z1z1 = O::sqr(x, p.z);
    const V u2 = O::mul(x, q.x, z1z1);
    const V s2 = O::mul(x, O::mul(x, q.y, p.z), z1z1);
    const V h = O::sub_k(x, u2, p.x, 11);
    const V rhalf = O::sub_k(x, s2, p.y, 10);
    const bool h_zero = O::is_zero(x, h);
    const bool r_zero = O::is_zero(x, rhalf);
    const V hh = O::sqr(x, h);
    const V i4 = dbl_raw(x, dbl_raw(x, hh));
    const V j = O::mul(x, h, i4);
    const V r = dbl_raw(x, rhalf);
    const V v = O::mul(x, p.x, i4);
    const V x3 = O::sub_k(x, O::sub_k(x, O::sqr(x, r), j, 6), dbl_raw(x, v), 7);
    const V y3 = O::sub_k(x, O::mul(x, r, O::sub_k(x, v, x3, 9)),
                          dbl_raw(x, O::mul(x, p.y, j)), 7);
    const V z3 = O::sub_k(x, O::sub_k(x, O::sqr(x, O::add(x, p.z, h)), z1z1, 6), hh, 6);
    return dispatch(x, p, q, P{x3, y3, z3}, h_zero, r_zero);
  }
};

// -- loads and stores of one coordinate: (comps, Kt, n) int32, channel c of
// lane j; a pad channel or a lane past n reads 0 and writes nothing --

template <class D, class O>
__device__ __forceinline__ typename O::V load(const int32_t* __restrict__ src, int64_t n,
                                              int c, int64_t j) {
  uint32_t v[2] = {0u, 0u};
  if (c < D::kt && j < n) {
#pragma unroll
    for (int i = 0; i < O::kComps; ++i) v[i] = static_cast<uint32_t>(src[(i * D::kt + c) * n + j]);
  }
  return O::make(v);
}

template <class D, class O>
__device__ __forceinline__ void store(int32_t* __restrict__ dst, int64_t n, int c, int64_t j,
                                      typename O::V a) {
  if (c < D::kt && j < n) {
#pragma unroll
    for (int i = 0; i < O::kComps; ++i) dst[(i * D::kt + c) * n + j] = static_cast<int32_t>(O::comp(a, i));
  }
}

// Copy the constant table into shared memory (every thread, then a barrier).
template <class D, class S>
__device__ __forceinline__ void load_table(S& sh, const int32_t* __restrict__ table) {
  for (int i = threadIdx.x; i < D::kWords; i += D::threads) sh.table[i] = table[i];
  __syncthreads();
}

// limb -> RNS for one lane and channel: the residue of v = sum_i limb_i·2^(16 i)
// (limbs of lane l in shared memory), reduced every 15 terms so the sum stays
// below 2^32 (limb < 2^16, table entry < 2^12).
template <class D, int NB>
__device__ __forceinline__ uint32_t limb_residue(const Ctx<D, NB>& x, const int32_t (&limbs)[D::limbs][kLanes]) {
  const int32_t* trow = x.sh.table + D::kT + x.c * D::limbs;
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < D::limbs; ++i) {
    acc += static_cast<uint32_t>(limbs[i][x.l]) * static_cast<uint32_t>(trow[i]);
    if (i % 15 == 14) acc = x.mod(acc);
  }
  return x.mod(acc);
}

// -- the bodies of the kernels of rns_kernels.cu: one block of 8 lanes each,
// `sh` the block's shared memory --

enum Which { kAdd = 0, kMadd = 1, kDouble = 2 };

template <class D, int NB, class O, int WHICH>
__device__ void point_block(Shared<D, NB>& sh, const int32_t* __restrict__ table,
                            const int32_t* __restrict__ px, const int32_t* __restrict__ py,
                            const int32_t* __restrict__ pz, const int32_t* __restrict__ qx,
                            const int32_t* __restrict__ qy, const int32_t* __restrict__ qz,
                            int32_t* __restrict__ ox, int32_t* __restrict__ oy,
                            int32_t* __restrict__ oz, int64_t n) {
  using F = Formulas<O>;
  using P = Point<O>;
  load_table<D>(sh, table);
  Ctx<D, NB> x(sh, threadIdx.x);
  const int64_t j = static_cast<int64_t>(blockIdx.x) * kLanes + x.l;
  const P p{load<D, O>(px, n, x.c, j), load<D, O>(py, n, x.c, j), load<D, O>(pz, n, x.c, j)};
  P r;
  if (WHICH == kDouble) {
    r = F::dbl(x, p);
  } else {
    const P q{load<D, O>(qx, n, x.c, j), load<D, O>(qy, n, x.c, j), load<D, O>(qz, n, x.c, j)};
    r = WHICH == kAdd ? F::add(x, p, q) : F::madd(x, p, q);
  }
  store<D, O>(ox, n, x.c, j, r.x);
  store<D, O>(oy, n, x.c, j, r.y);
  store<D, O>(oz, n, x.c, j, r.z);
}

// One step of the column loop: q = (x, y, 1), or infinity (x, 1, 0) where
// qinf; acc = q at a head, else madd(acc, q); acc stored at step k.
template <class D, int NB, class O>
__device__ __forceinline__ void column_step(Ctx<D, NB>& x, Point<O>& acc, typename O::V qx,
                                            typename O::V qy, bool q_inf, bool is_head,
                                            int32_t* __restrict__ ox, int32_t* __restrict__ oy,
                                            int32_t* __restrict__ oz, int64_t lanes, int64_t j) {
  const typename O::V one = O::one(x);
  const Point<O> q{qx, q_inf ? one : qy, q_inf ? O::zero(x) : one};
  const Point<O> added = Formulas<O>::madd(x, acc, q);
  acc = select(is_head, q, added);
  store<D, O>(ox, lanes, x.c, j, acc.x);
  store<D, O>(oy, lanes, x.c, j, acc.y);
  store<D, O>(oz, lanes, x.c, j, acc.z);
}

// px, py, ox, oy, oz: (K, *E, R); one step of a coordinate is comps·Kt·R words
template <class D, int NB, class O>
__device__ void column_block(Shared<D, NB>& sh, const int32_t* __restrict__ table,
                             const int32_t* __restrict__ px, const int32_t* __restrict__ py,
                             const int32_t* __restrict__ qinf, const int32_t* __restrict__ head,
                             int32_t* __restrict__ ox, int32_t* __restrict__ oy,
                             int32_t* __restrict__ oz, int steps, int64_t lanes) {
  load_table<D>(sh, table);
  Ctx<D, NB> x(sh, threadIdx.x);
  const int64_t j = static_cast<int64_t>(blockIdx.x) * kLanes + x.l;
  const bool live = j < lanes;
  const int64_t step = static_cast<int64_t>(O::kComps) * D::kt * lanes;
  Point<O> acc{O::zero(x), O::one(x), O::zero(x)};
  for (int k = 0; k < steps; ++k) {
    const int64_t at = k * step;
    const bool q_inf = live && qinf[k * lanes + j] != 0;
    const bool is_head = live && head[k * lanes + j] != 0;
    column_step<D, NB, O>(x, acc, load<D, O>(px + at, lanes, x.c, j),
                          load<D, O>(py + at, lanes, x.c, j), q_inf, is_head, ox + at, oy + at,
                          oz + at, lanes, j);
  }
}

// px, py: (K, *E(L), R) 16-bit limbs; ox, oy, oz: (K, *E(Kt), R) residues
template <class D, int NB, class O>
__device__ void hybrid_block(Shared<D, NB>& sh, const int32_t* __restrict__ table,
                             const int32_t* __restrict__ px, const int32_t* __restrict__ py,
                             const int32_t* __restrict__ qinf, const int32_t* __restrict__ head,
                             int32_t* __restrict__ ox, int32_t* __restrict__ oy,
                             int32_t* __restrict__ oz, int steps, int64_t lanes) {
  constexpr int C = O::kComps;
  constexpr int kLoads = 2 * C * D::limbs * kLanes;
  load_table<D>(sh, table);
  Ctx<D, NB> x(sh, threadIdx.x);
  const int64_t j0 = static_cast<int64_t>(blockIdx.x) * kLanes;
  const int64_t j = j0 + x.l;
  const bool live = j < lanes;
  const int64_t step_in = static_cast<int64_t>(C) * D::limbs * lanes;
  const int64_t step_out = static_cast<int64_t>(C) * D::kt * lanes;
  const uint32_t convk = x.row(kConvk);
  Point<O> acc{O::zero(x), O::one(x), O::zero(x)};
  for (int k = 0; k < steps; ++k) {
    // the block's limbs of this step into shared memory (the barrier of the
    // previous step's first product keeps them from being overwritten early)
    for (int i = threadIdx.x; i < kLoads; i += D::threads) {
      const int lane = i % kLanes, limb = (i / kLanes) % D::limbs;
      const int comp = (i / (kLanes * D::limbs)) % C, coord = i / (kLanes * D::limbs * C);
      const int64_t jj = j0 + lane;
      const int32_t* src = coord ? py : px;
      sh.limbs[coord][comp][limb][lane] =
          jj < lanes ? src[k * step_in + (static_cast<int64_t>(comp) * D::limbs + limb) * lanes + jj]
                     : 0;
    }
    __syncthreads();
    // each channel's residue of every coordinate component, then one RNS
    // product by M1²·2^(−16 L) into the RNS Montgomery domain, < (k1+2)·p
    uint32_t res[2 * C], conv[2 * C], q[2 * C];
#pragma unroll
    for (int i = 0; i < 2 * C; ++i) {
      res[i] = limb_residue<D, NB>(x, sh.limbs[i / C][i % C]);
      conv[i] = convk;
    }
    x.mul_n(res, conv, q);
    const int64_t at = k * step_out;
    const bool q_inf = live && qinf[k * lanes + j] != 0;
    const bool is_head = live && head[k * lanes + j] != 0;
    column_step<D, NB, O>(x, acc, O::make(q), O::make(q + C), q_inf, is_head, ox + at, oy + at,
                          oz + at, lanes, j);
  }
}

// a: (Kt, n) base-field residues -> out: (n,) 1 where the value is ≡ 0 mod p
template <class D, int NB>
__device__ void zero_block(Shared<D, NB>& sh, const int32_t* __restrict__ table,
                           const int32_t* __restrict__ a, int32_t* __restrict__ out, int64_t n) {
  using B = BaseOps<D, NB>;
  load_table<D>(sh, table);
  Ctx<D, NB> x(sh, threadIdx.x);
  const int64_t j = static_cast<int64_t>(blockIdx.x) * kLanes + x.l;
  const bool z = B::is_zero(x, load<D, B>(a, n, x.c, j));
  if (x.c == 0 && j < n) out[j] = z ? 1 : 0;
}

}  // namespace manta_rns
