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
//   - the Shenoy α from the redundant channel: each B2 thread adds its term
//     of the A2r sum into a word of its lane (a shared-memory atomic add,
//     before the second barrier), which the B1 threads read after it;
//   - the zero test (below).
//
// Rounds. A product costs two barriers, one for each base extension, and
// barriers set these kernels' pace. So the formulas issue their products in
// rounds of independent ones (`Ctx::round`): a round's products share its two
// barriers, up to NB base products a pass (an Fq2 product is four), and each
// extension thread loads a row of the matrix once for all of them. A mixed
// addition is 5 rounds (11 products), a complete addition 5 (16), a doubling
// 3 (7). A round also carries the formula's zero tests: the residues the
// test needs are staged before its first barrier, the lanes' votes cast
// between the two, and read after the second, so a test costs no barrier of
// its own. Each product, sum and offset is the one the formulas of
// `RnsCurveOps` compute, literal for literal, only issued in another order,
// so every residue is unchanged.
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
// CUDA built-ins defined for CPU threads and run whole blocks on the CPU
// (without __CUDA_ARCH__, `cp.async` is a plain copy).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace manta_rns {

constexpr int kLanes = 8;             // lanes of a block: one 32-byte sector
constexpr uint32_t kZeroClasses = 8192;  // the JAX kernel's zero-class rows
constexpr int kTests = 4;             // most residues one round's zero test holds

// Compile-time shape of one base field's RNS, and the layout of the int32
// constant table that `ops/kernels/rns_kernels.py::device_table` builds.
template <int K1, int K2, int L>
struct Dims {
  static constexpr int k1 = K1;
  static constexpr int k2 = K2;
  static constexpr int k1p = (K1 + 3) / 4 * 4;  // rows of k1 or k2 words padded to
  static constexpr int k2p = (K2 + 3) / 4 * 4;  // whole 16-byte loads
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

// One word from device memory into shared memory without holding the thread
// (`cp.async`), and the wait for the thread's own copies; a barrier after the
// wait makes them visible to the block.
__device__ __forceinline__ void copy_word_async(int32_t* dst, const int32_t* src) {
#ifdef __CUDA_ARCH__
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
#else
  *dst = *src;
#endif
}

__device__ __forceinline__ void copy_wait_all() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#endif
}

// Shared memory of one block. NB: the most base products a round's pass runs.
// The extension matrices and the sigmas are kept lane-major with rows padded
// to whole 16-byte words, so that the extension loops read four of each with
// one load (the pads of a1 and a2 are zeros; those of sig and sig2 are never
// written, and only ever multiplied by them).
template <class D, int NB>
struct Shared {
  int32_t table[D::kWords];
  alignas(16) uint32_t a1[D::k2 + 1][D::k1p];  // A1 (B1 -> B2 ∪ r)
  alignas(16) uint32_t a2[D::k1 + 1][D::k2p];  // A2 (B2 -> B1) and the A2r row
  alignas(16) uint32_t sig[NB][kLanes][D::k1p];
  alignas(16) uint32_t sig2[NB][kLanes][D::k2p];
  uint32_t outr[NB][kLanes];
  // per lane and product, sum_j A2r[j]·sigma2_j: the B2 threads add their
  // terms (two buffers, alternate passes)
  uint32_t asum[2][NB][kLanes];
  uint32_t zr[kTests][2][kLanes];  // channels 0 and 1 of the tested residues
  uint32_t vote[kTests][D::warps];
};

// The bucket column's input forms: RNS residues as they are (`rns_kernels.py::
// rns_accumulate_buckets`), or 16-bit Montgomery limbs converted to RNS
// (`hybrid_accumulate_buckets`).
enum Input { kResidues = 0, kLimbs = 1 };

// The bucket column's staging buffers in shared memory, after `Shared`: two
// steps' x and y of C components, [buffer][coordinate][component][row][lane],
// a row a limb (kLimbs) or a channel (kResidues: channel c of lane l is
// thread c·8 + l's own word).
template <class D, int C, int INPUT>
struct Staging {
  static constexpr int kRows = INPUT == kLimbs ? D::limbs : D::kp;
  int32_t w[2][2][C][kRows][kLanes];
};

__device__ __forceinline__ uint32_t dot4(uint4 a, uint4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

// Z residues of the thread's channel to test for zero in a round, and the
// per-lane answers.
template <int Z>
struct Tests {
  uint32_t v[Z];
  bool zero[Z];
};
template <>
struct Tests<0> {};

// E base products to run in a round beside the formula's own.
template <int E>
struct Extra {
  uint32_t a[E], b[E], out[E];
};
template <>
struct Extra<0> {};

// The thread's channel, lane, role and per-channel constants. VEC: the
// extension loops read four matrix entries and four sigmas a load (fewer
// instructions, more registers live).
template <class D, int NB, bool VEC = true>
struct Ctx {
  using Sh = Shared<D, NB>;
  Sh& sh;
  int c, l, role;
  uint32_t m, minv;
  int passes = 0;  // the round passes run so far: picks the `asum` buffer

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

  // -- the zero test in three parts, around two barriers --
  template <int Z>
  __device__ __forceinline__ void stage_tests(const Tests<Z>& zt) {
    if constexpr (Z > 0) {
      static_assert(Z <= kTests, "more zero tests than the shared buffers hold");
      if (c < 2) {
#pragma unroll
        for (int z = 0; z < Z; ++z) sh.zr[z][c][l] = zt.v[z];
      }
    }
  }
  template <int Z>
  __device__ __forceinline__ void vote_tests(const Tests<Z>& zt) {
    if constexpr (Z > 0) {
      bool ok[Z];
#pragma unroll
      for (int z = 0; z < Z; ++z) ok[z] = true;
      if (role != kPad) {
        const uint32_t ma = static_cast<uint32_t>(sh.table[kM * D::kp]);
        const uint32_t mb = static_cast<uint32_t>(sh.table[kM * D::kp + 1]);
        const uint32_t minva = static_cast<uint32_t>(sh.table[kMinv * D::kp]);
        const uint32_t minvb = static_cast<uint32_t>(sh.table[kMinv * D::kp + 1]);
        const uint32_t pinva = scalar(kPinvA), pinvb = scalar(kPinvB), mainvb = scalar(kMaInvB);
        const uint32_t pm = row(kPmod);
#pragma unroll
        for (int z = 0; z < Z; ++z) {
          // k0 = x·p^-1 mod m_a·m_b by Garner: k_a + m_a·((k_b − k_a)·m_a^-1 mod m_b)
          const uint32_t ka = reduce(sh.zr[z][0][l] * pinva, ma, minva);
          const uint32_t kb = reduce(sh.zr[z][1][l] * pinvb, mb, minvb);
          const uint32_t ka_b = ka >= mb ? ka - mb : ka;  // ka < m_a < 2·m_b
          uint32_t d = kb + mb - ka_b;
          d = d >= mb ? d - mb : d;
          const uint32_t k0 = ka + ma * reduce(d * mainvb, mb, minvb);
          ok[z] = k0 < kZeroClasses && zt.v[z] == mulmod(mod(k0), pm);
        }
      }
#pragma unroll
      for (int z = 0; z < Z; ++z) {
        // a warp is 4 channels of the same 8 lanes: fold its 32 votes to 8
        unsigned fail = __ballot_sync(0xffffffffu, !ok[z]);
        fail |= fail >> 16;
        fail |= fail >> 8;
        if ((threadIdx.x & 31) == 0) sh.vote[z][threadIdx.x >> 5] = fail & 0xffu;
      }
    }
  }
  template <int Z>
  __device__ __forceinline__ void read_tests(Tests<Z>& zt) {
    if constexpr (Z > 0) {
#pragma unroll
      for (int z = 0; z < Z; ++z) {
        unsigned all = 0;
#pragma unroll
        for (int w = 0; w < D::warps; ++w) all |= sh.vote[z][w];
        zt.zero[z] = !((all >> l) & 1u);
      }
    }
  }

  // -- one round: N independent RNS Montgomery products out[n] = a[n]·b[n],
  // NB a pass, two barriers a pass; the Z residues of `zt` are tested for
  // zero in the first pass's barriers --
  template <int N, int Z>
  __device__ void round(const uint32_t (&a)[N], const uint32_t (&b)[N], uint32_t (&out)[N],
                        Tests<Z>& zt) {
    constexpr int kPasses = (N + NB - 1) / NB;
#pragma unroll
    for (int pass = 0; pass < kPasses; ++pass, ++passes) {
      const int base = pass * NB;
      // this pass's α sums; the other buffer may still be read by the
      // previous pass's B1 threads, this one was last read two passes ago
      uint32_t (&asum)[NB][kLanes] = sh.asum[passes & 1];
      if (role == kRed) {
#pragma unroll
        for (int n = 0; n < NB; ++n) {
          if (base + n < N) asum[n][l] = 0u;
        }
      }
      uint32_t t[NB];
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        if (base + n < N) t[n] = mulmod(a[base + n], b[base + n]);
      }
      if (role == kB1) {
        const uint32_t npi = row(kNegPInv1), w1 = row(kW1);
#pragma unroll
        for (int n = 0; n < NB; ++n) {
          if (base + n < N) sh.sig[n][l][c] = mulmod(mulmod(t[n], npi), w1);
        }
      }
      if (pass == 0) stage_tests(zt);
      __syncthreads();
      if (role == kB2 || role == kRed) {
        // ext1 without the α correction: m̂ = sum_i A1[c][i]·sigma_i mod m,
        // each matrix entry loaded once for all the pass's products
        uint32_t s[NB];
#pragma unroll
        for (int n = 0; n < NB; ++n) s[n] = 0u;
        if constexpr (VEC) {
          const uint4* arow = reinterpret_cast<const uint4*>(sh.a1[c - D::k1]);
#pragma unroll
          for (int i = 0; i < D::k1p / 4; ++i) {
            const uint4 w = arow[i];
#pragma unroll
            for (int n = 0; n < NB; ++n) {
              if (base + n < N) s[n] += dot4(w, reinterpret_cast<const uint4*>(sh.sig[n][l])[i]);
            }
          }
        } else {
          const uint32_t* arow = sh.a1[c - D::k1];
#pragma unroll 5
          for (int i = 0; i < D::k1; ++i) {
            const uint32_t w = arow[i];
#pragma unroll
            for (int n = 0; n < NB; ++n) {
              if (base + n < N) s[n] += w * sh.sig[n][l][i];
            }
          }
        }
        const uint32_t pm = row(kP2r), minv1 = row(kM1Inv2r), w2 = row(kW2);
        const uint32_t ar = role == kB2 ? sh.a2[D::k1][c - D::k1] : 0u;
#pragma unroll
        for (int n = 0; n < NB; ++n) {
          if (base + n < N) {
            uint32_t u = t[n] + mulmod(mod(s[n]), pm);
            u = u >= m ? u - m : u;
            const uint32_t o = mulmod(u, minv1);
            out[base + n] = o;
            if (role == kB2) {
              const uint32_t sig2 = mulmod(o, w2);
              sh.sig2[n][l][c - D::k1] = sig2;
              atomicAdd(&asum[n][l], ar * sig2);  // < 2^30 summed: exact
            } else {
              sh.outr[n][l] = o;
            }
          }
        }
      }
      if (pass == 0) vote_tests(zt);
      __syncthreads();
      if (role == kB1) {
        // ext2 (Shenoy): sum_j A2[c][j]·sigma2_j, α from the redundant channel
        const uint32_t mr = scalar(kMr), minvr = scalar(kMinvR), m2invr = scalar(kM2InvR);
        const uint32_t m2mod = row(kM2Mod1);
        uint32_t s[NB];
#pragma unroll
        for (int n = 0; n < NB; ++n) s[n] = 0u;
        if constexpr (VEC) {
          const uint4* arow = reinterpret_cast<const uint4*>(sh.a2[c]);
#pragma unroll
          for (int j = 0; j < D::k2p / 4; ++j) {
            const uint4 wa = arow[j];
#pragma unroll
            for (int n = 0; n < NB; ++n) {
              if (base + n < N) s[n] += dot4(wa, reinterpret_cast<const uint4*>(sh.sig2[n][l])[j]);
            }
          }
        } else {
          const uint32_t* arow = sh.a2[c];
#pragma unroll 5
          for (int j = 0; j < D::k2; ++j) {
            const uint32_t wa = arow[j];
#pragma unroll
            for (int n = 0; n < NB; ++n) {
              if (base + n < N) s[n] += wa * sh.sig2[n][l][j];
            }
          }
        }
#pragma unroll
        for (int n = 0; n < NB; ++n) {
          if (base + n < N) {
            uint32_t d = reduce(asum[n][l], mr, minvr) + mr - sh.outr[n][l];
            d = d >= mr ? d - mr : d;
            const uint32_t alpha = reduce(d * m2invr, mr, minvr);
            const uint32_t corr = mulmod(alpha, m2mod);
            const uint32_t o = mod(s[n]);
            out[base + n] = o >= corr ? o - corr : o + m - corr;
          }
        }
      }
      if (role == kPad) {
#pragma unroll
        for (int n = 0; n < NB; ++n) {
          if (base + n < N) out[base + n] = 0u;
        }
      }
      if (pass == 0) read_tests(zt);
    }
  }

  // the zero test alone (two barriers)
  template <int Z>
  __device__ void test(Tests<Z>& zt) {
    stage_tests(zt);
    __syncthreads();
    vote_tests(zt);
    __syncthreads();
    read_tests(zt);
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
};

// -- coordinate types: one residue (G1), or two for Fq2 (G2). `put` lays a
// product's base operands into a round at index i, `get` builds its value
// from the round's outputs; `put_test` / `get_test` the same for a zero test --

template <class D, int NB, bool VEC = true>
struct BaseOps {
  using X = Ctx<D, NB, VEC>;
  using V = uint32_t;
  static constexpr int kComps = 1;
  static constexpr int kBase = 1;  // base products of one product
  template <int N>
  __device__ static void put(uint32_t (&a)[N], uint32_t (&b)[N], int i, V x, V y) {
    a[i] = x;
    b[i] = y;
  }
  template <int N>
  __device__ static V get(const X&, const uint32_t (&t)[N], int i) {
    return t[i];
  }
  template <int N>
  __device__ static void put_test(uint32_t (&v)[N], int i, V x) {
    v[i] = x;
  }
  template <int N>
  __device__ static bool get_test(const bool (&z)[N], int i) {
    return z[i];
  }
  __device__ static V add(const X& x, V a, V b) { return x.add(a, b); }
  __device__ static V sub_k(const X& x, V a, V b, int k) { return x.sub_k(a, b, k); }
  __device__ static V zero(const X&) { return 0u; }
  __device__ static V one(const X& x) { return x.row(kOne); }
  __device__ static uint32_t comp(V a, int) { return a; }
  __device__ static V make(const uint32_t* a) { return a[0]; }
};

// Fq[u]/(u^2 + 1), as `_KernelRnsFq2Ops`: schoolbook product (four base
// products, c0 = sub_k(a0 b0, a1 b1, 6), c1 = a0 b1 + a1 b0), and every
// requested sub_k offset raised by one (components run one bit wider).
template <class D, int NB, bool VEC = true>
struct Fq2Ops {
  using X = Ctx<D, NB, VEC>;
  struct V {
    uint32_t c0, c1;
  };
  static constexpr int kComps = 2;
  static constexpr int kBase = 4;
  template <int N>
  __device__ static void put(uint32_t (&a)[N], uint32_t (&b)[N], int i, V x, V y) {
    a[4 * i] = x.c0, b[4 * i] = y.c0;
    a[4 * i + 1] = x.c1, b[4 * i + 1] = y.c1;
    a[4 * i + 2] = x.c0, b[4 * i + 2] = y.c1;
    a[4 * i + 3] = x.c1, b[4 * i + 3] = y.c0;
  }
  template <int N>
  __device__ static V get(const X& x, const uint32_t (&t)[N], int i) {
    return V{x.sub_k(t[4 * i], t[4 * i + 1], 6), x.add(t[4 * i + 2], t[4 * i + 3])};
  }
  template <int N>
  __device__ static void put_test(uint32_t (&v)[N], int i, V x) {
    v[2 * i] = x.c0;
    v[2 * i + 1] = x.c1;
  }
  template <int N>
  __device__ static bool get_test(const bool (&z)[N], int i) {
    return z[2 * i] && z[2 * i + 1];
  }
  __device__ static V add(const X& x, V a, V b) { return V{x.add(a.c0, b.c0), x.add(a.c1, b.c1)}; }
  __device__ static V sub_k(const X& x, V a, V b, int k) {
    return V{x.sub_k(a.c0, b.c0, k + 1), x.sub_k(a.c1, b.c1, k + 1)};
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

// A round of R products of coordinates (each O::kBase base products), T zero
// tests of coordinates and E extra base products.
template <class O, int R, int T = 0, int E = 0>
struct Round {
  using X = typename O::X;
  using V = typename O::V;
  static constexpr int kN = R * O::kBase + E;
  uint32_t a[kN], b[kN], t[kN];
  Tests<T * O::kComps> zt;

  __device__ void mul(int i, V x, V y) { O::put(a, b, i, x, y); }
  __device__ void test(int i, V v) {
    if constexpr (T > 0) O::put_test(zt.v, i, v);
  }
  __device__ void run(X& x, Extra<E>& ex) {
    if constexpr (E > 0) {
#pragma unroll
      for (int e = 0; e < E; ++e) a[R * O::kBase + e] = ex.a[e], b[R * O::kBase + e] = ex.b[e];
    }
    x.round(a, b, t, zt);
    if constexpr (E > 0) {
#pragma unroll
      for (int e = 0; e < E; ++e) ex.out[e] = t[R * O::kBase + e];
    }
  }
  __device__ void run(X& x) {
    static_assert(E == 0, "pass the extra products");
    x.round(a, b, t, zt);
  }
  __device__ V out(const X& x, int i) const { return O::get(x, t, i); }
  __device__ bool zero(int i) const {
    if constexpr (T > 0) {
      return O::get_test(zt.zero, i);
    } else {
      return false;
    }
  }
};

struct NoHook {
  __device__ void operator()() const {}
};

// The bound-annotated formulas of `RnsCurveOps` (manta_tpu_torch/ops/curve.py,
// the JAX package's `curve.py::RnsCurveOps`), op for op, with the sub_k
// offsets literal for literal, and the edge dispatch of `_add_dispatch`; the
// products in rounds of independent ones, the zero tests inside the rounds.
// Barriers: a doubling 6, a mixed or complete addition 11 (5 rounds and the
// doubling vote; a G2 complete addition 13, its first round running in two
// passes), plus a doubling's 6 where a lane of the block doubles.
template <class O>
struct Formulas {
  using X = typename O::X;
  using V = typename O::V;
  using P = Point<O>;

  __device__ static V dbl_raw(const X& x, V a) { return O::add(x, a, a); }

  __device__ static P dbl(X& x, const P& p) {
    Round<O, 3> r1;
    r1.mul(0, p.x, p.x);
    r1.mul(1, p.y, p.y);
    r1.mul(2, dbl_raw(x, p.y), p.z);
    r1.run(x);
    const V a = r1.out(x, 0), b = r1.out(x, 1), z3 = r1.out(x, 2);
    const V e = O::add(x, O::add(x, a, a), a);
    const V xb = O::add(x, p.x, b);
    Round<O, 3> r2;
    r2.mul(0, b, b);
    r2.mul(1, xb, xb);
    r2.mul(2, e, e);
    r2.run(x);
    const V c = r2.out(x, 0), t = r2.out(x, 1), f = r2.out(x, 2);
    const V d = dbl_raw(x, O::sub_k(x, O::sub_k(x, t, a, 6), c, 6));
    const V x3 = O::sub_k(x, f, dbl_raw(x, d), 10);
    const V c8 = dbl_raw(x, dbl_raw(x, dbl_raw(x, c)));
    Round<O, 1> r3;
    r3.mul(0, e, O::sub_k(x, d, x3, 11));
    r3.run(x);
    const V y3 = O::sub_k(x, r3.out(x, 0), c8, 9);
    return P{x3, y3, z3};
  }

  __device__ static P dispatch(X& x, const P& p, const P& q, const P& generic, bool p_inf,
                               bool q_inf, bool h_zero, bool r_zero) {
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
    const V pz2 = dbl_raw(x, p.z);
    Round<O, 5, 2> r1;
    r1.mul(0, p.z, p.z);
    r1.mul(1, q.z, q.z);
    r1.mul(2, p.y, q.z);
    r1.mul(3, q.y, p.z);
    r1.mul(4, pz2, q.z);
    r1.test(0, p.z);
    r1.test(1, q.z);
    r1.run(x);
    const V z1z1 = r1.out(x, 0), z2z2 = r1.out(x, 1), t3 = r1.out(x, 4);
    Round<O, 4> r2;
    r2.mul(0, p.x, z2z2);
    r2.mul(1, q.x, z1z1);
    r2.mul(2, r1.out(x, 2), z2z2);
    r2.mul(3, r1.out(x, 3), z1z1);
    r2.run(x);
    const V u1 = r2.out(x, 0), u2 = r2.out(x, 1), s1 = r2.out(x, 2), s2 = r2.out(x, 3);
    const V h = O::sub_k(x, u2, u1, 6);
    const V rr = O::sub_k(x, s2, s1, 6);
    const V h2 = dbl_raw(x, h);
    const V r2v = dbl_raw(x, rr);
    Round<O, 3, 2> r3;
    r3.mul(0, h2, h2);
    r3.mul(1, r2v, r2v);
    r3.mul(2, t3, h);
    r3.test(0, h);
    r3.test(1, rr);
    r3.run(x);
    const V i = r3.out(x, 0), z3 = r3.out(x, 2);
    Round<O, 2> r4;
    r4.mul(0, h, i);
    r4.mul(1, u1, i);
    r4.run(x);
    const V j = r4.out(x, 0), v = r4.out(x, 1);
    const V x3 = O::sub_k(x, O::sub_k(x, r3.out(x, 1), j, 6), dbl_raw(x, v), 7);
    Round<O, 2> r5;
    r5.mul(0, r2v, O::sub_k(x, v, x3, 9));
    r5.mul(1, s1, j);
    r5.run(x);
    const V y3 = O::sub_k(x, r5.out(x, 0), dbl_raw(x, r5.out(x, 1)), 7);
    return dispatch(x, p, q, P{x3, y3, z3}, r1.zero(0), r1.zero(1), r3.zero(0), r3.zero(1));
  }

  // The mixed addition, with E extra base products in its first round and
  // `hook` called before its last round (the hybrid column converts its next
  // step's point there, and waits for its staged limbs).
  template <int E, class Hook>
  __device__ static P madd(X& x, const P& p, const P& q, Extra<E>& ex, Hook hook) {
    Round<O, 2, 2, E> r1;
    r1.mul(0, p.z, p.z);
    r1.mul(1, q.y, p.z);
    r1.test(0, p.z);
    r1.test(1, q.z);
    r1.run(x, ex);
    const V z1z1 = r1.out(x, 0);
    Round<O, 2> r2;
    r2.mul(0, q.x, z1z1);
    r2.mul(1, r1.out(x, 1), z1z1);
    r2.run(x);
    const V h = O::sub_k(x, r2.out(x, 0), p.x, 11);
    const V rhalf = O::sub_k(x, r2.out(x, 1), p.y, 10);
    const V r = dbl_raw(x, rhalf);
    const V zh = O::add(x, p.z, h);
    Round<O, 3, 2> r3;
    r3.mul(0, h, h);
    r3.mul(1, r, r);
    r3.mul(2, zh, zh);
    r3.test(0, h);
    r3.test(1, rhalf);
    r3.run(x);
    const V hh = r3.out(x, 0);
    const V i4 = dbl_raw(x, dbl_raw(x, hh));
    Round<O, 2> r4;
    r4.mul(0, h, i4);
    r4.mul(1, p.x, i4);
    r4.run(x);
    const V j = r4.out(x, 0), v = r4.out(x, 1);
    const V x3 = O::sub_k(x, O::sub_k(x, r3.out(x, 1), j, 6), dbl_raw(x, v), 7);
    hook();
    Round<O, 2> r5;
    r5.mul(0, r, O::sub_k(x, v, x3, 9));
    r5.mul(1, p.y, j);
    r5.run(x);
    const V y3 = O::sub_k(x, r5.out(x, 0), dbl_raw(x, r5.out(x, 1)), 7);
    const V z3 = O::sub_k(x, O::sub_k(x, r3.out(x, 2), z1z1, 6), hh, 6);
    return dispatch(x, p, q, P{x3, y3, z3}, r1.zero(0), r1.zero(1), r3.zero(0), r3.zero(1));
  }

  __device__ static P madd(X& x, const P& p, const P& q) {
    Extra<0> none;
    return madd<0>(x, p, q, none, NoHook{});
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

template <class D, class O>
__device__ __forceinline__ Point<O> load_point(const int32_t* __restrict__ x,
                                               const int32_t* __restrict__ y,
                                               const int32_t* __restrict__ z, int64_t n, int c,
                                               int64_t j) {
  return Point<O>{load<D, O>(x, n, c, j), load<D, O>(y, n, c, j), load<D, O>(z, n, c, j)};
}

template <class D, class O>
__device__ __forceinline__ void store_point(int32_t* __restrict__ x, int32_t* __restrict__ y,
                                            int32_t* __restrict__ z, int64_t n, int c, int64_t j,
                                            const Point<O>& p) {
  store<D, O>(x, n, c, j, p.x);
  store<D, O>(y, n, c, j, p.y);
  store<D, O>(z, n, c, j, p.z);
}

// Copy the constant table into shared memory, and the extension matrices
// into their padded rows (every thread, then a barrier).
template <class D, class S>
__device__ __forceinline__ void load_table(S& sh, const int32_t* __restrict__ table) {
  for (int i = threadIdx.x; i < D::kWords; i += D::threads) sh.table[i] = table[i];
  for (int i = threadIdx.x; i < (D::k2 + 1) * D::k1p; i += D::threads) {
    const int r = i / D::k1p, col = i % D::k1p;
    sh.a1[r][col] = col < D::k1 ? static_cast<uint32_t>(table[D::kA1 + r * D::k1 + col]) : 0u;
  }
  for (int i = threadIdx.x; i < (D::k1 + 1) * D::k2p; i += D::threads) {
    const int r = i / D::k2p, col = i % D::k2p;
    sh.a2[r][col] = col < D::k2 ? static_cast<uint32_t>(table[D::kA2 + r * D::k2 + col]) : 0u;
  }
  __syncthreads();
}

// limb -> RNS for one lane and channel: the residue of v = sum_i limb_i·2^(16 i)
// (limbs[i][l]: the D::limbs limbs of lane l in shared memory), reduced every
// 15 terms so the sum stays below 2^32 (limb < 2^16, table entry < 2^12).
template <class D, class X>
__device__ __forceinline__ uint32_t limb_residue(const X& x, const int32_t (*limbs)[kLanes]) {
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
  typename O::X x(sh, threadIdx.x);
  const int64_t j = static_cast<int64_t>(blockIdx.x) * kLanes + x.l;
  const P p = load_point<D, O>(px, py, pz, n, x.c, j);
  P r;
  if (WHICH == kDouble) {
    r = F::dbl(x, p);
  } else {
    const P q = load_point<D, O>(qx, qy, qz, n, x.c, j);
    r = WHICH == kAdd ? F::add(x, p, q) : F::madd(x, p, q);
  }
  store_point<D, O>(ox, oy, oz, n, x.c, j, r);
}

// The bucket column, one loop for both input forms. px, py: (K, *E(Kt), R)
// RNS residues (kResidues) or (K, *E(L), R) 16-bit Montgomery limbs (kLimbs);
// qinf, head, slot: (K, R). Per lane: q = (x, y, 1), or infinity (x, 1, 0)
// where qinf; acc = q at a head, else madd(acc, q). The accumulator is
// written only where slot >= 0, into bucket slot of bx, by, bz (*E(Kt),
// num_slots), and after the last step into ax, ay, az (*E(Kt), R); no
// stream. Barriers a step: the mixed addition's 11, no more. Pipelined:
//   - kLimbs: each step's point is converted to RNS (the residues of its limb
//     value, then one RNS product by M1²·2^(−16 L)); step k+1's conversion
//     product runs in step k's first round, and step k+2's limbs are staged
//     with cp.async by the whole block into the buffer step k's conversion
//     left, waited for before step k's last round, whose barriers publish
//     them;
//   - kResidues: each thread stages its own channel's words of step k+2
//     with cp.async before step k's last round, into the buffer it read step
//     k from, after waiting for step k+1's (so a step's loads overlap the
//     step before it).
template <class D, int NB, class O, int INPUT>
__device__ void bucket_block(Shared<D, NB>& sh, Staging<D, O::kComps, INPUT>& st,
                             const int32_t* __restrict__ table, const int32_t* __restrict__ px,
                             const int32_t* __restrict__ py, const int32_t* __restrict__ qinf,
                             const int32_t* __restrict__ head, const int32_t* __restrict__ slot,
                             int32_t* __restrict__ bx, int32_t* __restrict__ by,
                             int32_t* __restrict__ bz, int32_t* __restrict__ ax,
                             int32_t* __restrict__ ay, int32_t* __restrict__ az, int steps,
                             int64_t lanes, int64_t num_slots) {
  using V = typename O::V;
  constexpr int C = O::kComps;
  constexpr bool kConvert = INPUT == kLimbs;
  constexpr int kRowsIn = kConvert ? D::limbs : D::kt;  // rows of a component in px, py
  load_table<D>(sh, table);
  typename O::X x(sh, threadIdx.x);
  const int64_t j0 = static_cast<int64_t>(blockIdx.x) * kLanes;
  const int64_t j = j0 + x.l;
  const bool live = j < lanes;
  const int64_t step_in = static_cast<int64_t>(C) * kRowsIn * lanes;
  // step k's x, y of the block's lanes into buffer buf
  auto stage = [&](int k, int buf) {
    if constexpr (kConvert) {  // a word a thread, over the block
      constexpr int kLoads = 2 * C * D::limbs * kLanes;
      for (int i = threadIdx.x; i < kLoads; i += D::threads) {
        const int lane = i % kLanes, limb = (i / kLanes) % D::limbs;
        const int comp = (i / (kLanes * D::limbs)) % C, coord = i / (kLanes * D::limbs * C);
        const int64_t jj = j0 + lane;
        int32_t* dst = &st.w[buf][coord][comp][limb][lane];
        if (jj < lanes) {
          const int32_t* src = coord ? py : px;
          copy_word_async(dst, src + k * step_in + (static_cast<int64_t>(comp) * D::limbs + limb) * lanes + jj);
        } else {
          *dst = 0;
        }
      }
    } else {  // the thread's own channel and lane
#pragma unroll
      for (int i = 0; i < 2 * C; ++i) {
        int32_t* dst = &st.w[buf][i / C][i % C][x.c][x.l];
        if (live && x.c < D::kt) {
          const int32_t* src = i / C ? py : px;
          copy_word_async(dst, src + k * step_in + (static_cast<int64_t>(i % C) * D::kt + x.c) * lanes + j);
        } else {
          *dst = 0;
        }
      }
    }
  };
  // kLimbs: the conversion product's operands, each coordinate component's
  // residue of step k's limbs in buffer buf, and M1²·2^(−16 L)
  auto convert = [&](int buf, Extra<2 * C>& ex) {
    const uint32_t convk = x.row(kConvk);
#pragma unroll
    for (int i = 0; i < 2 * C; ++i) {
      ex.a[i] = limb_residue<D>(x, st.w[buf][i / C][i % C]);
      ex.b[i] = convk;
    }
  };
  const V one = O::one(x), zero = O::zero(x);
  Point<O> acc{zero, one, zero};
  Extra<kConvert ? 2 * C : 0> ex;
  // fill the pipeline: steps 0 and 1 staged (and step 0 converted)
  stage(0, 0);
  if (steps > 1) stage(1, 1);
  copy_wait_all();
  __syncthreads();
  if constexpr (kConvert) {
    convert(0, ex);
    Tests<0> none;
    x.round(ex.a, ex.b, ex.out, none);
  }
  for (int k = 0; k < steps; ++k) {
    uint32_t q[2 * C];
    if constexpr (kConvert) {
#pragma unroll
      for (int i = 0; i < 2 * C; ++i) q[i] = ex.out[i];
      // buffer k & 1 was last read before step k−1's first barrier
      if (k + 2 < steps) stage(k + 2, k & 1);
      if (k + 1 < steps) {
        convert((k + 1) & 1, ex);
      } else {
#pragma unroll
        for (int i = 0; i < 2 * C; ++i) ex.a[i] = ex.b[i] = 0u;
      }
    } else {
#pragma unroll
      for (int i = 0; i < 2 * C; ++i) q[i] = static_cast<uint32_t>(st.w[k & 1][i / C][i % C][x.c][x.l]);
    }
    const bool q_inf = live && qinf[k * lanes + j] != 0;
    const bool is_head = live && head[k * lanes + j] != 0;
    const Point<O> pt{O::make(q), q_inf ? one : O::make(q + C), q_inf ? zero : one};
    // before the last round: the staged words are waited for (kResidues then
    // stages step k+2 into the buffer step k was read from)
    auto hook = [&] {
      copy_wait_all();
      if constexpr (!kConvert) {
        if (k + 2 < steps) stage(k + 2, k & 1);
      }
    };
    acc = select(is_head, pt, Formulas<O>::madd(x, acc, pt, ex, hook));
    const int32_t s = live ? slot[k * lanes + j] : -1;
    if (s >= 0) store_point<D, O>(bx, by, bz, num_slots, x.c, s, acc);
  }
  store_point<D, O>(ax, ay, az, lanes, x.c, j, acc);
}

// The chains of the MSM's last steps: per lane, acc = init; then for each
// of `steps` addends w: `doublings` doublings of acc, and acc = add(acc, w)
// (chain_first) or add(w, acc). init, out: (*E, n); addends: (steps, *E, n).
template <class D, int NB, class O>
__device__ void combine_block(Shared<D, NB>& sh, const int32_t* __restrict__ table,
                              const int32_t* __restrict__ ix, const int32_t* __restrict__ iy,
                              const int32_t* __restrict__ iz, const int32_t* __restrict__ wx,
                              const int32_t* __restrict__ wy, const int32_t* __restrict__ wz,
                              int32_t* __restrict__ ox, int32_t* __restrict__ oy,
                              int32_t* __restrict__ oz, int64_t n, int steps, int doublings,
                              bool chain_first) {
  using F = Formulas<O>;
  load_table<D>(sh, table);
  typename O::X x(sh, threadIdx.x);
  const int64_t j = static_cast<int64_t>(blockIdx.x) * kLanes + x.l;
  const int64_t step = static_cast<int64_t>(O::kComps) * D::kt * n;
  Point<O> acc = load_point<D, O>(ix, iy, iz, n, x.c, j);
  for (int s = 0; s < steps; ++s) {
    for (int d = 0; d < doublings; ++d) acc = F::dbl(x, acc);
    const int64_t at = s * step;
    const Point<O> w = load_point<D, O>(wx + at, wy + at, wz + at, n, x.c, j);
    acc = chain_first ? F::add(x, acc, w) : F::add(x, w, acc);
  }
  store_point<D, O>(ox, oy, oz, n, x.c, j, acc);
}

// a: (Kt, n) base-field residues -> out: (n,) 1 where the value is ≡ 0 mod p
template <class D, int NB>
__device__ void zero_block(Shared<D, NB>& sh, const int32_t* __restrict__ table,
                           const int32_t* __restrict__ a, int32_t* __restrict__ out, int64_t n) {
  using B = BaseOps<D, NB>;
  load_table<D>(sh, table);
  typename B::X x(sh, threadIdx.x);
  const int64_t j = static_cast<int64_t>(blockIdx.x) * kLanes + x.l;
  Tests<1> zt;
  zt.v[0] = load<D, B>(a, n, x.c, j);
  x.test(zt);
  if (x.c == 0 && j < n) out[j] = zt.zero[0] ? 1 : 0;
}

}  // namespace manta_rns
