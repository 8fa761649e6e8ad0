// Curve arithmetic as device functions for the kernels of `point_kernels.cu`:
// coordinate ops over a base field (G1) or over Fq2 = Fq[u]/(u^2 + 1) (G2),
// Jacobian points, the three formulas of `manta_tpu_torch/ops/curve.py`
// (CurveOps.double / add / madd with the edge dispatch of `_add_dispatch`),
// each in the same sequence of field ops, so the lazy [0, 2p) values agree
// bit for bit with the plain versions, and the body of each kernel: one lane
// (`point_lane`), the threads of a lane's group (`point_group`,
// `bucket_column_group`, `fold_group`, `merge_group`), one warp
// (`double_add_warp`) or one block (`combine_block`). The point op, bucket
// column, merge, chain and combine run their formulas spread over a group of
// threads of a warp (`group_madd_to`, `group_add_to`, `group_double_to`;
// `double_add_chain`). Nothing here
// launches: a host C++ harness can include this header (with the CUDA
// qualifiers, the warp shuffles and the block barrier defined for the CPU)
// and run the bodies there.

#pragma once

#include "field_ops.cuh"

namespace manta {

// Base-field coordinate ops (G1): one element is S 32-bit words.
template <class F>
struct Base {
  using O = FieldOps<F>;
  static constexpr int kRows = F::kLimbs;  // 16-bit rows of one coordinate
  struct V {
    uint32_t w[O::S];
  };

  __device__ __forceinline__ static V add(const V& a, const V& b) {
    V r;
    O::add(a.w, b.w, r.w);
    return r;
  }
  __device__ __forceinline__ static V sub(const V& a, const V& b) {
    V r;
    O::sub(a.w, b.w, r.w);
    return r;
  }
  __device__ __forceinline__ static V mul(const V& a, const V& b) {
    V r;
    O::mul(a.w, b.w, r.w);
    return r;
  }
  __device__ __forceinline__ static V sqr(const V& a) { return mul(a, a); }
  __device__ __forceinline__ static V dbl(const V& a) { return add(a, a); }
  __device__ __forceinline__ static V triple(const V& a) { return add(add(a, a), a); }
  __device__ __forceinline__ static V zero() {
    V r;
#pragma unroll
    for (int k = 0; k < O::S; ++k) r.w[k] = 0u;
    return r;
  }
  __device__ __forceinline__ static V one() {
    V r;
#pragma unroll
    for (int k = 0; k < O::S; ++k) r.w[k] = F::one(k);
    return r;
  }
  // zero has two lazy residues: 0 and p
  __device__ __forceinline__ static bool is_zero(const V& a) {
    bool z = true, e = true;
#pragma unroll
    for (int k = 0; k < O::S; ++k) {
      z = z && (a.w[k] == 0u);
      e = e && (a.w[k] == F::p(k));
    }
    return z || e;
  }
  // (kRows, n) rows starting at src, lane j
  __device__ __forceinline__ static V load(const int32_t* __restrict__ src, int64_t n,
                                           int64_t j) {
    V r;
    O::load(src, n, j, r.w);
    return r;
  }
  __device__ __forceinline__ static void store(int32_t* __restrict__ dst, int64_t n, int64_t j,
                                               const V& a) {
    O::store(dst, n, j, a.w);
  }
};

// Fq2 = Fq[u]/(u^2 + 1) coordinate ops (G2), in the op order of
// `manta_tpu_torch/ops/curve.py::Fq2Ops` (and the JAX `_KernelFq2Ops`).
template <class F>
struct Ext {
  using B = Base<F>;
  static constexpr int kRows = 2 * F::kLimbs;
  struct V {
    typename B::V c0, c1;
  };

  __device__ __forceinline__ static V add(const V& a, const V& b) {
    return {B::add(a.c0, b.c0), B::add(a.c1, b.c1)};
  }
  __device__ __forceinline__ static V sub(const V& a, const V& b) {
    return {B::sub(a.c0, b.c0), B::sub(a.c1, b.c1)};
  }
  __device__ __forceinline__ static V mul(const V& a, const V& b) {
    const auto t0 = B::mul(a.c0, b.c0);
    const auto t1 = B::mul(a.c1, b.c1);
    const auto s = B::mul(B::add(a.c0, a.c1), B::add(b.c0, b.c1));
    return {B::sub(t0, t1), B::sub(B::sub(s, t0), t1)};
  }
  __device__ __forceinline__ static V sqr(const V& a) {
    const auto t = B::mul(B::add(a.c0, a.c1), B::sub(a.c0, a.c1));
    return {t, B::dbl(B::mul(a.c0, a.c1))};
  }
  __device__ __forceinline__ static V dbl(const V& a) { return add(a, a); }
  __device__ __forceinline__ static V triple(const V& a) { return add(add(a, a), a); }
  __device__ __forceinline__ static V zero() { return {B::zero(), B::zero()}; }
  __device__ __forceinline__ static V one() { return {B::one(), B::zero()}; }
  __device__ __forceinline__ static bool is_zero(const V& a) {
    return B::is_zero(a.c0) && B::is_zero(a.c1);
  }
  // (2, L, n) rows starting at src, lane j
  __device__ __forceinline__ static V load(const int32_t* __restrict__ src, int64_t n,
                                           int64_t j) {
    return {B::load(src, n, j), B::load(src + F::kLimbs * n, n, j)};
  }
  __device__ __forceinline__ static void store(int32_t* __restrict__ dst, int64_t n, int64_t j,
                                               const V& a) {
    B::store(dst, n, j, a.c0);
    B::store(dst + F::kLimbs * n, n, j, a.c1);
  }
};

template <class C>
struct Pt {
  typename C::V x, y, z;
};

template <class C>
__device__ __forceinline__ Pt<C> infinity() {
  return {C::zero(), C::one(), C::zero()};
}

// dbl-2009-l (a = 0); infinity (Z = 0) maps to Z3 = 0. CurveOps.double.
template <class C>
__device__ __forceinline__ Pt<C> point_double(const Pt<C>& p) {
  const auto a = C::sqr(p.x);
  const auto b = C::sqr(p.y);
  const auto c = C::sqr(b);
  const auto t = C::sqr(C::add(p.x, b));
  const auto d = C::dbl(C::sub(C::sub(t, a), c));
  const auto e = C::triple(a);
  const auto f = C::sqr(e);
  const auto x3 = C::sub(f, C::dbl(d));
  const auto y3 = C::sub(C::mul(e, C::sub(d, x3)), C::dbl(C::dbl(C::dbl(c))));
  const auto z3 = C::mul(C::dbl(p.y), p.z);
  return {x3, y3, z3};
}

// CurveOps._add_dispatch: p = inf -> q; q = inf -> p; h = 0 and r = 0 ->
// double(p); h = 0 and r != 0 -> infinity; else the generic sum.
template <class C>
__device__ __forceinline__ Pt<C> dispatch(const Pt<C>& p, const Pt<C>& q, const Pt<C>& gen,
                                          bool h_zero, bool r_zero) {
  if (C::is_zero(p.z)) return q;
  if (C::is_zero(q.z)) return p;
  if (h_zero) return r_zero ? point_double<C>(p) : infinity<C>();
  return gen;
}

// add-2007-bl, complete. CurveOps.add.
template <class C>
__device__ __forceinline__ Pt<C> point_add(const Pt<C>& p, const Pt<C>& q) {
  const auto z1z1 = C::sqr(p.z);
  const auto z2z2 = C::sqr(q.z);
  const auto u1 = C::mul(p.x, z2z2);
  const auto u2 = C::mul(q.x, z1z1);
  const auto s1 = C::mul(C::mul(p.y, q.z), z2z2);
  const auto s2 = C::mul(C::mul(q.y, p.z), z1z1);
  const auto h = C::sub(u2, u1);
  const auto rr = C::sub(s2, s1);
  const bool h_zero = C::is_zero(h);
  const bool r_zero = C::is_zero(rr);
  const auto i = C::sqr(C::dbl(h));
  const auto j = C::mul(h, i);
  const auto r2 = C::dbl(rr);
  const auto v = C::mul(u1, i);
  const auto x3 = C::sub(C::sub(C::sqr(r2), j), C::dbl(v));
  const auto y3 = C::sub(C::mul(r2, C::sub(v, x3)), C::dbl(C::mul(s1, j)));
  const auto z3 = C::mul(C::mul(C::dbl(p.z), q.z), h);
  return dispatch<C>(p, q, {x3, y3, z3}, h_zero, r_zero);
}

// madd-2007-bl: p Jacobian + q affine (Z in {0, 1}), complete. CurveOps.madd.
template <class C>
__device__ __forceinline__ Pt<C> point_madd(const Pt<C>& p, const Pt<C>& q) {
  const auto z1z1 = C::sqr(p.z);
  const auto u2 = C::mul(q.x, z1z1);
  const auto s2 = C::mul(C::mul(q.y, p.z), z1z1);
  const auto h = C::sub(u2, p.x);
  const auto rhalf = C::sub(s2, p.y);
  const bool h_zero = C::is_zero(h);
  const bool r_zero = C::is_zero(rhalf);
  const auto hh = C::sqr(h);
  const auto i4 = C::dbl(C::dbl(hh));
  const auto j = C::mul(h, i4);
  const auto r = C::dbl(rhalf);
  const auto v = C::mul(p.x, i4);
  const auto x3 = C::sub(C::sub(C::sqr(r), j), C::dbl(v));
  const auto y3 = C::sub(C::mul(r, C::sub(v, x3)), C::dbl(C::mul(p.y, j)));
  const auto z3 = C::sub(C::sub(C::sqr(C::add(p.z, h)), z1z1), hh);
  return dispatch<C>(p, q, {x3, y3, z3}, h_zero, r_zero);
}

template <class C>
__device__ __forceinline__ Pt<C> load_point(const int32_t* __restrict__ x,
                                            const int32_t* __restrict__ y,
                                            const int32_t* __restrict__ z, int64_t n,
                                            int64_t j) {
  return {C::load(x, n, j), C::load(y, n, j), C::load(z, n, j)};
}

template <class C>
__device__ __forceinline__ void store_point(int32_t* __restrict__ x, int32_t* __restrict__ y,
                                            int32_t* __restrict__ z, int64_t n, int64_t j,
                                            const Pt<C>& p) {
  C::store(x, n, j, p.x);
  C::store(y, n, j, p.y);
  C::store(z, n, j, p.z);
}

enum Which : int { kAdd = 0, kMadd = 1, kDouble = 2 };

// One lane of the point-op kernel: every coordinate a (*E, n) array.
template <class C, int WHICH>
__device__ __forceinline__ void point_lane(
    const int32_t* __restrict__ px, const int32_t* __restrict__ py,
    const int32_t* __restrict__ pz, const int32_t* __restrict__ qx,
    const int32_t* __restrict__ qy, const int32_t* __restrict__ qz, int32_t* __restrict__ ox,
    int32_t* __restrict__ oy, int32_t* __restrict__ oz, int64_t n, int64_t j) {
  const Pt<C> p = load_point<C>(px, py, pz, n, j);
  Pt<C> r;
  if constexpr (WHICH == kDouble) {
    r = point_double<C>(p);
  } else {
    const Pt<C> q = load_point<C>(qx, qy, qz, n, j);
    r = (WHICH == kAdd) ? point_add<C>(p, q) : point_madd<C>(p, q);
  }
  store_point<C>(ox, oy, oz, n, j, r);
}

// Out-of-line complete addition and doubling for the fold and combine
// kernels, which reach each formula from several places: one body per object
// keeps `ptxas` time (minutes for the BLS12-381 G2 objects) from growing with
// the number of call sites. The result is written after it is computed, so
// `r` may alias `p` or `q`.
template <class C>
__device__ __noinline__ void add_to(Pt<C>& r, const Pt<C>& p, const Pt<C>& q) {
  r = point_add<C>(p, q);
}

template <class C>
__device__ __noinline__ void double_to(Pt<C>& r, const Pt<C>& p) {
  r = point_double<C>(p);
}

constexpr unsigned kFullWarp = 0xffffffffu;

// Every 32-bit word of a point from the thread `delta` below (`shfl_up`) or
// above (`shfl_down`) in its group of `width` threads of the warp; a thread
// with no such partner keeps its own value. All threads of the warp call it.
template <class C>
__device__ __forceinline__ Pt<C> shfl_up(const Pt<C>& v, int delta, int width) {
  constexpr int kWords = sizeof(Pt<C>) / sizeof(uint32_t);
  Pt<C> r;
  const uint32_t* s = reinterpret_cast<const uint32_t*>(&v);
  uint32_t* o = reinterpret_cast<uint32_t*>(&r);
#pragma unroll
  for (int i = 0; i < kWords; ++i) o[i] = __shfl_up_sync(kFullWarp, s[i], delta, width);
  return r;
}

template <class C>
__device__ __forceinline__ Pt<C> shfl_down(const Pt<C>& v, int delta, int width) {
  constexpr int kWords = sizeof(Pt<C>) / sizeof(uint32_t);
  Pt<C> r;
  const uint32_t* s = reinterpret_cast<const uint32_t*>(&v);
  uint32_t* o = reinterpret_cast<uint32_t*>(&r);
#pragma unroll
  for (int i = 0; i < kWords; ++i) o[i] = __shfl_down_sync(kFullWarp, s[i], delta, width);
  return r;
}

// Threads that share one lane of the fold kernel for a K-step stream: chunks
// of 4 to 8 steps (all K steps where K < 8), a power of two, at most a
// warp. A function of K alone; `point_kernels.fold_threads` is the same.
__host__ __device__ __forceinline__ int fold_threads(int steps) {
  int t = 1;
  while (t < 32 && 8 * t <= steps) t *= 2;
  return t;
}

// One thread of the fold kernel: thread `t` of the `width` threads that scan
// lane j. qx, qy, qz, ax, ay, az: (K, *E, R); head: (K, R); bx, by, bz: (*E, R)
// or null. Per lane, A[k] = q[k] if head[k] else A[k-1] + q[k] (A[-1] =
// infinity), and B = sum over k of A[k], as a segmented inclusive scan under
// complete addition, (f1, P1) o (f2, P2) = (f1 | f2, f2 ? P2 : P1 + P2):
//   1. thread t folds its chunk of ceil(K / width) steps from infinity into
//      (any head, its last A);
//   2. the group scans those totals by shuffles in log2(width) levels;
//   3. each thread folds its chunk again from the total of the chunks before
//      it (infinity for the first), writing A and summing its A values;
//   4. the partial sums of B are added pairwise in log2(width) levels.
// `live` is false for the threads of a lane past R: they take part in the
// shuffles and compute nothing. `point_kernels._fold_scan` runs the same
// additions on the same operands.
template <class C>
__device__ __forceinline__ void fold_group(
    const int32_t* __restrict__ qx, const int32_t* __restrict__ qy,
    const int32_t* __restrict__ qz, const int32_t* __restrict__ head,
    int32_t* __restrict__ ax, int32_t* __restrict__ ay, int32_t* __restrict__ az,
    int32_t* __restrict__ bx, int32_t* __restrict__ by, int32_t* __restrict__ bz, int steps,
    int64_t lanes, int64_t j, int t, int width, bool live) {
  const int64_t step = C::kRows * lanes;
  const int chunk = (steps + width - 1) / width;
  const int k0 = live ? min(steps, t * chunk) : 0;
  const int k1 = live ? min(steps, k0 + chunk) : 0;

  // 1. the chunk's own fold
  Pt<C> a = infinity<C>();
  bool f = false;
#pragma unroll 1
  for (int k = k0; k < k1; ++k) {
    const int64_t off = k * step;
    const Pt<C> q = load_point<C>(qx + off, qy + off, qz + off, lanes, j);
    if (head[k * lanes + j] != 0) {
      a = q;
      f = true;
    } else {
      add_to<C>(a, a, q);
    }
  }
  // 2. inclusive scan of the chunk totals
#pragma unroll 1
  for (int d = 1; d < width; d *= 2) {
    const Pt<C> prev = shfl_up<C>(a, d, width);
    const bool prev_f = __shfl_up_sync(kFullWarp, f, d, width) != 0;
    if (t >= d) {
      if (!f) add_to<C>(a, prev, a);
      f = f || prev_f;
    }
  }
  // 3. the chunk again, from the total before it
  a = shfl_up<C>(a, 1, width);
  if (t == 0) a = infinity<C>();
  Pt<C> b = infinity<C>();
#pragma unroll 1
  for (int k = k0; k < k1; ++k) {
    const int64_t off = k * step;
    const Pt<C> q = load_point<C>(qx + off, qy + off, qz + off, lanes, j);
    if (head[k * lanes + j] != 0) {
      a = q;
    } else {
      add_to<C>(a, a, q);
    }
    store_point<C>(ax + off, ay + off, az + off, lanes, j, a);
    if (bx != nullptr) add_to<C>(b, b, a);
  }
  if (bx == nullptr) return;
  // 4. B = the sum of the threads' partial sums, pairwise
#pragma unroll 1
  for (int d = 1; d < width; d *= 2) {
    const Pt<C> other = shfl_down<C>(b, d, width);
    if ((t & (2 * d - 1)) == 0) add_to<C>(b, b, other);
  }
  if (t == 0 && live) store_point<C>(bx, by, bz, lanes, j, b);
}

// The formulas spread over a group of G threads of one warp (G a power of
// two, at most 32) that run one chain together: the bucket column and the
// merge kernel put 2 (G1) or 4 (G2) threads on each lane, the combine all 32
// on its Horner chain. Each round of a formula's Montgomery products whose
// operands are known runs as base-field products spread over the group:
// base product i of the round is computed by thread i % G in pass i / G
// (one pass where the round has at most G base products), and every thread
// gathers all of them by shuffles within the group, so that every thread
// of the group holds the same values and takes the same branches. The base
// products, their operands and the additions around them are those of
// `point_double`, `point_add` and `point_madd` (an Fq2 product is its three
// base products, an Fq2 square its two), so the results are the same
// integers. `WarpProducts<C>` splits a product of C into base products:
// `*_operands` gives base product `part`'s operands, `*_result` gathers
// base products first, first + 1, ... through `get(i)`.
template <int G>
struct Group {
  static_assert(G >= 1 && G <= 32 && (G & (G - 1)) == 0, "a group is 2^k <= 32 threads");
  int rank;       // this thread's place in the group
  unsigned mask;  // the group's threads in the warp
  __device__ __forceinline__ explicit Group(int lane)
      : rank(lane % G), mask(G == 32 ? kFullWarp : ((1u << G) - 1u) << (lane - lane % G)) {}
};

// Every 32-bit word of v from thread `src` of the group.
template <int G, class V>
__device__ __forceinline__ V shfl_from(const V& v, int src, const Group<G>& g) {
  constexpr int kWords = sizeof(V) / sizeof(uint32_t);
  V r;
  const uint32_t* s = reinterpret_cast<const uint32_t*>(&v);
  uint32_t* o = reinterpret_cast<uint32_t*>(&r);
#pragma unroll
  for (int i = 0; i < kWords; ++i) o[i] = __shfl_sync(g.mask, s[i], src, G);
  return r;
}

// One round of P base products of B over a group of G threads.
// `operands(i, u, v)` sets the operands of base product i; `get(i)` returns
// base product i in every thread of the group (i a constant after inlining).
template <class B, int G, int P>
struct Round {
  using V = typename B::V;
  static constexpr int kPasses = (P + G - 1) / G;
  V w[kPasses];
  const Group<G>& g;
  template <class Operands>
  __device__ __forceinline__ Round(const Group<G>& group, const Operands& operands) : g(group) {
#pragma unroll
    for (int pass = 0; pass < kPasses; ++pass) {
      V u, v;
      operands(min(pass * G + g.rank, P - 1), u, v);
      w[pass] = B::mul(u, v);
    }
  }
  __device__ __forceinline__ V get(int i) const { return shfl_from<G>(w[i / G], i % G, g); }
};

template <class C>
struct WarpProducts;

template <class F>
struct WarpProducts<Base<F>> {
  using B = Base<F>;
  using V = typename B::V;
  static constexpr int kMul = 1, kSqr = 1;  // base products of a product, of a square
  __device__ __forceinline__ static void mul_operands(const V& a, const V& b, int, V& u, V& v) {
    u = a;
    v = b;
  }
  __device__ __forceinline__ static void sqr_operands(const V& a, int, V& u, V& v) {
    u = a;
    v = a;
  }
  template <class R>
  __device__ __forceinline__ static V mul_result(const R& r, int first) {
    return r.get(first);
  }
  template <class R>
  __device__ __forceinline__ static V sqr_result(const R& r, int first) {
    return r.get(first);
  }
};

template <class F>
struct WarpProducts<Ext<F>> {
  using B = Base<F>;
  using BV = typename B::V;
  using V = typename Ext<F>::V;
  static constexpr int kMul = 3, kSqr = 2;
  // Ext::mul: t0 = a0 b0, t1 = a1 b1, s = (a0 + a1)(b0 + b1)
  __device__ __forceinline__ static void mul_operands(const V& a, const V& b, int part, BV& u,
                                                      BV& v) {
    if (part == 0) {
      u = a.c0;
      v = b.c0;
    } else if (part == 1) {
      u = a.c1;
      v = b.c1;
    } else {
      u = B::add(a.c0, a.c1);
      v = B::add(b.c0, b.c1);
    }
  }
  // Ext::sqr: t = (a0 + a1)(a0 − a1), m = a0 a1
  __device__ __forceinline__ static void sqr_operands(const V& a, int part, BV& u, BV& v) {
    if (part == 0) {
      u = B::add(a.c0, a.c1);
      v = B::sub(a.c0, a.c1);
    } else {
      u = a.c0;
      v = a.c1;
    }
  }
  template <class R>
  __device__ __forceinline__ static V mul_result(const R& r, int first) {
    const BV t0 = r.get(first);
    const BV t1 = r.get(first + 1);
    const BV s = r.get(first + 2);
    return {B::sub(t0, t1), B::sub(B::sub(s, t0), t1)};
  }
  template <class R>
  __device__ __forceinline__ static V sqr_result(const R& r, int first) {
    const BV t = r.get(first);
    return {t, B::dbl(r.get(first + 1))};
  }
};

// The base field of a coordinate type: `Base<F>` for G1 and G2 alike.
template <class C>
using BaseOf = typename WarpProducts<C>::B;

// point_double in 3 rounds of products: {X², Y², 2Y·Z}, {B², (X + B)², (3A)²},
// {E·(D − X3)}. Every thread of the group returns the result.
template <class C, int G>
__device__ __noinline__ void group_double_to(Pt<C>& r, const Pt<C>& p, Group<G> g) {
  using W = WarpProducts<C>;
  using B = BaseOf<C>;
  using BV = typename B::V;
  constexpr int s = W::kSqr, m = W::kMul;
  // round 1: a = X², b = Y², z3 = 2Y·Z
  const Round<B, G, 2 * s + m> r1(g, [&](int i, BV& u, BV& v) {
    if (i < s) {
      W::sqr_operands(p.x, i, u, v);
    } else if (i < 2 * s) {
      W::sqr_operands(p.y, i - s, u, v);
    } else {
      W::mul_operands(C::dbl(p.y), p.z, i - 2 * s, u, v);
    }
  });
  const auto a = W::sqr_result(r1, 0);
  const auto b = W::sqr_result(r1, s);
  const auto z3 = W::mul_result(r1, 2 * s);
  // round 2: c = b², t = (X + b)², f = (3a)²
  const auto e = C::triple(a);
  const Round<B, G, 3 * s> r2(g, [&](int i, BV& u, BV& v) {
    if (i < s) {
      W::sqr_operands(b, i, u, v);
    } else if (i < 2 * s) {
      W::sqr_operands(C::add(p.x, b), i - s, u, v);
    } else {
      W::sqr_operands(e, i - 2 * s, u, v);
    }
  });
  const auto c = W::sqr_result(r2, 0);
  const auto t = W::sqr_result(r2, s);
  const auto f = W::sqr_result(r2, 2 * s);
  const auto d = C::dbl(C::sub(C::sub(t, a), c));
  const auto x3 = C::sub(f, C::dbl(d));
  // round 3: e·(d − x3)
  const Round<B, G, m> r3(g, [&](int i, BV& u, BV& v) {
    W::mul_operands(e, C::sub(d, x3), i, u, v);
  });
  const auto y3 = C::sub(W::mul_result(r3, 0), C::dbl(C::dbl(C::dbl(c))));
  r = {x3, y3, z3};
}

// point_add in 5 rounds of products: {Z1², Z2², Y1·Z2, Y2·Z1, 2Z1·Z2},
// {X1·Z2Z2, X2·Z1Z1, Y1Z2·Z2Z2, Y2Z1·Z1Z1}, {(2h)², r2², Z·h}, {h·i, u1·i},
// {r2·(v − x3), s1·j}, with the edge dispatch of `dispatch` taken as soon as
// its operands are known (the results are the same), its doubling by
// `group_double_to`. Every thread of the group returns the result.
template <class C, int G>
__device__ __noinline__ void group_add_to(Pt<C>& r, const Pt<C>& p, const Pt<C>& q, Group<G> g) {
  using W = WarpProducts<C>;
  using B = BaseOf<C>;
  using BV = typename B::V;
  constexpr int s = W::kSqr, m = W::kMul;
  if (C::is_zero(p.z)) {
    r = q;
    return;
  }
  if (C::is_zero(q.z)) {
    r = p;
    return;
  }
  // round 1
  const Round<B, G, 2 * s + 3 * m> r1(g, [&](int i, BV& u, BV& v) {
    if (i < s) {
      W::sqr_operands(p.z, i, u, v);
    } else if (i < 2 * s) {
      W::sqr_operands(q.z, i - s, u, v);
    } else if (i < 2 * s + m) {
      W::mul_operands(p.y, q.z, i - 2 * s, u, v);
    } else if (i < 2 * s + 2 * m) {
      W::mul_operands(q.y, p.z, i - 2 * s - m, u, v);
    } else {
      W::mul_operands(C::dbl(p.z), q.z, i - 2 * s - 2 * m, u, v);
    }
  });
  const auto z1z1 = W::sqr_result(r1, 0);
  const auto z2z2 = W::sqr_result(r1, s);
  const auto y1z2 = W::mul_result(r1, 2 * s);
  const auto y2z1 = W::mul_result(r1, 2 * s + m);
  const auto zz = W::mul_result(r1, 2 * s + 2 * m);
  // round 2
  const Round<B, G, 4 * m> r2(g, [&](int i, BV& u, BV& v) {
    if (i < m) {
      W::mul_operands(p.x, z2z2, i, u, v);
    } else if (i < 2 * m) {
      W::mul_operands(q.x, z1z1, i - m, u, v);
    } else if (i < 3 * m) {
      W::mul_operands(y1z2, z2z2, i - 2 * m, u, v);
    } else {
      W::mul_operands(y2z1, z1z1, i - 3 * m, u, v);
    }
  });
  const auto u1 = W::mul_result(r2, 0);
  const auto h = C::sub(W::mul_result(r2, m), u1);
  const auto s1 = W::mul_result(r2, 2 * m);
  const auto rr = C::sub(W::mul_result(r2, 3 * m), s1);
  if (C::is_zero(h)) {
    if (C::is_zero(rr)) {
      group_double_to<C, G>(r, p, g);
    } else {
      r = infinity<C>();
    }
    return;
  }
  const auto r2x = C::dbl(rr);
  // round 3
  const Round<B, G, 2 * s + m> r3(g, [&](int i, BV& u, BV& v) {
    if (i < s) {
      W::sqr_operands(C::dbl(h), i, u, v);
    } else if (i < 2 * s) {
      W::sqr_operands(r2x, i - s, u, v);
    } else {
      W::mul_operands(zz, h, i - 2 * s, u, v);
    }
  });
  const auto i4 = W::sqr_result(r3, 0);
  const auto r2r2 = W::sqr_result(r3, s);
  const auto z3 = W::mul_result(r3, 2 * s);
  // round 4
  const Round<B, G, 2 * m> r4(g, [&](int i, BV& u, BV& v) {
    if (i < m) {
      W::mul_operands(h, i4, i, u, v);
    } else {
      W::mul_operands(u1, i4, i - m, u, v);
    }
  });
  const auto j = W::mul_result(r4, 0);
  const auto vv = W::mul_result(r4, m);
  const auto x3 = C::sub(C::sub(r2r2, j), C::dbl(vv));
  // round 5
  const Round<B, G, 2 * m> r5(g, [&](int i, BV& u, BV& v) {
    if (i < m) {
      W::mul_operands(r2x, C::sub(vv, x3), i, u, v);
    } else {
      W::mul_operands(s1, j, i - m, u, v);
    }
  });
  const auto y3 = C::sub(W::mul_result(r5, 0), C::dbl(W::mul_result(r5, m)));
  r = {x3, y3, z3};
}

// point_madd (q affine, Z in {0, 1}) in 5 rounds of products: {Z1², Y2·Z1},
// {X2·Z1Z1, Y2Z1·Z1Z1}, {H², R², (Z1 + H)²}, {H·I4, X1·I4}, {R·(V − X3),
// Y1·J}: at most 3 base products a round for G1, 6 for G2. The edge
// dispatch as in `group_add_to`. Every thread of the group returns the
// result.
template <class C, int G>
__device__ __noinline__ void group_madd_to(Pt<C>& r, const Pt<C>& p, const Pt<C>& q, Group<G> g) {
  using W = WarpProducts<C>;
  using B = BaseOf<C>;
  using BV = typename B::V;
  constexpr int s = W::kSqr, m = W::kMul;
  if (C::is_zero(p.z)) {
    r = q;
    return;
  }
  if (C::is_zero(q.z)) {
    r = p;
    return;
  }
  // round 1: z1z1 = Z1², yz = Y2·Z1
  const Round<B, G, s + m> r1(g, [&](int i, BV& u, BV& v) {
    if (i < s) {
      W::sqr_operands(p.z, i, u, v);
    } else {
      W::mul_operands(q.y, p.z, i - s, u, v);
    }
  });
  const auto z1z1 = W::sqr_result(r1, 0);
  const auto yz = W::mul_result(r1, s);
  // round 2: u2 = X2·z1z1, s2 = yz·z1z1
  const Round<B, G, 2 * m> r2(g, [&](int i, BV& u, BV& v) {
    if (i < m) {
      W::mul_operands(q.x, z1z1, i, u, v);
    } else {
      W::mul_operands(yz, z1z1, i - m, u, v);
    }
  });
  const auto h = C::sub(W::mul_result(r2, 0), p.x);
  const auto rhalf = C::sub(W::mul_result(r2, m), p.y);
  if (C::is_zero(h)) {
    if (C::is_zero(rhalf)) {
      group_double_to<C, G>(r, p, g);
    } else {
      r = infinity<C>();
    }
    return;
  }
  const auto rx = C::dbl(rhalf);
  // round 3: hh = h², rr = r², zh = (Z1 + h)²
  const Round<B, G, 3 * s> r3(g, [&](int i, BV& u, BV& v) {
    if (i < s) {
      W::sqr_operands(h, i, u, v);
    } else if (i < 2 * s) {
      W::sqr_operands(rx, i - s, u, v);
    } else {
      W::sqr_operands(C::add(p.z, h), i - 2 * s, u, v);
    }
  });
  const auto hh = W::sqr_result(r3, 0);
  const auto rr = W::sqr_result(r3, s);
  const auto z3 = C::sub(C::sub(W::sqr_result(r3, 2 * s), z1z1), hh);
  const auto i4 = C::dbl(C::dbl(hh));
  // round 4: j = h·i4, v = X1·i4
  const Round<B, G, 2 * m> r4(g, [&](int i, BV& u, BV& v) {
    if (i < m) {
      W::mul_operands(h, i4, i, u, v);
    } else {
      W::mul_operands(p.x, i4, i - m, u, v);
    }
  });
  const auto j = W::mul_result(r4, 0);
  const auto vv = W::mul_result(r4, m);
  const auto x3 = C::sub(C::sub(rr, j), C::dbl(vv));
  // round 5: r·(v − x3), Y1·j
  const Round<B, G, 2 * m> r5(g, [&](int i, BV& u, BV& v) {
    if (i < m) {
      W::mul_operands(rx, C::sub(vv, x3), i, u, v);
    } else {
      W::mul_operands(p.y, j, i - m, u, v);
    }
  });
  const auto y3 = C::sub(W::mul_result(r5, 0), C::dbl(W::mul_result(r5, m)));
  r = {x3, y3, z3};
}

// p at lane j of (*E, n) arrays, stored by the threads of a group that all
// hold it: thread `rank` stores coordinates rank, rank + G, ... (0 x, 1 y,
// 2 z).
template <class C, int G>
__device__ __forceinline__ void store_spread(int32_t* __restrict__ x, int32_t* __restrict__ y,
                                             int32_t* __restrict__ z, int64_t n, int64_t j,
                                             const Pt<C>& p, const Group<G>& g) {
#pragma unroll
  for (int which = 0; which < 3; ++which) {
    if (which % G != g.rank) continue;
    if (which == 0) {
      C::store(x, n, j, p.x);
    } else if (which == 1) {
      C::store(y, n, j, p.y);
    } else {
      C::store(z, n, j, p.z);
    }
  }
}

// One group of the point-op kernel: the G threads that run lane j of the
// (*E, n) arrays, one add (`group_add_to`), mixed add (`group_madd_to`) or
// double (`group_double_to`); the edge dispatch is a branch of the group, so
// the doubling runs only where a lane needs it. Each thread loads the
// operands itself.
template <class C, int WHICH, int G>
__device__ __forceinline__ void point_group(
    const int32_t* __restrict__ px, const int32_t* __restrict__ py,
    const int32_t* __restrict__ pz, const int32_t* __restrict__ qx,
    const int32_t* __restrict__ qy, const int32_t* __restrict__ qz, int32_t* __restrict__ ox,
    int32_t* __restrict__ oy, int32_t* __restrict__ oz, int64_t n, int64_t j,
    const Group<G>& g) {
  if (j >= n) return;  // the whole group: its threads share j
  const Pt<C> p = load_point<C>(px, py, pz, n, j);
  Pt<C> r;
  if constexpr (WHICH == kDouble) {
    group_double_to<C, G>(r, p, g);
  } else if constexpr (WHICH == kAdd) {
    group_add_to<C, G>(r, p, load_point<C>(qx, qy, qz, n, j), g);
  } else {
    group_madd_to<C, G>(r, p, load_point<C>(qx, qy, qz, n, j), g);
  }
  store_spread<C, G>(ox, oy, oz, n, j, r, g);
}

// One group of the bucket-column kernel: the G threads (thread `rank` of
// group `g`) that run lane j. px, py: (K, *E, R); qinf, head, slot: (K, R).
// Per lane, for k < K: acc = q[k] if head[k] else madd(acc, q[k]) (q =
// infinity where qinf[k]), the JAX kernel's column loop; acc is written to
// the buckets (*E, num_slots) at slot[k] where slot[k] >= 0, and the last acc
// to acc_last (*E, R). Nothing else is written. Each thread of the group
// loads the step's point itself: the group's threads read the same words, a
// warp's groups neighbouring lanes.
template <class C, int G>
__device__ __forceinline__ void bucket_column_group(
    const int32_t* __restrict__ px, const int32_t* __restrict__ py,
    const int32_t* __restrict__ qinf, const int32_t* __restrict__ head,
    const int32_t* __restrict__ slot, int32_t* __restrict__ bx, int32_t* __restrict__ by,
    int32_t* __restrict__ bz, int32_t* __restrict__ ax, int32_t* __restrict__ ay,
    int32_t* __restrict__ az, int steps, int64_t lanes, int64_t num_slots, int64_t j,
    const Group<G>& g) {
  if (j >= lanes) return;
  const int64_t step = C::kRows * lanes;  // elements of one coordinate per step
  Pt<C> acc = infinity<C>();
#pragma unroll 1
  for (int k = 0; k < steps; ++k) {
    const int64_t off = k * step;
    const int64_t m = k * lanes + j;
    const bool q_inf = qinf[m] != 0;
    const Pt<C> q = {C::load(px + off, lanes, j),
                     q_inf ? C::one() : C::load(py + off, lanes, j),
                     q_inf ? C::zero() : C::one()};
    if (head[m] != 0) {
      acc = q;
    } else {
      group_madd_to<C, G>(acc, acc, q, g);
    }
    if (slot[m] >= 0) store_spread<C, G>(bx, by, bz, num_slots, slot[m], acc, g);
  }
  store_spread<C, G>(ax, ay, az, lanes, j, acc, g);
}

// One group of the merge kernel: bucket array a (*E, num_slots), updated in
// place; the trailing partials of the fold's two levels, v1 (*E, n1) at
// slots key1 (n1) and v2 (*E, n2) at key2 (n2), a slot −1 for none, the slots
// of a level unique; inv1, inv2 (num_slots): the entry of each level at a
// slot, or −1. Group e < n1 takes level-1 entry e's bucket, and its level-2
// partial if any; group n1 + e takes level-2 entry e's bucket where no
// level-1 partial hits it. The bucket becomes add(add(a, b1), b2), a missing
// partial being infinity: the two complete additions of the dense merge,
// on the buckets a partial hits.
template <class C, int G>
__device__ __forceinline__ void merge_group(
    int32_t* __restrict__ ax, int32_t* __restrict__ ay, int32_t* __restrict__ az,
    const int32_t* __restrict__ v1x, const int32_t* __restrict__ v1y,
    const int32_t* __restrict__ v1z, const int32_t* __restrict__ key1,
    const int32_t* __restrict__ v2x, const int32_t* __restrict__ v2y,
    const int32_t* __restrict__ v2z, const int32_t* __restrict__ key2,
    const int32_t* __restrict__ inv1, const int32_t* __restrict__ inv2, int64_t n1, int64_t n2,
    int64_t num_slots, int64_t e, const Group<G>& g) {
  int64_t b, i1, i2;
  if (e < n1) {
    b = key1[e];
    if (b < 0) return;
    i1 = e;
    i2 = inv2[b];
  } else if (e < n1 + n2) {
    i2 = e - n1;
    b = key2[i2];
    if (b < 0 || inv1[b] >= 0) return;
    i1 = -1;
  } else {
    return;
  }
  const Pt<C> a = load_point<C>(ax, ay, az, num_slots, b);
  const Pt<C> p1 = i1 >= 0 ? load_point<C>(v1x, v1y, v1z, n1, i1) : infinity<C>();
  const Pt<C> p2 = i2 >= 0 ? load_point<C>(v2x, v2y, v2z, n2, i2) : infinity<C>();
  // the bucket is written back in place: every thread of the group has read
  // it before any thread stores (threads of a warp need not run in step)
  __syncwarp(g.mask);
  Pt<C> r;
  group_add_to<C, G>(r, a, p1, g);
  group_add_to<C, G>(r, r, p2, g);
  store_spread<C, G>(ax, ay, az, num_slots, b, r, g);
}

// A bucket no partial hits: the dense merge's add(add(a, ∞), ∞) is a, or the
// backend's infinity (0, 1, 0) where a is at infinity with other
// coordinates.
template <class C>
__device__ __forceinline__ void merge_untouched(int32_t* __restrict__ ax,
                                                int32_t* __restrict__ ay,
                                                int32_t* __restrict__ az,
                                                const int32_t* __restrict__ inv1,
                                                const int32_t* __restrict__ inv2,
                                                int64_t num_slots, int64_t b) {
  if (b >= num_slots || inv1[b] >= 0 || inv2[b] >= 0) return;
  if (C::is_zero(C::load(az, num_slots, b))) {
    store_point<C>(ax, ay, az, num_slots, b, infinity<C>());
  }
}

// The chain of the MSM's last steps, spread over the 32 threads of a warp:
// for each of `steps` addends w = addend(s), `doublings` doublings of acc,
// then acc = add(acc, w) (chain_first) or add(w, acc); `msm.double_add_loop`
// formula for formula. Every thread of the warp holds acc.
template <class C, class Addend>
__device__ __forceinline__ void double_add_chain(Pt<C>& acc, int steps, int doublings,
                                                 bool chain_first, const Addend& addend,
                                                 const Group<32>& warp) {
#pragma unroll 1
  for (int s = 0; s < steps; ++s) {
#pragma unroll 1
    for (int i = 0; i < doublings; ++i) group_double_to<C, 32>(acc, acc, warp);
    const Pt<C> w = addend(s);
    if (chain_first) {
      group_add_to<C, 32>(acc, acc, w, warp);
    } else {
      group_add_to<C, 32>(acc, w, acc, warp);
    }
  }
}

// One warp of the chain kernel: lane j of init (*E, n) and of the addends
// (steps, *E, n), its chain (`double_add_chain`) into out (*E, n).
template <class C>
__device__ __forceinline__ void double_add_warp(
    const int32_t* __restrict__ ix, const int32_t* __restrict__ iy,
    const int32_t* __restrict__ iz, const int32_t* __restrict__ wx,
    const int32_t* __restrict__ wy, const int32_t* __restrict__ wz, int32_t* __restrict__ ox,
    int32_t* __restrict__ oy, int32_t* __restrict__ oz, int64_t n, int steps, int doublings,
    bool chain_first, int64_t j, const Group<32>& warp) {
  if (j >= n) return;  // the whole warp
  const int64_t step = C::kRows * n;
  Pt<C> acc = load_point<C>(ix, iy, iz, n, j);
  double_add_chain<C>(acc, steps, doublings, chain_first, [&](int s) {
    const int64_t off = s * step;
    return load_point<C>(wx + off, wy + off, wz + off, n, j);
  }, warp);
  store_spread<C, 32>(ox, oy, oz, n, j, acc, warp);
}

// The window combine of the MSM, one block of `threads` threads (whole
// warps): the weighted fold's level-2 final rows A and B, (*E, 2W) each
// (lanes [T | B] of `msm._weighted_fold_fused`), give per window
// S_w = 2^doublings·(B[w] − A[w]) + A[W + w] (one warp per window, into
// `sums`, shared memory), then warp 0 runs Horner's rule acc = S_{W−1};
// acc = 2^window_bits·acc + S_w for w = W−2 .. 0 (`double_add_chain`) and
// writes acc, (*E, 1). The formulas and their order are those of
// `msm.window_sums` and `msm.horner`, each spread over the warp's 32 lanes
// (`group_add_to`, `group_double_to`).
template <class C>
__device__ __forceinline__ void combine_block(
    const int32_t* __restrict__ ax, const int32_t* __restrict__ ay,
    const int32_t* __restrict__ az, const int32_t* __restrict__ bx,
    const int32_t* __restrict__ by, const int32_t* __restrict__ bz, int32_t* __restrict__ ox,
    int32_t* __restrict__ oy, int32_t* __restrict__ oz, int windows, int doublings,
    int window_bits, Pt<C>* sums, int t, int threads) {
  const int64_t lanes = 2 * windows;
  const Group<32> lane(t % 32);
#pragma unroll 1
  for (int w = t / 32; w < windows; w += threads / 32) {
    const Pt<C> a2 = load_point<C>(ax, ay, az, lanes, w);
    const Pt<C> b2 = load_point<C>(bx, by, bz, lanes, w);
    Pt<C> d;
    group_add_to<C, 32>(d, b2, {a2.x, C::sub(C::zero(), a2.y), a2.z}, lane);
#pragma unroll 1
    for (int i = 0; i < doublings; ++i) group_double_to<C, 32>(d, d, lane);
    Pt<C> sum;
    group_add_to<C, 32>(sum, d, load_point<C>(ax, ay, az, lanes, windows + w), lane);
    if (lane.rank == 0) sums[w] = sum;
  }
  __syncthreads();
  if (t >= 32) return;
  Pt<C> acc = sums[windows - 1];
  double_add_chain<C>(acc, windows - 1, window_bits, true,
                      [&](int s) { return sums[windows - 2 - s]; }, lane);
  if (lane.rank == 0) store_point<C>(ox, oy, oz, 1, 0, acc);
}

}  // namespace manta
