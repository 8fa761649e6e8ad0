// Curve arithmetic as device functions for the kernels of `point_kernels.cu`:
// coordinate ops over a base field (G1) or over Fq2 = Fq[u]/(u^2 + 1) (G2),
// Jacobian points, the three formulas of `manta_tpu_torch/ops/curve.py`
// (CurveOps.double / add / madd with the edge dispatch of `_add_dispatch`),
// each in the same sequence of field ops, so the lazy [0, 2p) values agree
// bit for bit with the plain versions, and the body of each kernel: one lane
// (`point_lane`, `column_lane`), one thread of a lane's group (`fold_group`)
// or one block (`combine_block`, whose formulas run spread over the lanes of
// a warp: `warp_double_to`, `warp_add_to`). Nothing here launches: a host
// C++ harness can include this header (with the CUDA qualifiers and the warp
// shuffles defined for the CPU) and run the bodies there.

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

// One lane of the column kernel. px, py, ox, oy, oz: (K, *E, R); qinf, head:
// (K, R). The accumulator starts at infinity and stays in registers.
template <class C>
__device__ __forceinline__ void column_lane(
    const int32_t* __restrict__ px, const int32_t* __restrict__ py,
    const int32_t* __restrict__ qinf, const int32_t* __restrict__ head,
    int32_t* __restrict__ ox, int32_t* __restrict__ oy, int32_t* __restrict__ oz, int steps,
    int64_t lanes, int64_t j) {
  const int64_t step = C::kRows * lanes;  // elements of one coordinate per step
  Pt<C> acc = infinity<C>();
#pragma unroll 1
  for (int k = 0; k < steps; ++k) {
    const int64_t off = k * step;
    const bool q_inf = qinf[k * lanes + j] != 0;
    const Pt<C> q = {C::load(px + off, lanes, j),
                     q_inf ? C::one() : C::load(py + off, lanes, j),
                     q_inf ? C::zero() : C::one()};
    acc = (head[k * lanes + j] != 0) ? q : point_madd<C>(acc, q);
    store_point<C>(ox + off, oy + off, oz + off, lanes, j, acc);
  }
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

// The formulas spread over the 32 lanes of a warp, for one chain that has
// nothing else to run in parallel (the combine's Horner chain). Each round
// of a formula's Montgomery products whose operands are known runs as one
// base-field product per lane: lane i computes base product i of the round
// and every lane gathers all of them by shuffles, so that every lane holds
// the same values and runs the same code. The base products, their operands
// and the additions around them are those of `point_double` and
// `point_add` (an Fq2 product is its three base products, an Fq2 square
// its two), so the results are the same integers. `WarpProducts<C>` splits
// a product of C into base products: `*_operands` gives lane `part`'s
// operands, `*_result` gathers the products of lanes first, first + 1, ...
template <class F>
__device__ __forceinline__ typename Base<F>::V shfl_from(const typename Base<F>::V& v, int src) {
  typename Base<F>::V r;
#pragma unroll
  for (int k = 0; k < FieldOps<F>::S; ++k) r.w[k] = __shfl_sync(kFullWarp, v.w[k], src);
  return r;
}

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
  __device__ __forceinline__ static V mul_result(const V& w, int first) {
    return shfl_from<F>(w, first);
  }
  __device__ __forceinline__ static V sqr_result(const V& w, int first) {
    return shfl_from<F>(w, first);
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
  __device__ __forceinline__ static V mul_result(const BV& w, int first) {
    const BV t0 = shfl_from<F>(w, first);
    const BV t1 = shfl_from<F>(w, first + 1);
    const BV s = shfl_from<F>(w, first + 2);
    return {B::sub(t0, t1), B::sub(B::sub(s, t0), t1)};
  }
  __device__ __forceinline__ static V sqr_result(const BV& w, int first) {
    const BV t = shfl_from<F>(w, first);
    return {t, B::dbl(shfl_from<F>(w, first + 1))};
  }
};

// The base field of a coordinate type: `Base<F>` for G1 and G2 alike.
template <class C>
using BaseOf = typename WarpProducts<C>::B;

// point_double in 3 rounds of products: {X², Y², 2Y·Z}, {B², (X + B)², (3A)²},
// {E·(D − X3)}. Every lane of the warp returns the result.
template <class C>
__device__ __noinline__ void warp_double_to(Pt<C>& r, const Pt<C>& p, int lane) {
  using W = WarpProducts<C>;
  using B = BaseOf<C>;
  constexpr int s = W::kSqr, m = W::kMul;
  typename B::V u, v;
  // round 1: a = X², b = Y², z3 = 2Y·Z
  if (lane < s) {
    W::sqr_operands(p.x, lane, u, v);
  } else if (lane < 2 * s) {
    W::sqr_operands(p.y, lane - s, u, v);
  } else {
    W::mul_operands(C::dbl(p.y), p.z, min(lane - 2 * s, m - 1), u, v);
  }
  typename B::V w = B::mul(u, v);
  const auto a = W::sqr_result(w, 0);
  const auto b = W::sqr_result(w, s);
  const auto z3 = W::mul_result(w, 2 * s);
  // round 2: c = b², t = (X + b)², f = (3a)²
  const auto e = C::triple(a);
  if (lane < s) {
    W::sqr_operands(b, lane, u, v);
  } else if (lane < 2 * s) {
    W::sqr_operands(C::add(p.x, b), lane - s, u, v);
  } else {
    W::sqr_operands(e, min(lane - 2 * s, s - 1), u, v);
  }
  w = B::mul(u, v);
  const auto c = W::sqr_result(w, 0);
  const auto t = W::sqr_result(w, s);
  const auto f = W::sqr_result(w, 2 * s);
  const auto d = C::dbl(C::sub(C::sub(t, a), c));
  const auto x3 = C::sub(f, C::dbl(d));
  // round 3: e·(d − x3)
  W::mul_operands(e, C::sub(d, x3), min(lane, m - 1), u, v);
  w = B::mul(u, v);
  const auto y3 = C::sub(W::mul_result(w, 0), C::dbl(C::dbl(C::dbl(c))));
  r = {x3, y3, z3};
}

// point_add in 5 rounds of products: {Z1², Z2², Y1·Z2, Y2·Z1, 2Z1·Z2},
// {X1·Z2Z2, X2·Z1Z1, Y1Z2·Z2Z2, Y2Z1·Z1Z1}, {(2h)², r2², Z·h}, {h·i, u1·i},
// {r2·(v − x3), s1·j}; the edge dispatch as `dispatch`, its doubling by
// `warp_double_to`. Every lane of the warp returns the result.
template <class C>
__device__ __noinline__ void warp_add_to(Pt<C>& r, const Pt<C>& p, const Pt<C>& q, int lane) {
  using W = WarpProducts<C>;
  using B = BaseOf<C>;
  constexpr int s = W::kSqr, m = W::kMul;
  typename B::V u, v;
  // round 1
  if (lane < s) {
    W::sqr_operands(p.z, lane, u, v);
  } else if (lane < 2 * s) {
    W::sqr_operands(q.z, lane - s, u, v);
  } else if (lane < 2 * s + m) {
    W::mul_operands(p.y, q.z, lane - 2 * s, u, v);
  } else if (lane < 2 * s + 2 * m) {
    W::mul_operands(q.y, p.z, lane - 2 * s - m, u, v);
  } else {
    W::mul_operands(C::dbl(p.z), q.z, min(lane - 2 * s - 2 * m, m - 1), u, v);
  }
  typename B::V w = B::mul(u, v);
  const auto z1z1 = W::sqr_result(w, 0);
  const auto z2z2 = W::sqr_result(w, s);
  const auto y1z2 = W::mul_result(w, 2 * s);
  const auto y2z1 = W::mul_result(w, 2 * s + m);
  const auto zz = W::mul_result(w, 2 * s + 2 * m);
  // round 2
  if (lane < m) {
    W::mul_operands(p.x, z2z2, lane, u, v);
  } else if (lane < 2 * m) {
    W::mul_operands(q.x, z1z1, lane - m, u, v);
  } else if (lane < 3 * m) {
    W::mul_operands(y1z2, z2z2, lane - 2 * m, u, v);
  } else {
    W::mul_operands(y2z1, z1z1, min(lane - 3 * m, m - 1), u, v);
  }
  w = B::mul(u, v);
  const auto u1 = W::mul_result(w, 0);
  const auto h = C::sub(W::mul_result(w, m), u1);
  const auto s1 = W::mul_result(w, 2 * m);
  const auto rr = C::sub(W::mul_result(w, 3 * m), s1);
  const bool h_zero = C::is_zero(h);
  const bool r_zero = C::is_zero(rr);
  const auto r2 = C::dbl(rr);
  // round 3
  if (lane < s) {
    W::sqr_operands(C::dbl(h), lane, u, v);
  } else if (lane < 2 * s) {
    W::sqr_operands(r2, lane - s, u, v);
  } else {
    W::mul_operands(zz, h, min(lane - 2 * s, m - 1), u, v);
  }
  w = B::mul(u, v);
  const auto i = W::sqr_result(w, 0);
  const auto r2r2 = W::sqr_result(w, s);
  const auto z3 = W::mul_result(w, 2 * s);
  // round 4
  if (lane < m) {
    W::mul_operands(h, i, lane, u, v);
  } else {
    W::mul_operands(u1, i, min(lane - m, m - 1), u, v);
  }
  w = B::mul(u, v);
  const auto j = W::mul_result(w, 0);
  const auto vv = W::mul_result(w, m);
  const auto x3 = C::sub(C::sub(r2r2, j), C::dbl(vv));
  // round 5
  if (lane < m) {
    W::mul_operands(r2, C::sub(vv, x3), lane, u, v);
  } else {
    W::mul_operands(s1, j, min(lane - m, m - 1), u, v);
  }
  w = B::mul(u, v);
  const auto y3 = C::sub(W::mul_result(w, 0), C::dbl(W::mul_result(w, m)));
  if (C::is_zero(p.z)) {
    r = q;
  } else if (C::is_zero(q.z)) {
    r = p;
  } else if (h_zero) {
    if (r_zero) {
      warp_double_to<C>(r, p, lane);
    } else {
      r = infinity<C>();
    }
  } else {
    r = {x3, y3, z3};
  }
}

// The window combine of the MSM, one block of `threads` threads (whole
// warps): the weighted fold's level-2 final rows A and B, (*E, 2W) each
// (lanes [T | B] of `msm._weighted_fold_fused`), give per window
// S_w = 2^doublings·(B[w] − A[w]) + A[W + w] (one warp per window, into
// `sums`, shared memory), then warp 0 runs Horner's rule acc = S_{W−1};
// acc = 2^window_bits·acc + S_w for w = W−2 .. 0 and writes acc, (*E, 1).
// The formulas and their order are those of `msm.window_sums` and
// `msm.horner`, each spread over the warp's lanes (`warp_add_to`,
// `warp_double_to`).
template <class C>
__device__ __forceinline__ void combine_block(
    const int32_t* __restrict__ ax, const int32_t* __restrict__ ay,
    const int32_t* __restrict__ az, const int32_t* __restrict__ bx,
    const int32_t* __restrict__ by, const int32_t* __restrict__ bz, int32_t* __restrict__ ox,
    int32_t* __restrict__ oy, int32_t* __restrict__ oz, int windows, int doublings,
    int window_bits, Pt<C>* sums, int t, int threads) {
  const int64_t lanes = 2 * windows;
  const int lane = t % 32;
#pragma unroll 1
  for (int w = t / 32; w < windows; w += threads / 32) {
    const Pt<C> a2 = load_point<C>(ax, ay, az, lanes, w);
    const Pt<C> b2 = load_point<C>(bx, by, bz, lanes, w);
    Pt<C> d;
    warp_add_to<C>(d, b2, {a2.x, C::sub(C::zero(), a2.y), a2.z}, lane);
#pragma unroll 1
    for (int i = 0; i < doublings; ++i) warp_double_to<C>(d, d, lane);
    Pt<C> sum;
    warp_add_to<C>(sum, d, load_point<C>(ax, ay, az, lanes, windows + w), lane);
    if (lane == 0) sums[w] = sum;
  }
  __syncthreads();
  if (t >= 32) return;
  Pt<C> acc = sums[windows - 1];
#pragma unroll 1
  for (int w = windows - 2; w >= 0; --w) {
#pragma unroll 1
    for (int i = 0; i < window_bits; ++i) warp_double_to<C>(acc, acc, lane);
    warp_add_to<C>(acc, acc, sums[w], lane);
  }
  if (lane == 0) store_point<C>(ox, oy, oz, 1, 0, acc);
}

}  // namespace manta
