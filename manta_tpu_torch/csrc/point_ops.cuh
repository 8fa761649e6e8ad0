// Curve arithmetic as device functions for the kernels of `point_kernels.cu`:
// coordinate ops over a base field (G1) or over Fq2 = Fq[u]/(u^2 + 1) (G2),
// Jacobian points, the three formulas of `manta_tpu_torch/ops/curve.py`
// (CurveOps.double / add / madd with the edge dispatch of `_add_dispatch`),
// each in the same sequence of field ops, so the lazy [0, 2p) values agree
// bit for bit with the plain versions, and the body of one lane of each
// kernel. Nothing here launches: a host C++ harness can include this header
// (with the CUDA qualifiers defined away) and run the lanes on the CPU.

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

// One lane of the fold kernel. qx, qy, qz and the six outputs: (K, *E, R);
// head: (K, R). The two complete additions of a step go through one loop
// of two turns, so the add formula is compiled once.
template <class C>
__device__ __forceinline__ void fold_lane(
    const int32_t* __restrict__ qx, const int32_t* __restrict__ qy,
    const int32_t* __restrict__ qz, const int32_t* __restrict__ head,
    int32_t* __restrict__ ax, int32_t* __restrict__ ay, int32_t* __restrict__ az,
    int32_t* __restrict__ bx, int32_t* __restrict__ by, int32_t* __restrict__ bz, int steps,
    int64_t lanes, int64_t j) {
  const int64_t step = C::kRows * lanes;
  Pt<C> a = infinity<C>();
  Pt<C> b = infinity<C>();
#pragma unroll 1
  for (int k = 0; k < steps; ++k) {
    const int64_t off = k * step;
    const Pt<C> q = load_point<C>(qx + off, qy + off, qz + off, lanes, j);
    const bool h = head[k * lanes + j] != 0;
    // turn 0: a = h ? q : a + q; turn 1: b = b + a
    Pt<C> u = a, v = q;
#pragma unroll 1
    for (int turn = 0; turn < 2; ++turn) {
      const Pt<C> s = point_add<C>(u, v);
      if (turn == 0) {
        a = h ? q : s;
        u = b;
        v = a;
      } else {
        b = s;
      }
    }
    store_point<C>(ax + off, ay + off, az + off, lanes, j, a);
    store_point<C>(bx + off, by + off, bz + off, lanes, j, b);
  }
}

}  // namespace manta
