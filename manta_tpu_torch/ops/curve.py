"""Batched elliptic-curve group operations on the GPU (PyTorch).

Short Weierstrass curves y^2 = x^3 + b with a = 0 (BN254, BLS12-381), in
Jacobian coordinates (X, Y, Z), Z == 0 encoding infinity. The formulas are
branchless over the batch: additions compute the generic-add, double and
identity-passthrough results and lane-select between them (the doubling only
when some lane needs it).

Coordinates are field-element batches in limb-major Montgomery layout
(`manta_tpu_torch.ops.field_ops`): (L, ...) int32 for Fq curves (G1) and
(2, L, ...) for Fq2 curves (G2). `CoordOps` / `Fq2Ops` make the point
formulas generic over both. Port of `manta_tpu/ops/curve.py`: the limb
backend here, the fused backend in `ops/kernels/point_kernels.py`. The RNS
backends hold coordinates as packed residues (Kt, ...) / (2, Kt, ...)
(`ops/rns.py`): `CurveOps(curve, "rns")` runs the formulas above over
renormalizing RNS field ops, `RnsCurveOps` the bound-annotated formulas, and
`ops/kernels/rns_kernels.py` the kernels of the "rns_fused" and
"rns_hybrid" backends.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from manta_tpu_torch import fields
from manta_tpu_torch.ops import field_ops as F
from manta_tpu_torch.ops import rns as RNS
from manta_tpu_torch.utils import hostmath


class CoordOps:
    """Field-op dispatch over base-field coordinate arrays (Fq: (L, ...))."""

    def __init__(self, spec: fields.FieldSpec):
        self.spec = spec

    def add(self, a, b):
        return F.add(self.spec, a, b)

    def sub(self, a, b):
        return F.sub(self.spec, a, b)

    def neg(self, a):
        return F.neg(self.spec, a)

    def mul(self, a, b):
        return F.mont_mul(self.spec, a, b)

    def sqr(self, a):
        return F.mont_mul(self.spec, a, a)

    def double(self, a):
        return F.add(self.spec, a, a)

    def triple(self, a):
        return F.add(self.spec, F.add(self.spec, a, a), a)

    def is_zero(self, a):
        return F.is_zero(self.spec, a)

    def eq(self, a, b):
        return F.eq(self.spec, a, b)

    def select(self, mask, a, b):
        return F.select(mask, a, b)

    def zeros_like(self, a):
        return torch.zeros_like(a)

    def one_like(self, a):
        return F.one_like(self.spec, a)

    def batch_inv(self, a):
        return F.batch_inv(self.spec, a)

    def encode(self, values, montgomery=True):
        return F.encode_ints(self.spec, values, montgomery=montgomery)

    def decode(self, arr, montgomery=True):
        return F.decode_ints(self.spec, arr, montgomery=montgomery)


def _lanes(*parts):
    """Stack base-field operands (L, ...) along a new axis 1 -> (L, k, ...),
    so that one base-field call works on all of them."""
    return torch.stack(parts, dim=1)


class Fq2Ops:
    """Quadratic extension Fq[u]/(u^2 + 1) over stacked arrays (2, L, ...).

    The same base-field operations as the JAX package's `Fq2Ops` (Karatsuba
    multiplication: 3 base Montgomery products), so the limbs agree bit for
    bit; independent base operations of one kind go to the base field in one
    call on stacked operands (one kernel launch instead of two or three)."""

    def __init__(self, spec: fields.FieldSpec):
        self.spec = spec
        self.base = CoordOps(spec)

    @staticmethod
    def _pairwise(op, a, b):
        """op on both components at once: (2, L, ...) viewed as (L, 2, ...)."""
        return op(a.movedim(0, 1), b.movedim(0, 1)).movedim(1, 0)

    def add(self, a, b):
        return self._pairwise(self.base.add, a, b)

    def sub(self, a, b):
        return self._pairwise(self.base.sub, a, b)

    def neg(self, a):
        return self.sub(torch.zeros_like(a), a)

    def mul(self, a, b):
        base = self.base
        s = base.add(_lanes(a[0], b[0]), _lanes(a[1], b[1]))  # a0+a1, b0+b1
        t = base.mul(_lanes(a[0], a[1], s[:, 0]), _lanes(b[0], b[1], s[:, 1]))
        t0, t1, t2 = t.unbind(1)
        u = base.sub(_lanes(t0, t2), _lanes(t1, t0))  # t0 - t1, s - t0
        return torch.stack([u[:, 0], base.sub(u[:, 1], t1)])  # u^2 = -1

    def sqr(self, a):
        # (a0 + a1 u)^2 = (a0+a1)(a0-a1) + 2 a0 a1 u
        base = self.base
        t = base.mul(
            _lanes(base.add(a[0], a[1]), a[0]), _lanes(base.sub(a[0], a[1]), a[1])
        )
        return torch.stack([t[:, 0], base.double(t[:, 1])])

    def double(self, a):
        return self.add(a, a)

    def triple(self, a):
        return self.add(self.add(a, a), a)

    def is_zero(self, a):
        return self.base.is_zero(a[0]) & self.base.is_zero(a[1])

    def eq(self, a, b):
        return self.base.eq(a[0], b[0]) & self.base.eq(a[1], b[1])

    def select(self, mask, a, b):
        return torch.where(mask[None, None], a, b)

    def zeros_like(self, a):
        return torch.zeros_like(a)

    def one_like(self, a):
        return torch.stack([self.base.one_like(a[0]), self.base.zeros_like(a[1])])

    def batch_inv(self, a):
        # (a0 + a1 u)^-1 = (a0 - a1 u) / (a0^2 + a1^2)
        norm = self.base.add(self.base.sqr(a[0]), self.base.sqr(a[1]))
        n_inv = self.base.batch_inv(norm)
        return torch.stack(
            [self.base.mul(a[0], n_inv), self.base.neg(self.base.mul(a[1], n_inv))]
        )

    def encode(self, values, montgomery=True):
        c0 = self.base.encode([v[0] for v in values], montgomery)
        c1 = self.base.encode([v[1] for v in values], montgomery)
        return np.stack([c0, c1])

    def decode(self, arr, montgomery=True):
        c0 = self.base.decode(arr[0], montgomery)
        c1 = self.base.decode(arr[1], montgomery)
        return list(zip(c0, c1))


class JacobianPoint(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor


@dataclasses.dataclass(frozen=True)
class CurveOps:
    """Batched group ops for one short-Weierstrass a=0 curve. On the limb
    backend every field op is one launch of the field kernel on a CUDA
    tensor (its plain version on a CPU tensor); on the "rns" backend the
    field ops are the packed RNS ops of `ops/rns.py`."""

    curve: hostmath.WeierstrassCurve
    backend: str = "limb"

    @functools.cached_property
    def ops(self):
        if self.backend == "rns":
            if self.curve.is_ext:
                return RNS.RnsFq2CoordOps(self.curve.field)
            return RNS.RnsCoordOps(self.curve.field)
        if self.curve.is_ext:
            return Fq2Ops(self.curve.field)
        return CoordOps(self.curve.field)

    @property
    def limb16_points(self) -> bool:
        """True when the affine point arrays this backend feeds the MSM are
        (L, n) rows of 16-bit limbs, which the MSM gathers two to a word."""
        return not self.curve.is_ext and self.backend != "rns"

    # -- host <-> device --

    def encode_points(self, points, device="cuda") -> JacobianPoint:
        """Affine host points (None = infinity) -> Jacobian batch on `device`."""
        dev = F.resolve_device(device)
        o = self.ops
        zero = (0, 0) if self.curve.is_ext else 0
        one = (1, 0) if self.curve.is_ext else 1
        xs = [zero if pt is None else pt[0] for pt in points]
        ys = [one if pt is None else pt[1] for pt in points]
        zs = [zero if pt is None else one for pt in points]
        return JacobianPoint(
            F.as_tensor(o.encode(xs), dev),
            F.as_tensor(o.encode(ys), dev),
            F.as_tensor(o.encode(zs), dev),
        )

    def decode_points(self, pt: JacobianPoint):
        """Jacobian batch -> affine host points (None = infinity)."""
        o = self.ops
        xs, ys = o.decode(pt.x), o.decode(pt.y)
        zs = o.decode(pt.z)
        p = self.curve.field.modulus
        out = []
        for x, y, z in zip(xs, ys, zs):
            if z == 0 or z == (0, 0):
                out.append(None)
                continue
            if self.curve.is_ext:
                z_inv = hostmath.fq2_inv(z, p)
                z2 = hostmath.fq2_square(z_inv, p)
                z3 = hostmath.fq2_mul(z2, z_inv, p)
                out.append((hostmath.fq2_mul(x, z2, p), hostmath.fq2_mul(y, z3, p)))
            else:
                z_inv = hostmath.finv(z, p)
                out.append((x * z_inv * z_inv % p, y * pow(z_inv, 3, p) % p))
        return out

    # -- group law --

    def infinity_like(self, template: JacobianPoint) -> JacobianPoint:
        o = self.ops
        return JacobianPoint(
            o.zeros_like(template.x), o.one_like(template.y), o.zeros_like(template.z)
        )

    def is_infinity(self, pt: JacobianPoint):
        return self.ops.is_zero(pt.z)

    def affine_infinity_mask(self, pt: JacobianPoint):
        """Infinity test for encoder-produced affine batches (Z in {0, 1})."""
        return self.is_infinity(pt)

    def double(self, pt: JacobianPoint) -> JacobianPoint:
        """dbl-2009-l (a = 0); infinity (Z = 0) maps to Z3 = 0."""
        o = self.ops
        a = o.sqr(pt.x)  # XX
        b = o.sqr(pt.y)  # YY
        c = o.sqr(b)  # YYYY
        t = o.sqr(o.add(pt.x, b))
        d = o.double(o.sub(o.sub(t, a), c))  # S = 2((X+YY)^2 - XX - YYYY)
        e = o.triple(a)  # M = 3 XX
        f = o.sqr(e)
        x3 = o.sub(f, o.double(d))
        y3 = o.sub(o.mul(e, o.sub(d, x3)), o.double(o.double(o.double(c))))
        z3 = o.mul(o.double(pt.y), pt.z)
        return JacobianPoint(x3, y3, z3)

    def _add_dispatch(self, p, q, generic, h_zero, r_zero) -> JacobianPoint:
        """Branchless edge cases shared by add/madd: p_inf -> q; q_inf -> p;
        h==0 & r==0 -> double(p); h==0 & r!=0 -> infinity; else generic.
        The doubling is computed only when some lane needs it (the JAX
        package's `lax.cond`)."""
        o = self.ops
        p_inf = self.is_infinity(p)
        q_inf = self.is_infinity(q)
        either_inf = p_inf | q_inf
        is_dbl = h_zero & r_zero & ~either_inf
        is_inf_result = h_zero & ~r_zero & ~either_inf
        dbl = self.double(p) if bool(is_dbl.any()) else p
        inf = self.infinity_like(p)

        def pick(gen, dbl_c, inf_c, p_c, q_c):
            out = o.select(is_dbl, dbl_c, gen)
            out = o.select(is_inf_result, inf_c, out)
            out = o.select(q_inf, p_c, out)
            return o.select(p_inf, q_c, out)

        return JacobianPoint(
            pick(generic.x, dbl.x, inf.x, p.x, q.x),
            pick(generic.y, dbl.y, inf.y, p.y, q.y),
            pick(generic.z, dbl.z, inf.z, p.z, q.z),
        )

    def add(self, p: JacobianPoint, q: JacobianPoint) -> JacobianPoint:
        """Complete Jacobian addition (add-2007-bl + branchless edge cases)."""
        o = self.ops
        z1z1 = o.sqr(p.z)
        z2z2 = o.sqr(q.z)
        u1 = o.mul(p.x, z2z2)
        u2 = o.mul(q.x, z1z1)
        s1 = o.mul(o.mul(p.y, q.z), z2z2)
        s2 = o.mul(o.mul(q.y, p.z), z1z1)
        h = o.sub(u2, u1)
        rr = o.sub(s2, s1)
        h_zero = o.is_zero(h)
        r_zero = o.is_zero(rr)
        i = o.sqr(o.double(h))
        j = o.mul(h, i)
        r2 = o.double(rr)
        v = o.mul(u1, i)
        x3 = o.sub(o.sub(o.sqr(r2), j), o.double(v))
        y3 = o.sub(o.mul(r2, o.sub(v, x3)), o.double(o.mul(s1, j)))
        z3 = o.mul(o.mul(o.double(p.z), q.z), h)
        return self._add_dispatch(p, q, JacobianPoint(x3, y3, z3), h_zero, r_zero)

    def madd(self, p: JacobianPoint, q: JacobianPoint) -> JacobianPoint:
        """Complete mixed addition (madd-2007-bl): p Jacobian + q affine
        (Z in {0, 1}; (0, 1, 0) encodes infinity)."""
        o = self.ops
        z1z1 = o.sqr(p.z)
        u2 = o.mul(q.x, z1z1)
        s2 = o.mul(o.mul(q.y, p.z), z1z1)
        h = o.sub(u2, p.x)
        rhalf = o.sub(s2, p.y)
        h_zero = o.is_zero(h)
        r_zero = o.is_zero(rhalf)
        hh = o.sqr(h)
        i4 = o.double(o.double(hh))
        j = o.mul(h, i4)
        r = o.double(rhalf)
        v = o.mul(p.x, i4)
        x3 = o.sub(o.sub(o.sqr(r), j), o.double(v))
        y3 = o.sub(o.mul(r, o.sub(v, x3)), o.double(o.mul(p.y, j)))
        z3 = o.sub(o.sub(o.sqr(o.add(p.z, h)), z1z1), hh)
        return self._add_dispatch(p, q, JacobianPoint(x3, y3, z3), h_zero, r_zero)

    def neg(self, pt: JacobianPoint) -> JacobianPoint:
        return JacobianPoint(pt.x, self.ops.neg(pt.y), pt.z)

    def to_affine(self, pt: JacobianPoint) -> JacobianPoint:
        """Batch-normalize to affine (Z in {0, 1}); infinity -> (0, 1, 0)."""
        o = self.ops
        z_inv = o.batch_inv(pt.z)  # zeros stay zero
        z2 = o.sqr(z_inv)
        z3 = o.mul(z2, z_inv)
        x = o.mul(pt.x, z2)
        y = o.mul(pt.y, z3)
        inf = self.is_infinity(pt)
        one = o.one_like(pt.z)
        zero = o.zeros_like(pt.z)
        return JacobianPoint(
            o.select(inf, zero, x), o.select(inf, one, y), o.select(inf, zero, one)
        )


_NAMED = {
    c.name: CurveOps(c)
    for c in (
        hostmath.BLS12_381_G1,
        hostmath.BLS12_381_G2,
        hostmath.BN254_G1,
        hostmath.BN254_G2,
    )
}


@functools.lru_cache(maxsize=None)
def _ops_cache(curve: hostmath.WeierstrassCurve, backend: str) -> CurveOps:
    return CurveOps(curve, backend)


BACKENDS = ("limb", "fused", "rns", "rns_fused", "rns_hybrid")


def curve_ops_for(curve: hostmath.WeierstrassCurve, backend: str = "limb") -> CurveOps:
    """Curve ops for `backend`: "limb" (one field-kernel launch per field op),
    "fused" (one kernel launch per whole formula, and the MSM's column and
    fold kernels; `ops/kernels/point_kernels.py`), "rns" (the formulas over
    RNS field ops), "rns_fused" (RNS point and column kernels) or
    "rns_hybrid" (RNS group law over limb point arrays;
    `ops/kernels/rns_kernels.py`)."""
    if backend == "fused":
        from manta_tpu_torch.ops.kernels.point_kernels import fused_curve_ops_for

        return fused_curve_ops_for(curve)
    if backend in ("rns_fused", "rns_hybrid"):
        from manta_tpu_torch.ops.kernels import rns_kernels as RK

        return getattr(RK, f"{backend}_curve_ops_for")(curve)
    if backend not in BACKENDS:
        raise ValueError(f"unknown curve backend {backend!r}; expected one of {BACKENDS}")
    if backend == "limb" and curve.name in _NAMED:
        return _NAMED[curve.name]
    return _ops_cache(curve, backend)


@functools.lru_cache(maxsize=None)
def rns_curve_ops_for(curve: hostmath.WeierstrassCurve) -> "RnsCurveOps":
    """RNS backend with the bound-annotated (renormalization-free) formulas."""
    return RnsCurveOps(curve, "rns")


@dataclasses.dataclass(frozen=True)
class RnsCurveOps(CurveOps):
    """Curve ops with the bound-annotated RNS formulas of the JAX package
    (`manta_tpu/ops/curve.py::RnsCurveOps`): raw residue adds and subs with
    per-call offsets instead of a renormalizing product per add or sub. The
    `sub_k` offsets are the JAX package's, literal for literal: they decide
    the residues.

    Bound audit (values as multiples of p; product outputs < (k1+2)p ≈ 2^6):
    every mul/sqr resets to 2^6; the longest raw chains stay <= 2^11.2, and
    the RNS spec admits product inputs up to 2^12 (M1 > 2^25·p)."""

    def double(self, pt: JacobianPoint) -> JacobianPoint:
        o = self.ops
        a = o.sqr(pt.x)  # 2^6
        b = o.sqr(pt.y)  # 2^6
        c = o.sqr(b)  # 2^6
        t = o.sqr(o.add_raw(pt.x, b))  # input <= 2^11; out 2^6
        d = o.double_raw(o.sub_k(o.sub_k(t, a, 6), c, 6))  # <= 2^8.6
        e = o.add_raw(o.add_raw(a, a), a)  # 3·2^6 <= 2^8
        f = o.sqr(e)  # 2^6
        x3 = o.sub_k(f, o.double_raw(d), 10)  # <= 2^6 + 2^10
        c8 = o.double_raw(o.double_raw(o.double_raw(c)))  # 2^9
        y3 = o.sub_k(o.mul(e, o.sub_k(d, x3, 11)), c8, 9)  # <= 2^9.2
        z3 = o.mul(o.double_raw(pt.y), pt.z)  # 2^6
        return JacobianPoint(x3, y3, z3)

    def add(self, p: JacobianPoint, q: JacobianPoint) -> JacobianPoint:
        o = self.ops
        z1z1 = o.sqr(p.z)
        z2z2 = o.sqr(q.z)
        u1 = o.mul(p.x, z2z2)
        u2 = o.mul(q.x, z1z1)
        s1 = o.mul(o.mul(p.y, q.z), z2z2)
        s2 = o.mul(o.mul(q.y, p.z), z1z1)
        h = o.sub_k(u2, u1, 6)  # <= 2^7
        rr = o.sub_k(s2, s1, 6)  # <= 2^7
        h_zero = o.is_zero(h)
        r_zero = o.is_zero(rr)
        i = o.sqr(o.double_raw(h))  # 2^6
        j = o.mul(h, i)  # 2^6
        r2 = o.double_raw(rr)  # 2^8
        v = o.mul(u1, i)  # 2^6
        x3 = o.sub_k(o.sub_k(o.sqr(r2), j, 6), o.double_raw(v), 7)  # <= 2^8.3
        y3 = o.sub_k(
            o.mul(r2, o.sub_k(v, x3, 9)),  # inner <= 2^9.3; out 2^6
            o.double_raw(o.mul(s1, j)),  # 2^7
            7,
        )  # <= 2^7.3
        z3 = o.mul(o.mul(o.double_raw(p.z), q.z), h)  # inputs <= 2^7
        return self._add_dispatch(p, q, JacobianPoint(x3, y3, z3), h_zero, r_zero)

    def madd(self, p: JacobianPoint, q: JacobianPoint) -> JacobianPoint:
        """Bound-annotated mixed add (madd-2007-bl). Accumulator bounds under
        MSM use: a fresh affine value, a madd output (x <= 2^8.1,
        y <= 2^7.7, z <= 2^7.6) or a double output (x <= 2^10.1, y <= 2^9.2,
        z <= 2^6); the offsets cover x <= 2^11, y <= 2^10, z <= 2^8, and
        every product input stays <= 2^12. q is normalized (< p)."""
        o = self.ops
        z1z1 = o.sqr(p.z)  # 2^6
        u2 = o.mul(q.x, z1z1)  # 2^6
        s2 = o.mul(o.mul(q.y, p.z), z1z1)  # 2^6
        h = o.sub_k(u2, p.x, 11)  # <= 2^6 + 2^11
        rhalf = o.sub_k(s2, p.y, 10)  # <= 2^6 + 2^10
        h_zero = o.is_zero(h)
        r_zero = o.is_zero(rhalf)
        hh = o.sqr(h)  # 2^6
        i4 = o.double_raw(o.double_raw(hh))  # 2^8
        j = o.mul(h, i4)  # 2^6
        r = o.double_raw(rhalf)  # <= 2^11.1
        v = o.mul(p.x, i4)  # 2^6
        x3 = o.sub_k(o.sub_k(o.sqr(r), j, 6), o.double_raw(v), 7)  # <= 2^8.1
        y3 = o.sub_k(
            o.mul(r, o.sub_k(v, x3, 9)),  # inner <= 2^9.2; out 2^6
            o.double_raw(o.mul(p.y, j)),  # 2^7
            7,
        )  # <= 2^7.7
        z3 = o.sub_k(o.sub_k(o.sqr(o.add_raw(p.z, h)), z1z1, 6), hh, 6)  # <= 2^7.6
        return self._add_dispatch(p, q, JacobianPoint(x3, y3, z3), h_zero, r_zero)
