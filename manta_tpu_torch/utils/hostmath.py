"""Host-side arbitrary-precision field and curve arithmetic.

Pure-Python (big-int) implementations of the prime-field and elliptic-curve
operations. These serve three purposes:

1. Ground truth for the device kernels (`manta_tpu_torch.ops.*`) in tests.
2. Host-side implementation for cold paths (parameter generation, point
   (de)serialization, Schnorr over the embedded curve) — mirroring how the
   reference keeps small serial work on the CPU.
3. Reference semantics for arkworks compatibility (Montgomery representation
   is a device-only concern; host values are canonical integers).

Curve constants match arkworks 0.3 (`ark-bls12-381`, `ark-bn254`,
`ark-ed-on-bn254`), which the reference consumes via
`manta-crypto/src/arkworks/*` (see reference `manta-crypto/Cargo.toml:95-110`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from manta_tpu_torch import fields

# ---------------------------------------------------------------------------
# Prime field helpers (canonical int representation)
# ---------------------------------------------------------------------------


def finv(x: int, p: int) -> int:
    if x % p == 0:
        raise ZeroDivisionError("field inverse of zero")
    return pow(x, -1, p)


def fsqrt(x: int, p: int) -> Optional[int]:
    """Square root via Tonelli-Shanks; None if not a QR. Returns min root."""
    x %= p
    if x == 0:
        return 0
    if pow(x, (p - 1) // 2, p) != 1:
        return None
    # Tonelli-Shanks
    q, s = p - 1, 0
    while q % 2 == 0:
        q //= 2
        s += 1
    if s == 1:
        r = pow(x, (p + 1) // 4, p)
    else:
        z = 2
        while pow(z, (p - 1) // 2, p) != p - 1:
            z += 1
        m, c, t, r = s, pow(z, q, p), pow(x, q, p), pow(x, (q + 1) // 2, p)
        while t != 1:
            t2, i = t, 0
            while t2 != 1:
                t2 = (t2 * t2) % p
                i += 1
            b = pow(c, 1 << (m - i - 1), p)
            m, c = i, (b * b) % p
            t, r = (t * c) % p, (r * b) % p
    return min(r, p - r)


# ---------------------------------------------------------------------------
# Quadratic extension Fq2 = Fq[u] / (u^2 - beta). Elements are (c0, c1) pairs.
# Both BLS12-381 and BN254 use beta = -1.
# ---------------------------------------------------------------------------


def fq2_add(a, b, p):
    return ((a[0] + b[0]) % p, (a[1] + b[1]) % p)


def fq2_sub(a, b, p):
    return ((a[0] - b[0]) % p, (a[1] - b[1]) % p)


def fq2_neg(a, p):
    return ((-a[0]) % p, (-a[1]) % p)


def fq2_mul(a, b, p):
    # (a0 + a1 u)(b0 + b1 u) with u^2 = -1
    t0 = a[0] * b[0] % p
    t1 = a[1] * b[1] % p
    return ((t0 - t1) % p, ((a[0] + a[1]) * (b[0] + b[1]) - t0 - t1) % p)


def fq2_square(a, p):
    return fq2_mul(a, a, p)


def fq2_scalar(a, k: int, p):
    return (a[0] * k % p, a[1] * k % p)


def fq2_inv(a, p):
    norm = (a[0] * a[0] + a[1] * a[1]) % p
    n_inv = finv(norm, p)
    return (a[0] * n_inv % p, (-a[1] * n_inv) % p)


def fq2_is_zero(a):
    return a[0] == 0 and a[1] == 0


# ---------------------------------------------------------------------------
# Short Weierstrass curves y^2 = x^3 + b over Fq or Fq2.
#
# Points: affine (x, y) or None for infinity. Jacobian (X, Y, Z): x = X/Z^2,
# y = Y/Z^3, Z = 0 means infinity. Coordinates are ints (Fq) or pairs (Fq2).
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class WeierstrassCurve:
    """y^2 = x^3 + b over the base field (degree 1 or 2 extension)."""

    name: str
    field: fields.FieldSpec  # base prime field Fq
    scalar_field: fields.FieldSpec
    b: object  # int for Fq curves, (int, int) for Fq2 curves
    generator: Tuple[object, object]
    cofactor: int = 1

    @property
    def is_ext(self) -> bool:
        return isinstance(self.b, tuple)

    # -- generic field dispatch over Fq / Fq2 --
    def _add(self, a, b):
        p = self.field.modulus
        return fq2_add(a, b, p) if self.is_ext else (a + b) % p

    def _sub(self, a, b):
        p = self.field.modulus
        return fq2_sub(a, b, p) if self.is_ext else (a - b) % p

    def _neg(self, a):
        p = self.field.modulus
        return fq2_neg(a, p) if self.is_ext else (-a) % p

    def _mul(self, a, b):
        p = self.field.modulus
        return fq2_mul(a, b, p) if self.is_ext else a * b % p

    def _sq(self, a):
        return self._mul(a, a)

    def _inv(self, a):
        p = self.field.modulus
        return fq2_inv(a, p) if self.is_ext else finv(a, p)

    def _scalar(self, a, k):
        p = self.field.modulus
        return fq2_scalar(a, k, p) if self.is_ext else a * k % p

    def _is_zero(self, a):
        return fq2_is_zero(a) if self.is_ext else a == 0

    def _zero(self):
        return (0, 0) if self.is_ext else 0

    def _one(self):
        return (1, 0) if self.is_ext else 1

    # -- affine ops --
    def is_on_curve(self, pt) -> bool:
        if pt is None:
            return True
        x, y = pt
        return self._sq(y) == self._add(self._mul(self._sq(x), x), self.b)

    def add(self, a, b):
        """Affine addition (complete)."""
        if a is None:
            return b
        if b is None:
            return a
        x1, y1 = a
        x2, y2 = b
        if x1 == x2:
            if self._is_zero(self._add(y1, y2)):
                return None
            return self.double(a)
        lam = self._mul(self._sub(y2, y1), self._inv(self._sub(x2, x1)))
        x3 = self._sub(self._sub(self._sq(lam), x1), x2)
        y3 = self._sub(self._mul(lam, self._sub(x1, x3)), y1)
        return (x3, y3)

    def double(self, a):
        if a is None:
            return None
        x1, y1 = a
        if self._is_zero(y1):
            return None
        lam = self._mul(
            self._scalar(self._sq(x1), 3), self._inv(self._scalar(y1, 2))
        )
        x3 = self._sub(self._sq(lam), self._scalar(x1, 2))
        y3 = self._sub(self._mul(lam, self._sub(x1, x3)), y1)
        return (x3, y3)

    def neg(self, a):
        if a is None:
            return None
        return (a[0], self._neg(a[1]))

    def scalar_mul(self, k: int, pt):
        k %= self.scalar_field.modulus
        result, addend = None, pt
        while k:
            if k & 1:
                result = self.add(result, addend)
            addend = self.double(addend)
            k >>= 1
        return result

    def msm(self, scalars, points):
        """Host MSM (naive; test oracle only)."""
        acc = None
        for k, pt in zip(scalars, points):
            acc = self.add(acc, self.scalar_mul(k, pt))
        return acc

    def msm_pippenger(self, scalars, points, c: int = 8):
        """Windowed-bucket Pippenger on the host (cold paths: Groth16 host
        backend for small circuits; the hot path is the device MSM)."""
        r = self.scalar_field.modulus
        pairs = [
            (k % r, pt)
            for k, pt in zip(scalars, points)
            if pt is not None and k % r
        ]
        if not pairs:
            return None
        nbits = self.scalar_field.bits
        num_windows = (nbits + c - 1) // c
        mask = (1 << c) - 1
        result = None
        for w in range(num_windows - 1, -1, -1):
            if result is not None:
                for _ in range(c):
                    result = self.double(result)
            buckets = [None] * (1 << c)
            shift = w * c
            for k, pt in pairs:
                digit = (k >> shift) & mask
                if digit:
                    buckets[digit] = self.add(buckets[digit], pt)
            running, window_sum = None, None
            for b in range(len(buckets) - 1, 0, -1):
                running = self.add(running, buckets[b])
                window_sum = self.add(window_sum, running)
            result = self.add(result, window_sum)
        return result


class FixedBaseTable:
    """Precomputed window table for repeated scalar mults on one base
    (Groth16 setup: thousands of [x]G on the generator)."""

    def __init__(self, curve: WeierstrassCurve, base, window: int = 8):
        self.curve = curve
        self.window = window
        nbits = curve.scalar_field.bits
        self.num_windows = (nbits + window - 1) // window
        self.table = []
        current = base
        for _ in range(self.num_windows):
            row = [None] * (1 << window)
            acc = None
            for j in range(1, 1 << window):
                acc = curve.add(acc, current)
                row[j] = acc
            self.table.append(row)
            # advance base by 2^window
            for _ in range(window):
                current = curve.double(current)

    def scalar_mul(self, k: int):
        k %= self.curve.scalar_field.modulus
        mask = (1 << self.window) - 1
        acc = None
        for w in range(self.num_windows):
            digit = (k >> (w * self.window)) & mask
            if digit:
                acc = self.curve.add(acc, self.table[w][digit])
        return acc


# ---------------------------------------------------------------------------
# Twisted Edwards curve a*x^2 + y^2 = 1 + d*x^2*y^2 over a prime field.
# The identity is (0, 1); the addition law is complete.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class EdwardsCurve:
    name: str
    field: fields.FieldSpec  # base field (= BN254 Fr for ed-on-bn254)
    scalar_field: fields.FieldSpec
    a: int
    d: int
    generator: Tuple[int, int]
    cofactor: int = 8

    def is_on_curve(self, pt) -> bool:
        p = self.field.modulus
        x, y = pt
        lhs = (self.a * x * x + y * y) % p
        rhs = (1 + self.d * x * x % p * y * y) % p
        return lhs == rhs

    @property
    def identity(self):
        return (0, 1)

    def add(self, pt1, pt2):
        p = self.field.modulus
        x1, y1 = pt1
        x2, y2 = pt2
        dxy = self.d * x1 * x2 % p * y1 * y2 % p
        x3 = (x1 * y2 + y1 * x2) * finv(1 + dxy, p) % p
        y3 = (y1 * y2 - self.a * x1 * x2) * finv(1 - dxy, p) % p
        return (x3, y3)

    def neg(self, pt):
        return ((-pt[0]) % self.field.modulus, pt[1])

    def scalar_mul(self, k: int, pt):
        k %= self.scalar_field.modulus
        result, addend = self.identity, pt
        while k:
            if k & 1:
                result = self.add(result, addend)
            addend = self.add(addend, addend)
            k >>= 1
        return result


# ---------------------------------------------------------------------------
# Concrete curves (constants = arkworks 0.3)
# ---------------------------------------------------------------------------

BLS12_381_G1 = WeierstrassCurve(
    name="bls12_381_g1",
    field=fields.BLS12_381_FQ,
    scalar_field=fields.BLS12_381_FR,
    b=4,
    generator=(
        0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB,
        0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1,
    ),
    cofactor=0x396C8C005555E1568C00AAAB0000AAAB,
)

BLS12_381_G2 = WeierstrassCurve(
    name="bls12_381_g2",
    field=fields.BLS12_381_FQ,
    scalar_field=fields.BLS12_381_FR,
    # b' = 4 * (1 + u)
    b=(4, 4),
    generator=(
        (
            0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8,
            0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E,
        ),
        (
            0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801,
            0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE,
        ),
    ),
    cofactor=0x5D543A95414E7F1091D50792876A202CD91DE4547085ABAA68A205B2E5A7DDFA628F1CB4D9E82EF21537E293A6691AE1616EC6E786F0C70CF1C38E31C7238E5,
)

BN254_G1 = WeierstrassCurve(
    name="bn254_g1",
    field=fields.BN254_FQ,
    scalar_field=fields.BN254_FR,
    b=3,
    generator=(1, 2),
    cofactor=1,
)

BN254_G2 = WeierstrassCurve(
    name="bn254_g2",
    field=fields.BN254_FQ,
    scalar_field=fields.BN254_FR,
    # b' = 3 / (9 + u)
    b=(
        0x2B149D40CEB8AAAE81BE18991BE06AC3B5B4C5E559DBEFA33267E6DC24A138E5,
        0x009713B03AF0FED4CD2CAFADEED8FDF4A74FA084E52D1852E4A2BD0685C315D2,
    ),
    generator=(
        (
            0x1800DEEF121F1E76426A00665E5C4479674322D4F75EDADD46DEBD5CD992F6ED,
            0x198E9393920D483A7260BFB731FB5D25F1AA493335A9E71297E485B7AEF312C2,
        ),
        (
            0x12C85EA5DB8C6DEB4AAB71808DCB408FE3D1E7690C43D37B4CE6CC0166FA7DAA,
            0x090689D0585FF075EC9E99AD690C3395BC4B313370B38EF355ACDADCD122975B,
        ),
    ),
    cofactor=0x30644E72E131A029B85045B68181585E06CEECDA572A2489345F2299C0F9FA8D,
)

# ark-ed-on-bn254 ("Baby Jubjub"): arkworks 0.3 uses the scaled twisted
# Edwards form with COEFF_A = 1 and COEFF_D = (168696 / 168700) mod p,
# isomorphic to the standard Baby Jubjub 168700 x^2 + y^2 = 1 + 168696 x^2 y^2.
ED_ON_BN254 = EdwardsCurve(
    name="ed_on_bn254",
    field=fields.BN254_FR,  # base field = BN254 scalar field
    scalar_field=fields.ED_ON_BN254_FR,
    a=1,
    d=(168696 * pow(168700, -1, fields.BN254_FR.modulus)) % fields.BN254_FR.modulus,
    generator=(
        19698561148652590122159747500897617769866003486955115824547446575314762165298,
        19298250018296453272277890825869354524455968081175474282777126169995084727839,
    ),
    cofactor=8,
)

#: Tiny curve over a 16-bit prime (2 limbs with lazy headroom). The group
#: order 65353 is prime. Used to exercise the full device MSM/curve machinery
#: with small compiled graphs (tests); NOT cryptographically meaningful.
TOY_FQ = fields.TOY_FQ
TOY_FR = fields.TOY_FR
TOY_G1 = WeierstrassCurve(
    name="toy_g1",
    field=TOY_FQ,
    scalar_field=TOY_FR,
    b=17,
    generator=(1, 1086),
    cofactor=1,
)

ALL_CURVES = {
    c.name: c for c in (BLS12_381_G1, BLS12_381_G2, BN254_G1, BN254_G2)
}
