"""Residue-number-system (RNS) field arithmetic (PyTorch).

Port of `manta_tpu/ops/rns.py`. A field element x is held as the residues of
x·M1 mod p (Montgomery form with respect to M1, plus small multiples of p
while it is lazy) modulo two bases of 12-bit primes B1 (k1 primes, product
M1), B2 (k2 primes, product M2) and one redundant prime m_r, with the
Bajard-style RNS Montgomery product:

- multiply: one modular product per channel;
- reduce: m = −T·p⁻¹ mod M1 residue-wise in B1, extended to B2 ∪ {m_r}
  through a constant (k2+1)×k1 integer matrix without the α·M1 correction
  (the overshoot only adds a multiple of p below the lazy bound), then
  t = (T + m̂·p)/M1 per channel;
- back into B1 exactly: Shenoy–Kumaresan base extension, with α recovered
  from the redundant channel.

Bounds: values stay below C_MAX·p between products; a product's output is
below (k1+2)·p. M1 > 2^25·p and M2 > 4·(k1+2)·C_MAX·p make every step exact
(`_check_spec`).

Layout at the boundary, as in the JAX package: packed channels-major
(Kt, ...) `torch.int32`, Kt = k1 + k2 + 1, every residue canonical in
[0, m). Inside, plain PyTorch with integer `%` and integer matrix products,
in int32: a channel product is below 2^24 and an extension sum of at most 37
of them below 2^30. This is the plain version of the field layer. The JAX package
computes the same residues with float32 Barrett steps and 6-bit digit-split
float matrix products, because the TPU's matrix unit has no integer product;
every one of those steps is exact, so the residues are the same integers.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch

from manta_tpu_torch import fields

#: integer-value slack budget: values may grow to C_MAX * p between products
C_MAX = 1 << 12

#: the `sub_k` offsets 2^k·p that the tables hold
OFFSETS = range(5, 14)


def _is_prime(n: int) -> bool:
    if n < 2:
        return False
    d = 2
    while d * d <= n:
        if n % d == 0:
            return False
        d += 1
    return True


def _primes_below(bits: int, count: int, skip=()):
    """`count` largest primes below 2^bits, excluding `skip` (trial division:
    the moduli are 12-bit)."""
    out = []
    candidate = (1 << bits) - 1
    while len(out) < count:
        if _is_prime(candidate) and candidate not in skip:
            out.append(candidate)
        candidate -= 2
    return out


@dataclasses.dataclass(frozen=True)
class RnsSpec:
    field: fields.FieldSpec
    b1: Tuple[int, ...]
    b2: Tuple[int, ...]
    m_r: int

    @functools.cached_property
    def M1(self) -> int:
        out = 1
        for m in self.b1:
            out *= m
        return out

    @functools.cached_property
    def M2(self) -> int:
        out = 1
        for m in self.b2:
            out *= m
        return out

    @property
    def k1(self) -> int:
        return len(self.b1)

    @property
    def k2(self) -> int:
        return len(self.b2)

    @property
    def kt(self) -> int:
        return self.k1 + self.k2 + 1

    @property
    def moduli(self) -> Tuple[int, ...]:
        return (*self.b1, *self.b2, self.m_r)

    @functools.cached_property
    def consts(self) -> dict:
        """The integer constant tables of the JAX package's `RnsSpec.consts`
        (its float32 reciprocals belong to the TPU's Barrett steps and are
        left out)."""
        p = self.field.modulus
        b1, b2, m_r = self.b1, self.b2, self.m_r
        M1, M2 = self.M1, self.M2
        all_t = list(b2) + [m_r]
        arr = lambda v: np.asarray(v, dtype=np.int32)  # noqa: E731
        c = {
            "m1": arr(b1),
            "m2": arr(b2),
            "neg_p_inv_1": arr([(-pow(p, -1, m)) % m for m in b1]),
            "w1": arr([pow(M1 // m, -1, m) for m in b1]),
            # ext1: (M1/m_i) mod m_t for t in B2 ∪ {m_r}
            "A1": arr([[(M1 // mi) % mt for mi in b1] for mt in all_t]),
            "p_2": arr([p % m for m in b2]),
            "p_r": np.int32(p % m_r),
            "M1_inv_2": arr([pow(M1, -1, m) % m for m in b2]),
            "M1_inv_r": np.int32(pow(M1, -1, m_r)),
            # ext2 (Shenoy): exact extension from B2 to B1
            "w2": arr([pow(M2 // m, -1, m) for m in b2]),
            "A2": arr([[(M2 // mj) % mi for mj in b2] for mi in b1]),
            "A2r": arr([(M2 // mj) % m_r for mj in b2]),
            "M2_inv_r": np.int32(pow(M2, -1, m_r)),
            "M2_mod_1": arr([M2 % m for m in b1]),
        }
        # residues of 2^k·p: the offsets that keep differences nonnegative
        for k in OFFSETS:
            c[f"off{k}_1"] = arr([((1 << k) * p) % m for m in b1])
            c[f"off{k}_2"] = arr([((1 << k) * p) % m for m in b2])
            c[f"off{k}_r"] = np.int32(((1 << k) * p) % m_r)
        return c


def _check_spec(spec: RnsSpec):
    p = spec.field.modulus
    if not spec.M1 > (1 << 25) * p:
        raise ValueError("M1 too small for the lazy bounds")
    if not spec.M2 > 4 * (spec.k1 + 2) * C_MAX * p:
        raise ValueError("M2 too small")
    if not spec.m_r > spec.k2 + 2:
        raise ValueError("redundant modulus must exceed k2")
    mods = spec.moduli
    if len(set(mods)) != len(mods):
        raise ValueError("moduli must be distinct")
    if any(m >= 1 << 12 for m in mods):
        raise ValueError("12-bit moduli required")


@functools.lru_cache(maxsize=None)
def default_spec(field: fields.FieldSpec) -> RnsSpec:
    k1 = (field.bits + 18 + 11) // 11  # conservative: primes are ~2^12
    k2 = (field.bits + 16 + 11) // 11
    b1 = _primes_below(12, k1)
    b2 = _primes_below(12, k2, skip=set(b1))
    m_r = _primes_below(12, 1, skip=set(b1) | set(b2))[0]
    spec = RnsSpec(field=field, b1=tuple(b1), b2=tuple(b2), m_r=m_r)
    _check_spec(spec)
    return spec


# ---------------------------------------------------------------------------
# Host encode / decode (numpy)
# ---------------------------------------------------------------------------


def encode_ints(spec: RnsSpec, values) -> tuple:
    """Canonical ints -> (B1 (k1, N), B2 (k2, N), r (N,)) int32 residues of
    x·M1 mod p."""
    p = spec.field.modulus
    vals = [(v % p) * spec.M1 % p for v in values]
    b1 = np.asarray([[v % m for v in vals] for m in spec.b1], dtype=np.int32).reshape(
        spec.k1, len(vals))
    b2 = np.asarray([[v % m for v in vals] for m in spec.b2], dtype=np.int32).reshape(
        spec.k2, len(vals))
    r = np.asarray([v % spec.m_r for v in vals], dtype=np.int32)
    return b1, b2, r


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def decode_ints(spec: RnsSpec, rep) -> list:
    """Residues -> canonical ints (CRT over B1; values must be < M1)."""
    b1 = _host(rep[0]).astype(np.int64)
    p = spec.field.modulus
    M1 = spec.M1
    M1_inv = pow(M1, -1, p)
    crt_w = [(M1 // m) * pow(M1 // m, -1, m) % M1 for m in spec.b1]
    out = []
    for n in range(b1.shape[1]):
        v = 0
        for i in range(spec.k1):
            v += int(b1[i, n]) * crt_w[i]
        out.append(v % M1 % p * M1_inv % p)
    return out


def pack(spec: RnsSpec, rep) -> torch.Tensor:
    """(B1, B2, r) residues -> one packed (Kt, ...) int32 tensor."""
    b1, b2, r = (torch.as_tensor(x) for x in rep)
    return torch.cat([b1, b2, r[None]], 0).to(torch.int32)


def unpack(spec: RnsSpec, arr):
    return arr[: spec.k1], arr[spec.k1 : spec.k1 + spec.k2], arr[spec.k1 + spec.k2]


# ---------------------------------------------------------------------------
# Packed ops: the single (Kt, ...) int32 array
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _packed_consts(spec: RnsSpec) -> dict:
    """Per-channel int32 columns (Kt,) and the extension matrices, numpy."""
    c = spec.consts
    i32 = lambda v: np.asarray(v, dtype=np.int32)  # noqa: E731
    p = spec.field.modulus
    mods = np.asarray(spec.moduli, dtype=np.int32)
    out = {
        "m_all": mods,
        "m1": i32(c["m1"]),
        "m2r": i32([*spec.b2, spec.m_r]),
        "neg_p_inv_1": i32(c["neg_p_inv_1"]),
        "w1": i32(c["w1"]),
        "A1": i32(c["A1"]),
        "p_2r": i32([*c["p_2"], c["p_r"]]),
        "M1_inv_2r": i32([*c["M1_inv_2"], c["M1_inv_r"]]),
        "w2": i32(c["w2"]),
        "A2": i32(c["A2"]),
        "A2r": i32(c["A2r"])[None],
        "M2_mod_1": i32(c["M2_mod_1"]),
        "one": np.concatenate([x.reshape(-1) for x in _one_rep_cached(spec)]).astype(np.int32),
    }
    for k in OFFSETS:
        out[f"off{k}"] = np.asarray([((1 << k) * p) % m for m in spec.moduli], dtype=np.int32)
    return out


@functools.lru_cache(maxsize=None)
def _const_on(spec: RnsSpec, key: str, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_packed_consts(spec)[key]).to(device)


def _col(spec: RnsSpec, key: str, like: torch.Tensor) -> torch.Tensor:
    """Constant `key` as an int32 column broadcasting over `like`'s batch."""
    v = _const_on(spec, key, like.device)
    return v.reshape(v.shape + (1,) * (like.ndim - 1))


def packed_add(spec: RnsSpec, a, b) -> torch.Tensor:
    m = _col(spec, "m_all", a)
    s = a + b
    return torch.where(s >= m, s - m, s)


def packed_sub_k(spec: RnsSpec, a, b, k: int) -> torch.Tensor:
    """a − b + 2^k·p per channel: the represented integer stays nonnegative
    while bound(b) <= 2^k·p; the bound grows to bound(a) + 2^k·p."""
    return (a - b + _col(spec, f"off{k}", a)) % _col(spec, "m_all", a)


def _ext(spec: RnsSpec, key: str, x: torch.Tensor) -> torch.Tensor:
    """(rows, k) @ (k, ...) exact integer product by the matrix `key`. CUDA
    has no integer matrix product: there it runs in float64, exact for these
    sums (< 2^30)."""
    mat = _const_on(spec, key, x.device)
    flat = x.reshape(x.shape[0], -1)
    if x.device.type == "cuda":
        out = (mat.double() @ flat.double()).to(x.dtype)
    else:
        out = mat @ flat
    return out.reshape(mat.shape[0], *x.shape[1:])


def packed_mul(spec: RnsSpec, a, b) -> torch.Tensor:
    """RNS Montgomery product: represents a·b·M1⁻¹ mod p, below (k1+2)·p."""
    k1, k2 = spec.k1, spec.k2
    t = a * b % _col(spec, "m_all", a)
    t1, t2r = t[:k1], t[k1:]
    m1 = _col(spec, "m1", t1)
    m2r = _col(spec, "m2r", t2r)
    sigma = t1 * _col(spec, "neg_p_inv_1", t1) % m1 * _col(spec, "w1", t1) % m1
    mhat = _ext(spec, "A1", sigma) % m2r  # B2 ∪ {m_r}, no α correction
    u = (t2r + mhat * _col(spec, "p_2r", t2r) % m2r) % m2r
    out2r = u * _col(spec, "M1_inv_2r", t2r) % m2r
    out2, out_r = out2r[:k2], out2r[k2]
    sigma2 = out2 * _col(spec, "w2", out2) % _col(spec, "m2r", out2r)[:k2]
    m_r = spec.m_r
    s2r = _ext(spec, "A2r", sigma2)[0] % m_r
    alpha = (s2r - out_r) % m_r * int(spec.consts["M2_inv_r"]) % m_r
    corr = alpha[None] * _col(spec, "M2_mod_1", t1) % m1
    out1 = (_ext(spec, "A2", sigma2) % m1 - corr) % m1
    return torch.cat([out1, out2r], 0)


def packed_renorm(spec: RnsSpec, a) -> torch.Tensor:
    """Montgomery-multiply by enc(1): the same element, bound reset below
    (k1+2)·p."""
    return packed_mul(spec, a, _col(spec, "one", a).expand(a.shape))


@functools.lru_cache(maxsize=None)
def _one_rep_cached(spec: RnsSpec):
    b1, b2, r = encode_ints(spec, [1])
    return b1[:, 0], b2[:, 0], r[0]


@functools.lru_cache(maxsize=None)
def _zero_class_table(spec: RnsSpec) -> np.ndarray:
    """Residue vectors of k·p for k in [0, k1+2): the zero classes of a
    renormalized value, packed (k1+2, Kt)."""
    p = spec.field.modulus
    return np.asarray([[k * p % m for m in spec.moduli] for k in range(spec.k1 + 2)],
                      dtype=np.int32)


# ---------------------------------------------------------------------------
# CoordOps-compatible backends
# ---------------------------------------------------------------------------


class RnsCoordOps:
    """CoordOps-compatible field ops over packed RNS arrays (Kt, ...).

    Policy, as in the JAX package: every add / sub / neg renormalizes (one
    extra Montgomery product), so values stay below (k1+2)·p whatever the
    formula; the `*_raw` and `sub_k` variants leave the bound to the caller
    (the bound-annotated `RnsCurveOps` formulas)."""

    def __init__(self, field: fields.FieldSpec):
        self.field = field
        self.spec = default_spec(field)

    def add(self, a, b):
        return packed_renorm(self.spec, packed_add(self.spec, a, b))

    def sub(self, a, b):
        return packed_renorm(self.spec, packed_sub_k(self.spec, a, b, 6))

    def neg(self, a):
        return packed_renorm(self.spec, packed_sub_k(self.spec, torch.zeros_like(a), a, 6))

    def mul(self, a, b):
        return packed_mul(self.spec, a, b)

    def sqr(self, a):
        return self.mul(a, a)

    def double(self, a):
        return self.add(a, a)

    def triple(self, a):
        return self.add(self.add(a, a), a)

    def add_raw(self, a, b):
        """Residue add without renormalization (bound = sum of the bounds)."""
        return packed_add(self.spec, a, b)

    def sub_k(self, a, b, k: int):
        """Raw subtraction with a 2^k·p offset (needs bound(b) <= 2^k·p)."""
        return packed_sub_k(self.spec, a, b, k)

    def double_raw(self, a):
        return self.add_raw(a, a)

    def is_zero(self, a):
        """value ≡ 0 mod p: after a renormalization the value is below
        (k1+2)·p, so it is one of the zero classes k·p, k < k1+2."""
        a = packed_renorm(self.spec, a)
        table = torch.from_numpy(_zero_class_table(self.spec)).to(a.device)
        rows = table.reshape(*table.shape, *(1,) * (a.ndim - 1))
        return (a[None] == rows).all(1).any(0)

    def eq(self, a, b):
        return self.is_zero(self.sub(a, b))

    def select(self, mask, a, b):
        return torch.where(mask[None], a, b)

    def zeros_like(self, a):
        return torch.zeros_like(a)

    def one_like(self, a):
        return _col(self.spec, "one", a).expand(a.shape).contiguous()

    def inv(self, a):
        """Fermat inverse a^(p−2), square-and-multiply from the top bit."""
        e = self.field.modulus - 2
        acc = a
        for i in range(e.bit_length() - 2, -1, -1):
            acc = self.mul(acc, acc)
            if (e >> i) & 1:
                acc = self.mul(acc, a)
        return acc

    def batch_inv(self, a):
        """Elementwise inverse; zeros map to zero."""
        nz = ~self.is_zero(a)
        safe = torch.where(nz[None], a, self.one_like(a))
        return torch.where(nz[None], self.inv(safe), torch.zeros_like(a))

    # -- host conversions --
    def encode(self, values, montgomery=True):
        b1, b2, r = encode_ints(self.spec, values)
        return np.concatenate([b1, b2, r[None]], 0).astype(np.int32)

    def decode(self, arr, montgomery=True):
        a = _host(arr)
        flat = a.reshape(a.shape[0], -1)
        return decode_ints(self.spec, unpack(self.spec, flat))


class RnsFq2CoordOps:
    """Fq[u]/(u^2 + 1) over stacked (2, Kt, ...) packed RNS arrays (G2),
    per-component ops of `RnsCoordOps`; schoolbook multiplication."""

    def __init__(self, field: fields.FieldSpec):
        self.field = field
        self.base = RnsCoordOps(field)
        self.spec = self.base.spec

    def _map2(self, fn, *arrs):
        return torch.stack([fn(*(a[0] for a in arrs)), fn(*(a[1] for a in arrs))])

    def mul(self, a, b):
        base = self.base
        t0 = base.mul(a[0], b[0])
        t1 = base.mul(a[1], b[1])
        c0 = packed_renorm(self.spec, packed_sub_k(self.spec, t0, t1, 6))
        c1 = base.add(base.mul(a[0], b[1]), base.mul(a[1], b[0]))
        return torch.stack([c0, c1])

    def sqr(self, a):
        return self.mul(a, a)

    def add(self, a, b):
        return self._map2(self.base.add, a, b)

    def sub(self, a, b):
        # components reach 2^7·p: a 2^7 offset where the base field uses 2^6
        return self._map2(
            lambda x, y: packed_renorm(self.spec, packed_sub_k(self.spec, x, y, 7)), a, b)

    def neg(self, a):
        return self.sub(torch.zeros_like(a), a)

    def double(self, a):
        return self.add(a, a)

    def triple(self, a):
        return self.add(self.add(a, a), a)

    # raw variants: components run one bit wider than the base field, so
    # every requested sub_k offset shifts by one
    def add_raw(self, a, b):
        return self._map2(self.base.add_raw, a, b)

    def double_raw(self, a):
        return self.add_raw(a, a)

    def sub_k(self, a, b, k: int):
        return self._map2(lambda x, y: self.base.sub_k(x, y, k + 1), a, b)

    def is_zero(self, a):
        return self.base.is_zero(a[0]) & self.base.is_zero(a[1])

    def eq(self, a, b):
        return self.base.eq(a[0], b[0]) & self.base.eq(a[1], b[1])

    def select(self, mask, a, b):
        return torch.where(mask[None, None], a, b)

    def zeros_like(self, a):
        return torch.zeros_like(a)

    def one_like(self, a):
        return torch.stack([self.base.one_like(a[0]), torch.zeros_like(a[1])])

    def batch_inv(self, a):
        # (a0 + a1 u)^-1 = (a0 - a1 u) / (a0^2 + a1^2)
        base = self.base
        n_inv = base.batch_inv(base.add(base.sqr(a[0]), base.sqr(a[1])))
        return torch.stack([base.mul(a[0], n_inv), base.neg(base.mul(a[1], n_inv))])

    def encode(self, values, montgomery=True):
        c0 = self.base.encode([v[0] for v in values], montgomery)
        c1 = self.base.encode([v[1] for v in values], montgomery)
        return np.stack([c0, c1])

    def decode(self, arr, montgomery=True):
        a = _host(arr)
        return list(zip(self.base.decode(a[0]), self.base.decode(a[1])))
