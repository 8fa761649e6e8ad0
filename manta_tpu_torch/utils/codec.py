"""arkworks-compatible canonical deserialization of field elements and
uncompressed short-Weierstrass points (the part `utils.keyio` reads).

Formats (reference `manta-crypto/src/arkworks/serialize.rs`, ark-serialize
v0.3):

- `Fp256`/`Fp384` field elements: canonical (non-Montgomery) integer as
  little-endian bytes, 32/48 bytes.
- Short Weierstrass points, uncompressed: x || y with 2-bit flags in the top
  bits of the LAST byte (bit6 = infinity).
- Fq2 elements: c0 || c1.

Stricter than the JAX package's `utils/codec.py`: a decoded point must lie in
the prime-order subgroup, not only on the curve. BN254 G2 and both BLS12-381
groups have cofactors, so an on-curve point can still sit outside the group
the pairing check assumes.
"""

from __future__ import annotations

from typing import Optional, Tuple

from manta_tpu_torch import fields
from manta_tpu_torch.utils import hostmath


def field_byte_size(spec: fields.FieldSpec) -> int:
    """Serialized byte length of one field element (BigInt limb size)."""
    return ((spec.bits + 63) // 64) * 8


def deserialize_field(data: bytes, spec: fields.FieldSpec) -> int:
    x = int.from_bytes(data, "little")
    if x >= spec.modulus:
        raise ValueError(f"field element out of range for {spec.name}")
    return x


def in_prime_subgroup(curve: hostmath.WeierstrassCurve, pt) -> bool:
    """r·P == ∞ for the scalar-field order r (trivially true at cofactor 1).

    `curve.scalar_mul` reduces its scalar mod r, so r·P is computed here by
    plain double-and-add."""
    if pt is None or curve.cofactor == 1:
        return True
    k, acc, addend = curve.scalar_field.modulus, None, pt
    while k:
        if k & 1:
            acc = curve.add(acc, addend)
        addend = curve.double(addend)
        k >>= 1
    return acc is None


def _split_flags(data: bytes) -> Tuple[bytearray, bool]:
    data = bytearray(data)
    infinity = bool(data[-1] & (1 << 6))
    data[-1] &= 0x3F
    return data, infinity


def _checked(pt, curve: hostmath.WeierstrassCurve, what: str):
    if not curve.is_on_curve(pt):
        raise ValueError(f"uncompressed {what} point not on curve")
    if not in_prime_subgroup(curve, pt):
        raise ValueError(f"uncompressed {what} point not in the prime-order subgroup")
    return pt


def deserialize_g1_uncompressed(
    data: bytes, curve: hostmath.WeierstrassCurve
) -> Optional[Tuple[int, int]]:
    size = field_byte_size(curve.field)
    data, infinity = _split_flags(data)
    if infinity:
        return None
    x = int.from_bytes(bytes(data[:size]), "little")
    y = int.from_bytes(bytes(data[size:]), "little")
    return _checked((x, y), curve, "G1")


def deserialize_g2_uncompressed(data: bytes, curve: hostmath.WeierstrassCurve):
    size = field_byte_size(curve.field)
    data, infinity = _split_flags(data)
    if infinity:
        return None
    vals = [
        int.from_bytes(bytes(data[i * size : (i + 1) * size]), "little")
        for i in range(4)
    ]
    return _checked(((vals[0], vals[1]), (vals[2], vals[3])), curve, "G2")
