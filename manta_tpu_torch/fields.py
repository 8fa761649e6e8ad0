"""Field specifications for the PyTorch/CUDA proving stack.

Defines the prime fields used by the framework as static configuration
objects consumed by both the host math layer (`manta_tpu_torch.utils.hostmath`)
and the device kernels (`manta_tpu_torch.ops.field_ops`).

Curves supported (mirrors the reference's curve matrix,
see reference `manta-pay/src/config/mod.rs:40-67` and
`manta-benchmark/benches/ecc.rs:23`):

- BLS12-381 (benchmark + Poseidon-vector curve): base field Fq (381 bits),
  scalar field Fr (255 bits).
- BN254 (production MantaPay pairing curve): Fq (254 bits), Fr (254 bits).
- ed-on-bn254 (Baby Jubjub-style embedded twisted Edwards curve): its scalar
  field ("embedded scalar field") used for Schnorr / key agreement.

Device representation: little-endian base-2^16 limbs (numpy uint32 on the
host, int32 tensors on the device), values kept in Montgomery form with
R = 2^(16*L).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

LIMB_BITS = 16
LIMB_MASK = (1 << LIMB_BITS) - 1


@dataclasses.dataclass(frozen=True)
class FieldSpec:
    """Static description of a prime field in limb form.

    All integer members are Python ints (arbitrary precision); numpy arrays
    derived from them are cached on first use.
    """

    name: str
    modulus: int
    #: multiplicative generator of the field (smallest, matching arkworks
    #: `GENERATOR`), used as the coset shift for coset NTT domains.
    generator: int = 0

    @functools.cached_property
    def two_adicity(self) -> int:
        """Largest s with 2^s | (modulus - 1)."""
        s, m = 0, self.modulus - 1
        while m % 2 == 0:
            s, m = s + 1, m // 2
        return s

    @functools.cached_property
    def two_adic_root(self) -> int:
        """Element of order 2^two_adicity: generator^((p-1)/2^s).

        This is exactly how arkworks derives `TWO_ADIC_ROOT_OF_UNITY` from
        `GENERATOR`, so NTT domains match ark-poly's Radix2EvaluationDomain.
        """
        return pow(
            self.generator, (self.modulus - 1) >> self.two_adicity, self.modulus
        )

    @property
    def bits(self) -> int:
        return self.modulus.bit_length()

    @property
    def num_limbs(self) -> int:
        """Limb count sized so that 4p < R = 2^(16·L): the device kernels use
        lazy reduction with values in [0, 2p), which requires two headroom
        bits above the modulus (e.g. BLS12-381 Fr gets 17 limbs)."""
        return (self.bits + 2 + LIMB_BITS - 1) // LIMB_BITS

    @property
    def R(self) -> int:
        """Montgomery radix 2^(16*L) mod p."""
        return (1 << (LIMB_BITS * self.num_limbs)) % self.modulus

    @property
    def R2(self) -> int:
        return (self.R * self.R) % self.modulus

    @property
    def R_inv(self) -> int:
        return pow(1 << (LIMB_BITS * self.num_limbs), -1, self.modulus)

    @property
    def n0_inv(self) -> int:
        """-p^{-1} mod 2^16 (the Montgomery multiplication constant m')."""
        return (-pow(self.modulus, -1, 1 << LIMB_BITS)) % (1 << LIMB_BITS)

    @functools.cached_property
    def modulus_limbs(self) -> np.ndarray:
        return int_to_limbs(self.modulus, self.num_limbs)

    @functools.cached_property
    def r2_limbs(self) -> np.ndarray:
        return int_to_limbs(self.R2, self.num_limbs)

    @functools.cached_property
    def one_mont_limbs(self) -> np.ndarray:
        return int_to_limbs(self.R, self.num_limbs)

    def root_of_unity(self, n: int) -> int:
        """Primitive n-th root of unity (n = power of two)."""
        assert n & (n - 1) == 0, "n must be a power of two"
        log_n = n.bit_length() - 1
        assert log_n <= self.two_adicity, f"no 2^{log_n} root of unity in {self.name}"
        root = self.two_adic_root
        for _ in range(self.two_adicity - log_n):
            root = (root * root) % self.modulus
        return root


def int_to_limbs(x: int, num_limbs: int) -> np.ndarray:
    """Python int -> little-endian uint32 array of 16-bit limbs."""
    assert 0 <= x < (1 << (LIMB_BITS * num_limbs))
    out = np.zeros(num_limbs, dtype=np.uint32)
    for i in range(num_limbs):
        out[i] = (x >> (LIMB_BITS * i)) & LIMB_MASK
    return out


def limbs_to_int(limbs) -> int:
    """Little-endian 16-bit limb array -> Python int."""
    x = 0
    for i, limb in enumerate(np.asarray(limbs, dtype=np.uint64).tolist()):
        x |= int(limb) << (LIMB_BITS * i)
    return x


# ---------------------------------------------------------------------------
# BLS12-381 (matches arkworks ark-bls12-381 v0.3 constants; reference uses it
# in `manta-benchmark/benches/ecc.rs:23` and the Poseidon test vectors at
# `manta-pay/src/crypto/poseidon/hash.rs:214`)
# ---------------------------------------------------------------------------

BLS12_381_FQ = FieldSpec(
    name="bls12_381_fq",
    modulus=0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB,
    generator=2,
)

BLS12_381_FR = FieldSpec(
    name="bls12_381_fr",
    modulus=0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001,
    generator=7,
)

# ---------------------------------------------------------------------------
# BN254 (arkworks ark-bn254 v0.3; production MantaPay curve,
# reference `manta-pay/src/config/mod.rs:40`)
# ---------------------------------------------------------------------------

BN254_FQ = FieldSpec(
    name="bn254_fq",
    modulus=0x30644E72E131A029B85045B68181585D97816A916871CA8D3C208C16D87CFD47,
    generator=3,
)

BN254_FR = FieldSpec(
    name="bn254_fr",
    modulus=0x30644E72E131A029B85045B68181585D2833E84879B9709143E1F593F0000001,
    generator=5,
)

# ---------------------------------------------------------------------------
# ed-on-bn254 ("Baby Jubjub" in arkworks ark-ed-on-bn254 v0.3): twisted
# Edwards curve whose base field is BN254 Fr; this is its scalar field,
# the "embedded scalar field" of the reference
# (`manta-pay/src/config/mod.rs:52` GroupCurve = Bn254_Edwards).
# ---------------------------------------------------------------------------

ED_ON_BN254_FR = FieldSpec(
    name="ed_on_bn254_fr",
    modulus=0x060C89CE5C263405370A08B6D0302B0BAB3EEDB83920EE0A677297DC392126F1,
    generator=31,
)

# ---------------------------------------------------------------------------
# Toy fields over 16-bit primes (2 limbs with lazy headroom): small enough to
# exercise the whole device machinery in tests; NOT cryptographically
# meaningful. The toy curve over TOY_FQ lives in `utils.hostmath`.
# ---------------------------------------------------------------------------

TOY_FQ = FieldSpec(name="toy_fq", modulus=65521, generator=17)
# generator must be a PRIMITIVE root: 3 has order 2723 (odd), which makes
# two_adic_root == 1 and every toy NTT domain degenerate; 5 generates
TOY_FR = FieldSpec(name="toy_fr", modulus=65353, generator=5)

ALL_FIELDS = {
    spec.name: spec
    for spec in (BLS12_381_FQ, BLS12_381_FR, BN254_FQ, BN254_FR, ED_ON_BN254_FR)
}
