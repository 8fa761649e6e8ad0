"""Poseidon parameter generation: Grain LFSR round constants + Cauchy MDS.

Bit-exact reimplementation of the reference's deterministic Poseidon
parameter generation:

- 80-bit Grain LFSR seeded per [GKRRS19] Appendix A
  (reference `manta-pay/src/crypto/poseidon/lfsr.rs:30`).
- Round constants via big-endian rejection sampling of MODULUS_BITS-sized
  chunks (reference `manta-pay/src/crypto/poseidon/round_constants.rs:26-75`).
- MDS matrix as the Cauchy matrix M[x][y] = 1/(x + y), x in 0..t,
  y in t..2t, row-major (reference `manta-pay/src/crypto/poseidon/mds.rs:100`).
- Domain tag 2^(width-1) - 1
  (reference `manta-pay/src/crypto/poseidon/arkworks.rs:247-268`).

Validated against the published production parameter blobs in
`manta-parameters/data/pay/parameters/*.dat` and the sage-derived
`parameters_hardcoded_test/lfsr_values` vectors.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List

from manta_tpu_torch import fields


class GrainLFSR:
    """80-bit Grain linear feedback shift register (bit-exact)."""

    SIZE = 80

    def __init__(self, seed_fields):
        self.state = [False] * self.SIZE
        self.head = 0
        for n, bits in seed_fields:
            for i in reversed(range(n)):
                self._set_next((bits >> i) & 1 != 0)
        for _ in range(self.SIZE * 2):
            self._update()

    def _set_next(self, next_bit: bool) -> bool:
        self.state[self.head] = next_bit
        self.head = (self.head + 1) % self.SIZE
        return next_bit

    def _bit(self, index: int) -> bool:
        return self.state[(index + self.head) % self.SIZE]

    def _update(self) -> bool:
        return self._set_next(
            self._bit(62)
            ^ self._bit(51)
            ^ self._bit(38)
            ^ self._bit(23)
            ^ self._bit(13)
            ^ self._bit(0)
        )

    def __iter__(self) -> Iterator[bool]:
        return self

    def __next__(self) -> bool:
        # Self-shrinking output rule: scan update pairs; emit the bit that
        # follows the first 1 (reference lfsr.rs `Iterator::next`).
        bit = self._update()
        while not bit:
            self._update()
            bit = self._update()
        return self._update()


def generate_lfsr(
    modulus_bits: int, width: int, full_rounds: int, partial_rounds: int
) -> GrainLFSR:
    return GrainLFSR(
        [
            (2, 1),
            (4, 0),
            (12, modulus_bits),
            (12, width),
            (10, full_rounds),
            (10, partial_rounds),
            (30, 0b111111111111111111111111111111),
        ]
    )


def sample_field_element(lfsr: GrainLFSR, modulus: int, modulus_bits: int) -> int:
    """Rejection-sample one field element from MODULUS_BITS big-endian bits."""
    while True:
        value = 0
        for _ in range(modulus_bits):
            value = (value << 1) | int(next(lfsr))
        if value < modulus:
            return value


def generate_round_constants(
    field: fields.FieldSpec, width: int, full_rounds: int, partial_rounds: int
) -> List[int]:
    lfsr = generate_lfsr(field.bits, width, full_rounds, partial_rounds)
    return [
        sample_field_element(lfsr, field.modulus, field.bits)
        for _ in range(width * (full_rounds + partial_rounds))
    ]


def generate_mds(field: fields.FieldSpec, width: int) -> List[List[int]]:
    """Cauchy MDS matrix: M[x][y] = (x + y')^-1, x in 0..t, y' in t..2t."""
    p = field.modulus
    return [
        [pow((x + y) % p, -1, p) for y in range(width, 2 * width)]
        for x in range(width)
    ]


# Poseidon round structure used by MantaPay
# (reference `manta-pay/src/config/poseidon.rs:26-56`):
#   arity 2..5 -> width 3..6; 8 full rounds; partial rounds 55/55/56/56.
PARTIAL_ROUNDS = {3: 55, 4: 55, 5: 56, 6: 56}
FULL_ROUNDS = 8
SBOX_EXPONENT = 5


@dataclasses.dataclass(frozen=True)
class PoseidonSpec:
    """Full parameter set for one Poseidon permutation width."""

    field: fields.FieldSpec
    width: int
    full_rounds: int
    partial_rounds: int
    round_keys: tuple  # length rounds * width, canonical ints
    mds: tuple  # length width * width, row-major canonical ints
    #: Domain tag prepended as state[0] in hashing. The production MantaPay
    #: config uses 0 for every hasher (reference `config/utxo.rs:282` et al.,
    #: "FIXME: Use a real domain tag"); the Poseidon test-vector convention is
    #: TwoPowerMinusOneDomainTag = 2^(width-1) - 1 (`arkworks.rs:247-268`).
    domain_tag: int = 0

    @property
    def rounds(self) -> int:
        return self.full_rounds + self.partial_rounds

    @property
    def arity(self) -> int:
        return self.width - 1


def poseidon_spec(
    field: fields.FieldSpec,
    width: int,
    full_rounds: int = FULL_ROUNDS,
    partial_rounds: int | None = None,
    domain_tag: int | str = 0,
) -> PoseidonSpec:
    if partial_rounds is None:
        partial_rounds = PARTIAL_ROUNDS[width]
    if domain_tag == "two_power_minus_one":
        domain_tag = (1 << (width - 1)) - 1
    return PoseidonSpec(
        field=field,
        width=width,
        full_rounds=full_rounds,
        partial_rounds=partial_rounds,
        round_keys=tuple(
            generate_round_constants(field, width, full_rounds, partial_rounds)
        ),
        mds=tuple(x for row in generate_mds(field, width) for x in row),
        domain_tag=domain_tag,
    )


def poseidon_permute(spec: PoseidonSpec, state: List[int]) -> List[int]:
    """Host reference permutation (naive Poseidon, canonical ints).

    Round order (reference `manta-pay/src/crypto/poseidon/mod.rs:385-470`):
    each round adds round keys to every element, applies the x^5 S-box (to
    all elements in full rounds, element 0 only in partial rounds), then
    multiplies by the MDS matrix. HALF full, PARTIAL partial, HALF full.
    """
    p = spec.field.modulus
    w = spec.width
    assert len(state) == w
    state = [x % p for x in state]
    half = spec.full_rounds // 2

    def mds_mul(st):
        return [
            sum(spec.mds[w * i + j] * st[j] for j in range(w)) % p for i in range(w)
        ]

    for rnd in range(spec.rounds):
        keys = spec.round_keys[rnd * w : (rnd + 1) * w]
        state = [(x + k) % p for x, k in zip(state, keys)]
        if half <= rnd < half + spec.partial_rounds:
            state[0] = pow(state[0], SBOX_EXPONENT, p)
        else:
            state = [pow(x, SBOX_EXPONENT, p) for x in state]
        state = mds_mul(state)
    return state


def poseidon_hash_untruncated(spec: PoseidonSpec, inputs: List[int]) -> List[int]:
    """State after permuting [domain_tag, inputs...]."""
    assert len(inputs) == spec.arity
    return poseidon_permute(spec, [spec.domain_tag] + list(inputs))


def poseidon_hash(spec: PoseidonSpec, inputs: List[int]) -> int:
    """Poseidon hash output = first state element
    (reference `manta-pay/src/crypto/poseidon/hash.rs:149-152`)."""
    return poseidon_hash_untruncated(spec, inputs)[0]
