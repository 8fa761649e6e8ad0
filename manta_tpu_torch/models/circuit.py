"""ECLAIR-equivalent circuit DSL: write gadgets once, run them natively or
compile them to R1CS.

Mirrors the reference's compiler-generic programming model
(`manta-crypto/src/eclair/`): every gadget takes a *compiler* argument —
`Native()` executes over canonical field ints; `R1CS(...)` records rank-1
constraints (and, in proving mode, synthesizes the witness as it goes,
like arkworks' `SynthesisMode::Prove` vs `Setup`,
reference `manta-crypto/src/arkworks/constraint/mod.rs:111-121`).

Variables are lazy linear combinations over allocated wires (constant wire 0
fixed to 1), so add/sub/scalar-mul cost no constraints — matching
ark-r1cs-std's `FpVar` arithmetic and therefore the reference circuits'
constraint counts.

Allocation modes follow `eclair/alloc.rs:438-470`: Constant / Public /
Secret.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from manta_tpu_torch import fields
from manta_tpu_torch.utils import grain


class Native:
    """The native compiler: gadget values are canonical Python ints
    (ECLAIR `COM = ()`, reference `eclair/mod.rs:31-42`)."""

    def __init__(self, field: fields.FieldSpec):
        self.field = field
        self.p = field.modulus

    # allocation is the identity
    def constant(self, value: int) -> int:
        return value % self.p

    def public_input(self, value: int) -> int:
        return value % self.p

    def secret_witness(self, value: int) -> int:
        return value % self.p

    def add(self, a, b):
        return (a + b) % self.p

    def sub(self, a, b):
        return (a - b) % self.p

    def mul(self, a, b):
        return a * b % self.p

    def scale(self, a, k: int):
        return a * k % self.p

    def assert_eq(self, a, b):
        assert a % self.p == b % self.p, "native assertion failed"

    def assert_zero(self, a):
        assert a % self.p == 0, "native assertion failed"

    def inv(self, a):
        return pow(a, -1, self.p)

    def value(self, a) -> int:
        return a % self.p


@dataclasses.dataclass
class LC:
    """Sparse linear combination over wire indices (wire 0 == constant 1)."""

    terms: Dict[int, int]

    def __hash__(self):
        return id(self)


class R1CS:
    """Constraint-recording compiler.

    mode: "setup" (no values — mirrors `R1CS::for_contexts`) or "prove"
    (values carried with every wire — mirrors `R1CS::for_proofs`).

    Wire layout (Groth16 instance convention): wire 0 = constant ONE, then
    public inputs in allocation order, then secret witnesses. Matrices are
    finalized against that ordering by `finalize()`.
    """

    def __init__(self, field: fields.FieldSpec, mode: str = "prove"):
        assert mode in ("setup", "prove")
        self.field = field
        self.p = field.modulus
        self.mode = mode
        self.num_public = 0
        self.public_values: List[int] = []
        self.witness_values: List[Optional[int]] = []
        # constraints as (a_lc, b_lc, c_lc) with GLOBAL wire keys:
        #   0 -> one, (1, i) -> public i, (2, j) -> witness j
        self.constraints: List[Tuple[dict, dict, dict]] = []
        #: labeled measurement regions: name -> (constraints, witnesses)
        #: (the reference's Instrument, `manta-crypto/src/constraint.rs:320`)
        self.measurements: List[Tuple[str, int, int]] = []

    def instrument(self, label: str):
        """Context manager attributing constraint/witness deltas to `label`
        (reference `print_measurement`/`Instrument`)."""
        import contextlib

        @contextlib.contextmanager
        def _region():
            c0, w0 = len(self.constraints), len(self.witness_values)
            yield
            self.measurements.append(
                (label, len(self.constraints) - c0, len(self.witness_values) - w0)
            )

        return _region()

    # -- allocation --

    def constant(self, value: int) -> LC:
        return LC({0: value % self.p})

    def public_input(self, value: Optional[int]) -> LC:
        idx = self.num_public
        self.num_public += 1
        if self.mode == "prove":
            assert value is not None
            self.public_values.append(value % self.p)
        return LC({(1, idx): 1})

    def secret_witness(self, value: Optional[int]) -> LC:
        idx = len(self.witness_values)
        if self.mode == "prove":
            assert value is not None
            self.witness_values.append(value % self.p)
        else:
            self.witness_values.append(None)
        return LC({(2, idx): 1})

    # -- linear ops (free) --

    def add(self, a: LC, b: LC) -> LC:
        terms = dict(a.terms)
        for k, v in b.terms.items():
            terms[k] = (terms.get(k, 0) + v) % self.p
        return LC(terms)

    def sub(self, a: LC, b: LC) -> LC:
        terms = dict(a.terms)
        for k, v in b.terms.items():
            terms[k] = (terms.get(k, 0) - v) % self.p
        return LC(terms)

    def scale(self, a: LC, k: int) -> LC:
        k %= self.p
        return LC({key: v * k % self.p for key, v in a.terms.items()})

    # -- evaluation --

    def _wire_value(self, key) -> int:
        if key == 0:
            return 1
        kind, idx = key
        return self.public_values[idx] if kind == 1 else self.witness_values[idx]

    def eval_lc(self, a: LC) -> int:
        assert self.mode == "prove"
        return sum(v * self._wire_value(k) for k, v in a.terms.items()) % self.p

    def value(self, a: LC) -> int:
        return self.eval_lc(a)

    # -- constraints --

    def _enforce(self, a: LC, b: LC, c: LC):
        self.constraints.append((dict(a.terms), dict(b.terms), dict(c.terms)))

    def mul(self, a: LC, b: LC) -> LC:
        value = None
        if self.mode == "prove":
            value = self.eval_lc(a) * self.eval_lc(b) % self.p
        out = self.secret_witness(value)
        self._enforce(a, b, out)
        return out

    def inv(self, a: LC) -> LC:
        value = None
        if self.mode == "prove":
            value = pow(self.eval_lc(a), -1, self.p)
        out = self.secret_witness(value)
        self._enforce(a, out, self.constant(1))
        return out

    def assert_eq(self, a: LC, b: LC):
        self._enforce(a, self.constant(1), b)

    def assert_zero(self, a: LC):
        self._enforce(a, self.constant(1), self.constant(0))

    # -- finalize to Groth16 wire ordering --

    def finalize(self):
        """Returns (ConstraintMatrices, full assignment or None)."""
        num_instance = 1 + self.num_public

        def col(key) -> int:
            if key == 0:
                return 0
            kind, idx = key
            return 1 + idx if kind == 1 else num_instance + idx

        rows = []
        for a, b, c in self.constraints:
            rows.append(
                (
                    {col(k): v for k, v in a.items() if v % self.p},
                    {col(k): v for k, v in b.items() if v % self.p},
                    {col(k): v for k, v in c.items() if v % self.p},
                )
            )
        matrices = ConstraintMatrices(
            field=self.field,
            num_instance=num_instance,
            num_witness=len(self.witness_values),
            rows=rows,
        )
        if self.mode == "prove":
            assignment = [1] + self.public_values + list(self.witness_values)
            return matrices, assignment
        return matrices, None


@dataclasses.dataclass
class ConstraintMatrices:
    """Finalized sparse R1CS: rows of ({col: coeff}, ..., ...)."""

    field: fields.FieldSpec
    num_instance: int  # includes the leading ONE
    num_witness: int
    rows: List[Tuple[dict, dict, dict]]

    @property
    def num_constraints(self) -> int:
        return len(self.rows)

    @property
    def num_variables(self) -> int:
        return self.num_instance + self.num_witness

    def is_satisfied(self, assignment: List[int]) -> bool:
        p = self.field.modulus

        def ev(lc):
            return sum(v * assignment[c] for c, v in lc.items()) % p

        return all(
            ev(a) * ev(b) % p == ev(c) for a, b, c in self.rows
        )


# ---------------------------------------------------------------------------
# Gadgets (compiler-generic — the ECLAIR idea). `com` is Native or R1CS.
# ---------------------------------------------------------------------------


def square(com, x):
    return com.mul(x, x)


def power5(com, x):
    """x^5 — the Poseidon S-box (3 constraints)."""
    x2 = com.mul(x, x)
    x4 = com.mul(x2, x2)
    return com.mul(x4, x)


def poseidon_permutation(com, spec: grain.PoseidonSpec, state):
    """COM-generic Poseidon permutation over `state` (list of vars).

    Same round structure as the device kernel / host reference
    (reference `manta-pay/src/crypto/poseidon/mod.rs:385-470`)."""
    w = spec.width
    assert len(state) == w
    half = spec.full_rounds // 2
    for rnd in range(spec.rounds):
        keys = spec.round_keys[rnd * w : (rnd + 1) * w]
        state = [com.add(x, com.constant(k)) for x, k in zip(state, keys)]
        if half <= rnd < half + spec.partial_rounds:
            state[0] = power5(com, state[0])
        else:
            state = [power5(com, x) for x in state]
        state = [
            _lc_sum(
                com,
                [com.scale(state[j], spec.mds[w * i + j]) for j in range(w)],
            )
            for i in range(w)
        ]
    return state


def _lc_sum(com, xs):
    acc = xs[0]
    for x in xs[1:]:
        acc = com.add(acc, x)
    return acc


def poseidon_hash(com, spec: grain.PoseidonSpec, inputs):
    """Hash = first element of permuted [domain_tag, inputs...]."""
    assert len(inputs) == spec.arity
    state = [com.constant(spec.domain_tag)] + list(inputs)
    return poseidon_permutation(com, spec, state)[0]


def boolean(com, value):
    """Allocate a secret boolean (b * (1-b) = 0)."""
    b = com.secret_witness(value)
    com.assert_zero(com.mul(b, com.sub(com.constant(1), b)))
    return b


def to_bits_le(com, x, num_bits: int, value: Optional[int] = None):
    """Decompose x into `num_bits` little-endian boolean wires and constrain
    the recomposition — the range-check pattern of the reference
    (`AssertWithinBitRange`, `arkworks/constraint/mod.rs:308-326`)."""
    if isinstance(com, Native):
        v = com.value(x)
        assert v < (1 << num_bits), "value exceeds bit range"
        return [(v >> i) & 1 for i in range(num_bits)]
    v = com.eval_lc(x) if com.mode == "prove" else None
    if v is not None:
        assert v < (1 << num_bits), "value exceeds bit range"
    bits = []
    for i in range(num_bits):
        bits.append(boolean(com, None if v is None else (v >> i) & 1))
    acc = com.constant(0)
    for i, b in enumerate(bits):
        acc = com.add(acc, com.scale(b, 1 << i))
    com.assert_eq(acc, x)
    if num_bits >= com.field.bits:
        # full-width decompositions admit a second (x + p) representation;
        # enforce the canonical one (bits <= p - 1), matching ark-r1cs-std
        # FpVar::to_bits_le's enforce_in_field_le
        enforce_bits_le_constant(com, bits, com.field.modulus - 1)
    return bits


def enforce_bits_le_constant(com, bits, c: int):
    """Enforce the little-endian boolean wires `bits` represent a value
    <= the constant c (lexicographic compare, MSB down: one multiply per
    bit — the ark `enforce_smaller_or_equal_than_le` pattern)."""
    if isinstance(com, Native):
        v = sum(int(com.value(b)) << i for i, b in enumerate(bits))
        assert v <= c, "value exceeds field-canonical range"
        return
    # eq = "all higher bits equal c's bits so far"
    eq = com.constant(1)
    for i in reversed(range(len(bits))):
        if (c >> i) & 1:
            eq = com.mul(eq, bits[i])
        else:
            # if still equal on the high bits, this bit must be 0
            com._enforce(eq, bits[i], com.constant(0))
    return


def conditional_select(com, cond, if_true, if_false):
    """cond ? if_true : if_false (cond boolean). 1 constraint."""
    if isinstance(com, Native):
        return if_true if cond == 1 else if_false
    # out = f + cond * (t - f)
    diff = com.sub(if_true, if_false)
    prod = com.mul(cond, diff)
    return com.add(if_false, prod)


def conditional_swap(com, cond, a, b):
    """Returns (a, b) if cond == 0 else (b, a) — the Merkle-path sibling
    ordering gadget (`eclair/bool.rs` ConditionalSwap)."""
    if isinstance(com, Native):
        return (b, a) if cond == 1 else (a, b)
    diff = com.sub(b, a)
    delta = com.mul(cond, diff)
    return com.add(a, delta), com.sub(b, delta)


def assert_all_eq(com, xs):
    first = xs[0]
    for x in xs[1:]:
        com.assert_eq(first, x)


def merkle_path_root(com, spec: grain.PoseidonSpec, leaf_digest, path_bits, siblings):
    """Recompute a Merkle root from a leaf digest and an authentication path.

    path_bits[i] = 1 if the current node is the RIGHT child at level i;
    siblings[i] is the other child. Inner hash = Poseidon-2 (reference
    `config/utxo.rs:1224-1274`, height 20 tree)."""
    node = leaf_digest
    for bit, sib in zip(path_bits, siblings):
        left, right = conditional_swap(com, bit, node, sib)
        node = poseidon_hash(com, spec, [left, right])
    return node
