"""PyTorch port: field ops (plain PyTorch path on the CPU) vs the JAX package.

The same numpy inputs go through `manta_tpu.ops.field_ops` (eager, on the
CPU) and `manta_tpu_torch.ops.field_ops` (CPU tensors -> the plain versions
of the CUDA kernel). Tolerance: none — both are exact integer arithmetic on
the same limb layout, so every output must agree bit for bit.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from manta_tpu import fields as JF
from manta_tpu.ops import field_ops as JFO
from manta_tpu.utils import hostmath as JH
from manta_tpu_torch import fields as TF
from manta_tpu_torch.ops import field_ops as TFO
from manta_tpu_torch.ops.kernels import field_kernels as K

# small tensors: one intra-op thread per test worker is all they use well
torch.set_num_threads(1)

SPECS = {
    "toy_fr": (JH.TOY_FR, TF.TOY_FR),
    "bn254_fr": (JF.BN254_FR, TF.BN254_FR),
    "bn254_fq": (JF.BN254_FQ, TF.BN254_FQ),
    "bls12_381_fr": (JF.BLS12_381_FR, TF.BLS12_381_FR),
    "bls12_381_fq": (JF.BLS12_381_FQ, TF.BLS12_381_FQ),
}
N = 32  # one lane count per field keeps the JAX eager compiles to one shape


def _limbs(values, L):
    return np.array([[(v >> (16 * i)) & 0xFFFF for v in values] for i in range(L)], np.uint32)


def lazy_pair(spec, seed):
    """Two (L, N) uint32 arrays of lazy values in [0, 2p): all 25 pairs of the
    edge values 0, 1, p-1, p, 2p-1, then random values."""
    rng = np.random.default_rng(seed)
    p = spec.modulus
    edges = [0, 1, p - 1, p, 2 * p - 1]
    pairs = [(x, y) for x in edges for y in edges]
    hb = (2 * p).bit_length() - 1
    rand = [
        [int.from_bytes(rng.bytes(64), "little") % (1 << hb) for _ in range(N - len(pairs))]
        for _ in range(2)
    ]
    xs = [x for x, _ in pairs] + rand[0]
    ys = [y for _, y in pairs] + rand[1]
    L = spec.num_limbs
    return _limbs(xs, L), _limbs(ys, L)


def jax_out(arr):
    return np.asarray(arr, dtype=np.uint32)


def torch_out(t):
    return TFO.to_numpy(t)


def both(name, seed=0):
    jspec, tspec = SPECS[name]
    a, b = lazy_pair(jspec, seed)
    return jspec, tspec, a, b, TFO.as_tensor(a, "cpu"), TFO.as_tensor(b, "cpu")


@pytest.mark.parametrize("name", list(SPECS))
@pytest.mark.parametrize("op", ["add", "sub", "mont_mul"])
def test_binary_ops_bit_equal(name, op):
    jspec, tspec, a, b, ta, tb = both(name)
    want = jax_out(getattr(JFO, op)(jspec, jnp.asarray(a), jnp.asarray(b)))
    got = torch_out(getattr(TFO, op)(tspec, ta, tb))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", list(SPECS))
@pytest.mark.parametrize("op", ["neg", "mont_sqr", "to_mont", "from_mont", "normalize", "double"])
def test_unary_ops_bit_equal(name, op):
    jspec, tspec, a, _, ta, _ = both(name, seed=1)
    want = jax_out(getattr(JFO, op)(jspec, jnp.asarray(a)))
    got = torch_out(getattr(TFO, op)(tspec, ta))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", list(SPECS))
def test_inv_bit_equal(name):
    jspec, tspec, a, _, ta, _ = both(name, seed=2)
    lanes = [0, 5, 10, 15, 20, 25, 26, 27]  # 0, 1, p-1, p, 2p-1, random
    a, ta = a[:, lanes], ta[:, lanes]
    want = jax_out(JFO.inv(jspec, jnp.asarray(a)))
    got = torch_out(TFO.inv(tspec, ta))
    np.testing.assert_array_equal(got, want)
    vals = TFO.decode_ints(tspec, ta)
    inv = TFO.decode_ints(tspec, TFO.inv(tspec, ta))
    p = tspec.modulus
    assert inv == [pow(v, -1, p) if v else 0 for v in vals]


@pytest.mark.parametrize("name", list(SPECS))
def test_mul_const_broadcast_bit_equal(name):
    jspec, tspec, a, _, ta, _ = both(name, seed=3)
    c = JFO.const(jspec, 0xC0FFEE)
    assert np.array_equal(c, TFO.const(tspec, 0xC0FFEE))
    want = jax_out(JFO.mul_const(jspec, jnp.asarray(a), c))
    got = torch_out(TFO.mul_const(tspec, ta, c))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", list(SPECS))
def test_segment_sum_mod_bit_equal(name):
    jspec, tspec, a, _, ta, _ = both(name, seed=4)
    rng = np.random.default_rng(5)
    seg = np.sort(rng.integers(0, 8, size=N)).astype(np.int32)
    max_terms = int(np.bincount(seg).max())
    want = jax_out(JFO.segment_sum_mod(jspec, jnp.asarray(a), seg, 8, max_terms))
    got = torch_out(TFO.segment_sum_mod(tspec, ta, torch.from_numpy(seg), 8, max_terms))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", list(SPECS))
def test_encode_decode_match(name):
    jspec, tspec = SPECS[name]
    rng = np.random.default_rng(6)
    vals = [0, 1, tspec.modulus - 1] + [
        int.from_bytes(rng.bytes(64), "little") % tspec.modulus for _ in range(13)
    ]
    for mont in (True, False):
        enc = TFO.encode_ints(tspec, vals, montgomery=mont)
        np.testing.assert_array_equal(enc, JFO.encode_ints(jspec, vals, montgomery=mont))
        assert TFO.decode_ints(tspec, TFO.as_tensor(enc, "cpu"), montgomery=mont) == vals


def test_predicates_and_batch_inv():
    _, tspec, a, _, ta, _ = both("bn254_fq", seed=7)
    p = tspec.modulus
    vals = [v % p for v in TFO.decode_ints(tspec, ta, montgomery=False)]
    assert TFO.is_zero(tspec, ta).tolist() == [v == 0 for v in vals]
    inv = TFO.decode_ints(tspec, TFO.batch_inv(tspec, ta), montgomery=False)
    R = tspec.R
    # batch_inv of x·R (Montgomery) is x^-1·R: canonical limbs hold R^2 / v
    assert inv == [pow(v, -1, p) * R * R % p if v else 0 for v in vals]


def test_kernel_constants_match_fields():
    """The constant tables of the kernels' shared header (p, 2p and R mod p
    as 32-bit words, n0' = −p^-1 mod 2^32) are the fields' own; and the
    kernel's field ids are mapped."""
    src = Path(K.HEADER).read_text()
    assert '#include "field_ops.cuh"' in Path(K.SOURCE).read_text()
    structs = dict(re.findall(r"struct (\w+) \{(.*?)\n\};", src, re.S))
    names = {"Bn254Fr": TF.BN254_FR, "Bn254Fq": TF.BN254_FQ,
             "Bls12381Fr": TF.BLS12_381_FR, "Bls12381Fq": TF.BLS12_381_FQ}
    for struct, spec in names.items():
        body = structs[struct]
        L = int(re.search(r"kLimbs = (\d+)", body).group(1))
        assert L == spec.num_limbs
        n0 = int(re.search(r"kN0 = (0x[0-9a-f]+)u", body).group(1), 16)
        assert n0 == (-pow(spec.modulus, -1, 1 << 32)) % (1 << 32)
        tables = re.findall(r"v\[\d+\] = \{(.*?)\};", body, re.S)
        words = [[int(w.strip().rstrip("u"), 16) for w in t.split(",")] for t in tables]
        assert len(words) == 3
        for value, ws in zip((spec.modulus, 2 * spec.modulus, spec.R), words):
            assert len(ws) == (L + 1) // 2
            assert sum(w << (32 * i) for i, w in enumerate(ws)) == value
        assert spec.name in K.KERNEL_FIELDS


def test_wrapper_rejects_other_devices():
    """No fallback: only CPU tensors take the plain version."""
    _, tspec, _, _, ta, tb = both("bn254_fr")
    with pytest.raises(ValueError):
        K.mont_mul(tspec, ta.to("meta"), tb.to("meta"))
    with pytest.raises(ValueError):
        K.add(tspec, ta, tb.to("meta"))
