"""PyTorch port: NTTs vs the JAX package, bit for bit.

`ntt`, `intt`, `coset_ntt` and `coset_intt` of `manta_tpu_torch.ops.ntt`
(plain field ops on CPU tensors) against the same functions of
`manta_tpu.ops.ntt` run eagerly at m = 16, on inputs made by numpy from a
seed (m = 8 on `toy_fr`, whose two-adicity is 3). Tolerance: none (exact
integer arithmetic on the same limbs).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from manta_tpu import fields as JF
from manta_tpu.models import groth16 as JG
from manta_tpu.ops import ntt as JNTT
from manta_tpu.utils import hostmath as JH
from manta_tpu_torch import fields as TF
from manta_tpu_torch.ops import field_ops as F
from manta_tpu_torch.ops import ntt as TNTT

# small tensors: one intra-op thread per test worker is all they use well
torch.set_num_threads(1)

SPECS = {
    "toy_fr": (JH.TOY_FR, TF.TOY_FR),
    "bn254_fr": (JF.BN254_FR, TF.BN254_FR),
    "bls12_381_fr": (JF.BLS12_381_FR, TF.BLS12_381_FR),
}
SIZES = {"toy_fr": 8, "bn254_fr": 16, "bls12_381_fr": 16}


def values(spec, seed, shape):
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    vals = [int.from_bytes(rng.bytes(48), "little") % spec.modulus for _ in range(n)]
    return vals, F.encode_ints(spec, vals).reshape(spec.num_limbs, *shape)


def test_toy_domain_is_not_degenerate():
    m = SIZES["toy_fr"]
    assert TF.TOY_FR.root_of_unity(m) != 1
    assert TF.TOY_FR.root_of_unity(m) == JH.TOY_FR.root_of_unity(m)


@pytest.mark.parametrize("name", list(SPECS))
@pytest.mark.parametrize("fn", ["ntt", "intt", "coset_ntt", "coset_intt"])
def test_ntt_bit_equal(name, fn):
    jspec, tspec = SPECS[name]
    seed = ["ntt", "intt", "coset_ntt", "coset_intt"].index(fn)
    _, a = values(tspec, seed, (SIZES[name],))
    want = np.asarray(getattr(JNTT, fn)(jspec, jnp.asarray(a)), dtype=np.uint32)
    got = F.to_numpy(getattr(TNTT, fn)(tspec, F.as_tensor(a, "cpu")))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["toy_fr", "bn254_fr"])
def test_ntt_matches_host_dft_and_round_trips(name):
    jspec, tspec = SPECS[name]
    m = SIZES[name]
    vals, a = values(tspec, 21, (3, m))  # a batch axis between L and m
    t = F.as_tensor(a, "cpu")
    ev = TNTT.ntt(tspec, t)
    for row in range(3):
        host = JG._host_ntt(jspec, vals[row * m : (row + 1) * m])
        assert F.decode_ints(tspec, ev[:, row]) == host
    back = F.normalize(tspec, TNTT.intt(tspec, ev))
    np.testing.assert_array_equal(F.to_numpy(back), a)
    back = F.normalize(tspec, TNTT.coset_intt(tspec, TNTT.coset_ntt(tspec, t)))
    np.testing.assert_array_equal(F.to_numpy(back), a)
