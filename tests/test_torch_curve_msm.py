"""PyTorch port: curve ops and the limb-backend MSM vs the JAX package.

Point results are compared after `decode_points` (affine host points), since
Jacobian limbs depend on the order of accumulation; the references are the
JAX package's `hostmath` curves and `ops.msm.msm_host_oracle`. Window digits
are compared bit for bit with the JAX function. Tolerance: none (exact
integer arithmetic). Everything runs on CPU tensors (the plain versions).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from manta_tpu.ops import msm as JM
from manta_tpu.utils import hostmath as JH
from manta_tpu_torch.ops import curve as C
from manta_tpu_torch.ops import field_ops as F
from manta_tpu_torch.ops import msm as M
from manta_tpu_torch.utils import hostmath as TH

# small tensors: one intra-op thread per test worker is all they use well
torch.set_num_threads(1)

CURVES = {
    "bn254_g1": (JH.BN254_G1, TH.BN254_G1),
    "bn254_g2": (JH.BN254_G2, TH.BN254_G2),
    "bls12_381_g1": (JH.BLS12_381_G1, TH.BLS12_381_G1),
    "bls12_381_g2": (JH.BLS12_381_G2, TH.BLS12_381_G2),
}


def scalars_np(rng, n, modulus):
    return [int.from_bytes(rng.bytes(48), "little") % modulus for _ in range(n)]


def lane_pairs(curve, rng):
    """(P, Q) lanes: P+P, P+(-P), P+inf, inf+Q, inf+inf and two generic sums."""
    g = curve.generator
    r = curve.scalar_field.modulus
    pts = [curve.scalar_mul(k, g) for k in scalars_np(rng, 5, r)]
    ps = [pts[0], pts[1], pts[2], None, None, pts[3], pts[4]]
    qs = [pts[0], curve.neg(pts[1]), None, pts[3], None, pts[4], pts[0]]
    return ps, qs


@pytest.mark.parametrize("name", list(CURVES))
def test_add_madd_double_match_hostmath(name):
    jcurve, tcurve = CURVES[name]
    rng = np.random.default_rng(11)
    ps, qs = lane_pairs(jcurve, rng)
    cops = C.curve_ops_for(tcurve, "limb")
    p = cops.encode_points(ps, "cpu")
    q = cops.encode_points(qs, "cpu")
    assert cops.decode_points(cops.add(p, q)) == [jcurve.add(a, b) for a, b in zip(ps, qs)]
    assert cops.decode_points(cops.double(p)) == [jcurve.double(a) for a in ps]
    # madd with a Jacobian accumulator (Z != 1): 2P in Jacobian form, q affine
    p2 = cops.double(p)
    want = [jcurve.add(jcurve.double(a), b) for a, b in zip(ps, qs)]
    assert cops.decode_points(cops.madd(p2, q)) == want
    # ... and the doubling lane of madd: 2P + 2P with 2P affine
    aff = cops.encode_points([jcurve.double(a) for a in ps], "cpu")
    want = [jcurve.double(jcurve.double(a)) for a in ps]
    assert cops.decode_points(cops.madd(p2, aff)) == want


@pytest.mark.parametrize("name", ["bn254_g1", "bn254_g2"])
def test_to_affine_matches_hostmath(name):
    jcurve, tcurve = CURVES[name]
    rng = np.random.default_rng(12)
    ps, qs = lane_pairs(jcurve, rng)
    cops = C.curve_ops_for(tcurve, "limb")
    s = cops.add(cops.encode_points(ps, "cpu"), cops.encode_points(qs, "cpu"))
    aff = cops.to_affine(s)
    want = [jcurve.add(a, b) for a, b in zip(ps, qs)]
    assert cops.decode_points(aff) == want
    one, zero = ((1, 0), (0, 0)) if tcurve.is_ext else (1, 0)
    assert cops.ops.decode(aff.z) == [zero if w is None else one for w in want]


@pytest.mark.parametrize("backend", ["fused", "rns_fused", "rns_hybrid", "unknown"])
def test_other_backends_raise(backend):
    """Every ported backend is served and the default stays "limb"; an
    unknown backend name raises."""
    assert C.curve_ops_for(TH.BN254_G1).backend == "limb"
    if backend == "unknown":
        with pytest.raises(ValueError, match="unknown curve backend"):
            C.curve_ops_for(TH.BN254_G1, "rns_turbo")
        return
    cops = C.curve_ops_for(TH.BN254_G1, backend)
    assert cops.backend == ("fused" if backend == "fused" else "rns")
    # the fused and rns_hybrid backends' columns write run ends only; rns_fused's a stream
    assert hasattr(cops, "run_bucket_columns") == (backend in ("fused", "rns_hybrid"))
    assert hasattr(cops, "run_columns") == (backend == "rns_fused")
    # the RNS backends run the MSM's chains of doublings as combine launches
    assert hasattr(cops, "double_add") == backend.startswith("rns")
    assert hasattr(cops, "point_ops") == (backend == "rns_hybrid")


@pytest.mark.parametrize("window_bits,scalar_bits", [(13, 254), (8, 254), (16, 255), (5, 0)])
def test_window_digits_bit_equal(window_bits, scalar_bits):
    rng = np.random.default_rng(13)
    spec = TH.BN254_G1.scalar_field
    vals = [0, 1, spec.modulus - 1] + scalars_np(rng, 29, spec.modulus)
    sc = F.encode_ints(spec, vals, montgomery=False)
    d_j, n_j, c_j = JM.window_digits_signed(jnp.asarray(sc), window_bits, scalar_bits)
    d_t, n_t, c_t = M.window_digits_signed(F.as_tensor(sc, "cpu"), window_bits, scalar_bits)
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))
    np.testing.assert_array_equal(n_t.numpy(), np.asarray(n_j))
    np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))
    np.testing.assert_array_equal(
        M.window_digits(F.as_tensor(sc, "cpu"), window_bits).numpy(),
        np.asarray(JM.window_digits(jnp.asarray(sc), window_bits)),
    )


def _msm_case(jcurve, tcurve, points, scalars, window_bits, steps, signed=True):
    cops = C.curve_ops_for(tcurve, "limb")
    sc = F.as_tensor(F.encode_ints(tcurve.scalar_field, scalars, montgomery=False), "cpu")
    got = M.msm(
        cops, sc, cops.encode_points(points, "cpu"), window_bits, steps,
        tcurve.scalar_field.bits if signed else 0, signed,
    )
    assert cops.decode_points(got) == [JM.msm_host_oracle(jcurve, scalars, points)]


def toy_points(rng, n):
    r = JH.TOY_G1.scalar_field.modulus
    return [JH.TOY_G1.scalar_mul(k, JH.TOY_G1.generator) for k in scalars_np(rng, n, r - 1)]


@pytest.mark.parametrize("window_bits,steps,n", [(4, 8, 64), (6, 16, 200), (5, 7, 10), (4, 64, 64)])
def test_toy_msm_matches_oracle(window_bits, steps, n):
    rng = np.random.default_rng(14 + n)
    r = JH.TOY_G1.scalar_field.modulus
    scalars = scalars_np(rng, n - 3, r) + [0, 1, r - 1]
    _msm_case(JH.TOY_G1, TH.TOY_G1, toy_points(rng, n), scalars, window_bits, steps)


def test_toy_msm_unsigned_matches_oracle():
    rng = np.random.default_rng(15)
    r = JH.TOY_G1.scalar_field.modulus
    _msm_case(JH.TOY_G1, TH.TOY_G1, toy_points(rng, 48), scalars_np(rng, 48, r), 4, 8, False)


def test_toy_msm_edge_cases():
    """Duplicated points with equal scalars (the doubling lane inside the
    bucket loop), zero scalars, infinity points, and one bucket spanning
    every column chunk (the trailing-partial fold)."""
    g = JH.TOY_G1.generator
    p = JH.TOY_G1.scalar_mul(7, g)
    points = [p, p, p, None] + [JH.TOY_G1.scalar_mul(k + 2, g) for k in range(12)]
    scalars = [9, 9, 9, 5, 0, 0] + [12345] * 10
    _msm_case(JH.TOY_G1, TH.TOY_G1, points, scalars, 4, 2)
    _msm_case(JH.TOY_G1, TH.TOY_G1, points, scalars, 4, 4)


def test_bn254_g1_msm_matches_oracle():
    jcurve, tcurve = CURVES["bn254_g1"]
    rng = np.random.default_rng(16)
    r = jcurve.scalar_field.modulus
    g = jcurve.generator
    points = [jcurve.scalar_mul(k + 1, g) for k in range(24)] + [None]
    scalars = scalars_np(rng, 23, r) + [0, r - 1]
    _msm_case(jcurve, tcurve, points, scalars, 8, 8)


def test_msm_rejects_mismatched_lanes():
    cops = C.curve_ops_for(TH.TOY_G1, "limb")
    pts = cops.encode_points(toy_points(np.random.default_rng(17), 4), "cpu")
    with pytest.raises(ValueError):
        M.msm(cops, torch.zeros((2, 5), dtype=torch.int32), pts, 4, 2)
