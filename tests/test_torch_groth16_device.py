"""PyTorch port: the slice as a whole — the device Groth16 prover on the CPU.

The 31-constraint squaring chain of `__graft_entry__._dryrun_circuit`
(domain 64, 256 MSM lanes) is set up on the host by the JAX package; a JAX
`DeviceProver(backend="limb")` is built (nothing is compiled) and its
`save_cache` state goes through the port's `DeviceProver.from_numpy_state`,
on the limb backend as recorded and on the fused backend with its meta
changed. The port's h(x), scalars and proofs are then held against the JAX
package's host references: `_h_coefficients_host`,
`groth16.prove(..., backend="host")` and both packages' `groth16.verify`. Tolerance: none (exact arithmetic; the
proofs are compared as affine points).
"""

import functools
import io
import json

import numpy as np
import pytest
import torch

import __graft_entry__ as GE
from manta_tpu.models import groth16 as JG
from manta_tpu.models import groth16_device as JGD
from manta_tpu.models import pairing as JPR
from manta_tpu.utils import keyio as JKIO
from manta_tpu_torch.models import groth16 as TG
from manta_tpu_torch.models.groth16_device import DeviceProver
from manta_tpu_torch.ops import field_ops as F
from manta_tpu_torch.utils import keyio as TKIO

# small tensors: one intra-op thread per test worker is all they use well
torch.set_num_threads(1)

# MSM shape of the test prover: the production prover uses window 13 with
# 128 column steps; a narrower window keeps the CPU run of the plain field
# ops short while every code path stays the same.
WINDOW_BITS = 6
COLUMN_STEPS = 64


@functools.lru_cache(maxsize=1)
def _slice():
    matrices, assignment, digest, _ = GE._dryrun_circuit("prove")
    pk, vk = JG.setup(JPR.BN254_PAIRING, matrices, seed=3)
    jax_prover = JGD.DeviceProver(
        pk, matrices, backend="limb", window_bits=WINDOW_BITS, column_steps=COLUMN_STEPS
    )
    buf = io.BytesIO()
    jax_prover.save_cache(buf)
    state = dict(np.load(io.BytesIO(buf.getvalue())))
    return matrices, assignment, digest, pk, vk, state


def _prover():
    *_, state = _slice()
    return DeviceProver.from_numpy_state(state, device="cpu")


def _as_tuple(proof):
    return proof.a, proof.b, proof.c


def test_state_loads_and_round_trips(tmp_path):
    matrices, _, _, pk, _, state = _slice()
    prover = _prover()
    assert (prover.m, prover.nv, prover.ni) == (pk.domain_size, matrices.num_variables,
                                               matrices.num_instance)
    assert (prover.n_ab, prover.n_lh) == (256, 256)
    assert prover.g1.backend == prover.g2.backend == "limb"
    for tag in ("a", "b1", "b2", "lh"):
        np.testing.assert_array_equal(F.to_numpy(getattr(prover, f"{tag}_pts").x), state[f"{tag}_x"])
    path = tmp_path / "prover.npz"
    prover.save_cache(str(path))
    back = DeviceProver.from_cache(str(path), device="cpu")
    with np.load(path) as saved:
        for key in state:
            np.testing.assert_array_equal(saved[key], state[key], err_msg=key)
    np.testing.assert_array_equal(F.to_numpy(back.lh_pts.y), state["lh_y"])


def _with_meta(state, **changes):
    """The prover state with its JSON meta updated."""
    meta = json.loads(bytes(state["meta"]).decode())
    meta.update(changes)
    return {**state, "meta": np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)}


@pytest.mark.parametrize("backend", ["fused", "rns_fused", "rns_hybrid", "unknown"])
def test_fused_backend_and_missing_card_raise(backend):
    """A meta recording "fused" (as the production cache does) loads on the
    fused backend with no override, and "limb" overrides it; asking for the
    card where there is none raises. The limb state loads on "rns_hybrid"
    (limb points) and not on "rns_fused" (RNS points), which raises, as an
    unknown backend does."""
    *_, state = _slice()
    if backend == "fused":
        prover = DeviceProver.from_numpy_state(_with_meta(state, backend="fused"), device="cpu")
        assert prover.g1.backend == prover.g2.backend == "fused"
        assert hasattr(prover.g1, "run_fold_columns")
        limb = DeviceProver.from_numpy_state(state, backend="limb", device="cpu")
        assert limb.g1.backend == "limb"
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA device"):
                DeviceProver.from_numpy_state(state)
    elif backend == "rns_fused":
        with pytest.raises(ValueError, match="coordinate rows"):
            DeviceProver.from_numpy_state(state, backend=backend, device="cpu")
    elif backend == "rns_hybrid":
        hybrid = DeviceProver.from_numpy_state(state, backend=backend, device="cpu")
        assert hybrid.g1.backend == hybrid.g2.backend == "rns"
        assert hasattr(hybrid.g2, "point_ops") and not hasattr(hybrid.g1, "run_fold_columns")
    else:
        with pytest.raises(ValueError, match="unknown curve backend"):
            DeviceProver.from_numpy_state(_with_meta(state, backend="rns_turbo"), device="cpu")


def test_h_and_scalars_match_host():
    matrices, assignment, _, pk, _, _ = _slice()
    prover = _prover()
    fr = prover.fr
    p = fr.modulus
    rows = JG._qap_rows(matrices)
    m = pk.domain_size

    def ev(k):
        vals = [sum(c * assignment[col] for col, c in r[k].items()) % p for r in rows]
        return vals + [0] * (m - len(rows))

    z_mont, z_canon = prover._encode_witness(assignment)
    evals = [prover._row_eval(mat, z_mont, bufs)
             for mat, bufs in zip(prover.mats, prover._mat_buffers)]
    assert [F.decode_ints(fr, e) for e in evals] == [ev(0), ev(1), ev(2)]
    h = F.decode_ints(fr, prover._h_canonical(z_mont), montgomery=False)
    assert h == JG._h_coefficients_host(JPR.BN254_PAIRING.g1.scalar_field, ev(0), ev(1), ev(2), m)
    sc_a, sc_b1, sc_b2, sc_lh = prover._prove_scalars(z_mont, z_canon)
    a_mask = [q is not None for q in pk.a_query] + [False] * (prover.n_ab - prover.nv)
    want_a = [x if keep else 0 for x, keep in zip(list(assignment) + [0] * 999, a_mask)]
    assert F.decode_ints(fr, sc_a, montgomery=False) == want_a
    ni = matrices.num_instance
    lh = list(assignment[ni:]) + h[: len(pk.h_query)]
    lh_mask = [q is not None for q in list(pk.l_query) + list(pk.h_query)]
    want_lh = [x if keep else 0 for x, keep in zip(lh, lh_mask)]
    want_lh += [0] * (prover.n_lh - len(want_lh))
    assert F.decode_ints(fr, sc_lh, montgomery=False) == want_lh


def test_proof_with_zero_randomness_equals_host_prove():
    matrices, assignment, digest, pk, vk, _ = _slice()
    proof = _prover().prove(assignment, 0, 0)
    want = JG.prove(pk, matrices, assignment, 0, 0, backend="host")
    assert _as_tuple(proof) == _as_tuple(want)


def test_random_proof_verifies_under_both_packages():
    _, assignment, digest, _, vk, _ = _slice()
    rng = np.random.default_rng(31)
    r = int.from_bytes(rng.bytes(32), "little") % JPR.BN254_PAIRING.g1.scalar_field.modulus
    s = int.from_bytes(rng.bytes(32), "little") % JPR.BN254_PAIRING.g1.scalar_field.modulus
    proof = _prover().prove(assignment, r, s)
    assert JG.verify(vk, JG.Proof(*_as_tuple(proof)), [digest])
    port_vk = TKIO.vk_from_bytes(JKIO.vk_to_bytes(vk))
    assert TG.verify(port_vk, proof, [digest])
    assert not TG.verify(port_vk, proof, [digest + 1])


def _fused_prover():
    """The test prover on the fused backend with window 8 and 2 column steps:
    R = 128 lanes and 128 covered buckets, so every MSM takes the fold path."""
    *_, state = _slice()
    return DeviceProver.from_numpy_state(
        _with_meta(state, backend="fused", window_bits=8, column_steps=2), device="cpu"
    )


def test_fused_proof_with_zero_randomness_equals_host_prove():
    matrices, assignment, _, pk, _, _ = _slice()
    proof = _fused_prover().prove(assignment, 0, 0)
    want = JG.prove(pk, matrices, assignment, 0, 0, backend="host")
    assert _as_tuple(proof) == _as_tuple(want)


def test_fused_random_proof_verifies_under_both_packages():
    _, assignment, digest, _, vk, _ = _slice()
    rng = np.random.default_rng(32)
    r, s = (int.from_bytes(rng.bytes(32), "little") % JPR.BN254_PAIRING.g1.scalar_field.modulus
            for _ in range(2))
    proof = _fused_prover().prove(assignment, r, s)
    assert JG.verify(vk, JG.Proof(*_as_tuple(proof)), [digest])
    assert TG.verify(TKIO.vk_from_bytes(JKIO.vk_to_bytes(vk)), proof, [digest])


def test_production_vk_reads_like_the_jax_package():
    with open(GE.__file__.replace("__graft_entry__.py", ".bench_prover_pt_vk.bin"), "rb") as f:
        data = f.read()
    want = JKIO.vk_from_bytes(data)
    got = TKIO.vk_from_bytes(data)
    for field in ("alpha_g1", "beta_g2", "gamma_g2", "delta_g2", "gamma_abc_g1"):
        assert getattr(got, field) == getattr(want, field)
    with pytest.raises(ValueError):
        TKIO.vk_from_bytes(data + b"\0")


def test_codec_rejects_g2_points_outside_the_subgroup():
    """Divergence by design: the JAX package's codec accepts any on-curve G2
    point; the port's also requires the prime-order subgroup."""
    from manta_tpu.utils import codec as JC
    from manta_tpu_torch.utils import codec as TC
    from manta_tpu_torch.utils import hostmath as TH

    curve = TH.BN254_G2
    p = curve.field.modulus
    x = (1, 0)
    while True:  # the first on-curve x = (k, 0); the cofactor makes r·P != inf
        rhs = TH.fq2_add(TH.fq2_mul(TH.fq2_square(x, p), x, p), curve.b, p)
        y = JC.fq2_sqrt(rhs, p)
        if y is not None:
            break
        x = (x[0] + 1, 0)
    data = JC.serialize_g2_uncompressed((x, y), curve)
    assert JC.deserialize_g2_uncompressed(data, curve) == (x, y)
    with pytest.raises(ValueError, match="subgroup"):
        TC.deserialize_g2_uncompressed(data, curve)
    g = TC.deserialize_g2_uncompressed(JC.serialize_g2_uncompressed(curve.generator, curve), curve)
    assert g == curve.generator


def test_port_host_layer_matches_the_jax_package():
    """The port's own circuit DSL, Poseidon parameters and host setup give the
    JAX package's matrices, witness and keys; a prover built from them by the
    port's constructor holds the arrays that the JAX prover's state holds."""
    from manta_tpu.models import circuit as JCC
    from manta_tpu.utils import grain as JGR
    from manta_tpu_torch.models import circuit as TCC
    from manta_tpu_torch.models import pairing as TPR
    from manta_tpu_torch.utils import grain as TGR

    matrices, assignment, digest, pk, _, state = _slice()
    fr = TPR.BN254_PAIRING.g1.scalar_field
    com = TCC.R1CS(fr, mode="prove")
    x = com.secret_witness(0xE17E17)
    for _ in range(GE._DRYRUN_CHAIN):
        x = com.mul(x, x)
    com.assert_eq(x, com.public_input(digest))
    t_matrices, t_assignment = com.finalize()
    assert t_assignment == assignment
    assert (t_matrices.num_instance, t_matrices.rows) == (matrices.num_instance, matrices.rows)

    t_spec, j_spec = TGR.poseidon_spec(fr, 3), JGR.poseidon_spec(JPR.BN254_PAIRING.g1.scalar_field, 3)
    assert TGR.poseidon_hash(t_spec, [1, 2]) == JGR.poseidon_hash(j_spec, [1, 2])
    t_com, j_com = TCC.R1CS(fr, mode="prove"), JCC.R1CS(j_spec.field, mode="prove")
    for com_, cc, spec in ((t_com, TCC, t_spec), (j_com, JCC, j_spec)):
        cc.poseidon_hash(com_, spec, [com_.secret_witness(5), com_.secret_witness(6)])
    assert t_com.finalize()[0].rows == j_com.finalize()[0].rows

    t_pk, _ = TG.setup(TPR.BN254_PAIRING, t_matrices, seed=3)
    for field in ("alpha_g1", "delta_g2", "a_query", "b_g2_query", "h_query", "l_query"):
        assert getattr(t_pk, field) == getattr(pk, field)
    built = DeviceProver(t_pk, t_matrices, window_bits=WINDOW_BITS,
                         column_steps=COLUMN_STEPS, device="cpu")
    for tag in ("a", "b1", "b2", "lh"):
        for c in "xyz":
            np.testing.assert_array_equal(
                F.to_numpy(getattr(getattr(built, f"{tag}_pts"), c)), state[f"{tag}_{c}"]
            )
        np.testing.assert_array_equal(F.to_numpy(getattr(built, f"{tag}_mask")), state[f"{tag}_mask"])
    for i, mat in enumerate(built.mats):
        np.testing.assert_array_equal(mat.coeffs, state[f"mat{i}_coeffs"])
        np.testing.assert_array_equal(mat.cols, state[f"mat{i}_cols"])
        np.testing.assert_array_equal(mat.seg_ids, state[f"mat{i}_seg"])


def test_rns_hybrid_proof_equals_fused_proof():
    """The limb state on the "rns_hybrid" backend (its limb points as they
    are, RNS buckets) proves the fused backend's proof, at random r, s."""
    _, assignment, digest, _, vk, state = _slice()
    rng = np.random.default_rng(33)
    r, s = (int.from_bytes(rng.bytes(32), "little") % JPR.BN254_PAIRING.g1.scalar_field.modulus
            for _ in range(2))
    hybrid = DeviceProver.from_numpy_state(state, backend="rns_hybrid", device="cpu")
    proof = hybrid.prove(assignment, r, s)
    assert _as_tuple(proof) == _as_tuple(_fused_prover().prove(assignment, r, s))
    assert JG.verify(vk, JG.Proof(*_as_tuple(proof)), [digest])
