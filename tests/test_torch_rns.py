"""PyTorch port: the RNS field layer, the RNS curve formulas and the RNS MSMs.

`manta_tpu_torch/ops/rns.py` is held bit for bit (residues compared as
integers) against `manta_tpu/ops/rns.py`: the spec constants, encode/decode,
the packed ops on lazy values up to 2^12·p, and the renormalizing
`RnsCoordOps` / `RnsFq2CoordOps`. The bound-annotated `RnsCurveOps`
formulas are held bit for bit against the JAX package's, and the
"rns_fused" / "rns_hybrid" MSMs against the host oracle (points (i+1)·G, so
the oracle is (sum (i+1)·s_i)·G on the JAX package's `hostmath`). The
port's entry point (`torch_entry.py`) proves the Poseidon-preimage circuit on
"rns_fused" and is held against the JAX package's host prover. Inputs come
from seeded numpy generators. Tolerance: none.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from manta_tpu import fields as JF
from manta_tpu.ops import curve as JC
from manta_tpu.ops import rns as JR
from manta_tpu.utils import hostmath as JH
from manta_tpu_torch import fields as TF
from manta_tpu_torch.ops import curve as C
from manta_tpu_torch.ops import field_ops as F
from manta_tpu_torch.ops import msm as M
from manta_tpu_torch.ops import rns as R
from manta_tpu_torch.ops.curve import JacobianPoint
from manta_tpu_torch.ops.kernels import rns_kernels as RK
from manta_tpu_torch.utils import hostmath as TH

# small tensors: one intra-op thread per test worker is all they use well
torch.set_num_threads(1)

FIELDS = {
    "bn254_fq": (JF.BN254_FQ, TF.BN254_FQ),
    "bls12_381_fq": (JF.BLS12_381_FQ, TF.BLS12_381_FQ),
}


def lazy_values(p, rng, n):
    """0, p, k·p and random integers below 2^12·p."""
    vals = [0, p, 5 * p, 4095 * p, p - 1, p + 1]
    vals += [int.from_bytes(rng.bytes(64), "little") % (4096 * p) for _ in range(n - len(vals))]
    return vals


def residues(spec, vals) -> np.ndarray:
    """(Kt, n) int32 residues of the integers `vals` (not reduced mod p)."""
    return np.asarray([[v % m for v in vals] for m in spec.moduli], dtype=np.int32)


def _j(a):
    return np.asarray(a)


@pytest.mark.parametrize("name", list(FIELDS))
def test_spec_constants_equal_jax(name):
    jf, tf = FIELDS[name]
    js, ts = JR.default_spec(jf), R.default_spec(tf)
    assert (ts.b1, ts.b2, ts.m_r) == (js.b1, js.b2, js.m_r)
    assert (ts.M1, ts.M2, ts.k1, ts.k2) == (js.M1, js.M2, js.k1, js.k2)
    int_keys = {k for k, v in js.consts.items() if np.asarray(v).dtype.kind == "i"}
    assert set(ts.consts) == int_keys
    for key in int_keys:
        np.testing.assert_array_equal(ts.consts[key], js.consts[key], err_msg=key)
    np.testing.assert_array_equal(R._zero_class_table(ts), JR._zero_class_table(js))


@pytest.mark.parametrize("name", list(FIELDS))
def test_encode_decode_equal_jax(name):
    jf, tf = FIELDS[name]
    js, ts = JR.default_spec(jf), R.default_spec(tf)
    rng = np.random.default_rng(1)
    vals = [0, 1, tf.modulus - 1] + [int.from_bytes(rng.bytes(48), "little") % tf.modulus
                                     for _ in range(61)]
    for got, want in zip(R.encode_ints(ts, vals), JR.encode_ints(js, vals)):
        np.testing.assert_array_equal(got, want)
    packed = R.pack(ts, R.encode_ints(ts, vals))
    np.testing.assert_array_equal(packed.numpy(), _j(JR.pack(js, JR.encode_ints(js, vals))))
    assert R.decode_ints(ts, R.unpack(ts, packed)) == vals
    assert JR.decode_ints(js, JR.unpack(js, jnp.asarray(packed.numpy()))) == vals


@pytest.mark.parametrize("name", list(FIELDS))
def test_packed_ops_bit_equal_to_jax(name):
    jf, tf = FIELDS[name]
    js, ts = JR.default_spec(jf), R.default_spec(tf)
    rng = np.random.default_rng(2)
    p = tf.modulus
    a_np = residues(ts, lazy_values(p, rng, 512))
    b_np = residues(ts, lazy_values(p, rng, 512)[::-1])
    a, b = torch.from_numpy(a_np), torch.from_numpy(b_np)
    ja, jb = jnp.asarray(a_np), jnp.asarray(b_np)
    np.testing.assert_array_equal(R.packed_add(ts, a, b).numpy(), _j(JR.packed_add(js, ja, jb)))
    for k in R.OFFSETS:
        np.testing.assert_array_equal(R.packed_sub_k(ts, a, b, k).numpy(),
                                      _j(JR.packed_sub_k(js, ja, jb, k)))
    np.testing.assert_array_equal(R.packed_mul(ts, a, b).numpy(), _j(JR.packed_mul(js, ja, jb)))
    np.testing.assert_array_equal(R.packed_renorm(ts, a).numpy(), _j(JR.packed_renorm(js, ja)))
    # Montgomery with respect to M1: decode(a·b) = decode(a)·decode(b) mod p
    ops = R.RnsCoordOps(tf)
    want = [x * y % p for x, y in zip(ops.decode(a), ops.decode(b))]
    assert ops.decode(R.packed_mul(ts, a, b)) == want


@pytest.mark.parametrize("name", list(FIELDS))
def test_coord_ops_equal_jax(name):
    """RnsCoordOps and RnsFq2CoordOps: mul, sub, neg, is_zero, eq and
    batch_inv bit-equal to the JAX package's."""
    jf, tf = FIELDS[name]
    rng = np.random.default_rng(3)
    p = tf.modulus
    vals = [0, 1, p - 1] + [int.from_bytes(rng.bytes(48), "little") % p for _ in range(13)]
    jo, to = JR.RnsCoordOps(jf), R.RnsCoordOps(tf)
    a_np, b_np = to.encode(vals), to.encode(vals[::-1])
    np.testing.assert_array_equal(a_np, jo.encode(vals))
    a, b = torch.from_numpy(a_np), torch.from_numpy(b_np)
    ja, jb = jnp.asarray(a_np), jnp.asarray(b_np)
    for op in ("mul", "sub", "add", "eq"):
        np.testing.assert_array_equal(getattr(to, op)(a, b).numpy(), _j(getattr(jo, op)(ja, jb)),
                                      err_msg=op)
    for op in ("neg", "is_zero", "batch_inv"):
        np.testing.assert_array_equal(getattr(to, op)(a).numpy(), _j(getattr(jo, op)(ja)),
                                      err_msg=op)
    assert to.decode(to.batch_inv(a)) == [pow(v, p - 2, p) for v in vals]
    jo2, to2 = JR.RnsFq2CoordOps(jf), R.RnsFq2CoordOps(tf)
    pairs = list(zip(vals, vals[3:] + vals[:3]))
    a2_np = to2.encode(pairs)
    np.testing.assert_array_equal(a2_np, jo2.encode(pairs))
    b2_np = to2.encode(pairs[::-1])
    a2, b2 = torch.from_numpy(a2_np), torch.from_numpy(b2_np)
    ja2, jb2 = jnp.asarray(a2_np), jnp.asarray(b2_np)
    for op in ("mul", "sub", "eq"):
        np.testing.assert_array_equal(getattr(to2, op)(a2, b2).numpy(),
                                      _j(getattr(jo2, op)(ja2, jb2)), err_msg=op)
    for op in ("neg", "is_zero", "batch_inv"):
        np.testing.assert_array_equal(getattr(to2, op)(a2).numpy(), _j(getattr(jo2, op)(ja2)),
                                      err_msg=op)
    assert to2.decode(to2.mul(a2, b2)) == [
        JH.fq2_mul(x, y, p) for x, y in zip(pairs, pairs[::-1])]


def _edge_lanes(curve, n=9):
    """(P, Q) lanes: P+P, P+(−P), P+∞, ∞+Q, ∞+∞, then generic sums."""
    g = curve.generator
    pts = [curve.scalar_mul(k, g) for k in (3, 5, 7, 11, 13)]
    ps = [pts[0], pts[1], pts[2], None, None] + pts[:n - 5]
    qs = [pts[0], curve.neg(pts[1]), None, pts[3], None] + pts[::-1][:n - 5]
    return ps, qs


@pytest.mark.parametrize("name", ["bn254_g1", "bn254_g2"])
def test_annotated_formulas_equal_jax(name):
    """RnsCurveOps (bound-annotated formulas, renormalizing field ops) bit
    for bit against the JAX package's, and add / madd / double against
    hostmath after decode_points."""
    jcurve, tcurve = getattr(JH, name.upper()), getattr(TH, name.upper())
    jc, tc = JC.rns_curve_ops_for(jcurve), C.rns_curve_ops_for(tcurve)
    assert C.rns_curve_ops_for(tcurve) is tc and not tc.limb16_points
    ps, qs = _edge_lanes(jcurve)
    jp, jq = jc.encode_points(ps), jc.encode_points(qs)
    tp, tq = tc.encode_points(ps, "cpu"), tc.encode_points(qs, "cpu")
    for a, b in zip(tp, jp):
        np.testing.assert_array_equal(a.numpy(), _j(b))
    t2, j2 = tc.double(tp), jc.double(jp)
    cases = (("double", (tp,), (jp,)), ("add", (t2, tq), (j2, jq)), ("madd", (t2, tq), (j2, jq)))
    # G2: the JAX package's eager Fq2 formulas take seconds an op on the CPU;
    # its doubling stands for them (the RNS kernels' tests cover G2 add/madd)
    for which, targs, jargs in cases[: 1 if tcurve.is_ext else 3]:
        got, want = getattr(tc, which)(*targs), getattr(jc, which)(*jargs)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), _j(b), err_msg=which)
    assert tc.decode_points(tc.add(tp, tq)) == [jcurve.add(a, b) for a, b in zip(ps, qs)]
    assert tc.decode_points(tc.madd(t2, tq)) == [
        jcurve.add(jcurve.double(a), b) for a, b in zip(ps, qs)]
    # the renormalizing backend runs the limb formulas over RNS field ops
    rc = C.curve_ops_for(tcurve, "rns")
    assert rc.decode_points(rc.add(tp, tq)) == [jcurve.add(a, b) for a, b in zip(ps, qs)]
    assert rc.decode_points(rc.to_affine(rc.double(tp))) == [jcurve.double(a) for a in ps]


def _msm_case(name, backend, n, steps, window_bits=8, inf_lane=3):
    """An RNS MSM over (i+1)·G with one infinity lane, against the host:
    sum_i s_i·(i+1)·G = (sum_i (i+1)·s_i mod r)·G."""
    jcurve, tcurve = getattr(JH, name.upper()), getattr(TH, name.upper())
    rng = np.random.default_rng(n + steps)
    r = jcurve.scalar_field.modulus
    scalars = [int.from_bytes(rng.bytes(40), "little") % r for _ in range(n)]
    points, acc = [], None
    for _ in range(n):
        acc = jcurve.add(acc, jcurve.generator)
        points.append(acc)
    points[inf_lane] = None
    weight = sum((i + 1) * s for i, s in enumerate(scalars) if i != inf_lane) % r
    want = jcurve.scalar_mul(weight, jcurve.generator)
    cops = C.curve_ops_for(tcurve, backend)
    sc = F.as_tensor(F.encode_ints(tcurve.scalar_field, scalars, montgomery=False), "cpu")
    got = M.msm(cops, sc, cops.encode_points(points, "cpu"), window_bits, steps,
                tcurve.scalar_field.bits, True)
    assert cops.decode_points(got) == [want]


@pytest.mark.parametrize("backend", ["rns_fused", "rns_hybrid"])
@pytest.mark.parametrize("name,n,steps", [("bn254_g1", 256, 2), ("bls12_381_g1", 512, 4),
                                          ("bn254_g2", 128, 1)])
def test_rns_msm_equals_host(backend, name, n, steps):
    _msm_case(name, backend, n, steps)


@pytest.mark.parametrize("backend", ["rns_fused", "rns_hybrid"])
def test_rns_msm_runs_bucket_column_and_combine_not_single_lane_doubles(backend, monkeypatch):
    """The RNS MSM's kernel calls, read by wrapping the kernel wrappers the
    backends call: rns_hybrid accumulates through the hybrid bucket column
    (no column stream), rns_fused through the column stream; both run
    Horner's rule and the two weighted reductions' doubling runs as three
    combine calls, and no single-lane doubling."""
    names = ("rns_double", "rns_double_add", "hybrid_accumulate_buckets",
             "rns_accumulate_columns")
    calls = dict.fromkeys(names, 0)
    for name in names:
        def counted(*args, _fn=getattr(RK, name), _name=name):
            calls[_name] += 1
            return _fn(*args)

        monkeypatch.setattr(RK, name, counted)
    _msm_case("bn254_g1", backend, 256, 2)
    hybrid = backend == "rns_hybrid"
    assert calls == {"rns_double": 0, "rns_double_add": 3, "hybrid_accumulate_buckets": int(hybrid),
                     "rns_accumulate_columns": int(not hybrid)}


def test_hybrid_msm_negates_and_pads_limb_points():
    """The hybrid MSM negates y (signed digits) and pads the point arrays in
    the limb form (`point_ops`, `point_infinity_like`), while its buckets are
    RNS: 201 points pad to 204 for 4 column steps."""
    cops = C.curve_ops_for(TH.BN254_G1, "rns_hybrid")
    assert cops.limb16_points and cops.point_ops.spec is TH.BN254_G1.field
    pad = cops.point_infinity_like(cops.encode_points([None], "cpu"))
    np.testing.assert_array_equal(pad.y.numpy(), F.one_like(TH.BN254_G1.field, pad.y).numpy())
    _msm_case("bn254_g1", "rns_hybrid", 201, 4)


def test_backends_and_unknown_name():
    """Every backend name is served; an unknown one raises."""
    for backend in ("limb", "fused", "rns", "rns_fused", "rns_hybrid"):
        cops = C.curve_ops_for(TH.BN254_G1, backend)
        assert isinstance(cops, C.CurveOps)
    assert isinstance(C.curve_ops_for(TH.BN254_G2, "rns").ops, R.RnsFq2CoordOps)
    with pytest.raises(ValueError, match="unknown curve backend"):
        C.curve_ops_for(TH.BN254_G1, "rns_turbo")
    x = JacobianPoint(*(torch.zeros((R.default_spec(TH.BN254_G1.field).kt, 4), dtype=torch.int32)
                        for _ in range(3)))
    assert C.curve_ops_for(TH.BN254_G1, "rns_fused").affine_infinity_mask(x).all()


def test_rns_fused_prover_equals_host_prove():
    """`torch_entry.entry()`: the port's prover core on the Poseidon-preimage
    circuit, "rns_fused", window 8, 16 column steps; its randomization-free
    proof equals the JAX package's host prover's on the same key (both
    packages' setups at seed 3)."""
    import __graft_entry__ as GE
    import torch_entry as TE
    from manta_tpu.models import groth16 as JG
    from manta_tpu.models import pairing as JPR

    fn, args = TE.entry(device="cpu")
    prover, _, _ = TE.small_prover("cpu")
    assert prover.g1.run_columns.__func__ is RK.RnsFusedCurveOps.run_columns
    proof = prover._finish(fn(*args), 0, 0)
    matrices, assignment, _, _ = GE._poseidon_preimage_circuit("prove")
    pk, _ = JG.setup(JPR.BN254_PAIRING, GE._poseidon_preimage_circuit("setup")[0], seed=3)
    want = JG.prove(pk, matrices, assignment, 0, 0, backend="host")
    assert (proof.a, proof.b, proof.c) == (want.a, want.b, want.c)


def test_torch_entry_dryrun_verifies_on_the_cpu():
    import torch_entry as TE

    proof = TE.dryrun(device="cpu")
    assert proof.a is not None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TE.entry()
