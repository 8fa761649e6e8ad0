"""PyTorch port: the RNS kernels' plain versions vs the JAX package.

`ops/kernels/rns_kernels.py` holds the CUDA point-op, column and hybrid
column kernels and their plain versions; on CPU tensors the public functions
take the plain versions. They are held here bit for bit, residues compared as
integers, against the JAX package's Pallas kernels
(`manta_tpu/ops/pallas/rns_kernels.py`) in interpret mode: `_run_point_op`
(G1), `rns_accumulate_columns` and `hybrid_accumulate_columns` (the
hybrid bucket column's plain version against the JAX stream and the pick of
its run ends), on BN254 with 128 lanes and K = 8 (the JAX `_tables` cannot be
built for the TOY field: ROADMAP queue C). The combine's plain version is
held against the JAX kernel's formulas run as the JAX package's MSM runs
them, a double or add at a time. For G2 the JAX kernel's own formulas and field ops
(`_RnsKernelCurve` over `_KernelRnsFq2Ops`) run eagerly instead of through
the interpreter, whose trace of a G2 formula takes 7–23 s. The kernels'
table-free zero test is held against the zero-class table and the JAX
kernel's `is_zero`. Inputs come from seeded numpy generators and include the
edge lanes P+P, P+(−P), P+∞, ∞+Q and ∞+∞. Tolerance: none.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from manta_tpu.ops import curve as JC
from manta_tpu.ops import rns as JR
from manta_tpu.ops.curve import JacobianPoint as JPoint
from manta_tpu.ops.pallas import rns_kernels as JRK
from manta_tpu.utils import hostmath as JH
from manta_tpu_torch.ops import curve as C
from manta_tpu_torch.ops import msm as M
from manta_tpu_torch.ops import rns as R
from manta_tpu_torch.ops.curve import JacobianPoint
from manta_tpu_torch.ops.kernels import build as B
from manta_tpu_torch.ops.kernels import rns_kernels as RK
from manta_tpu_torch.utils import hostmath as TH

# small tensors: one intra-op thread per test worker is all they use well
torch.set_num_threads(1)

LANES = 128
STEPS = 8


def host_points(curve, rng, n, p_inf=0.1):
    """n points from 8 random multiples of G (repeats give P+P lanes), a
    share of them at infinity."""
    r = curve.scalar_field.modulus
    base = [curve.scalar_mul(int(k) % r or 1, curve.generator) for k in rng.integers(1, 2**62, 8)]
    return [None if rng.random() < p_inf else base[int(i)] for i in rng.integers(0, 8, n)]


def edge_pairs(curve, rng, n):
    """(P, Q) lane lists: P+P, P+(−P), P+∞, ∞+Q, ∞+∞, then random lanes."""
    ps, qs = host_points(curve, rng, n, 0.0), host_points(curve, rng, n)
    ps[3] = ps[4] = None
    qs[:5] = [ps[0], curve.neg(ps[1]), None, qs[5], None]
    return ps, qs


def _t(pt) -> JacobianPoint:
    return JacobianPoint(*(torch.from_numpy(np.array(a, dtype=np.int32)) for a in pt))


def _equal(got, want, what):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(np.int64), err_msg=what)


def _point_inputs(name, seed):
    jcurve, tcurve = getattr(JH, name.upper()), getattr(TH, name.upper())
    ps, qs = edge_pairs(jcurve, np.random.default_rng(seed), LANES)
    jops = JC.curve_ops_for(jcurve, "rns_fused")
    return jcurve, tcurve, jops.encode_points(ps), jops.encode_points(qs), ps, qs


@pytest.mark.parametrize("which", ["add", "madd", "double"])
def test_plain_point_ops_equal_jax_kernel_g1(which):
    jcurve, tcurve, jp, jq, ps, qs = _point_inputs("bn254_g1", 5)
    # a Jacobian accumulator (Z != 1): 2P, by both packages
    j2 = JRK._run_point_op(jcurve, "double", jp)
    t2 = RK.rns_double(tcurve, _t(jp))
    _equal(t2, j2, "double")
    if which == "double":
        return
    for jargs, targs in (((j2, jq), (t2, _t(jq))), ((jp, jp), (_t(jp), _t(jp)))):
        want = JRK._run_point_op(jcurve, which, *jargs)
        got = getattr(RK, f"rns_{which}")(tcurve, *targs)
        _equal(got, want, which)
    got = RK.rns_add(tcurve, _t(jp), _t(jq))
    cops = C.curve_ops_for(tcurve, "rns_fused")
    assert cops.decode_points(got) == [jcurve.add(a, b) for a, b in zip(ps, qs)]


@pytest.mark.parametrize("which", ["add", "madd", "double"])
def test_plain_point_ops_equal_jax_kernel_ops_g2(which):
    """G2: the JAX kernel's formulas over `_KernelRnsFq2Ops`, eagerly."""
    jcurve, tcurve, jp, jq, ps, qs = _point_inputs("bn254_g2", 6)
    spec = JR.default_spec(jcurve.field)
    names, fvec, amat, ztab, znorm = JRK._tables(spec)
    kops = JRK._make_kops(jcurve, spec, names, *map(jnp.asarray, (fvec, amat, ztab, znorm)))
    kc = JRK._RnsKernelCurve(jcurve, backend="rns_kernel", kops=kops)

    def f32(pt):
        return JPoint(*(jnp.asarray(a).astype(jnp.float32) for a in pt))

    if which == "double":
        _equal(RK.rns_double(tcurve, _t(jp)), kc.double(f32(jp)), "double")
        return
    want = getattr(kc, which)(f32(jp), f32(jq))
    got = getattr(RK, f"rns_{which}")(tcurve, _t(jp), _t(jq))
    _equal(got, want, which)
    cops = C.curve_ops_for(tcurve, "rns_fused")
    assert cops.decode_points(got) == [jcurve.add(a, b) for a, b in zip(ps, qs)]


def _column_inputs(jcurve, backend, seed):
    """A (K, *E, R) sorted-stream stand-in: lane j owns points [jK, (j+1)K);
    random head / qinf, an all-head row, an all-infinity column."""
    rng = np.random.default_rng(seed)
    flat = host_points(jcurve, rng, STEPS * LANES)
    enc = JC.curve_ops_for(jcurve, backend).encode_points(flat)

    def stream(c):
        c = np.asarray(c).astype(np.int32)
        return np.ascontiguousarray(np.moveaxis(c.reshape(*c.shape[:-1], LANES, STEPS), -1, 0))

    head = rng.random((STEPS, LANES)) < 0.3
    head[3] = True
    qinf = rng.random((STEPS, LANES)) < 0.1
    qinf[:, 5] = True
    qinf |= np.asarray([p is None for p in flat]).reshape(LANES, STEPS).T
    return stream(enc.x), stream(enc.y), qinf, head


@pytest.mark.parametrize("kind", ["columns", "hybrid"])
def test_plain_columns_equal_jax_kernel(kind):
    jcurve, tcurve = JH.BN254_G1, TH.BN254_G1
    backend = "rns_fused" if kind == "columns" else "rns_hybrid"
    px, py, qinf, head = _column_inputs(jcurve, backend, 7)
    jfn = JRK.rns_accumulate_columns if kind == "columns" else JRK.hybrid_accumulate_columns
    want = jfn(jcurve, jnp.asarray(px), jnp.asarray(py), jnp.asarray(qinf.astype(np.int32)),
               jnp.asarray(head.astype(np.int32)))
    tfn = RK.rns_accumulate_columns if kind == "columns" else RK.plain_hybrid_accumulate_columns
    got = tfn(tcurve, *(torch.from_numpy(a) for a in (px, py, qinf, head)))
    _equal(got, want, kind)


def test_plain_hybrid_buckets_equal_jax_stream_and_pick():
    """The hybrid bucket column's plain version (CPU tensors) on the MSM's
    layout: 2 windows of 64 lanes of K = 8 steps, each window's digits
    sorted (`msm._sorted_layout`, `_run_end_slots`), window 0 with a run
    ending on a lane's first step, one ending on a lane's last step and a
    digit over two whole lanes, window 1 with a lane all at infinity; bit for
    bit the JAX kernel's stream (`hybrid_accumulate_columns`), its run ends
    picked into infinity buckets, and its last step."""
    jcurve, tcurve = JH.BN254_G1, TH.BN254_G1
    rng = np.random.default_rng(17)
    windows, lanes, nb = 2, LANES // 2, 40
    n = lanes * STEPS
    digits = np.sort(rng.integers(0, nb, (windows, n)), axis=-1)
    edge = [np.full(STEPS + 1, 1), np.full(STEPS - 1, 2), np.full(2 * STEPS, 3)]
    digits[0] = np.concatenate(edge + [np.sort(rng.integers(4, nb, n - 4 * STEPS))])
    flat = host_points(jcurve, rng, windows * n)  # in each window's sorted order
    flat[n + 3 * STEPS : n + 4 * STEPS] = [None] * STEPS
    enc = JC.curve_ops_for(jcurve, "rns_hybrid").encode_points(flat)

    def stream(c):  # (L, W·n) -> (K, L, W·R): lane j of window w owns [jK, (j+1)K)
        c = np.asarray(c).astype(np.int32).reshape(-1, windows, lanes, STEPS)
        return np.ascontiguousarray(np.moveaxis(c, -1, 0).reshape(STEPS, -1, windows * lanes))

    px, py = stream(enc.x), stream(enc.y)
    qinf = stream(np.asarray([[p is None for p in flat]]))[:, 0]
    _, d_t, head, end = M._sorted_layout(torch.from_numpy(digits), STEPS)
    head = head.reshape(STEPS, -1)
    slot = M._run_end_slots(d_t, end, nb)
    got_b, got_a = RK.hybrid_accumulate_buckets(
        tcurve, torch.from_numpy(px), torch.from_numpy(py), torch.from_numpy(qinf), head, slot,
        windows * nb)
    want = [np.asarray(c) for c in JRK.hybrid_accumulate_columns(
        jcurve, jnp.asarray(px), jnp.asarray(py), jnp.asarray(qinf.astype(np.int32)),
        jnp.asarray(head.numpy().astype(np.int32)))]
    _equal(got_a, [c[-1] for c in want], "last step")
    # the run ends, found in numpy: the last sorted position of each digit
    want_b = [c.numpy().copy() for c in RK._infinity(tcurve, windows * nb, "cpu")]
    ends = 0
    for w in range(windows):
        for i in range(n):
            if i == n - 1 or digits[w, i] != digits[w, i + 1]:
                j, k = divmod(i, STEPS)
                for b, c in zip(want_b, want):
                    b[:, w * nb + digits[w, i]] = c[k, :, w * lanes + j]
                ends += 1
    assert int((slot >= 0).sum()) == ends
    _equal(got_b, want_b, "buckets")


def _jax_kernel_curve(jcurve):
    """The JAX kernel's formulas over its field ops, run eagerly."""
    spec = JR.default_spec(jcurve.field)
    names, fvec, amat, ztab, znorm = JRK._tables(spec)
    kops = JRK._make_kops(jcurve, spec, names, *map(jnp.asarray, (fvec, amat, ztab, znorm)))
    return JRK._RnsKernelCurve(jcurve, backend="rns_kernel", kops=kops)


@pytest.mark.parametrize("chain", ["horner", "weighted_reduce", "weighted_reduce_signed"])
def test_plain_combine_equal_jax_double_add_sequence(chain):
    """The combine's plain version against the JAX kernel's formulas run as
    the JAX package's MSM runs them, a double or add at a time (BN254 G1):
    Horner's rule over 4 windows of 2 bits (`msm.horner`, through the
    backend: acc = 2^c·acc + W_w), with a window at infinity, two equal
    consecutive windows and a window equal to 2^c·acc (the addition's
    doubling branch); and the weighted reductions' runs over 5 lanes,
    add(2^d·hi, lo) and add(acc, 2^d·top) (the doubled point second), with
    a lane at infinity and a lane where the two operands are equal."""
    jcurve, tcurve = JH.BN254_G1, TH.BN254_G1
    kc = _jax_kernel_curve(jcurve)
    jc = JC.curve_ops_for(jcurve, "rns_fused")
    rng = np.random.default_rng(23)
    g = jcurve.generator

    def f32(pt):
        return JPoint(*(jnp.asarray(a).astype(jnp.float32) for a in pt))

    if chain == "horner":
        c = 2
        top = jcurve.scalar_mul(5, g)
        # W_3 = W_2 = 5·G, W_1 at infinity, W_0 = 400·G = 2^c·acc as it meets acc
        wins = [jcurve.scalar_mul(400, g), None, top, top]
        enc = jc.encode_points(wins)  # (Kt, 4)
        acc = f32(JPoint(*(a[..., 3:] for a in enc)))
        for w in (2, 1, 0):
            for _ in range(c):
                acc = kc.double(acc)
            acc = kc.add(acc, f32(JPoint(*(a[..., w : w + 1] for a in enc))))
        got = M.horner(RK.rns_fused_curve_ops_for(tcurve),
                       _t(JPoint(*(np.asarray(a)[:, :, None] for a in enc))), c)  # (Kt, W, 1)
        _equal(got, acc, "horner")
        cops = C.curve_ops_for(tcurve, "rns_fused")
        assert cops.decode_points(got) == [jcurve.scalar_mul(800, g)]
        return
    d, first = (2, True) if chain == "weighted_reduce" else (3, False)
    ps, qs = host_points(jcurve, rng, 5, 0.0), host_points(jcurve, rng, 5, 0.0)
    ps[1] = None  # the chain at infinity
    qs[2] = None  # the other operand at infinity
    qs[3] = jcurve.scalar_mul(1 << d, ps[3])  # the operands equal after the doublings
    jp, jq = jc.encode_points(ps), jc.encode_points(qs)
    chain_pt = kc.double(f32(jp))  # Jacobian (Z != 1), as the reductions' inputs
    other = kc.double(f32(jq))
    acc = chain_pt
    for _ in range(d):
        acc = kc.double(acc)
    want = kc.add(acc, other) if first else kc.add(other, acc)
    init = _t(JPoint(*(np.asarray(a) for a in chain_pt)))
    addends = _t(JPoint(*(np.asarray(a)[None] for a in other)))
    got = RK.rns_double_add(tcurve, init, addends, d, first)
    _equal(got, want, chain)
    sums = [jcurve.add(jcurve.scalar_mul(2 << d, p), jcurve.double(q)) for p, q in zip(ps, qs)]
    assert C.curve_ops_for(tcurve, "rns_fused").decode_points(got) == sums


@pytest.mark.parametrize("name", ["bn254_g2", "bls12_381_g1"])
def test_plain_columns_match_host(name):
    """Column and hybrid column on G2 and on BLS12-381 against host running
    sums, after decode_points, at every step."""
    jcurve, tcurve = getattr(JH, name.upper()), getattr(TH, name.upper())
    rng = np.random.default_rng(8)
    K, lanes = 4, 6
    flat = host_points(jcurve, rng, K * lanes)
    head = rng.random((K, lanes)) < 0.3
    head[0] = True
    qinf = rng.random((K, lanes)) < 0.2
    for k in range(K):  # an infinity point enters as such (the MSM's affine_infinity_mask)
        for j in range(lanes):
            qinf[k, j] |= flat[j * K + k] is None
    want = []
    acc = [None] * lanes
    for k in range(K):
        for j in range(lanes):
            q = None if qinf[k, j] else flat[j * K + k]
            acc[j] = q if head[k, j] else jcurve.add(acc[j], q)
        want.append(list(acc))
    cops = C.curve_ops_for(tcurve, "rns_fused")
    for backend, fn in (("rns_fused", RK.rns_accumulate_columns),
                        ("rns_hybrid", RK.plain_hybrid_accumulate_columns)):
        enc = C.curve_ops_for(tcurve, backend).encode_points(flat, "cpu")

        def stream(c):
            return c.reshape(*c.shape[:-1], lanes, K).movedim(-1, 0).contiguous()

        out = fn(tcurve, stream(enc.x), stream(enc.y), torch.from_numpy(qinf),
                 torch.from_numpy(head))
        for k in range(K):
            assert cops.decode_points(JacobianPoint(*(c[k] for c in out))) == want[k], backend


def test_zero_tests_agree():
    """The kernels' table-free test (`crt_is_zero`), the table
    (`table_is_zero`) and the JAX kernel's `is_zero` on k·p, k·p ± 1 for
    k < 2^13 + 2 and random lazy values."""
    tspec = R.default_spec(TH.BN254_G1.field)
    jspec = JR.default_spec(JH.BN254_G1.field)
    p = tspec.field.modulus
    rng = np.random.default_rng(9)
    vals = [k * p + d for k in range(RK.N_ZERO_CLASSES + 2) for d in (-1, 0, 1) if k * p + d >= 0]
    vals += [int.from_bytes(rng.bytes(48), "little") % (4096 * p) for _ in range(512)]
    a = torch.tensor([[v % m for v in vals] for m in tspec.moduli], dtype=torch.int32)
    want = [v % p == 0 and v // p < RK.N_ZERO_CLASSES for v in vals]
    table = RK.table_is_zero(tspec, a)
    assert table.tolist() == want
    assert torch.equal(RK.crt_is_zero(tspec, a), table)
    assert torch.equal(RK.rns_is_zero(TH.BN254_G1, a), table)
    names, fvec, amat, ztab, znorm = JRK._tables(jspec)
    kops = JRK._KernelRnsOps(jspec, fvec, amat, jnp.asarray(ztab), jnp.asarray(znorm), names)
    # the JAX test forms (2^13, lanes) distance matrices: 2048 lanes at a time
    # keep them at ~70 MB each
    for i in range(0, a.shape[1], 2048):
        chunk = jnp.asarray(a[:, i : i + 2048].numpy(), jnp.float32)
        np.testing.assert_array_equal(np.asarray(kops.is_zero(chunk)),
                                      table[i : i + 2048].numpy())


def test_from_limbs_matches_encode():
    """limb -> RNS conversion (the hybrid column's first step at a head is
    the converted point) decodes to the point's coordinates."""
    curve = TH.BLS12_381_G1
    pts = [curve.scalar_mul(k + 1, curve.generator) for k in range(16)]
    limb = C.curve_ops_for(curve, "rns_hybrid").encode_points(pts, "cpu")
    ox, oy, oz = RK.plain_hybrid_accumulate_columns(curve, limb.x[None], limb.y[None],
                                                    torch.zeros((1, 16), dtype=torch.bool),
                                                    torch.ones((1, 16), dtype=torch.bool))
    ops = R.RnsCoordOps(curve.field)
    assert ops.decode(ox[0]) == [pt[0] for pt in pts]
    assert ops.decode(oy[0]) == [pt[1] for pt in pts]
    assert ops.decode(oz[0]) == [1] * 16


def test_device_table_layout():
    """The kernels' constant table matches `rns_ops.cuh`'s layout: each
    curve field's (k1, k2, L) as the header's Dims, and the rows at their
    offsets."""
    header = (B.CSRC / "rns_ops.cuh").read_text()
    dims = dict(re.findall(r"using (\w+) = Dims<(\d+, \d+, \d+)>;", header))
    assert re.search(r"kRows = 20;", header)
    for name, field in (("Bn254", TH.BN254_G1.field), ("Bls12381", TH.BLS12_381_G1.field)):
        spec = R.default_spec(field)
        assert dims[name] == f"{spec.k1}, {spec.k2}, {field.num_limbs}"
        kp = RK.padded_channels(spec)
        words = RK.device_table(spec).view(np.uint32).astype(np.int64)
        size = 20 * kp + (spec.k2 + 1) * spec.k1 + (spec.k1 + 1) * spec.k2 + kp * field.num_limbs
        assert words.shape == (size + 8,)
        rows = words[: 20 * kp].reshape(20, kp)
        np.testing.assert_array_equal(rows[0, : spec.kt], spec.moduli)
        np.testing.assert_array_equal(rows[1, : spec.kt], [(1 << 32) // m for m in spec.moduli])
        np.testing.assert_array_equal(rows[10 + 6, : spec.kt], R._packed_consts(spec)["off11"])
        a1 = words[20 * kp : 20 * kp + (spec.k2 + 1) * spec.k1].reshape(spec.k2 + 1, spec.k1)
        np.testing.assert_array_equal(a1, spec.consts["A1"])
        assert words[size] == spec.m_r


def test_wrappers_reject_bad_input():
    curve = TH.BN254_G1
    kt = R.default_spec(curve.field).kt
    good = JacobianPoint(*(torch.zeros((kt, 4), dtype=torch.int32) for _ in range(3)))
    limbs = JacobianPoint(*(torch.zeros((16, 4), dtype=torch.int32) for _ in range(3)))
    with pytest.raises(ValueError, match="RNS coordinates"):
        RK.rns_add(curve, good, limbs)
    mask = torch.zeros((2, 4), dtype=torch.bool)
    stream = torch.zeros((2, kt, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match=r"\(K, \*E, R\)"):
        RK.hybrid_accumulate_buckets(curve, stream, stream, mask, mask, mask, 8)
    with pytest.raises(ValueError, match="addends"):
        RK.rns_double_add(curve, good, JacobianPoint(*(c[None, :, :2] for c in good)), 3)
    with pytest.raises(ValueError, match="addends"):
        RK.rns_double_add(curve, good, JacobianPoint(*(c[None] for c in good)), -1)
    with pytest.raises(ValueError, match=r"\(K, \*E, R\)"):
        RK.rns_accumulate_columns(curve, stream, stream, mask[:1], mask)
    with pytest.raises(ValueError, match="residues"):
        RK.rns_is_zero(curve, torch.zeros((16, 4), dtype=torch.int32))
    empty = JacobianPoint(*(torch.zeros((kt, 0), dtype=torch.int32) for _ in range(3)))
    assert RK.rns_double(curve, empty).x.shape == (kt, 0)


def test_libraries_cover_source_and_header(tmp_path, monkeypatch):
    """One library per curve, one object per kernel; the digest covers
    rns_ops.cuh, and the other headers leave it as it is."""
    for f in B.CSRC.iterdir():
        (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(B, "CSRC", tmp_path)
    lib = RK.library("bn254_g1")
    assert len(lib.units) == len(RK.KERNELS) and lib.headers == ("rns_ops.cuh",)
    assert re.findall(r'#include "([^"]+)"', (tmp_path / lib.source).read_text()) == ["rns_ops.cuh"]
    before = lib.path()
    (tmp_path / "point_ops.cuh").write_text((tmp_path / "point_ops.cuh").read_text() + "\n")
    assert lib.path() == before
    (tmp_path / "rns_ops.cuh").write_text((tmp_path / "rns_ops.cuh").read_text() + "\n")
    assert lib.path() != before != RK.library("bn254_g2").path()
