"""PyTorch port: the fused-backend MSM vs the JAX package.

MSM results are compared after `decode_points` with `msm_host_oracle` (the
JAX package's host big-int MSM) at the shapes of the JAX package's
`TestFoldReduction` (n = 2048, window 9, 16 column steps: R = 128 lanes, so
the fold path runs) and on BN254 G1. The stages of the fold path are held
against the JAX functions called eagerly on TOY (their kernels in Pallas
interpret mode): the run ends (`_run_end_slots` here, `_run_ends_compact`
there) and `_bucket_sums_fused` (one column launch over all windows here,
one per window there) bit for bit;
`_fold_trailing_fused` (whose compact run ends are scattered into the JAX
function's dense bucket arrays here), the bucket merge and
`_weighted_fold_fused` after `decode_points`, because the port's fold
kernel is a segmented scan that adds in another order, and bit for bit with
the scan cut to one thread per lane (the JAX kernel's sequential order).
No backend's MSM writes a column stream: every kernel backend takes its
bucket column. Off the fold path the fused MSM runs Horner's rule and the
weighted reductions' doubling runs as chain calls (`FusedCurveOps.double_add`),
held against the JAX package's fused MSM after `decode_points`. Inputs come
from numpy seeds; tolerance: none
(exact integer arithmetic). Everything runs on CPU tensors (the plain
versions).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from manta_tpu.ops import curve as JC
from manta_tpu.ops import msm as JM
from manta_tpu.ops.pallas import point_kernels as JPK
from manta_tpu.utils import hostmath as JH
from manta_tpu_torch.ops import curve as C
from manta_tpu_torch.ops import field_ops as F
from manta_tpu_torch.ops import msm as M
from manta_tpu_torch.ops.curve import JacobianPoint
from manta_tpu_torch.ops.kernels import point_kernels as PK
from manta_tpu_torch.utils import hostmath as TH

# small tensors: one intra-op thread per test worker is all they use well
torch.set_num_threads(1)


def scalars_np(rng, n, modulus):
    return [int.from_bytes(rng.bytes(48), "little") % modulus for _ in range(n)]


@functools.lru_cache(maxsize=None)
def _multiples(curve_name: str, n: int):
    """(i+1)·G for i < n, by repeated addition."""
    curve = {"toy_g1": JH.TOY_G1, "bn254_g1": JH.BN254_G1}[curve_name]
    out, acc = [], None
    for _ in range(n):
        acc = curve.add(acc, curve.generator)
        out.append(acc)
    return out


def _fused_msm(jcurve, tcurve, points, scalars, window_bits, steps, signed=True, want=None):
    """The port's fused MSM against `want`, by default `msm_host_oracle`."""
    cops = C.curve_ops_for(tcurve, "fused")
    sc = F.as_tensor(F.encode_ints(tcurve.scalar_field, scalars, montgomery=False), "cpu")
    got = M.msm(
        cops, sc, cops.encode_points(points, "cpu"), window_bits, steps,
        tcurve.scalar_field.bits if signed else 0, signed,
    )
    if want is None:
        want = JM.msm_host_oracle(jcurve, scalars, points)
    assert cops.decode_points(got) == [want]


def _toy_points(rng, n):
    """Multiples of G at random indices, one duplicate and one infinity lane."""
    base = _multiples("toy_g1", 4096)
    pts = [base[int(i)] for i in rng.integers(0, len(base), n)]
    pts[3] = pts[2]
    pts[7] = None
    return pts


@pytest.mark.parametrize("signed", [True, False], ids=["signed", "unsigned"])
def test_toy_fold_path_matches_oracle(signed):
    """R = 2048/16 = 128 lanes; M = 256 (signed) or 512 with the phantom
    top bucket (unsigned): the fold path."""
    rng = np.random.default_rng(41 + signed)
    r = JH.TOY_G1.scalar_field.modulus
    _fused_msm(JH.TOY_G1, TH.TOY_G1, _toy_points(rng, 2048), scalars_np(rng, 2048, r), 9, 16, signed)


def test_toy_fold_path_multi_chunk_runs():
    """Few distinct scalars: buckets span many chunks, so both levels of the
    trailing-partial fold carry values."""
    rng = np.random.default_rng(43)
    r = JH.TOY_G1.scalar_field.modulus
    base = scalars_np(rng, 3, r - 1)
    scalars = [base[i % 3] + 1 for i in range(2048)]
    _fused_msm(JH.TOY_G1, TH.TOY_G1, _toy_points(rng, 2048), scalars, 9, 16)


@pytest.mark.parametrize("window_bits,steps,n", [(6, 16, 2048), (5, 7, 200)],
                         ids=["column-kernel", "point-kernels"])
def test_toy_fused_without_fold_path(window_bits, steps, n):
    """M = 32 is not a multiple of 128: no fold path. The column kernel,
    `_fold_partials` (fused additions) and the split-index weighted reduce
    run, with 128 lanes and with 29 (not a multiple of 128: the JAX package
    runs fused mixed additions step by step there)."""
    rng = np.random.default_rng(44 + n)
    r = JH.TOY_G1.scalar_field.modulus
    _fused_msm(JH.TOY_G1, TH.TOY_G1, _toy_points(rng, n), scalars_np(rng, n, r), window_bits, steps)


def test_toy_fused_off_fold_path_runs_chains_and_equals_limb_msm(monkeypatch):
    """Off the fold path (window 5, 7 steps: 29 lanes, M = 16) the fused MSM
    runs Horner's rule and the weighted reductions' two doubling runs as
    three chain calls (`fused_double_add`, through `FusedCurveOps.double_add`)
    and no single-lane doubling; it equals `msm_host_oracle`, and bit for bit
    the limb backend's MSM, which runs the same formulas a double or an add
    at a time (`msm.double_add_loop`, the JAX package's order)."""
    calls = {"chain": 0, "double": 0}

    def chain(*args, _fn=PK.fused_double_add):
        calls["chain"] += 1
        return _fn(*args)

    def point_op(curve, which, *args, _fn=PK._point_op):
        calls["double"] += which == "double"
        return _fn(curve, which, *args)

    monkeypatch.setattr(PK, "fused_double_add", chain)
    monkeypatch.setattr(PK, "_point_op", point_op)
    rng = np.random.default_rng(65)
    r = JH.TOY_G1.scalar_field.modulus
    points, scalars = _toy_points(rng, 200), scalars_np(rng, 200, r)
    sc = F.as_tensor(F.encode_ints(TH.TOY_G1.scalar_field, scalars, montgomery=False), "cpu")
    got = {}
    for backend in ("fused", "limb"):
        cops = C.curve_ops_for(TH.TOY_G1, backend)
        got[backend] = M.msm(cops, sc, cops.encode_points(points, "cpu"), 5, 7,
                             TH.TOY_G1.scalar_field.bits, True)
        if backend == "fused":
            assert calls == {"chain": 3, "double": 0}
    _assert_points_equal(got["fused"], [F.to_numpy(c) for c in got["limb"]])
    assert _TOY.decode_points(got["fused"]) == [JM.msm_host_oracle(JH.TOY_G1, scalars, points)]


def test_toy_fold_path_runs_the_fold_and_combine_kernels(monkeypatch):
    """The fold path reaches the fused backend's fold (4 calls: two levels
    of trailing partials, two of the weighted sum) and combine (1 call)
    functions, which run their plain versions on CPU tensors, and the MSM
    equals `msm_host_oracle`."""
    calls = {"fold": 0, "combine": 0}
    for name, key in (("fold_columns", "fold"), ("combine_windows", "combine")):
        def counted(*args, _fn=getattr(PK, name), _key=key):
            calls[_key] += 1
            return _fn(*args)

        monkeypatch.setattr(PK, name, counted)
    rng = np.random.default_rng(42)
    r = JH.TOY_G1.scalar_field.modulus
    _fused_msm(JH.TOY_G1, TH.TOY_G1, _toy_points(rng, 2048), scalars_np(rng, 2048, r), 9, 16)
    assert calls == {"fold": 4, "combine": 1}


def test_toy_fold_path_runs_bucket_column_and_merge_once(monkeypatch):
    """The fold path accumulates its buckets with one bucket-column call and
    adds the trailing partials with one merge call, and calls no point-op
    formula: the launches an MSM on the card (1 + 1, where the dense merge
    took 2 point-op adds)."""
    calls = {"accumulate_buckets": 0, "merge_buckets": 0, "_point_op": 0}
    for name in calls:
        def counted(*args, _fn=getattr(PK, name), _name=name):
            calls[_name] += 1
            return _fn(*args)

        monkeypatch.setattr(PK, name, counted)
    rng = np.random.default_rng(48)
    r = JH.TOY_G1.scalar_field.modulus
    _fused_msm(JH.TOY_G1, TH.TOY_G1, _toy_points(rng, 2048), scalars_np(rng, 2048, r), 9, 16)
    assert calls == {"accumulate_buckets": 1, "merge_buckets": 1, "_point_op": 0}


@pytest.mark.parametrize("backend", ["fused", "rns_fused", "rns_hybrid"])
def test_column_stream_path_only_on_rns_backends(backend, monkeypatch):
    """Every kernel backend's buckets come from its bucket column
    (`_column_run_ends`, one call): the stream path (`_column_stream`) and
    the backends' stream columns (`run_columns`) are gone; all three give
    the same buckets."""
    assert not hasattr(M, "_column_stream")
    calls = {"_column_run_ends": 0}

    def counted(*args, _fn=M._column_run_ends):
        calls["_column_run_ends"] += 1
        return _fn(*args)

    monkeypatch.setattr(M, "_column_run_ends", counted)
    rng = np.random.default_rng(62)
    curve = TH.BN254_G1
    num_windows, n, steps, nb = 2, 48, 8, 9
    digits = torch.from_numpy(np.sort(rng.integers(0, nb, (num_windows, n)), axis=-1))
    pts = list(_multiples("bn254_g1", n))
    pts[5] = None
    cops = C.curve_ops_for(curve, backend)
    assert not hasattr(cops, "run_columns")
    got = M._bucket_sums(cops, digits, cops.encode_points(pts, "cpu"), nb, steps)
    assert calls == {"_column_run_ends": 1}
    flat = JacobianPoint(*(c.reshape(*c.shape[:-2], -1) for c in got))
    for w in range(num_windows):
        for b in range(nb):
            members = [p for p, d in zip(pts, digits[w].tolist()) if d == b]
            acc = None
            for p in members:
                acc = JH.BN254_G1.add(acc, p)
            assert cops.decode_points(JacobianPoint(*(c[..., w * nb + b : w * nb + b + 1]
                                                      for c in flat))) == [acc]


def test_bn254_g1_fold_path_matches_closed_form():
    """Points (i+1)·G, as `bench.py` checks: the MSM is (sum (i+1)·s_i)·G,
    one host scalar multiplication instead of the oracle's 2048."""
    rng = np.random.default_rng(45)
    curve = JH.BN254_G1
    r = curve.scalar_field.modulus
    points = list(_multiples("bn254_g1", 2048))
    points[11] = None
    scalars = scalars_np(rng, 2046, r) + [0, r - 1]
    k = sum((i + 1) * s for i, s in enumerate(scalars) if points[i] is not None) % r
    _fused_msm(curve, TH.BN254_G1, points, scalars, 9, 16,
               want=curve.scalar_mul(k, curve.generator))


# ---------------------------------------------------------------------------
# The fold stages against the JAX functions, bit for bit
# ---------------------------------------------------------------------------


def _toy_jacobian(rng, shape):
    """Jacobian TOY points (Z != 1) of batch `shape`, a few at infinity, as
    (numpy uint32 coords, port tensors)."""
    n = int(np.prod(shape))
    base = _multiples("toy_g1", 4096)
    pts = [None if rng.random() < 0.05 else base[int(i)] for i in rng.integers(0, 4096, n)]
    cops = C.curve_ops_for(TH.TOY_G1, "limb")
    jac = cops.double(cops.encode_points(pts, "cpu"))
    arrs = [F.to_numpy(c).reshape(-1, *shape) for c in jac]
    return arrs, JacobianPoint(*(F.as_tensor(a, "cpu") for a in arrs))


def _assert_points_equal(got: JacobianPoint, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(F.to_numpy(g), np.asarray(w))


_TOY = C.curve_ops_for(TH.TOY_G1, "limb")


def _assert_decoded_equal(got: JacobianPoint, want):
    """Equal points after `decode_points`, lane by lane over any batch."""
    def flat(pt):
        return JacobianPoint(*(c.reshape(c.shape[0], -1) for c in pt))

    want = JacobianPoint(*(F.as_tensor(np.array(w), "cpu") for w in want))
    assert _TOY.decode_points(flat(got)) == _TOY.decode_points(flat(want))


def _sequential_fold(monkeypatch):
    """Cut the fold's scan to one thread per lane: the JAX kernel's order."""
    monkeypatch.setattr(PK, "fold_threads", lambda steps: 1)


def _dense(level, num_windows: int, num_buckets: int) -> JacobianPoint:
    """A level's compact run ends (values (*E, n), slots (n,)) scattered into
    an infinity bucket array (*E, W, num_buckets), as the JAX function
    returns them."""
    vals, slots = level
    out = PK._infinity(TH.TOY_G1, num_windows * num_buckets, "cpu")
    live = slots >= 0
    for o, v in zip(out, vals):
        o[..., slots[live]] = v[..., live]
    return JacobianPoint(*(c.reshape(*c.shape[:-1], num_windows, num_buckets) for c in out))


def _toy_trailing(rng, num_windows, lanes, num_buckets):
    """Trailing accumulators and digits with long runs: partials continue
    across chunks and lanes. Returns (numpy coords, port acc, last, first)."""
    arrs, acc = _toy_jacobian(rng, (num_windows, lanes))
    d = np.sort(rng.integers(0, num_buckets, (num_windows, 2 * lanes)), axis=-1)
    d[1, :300] = 7  # one bucket over many chunks
    return arrs, acc, d[:, 1::2], d[:, 0::2]


@pytest.mark.parametrize("threads", ["scan", "sequential"])
def test_fold_trailing_fused_equal_to_jax_after_decode(threads, monkeypatch):
    """W = 2 windows of R = 256 lanes (two chunks per level-1 lane), digits
    with long runs so that partials continue across chunks and lanes. The
    level-2 fold (K = 128) scans 32 threads a lane: equal points; cut to one
    thread, bit for bit."""
    rng = np.random.default_rng(46)
    num_windows, lanes, num_buckets = 2, 256, 129
    arrs, acc, last, first = _toy_trailing(rng, num_windows, lanes, num_buckets)
    if threads == "sequential":
        _sequential_fold(monkeypatch)
    got = M._fold_trailing_fused(
        C.curve_ops_for(TH.TOY_G1, "fused"), acc,
        torch.from_numpy(last), torch.from_numpy(first), num_buckets,
    )
    jops = JPK.fused_curve_ops_for(JH.TOY_G1)
    want = JM._fold_trailing_fused(
        jops, JC.JacobianPoint(*map(jnp.asarray, arrs)),
        jnp.asarray(last.astype(np.uint32)), jnp.asarray(first.astype(np.uint32)), num_buckets,
    )
    for g, w in zip(got, want):
        g = _dense(g, num_windows, num_buckets)
        _assert_decoded_equal(g, w)
        if threads == "sequential":
            _assert_points_equal(g, w)


@pytest.mark.parametrize("threads", ["scan", "sequential"])
def test_merge_buckets_equal_to_jax_dense_merge_after_decode(threads, monkeypatch):
    """The fold path's bucket merge: run-end buckets plus both levels of
    trailing partials, by the port's merge on the compact run ends against
    the JAX package's two dense fused additions over its `_fold_trailing_fused`
    arrays (its point-op kernel in interpret mode): equal points; with the
    scan cut to one thread a lane, bit for bit."""
    rng = np.random.default_rng(63)
    num_windows, lanes, num_buckets = 2, 256, 129
    arrs, acc, last, first = _toy_trailing(rng, num_windows, lanes, num_buckets)
    b_arrs, bucket_a = _toy_jacobian(rng, (num_windows, num_buckets))
    if threads == "sequential":
        _sequential_fold(monkeypatch)
    cops = C.curve_ops_for(TH.TOY_G1, "fused")
    (v1, k1), (v2, k2) = M._fold_trailing_fused(
        cops, acc, torch.from_numpy(last), torch.from_numpy(first), num_buckets)
    flat = JacobianPoint(*(c.reshape(c.shape[0], -1) for c in bucket_a))
    got = cops.merge_buckets(flat, v1, k1, v2, k2)
    jops = JPK.fused_curve_ops_for(JH.TOY_G1)
    jb1, jb2 = JM._fold_trailing_fused(
        jops, JC.JacobianPoint(*map(jnp.asarray, arrs)),
        jnp.asarray(last.astype(np.uint32)), jnp.asarray(first.astype(np.uint32)), num_buckets,
    )
    ja = JC.JacobianPoint(*map(jnp.asarray, b_arrs))
    want = [np.asarray(c).reshape(c.shape[0], -1) for c in jops.add(jops.add(ja, jb1), jb2)]
    _assert_decoded_equal(got, want)
    if threads == "sequential":
        _assert_points_equal(got, want)


@pytest.mark.parametrize("threads", ["scan", "sequential"])
@pytest.mark.parametrize("signed", [True, False], ids=["signed", "unsigned"])
def test_weighted_fold_fused_equal_to_jax_after_decode(signed, threads, monkeypatch):
    """M = 256 covered buckets: Kw = 2 buckets per lane (one doubling);
    unsigned adds the phantom top bucket. The port's function stops at the
    level-2 rows; `window_sums` gives the JAX function's window sums. Equal
    points; cut to one thread per lane, bit for bit."""
    rng = np.random.default_rng(47 + signed)
    num_windows = 2
    num_buckets = 257 if signed else 256
    arrs, buckets = _toy_jacobian(rng, (num_windows, num_buckets))
    if threads == "sequential":
        _sequential_fold(monkeypatch)
    cops = C.curve_ops_for(TH.TOY_G1, "fused")
    got = M.window_sums(cops, *M._weighted_fold_fused(cops, buckets, num_buckets, signed))
    want = JM._weighted_fold_fused(
        JPK.fused_curve_ops_for(JH.TOY_G1), JC.JacobianPoint(*map(jnp.asarray, arrs)),
        num_buckets, signed,
    )
    _assert_decoded_equal(got, want)
    if threads == "sequential":
        _assert_points_equal(got, want)


def test_run_ends_compact_matches_jax():
    """Run ends of three windows' sorted digits in the chunk-transposed
    stream order: the slots the bucket columns write (`_run_end_slots`, all
    windows at once) are the run ends that the JAX function locates window
    by window, each naming its bucket w·num_buckets + digit."""
    rng = np.random.default_rng(49)
    num_buckets = 20
    digits = rng.integers(0, num_buckets, (3, 64))
    digits[2] = 5  # one run
    steps, lanes = 4, 16
    _, d_t, _, end = M._sorted_layout(torch.from_numpy(digits), steps)
    slot = M._run_end_slots(d_t, end, num_buckets).reshape(steps, 3, lanes)
    d_flat = d_t.permute(1, 0, 2).reshape(3, -1)
    end_flat = end.permute(1, 0, 2).reshape(3, -1)
    for w in range(3):
        jp, ji = JM._run_ends_compact(
            jnp.asarray(d_flat[w].numpy().astype(np.int32)), jnp.asarray(end_flat[w].numpy()),
            num_buckets,
        )
        jp, ji = np.asarray(jp), np.asarray(ji)
        want = np.full(steps * lanes, -1)  # stream order k·R + j
        live = ji < num_buckets
        want[jp[live]] = w * num_buckets + ji[live]
        np.testing.assert_array_equal(slot[:, w].reshape(-1).numpy(), want)


def test_bucket_sums_fused_bit_equal_to_jax_per_window():
    """One column launch over both windows' lanes gives each window the
    buckets, trailing accumulators and digit layout that the JAX package's
    per-window `_bucket_sums_fused` gives it (its column kernel in Pallas
    interpret mode): n = 2048, window 9, 16 steps, signed digits."""
    rng = np.random.default_rng(50)
    curve = JH.TOY_G1
    r = curve.scalar_field.modulus
    scalars = scalars_np(rng, 2048, r)
    points = _toy_points(rng, 2048)
    num_buckets = (1 << 8) + 1
    cops = C.curve_ops_for(TH.TOY_G1, "fused")
    sc = F.encode_ints(curve.scalar_field, scalars, montgomery=False)
    enc = cops.encode_points(points, "cpu")
    digits, negs, _ = M.window_digits_signed(F.as_tensor(sc, "cpu"), 9, curve.scalar_field.bits)
    got_b, got_acc, got_d = M._bucket_sums_fused(
        cops, digits, enc, num_buckets, 16, negs, parts=True
    )
    jops = JPK.fused_curve_ops_for(curve)
    jpts = JC.JacobianPoint(*(jnp.asarray(F.to_numpy(c)) for c in enc))
    j_digits, j_negs, _ = JM.window_digits_signed(jnp.asarray(sc), 9, curve.scalar_field.bits)
    y_neg = jops.ops.neg(jpts.y)
    for w in range(digits.shape[0]):
        pts_w = JC.JacobianPoint(jpts.x, jops.ops.select(j_negs[w], y_neg, jpts.y), jpts.z)
        want_b, want_acc, want_d = JM._bucket_sums_fused(
            jops, j_digits[w], pts_w, num_buckets, 16, parts=True
        )
        _assert_points_equal(JacobianPoint(*(c[..., w, :] for c in got_b)), want_b)
        _assert_points_equal(JacobianPoint(*(c[..., w, :] for c in got_acc)), want_acc)
        np.testing.assert_array_equal(got_d[:, w].numpy(), np.asarray(want_d))
