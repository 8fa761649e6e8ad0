"""PyTorch port: the fused curve kernels' plain versions vs the JAX package.

`ops/kernels/point_kernels.py` holds the CUDA point-op, bucket-column,
fold, combine, merge and chain kernels and their plain versions; on CPU
tensors the public functions take the plain versions. They are held here, bit for bit on
the raw limb arrays, against the JAX package's Pallas kernels (`manta_tpu/
ops/pallas/point_kernels.py`) in interpret mode on the TOY curve (the bucket
column against the JAX column kernel followed by the JAX MSM's run-end
pick), against the port's limb `CurveOps` on BN254 and BLS12-381 G1/G2 (the
merge against the dense additions it replaces), and, after `decode_points`,
against `hostmath`. The fold is a segmented scan that adds
in another order than the JAX kernel: its points are held after
`decode_points` against the JAX kernel and the sequential fold, and with one
thread per lane (the sequential order) bit for bit. Inputs come from numpy
seeds and include the edge lanes P+P, P+(−P), P+∞, ∞+Q and ∞+∞.
Tolerance: none (exact integers).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as CS
from manta_tpu.ops import msm as JM
from manta_tpu.ops.curve import JacobianPoint as JPoint
from manta_tpu.ops.pallas import point_kernels as JPK
from manta_tpu.utils import hostmath as JH
from manta_tpu_torch.ops import curve as C
from manta_tpu_torch.ops import field_ops as F
from manta_tpu_torch.ops import msm as M
from manta_tpu_torch.ops.curve import JacobianPoint
from manta_tpu_torch.ops.kernels import build as B
from manta_tpu_torch.ops.kernels import point_kernels as PK
from manta_tpu_torch.utils import hostmath as TH

# small tensors: one intra-op thread per test worker is all they use well
torch.set_num_threads(1)

CURVES = {
    "bn254_g1": (JH.BN254_G1, TH.BN254_G1),
    "bn254_g2": (JH.BN254_G2, TH.BN254_G2),
    "bls12_381_g1": (JH.BLS12_381_G1, TH.BLS12_381_G1),
    "bls12_381_g2": (JH.BLS12_381_G2, TH.BLS12_381_G2),
}


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


def _tensors(arrs):
    return JacobianPoint(*(F.as_tensor(a, "cpu") for a in arrs))


def _numpy(pt):
    return [F.to_numpy(c) for c in pt]


def _assert_equal(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(F.to_numpy(g), np.asarray(w))


# ---------------------------------------------------------------------------
# TOY: the plain versions against the JAX package's interpret-mode kernels
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=1)
def _toy_operands():
    """Jacobian P (Z != 1), affine Q and Jacobian 2Q over 100 lanes with the
    edge lanes, as numpy uint32 coordinates."""
    rng = np.random.default_rng(51)
    curve = JH.TOY_G1
    ps, qs = edge_pairs(curve, rng, 100)
    limb = C.curve_ops_for(TH.TOY_G1, "limb")
    p = limb.double(limb.encode_points(ps, "cpu"))
    q = limb.encode_points(qs, "cpu")
    return _numpy(p), _numpy(q), _numpy(limb.double(q))


@pytest.mark.parametrize("which", ["add", "madd", "double"])
def test_toy_point_ops_equal_jax_kernels(which):
    p, q_aff, q_jac = _toy_operands()
    q = q_aff if which == "madd" else q_jac
    tp, tq = _tensors(p), _tensors(q)
    jp, jq = JPoint(*map(jnp.asarray, p)), JPoint(*map(jnp.asarray, q))
    if which == "double":
        got, want = PK.fused_double(TH.TOY_G1, tp), JPK.fused_double(JH.TOY_G1, jp)
    else:
        got = getattr(PK, f"fused_{which}")(TH.TOY_G1, tp, tq)
        want = getattr(JPK, f"fused_{which}")(JH.TOY_G1, jp, jq)
    _assert_equal(got, want)


def _toy_stream(rng, K, R, jacobian):
    """(K, L, R) TOY coordinates of random points, numpy uint32."""
    limb = C.curve_ops_for(TH.TOY_G1, "limb")
    pts = limb.encode_points(host_points(JH.TOY_G1, rng, K * R, 0.0), "cpu")
    if jacobian:
        pts = limb.double(pts)
    return [F.to_numpy(c).reshape(-1, R, K).transpose(2, 0, 1).copy() for c in pts]


def _masks(rng, K, R):
    """Random head / qinf masks (K, R) plus an all-head row and an all-qinf column."""
    head = rng.random((K, R)) < 0.3
    qinf = rng.random((K, R)) < 0.1
    head[3] = True
    qinf[:, 5] = True
    return head, qinf


def test_toy_accumulate_columns_equal_jax_kernel():
    """The JAX column kernel's twin (the stream the bucket column picks its
    run ends from)."""
    rng = np.random.default_rng(52)
    K, R = 8, 128
    px, py, _ = _toy_stream(rng, K, R, jacobian=False)
    head, qinf = _masks(rng, K, R)
    got = PK.plain_accumulate_columns(
        TH.TOY_G1, F.as_tensor(px, "cpu"), F.as_tensor(py, "cpu"),
        torch.from_numpy(qinf), torch.from_numpy(head),
    )
    want = JPK.accumulate_columns(
        JH.TOY_G1, jnp.asarray(px), jnp.asarray(py), jnp.asarray(qinf), jnp.asarray(head)
    )
    _assert_equal(got, want)


def test_toy_accumulate_buckets_equal_jax_column_and_pick():
    """The bucket column's plain version (and the CPU path of
    `accumulate_buckets`) against the JAX package's column kernel in
    interpret mode, one call per window on its 128 lanes, followed by the
    JAX MSM's run-end pick (`_run_ends_compact`, then each run end's value
    written to its bucket): bit-equal buckets and last accumulators, on the
    edge streams of `chip_smoke.bucket_stream` (q, -q lanes, a repeated
    point, one digit over whole lanes, runs ending on a chunk's first and
    last step, empty buckets, a lane at infinity)."""
    rng = np.random.default_rng(60)
    K, W, R, nb = 8, 2, 128, 257
    limb = C.curve_ops_for(TH.TOY_G1, "limb")
    px, py, qinf, head, slot, num_slots = CS.bucket_stream(TH.TOY_G1, limb, rng, K, W, R, nb,
                                                           "cpu")
    got_b, got_a = PK.accumulate_buckets(TH.TOY_G1, px, py, qinf, head, slot, num_slots)
    plain_b, plain_a = PK.plain_accumulate_buckets(TH.TOY_G1, px, py, qinf, head, slot, num_slots)
    _assert_equal(got_b, _numpy(plain_b))
    _assert_equal(got_a, _numpy(plain_a))
    inf = [F.to_numpy(c) for c in PK._infinity(TH.TOY_G1, nb, "cpu")]
    d_t = (slot.numpy().reshape(K, W, R) - np.arange(W)[:, None] * nb)
    for w in range(W):
        lanes = slice(w * R, (w + 1) * R)
        stream = JPK.accumulate_columns(
            JH.TOY_G1, *(jnp.asarray(F.to_numpy(c)[..., lanes]) for c in (px, py)),
            jnp.asarray(qinf[:, lanes].numpy()), jnp.asarray(head[:, lanes].numpy()))
        end = slot[:, lanes].numpy() >= 0
        # the window's digits at its run ends; the JAX pick needs only those
        digits = np.where(end, d_t[:, w], 0).T.reshape(-1)
        pos, idx = JM._run_ends_compact(jnp.asarray(digits.astype(np.int32)),
                                        jnp.asarray(end.T.reshape(-1)), nb)
        pos, idx = np.asarray(pos), np.asarray(idx)
        for c, gb, ga, ic in zip(stream, got_b, got_a, inf):
            flat = np.asarray(c).transpose(1, 2, 0).reshape(c.shape[1], -1)  # (L, R·K), j·K + k
            want = ic.copy()
            live = idx < nb
            want[..., idx[live]] = flat[..., pos[live]]
            np.testing.assert_array_equal(F.to_numpy(gb)[..., w * nb : (w + 1) * nb], want)
            np.testing.assert_array_equal(F.to_numpy(ga)[..., lanes], np.asarray(c)[-1])


def _decoded_steps(cops, stream):
    """A (K, *E, R) stream -> the affine points of each step."""
    return [cops.decode_points(JacobianPoint(*(c[k] for c in stream)))
            for k in range(stream[0].shape[0])]


def _sequential(monkeypatch, fn, *args):
    """`fn(*args)` with the fold's scan cut to one thread a lane: the
    sequential order of the JAX kernel."""
    with monkeypatch.context() as m:
        m.setattr(PK, "fold_threads", lambda steps: 1)
        return fn(*args)


def test_toy_fold_columns_equal_jax_kernel(monkeypatch):
    """The JAX kernel writes A's and B's streams; the port writes A's stream
    and B's last row. With one thread per lane (the sequential order) they
    are bit-equal; at K = 8 the kernel's scan runs 2 threads per lane, and
    its points equal the JAX kernel's after `decode_points`."""
    rng = np.random.default_rng(53)
    K, R = 8, 128
    q = _toy_stream(rng, K, R, jacobian=True)
    head, _ = _masks(rng, K, R)
    tq = [F.as_tensor(c, "cpu") for c in q]
    want_a, want_b = JPK.fold_columns(JH.TOY_G1, *map(jnp.asarray, q), jnp.asarray(head))
    seq_a, seq_b = _sequential(monkeypatch, PK.plain_fold_columns, TH.TOY_G1, *tq,
                               torch.from_numpy(head), True)
    _assert_equal(seq_a, want_a)
    _assert_equal(seq_b, [np.asarray(c)[-1] for c in want_b])
    assert PK.fold_threads(K) == 2
    got_a, got_b = PK.fold_columns(TH.TOY_G1, *tq, torch.from_numpy(head), True)
    limb = C.curve_ops_for(TH.TOY_G1, "limb")
    jax_a = JacobianPoint(*(F.as_tensor(np.array(c), "cpu") for c in want_a))
    assert _decoded_steps(limb, got_a) == _decoded_steps(limb, jax_a)
    assert limb.decode_points(got_b) == limb.decode_points(
        JacobianPoint(*(F.as_tensor(np.array(c)[-1], "cpu") for c in want_b)))
    no_b_a, no_b = PK.fold_columns(TH.TOY_G1, *tq, torch.from_numpy(head))
    assert no_b is None
    _assert_equal(no_b_a, _numpy(got_a))


# ---------------------------------------------------------------------------
# The four production curves: the limb formulas and hostmath
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(CURVES))
def test_fused_point_ops_equal_limb_curve_ops_and_hostmath(name):
    jcurve, tcurve = CURVES[name]
    rng = np.random.default_rng(54)
    ps, qs = edge_pairs(jcurve, rng, 12)
    limb = C.curve_ops_for(tcurve, "limb")
    fused = C.curve_ops_for(tcurve, "fused")
    assert isinstance(fused, PK.FusedCurveOps) and fused.backend == "fused"
    pa, qa = limb.encode_points(ps, "cpu"), limb.encode_points(qs, "cpu")
    p2, q2 = limb.double(pa), limb.double(qa)
    cases = [
        ("add", (p2, q2), [jcurve.add(jcurve.double(a), jcurve.double(b)) for a, b in zip(ps, qs)]),
        ("add", (pa, pa), [jcurve.double(a) for a in ps]),
        ("madd", (p2, qa), [jcurve.add(jcurve.double(a), b) for a, b in zip(ps, qs)]),
        ("madd", (pa, pa), [jcurve.double(a) for a in ps]),
        ("double", (p2,), [jcurve.double(jcurve.double(a)) for a in ps]),
    ]
    for which, args, want in cases:
        got = getattr(fused, which)(*args)
        _assert_equal(got, _numpy(getattr(limb, which)(*args)))
        assert fused.decode_points(got) == want, which


@pytest.mark.parametrize("name", ["bn254_g1", "bls12_381_g2"])
def test_plain_columns_and_fold_match_hostmath(name):
    """Every step of the column and fold streams, decoded, against running
    sums on the host."""
    jcurve, tcurve = CURVES[name]
    rng = np.random.default_rng(55)
    K, R = 9, 6  # the fold scans 2 chunks a lane
    pts = host_points(jcurve, rng, K * R)
    head, _ = _masks(rng, K, R)
    limb = C.curve_ops_for(tcurve, "limb")
    enc = limb.encode_points(pts, "cpu")

    def stream(c):  # lane j's chunk is points [j*K, (j+1)*K)
        return c.reshape(*c.shape[:-1], R, K).movedim(-1, 0).contiguous()

    qinf = np.array([[pts[j * K + k] is None for j in range(R)] for k in range(K)])
    cols = PK.plain_accumulate_columns(tcurve, stream(enc.x), stream(enc.y),
                                 torch.from_numpy(qinf), torch.from_numpy(head))
    fa, fb = PK.fold_columns(tcurve, *(stream(c) for c in limb.double(enc)),
                             torch.from_numpy(head), True)
    for j in range(R):
        acc = a = b = None
        for k in range(K):
            q = pts[j * K + k]
            acc = q if head[k, j] else jcurve.add(acc, q)
            a = jcurve.double(q) if head[k, j] else jcurve.add(a, jcurve.double(q))
            b = jcurve.add(b, a)
            lane = (k, ..., j)
            for got, want in ((cols, acc), (fa, a)):
                assert limb.decode_points(JacobianPoint(*(c[lane][..., None] for c in got))) == [want]
        assert limb.decode_points(JacobianPoint(*(c[..., j : j + 1] for c in fb))) == [b]


@pytest.mark.parametrize("name", ["bn254_g1", "bls12_381_g2"])
def test_limb_columns_and_fold_equal_plain(name):
    """The bucket column's loop and the fold's scan over the limb `CurveOps`
    (the reference that `chip_smoke.py` holds the kernels against at the
    prover's shapes) equal the plain versions, edge masks included; the fold
    at K = 37, 4 threads a lane of chunks of 10 steps (the last one 7)."""
    jcurve, tcurve = CURVES[name]
    rng = np.random.default_rng(57)
    K, R = 6, 7
    limb = C.curve_ops_for(tcurve, "limb")
    enc = limb.encode_points(host_points(jcurve, rng, K * R), "cpu")
    head, qinf = _masks(rng, K, R)
    head, qinf = torch.from_numpy(head), torch.from_numpy(qinf)

    def stream(c, k):
        return c.reshape(*c.shape[:-1], R, k).movedim(-1, 0).contiguous()

    px, py = stream(enc.x, K), stream(enc.y, K)
    slot = torch.full((K, R), -1, dtype=torch.int32)  # 20 run ends, each its own bucket
    slot.view(-1)[torch.from_numpy(rng.choice(K * R, 20, replace=False))] = torch.arange(
        20, dtype=torch.int32)
    for got, want in zip(PK.limb_accumulate_buckets(tcurve, px, py, qinf, head, slot, 20),
                         PK.plain_accumulate_buckets(tcurve, px, py, qinf, head, slot, 20)):
        _assert_equal(got, _numpy(want))
    K = 37
    enc = limb.encode_points(host_points(jcurve, rng, K * R), "cpu")
    q = [stream(c, K) for c in limb.double(enc)]
    head = torch.from_numpy(_masks(rng, K, R)[0])
    for sums in (False, True):
        got_a, got_b = PK.limb_fold_columns(tcurve, *q, head, sums)
        want_a, want_b = PK.plain_fold_columns(tcurve, *q, head, sums)
        _assert_equal(got_a, _numpy(want_a))
        if sums:
            _assert_equal(got_b, _numpy(want_b))
        else:
            assert got_b is None and want_b is None


def _fold_stream(jcurve, tcurve, rng, K, R):
    """(K, *E, R) Jacobian streams and a (K, R) head mask with the fold's
    edge cases: lane 0 alternates q and −q (inner sums at infinity), lane 1
    repeats one point (inner sums double), lane 2 is all heads, lane 3 has
    none, lane 4 has a head on every chunk's first step and lane 5 on every
    chunk's last step; the other lanes random."""
    pts = host_points(jcurve, rng, K * R, 0.05)
    g = jcurve.generator
    for k in range(K):
        pts[k] = g if k % 2 == 0 else jcurve.neg(g)
        pts[K + k] = pts[K]
    limb = C.curve_ops_for(tcurve, "limb")
    enc = limb.double(limb.encode_points(pts, "cpu"))
    q = [c.reshape(*c.shape[:-1], R, K).movedim(-1, 0).contiguous() for c in enc]
    head = rng.random((K, R)) < 0.2
    chunk = -(-K // PK.fold_threads(K))
    head[:, 2], head[:, 3] = True, False
    head[:, 4] = np.arange(K) % chunk == 0
    head[:, 5] = np.arange(K) % chunk == chunk - 1
    return q, torch.from_numpy(head)


@pytest.mark.parametrize("K", [4, 32, 37, 128])
@pytest.mark.parametrize("name", ["toy_g1", "bn254_g1", "bn254_g2"])
def test_fold_scan_equals_sequential_fold(name, K, monkeypatch):
    """The kernel's scan (1, 8, 4 and 32 threads a lane; 37 is not a
    multiple of its 4 threads) against the sequential fold of the TPU
    kernel (one thread a lane): every step of A and B's last row, after
    `decode_points`."""
    jcurve, tcurve = {"toy_g1": (JH.TOY_G1, TH.TOY_G1), **CURVES}[name]
    rng = np.random.default_rng(58 + K)
    q, head = _fold_stream(jcurve, tcurve, rng, K, 8)
    got_a, got_b = PK.plain_fold_columns(tcurve, *q, head, True)
    want_a, want_b = _sequential(monkeypatch, PK.plain_fold_columns, tcurve, *q, head, True)
    limb = C.curve_ops_for(tcurve, "limb")
    assert _decoded_steps(limb, got_a) == _decoded_steps(limb, want_a)
    assert limb.decode_points(got_b) == limb.decode_points(want_b)
    if PK.fold_threads(K) == 1:
        _assert_equal(got_a, _numpy(want_a))


@pytest.mark.parametrize("name", ["toy_g1", "bn254_g1"])
def test_combine_windows_equals_python_lines(name):
    """The combine's plain version (and the CPU path of `combine_windows`) is
    bit-equal to the window sums and Horner loop of the fold path, written
    out here over the limb `CurveOps`: W = 20 windows of 13 bits, Kw = 32
    (5 doublings), as the production MSMs; rows with infinity lanes."""
    jcurve, tcurve = {"toy_g1": (JH.TOY_G1, TH.TOY_G1), **CURVES}[name]
    rng = np.random.default_rng(59)
    W, doublings, c = 20, 5, 13
    limb = C.curve_ops_for(tcurve, "limb")
    a = limb.double(limb.encode_points(host_points(jcurve, rng, 2 * W), "cpu"))
    b = limb.double(limb.encode_points(host_points(jcurve, rng, 2 * W), "cpu"))

    def lanes(pt, lo, hi):
        return JacobianPoint(*(t[..., lo:hi] for t in pt))

    d = limb.add(lanes(b, 0, W), limb.neg(lanes(a, 0, W)))
    for _ in range(doublings):
        d = limb.double(d)
    sums = limb.add(d, lanes(a, W, 2 * W))
    acc = lanes(sums, W - 1, W)
    for w in range(W - 2, -1, -1):
        for _ in range(c):
            acc = limb.double(acc)
        acc = limb.add(acc, lanes(sums, w, w + 1))
    _assert_equal(PK.plain_combine_windows(tcurve, a, b, doublings, c), _numpy(acc))
    _assert_equal(PK.combine_windows(tcurve, a, b, doublings, c), _numpy(acc))
    _assert_equal(PK.limb_combine_windows(tcurve, a, b, doublings, c), _numpy(acc))
    wins = M.window_sums(limb, a, b, doublings)
    _assert_equal(M.horner(limb, wins, c), _numpy(acc))


@pytest.mark.parametrize("name", ["toy_g1", "bn254_g2"])
@pytest.mark.parametrize("chain", ["horner", "weighted_reduce", "weighted_reduce_signed"])
def test_plain_chain_equal_jax_double_add_sequence(chain, name, monkeypatch):
    """The chain kernel's plain version, reached as the MSM reaches it
    (`FusedCurveOps.double_add`: `msm.horner`, and `fused_double_add` as
    `msm._double_add` calls it), against the formulas run as the JAX
    package's MSM runs them, a double or an add at a time: on TOY G1 the
    JAX package's fused point kernels in interpret mode; on BN254 G2
    (neither package has a TOY G2, and the JAX formulas run eagerly over Fq2
    take minutes) the port's limb `CurveOps`, held against the JAX
    package's in `test_torch_curve_msm.py`. Horner's rule over 4 windows of 2 bits (acc =
    2^c·acc + W_w) with a window at infinity, two equal windows and a window
    equal to 2^c·acc as it meets it (the addition's doubling branch); the
    weighted reductions' runs over 5 lanes, add(2^d·hi, lo) and add(acc,
    2^d·top) (the doubled point second), with a lane at infinity and a lane
    where the two operands are equal. Bit for bit, one chain call each."""
    jcurve, tcurve = {"toy_g1": (JH.TOY_G1, TH.TOY_G1), **CURVES}[name]
    if name == "toy_g1":
        ops = JPK.fused_curve_ops_for(jcurve)
        encode = ops.encode_points
    else:
        ops = C.curve_ops_for(tcurve, "limb")

        def encode(pts):
            return ops.encode_points(pts, "cpu")

    fused = C.curve_ops_for(tcurve, "fused")
    calls = []

    def counted(*args, _fn=PK.fused_double_add):
        calls.append(args[3])
        return _fn(*args)

    monkeypatch.setattr(PK, "fused_double_add", counted)
    g = jcurve.generator
    if chain == "horner":
        c = 2
        top = jcurve.scalar_mul(5, g)
        # W_3 = W_2 = 5·G, W_1 at infinity, W_0 = 400·G = 2^c·acc as it meets acc
        enc = encode([jcurve.scalar_mul(400, g), None, top, top])
        acc = JPoint(*(a[..., 3:] for a in enc))
        for w in (2, 1, 0):
            for _ in range(c):
                acc = ops.double(acc)
            acc = ops.add(acc, JPoint(*(a[..., w : w + 1] for a in enc)))
        got = M.horner(fused, _tensors([np.asarray(a)[..., None] for a in enc]), c)
        _assert_equal(got, acc)
        assert fused.decode_points(got) == [jcurve.scalar_mul(800, g)] and calls == [c]
        return
    d, first = (2, True) if chain == "weighted_reduce" else (3, False)
    rng = np.random.default_rng(64)
    ps, qs = host_points(jcurve, rng, 5, 0.0), host_points(jcurve, rng, 5, 0.0)
    ps[1] = None  # the chain at infinity
    qs[2] = None  # the other operand at infinity
    qs[3] = jcurve.scalar_mul(1 << d, ps[3])  # the operands equal after the doublings
    chain_pt = ops.double(encode(ps))  # Jacobian (Z != 1), as the reductions' inputs
    other = ops.double(encode(qs))
    acc = chain_pt
    for _ in range(d):
        acc = ops.double(acc)
    want = ops.add(acc, other) if first else ops.add(other, acc)
    got = M._double_add(fused, _tensors([np.asarray(a) for a in chain_pt]),
                        _tensors([np.asarray(a)[None] for a in other]), d, first)
    _assert_equal(got, want)
    sums = [jcurve.add(jcurve.scalar_mul(2 << d, p), jcurve.double(q)) for p, q in zip(ps, qs)]
    assert fused.decode_points(got) == sums and calls == [d]


@pytest.mark.parametrize("name", ["toy_g1", "bn254_g1", "bn254_g2"])
def test_merge_buckets_equal_dense_merge(name):
    """The merge's plain version (and the CPU path of `merge_buckets`) is
    bit-equal to the dense merge it replaced, add(add(a, B1), B2) with B1,
    B2 infinity but at their slots, through the limb `CurveOps` and through
    the fused point-op formulas: on `chip_smoke.merge_inputs`' edges (a
    partial -a and a, an infinite partial, buckets at infinity as (0, 1, 0),
    with x kept and with Z = p, one hit by level 2 only, dead keys)."""
    jcurve, tcurve = {"toy_g1": (JH.TOY_G1, TH.TOY_G1), **CURVES}[name]
    rng = np.random.default_rng(61)
    limb = C.curve_ops_for(tcurve, "limb")
    a, v1, k1, v2, k2 = CS.merge_inputs(tcurve, limb, rng, 90, 40, 24, "cpu")
    want = PK.limb_merge_buckets(tcurve, a, v1, k1, v2, k2)
    got = PK.merge_buckets(tcurve, a, v1, k1, v2, k2)
    _assert_equal(got, _numpy(want))
    _assert_equal(PK.plain_merge_buckets(tcurve, a, v1, k1, v2, k2), _numpy(want))
    fused = C.curve_ops_for(tcurve, "fused")

    def dense(v, k):
        out = PK._infinity(tcurve, 90, "cpu")
        for o, c in zip(out, v):
            o[..., k[k >= 0]] = c[..., k >= 0]
        return out

    _assert_equal(fused.add(fused.add(a, dense(v1, k1)), dense(v2, k2)), _numpy(want))
    hit = set(k1[k1 >= 0].tolist()) | set(k2[k2 >= 0].tolist())
    assert 2 in hit and 1 not in hit and 3 not in hit  # the edges are there
    for c, i in zip(got, PK._infinity(tcurve, 90, "cpu")):  # infinity made (0, 1, 0)
        assert torch.equal(c[..., 1:4:2], i[..., 1:4:2])


# ---------------------------------------------------------------------------
# Wrappers and build
# ---------------------------------------------------------------------------


def test_wrappers_reject_bad_input():
    """No fallback: only CPU tensors take the plain version; shapes are checked."""
    limb = C.curve_ops_for(TH.BN254_G1, "limb")
    p = limb.encode_points(host_points(JH.BN254_G1, np.random.default_rng(56), 4), "cpu")
    meta = JacobianPoint(*(c.to("meta") for c in p))
    with pytest.raises(ValueError, match="device"):
        PK.fused_double(TH.BN254_G1, meta)
    with pytest.raises(ValueError, match="different devices"):
        PK.fused_add(TH.BN254_G1, p, meta)
    with pytest.raises(ValueError, match="one shape"):
        PK.fused_add(TH.BN254_G1, p, JacobianPoint(*(c[..., :2] for c in p)))
    stream = p.x.reshape(16, 2, 2).movedim(1, 0).contiguous()  # (K=2, L, R=2)
    ok = torch.zeros(2, 2, dtype=torch.bool)
    for bad in range(3):  # qinf, head, slot: each (K, R)
        masks = [ok, ok, ok.int()]
        masks[bad] = torch.zeros(2, 3, dtype=masks[bad].dtype)
        with pytest.raises(ValueError, match="masks"):
            PK.accumulate_buckets(TH.BN254_G1, stream, stream, *masks, 4)
    with pytest.raises(ValueError, match="2W"):
        PK.combine_windows(TH.BN254_G1, p, JacobianPoint(*(c[..., :2] for c in p)), 1, 13)
    keys = torch.tensor([0, -1])
    two = JacobianPoint(*(c[..., :2] for c in p))
    with pytest.raises(ValueError, match="keys"):  # partials and keys of other lengths
        PK.merge_buckets(TH.BN254_G1, p, two, torch.tensor([0, 1, 2]), two, keys)
    with pytest.raises(ValueError, match="keys"):  # keys of two dimensions
        PK.merge_buckets(TH.BN254_G1, p, two, keys[None], two, keys)
    with pytest.raises(ValueError, match="device"):
        PK.merge_buckets(TH.BN254_G1, meta, JacobianPoint(*(c[..., :2] for c in meta)), keys,
                         JacobianPoint(*(c[..., :2] for c in meta)), keys)
    assert PK.library("bn254_g2").units == tuple(
        ("MANTA_CURVE=1", f"MANTA_KERNEL={k}") for k in range(6))
    # the point op built for another number of threads a lane: the add object alone
    assert PK.library("bn254_g2", 1).units == (
        ("MANTA_CURVE=1", "MANTA_KERNEL=0", "MANTA_POINT_GROUP=1"),)
    assert PK.library("bn254_g2", 1).path() != PK.library("bn254_g2", 4).path()
    with pytest.raises(ValueError, match="point_group"):
        PK.library("bn254_g1", 3)
    with pytest.raises(ValueError, match="addends"):  # addends of another lane count
        PK.fused_double_add(TH.BN254_G1, p, JacobianPoint(*(c[None] for c in two)), 3)
    with pytest.raises(ValueError, match="addends"):  # no doublings below zero
        PK.fused_double_add(TH.BN254_G1, p, JacobianPoint(*(c[None] for c in p)), -1)
    with pytest.raises(ValueError, match="different devices"):
        PK.fused_double_add(TH.BN254_G1, p, JacobianPoint(*(c[None] for c in meta)), 3)


def test_library_digest_covers_sources_and_headers(tmp_path, monkeypatch):
    """A library's file name changes with its source, each header it
    includes, and its defines: an edited header never loads a stale build,
    and a header that a library does not include leaves it as it is."""
    import re

    from manta_tpu_torch.ops.kernels import field_kernels as FK

    for f in B.CSRC.iterdir():
        (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(B, "CSRC", tmp_path)
    lib = PK.library("bn254_g1")
    before, field_before = lib.path(), FK.LIBRARY.path()
    assert before == PK.library("bn254_g1").path() != PK.library("bn254_g2").path()
    assert lib.report_path().parent == before.parent != lib.report_path()
    header = tmp_path / "field_ops.cuh"
    header.write_text(header.read_text() + "\n")
    assert lib.path() != before and FK.LIBRARY.path() != field_before
    before, field_before = lib.path(), FK.LIBRARY.path()
    header = tmp_path / "point_ops.cuh"
    header.write_text(header.read_text() + "\n")
    assert lib.path() != before and FK.LIBRARY.path() == field_before

    def included(name, seen):  # the csrc headers `name` includes, transitively
        for inc in re.findall(r'#include "([^"]+)"', (tmp_path / name).read_text()):
            if inc not in seen:
                seen.add(inc)
                included(inc, seen)
        return seen

    for library in (FK.LIBRARY, lib):
        assert set(library.headers) == included(library.source, set())
