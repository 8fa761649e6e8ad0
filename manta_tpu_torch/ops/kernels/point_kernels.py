"""Whole-formula curve kernels: point op, bucket column, fold, window combine,
bucket merge, chain; CUDA and plain.

Replaces the JAX package's Pallas TPU kernels of
`manta_tpu/ops/pallas/point_kernels.py`: `_point_op` (public `fused_add`,
`fused_madd`, `fused_double`), `_column_call` (`accumulate_buckets`, which
writes the run ends straight into their buckets where the TPU kernel writes
the accumulator after every step) and `_fold_call` (`fold_columns`), with
the backend object `FusedCurveOps` / `fused_curve_ops_for`;
`combine_windows` runs the MSM's window sums and Horner loop on the fold
path, `merge_buckets` its two dense bucket merges, and `fused_double_add`
its chains of doublings and an addition off the fold path (point-op calls in
the JAX package), as one kernel each. The kernel source is
`manta_tpu_torch/csrc/point_kernels.cu` (formulas in `point_ops.cuh`); its
header gives the bound on the H100 and what the design does about it.

Layout at the boundary, as in the JAX package: coordinates limb-major int32,
`(L, ...)` for G1 and `(2, L, ...)` for G2, Montgomery form, lazy [0, 2p);
the column and fold streams `(K, *E, R)` with masks `(K, R)`. Each public
function dispatches on the tensors' device:

- CUDA: one launch of the curve's kernel on the current stream, counted in
  `LAUNCHES`. No fallback: an unsupported curve, dtype or shape raises, and
  so does a failed build or launch.
- CPU: the plain version (`PLAIN`).

The plain versions run the port's own `CurveOps.add / madd / double`
(`ops/curve.py`) — the limb formulas, the same field operations on the same
operands — over a per-lane representation of the coordinates as Python
integers (`_LaneInts`), with the field ops defined as the integers that the
limb functions and the kernel compute: a·b·R⁻¹ mod R by Montgomery without
a final subtract, add and sub against 2p. The column, fold and combine
versions are Python loops of those formulas with `select`: the column's over
K, written from the JAX kernel body (`plain_accumulate_columns`, the JAX
kernel's twin; `plain_accumulate_buckets` picks its run ends), the fold's
the kernel's segmented scan (`_fold_scan`: chunks of a lane's steps, batched
over the chunks), the combine's `msm.window_sums` and `msm.horner`, the
chain's `msm.double_add_loop`, the merge's the two additions on the buckets
a partial hits. Integers per lane
keep the loops cheap on the CPU, where a limb-tensor field op costs about the
same at any small lane count; the CPU tests hold them against the limb
`CurveOps` and the JAX kernels, and `chip_smoke.py` holds the kernels
against them bit for bit. The same loops also run over the limb `CurveOps`
on the tensors' own device (`limb_accumulate_buckets`, `limb_fold_columns`,
`limb_combine_windows`, and `limb_merge_buckets`, the dense merge): on the
card that is the reference at the prover's shapes, where the host integers
are too slow.

The kernels are built at first use with `nvcc`, one shared library per curve
(`build.py`), into `build/torch_kernels/`.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from manta_tpu_torch.fields import LIMB_BITS, FieldSpec
from manta_tpu_torch.ops import curve as C
from manta_tpu_torch.ops import msm as M
from manta_tpu_torch.ops.curve import JacobianPoint
from manta_tpu_torch.ops.kernels import build as B
from manta_tpu_torch.utils import hostmath

#: launches of the CUDA kernels, counted by the wrappers: the point-op kernel
#: by formula, the bucket column, fold, combine, merge and chain kernels
LAUNCHES = {"add": 0, "madd": 0, "double": 0, "buckets": 0, "fold": 0, "combine": 0,
            "merge": 0, "chain": 0}

#: curve name -> the MANTA_CURVE id of `point_kernels.cu`
KERNEL_CURVES = {"bn254_g1": 0, "bn254_g2": 1, "bls12_381_g1": 2, "bls12_381_g2": 3}
#: the MANTA_KERNEL ids of `point_kernels.cu`: one object each (the merge
#: kernel is in the add kernel's, the chain kernel in the combine's)
KERNELS = ("add", "madd", "double", "buckets", "fold", "combine")
#: threads a lane of the point op, 1 (one thread), 2 or 4: the kernel's own
#: choice is 2 for G1 and 1 for G2 (the fastest on the card, `point_kernels.cu`);
#: `library(.., point_group=g)` builds the add object with another, to time
#: the choices
POINT_GROUPS = (1, 2, 4)

SOURCE = B.CSRC / "point_kernels.cu"


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def library(curve_name: str, point_group: int = 0) -> B.Library:
    """The curve's library; with `point_group`, its add object alone, the
    point op built for that many threads a lane."""
    curve = f"MANTA_CURVE={KERNEL_CURVES[curve_name]}"
    if point_group:
        if point_group not in POINT_GROUPS:
            raise ValueError(f"point_group must be one of {POINT_GROUPS}, got {point_group}")
        return B.Library(f"point_kernels-{curve_name}-point_group{point_group}", SOURCE.name,
                         ("field_ops.cuh", "point_ops.cuh"),
                         ((curve, "MANTA_KERNEL=0", f"MANTA_POINT_GROUP={point_group}"),))
    units = tuple((curve, f"MANTA_KERNEL={k}") for k in range(len(KERNELS)))
    return B.Library(f"point_kernels-{curve_name}", SOURCE.name,
                     ("field_ops.cuh", "point_ops.cuh"), units)


LIBRARIES = tuple(library(name) for name in KERNEL_CURVES)


@functools.lru_cache(maxsize=None)
def _lib(curve_name: str, point_group: int = 0) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(B.build([library(curve_name, point_group)])[0]))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    entries = {
        "point_add": [*[ptr] * 9, i64, ptr], "merge_buckets": [*[ptr] * 13, i64, i64, i64, ptr],
        "point_madd": [*[ptr] * 9, i64, ptr], "point_double": [*[ptr] * 9, i64, ptr],
        "accumulate_buckets": [*[ptr] * 11, i32, i64, i64, ptr],
        "fold_columns": [*[ptr] * 10, i32, i64, ptr],
        "combine_windows": [*[ptr] * 9, i32, i32, i32, ptr],
        "double_add": [*[ptr] * 9, i64, i32, i32, i32, ptr],
    }
    for name, argtypes in entries.items():
        if point_group and name not in ("point_add", "merge_buckets"):
            continue  # a point-group library is the add object alone
        fn = getattr(lib, f"manta_{name}")
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return lib


# ---------------------------------------------------------------------------
# Plain versions: CurveOps formulas over per-lane Python integers
# ---------------------------------------------------------------------------


class _LaneInts:
    """Base-field ops on numpy object arrays of Python ints, one per lane:
    the integers of `field_ops` (lazy [0, 2p), Montgomery R = 2^(16·L))."""

    def __init__(self, spec: FieldSpec):
        self.spec = spec
        self.bits = LIMB_BITS * spec.num_limbs
        self.mask = (1 << self.bits) - 1
        self.p = spec.modulus
        self.two_p = 2 * spec.modulus
        self.n_prime = (-pow(spec.modulus, -1, 1 << self.bits)) & self.mask
        self.one = spec.R

    def add(self, a, b):
        s = a + b
        return np.where(s >= self.two_p, (s - self.two_p) & self.mask, s)

    def sub(self, a, b):
        d = a - b
        return np.where(d < 0, (d + self.two_p) & self.mask, d)

    def mul(self, a, b):
        t = a * b
        m = ((t & self.mask) * self.n_prime) & self.mask
        return ((t + m * self.p) >> self.bits) & self.mask

    def sqr(self, a):
        return self.mul(a, a)

    def neg(self, a):
        return self.sub(self.zeros_like(a), a)

    def double(self, a):
        return self.add(a, a)

    def triple(self, a):
        return self.add(self.add(a, a), a)

    def is_zero(self, a):
        return (a == 0) | (a == self.p)

    def select(self, mask, a, b):
        return np.where(mask, a, b)

    def zeros_like(self, a):
        return np.zeros_like(a)

    def one_like(self, a):
        return np.full(a.shape, self.one, dtype=object)


class _LaneInts2:
    """Fq2 ops on (2, ...) object arrays, in the op order of `curve.Fq2Ops`."""

    def __init__(self, spec: FieldSpec):
        self.base = _LaneInts(spec)

    def add(self, a, b):
        return np.stack([self.base.add(a[0], b[0]), self.base.add(a[1], b[1])])

    def sub(self, a, b):
        return np.stack([self.base.sub(a[0], b[0]), self.base.sub(a[1], b[1])])

    def neg(self, a):
        return self.sub(self.zeros_like(a), a)

    def mul(self, a, b):
        o = self.base
        s0, s1 = o.add(a[0], a[1]), o.add(b[0], b[1])
        t0, t1, t2 = o.mul(a[0], b[0]), o.mul(a[1], b[1]), o.mul(s0, s1)
        return np.stack([o.sub(t0, t1), o.sub(o.sub(t2, t0), t1)])

    def sqr(self, a):
        o = self.base
        t = o.mul(o.add(a[0], a[1]), o.sub(a[0], a[1]))
        return np.stack([t, o.double(o.mul(a[0], a[1]))])

    def double(self, a):
        return self.add(a, a)

    def triple(self, a):
        return self.add(self.add(a, a), a)

    def is_zero(self, a):
        return self.base.is_zero(a[0]) & self.base.is_zero(a[1])

    def select(self, mask, a, b):
        return np.where(mask, a, b)

    def zeros_like(self, a):
        return np.zeros_like(a)

    def one_like(self, a):
        return np.stack([self.base.one_like(a[0]), self.base.zeros_like(a[1])])


@dataclasses.dataclass(frozen=True)
class _LaneCurve(C.CurveOps):
    """`CurveOps` whose formulas run over `_LaneInts` coordinates."""

    @functools.cached_property
    def ops(self):
        spec = self.curve.field
        return _LaneInts2(spec) if self.curve.is_ext else _LaneInts(spec)


@functools.lru_cache(maxsize=None)
def _lane_curve(curve: hostmath.WeierstrassCurve) -> _LaneCurve:
    return _LaneCurve(curve, backend="plain")


def _to_ints(t: torch.Tensor, ext: bool) -> np.ndarray:
    """(L, *batch) / (2, L, *batch) limbs -> object array (*batch) / (2, *batch)."""
    a = t.detach().cpu().numpy()
    limb_axis = 1 if ext else 0
    L = a.shape[limb_axis]
    rows = np.ascontiguousarray(np.moveaxis(a, limb_axis, -1).astype("<u2"))
    raw = rows.tobytes()
    w = 2 * L
    out = np.empty(rows.size // L, dtype=object)
    out[:] = [int.from_bytes(raw[i : i + w], "little") for i in range(0, len(raw), w)]
    return out.reshape(rows.shape[:-1])


def _from_ints(v: np.ndarray, L: int, ext: bool, device) -> torch.Tensor:
    raw = b"".join(int(x).to_bytes(2 * L, "little") for x in v.reshape(-1))
    a = np.frombuffer(raw, dtype="<u2").reshape(*v.shape, L)
    a = np.ascontiguousarray(np.moveaxis(a, -1, 1 if ext else 0)).astype(np.int32)
    return torch.from_numpy(a).to(device)


def _point_to_ints(curve, pt: JacobianPoint) -> JacobianPoint:
    return JacobianPoint(*(_to_ints(c, curve.is_ext) for c in pt))


def _point_from_ints(curve, pt: JacobianPoint, device) -> JacobianPoint:
    L = curve.field.num_limbs
    return JacobianPoint(*(_from_ints(c, L, curve.is_ext, device) for c in pt))


def _steps_last(a: torch.Tensor) -> torch.Tensor:
    """(K, *E, R) stream -> (*E, K, R): a coordinate with batch (K, R)."""
    return a.movedim(0, -2)


def _steps_first(a: torch.Tensor) -> torch.Tensor:
    return a.movedim(-2, 0).contiguous()


def _step(v: np.ndarray, k: int) -> np.ndarray:
    return v[..., k, :]


def _stream_from_ints(curve, steps, device) -> JacobianPoint:
    """Per-step points of (R,) lanes -> a (K, *E, R) stream on `device`."""
    stacked = JacobianPoint(*(np.stack([t[i] for t in steps], axis=-2) for i in range(3)))
    return JacobianPoint(*map(_steps_first, _point_from_ints(curve, stacked, device)))


def _stream_from_tensors(steps) -> JacobianPoint:
    return JacobianPoint(*(torch.stack([t[i] for t in steps]) for i in range(3)))


def _column_loop(cops, X, Y, q_inf, heads, step) -> list:
    """The column kernel's loop over `cops`' formulas: per lane, for k < K,
    acc = q[k] if head[k] else madd(acc, q[k]), q = infinity where qinf[k];
    the accumulator after every step (`point_kernels.py:650-669` of the JAX
    package). `step(v, k)` is step k of a coordinate stream."""
    o = cops.ops
    x0 = step(X, 0)
    acc = JacobianPoint(o.zeros_like(x0), o.one_like(x0), o.zeros_like(x0))
    outs = []
    for k in range(len(heads)):
        qx = step(X, k)
        one = o.one_like(qx)
        qz = o.select(q_inf[k], o.zeros_like(qx), one)
        q = JacobianPoint(qx, o.select(q_inf[k], one, step(Y, k)), qz)
        added = cops.madd(acc, q)
        acc = JacobianPoint(*(o.select(heads[k], a, b) for a, b in zip(q, added)))
        outs.append(acc)
    return outs


def fold_threads(steps: int) -> int:
    """Threads that share one lane of the fold kernel for a K-step stream
    (`fold_threads` of point_ops.cuh): a power of two, at most 32, with
    chunks of 4 to 8 steps (one thread where K < 8)."""
    t = 1
    while t < 32 and 8 * t <= steps:
        t *= 2
    return t


def _cat(a, b):
    """a and b joined along the axis of a lane's threads (-2)."""
    if isinstance(a, np.ndarray):
        return np.concatenate([a, b], axis=-2)
    return torch.cat([a, b], dim=-2)


def _shift_up(v, d: int):
    """Thread t gets thread t−d's value, threads t < d their own
    (`__shfl_up_sync`)."""
    return _cat(v[..., :d, :], v[..., :-d, :])


def _chunks(v, threads: int, chunk: int):
    """A stream with its K steps on axis 0 (tensors, (K, *E, R) and masks
    (K, R)) or -2 (integers per lane, (*E, K, R)) -> (*E, chunk, threads,
    R): [..., i, t, :] is step t·chunk + i, zeros past K."""
    if isinstance(v, np.ndarray):
        pad = np.zeros((*v.shape[:-2], threads * chunk - v.shape[-2], v.shape[-1]), v.dtype)
        w = np.concatenate([v, pad], axis=-2)
        return np.swapaxes(w.reshape(*v.shape[:-2], threads, chunk, v.shape[-1]), -3, -2)
    w = torch.cat([v, v.new_zeros((threads * chunk - v.shape[0], *v.shape[1:]))])
    return w.reshape(threads, chunk, *v.shape[1:]).movedim((0, 1), (-2, -3))


def _unchunk(steps: list, K: int):
    """Inverse of `_chunks` on a point coordinate: the list of its steps i
    -> the stream, (K, *E, R) tensors or (*E, K, R) integers."""
    if isinstance(steps[0], np.ndarray):
        w = np.stack(steps, axis=-2)
        return w.reshape(*w.shape[:-3], -1, w.shape[-1])[..., :K, :]
    w = torch.stack(steps, dim=-2)
    return w.reshape(*w.shape[:-3], -1, w.shape[-1])[..., :K, :].movedim(-2, 0).contiguous()


def _fold_scan(cops, Q: JacobianPoint, head, sums: bool):
    """The fold kernel's segmented scan (`fold_group` of point_ops.cuh) over
    `cops`' formulas, batched over the lanes and over the `fold_threads(K)`
    chunks of each lane: the same additions on the same operands, so the
    same coordinates. Per lane, A[k] = q[k] if head[k] else A[k-1] + q[k],
    and with `sums` B = the sum of A[k]. With one thread a lane it is the
    TPU kernel's sequential loop (`point_kernels.py:762-781` of the JAX
    package). Returns (the A stream, B or None)."""
    o = cops.ops
    K = head.shape[0]
    T = fold_threads(K)
    c = -(-K // T)
    X = [_chunks(v, T, c) for v in Q]
    H = _chunks(head, T, c)
    if isinstance(head, np.ndarray):
        t_ids = np.arange(T)[:, None]
    else:
        t_ids = torch.arange(T, device=head.device)[:, None]
    valid = [t_ids * c + i < K for i in range(c)]

    def sel(mask, p, q):
        return JacobianPoint(*(o.select(mask, u, v) for u, v in zip(p, q)))

    def step(i):
        return JacobianPoint(*(v[..., i, :, :] for v in X))

    def walk(a, b):  # a chunk: A = q if head else A + q; B += A
        outs = []
        for i in range(c):
            q = step(i)
            a = sel(valid[i], sel(H[i], q, cops.add(a, q)), a)
            outs.append(a)
            if b is not None:
                b = sel(valid[i], cops.add(b, a), b)
        return a, b, outs

    inf = cops.infinity_like(step(0))
    # 1. each chunk from infinity: (any head, its last A)
    a, _, _ = walk(inf, None)
    f = H[0] != H[0]
    for i in range(c):
        f = f | H[i]
    # 2. inclusive scan of the chunk totals, (f1, P1) o (f2, P2) = (f1 | f2, f2 ? P2 : P1 + P2)
    d = 1
    while d < T:
        later = t_ids >= d
        a = sel(later & ~f, cops.add(JacobianPoint(*(_shift_up(u, d) for u in a)), a), a)
        f = f | (later & _shift_up(f, d))
        d *= 2
    # 3. each chunk again from the total of the chunks before it
    carry = JacobianPoint(*(_shift_up(u, 1) for u in a))
    _, b, outs = walk(sel(t_ids == 0, inf, carry), inf if sums else None)
    # 4. B = the sum of the chunks' sums, pairwise
    while b is not None and b.x.shape[-2] > 1:
        b = cops.add(JacobianPoint(*(u[..., 0::2, :] for u in b)),
                     JacobianPoint(*(u[..., 1::2, :] for u in b)))
    a_stream = JacobianPoint(*(_unchunk([pt[i] for pt in outs], K) for i in range(3)))
    return a_stream, None if b is None else JacobianPoint(*(u[..., 0, :] for u in b))


def plain_point_op(curve, which: str, p: JacobianPoint, q: JacobianPoint = None):
    """add / madd / double of `CurveOps` on (*E, n) coordinates."""
    lc = _lane_curve(curve)
    pi = _point_to_ints(curve, p)
    if which == "double":
        r = lc.double(pi)
    else:
        r = getattr(lc, which)(pi, _point_to_ints(curve, q))
    return _point_from_ints(curve, r, p.x.device)


def plain_accumulate_columns(curve, px, py, qinf, head) -> JacobianPoint:
    """Per lane, for k < K: acc = q[k] if head[k] else madd(acc, q[k]), q =
    infinity where qinf[k]; acc after every step, (K, *E, R) each."""
    X = _to_ints(_steps_last(px), curve.is_ext)
    Y = _to_ints(_steps_last(py), curve.is_ext)
    q_inf = qinf.detach().cpu().numpy() != 0
    heads = head.detach().cpu().numpy() != 0
    outs = _column_loop(_lane_curve(curve), X, Y, q_inf, heads, _step)
    return _stream_from_ints(curve, outs, px.device)


def _infinity(curve, lanes: int, device) -> JacobianPoint:
    """The backend's infinity (0, 1, 0), (*E, lanes) coordinates of their own."""
    z = torch.zeros((*_edims(curve), lanes), dtype=torch.int32, device=device)
    return JacobianPoint(*(c.contiguous() for c in fused_curve_ops_for(curve).infinity_like(
        JacobianPoint(z, z, z))))


def _pick_run_ends(curve, stream: JacobianPoint, slot, num_slots: int):
    """The column's stream (K, *E, R) -> (buckets (*E, num_slots): infinity
    where no slot names them, else the stream's value at the step and lane
    whose slot it is; the last step (*E, R))."""
    s = slot.reshape(-1).long()
    live = s >= 0
    buckets = _infinity(curve, num_slots, stream.x.device)
    for b, c in zip(buckets, stream):
        flat = c.movedim(0, -2).reshape(*c.shape[1:-1], -1)
        b[..., s[live]] = flat[..., live]
    return buckets, JacobianPoint(*(c[-1].clone() for c in stream))


def plain_accumulate_buckets(curve, px, py, qinf, head, slot, num_slots: int):
    """`plain_accumulate_columns`, then its value at each step and lane with
    slot >= 0 written to bucket slot of an infinity array (*E, num_slots);
    returns (the buckets, the last step's accumulator (*E, R))."""
    stream = plain_accumulate_columns(curve, px, py, qinf, head)
    return _pick_run_ends(curve, stream, slot, num_slots)


def plain_fold_columns(curve, qx, qy, qz, head, sums: bool = False):
    """Per lane: A = q[k] if head[k] else add(A, q[k]), the stream (K, *E, R);
    with `sums`, B = the sum of the A[k], (*E, R). The additions of the
    kernel's scan (`_fold_scan`). Returns (A, B or None)."""
    Q = JacobianPoint(*(_to_ints(_steps_last(c), curve.is_ext) for c in (qx, qy, qz)))
    heads = head.detach().cpu().numpy() != 0
    a, b = _fold_scan(_lane_curve(curve), Q, heads, sums)
    a = JacobianPoint(*map(_steps_first, _point_from_ints(curve, a, qx.device)))
    return a, None if b is None else _point_from_ints(curve, b, qx.device)


def plain_combine_windows(curve, a, b, doublings: int, window_bits: int) -> JacobianPoint:
    """The MSM's window combine (`msm.window_sums`, then `msm.horner`) on the
    weighted fold's level-2 rows a, b (*E, 2W): one lane, (*E, 1)."""
    lc = _lane_curve(curve)
    sums = M.window_sums(lc, _point_to_ints(curve, a), _point_to_ints(curve, b), doublings)
    return _point_from_ints(curve, M.horner(lc, sums, window_bits), a.x.device)


def plain_fused_double_add(curve, init, addends, doublings: int, chain_first: bool = True):
    """The chain kernel's work, over per-lane integers: the MSM's Python
    lines it replaces (`msm.double_add_loop`) on init (*E, n) and addends
    (S, *E, n); returns (*E, n)."""
    ws = JacobianPoint(*(np.array([_to_ints(w, curve.is_ext) for w in c], dtype=object)
                         for c in addends))  # (S, *E, n) -> (S, [2,] n) integers
    acc = M.double_add_loop(_lane_curve(curve), _point_to_ints(curve, init), ws, doublings,
                            chain_first)
    return _point_from_ints(curve, acc, init.x.device)


def _inverse_index(key, num_slots: int) -> torch.Tensor:
    """(num_slots,) int32: the entry of `key` (n,) that names each slot, or
    -1 (a key of -1 names none; the keys >= 0 are unique)."""
    k = key.long()
    idx = torch.where(k >= 0, k, num_slots)
    entries = torch.arange(k.numel(), dtype=torch.int32, device=k.device)
    inv = torch.full((num_slots + 1,), -1, dtype=torch.int32, device=k.device)
    return inv.scatter_(0, idx, entries)[:num_slots]


def plain_merge_buckets(curve, buckets, v1, key1, v2, key2) -> JacobianPoint:
    """The merge kernel's work, over per-lane integers: the buckets that a
    partial hits become add(add(a, b1), b2) (a missing partial is
    infinity); the others stay, but an infinity among them becomes the
    backend's (0, 1, 0). That is the dense add(add(a, B1), B2), B1 and B2
    infinity except at their keys (`limb_merge_buckets`). Returns new
    buckets."""
    num_slots = buckets.x.shape[-1]
    inv1, inv2 = _inverse_index(key1, num_slots), _inverse_index(key2, num_slots)
    hit = torch.nonzero((inv1 >= 0) | (inv2 >= 0)).reshape(-1)
    i1, i2 = inv1[hit].long(), inv2[hit].long()
    lc = _lane_curve(curve)
    inf = _point_to_ints(curve, _infinity(curve, len(hit), buckets.x.device))

    def part(v, i):  # v's lanes i, infinity where i < 0
        vi = _point_to_ints(curve, JacobianPoint(*(c[..., i.clamp(min=0)] for c in v)))
        live = i.cpu().numpy() >= 0
        return JacobianPoint(*(np.where(live, a, b) for a, b in zip(vi, inf)))

    a = _point_to_ints(curve, JacobianPoint(*(c[..., hit] for c in buckets)))
    r = lc.add(lc.add(a, part(v1, i1)), part(v2, i2))
    out = JacobianPoint(*(c.clone() for c in buckets))
    untouched = (inv1 < 0) & (inv2 < 0) & C.curve_ops_for(curve, "limb").is_infinity(buckets)
    for o, c, ic in zip(out, _point_from_ints(curve, r, buckets.x.device),
                        _infinity(curve, num_slots, buckets.x.device)):
        o[..., hit] = c
        o[..., untouched] = ic[..., untouched]
    return out


def limb_accumulate_buckets(curve, px, py, qinf, head, slot, num_slots: int):
    """`plain_accumulate_buckets` through the limb `CurveOps` on the
    tensors' own device (on CUDA, one field-kernel launch per field op): the
    same loop over the same formulas, fast enough on the card to hold the
    bucket column against at the prover's shapes."""
    outs = _column_loop(C.curve_ops_for(curve, "limb"), px, py, qinf.bool(), head.bool(),
                        lambda v, k: v[k])
    return _pick_run_ends(curve, _stream_from_tensors(outs), slot, num_slots)


def limb_merge_buckets(curve, buckets, v1, key1, v2, key2) -> JacobianPoint:
    """The dense merge the merge kernel replaced: B1 and B2 infinity but at
    their keys, add(add(buckets, B1), B2) through the limb `CurveOps` on the
    tensors' own device."""
    cops = C.curve_ops_for(curve, "limb")
    num_slots = buckets.x.shape[-1]

    def dense(v, key):
        k = key.long()
        live = k >= 0
        out = _infinity(curve, num_slots, buckets.x.device)
        for o, c in zip(out, v):
            o[..., k[live]] = c[..., live]
        return out

    return cops.add(cops.add(buckets, dense(v1, key1)), dense(v2, key2))


def limb_fold_columns(curve, qx, qy, qz, head, sums: bool = False):
    """`plain_fold_columns` through the limb `CurveOps` on the tensors' own
    device."""
    return _fold_scan(C.curve_ops_for(curve, "limb"), JacobianPoint(qx, qy, qz), head.bool(),
                      sums)


def limb_combine_windows(curve, a, b, doublings: int, window_bits: int) -> JacobianPoint:
    """`plain_combine_windows` through the limb `CurveOps` on the tensors'
    own device."""
    cops = C.curve_ops_for(curve, "limb")
    return M.horner(cops, M.window_sums(cops, a, b, doublings), window_bits)


def plain_add(curve, p: JacobianPoint, q: JacobianPoint) -> JacobianPoint:
    return plain_point_op(curve, "add", p, q)


def plain_madd(curve, p: JacobianPoint, q: JacobianPoint) -> JacobianPoint:
    return plain_point_op(curve, "madd", p, q)


def plain_double(curve, p: JacobianPoint) -> JacobianPoint:
    return plain_point_op(curve, "double", p)


PLAIN = {
    "add": plain_add,
    "madd": plain_madd,
    "double": plain_double,
    "buckets": plain_accumulate_buckets,
    "fold": plain_fold_columns,
    "combine": plain_combine_windows,
    "merge": plain_merge_buckets,
    "chain": plain_fused_double_add,
}


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def _edims(curve) -> tuple:
    L = curve.field.num_limbs
    return (2, L) if curve.is_ext else (L,)


def _on_cuda(curve, tensors) -> bool:
    """True for CUDA tensors the kernels take, False for CPU tensors; raises
    for anything else."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"operands on different devices: {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"no point kernel for device {dev}")
    if curve.name not in KERNEL_CURVES:
        raise ValueError(f"the CUDA point kernels have no build for {curve.name}")
    if dev.index not in (None, torch.cuda.current_device()):
        raise ValueError(f"operands on {dev}, current CUDA device is "
                         f"{torch.cuda.current_device()}")
    for t in tensors:
        if t.dtype != torch.int32:
            raise TypeError(f"point kernels take int32 limbs, got {t.dtype}")
    return True


def _check_launch(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError {err}")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _point_op(curve, which: str, p: JacobianPoint, q: JacobianPoint = None,
              point_group: int = 0) -> JacobianPoint:
    """One point-op launch on CUDA tensors (the curve's own build, or with
    `point_group` the add object built for that many threads a lane), the
    plain version on CPU tensors."""
    pts = [*p] if q is None else [*p, *q]
    edims = _edims(curve)
    shape = p.x.shape
    if shape[: len(edims)] != edims or any(c.shape != shape for c in pts):
        raise ValueError(f"expected coordinates of one shape ({', '.join(map(str, edims))}, "
                         f"...), got {[tuple(c.shape) for c in pts]}")
    n = 1
    for d in shape[len(edims):]:
        n *= d
    flat = [c.reshape(*edims, n).contiguous() for c in pts]
    if not _on_cuda(curve, flat):
        if n == 0:
            return JacobianPoint(*(c.clone() for c in p))
        fp = JacobianPoint(*flat[:3])
        fq = None if q is None else JacobianPoint(*flat[3:])
        out = plain_point_op(curve, which, fp, fq)
    else:
        out = JacobianPoint(*(torch.empty_like(flat[0]) for _ in range(3)))
        if n:
            ins = flat if q is not None else flat * 2
            err = getattr(_lib(curve.name, point_group), f"manta_point_{which}")(
                *(t.data_ptr() for t in ins),
                *(t.data_ptr() for t in out), n, _stream())
            _check_launch(err, f"point {which}")
            LAUNCHES[which] += 1
    return JacobianPoint(*(c.reshape(shape) for c in out))


def fused_add(curve, p: JacobianPoint, q: JacobianPoint) -> JacobianPoint:
    """Complete Jacobian addition, one launch for the whole formula."""
    return _point_op(curve, "add", p, q)


def fused_madd(curve, p: JacobianPoint, q: JacobianPoint) -> JacobianPoint:
    """Mixed addition (q affine, Z in {0, 1}), one launch."""
    return _point_op(curve, "madd", p, q)


def fused_double(curve, p: JacobianPoint) -> JacobianPoint:
    """Doubling, one launch."""
    return _point_op(curve, "double", p)


def _check_stream(curve, coords, masks) -> tuple:
    K = coords[0].shape[0]
    shape = (K, *_edims(curve), coords[0].shape[-1])
    if any(tuple(c.shape) != shape for c in coords) or any(
        tuple(m.shape) != (K, shape[-1]) for m in masks
    ):
        raise ValueError(f"expected (K, *E, R) = {shape} streams and (K, R) masks, got "
                         f"{[tuple(c.shape) for c in coords]}, {[tuple(m.shape) for m in masks]}")
    return K, shape[-1]


def accumulate_buckets(curve, px, py, qinf, head, slot, num_slots: int):
    """The K-step bucket accumulation over the sorted affine stream `px, py`
    (K, *E, R) with masks `qinf, head` (K, R) and `slot` (K, R) int: the
    accumulator at each step and lane with slot >= 0, written to bucket
    slot of a (*E, num_slots) array that is infinity elsewhere (the slots
    >= 0 unique), and the last step's accumulator (*E, R). Returns (buckets,
    acc_last). See `plain_accumulate_buckets`."""
    K, R = _check_stream(curve, (px, py), (qinf, head, slot))
    if not _on_cuda(curve, (px, py)):
        return plain_accumulate_buckets(curve, px, py, qinf, head, slot, num_slots)
    if any(m.device != px.device for m in (qinf, head, slot)):
        raise ValueError("masks and stream on different devices")
    px, py = px.contiguous(), py.contiguous()
    masks = [m.to(torch.int32).contiguous() for m in (qinf, head, slot)]
    buckets = _infinity(curve, num_slots, px.device)
    acc_last = JacobianPoint(*(px.new_empty(px.shape[1:]) for _ in range(3)))
    if K and R:
        err = _lib(curve.name).manta_accumulate_buckets(
            px.data_ptr(), py.data_ptr(), *(m.data_ptr() for m in masks),
            *(t.data_ptr() for t in buckets), *(t.data_ptr() for t in acc_last), K, R,
            num_slots, _stream())
        _check_launch(err, "bucket column")
        LAUNCHES["buckets"] += 1
    return buckets, acc_last


def fold_columns(curve, qx, qy, qz, head, sums: bool = False):
    """Segmented sums over the projective stream `qx, qy, qz` (K, *E, R) with
    `head` (K, R): the post-step accumulator stream A, and with `sums` B =
    the sum of A[k] over k, (*E, R) (else None). See `plain_fold_columns`."""
    K, R = _check_stream(curve, (qx, qy, qz), (head,))
    if not _on_cuda(curve, (qx, qy, qz)):
        return plain_fold_columns(curve, qx, qy, qz, head, sums)
    if head.device != qx.device:
        raise ValueError("mask and stream on different devices")
    ins = [c.contiguous() for c in (qx, qy, qz)]
    hd = head.to(torch.int32).contiguous()
    a = [torch.empty_like(ins[0]) for _ in range(3)]
    b = [ins[0].new_empty(ins[0].shape[1:]) for _ in range(3)] if sums else None
    if K and R:
        err = _lib(curve.name).manta_fold_columns(
            *(t.data_ptr() for t in ins), hd.data_ptr(), *(t.data_ptr() for t in a),
            *((t.data_ptr() for t in b) if sums else (None,) * 3), K, R, _stream())
        _check_launch(err, "fold")
        LAUNCHES["fold"] += 1
    return JacobianPoint(*a), None if b is None else JacobianPoint(*b)


def fused_double_add(curve, init: JacobianPoint, addends: JacobianPoint, doublings: int,
                     chain_first: bool = True) -> JacobianPoint:
    """Per lane of init (*E, ...): acc = init; for each of the S addends
    (S, *E, ...): `doublings` doublings of acc, then acc = add(acc, w)
    (chain_first) or add(w, acc); one launch for every chain (a warp a
    chain). Returns acc, shaped as init. See `plain_fused_double_add`."""
    edims = _edims(curve)
    shape = init.x.shape
    steps = addends.x.shape[0]
    if (tuple(shape[: len(edims)]) != edims or any(c.shape != shape for c in init)
            or any(tuple(c.shape) != (steps, *shape) for c in addends) or doublings < 0):
        raise ValueError(f"{curve.name}: expected coordinates ({', '.join(map(str, edims))}, "
                         f"...) and addends (S, same), doublings >= 0, got "
                         f"{[tuple(c.shape) for c in (*init, *addends)]}, {doublings}")
    n = 1
    for d in shape[len(edims):]:
        n *= d
    ins = [c.reshape(*edims, n).contiguous() for c in init]
    ws = [c.reshape(steps, *edims, n).contiguous() for c in addends]
    if not _on_cuda(curve, (*ins, *ws)):
        out = plain_fused_double_add(curve, JacobianPoint(*ins), JacobianPoint(*ws), doublings,
                                     chain_first)
        return JacobianPoint(*(c.reshape(shape) for c in out))
    out = [torch.empty_like(ins[0]) for _ in range(3)]
    if n:
        err = _lib(curve.name).manta_double_add(
            *(t.data_ptr() for t in ins), *(t.data_ptr() for t in ws),
            *(t.data_ptr() for t in out), n, steps, doublings, int(chain_first), _stream())
        _check_launch(err, "chain")
        LAUNCHES["chain"] += 1
    return JacobianPoint(*(c.reshape(shape) for c in out))


def merge_buckets(curve, buckets: JacobianPoint, v1: JacobianPoint, key1, v2: JacobianPoint,
                  key2) -> JacobianPoint:
    """Add the fold's trailing partials into the buckets: buckets (*E, N);
    level 1 v1 (*E, n1) at slots key1 (n1,) and level 2 v2 (*E, n2) at key2
    (n2,), int, -1 for none, the slots of a level unique. Returns
    add(add(buckets, B1), B2) with B1, B2 infinity but at their keys, bit
    for bit; on CUDA computed in place in `buckets`, only where a partial
    hits (and an infinity elsewhere made the backend's (0, 1, 0)). See
    `plain_merge_buckets`."""
    edims = _edims(curve)
    n1, n2 = key1.shape[-1], key2.shape[-1]
    num_slots = buckets.x.shape[-1]
    shapes = ((buckets, num_slots), (v1, n1), (v2, n2))
    if key1.dim() != 1 or key2.dim() != 1 or any(
        tuple(c.shape) != (*edims, n) for pt, n in shapes for c in pt
    ):
        raise ValueError(f"expected (*E, n) = ({', '.join(map(str, edims))}, n) coordinates and "
                         f"(n,) keys, got {[tuple(c.shape) for pt, _ in shapes for c in pt]}, "
                         f"{tuple(key1.shape)}, {tuple(key2.shape)}")
    if not _on_cuda(curve, (*buckets, *v1, *v2)):
        return plain_merge_buckets(curve, buckets, v1, key1, v2, key2)
    if key1.device != buckets.x.device or key2.device != buckets.x.device:
        raise ValueError("keys and buckets on different devices")
    if any(not c.is_contiguous() for c in buckets):
        raise ValueError("merge_buckets updates the buckets in place: pass contiguous ones")
    parts = [c.contiguous() for c in (*v1, *v2)]
    keys = [k.to(torch.int32).contiguous() for k in (key1, key2)]
    inv = [_inverse_index(k, num_slots) for k in keys]
    if num_slots:
        err = _lib(curve.name).manta_merge_buckets(
            *(c.data_ptr() for c in buckets), *(c.data_ptr() for c in parts[:3]),
            keys[0].data_ptr(), *(c.data_ptr() for c in parts[3:]), keys[1].data_ptr(),
            *(t.data_ptr() for t in inv), n1, n2, num_slots, _stream())
        _check_launch(err, "merge")
        LAUNCHES["merge"] += 1
    return buckets


def combine_windows(curve, a: JacobianPoint, b: JacobianPoint, doublings: int,
                    window_bits: int) -> JacobianPoint:
    """The MSM's last steps in one launch: from the weighted fold's level-2
    rows a, b (*E, 2W) (lanes [T | B], `msm._weighted_fold_fused`), the
    window sums S_w = 2^doublings·(b[w] − a[w]) + a[W + w] and Horner's rule
    over them, window_bits doublings a window; one lane, (*E, 1). See
    `plain_combine_windows`."""
    edims = _edims(curve)
    lanes = a.x.shape[-1]
    if any(tuple(c.shape) != (*edims, lanes) for c in (*a, *b)) or lanes % 2 or not (
        2 <= lanes <= 128
    ):
        raise ValueError(f"expected (*E, 2W) = ({', '.join(map(str, edims))}, 2W) rows, "
                         f"2 <= 2W <= 128, got {[tuple(c.shape) for c in (*a, *b)]}")
    if not _on_cuda(curve, (*a, *b)):
        return plain_combine_windows(curve, a, b, doublings, window_bits)
    ins = [c.contiguous() for c in (*a, *b)]
    out = [ins[0].new_empty((*edims, 1)) for _ in range(3)]
    err = _lib(curve.name).manta_combine_windows(
        *(t.data_ptr() for t in ins), *(t.data_ptr() for t in out), lanes // 2, doublings,
        window_bits, _stream())
    _check_launch(err, "combine")
    LAUNCHES["combine"] += 1
    return JacobianPoint(*out)


# ---------------------------------------------------------------------------
# The fused curve backend
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FusedCurveOps(C.CurveOps):
    """CurveOps whose group law runs as whole-formula kernels.

    `ops` stays the limb `CoordOps` / `Fq2Ops` (select, is_zero, neg for the
    MSM's glue); add / madd / double launch one kernel each, and the MSM
    finds `run_bucket_columns` / `run_fold_columns` / `merge_buckets` /
    `combine_windows` and runs its bucket loop, folds, bucket merge and
    window combine as single launches, and off the fold path `double_add`
    and runs each chain of doublings and an addition (Horner, the weighted
    reductions) as one (`ops/msm.py`)."""

    def add(self, p: JacobianPoint, q: JacobianPoint) -> JacobianPoint:
        return fused_add(self.curve, p, q)

    def madd(self, p: JacobianPoint, q: JacobianPoint) -> JacobianPoint:
        return fused_madd(self.curve, p, q)

    def double(self, p: JacobianPoint) -> JacobianPoint:
        return fused_double(self.curve, p)

    def double_add(self, init, addends, doublings: int, chain_first: bool = True):
        return fused_double_add(self.curve, init, addends, doublings, chain_first)

    def run_bucket_columns(self, px, py, qinf, head, slot, num_slots: int):
        return accumulate_buckets(self.curve, px, py, qinf, head, slot, num_slots)

    def run_fold_columns(self, qx, qy, qz, head, sums: bool = False):
        return fold_columns(self.curve, qx, qy, qz, head, sums)

    def combine_windows(self, a, b, doublings: int, window_bits: int) -> JacobianPoint:
        return combine_windows(self.curve, a, b, doublings, window_bits)

    def merge_buckets(self, buckets, v1, key1, v2, key2) -> JacobianPoint:
        return merge_buckets(self.curve, buckets, v1, key1, v2, key2)


@functools.lru_cache(maxsize=None)
def fused_curve_ops_for(curve: hostmath.WeierstrassCurve) -> FusedCurveOps:
    return FusedCurveOps(curve, backend="fused")
