"""RNS curve kernels: point op, bucket column, hybrid bucket column, combine;
CUDA and plain.

Replaces the JAX package's Pallas TPU kernels of
`manta_tpu/ops/pallas/rns_kernels.py`: `_rns_point_op` (public `rns_add`,
`rns_madd`, `rns_double`), `_rns_column_call` (`rns_accumulate_buckets`) and
`_hybrid_column_call` (`hybrid_accumulate_buckets`), with the backend objects
`RnsFusedCurveOps` / `RnsHybridCurveOps` and `rns_fused_curve_ops_for` /
`rns_hybrid_curve_ops_for`. The combine kernel (`rns_double_add`) runs the
chains of doublings and additions that the JAX package's MSM issues as
`_rns_point_op` calls a lane at a time (Horner's rule, the weighted
reductions' doubling runs). The kernel source is `manta_tpu_torch/csrc/
rns_kernels.cu` (arithmetic in `rns_ops.cuh`); its header gives the bound on
the H100 and what the design does about it.

Layout at the boundary, as in the JAX package: coordinates packed
channels-major int32 residues, `(Kt, ...)` for G1 and `(2, Kt, ...)` for G2
(`ops/rns.py`); the bucket columns' sorted point streams `(K, *E, R)` with
masks `(K, R)`, RNS residues (`rns_accumulate_buckets`) or 16-bit
Montgomery limbs `(K, *E(L), R)` (`hybrid_accumulate_buckets`). The JAX
column kernels write the accumulator after every step, from which the MSM
picks the run ends; both bucket columns here write only the run ends, into
their buckets, and the last step (the same buckets, bit for bit: their plain
versions are the JAX kernels' streams and `pick_run_ends`). Each public
function dispatches on the tensors' device:

- CUDA: one launch of the curve's kernel on the current stream, counted in
  `LAUNCHES`. No fallback: an unsupported curve, dtype or shape raises, and
  so does a failed build or launch.
- CPU: the plain version (`PLAIN`).

The plain versions run the port's `RnsCurveOps` formulas (`ops/curve.py`)
over the plain packed ops of `ops/rns.py`, with the field ops of the JAX
kernels' `_KernelRnsOps` / `_KernelRnsFq2Ops`: a canonical add for every
add, `sub_k` at the requested offset (one higher for Fq2 components), the
schoolbook Fq2 product, and the zero test against the 2^13 zero classes k·p
(`table_is_zero`). The column loops are `point_kernels._column_loop` over
those formulas. The kernels' zero test needs no table (`crt_is_zero` is its
arithmetic in PyTorch); the CPU tests hold the two against each other and
against the JAX kernel ops.

The kernels are built at first use with `nvcc`, one shared library per curve
(`build.py`), into `build/torch_kernels/`; the constant tables go to the
kernel as one int32 tensor (`device_table`), built from the spec.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from manta_tpu_torch.ops import curve as C
from manta_tpu_torch.ops import field_ops as F
from manta_tpu_torch.ops import msm as M
from manta_tpu_torch.ops import rns as R
from manta_tpu_torch.ops.curve import JacobianPoint
from manta_tpu_torch.ops.kernels import build as B
from manta_tpu_torch.ops.kernels import point_kernels as PK
from manta_tpu_torch.utils import hostmath

#: zero classes of the JAX kernel: values below 2^13·p (`N_ZERO_CLASSES`)
N_ZERO_CLASSES = 1 << 13

#: launches of the CUDA kernels, counted by the wrappers: the point-op kernel
#: by formula, the bucket column (RNS points in), the hybrid bucket column
#: (limb points in), the combine and the zero-test launcher
LAUNCHES = {"add": 0, "madd": 0, "double": 0, "buckets": 0, "hybrid": 0, "combine": 0,
            "is_zero": 0}

#: curve name -> the MANTA_CURVE id of `rns_kernels.cu`
KERNEL_CURVES = {"bn254_g1": 0, "bn254_g2": 1, "bls12_381_g1": 2, "bls12_381_g2": 3}
#: the MANTA_KERNEL ids of `rns_kernels.cu`: one object each
KERNELS = ("add", "madd", "double", "buckets", "hybrid", "combine")

SOURCE = B.CSRC / "rns_kernels.cu"

#: rows of per-channel constants in the device table (`rns_ops.cuh::Row`)
_TABLE_ROWS = 20


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def library(curve_name: str) -> B.Library:
    curve = f"MANTA_CURVE={KERNEL_CURVES[curve_name]}"
    units = tuple((curve, f"MANTA_KERNEL={k}") for k in range(len(KERNELS)))
    return B.Library(f"rns_kernels-{curve_name}", SOURCE.name, ("rns_ops.cuh",), units)


LIBRARIES = tuple(library(name) for name in KERNEL_CURVES)


@functools.lru_cache(maxsize=None)
def _lib(curve_name: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(B.build([library(curve_name)])[0]))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for which in ("add", "madd", "double"):
        getattr(lib, f"manta_rns_point_{which}").argtypes = [*[ptr] * 10, i64, i64, ptr]
    lib.manta_rns_is_zero.argtypes = [ptr, ptr, ptr, i64, i64, ptr]
    for which in ("accumulate_buckets", "hybrid_buckets"):
        getattr(lib, f"manta_rns_{which}").argtypes = [*[ptr] * 12, i32, i64, i64, i64, ptr]
    lib.manta_rns_double_add.argtypes = [*[ptr] * 10, i64, i32, i32, i32, i64, ptr]
    for name in ("point_add", "point_madd", "point_double", "is_zero", "accumulate_buckets",
                 "hybrid_buckets", "double_add"):
        getattr(lib, f"manta_rns_{name}").restype = ctypes.c_int
    return lib


# ---------------------------------------------------------------------------
# Constant tables, built from the spec
# ---------------------------------------------------------------------------


def padded_channels(spec: R.RnsSpec) -> int:
    """Kt rounded up to whole warps of 4 channels (the kernels' block)."""
    return (spec.kt + 3) // 4 * 4


@functools.lru_cache(maxsize=None)
def limb_tables(spec: R.RnsSpec):
    """Limb -> RNS conversion (the JAX package's `_limb_conv_tables` without
    its float digit splits): T (Kt, L) with T[c, i] = 2^(16 i) mod m_c, and
    convk (Kt,), the residues of M1²·2^(−16 L) mod p. The residues of a limb
    value v are sum_i limb_i·T[c, i] mod m_c; one RNS product by convk takes
    v = x·2^(16 L) to the RNS Montgomery form of x."""
    field = spec.field
    T = np.asarray([[pow(2, 16 * i, m) for i in range(field.num_limbs)] for m in spec.moduli],
                   dtype=np.int64)
    p = field.modulus
    k = spec.M1 * spec.M1 % p * field.R_inv % p
    return T, np.asarray([k % m for m in spec.moduli], dtype=np.int64)


@functools.lru_cache(maxsize=None)
def _zero_key(spec: R.RnsSpec):
    """The zero classes k·p, k < 2^13, as residue rows (2^13, Kt), keyed by
    their residues in channels 0 and 1 (distinct: m_0·m_1 > 2^13)."""
    p = spec.field.modulus
    rows = np.asarray([[k * p % m for m in spec.moduli] for k in range(N_ZERO_CLASSES)],
                      dtype=np.int64)
    keys = rows[:, 0] * spec.moduli[1] + rows[:, 1]
    order = np.argsort(keys, kind="stable")
    if len(np.unique(keys)) != N_ZERO_CLASSES:
        raise AssertionError("two zero classes share their channel-0/1 residues")
    return rows, keys[order], order


@functools.lru_cache(maxsize=None)
def device_table(spec: R.RnsSpec) -> np.ndarray:
    """The kernels' int32 constant table (layout: `rns_ops.cuh::Dims`)."""
    c = spec.consts
    k1, k2, kt = spec.k1, spec.k2, spec.kt
    kp = padded_channels(spec)
    p = spec.field.modulus
    mods = np.asarray(list(spec.moduli) + [spec.moduli[0]] * (kp - kt), dtype=np.int64)
    rows = np.zeros((_TABLE_ROWS, kp), dtype=np.int64)
    rows[0] = mods
    rows[1] = (1 << 32) // mods
    rows[2, :k1] = c["neg_p_inv_1"]
    rows[3, :k1] = c["w1"]
    rows[4, k1:kt] = [*c["p_2"], c["p_r"]]
    rows[5, k1:kt] = [*c["M1_inv_2"], c["M1_inv_r"]]
    rows[6, k1 : k1 + k2] = c["w2"]
    rows[7, :k1] = c["M2_mod_1"]
    rows[8, :kt] = np.concatenate([x.reshape(-1) for x in R._one_rep_cached(spec)])
    rows[9] = [p % int(m) for m in mods]
    for k in R.OFFSETS:
        rows[10 + k - 5] = [((1 << k) * p) % int(m) for m in mods]
    T, convk = limb_tables(spec)
    rows[19, :kt] = convk
    a2 = np.concatenate([c["A2"], c["A2r"][None]], 0)
    t_pad = np.concatenate([T, np.repeat(T[:1], kp - kt, 0)], 0)
    m_r, ma, mb = spec.m_r, spec.moduli[0], spec.moduli[1]
    scalars = [m_r, (1 << 32) // m_r, int(c["M2_inv_r"]), pow(p, -1, ma), pow(p, -1, mb),
               pow(ma, -1, mb), 0, 0]
    words = np.concatenate([rows.reshape(-1), np.asarray(c["A1"]).reshape(-1),
                            a2.reshape(-1), t_pad.reshape(-1), np.asarray(scalars)])
    return words.astype(np.uint32).view(np.int32)


@functools.lru_cache(maxsize=None)
def _device_table_on(spec: R.RnsSpec, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(device_table(spec).copy()).to(device)


# ---------------------------------------------------------------------------
# Zero tests
# ---------------------------------------------------------------------------


def table_is_zero(spec: R.RnsSpec, a: torch.Tensor) -> torch.Tensor:
    """value ≡ 0 mod p as the JAX kernels decide it: the residue vector
    equals one of the 2^13 rows k·p (`_KernelRnsOps.is_zero`). The row to
    compare with is found by its channel-0/1 residues; `a` (Kt, ...)."""
    rows, keys, order = _zero_key(spec)
    dev = a.device
    flat = a.reshape(a.shape[0], -1).long()
    key = flat[0] * spec.moduli[1] + flat[1]
    keys_t = torch.from_numpy(keys).to(dev)
    pos = torch.searchsorted(keys_t, key).clamp_(max=len(keys) - 1)
    cand = torch.from_numpy(order).to(dev)[pos]
    same = (torch.from_numpy(rows).to(dev)[cand].T == flat).all(0)
    return (same & (keys_t[pos] == key)).reshape(a.shape[1:])


def crt_is_zero(spec: R.RnsSpec, a: torch.Tensor) -> torch.Tensor:
    """The kernels' table-free zero test, in PyTorch: k0 = x·p⁻¹ mod m_0·m_1
    by CRT from channels 0 and 1; zero iff k0 < 2^13 and every channel
    equals k0·p mod m."""
    p = spec.field.modulus
    ma, mb = spec.moduli[0], spec.moduli[1]
    flat = a.reshape(a.shape[0], -1).long()
    ka = flat[0] * pow(p, -1, ma) % ma
    kb = flat[1] * pow(p, -1, mb) % mb
    k0 = ka + ma * ((kb - ka) % mb * pow(ma, -1, mb) % mb)
    mods = torch.tensor(spec.moduli, dtype=torch.int64, device=a.device)[:, None]
    p_mod = torch.tensor([p % m for m in spec.moduli], dtype=torch.int64, device=a.device)
    want = k0[None] % mods * p_mod[:, None] % mods
    return ((k0 < N_ZERO_CLASSES) & (flat == want).all(0)).reshape(a.shape[1:])


# ---------------------------------------------------------------------------
# Plain versions: RnsCurveOps formulas over the plain packed ops
# ---------------------------------------------------------------------------


class _KernelOps:
    """The JAX kernels' base-field ops (`_KernelRnsOps`) that the
    `RnsCurveOps` formulas use, over packed int32 tensors (Kt, ...):
    canonical adds, `sub_k` offsets, the zero test against the 2^13 classes,
    limb -> RNS conversion."""

    def __init__(self, spec: R.RnsSpec):
        self.spec = spec

    def mul(self, a, b):
        return R.packed_mul(self.spec, a, b)

    def sqr(self, a):
        return self.mul(a, a)

    def add(self, a, b):
        return R.packed_add(self.spec, a, b)

    add_raw = add

    def double_raw(self, a):
        return self.add(a, a)

    def sub_k(self, a, b, k: int):
        return R.packed_sub_k(self.spec, a, b, k)

    def is_zero(self, a):
        return table_is_zero(self.spec, a)

    def select(self, mask, a, b):
        return torch.where(mask[None], a, b)

    def zeros_like(self, a):
        return torch.zeros_like(a)

    def one_like(self, a):
        return R.RnsCoordOps(self.spec.field).one_like(a)

    def from_limbs(self, limbs):
        """(L, ...) 16-bit Montgomery limbs of v = x·2^(16 L) (lazy, < 2p)
        -> RNS residues of x·M1 (below (k1+2)·p)."""
        T, convk = limb_tables(self.spec)
        # sum_i limb_i·T[c, i] < 24·2^28: exact in float64 (CUDA has no
        # integer matrix product)
        flat = limbs.reshape(limbs.shape[0], -1).double()
        sums = (torch.from_numpy(T).to(limbs.device).double() @ flat).long()
        mods = torch.tensor(self.spec.moduli, dtype=torch.int64, device=limbs.device)[:, None]
        res = sums % mods
        k = torch.from_numpy(convk).to(limbs.device)[:, None].expand(res.shape)
        out = self.mul(res.to(torch.int32), k.to(torch.int32))
        return out.reshape(self.spec.kt, *limbs.shape[1:])


class _KernelOps2:
    """The JAX kernels' Fq2 ops (`_KernelRnsFq2Ops`) over (2, Kt, ...):
    schoolbook product, every sub_k offset one higher."""

    def __init__(self, spec: R.RnsSpec):
        self.base = _KernelOps(spec)

    def _map2(self, fn, *arrs):
        return torch.stack([fn(*(a[0] for a in arrs)), fn(*(a[1] for a in arrs))])

    def mul(self, a, b):
        # the four base products a0 b0, a1 b1, a0 b1, a1 b0 in one call
        o = self.base
        t = o.mul(torch.stack([a[0], a[1], a[0], a[1]], 1), torch.stack([b[0], b[1], b[1], b[0]], 1))
        return torch.stack([o.sub_k(t[:, 0], t[:, 1], 6), o.add(t[:, 2], t[:, 3])])

    def sqr(self, a):
        return self.mul(a, a)

    def add(self, a, b):
        return self._map2(self.base.add, a, b)

    add_raw = add

    def double_raw(self, a):
        return self.add(a, a)

    def sub_k(self, a, b, k: int):
        return self._map2(lambda x, y: self.base.sub_k(x, y, k + 1), a, b)

    def is_zero(self, a):
        return self.base.is_zero(a[0]) & self.base.is_zero(a[1])

    def select(self, mask, a, b):
        return torch.where(mask[None, None], a, b)

    def zeros_like(self, a):
        return torch.zeros_like(a)

    def one_like(self, a):
        return torch.stack([self.base.one_like(a[0]), torch.zeros_like(a[1])])

    def from_limbs(self, limbs):
        return torch.stack([self.base.from_limbs(limbs[0]), self.base.from_limbs(limbs[1])])


@dataclasses.dataclass(frozen=True)
class _PlainCurve(C.RnsCurveOps):
    """`RnsCurveOps` formulas over the kernels' field ops."""

    @functools.cached_property
    def ops(self):
        spec = R.default_spec(self.curve.field)
        return _KernelOps2(spec) if self.curve.is_ext else _KernelOps(spec)


@functools.lru_cache(maxsize=None)
def _plain_curve(curve: hostmath.WeierstrassCurve) -> _PlainCurve:
    return _PlainCurve(curve, backend="rns")


def plain_rns_point_op(curve, which: str, p: JacobianPoint, q: JacobianPoint = None):
    """add / madd / double of the RNS formulas on (*E, n) coordinates."""
    pc = _plain_curve(curve)
    return pc.double(p) if which == "double" else getattr(pc, which)(p, q)


def plain_rns_accumulate_columns(curve, px, py, qinf, head) -> JacobianPoint:
    """Per lane, for k < K: acc = q[k] if head[k] else madd(acc, q[k]), q =
    infinity where qinf[k]; acc after every step, (K, *E, R) each."""
    outs = PK._column_loop(_plain_curve(curve), px, py, qinf.bool(), head.bool(),
                           lambda v, k: v[k])
    return PK._stream_from_tensors(outs)


def plain_hybrid_accumulate_columns(curve, px, py, qinf, head) -> JacobianPoint:
    """`plain_rns_accumulate_columns` over limb points: each step's q
    converted to RNS first (`from_limbs`)."""
    pc = _plain_curve(curve)
    outs = PK._column_loop(pc, px, py, qinf.bool(), head.bool(),
                           lambda v, k: pc.ops.from_limbs(v[k]))
    return PK._stream_from_tensors(outs)


def _infinity(curve, lanes: int, device) -> JacobianPoint:
    """The RNS backends' infinity (0, encoded 1, 0), (*E(Kt), lanes)
    coordinates of their own (`infinity_like`)."""
    spec = R.default_spec(curve.field)
    z = torch.zeros((*_edims(curve, spec.kt), lanes), dtype=torch.int32, device=device)
    inf = rns_fused_curve_ops_for(curve).infinity_like(JacobianPoint(z, z, z))
    return JacobianPoint(*(c.contiguous() for c in inf))


def plain_rns_accumulate_buckets(curve, px, py, qinf, head, slot, num_slots: int):
    """`plain_rns_accumulate_columns`, then its value at each step and lane
    with slot >= 0 written to bucket slot of an infinity array (*E(Kt),
    num_slots); returns (the buckets, the last step's accumulator (*E(Kt),
    R))."""
    return pick_run_ends(curve, plain_rns_accumulate_columns(curve, px, py, qinf, head), slot,
                         num_slots)


def plain_hybrid_accumulate_buckets(curve, px, py, qinf, head, slot, num_slots: int):
    """`plain_hybrid_accumulate_columns`, then its value at each step and
    lane with slot >= 0 written to bucket slot of an infinity array
    (*E(Kt), num_slots); returns (the buckets, the last step's accumulator
    (*E(Kt), R))."""
    return pick_run_ends(curve, plain_hybrid_accumulate_columns(curve, px, py, qinf, head), slot,
                         num_slots)


def pick_run_ends(curve, stream: JacobianPoint, slot, num_slots: int):
    """A column's stream (K, *E(Kt), R) -> (buckets (*E(Kt), num_slots):
    infinity where no slot names them, else the stream's value at the step
    and lane whose slot it is; the last step (*E(Kt), R))."""
    s = slot.reshape(-1).long()
    live = s >= 0
    buckets = _infinity(curve, num_slots, stream.x.device)
    for b, c in zip(buckets, stream):
        b[..., s[live]] = c.movedim(0, -2).reshape(*c.shape[1:-1], -1)[..., live]
    return buckets, JacobianPoint(*(c[-1].clone() for c in stream))


def plain_rns_double_add(curve, init, addends, doublings: int, chain_first: bool):
    """The combine's work: the MSM's Python lines it replaces
    (`msm.double_add_loop`) over the plain RNS formulas."""
    return M.double_add_loop(_plain_curve(curve), init, addends, doublings, chain_first)


def plain_rns_is_zero(curve, a) -> torch.Tensor:
    return table_is_zero(R.default_spec(curve.field), a)


PLAIN = {
    "add": lambda curve, p, q: plain_rns_point_op(curve, "add", p, q),
    "madd": lambda curve, p, q: plain_rns_point_op(curve, "madd", p, q),
    "double": lambda curve, p: plain_rns_point_op(curve, "double", p),
    "buckets": plain_rns_accumulate_buckets,
    "hybrid": plain_hybrid_accumulate_buckets,
    "combine": plain_rns_double_add,
    "is_zero": plain_rns_is_zero,
}


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def _edims(curve, rows: int) -> tuple:
    return (2, rows) if curve.is_ext else (rows,)


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
        raise ValueError(f"no RNS kernel for device {dev}")
    if curve.name not in KERNEL_CURVES:
        raise ValueError(f"the CUDA RNS kernels have no build for {curve.name}")
    if dev.index not in (None, torch.cuda.current_device()):
        raise ValueError(f"operands on {dev}, current CUDA device is "
                         f"{torch.cuda.current_device()}")
    for t in tensors:
        if t.dtype != torch.int32:
            raise TypeError(f"RNS kernels take int32 residues and limbs, got {t.dtype}")
    return True


def _table(curve, device) -> tuple:
    spec = R.default_spec(curve.field)
    t = _device_table_on(spec, device)
    return t.data_ptr(), t.numel()


def _point_op(curve, which: str, p: JacobianPoint, q: JacobianPoint = None) -> JacobianPoint:
    spec = R.default_spec(curve.field)
    pts = [*p] if q is None else [*p, *q]
    edims = _edims(curve, spec.kt)
    shape = p.x.shape
    if tuple(shape[: len(edims)]) != edims or any(c.shape != shape for c in pts):
        raise ValueError(f"{curve.name}: expected RNS coordinates of one shape "
                         f"({', '.join(map(str, edims))}, ...), got "
                         f"{[tuple(c.shape) for c in pts]}")
    n = 1
    for d in shape[len(edims):]:
        n *= d
    flat = [c.reshape(*edims, n).contiguous() for c in pts]
    if not _on_cuda(curve, flat):
        if n == 0:
            return JacobianPoint(*(c.clone() for c in p))
        fp = JacobianPoint(*flat[:3])
        fq = None if q is None else JacobianPoint(*flat[3:])
        out = plain_rns_point_op(curve, which, fp, fq)
    else:
        out = JacobianPoint(*(torch.empty_like(flat[0]) for _ in range(3)))
        if n:
            ins = flat if q is not None else flat * 2
            table, words = _table(curve, flat[0].device)
            err = getattr(_lib(curve.name), f"manta_rns_point_{which}")(
                table, *(t.data_ptr() for t in ins), *(t.data_ptr() for t in out), n, words,
                PK._stream())
            PK._check_launch(err, f"RNS point {which}")
            LAUNCHES[which] += 1
    return JacobianPoint(*(c.reshape(shape) for c in out))


def rns_add(curve, p: JacobianPoint, q: JacobianPoint) -> JacobianPoint:
    """Complete addition of RNS points, one launch for the whole formula."""
    return _point_op(curve, "add", p, q)


def rns_madd(curve, p: JacobianPoint, q: JacobianPoint) -> JacobianPoint:
    """Mixed addition (q affine, Z in {0, 1}), one launch."""
    return _point_op(curve, "madd", p, q)


def rns_double(curve, p: JacobianPoint) -> JacobianPoint:
    """Doubling, one launch."""
    return _point_op(curve, "double", p)


def rns_is_zero(curve, a: torch.Tensor) -> torch.Tensor:
    """The zero test alone on base-field residues a (Kt, n): on CUDA the
    kernels' table-free test, on the CPU the table (`table_is_zero`)."""
    spec = R.default_spec(curve.field)
    if a.ndim != 2 or a.shape[0] != spec.kt:
        raise ValueError(f"expected ({spec.kt}, n) residues, got {tuple(a.shape)}")
    a = a.contiguous()
    if not _on_cuda(curve, (a,)):
        return plain_rns_is_zero(curve, a)
    out = torch.empty(a.shape[1], dtype=torch.int32, device=a.device)
    if a.shape[1]:
        table, words = _table(curve, a.device)
        err = _lib(curve.name).manta_rns_is_zero(table, a.data_ptr(), out.data_ptr(),
                                                 a.shape[1], words, PK._stream())
        PK._check_launch(err, "RNS zero test")
        LAUNCHES["is_zero"] += 1
    return out != 0


def _check_stream(curve, coords, masks, in_rows: int) -> tuple:
    K = coords[0].shape[0]
    shape = (K, *_edims(curve, in_rows), coords[0].shape[-1])
    if any(tuple(c.shape) != shape for c in coords) or any(
        tuple(m.shape) != (K, shape[-1]) for m in masks
    ):
        raise ValueError(f"expected (K, *E, R) = {shape} streams and (K, R) masks, got "
                         f"{[tuple(c.shape) for c in coords]}, {[tuple(m.shape) for m in masks]}")
    return K, shape[-1]


def _bucket_column(curve, which: str, px, py, qinf, head, slot, num_slots: int):
    """One launch of a bucket column (`which`: "buckets", RNS points in, or
    "hybrid", 16-bit limb points in), or its plain version on CPU tensors."""
    spec = R.default_spec(curve.field)
    in_rows = spec.kt if which == "buckets" else curve.field.num_limbs
    K, lanes = _check_stream(curve, (px, py), (qinf, head, slot), in_rows)
    if not _on_cuda(curve, (px, py)):
        return PLAIN[which](curve, px, py, qinf, head, slot, num_slots)
    if any(m.device != px.device for m in (qinf, head, slot)):
        raise ValueError("masks and stream on different devices")
    px, py = px.contiguous(), py.contiguous()
    masks = [m.to(torch.int32).contiguous() for m in (qinf, head, slot)]
    buckets = _infinity(curve, num_slots, px.device)
    acc_last = JacobianPoint(*(px.new_empty((*_edims(curve, spec.kt), lanes)) for _ in range(3)))
    if K and lanes:
        table, words = _table(curve, px.device)
        launch = {"buckets": "manta_rns_accumulate_buckets",
                  "hybrid": "manta_rns_hybrid_buckets"}[which]
        err = getattr(_lib(curve.name), launch)(
            table, px.data_ptr(), py.data_ptr(), *(m.data_ptr() for m in masks),
            *(t.data_ptr() for t in buckets), *(t.data_ptr() for t in acc_last), K, lanes,
            num_slots, words, PK._stream())
        PK._check_launch(err, f"RNS {which} bucket column")
        LAUNCHES[which] += 1
    return buckets, acc_last


def rns_accumulate_buckets(curve, px, py, qinf, head, slot, num_slots: int):
    """The K-step bucket accumulation over the sorted affine RNS stream
    `px, py` (K, *E(Kt), R) with masks `qinf, head` and `slot` (K, R) int:
    the accumulator at each step and lane with slot >= 0, written to bucket
    slot of a (*E(Kt), num_slots) array that is infinity elsewhere (the slots
    >= 0 unique), and the last step's accumulator (*E(Kt), R). Returns
    (buckets, acc_last). See `plain_rns_accumulate_buckets`."""
    return _bucket_column(curve, "buckets", px, py, qinf, head, slot, num_slots)


def hybrid_accumulate_buckets(curve, px, py, qinf, head, slot, num_slots: int):
    """`rns_accumulate_buckets` over 16-bit-limb points `px, py` (K, *E(L),
    R), each step's point converted to RNS. Returns (buckets, acc_last). See
    `plain_hybrid_accumulate_buckets`."""
    return _bucket_column(curve, "hybrid", px, py, qinf, head, slot, num_slots)


def rns_double_add(curve, init: JacobianPoint, addends: JacobianPoint, doublings: int,
                   chain_first: bool = True) -> JacobianPoint:
    """Per lane of init (*E, ...): acc = init; for each of the S addends
    (S, *E, ...): `doublings` doublings of acc, then acc = add(acc, w)
    (chain_first) or add(w, acc); one launch for every chain. Returns acc,
    shaped as init. See `plain_rns_double_add`."""
    spec = R.default_spec(curve.field)
    edims = _edims(curve, spec.kt)
    shape = init.x.shape
    steps = addends.x.shape[0]
    if (tuple(shape[: len(edims)]) != edims or any(c.shape != shape for c in init)
            or any(tuple(c.shape) != (steps, *shape) for c in addends) or doublings < 0):
        raise ValueError(f"{curve.name}: expected RNS coordinates ({', '.join(map(str, edims))}, "
                         f"...) and addends (S, same), doublings >= 0, got "
                         f"{[tuple(c.shape) for c in (*init, *addends)]}, {doublings}")
    n = 1
    for d in shape[len(edims):]:
        n *= d
    ins = [c.reshape(*edims, n).contiguous() for c in init]
    ws = [c.reshape(steps, *edims, n).contiguous() for c in addends]
    if not _on_cuda(curve, (*ins, *ws)):
        out = plain_rns_double_add(curve, JacobianPoint(*ins), JacobianPoint(*ws), doublings,
                                   chain_first)
        return JacobianPoint(*(c.reshape(shape) for c in out))
    out = [torch.empty_like(ins[0]) for _ in range(3)]
    if n:
        table, words = _table(curve, ins[0].device)
        err = _lib(curve.name).manta_rns_double_add(
            table, *(t.data_ptr() for t in ins), *(t.data_ptr() for t in ws),
            *(t.data_ptr() for t in out), n, steps, doublings, int(chain_first), words,
            PK._stream())
        PK._check_launch(err, "RNS combine")
        LAUNCHES["combine"] += 1
    return JacobianPoint(*(c.reshape(shape) for c in out))


# ---------------------------------------------------------------------------
# The RNS curve backends
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _RnsKernelCurveOps(C.CurveOps):
    """CurveOps whose group law runs as RNS kernels.

    Coordinates are packed int32 residues; `ops` is the renormalizing
    `RnsCoordOps` / `RnsFq2CoordOps` (encode, decode, select for the MSM's
    glue); add / madd / double launch one kernel each, and the MSM finds
    `double_add` and runs its chains of doublings and additions (Horner,
    the weighted reductions) as one combine launch each. There is no fold
    kernel: the MSM reduces the buckets with point additions."""

    def add(self, p: JacobianPoint, q: JacobianPoint) -> JacobianPoint:
        return rns_add(self.curve, p, q)

    def madd(self, p: JacobianPoint, q: JacobianPoint) -> JacobianPoint:
        return rns_madd(self.curve, p, q)

    def double(self, p: JacobianPoint) -> JacobianPoint:
        return rns_double(self.curve, p)

    def double_add(self, init, addends, doublings: int, chain_first: bool = True):
        return rns_double_add(self.curve, init, addends, doublings, chain_first)

    def affine_infinity_mask(self, pt: JacobianPoint):
        """Encoded affine batches: Z residues all 0 (infinity) or the encoded 1."""
        return (pt.z == 0).flatten(0, pt.z.ndim - 2).all(0)


@dataclasses.dataclass(frozen=True)
class RnsFusedCurveOps(_RnsKernelCurveOps):
    """RNS kernels over RNS point arrays: the MSM finds `run_bucket_columns`
    and runs its bucket loop as one launch of the bucket column, which writes
    the run ends into their buckets."""

    def run_bucket_columns(self, px, py, qinf, head, slot, num_slots: int):
        return rns_accumulate_buckets(self.curve, px, py, qinf, head, slot, num_slots)


@functools.lru_cache(maxsize=None)
def rns_fused_curve_ops_for(curve: hostmath.WeierstrassCurve) -> RnsFusedCurveOps:
    return RnsFusedCurveOps(curve, backend="rns")


@dataclasses.dataclass(frozen=True)
class RnsHybridCurveOps(_RnsKernelCurveOps):
    """RNS group law over limb-resident point arrays.

    The affine point arrays (the MSM's input: `encode_points`, padding, the
    signed y negation, the sorted gather) stay 16-bit Montgomery limbs,
    served by `point_ops`; the hybrid bucket column (`run_bucket_columns`)
    converts each step's point to RNS and writes the run ends into their
    buckets, and accumulators, buckets and the reduction are RNS. So
    `encode_points` gives limb batches and `decode_points` takes RNS ones,
    as in the JAX package."""

    @property
    def limb16_points(self) -> bool:
        return not self.curve.is_ext

    @functools.cached_property
    def point_ops(self):
        """Limb-form field ops for the affine point arrays."""
        return C.Fq2Ops(self.curve.field) if self.curve.is_ext else C.CoordOps(self.curve.field)

    def encode_points(self, points, device="cuda") -> JacobianPoint:
        """Affine host points -> limb-major Jacobian batch on `device`, the
        encoding of the limb backends."""
        dev = F.resolve_device(device)
        o = self.point_ops
        zero = (0, 0) if self.curve.is_ext else 0
        one = (1, 0) if self.curve.is_ext else 1
        xs = [zero if pt is None else pt[0] for pt in points]
        ys = [one if pt is None else pt[1] for pt in points]
        zs = [zero if pt is None else one for pt in points]
        return JacobianPoint(*(F.as_tensor(o.encode(v), dev) for v in (xs, ys, zs)))

    def point_infinity_like(self, template: JacobianPoint) -> JacobianPoint:
        """Limb-form (0, 1, 0) batch for padding the point arrays."""
        o = self.point_ops
        return JacobianPoint(o.zeros_like(template.x), o.one_like(template.y),
                             o.zeros_like(template.z))

    def run_bucket_columns(self, px, py, qinf, head, slot, num_slots: int):
        return hybrid_accumulate_buckets(self.curve, px, py, qinf, head, slot, num_slots)


@functools.lru_cache(maxsize=None)
def rns_hybrid_curve_ops_for(curve: hostmath.WeierstrassCurve) -> RnsHybridCurveOps:
    return RnsHybridCurveOps(curve, backend="rns")
