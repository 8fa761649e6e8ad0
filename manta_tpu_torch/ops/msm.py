"""Pippenger multi-scalar multiplication on the GPU (PyTorch).

Port of `manta_tpu/ops/msm.py`, limb and fused backends:

1. **Windows**: c-bit windows (c <= 16); signed recoding halves the bucket
   count and trims the window count to ceil(bits/c).
2. **Bucket accumulation** — sequential-column segmented reduce, for all
   windows at once (the JAX package loops over windows; the sums are the
   same, the launches 1/W as many): one stable `torch.sort` of each window's
   digits; lane j of a window owns the contiguous sorted chunk [jK, (j+1)K)
   and K mixed additions walk every window's lanes together, the
   accumulator restarting at digit boundaries. On the fused backends
   (`_fused`) the K steps are ONE launch of a column kernel over all
   windows' lanes (K, *E, W·R), where the JAX package launches it once per
   window on R lanes; each lane keeps the chunk and the order of steps it has
   there, so every bucket value is bit for bit the JAX package's. The kernels
   take any lane count, so they also serve the R that the JAX package's
   kernel cannot (not a multiple of 128: there, K launches of the fused
   mixed addition add up the same per-lane chains). Completed runs land in
   their bucket: the fused backend's bucket column writes each run end
   straight into it (`_column_run_ends`, slots from `_run_end_slots`), and
   so does the "rns_hybrid" backend's hybrid bucket column; the "rns_fused"
   backend's column kernel writes the accumulator after every step, of
   which `_run_ends_compact` locates the run ends (`_column_stream`). Runs
   that span chunks leave trailing partials that a segmented fold adds into
   a second bucket batch.
3. **Bucket reduction**: sum_b b·S_b. On the fold path of the fused backend
   (`msm`'s `fold_path`) the trailing partials and the weighted sum go
   through the fold kernel (`_fold_trailing_fused`, `_weighted_fold_fused`);
   otherwise via b = 2^c2·h + l — row and column sums of the (2^c1, 2^c2)
   bucket matrix by pairwise halving, then two small weighted sums (suffix
   scans). Both batched over all windows. The fold kernel adds in another
   order than the JAX package's (a segmented scan), so the fold path's
   Jacobian coordinates differ from the JAX package's; its points do not.
   The trailing partials come back compact (each fold level's run ends and
   their bucket slots), and the fused backend's merge kernel adds them into
   the buckets in one launch (`merge_buckets`), where the JAX package adds
   two dense bucket batches.
4. **Window combine**: Horner over windows (c doublings per window),
   `horner`. On the fold path the window sums (`window_sums`) and Horner's
   rule are one launch of the fused backend's combine kernel
   (`combine_windows`). On the RNS backends each chain of doublings and an
   addition (Horner's rule, the weighted reductions' doubling runs) is one
   launch of their combine kernel (`double_add`, `_double_add`).

On the limb backend every field operation is one launch of the field kernel
on a CUDA tensor (`ops/kernels/field_kernels.py`); on the fused backend each
point formula is one launch (`ops/kernels/point_kernels.py`) and only the
glue (selects, negations) runs as field ops. The RNS backends
(`ops/kernels/rns_kernels.py`) have a column kernel and point-formula
kernels but no fold kernel, so they take the non-fold path; the hybrid one
keeps the affine point arrays as limbs (`point_ops`, `point_infinity_like`)
while its buckets are RNS. GLV is a later slice.
"""

from __future__ import annotations

import torch

from manta_tpu_torch import fields
from manta_tpu_torch.ops import curve as C
from manta_tpu_torch.ops import scan as S
from manta_tpu_torch.ops.curve import JacobianPoint

DEFAULT_WINDOW_BITS = 13
DEFAULT_COLUMN_STEPS = 128

_BIG = torch.iinfo(torch.int64).max


def _map(pt: JacobianPoint, fn) -> JacobianPoint:
    return JacobianPoint(fn(pt.x), fn(pt.y), fn(pt.z))


def _fused(cops: C.CurveOps) -> bool:
    """Fused backends: the column loop runs as one kernel, a bucket column
    that writes run ends only (`run_bucket_columns`: the fused backend,
    `ops/kernels/point_kernels.py`, and "rns_hybrid") or the "rns_fused"
    backend's stream column (`run_columns`, `ops/kernels/rns_kernels.py`)."""
    return hasattr(cops, "run_bucket_columns") or hasattr(cops, "run_columns")


def window_digits(scalars: torch.Tensor, window_bits: int) -> torch.Tensor:
    """(S_L, N) 16-bit limbs -> (W, N) int64 c-bit window digits, little-endian.

    Window w covers scalar bits [w*c, (w+1)*c); a digit may straddle two limbs."""
    if not 1 <= window_bits <= fields.LIMB_BITS:
        raise ValueError(f"window_bits must be in 1..{fields.LIMB_BITS}, got {window_bits}")
    sc = scalars.to(torch.int64)
    num_limbs = sc.shape[0]
    total_bits = num_limbs * fields.LIMB_BITS
    num_windows = -(-total_bits // window_bits)
    mask = (1 << window_bits) - 1
    rows = []
    for w in range(num_windows):
        i, sh = divmod(w * window_bits, fields.LIMB_BITS)
        d = sc[i] >> sh
        if sh + window_bits > fields.LIMB_BITS and i + 1 < num_limbs:
            d = d | (sc[i + 1] << (fields.LIMB_BITS - sh))
        rows.append(d & mask)
    return torch.stack(rows)


def window_digits_signed(scalars: torch.Tensor, window_bits: int, scalar_bits: int = 0):
    """Signed window recoding: (|digit|, negate, final carry) per window.

    Digits lie in [-(2^(c-1)-1), 2^(c-1)]: a raw digit u > 2^(c-1) becomes
    u - 2^c with a carry into the next window. With `scalar_bits` set, the
    windows above ceil((bits+1)/c) (all zero) are trimmed."""
    raw = window_digits(scalars, window_bits)
    if scalar_bits:
        num_windows = -(-(scalar_bits + 1) // window_bits)
        if num_windows > raw.shape[0]:
            raise ValueError(f"scalar_bits {scalar_bits} exceeds the scalars' limbs")
        raw = raw[:num_windows]
    half = 1 << (window_bits - 1)
    full = 1 << window_bits
    carry = torch.zeros_like(raw[0])
    digits, negs = [], []
    for u in raw:
        u2 = u + carry
        neg = u2 > half
        digits.append(torch.where(neg, full - u2, u2))
        negs.append(neg)
        carry = neg.to(raw.dtype)
    return torch.stack(digits), torch.stack(negs), carry


def _sorted_layout(digits: torch.Tensor, steps: int):
    """Sort each window's digits; return (perm, d_t, head, end) in the
    chunk-transposed layout: perm (W, K, R) and d_t/head/end (K, W, R) with
    element [k, w, j] = sorted_w[j*K + k]."""
    num_windows, n = digits.shape
    lanes = n // steps
    d_sorted, order = torch.sort(digits, dim=-1, stable=True)
    perm = order.reshape(num_windows, lanes, steps).transpose(1, 2)
    d_t = d_sorted.reshape(num_windows, lanes, steps).permute(2, 0, 1)
    big = torch.full((1, num_windows, 1), _BIG, dtype=d_t.dtype, device=d_t.device)
    prev = torch.cat([big.expand(1, num_windows, lanes), d_t[:-1]])
    head = d_t != prev  # run restarts (k == 0 or digit change)
    next_last = torch.cat([d_t[0, :, 1:], big[0]], dim=-1)
    nxt = torch.cat([d_t[1:], next_last[None]])
    end = d_t != nxt  # true segment ends in each window's sorted order
    return perm, d_t, head, end


def _bucket_template(cops: C.CurveOps, acc: JacobianPoint, num_buckets: int):
    """Infinity buckets shaped like the (*E, W, R) accumulator, R -> buckets."""

    def tmpl(a):
        return torch.zeros((*a.shape[:-1], num_buckets), dtype=a.dtype, device=a.device)

    return cops.infinity_like(_map(acc, tmpl))


class _BucketStore:
    """(*E, W, num_buckets) buckets plus one spare slot per lane and window.

    Writes aimed at the spare slots are the dropped writes of the JAX
    package's `.at[idx].set(mode="drop")`; `buckets()` slices them off."""

    def __init__(self, binf: JacobianPoint, lanes: int):
        nb = binf.x.shape[-1]
        self.num_buckets, self.width = nb, nb + lanes
        num_windows = binf.x.shape[-2]
        dev = binf.x.device
        self.base = torch.arange(num_windows, device=dev)[:, None] * self.width
        self.spare = nb + torch.arange(lanes, device=dev)
        self.flat = _map(
            binf,
            lambda a: torch.cat([a, a[..., :1].expand(*a.shape[:-1], lanes)], -1).reshape(
                *a.shape[:-2], num_windows * self.width
            ),
        )

    def put(self, keep: torch.Tensor, key: torch.Tensor, val: JacobianPoint) -> None:
        """Bucket key[w, j] of window w takes val[..., w, j] where `keep`."""
        idx = (torch.where(keep, key, self.spare) + self.base).reshape(-1)
        for store, v in zip(self.flat, val):
            store.index_copy_(store.ndim - 1, idx, v.reshape(*v.shape[:-2], -1))

    def buckets(self) -> JacobianPoint:
        nw = self.base.shape[0]
        return _map(
            self.flat,
            lambda a: a.reshape(*a.shape[:-1], nw, self.width)[..., : self.num_buckets],
        )


def _fold_partials(
    cops: C.CurveOps,
    acc: JacobianPoint,
    d_t: torch.Tensor,
    binf: JacobianPoint,
    num_buckets: int,
) -> JacobianPoint:
    """Fold cross-chunk trailing partials into a second bucket batch.

    Chunk j's last run continues into chunk j+1 iff the digit matches across
    the boundary; equal-key (adjacent) partials fold with one segmented scan
    — run over all windows at once, keys made unique per window so that no
    segment crosses a window — and the group totals land at their buckets."""
    o = cops.ops
    num_windows, lanes = d_t.shape[1:]
    dev = d_t.device
    last_d, first_d = d_t[-1], d_t[0]
    cont = torch.cat(
        [last_d[:, :-1] == first_d[:, 1:], torch.zeros((num_windows, 1), dtype=torch.bool, device=dev)],
        dim=-1,
    )
    inf_r = cops.infinity_like(acc)
    val = JacobianPoint(
        o.select(cont, acc.x, inf_r.x),
        o.select(cont, acc.y, inf_r.y),
        o.select(cont, acc.z, inf_r.z),
    )
    key = torch.where(cont, last_d, torch.full_like(last_d, num_buckets))
    key_flat = (key + torch.arange(num_windows, device=dev)[:, None] * (num_buckets + 1)).reshape(-1)
    change = key_flat[1:] != key_flat[:-1]
    true1 = torch.ones((1,), dtype=torch.bool, device=dev)
    scanned = S.seg_scan(
        cops, _map(val, lambda a: a.reshape(*a.shape[:-2], -1)), torch.cat([true1, change])
    )
    ends = torch.cat([change, true1]).reshape(num_windows, lanes)
    store = _BucketStore(binf, lanes)
    store.put(ends, key, _map(scanned, lambda a: a.reshape(*a.shape[:-1], num_windows, lanes)))
    return store.buckets()


def _run_ends_compact(d_flat: torch.Tensor, end_flat: torch.Tensor, num_buckets: int):
    """Locate each window's run ends with index math over rows (W, KR):
    pos_c[w, s] is the stream position of the end of window w's s-th run
    (clamped), idx_b[w, s] its bucket (num_buckets = no run, dropped)."""
    num_windows, kr = d_flat.shape
    rank = torch.cumsum(end_flat.to(torch.int64), -1)
    slots = torch.where(end_flat, rank - 1, num_buckets).clamp_(max=num_buckets)
    iota = torch.arange(kr, device=d_flat.device).expand(num_windows, kr)
    pos = torch.full((num_windows, num_buckets + 1), kr, dtype=torch.int64, device=d_flat.device)
    pos = pos.scatter_(-1, slots, iota)[:, :num_buckets]
    valid = pos < kr
    pos_c = pos.clamp(max=kr - 1)
    idx_b = torch.where(valid, d_flat.gather(-1, pos_c), num_buckets)
    return pos_c, idx_b


def _scatter_drop(binf: JacobianPoint, idx: torch.Tensor, val: JacobianPoint) -> JacobianPoint:
    """binf with val[..., s] written at bucket idx[..., s] along the last
    axis; an index equal to the bucket count is dropped (the JAX package's
    `.at[idx].set(mode="drop")`)."""

    def put(b, v):
        spare = torch.cat([b, b[..., :1]], -1).contiguous()
        ix = idx.expand(*v.shape[:-idx.ndim], *idx.shape)
        return spare.scatter_(-1, ix, v)[..., : b.shape[-1]]

    return JacobianPoint(*(put(b, v) for b, v in zip(binf, val)))


def _run_end_slots(d_t: torch.Tensor, end: torch.Tensor, num_buckets: int) -> torch.Tensor:
    """(K, W·R) int32: w·num_buckets + digit at each step and lane where a
    run ends in window w's sorted order (`_sorted_layout`'s `end`), else -1:
    the bucket each run end lands in, unique per window."""
    steps, num_windows, lanes = d_t.shape
    base = torch.arange(num_windows, device=d_t.device)[:, None] * num_buckets
    slot = torch.where(end, d_t + base, -1)
    return slot.to(torch.int32).reshape(steps, num_windows * lanes)


def _column_run_ends(cops, px, py, qinf, head, d_t, end, num_buckets: int):
    """The bucket column (fused and "rns_hybrid"): one launch writes each run end
    into its bucket and the last step's accumulator; no (K, *E, W·R)
    stream. Returns the (*E, W, num_buckets) buckets (infinity where no run
    ends) and the trailing accumulators (*E, W, R)."""
    steps, num_windows, lanes = d_t.shape
    slot = _run_end_slots(d_t, end, num_buckets)
    buckets, acc = cops.run_bucket_columns(px, py, qinf, head, slot, num_windows * num_buckets)
    return (_map(buckets, lambda a: a.reshape(*a.shape[:-1], num_windows, num_buckets)),
            _map(acc, lambda a: a.reshape(*a.shape[:-1], num_windows, lanes)))


def _column_stream(cops, px, py, qinf, head, d_t, end, num_buckets: int):
    """The "rns_fused" backend's column kernel: the accumulator after every step,
    (K, *E, W·R); the <= num_buckets run-end values of each window are
    picked out of it and written to their buckets. Same returns as
    `_column_run_ends`."""
    steps, num_windows, lanes = d_t.shape
    ox, oy, oz = cops.run_columns(px, py, qinf, head)
    stream = JacobianPoint(
        *(a.reshape(*a.shape[:-1], num_windows, lanes) for a in (ox, oy, oz))
    )  # (K, *E, W, R)

    def tmpl(a):
        return torch.zeros((*a.shape[1:-1], num_buckets), dtype=a.dtype, device=a.device)

    binf = cops.infinity_like(_map(stream, tmpl))
    # run ends in each window's stream order [k, j] -> k*R + j
    d_flat = d_t.permute(1, 0, 2).reshape(num_windows, -1)
    end_flat = end.permute(1, 0, 2).reshape(num_windows, -1)
    pos_c, idx_b = _run_ends_compact(d_flat, end_flat, num_buckets)

    def pick(a):  # (K, *E, W, R) -> (*E, W, num_buckets) values at run ends
        flat = a.movedim(0, -2).reshape(*a.shape[1:-2], num_windows, steps * lanes)
        return flat.gather(-1, pos_c.expand(*flat.shape[:-2], *pos_c.shape))

    buckets = _scatter_drop(binf, idx_b, _map(stream, pick))
    # the last step is all that stays: copying it frees the (K, *E, W·R)
    # streams (0.8–1.6 GB an MSM of the production prover) at return
    return buckets, _map(stream, lambda a: a[-1].clone())


def _bucket_sums_fused(
    cops: C.CurveOps,
    digits: torch.Tensor,
    points: JacobianPoint,
    num_buckets: int,
    steps: int,
    negs=None,
    parts: bool = False,
):
    """Fused bucket accumulation, all windows at once: one column-kernel
    launch over the (K, *E, W·R) sorted affine stream; the <= num_buckets
    run-end values of each window land in their buckets
    (`_column_run_ends` where the backend has a bucket column,
    `_column_stream` on "rns_fused").

    Returns the (*E, W, num_buckets) buckets; with `parts`, instead the
    run-end buckets, the trailing accumulators (*E, W, R) and d_t (K, W, R)
    for the fold path."""
    num_windows, n = digits.shape
    lanes = n // steps
    perm, d_t, head, end = _sorted_layout(digits, steps)

    def gather(a):  # (*E, n) -> (K, *E, W*R), contiguous per step
        g = a[..., perm].movedim(-2, 0)
        return g.reshape(*g.shape[:-2], num_windows * lanes)

    # the point arrays' own field ops: split-representation backends (limb
    # points feeding an RNS accumulation) name them `point_ops`
    po = getattr(cops, "point_ops", None) or cops.ops
    if cops.limb16_points:
        # (L, n) rows of 16-bit limbs: gather x and y two to a word
        g = gather(points.x | (points.y << 16))
        px, py = g & 0xFFFF, (g >> 16) & 0xFFFF
    else:
        px, py = gather(points.x), gather(points.y)
    if negs is not None:
        neg_t = negs.gather(-1, perm.reshape(num_windows, -1)).reshape(perm.shape)
        neg_t = neg_t.permute(1, 0, 2).reshape(steps, *(1,) * (py.ndim - 2), -1)
        py = torch.where(neg_t, gather(po.neg(points.y)), py)
    qinf = cops.affine_infinity_mask(points)[perm].permute(1, 0, 2)  # (K, W, R)
    column = _column_run_ends if hasattr(cops, "run_bucket_columns") else _column_stream
    buckets_a, acc_last = column(cops, px, py, qinf.reshape(steps, -1),
                                 head.reshape(steps, -1), d_t, end, num_buckets)
    if parts:
        return buckets_a, acc_last, d_t
    binf = cops.infinity_like(buckets_a)
    buckets_b = _fold_partials(cops, acc_last, d_t, binf, num_buckets)
    return cops.add(buckets_a, buckets_b)


def _bucket_sums(
    cops: C.CurveOps,
    digits: torch.Tensor,
    points: JacobianPoint,
    num_buckets: int,
    column_steps: int,
    negs=None,
) -> JacobianPoint:
    """S[w, b] = sum of the points whose window-w digit is b, all windows at
    once: (*E, W, num_buckets), empty buckets at infinity.

    digits: (W, n) with n = R*K (pre-padded); points: affine Jacobian batch
    (*E, n), Z in {0, 1}; negs: (W, n) bool, lanes whose point enters window
    w negated (signed digits), or None."""
    num_windows, n = digits.shape
    steps = min(column_steps, n)
    lanes = n // steps
    assert lanes * steps == n
    if _fused(cops):
        return _bucket_sums_fused(cops, digits, points, num_buckets, steps, negs)
    o = cops.ops
    perm, d_t, head, end = _sorted_layout(digits, steps)

    def gather(a):  # (*E, n) -> (K, *E, W, R), contiguous per step
        return a[..., perm].movedim(-2, 0).contiguous()

    px, pz = gather(points.x), gather(points.z)
    py = gather(points.y)
    if negs is not None:
        neg_t = negs.gather(-1, perm.reshape(num_windows, -1)).reshape(perm.shape)
        neg_t = neg_t.permute(1, 0, 2)  # (K, W, R)
        neg_t = neg_t.reshape(steps, *(1,) * (py.ndim - 3), num_windows, lanes)
        py = torch.where(neg_t, gather(o.neg(points.y)), py)
    acc = cops.infinity_like(JacobianPoint(px[0], py[0], pz[0]))
    binf = _bucket_template(cops, acc, num_buckets)
    store = _BucketStore(binf, lanes)
    for k in range(steps):
        p_k = JacobianPoint(px[k], py[k], pz[k])
        added = cops.madd(acc, p_k)
        acc = JacobianPoint(
            o.select(head[k], p_k.x, added.x),
            o.select(head[k], p_k.y, added.y),
            o.select(head[k], p_k.z, added.z),
        )
        # completed runs land in their bucket; the others in the spare slots
        store.put(end[k], d_t[k], acc)
    buckets_b = _fold_partials(cops, acc, d_t, binf, num_buckets)
    return cops.add(store.buckets(), buckets_b)


def _chunk_t(a: torch.Tensor, k2: int) -> torch.Tensor:
    """(..., n) -> (K2, ..., n // K2) with out[k, ..., j] = a[..., j*K2 + k]:
    each output lane owns a contiguous chunk, as in `_sorted_layout`."""
    return a.reshape(*a.shape[:-1], a.shape[-1] // k2, k2).movedim(-1, 0)


def _merge_lanes(a: torch.Tensor) -> torch.Tensor:
    """(K, ..., W, R2) -> (K, ..., W*R2): windows stay lane-separated."""
    return a.reshape(*a.shape[:-2], a.shape[-2] * a.shape[-1])


def _fold_trailing_fused(
    cops: C.CurveOps, acc_last: JacobianPoint, last_d, first_d, num_buckets: int
):
    """Fold the per-window cross-chunk trailing partials through the fold
    kernel (2 levels), all windows at once: the semantics of `_fold_partials`.

    acc_last: (*E, W, R) trailing accumulators; last_d/first_d: (W, R) last
    and first digit of each chunk. Returns each level's deposits compact,
    (values (*E, n), slots (n,)): the fold's value at every step and lane and
    the bucket slot w·num_buckets + digit where a run ends there, else -1;
    the slots of a level are unique. The JAX package scatters them into two
    (*E, W, num_buckets) bucket arrays instead; the caller adds them in
    (`merge_buckets`). Level 2 runs on W lanes where the JAX package pads
    them to 128 with dead rows, which deposit nothing."""
    o = cops.ops
    num_windows, lanes = last_d.shape
    r2 = 128
    k2 = lanes // r2
    bp = num_buckets + 1  # per-window slots incl. one garbage column
    dead = num_windows * bp  # out of range everywhere -> dropped
    dev = last_d.device
    w_ids = torch.arange(num_windows, device=dev)[:, None]
    # lane j's trailing partial joins iff its run continues into lane j+1;
    # keys w*bp + digit keep windows apart
    no = torch.zeros((num_windows, 1), dtype=torch.bool, device=dev)
    cont = torch.cat([last_d[:, :-1] == first_d[:, 1:], no], -1)
    key = torch.where(cont, w_ids * bp + last_d, dead)
    inf = cops.infinity_like(acc_last)
    val = JacobianPoint(*(o.select(cont, a, i) for a, i in zip(acc_last, inf)))

    def level(val, key, rows, k):
        """One fold level over `rows` sequences (key (rows, seqlen), val
        (*E, rows, seqlen)): chunk-transpose into (k, rows*seqlen/k), run the
        fold kernel; its values and their slots at the run ends."""
        kt = _merge_lanes(_chunk_t(key, k))  # (k, lanes)
        ct = _map(val, lambda a: _merge_lanes(_chunk_t(a, k)))
        first = torch.ones((1, kt.shape[1]), dtype=torch.bool, device=dev)
        head = torch.cat([first, kt[1:] != kt[:-1]])
        astream, _ = cops.run_fold_columns(ct.x, ct.y, ct.z, head, False)
        last = torch.ones((rows, 1), dtype=torch.bool, device=dev)
        end_seq = torch.cat([key[:, :-1] != key[:, 1:], last], -1)
        end_flat = _merge_lanes(_chunk_t(end_seq, k)).reshape(-1)
        end_key = torch.where(end_flat, kt.reshape(-1), dead)
        slots = torch.where(end_key < dead, end_key // bp * num_buckets + end_key % bp, -1)
        flat = _map(astream, lambda a: a.movedim(0, -2).reshape(*a.shape[1:-1], -1))
        return (flat, slots), _map(astream, lambda a: a[-1]), kt

    # level 1: W rows of R-long sequences -> (K2 steps, W*128 lanes)
    b1, trail1, kt1 = level(val, key, num_windows, k2)
    # level 2: each window's 128 lane-trailing partials, one 128-step chain
    tkey, fkey = kt1[-1], kt1[0]  # lane order l = w*128 + j2
    cont2 = torch.cat([tkey[:-1] == fkey[1:], no[0]])
    key2 = torch.where(cont2, tkey, dead)
    inf2 = cops.infinity_like(trail1)
    val2 = JacobianPoint(*(o.select(cont2, a, i) for a, i in zip(trail1, inf2)))
    rows2 = _map(val2, lambda a: a.reshape(*a.shape[:-1], num_windows, r2))
    b2, _, _ = level(rows2, key2.reshape(num_windows, r2), num_windows, r2)
    return b1, b2


def _weighted_fold_fused(cops: C.CurveOps, buckets: JacobianPoint, num_buckets: int, signed: bool):
    """sum_{b>=1} b·S_b per window through the fold kernel, up to its last
    step (`window_sums`).

    buckets: (*E, W, num_buckets). Split b = j·Kw + m' (m' in [1, Kw]):
    feeding each kernel lane its buckets in DESCENDING order makes the
    kernel's sum B end at sum_m' m'·S and A at T_j = sum S. Then sum_b b·S_b
    = Kw·sum_j j·T_j + sum_j B_j, the level-2 sums by one more fold launch
    over lanes [T | B] (2W lanes; the JAX package pads them to 128). Returns
    that launch's last A row and its B, (*E, 2W) each, and log2(Kw)."""
    num_windows = buckets.x.shape[-2]
    m = num_buckets - 1 if signed else num_buckets  # covered b range [1, M]
    rw = 128
    kw = m // rw

    def stream1(a):
        s = a[..., 1:]  # drop bucket 0 (weight 0)
        if not signed:
            # a phantom bucket at b = 2^c: zeros, which the formulas treat as infinity
            s = torch.cat([s, s.new_zeros((*s.shape[:-1], 1))], -1)
        r = s.reshape(*s.shape[:-1], rw, kw).flip(-1).movedim(-1, 0)  # (Kw, *E, W, Rw)
        return _merge_lanes(r)

    heads = torch.zeros((kw, num_windows * rw), dtype=torch.bool, device=buckets.x.device)
    astr, b_sum = cops.run_fold_columns(*map(stream1, buckets), heads, True)
    t_sum = _map(astr, lambda a: a[-1])  # (*E, W*Rw)

    def stream2(a_t, a_b):  # per window: T descending j, then B -> (Rw, *E, 2W)
        rt = a_t.reshape(*a_t.shape[:-1], num_windows, rw).flip(-1)
        rb = a_b.reshape(*a_b.shape[:-1], num_windows, rw)
        return torch.cat([rt, rb], -2).movedim(-1, 0).contiguous()

    heads2 = torch.zeros((rw, 2 * num_windows), dtype=torch.bool, device=buckets.x.device)
    astr2, fin_b = cops.run_fold_columns(
        *(stream2(t, b) for t, b in zip(t_sum, b_sum)), heads2, True
    )
    return _map(astr2, lambda a: a[-1]), fin_b, kw.bit_length() - 1


def window_sums(cops: C.CurveOps, a: JacobianPoint, b: JacobianPoint, doublings: int):
    """The window sums S_w = 2^doublings·(B2 − A2) + A3 from the weighted
    fold's level-2 rows a, b (*E, 2W): A2 = sum_j T_j = a[..., :W], B2 =
    sum_j (j+1)·T_j = b[..., :W], A3 = sum_j B_j = a[..., W:]. Returns
    (*E, W, 1), the layout `horner` takes."""
    num_windows = a.x.shape[-1] // 2
    a2 = _map(a, lambda t: t[..., :num_windows])
    b2 = _map(b, lambda t: t[..., :num_windows])
    a3 = _map(a, lambda t: t[..., num_windows:])
    d = cops.add(b2, cops.neg(a2))
    for _ in range(doublings):
        d = cops.double(d)
    return _map(cops.add(d, a3), lambda t: t[..., None])


def double_add_loop(cops: C.CurveOps, init: JacobianPoint, addends: JacobianPoint,
                    doublings: int, chain_first: bool = True) -> JacobianPoint:
    """acc = init; for each addend w of addends (S, *E, ...) in turn:
    `doublings` doublings of acc, then acc = add(acc, w) (chain_first) or
    add(w, acc). One launch per formula on the kernel backends."""
    acc = init
    for s in range(addends.x.shape[0]):
        for _ in range(doublings):
            acc = cops.double(acc)
        w = _map(addends, lambda a: a[s])
        acc = cops.add(acc, w) if chain_first else cops.add(w, acc)
    return acc


def _double_add(cops: C.CurveOps, init, addends, doublings: int, chain_first: bool = True):
    """`double_add_loop`, as one launch of the backend's combine kernel where
    it has one (`double_add`: the RNS backends)."""
    if hasattr(cops, "double_add"):
        return cops.double_add(init, addends, doublings, chain_first)
    return double_add_loop(cops, init, addends, doublings, chain_first)


def horner(cops: C.CurveOps, wins: JacobianPoint, window_bits: int) -> JacobianPoint:
    """Horner from the most significant window down over wins (*E, W, 1):
    acc = W_last; for w = last-1..0: acc = 2^c·acc + W_w. Returns (*E, 1)."""
    acc = _map(wins, lambda a: a[..., -1, :])
    if hasattr(cops, "double_add"):
        # one combine launch over the addends W_{last-1}, ..., W_0: (W-1, *E, 1)
        rest = _map(wins, lambda a: a[..., :-1, :].flip(-2).movedim(-2, 0))
        return cops.double_add(acc, rest, window_bits)
    for w in range(wins.x.shape[-2] - 2, -1, -1):
        for _ in range(window_bits):
            acc = cops.double(acc)
        acc = cops.add(acc, _map(wins, lambda a: a[..., w, :]))
    return acc


def _tree_reduce_last(cops: C.CurveOps, pts: JacobianPoint) -> JacobianPoint:
    """Pairwise-halving sum over the (power-of-two) trailing axis -> length 1.

    Lane 0 gets the same additions, in the same order, as the JAX package's
    rolled halving (`_tree_reduce_rolled`)."""
    n = pts.x.shape[-1]
    assert n & (n - 1) == 0
    while n > 1:
        half = n // 2
        lo = _map(pts, lambda a: a[..., :half])
        hi = _map(pts, lambda a: a[..., half:])
        pts = cops.add(lo, hi)
        n = half
    return pts


def _weighted_linear(cops: C.CurveOps, buckets: JacobianPoint) -> JacobianPoint:
    """sum_{b>=1} b*S_b = sum_{b>=1} suffix[b], suffix[b] = sum_{b'>=b} S_b'."""
    lane0 = torch.zeros((buckets.x.shape[-1],), dtype=torch.bool, device=buckets.x.device)
    lane0[0] = True
    inf = cops.infinity_like(buckets)
    o = cops.ops
    b0 = JacobianPoint(
        o.select(lane0, inf.x, buckets.x),
        o.select(lane0, inf.y, buckets.y),
        o.select(lane0, inf.z, buckets.z),
    )
    suffix = S.suffix_scan(cops, b0)
    # suffix[0] duplicates suffix[1]; mask it out, then sum all lanes
    masked = JacobianPoint(
        o.select(lane0, inf.x, suffix.x),
        o.select(lane0, inf.y, suffix.y),
        o.select(lane0, inf.z, suffix.z),
    )
    return S.total_sum(cops, masked)


def _weighted_reduce(cops: C.CurveOps, buckets: JacobianPoint, window_bits: int) -> JacobianPoint:
    """sum_{b>=1} b*S_b over 2^c buckets via b = 2^c2*h + l."""
    c1 = window_bits // 2
    c2 = window_bits - c1
    hi_n, lo_n = 1 << c1, 1 << c2
    mat = _map(buckets, lambda a: a.reshape(*a.shape[:-1], hi_n, lo_n))
    row_sums = _map(_tree_reduce_last(cops, mat), lambda a: a[..., 0])  # sum over l
    mat_t = _map(mat, lambda a: a.transpose(-1, -2))
    col_sums = _map(_tree_reduce_last(cops, mat_t), lambda a: a[..., 0])  # sum over h
    w_hi = _weighted_linear(cops, row_sums)  # sum_h h*R_h
    w_lo = _weighted_linear(cops, col_sums)  # sum_l l*C_l
    # 2^c2·w_hi + w_lo
    return _double_add(cops, w_hi, _map(w_lo, lambda a: a[None]), c2)


def _weighted_reduce_signed(
    cops: C.CurveOps, buckets: JacobianPoint, window_bits: int
) -> JacobianPoint:
    """Weighted reduce over 2^(c-1)+1 signed-digit buckets: the split-index
    identity on [0, 2^(c-1)), plus the top-weight bucket folded in with c-1
    doublings."""
    half_bits = window_bits - 1
    main = _map(buckets, lambda a: a[..., : 1 << half_bits])
    top = _map(buckets, lambda a: a[..., 1 << half_bits : (1 << half_bits) + 1])
    acc = _weighted_reduce(cops, main, half_bits)
    # acc + 2^(c-1)·top: the doubled point is the addition's second operand
    return _double_add(cops, top, _map(acc, lambda a: a[None]), half_bits, chain_first=False)


@torch.inference_mode()
def msm(
    cops: C.CurveOps,
    scalars: torch.Tensor,
    points: JacobianPoint,
    window_bits: int = DEFAULT_WINDOW_BITS,
    column_steps: int = DEFAULT_COLUMN_STEPS,
    scalar_bits: int = 0,
    signed: bool = True,
) -> JacobianPoint:
    """sum_i scalars[i] * points[i].

    scalars: (S_L, N) canonical (non-Montgomery) 16-bit limbs of the scalar
    field, on the points' device. points: Jacobian batch of N affine points
    (Z in {0, 1}, as `encode_points`/`to_affine` give them). Returns a
    single-lane Jacobian point."""
    num_buckets = (1 << (window_bits - 1)) + 1 if signed else 1 << window_bits
    n = points.x.shape[-1]
    if scalars.shape[-1] != n:
        raise ValueError(f"scalar lanes ({scalars.shape[-1]}) != point lanes ({n})")
    steps = min(column_steps, n)
    n2 = -(-n // steps) * steps
    if n2 != n:
        # pad with infinity points, digit 0 (bucket 0 has weight 0)
        pad = n2 - n
        scalars = torch.cat([scalars, scalars.new_zeros((scalars.shape[0], pad))], -1)
        inf = getattr(cops, "point_infinity_like", cops.infinity_like)(points)
        points = JacobianPoint(
            *(torch.cat([a, ia[..., :pad]], -1) for a, ia in zip(points, inf))
        )
    if signed:
        digits, negs, _ = window_digits_signed(scalars, window_bits, scalar_bits)
    else:
        digits, negs = window_digits(scalars, window_bits), None
    num_windows = digits.shape[0]
    lanes = n2 // steps
    covered = num_buckets - 1 if signed else num_buckets
    fold_path = (
        hasattr(cops, "run_fold_columns")
        and lanes % 128 == 0
        and covered % 128 == 0
        and 2 * num_windows <= 128
    )
    if fold_path:
        bucket_a, acc_last, d_t = _bucket_sums_fused(
            cops, digits, points, num_buckets, steps, negs, parts=True
        )
        (v1, key1), (v2, key2) = _fold_trailing_fused(cops, acc_last, d_t[-1], d_t[0],
                                                      num_buckets)
        shape = bucket_a.x.shape
        merged = cops.merge_buckets(_map(bucket_a, lambda a: a.reshape(*shape[:-2], -1)),
                                    v1, key1, v2, key2)
        buckets = _map(merged, lambda a: a.reshape(shape))
        a, b, doublings = _weighted_fold_fused(cops, buckets, num_buckets, signed)
        return cops.combine_windows(a, b, doublings, window_bits)
    buckets = _bucket_sums(cops, digits, points, num_buckets, steps, negs)
    if signed:
        wins = _weighted_reduce_signed(cops, buckets, window_bits)
    else:
        wins = _weighted_reduce(cops, buckets, window_bits)  # coords (*E, W, 1)
    return horner(cops, wins, window_bits)


def msm_host_oracle(curve, scalars, points):
    """Slow host-side MSM for tests."""
    return curve.msm(scalars, points)
