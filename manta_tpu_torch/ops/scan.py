"""Segmented scans over elliptic-curve point batches.

Port of `manta_tpu/ops/scan.py`, same two-level decomposition so results
match lane for lane:

1. reshape the batch to (blocks, B) and run a Hillis-Steele segmented scan
   within blocks — log2(B) steps, each ONE full-width point addition;
2. scan the block tails across blocks with the same head-flag monoid;
3. add each block's carry into the lanes that precede the block's first
   segment head.

Cost: ~(log2(B) + 1)·n point additions of full lane width. Used by the MSM
bucket machinery (`manta_tpu_torch.ops.msm`) for the cross-chunk partial
fold, suffix sums and total reduction.
"""

from __future__ import annotations

import torch

from manta_tpu_torch.ops import curve as C
from manta_tpu_torch.ops.curve import JacobianPoint


def _shift_right(arr: torch.Tensor, offset: int, fill: torch.Tensor) -> torch.Tensor:
    """out[..., i] = arr[..., i - offset], `fill` values entering from the left."""
    n = arr.shape[-1]
    fill = fill.expand(arr.shape)
    return torch.cat([fill[..., :offset], arr[..., : n - offset]], dim=-1)


def _squeeze_to_rank(mask: torch.Tensor, rank: int) -> torch.Tensor:
    """Drop leading size-1 axes until `mask` has `rank` dims."""
    while mask.ndim > rank:
        assert mask.shape[0] == 1
        mask = mask[0]
    return mask


def _hillis_steele(cops: C.CurveOps, pts: JacobianPoint, heads: torch.Tensor, scan_rank: int):
    """Inclusive segmented scan along the last axis.

    pts coords: (coord_dims..., *scan_shape); heads: bool (1..., *scan_shape).
    Lanes where a head has been seen stop absorbing from the left."""
    n = pts.x.shape[-1]
    steps = max(1, (n - 1).bit_length())
    inf = cops.infinity_like(pts)
    o = cops.ops
    vx, vy, vz, h = pts.x, pts.y, pts.z, heads
    for k in range(steps):
        off = min(1 << k, n)
        sx = _shift_right(vx, off, inf.x)
        sy = _shift_right(vy, off, inf.y)
        sz = _shift_right(vz, off, inf.z)
        sh = _shift_right(h, off, torch.ones_like(h))
        summed = cops.add(JacobianPoint(sx, sy, sz), JacobianPoint(vx, vy, vz))
        absorb = _squeeze_to_rank(~h, scan_rank)
        vx = o.select(absorb, summed.x, vx)
        vy = o.select(absorb, summed.y, vy)
        vz = o.select(absorb, summed.z, vz)
        h = h | sh
    return JacobianPoint(vx, vy, vz), h


def seg_scan(cops: C.CurveOps, pts: JacobianPoint, heads: torch.Tensor, block: int = 128):
    """Inclusive segmented scan over a 1D batch (trailing axis), two-level.

    pts coords: (..., n); heads: bool (n,). Returns scanned points."""
    n = pts.x.shape[-1]
    if n <= block:
        scanned, _ = _hillis_steele(
            cops, pts, heads.reshape((1,) * (pts.x.ndim - 1) + (-1,)), 1
        )
        return scanned
    if n % block:
        # pad with infinity lanes forming their own segment, slice back after
        pad = block - n % block
        inf = cops.infinity_like(pts)

        def pad_c(a, ia):
            return torch.cat([a, ia[..., :pad]], dim=-1)

        padded = JacobianPoint(pad_c(pts.x, inf.x), pad_c(pts.y, inf.y), pad_c(pts.z, inf.z))
        padded_heads = torch.cat([heads, heads.new_ones((pad,))])
        out = seg_scan(cops, padded, padded_heads, block=block)
        return JacobianPoint(out.x[..., :n], out.y[..., :n], out.z[..., :n])
    nb = n // block
    o = cops.ops

    def to_blocks(a):
        return a.reshape(*a.shape[:-1], nb, block)

    def from_blocks(a):
        return a.reshape(*a.shape[:-2], n)

    bp = JacobianPoint(to_blocks(pts.x), to_blocks(pts.y), to_blocks(pts.z))
    bh = heads.reshape((1,) * (pts.x.ndim - 1) + (nb, block))

    # level 1: within blocks; the true "head at or before lane" mask is
    # computed separately (the scan's flag is polluted by the block fill)
    scanned, _ = _hillis_steele(cops, bp, bh, 2)
    seen = torch.cumsum(bh.to(torch.int32), dim=-1) > 0

    # level 2: block tails across blocks, segmented by block-has-head
    tails = JacobianPoint(scanned.x[..., -1], scanned.y[..., -1], scanned.z[..., -1])
    block_has_head = bh.any(dim=-1)
    tail_scan, _ = _hillis_steele(cops, tails, block_has_head, 1)

    # level 3: carry for block r = tail_scan[r-1], added into the lanes that
    # have not yet seen a head inside their block
    inf_t = cops.infinity_like(tails)
    carry = JacobianPoint(
        _shift_right(tail_scan.x, 1, inf_t.x),
        _shift_right(tail_scan.y, 1, inf_t.y),
        _shift_right(tail_scan.z, 1, inf_t.z),
    )
    carry_full = JacobianPoint(
        carry.x[..., None].expand(scanned.x.shape),
        carry.y[..., None].expand(scanned.y.shape),
        carry.z[..., None].expand(scanned.z.shape),
    )
    fixed = cops.add(carry_full, scanned)
    lane_mask = _squeeze_to_rank(seen, 2)
    out = JacobianPoint(
        o.select(lane_mask, scanned.x, fixed.x),
        o.select(lane_mask, scanned.y, fixed.y),
        o.select(lane_mask, scanned.z, fixed.z),
    )
    return JacobianPoint(from_blocks(out.x), from_blocks(out.y), from_blocks(out.z))


def prefix_scan(cops: C.CurveOps, pts: JacobianPoint, block: int = 128):
    """Unsegmented inclusive prefix scan (one segment starting at lane 0)."""
    n = pts.x.shape[-1]
    heads = torch.zeros((n,), dtype=torch.bool, device=pts.x.device)
    heads[0] = True
    return seg_scan(cops, pts, heads, block=block)


def suffix_scan(cops: C.CurveOps, pts: JacobianPoint, block: int = 128):
    """Unsegmented inclusive suffix scan: out[i] = sum_{j>=i} pts[j]."""
    rev = JacobianPoint(pts.x.flip(-1), pts.y.flip(-1), pts.z.flip(-1))
    scanned = prefix_scan(cops, rev, block=block)
    return JacobianPoint(scanned.x.flip(-1), scanned.y.flip(-1), scanned.z.flip(-1))


def total_sum(cops: C.CurveOps, pts: JacobianPoint, block: int = 128):
    """Sum of all points: the last lane of the prefix scan."""
    scanned = prefix_scan(cops, pts, block=block)
    return JacobianPoint(scanned.x[..., -1:], scanned.y[..., -1:], scanned.z[..., -1:])
