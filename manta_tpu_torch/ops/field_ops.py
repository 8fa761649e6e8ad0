"""Batched prime-field arithmetic on the GPU (PyTorch).

Field elements are little-endian base-2^16 limb vectors in **limb-major
layout**: shape ``(L, ...)`` with ``L = spec.num_limbs`` and all trailing
axes batch, held in ``torch.int32`` (every limb is < 2^16). Values are kept in
**Montgomery form** (x·R mod p, R = 2^(16·L)) and **lazy** in [0, 2p): a
Montgomery product has no trailing conditional subtract (sound because
4p < R for every supported field), add/sub reduce against 2p, the two
residues of zero are {0, p}, and `normalize` folds back to [0, p).

This is the layout of the JAX package's `manta_tpu/ops/field_ops.py`, so
limb arrays and `.npz` caches cross between the two unchanged. This module
is the one place where numpy ``uint32`` limb arrays become int32 tensors and
back (`as_tensor`, `to_numpy`).

`add`, `sub` and `mont_mul` dispatch on the tensor's device: CUDA tensors go
to the hand-written kernel (`ops/kernels/field_kernels.py`), CPU tensors to
its plain PyTorch version. Everything else here is plain PyTorch on either
device, built on those three.
"""

from __future__ import annotations

import numpy as np
import torch

from manta_tpu_torch.fields import LIMB_BITS, LIMB_MASK, FieldSpec
from manta_tpu_torch.ops.kernels import field_kernels as K

DTYPE = torch.int32


# ---------------------------------------------------------------------------
# Devices and the numpy boundary
# ---------------------------------------------------------------------------


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on. CUDA is the default; asking for it
    without a card raises instead of running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' was asked for but no CUDA device is present "
            "(pass device='cpu' to run the plain PyTorch versions)"
        )
    return dev


def as_tensor(arr, device) -> torch.Tensor:
    """numpy uint32 (or any integer) limb array -> int32 tensor on `device`."""
    if isinstance(arr, torch.Tensor):
        return arr.to(device=device, dtype=DTYPE)
    a = np.ascontiguousarray(arr)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    else:
        a = a.astype(np.int32)
    return torch.from_numpy(a).to(device)


def to_numpy(t) -> np.ndarray:
    """int32 limb tensor (or numpy array) -> numpy uint32."""
    if isinstance(t, torch.Tensor):
        return t.detach().to("cpu", DTYPE).contiguous().numpy().view(np.uint32)
    return np.asarray(t).astype(np.uint32)


def _limb_col(value: int, count: int, like: torch.Tensor) -> torch.Tensor:
    """(count, 1, ..., 1) int32 limbs of `value` on `like`'s device."""
    return K.limb_column(value, count, like.ndim, str(like.device), DTYPE)


def one_like(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """Montgomery one (R mod p) broadcast to `a`'s shape (a view)."""
    return _limb_col(spec.R, spec.num_limbs, a).expand(a.shape)


# ---------------------------------------------------------------------------
# Host <-> device conversion helpers
# ---------------------------------------------------------------------------


def encode_ints(spec: FieldSpec, values, montgomery: bool = True) -> np.ndarray:
    """Python ints -> (L, N) uint32 limb array (Montgomery form by default)."""
    L = spec.num_limbs
    p = spec.modulus
    shift = LIMB_BITS * L
    vals = [v % p for v in values]
    if montgomery:
        vals = [(v << shift) % p for v in vals]
    nbytes = 2 * L
    buf = b"".join(v.to_bytes(nbytes, "little") for v in vals)
    limbs = np.frombuffer(buf, dtype="<u2").reshape(len(vals), L)
    return np.ascontiguousarray(limbs.T).astype(np.uint32)


def decode_ints(spec: FieldSpec, arr, montgomery: bool = True) -> list:
    """(L, ...) limb array or tensor -> list of canonical Python ints."""
    a = to_numpy(arr)
    L = a.shape[0]
    flat = np.ascontiguousarray(a.reshape(L, -1).T.astype("<u2"))
    raw = flat.tobytes()
    nbytes = 2 * L
    p = spec.modulus
    out = []
    r_inv = spec.R_inv
    for i in range(flat.shape[0]):
        v = int.from_bytes(raw[i * nbytes : (i + 1) * nbytes], "little")
        out.append(v * r_inv % p if montgomery else v % p)
    return out


def const(spec: FieldSpec, value: int, montgomery: bool = True) -> np.ndarray:
    """Single field constant as an (L, 1) limb column (broadcastable)."""
    return encode_ints(spec, [value], montgomery=montgomery)


def zeros(spec: FieldSpec, batch_shape, device) -> torch.Tensor:
    return torch.zeros((spec.num_limbs, *batch_shape), dtype=DTYPE, device=device)


def _carry_propagate(acc: torch.Tensor, out_limbs: int) -> torch.Tensor:
    """Normalize non-negative column sums (K, ...) to `out_limbs` 16-bit limbs;
    whatever carries past the top limb falls off (the caller sizes it)."""
    cols = acc.shape[0]
    x = acc.to(torch.int64)
    if out_limbs > cols:
        x = torch.cat([x, x.new_zeros((out_limbs - cols, *x.shape[1:]))])
    out = K.carry_resolve(x, rounds=2)[:out_limbs]
    out[-1] &= LIMB_MASK
    return out.to(DTYPE)


# ---------------------------------------------------------------------------
# Lazy-reduction arithmetic
# ---------------------------------------------------------------------------


def add(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return K.add(spec, a, b)


def sub(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return K.sub(spec, a, b)


def mont_mul(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product: a·b·R^-1, lazy (< 2p)."""
    return K.mont_mul(spec, a, b)


def neg(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    return sub(spec, torch.zeros_like(a), a)


def double(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    return add(spec, a, a)


def normalize(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """Fold a lazy value in [0, 2p) to canonical [0, p)."""
    L = spec.num_limbs
    p = K.limb_column(spec.modulus, L + 1, a.ndim, str(a.device))
    d = K.carry_resolve(torch.cat([a.long(), a.new_zeros((1, *a.shape[1:]), dtype=torch.int64)]) - p)
    ge_p = d[L] >= 0  # no borrow out of a − p
    return torch.where(ge_p, d[:L].to(DTYPE), a)


def mont_sqr(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    return mont_mul(spec, a, a)


def mul_const(spec: FieldSpec, a: torch.Tensor, c) -> torch.Tensor:
    """Multiply a batch by a constant (L, 1) limb column (Montgomery form)."""
    return mont_mul(spec, a, as_tensor(c, a.device))


def to_mont(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """Raw canonical limbs -> Montgomery form (multiply by R^2)."""
    return mont_mul(spec, a, _limb_col(spec.R2, spec.num_limbs, a))


def from_mont(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """Montgomery form -> canonical limbs (multiply by 1)."""
    return mont_mul(spec, a, _limb_col(1, spec.num_limbs, a))


def fold_wide(spec: FieldSpec, limbs: torch.Tensor) -> torch.Tensor:
    """(W, ...) 16-bit limbs of a W-limb value -> lazy [0, 2p).

    Splits V = V_lo + 2^(16H)·V_hi at the largest H with 2^(16H) <= 2p (so
    V_lo is already a valid lazy value) and folds the high half with ONE
    Montgomery multiply by the constant (2^(16H)·R mod p). Valid whenever
    W − H <= L."""
    W = limbs.shape[0]
    L = spec.num_limbs
    H = ((2 * spec.modulus).bit_length() - 1) // LIMB_BITS
    assert H <= L and W - H <= L, (W, H, L)

    def pad_to_l(part):
        k = part.shape[0]
        if k == L:
            return part
        return torch.cat([part, part.new_zeros((L - k, *part.shape[1:]))])

    v_lo = pad_to_l(limbs[:H])
    v_hi = pad_to_l(limbs[H:])
    k_const = (1 << (LIMB_BITS * H)) * spec.R % spec.modulus
    return add(spec, mont_mul(spec, v_hi, _limb_col(k_const, L, limbs)), v_lo)


def segment_sum_mod(
    spec: FieldSpec,
    values: torch.Tensor,
    seg_ids: torch.Tensor,
    num_segments: int,
    max_terms: int,
) -> torch.Tensor:
    """Segmented modular sum: values (L, ..., E) lazy [0, 2p) grouped by
    `seg_ids` (E,) -> (L, ..., num_segments) lazy [0, 2p).

    `index_add_` of the raw limbs (int64: no overflow), one carry pass to
    L + 1 limbs, and one `fold_wide` — a single Montgomery multiply,
    independent of segment sizes."""
    if max_terms >= 1 << 15:
        raise ValueError(f"max_terms {max_terms}: limb sums would overflow L+1 limbs")
    L = spec.num_limbs
    sums = torch.zeros(
        (L, *values.shape[1:-1], num_segments), dtype=torch.int64, device=values.device
    )
    sums.index_add_(-1, seg_ids.to(values.device, torch.int64), values.long())
    return fold_wide(spec, _carry_propagate(sums, L + 1))


# ---------------------------------------------------------------------------
# Exponentiation / inversion
# ---------------------------------------------------------------------------


def pow_const(spec: FieldSpec, a: torch.Tensor, exponent: int) -> torch.Tensor:
    """a^exponent for a Python-int exponent, left-to-right square-and-multiply
    (the JAX package's sequence of products, so lazy outputs agree)."""
    assert exponent >= 0
    if exponent == 0:
        return _limb_col(spec.R, spec.num_limbs, a).expand(a.shape).clone()
    acc = a
    for bit in bin(exponent)[3:]:
        acc = mont_sqr(spec, acc)
        if bit == "1":
            acc = mont_mul(spec, acc, a)
    return acc


def inv(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """Field inverse via Fermat: a^(p−2). inv(0) = 0."""
    return pow_const(spec, a, spec.modulus - 2)


def batch_inv(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """Montgomery-trick batched inversion along the LAST axis: Hillis-Steele
    prefix and suffix products, one Fermat inversion of the total. Zeros map
    to zero."""
    a = normalize(spec, a)  # the lazy zero residue p would poison the products
    nz = is_nonzero(spec, a)
    one = _limb_col(spec.R, spec.num_limbs, a)
    one_full = one.expand(a.shape)
    safe = torch.where(nz[None], a, one_full)
    n = a.shape[-1]
    levels = max((n - 1).bit_length(), 1)
    lane = torch.arange(n, device=a.device)

    prefix = safe
    for i in range(levels):
        shift = 1 << i
        rolled = torch.where(lane < shift, one_full, torch.roll(prefix, shift, -1))
        prefix = mont_mul(spec, prefix, rolled)
    suffix = safe
    for i in range(levels):
        shift = 1 << i
        rolled = torch.where(lane >= n - shift, one_full, torch.roll(suffix, -shift, -1))
        suffix = mont_mul(spec, suffix, rolled)
    total_inv = inv(spec, prefix[..., -1:])
    one_col = one.expand((*a.shape[:-1], 1))
    shifted_prefix = torch.cat([one_col, prefix[..., :-1]], dim=-1)
    shifted_suffix = torch.cat([suffix[..., 1:], one_col], dim=-1)
    out = mont_mul(spec, mont_mul(spec, shifted_prefix, shifted_suffix), total_inv)
    return torch.where(nz[None], out, torch.zeros_like(out))


# ---------------------------------------------------------------------------
# Predicates / selection
# ---------------------------------------------------------------------------


def is_zero(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """Boolean mask over the batch axes; zero is either 0 or p (lazy)."""
    p = _limb_col(spec.modulus, spec.num_limbs, a)
    return (a == 0).all(0) | (a == p).all(0)


def is_nonzero(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    return ~is_zero(spec, a)


def eq(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Field equality on lazy values (normalizes both sides)."""
    return (normalize(spec, a) == normalize(spec, b)).all(0)


def select(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """mask ? a : b, with mask shaped like the batch axes."""
    return torch.where(mask[None], a, b)
