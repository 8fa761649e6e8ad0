"""Montgomery mul / add / sub: the CUDA kernel and its plain PyTorch version.

Replaces the JAX package's Pallas TPU kernel
`manta_tpu/ops/pallas/field_kernels.py::_binary_op` (`_mul_kernel`,
`_add_kernel`, `_sub_kernel`; public `mont_mul`, `add`, `sub`). The kernel
source is `manta_tpu_torch/csrc/field_kernels.cu`; its header gives the
bound on the H100 and what the design does about it.

Layout at the boundary: limb-major `(L, ...)` int32 tensors of 16-bit limbs,
Montgomery form with R = 2^(16·L), lazy values in [0, 2p). The public
functions broadcast `a` and `b` against each other and dispatch on the
tensor's device:

- CUDA: flatten to `(L, n)`, launch the kernel on the current stream, count
  the launch in `LAUNCHES`. There is no fallback: an unsupported field,
  dtype or shape raises.
- CPU: the plain version below (int64 inside, same integers bit for bit).

The kernel is built at first use with `nvcc` into `build/torch_kernels/` at
the repository root (a plain C interface, loaded with ctypes; `build.py`).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from manta_tpu_torch.fields import LIMB_BITS, LIMB_MASK, FieldSpec
from manta_tpu_torch.ops.kernels import build as B

#: launches of the CUDA kernel per op, counted by the wrappers
LAUNCHES = {"mul": 0, "add": 0, "sub": 0}

#: field name -> the `field` id of `manta_field_binary` in the .cu source
KERNEL_FIELDS = {"bn254_fr": 0, "bn254_fq": 1, "bls12_381_fr": 2, "bls12_381_fq": 3}
_OPS = {"mul": 0, "add": 1, "sub": 2}

LIBRARY = B.Library("field_kernels", "field_kernels.cu", ("field_ops.cuh",))
SOURCE = B.CSRC / LIBRARY.source
#: the field constants and `FieldOps` shared with the point kernels
HEADER = B.CSRC / "field_ops.cuh"


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(B.build([LIBRARY])[0]))
    fn = lib.manta_field_binary
    fn.argtypes = [
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_void_p,
        ctypes.c_void_p,
        ctypes.c_void_p,
        ctypes.c_longlong,
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return lib


# ---------------------------------------------------------------------------
# Plain PyTorch versions (int64 inside; the CPU path and the kernel's yardstick)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _limbs(value: int, count: int) -> list:
    return [(value >> (LIMB_BITS * i)) & LIMB_MASK for i in range(count)]


def carry_resolve(x: torch.Tensor, rounds: int = 1, settle: bool = True) -> torch.Tensor:
    """Resolve int64 limb columns (K, ...) into 16-bit limbs, in place.

    Every limb but the top one ends in [0, 2^16); the top limb absorbs the
    remaining carry or borrow (it may be negative or >= 2^16). Works for
    negative columns too (arithmetic shift = floor division). Each round
    moves every column's excess one limb up: `rounds` of them run
    unconditionally (enough for the column bound the caller knows); with
    `settle`, rounds repeat while a carry is left — a carry rippling through
    0xFFFF limbs takes one round per limb."""
    low, high = x[:-1], x[1:]
    for r in range(rounds + (len(x) if settle else 0)):
        hi = low >> LIMB_BITS
        if r >= rounds and not bool(hi.any()):
            break
        low &= LIMB_MASK
        high += hi
    return x


def _product_columns(x: torch.Tensor, y: torch.Tensor, ncols: int) -> torch.Tensor:
    """Unreduced schoolbook columns sum_{i+j=c} x[i]·y[j] for c < ncols.

    x: (Lx, ...) int64, y: (Ly, ...) int64 broadcastable against x's batch.
    Row i of the products is written at columns i .. i+Ly-1 of a zeroed
    (Lx, Lx+Ly, ...) buffer through a strided view, then the rows are summed."""
    lx, ly = x.shape[0], y.shape[0]
    batch = torch.broadcast_shapes(x.shape[1:], y.shape[1:])
    width = lx + ly
    buf = torch.zeros((lx, width, *batch), dtype=torch.int64, device=x.device)
    inner = buf.stride(1)
    diag = buf.as_strided((lx, ly, *batch), ((width + 1) * inner, inner, *buf.stride()[2:]))
    torch.mul(x.unsqueeze(1), y.unsqueeze(0), out=diag)
    return buf.sum(0)[:ncols]


@functools.lru_cache(maxsize=None)
def limb_column(
    value: int, count: int, ndim: int, device: str, dtype: torch.dtype = torch.int64
) -> torch.Tensor:
    """(count, 1, ..., 1) limbs of `value`, `ndim` axes in all."""
    col = torch.tensor(_limbs(value, count), dtype=dtype, device=device)
    return col.reshape((count,) + (1,) * (ndim - 1))


@functools.lru_cache(maxsize=None)
def _constant_products(spec: FieldSpec, device: str):
    """float64 Toeplitz matrices of the products by constants: N (L, L) takes
    limbs to the low L columns of x·N' (N' = −p^-1 mod R), P (2L, L) to the
    columns of x·p."""
    L = spec.num_limbs
    R = 1 << (LIMB_BITS * L)
    n_prime = _limbs((-pow(spec.modulus, -1, R)) % R, L)
    p = _limbs(spec.modulus, L)
    N = np.zeros((L, L))
    P = np.zeros((2 * L, L))
    for i in range(L):
        for j in range(L):
            P[i + j, i] = p[j]
            if i + j < L:
                N[i + j, i] = n_prime[j]
    return torch.from_numpy(N).to(device), torch.from_numpy(P).to(device)


def plain_mont_mul(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a·b·R^-1 mod R, no final subtract: the same integer as the kernel.

    Montgomery by whole products instead of a digit loop: T = a·b, then
    M = (T mod R)·N' mod R with N' = −p^-1 mod R, then (T + M·p)/R. T's
    columns are exact in int64 (< 2^37); the products by the constants N'
    and p run as float64 matrix products, exact because their columns stay
    below 2^53 (T mod R is first carried once to limbs < 2^22: T·N' < 2^42;
    M·p < 2^37)."""
    L = spec.num_limbs
    a, b = torch.broadcast_tensors(a, b)
    shape = a.shape
    N, P = _constant_products(spec, str(a.device))
    t = _product_columns(a.reshape(L, -1).long(), b.reshape(L, -1).long(), 2 * L)
    t_lo = carry_resolve(t[:L].clone(), 1, settle=False)
    t_lo[-1] &= LIMB_MASK  # T mod R
    m = carry_resolve((N @ t_lo.double()).long(), 3)
    m[-1] &= LIMB_MASK  # M mod R
    s = carry_resolve(t + (P @ m.double()).long(), 3, settle=False)
    # Now every limb is <= 2^16 and the low half is a multiple of R below 2R,
    # so it is 0 or R: it carries 1 into limb L iff some low limb is nonzero
    # (resolving it limb by limb would ripple through all L zero limbs).
    out = s[L:]
    out[0] += (s[:L] != 0).any(0)
    out = carry_resolve(out, rounds=0)
    out[-1] &= LIMB_MASK  # mod R: the carry out of limb 2L-1 falls off
    return out.to(torch.int32).reshape(shape)


def _pad_top(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, x.new_zeros((1, *x.shape[1:]))])


def _resolve_pair(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Carry-resolve two (L+1, ...) limb columns at once -> (L+1, 2, ...)."""
    return carry_resolve(torch.stack([x, y], dim=1))


def plain_add(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a + b, minus 2p when the sum is >= 2p or carries out of 16·L bits."""
    L = spec.num_limbs
    s = _pad_top(a.long() + b.long())  # limb L takes the carry out
    two_p = limb_column(2 * spec.modulus, L + 1, s.ndim, str(s.device))
    both = _resolve_pair(s, s - two_p)
    ge = both[L, 1] >= 0  # no borrow out of the (L+1)-limb s − 2p
    return torch.where(ge, both[:L, 1], both[:L, 0]).to(torch.int32)


def plain_sub(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a − b, plus 2p (mod 2^(16·L)) when it borrows."""
    L = spec.num_limbs
    d = _pad_top(a.long() - b.long())
    two_p = limb_column(2 * spec.modulus, L + 1, d.ndim, str(d.device))
    both = _resolve_pair(d, d + two_p)
    borrow = both[L, 0] < 0
    return torch.where(borrow, both[:L, 1], both[:L, 0]).to(torch.int32)


PLAIN = {"mul": plain_mont_mul, "add": plain_add, "sub": plain_sub}


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def _binary(spec: FieldSpec, which: str, a: torch.Tensor, b: torch.Tensor):
    if a.device != b.device:
        raise ValueError(f"operands on different devices: {a.device}, {b.device}")
    if a.device.type == "cpu":
        return PLAIN[which](spec, a, b)
    if a.device.type != "cuda":
        raise ValueError(f"no field kernel for device {a.device}")
    if spec.name not in KERNEL_FIELDS:
        raise ValueError(f"the CUDA field kernel has no constants for {spec.name}")
    if a.dtype != torch.int32 or b.dtype != torch.int32:
        raise TypeError(f"field kernel takes int32 limbs, got {a.dtype}, {b.dtype}")
    shape = torch.broadcast_shapes(a.shape, b.shape)
    L = spec.num_limbs
    if len(shape) < 1 or shape[0] != L:
        raise ValueError(f"expected limb-major (L={L}, ...) operands, got {tuple(shape)}")
    a2 = a.expand(shape).reshape(L, -1).contiguous()
    b2 = b.expand(shape).reshape(L, -1).contiguous()
    out = torch.empty_like(a2)
    n = a2.shape[1]
    if n:
        if a.device.index not in (None, torch.cuda.current_device()):
            raise ValueError(f"operands on {a.device}, current CUDA device is "
                             f"{torch.cuda.current_device()}")
        err = _lib().manta_field_binary(
            KERNEL_FIELDS[spec.name], _OPS[which],
            a2.data_ptr(), b2.data_ptr(), out.data_ptr(), n,
            torch.cuda.current_stream().cuda_stream,
        )
        if err != 0:
            raise RuntimeError(f"field kernel '{which}' launch failed: cudaError {err}")
        LAUNCHES[which] += 1
    return out.reshape(shape)


def mont_mul(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _binary(spec, "mul", a, b)


def add(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _binary(spec, "add", a, b)


def sub(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _binary(spec, "sub", a, b)
