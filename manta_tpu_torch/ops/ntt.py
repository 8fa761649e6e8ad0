"""Radix-2 NTT / iNTT over the scalar field on the GPU (PyTorch).

Port of `manta_tpu/ops/ntt.py`, with the same arkworks domain conventions:

- domain generator ω = TWO_ADIC_ROOT_OF_UNITY^(2^(s - log2 n))
  (`FieldSpec.root_of_unity`);
- `ntt` maps coefficients -> evaluations at ω^i in natural order;
- `coset_*` evaluate on the coset g·ω^i with g the field's multiplicative
  generator (arkworks' `coset_fft`).

Constant-geometry decimation in time after a bit-reversal gather: every
stage is one XOR-partner gather, one full-width Montgomery multiply by the
stage's twiddle row, one add, one sub and a select — the field ops go to the
field kernel on a CUDA tensor. Works on (L, ..., n): the transform runs
along the LAST axis, axes in between are batch.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from manta_tpu_torch.fields import FieldSpec
from manta_tpu_torch.ops import field_ops as F


@functools.lru_cache(maxsize=None)
def _bit_reverse_perm(n: int) -> np.ndarray:
    bits = n.bit_length() - 1
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return rev


@functools.lru_cache(maxsize=None)
def _stage_tables(spec: FieldSpec, n: int, inverse: bool):
    """Stacked per-stage tables for the constant-geometry sweep.

    Returns (partner, hi_bit, tw):
      partner (S, n) int64 — XOR-partner lane index per stage,
      hi_bit  (S, n) bool — lane is the high half of its pair,
      tw      (S, L, n) uint32 — Montgomery twiddle w_{2^s}^(j mod 2^(s-1))
                                 broadcast to both lanes of the pair.
    """
    p = spec.modulus
    omega = spec.root_of_unity(n)
    if inverse:
        omega = pow(omega, -1, p)
    stages = n.bit_length() - 1
    j = np.arange(n)
    partners, hi_bits, tws = [], [], []
    for s in range(1, stages + 1):
        half = 1 << (s - 1)
        partners.append(j ^ half)
        hi_bits.append((j & half) != 0)
        w = pow(omega, n >> s, p)
        pw = [1] * half
        for k in range(1, half):
            pw[k] = pw[k - 1] * w % p
        tws.append(F.encode_ints(spec, pw)[:, j & (half - 1)])
    return np.stack(partners), np.stack(hi_bits), np.stack(tws)


@functools.lru_cache(maxsize=None)
def _coset_powers(spec: FieldSpec, n: int, inverse: bool) -> np.ndarray:
    g = spec.generator
    if inverse:
        g = pow(g, -1, spec.modulus)
    pw = [1] * n
    for i in range(1, n):
        pw[i] = pw[i - 1] * g % spec.modulus
    return F.encode_ints(spec, pw)


@functools.lru_cache(maxsize=None)
def device_tables(spec: FieldSpec, n: int, inverse: bool, device: str):
    """(perm, partner, hi_bit, tw) as tensors on `device`, built once."""
    partner, hi_bit, tw = _stage_tables(spec, n, inverse)
    return (
        torch.from_numpy(_bit_reverse_perm(n)).to(device),
        torch.from_numpy(partner).to(device),
        torch.from_numpy(hi_bit).to(device),
        F.as_tensor(tw, device),
    )


def ntt_with_tables(
    spec: FieldSpec,
    a: torch.Tensor,
    perm: torch.Tensor,
    partner: torch.Tensor,
    hi_bit: torch.Tensor,
    tw: torch.Tensor,
    inverse: bool = False,
) -> torch.Tensor:
    """NTT core over explicit tables (see `device_tables`)."""
    n = a.shape[-1]
    axis = a.ndim - 1
    x = a.index_select(axis, perm)
    bshape = (1,) * (x.ndim - 2)  # axes between L and n
    for s in range(partner.shape[0]):
        xp = x.index_select(axis, partner[s])
        hi = hi_bit[s].reshape(*bshape, n)
        # per-lane views of the pair: lo = x[j & ~half], hi_v = x[j | half]
        lo = torch.where(hi, xp, x)
        hi_v = torch.where(hi, x, xp)
        v = F.mont_mul(spec, hi_v, tw[s].reshape(spec.num_limbs, *bshape, n))
        x = torch.where(hi, F.sub(spec, lo, v), F.add(spec, lo, v))
    if inverse:
        n_inv = F.const(spec, pow(n, -1, spec.modulus))
        x = F.mul_const(spec, x, n_inv.reshape((spec.num_limbs,) + (1,) * (x.ndim - 1)))
    return x


def ntt(spec: FieldSpec, a: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """NTT along the last axis. a: (L, ..., n) Montgomery-form limbs."""
    n = a.shape[-1]
    if n & (n - 1):
        raise ValueError(f"NTT size {n} is not a power of two")
    if n == 1:
        return a
    tables = device_tables(spec, n, inverse, str(a.device))
    return ntt_with_tables(spec, a, *tables, inverse)


def intt(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    return ntt(spec, a, inverse=True)


def _coset_row(spec: FieldSpec, n: int, inverse: bool, a: torch.Tensor) -> torch.Tensor:
    pw = F.as_tensor(_coset_powers(spec, n, inverse), a.device)
    return pw.reshape((spec.num_limbs,) + (1,) * (a.ndim - 2) + (n,))


def coset_ntt(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """Evaluate coefficients on the coset g·ω^i (arkworks coset_fft)."""
    n = a.shape[-1]
    return ntt(spec, F.mont_mul(spec, a, _coset_row(spec, n, False, a)))


def coset_intt(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """Inverse of `coset_ntt` (arkworks coset_ifft)."""
    n = a.shape[-1]
    x = ntt(spec, a, inverse=True)
    return F.mont_mul(spec, x, _coset_row(spec, n, True, x))
