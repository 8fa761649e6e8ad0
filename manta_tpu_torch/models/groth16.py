"""Groth16 proving system: setup / prove / verify.

Host replacement for the reference's ark-groth16 backend
(`manta-crypto/src/arkworks/groth16.rs:548-610`, SURVEY.md §2.9#5):

- `setup` — circuit-specific CRS generation from explicit toxic waste
  (deterministic from a seed; the MPC ceremony layer replaces this for
  production, as in the reference's trusted setup).
- `prove` — witness evaluation per R1CS row, h(x) via coset NTT
  (Z(g·ωⁱ) = g^m − 1 is constant on the coset), then 4 G1 MSMs + 1 G2 MSM.
- `verify` — the pairing-product equation on the host (never on the hot
  path, mirroring the reference).

QAP reduction matches ark-groth16's libsnark-style reduction: the
evaluation domain has size ≥ num_constraints + num_instance and the extra
instance rows (A[nc+i][i] = 1) make the instance polynomials linearly
independent (non-malleability).

This module is the host half: pure Python big ints (small circuits,
tests, cold paths, verification). The device prover, with the NTTs and
MSMs on the GPU, is `manta_tpu_torch.models.groth16_device.DeviceProver`.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

from manta_tpu_torch import fields
from manta_tpu_torch.models import pairing as PR
from manta_tpu_torch.models.circuit import ConstraintMatrices
from manta_tpu_torch.utils import hostmath


@dataclasses.dataclass
class ProvingKey:
    cfg: PR.PairingConfig
    domain_size: int
    # G1 points (affine tuples / None)
    alpha_g1: tuple
    beta_g1: tuple
    delta_g1: tuple
    a_query: list  # [u_i(τ)]₁, len num_variables
    b_g1_query: list  # [v_i(τ)]₁
    h_query: list  # [τ^i Z(τ)/δ]₁, len domain_size - 1
    l_query: list  # [(β u_i + α v_i + w_i)/δ]₁ for witness indices
    # G2 points
    beta_g2: tuple
    delta_g2: tuple
    b_g2_query: list  # [v_i(τ)]₂


@dataclasses.dataclass
class VerifyingKey:
    cfg: PR.PairingConfig
    alpha_g1: tuple
    beta_g2: tuple
    gamma_g2: tuple
    delta_g2: tuple
    gamma_abc_g1: list  # [(β u_i + α v_i + w_i)/γ]₁ for instance indices


@dataclasses.dataclass
class Proof:
    a: tuple  # G1
    b: tuple  # G2
    c: tuple  # G1


def _qap_rows(matrices: ConstraintMatrices):
    """R1CS rows + the instance-consistency rows of the libsnark reduction."""
    rows = list(matrices.rows)
    for i in range(matrices.num_instance):
        rows.append(({i: 1}, {}, {}))
    return rows


def _domain_size(n: int) -> int:
    m = 1
    while m < n:
        m *= 2
    return m


def setup(
    cfg: PR.PairingConfig,
    matrices: ConstraintMatrices,
    toxic: Optional[dict] = None,
    seed: int = 0,
) -> tuple:
    """Generate (ProvingKey, VerifyingKey). `toxic` may provide
    alpha/beta/gamma/delta/tau explicitly; otherwise they are derived
    deterministically from `seed` (test/dev use — production keys come from
    the MPC ceremony)."""
    r = cfg.g1.scalar_field.modulus
    if toxic is None:
        import hashlib

        def h(tag):
            d = hashlib.blake2s(f"manta-tpu-setup:{seed}:{tag}".encode()).digest()
            return int.from_bytes(d, "little") % (r - 1) + 1

        toxic = {k: h(k) for k in ("alpha", "beta", "gamma", "delta", "tau")}
    alpha, beta, gamma, delta, tau = (
        toxic["alpha"],
        toxic["beta"],
        toxic["gamma"],
        toxic["delta"],
        toxic["tau"],
    )
    rows = _qap_rows(matrices)
    m = _domain_size(len(rows))
    fr = cfg.g1.scalar_field
    omega = fr.root_of_unity(m)

    # Lagrange basis at tau: L_j(tau) = (tau^m - 1) * ω^j / (m * (tau - ω^j));
    # if tau = ω^j (probability ~0) this would need the limit — reject seed.
    z_tau = (pow(tau, m, r) - 1) % r
    assert z_tau != 0, "tau landed in the domain; change seed"
    m_inv = pow(m, -1, r)
    lagrange = []
    wj = 1
    for _ in range(m):
        lagrange.append(z_tau * wj % r * pow((tau - wj) % r, -1, r) % r * m_inv % r)
        wj = wj * omega % r
    num_vars = matrices.num_variables
    u = [0] * num_vars
    v = [0] * num_vars
    w = [0] * num_vars
    for j, (a_lc, b_lc, c_lc) in enumerate(rows):
        lj = lagrange[j]
        for col, coeff in a_lc.items():
            u[col] = (u[col] + coeff * lj) % r
        for col, coeff in b_lc.items():
            v[col] = (v[col] + coeff * lj) % r
        for col, coeff in c_lc.items():
            w[col] = (w[col] + coeff * lj) % r

    g1, g2 = cfg.g1, cfg.g2
    gamma_inv = pow(gamma, -1, r)
    delta_inv = pow(delta, -1, r)
    ni = matrices.num_instance

    # fixed-base window tables make the thousands of generator mults cheap
    t1 = hostmath.FixedBaseTable(g1, g1.generator)
    t2 = hostmath.FixedBaseTable(g2, g2.generator)

    gamma_abc = [
        t1.scalar_mul((beta * u[i] + alpha * v[i] + w[i]) * gamma_inv % r)
        for i in range(ni)
    ]
    l_query = [
        t1.scalar_mul((beta * u[i] + alpha * v[i] + w[i]) * delta_inv % r)
        for i in range(ni, num_vars)
    ]
    tz = z_tau * delta_inv % r
    tau_pow = 1
    h_query = []
    for i in range(m - 1):
        h_query.append(t1.scalar_mul(tau_pow * tz % r))
        tau_pow = tau_pow * tau % r
    pk = ProvingKey(
        cfg=cfg,
        domain_size=m,
        alpha_g1=t1.scalar_mul(alpha),
        beta_g1=t1.scalar_mul(beta),
        delta_g1=t1.scalar_mul(delta),
        a_query=[t1.scalar_mul(x) if x else None for x in u],
        b_g1_query=[t1.scalar_mul(x) if x else None for x in v],
        h_query=h_query,
        l_query=l_query,
        beta_g2=t2.scalar_mul(beta),
        delta_g2=t2.scalar_mul(delta),
        b_g2_query=[t2.scalar_mul(x) if x else None for x in v],
    )
    vk = VerifyingKey(
        cfg=cfg,
        alpha_g1=pk.alpha_g1,
        beta_g2=pk.beta_g2,
        gamma_g2=t2.scalar_mul(gamma),
        delta_g2=pk.delta_g2,
        gamma_abc_g1=gamma_abc,
    )
    return pk, vk


# ---------------------------------------------------------------------------
# h(x) on the host
# ---------------------------------------------------------------------------


def _host_ntt(spec: fields.FieldSpec, values: List[int], inverse=False):
    n = len(values)
    p = spec.modulus
    if n == 1:
        return list(values)
    omega = spec.root_of_unity(n)
    if inverse:
        omega = pow(omega, -1, p)
    # iterative radix-2
    rev = [0] * n
    bits = n.bit_length() - 1
    for i in range(n):
        rev[i] = int(bin(i)[2:].zfill(bits)[::-1], 2)
    a = [values[rev[i]] for i in range(n)]
    size = 2
    while size <= n:
        wstep = pow(omega, n // size, p)
        half = size // 2
        for start in range(0, n, size):
            wcur = 1
            for k in range(half):
                u_val = a[start + k]
                t = a[start + k + half] * wcur % p
                a[start + k] = (u_val + t) % p
                a[start + k + half] = (u_val - t) % p
                wcur = wcur * wstep % p
        size *= 2
    if inverse:
        n_inv = pow(n, -1, p)
        a = [x * n_inv % p for x in a]
    return a


def _h_coefficients_host(
    fr: fields.FieldSpec, a_ev, b_ev, c_ev, m: int
) -> List[int]:
    p = fr.modulus
    g = fr.generator
    a_c = _host_ntt(fr, a_ev, inverse=True)
    b_c = _host_ntt(fr, b_ev, inverse=True)
    c_c = _host_ntt(fr, c_ev, inverse=True)

    def coset_eval(coeffs):
        shifted = [coeffs[i] * pow(g, i, p) % p for i in range(m)]
        return _host_ntt(fr, shifted)

    A = coset_eval(a_c)
    B = coset_eval(b_c)
    C = coset_eval(c_c)
    z_inv = pow((pow(g, m, p) - 1) % p, -1, p)
    H = [(x * y - z) * z_inv % p for x, y, z in zip(A, B, C)]
    h_c = _host_ntt(fr, H, inverse=True)
    g_inv = pow(g, -1, p)
    return [h_c[i] * pow(g_inv, i, p) % p for i in range(m)]


# ---------------------------------------------------------------------------
# prove / verify
# ---------------------------------------------------------------------------


def _msm_host(curve, scalars, points):
    return curve.msm_pippenger(scalars, points)


def prove(
    pk: ProvingKey,
    matrices: ConstraintMatrices,
    assignment: Sequence[int],
    r_rand: int = 0,
    s_rand: int = 0,
) -> Proof:
    """Generate a proof for `assignment` (instance ++ witness, [0] == 1) on
    the host. The device prover is `models.groth16_device.DeviceProver`."""
    cfg = pk.cfg
    fr = cfg.g1.scalar_field
    p = fr.modulus
    rows = _qap_rows(matrices)
    m = pk.domain_size
    assert len(rows) <= m

    def row_eval(lc):
        return sum(coeff * assignment[col] for col, coeff in lc.items()) % p

    a_ev = [row_eval(a) for a, _, _ in rows] + [0] * (m - len(rows))
    b_ev = [row_eval(b) for _, b, _ in rows] + [0] * (m - len(rows))
    c_ev = [row_eval(c) for _, _, c in rows] + [0] * (m - len(rows))

    h = _h_coefficients_host(fr, a_ev, b_ev, c_ev, m)

    msm = _msm_host
    g1 = cfg.g1
    g2 = cfg.g2

    # A = α + Σ z_i [u_i(τ)] + r δ
    a_acc = msm(g1, assignment, pk.a_query)
    a_pt = g1.add(g1.add(pk.alpha_g1, a_acc), g1.scalar_mul(r_rand, pk.delta_g1))
    # B = β + Σ z_i [v_i(τ)] + s δ   (G2, and its G1 shadow for C)
    b_acc_g2 = msm(g2, assignment, pk.b_g2_query)
    b_pt = g2.add(g2.add(pk.beta_g2, b_acc_g2), g2.scalar_mul(s_rand, pk.delta_g2))
    b_acc_g1 = msm(g1, assignment, pk.b_g1_query)
    b1_pt = g1.add(g1.add(pk.beta_g1, b_acc_g1), g1.scalar_mul(s_rand, pk.delta_g1))
    # C = Σ_w z_i l_i + Σ h_k [τ^k Z/δ] + s A + r B1 - r s δ
    ni = matrices.num_instance
    c_acc = msm(g1, list(assignment[ni:]), pk.l_query)
    h_acc = msm(g1, h[: len(pk.h_query)], pk.h_query)
    c_pt = g1.add(c_acc, h_acc)
    c_pt = g1.add(c_pt, g1.scalar_mul(s_rand, a_pt))
    c_pt = g1.add(c_pt, g1.scalar_mul(r_rand, b1_pt))
    c_pt = g1.add(
        c_pt, g1.neg(g1.scalar_mul(r_rand * s_rand % p, pk.delta_g1))
    )
    return Proof(a=a_pt, b=b_pt, c=c_pt)


def verify(vk: VerifyingKey, proof: Proof, public_inputs: Sequence[int]) -> bool:
    """Pairing check e(A,B) = e(α,β)·e(acc,γ)·e(C,δ); public_inputs exclude
    the leading ONE."""
    cfg = vk.cfg
    g1 = cfg.g1
    assert len(public_inputs) == len(vk.gamma_abc_g1) - 1
    acc = vk.gamma_abc_g1[0]
    for x, pt in zip(public_inputs, vk.gamma_abc_g1[1:]):
        acc = g1.add(acc, g1.scalar_mul(x, pt))
    eng = PR.engine(cfg)
    return eng.multi_pairing_is_one(
        [
            (proof.a, proof.b),
            (g1.neg(vk.alpha_g1), vk.beta_g2),
            (g1.neg(acc), vk.gamma_g2),
            (g1.neg(proof.c), vk.delta_g2),
        ]
    )
