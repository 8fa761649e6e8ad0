"""Device-resident Groth16 prover (PyTorch).

Port of `manta_tpu/models/groth16_device.py::DeviceProver`. For one proving
key + circuit it keeps on the device, for the life of the prover:

- every query point batch, encoded once (affine limbs, Z in {0, 1}),
- the three sparse R1CS matrices (entry-sorted COO: coefficients in
  Montgomery form, column and row indices),
- the zero-scalar masks of the queries,

and proves a witness with

1. sparse A/B/C row evaluation: one Montgomery multiply per matrix entry and
   a segmented modular sum (`field_ops.segment_sum_mod`);
2. h(x) on the device: 3 iNTT, 3 coset NTT, one product, one coset iNTT;
3. four MSMs (A, B in G1, B in G2, and the merged L/H query);
4. the constant-size randomization (r·δ, s·A, …) on the host (`_finish`).

`from_cache` / `from_numpy_state` read the npz + JSON state that the JAX
package's `DeviceProver.save_cache` writes, so a prover built there (or the
production cache) loads here unchanged.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from manta_tpu_torch.models import groth16 as G
from manta_tpu_torch.models import pairing as PR
from manta_tpu_torch.ops import curve as C
from manta_tpu_torch.ops import field_ops as F
from manta_tpu_torch.ops import msm as M
from manta_tpu_torch.ops import ntt as NTT
from manta_tpu_torch.ops.curve import JacobianPoint


def _pow2_at_least(n: int, floor: int = 256) -> int:
    m = floor
    while m < n:
        m *= 2
    return m


@dataclasses.dataclass
class _SparseMat:
    """One R1CS matrix in entry-sorted COO form (static per circuit)."""

    seg_ids: np.ndarray  # (E,) int32 row index per entry, ascending
    cols: np.ndarray  # (E,) int32 variable index per entry
    coeffs: np.ndarray  # (L, E) uint32 Montgomery-form coefficients
    max_row_terms: int


def _build_sparse(fr, rows, which: int) -> _SparseMat:
    seg, cols, vals = [], [], []
    max_terms = 1
    for j, row in enumerate(rows):
        lc = row[which]
        if not lc:
            continue
        max_terms = max(max_terms, len(lc))
        for col, coeff in sorted(lc.items()):
            seg.append(j)
            cols.append(col)
            vals.append(coeff % fr.modulus)
    return _SparseMat(
        seg_ids=np.asarray(seg, dtype=np.int32),
        cols=np.asarray(cols, dtype=np.int32),
        coeffs=F.encode_ints(fr, vals),
        max_row_terms=max_terms,
    )


@dataclasses.dataclass
class _PkView:
    """The slice of a ProvingKey the prover needs once its query points are
    encoded: the constant-size randomization points and the query lengths."""

    cfg: object
    domain_size: int
    alpha_g1: tuple
    beta_g1: tuple
    delta_g1: tuple
    beta_g2: tuple
    delta_g2: tuple
    l_query: tuple  # length-only placeholders
    h_query: tuple


_QUERIES = ("a", "b1", "b2", "lh")
_CONFIGS = {"bn254": PR.BN254_PAIRING, "bls12_381": PR.BLS12_381_PAIRING}


def _check_point_rows(cops, backend: str, tag: str, shape) -> None:
    """Raise unless cached query points have the coordinate rows that
    `backend` encodes: limb rows for "fused", "limb" and "rns_hybrid",
    RNS residues for "rns_fused" (a limb cache cannot load there, as in the
    JAX package)."""
    want = tuple(cops.encode_points([], "cpu").x.shape[:-1])
    if tuple(shape[:-1]) != want:
        raise ValueError(
            f"the cached {tag!r} query points have coordinate rows {tuple(shape[:-1])}, but "
            f"backend {backend!r} takes {want}: build the prover on that backend, or load "
            "this cache on the backend whose encoding it holds"
        )


class DeviceProver:
    """Device-resident prover for one proving key + circuit.

    backend: curve backend of the MSMs: "fused" (the default, as in the JAX
    package: one kernel launch per point formula, the bucket loop and the
    folds as single launches), "limb" (one field-kernel launch per field
    op), "rns_fused" (RNS point and column kernels over RNS-encoded query
    points) or "rns_hybrid" (the same group law over limb-encoded query
    points, converted to RNS inside the column kernel). device: "cuda" by
    default; "cpu" runs the plain versions.
    """

    def __init__(
        self,
        pk: G.ProvingKey,
        matrices,
        backend: str = "fused",
        window_bits: int = 13,
        column_steps: int = 128,
        lane_floor: int = 256,
        device="cuda",
    ):
        self.device = F.resolve_device(device)
        self.pk = pk
        self.window_bits = window_bits
        self.column_steps = column_steps
        cfg = pk.cfg
        self.fr = cfg.g1.scalar_field
        self.g1 = C.curve_ops_for(cfg.g1, backend)
        self.g2 = C.curve_ops_for(cfg.g2, backend)
        rows = G._qap_rows(matrices)
        self.m = pk.domain_size
        if len(rows) > self.m:
            raise ValueError(f"{len(rows)} QAP rows do not fit the domain of {self.m}")
        self.ni = matrices.num_instance
        self.nv = matrices.num_variables
        self.mats = tuple(_build_sparse(self.fr, rows, w) for w in range(3))
        self.n_ab = _pow2_at_least(self.nv, lane_floor)
        self.n_lh = _pow2_at_least(len(pk.l_query) + len(pk.h_query), lane_floor)
        queries = {
            "a": (self.g1, pk.a_query, self.n_ab),
            "b1": (self.g1, pk.b_g1_query, self.n_ab),
            "b2": (self.g2, pk.b_g2_query, self.n_ab),
            "lh": (self.g1, list(pk.l_query) + list(pk.h_query), self.n_lh),
        }
        for tag, (cops, query, n) in queries.items():
            pts, mask = self._encode_query(cops, query, n)
            setattr(self, f"{tag}_pts", pts)
            setattr(self, f"{tag}_mask", mask)
        self._upload_mats()

    # -- state: the JAX package's `save_cache` format (npz + JSON meta) --

    def _meta(self) -> dict:
        return {
            "cfg": self.pk.cfg.name,
            "backend": self.g1.backend,
            "window_bits": self.window_bits,
            "column_steps": self.column_steps,
            "domain_size": self.m,
            "ni": self.ni,
            "nv": self.nv,
            "n_ab": self.n_ab,
            "n_lh": self.n_lh,
            "n_l": len(self.pk.l_query),
            "n_h": len(self.pk.h_query),
            "max_row_terms": [m.max_row_terms for m in self.mats],
            "alpha_g1": self.pk.alpha_g1,
            "beta_g1": self.pk.beta_g1,
            "delta_g1": self.pk.delta_g1,
            "beta_g2": self.pk.beta_g2,
            "delta_g2": self.pk.delta_g2,
        }

    def save_cache(self, path: str) -> None:
        """Dump what the prover needs at run time (numpy + JSON, no pickle)."""
        arrays = {"meta": np.frombuffer(json.dumps(self._meta()).encode(), dtype=np.uint8)}
        for tag in _QUERIES:
            pts = getattr(self, f"{tag}_pts")
            for c in "xyz":
                arrays[f"{tag}_{c}"] = F.to_numpy(getattr(pts, c))
            arrays[f"{tag}_mask"] = F.to_numpy(getattr(self, f"{tag}_mask"))
        for i, m in enumerate(self.mats):
            arrays[f"mat{i}_coeffs"] = m.coeffs
            arrays[f"mat{i}_cols"] = m.cols
            arrays[f"mat{i}_seg"] = m.seg_ids
        np.savez(path, **arrays)

    @classmethod
    def from_cache(cls, path: str, backend: Optional[str] = None, device="cuda"):
        """Load a prover from `save_cache` output (this package's or the JAX
        package's) without the host ProvingKey or matrices."""
        with np.load(path) as data:
            return cls.from_numpy_state(data, backend=backend, device=device)

    @classmethod
    def from_numpy_state(cls, state, backend: Optional[str] = None, device="cuda"):
        """Build a prover from the dict of numpy arrays + JSON meta that
        `save_cache` writes, on the curve backend the meta records (the
        production cache: "fused") unless `backend` names another. The
        cache's points serve as they are: limb points on "fused", "limb"
        and "rns_hybrid", RNS points on "rns_fused"; other pairs raise."""
        meta = json.loads(bytes(np.asarray(state["meta"])).decode())
        cfg = _CONFIGS[meta["cfg"]]

        def as_pt(v):
            if v is None:
                return None
            return tuple(tuple(c) if isinstance(c, list) else c for c in v)

        self = cls.__new__(cls)
        self.device = F.resolve_device(device)
        self.pk = _PkView(
            cfg=cfg,
            domain_size=meta["domain_size"],
            alpha_g1=as_pt(meta["alpha_g1"]),
            beta_g1=as_pt(meta["beta_g1"]),
            delta_g1=as_pt(meta["delta_g1"]),
            beta_g2=as_pt(meta["beta_g2"]),
            delta_g2=as_pt(meta["delta_g2"]),
            l_query=(None,) * meta["n_l"],
            h_query=(None,) * meta["n_h"],
        )
        self.window_bits = meta["window_bits"]
        self.column_steps = meta["column_steps"]
        self.fr = cfg.g1.scalar_field
        bk = backend or meta["backend"]
        self.g1 = C.curve_ops_for(cfg.g1, bk)
        self.g2 = C.curve_ops_for(cfg.g2, bk)
        self.m = meta["domain_size"]
        self.ni = meta["ni"]
        self.nv = meta["nv"]
        self.n_ab = meta["n_ab"]
        self.n_lh = meta["n_lh"]
        for tag, cops in (("a", self.g1), ("b1", self.g1), ("b2", self.g2), ("lh", self.g1)):
            _check_point_rows(cops, bk, tag, state[f"{tag}_x"].shape)
        if meta["n_l"] != self.nv - self.ni or meta["n_l"] + meta["n_h"] > self.n_lh:
            raise ValueError("inconsistent prover state: query lengths do not match")
        self.mats = tuple(
            _SparseMat(
                seg_ids=np.asarray(state[f"mat{i}_seg"]),
                cols=np.asarray(state[f"mat{i}_cols"]),
                coeffs=np.asarray(state[f"mat{i}_coeffs"]),
                max_row_terms=meta["max_row_terms"][i],
            )
            for i in range(3)
        )
        dev = self.device
        for tag in _QUERIES:
            pts = JacobianPoint(
                *(F.as_tensor(state[f"{tag}_{c}"], dev) for c in "xyz")
            )
            setattr(self, f"{tag}_pts", pts)
            setattr(self, f"{tag}_mask", F.as_tensor(state[f"{tag}_mask"], dev))
        self._upload_mats()
        return self

    def _upload_mats(self) -> None:
        dev = self.device
        self._mat_buffers = tuple(
            (
                F.as_tensor(m.coeffs, dev),
                torch.from_numpy(m.cols.astype(np.int64)).to(dev),
                torch.from_numpy(m.seg_ids.astype(np.int64)).to(dev),
            )
            for m in self.mats
        )

    def _encode_query(self, cops, query, n: int):
        curve = cops.curve
        pts = [curve.generator if p is None else p for p in query]
        pts += [curve.generator] * (n - len(query))
        mask = np.zeros(n, dtype=np.uint32)
        for i, p in enumerate(query):
            if p is not None:
                mask[i] = 1
        return cops.encode_points(pts, self.device), F.as_tensor(mask, self.device)

    # -- device pipeline --

    def _row_eval(self, mat: _SparseMat, z_mont, bufs):
        """A/B/C evaluations over the domain: (L, m) Montgomery."""
        coeffs, cols, seg_ids = bufs
        taken = z_mont.index_select(-1, cols)
        prods = F.mont_mul(self.fr, coeffs, taken)
        return F.segment_sum_mod(self.fr, prods, seg_ids, self.m, mat.max_row_terms)

    def _h_canonical(self, z_mont):
        """Witness -> canonical h(x) coefficient limbs, all on the device."""
        fr = self.fr
        a_ev, b_ev, c_ev = (
            self._row_eval(m, z_mont, bufs) for m, bufs in zip(self.mats, self._mat_buffers)
        )
        a_c = NTT.intt(fr, a_ev)
        b_c = NTT.intt(fr, b_ev)
        c_c = NTT.intt(fr, c_ev)
        ab = F.mont_mul(fr, NTT.coset_ntt(fr, a_c), NTT.coset_ntt(fr, b_c))
        diff = F.sub(fr, ab, NTT.coset_ntt(fr, c_c))
        z_inv = pow(
            (pow(fr.generator, self.m, fr.modulus) - 1) % fr.modulus, -1, fr.modulus
        )
        h_ev = F.mul_const(fr, diff, F.const(fr, z_inv))
        h_c = NTT.coset_intt(fr, h_ev)
        return F.normalize(fr, F.from_mont(fr, h_c))

    def _prove_scalars(self, z_mont, z_canon):
        """Witness -> the four masked MSM scalar arrays (A, B1, B2 over the
        AB lanes; the merged L/H array with h(x) computed on the device)."""
        h_canon = self._h_canonical(z_mont)
        L = z_canon.shape[0]
        sc_ab = torch.cat([z_canon, z_canon.new_zeros((L, self.n_ab - self.nv))], -1)
        n_l = len(self.pk.l_query)
        n_h = len(self.pk.h_query)
        sc_lh = torch.cat(
            [
                z_canon[:, self.ni : self.nv],
                h_canon[:, :n_h],
                z_canon.new_zeros((L, self.n_lh - n_l - n_h)),
            ],
            -1,
        )
        return (
            sc_ab * self.a_mask[None, :],
            sc_ab * self.b1_mask[None, :],
            sc_ab * self.b2_mask[None, :],
            sc_lh * self.lh_mask[None, :],
        )

    def _run_msm(self, cops, sc, pts, n: int):
        return M.msm(
            cops, sc, pts, self.window_bits, min(n, self.column_steps), self.fr.bits, True
        )

    # -- host API --

    def _encode_witness(self, assignment: Sequence[int]):
        if len(assignment) != self.nv:
            raise ValueError(f"assignment has {len(assignment)} values, the circuit {self.nv}")
        vals = [int(x) % self.fr.modulus for x in assignment]
        z_mont = F.as_tensor(F.encode_ints(self.fr, vals), self.device)
        z_canon = F.as_tensor(F.encode_ints(self.fr, vals, montgomery=False), self.device)
        return z_mont, z_canon

    def _prove_core(self, z_mont, z_canon, mark=lambda name: None) -> list:
        """The device part of a proof: witness -> the four MSM accumulators
        (A, B1, B2, L/H). `mark(phase)` is called after each phase."""
        sc_a, sc_b1, sc_b2, sc_lh = self._prove_scalars(z_mont, z_canon)
        mark("scalars")
        accs = []
        for tag, cops, sc, pts, n in (
            ("msm_a", self.g1, sc_a, self.a_pts, self.n_ab),
            ("msm_b1", self.g1, sc_b1, self.b1_pts, self.n_ab),
            ("msm_b2", self.g2, sc_b2, self.b2_pts, self.n_ab),
            ("msm_lh", self.g1, sc_lh, self.lh_pts, self.n_lh),
        ):
            accs.append(self._run_msm(cops, sc, pts, n))
            mark(tag)
        return accs

    def _finish(self, accs, r_rand: int, s_rand: int) -> G.Proof:
        """Host completion: decode the four accumulators, apply the
        constant-size randomization terms."""
        pk = self.pk
        g1c, g2c = pk.cfg.g1, pk.cfg.g2
        p = self.fr.modulus
        a_acc = self.g1.decode_points(accs[0])[0]
        b1_acc = self.g1.decode_points(accs[1])[0]
        b2_acc = self.g2.decode_points(accs[2])[0]
        lh_acc = self.g1.decode_points(accs[3])[0]
        a_pt = g1c.add(g1c.add(pk.alpha_g1, a_acc), g1c.scalar_mul(r_rand, pk.delta_g1))
        b_pt = g2c.add(g2c.add(pk.beta_g2, b2_acc), g2c.scalar_mul(s_rand, pk.delta_g2))
        b1_pt = g1c.add(g1c.add(pk.beta_g1, b1_acc), g1c.scalar_mul(s_rand, pk.delta_g1))
        c_pt = g1c.add(lh_acc, g1c.scalar_mul(s_rand, a_pt))
        c_pt = g1c.add(c_pt, g1c.scalar_mul(r_rand, b1_pt))
        c_pt = g1c.add(c_pt, g1c.neg(g1c.scalar_mul(r_rand * s_rand % p, pk.delta_g1)))
        return G.Proof(a=a_pt, b=b_pt, c=c_pt)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def prove(
        self,
        assignment: Sequence[int],
        r_rand: int = 0,
        s_rand: int = 0,
        timings: Optional[dict] = None,
    ) -> G.Proof:
        """One proof. With a `timings` dict, the device is synchronised at
        each phase boundary and the wall seconds of the phases are stored in
        it: "scalars" (witness upload, row evaluation, h(x), masks), "msm_a",
        "msm_b1", "msm_b2", "msm_lh" and "finish" (host decode + randomization)."""
        clock = [time.perf_counter()]

        def mark(name):
            if timings is not None:
                self._sync()
                now = time.perf_counter()
                timings[name] = now - clock[0]
                clock[0] = now

        accs = self._prove_core(*self._encode_witness(assignment), mark)
        proof = self._finish(accs, r_rand, s_rand)
        mark("finish")
        return proof

    def prove_batch(
        self,
        assignments: Sequence[Sequence[int]],
        rands: Optional[Sequence[tuple]] = None,
    ) -> List[G.Proof]:
        """Prove B independent witnesses one after another."""
        if rands is None:
            rands = [(0, 0)] * len(assignments)
        return [self.prove(a, r, s) for a, (r, s) in zip(assignments, rands)]
