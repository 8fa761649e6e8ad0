"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit code, and no
phase catches its own failure:

1. record the machine (torch, CUDA, nvcc, the card's name and power limit);
   no CUDA device -> exit 1 before any result is printed;
2. build every kernel from `manta_tpu_torch/csrc/` with `nvcc` for sm_90a,
   all objects at once, and print the compiler's register and spill report;
3. hold the field kernel's mul / add / sub against their plain versions on
   the card, bit for bit (tolerance 0: exact integer arithmetic), on BN254 Fr
   and Fq and BLS12-381 Fr and Fq at n in {1000, 65536, 826224}, random
   lazy values plus the edge values 0, 1, p-1, p, 2p-1; time kernel and
   plain version at the prover's shapes beside the bound (the kernel's device
   time from a replayed CUDA graph, and its time a call from Python);
4. hold the point-op (add, madd, double), bucket-column, fold, combine,
   merge and chain kernels against their plain versions, bit for bit, on
   BN254 G1 and G2 and BLS12-381 G1 and G2: point ops (a group of 2 threads
   a lane on G1, one thread on G2) over 1000 lanes with the lanes P+P,
   P+(-P), P+inf, inf+Q and inf+inf, and on BN254 the point addition built
   for 1, 2 and 4 threads a lane (`point_kernels.POINT_GROUPS`, timed in
   phase 7); the
   bucket column at K = 16 over 4 windows of 256 lanes with sorted digits
   (`bucket_stream`: a lane of q, -q, q, ..., a lane of one point repeated
   (the doubling branch), one digit across whole lanes, runs ending on a
   chunk's first and last step, empty buckets, a lane at infinity and a
   tenth of the points at infinity); the fold at K = 16, R = 1024 with
   random heads plus an all-head row; the fold (with and without B) also at
   K = 37 (4 threads a lane, 37 not a multiple of 4) and K = 128 (32 threads
   a lane) with an all-head and a no-head lane, heads on the first and on
   the last step of every chunk, a lane of q, -q, q, ... (inner sums at
   infinity) and a lane of one point repeated (inner sums double); the
   combine at 20 windows of 13 bits (5 weight doublings) and at 3 windows;
   the merge over 4000 buckets with 1200 level-1 and 300 level-2 partials
   (`merge_inputs`: partials -a and a, infinite partials, buckets at
   infinity with other coordinates, dead keys), also against the dense
   additions it replaced; the chain kernel (`fused_double_add`) on Horner's
   shape (one lane, and 8 lanes, 19 steps of 13 doublings) and the weighted
   reductions' (20 lanes, one step of 12 or 6 doublings, either operand
   order) with edge chains (`combine_inputs`: acc = W_w, a sum at infinity,
   chains and addends at infinity);
5. the same for the RNS kernels (point op, bucket column with RNS points in
   and with limb points in, combine) against their plain versions, bit for
   bit, on the four curves: both bucket columns on `bucket_stream`'s edge
   lanes (the RNS one on the same points converted to RNS, its buckets also
   the hybrid one's), the combine on Horner's shape (8 lanes, 19 steps of 13
   doublings) and the weighted reductions' (40 lanes, one step of 12 or 6
   doublings, either operand order) with `combine_inputs`' edge chains; and
   the RNS kernels' table-free zero test against the 2^13-row zero-class
   table on the values k·p and k·p ± 1, k < 8192;
6. MSMs on the card: BN254 G1 over 65536 points (i+1)·G (window 13, 128
   column steps: the fold path) and over 4096 points (32 lanes: no fold
   path, where the point-op and chain kernels run; their launches are
   counted there: no point-op doubling, at most 48 additions, 3 chains, and
   every point-op and chain call recorded) on the fused backend, and 4096
   points on the limb backend; BN254 G1 over 65536 points on "rns_fused"
   (one RNS bucket column, no stream) and "rns_hybrid" and BLS12-381 G1 over
   65536 points on "rns_hybrid" (window 13); each checked against
   (sum (i+1)·s_i mod r)·G as `bench.py` checks;
7. the production PrivateTransfer prover from `.bench_prover_pt.npz` on the
   backend its meta records (fused), two proofs (r, s) = (7, 9) and (2, 3),
   each verified by the host pairing against `.bench_prover_pt_vk.bin`,
   with the launch count of every kernel read around that run (bucket column
   4, fold 16, combine 4 and merge 4 a proof, no point op, no chain); the
   point kernels' calls of the first proof (bucket columns, every fold
   level, the combines, the merges) are recorded, each (kernel, curve,
   shape) held bit for bit against the same formulas through the limb
   `CurveOps` on the card on the recorded inputs (the merge against the
   dense additions it replaced; and at the shape its `kernels` entry
   reports, against the plain version too), then timed at that shape beside
   its bound; the point-op and chain calls of phase 6's MSM off the fold
   path the same way (the point op's largest addition its reported shape);
   the single-lane doubling that the combine replaced, and the dense
   point-op addition of the bucket merge that the merge kernel replaced (the
   point op's yardstick shape), are timed, the latter also with the point op
   built for 1, 2 and 4 threads a lane;
8. one proof on the limb backend, verified, its launches read around it;
9. the production prover on "rns_hybrid" (its limb points as they are), two
   proofs verified, launches read around them (exactly 8 hybrid bucket
   columns and 24 combines, no RNS-input bucket column, no single-lane
   doubling, no mixed-add point op); every RNS-kernel call of the first
   proof recorded, held bit for bit against its plain version on the
   recorded inputs and timed beside its bound; the RNS bucket column (B7)
   timed at the prover's G1 shape on the same points converted to RNS, its
   buckets and last step held against the hybrid bucket column's there; the
   single-lane doubling the combine replaced timed as a yardstick;
10. the port's entry point: `torch_entry.dryrun()` ("rns_fused", the
   Poseidon-preimage circuit) proves and verifies, launches read around it
   (bucket columns with RNS points in, no single-lane doubling, no hybrid
   column); every RNS-kernel call of that proof (point ops, bucket columns
   and combines, G1 and G2) recorded, held bit for bit against its plain
   version on the recorded inputs and timed; its largest G1 bucket-column
   call is that kernel's reported shape;
11. one JSON line describing each ported kernel, then the card's
   `nvidia-smi` line, then the last line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
import os
import random
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

# H100 SXM peaks (NVIDIA data sheet): HBM rate, and the non-tensor float32
# rate used as the ceiling for 32-bit integer multiply-adds.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12

SEED = 20261017
KERNEL_SOURCE = "manta_tpu_torch/csrc/field_kernels.cu"
REPLACES = "manta_tpu/ops/pallas/field_kernels.py:164"
POINT_SOURCE = "manta_tpu_torch/csrc/point_kernels.cu"
POINT_REPLACES = {
    "point": "manta_tpu/ops/pallas/point_kernels.py:501",
    "buckets": "manta_tpu/ops/pallas/point_kernels.py:603",
    "fold": "manta_tpu/ops/pallas/point_kernels.py:711",
    # the window sums and Horner loop that ran as `_point_op` launches
    "combine": "manta_tpu/ops/pallas/point_kernels.py:501",
    # the two dense bucket merges that ran as `_point_op` launches
    "merge": "manta_tpu/ops/pallas/point_kernels.py:501",
    # Horner's rule and the weighted reductions' doubling runs off the fold
    # path, which ran as `_point_op` launches
    "chain": "manta_tpu/ops/pallas/point_kernels.py:501",
}
RNS_SOURCE = "manta_tpu_torch/csrc/rns_kernels.cu"
RNS_REPLACES = {
    "point": "manta_tpu/ops/pallas/rns_kernels.py:739",
    "buckets": "manta_tpu/ops/pallas/rns_kernels.py:511",
    "hybrid": "manta_tpu/ops/pallas/rns_kernels.py:599",
    # Horner's rule and the weighted reductions' doubling runs, which ran as
    # `_rns_point_op` launches
    "combine": "manta_tpu/ops/pallas/rns_kernels.py:739",
}


def log(msg: str) -> None:
    print(msg, flush=True)


def run(cmd) -> str:
    return subprocess.run(cmd, capture_output=True, text=True, check=True).stdout.strip()


def cuda_ms(fn, reps: int) -> float:
    """Mean wall time of `fn` on the device in ms over `reps` back-to-back
    calls (CUDA events), after a warm-up. Where the host issues calls more
    slowly than the device runs them, this is the host's rate."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int) -> float:
    """Device time of one `fn` call in ms: `reps` calls captured in a CUDA
    graph and replayed, so no host work sits between the launches."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (3 * reps)


# ---------------------------------------------------------------------------
# phase 1
# ---------------------------------------------------------------------------


def record_machine() -> str:
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke needs a GPU", file=sys.stderr)
        sys.exit(1)
    from manta_tpu_torch.ops.kernels import build as B

    nvcc = run([B.nvcc(), "--version"]).splitlines()
    log("nvcc: " + next((ln for ln in nvcc if "release" in ln), nvcc[-1]))
    smi = run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    log(f"nvidia-smi: {smi}")
    log(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    return smi.splitlines()[0]


# ---------------------------------------------------------------------------
# phase 3: kernel vs plain
# ---------------------------------------------------------------------------


def lazy_operands(spec, n: int, rng: np.random.Generator):
    """Two (L, n) int32 tensors of lazy values in [0, 2p): the 25 pairs of
    edge values first, then random values below the top power of two <= 2p."""
    from manta_tpu_torch import fields
    from manta_tpu_torch.ops import field_ops as F

    L = spec.num_limbs
    p = spec.modulus
    hb = (2 * p).bit_length() - 1  # random values below 2^hb <= 2p
    out = []
    for _ in range(2):
        limbs = rng.integers(0, 1 << 16, size=(L, n), dtype=np.int64)
        limbs[hb // 16] &= (1 << (hb % 16)) - 1
        limbs[hb // 16 + 1 :] = 0
        out.append(limbs.astype(np.uint32))
    edges = [0, 1, p - 1, p, 2 * p - 1]
    pairs = [(x, y) for x in edges for y in edges][:n]
    for j, (x, y) in enumerate(pairs):
        out[0][:, j] = fields.int_to_limbs(x, L)
        out[1][:, j] = fields.int_to_limbs(y, L)
    return [F.as_tensor(a, "cuda") for a in out]


def bound_ms(which: str, L: int, n: int):
    """Least time for one call: bytes (two inputs read, one output written,
    int32 limbs) over HBM rate, and for mul the 32-bit multiply-adds of CIOS
    (2·S² + S per lane, S = ceil(L/2); two operations each) over the
    int32 ceiling. Returns (ms, "bytes" | "operations")."""
    t_bytes = 3 * L * 4 * n / HBM_BYTES_PER_S
    S = (L + 1) // 2
    ops = 2 * (2 * S * S + S) * n if which == "mul" else 2 * S * n
    t_ops = ops / INT32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def check_kernels():
    from manta_tpu_torch import fields
    from manta_tpu_torch.ops.kernels import field_kernels as K

    rng = np.random.default_rng(SEED)
    ops = {"mul": K.mont_mul, "add": K.add, "sub": K.sub}
    specs = [fields.BN254_FR, fields.BN254_FQ, fields.BLS12_381_FR, fields.BLS12_381_FQ]
    max_err = {w: 0 for w in ops}
    for spec in specs:
        for n in (1000, 65536, 826224):
            a, b = lazy_operands(spec, n, rng)
            for which, fn in ops.items():
                got = fn(spec, a, b)
                want = K.PLAIN[which](spec, a, b)
                torch.cuda.synchronize()
                err = int((got.long() - want.long()).abs().max())
                max_err[which] = max(max_err[which], err)
                if not torch.equal(got, want):
                    raise AssertionError(
                        f"{which} kernel != plain on {spec.name} n={n}: max |diff| {err}"
                    )
            log(f"  {spec.name:13s} n={n:7d}: mul add sub bit-equal to the plain versions")
            del a, b

    # timing at the prover's shapes: BN254 Fr over the largest sparse matrix
    # (row evaluation, 826224 entries) and the NTT domain (65536), BN254 Fq
    # over the MSM's 1024 lanes
    shapes = {
        "mul": [(fields.BN254_FR, 826224), (fields.BN254_FQ, 1024)],
        "add": [(fields.BN254_FR, 65536), (fields.BN254_FQ, 1024)],
        "sub": [(fields.BN254_FR, 65536), (fields.BN254_FQ, 1024)],
    }
    timings = {}
    for which, cases in shapes.items():
        rows = []
        for spec, n in cases:
            a, b = lazy_operands(spec, n, rng)
            reps = 50 if n > 100000 else 200
            k_ms = graph_ms(lambda: ops[which](spec, a, b), reps)
            call_ms = cuda_ms(lambda: ops[which](spec, a, b), reps)
            p_ms = cuda_ms(lambda: K.PLAIN[which](spec, a, b), max(reps // 10, 5))
            b_ms, b_by = bound_ms(which, spec.num_limbs, n)
            rows.append(
                {"field": spec.name, "n": n, "ms": k_ms, "call_ms": call_ms,
                 "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by}
            )
            log(
                f"  {which} {spec.name} n={n}: kernel {k_ms:.6f} ms on the device, "
                f"{call_ms:.6f} ms a call from Python, plain {p_ms:.6f} ms, "
                f"bound {b_ms:.6f} ms ({b_by})"
            )
        timings[which] = rows
    return max_err, timings


# ---------------------------------------------------------------------------
# phase 2: build
# ---------------------------------------------------------------------------


def build_kernels() -> dict:
    """Build every library not built yet, all objects at once; return the
    registers and spill bytes of each kernel by curve, from the `-Xptxas -v`
    report kept beside each library (so a library that an earlier run built
    reports too)."""
    import re

    from manta_tpu_torch.ops.kernels import build as B
    from manta_tpu_torch.ops.kernels import field_kernels as FK
    from manta_tpu_torch.ops.kernels import point_kernels as PK
    from manta_tpu_torch.ops.kernels import rns_kernels as RK

    # the point op built for each number of threads a lane, on BN254 (timed
    # in phase 7); the curve's own choice is in its library
    groups = [PK.library(name, g) for name in ("bn254_g1", "bn254_g2") for g in PK.POINT_GROUPS]
    libs = [FK.LIBRARY, *PK.LIBRARIES, *groups, *RK.LIBRARIES]
    t0 = time.perf_counter()
    paths = B.build(libs, verbose=True)
    seconds = time.perf_counter() - t0
    log(f"  built {len(paths)} libraries in {seconds:.3f} s: "
        + ", ".join(os.path.relpath(p, ROOT) for p in paths))
    report = {"field": {}, "point": {}, "point_groups": {}, "buckets": {}, "fold": {},
              "combine": {}, "merge": {}, "chain": {}, "rns_point": {}, "rns_buckets": {},
              "rns_hybrid": {}, "rns_combine": {}, "seconds": seconds}
    texts = {what: text for lib in libs for what, text in B.reports(lib).items()}
    if len(texts) != sum(len(lib.units) for lib in libs):
        raise AssertionError(f"compiler reports missing: have {sorted(texts)}")
    def usage(text):
        regs = [int(x) for x in re.findall(r"Used (\d+) registers", text)]
        spills = [int(a) + int(b) for a, b in
                  re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads", text)]
        return {"registers": max(regs), "spill_bytes": max(spills, default=0)}

    def split(text, kernel):  # (usage without `kernel`'s entries, usage of them)
        entries = text.split("Compiling entry function")
        theirs = "".join(e for e in entries[1:] if kernel in e)
        return usage(entries[0] + "".join(e for e in entries[1:] if kernel not in e)), usage(theirs)

    for what, text in texts.items():
        row = usage(text)
        if what.startswith("field_kernels"):
            report["field"] = row
            continue
        if what.startswith("rns_kernels"):
            curve = what.split()[0].removeprefix("rns_kernels-")
            kernel = RK.KERNELS[int(what.rsplit("=", 1)[1])]
            kind = "rns_point" if kernel in ("add", "madd", "double") else f"rns_{kernel}"
            report[kind][f"{curve} {kernel}" if kind == "rns_point" else curve] = row
            continue
        curve = what.split()[0].removeprefix("point_kernels-")
        if "MANTA_POINT_GROUP" in what:  # the add object of a point-group library
            report["point_groups"][curve] = split(text, "merge_kernel")[0]
            continue
        kernel = PK.KERNELS[int(what.rsplit("=", 1)[1])]
        kind = "point" if kernel in ("add", "madd", "double") else kernel
        if kernel == "add":  # the add object also holds the merge kernel
            row, report["merge"][curve] = split(text, "merge_kernel")
        if kernel == "combine":  # and the combine object the chain kernel
            row, report["chain"][curve] = split(text, "chain_kernel")
        report[kind][f"{curve} {kernel}" if kind == "point" else curve] = row
    for kind, rows in report.items():
        if kind != "seconds":
            log(f"  {kind}: registers / spill bytes {json.dumps(rows)}")
    return report


# ---------------------------------------------------------------------------
# phase 4: point, column and fold kernels vs their plain versions
# ---------------------------------------------------------------------------

CURVE_NAMES = ("bn254_g1", "bn254_g2", "bls12_381_g1", "bls12_381_g2")


def _curve(name):
    from manta_tpu_torch.utils import hostmath

    return getattr(hostmath, name.upper())


def host_points(curve, rng, n, p_inf=0.1):
    """n points from 8 random multiples of G (repeats give P+P lanes), a share
    of them at infinity."""
    r = curve.scalar_field.modulus
    base = [curve.scalar_mul(int(k) % r or 1, curve.generator) for k in rng.integers(1, 2**62, 8)]
    return [None if rng.random() < p_inf else base[int(i)] for i in rng.integers(0, 8, n)]


def _max_err(got, want) -> int:
    return max(int((g.long() - w.long()).abs().max()) for g, w in zip(got, want))


def check_point_kernels() -> dict:
    from manta_tpu_torch.ops import curve as C
    from manta_tpu_torch.ops.kernels import point_kernels as PK

    rng = np.random.default_rng(SEED + 1)
    max_err = {"point": 0, "buckets": 0, "fold": 0, "combine": 0, "merge": 0, "chain": 0}

    def hold(kind, what, got, want):
        torch.cuda.synchronize()
        err = _max_err(got, want)
        max_err[kind] = max(max_err[kind], err)
        if err:
            raise AssertionError(f"{what} kernel != plain: max |diff| {err}")

    for name in CURVE_NAMES:
        curve = _curve(name)
        limb = C.curve_ops_for(curve, "limb")
        ps, qs = host_points(curve, rng, 1000, 0.0), host_points(curve, rng, 1000)
        ps[3] = ps[4] = None  # P+P, P+(-P), P+inf, inf+Q, inf+inf
        qs[:5] = [ps[0], curve.neg(ps[1]), None, qs[5], None]
        pa, qa = limb.encode_points(ps, "cuda"), limb.encode_points(qs, "cuda")
        p2, q2 = limb.double(pa), limb.double(qa)
        for which, args in (("add", (p2, q2)), ("add", (pa, pa)), ("madd", (p2, qa)),
                            ("madd", (pa, pa)), ("double", (p2,))):
            hold("point", f"{name} {which}", getattr(PK, f"fused_{which}")(curve, *args),
                 PK.PLAIN[which](curve, *args))
        if name in ("bn254_g1", "bn254_g2"):  # the point-group builds timed in phase 7
            for args in ((p2, q2), (pa, pa)):
                want = PK.plain_add(curve, *args)
                for g in PK.POINT_GROUPS:
                    hold("point", f"{name} add, {g} threads a lane",
                         PK._point_op(curve, "add", *args, point_group=g), want)
        cops = C.curve_ops_for(curve, "fused")
        for n, steps, doublings, first in ((1, 19, 13, True), (8, 19, 13, True),
                                           (20, 1, 12, False), (20, 1, 6, True)):
            init, addends = combine_inputs(curve, cops, rng, n, steps, doublings, first)
            hold("chain", f"{name} chain (n={n}, {steps} steps of {doublings} doublings)",
                 PK.fused_double_add(curve, init, addends, doublings, first),
                 PK.plain_fused_double_add(curve, init, addends, doublings, first))
        K, R = 16, 1024
        args = bucket_stream(curve, limb, rng, K, 4, R // 4, 513)
        got_b, got_a = PK.accumulate_buckets(curve, *args)
        want_b, want_a = PK.plain_accumulate_buckets(curve, *args)
        hold("buckets", f"{name} bucket column", [*got_b, *got_a], [*want_b, *want_a])
        # the plain merge and the dense additions it replaced first: the
        # kernel updates the buckets in place
        merge_args = merge_inputs(curve, limb, rng, 4000, 1200, 300)
        want = PK.plain_merge_buckets(curve, *merge_args)
        hold("merge", f"{name} dense merge (limb reference) vs plain merge",
             PK.limb_merge_buckets(curve, *merge_args), want)
        hold("merge", f"{name} merge", PK.merge_buckets(curve, *merge_args), want)
        enc = limb.encode_points(host_points(curve, rng, K * R), "cuda")
        head = torch.from_numpy(rng.random((K, R)) < 0.3).cuda()
        head[3] = True

        def stream(c):  # lane j owns points [j*K, (j+1)*K)
            return c.reshape(*c.shape[:-1], R, K).movedim(-1, 0).contiguous()

        q = [stream(c) for c in limb.double(enc)]
        got_a, got_b = PK.fold_columns(curve, *q, head, True)
        want_a, want_b = PK.plain_fold_columns(curve, *q, head, True)
        hold("fold", f"{name} fold", [*got_a, *got_b], [*want_a, *want_b])
        for k in (37, 128):
            q, fold_head = fold_stream(curve, limb, rng, k, 40)
            for sums in (False, True):
                got_a, got_b = PK.fold_columns(curve, *q, fold_head, sums)
                want_a, want_b = PK.plain_fold_columns(curve, *q, fold_head, sums)
                hold("fold", f"{name} fold K={k} sums={sums}",
                     [*got_a, *(got_b or ())], [*want_a, *(want_b or ())])
        for windows in (20, 3):
            a, b = (limb.double(limb.encode_points(host_points(curve, rng, 2 * windows), "cuda"))
                    for _ in range(2))
            hold("combine", f"{name} combine W={windows}", PK.combine_windows(curve, a, b, 5, 13),
                 PK.plain_combine_windows(curve, a, b, 5, 13))
        log(f"  {name}: point add / madd / double over 1000 lanes, bucket column and fold at "
            f"K={K}, R={R} (edge lanes), fold at K=37 and 128 (R=40, edge lanes), combine at "
            f"W=20 and 3, merge over 4000 buckets (edge partials), chain on Horner's and the "
            f"reductions' shapes (edge chains): bit-equal to the plain versions")
    return max_err


def bucket_stream(curve, limb, rng, K, W, R, num_buckets, device="cuda"):
    """Arguments of `accumulate_buckets` as the MSM gives them: W windows of
    R lanes of K steps, each window's digits sorted, lane j of a window
    owning its sorted positions [j·K, (j+1)·K); heads, run ends and slots
    from `msm._sorted_layout` / `msm._run_end_slots`. Window 0 holds the
    edge lanes: lane 0 one digit over q, -q, q, ... (the sum at infinity
    every other step), lane 1 one digit over one point repeated (the
    doubling branch), lanes 2-4 one digit across whole lanes, lane 5 a run
    of one step at its first step and a run ending at its last step, then
    random digits, some buckets empty; window 1's lane 3 is all infinity, and
    a tenth of the other points are at infinity. Returns (px, py, qinf, head,
    slot, W·num_buckets)."""
    from manta_tpu_torch.ops import msm as M

    n = K * R
    digits = np.sort(rng.integers(0, num_buckets, (W, n)), axis=-1)
    edge = [np.full(K, 1), np.full(K, 2), np.full(3 * K, 3), [4], np.full(K - 1, 5)]
    digits[0] = np.concatenate(edge + [np.sort(rng.integers(6, num_buckets, n - 6 * K))])
    pts = host_points(curve, rng, W * n)
    g = curve.generator
    for k in range(K):
        pts[k] = g if k % 2 == 0 else curve.neg(g)
        pts[K + k] = pts[K]
        pts[n + 3 * K + k] = None
    enc = limb.encode_points(pts, device)

    def stream(c):  # (*E, W·n) in sorted order -> (K, *E, W·R)
        c = c.reshape(*c.shape[:-1], W, R, K).movedim(-1, 0)
        return c.reshape(*c.shape[:-2], W * R).contiguous()

    _, d_t, head, end = M._sorted_layout(torch.from_numpy(digits).to(device), K)
    qinf = stream(limb.affine_infinity_mask(enc)[None])[:, 0]
    return (stream(enc.x), stream(enc.y), qinf, head.reshape(K, W * R),
            M._run_end_slots(d_t, end, num_buckets), W * num_buckets)


def merge_inputs(curve, limb, rng, num_slots, n1, n2, device="cuda"):
    """Arguments of `merge_buckets`: Jacobian buckets (*E, num_slots), some at
    infinity as (0, 1, 0) and some with other coordinates (x kept, Z = 0 or
    Z = p); level-1 partials at n1 distinct slots (some -1) and level-2
    partials at n2 (some -1, some slots shared with level 1, one bucket at
    infinity with other coordinates hit by level 2 only); partials -a (sum
    at infinity), a (the doubling branch) and infinity among them."""
    from manta_tpu_torch import fields
    from manta_tpu_torch.ops.curve import JacobianPoint

    a = limb.double(limb.encode_points(host_points(curve, rng, num_slots, 0.05), device))
    a = JacobianPoint(*(c.contiguous() for c in a))  # updated in place on the card
    p_limbs = torch.tensor(fields.int_to_limbs(curve.field.modulus, curve.field.num_limbs)
                           .astype(np.int32), device=device)
    a.z[..., 1] = 0  # infinity, x and y kept
    a.z[..., 2] = 0
    if curve.is_ext:
        a.z[0, :, 3] = p_limbs  # z = p + 0·u: zero
        a.z[1, :, 3] = 0
    else:
        a.z[:, 3] = p_limbs
    order = rng.permutation(num_slots)
    # slots 1 and 3 (infinity, other coordinates) hit by nothing, slot 2 by
    # level 2 only: they come last (num_slots >= n1 + n2 + 3)
    order = np.concatenate([order[~np.isin(order, (1, 2, 3))], [1, 3, 2]])
    key1 = order[:n1].copy()
    key2 = np.concatenate([order[n1 // 2 : n1 // 2 + n2 // 2],
                           order[n1 : n1 + n2 - n2 // 2 - 1], [2]])
    key1[rng.integers(4, n1, n1 // 8)] = -1
    key2[rng.integers(0, n2 - 1, n2 // 8)] = -1
    key1, key2 = (torch.from_numpy(k).to(device) for k in (key1, key2))
    v1 = limb.double(limb.encode_points(host_points(curve, rng, n1, 0.05), device))
    v2 = limb.double(limb.encode_points(host_points(curve, rng, n2, 0.05), device))
    neg = limb.neg(JacobianPoint(*(c[..., key1[0:1]] for c in a)))
    same = JacobianPoint(*(c[..., key1[1:2]] for c in a))
    for c, cn, cs in zip(v1, neg, same):
        c[..., 0:1] = cn
        c[..., 1:2] = cs
        c[..., 2] = 0  # infinity
    return a, v1, key1, v2, key2


def fold_stream(curve, limb, rng, K, R):
    """(K, *E, R) Jacobian fold streams and a (K, R) head mask with the edge
    lanes of the scan: 0 alternates q and -q, 1 repeats one point, 2 is all
    heads, 3 has none, 4 has a head on every chunk's first step and 5 on
    every chunk's last step; the other lanes random."""
    from manta_tpu_torch.ops.kernels import point_kernels as PK

    pts = host_points(curve, rng, K * R, 0.05)
    g = curve.generator
    for k in range(K):
        pts[k] = g if k % 2 == 0 else curve.neg(g)
        pts[K + k] = pts[K]
    enc = limb.double(limb.encode_points(pts, "cuda"))
    q = [c.reshape(*c.shape[:-1], R, K).movedim(-1, 0).contiguous() for c in enc]
    head = rng.random((K, R)) < 0.2
    chunk = -(-K // PK.fold_threads(K))
    head[:, 2], head[:, 3] = True, False
    head[:, 4] = np.arange(K) % chunk == 0
    head[:, 5] = np.arange(K) % chunk == chunk - 1
    return q, torch.from_numpy(head).cuda()


# ---------------------------------------------------------------------------
# phase 5: RNS kernels vs their plain versions
# ---------------------------------------------------------------------------


def check_rns_kernels() -> dict:
    from manta_tpu_torch.ops import curve as C
    from manta_tpu_torch.ops import rns as R
    from manta_tpu_torch.ops.kernels import rns_kernels as RK

    rng = np.random.default_rng(SEED + 2)
    max_err = {"point": 0, "buckets": 0, "hybrid": 0, "combine": 0}

    def hold(kind, what, got, want):
        torch.cuda.synchronize()
        err = _max_err(got, want)
        max_err[kind] = max(max_err[kind], err)
        if err:
            raise AssertionError(f"{what} kernel != plain: max |diff| {err}")

    for name in CURVE_NAMES:
        curve = _curve(name)
        cops = C.curve_ops_for(curve, "rns_fused")
        ps, qs = host_points(curve, rng, 1000, 0.0), host_points(curve, rng, 1000)
        ps[3] = ps[4] = None  # P+P, P+(-P), P+inf, inf+Q, inf+inf
        qs[:5] = [ps[0], curve.neg(ps[1]), None, qs[5], None]
        pa, qa = cops.encode_points(ps, "cuda"), cops.encode_points(qs, "cuda")
        p2 = RK.plain_rns_point_op(curve, "double", pa)
        for which, args in (("add", (p2, qa)), ("add", (pa, pa)), ("madd", (p2, qa)),
                            ("madd", (pa, pa)), ("double", (p2,))):
            hold("point", f"{name} RNS {which}", getattr(RK, f"rns_{which}")(curve, *args),
                 RK.PLAIN[which](curve, *args))
        # both bucket columns on the MSM's layout: limb points in, and the same
        # points converted to RNS
        K, R_ = 16, 1024
        args = bucket_stream(curve, C.curve_ops_for(curve, "limb"), rng, K, 4, R_ // 4, 513)
        got_b, got_a = RK.hybrid_accumulate_buckets(curve, *args)
        want_b, want_a = RK.plain_hybrid_accumulate_buckets(curve, *args)
        hold("hybrid", f"{name} RNS hybrid bucket column", [*got_b, *got_a],
             [*want_b, *want_a])
        rns_args = (to_rns(curve, args[0]), to_rns(curve, args[1]), *args[2:])
        got_b, got_a = RK.rns_accumulate_buckets(curve, *rns_args)
        plain_b, plain_a = RK.plain_rns_accumulate_buckets(curve, *rns_args)
        hold("buckets", f"{name} RNS bucket column", [*got_b, *got_a], [*plain_b, *plain_a])
        hold("buckets", f"{name} RNS bucket column vs the hybrid one", [*got_b, *got_a],
             [*want_b, *want_a])
        for n, steps, doublings, first in ((8, 19, 13, True), (40, 1, 12, False), (40, 1, 6, True)):
            init, addends = combine_inputs(curve, cops, rng, n, steps, doublings, first)
            hold("combine", f"{name} RNS combine (n={n}, {steps} steps of {doublings} doublings)",
                 RK.rns_double_add(curve, init, addends, doublings, first),
                 RK.plain_rns_double_add(curve, init, addends, doublings, first))
        log(f"  {name}: RNS point add / madd / double over 1000 lanes, bucket column (RNS and "
            f"limb points in) at K={K}, R={R_} (edge lanes), combine on Horner's and the "
            f"reductions' shapes (edge chains): bit-equal to the plain versions")
        if not curve.is_ext:
            spec = R.default_spec(curve.field)
            p = curve.field.modulus
            vals = [k * p + d for k in range(RK.N_ZERO_CLASSES + 2) for d in (-1, 0, 1)
                    if k * p + d >= 0]
            a = torch.tensor([[v % m for v in vals] for m in spec.moduli], dtype=torch.int32,
                             device="cuda")
            got = RK.rns_is_zero(curve, a)
            want = RK.table_is_zero(spec, a)
            torch.cuda.synchronize()
            if not torch.equal(got, want) or int(want.sum()) != RK.N_ZERO_CLASSES:
                raise AssertionError(f"{name}: the table-free zero test disagrees with the table")
            log(f"  {name}: table-free zero test = the 2^13-row table on {len(vals)} values "
                f"k·p, k·p ± 1 ({int(got.sum())} zero)")
    return max_err


def to_rns(curve, stream):
    """(K, *E(L), R) 16-bit Montgomery limbs -> (K, *E(Kt), R) RNS residues of
    the same values (the hybrid column's conversion, in PyTorch)."""
    from manta_tpu_torch.ops.kernels import rns_kernels as RK

    ops = RK._plain_curve(curve).ops
    return ops.from_limbs(stream.movedim(0, -2)).movedim(-2, 0).contiguous()


def combine_inputs(curve, cops, rng, n, steps, doublings, chain_first, device="cuda"):
    """Arguments of a chain kernel, `rns_double_add` (`cops` an RNS backend)
    or `fused_double_add` (the fused backend): n chains of `steps` addends,
    Jacobian (Z != 1) and a fifth at infinity, with edge chains where there
    are lanes for them: lane 0's second addend equals its chain's value when
    it is added (the addition's doubling branch: acc = W_w), lane 1's first
    addend is the negation of it (the sum at infinity), lane 2 starts at
    infinity and lane 3's addends are all at infinity."""
    from manta_tpu_torch.ops import curve as C
    from manta_tpu_torch.ops.curve import JacobianPoint
    from manta_tpu_torch.ops.kernels import point_kernels as PK
    from manta_tpu_torch.ops.kernels import rns_kernels as RK

    if cops.backend == "rns":
        def double(p):
            return RK.plain_rns_point_op(curve, "double", p)

        def neg_y(y):  # −y + 2^10·p: a doubling's y is below 2^9.2·p (`RnsCurveOps.double`)
            return RK._plain_curve(curve).ops.sub_k(torch.zeros_like(y), y, 10)

        chain, infinity = RK.plain_rns_double_add, RK._infinity
    else:
        def double(p):
            return PK.plain_double(curve, p)

        neg_y = C.curve_ops_for(curve, "limb").ops.neg
        chain, infinity = PK.plain_fused_double_add, PK._infinity

    def pts(k):
        return double(cops.encode_points(host_points(curve, rng, k, 0.2), device))

    init = pts(n)
    addends = JacobianPoint(*(torch.stack(c) for c in zip(*(pts(n) for _ in range(steps)))))
    for c, i, a in zip(addends, infinity(curve, 1, device), init):
        if n > 3:
            c[..., 3] = i[..., 0]
        if n > 2:
            a[..., 2] = i[..., 0]

    def chain_value(lane, upto):  # lane's acc, doubled, as addend `upto` meets it
        acc = chain(curve, JacobianPoint(*(c[..., lane : lane + 1] for c in init)),
                    JacobianPoint(*(c[:upto, ..., lane : lane + 1] for c in addends)), doublings,
                    chain_first)
        for _ in range(doublings):
            acc = double(acc)
        return acc

    if steps > 1:
        for c, v in zip(addends, chain_value(0, 1)):
            c[1, ..., 0:1] = v
    if n > 1:
        v = chain_value(1, 0)
        for c, w in zip(addends, (v.x, neg_y(v.y), v.z)):
            c[0, ..., 1:2] = w
    return init, addends


# ---------------------------------------------------------------------------
# phase 6: MSMs
# ---------------------------------------------------------------------------


def multiples_of_g(curve, n):
    """(i+1)·G for i < n, by repeated addition on the host."""
    out, acc = [], None
    for _ in range(n):
        acc = curve.add(acc, curve.generator)
        out.append(acc)
    return out


def check_msm(cops, pts, steps, label):
    """sum s_i·(i+1)·G on the card against (sum (i+1)·s_i mod r)·G."""
    from manta_tpu_torch.ops import field_ops as F
    from manta_tpu_torch.ops import msm as M
    from manta_tpu_torch.ops.kernels import field_kernels as FK

    curve = cops.curve
    r = curve.scalar_field.modulus
    n = len(pts)
    rng = random.Random(SEED + n)
    scalars = [rng.randrange(r) for _ in range(n)]
    sc = F.as_tensor(F.encode_ints(curve.scalar_field, scalars, montgomery=False), "cuda")
    points = cops.encode_points(pts, "cuda")
    torch.cuda.synchronize()
    FK.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    got = M.msm(cops, sc, points, 13, steps, curve.scalar_field.bits)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    field_launches = dict(FK.LAUNCHES)
    want = curve.scalar_mul(sum((i + 1) * s for i, s in enumerate(scalars)) % r, curve.generator)
    if cops.decode_points(got)[0] != want:
        raise AssertionError(f"{label} disagrees with (sum (i+1)·s_i)·G")
    log(f"  {label}: {dt:.3f} s, equal to (sum (i+1)·s_i)·G; device memory allocated at its "
        f"peak above its inputs {peak:.3f} GiB; field-kernel launches in it {field_launches}")
    return field_launches


def check_msms():
    """The MSMs of phase 6; returns the point-kernel launches of the fused
    MSM off the fold path, the path where the point-op and chain kernels
    run, and a recorder of their calls there."""
    from manta_tpu_torch.ops import curve as C
    from manta_tpu_torch.ops.kernels import point_kernels as PK
    from manta_tpu_torch.ops.kernels import rns_kernels as RK
    from manta_tpu_torch.utils import hostmath

    curve = hostmath.BN254_G1
    fused, limb = C.curve_ops_for(curve, "fused"), C.curve_ops_for(curve, "limb")
    pts = multiples_of_g(curve, 65536)
    glue = check_msm(fused, pts, 128, "BN254 G1 MSM n=65536, fused, fold path")
    # the curve formulas of the fused MSM are kernels: only its glue (the
    # negated y coordinates, one negation in the weighted fold) is field ops
    if sum(glue.values()) > 4:
        raise AssertionError(f"the fused MSM ran field-kernel launches {glue}")
    PK.reset_launches()
    with Recorder() as recorder:
        check_msm(fused, pts[:4096], 128, "BN254 G1 MSM n=4096, fused, 32 lanes (no fold path)")
    off_fold = dict(PK.LAUNCHES)
    log(f"  point-kernel launches in it: {json.dumps(off_fold)}")
    # Horner's rule and the two weighted reductions' doubling runs are one
    # chain launch each; the point op only adds (69 additions and 265
    # doublings before the chain kernel, of which the chains took 21 and all)
    if (off_fold["double"] or off_fold["madd"] or not 0 < off_fold["add"] <= 48
            or off_fold["chain"] != 3 or off_fold["buckets"] != 1):
        raise AssertionError(f"the fused MSM off the fold path launched {off_fold}")
    check_msm(limb, pts[:4096], 128, "BN254 G1 MSM n=4096, limb")
    for backend in ("rns_fused", "rns_hybrid"):
        RK.reset_launches()
        check_msm(C.curve_ops_for(curve, backend), pts, 128, f"BN254 G1 MSM n=65536, {backend}")
        # one bucket column (RNS points in on rns_fused, limb points on
        # rns_hybrid) writing run ends only: no column writes a stream
        launched = {k: RK.LAUNCHES[k] for k in ("buckets", "hybrid", "double")}
        want = {"buckets": int(backend == "rns_fused"), "hybrid": int(backend == "rns_hybrid"),
                "double": 0}
        if launched != want or "columns" in RK.LAUNCHES:
            raise AssertionError(f"the {backend} MSM launched {dict(RK.LAUNCHES)}")
        log(f"  RNS-kernel launches in it: {json.dumps(RK.LAUNCHES)}")
    bls = hostmath.BLS12_381_G1
    check_msm(C.curve_ops_for(bls, "rns_hybrid"), multiples_of_g(bls, 65536), 128,
              "BLS12-381 G1 MSM n=65536, rns_hybrid")
    return off_fold, recorder


# ---------------------------------------------------------------------------
# phases 7 to 9: the production PrivateTransfer proofs
# ---------------------------------------------------------------------------


def load_production(backend=None):
    from manta_tpu_torch.models.groth16_device import DeviceProver
    from manta_tpu_torch.utils import keyio

    t0 = time.perf_counter()
    prover = DeviceProver.from_cache(
        os.path.join(ROOT, ".bench_prover_pt.npz"), backend=backend, device="cuda"
    )
    torch.cuda.synchronize()
    with open(os.path.join(ROOT, ".bench_prover_pt_aux.json")) as f:
        aux = json.load(f)
    with open(os.path.join(ROOT, ".bench_prover_pt_vk.bin"), "rb") as f:
        vk = keyio.vk_from_bytes(f.read())
    log(
        f"  cache load: {time.perf_counter() - t0:.3f} s (backend {prover.g1.backend}, "
        f"n_ab={prover.n_ab}, n_lh={prover.n_lh}, domain {prover.m}, window "
        f"{prover.window_bits}, column steps {prover.column_steps})"
    )
    return prover, aux, vk


def reset_counts():
    from manta_tpu_torch.ops.kernels import field_kernels as FK
    from manta_tpu_torch.ops.kernels import point_kernels as PK
    from manta_tpu_torch.ops.kernels import rns_kernels as RK

    FK.reset_launches()
    PK.reset_launches()
    RK.reset_launches()


def read_counts() -> dict:
    from manta_tpu_torch.ops.kernels import field_kernels as FK
    from manta_tpu_torch.ops.kernels import point_kernels as PK
    from manta_tpu_torch.ops.kernels import rns_kernels as RK

    return {"field": dict(FK.LAUNCHES), "point": dict(PK.LAUNCHES), "rns": dict(RK.LAUNCHES)}


def prove_and_verify(prover, aux, vk, idx, r, s):
    from manta_tpu_torch.models import groth16 as G

    assignment = [int(x) for x in aux["assignments"][idx]]
    public = [int(x) for x in aux["publics"][idx]]
    timings = {}
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    proof = prover.prove(assignment, r, s, timings=timings)
    wall = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    t1 = time.perf_counter()
    if not G.verify(vk, proof, public):
        raise AssertionError(f"proof of assignment {idx} failed to verify")
    parts = ", ".join(f"{k} {v:.3f}" for k, v in timings.items())
    log(f"  proof {idx} (r={r}, s={s}): {wall:.3f} s [{parts}] s; "
        f"verified by the host pairing in {time.perf_counter() - t1:.3f} s; device memory "
        f"allocated at the peak of the proof, above the prover's state: {peak:.3f} GiB")


class Recorder:
    """Wraps the point-kernel wrappers (or, with `rns`, the RNS-kernel
    wrappers) so that a run keeps the arguments of the first call of each
    (kernel, curve, shape): the calls to time."""

    def __init__(self, rns=False):
        from manta_tpu_torch.ops.kernels import point_kernels as PK
        from manta_tpu_torch.ops.kernels import rns_kernels as RK

        self.mod = RK if rns else PK
        self.names = ("_point_op", *RNS_WRAPPERS) if rns else ("_point_op", *POINT_WRAPPERS)
        self.calls, self.saved = {}, {}

    def __enter__(self):
        for name in self.names:
            fn = self.saved[name] = getattr(self.mod, name)
            setattr(self.mod, name, self._wrap(name, fn))
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.mod, name, fn)

    def _wrap(self, name, fn):
        from manta_tpu_torch.ops import curve as C

        def call(curve, *args):
            kind = "point" if name == "_point_op" else {**RNS_WRAPPERS, **POINT_WRAPPERS}[name]
            if kind == "point":
                key = (args[0], curve.name, tuple(args[1].x.shape))
            elif kind in ("combine", "chain") and name != "combine_windows":
                # (init, addends, doublings[, chain_first])
                first = bool(args[3]) if len(args) > 3 else True
                key = (kind, curve.name, tuple(args[1].x.shape), args[2], first)
            else:  # (px, py, ...), (qx, qy, qz, ...) or points first
                first = args[0].x if kind in ("combine", "merge") else args[0]
                key = (kind, curve.name, tuple(first.shape))
                if kind == "merge" and key not in self.calls:
                    # the merge updates its buckets in place: keep them as given
                    kept = (C.JacobianPoint(*(c.clone() for c in args[0])), *args[1:])
                    self.calls[key] = (fn, curve, kept)
            self.calls.setdefault(key, (fn, curve, args))
            return fn(curve, *args)

        return call


def prove_production(backend=None, proofs=((0, (7, 9)), (1, (2, 3))), record=False):
    prover, aux, vk = load_production(backend)
    recorder = Recorder(rns=(backend or "").startswith("rns")) if record else None
    reset_counts()
    for n, (idx, (r, s)) in enumerate(proofs):
        if recorder is not None and n == 0:
            with recorder:
                prove_and_verify(prover, aux, vk, idx, r, s)
        else:
            prove_and_verify(prover, aux, vk, idx, r, s)
    counts = read_counts()
    log(f"  kernel launches over the {len(proofs)} proof(s): {json.dumps(counts)}")
    return counts, recorder


# ---------------------------------------------------------------------------
# timing the point kernels at the shapes the proof gave them
# ---------------------------------------------------------------------------

# the point-kernel wrappers the recorder wraps (besides `_point_op`), by kind
POINT_WRAPPERS = {"accumulate_buckets": "buckets", "fold_columns": "fold",
                  "combine_windows": "combine", "merge_buckets": "merge",
                  "fused_double_add": "chain"}

# Montgomery products per formula: (base-field products of G1, of G2; an Fq2
# product is 3 base products, an Fq2 square 2)
PRODUCTS = {"add": (16, 44), "madd": (11, 29), "double": (7, 16)}


def point_bound_ms(kind, curve, args):
    """Least time of one call: the bytes it must move (each input read once,
    each output written once) over HBM rate, against its 32-bit
    multiply-adds (2 operations each: 2·S² + S per Montgomery product, S
    words; the formulas this run's data needs: no mixed add at a head, no
    add into A at a head in the fold, K additions into B where the caller
    asks for B; the fold scan's extra additions are not the function's
    work; the rare doubling lanes of the edge dispatch are not counted) over
    the int32 ceiling."""
    words = (curve.field.num_limbs + 1) // 2
    per_product = 2 * (2 * words * words + words)
    g = 1 if curve.is_ext else 0
    if kind in PRODUCTS:  # args: (which, p[, q])
        size = args[1].x.numel()
        coords = size * (3 if kind == "double" else 6) + 3 * size
        lanes = size // (curve.field.num_limbs * (2 if curve.is_ext else 1))
        products = PRODUCTS[kind][g] * lanes
    elif kind == "buckets":  # args: (px, py, qinf, head, slot, num_slots)
        px, _, _, head, slot, _ = args
        lanes = px.shape[-1]
        rows = px[0].numel() // lanes  # 16-bit rows of a coordinate
        ends = int((slot >= 0).sum())
        # px, py and the three masks read; the run ends and the last step written
        coords = 2 * px.numel() + 3 * head.numel() + 3 * rows * (ends + lanes)
        products = PRODUCTS["madd"][g] * int((~head.bool()).sum())
    elif kind == "merge":  # args: (buckets, v1, key1, v2, key2)
        a, _, key1, _, key2 = args
        n = a.x.shape[-1]
        rows = a.x.numel() // n
        live = int((key1 >= 0).sum()) + int((key2 >= 0).sum())
        hit = int(torch.unique(torch.cat([key1[key1 >= 0], key2[key2 >= 0]])).numel())
        # every bucket's Z read (an infinity elsewhere is made canonical), the
        # hit buckets' X, Y read and all three written, the live partials and
        # both keys read; an addition per live partial
        coords = rows * n + 5 * rows * hit + 3 * rows * live + key1.numel() + key2.numel()
        products = PRODUCTS["add"][g] * live
    elif kind == "fold":  # args: (qx, qy, qz, head, sums); B's last row with sums
        qx, _, _, head, sums = args
        coords = 6 * qx.numel() + head.numel() + (3 * qx[0].numel() if sums else 0)
        products = PRODUCTS["add"][g] * (int((~head.bool()).sum())
                                         + (head.numel() if sums else 0))
    elif kind == "chain":  # (init, addends, doublings, chain_first): init read,
        # the addends read, the result written; the chain's doublings and additions
        init, addends, doublings, _ = args
        coords = 6 * init.x.numel() + 3 * addends.x.numel()
        lanes = init.x.numel() // (curve.field.num_limbs * (2 if curve.is_ext else 1))
        products = lanes * addends.x.shape[0] * (doublings * PRODUCTS["double"][g]
                                                 + PRODUCTS["add"][g])
    else:  # combine: (a, b, doublings, window_bits); a, b (*E, 2W) -> (*E, 1)
        a, _, doublings, window_bits = args
        windows = a.x.shape[-1] // 2
        coords = 6 * a.x.numel() + 3 * a.x.numel() // a.x.shape[-1]
        doubles = windows * doublings + (windows - 1) * window_bits
        products = (PRODUCTS["double"][g] * doubles
                    + PRODUCTS["add"][g] * (2 * windows + windows - 1))
    t_bytes = coords * 4 / HBM_BYTES_PER_S
    t_ops = products * per_product / INT32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


# the shape of each kernel that its `kernels` entry reports from the fused
# proof, with its plain time: the G1 bucket column of MSM A, the weighted
# fold's first level, the G1 combine, the G1 merge
MAIN_SHAPES = {
    "buckets": ("buckets", "bn254_g1", (128, 16, 10240)),
    "fold": ("fold", "bn254_g1", (32, 16, 2560)),
    "combine": ("combine", "bn254_g1", (16, 40)),
    "merge": ("merge", "bn254_g1", (16, 81940)),
}
# the point op's yardstick, its reported shape before the chain kernel: the
# dense point-op addition of the bucket merge that the merge kernel replaced
# (one of two a G1 MSM)
POINT_YARDSTICK = ("add", "bn254_g1", (16, 81940))
# the chain kernel's reported call in the fused MSM off the fold path:
# Horner's rule, 19 windows after the first, 13 doublings each
CHAIN_MAIN = ("chain", "bn254_g1", (19, 16, 1), 13, True)


def reference(kind, which, curve, args):
    """The recorded call through the limb `CurveOps` on the card: the same
    formulas, one field-kernel launch per field op (field kernel held
    against its plain version in phase 3)."""
    from manta_tpu_torch.ops import curve as C
    from manta_tpu_torch.ops.kernels import point_kernels as PK

    from manta_tpu_torch.ops import msm as M

    if kind == "point":
        return getattr(C.curve_ops_for(curve, "limb"), which)(*args[1:])
    if kind == "chain":
        return M.double_add_loop(C.curve_ops_for(curve, "limb"), *args)
    limb = {"buckets": PK.limb_accumulate_buckets, "fold": PK.limb_fold_columns,
            "combine": PK.limb_combine_windows, "merge": PK.limb_merge_buckets}[kind]
    return limb(curve, *args)


def _coords(out) -> list:
    """The coordinate tensors of a point, or of the fold's (A, B or None)."""
    if isinstance(out[0], tuple):
        return [c for pt in out if pt is not None for c in pt]
    return list(out)


def time_recorded(recorder, max_err, main_shapes) -> dict:
    """Hold every recorded call against the limb reference on the card, and
    at the `main_shapes` also against the plain version (the host integers),
    bit for bit, on the recorded inputs; raise on any difference, and keep
    the largest in `max_err`. Then time each call."""
    from manta_tpu_torch.ops import curve as C
    from manta_tpu_torch.ops.kernels import point_kernels as PK

    rows = {"point": [], "buckets": [], "fold": [], "combine": [], "merge": [], "chain": []}
    for key, (fn, curve, args) in sorted(recorder.calls.items(), key=lambda kv: kv[0]):
        which, curve_name, shape = key[:3]
        kind = "point" if which in PRODUCTS else which
        if kind == "merge":  # in place: a copy for each use
            kept = args
            args = (C.JacobianPoint(*(c.clone() for c in kept[0])), *kept[1:])
        got = _coords(fn(curve, *args))
        if kind == "merge":
            args = kept
        err = _max_err(got, _coords(reference(kind, which, curve, args)))
        row = {"op": which, "curve": curve_name, "shape": list(shape)}
        if kind == "chain":
            row["doublings"], row["chain_first"] = key[3:]
        main = main_shapes.get(kind) == key
        if main:
            t0 = time.perf_counter()
            want = (PK.PLAIN[which](curve, *args[1:]) if kind == "point"
                    else PK.PLAIN[kind](curve, *args))
            torch.cuda.synchronize()
            row["plain_ms"] = (time.perf_counter() - t0) * 1e3
            row["main"] = True
            err = max(err, _max_err(got, _coords(want)))
        row["max_abs_err"] = err
        max_err[kind] = max(max_err[kind], err)
        if err:
            raise AssertionError(f"{which} {curve_name} {tuple(shape)}: kernel != "
                                 f"{'plain version' if main else 'limb reference'}: "
                                 f"max |diff| {err}")
        row["bound_ms"], row["bound_by"] = point_bound_ms(which, curve, args)
        if kind == "merge":  # timed on a copy, updated in place call after call
            args = (C.JacobianPoint(*(c.clone() for c in args[0])), *args[1:])
        once = graph_ms(lambda: fn(curve, *args), 1)
        reps = max(1, min(200, int(20 / max(once, 1e-3))))
        row["ms"] = graph_ms(lambda: fn(curve, *args), reps)
        row["call_ms"] = cuda_ms(lambda: fn(curve, *args), reps)
        if main and kind == "point":
            row["point_groups_ms"] = point_groups_ms(curve, *args[1:])
        rows[kind].append(row)
        checked = "the limb reference" + (" and the plain version" if main else "")
        log(f"  {which} {curve_name} {tuple(shape)}: bit-equal to {checked}; "
            f"{row['ms']:.6f} ms on the device, {row['call_ms']:.6f} ms a call, bound "
            f"{row['bound_ms']:.6f} ms ({row['bound_by']})"
            + (f", plain {row['plain_ms']:.3f} ms" if main else "")
            + (f"; by threads a lane {row['point_groups_ms']}" if "point_groups_ms" in row
               else ""))
    for kind, key in main_shapes.items():
        if not any(r.get("main") for r in rows[kind]):
            raise AssertionError(f"no {key[0]} call on {key[1]} at {key[2:]} was recorded")
    return rows


def point_groups_ms(curve, p, q) -> dict:
    """The point addition's device time on p, q with the kernel built for 1,
    2 and 4 threads a lane (`point_kernels.POINT_GROUPS`), in turns 1, 2, 4,
    4, 2, 1 on the same card; each the mean of its two turns, in ms. Each
    build is held bit for bit against the curve's own build first."""
    from manta_tpu_torch.ops.kernels import point_kernels as PK

    want = PK.fused_add(curve, p, q)
    for g in PK.POINT_GROUPS:
        err = _max_err(PK._point_op(curve, "add", p, q, point_group=g), want)
        if err:
            raise AssertionError(f"add {curve.name}, {g} threads a lane, != the curve's build: "
                                 f"max |diff| {err}")
    times = {g: [] for g in PK.POINT_GROUPS}
    for g in (*PK.POINT_GROUPS, *reversed(PK.POINT_GROUPS)):
        times[g].append(graph_ms(lambda: PK._point_op(curve, "add", p, q, point_group=g), 20))
    return {str(g): sum(t) / len(t) for g, t in times.items()}


def dense_merges(recorder, max_err) -> list:
    """The dense point-op addition of the bucket merge that the merge kernel
    replaced (two a MSM before it: buckets + B1, then + B2), on each
    recorded merge call's buckets and its level-1 partials spread over the
    buckets: held against the limb reference (and at the point op's
    yardstick shape the plain version) and timed, also with the kernel built
    for 1, 2 and 4 threads a lane; and those builds on the buckets added to
    themselves one lane over, where every lane is a generic addition (the
    partials of the dense merge are infinity on all but its run ends)."""
    from manta_tpu_torch.ops import curve as C
    from manta_tpu_torch.ops.kernels import point_kernels as PK

    rows = []
    for (which, curve_name, shape), (_, curve, args) in sorted(recorder.calls.items(),
                                                              key=lambda kv: kv[0]):
        if which != "merge":
            continue
        a, v1, key1 = args[:3]
        b1 = PK._infinity(curve, a.x.shape[-1], "cuda")
        live = key1 >= 0
        for o, c in zip(b1, v1):
            o[..., key1[live]] = c[..., live]
        got = PK.fused_add(curve, a, b1)
        err = _max_err(got, C.curve_ops_for(curve, "limb").add(a, b1))
        row = {"op": "add", "curve": curve_name, "shape": list(a.x.shape),
               "path": "the dense bucket merge's addition that the merge kernel replaced"}
        if POINT_YARDSTICK == ("add", curve_name, tuple(a.x.shape)):
            t0 = time.perf_counter()
            want = PK.plain_add(curve, a, b1)
            torch.cuda.synchronize()
            row["plain_ms"] = (time.perf_counter() - t0) * 1e3
            row["yardstick"] = True
            err = max(err, _max_err(got, want))
        row["max_abs_err"] = err
        max_err["point"] = max(max_err["point"], err)
        if err:
            raise AssertionError(f"add {curve_name} at the bucket-merge shape: kernel != "
                                 f"reference: max |diff| {err}")
        row["ms"] = graph_ms(lambda: PK.fused_add(curve, a, b1), 20)
        row["call_ms"] = cuda_ms(lambda: PK.fused_add(curve, a, b1), 20)
        row["bound_ms"], row["bound_by"] = point_bound_ms("add", curve, ("add", a, b1))
        row["point_groups_ms"] = point_groups_ms(curve, a, b1)
        other = C.JacobianPoint(*(torch.roll(c, 1, -1) for c in a))
        row["point_groups_generic_ms"] = point_groups_ms(curve, a, other)
        rows.append(row)
        log(f"  add {curve_name} {tuple(a.x.shape)} (the dense bucket merge's addition the "
            f"merge kernel replaced): bit-equal to the reference; {row['ms']:.6f} ms on the "
            f"device, {row['call_ms']:.6f} ms a call, bound {row['bound_ms']:.6f} ms "
            f"({row['bound_by']}); by threads a lane {row['point_groups_ms']}, on generic "
            f"lanes {row['point_groups_generic_ms']}")
    if not any(r.get("yardstick") for r in rows):
        raise AssertionError(f"the proof made no merge at the yardstick shape {POINT_YARDSTICK}")
    return rows


def horner_doublings(recorder, max_err) -> list:
    """The single-lane doubling that the combine kernel replaced (247 of them
    an MSM until PR 6), on the first window row of each recorded combine
    call: held against the limb reference and timed, as a yardstick for the
    combine."""
    from manta_tpu_torch.ops import curve as C
    from manta_tpu_torch.ops.kernels import point_kernels as PK

    rows = []
    for (which, curve_name, _), (_, curve, args) in sorted(recorder.calls.items(),
                                                          key=lambda kv: kv[0]):
        if which != "combine":
            continue
        p = C.JacobianPoint(*(c[..., :1].contiguous() for c in args[0]))
        err = _max_err(PK.fused_double(curve, p), C.curve_ops_for(curve, "limb").double(p))
        max_err["point"] = max(max_err["point"], err)
        if err:
            raise AssertionError(f"double {curve_name} at the Horner shape: kernel != limb "
                                 f"reference: max |diff| {err}")
        row = {"op": "double", "curve": curve_name, "shape": list(p.x.shape),
               "path": "the Horner doubling the combine replaced", "max_abs_err": err}
        row["ms"] = graph_ms(lambda: PK.fused_double(curve, p), 200)
        row["call_ms"] = cuda_ms(lambda: PK.fused_double(curve, p), 200)
        row["bound_ms"], row["bound_by"] = point_bound_ms("double", curve, ("double", p))
        rows.append(row)
        log(f"  double {curve_name} {tuple(p.x.shape)} (the Horner doubling the combine "
            f"replaced): bit-equal to the limb reference; {row['ms']:.6f} ms on the device, "
            f"{row['call_ms']:.6f} ms a call, bound {row['bound_ms']:.6f} ms ({row['bound_by']})")
    return rows


# ---------------------------------------------------------------------------
# phase 9: the RNS kernels at the shapes the rns_hybrid proof gave them
# ---------------------------------------------------------------------------

# RNS products per formula (G1; G2 with 4 base products per Fq2 product)
RNS_PRODUCTS = {"add": (16, 64), "madd": (11, 44), "double": (7, 28)}


def rns_product_ops(spec) -> int:
    """32-bit integer operations of one RNS Montgomery product, counted as
    the int32 ceiling counts them (a multiply-add is 2): the two base
    extensions' multiply-adds ((k2+1)·k1 and (k1+1)·k2) and ~4 instructions
    (product, Barrett high product, product, subtract), 2 operations each,
    for each of the Kt + 4·k1 + 3·k2 + 2 channel modular products."""
    k1, k2, kt = spec.k1, spec.k2, spec.kt
    return 2 * ((k2 + 1) * k1 + (k1 + 1) * k2) + 2 * 4 * (kt + 4 * k1 + 3 * k2 + 2)


def rns_bound_ms(kind, curve, args):
    """Least time of one RNS-kernel call: each input read once and each output
    written once over HBM rate, against the integer operations of the RNS
    products this run's data needs (no mixed add at a head; the hybrid
    column's limb sums and conversion products; the zero tests and the rare
    doubling lanes not counted) over the int32 ceiling."""
    from manta_tpu_torch.ops import rns as R

    spec = R.default_spec(curve.field)
    comps = 2 if curve.is_ext else 1
    g = 1 if curve.is_ext else 0
    per = rns_product_ops(spec)
    if kind == "point":  # args: (which, p[, q])
        which, size = args[0], args[1].x.numel()
        words = size * (3 if which == "double" else 6) + 3 * size
        ops = RNS_PRODUCTS[which][g] * (size // (spec.kt * comps)) * per
    elif kind == "combine":  # args: (init, addends, doublings, chain_first)
        init, addends, doublings, _ = args
        lanes = init.x.numel() // (spec.kt * comps)
        steps = addends.x.shape[0]
        # init and addends read, the result written
        words = 3 * init.x.numel() + 3 * addends.x.numel() + 3 * init.x.numel()
        ops = lanes * steps * (doublings * RNS_PRODUCTS["double"][g]
                               + RNS_PRODUCTS["add"][g]) * per
    else:  # buckets, hybrid: (px, py, qinf, head, slot, num_slots)
        px, _, qinf, head, slot, _ = args
        steps, lanes = head.shape
        ends = int((slot >= 0).sum())
        # the points and three masks read; the run ends and the last step written
        words = 2 * px.numel() + 3 * head.numel() + 3 * comps * spec.kt * (ends + lanes)
        ops = RNS_PRODUCTS["madd"][g] * int((~head.bool()).sum()) * per
        if kind == "hybrid":  # limb sums and one conversion product per component
            L = curve.field.num_limbs
            ops += steps * lanes * 2 * comps * (2 * L * spec.kt + per)
    t_bytes = words * 4 / HBM_BYTES_PER_S
    t_ops = ops / INT32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


# the RNS kernel wrappers the recorder wraps, by kind
RNS_WRAPPERS = {"rns_accumulate_buckets": "buckets", "hybrid_accumulate_buckets": "hybrid",
                "rns_double_add": "combine"}

# the shape of each RNS kernel that its `kernels` entry reports from the
# rns_hybrid proof: the G1 bucket merge of MSM A, its hybrid bucket column and
# its Horner chain (19 windows after the first, 13 doublings each; the RNS
# bucket column's is the entry point's largest G1 call, phase 10)
RNS_MAIN_SHAPES = {
    "point": ("add", "bn254_g1", (51, 20, 4097)),
    "hybrid": ("hybrid", "bn254_g1", (128, 16, 10240)),
    "combine": ("combine", "bn254_g1", (19, 51, 1), 13, True),
}


def _time_row(fn, row, kind, curve, args):
    once = graph_ms(fn, 1)
    reps = max(1, min(200, int(20 / max(once, 1e-3))))
    row["ms"] = graph_ms(fn, reps)
    row["call_ms"] = cuda_ms(fn, reps)
    row["bound_ms"], row["bound_by"] = rns_bound_ms(kind, curve, args)


def time_recorded_rns(recorder, max_err, main_shapes, path) -> dict:
    """Hold every recorded RNS-kernel call of a proof against its plain
    version (PyTorch on the card) on the recorded inputs, bit for bit; raise
    on any difference, keep the largest in `max_err`. Time each call beside
    its bound, and its plain version; the rows at `main_shapes` are the ones
    the `kernels` line reports."""
    from manta_tpu_torch.ops.kernels import rns_kernels as RK

    rows = {"point": [], "buckets": [], "hybrid": [], "combine": []}
    for key, (fn, curve, args) in sorted(recorder.calls.items(), key=lambda kv: kv[0]):
        which, curve_name, shape = key[:3]
        kind = "point" if which in RNS_PRODUCTS else which
        got = _coords(fn(curve, *args))
        t0 = time.perf_counter()
        if kind == "point":
            want = RK.plain_rns_point_op(curve, *args)
        else:
            want = RK.PLAIN[kind](curve, *args)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = _max_err(got, _coords(want))
        row = {"op": which, "curve": curve_name, "shape": list(shape), "path": path,
               "max_abs_err": err, "plain_ms": plain_ms}
        if kind == "combine":
            row["doublings"], row["chain_first"] = key[3:]
        max_err[kind] = max(max_err[kind], err)
        if err:
            raise AssertionError(f"RNS {which} {curve_name} {tuple(shape)} ({path}): kernel != "
                                 f"plain version: max |diff| {err}")
        if main_shapes.get(kind) == key:
            row["main"] = True
        _time_row(lambda: fn(curve, *args), row, kind, curve, args)
        rows[kind].append(row)
        log(f"  RNS {which} {curve_name} {tuple(shape)}: bit-equal to the plain version; "
            f"{row['ms']:.6f} ms on the device, {row['call_ms']:.6f} ms a call, bound "
            f"{row['bound_ms']:.6f} ms ({row['bound_by']}), plain {plain_ms:.3f} ms")
    for kind, key in main_shapes.items():
        if not any(r.get("main") for r in rows[kind]):
            raise AssertionError(f"{path} made no RNS {key[0]} call on {key[1]} at {key[2:]}")
    return rows


def buckets_on_hybrid_points(recorder, max_err) -> dict:
    """The RNS bucket column (B7) at the hybrid bucket column's reported
    shape, on the same points converted to RNS: its buckets and last step
    held against the hybrid bucket column's there and against its own plain
    version; timed."""
    from manta_tpu_torch.ops.kernels import rns_kernels as RK

    fn, curve, args = recorder.calls[RNS_MAIN_SHAPES["hybrid"]]
    px, py, qinf, head, slot, num_slots = args
    bargs = (to_rns(curve, px), to_rns(curve, py), qinf, head, slot, num_slots)
    got = _coords(RK.rns_accumulate_buckets(curve, *bargs))
    hybrid = _coords(fn(curve, *args))
    t0 = time.perf_counter()
    want = _coords(RK.plain_rns_accumulate_buckets(curve, *bargs))
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = max(_max_err(got, want), _max_err(got, hybrid))
    max_err["buckets"] = max(max_err["buckets"], err)
    if err:
        raise AssertionError(f"RNS bucket column at {tuple(bargs[0].shape)}: != plain version "
                             f"or hybrid bucket column: max |diff| {err}")
    row = {"op": "buckets", "curve": curve.name, "shape": list(bargs[0].shape),
           "path": "the hybrid column's points in RNS", "max_abs_err": err, "plain_ms": plain_ms}
    _time_row(lambda: RK.rns_accumulate_buckets(curve, *bargs), row, "buckets", curve, bargs)
    log(f"  RNS buckets {curve.name} {tuple(bargs[0].shape)} (the hybrid column's points in "
        f"RNS): bit-equal to the plain version and to the hybrid bucket column's buckets; "
        f"{row['ms']:.6f} ms on the device, bound {row['bound_ms']:.6f} ms ({row['bound_by']}), "
        f"plain {plain_ms:.3f} ms")
    return row


def rns_horner_doublings(recorder, max_err) -> list:
    """The single-lane RNS doubling that the combine replaced (247 of them
    an MSM before it), on the first addend of each recorded Horner chain
    (one lane): held against its plain version and timed, as a yardstick
    for the combine."""
    from manta_tpu_torch.ops.curve import JacobianPoint
    from manta_tpu_torch.ops.kernels import rns_kernels as RK

    rows = []
    for key, (_, curve, args) in sorted(recorder.calls.items(), key=lambda kv: kv[0]):
        if key[0] != "combine" or key[2][-1] != 1:  # Horner: one lane
            continue
        p = JacobianPoint(*(c[0].contiguous() for c in args[1]))
        err = _max_err(RK.rns_double(curve, p), RK.plain_rns_point_op(curve, "double", p))
        max_err["point"] = max(max_err["point"], err)
        if err:
            raise AssertionError(f"RNS double {curve.name} at the Horner shape: kernel != plain "
                                 f"version: max |diff| {err}")
        row = {"op": "double", "curve": curve.name, "shape": list(p.x.shape),
               "path": "the Horner doubling the combine replaced", "max_abs_err": err}
        _time_row(lambda: RK.rns_double(curve, p), row, "point", curve, ("double", p))
        rows.append(row)
        log(f"  RNS double {curve.name} {tuple(p.x.shape)} (the Horner doubling the combine "
            f"replaced): bit-equal to the plain version; {row['ms']:.6f} ms on the device, "
            f"{row['call_ms']:.6f} ms a call, bound {row['bound_ms']:.6f} ms")
    return rows


# ---------------------------------------------------------------------------
# phase 10: the port's entry point
# ---------------------------------------------------------------------------


def entry_dryrun():
    """Run `torch_entry.dryrun()` with every RNS-kernel call recorded:
    (launch counts, recorder)."""
    import torch_entry

    torch_entry._setup()  # the host's key setup, outside the counted run
    reset_counts()
    t0 = time.perf_counter()
    with Recorder(rns=True) as recorder:
        torch_entry.dryrun()
    torch.cuda.synchronize()
    counts = read_counts()
    log(f"  torch_entry.dryrun(): {torch_entry.BACKEND} proof of the Poseidon preimage "
        f"verified in {time.perf_counter() - t0:.3f} s; launches {json.dumps(counts)}")
    return counts, recorder


def main() -> int:
    log("== phase 1: machine")
    smi = record_machine()

    log("== phase 2: build")
    build = build_kernels()

    log("== phase 3: field kernel vs plain version")
    max_err, timings = check_kernels()

    log("== phase 4: point, bucket-column, fold, combine, merge and chain kernels vs plain "
        "versions")
    point_err = check_point_kernels()

    log("== phase 5: RNS point, bucket-column (RNS and limb points in) and combine kernels vs "
        "plain versions")
    rns_err = check_rns_kernels()

    log("== phase 6: MSMs")
    off_fold, off_fold_calls = check_msms()

    log("== phase 7: production PrivateTransfer proofs (the meta's backend)")
    counts, recorder = prove_production(record=True)
    for group, ops in (("field", ("mul", "add", "sub")),
                       ("point", ("buckets", "fold", "combine", "merge"))):
        for op in ops:
            if counts[group][op] <= 0:
                raise AssertionError(f"the main path launched no {group} {op} kernel")
    # two proofs of four MSMs: 1 bucket column, 4 folds, 1 merge and 1
    # combine an MSM; no point-op or chain launch (the merge kernel adds the
    # bucket batches, the combine runs Horner's rule)
    want = {"add": 0, "madd": 0, "double": 0, "buckets": 8, "fold": 32, "combine": 8, "merge": 8,
            "chain": 0}
    if counts["point"] != want:
        raise AssertionError(f"unexpected point-kernel launches over two proofs: {counts['point']}")
    log("  the point kernels at the shapes of the first proof: checked, then timed")
    point_rows = time_recorded(recorder, point_err, MAIN_SHAPES)
    point_rows["point"] += dense_merges(recorder, point_err)
    point_rows["point"] += horner_doublings(recorder, point_err)
    del recorder
    log("  the point-op and chain kernels at the shapes of phase 6's MSM off the fold path: "
        "checked, then timed")
    # its bucket column is the production proofs' kernel, held and timed there
    off_fold_calls.calls = {key: call for key, call in off_fold_calls.calls.items()
                            if key[0] in PRODUCTS or key[0] == "chain"}
    largest_add = max((key for key in off_fold_calls.calls if key[:2] == ("add", "bn254_g1")),
                      key=lambda key: math.prod(key[2]))
    off_rows = time_recorded(off_fold_calls, point_err, {"point": largest_add,
                                                         "chain": CHAIN_MAIN})
    del off_fold_calls
    for kind in ("point", "chain"):
        for row in off_rows[kind]:
            row["path"] = "fused MSM off the fold path, 4096 points (phase 6)"
        point_rows[kind] += off_rows[kind]

    log("== phase 8: production proof (limb backend)")
    limb_counts, _ = prove_production("limb", proofs=((0, (7, 9)),))
    for op, count in limb_counts["field"].items():
        if count <= 0:
            raise AssertionError(f"the limb path launched no {op} kernel")

    log("== phase 9: production PrivateTransfer proofs on rns_hybrid")
    rns_counts, recorder = prove_production("rns_hybrid", record=True)
    # two proofs of four MSMs: 1 hybrid bucket column and 3 combines (Horner,
    # the two weighted reductions' doubling runs) an MSM; no bucket column of
    # RNS points and no single-lane doubling; the point op adds the trailing
    # partials, the buckets and their reductions
    want = {"madd": 0, "double": 0, "buckets": 0, "hybrid": 8, "combine": 24, "is_zero": 0}
    got = {op: rns_counts["rns"][op] for op in want}
    if got != want or rns_counts["rns"]["add"] <= 0:
        raise AssertionError(f"unexpected RNS-kernel launches over two rns_hybrid proofs: "
                             f"{rns_counts['rns']}")
    log("  the RNS kernels at the shapes of the first proof: checked, then timed")
    rns_rows = time_recorded_rns(recorder, rns_err, RNS_MAIN_SHAPES,
                                 "production proof (rns_hybrid)")
    rns_rows["buckets"].append(buckets_on_hybrid_points(recorder, rns_err))
    rns_rows["point"] += rns_horner_doublings(recorder, rns_err)
    del recorder

    log("== phase 10: torch_entry.dryrun() (rns_fused)")
    entry_counts, recorder = entry_dryrun()
    for op in ("add", "buckets", "combine"):
        if entry_counts["rns"][op] <= 0:
            raise AssertionError(f"the entry point launched no RNS {op} kernel")
    if entry_counts["rns"]["double"] or entry_counts["rns"]["hybrid"]:
        raise AssertionError(f"the entry point's rns_fused proof launched {entry_counts['rns']}")
    log("  the RNS kernels at the shapes of the entry point's proof: checked, then timed")
    g1_buckets = max((key for key in recorder.calls if key[:2] == ("buckets", "bn254_g1")),
                     key=lambda key: math.prod(key[2]))
    entry_rows = time_recorded_rns(recorder, rns_err, {"buckets": g1_buckets},
                                   "torch_entry.dryrun (rns_fused)")
    del recorder
    for kind, rows in entry_rows.items():
        rns_rows[kind] += rows

    names = {"mul": "field_kernels.mont_mul", "add": "field_kernels.add",
             "sub": "field_kernels.sub"}
    kernels = []
    for which in ("mul", "add", "sub"):
        main_shape = timings[which][0]
        kernels.append({
            "name": names[which],
            "route": "cuda",
            "source": KERNEL_SOURCE,
            "replaces": REPLACES,
            "launches": counts["field"][which],
            "limb_path_launches": limb_counts["field"][which],
            "max_abs_err": max_err[which],
            "ms": main_shape["ms"],
            "call_ms": main_shape["call_ms"],
            "plain_ms": main_shape["plain_ms"],
            "bound_ms": main_shape["bound_ms"],
            "bound_by": main_shape["bound_by"],
            "library_ms": None,
            "field": main_shape["field"],
            "n": main_shape["n"],
            "shapes": timings[which],
            "build": build["field"],
        })
    # the point op and the chain kernel run off the fold path only: their
    # launches are those of the fused MSM off the fold path (phase 6)
    point_launches = {
        "point": {op: off_fold[op] for op in ("add", "madd", "double")},
        "chain": off_fold["chain"],
        **{kind: counts["point"][kind] for kind in ("buckets", "fold", "combine", "merge")},
    }
    for kind, name in (("point", "point_kernels.point_op"),
                       ("buckets", "point_kernels.accumulate_buckets"),
                       ("fold", "point_kernels.fold_columns"),
                       ("combine", "point_kernels.combine_windows"),
                       ("merge", "point_kernels.merge_buckets"),
                       ("chain", "point_kernels.fused_double_add")):
        main_row = next(r for r in point_rows[kind] if r.get("main"))
        launches = point_launches[kind]
        off = kind in ("point", "chain")
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": POINT_SOURCE,
            "replaces": POINT_REPLACES[kind],
            "launches": sum(launches.values()) if kind == "point" else launches,
            "path": ("fused MSM off the fold path, 4096 points (phase 6)" if off
                     else "production proofs (fused)"),
            "max_abs_err": point_err[kind],
            "ms": main_row["ms"],
            "call_ms": main_row["call_ms"],
            "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"],
            "library_ms": None,
            "curve": main_row["curve"],
            "op": main_row["op"],
            "shape": main_row["shape"],
            **({"launches_by_op": launches,
                "point_groups_ms": main_row["point_groups_ms"],
                # the shape it was reported at before the chain kernel, for comparison
                "yardstick": next(r for r in point_rows[kind] if r.get("yardstick"))}
               if kind == "point" else {}),
            "shapes": point_rows[kind],
            "build": {**build[kind], **({"point_groups": build["point_groups"]}
                                        if kind == "point" else {})},
        })
    rns_launches = {
        "point": {op: rns_counts["rns"][op] for op in ("add", "madd", "double")},
        "buckets": entry_counts["rns"]["buckets"],
        "hybrid": rns_counts["rns"]["hybrid"],
        "combine": rns_counts["rns"]["combine"],
    }
    for kind, name in (("point", "rns_kernels.rns_point_op"),
                       ("buckets", "rns_kernels.rns_accumulate_buckets"),
                       ("hybrid", "rns_kernels.hybrid_accumulate_buckets"),
                       ("combine", "rns_kernels.rns_double_add")):
        main_row = next(r for r in rns_rows[kind] if r.get("main"))
        launches = rns_launches[kind]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": RNS_SOURCE,
            "replaces": RNS_REPLACES[kind],
            # B6, B8 and the combine on the rns_hybrid proofs; B7 on the entry
            # point's rns_fused proof
            "launches": sum(launches.values()) if kind == "point" else launches,
            "path": "torch_entry.dryrun (rns_fused)" if kind == "buckets" else
                    "production proofs (rns_hybrid)",
            "max_abs_err": rns_err[kind],
            "ms": main_row["ms"],
            "call_ms": main_row["call_ms"],
            "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"],
            "library_ms": None,
            "curve": main_row["curve"],
            "op": main_row["op"],
            "shape": main_row["shape"],
            **({"launches_by_op": launches,
                "entry_launches_by_op": {op: entry_counts["rns"][op]
                                         for op in ("add", "madd", "double")}}
               if kind == "point" else {}),
            "shapes": rns_rows[kind],
            "build": build[f"rns_{kind}"],
        })
    print(json.dumps({"kernels": kernels, "build_seconds": build["seconds"]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
