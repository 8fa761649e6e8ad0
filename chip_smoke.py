"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit code:

1. record the machine (torch, CUDA, nvcc, the card's name and power limit);
   no CUDA device -> exit 1 before any result is printed;
2. build the CUDA field kernel from `manta_tpu_torch/csrc/field_kernels.cu`;
3. hold the kernel's mul / add / sub against their plain PyTorch versions on
   the card, bit for bit (tolerance 0: exact integer arithmetic), on BN254 Fr
   and Fq and BLS12-381 Fr and Fq at n in {1000, 65536, 826224}, random
   lazy values plus the edge values 0, 1, p-1, p, 2p-1; time kernel and
   plain version at the prover's shapes beside the bound (the kernel's device
   time from a replayed CUDA graph, and its time a call from Python);
4. a BN254 G1 MSM of 4096 points (window 13) through the port's `msm`,
   checked against `msm_host_oracle`;
5. the main path: the production PrivateTransfer prover from
   `.bench_prover_pt.npz` on the limb backend, two proofs (r, s) = (7, 9) and
   (2, 3), each verified by the host pairing against `.bench_prover_pt_vk.bin`,
   with the launch count of every kernel op read around that run;
6. one JSON line describing each ported kernel, then the card's
   `nvidia-smi` line, then the last line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
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
    from manta_tpu_torch.ops.kernels import field_kernels as K

    nvcc = run([K._nvcc(), "--version"]).splitlines()
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
# phase 4: a small MSM
# ---------------------------------------------------------------------------


def check_msm():
    from manta_tpu_torch.ops import curve as C
    from manta_tpu_torch.ops import field_ops as F
    from manta_tpu_torch.ops import msm as M
    from manta_tpu_torch.utils import hostmath

    curve = hostmath.BN254_G1
    cops = C.curve_ops_for(curve, "limb")
    n = 4096
    pts, acc = [], None
    for _ in range(n):  # (i+1)·G by repeated addition
        acc = curve.add(acc, curve.generator)
        pts.append(acc)
    rng = random.Random(SEED)
    scalars = [rng.randrange(curve.scalar_field.modulus) for _ in range(n)]
    sc = F.as_tensor(F.encode_ints(curve.scalar_field, scalars, montgomery=False), "cuda")
    points = cops.encode_points(pts, "cuda")
    t0 = time.perf_counter()
    got = M.msm(cops, sc, points, 13, 128, curve.scalar_field.bits)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    got = cops.decode_points(got)[0]
    want = M.msm_host_oracle(curve, scalars, pts)
    if got != want:
        raise AssertionError("BN254 G1 MSM (n=4096) disagrees with msm_host_oracle")
    log(f"  BN254 G1 MSM n={n} window 13: {dt:.3f} s, equal to msm_host_oracle")


# ---------------------------------------------------------------------------
# phase 5: the production PrivateTransfer proofs
# ---------------------------------------------------------------------------


def prove_production():
    from manta_tpu_torch.models import groth16 as G
    from manta_tpu_torch.models.groth16_device import DeviceProver
    from manta_tpu_torch.ops.kernels import field_kernels as K
    from manta_tpu_torch.utils import keyio

    t0 = time.perf_counter()
    prover = DeviceProver.from_cache(
        os.path.join(ROOT, ".bench_prover_pt.npz"), backend="limb", device="cuda"
    )
    torch.cuda.synchronize()
    with open(os.path.join(ROOT, ".bench_prover_pt_aux.json")) as f:
        aux = json.load(f)
    with open(os.path.join(ROOT, ".bench_prover_pt_vk.bin"), "rb") as f:
        vk = keyio.vk_from_bytes(f.read())
    assignments = [[int(x) for x in a] for a in aux["assignments"]]
    publics = [[int(x) for x in p] for p in aux["publics"]]
    log(
        f"  cache load: {time.perf_counter() - t0:.3f} s (n_ab={prover.n_ab}, "
        f"n_lh={prover.n_lh}, domain {prover.m}, window {prover.window_bits}, "
        f"column steps {prover.column_steps})"
    )
    K.reset_launches()
    results = []
    for idx, (r, s) in ((0, (7, 9)), (1, (2, 3))):
        timings = {}
        t0 = time.perf_counter()
        proof = prover.prove(assignments[idx], r, s, timings=timings)
        wall = time.perf_counter() - t0
        t1 = time.perf_counter()
        ok = G.verify(vk, proof, publics[idx])
        t_verify = time.perf_counter() - t1
        if not ok:
            raise AssertionError(f"proof of assignment {idx} failed to verify")
        parts = ", ".join(f"{k} {v:.3f}" for k, v in timings.items())
        log(f"  proof {idx} (r={r}, s={s}): {wall:.3f} s [{parts}] s; "
            f"verified by the host pairing in {t_verify:.3f} s")
        results.append({"assignment": idx, "wall_s": wall, **timings})
    launches = dict(K.LAUNCHES)
    log(f"  kernel launches over the two proofs: {launches}")
    for which, count in launches.items():
        if count <= 0:
            raise AssertionError(f"the main path launched no {which} kernel")
    return launches, results


def main() -> int:
    log("== phase 1: machine")
    smi = record_machine()

    log("== phase 2: build")
    from manta_tpu_torch.ops.kernels import field_kernels as K

    t0 = time.perf_counter()
    lib = K.build(verbose=True)
    log(f"  built {os.path.relpath(lib, ROOT)} in {time.perf_counter() - t0:.3f} s")

    log("== phase 3: kernel vs plain version")
    max_err, timings = check_kernels()

    log("== phase 4: MSM")
    check_msm()

    log("== phase 5: production PrivateTransfer proofs (limb backend)")
    launches, _ = prove_production()

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
            "launches": launches[which],
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
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
