"""Wall time, kernel launches and peak device memory of three MSMs of the port.

    python3 tools/torch_time_msm.py [--root DIR] [--reps N]

The MSMs (window 13, 128 column steps) are BN254 G1 over 4096 points on the
fused backend (32 lanes, so off the fold path, where the point-op kernel
adds and the MSM's chains of doublings run), BN254 G1 over 65536 points on
"rns_fused" (the production G1 shape of the bucket column, (128, 51,
20·512)) and BN254 G2 over 65536 points on the fused backend (the fold path
of the production prover's G2 MSM); points (i+1)·G and seeded random
scalars, each result checked against (sum (i+1)·s_i mod r)·G. Each MSM runs
once to warm up, then `reps` times; printed per MSM: the wall times (host
clock around the call and a device synchronize), the launches of every
point and RNS kernel in one run (the wrappers' counts), and the device
memory allocated at the run's peak above its inputs. Prints one JSON line,
with the card's name.

`--root` imports the port (`manta_tpu_torch`) from another checkout, whose
kernels it builds into that checkout's `build/`: run against a copy of an
earlier commit, and this script times both in one call on one card.
Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import sys
import time

import torch

SEED = 20261018


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device: this script times the port on a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    from manta_tpu_torch.ops import curve as C
    from manta_tpu_torch.ops import field_ops as F
    from manta_tpu_torch.ops import msm as M
    from manta_tpu_torch.ops.kernels import point_kernels as PK
    from manta_tpu_torch.ops.kernels import rns_kernels as RK
    from manta_tpu_torch.utils import hostmath

    multiples = {}
    for curve in (hostmath.BN254_G1, hostmath.BN254_G2):
        acc, multiples[curve.name] = None, []
        for _ in range(65536):
            acc = curve.add(acc, curve.generator)
            multiples[curve.name].append(acc)
    out = {"root": os.path.abspath(args.root), "device": torch.cuda.get_device_name(0),
           "msms": {}}
    for backend, curve, n in (("fused", hostmath.BN254_G1, 4096),
                              ("rns_fused", hostmath.BN254_G1, 65536),
                              ("fused", hostmath.BN254_G2, 65536)):
        pts = multiples[curve.name]
        r = curve.scalar_field.modulus
        cops = C.curve_ops_for(curve, backend)
        rng = random.Random(SEED + n)
        scalars = [rng.randrange(r) for _ in range(n)]
        sc = F.as_tensor(F.encode_ints(curve.scalar_field, scalars, montgomery=False), "cuda")
        points = cops.encode_points(pts[:n], "cuda")
        want = curve.scalar_mul(sum((i + 1) * s for i, s in enumerate(scalars)) % r,
                                curve.generator)
        walls = []
        for rep in range(args.reps + 1):
            PK.reset_launches()
            RK.reset_launches()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            got = M.msm(cops, sc, points, 13, 128, curve.scalar_field.bits)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            if cops.decode_points(got)[0] != want:
                raise AssertionError(f"{curve.name} {backend} MSM n={n} != (sum (i+1)·s_i)·G")
            if rep:  # the first run warms up
                walls.append(wall)
        out["msms"][f"{curve.name} {backend} n={n}"] = {
            "wall_s": walls,
            "launches": {"point": dict(PK.LAUNCHES), "rns": dict(RK.LAUNCHES)},
            "peak_gib": (torch.cuda.max_memory_allocated() - base) / 2**30,
        }
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
