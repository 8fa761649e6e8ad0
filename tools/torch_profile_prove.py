"""Where one production PrivateTransfer proof spends its time on the GPU.

    python3 tools/torch_profile_prove.py [--backend fused|limb|rns_hybrid] [--out PATH]

Loads `.bench_prover_pt.npz` into the port's `DeviceProver` (CUDA) on the
curve backend asked for (default: fused, the backend the cache records; the
cache's limb points serve "rns_hybrid" as they are),
proves `assignments[0]` of `.bench_prover_pt_aux.json` once to warm up, then
proves it again under `torch.profiler` and prints: the wall time of each
phase, the device's busy time (sum of CUDA kernel times) and idle share of
the proof's wall time, the launches of each field-kernel op, point kernel
(point ops, bucket columns, folds, combines, merges, chains) and RNS kernel
(point ops, bucket columns of RNS and of limb points, combines), the device
time of each kind
of point kernel and of RNS kernel, and the kernels that take the most
device time. With --out, the full `key_averages` table is written to PATH.
Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--backend", default="fused", choices=("fused", "limb", "rns_hybrid"),
                    help="curve backend of the MSMs (default: fused)")
    ap.add_argument("--out", help="write the full key_averages table here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    from manta_tpu_torch.models import groth16 as G
    from manta_tpu_torch.models.groth16_device import DeviceProver
    from manta_tpu_torch.ops.kernels import field_kernels as K
    from manta_tpu_torch.ops.kernels import point_kernels as PK
    from manta_tpu_torch.ops.kernels import rns_kernels as RK
    from manta_tpu_torch.utils import keyio

    prover = DeviceProver.from_cache(
        os.path.join(ROOT, ".bench_prover_pt.npz"), backend=args.backend, device="cuda"
    )
    with open(os.path.join(ROOT, ".bench_prover_pt_aux.json")) as f:
        aux = json.load(f)
    with open(os.path.join(ROOT, ".bench_prover_pt_vk.bin"), "rb") as f:
        vk = keyio.vk_from_bytes(f.read())
    assignment = [int(x) for x in aux["assignments"][0]]
    public = [int(x) for x in aux["publics"][0]]
    assert G.verify(vk, prover.prove(assignment, 7, 9), public)  # warm-up

    K.reset_launches()
    PK.reset_launches()
    RK.reset_launches()
    timings = {}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        proof = prover.prove(assignment, 7, 9, timings=timings)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    assert G.verify(vk, proof, public)
    print(f"device: {torch.cuda.get_device_name(0)}; backend {args.backend}")
    print(f"proof wall time under the profiler: {wall:.6f} s")
    print("phases (s): " + json.dumps(timings))
    print(f"field-kernel launches in the proof: {dict(K.LAUNCHES)}")
    print(f"point-kernel launches in the proof: {dict(PK.LAUNCHES)}")
    print(f"RNS-kernel launches in the proof: {dict(RK.LAUNCHES)}")

    events = prof.key_averages()
    device_us = 0.0
    rows = []
    for e in events:
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = getattr(e, "self_cuda_time_total", 0.0)
        if t and e.device_type == torch.autograd.DeviceType.CUDA:
            device_us += t
            rows.append((t, e.count, e.key))
    if device_us == 0.0:
        print("device busy time: not measured (the profiler recorded no CUDA kernels)")
    else:
        print(f"device busy time: {device_us / 1e6:.6f} s; idle share of the wall time: "
              f"{1 - device_us / 1e6 / wall:.6f}")
        kinds = {}  # the fused backend's kernels: templates of manta::Base / manta::Ext
        for t, count, key in rows:
            if "manta::Base<" not in key and "manta::Ext<" not in key:
                continue
            for kind in ("point_kernel", "bucket_column_kernel", "fold_kernel", "combine_kernel",
                         "merge_kernel", "chain_kernel"):
                if kind in key:
                    ms, n = kinds.get(kind, (0.0, 0))
                    kinds[kind] = (ms + t / 1e3, n + count)
                    break
        print("point kernels by kind (device ms, launches): " + json.dumps(
            {k: [ms, n] for k, (ms, n) in kinds.items()}))
        rns = {}  # the RNS kernels (rns_kernels.cu): no manta:: template argument
        for t, count, key in rows:
            if "manta::" in key:
                continue
            for kind in ("hybrid_bucket_kernel", "rns_bucket_kernel", "combine_kernel",
                         "point_kernel", "zero_kernel"):
                if f"::{kind}" in key:
                    ms, n = rns.get(kind, (0.0, 0))
                    rns[kind] = (ms + t / 1e3, n + count)
                    break
        if rns:
            print("RNS kernels by kind (device ms, launches): " + json.dumps(
                {k: [ms, n] for k, (ms, n) in rns.items()}))
        print("top kernels by device time (us total, launches, name):")
        for t, count, key in sorted(rows, reverse=True)[:12]:
            print(f"  {t:14.1f} {count:8d}  {key[:90]}")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(events.table(sort_by="self_cpu_time_total", row_limit=60))
        print(f"key_averages table written to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
