"""PyTorch port: the package stands alone, and its entry points never fall
back to the CPU on their own.

`manta_tpu_torch` and every one of its modules is imported in a fresh
interpreter, which must then hold no `jax*` and no `manta_tpu.*` module.
Entry points default to device="cuda" and must raise when no card is there.
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, json, pkgutil, sys
import manta_tpu_torch
names = [m.name for m in pkgutil.walk_packages(manta_tpu_torch.__path__, "manta_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib")) or m.startswith("manta_tpu.")
             or m == "manta_tpu")
print(json.dumps({"modules": names, "bad": bad}))
"""


def test_port_imports_neither_jax_nor_the_jax_package():
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=ROOT, capture_output=True, text=True, check=True
    )
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert report["bad"] == []
    for name in ("manta_tpu_torch.ops.field_ops", "manta_tpu_torch.ops.kernels.field_kernels",
                 "manta_tpu_torch.ops.kernels.point_kernels", "manta_tpu_torch.ops.kernels.build",
                 "manta_tpu_torch.ops.msm", "manta_tpu_torch.models.groth16_device",
                 "manta_tpu_torch.ops.rns", "manta_tpu_torch.ops.kernels.rns_kernels"):
        assert name in report["modules"]


def test_no_port_source_mentions_jax_imports():
    sources = [*(ROOT / "manta_tpu_torch").rglob("*.py"), ROOT / "chip_smoke.py",
               ROOT / "torch_entry.py", *(ROOT / "tools").glob("torch_*.py")]
    for path in sources:
        for line in path.read_text().splitlines():
            stripped = line.strip()
            if stripped.startswith(("import ", "from ")):
                assert "jax" not in stripped, (path, line)
                assert not stripped.split()[1].startswith("manta_tpu."), (path, line)
                assert stripped.split()[1] != "manta_tpu", (path, line)


def test_cuda_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from manta_tpu_torch.models.groth16_device import DeviceProver
    from manta_tpu_torch.ops import curve as C
    from manta_tpu_torch.ops import field_ops as F
    from manta_tpu_torch.utils import hostmath

    with pytest.raises(RuntimeError, match="no CUDA device"):
        F.resolve_device()
    for backend in ("limb", "fused", "rns_fused", "rns_hybrid"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            C.curve_ops_for(hostmath.BN254_G1, backend).encode_points([hostmath.BN254_G1.generator])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceProver.from_cache(str(ROOT / ".bench_prover_pt.npz"))
    assert F.resolve_device("cpu").type == "cpu"
