"""Build the CUDA sources of `manta_tpu_torch/csrc/` with `nvcc`.

A kernel library is one shared library in `build/torch_kernels/` at the
repository root, loaded with ctypes through a plain C interface. It is built
from one `.cu` source as one or more objects, each compiled with its own `-D`
defines (a curve's five kernels compile as five objects, so that the slow
ones run side by side), then linked. A library's file name carries a digest
of everything the compiler reads (the source, the headers of `csrc/` that it
includes, the flags and defines), so an edit to any of them builds it anew
instead of loading a stale library. `build` starts one `nvcc` for each object
of every library that is missing, all at once, waits for them all, then
links. Every object is compiled with `-Xptxas -v`; the compiler's report of
registers and spills is kept beside the library (`reports`), so it is there
for a library built by an earlier run too.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Sequence, Tuple

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = CSRC.parents[1] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-Xcompiler",
    "-fPIC",
)


@dataclasses.dataclass(frozen=True)
class Library:
    """One shared library: `name`, its source in `csrc/`, the headers of
    `csrc/` that the source includes, and the `-D` defines of each object it
    links."""

    name: str
    source: str
    headers: Tuple[str, ...] = ()
    units: Tuple[Tuple[str, ...], ...] = ((),)

    def inputs(self):
        return [CSRC / self.source, *(CSRC / h for h in self.headers)]

    def path(self) -> Path:
        h = hashlib.sha256()
        for f in self.inputs():
            h.update(f.name.encode() + b"\0" + f.read_bytes())
        h.update(repr((NVCC_FLAGS, self.units)).encode())
        return BUILD_DIR / f"lib{self.name}-{h.hexdigest()[:16]}.so"

    def report_path(self) -> Path:
        return self.path().with_suffix(".ptxas.json")


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def reports(lib: Library) -> dict:
    """The compiler's report of each object of a built library, by object
    ("<library> <defines>"): the `-Xptxas -v` lines of registers and spills."""
    return json.loads(lib.report_path().read_text())


def _finish(proc: subprocess.Popen, what: str) -> tuple:
    """Wait for one nvcc; return (its report, "" or the failure report)."""
    report = proc.communicate()[0]
    if proc.returncode != 0:
        return report, f"nvcc failed for {what} ({proc.returncode}):\n{report}"
    return report, ""


_lock = threading.Lock()


def build(libs: Sequence[Library], verbose: bool = False) -> list:
    """Compile and link the libraries not built yet (or built without their
    report), every object's `nvcc` started together; return the libraries'
    paths in order. `verbose` prints each compiler's report of registers and
    spills as it comes."""
    paths = [lib.path() for lib in libs]
    with _lock:
        todo = {out: lib for lib, out in zip(libs, paths)
                if not (out.exists() and lib.report_path().exists())}
        if not todo:
            return paths
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            objects, jobs = {}, []
            for out, lib in todo.items():
                objects[out] = []
                for i, defines in enumerate(lib.units):
                    obj = Path(tmp) / f"{out.stem}.{i}.o"
                    cmd = [nvcc(), *NVCC_FLAGS, *(f"-D{d}" for d in defines),
                           "-Xptxas", "-v", "-c", "-o", str(obj), str(CSRC / lib.source)]
                    what = " ".join([lib.name, *defines])
                    jobs.append((out, what, subprocess.Popen(
                        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
                    objects[out].append(str(obj))
            texts, failed = {out: {} for out in todo}, []
            for out, what, proc in jobs:
                texts[out][what], err = _finish(proc, what)
                if err:
                    failed.append(err)
                elif verbose:
                    print(f"-- {what}\n{texts[out][what]}", end="", flush=True)
            if failed:
                raise RuntimeError("\n".join(failed))
            for out, objs in objects.items():
                so = Path(tmp) / out.name
                link = subprocess.Popen([nvcc(), *NVCC_FLAGS, "-shared", "-o", str(so), *objs],
                                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True)
                err = _finish(link, f"linking {todo[out].name}")[1]
                if err:
                    raise RuntimeError(err)
                os.replace(so, out)
                todo[out].report_path().write_text(json.dumps(texts[out]))
    return paths
