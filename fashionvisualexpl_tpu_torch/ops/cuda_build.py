"""Build and load the port's CUDA kernels.

Each ``ops/csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with ``ctypes``.  The build
happens at first use, into ``build/torch_kernels/`` at the repository root,
under a file name keyed on the hash of the sources and flags, so a changed
source builds anew and an unchanged one is reused.  Nothing is built when a
module is imported: the CPU tests import every module and have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_libs: Dict[str, ctypes.CDLL] = {}
# compiler output (ptxas register / shared memory report) per built source
build_logs: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str]) -> List[Path]:
    """Compile every named source that is not built yet, one ``nvcc`` per
    source, all started together; raises with the compiler's output on a
    failure."""
    names = list(names)
    jobs = []
    for name in names:
        so = library_path(name)
        if so.exists():
            log = so.with_suffix(".log")
            build_logs[name] = log.read_text() if log.exists() else ""
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        jobs.append((name, so, tmp, proc))
    failed = []
    for name, so, tmp, proc in jobs:
        log, _ = proc.communicate()
        build_logs[name] = log
        if proc.returncode:
            failed.append(f"nvcc failed for {name}.cu:\n{log}")
        else:
            so.with_suffix(".log").write_text(log)
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("\n".join(failed))
    return [library_path(n) for n in names]


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        (path,) = build([name])
        lib = ctypes.CDLL(str(path))
        _libs[name] = lib
    return lib
