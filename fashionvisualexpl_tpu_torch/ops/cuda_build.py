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
import re
import shutil
import subprocess
import time
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
# seconds each source's nvcc took, per source built by this process
build_seconds: Dict[str, float] = {}


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
        out = tmp.with_suffix(".out")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        with open(out, "w") as f:
            proc = subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT)
        jobs.append((name, so, tmp, out, proc, time.perf_counter()))
    pending = list(jobs)
    while pending:  # each job's own time, though all run together
        for job in list(pending):
            if job[4].poll() is not None:
                build_seconds[job[0]] = time.perf_counter() - job[5]
                pending.remove(job)
        time.sleep(0.01)
    failed = []
    for name, so, tmp, out, proc, _ in jobs:
        log = out.read_text()
        out.unlink()
        build_logs[name] = log
        if proc.returncode:
            failed.append(f"nvcc failed for {name}.cu:\n{log}")
        else:
            so.with_suffix(".log").write_text(log)
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("\n".join(failed))
    return [library_path(n) for n in names]


def ptxas_report(log: str) -> List[dict]:
    """Each kernel's registers, spill bytes and static shared memory from
    ``-Xptxas=-v`` output: dicts of kernel (name and template arguments,
    from the mangled name), registers, spill_stores, spill_loads, smem."""
    rows, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = dict(kernel=_kernel_name(m.group(1)), registers=None,
                       spill_stores=0, spill_loads=0, smem=0)
            rows.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            cur["smem"] = int(m.group(1)) if m else 0
    return rows


# Itanium codes of the builtin types the kernels take as template arguments
_BUILTIN = {"f": "float", "j": "unsigned int"}


def _kernel_name(mangled: str) -> str:
    """``segmax_wgmma_kernel<10, 16>`` or ``edge_bwd_kernel`` from an
    Itanium-mangled kernel name (``_Z<n><name>`` or ``_ZN<n><name>...E``):
    the innermost source name, with its template arguments (integers,
    bools, ``float``, ``unsigned int`` or a named type), if any;
    otherwise the mangled name."""
    m = re.match(r"_ZN?", mangled)
    i, name = (m.end(), None) if m else (len(mangled), None)
    while i < len(mangled):
        n = re.match(r"\d+", mangled[i:])
        if not n:
            break
        i += n.end()
        name, i = mangled[i:i + int(n.group())], i + int(n.group())
        if mangled[i:i + 1] == "I":
            args, i = [], i + 1
            while i < len(mangled) and mangled[i] != "E":
                lit = re.match(r"L[ib](\d+)E", mangled[i:])
                named = re.match(r"(\d+)", mangled[i:])
                if lit:
                    args.append(lit.group(1))
                    i += lit.end()
                elif named:
                    j = i + named.end()
                    args.append(mangled[j:j + int(named.group(1))])
                    i = j + int(named.group(1))
                else:
                    args.append(_BUILTIN.get(mangled[i], mangled[i]))
                    i += 1
            return f"{name}<{', '.join(args)}>"
        if mangled[1:3] != "ZN" or mangled[i:i + 1] == "E":
            return name
    return mangled


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        (path,) = build([name])
        lib = ctypes.CDLL(str(path))
        _libs[name] = lib
    return lib
