"""ctypes bindings for the native C++ host data plane (port of
``fashionvisualexpl_tpu/data/native.py``).

The library is the port's own copy of the JAX package's source,
``data/csrc/fvx_native.cpp`` (byte-identical): a multithreaded, mmap'd TSV
parser, the padded sorted-positives construction, the recommendation-dump
writer and a threaded row gather.  It is host code, not a device kernel.

It is built with ``g++`` at first use, never at import, into
``build/torch_kernels/`` at the repository root under a file name keyed on
the hash of the source and the flags.  The compiler writes a temporary
name in that directory, which ``os.replace`` then moves into place, so a
concurrent process (an xdist worker) never loads a half-written library.
Without ``g++`` (or if the build fails) every wrapper returns ``None`` /
``False`` and its caller takes the pure-Python path, as in the JAX package.

Each wrapper counts the calls that went through the library in a plain
integer attribute, ``<wrapper>.calls`` (the kernel wrappers' ``.launches``),
so a run can show that the native route was taken.  All interfaces return
numpy arrays equal to the Python implementations' (tested).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent / "csrc" / "fvx_native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()
# seconds the g++ build took in this process (None: built before, or not built)
build_seconds: Optional[float] = None


def library_path() -> Path:
    """Where the library of this source and these flags lives."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libfvx_native-{h.hexdigest()[:16]}.so"


def _build(so: Path) -> bool:
    """Compile to a temporary name beside ``so`` and rename it into place."""
    global build_seconds
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    t0 = time.perf_counter()
    try:
        subprocess.run(["g++", *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                       check=True, capture_output=True)
    except (subprocess.CalledProcessError, FileNotFoundError):
        tmp.unlink(missing_ok=True)
        return False
    os.replace(tmp, so)
    build_seconds = time.perf_counter() - t0
    return True


def load_library() -> Optional[ctypes.CDLL]:
    """The loaded library, built first if needed; None if unavailable."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        so = library_path()
        if not so.exists() and not _build(so):
            return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError:
            return None
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        lib.fvx_count_tsv_rows.restype = ctypes.c_long
        lib.fvx_count_tsv_rows.argtypes = [ctypes.c_char_p]
        lib.fvx_parse_interactions.restype = ctypes.c_long
        lib.fvx_parse_interactions.argtypes = [
            ctypes.c_char_p, i32p, i32p, i64p, ctypes.c_long,
        ]
        lib.fvx_max_pos_count.restype = ctypes.c_int32
        lib.fvx_max_pos_count.argtypes = [i32p, i32p, ctypes.c_long, ctypes.c_int32]
        lib.fvx_pad_positives.restype = ctypes.c_int32
        lib.fvx_pad_positives.argtypes = [
            i32p, i32p, ctypes.c_long, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, i32p, i32p,
        ]
        lib.fvx_write_recs_tsv.restype = ctypes.c_long
        lib.fvx_write_recs_tsv.argtypes = [
            ctypes.c_char_p, i32p, i32p, f32p, ctypes.c_long, ctypes.c_long,
        ]
        lib.fvx_gather_rows.restype = None
        lib.fvx_gather_rows.argtypes = [
            ctypes.c_void_p, ctypes.c_long, ctypes.c_long, i32p,
            ctypes.c_long, ctypes.c_void_p,
        ]
        _lib = lib
        return _lib


def parse_interactions_tsv(
    path: str,
) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """(users, items, times) int arrays in file order, or None if the native
    library is unavailable."""
    lib = load_library()
    if lib is None:
        return None
    cap = lib.fvx_count_tsv_rows(path.encode())
    if cap < 0:
        raise FileNotFoundError(path)
    users = np.empty(cap, np.int32)
    items = np.empty(cap, np.int32)
    times = np.empty(cap, np.int64)
    n = lib.fvx_parse_interactions(path.encode(), users, items, times, cap)
    if n < 0:
        raise RuntimeError(f"native parse failed for {path}")
    parse_interactions_tsv.calls += 1
    return users[:n], items[:n], times[:n]


def pad_sorted_positives_native(
    users: np.ndarray, items: np.ndarray, num_users: int, num_items: int,
    width: Optional[int] = None,
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Native padded strictly-increasing positives (equal to
    ``data/interactions.py::pad_sorted_positives``); None without the
    library."""
    lib = load_library()
    if lib is None:
        return None
    users = np.ascontiguousarray(users, np.int32)
    items = np.ascontiguousarray(items, np.int32)
    if width is None:
        width = max(1, int(lib.fvx_max_pos_count(users, items, len(users), num_users)))
    padded = np.empty((num_users, width), np.int32)
    counts = np.empty(num_users, np.int32)
    rc = lib.fvx_pad_positives(
        users, items, len(users), num_users, num_items, width,
        padded.reshape(-1), counts,
    )
    if rc != 0:
        raise ValueError(
            f"width {width} < max positives (matching the Python "
            "implementation's error; truncation would corrupt sampling)"
        )
    pad_sorted_positives_native.calls += 1
    return padded, counts


def gather_rows_native(src: np.ndarray, ids: np.ndarray,
                       out: Optional[np.ndarray] = None) -> Optional[np.ndarray]:
    """Threaded row gather ``src[ids]`` of a C-contiguous array or read-only
    ``np.memmap`` into ``out`` (a new array when None; given, it must be a
    C-contiguous [len(ids), *src.shape[1:]] array of src's dtype, e.g. a
    numpy view of a pinned tensor).  Returns None when the library is
    unavailable or ``src`` is not a C-contiguous ndarray (the caller falls
    back to ``src[ids]``).

    Ids must lie in [0, n_rows): the C side clamps out-of-range ids while
    numpy wraps negatives and raises on overflow, so the range is checked
    here before dispatch and both routes raise ``IndexError``."""
    ids = np.ascontiguousarray(ids, np.int32)
    if ids.size and (int(ids.min()) < 0 or int(ids.max()) >= src.shape[0]):
        raise IndexError(
            f"gather ids outside [0, {src.shape[0]}): "
            f"min={int(ids.min())} max={int(ids.max())}"
        )
    lib = load_library()
    if lib is None:
        return None
    if not (isinstance(src, np.ndarray) and src.flags["C_CONTIGUOUS"]):
        return None
    row_shape = src.shape[1:]
    if out is None:
        out = np.empty((len(ids),) + row_shape, src.dtype)
    elif (out.shape != (len(ids),) + row_shape or out.dtype != src.dtype
          or not out.flags["C_CONTIGUOUS"]):
        raise ValueError(
            f"out must be C-contiguous {src.dtype}{(len(ids),) + row_shape}, "
            f"got {out.dtype}{out.shape}"
        )
    row_bytes = int(np.prod(row_shape, dtype=np.int64)) * src.itemsize
    lib.fvx_gather_rows(src.ctypes.data, src.shape[0], row_bytes, ids, len(ids),
                        out.ctypes.data)
    gather_rows_native.calls += 1
    return out


def write_recs_tsv(path: str, users: np.ndarray, ids: np.ndarray,
                   vals: np.ndarray) -> bool:
    """Native recommendation-dump writer: k rows ``user\\titem\\tscore`` per
    user (the ``store_recommendation`` format), formatted in parallel.
    Scores print as %.9g (float32 round-trip).  Returns False when the
    library is unavailable (the caller falls back to the Python writer)."""
    lib = load_library()
    if lib is None:
        return False
    users = np.ascontiguousarray(users, np.int32)
    ids = np.ascontiguousarray(ids, np.int32)
    vals = np.ascontiguousarray(vals, np.float32)
    n, k = ids.shape
    if users.shape != (n,) or vals.shape != (n, k):
        raise ValueError(f"shape mismatch: {users.shape} {ids.shape} {vals.shape}")
    written = lib.fvx_write_recs_tsv(path.encode(), users, ids.reshape(-1),
                                     vals.reshape(-1), n, k)
    if written < 0:
        raise OSError(f"native TSV write failed for {path}")
    write_recs_tsv.calls += 1
    return True


parse_interactions_tsv.calls = 0
pad_sorted_positives_native.calls = 0
gather_rows_native.calls = 0
write_recs_tsv.calls = 0
