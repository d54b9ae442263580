"""ctypes binding of the native pointcore library, for the host pipeline.

The port's own copy of ``u2mkd_tpu/data/native.py``: the plumbing and
window-geometry builders that ``plumbing_host`` and ``wgeom_host`` call, and
``dedup_first``, ``transform_points``, ``remap_labels_lut`` and
``box_occupancy``. At first use it compiles the repository's
``native/pointcore.cpp`` with ``g++`` into ``u2mkd_tpu_torch/_build/``
(listed in ``.gitignore``); it writes nothing under ``native/``. The port has
no numpy fallback: if the library cannot be built, the host pipeline raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path
from typing import Tuple

import numpy as np

_REPO = Path(__file__).resolve().parents[2]
SOURCE = _REPO / "native" / "pointcore.cpp"
BUILD_DIR = _REPO / "u2mkd_tpu_torch" / "_build"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-shared")

_LIB = None
_LOCK = threading.Lock()  # the host pipeline calls load() from worker threads


def _cpu_flags() -> bytes:
    """The host's instruction-set flags: ``-march=native`` builds for them,
    so a library built on another CPU is not reused."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            for line in f:
                if line.startswith(b"flags"):
                    return line
    except OSError:
        pass
    return platform.machine().encode()


def _library_path() -> Path:
    digest = hashlib.sha1(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()
                          + _cpu_flags())
    return BUILD_DIR / f"libpointcore-{digest.hexdigest()[:12]}.so"


def load() -> ctypes.CDLL:
    """The pointcore library, built from ``native/pointcore.cpp`` if needed."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            _LIB = _build_and_load()
    return _LIB


def _build_and_load() -> ctypes.CDLL:
    so = _library_path()
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cxx = os.environ.get("CXX", "g++")
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"building {SOURCE.name} failed:\n{proc.stderr}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.build_plumbing_host.argtypes = [
        ptr, ptr, ptr, i64, ptr, ctypes.c_int] + [ptr] * 11
    lib.build_plumbing_host.restype = None
    lib.build_wgeom_branch.argtypes = [
        ptr, ptr, i64, i64, ptr, ptr, i64] + [ptr] * 8
    lib.build_wgeom_branch.restype = None
    lib.dedup_first.argtypes = [ptr, i64, ptr, ptr]
    lib.dedup_first.restype = i64
    lib.transform_points.argtypes = [ptr, ptr, i64, ptr]
    lib.transform_points.restype = None
    lib.remap_labels.argtypes = [ptr, i64, ptr, ctypes.c_int32, ptr]
    lib.remap_labels.restype = None
    lib.box_occupancy.argtypes = [ptr, ptr, ptr, i64, ptr, ptr, ptr, ptr]
    lib.box_occupancy.restype = None
    return lib


def dedup_first(voxel: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """First-occurrence dedup of [N, 3] integer voxel coords (torchsparse
    ``sparse_quantize`` semantics) -> (inds: the first row of each unique
    voxel, in scan order; inverse: each row's position in ``inds``)."""
    v = np.ascontiguousarray(voxel, np.int32)
    n = len(v)
    inds = np.empty(n, np.int32)
    inverse = np.empty(n, np.int32)
    n_unique = load().dedup_first(v.ctypes.data, n, inds.ctypes.data, inverse.ctypes.data)
    return inds[:n_unique].copy(), inverse


def transform_points(tm: np.ndarray, xyz: np.ndarray) -> np.ndarray:
    """A 4x4 homogeneous transform (float64) applied to [N, 3] points, in
    float64, returned as float32."""
    t = np.ascontiguousarray(tm, np.float64)
    p = np.ascontiguousarray(xyz, np.float32)
    out = np.empty_like(p)
    load().transform_points(t.ctypes.data, p.ctypes.data, len(p), out.ctypes.data)
    return out


def remap_labels_lut(raw: np.ndarray, lut: np.ndarray) -> np.ndarray:
    """uint8 raw labels -> int32 ``lut[raw]`` (0 where ``raw >= len(lut)``)."""
    r = np.ascontiguousarray(raw, np.uint8)
    table = np.ascontiguousarray(lut, np.int32)
    out = np.empty(len(r), np.int32)
    load().remap_labels(r.ctypes.data, len(r), table.ctypes.data, len(table), out.ctypes.data)
    return out


def box_occupancy(xyz: np.ndarray, labels: np.ndarray, thing_mask: np.ndarray,
                  mn: np.ndarray, mx: np.ndarray) -> Tuple[int, int]:
    """Points strictly inside the box (mn, mx) -> (how many carry a label
    of ``thing_mask``, how many do not), in float32."""
    x = np.ascontiguousarray(xyz, np.float32)
    lb = np.ascontiguousarray(labels, np.int32)
    tm = np.ascontiguousarray(thing_mask, np.uint8)
    if len(lb) != len(x) or (len(lb) and not 0 <= lb.min() <= lb.max() < len(tm)):
        raise ValueError("box_occupancy: one label per point, each an index of thing_mask")
    lo = np.ascontiguousarray(mn, np.float32)
    hi = np.ascontiguousarray(mx, np.float32)
    n_thing, n_other = ctypes.c_int64(), ctypes.c_int64()
    load().box_occupancy(x.ctypes.data, lb.ctypes.data, tm.ctypes.data, len(x), lo.ctypes.data,
                         hi.ctypes.data, ctypes.byref(n_thing), ctypes.byref(n_other))
    return n_thing.value, n_other.value
