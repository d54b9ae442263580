"""ctypes binding of the native pointcore library, for the host pipeline.

The port's own copy of what ``plumbing_host`` and ``wgeom_host`` need from
``u2mkd_tpu/data/native.py``. At first use it compiles the repository's
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
    return lib
