"""Build the port's CUDA kernels and load them with ctypes.

Each source under ``u2mkd_tpu_torch/csrc/`` is compiled by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, at first use,
into ``u2mkd_tpu_torch/_build/`` (listed in ``.gitignore``). The library's
file name carries a hash of its source, of every header under ``csrc/`` and
of the flags, so an edited source or shared header is rebuilt and concurrent
builds never see a half-written file.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

import torch

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
KERNEL_SOURCES = ("rulebook_conv", "rulebook_conv_bwd", "wattn_fwd", "wattn_rpe_fwd",
                  "wattn_rpe_bwd_q", "wattn_rpe_bwd_k")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def library_path(name: str) -> Path:
    digest = hashlib.sha1((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build(names: Iterable[str] = KERNEL_SOURCES) -> Dict[str, str]:
    """Compile every named source that is not built yet, one ``nvcc`` each,
    all started together. Returns the compiler's output (``ptxas`` register
    and shared-memory counts) per source built; raises if one fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        so = library_path(name)
        if so.exists():
            continue
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, so)
    logs = {}
    for name, (proc, tmp, so) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}.cu:\n{out}")
        os.replace(tmp, so)
        logs[name] = out
    return logs


def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu``, building it if needed."""
    if name not in _LOADED:
        build([name])
        _LOADED[name] = ctypes.CDLL(str(library_path(name)))
    return _LOADED[name]


def stream_of(t: torch.Tensor) -> int:
    """The raw handle of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check_tensors(what: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor is contiguous and on the first one's CUDA
    device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"{what}: inputs must share one CUDA device, got "
                             f"{[str(u.device) for u in tensors]}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: inputs must be contiguous")


def check_rc(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {rc}")
