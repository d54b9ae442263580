"""Compute-precision policy (port of ``u2mkd_tpu/ops/precision.py``).

bf16 compute with f32 parameters and accumulation, no loss scaling (bf16
keeps the f32 exponent range). The policy is a process-global static, read
when a model runs by the FLOP-heavy ops (sparse convs, window attention,
the image branch's convs), which cast their inputs to the compute dtype;
numerics-sensitive math (BN statistics, softmax, losses) stays f32.

Usage: ``set_compute_dtype("bfloat16")`` before running the model (or
``precision: bfloat16`` in the config, which ``train/builder.make_model``
sets in both directions).

TF32. No module of the port sets torch's TF32 flags, so the entry points run
under torch's defaults. Under ``precision: float32`` that means: cuDNN's
image convolutions (the SwiftNet branch) run in TF32
(``torch.backends.cudnn.allow_tf32``, on by default), as the reference
trains under cuDNN's default on Ampere and later cards; cuBLAS matmuls run in
IEEE f32 (``torch.backends.cuda.matmul.allow_tf32``, off by default); the
hand kernels ignore both flags: K1 and K1b multiply f32 in 3xTF32 (f32
accuracy), K2-K5 in f32. ``chip_smoke.py`` and the tests turn both flags
off, so that every kernel is held to its plain version in IEEE f32. Each
entry point prints :func:`numerics_line` beside its ``device:`` line.
"""

from __future__ import annotations

from typing import Union

import torch

_COMPUTE_DTYPE = torch.float32
_BY_NAME = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def set_compute_dtype(dtype: Union[str, torch.dtype]) -> None:
    """Set the compute dtype: ``"float32"``, ``"bfloat16"`` or a torch dtype;
    any other string raises ``KeyError``, as the JAX package's does."""
    global _COMPUTE_DTYPE
    _COMPUTE_DTYPE = _BY_NAME[dtype] if isinstance(dtype, str) else dtype


def compute_dtype() -> torch.dtype:
    return _COMPUTE_DTYPE


def cast_compute(*tensors):
    """Each tensor in the compute dtype (those already in it as they are)."""
    dt = _COMPUTE_DTYPE
    out = tuple(t if t.dtype == dt else t.to(dt) for t in tensors)
    return out if len(out) > 1 else out[0]


def round_compute(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to the compute dtype and held in f32: the values a
    compute-dtype product of JAX's with ``preferred_element_type=float32``
    reads, for sums that stay in f32."""
    return cast_compute(t).float()


def numerics_line() -> str:
    """The entry points' start line: the compute policy and both TF32 flags
    as the process has them, e.g. ``numerics: precision=float32
    cudnn.allow_tf32=True cuda.matmul.allow_tf32=False``."""
    name = {v: k for k, v in _BY_NAME.items()}.get(_COMPUTE_DTYPE, str(_COMPUTE_DTYPE))
    return (f"numerics: precision={name} "
            f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
            f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
