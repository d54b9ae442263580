"""Compute-precision policy (port of ``u2mkd_tpu/ops/precision.py``).

The FLOP-heavy ops (sparse convs) cast their inputs to the compute dtype and
accumulate in f32; numerics-sensitive math (BN, softmax, losses) stays f32.
The dtype is float32, the default of ``configs/default.yaml``; the bf16
policy arrives with the config system.
"""

from __future__ import annotations

import torch

_COMPUTE_DTYPE = torch.float32


def compute_dtype() -> torch.dtype:
    return _COMPUTE_DTYPE


def cast_compute(*tensors):
    out = tuple(t.to(_COMPUTE_DTYPE) for t in tensors)
    return out if len(out) > 1 else out[0]
