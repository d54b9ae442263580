"""Weight bridge from the JAX package's flax variables to the port.

``from_flax(params, batch_stats)`` takes the nested dicts of numpy arrays of
a flax model (``variables["params"]``, ``variables["batch_stats"]``) and
returns a state dict for its counterpart in the port: a SPVCNN for
:class:`~u2mkd_tpu_torch.models.spvcnn.SPVCNN`, a whole ``TSDFull`` tree
(``model_s``, ``model_t``) for :class:`~u2mkd_tpu_torch.models.tsd.TSDFull`.
The port's module names mirror the flax tree (the SwiftNet stages, the
fusion layers and the learners included), so the bridge is a rename:

  * ``SparseConv_i`` / ``SparseDownConv_0`` / ``SparseDeconv_0`` -> ``conv{i}``,
    ``MaskedBatchNorm_i`` -> ``bn{i}``, ``Dense_i`` -> ``fc{i}``;
  * a Dense ``kernel`` [in, out] becomes ``weight`` [out, in] (``nn.Linear``);
    a sparse conv ``kernel`` [K, Cin, Cout] keeps the JAX layout; a flax
    ``nn.Conv`` kernel [kh, kw, Cin, Cout] (HWIO) becomes ``weight`` [Cout,
    Cin, kh, kw] (``nn.Conv2d``);
  * ``scale`` -> ``weight`` (LayerNorm and the BNs); BN ``mean``/``var`` from
    ``batch_stats`` -> ``running_mean``/``running_var``;
  * RPE tables ``rel_*`` [L2, 3, h, d] keep name and layout.
"""

from __future__ import annotations

import re
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

_MODULE_RENAMES = (
    (re.compile(r"^(SparseConv|SparseDownConv|SparseDeconv)_(\d+)$"), r"conv\2"),
    (re.compile(r"^MaskedBatchNorm_(\d+)$"), r"bn\1"),
    (re.compile(r"^Dense_(\d+)$"), r"fc\1"),
)
_STAT_NAMES = {"mean": "running_mean", "var": "running_var"}


def _leaves(tree: Dict, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for key, val in tree.items():
        if hasattr(val, "items"):
            yield from _leaves(val, prefix + (key,))
        else:
            yield prefix + (key,), np.asarray(val)


def _key(path: Tuple[str, ...], leaf: str) -> str:
    out = []
    for name in path:
        for pat, rep in _MODULE_RENAMES:
            name = pat.sub(rep, name)
        out.append(name)
    return ".".join(out + [leaf])


def from_flax(params: Dict, batch_stats: Dict) -> Dict[str, torch.Tensor]:
    """Flax ``params`` and ``batch_stats`` (nested dicts of arrays) -> a
    state dict of f32 tensors (copies) for the port's counterpart."""
    sd = {}
    for path, arr in _leaves(params):
        leaf = path[-1]
        if leaf == "kernel" and arr.ndim == 2:
            name, arr = "weight", arr.T
        elif leaf == "kernel" and arr.ndim == 4:
            name, arr = "weight", arr.transpose(3, 2, 0, 1)
        elif leaf == "scale":
            name = "weight"
        else:
            name = leaf
        sd[_key(path[:-1], name)] = torch.from_numpy(np.array(arr, np.float32))
    for path, arr in _leaves(batch_stats):
        sd[_key(path[:-1], _STAT_NAMES[path[-1]])] = torch.from_numpy(np.array(arr, np.float32))
    return sd
