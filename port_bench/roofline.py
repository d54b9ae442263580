"""Operations and bytes of the program's kernel launches, the chip's peaks,
and the least time a launch could take.

The least time of a launch is the larger of its operations over the peak
rate of its precision and its bytes over the memory bandwidth
(``peaks.json``, NVIDIA's data sheet). Operations count what the inputs
need, not what a kernel executes: for the sparse conv (K1 forward, K1 as
dX, K1b) two per multiply-add over the rulebook's valid pairs,
``2 * pairs * Cin * Cout``; for the window attention (K3, K4, K5) two per
multiply-add of the products of d-vectors each (query, key) pair of a
window needs: K3 ``q.k`` and ``p v`` (4d), K4 ``q.k``, ``do.v`` and
``ds k`` (6d), K5 those of K4 with ``ds q`` and ``p do`` in place of
``ds k`` (8d), a pair being two rows of one window (a pad row belongs to
none). Bytes count each input read once and each output written once.
f32 work is held to the dense TF32 rate, bf16 work to the bf16 rate.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional, Sequence

import torch

PEAKS_FILE = Path(__file__).resolve().parent / "peaks.json"
# the window rank of the program's pad rows, which attend nothing
PAD_RANK = -7


def peaks(device_name: str) -> Optional[Dict[str, float]]:
    """The data sheet's peaks of ``device_name``, or None for a device the
    table does not know."""
    with open(PEAKS_FILE) as f:
        return json.load(f)["devices"].get(device_name)


def flop_peak(p: Dict[str, float], dtype: torch.dtype) -> float:
    return p["bf16_flops"] if dtype == torch.bfloat16 else p["tf32_flops"]


def least_s(ops: float, nbytes: float, flops_peak: float, bytes_peak: float) -> float:
    return max(ops / flops_peak, nbytes / bytes_peak)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def valid_pairs(nbr: torch.Tensor) -> torch.Tensor:
    """The rulebook's valid (output row, input row) pairs, 0 <= nbr < V, as
    a device scalar (no wait for the device)."""
    v = nbr.shape[-1]
    return ((nbr >= 0) & (nbr < v)).sum()


def conv_launch(kind: str, a: torch.Tensor, w_or_g: torch.Tensor, nbr: torch.Tensor,
                out: torch.Tensor) -> Dict:
    """One sparse conv launch, ``kind`` 'fwd' (a = x, w), 'dx' (a = g, w) or
    'dw' (a = x, g): {"pairs" (device scalar), "ops_per_pair", "bytes",
    "dtype"}."""
    if kind == "dw":
        cin, cout = a.shape[-1], w_or_g.shape[-1]
    else:
        cin, cout = w_or_g.shape[1], w_or_g.shape[2]
    return {"pairs": valid_pairs(nbr), "ops_per_pair": 2.0 * cin * cout,
            "bytes": float(nbytes(a, w_or_g, nbr, out)), "dtype": a.dtype}


def window_pairs(rank: torch.Tensor) -> torch.Tensor:
    """Sum of c^2 over the runs of equal rank in a window-sorted sequence,
    pad rows left out, as a device scalar (no wait for the device)."""
    n = rank.shape[0]
    if n == 0:
        return torch.zeros((), device=rank.device)
    new = torch.ones(n, dtype=torch.bool, device=rank.device)
    new[1:] = rank[1:] != rank[:-1]
    run = torch.cumsum(new.long(), 0) - 1
    live = (rank != PAD_RANK).double()
    counts = torch.zeros(n, dtype=torch.float64, device=rank.device).scatter_add_(0, run, live)
    return (counts * counts).sum()


# multiply-adds of d-vector products per pair and head, times two
ATTN_OPS_PER_PAIR = {"fwd": 4, "bwd_q": 6, "bwd_k": 8}


def attn_launch(kind: str, inputs: Sequence[Optional[torch.Tensor]],
                outputs: Sequence[torch.Tensor], qs: torch.Tensor, rank: torch.Tensor) -> Dict:
    """One window-attention launch ('fwd', 'bwd_q' or 'bwd_k') over its
    inputs and outputs, as :func:`conv_launch` gives a conv's."""
    _, h, d = qs.shape
    return {"pairs": window_pairs(rank), "ops_per_pair": float(h * d * ATTN_OPS_PER_PAIR[kind]),
            "bytes": float(nbytes(*inputs) + nbytes(*outputs)), "dtype": qs.dtype}


def share_of_roofline(launches, kernel_s: float, p: Dict[str, float]) -> Optional[float]:
    """Sum of the launches' least times over ``kernel_s``, the profiled time
    of their kernels, in percent; None when there is nothing to read."""
    if not launches or kernel_s <= 0:
        return None
    least = sum(least_s(float(x["pairs"]) * x["ops_per_pair"], x["bytes"],
                        flop_peak(p, x["dtype"]), p["hbm_bytes_per_s"]) for x in launches)
    return 100.0 * least / kernel_s


def attn_useful_flops(pairs: float, heads: int, head_dim: int, train: bool) -> float:
    """The whole step's matmul FLOPs of the window attention over ``pairs``
    (query, key) pairs: the forward's 4d a pair and head, with ``train`` the
    backward's 8d more (do.v and the gradients of q, k, v)."""
    return float(pairs) * heads * head_dim * (12 if train else 4)
