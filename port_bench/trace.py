"""The traced run: the program's kernel launches recorded at their
wrappers, and ``torch.profiler`` over a few calls inside the window.

:func:`recording` swaps the six counted kernel wrappers of the program
(K1 forward and as dX, K1b, K3, K4, K5) for shims that count each
launch's operations and bytes (``roofline.py``), its valid pairs summed on
the device so that nothing waits. :class:`Trace` holds what the
profiler saw: every device activity with its interval, every host event
with its interval, and the device time under each host operator.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import torch

from port_bench import roofline

TRACED = "port_bench.traced"
CALL = "port_bench.call"


@dataclass
class LaunchLog:
    """The launches of the traced calls, as ``roofline.conv_launch`` and
    ``roofline.attn_launch`` count them, by family ("spconv", "wattn")."""

    launches: Dict[str, List[Dict]] = field(default_factory=lambda: {"spconv": [], "wattn": []})


@contextlib.contextmanager
def recording(log: LaunchLog):
    """Inside, every launch of the six kernel wrappers is counted into
    ``log``: its valid pairs on the device, its widths and bytes."""
    from u2mkd_tpu_torch.ops.kernels import spconv_kernel as S
    from u2mkd_tpu_torch.ops.kernels import wattn_kernel as W
    from u2mkd_tpu_torch.ops.kernels import wrappers_replaced

    def conv_shim(kind, wrapper):
        def shim(a, b, nbr, plan=None):
            out = wrapper(a, b, nbr, plan)
            log.launches["spconv"].append(roofline.conv_launch(kind, a, b, nbr, out))
            return out
        return shim

    def fwd_shim(wrapper):
        def shim(qs, ks, vs, qT, kT, table_v, rank, quant, r, grid_len, a):
            out = wrapper(qs, ks, vs, qT, kT, table_v, rank, quant, r, grid_len, a)
            log.launches["wattn"].append(roofline.attn_launch(
                "fwd", (qs, ks, vs, qT, kT, table_v, rank, quant, r), out, qs, rank))
            return out
        return shim

    def bwd_shim(kind, wrapper):
        def shim(qs, ks, vs, qT, kT, edo, rank, quant, r, lse, do, dfac, grid_len, a):
            out = wrapper(qs, ks, vs, qT, kT, edo, rank, quant, r, lse, do, dfac, grid_len, a)
            log.launches["wattn"].append(roofline.attn_launch(
                kind, (qs, ks, vs, qT, kT, edo, rank, quant, r, lse, do, dfac), out, qs, rank))
            return out
        return shim

    with wrappers_replaced({
            (S, "rulebook_conv"): conv_shim("fwd", S.rulebook_conv),
            (S, "rulebook_conv_dx"): conv_shim("dx", S.rulebook_conv_dx),
            (S, "rulebook_conv_dw"): conv_shim("dw", S.rulebook_conv_dw),
            (W, "flash_rpe_fwd"): fwd_shim(W.flash_rpe_fwd),
            (W, "flash_rpe_bwd_q"): bwd_shim("bwd_q", W.flash_rpe_bwd_q),
            (W, "flash_rpe_bwd_k"): bwd_shim("bwd_k", W.flash_rpe_bwd_k)}):
        yield


def _ns(event, what: str) -> int:
    getter = getattr(event, f"{what}_ns", None)
    if getter is not None:
        return int(getter())
    return int(getattr(event, f"{what}_us")() * 1000)


@dataclass
class Trace:
    """What one profile of ``calls`` traced calls saw, times in ns on the
    profiler's clock."""

    calls: int
    span: Tuple[int, int]
    call_spans: List[Tuple[int, int]]       # each traced call, from its issue to its end
    device: List[Tuple[str, int, int]]      # (name, start, end) of each device activity
    host: List[Tuple[str, int, int]]        # (name, start, end) of each host event
    op_device_us: Dict[str, float]          # host operator -> device us under it

    @classmethod
    def from_profiler(cls, prof, calls: int) -> "Trace":
        device, host, span, call_spans = [], [], None, []
        for e in prof.profiler.kineto_results.events():
            start = _ns(e, "start")
            end = start + _ns(e, "duration")
            name = e.name()
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                device.append((name, start, end))
            else:
                host.append((name, start, end))
                if name == TRACED:
                    span = (start, end)
                elif name == CALL:
                    call_spans.append((start, end))
        if span is None:
            raise RuntimeError(f"the trace holds no {TRACED} range")
        op_us = {}
        for row in prof.key_averages():
            us = getattr(row, "device_time_total", None)
            if us is None:
                us = getattr(row, "cuda_time_total", 0.0)
            op_us[row.key] = float(us)
        # a record_function range shows on the device too, as an annotation
        # spanning its kernels and the gaps between them: not device work
        annotations = {n for n, _, _ in host}
        device = [(n, max(s, span[0]), min(e, span[1])) for n, s, e in device
                  if e > span[0] and s < span[1] and n not in annotations]
        return cls(calls, span, sorted(call_spans), device, host, op_us)

    @property
    def window_s(self) -> float:
        return (self.span[1] - self.span[0]) * 1e-9

    def busy_intervals(self) -> List[Tuple[int, int]]:
        merged: List[List[int]] = []
        for _, s, e in sorted(self.device, key=lambda x: x[1]):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-9

    @property
    def calls_s(self) -> float:
        """Seconds inside the traced calls: the span less the harness's own
        time between them."""
        return sum(e - s for s, e in self.call_spans) * 1e-9

    @property
    def busy_in_calls_s(self) -> float:
        """Seconds inside the traced calls in which the device worked."""
        total = 0
        for bs, be in self.busy_intervals():
            for cs, ce in self.call_spans:
                total += max(0, min(be, ce) - max(bs, cs))
        return total * 1e-9

    def kernel_s(self, needles) -> float:
        """Seconds of the device activities whose names hold one of
        ``needles``."""
        return sum(e - s for n, s, e in self.device if any(k in n for k in needles)) * 1e-9

    def top_device_ops(self, n: int = 10) -> List[List]:
        total: Dict[str, int] = {}
        for name, s, e in self.device:
            total[name[:160]] = total.get(name[:160], 0) + (e - s)
        top = sorted(total.items(), key=lambda kv: -kv[1])[:n]
        return [[name, ns * 1e-9] for name, ns in top]

    def idle_gaps(self, n: int = 10) -> List[List]:
        """The longest stretches with nothing on the device, each named by
        the innermost host event running at its start."""
        edges = [self.span[0]]
        for s, e in self.busy_intervals():
            edges += [s, e]
        edges.append(self.span[1])
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:n]
        out = []
        for a, b in gaps:
            covering = [h for h in self.host if h[1] <= a < h[2] and h[0] != TRACED]
            label = (max(covering, key=lambda h: h[1])[0] if covering
                     else "host: python, no operator")
            out.append([label[:160], (b - a) * 1e-9])
        return out
