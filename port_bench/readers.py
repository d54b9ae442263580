"""What the metric files (``metrics/<name>.py``) share: each reads the
run's context (``session.RunContext``) and returns a number, or None where
the run gives it nothing to read (another kind of cell, a run without a
trace, a layer that did not run)."""

from __future__ import annotations

import statistics
from typing import Iterable, Optional

from port_bench import roofline


def of_kind(ctx, kind: str) -> bool:
    return ctx.kind == kind


def dispatch_ms(ctx, kind: str) -> Optional[float]:
    """Median host ms from a call of the step or request to its return."""
    if not of_kind(ctx, kind) or not ctx.dispatch_ms:
        return None
    return statistics.median(ctx.dispatch_ms)


def op_device_ms(ctx, kind: str, ops: Iterable[str]) -> Optional[float]:
    """Device ms a traced call under the host operators ``ops``; None when
    none of them ran on the device."""
    if not of_kind(ctx, kind) or ctx.trace is None:
        return None
    us = sum(ctx.trace.op_device_us.get(op, 0.0) for op in ops)
    return us / 1e3 / ctx.trace.calls if us > 0 else None


def roofline_share(ctx, kind: str, family: str, kernels: Iterable[str]) -> Optional[float]:
    """Sum of the least times of ``family``'s traced launches over the
    profiled time of ``kernels``, in percent."""
    if not of_kind(ctx, kind) or ctx.trace is None or ctx.launches is None or ctx.peaks is None:
        return None
    return roofline.share_of_roofline(ctx.launches[family], ctx.trace.kernel_s(kernels),
                                      ctx.peaks)


def idle_share(ctx, kind: str) -> Optional[float]:
    """Percent of the traced calls' time with nothing on the device (each
    call from its issue to its ``synchronize()``; the harness's own time
    between calls is not the program's)."""
    if not of_kind(ctx, kind) or ctx.trace is None or ctx.trace.calls_s <= 0 \
            or not ctx.trace.device:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_in_calls_s / ctx.trace.calls_s)


def mfu(ctx, kind: str) -> Optional[float]:
    """The traced calls' useful FLOPs (counted by the reference) over the
    calls' time and the chip's peak for the configuration's precision, in
    percent."""
    if not of_kind(ctx, kind) or ctx.trace is None or ctx.peaks is None \
            or not ctx.traced_flops or ctx.trace.calls_s <= 0:
        return None
    peak = roofline.flop_peak(ctx.peaks, ctx.compute_dtype)
    return 100.0 * ctx.traced_flops / ctx.trace.calls_s / peak
