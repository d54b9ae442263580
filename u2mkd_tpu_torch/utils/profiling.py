"""Profiling hooks (port of ``u2mkd_tpu/utils/profiling.py``).

The reference times its kernels with synchronized wall clocks
(``sptr/functional.py:7,27-35``) and its requests with the ``InferTime``
callback. Here: a ``torch.profiler`` trace of a code block, a step timer
that reads CUDA events on the card (the host clock on the CPU), and named
ranges that show in the trace.
"""

from __future__ import annotations

import contextlib
import time
from typing import List, Optional

import torch


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]):
    """A ``torch.profiler`` trace of the block (host and, where there is a
    card, device activity), written into ``log_dir`` for TensorBoard's
    profiler plugin or Perfetto. Nothing happens when ``log_dir`` is falsy."""
    if not log_dir:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts,
                                on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)):
        yield


class StepTimer:
    """Step latency with the reference's warm-up trim (``InferTime``: the
    mean over [10:-3], ``core/callbacks.py:203-220``). On ``device`` cuda
    each step is timed by two CUDA events, read when the times are asked
    for, so timing adds no synchronize to a step; on the CPU by the host
    clock."""

    def __init__(self, device="cuda"):
        self.cuda = torch.device(device).type == "cuda"
        self._events: List = []
        self._times: List[float] = []
        self._t0: Optional[object] = None

    def __enter__(self):
        if self.cuda:
            self._t0 = torch.cuda.Event(enable_timing=True)
            self._t0.record()
        else:
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.cuda:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self._events.append((self._t0, end))
        else:
            self._times.append(time.perf_counter() - self._t0)

    @property
    def times(self) -> List[float]:
        """Seconds of each step so far (waits for the card's last one)."""
        for start, end in self._events:
            end.synchronize()
            self._times.append(start.elapsed_time(end) / 1e3)
        self._events.clear()
        return self._times

    def mean_ms(self, batch_size: int = 1) -> Optional[float]:
        t = self.times
        t = t[10:-3] if len(t) > 13 else t
        if not t:
            return None
        return float(sum(t) / len(t) / batch_size * 1000)


def annotate(name: str):
    """A named range of the trace (``torch.profiler.record_function``)."""
    return torch.profiler.record_function(name)
