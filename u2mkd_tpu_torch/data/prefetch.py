"""Background-thread batch prefetching and the pipelined plumbing stage.

Port of ``u2mkd_tpu/data/prefetch.py``. Overlaps host-side batch
construction (augmentation, collation, the native plumbing and window
geometry) with device steps: the role torch ``DataLoader`` worker processes
play for the reference (``train_spformer.py:63-75``). A bounded queue keeps
a configurable number of ready batches ahead of the consumer. Nothing here
imports torch: process workers import this module and ``loaders`` only.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator


_SENTINEL = object()


def prefetch(iterable: Iterable, depth: int = 2) -> Iterator:
    """Iterate ``iterable`` on a worker thread, keeping ``depth`` items ready.

    Closing the returned generator (``gen.close()``, or dropping it) stops
    the worker promptly instead of letting it keep driving the source
    iterable in the background — an abandoned epoch iterator would
    otherwise keep augmenting batches concurrently with a new one over the
    same dataset RandomState."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    err = []
    stop = threading.Event()

    def worker():
        try:
            for item in iterable:
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    break
        except BaseException as e:  # surface worker errors to the consumer
            err.append(e)
        finally:
            if stop.is_set():
                close = getattr(iterable, "close", None)
                if close is not None:
                    close()  # unwind pipelined_map's thread pool now
            # The sentinel MUST reach the consumer or it blocks in q.get()
            # forever (a put_nowait here silently dropped it whenever the
            # consumer lagged and the queue was full — i.e. at the end of
            # every epoch whose device step was slower than the loader).
            # Block with a stop-checking timeout like the item loop; give
            # up only when the consumer is gone (stop set).
            while True:
                try:
                    q.put(_SENTINEL, timeout=0.1)
                    break
                except queue.Full:
                    if stop.is_set():
                        break

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        stop.set()


def pipelined_map(fn, iterable: Iterable, workers: int,
                  depth: int = None) -> Iterator:
    """Apply ``fn`` over ``iterable`` on a thread pool, yielding results IN
    ORDER with at most ``depth`` items in flight.

    This is the parallel stage of the data pipeline: the iterable (sample
    fetch + augmentation + collate) is consumed serially in the caller's
    thread, preserving the datasets' shared-RandomState determinism, while
    ``fn`` — the pure, GIL-releasing numpy/C++ plumbing + window-geometry
    build, the largest host cost of a batch — runs ``workers`` batches
    deep. The role of the reference's torch ``DataLoader``
    ``num_workers`` (``configs/default.yaml:2``), minus the per-worker RNG
    forks (the parallel stage is deterministic by construction)."""
    import collections
    from concurrent.futures import ThreadPoolExecutor

    if depth is None:
        depth = workers + 2
    with ThreadPoolExecutor(max_workers=workers) as ex:
        futs = collections.deque()
        for item in iterable:
            futs.append(ex.submit(fn, item))
            if len(futs) >= depth:
                yield futs.popleft().result()
        while futs:
            yield futs.popleft().result()


def process_pipelined_map(fn, iterable: Iterable, workers: int,
                          depth: int = None,
                          mp_context: str = None) -> Iterator:
    """``pipelined_map`` on a PROCESS pool: escapes the GIL for the
    numpy-heavy parts of the plumbing stage that threads cannot overlap
    (the C++ builders already release the GIL, so threads cover them;
    pure-numpy batches do not scale on threads).

    ``fn`` must be picklable (a top-level callable or an instance of a
    module-level class such as ``loaders.PlumbingStage``); batches round-
    trip through pickle, so process workers only pay off when per-batch
    compute is large relative to its array payload (tens of MB at 131k
    points). Workers import no torch and never touch the device: the
    batches they return hold numpy arrays only, and the upload happens in
    the parent, after the stage.

    ``mp_context`` (or ``U2MKD_MP_CONTEXT``) picks the start method.
    Default ``spawn``: the training parent is multithreaded (CUDA runtime,
    prefetch threads), and forking a multithreaded process can deadlock a
    child on a lock some other thread held at fork time; a forked child
    would also inherit the parent's CUDA context, which CUDA does not
    support. ``fork`` is cheaper to start (no re-import) and fine for
    short-lived pools in single-threaded parents that never touched CUDA."""
    import collections
    import multiprocessing as mp
    import os
    from concurrent.futures import ProcessPoolExecutor

    if depth is None:
        depth = workers + 2
    if mp_context is None:
        mp_context = os.environ.get("U2MKD_MP_CONTEXT", "spawn")
    ctx = mp.get_context(mp_context)
    with ProcessPoolExecutor(max_workers=workers, mp_context=ctx) as ex:
        futs = collections.deque()
        for item in iterable:
            futs.append(ex.submit(fn, item))
            if len(futs) >= depth:
                yield futs.popleft().result()
        while futs:
            yield futs.popleft().result()


def prefetched_loader(loader_fn: Callable[[], Iterable], depth: int = 2):
    """Wrap a loader factory so each epoch's iteration is prefetched."""

    def wrapped():
        return prefetch(loader_fn(), depth)

    return wrapped


def maybe_pipelined(fn, iterable: Iterable, workers: int,
                    enabled: bool = True,
                    use_processes: bool = False) -> Iterator:
    """The loaders' shared pipeline policy: run ``fn`` (host plumbing +
    window geometry) through ``pipelined_map`` (threads; default) or
    ``process_pipelined_map`` (``use_processes=True``, requires picklable
    ``fn``) when ``enabled`` and ``workers > 1``, else apply it inline.
    One definition so the three loader families (uni-modal, distill,
    synthetic) cannot drift."""
    if enabled and workers > 1:
        mapper = process_pipelined_map if use_processes else pipelined_map
        yield from mapper(fn, iterable, workers)
    else:
        for item in iterable:
            yield fn(item)
