"""Device timing with CUDA events, and the port's host spans.

Counterpart of ``smolscale_tpu.utils.timing``.  The TPU harness times by
chain slopes because its remote platform's completion barrier is
unreliable; on a local CUDA device an event pair around each run measures
device time directly.

:func:`span` marks a layer of the port's host path under a ``smolscale.``
name.  A span is on exactly while a torch profiler collects
(``torch.autograd.profiler._is_profiler_enabled``): it then records a host
event under its name in the profiler's trace, on the device trace's clock,
and adds its duration to per-name totals (:func:`span_totals`).  Off, a
span reads one flag when entered and finds no span open when left: no
profiler call, no clock, no per-thread state, no allocation.

The spans: ``smolscale.scale``, ``smolscale.scale_rows`` and
``smolscale.pyramid`` (a function of ``make_pyramid_fn``) around each
public call, the outermost; inside them ``smolscale.dispatch`` (the choice
of a kernel in ``backends/torch_ops``) and, in the kernel wrappers' launch
frame (``ops/_kernel.py``), ``smolscale.alloc`` (the outputs), ``smolscale.tables`` (the
device's entry, the per-plan tables, the parameter block) and
``smolscale.launch`` (the kernel's launch).  ``scale_pyramid_mixed`` adds
``smolscale.farm.group`` (grouping the fleet into sub-batches),
``smolscale.farm.stack`` (a sub-batch's stacking into the pinned ring),
``smolscale.farm.upload`` and ``smolscale.farm.download``.

:func:`counter` counts work at a layer boundary on the same terms: on only
while a profiler collects, its per-name totals read by
:func:`counter_totals`.  Each kernel wrapper's frame (``ops/_kernel.py``) counts, under
its module's name (``bilinear``, ``bilinear128``, ``box``, ``deep``,
``pyramid``), the bytes of the images it is handed and of those it returns,
from their shapes, on every call, the plain versions' on the CPU included.
"""

from __future__ import annotations

import statistics
from threading import get_ident
from time import perf_counter_ns

import torch

# a host cpu_op under the given name, with no device-side annotation
from torch._C._profiler import _RecordFunctionFast as _record
from torch.autograd import profiler as _profiler


def cuda_time_ms(fn, warmup: int = 3, iters: int = 20) -> float:
    """Median device milliseconds of ``fn()`` over ``iters`` runs on the
    current stream, after ``warmup`` runs.  Raises without a CUDA device:
    a time from any other device is not this metric."""
    if not torch.cuda.is_available():
        raise RuntimeError("cuda_time_ms needs a CUDA device")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = [
        (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        for _ in range(iters)
    ]
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(start.elapsed_time(end) for start, end in events)


# By thread ident: the thread's open spans, innermost last (each ``[span,
# profiler record, child ns, start ns]``), held only while it has one; and
# the totals of the spans it closed, name -> [count, total ns, self ns].
# Each thread writes its own entries alone, so no lock is taken.
_stacks: dict[int, list] = {}
_totals: dict[int, dict] = {}


class _Span:
    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        if _profiler._is_profiler_enabled:
            rec = _record(self.name)
            rec.__enter__()
            ident = get_ident()
            stack = _stacks.get(ident)
            if stack is None:
                stack = _stacks[ident] = []
            stack.append([self, rec, 0, perf_counter_ns()])
        return self

    def __exit__(self, *exc):
        if not _stacks:
            return  # no span open on any thread
        ident = get_ident()
        stack = _stacks.get(ident)
        if stack is None or stack[-1][0] is not self:
            return  # entered with no profiler collecting, or ended already
        end_ns = perf_counter_ns()
        _, rec, child_ns, start_ns = stack.pop()
        rec.__exit__(None, None, None)
        dur = end_ns - start_ns
        if stack:
            stack[-1][2] += dur
        else:
            del _stacks[ident]
        totals = _totals.get(ident)
        if totals is None:
            totals = _totals[ident] = {}
        t = totals.get(self.name)
        if t is None:
            t = totals[self.name] = [0, 0, 0]
        t[0] += 1
        t[1] += dur
        t[2] += dur - child_ns

    # close the span before its ``with`` block ends; the block's end then
    # does nothing
    end = __exit__


def span(name: str) -> _Span:
    """The span ``name`` (``smolscale.<layer>``): a context manager that
    marks its block while a profiler collects, and does nothing otherwise.
    Make it once, where the module loads, and enter it on each call (off,
    entering reads one flag and allocates nothing); ``end()`` closes it
    before its block ends.  One object may be entered on many threads and
    inside itself."""
    return _Span(name)


def span_totals() -> dict[str, dict[str, int]]:
    """A copy of the totals of every span closed while tracing, by name:
    ``count``, ``total_ns`` and ``self_ns`` (the total less the spans
    opened inside it on the same thread), since the process started."""
    out: dict[str, dict[str, int]] = {}
    for totals in list(_totals.values()):
        for name, (c, t, s) in list(totals.items()):
            got = out.setdefault(name, {"count": 0, "total_ns": 0, "self_ns": 0})
            got["count"] += c
            got["total_ns"] += t
            got["self_ns"] += s
    return out


# By thread ident: the counts the thread added while tracing, name -> count.
_counts: dict[int, dict] = {}


class _Counter:
    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def add(self, *tensors: torch.Tensor) -> None:
        """Add the elements of ``tensors`` (bytes, for uint8 images) while a
        profiler collects; otherwise read one flag and do nothing."""
        if _profiler._is_profiler_enabled:
            ident = get_ident()
            counts = _counts.get(ident)
            if counts is None:
                counts = _counts[ident] = {}
            counts[self.name] = counts.get(self.name, 0) + sum(t.numel() for t in tensors)


def counter(name: str) -> _Counter:
    """The counter ``name``: ``add(*tensors)`` adds their elements while a
    profiler collects, and does nothing otherwise.  Make it once, where the
    module loads."""
    return _Counter(name)


def counter_totals() -> dict[str, int]:
    """The totals of every counter added to while tracing, by name, since
    the process started."""
    out: dict[str, int] = {}
    for counts in list(_counts.values()):
        for name, n in list(counts.items()):
            out[name] = out.get(name, 0) + n
    return out
