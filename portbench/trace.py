"""The traced run: ``torch.profiler`` over the measured window, reduced in
memory (no trace file is written) to what the per-layer metrics read.

The window is the benchmark's own ``record_function`` span around the
measured loop, so the idle time at its edges counts; the device's work is
the union of its kernels, copies and sets inside it (the union of
``smolscale_tpu_torch/utils/timing.trace_busy``, taken over that window in
place of first-to-last device event).  Each idle gap is labelled by what
the host was doing at its middle: the benchmark's span (``request``: the
call of the entry point; ``ready``: waiting for its outputs; else
``between``) and the innermost host event there.
"""

from __future__ import annotations

import bisect
import dataclasses

WINDOW, REQUEST, READY = "window", "request", "ready"
_NOT_DEVICE_WORK = {"gpu_user_annotation", "user_annotation"}


def profiler(device):
    """A profiler over the host, and over the card when ``device`` is one."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


@dataclasses.dataclass
class Event:
    name: str
    start: int  # ns
    end: int
    on_device: bool
    kind: str  # activity type: kernel, gpu_memcpy, gpu_memset, cpu_op, ...


def events(prof) -> list[Event]:
    """The profiler's events, without building its Python event tree.
    Some torch releases (2.11 among them) give an event no
    ``activity_type``: a device event's kind then follows from its name."""
    out = []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns() if hasattr(e, "start_ns") else int(e.start_us() * 1000)
        dur = e.duration_ns() if hasattr(e, "duration_ns") else int(e.duration_us() * 1000)
        kind = e.activity_type() if hasattr(e, "activity_type") else ""
        on_device = "CUDA" in str(e.device_type())
        name = e.name()
        if not kind and on_device:
            kind = ("gpu_memcpy" if name.startswith("Memcpy") else
                    "gpu_memset" if name.startswith("Memset") else
                    "gpu_user_annotation" if name in (WINDOW, REQUEST, READY) else "kernel")
        out.append(Event(name, start, start + dur, on_device, kind))
    return out


def short_name(name: str) -> str:
    """A kernel's name without its namespace, return type and argument
    list; a copy's or a set's name as it is."""
    if name.startswith("Mem"):
        return name
    name = name.replace("(anonymous namespace)::", "")
    if name.endswith(")"):
        depth = 0
        for k in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[k], 0)
            if depth == 0:
                name = name[:k]
                break
    return name[5:] if name.startswith("void ") else name


@dataclasses.dataclass
class Summary:
    window_s: float
    busy_s: float
    kernel_s: float
    device_ops: list  # [name, seconds], most first
    idle_gaps: list  # [host activity, seconds], most first
    n_device_events: int


def _union(spans: list[tuple[int, int]]) -> list[tuple[int, int]]:
    out: list[list[int]] = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def summarise(evs: list[Event], top: int = 10) -> Summary | None:
    """The window's device work and idle gaps; None without a window span."""
    win = [e for e in evs if e.name == WINDOW and not e.on_device]
    if not win:
        return None
    w0, w1 = win[0].start, win[0].end
    dev = [e for e in evs if e.on_device and e.kind not in _NOT_DEVICE_WORK
           and e.end > w0 and e.start < w1]
    clipped = [(max(e.start, w0), min(e.end, w1)) for e in dev]
    busy = _union(clipped)
    by_name: dict = {}
    kernel_s = 0.0
    for e, (s, t) in zip(dev, clipped):
        sec = (t - s) / 1e9
        name = short_name(e.name)
        by_name[name] = by_name.get(name, 0.0) + sec
        if e.kind == "kernel":
            kernel_s += sec
    gaps = []
    t = w0
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if t < w1:
        gaps.append((t, w1))
    labels = _gap_labels(evs, gaps)
    idle: dict = {}
    for (s, e), label in zip(gaps, labels):
        idle[label] = idle.get(label, 0.0) + (e - s) / 1e9
    return Summary(
        window_s=(w1 - w0) / 1e9,
        busy_s=sum(e - s for s, e in busy) / 1e9,
        kernel_s=kernel_s,
        device_ops=sorted(([k, v] for k, v in by_name.items()), key=lambda kv: -kv[1])[:top],
        idle_gaps=sorted(([k, v] for k, v in idle.items()), key=lambda kv: -kv[1])[:top],
        n_device_events=len(dev),
    )


def _gap_labels(evs: list[Event], gaps: list[tuple[int, int]]) -> list[str]:
    """What the host was doing at the middle of each gap: the benchmark's
    span there and the innermost other host event."""
    host = sorted((e for e in evs if not e.on_device and e.name != WINDOW),
                  key=lambda e: e.start)
    spans = [e for e in host if e.name in (REQUEST, READY)]
    other = [e for e in host if e.name not in (REQUEST, READY)]
    span_starts = [e.start for e in spans]
    other_starts = [e.start for e in other]
    out = []
    for s, e in gaps:
        mid = (s + e) // 2
        k = bisect.bisect_right(span_starts, mid) - 1
        span = spans[k].name if k >= 0 and spans[k].end >= mid else "between"
        inner = None
        k = bisect.bisect_right(other_starts, mid) - 1
        for j in range(k, max(-1, k - 256), -1):
            if other[j].end >= mid:
                inner = other[j].name
                break
        out.append(f"{span}: {inner}" if inner else span)
    return out
