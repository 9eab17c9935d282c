"""One run of one cell: set-up, the measured window, the check, the result.

Device-agnostic below the command line (``portbench.run``), which looks
for the card: the tests drive a whole run here on the CPU, where the port
runs its kernels' plain versions.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import sys
import time
import traceback

import torch

from . import entries, spec, trace, traffic

HBM_PEAK_BYTES_PER_S = 3.35e12  # H100 SXM data sheet, at the 700 W power limit
PLAIN_STRETCH_S = 2.0  # a traced run's untraced stretch, for the host's own times


@dataclasses.dataclass
class Record:
    """What a run measured, for the metrics' readers."""

    cell: str
    setup_s: float
    window_s: float
    spans: list  # (start, called, ready) of each completed request, host seconds
    work: list  # (pixels, bytes) of each completed request
    plain_spans: list  # the same spans with the profiler off: the window's, or a traced
    # run's untraced stretch after its window
    launches: int | None  # the program's kernel launches over the window
    trace: trace.Summary | None
    peak_bytes_per_s: float = HBM_PEAK_BYTES_PER_S


def launch_count() -> int | None:
    """The sum of the ``launches`` counters of the port's kernel wrappers
    (``smolscale_tpu_torch.ops.*``) loaded so far; None if none is."""
    counts = [m.launches for name, m in list(sys.modules.items())
              if name.startswith("smolscale_tpu_torch.ops.") and isinstance(
                  getattr(m, "launches", None), int)]
    return sum(counts) if counts else None


def _load_library(program, device: torch.device) -> None:
    """Load the program's kernel library (building it in a checkout's first
    run) before its first call, so that set-up can time it apart."""
    if device.type != "cuda":
        return
    try:
        build = importlib.import_module(program.__name__ + ".ops._build")
    except ImportError:
        return
    build.library()


def _stretch(entry, i: int, seconds: float) -> list:
    """Spans of whole passes over the traffic from request ``i`` on, with
    nothing traced, for at least ``seconds``; cut short by a request that
    raises (the window has counted those)."""
    spans = []
    t0 = time.perf_counter()
    try:
        while not spans or time.perf_counter() - t0 < seconds:
            for _ in range(entry.pass_requests):
                ts = time.perf_counter()
                outs = entry.call(i)
                tc = time.perf_counter()
                entry.ready(outs)
                spans.append((ts, tc, time.perf_counter()))
                i += 1
    except Exception:  # noqa: BLE001
        pass
    return spans


def _span(on: bool, name: str):
    if on:
        from torch.profiler import record_function

        return record_function(name)
    return contextlib.nullcontext()


def run(name: str, workload: dict, config: dict, metric_names: list, seed: int,
        seconds: float, traced: bool, device: torch.device, program, t_start: float,
        log=sys.stderr) -> dict:
    """Run cell ``name`` once and return its result line as a dict.
    ``t_start`` is the host clock at the process's start, from which
    ``setup_s`` runs to the first timed request; its parts are timed apart
    (``setup_parts``: the kernel library's load or build among them)."""
    marks = [("imports", time.perf_counter())]

    def mark(phase):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        marks.append((phase, time.perf_counter()))

    if device.type == "cuda":
        torch.zeros(1, device=device)
    mark("device")
    _load_library(program, device)
    mark("library")
    entry = entries.ENTRIES[workload["entry"]](config, workload, seed, device, program)
    mark("inputs")
    per_request = entry.warm()
    mark("warm")
    n_expected = 0.9 * seconds / max(per_request, 1e-9)
    keep = traffic.sample(n_expected, int(workload["check_requests"]), seed)
    entry.rehearse(keep)
    mark("rehearse")
    setup_parts = {"imports": marks[0][1] - t_start}
    setup_parts.update({p: t - t_prev for (_, t_prev), (p, t) in zip(marks, marks[1:])})
    kept, spans, work, outs = {}, [], [], None
    attempted = failed = 0
    prof = trace.profiler(device) if traced else contextlib.nullcontext()
    with prof:
        before = launch_count()
        with _span(traced, trace.WINDOW):
            t0 = time.perf_counter()
            setup_s = t0 - t_start
            i = 0
            while time.perf_counter() - t0 < seconds:
                attempted += 1
                try:
                    ts = time.perf_counter()
                    with _span(traced, trace.REQUEST):
                        outs = entry.call(i)
                    tc = time.perf_counter()
                    with _span(traced, trace.READY):
                        entry.ready(outs)
                    tr = time.perf_counter()
                except Exception:  # noqa: BLE001 - the window runs on; the run fails
                    if not failed:
                        traceback.print_exc(file=log)
                    failed += 1
                    i += 1
                    continue
                spans.append((ts, tc, tr))
                work.append(entry.work(i))
                if i in keep:
                    kept[i] = outs
                elif i in entry.one_frame:
                    kept[i] = entry.frame_of(i, outs)
                outs = None  # the caller is done with them before its next call
                i += 1
            window_s = time.perf_counter() - t0
        after = launch_count()
    summary = trace.summarise(trace.events(prof)) if traced else None
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    plain = _stretch(entry, i, PLAIN_STRETCH_S) if traced else spans
    record = Record(
        cell=name, setup_s=setup_s, window_s=window_s, spans=spans, work=work,
        plain_spans=plain, launches=None if before is None else after - before,
        trace=summary)
    metrics = {}
    for m in metric_names:
        reader = spec.metric(m)
        value = reader.read(record)
        if value is not None:
            metrics[m] = {"value": float(value), "unit": reader.UNIT}

    entry.release()
    del outs
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    worst, compared = entry.check(kept)
    check_s = time.perf_counter() - t_check
    checks = {
        "max_byte_diff": {"value": worst, "limit": 0},
        "failed_requests": {"value": failed, "limit": 0},
        "images_compared": {"value": compared, "at_least": 1},
    }
    correct = worst <= 0 and failed == 0 and compared >= 1
    print(f"[run] {name} seed {seed}: {len(spans)} requests completed in {window_s:.3f} s "
          f"({attempted} attempted, {failed} failed), set-up {setup_s:.3f} s, "
          f"{len(kept)} requests kept and {compared} images compared in {check_s:.3f} s",
          file=log)
    print("[setup] " + ", ".join(f"{p} {v:.3f} s" for p, v in setup_parts.items()), file=log)
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    result = {"cell": name, "seed": seed, "correct": correct, "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": dev, "setup_parts": setup_parts}
    if summary is not None:
        dev["busy_s"] = summary.busy_s
        dev["window_s"] = summary.window_s
        result["breakdown"] = {"device_ops": summary.device_ops,
                               "idle_gaps": summary.idle_gaps}
    result["checks"] = checks
    return result


def print_checks(result: dict, log=sys.stderr) -> None:
    """Each number compared beside its limit, as the last lines of standard
    error."""
    for name, c in result["checks"].items():
        limit = f"limit {c['limit']}" if "limit" in c else f"at least {c['at_least']}"
        print(f"check {name} {c['value']} {limit}", file=log)
    log.flush()
