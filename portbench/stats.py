"""Percentiles of a run and spreads over runs.

``python -m portbench.stats FILE...`` reads result lines (the last line of
each run's standard output, one JSON object a line; other lines are
skipped) and prints, per cell when the lines carry a ``"cell"`` key and
per metric, the runs' median, quartiles and spread: the distance between
the first and third quartile of ``statistics.quantiles(values, n=4)`` as a
share of the median, the rule the bounds in ``BENCHMARK.json`` are set by.
"""

from __future__ import annotations

import json
import math
import statistics
import sys


def percentile(values, q: float) -> float | None:
    """The ``q``-th percentile, interpolated linearly between the closest
    ranks (numpy's default), over all of ``values``; None if empty."""
    xs = sorted(values)
    if not xs:
        return None
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def spread(values) -> float:
    """Interquartile distance over the median (``statistics.quantiles``'
    default, exclusive method)."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2 if q2 else math.inf


def main(paths) -> int:
    runs: dict = {}
    for path in paths:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line.startswith("{"):
                    continue
                try:
                    res = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if "metrics" not in res:
                    continue
                for name, m in res["metrics"].items():
                    runs.setdefault((res.get("cell", "?"), name), []).append(m["value"])
    for (cell, name), vals in sorted(runs.items()):
        if len(vals) < 2:
            print(f"{cell} {name}: n={len(vals)} {vals}")
            continue
        q1, q2, q3 = statistics.quantiles(vals, n=4)
        print(f"{cell} {name}: n={len(vals)} median {statistics.median(vals)!r} "
              f"q1 {q1!r} q3 {q3!r} spread {spread(vals):.4%} min {min(vals)!r} max {max(vals)!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
