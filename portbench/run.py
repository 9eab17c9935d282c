"""Run one cell of the port's benchmark once.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell's ``BENCHMARK.json`` entry, its
workload file and its configuration say what runs; the last line of
standard output is the result, one JSON object; the numbers compared with
the reference, each beside its limit, are the last lines of standard
error.  Exits non-zero, printing no result, without a CUDA device (or with
fewer than the cell asks for), without the port's package, or if JAX or
the JAX package was loaded.

``--control 1`` puts the control (the reference in float32,
``portbench.control``) in the program's place: its result has to read
``correct: false``.  The benchmark's own runs never use it.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "smolscale_tpu")


def forbidden_modules(names=None) -> list[str]:
    """The top-level names, compared whole, of JAX or the JAX package among
    the loaded modules (or ``names``)."""
    names = list(sys.modules) if names is None else names
    return sorted({n.split(".", 1)[0] for n in names} & set(FORBIDDEN))


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi: {exc}"
    return res.stdout.strip().splitlines()[0] if res.stdout.strip() else res.stderr.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="portbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from . import spec

    # one process, one thread of host compute: the host's noise is the runs' noise
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ.setdefault(var, "1")

    bench = spec.benchmark()
    cell = spec.cell(bench, args.workload)
    workload = spec.workload(args.workload)
    config = spec.config(bench, cell["config"])
    metric_names = spec.cell_metrics(bench, args.workload, bool(args.trace))

    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"portbench: cell {args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    if args.control:
        from . import control as program
    else:
        import smolscale_tpu_torch as program
    from . import harness

    result = harness.run(args.workload, workload, config, metric_names, args.seed,
                         args.seconds, bool(args.trace), torch.device("cuda", 0), program,
                         T_START)
    print(f"[card] {card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          file=sys.stderr)
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {found}: nothing it runs may import JAX or "
              f"the JAX package", file=sys.stderr)
        return 3
    harness.print_checks(result)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
