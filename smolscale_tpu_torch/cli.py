"""Command-line harness: check / benchmark / benchmark-conv / generate.

Counterpart of ``smolscale_tpu.cli``, the reference's test driver modes
(test.c:1378-1390): a correctness sweep, throughput benchmarks, the 10x10
format-conversion matrix, and PNG generation.  Everything runs on
``--device``, by default the card.

    python -m smolscale_tpu_torch.cli check [--full] [--colors N]
    python -m smolscale_tpu_torch.cli benchmark [--width 1920 --height 1080 ...]
    python -m smolscale_tpu_torch.cli benchmark-conv
    python -m smolscale_tpu_torch.cli generate in.png out_prefix n_steps
    python -m smolscale_tpu_torch.cli --device cpu check   # the plain versions
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

import smolscale_tpu_torch as stt
from .backends import torch_ops
from .plan import ScalePlan
from .utils import png
from .utils.timing import cuda_time_ms


def _check_sizes(full: bool):
    """Size ladder: every boundary the planner cares about, plus a strided
    cover of 1..65535 (the full upstream plan iterates all 65535 sizes)."""
    base = (
        list(range(1, 65)) +
        [100, 127, 128, 129, 254, 255, 256, 257, 511, 512, 1000,
         2047, 2048, 4095, 4096, 8191, 8192, 16384, 32768, 65534, 65535]
    )
    if full:
        return sorted(set(base) | set(range(1, 65536)))
    return sorted(set(base) | set(range(65, 65536, 653)))


def _check_cases(full: bool, n_colors: int):
    """The solid-colour sweep of test.c:1119-1298 as ``(w_in, h_in, w_out,
    h_out, colour)``: W i -> 1, H i -> 1, 65535 -> i on each axis, and the
    long i -> j grid, for each canvas colour (i, i+1, i+2, i+3)."""
    color_is = ([0, 4, 128, 248, 252][:n_colors] if n_colors <= 5
                else list(range(0, 256, 4))[:n_colors])
    sizes = _check_sizes(full)
    step = 655 if not full else (65534 // 100)
    for ci in color_is:
        # canvas pixel (i<<24)|((i+1)<<16)|((i+2)<<8)|(i+3), LE byte order
        color = np.array([ci + 3, ci + 2, ci + 1, ci], dtype=np.uint8)
        for s in sizes:
            yield ci, (s, 1, 1, 1, color)        # Width i -> 1
            yield ci, (1, s, 1, 1, color)        # Height i -> 1
            yield ci, (65535, 1, s, 1, color)    # Width 65535 -> i
            yield ci, (1, 65535, 1, s, color)    # Height 65535 -> i
        for i in range(1, 65536, step):
            for j in ([1, i // 2 + 1, i] if not full else range(1, i + 1)):
                j = max(1, min(j, 65535))
                yield ci, (i, 1, j, 1, color)
                yield ci, (1, i, 1, j, color)


def _scale(plan: ScalePlan, img: np.ndarray, device) -> np.ndarray:
    """The scale under test, on ``device``, as a host array."""
    return stt.scale(plan, img, device=device).cpu().numpy()


def _plain(plan: ScalePlan, img: np.ndarray) -> np.ndarray:
    """The plain versions on the CPU: what the kernels are held to."""
    return stt.scale(plan, img, device="cpu").numpy()


def cmd_check(args) -> int:
    """Solid-colour sweep on the reference's plan (test.c:1119-1298):
    ARGB-premultiplied canvases of the colours (i, i+1, i+2, i+3), swept
    W i -> 1, H i -> 1, 65535 -> j on both axes, and the long i -> j grid.

    Each case runs on ``--device`` and is held byte for byte against the
    plain versions on the CPU, and to exact solid-colour invariance on
    every pixel that the box's final-element drop (generic.c:105-110)
    cannot reach (all output columns and rows but the last of each axis).
    On the card every case runs through a kernel.  Exits 1 on any failure.
    Default: every boundary size and a ~100-step cover (about 1,350 cases
    per colour); ``--full`` runs all 65535 sizes per sweep as test.c does
    (days); ``--colors N`` sets the canvas colours (upstream: 64).
    """
    TYPE = 2  # SMOL_PIXEL_ARGB8_PREMULTIPLIED (test.c:20)
    dev = torch_ops.numpy_device(args.device)
    if dev.type == "cpu":
        print("# device cpu: the plain versions against themselves; the invariance "
              "is the check")
    failures = total = 0
    t0 = time.perf_counter()
    last = None
    for ci, (wi, hi, wo, ho, color) in _check_cases(args.full, args.colors):
        if last is not None and ci != last:
            print(f"color {last}: {total - failures}/{total} ok", flush=True)
        last = ci
        img = np.broadcast_to(color, (hi, wi, 4)).copy()
        plan = ScalePlan(wi, hi, wo, ho, TYPE, TYPE, False)
        # every case is a new plan: what the kernels cache for it goes with it
        with torch_ops.transient_plans():
            out, ref = _scale(plan, img, dev), _plain(plan, img)
        total += 1
        ok = out.shape == ref.shape and np.array_equal(out, ref)
        # solid invariance holds exactly away from the drop-affected edge
        if ok and wo > 1 and (out[:, :-1] != color).any():
            ok = False
        if ok and ho > 1 and (out[:-1, :] != color).any():
            ok = False
        if not ok:
            failures += 1
            print(f"FAIL {wi}x{hi}->{wo}x{ho}: {out[-1, -1]} plain {ref[-1, -1]} want {color}")
    if last is not None:
        print(f"color {last}: {total - failures}/{total} ok", flush=True)
    print(f"check: {total - failures}/{total} ok on {dev} in "
          f"{time.perf_counter() - t0:.1f} s")
    return 1 if failures else 0


def _bench_one(plan: ScalePlan, device, reps: int = 5) -> float:
    """Min-time pixels/s = (in + out) / elapsed (test.c:219-224 metric).
    The input is made on the device once; on the card each run is timed by
    a CUDA event pair (the kernel's device time), on the CPU by the host
    clock."""
    dev = torch_ops.numpy_device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    shape = (plan.height_in, plan.width_in, plan.meta_in.n_bytes)
    img = torch.randint(0, 256, shape, generator=gen, dtype=torch.uint8, device=dev)
    stt.scale(plan, img)  # warm: tables, first launch
    if dev.type == "cuda":
        best = min(cuda_time_ms(lambda: stt.scale(plan, img), warmup=0, iters=1)
                   for _ in range(reps)) / 1e3
    else:
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            stt.scale(plan, img)
            best = min(best, time.perf_counter() - t0)
    px = plan.width_in * plan.height_in + plan.width_out * plan.height_out
    return px / best


def _print_average(pps_list, file=None):
    """Mean + 5th/95th percentile of pps, the reference's summary line
    (benchmark_print_average, test.c:357-382: sort by pps, index len*0.05
    and len*0.95)."""
    by_pps = sorted(pps_list)
    n = len(by_pps)
    mean = sum(by_pps) / n
    p5 = by_pps[int(n * 0.05)]
    p95 = by_pps[min(int(n * 0.95), n - 1)]
    print(f"{mean:.1f} {p5:.1f} {p95:.1f}", file=file)
    return mean, p5, p95


def _plot_samples(samples, path, title):
    """plot.sh analogue (plot.sh:11-19): elapsed vs output size and a pps
    curve, rendered with matplotlib instead of gnuplot."""
    try:
        import matplotlib
    except ImportError as e:
        raise RuntimeError("--plot needs matplotlib, which is not installed") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    xs = [w * h / 1e6 for w, h, _, _ in samples]
    el = [e * 1e3 for _, _, e, _ in samples]
    pps = [p / 1e6 for _, _, _, p in samples]
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(11, 4))
    ax1.plot(xs, el, "o-", ms=3)
    ax1.set_xlabel("output Mpix")
    ax1.set_ylabel("elapsed (ms)")
    ax1.set_title(f"{title}: elapsed vs size")
    ax2.plot(xs, pps, "o-", ms=3, color="tab:green")
    ax2.set_xlabel("output Mpix")
    ax2.set_ylabel("pixels/s (M, in+out)")
    ax2.set_title("throughput")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)


def _device_name(device) -> str:
    dev = torch_ops.numpy_device(device)
    return f"{dev} ({torch.cuda.get_device_name(dev)})" if dev.type == "cuda" else str(dev)


def cmd_benchmark(args) -> int:
    """Proportional-resize sweep (bench.sh:41-52 recipe shape) with the
    reference's postprocess: min-time per size (test.c:320-340), sample
    lines "w h elapsed pps" (benchmark_print_samples, test.c:343-355) via
    --samples, the mean/5pct/95pct summary (test.c:357-382), and a
    matplotlib rendering of plot.sh's charts via --plot."""
    w, h = args.width, args.height
    steps = args.steps
    print(f"# {w}x{h} proportional sweep, {steps} steps, device={_device_name(args.device)}")
    print("scale\twidth\theight\tMpix/s")
    samples = []
    for i in range(1, steps + 1):
        f = args.min_scale + (args.max_scale - args.min_scale) * i / steps
        wo, ho = max(1, int(w * f)), max(1, int(h * f))
        plan = ScalePlan(w, h, wo, ho, args.ptype, args.ptype, args.srgb)
        pps = _bench_one(plan, args.device, args.reps)
        elapsed = (w * h + wo * ho) / pps
        samples.append((wo, ho, elapsed, pps))
        print(f"{f:.3f}\t{wo}\t{ho}\t{pps/1e6:.1f}")
    print("# mean p5 p95 (pps)")
    _print_average([p for _, _, _, p in samples])
    if args.samples:
        with open(args.samples, "w") as fh:
            for wo, ho, el, pps in samples:
                fh.write(f"{wo} {ho} {el:.6f} {pps:.1f}\n")
    if args.plot:
        _plot_samples(samples, args.plot, f"{w}x{h}")
        print(f"# plot written to {args.plot}")
    return 0


def cmd_benchmark_conv(args) -> int:
    """10x10 pixel-type conversion matrix (test.c:1055-1107 recipe,
    3840x2160 -> 3839x2159)."""
    print(f"# conversion matrix Mpix/s (rows: in type, cols: out type), "
          f"device={_device_name(args.device)}")
    for ti in range(10):
        row = []
        for to in range(10):
            plan = ScalePlan(3840, 2160, 3839, 2159, ti, to, args.srgb)
            pps = _bench_one(plan, args.device, args.reps)
            row.append(f"{pps/1e6:7.0f}")
        print(f"t{ti}: " + " ".join(row))
    return 0


def cmd_generate(args) -> int:
    """PNG in -> n scaled PNGs out (test.c:1302-1371 visual regression)."""
    img = png.read_png(args.input)
    if img.ndim == 2:
        img = np.repeat(img[:, :, None], 3, axis=2)
    ptype = stt.PixelType.RGBA8_UNASSOCIATED if img.shape[2] == 4 else stt.PixelType.RGB8
    h, w = img.shape[:2]
    for i in range(1, args.n + 1):
        f = i / args.n
        wo, ho = max(1, int(w * f)), max(1, int(h * f))
        out = stt.scale_simple(img, ptype, wo, ho, with_srgb=args.srgb, device=args.device)
        path = f"{args.prefix}-{wo}x{ho}.png"
        png.write_png(path, out.cpu().numpy())
        print(path)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="smolscale_tpu_torch.cli")
    ap.add_argument("--device", default=None,
                    help="device to run on (default: the card; 'cpu' runs the plain versions)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    ck = sub.add_parser("check")
    ck.add_argument("--full", action="store_true",
                    help="run the complete upstream plan (all sizes; days)")
    ck.add_argument("--colors", type=int, default=4,
                    help="number of canvas colors (upstream: 64)")

    b = sub.add_parser("benchmark")
    b.add_argument("--width", type=int, default=1920)
    b.add_argument("--height", type=int, default=1080)
    b.add_argument("--steps", type=int, default=20)
    b.add_argument("--min-scale", type=float, default=0.01)
    b.add_argument("--max-scale", type=float, default=2.0)
    b.add_argument("--reps", type=int, default=5)
    b.add_argument("--ptype", type=int, default=0)
    b.add_argument("--srgb", action="store_true")
    b.add_argument("--samples", default=None,
                   help="write 'w h elapsed pps' sample lines (plot.sh input format)")
    b.add_argument("--plot", default=None,
                   help="render the plot.sh charts to this PNG (matplotlib)")

    c = sub.add_parser("benchmark-conv")
    c.add_argument("--reps", type=int, default=3)
    c.add_argument("--srgb", action="store_true")

    g = sub.add_parser("generate")
    g.add_argument("input")
    g.add_argument("prefix")
    g.add_argument("n", type=int, nargs="?", default=5)
    g.add_argument("--srgb", action="store_true")

    args = ap.parse_args(argv)
    return {
        "check": cmd_check,
        "benchmark": cmd_benchmark,
        "benchmark-conv": cmd_benchmark_conv,
        "generate": cmd_generate,
    }[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
