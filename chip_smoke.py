#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``smolscale_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):

1. Device: a CUDA device is required; prints the card's name and power
   limit (nvidia-smi), the torch and CUDA versions.
2. Build: compiles the CUDA kernels from ``smolscale_tpu_torch/csrc`` into
   ``build/kernels/`` (one nvcc per source, all at once) and prints the
   build time and ptxas's report.
3. Kernels against their plain versions, on the card for a batch of 2: the
   box kernel on each plan of ``CHECK_PLANS`` (plain version
   ``ops.box.box_scale_ref``), the general kernel on each plan of
   ``BILINEAR_CHECK_PLANS`` and each row range of ``BILINEAR_CHECK_ROWS``
   (``ops.bilinear.bilinear_scale_ref``), the deep box kernel on each plan
   of ``DEEP_CHECK_PLANS`` (one of them also on a constant-255 batch) and
   each row range of ``DEEP_CHECK_ROWS`` (``ops.deep.deep_scale_ref``), the
   128bpp kernel on each plan of ``WIDE_CHECK_PLANS`` (one of them also on
   a constant-255 batch) and each row range of ``WIDE_CHECK_ROWS``
   (``ops.bilinear128.bilinear128_scale_ref``), and all four on an input
   that is not 4-byte aligned.  Bytes must be equal.  The plain versions
   are held against the numpy spec (``backends/numpy_ref`` of the JAX
   package) and the Pallas kernels on the CPU by
   ``tests/test_torch_box.py``, ``tests/test_torch_bilinear.py``,
   ``tests/test_torch_deep.py`` and ``tests/test_torch_bilinear128.py``;
   this script imports nothing of the JAX package.
4. Main paths at the suite rows' full published sizes
   (``benchmarks/suite.py``), each with its kernel's launch counter set to
   0 just before and read just after: ``smolscale_tpu_torch.scale`` on rows
   0, 3e and 8 (box kernel, batch 8 of 4096^2 RGBA); then on rows 1, 1b, 2,
   3a, 3b, 3c and 3d, and ``scale_streamed`` on row 4 in 16 chunks
   (general kernel); then on rows 7b, 9, 9b, 9c and 9d, and
   ``scale_streamed`` on row 9 in 4 chunks (deep box kernel); then on rows
   6, 6b and 7, and ``scale_streamed`` on row 7 in 4 chunks (128bpp
   kernel).  Every image's bytes must equal the plain version.
5. Times: kernel and plain version by CUDA events, in turns plain, kernel,
   kernel, plain; Mpix/s and GB/s of input (and of output) with the share
   of HBM peak.  Also the rows of ``EXTRA_ROWS``, on no suite row and
   checked against the plain version first: RGB24 4096^2 -> 256^2 (the box
   kernel's 24bpp form), COPY x COPY 1024^2 (the general kernel's cost per
   output pixel without filtering, beside row 2) and row 0 on the general
   kernel (beside the box kernel).
6. Device busy share over 10 back-to-back ``scale`` calls per row of
   ``BUSY_ROWS``, from a ``torch.profiler`` trace (written to
   ``build/traces/``); then the same calls unprofiled: host enqueue time
   per call, and the share of an event-pair window that the kernel's
   phase-5 time fills.

All inputs are views of one random 512 MiB tensor made from a seed.  The
line before the last is a JSON object describing each kernel; the last line
is ``{"ok": true, "device": {...}}``.  Nothing here imports JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

# (w_in, h_in, w_out, h_out, type_in, type_out); with_srgb is False
CHECK_PLANS = [
    (256, 128, 16, 8, 0, 0),       # 16:1 both axes
    (384, 256, 3, 2, 0, 1),        # deep ratio, format reorder
    (512, 512, 4, 4, 2, 3),        # ARGB -> ABGR
    (1280, 640, 128, 64, 1, 1),    # 10:1
    (4096, 128, 256, 8, 0, 0),     # 16:1, wide
    (3840, 120, 384, 12, 2, 3),    # 10:1 + reorder
    (256, 128, 16, 8, 8, 8),       # RGB24 -> RGB24
    (384, 256, 3, 2, 9, 9),        # BGR24 deep ratio
    (512, 512, 4, 4, 8, 0),        # RGB24 -> RGBA
    (256, 128, 16, 8, 8, 4),       # RGB24 -> unassociated RGBA
    (1280, 640, 128, 64, 4, 0),    # unassociated in -> premultiplied
    (256, 128, 16, 8, 0, 4),       # premultiplied -> unassociated out
    (256, 128, 16, 8, 0, 8),       # RGBA -> RGB24 (4 bytes in, 3 out)
    (256, 128, 16, 8, 4, 9),       # unassociated RGBA -> BGR24
    (4096, 4096, 4096, 256, 0, 0), # COPY x box strip
    (256, 128, 16, 128, 0, 0),     # box x COPY
    (384, 64, 3, 64, 1, 1),        # deep box x COPY
    (256, 60, 256, 6, 1, 0),       # COPY x box 10:1
    (100, 90, 10, 9, 0, 0),        # width not a multiple of 128
    (99, 200, 9, 20, 5, 3),        # odd sizes, unassociated in
]

# the plan lists of tests/test_pallas_bilinear.py (:21-44, :65-71, :85-91,
# :189-196) and its 24bpp plans (:104-111, :138-148) that are not integer
# box; tests/test_torch_bilinear.py holds the plain version against numpy_ref
# and the Pallas kernel on each
BILINEAR_CHECK_PLANS = [
    (512, 512, 1024, 1024, 5, 0),  # 0h upscale, unassociated in
    (300, 200, 290, 190, 0, 0),    # 0h mild downscale, odd sizes
    (512, 256, 96, 56, 0, 1),      # 2h ladder + reorder
    (700, 500, 123, 77, 2, 3),     # 2h, tails on both axes
    (64, 64, 16, 16, 0, 0),        # 1h
    (1024, 512, 128, 64, 0, 0),    # uniform 2h ladder
    (1024, 512, 128, 64, 4, 0),    # same, unassociated in
    (1000, 512, 100, 64, 0, 0),    # box H x ladder V
    (640, 300, 64, 100, 0, 0),     # box H x bilinear V
    (1000, 500, 100, 500, 0, 0),   # box H x COPY V
    (512, 1000, 512, 100, 0, 1),   # COPY H x box V
    (555, 300, 55, 300, 2, 0),     # non-integer box H x COPY V
    (700, 1, 123, 9, 0, 0),        # ladder H x ONE V
    (1, 700, 9, 123, 4, 0),        # ONE H x ladder V
    (512, 700, 512, 123, 0, 3),    # COPY H x ladder V
    (300, 260, 300, 260, 5, 2),    # COPY x COPY
    (1, 1, 64, 32, 0, 0),          # ONE x ONE
    (512, 256, 96, 56, 0, 4),      # premul -> unassociated out
    (512, 512, 1024, 768, 1, 6),   # 0h upscale, unassociated out
    (1100, 300, 80, 100, 3, 5),    # box H x bilinear V, unassociated out
    (1100, 300, 80, 100, 0, 0),    # box H 13.75:1 x bilinear V
    (300, 1100, 100, 80, 4, 1),    # bilinear H x box V
    (1100, 1100, 80, 80, 0, 0),    # non-integer box x box
    (1100, 990, 80, 110, 4, 1),    # box x box, mixed ratios
    (700, 700, 50, 50, 0, 4),      # box x box, unassociated out
    (512, 256, 96, 56, 8, 8),      # RGB24 -> RGB24
    (512, 256, 96, 56, 8, 0),      # RGB24 -> RGBA
    (300, 200, 290, 190, 0, 8),    # RGBA -> RGB24
    (512, 256, 96, 56, 9, 9),      # BGR24 -> BGR24
    (640, 300, 80, 110, 8, 8),     # RGB24 box x box
    (512, 300, 512, 60, 8, 9),     # RGB24 COPY H x box V
    (512, 256, 96, 56, 8, 4),      # RGB24 -> unassociated RGBA
    (333, 200, 330, 190, 8, 8),    # RGB24 0h, ragged width
]
# (plan, first output row, rows) through the row form
BILINEAR_CHECK_ROWS = [
    ((1024, 512, 128, 64, 0, 0), 16, 8),
    ((1024, 512, 128, 64, 0, 0), 61, 3),
    ((512, 500, 96, 50, 0, 0), 13, 17),
    ((512, 256, 96, 56, 0, 4), 10, 30),
    ((512, 512, 1024, 1024, 5, 0), 100, 200),
    ((512, 700, 512, 123, 0, 3), 40, 50),
]

# the three plan lists of tests/test_pallas_deep.py (:21-36, :50-71, :86-98),
# two plans whose sums pass 16 and 32 bits and four with spans shorter than
# a warp: (w_in, h_in, w_out, h_out, type_in, type_out, with_srgb);
# tests/test_torch_deep.py holds the plain version against numpy_ref on each
DEEP_CHECK_PLANS = [
    (1024, 1024, 8, 8, 0, 0, False),    # 128:1, 64bpp
    (2048, 2048, 8, 8, 0, 0, False),    # 256:1, 128bpp PREMUL8
    (2048, 2048, 8, 8, 4, 4, False),    # 256:1, PREMUL16
    (2048, 2048, 8, 8, 4, 0, False),    # unassociated in -> premultiplied
    (2048, 1024, 8, 8, 1, 6, False),    # reorders, 256:1 x 128:1
    (1024, 4096, 8, 4, 0, 0, False),    # 1024 rows per span
    (1024, 4096, 8, 4, 4, 4, False),    # same, PREMUL16
    (1024, 3072, 8, 4, 4, 0, False),    # 768 rows per span
    (2000, 2000, 12, 12, 0, 0, False),  # ragged spans, 166.7:1
    (2000, 2000, 12, 12, 4, 4, False),  # ragged PREMUL16
    (1000, 900, 9, 10, 4, 0, False),    # ragged 64bpp, unassociated in
    (513, 700, 5, 7, 2, 3, False),      # ragged, odd sizes, reorders
    (1024, 1024, 8, 8, 4, 4, True),     # PREMUL16 linear light
    (1024, 1024, 8, 8, 4, 0, True),     # PREMUL8 linear, unassociated in
    (1024, 1024, 8, 8, 0, 0, True),     # PREMUL8 linear, premultiplied in
    (1000, 900, 9, 10, 4, 4, True),     # ragged PREMUL16 linear
    (1198, 475, 13, 2, 0, 9, True),     # 24bpp out: the pack asymmetry
    (1198, 900, 5, 7, 8, 4, True),      # 24bpp in
    (1842, 1538, 10, 15, 0, 0, True),   # a span ending on a TPU chunk edge
    (3516, 745, 54, 6, 9, 8, True),     # 3 * w_out > 128, linear
    (2816, 480, 48, 4, 4, 4, True),     # same, PREMUL16
    (1024, 1024, 8, 8, 8, 8, False),    # RGB24
    (1024, 1024, 8, 8, 9, 0, False),    # BGR24 -> RGBA
    (2000, 2000, 12, 12, 8, 8, False),  # ragged RGB24
    (2000, 2000, 12, 12, 8, 4, False),  # ragged RGB24 -> unassociated
    (258, 732, 2, 5, 8, 8, False),      # spans shorter than a TPU chunk
    (1024, 1024, 8, 8, 8, 8, True),     # RGB24 linear, pack24 direct
    (1198, 900, 5, 7, 8, 4, True),      # RGB24 linear -> unassociated
    (258, 732, 2, 5, 8, 8, True),       # short spans, linear
    (10000, 64, 2, 2, 4, 4, True),      # H sums past 2^31; 16-bit mask
    (5000, 5000, 2, 40, 0, 0, False),   # 2500:1 x 125:1 at 128bpp
    (256, 256, 16, 16, 4, 4, False),    # short spans: 16:1 PREMUL16
    (256, 256, 16, 16, 0, 0, True),     # 16:1 linear light
    (300, 200, 30, 20, 4, 4, True),     # 10:1 PREMUL16 linear, 11-row spans
    (99, 200, 9, 20, 8, 4, True),       # 11:1 x 10:1 RGB24 linear -> unassociated
]
# checked on a constant-255 batch too: numpy_ref gives (97, 97, 97, 255)
DEEP_CONST_PLAN = (10000, 64, 2, 2, 4, 4, True)
# (plan, first output row, rows) through the row form
DEEP_CHECK_ROWS = [
    ((1842, 1538, 10, 15, 0, 0, True), 5, 3),  # from the span starting on row 512
    ((1842, 1538, 10, 15, 0, 0, True), 4, 1),  # the span ending on row 512
    ((2000, 2000, 12, 12, 4, 4, False), 3, 6),
    ((1024, 4096, 8, 4, 0, 0, False), 1, 2),
    ((3516, 745, 54, 6, 9, 8, True), 0, 1),
    ((2048, 1024, 8, 8, 1, 6, False), 7, 1),   # the last row
]

# the plan lists of tests/test_pallas_128.py (:25-35) and
# tests/test_pallas_srgb.py (:24-33, :58-63 at 512x256 -> 96x56, :82-86),
# the low-alpha plan of test_pallas_128.py:55 and two box x box plans with
# one output column past 255:1; tests/test_torch_bilinear128.py holds the
# plain version against numpy_ref and the Pallas kernels #10-#12 on each
WIDE_CHECK_PLANS = [
    (512, 256, 96, 56, 4, 4, False),    # PREMUL16, 2h ladder both axes
    (512, 256, 96, 56, 5, 6, False),    # PREMUL16, reorders
    (256, 256, 200, 190, 7, 4, False),  # PREMUL16, 0h
    (1100, 300, 80, 100, 4, 5, False),  # PREMUL16, box H x bilinear V
    (900, 1100, 70, 90, 6, 7, False),   # PREMUL16, non-integer box x box
    (600, 2, 2, 1, 4, 4, False),        # PREMUL16 300:1 box x bilinear
    (520, 300, 2, 40, 0, 0, False),     # 260:1 box H -> S128 PREMUL8
    (16, 600, 8, 2, 4, 0, False),       # 300:1 box V, unassociated in
    (300, 280, 1, 1, 0, 4, False),      # box x box to 1x1
    (1024, 512, 128, 64, 4, 4, False),  # uniform 2h ladder
    (2048, 160, 8, 16, 4, 4, False),    # 256:1 box H, 10:1 box V
    (512, 256, 96, 56, 4, 4, True),     # PREMUL16-linear, 2h ladder
    (512, 256, 96, 56, 4, 0, True),     # PREMUL8-linear, unassociated in
    (512, 256, 96, 56, 0, 0, True),     # PREMUL8-linear, premultiplied in
    (512, 256, 96, 56, 2, 5, True),     # premultiplied in -> unassociated out
    (256, 256, 200, 190, 5, 6, True),   # 0h, reorders
    (1100, 300, 80, 100, 4, 4, True),   # box H x bilinear V
    (1024, 512, 128, 64, 4, 4, True),   # uniform 2h ladder
    (1024, 512, 128, 64, 0, 0, True),   # uniform ladder, premultiplied in
    (1024, 300, 128, 30, 8, 8, True),   # 24bpp, ladder H x 10:1 box V
    (1000, 1024, 100, 128, 4, 4, True),  # box H x ladder V
    (512, 256, 96, 56, 8, 8, True),     # RGB24 -> RGB24: pack24 direct
    (512, 256, 96, 56, 8, 9, True),     # RGB24 -> BGR24: unpremultiplied
    (512, 256, 96, 56, 0, 8, True),     # 4 bytes in, 3 out
    (512, 256, 96, 56, 4, 9, True),
    (512, 256, 96, 56, 8, 4, True),     # 24bpp -> unassociated (PREMUL16)
    (512, 256, 96, 56, 9, 0, True),
    (512, 256, 96, 56, 9, 9, True),     # the planes feed's plans (kernel #12)
    (1024, 300, 128, 30, 8, 0, True),
    (333, 200, 111, 40, 8, 8, True),    # ragged, box V
    (64, 64, 32, 32, 4, 4, False),      # low alpha (PREMUL16's reason)
    (2000, 400, 1, 20, 0, 0, False),    # box x box, one column, 2000:1
    (2000, 400, 1, 20, 4, 4, True),     # same, PREMUL16-linear
]
# checked on a constant-255 batch too: numpy_ref gives (97, 97, 97, 255)
WIDE_CONST_PLAN = (1100, 300, 80, 100, 4, 4, True)
# (plan, first output row, rows) through the row form
WIDE_CHECK_ROWS = [
    ((512, 256, 96, 56, 4, 4, True), 10, 20),
    ((1024, 512, 128, 64, 4, 4, False), 61, 3),
    ((1100, 300, 80, 100, 4, 4, True), 0, 1),
    ((16, 600, 8, 2, 4, 0, False), 1, 1),
    ((2000, 400, 1, 20, 0, 0, False), 5, 7),
    ((1024, 300, 128, 30, 8, 8, True), 29, 1),
]

# suite rows (benchmarks/suite.py:277-346) at their published sizes:
# (name, plan key, batch); box kernel
MAIN_ROWS = [
    ("row 0", (4096, 4096, 256, 256, 0, 0), 8),
    ("row 3e", (4096, 4096, 256, 256, 0, 4), 8),
    ("row 8", (4096, 4096, 4096, 256, 0, 0), 8),
]
# general kernel
BILINEAR_ROWS = [
    ("row 1", (2048, 2048, 256, 256, 0, 0), 1),
    ("row 1b", (2048, 2048, 256, 256, 0, 0), 32),
    ("row 2", (512, 512, 1024, 1024, 5, 0), 8),
    ("row 3a", (4096, 4096, 1371, 1371, 8, 8), 4),
    ("row 3b", (4096, 4096, 3000, 3000, 8, 8), 2),
    ("row 3c", (4096, 4096, 700, 700, 0, 0), 4),
    ("row 3d", (4096, 4096, 300, 300, 0, 0), 8),
]
# row 4 (bench_row_stream, suite.py:353): scale_streamed in 16 chunks
STREAM_ROW = ("row 4", (8192, 8192, 1024, 1024, 0, 0), 1)
STREAM_CHUNKS = 16
# deep box kernel (suite.py:325-346), and row 9 through scale_streamed
DEEP_ROWS = [
    ("row 7b", (4096, 4096, 16, 16, 0, 0), 8),
    ("row 9", (4096, 4096, 12, 12, 0, 0), 8),
    ("row 9b", (2048, 2048, 12, 12, 4, 4), 8),
    ("row 9c", (2000, 2000, 7, 7, 0, 0, True), 8),
    ("row 9d", (3000, 3000, 9, 9, 8, 8), 8),
]
DEEP_STREAM_ROW, DEEP_STREAM_CHUNKS = "row 9", 4
# 128bpp kernel (suite.py:314-324), and row 7 through scale_streamed
WIDE_ROWS = [
    ("row 6", (2048, 2048, 256, 256, 4, 4, True), 8),
    ("row 6b", (1920, 1080, 400, 225, 8, 8, True), 8),
    ("row 7", (2048, 2048, 256, 256, 4, 4, False), 8),
]
WIDE_STREAM_ROW, WIDE_STREAM_CHUNKS = "row 7", 4
# on no suite row, checked and timed beside them: (name, plan key, batch,
# kernel)
EXTRA_ROWS = [
    # the box kernel's 24bpp form (TPU kernel #2, pallas_box.py:455)
    ("rgb24", (4096, 4096, 256, 256, 8, 8), 8, "box"),
    # COPY x COPY at row 2's output size: the general kernel's cost per
    # output pixel without filtering
    ("copy", (1024, 1024, 1024, 1024, 0, 0), 8, "bilinear"),
    # the headline on the general kernel, beside the box kernel's row 0
    ("row 0 on bilinear", (4096, 4096, 256, 256, 0, 0), 8, "bilinear"),
]
BUSY_ROWS = ["row 0", "row 3e", "row 8", "rgb24", "row 1b", "row 3d", "row 7b", "row 9c",
             "row 6"]
HBM_PEAK_GBS = 3350.0  # H100 SXM data sheet, at the 700 W power limit


def log(*a):
    print(*a, flush=True)


def gpu_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def max_abs_err(a, b) -> int:
    return int((a.short() - b.short()).abs().max())


def view_input(x, plan, batch):
    """(batch, h_in, w_in, nb_in) uint8 over the first bytes of ``x``."""
    shape = (batch, plan.height_in, plan.width_in, plan.meta_in.n_bytes)
    return x.view(-1)[: int(np.prod(shape))].view(shape)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1

    import smolscale_tpu_torch as stt
    from smolscale_tpu_torch.ops import _build, bilinear, bilinear128, box, deep
    from smolscale_tpu_torch.utils.timing import cuda_time_ms, device_busy

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = gpu_line()

    # 1. device
    log(f"[device] {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    log(card)

    # 2. build
    lib_path, build_log, secs = _build.build()
    _build.library()
    log(f"[build] {lib_path} in {secs:.1f} s")
    for line in build_log.splitlines():
        if "registers" in line or "spill" in line or "error" in line.lower():
            log(f"[build] {line.strip()}")

    # 3. kernels against their plain versions
    err = {"box": 0, "bilinear": 0, "deep": 0, "bilinear128": 0}

    def check(kind, label, got, plain):
        torch.cuda.synchronize()
        e = max_abs_err(got, plain)
        err[kind] = max(err[kind], e)
        if not torch.equal(got, plain):
            raise AssertionError(f"{label}: {kind} kernel differs from plain version "
                                 f"(max abs err {e})")
        log(f"[check] {kind} {label}: kernel == plain, shape {tuple(got.shape)}")

    def random_images(key, seed):
        nb = stt.get_meta(key[4]).n_bytes
        rng = np.random.default_rng(seed)
        return torch.from_numpy(rng.integers(0, 256, (2, key[1], key[0], nb),
                                             dtype=np.uint8)).to(dev)

    def plan_of(key):
        return stt.ScalePlan(*key) if len(key) == 7 else stt.ScalePlan(*key, False)

    for i, key in enumerate(CHECK_PLANS):
        plan = stt.ScalePlan(*key, False)
        if not box.applicable(plan):
            raise AssertionError(f"{key}: outside the box class")
        x = random_images(key, 1000 + i)
        check("box", key, box.scale_fn(plan, x), box.box_scale_ref(plan, x))
    for i, key in enumerate(BILINEAR_CHECK_PLANS):
        plan = stt.ScalePlan(*key, False)
        if not bilinear.applicable(plan):
            raise AssertionError(f"{key}: outside the bilinear class")
        x = random_images(key, 2000 + i)
        check("bilinear", key, bilinear.scale_fn(plan, x), bilinear.bilinear_scale_ref(plan, x))
    for i, (key, first, n) in enumerate(BILINEAR_CHECK_ROWS):
        plan = stt.ScalePlan(*key, False)
        x = random_images(key, 3000 + i)
        check("bilinear", f"{key} rows [{first}, {first + n})",
              bilinear.scale_rows_fn(plan, x, first, n),
              bilinear.bilinear_scale_ref(plan, x, first, n))
    for i, key in enumerate(DEEP_CHECK_PLANS):
        plan = stt.ScalePlan(*key)
        if not deep.applicable(plan):
            raise AssertionError(f"{key}: outside the deep box class")
        x = random_images(key, 4000 + i)
        check("deep", key, deep.scale_fn(plan, x), deep.deep_scale_ref(plan, x))
    plan = stt.ScalePlan(*DEEP_CONST_PLAN)
    x = torch.full((2, plan.height_in, plan.width_in, 4), 255, dtype=torch.uint8, device=dev)
    got = deep.scale_fn(plan, x)
    check("deep", f"{DEEP_CONST_PLAN} constant 255", got, deep.deep_scale_ref(plan, x))
    log(f"[check] deep {DEEP_CONST_PLAN} constant 255: pixel (0, 0) {got[0, 0, 0].tolist()}")
    for i, (key, first, n) in enumerate(DEEP_CHECK_ROWS):
        plan = stt.ScalePlan(*key)
        x = random_images(key, 5000 + i)
        check("deep", f"{key} rows [{first}, {first + n})",
              deep.scale_rows_fn(plan, x, first, n), deep.deep_scale_ref(plan, x, first, n))
    for i, key in enumerate(WIDE_CHECK_PLANS):
        plan = stt.ScalePlan(*key)
        if not bilinear128.applicable(plan):
            raise AssertionError(f"{key}: outside the 128bpp class")
        x = random_images(key, 6000 + i)
        check("bilinear128", key, bilinear128.scale_fn(plan, x),
              bilinear128.bilinear128_scale_ref(plan, x))
    plan = stt.ScalePlan(*WIDE_CONST_PLAN)
    x = torch.full((2, plan.height_in, plan.width_in, 4), 255, dtype=torch.uint8, device=dev)
    got = bilinear128.scale_fn(plan, x)
    check("bilinear128", f"{WIDE_CONST_PLAN} constant 255", got,
          bilinear128.bilinear128_scale_ref(plan, x))
    log(f"[check] bilinear128 {WIDE_CONST_PLAN} constant 255: pixel (0, 0) "
        f"{got[0, 0, 0].tolist()}")
    for i, (key, first, n) in enumerate(WIDE_CHECK_ROWS):
        plan = stt.ScalePlan(*key)
        x = random_images(key, 6500 + i)
        check("bilinear128", f"{key} rows [{first}, {first + n})",
              bilinear128.scale_rows_fn(plan, x, first, n),
              bilinear128.bilinear128_scale_ref(plan, x, first, n))
    # a 4-byte input that is not 4-byte aligned takes the byte-load paths
    for kind, mod, plain, key in (
        ("box", box, box.box_scale_ref, CHECK_PLANS[0]),
        ("bilinear", bilinear, bilinear.bilinear_scale_ref, BILINEAR_CHECK_PLANS[3]),
        ("deep", deep, deep.deep_scale_ref, DEEP_CHECK_PLANS[2]),
        ("bilinear128", bilinear128, bilinear128.bilinear128_scale_ref, WIDE_CHECK_PLANS[11]),
    ):
        plan = plan_of(key)
        imgs = random_images(key, 7)
        flat = torch.empty(imgs.numel() + 1, dtype=torch.uint8, device=dev)
        shifted = flat[1:].view(imgs.shape)
        shifted.copy_(imgs)
        check(kind, f"{key} unaligned", mod.scale_fn(plan, shifted), plain(plan, imgs))

    # 4. main paths at full size
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(0, 256, (8, 4096, 4096, 4), dtype=np.uint8)).to(dev)
    torch.cuda.synchronize()
    log(f"[main] input {tuple(x.shape)} uint8 ({x.numel() / 2**20:.0f} MiB) "
        f"made and uploaded in {time.perf_counter() - t0:.1f} s")
    all_rows = (MAIN_ROWS + BILINEAR_ROWS + [STREAM_ROW] + DEEP_ROWS + WIDE_ROWS
                + [r[:3] for r in EXTRA_ROWS])
    plans = {name: plan_of(key) for name, key, _ in all_rows}
    inputs = {name: view_input(x, plans[name], batch) for name, _, batch in all_rows}
    kernels = {"box": (box.scale_fn, box.box_scale_ref),
               "bilinear": (bilinear.scale_fn, bilinear.bilinear_scale_ref),
               "deep": (deep.scale_fn, deep.deep_scale_ref),
               "bilinear128": (bilinear128.scale_fn, bilinear128.bilinear128_scale_ref)}

    def check_rows(kind, rows, outs, plain_fn):
        for name, _, batch in rows:
            plan, out = plans[name], outs[name]
            expect = (batch, plan.height_out, plan.width_out, plan.meta_out.n_bytes)
            if tuple(out.shape) != expect or out.dtype != torch.uint8 or out.device != dev:
                raise AssertionError(f"{name}: got {tuple(out.shape)} {out.dtype} on {out.device}")
            check(kind, f"{name} {plan.key} ({batch} images)", out, plain_fn(plan, inputs[name]))

    box.launches = 0
    outs = {name: stt.scale(plans[name], inputs[name]) for name, _, _ in MAIN_ROWS}
    torch.cuda.synchronize()
    box_launches = box.launches
    log(f"[main] box kernel launches in the box rows' main path: {box_launches}")
    if box_launches < len(MAIN_ROWS):
        raise AssertionError("the main path did not launch the box kernel for every row")
    check_rows("box", MAIN_ROWS, outs, box.box_scale_ref)

    stream_name = STREAM_ROW[0]
    bilinear.launches = 0
    outs = {name: stt.scale(plans[name], inputs[name]) for name, _, _ in BILINEAR_ROWS}
    chunks = list(stt.scale_streamed(plans[stream_name], inputs[stream_name],
                                     n_chunks=STREAM_CHUNKS))
    torch.cuda.synchronize()
    bilinear_launches = bilinear.launches
    log(f"[main] bilinear kernel launches in the general rows' main path: "
        f"{bilinear_launches} ({len(BILINEAR_ROWS)} rows + {len(chunks)} chunks of "
        f"{stream_name})")
    if bilinear_launches != len(BILINEAR_ROWS) + STREAM_CHUNKS or len(chunks) != STREAM_CHUNKS:
        raise AssertionError("the main path did not launch the bilinear kernel once per "
                             "row and once per chunk")
    firsts = [f for f, _ in chunks]
    step = -(-plans[stream_name].height_out // STREAM_CHUNKS)
    if firsts != list(range(0, plans[stream_name].height_out, step)):
        raise AssertionError(f"{stream_name}: chunks start at {firsts}")
    outs[stream_name] = torch.cat([chunk for _, chunk in chunks], dim=1)
    del chunks
    check_rows("bilinear", BILINEAR_ROWS + [STREAM_ROW], outs, bilinear.bilinear_scale_ref)
    del outs

    deep.launches = 0
    outs = {name: stt.scale(plans[name], inputs[name]) for name, _, _ in DEEP_ROWS}
    chunks = list(stt.scale_streamed(plans[DEEP_STREAM_ROW], inputs[DEEP_STREAM_ROW],
                                     n_chunks=DEEP_STREAM_CHUNKS))
    torch.cuda.synchronize()
    deep_launches = deep.launches
    log(f"[main] deep box kernel launches in the deep rows' main path: {deep_launches} "
        f"({len(DEEP_ROWS)} rows + {len(chunks)} chunks of {DEEP_STREAM_ROW})")
    if deep_launches != len(DEEP_ROWS) + DEEP_STREAM_CHUNKS or len(chunks) != DEEP_STREAM_CHUNKS:
        raise AssertionError("the main path did not launch the deep box kernel once per "
                             "row and once per chunk")
    check_rows("deep", DEEP_ROWS, outs, deep.deep_scale_ref)
    plan = plans[DEEP_STREAM_ROW]
    step = -(-plan.height_out // DEEP_STREAM_CHUNKS)
    if [f for f, _ in chunks] != list(range(0, plan.height_out, step)):
        raise AssertionError(f"{DEEP_STREAM_ROW}: chunks start at {[f for f, _ in chunks]}")
    check("deep", f"{DEEP_STREAM_ROW} in {DEEP_STREAM_CHUNKS} chunks",
          torch.cat([chunk for _, chunk in chunks], dim=1),
          deep.deep_scale_ref(plan, inputs[DEEP_STREAM_ROW]))
    del outs, chunks

    bilinear128.launches = 0
    outs = {name: stt.scale(plans[name], inputs[name]) for name, _, _ in WIDE_ROWS}
    chunks = list(stt.scale_streamed(plans[WIDE_STREAM_ROW], inputs[WIDE_STREAM_ROW],
                                     n_chunks=WIDE_STREAM_CHUNKS))
    torch.cuda.synchronize()
    wide_launches = bilinear128.launches
    log(f"[main] 128bpp kernel launches in the 128bpp rows' main path: {wide_launches} "
        f"({len(WIDE_ROWS)} rows + {len(chunks)} chunks of {WIDE_STREAM_ROW})")
    if wide_launches != len(WIDE_ROWS) + WIDE_STREAM_CHUNKS or len(chunks) != WIDE_STREAM_CHUNKS:
        raise AssertionError("the main path did not launch the 128bpp kernel once per "
                             "row and once per chunk")
    check_rows("bilinear128", WIDE_ROWS, outs, bilinear128.bilinear128_scale_ref)
    plan = plans[WIDE_STREAM_ROW]
    step = -(-plan.height_out // WIDE_STREAM_CHUNKS)
    if [f for f, _ in chunks] != list(range(0, plan.height_out, step)):
        raise AssertionError(f"{WIDE_STREAM_ROW}: chunks start at {[f for f, _ in chunks]}")
    check("bilinear128", f"{WIDE_STREAM_ROW} in {WIDE_STREAM_CHUNKS} chunks",
          torch.cat([chunk for _, chunk in chunks], dim=1),
          bilinear128.bilinear128_scale_ref(plan, inputs[WIDE_STREAM_ROW]))
    del outs, chunks

    for name, _, batch, kind in EXTRA_ROWS:
        kernel_fn, plain_fn = kernels[kind]
        check(kind, f"{name} {plans[name].key} ({batch} images)",
              kernel_fn(plans[name], inputs[name]), plain_fn(plans[name], inputs[name]))

    # 5. times (turns: plain, kernel, kernel, plain)
    def stream_kernel(plan, xin):
        step = -(-plan.height_out // STREAM_CHUNKS)
        for first in range(0, plan.height_out, step):
            bilinear.scale_rows_fn(plan, xin, first, min(step, plan.height_out - first))

    timed = [(row, *kernels["box"]) for row in MAIN_ROWS]
    timed += [(row, *kernels["bilinear"]) for row in BILINEAR_ROWS]
    timed += [(STREAM_ROW, stream_kernel, bilinear.bilinear_scale_ref)]
    timed += [(row, *kernels["deep"]) for row in DEEP_ROWS]
    timed += [(row, *kernels["bilinear128"]) for row in WIDE_ROWS]
    timed += [(row[:3], *kernels[row[3]]) for row in EXTRA_ROWS]
    times = {}
    for (name, _, batch), kernel_fn, plain_fn in timed:
        plan, xin = plans[name], inputs[name]
        p1 = cuda_time_ms(lambda: plain_fn(plan, xin), warmup=1, iters=5)
        k1 = cuda_time_ms(lambda: kernel_fn(plan, xin))
        k2 = cuda_time_ms(lambda: kernel_fn(plan, xin))
        p2 = cuda_time_ms(lambda: plain_fn(plan, xin), warmup=1, iters=5)
        k_ms, p_ms = (k1 + k2) / 2, (p1 + p2) / 2
        times[name] = (k_ms, p_ms)
        pix = batch * plan.height_in * plan.width_in
        in_bytes = pix * plan.meta_in.n_bytes
        out_bytes = batch * plan.height_out * plan.width_out * plan.meta_out.n_bytes
        for label, ms, turns in (("kernel", k_ms, (k1, k2)), ("plain", p_ms, (p1, p2))):
            sec = ms / 1e3
            in_gbs, out_gbs = in_bytes / 1e9 / sec, out_bytes / 1e9 / sec
            log(f"[time] {name} {label}: {ms:.4f} ms (turns {turns[0]:.4f}, "
                f"{turns[1]:.4f}), {pix / 1e6 / sec:.1f} Mpix/s, {in_gbs:.1f} GB/s of "
                f"input ({100 * in_gbs / HBM_PEAK_GBS:.1f}% of {HBM_PEAK_GBS:.0f} GB/s), "
                f"{out_gbs:.1f} GB/s of output (in + out "
                f"{100 * (in_gbs + out_gbs) / HBM_PEAK_GBS:.1f}%), on {card}")

    # 6. device busy share over back-to-back calls of the public entry point
    trace_dir = Path(__file__).resolve().parent / "build" / "traces"
    trace_dir.mkdir(parents=True, exist_ok=True)
    for name in BUSY_ROWS:
        plan, xin = plans[name], inputs[name]
        busy = device_busy(lambda: stt.scale(plan, xin),
                           str(trace_dir / f"{name.replace(' ', '_')}.json"))
        kernels = "; ".join(f"{k} x{c} mean {ms:.4f} ms"
                            for k, (c, ms) in busy["kernels"].items())
        log(f"[busy] {name}: device busy {100 * busy['busy_share']:.1f}% of a "
            f"{busy['window_ms']:.4f} ms window of 10 calls ({kernels}), on {card}")
        # the same 10 calls without the profiler: host clock for the enqueue,
        # an event pair for the device window
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for _ in range(10):
            stt.scale(plan, xin)
        end.record()
        host_ms = (time.perf_counter() - t0) * 1e3 / 10
        torch.cuda.synchronize()
        window = start.elapsed_time(end)
        log(f"[busy] {name} unprofiled: host {host_ms:.4f} ms per call to enqueue; "
            f"event window {window:.4f} ms for 10 calls, so the kernel's "
            f"{times[name][0]:.4f} ms x10 fills {100 * 10 * times[name][0] / window:.1f}% "
            f"of it, on {card}")

    if "jax" in sys.modules:
        raise AssertionError("jax was imported")

    log(f"[total] {time.perf_counter() - t_start:.1f} s wall, build included")
    log(card)
    log(json.dumps({"kernels": [
        {
            "name": "box_scale",
            "route": "cuda",
            "source": "smolscale_tpu_torch/csrc/box.cu",
            "replaces": "smolscale_tpu/ops/pallas_box.py:150",
            "launches": box_launches,
            "max_abs_err": err["box"],
            "ms": times["row 0"][0],
            "plain_ms": times["row 0"][1],
        },
        {
            "name": "bilinear_scale",
            "route": "cuda",
            "source": "smolscale_tpu_torch/csrc/bilinear.cu",
            "replaces": "smolscale_tpu/ops/pallas_bilinear.py:1482",
            "launches": bilinear_launches,
            "max_abs_err": err["bilinear"],
            "ms": times["row 1b"][0],
            "plain_ms": times["row 1b"][1],
        },
        {
            "name": "deep_box",
            "route": "cuda",
            "source": "smolscale_tpu_torch/csrc/deep.cu",
            "replaces": "smolscale_tpu/ops/pallas_deep.py:238,469,911",
            "launches": deep_launches,
            "max_abs_err": err["deep"],
            "ms": times["row 9"][0],
            "plain_ms": times["row 9"][1],
        },
        {
            "name": "bilinear128_scale",
            "route": "cuda",
            "source": "smolscale_tpu_torch/csrc/bilinear128.cu",
            "replaces": "smolscale_tpu/ops/pallas_128.py:86; smolscale_tpu/ops/pallas_srgb.py:162,415",
            "launches": wide_launches,
            "max_abs_err": err["bilinear128"],
            "ms": times["row 6"][0],
            "plain_ms": times["row 6"][1],
        },
    ]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
