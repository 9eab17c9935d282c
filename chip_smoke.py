#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``smolscale_tpu_torch``) on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --parent CHECKOUT [CHECKOUT ...]
        # also time each CHECKOUT's box, deep, general and 128bpp kernels

Phases, each of which raises on failure (the script then exits non-zero):

1. Device: a CUDA device is required; prints the card's name and power
   limit (nvidia-smi), the torch and CUDA versions.
2. Build: compiles the CUDA kernels from ``smolscale_tpu_torch/csrc`` into
   ``build/kernels/`` (one nvcc per source, all at once) and prints the
   build time, ptxas's report and each kernel's count of template
   instances, and for each instance of the box kernel
   (``box_kernel<FORM, W, PX>``), the general kernel
   (``bilinear_kernel<KX, KY, PACKED, FORM>``: FORM 0 LOOP, 1 H TILE, 2
   ROLL; KY 4 for H TILE, which reads the V kind at run time), the 128bpp
   kernel
   (``bilinear128_kernel<KX, KY, MODE, PX, FORM>``: PX 0 word, 1 bytes, 2
   3-byte through the folded table; FORM 0 LOOP, 1 H TILE, 2 ROLL; KY 4 for
   H TILE; KX 5 for ROLL's 1-2 halving X ladders) and the deep box kernel
   (``deep_kernel<MODE, FORM, W>``) its registers, stack frame, spills and
   shared memory per block; it raises if a deep box or general kernel
   instance, or a ROLL instance of the 128bpp kernel, has a stack frame or
   spills.
3. Kernels against their plain versions, on the card for a batch of 2: the
   box kernel on each plan of ``CHECK_PLANS`` (plain version
   ``ops.box.box_scale_ref``; its tile edges, 255:1 axes and deep ratios
   among them), each plan of ``BOX_UNALIGNED`` at the byte offsets of
   ``BOX_OFFSETS``, ``BOX_TALL`` (more than 65535 output rows in the batch)
   and ``BOX_CONST_PLANS`` on a constant-255 batch, the general kernel on each plan of
   ``BILINEAR_CHECK_PLANS`` and ``DIRECT_CHECK_PLANS`` and each row range
   of ``BILINEAR_CHECK_ROWS`` and ``DIRECT_CHECK_ROWS``
   (``ops.bilinear.bilinear_scale_ref``; boxes past 64:1, the staged X
   axes' tile edges and the direct path's tile edges among them), each
   plan of ``BILINEAR_UNALIGNED`` at byte offsets 1, 2 and 3, whole and by
   rows, and ``BILINEAR_TALL`` (more than 65,535 output rows, and more than
   65,535 images), a plan on the direct path in each of its forms that fits
   (``ops.bilinear.direct_forms``), the
   deep box kernel on each plan
   of ``DEEP_CHECK_PLANS`` (one of them also on a constant-255 batch; the
   edges of ``ops.deep.launch_shape`` among them), each plan of
   ``DEEP_UNALIGNED`` at the byte offsets of ``DEEP_OFFSETS``, whole and by
   rows, ``DEEP_TALL`` (more than 65535 images) and each row range of
   ``DEEP_CHECK_ROWS`` (``ops.deep.deep_scale_ref``), the
   128bpp kernel, in each of its forms that fits (``ops.bilinear128.forms``),
   on each plan of ``WIDE_CHECK_PLANS`` (COPY and ONE axes among them; two
   of them, box beside bilinear and box beside COPY, and the 3-byte
   ``WIDE_CONST24_PLANS`` also on a constant-255 batch) and each row range
   of ``WIDE_CHECK_ROWS`` (``ops.bilinear128.bilinear128_scale_ref``; its
   tile edges among them), each plan of ``WIDE_UNALIGNED`` (3-byte ones
   among them) at byte offsets 1, 2 and 3, whole and by rows, and
   ``WIDE_TALL`` (more than 65535 output rows in the batch), all
   four on an input that is not 4-byte aligned (and the widened classes: a
   box past 64:1, COPY, ONE), the pyramid kernel on each set of ``PYRAMID_CHECK_SETS`` and the
   unaligned inputs of ``PYRAMID_UNALIGNED`` (``ops.pyramid.pyramid_scale_ref``,
   every level), and row 5's set on a transposed (not contiguous) batch
   through ``make_pyramid_fn``, against the contiguous batch.  Bytes must
   be equal.
   The plain versions are held against the numpy spec
   (``backends/numpy_ref`` of the JAX package) and the Pallas kernels on
   the CPU by ``tests/test_torch_box.py``, ``tests/test_torch_bilinear.py``,
   ``tests/test_torch_deep.py``, ``tests/test_torch_bilinear128.py`` and
   ``tests/test_torch_pyramid.py``; this script imports nothing of the JAX
   package.
4. Main paths at the suite rows' full published sizes
   (``benchmarks/suite.py``), each with its kernel's launch counter set to
   0 just before and read just after: ``smolscale_tpu_torch.scale`` on rows
   0, 3e and 8 (box kernel, batch 8 of 4096^2 RGBA); then on rows 1, 1b, 2,
   3a, 3b, 3c and 3d, and ``scale_streamed`` on row 4 in 16 chunks
   (general kernel); then on rows 7b, 9, 9b, 9c and 9d, the linear-light
   sweep's srgb box-0.06 (32 frames 3840x2160 -> 229x129), and
   ``scale_streamed`` on row 9 in 4 chunks (deep box kernel); then on rows
   6, 6b and 7 and the 3-byte video rows 6b-4k (3840x2160 -> 1920x1080)
   and 6b-up (1280x720 -> 1920x1080), ROLL's conv u-u and u-7 (64 frames
   3840x2160 -> 3839x2159 between unassociated types), 5b 256 u (192
   unassociated 512^2 images -> 256^2), the linear-light sweep's srgb
   up-2.0, down-0.6 and 1h-0.5 (32 frames 3840x2160 -> 7680x4320,
   2292x1289, 1910x1074), and ``scale_streamed`` on row 7 in 4 chunks
   (128bpp kernel); then the rows of ``A1_ROWS``, the classes that
   every plan reaching a kernel added: ``scale`` on a1-p16-copy and a1-srgb-field
   (128bpp kernel, COPY axes) and on a1-strip (general kernel, a 128:1 box
   beside a bilinear axis), ``scale_streamed`` on a1-strip-rows in 4
   chunks (general kernel by rows, COPY x a 128:1 box), and ``scale`` on
   a 128:1 x 8.5:1 box x box plan of TPU kernel #7's (deep box kernel);
   then ``make_pyramid_fn`` on row 5 (256 x 512^2 RGBA -> (64, 128, 256):
   exactly one pyramid launch, no general-kernel launch) and
   ``scale_pyramid_mixed`` on row 5b (the suite's 10,000-image fleet, 192 MiB
   sub-batches: one pyramid launch per sub-batch of the three fused groups,
   one level-kernel launch per level of the other two; the general and
   128bpp kernels' launches by form are printed).  Every image's
   bytes must equal the plain version (row 5b: one probe image per group).
5. Times: kernel and plain version by CUDA events, in turns plain, five
   kernel turns, plain, with the kernel's median and min-max (row 9 is also
   timed as its 4 chunks through the row form; with ``--parent``, each
   other checkout's box, deep box, general and 128bpp kernels in turns with
   this one's on every box, deep, general and 128bpp row; a general row on
   the direct path, and a 3-byte 128bpp row, also in each other form that
   fits it, in the same turns);
   Mpix/s and GB/s of input (and of output) with the share of HBM peak, and each row's bound (its input and
   output bytes at the HBM peak) with the kernel's share of it.  Also the
   rows of ``A1_ROWS`` and of ``EXTRA_ROWS``, on no suite row and checked against
   the plain version first: RGB24 4096^2 -> 256^2 (the box kernel's 24bpp
   form), COPY x COPY 1024^2 (the general kernel's cost per output pixel
   without filtering, beside row 2), row 0 on the general kernel (beside
   the box kernel), box-10 (a 10:1 box, the box kernel's staged form),
   box-deep (128:1 x 128:1 on split warps, and on the deep box kernel) and
   the other kinds of box x box past 64:1 that both kernels take (RGB24,
   16:1 x 128:1, 10:1 x 128:1, 128:1 x 16:1), each on both, which decide
   ``torch_ops.whole_kernel``'s route, and the general kernel's 0h V
   downscales: upstream's format-conversion benchmark (64 frames 3840x2160
   -> 3839x2159 in six byte and alpha classes) and the sweep near 0.6x.
   The copy row is timed beside ``torch.Tensor.clone``, which gives its
   bytes (COPY x COPY between identical formats is the identity; checked
   first), as its library time.  Row 5 is also timed level by level on the
   general kernel (three launches); row 5b as pyramids/s on the
   pre-uploaded fleet (resident), each group's share of a sweep, its 384^2
   group's three levels apart on the general kernel (in turns with each
   other checkout's and with each other form), and end to end through
   ``scale_pyramid_mixed`` on 2,000 of its images (cold), as
   ``benchmarks/suite.py`` reports them.
6. 10 back-to-back calls of the public entry point (``scale``;
   ``make_pyramid_fn``'s function for row 5) per row of ``BUSY_ROWS``,
   unprofiled: host enqueue time per call, and the share of an event-pair
   window that the kernel's phase-5 time fills.

7. Split over a device list (``smolscale_tpu_torch.parallel``): the counts
   set to 0, then row 0 through ``make_batched_scale`` over a mesh of every
   card and over ``cuda:0`` listed 2 and 4 times, row 4 through
   ``make_row_sharded_scale`` over 4 row shards and a plan of 3 output rows
   over 4 shards, row 6 through ``make_sharded_batch_step`` on a 2 x 2 mesh,
   row 5 through ``make_pyramid_fn(mesh=...)`` over every card and over 4
   entries, and 200 images of row 5b's fleet through
   ``scale_pyramid_mixed(mesh=...)``: each kernel launched once per shard,
   every result byte-equal to the unsplit ``scale`` on ``cuda:0`` (also
   ``dryrun_multichip`` over 4 and 16 entries).  Then row 0's host-clock
   time per call over a one-entry mesh beside the unsplit ``scale``.
8. The CLI (``smolscale_tpu_torch.cli``): ``check --colors 1`` (its default
   sweep for one colour, every case one launch of the bilinear or the
   128bpp kernel and byte-equal to the plain versions on the CPU) must
   exit 0; ``generate`` on a PNG that the port's writer made under
   ``build/cli/``, each output equal to the plain version; ``benchmark
   --steps 4 --reps 2`` and ``benchmark-conv --reps 1``, their lines
   printed.
9. The differential fuzz (``smolscale_tpu_torch.fuzz``): ``FUZZ_CASES``
   cases of every mode at fixed seeds, each through every kernel that takes
   it and the public ``scale``, held against the plain versions on the card
   (poisoned outputs, two runs each); it raises on any failure, and unless
   all five kernels launched, all three forms of the box kernel were
   reached, the deep box kernel took more than one lane count and the
   128bpp kernel ran in every one of its forms.

All inputs but row 5b's are views of one random 512 MiB tensor made from a
seed; the row 5b fleet is made on the host from seed 0 as the suite makes
it.  The line before the last is a JSON object describing each kernel (its
launches summed over the main paths of phase 4, the widened classes' rows
and row 5b's level-by-level groups included); the last line is
``{"ok": true, "device": {...}}``.
Nothing here imports JAX.
"""

from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import time
from functools import partial
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
    # the kernel's tiles (ops/box.launch_shape at batch 2) on their edges:
    # direct 16:1, warps of 8 columns (w_out 7, 8, 9) and blocks of 16
    (112, 64, 7, 4, 0, 0),
    (128, 64, 8, 4, 0, 0),
    (144, 64, 9, 4, 0, 0),
    (240, 32, 15, 2, 0, 0),
    (256, 32, 16, 2, 0, 0),
    (272, 32, 17, 2, 0, 0),
    # COPY x box: warps of 128 columns (w_out 127 and 129 are staged),
    # blocks of 256
    (124, 64, 124, 4, 0, 0),
    (127, 64, 127, 4, 0, 0),
    (128, 64, 128, 4, 0, 0),
    (129, 64, 129, 4, 0, 0),
    (132, 64, 132, 4, 0, 0),
    (252, 64, 252, 4, 0, 0),
    (256, 64, 256, 4, 0, 0),
    (260, 64, 260, 4, 0, 0),
    # staged 10:1 (40-byte spans): warps of 32 columns (16 for outputs of
    # 16 columns or fewer), blocks of 64
    (150, 40, 15, 4, 0, 0),
    (160, 40, 16, 4, 0, 0),
    (170, 40, 17, 4, 0, 0),
    (310, 40, 31, 4, 1, 0),
    (320, 40, 32, 4, 0, 0),
    (330, 40, 33, 4, 2, 3),
    (630, 40, 63, 4, 0, 0),
    (640, 40, 64, 4, 0, 0),
    (650, 40, 65, 4, 0, 0),
    # 255:1 on each axis and on both (sums of 65,025 in a 16-bit half)
    (765, 20, 3, 20, 0, 0),
    (20, 765, 20, 3, 0, 0),
    (510, 510, 2, 2, 0, 4),
    # span bytes not a multiple of 16: 3-byte 9:1 and 11:1, 4-byte 63:1
    (81, 27, 9, 3, 8, 8),
    (121, 44, 11, 4, 9, 0),
    (252, 20, 4, 2, 0, 0),
    # deep ratios: split warps share each output's rows (direct, staged)
    (4096, 4096, 32, 32, 0, 0),
    (4080, 4080, 16, 16, 0, 0),
]
# the box kernel on inputs at byte offsets 1-4 and 8 (16-byte loads then
# need the staged form): direct 16:1, RGB24, COPY x box, 255:1 with
# unassociated out, 10:1 with a reorder
BOX_UNALIGNED = [(256, 128, 16, 8, 0, 0), (256, 128, 16, 8, 8, 8), (256, 64, 256, 4, 0, 0),
                 (510, 510, 2, 2, 0, 4), (3840, 120, 384, 12, 2, 3)]
BOX_OFFSETS = (1, 2, 3, 4, 8)
# more than 65535 output rows in the batch: (plan, batch), COPY and direct
BOX_TALL = [((16, 65529, 16, 7281, 0, 0), 10), ((48, 65532, 4, 5461, 0, 0), 13)]
# checked on a constant-255 batch too: the largest sums of each form
BOX_CONST_PLANS = [(510, 510, 2, 2, 0, 4), (4096, 128, 256, 8, 0, 0), (765, 20, 3, 20, 8, 8),
                   (20, 765, 20, 3, 0, 0)]

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
    # PAST_64 of tests/test_torch_bilinear.py: a box past 64:1 beside each
    # other axis kind, outside the deep box kernel's class
    (6500, 100, 100, 50, 0, 0),    # 65:1 box H x bilinear V
    (100, 6500, 50, 100, 0, 1),    # bilinear H x 65:1 box V, reorder
    (25500, 10, 100, 7, 0, 0),     # 255:1 box H x bilinear V
    (130, 2000, 130, 10, 2, 3),    # COPY H x 200:1 box V
    (2000, 70, 10, 70, 0, 0),      # 200:1 box H x COPY V
    (1, 9000, 3, 40, 0, 0),        # ONE H x 225:1 box V
    (9000, 1, 40, 3, 0, 0),        # 225:1 box H x ONE V
    (200, 650, 1, 10, 0, 0),       # box x box, one output column: 200:1 x 65:1
    (650, 200, 10, 1, 0, 0),       # box x box, one output row
    (6500, 60, 100, 30, 8, 8),     # RGB24
    (6500, 60, 100, 30, 8, 4),     # RGB24 -> unassociated RGBA
    (6500, 100, 100, 50, 4, 0),    # unassociated in
    (6500, 100, 100, 50, 0, 4),    # unassociated out
    # STAGED of tests/test_torch_bilinear.py: the staged box X axes' column
    # tiles (256 / lanes columns) on their edges at 1, 8 and 16 lanes, five
    # tiles, both sides of the staging threshold and of two lanes
    (4080, 64, 255, 16, 0, 0),     # 16:1 box x 1h ladder, one lane, T - 1
    (4096, 64, 256, 16, 0, 0),     # T
    (4112, 64, 257, 16, 0, 0),     # T + 1
    (4112, 64, 257, 16, 8, 8),     # same, RGB24
    (200, 50, 1, 7, 0, 1),         # 200:1 box, 16 lanes, one column
    (3968, 20, 31, 10, 0, 0),      # 128:1 box x 0h, 8 lanes, T - 1
    (4096, 20, 32, 10, 2, 3),      # T, reorder
    (4224, 20, 33, 10, 4, 1),      # T + 1, unassociated in
    (4335, 10, 17, 5, 0, 4),       # 255:1 box, 16 lanes, T + 1, unassociated out
    (16400, 8, 1025, 4, 0, 0),     # 16:1 box, five tiles
    (2800, 10, 200, 5, 0, 0),      # 14:1 box: direct loads
    (3000, 10, 200, 5, 0, 0),      # 15:1 box: staged, one lane
    (3600, 10, 200, 5, 9, 8),      # 18:1 box: two lanes, BGR24 -> RGB24
]
# (plan, first output row, rows) through the row form
BILINEAR_CHECK_ROWS = [
    ((1024, 512, 128, 64, 0, 0), 16, 8),
    ((1024, 512, 128, 64, 0, 0), 61, 3),
    ((512, 500, 96, 50, 0, 0), 13, 17),
    ((512, 256, 96, 56, 0, 4), 10, 30),
    ((512, 512, 1024, 1024, 5, 0), 100, 200),
    ((512, 700, 512, 123, 0, 3), 40, 50),
    ((4096, 512, 4096, 4, 0, 0), 1, 2),        # COPY x 128:1 integer box by rows
    ((6500, 100, 100, 50, 0, 0), 10, 20),
    ((1, 9000, 3, 40, 0, 0), 39, 1),
    # STAGED_ROWS of tests/test_torch_bilinear.py
    ((4112, 64, 257, 16, 0, 0), 5, 7),
    ((4112, 64, 257, 16, 8, 8), 9, 6),
    ((4224, 20, 33, 10, 4, 1), 3, 4),
    ((16400, 8, 1025, 4, 0, 0), 1, 2),
]
# DIRECT of tests/test_torch_bilinear.py: the direct path's tiles
# (ops/bilinear.launch_shape: tile_w output columns by 256 / tile_w rows) on
# their edges, w_out 1, 7, 31, 32, 33, 257 and 4096 by h_out 1, 7, 8, 9 and
# 257, over each V kind (COPY, ONE, bilinear 0h-2h, box) beside each X kind
# that loads directly; phase 3 runs each in every form that fits it
DIRECT_CHECK_PLANS = [
    (3, 9, 1, 8, 0, 0),            # 1h x 0h, one column
    (7, 1, 7, 7, 0, 1),            # COPY x ONE
    (62, 14, 31, 7, 8, 8),         # 0h x 0h, RGB24
    (128, 72, 32, 9, 0, 0),        # 1h x 2h
    (33, 257, 33, 257, 5, 2),      # COPY x COPY
    (257, 100, 257, 1, 0, 0),      # COPY x 100:1 box, one row
    (4096, 40, 4096, 8, 0, 0),     # COPY x 2h
    (4096, 9, 4096, 9, 8, 8),      # COPY x COPY, RGB24
    (66, 18, 33, 9, 1, 6),         # 0h x 0h, reorders
    (100, 257, 31, 257, 4, 0),     # 1h x COPY, unassociated in
    (14, 7, 7, 14, 0, 4),          # 0h x 0h upscale, unassociated out
    (20, 80, 257, 8, 9, 9),        # 0h upscale x 10:1 box, BGR24
    (700, 90, 257, 9, 0, 0),       # 1h x 10:1 box
    (310, 1500, 31, 100, 2, 3),    # 10:1 box x 15:1 box
    (10, 1, 1, 1, 0, 0),           # 10:1 box x ONE
    (1, 300, 7, 8, 0, 0),          # ONE x 37.5:1 box
    (448, 8, 32, 8, 0, 0),         # 14:1 box x COPY
    (300, 200, 290, 190, 8, 9),    # 0h x 0h, RGB24 -> BGR24
    (512, 512, 171, 171, 8, 8),    # row 3a's 1h ladder, RGB24
    (512, 512, 375, 375, 8, 8),    # row 3b's 0h, RGB24
    (384, 384, 64, 64, 0, 0),      # row 5b's 384^2 levels: 2h, 1h, 0h
    (384, 384, 128, 128, 0, 0),
    (384, 384, 256, 256, 0, 0),
    # ROLL's edges: f just above 1 and exactly 2, w_out not a multiple of 4,
    # 2-row input (1-row input is a ONE V axis, outside ROLL), one output
    # column (ONE and 1h X), 3-byte pixels, unassociated in, unassociated out,
    # and a 2h X axis
    (200, 300, 201, 301, 0, 0),
    (129, 64, 258, 128, 0, 0),
    (37, 2, 75, 9, 0, 0),
    (37, 1, 75, 9, 0, 0),
    (1, 30, 1, 77, 0, 0),
    (3, 30, 1, 77, 1, 2),
    (99, 41, 150, 83, 8, 9),
    (97, 40, 203, 77, 0, 8),
    (64, 50, 130, 101, 5, 0),
    (61, 50, 133, 101, 0, 4),
    (300, 40, 70, 83, 0, 0),
    # ROLL's downscale edges: conv-2160p's plan (the window steps one row at
    # every output row) in six byte and alpha classes (4 -> 4 premultiplied,
    # unassociated -> premultiplied, premultiplied -> unassociated, 3 -> 4,
    # 4 -> 3, 3 -> 3), f just above 0.5 (two rows at nearly every output
    # row), w_out not a multiple of 4, one output row, one output column
    # (ONE and 1h X)
    (3840, 2160, 3839, 2159, 0, 0),
    (3840, 2160, 3839, 2159, 4, 0),
    (3840, 2160, 3839, 2159, 0, 4),
    (3840, 2160, 3839, 2159, 8, 0),
    (3840, 2160, 3839, 2159, 0, 8),
    (3840, 2160, 3839, 2159, 8, 8),
    (400, 301, 201, 151, 0, 0),
    (301, 97, 203, 77, 0, 0),
    (37, 2, 30, 1, 0, 0),
    (1, 30, 1, 20, 0, 0),
    (3, 30, 1, 20, 1, 2),
]
# (plan, first output row, rows) through the row form: ranges that start and
# end inside a row group
DIRECT_CHECK_ROWS = [
    ((300, 200, 290, 190, 0, 0), 13, 100),
    ((128, 72, 32, 9, 0, 0), 3, 5),
    ((33, 257, 33, 257, 5, 2), 100, 157),
    ((100, 257, 31, 257, 4, 0), 250, 7),
    ((4096, 40, 4096, 8, 0, 0), 5, 1),
    ((512, 512, 171, 171, 8, 8), 9, 150),
    ((129, 64, 258, 128, 0, 0), 13, 115),
    ((400, 301, 201, 151, 0, 0), 51, 100),
    ((301, 97, 203, 77, 8, 0), 5, 72),
]
# the general kernel on inputs at byte offsets 1-3: a 2h ladder with tails
# (direct byte loads), and staged boxes (ragged stretch ends staged byte by
# byte, pixels read across shared words): 128:1 at 8 lanes, 16:1 RGB24, and
# 255:1 with unassociated out; the direct path's 3-byte rows (rows 3a and
# 3b's classes)
BILINEAR_UNALIGNED = [(700, 500, 123, 77, 2, 3), (4224, 20, 33, 10, 4, 1),
                      (4112, 64, 257, 16, 8, 8), (4335, 10, 17, 5, 0, 4),
                      (512, 512, 171, 171, 8, 8), (512, 512, 375, 375, 8, 8),
                      (62, 14, 31, 7, 8, 8)]
# batch x rows past 65,535 on the direct path: (plan, batch); the second
# also loops over images (grid z at 65,535)
BILINEAR_TALL = [((16, 9000, 8, 8200, 0, 0), 8), ((8, 4, 4, 2, 8, 8), 70000)]

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
    # the kernel's mapping (ops/deep.launch_shape at batch 2) on its edges:
    # covers of 16/17, 32/33, 64/65 and 128/129 words (4 -> 8 -> 16 -> 32
    # lanes, then two chunks), warps of 8 columns and blocks of 16 (w_out
    # 15, 16, 17), V spans of 16 and 18 rows (splits)
    (298, 300, 5, 20, 0, 0, False),
    (319, 300, 5, 20, 0, 0, False),
    (249, 300, 2, 20, 0, 0, False),
    (382, 300, 3, 20, 0, 0, False),
    (508, 300, 2, 20, 0, 0, False),
    (515, 300, 2, 20, 0, 0, False),
    (1019, 300, 2, 20, 0, 0, False),
    (1026, 300, 2, 20, 4, 4, False),
    (240, 64, 15, 4, 0, 0, False),
    (256, 64, 16, 4, 1, 6, False),
    (272, 64, 17, 4, 4, 0, False),
    (256, 240, 16, 16, 0, 0, False),
    (256, 255, 16, 15, 0, 4, False),
    (250, 90, 10, 9, 0, 0, False),      # spans of 25 pixels
    (1290, 300, 10, 30, 0, 0, False),   # spans of 129 pixels: 516 bytes
    (1720, 200, 10, 20, 8, 8, False),   # 3-byte spans of 172 pixels: 516 bytes
    (1001, 90, 7, 9, 8, 8, False),      # ragged 3-byte spans: every start mod 16
    (1001, 90, 7, 9, 0, 0, False),      # ragged 4-byte spans, rows of 4004 bytes
    (2060, 100, 2, 10, 8, 8, True),     # RGB24 linear over two chunks
    # 3-byte pixels in and out at each mode the planner gives them
    (999, 333, 11, 3, 8, 8, False),
    (999, 333, 11, 3, 9, 9, True),
    (999, 333, 11, 3, 0, 8, True),
    (999, 333, 11, 3, 8, 0, True),
]
# checked on a constant-255 batch too: numpy_ref gives (97, 97, 97, 255)
DEEP_CONST_PLAN = (10000, 64, 2, 2, 4, 4, True)
# the deep box kernel on inputs at byte offsets 1-4 and 8 (offsets 1-3
# take its SHIFTED reader), whole and by rows: 128:1, ragged PREMUL16,
# linear light from unassociated input, RGB24 and RGB24 in linear light
DEEP_UNALIGNED = [(1024, 1024, 8, 8, 0, 0, False), (2000, 2000, 12, 12, 4, 4, False),
                  (1000, 900, 9, 10, 4, 0, True), (1000, 900, 9, 10, 8, 8, False),
                  (1198, 900, 5, 7, 8, 4, True)]
DEEP_OFFSETS = (1, 2, 3, 4, 8)
# more than 65535 images (grid z loops): (plan, batch), a batch made of 7
# distinct images repeated
DEEP_TALL = ((20, 20, 2, 2, 0, 0, False), 70000)
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
# the low-alpha plan of test_pallas_128.py:55, two box x box plans with one
# output column past 255:1, and COPY and ONE axes at each (alpha, gamma)
# mode; tests/test_torch_bilinear128.py holds the plain version against
# numpy_ref, the Pallas kernels #10-#12 and the JAX package on each
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
    (96, 54, 96, 54, 4, 4, False),      # PREMUL16: COPY x COPY
    (96, 54, 96, 27, 4, 4, False),      # COPY x bilinear 0h
    (96, 54, 48, 54, 5, 6, False),      # bilinear x COPY, reorders
    (1, 300, 5, 20, 4, 4, False),       # ONE x box
    (300, 1, 20, 5, 4, 4, False),       # box x ONE
    (64, 600, 64, 2, 0, 0, False),      # PREMUL8 at 128bpp: COPY x 300:1 box
    (600, 1, 2, 7, 0, 1, False),        # 300:1 box x ONE
    (300, 600, 1, 600, 4, 4, False),    # box x COPY, one output column
    (96, 54, 96, 54, 0, 0, True),       # PREMUL8-linear: COPY x COPY
    (96, 54, 96, 27, 0, 0, True),       # COPY x bilinear
    (1, 300, 5, 20, 0, 0, True),        # ONE x box
    (300, 1, 20, 5, 2, 5, True),        # box x ONE, premultiplied in -> unassociated out
    (256, 256, 256, 16, 0, 0, True),    # COPY x box
    (96, 54, 96, 54, 4, 4, True),       # PREMUL16-linear: COPY x COPY
    (54, 96, 27, 96, 4, 4, True),       # bilinear x COPY
    (1, 300, 5, 20, 4, 4, True),        # ONE x box
    (300, 1, 20, 5, 4, 4, True),        # box x ONE
    (1, 1, 7, 5, 4, 4, True),           # ONE x ONE
    (96, 54, 96, 27, 8, 8, True),       # RGB24 linear: COPY x bilinear, pack24 direct
    (96, 54, 96, 54, 8, 4, True),       # RGB24 -> unassociated RGBA, COPY x COPY
    (1, 300, 5, 20, 9, 9, True),        # BGR24: ONE x box
    (1920, 1080, 1920, 1080, 0, 0, True),  # 1:1 in linear light
    (256, 1100, 256, 80, 4, 4, True),   # COPY x box, PREMUL16-linear
    # the kernel's tiles (32 columns by 8 rows, narrower outputs 1-16
    # columns by 256-16 rows) on their edges: w_out 1, 7, 64, 255, 256, 257
    (64, 100, 1, 90, 4, 4, False),      # one column: box x 0h
    (512, 300, 7, 290, 4, 4, True),     # 7 columns, 32 rows per tile
    (512, 512, 64, 64, 4, 4, False),    # 5b's PREMUL16 64 level: 2h x 2h
    (1020, 200, 255, 50, 4, 4, True),
    (1024, 200, 256, 50, 0, 0, True),
    (1028, 200, 257, 50, 4, 4, False),
    # 3-byte output at PREMUL8 compressed (S128 past 255:1); PREMUL8-linear
    # has its own above, and PREMUL16 is planned only for unassociated
    # 4-byte pixels in and out
    (520, 300, 2, 40, 8, 9, False),
    (520, 300, 2, 40, 0, 8, False),
    # ROLL's class (PREMUL16 at compressed gamma, a 0h bilinear V axis beside
    # a bilinear, COPY or ONE X axis) on its edges: a downscale by a pixel
    # (the V window steps a row per output row), a 0h upscale, fleet-5b's 2:1 level
    # (both tap rows new each row), X COPY, ONE and 1h and 2h ladders, and
    # output widths 1-9 and 129 (1-3 lanes, 33 quads, ragged last words)
    (700, 300, 699, 299, 4, 6, False),
    (300, 200, 450, 310, 5, 7, False),
    (512, 512, 256, 256, 4, 4, False),
    (96, 54, 96, 40, 7, 5, False),
    (1, 300, 5, 250, 4, 4, False),
    (800, 300, 300, 250, 6, 4, False),
    (1200, 90, 250, 70, 5, 5, False),
    (3, 40, 1, 60, 4, 5, False),
    (5, 41, 2, 39, 5, 6, False),
    (5, 42, 3, 62, 6, 7, False),
    (6, 43, 4, 40, 7, 4, False),
    (7, 44, 5, 64, 4, 5, False),
    (8, 45, 6, 47, 5, 6, False),
    (9, 46, 7, 66, 6, 7, False),
    (10, 47, 8, 51, 7, 4, False),
    (11, 48, 9, 68, 4, 5, False),
    (131, 49, 129, 55, 5, 6, False),
    # ROLL in P8-linear (sRGB linear light, 4-byte pixels with a
    # premultiplied side) on its edges: f just above 1, exactly 2, 0.5x and
    # a pixel less, X COPY, ONE and 1h and 2h ladders, output widths 1-9 and
    # 129, premultiplied and unassociated on either side
    (400, 300, 421, 316, 0, 0, True),
    (150, 100, 300, 200, 1, 2, True),
    (300, 200, 150, 100, 2, 3, True),
    (700, 300, 699, 299, 3, 0, True),
    (96, 54, 96, 40, 0, 4, True),
    (1, 300, 5, 250, 4, 0, True),
    (800, 300, 300, 250, 5, 1, True),
    (1200, 90, 250, 70, 6, 2, True),
    (3, 40, 1, 60, 7, 3, True),
    (5, 41, 2, 39, 0, 5, True),
    (5, 42, 3, 62, 1, 6, True),
    (6, 43, 4, 40, 2, 7, True),
    (7, 44, 5, 64, 3, 4, True),
    (8, 45, 6, 47, 4, 1, True),
    (9, 46, 7, 66, 5, 2, True),
    (10, 47, 8, 51, 6, 3, True),
    (11, 48, 9, 68, 7, 0, True),
    (131, 49, 129, 55, 2, 6, True),
]
# checked on a constant-255 batch too: numpy_ref gives (97, 97, 97, 255),
# on a box axis beside a bilinear one and beside a COPY one
WIDE_CONST_PLAN = (1100, 300, 80, 100, 4, 4, True)
WIDE_CONST_COPY_PLAN = (256, 1100, 256, 80, 4, 4, True)
# 3-byte input on a constant-255 batch, in each form: boxes in linear light
# (cut to 16 bits, kept in the h tile's cells) and at PREMUL8 past 255:1
WIDE_CONST24_PLANS = [(333, 200, 111, 40, 8, 8, True), (520, 300, 2, 40, 8, 9, False)]
# (plan, first output row, rows) through the row form
WIDE_CHECK_ROWS = [
    ((512, 256, 96, 56, 4, 4, True), 10, 20),
    ((1024, 512, 128, 64, 4, 4, False), 61, 3),
    ((1100, 300, 80, 100, 4, 4, True), 0, 1),
    ((16, 600, 8, 2, 4, 0, False), 1, 1),
    ((2000, 400, 1, 20, 0, 0, False), 5, 7),
    ((1024, 300, 128, 30, 8, 8, True), 29, 1),
    ((256, 256, 256, 16, 0, 0, True), 3, 5),     # COPY x box
    ((96, 54, 96, 27, 4, 4, False), 10, 7),      # COPY x bilinear
    ((1, 300, 5, 20, 4, 4, True), 19, 1),        # ONE x box, the last row
    ((512, 300, 7, 290, 4, 4, True), 45, 200),   # starts inside a 32-row tile
    ((1028, 200, 257, 50, 4, 4, False), 3, 13),
    ((700, 300, 699, 299, 4, 6, False), 37, 200),   # ROLL: starts and ends inside strips
    ((512, 512, 256, 256, 4, 4, False), 255, 1),    # ROLL: the last row
    ((300, 200, 450, 310, 5, 7, False), 1, 308),
    ((400, 300, 421, 316, 0, 0, True), 37, 200),    # ROLL, P8-linear: inside strips
    ((300, 200, 150, 100, 2, 3, True), 99, 1),      # ROLL, P8-linear: the last row
]
# the 128bpp kernel on inputs at byte offsets 1-3, whole and by rows: a 2h
# ladder in PREMUL16-linear, COPY x COPY at PREMUL16, a 260:1 box at
# PREMUL8, COPY x bilinear in PREMUL8-linear; 3-byte pixels (each form): a
# 2h ladder in linear light and a 260:1 box at PREMUL8; ROLL's class (each
# form): a downscale by a pixel, X COPY, X a 1h ladder, and in P8-linear a
# 2x upscale and X COPY
WIDE_UNALIGNED = [(512, 256, 96, 56, 4, 4, True), (96, 54, 96, 54, 4, 4, False),
                  (520, 300, 2, 40, 0, 0, False), (96, 54, 96, 27, 0, 0, True),
                  (512, 256, 96, 56, 8, 8, True), (520, 300, 2, 40, 8, 9, False),
                  (700, 300, 699, 299, 4, 6, False), (96, 54, 96, 40, 7, 5, False),
                  (800, 300, 300, 250, 6, 4, False), (150, 100, 300, 200, 1, 2, True),
                  (96, 54, 96, 40, 0, 4, True)]
# more than 65535 output rows in the batch: (plan, batch)
WIDE_TALL = ((8, 30000, 8, 30000, 4, 4, False), 3)

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
    # the proportional sweep's 0h upscales (frames-2160p): at 1.9x, and at
    # 1.1x, where each output row needs a new tap row
    ("up-2160", (3840, 2160, 7296, 4104, 0, 0), 8),
    ("up-1.1", (3840, 2160, 4224, 2376, 0, 0), 8),
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
    # the linear-light sweep's box x box plans (frames-2160p-srgb, 32 frames
    # a request as in sweep2160-srgb-b32): 0.06x in P8-linear
    ("srgb box-0.06", (3840, 2160, 229, 129, 0, 0, True), 32),
]
DEEP_STREAM_ROW, DEEP_STREAM_CHUNKS = "row 9", 4
# 128bpp kernel (suite.py:314-324), and row 7 through scale_streamed
WIDE_ROWS = [
    ("row 6", (2048, 2048, 256, 256, 4, 4, True), 8),
    ("row 6b", (1920, 1080, 400, 225, 8, 8, True), 8),
    ("row 7", (2048, 2048, 256, 256, 4, 4, False), 8),
    # gamma-correct video frames, on no suite row: 4K -> 1080p downscaling
    # (0h 2:1) and 720p -> 1080p upscaling (0h, tap rows shared 2.4-fold)
    ("6b-4k", (3840, 2160, 1920, 1080, 8, 8, True), 4),
    ("6b-up", (1280, 720, 1920, 1080, 8, 8, True), 8),
    # ROLL's class: upstream's format-conversion benchmark between
    # unassociated types (conv-2160p's PREMUL16 pairs: 64 4K frames to a
    # pixel less), and fleet-5b's unassociated 512^2 -> 256^2 level on one of
    # the farm's 192 MiB sub-batches
    ("conv u-u", (3840, 2160, 3839, 2159, 4, 4, False), 64),
    ("conv u-7", (3840, 2160, 3839, 2159, 4, 7, False), 64),
    ("5b 256 u", (512, 512, 256, 256, 4, 4, False), 192),
    # the linear-light sweep's heaviest classes (frames-2160p-srgb, 32 frames
    # a request as in sweep2160-srgb-b32) in P8-linear: 2x and 0.597x (0h,
    # ROLL; timed in LOOP too), 0.497x (the widest 1h ladder, LOOP)
    ("srgb up-2.0", (3840, 2160, 7680, 4320, 0, 0, True), 32),
    ("srgb down-0.6", (3840, 2160, 2292, 1289, 0, 0, True), 32),
    ("srgb 1h-0.5", (3840, 2160, 1910, 1074, 0, 0, True), 32),
]
WIDE_STREAM_ROW, WIDE_STREAM_CHUNKS = "row 7", 4
# the plans that no kernel took before every plan reached one, at full
# width, and a 64bpp box x box plan past 64:1 that must stay on the deep box
# kernel: (name, plan key, batch, kernel, chunks); a row with chunks runs
# through scale_streamed in that many chunks, the others through scale
A1_ROWS = [
    # RGBA unassociated at 1:1: PREMUL16, COPY x COPY
    ("a1-p16-copy", (1920, 1080, 1920, 1080, 4, 4, False), 8, "bilinear128", 0),
    # a video field halving in linear light: COPY x bilinear 0h
    ("a1-srgb-field", (3840, 2160, 3840, 1080, 0, 0, True), 4, "bilinear128", 0),
    # a waveform strip of a very wide image: 128:1 box x bilinear 0h
    ("a1-strip", (16384, 2048, 128, 1024, 0, 0, False), 2, "bilinear", 0),
    # row 8's strip at 128:1, by rows: COPY x 128:1 integer box
    ("a1-strip-rows", (4096, 4096, 4096, 32, 0, 0, False), 8, "bilinear", 4),
    # 128:1 x 8.5:1: a plan of TPU kernel #7 (pallas_deep._built_general),
    # which pallas_deep builds for it under its "general" knob only (no plan
    # reaches it otherwise; tests/test_torch_deep.py::test_general_kernel_row)
    ("deep general", (4096, 4096, 32, 480, 0, 0, False), 8, "deep", 0),
]
# on no suite row, checked and timed beside them: (name, plan key, batch,
# kernel)
EXTRA_ROWS = [
    # the box kernel's 24bpp form (TPU kernel #2, pallas_box.py:455)
    ("rgb24", (4096, 4096, 256, 256, 8, 8), 8, "box"),
    # COPY x COPY at row 2's output size: the general kernel's cost per
    # output pixel without filtering
    ("copy", (1024, 1024, 1024, 1024, 0, 0), 8, "bilinear"),
    # up-2160 in 3-byte pixels: the route of 3-byte 0h upscales
    ("up-2160 rgb24", (3840, 2160, 7296, 4104, 8, 8), 8, "bilinear"),
    # upstream's format-conversion benchmark (conv-2160p): 64 4K frames to a
    # pixel less, a 0h downscale whose V window steps one row at every output
    # row, in six byte and alpha classes (4 -> 4 premultiplied, unassociated
    # -> premultiplied, premultiplied -> unassociated, 3 -> 4, 4 -> 3, 3 -> 3)
    ("conv 4-4", (3840, 2160, 3839, 2159, 0, 0), 64, "bilinear"),
    ("conv u-4", (3840, 2160, 3839, 2159, 4, 0), 64, "bilinear"),
    ("conv 4-u", (3840, 2160, 3839, 2159, 0, 4), 64, "bilinear"),
    ("conv 3-4", (3840, 2160, 3839, 2159, 8, 0), 64, "bilinear"),
    ("conv 4-3", (3840, 2160, 3839, 2159, 0, 8), 64, "bilinear"),
    ("conv 3-3", (3840, 2160, 3839, 2159, 8, 8), 64, "bilinear"),
    # a 0h downscale of the proportional sweep (frames-2160p) near 0.6x
    ("down-0.6", (3840, 2160, 2292, 1289, 0, 0), 8, "bilinear"),
    # the headline on the general kernel, beside the box kernel's row 0
    ("row 0 on bilinear", (4096, 4096, 256, 256, 0, 0), 8, "bilinear"),
    # a 10:1 box whose 40-byte spans take the box kernel's staged form:
    # video-preview grids of 4K frames
    ("box-10", (3840, 2160, 384, 216, 0, 0), 8, "box"),
    # 128:1 x 128:1, icon-size thumbnails of camera images: split warps on
    # the box kernel, and the same plan on the deep box kernel beside it
    ("box-deep", (4096, 4096, 32, 32, 0, 0), 8, "box"),
    ("box-deep on deep", (4096, 4096, 32, 32, 0, 0), 8, "deep"),
    # the other kinds of box x box past 64:1 in both kernels' classes, each
    # on both: 3-byte pixels, and a narrow box axis beside a 128:1 one
    ("box-deep rgb24", (4096, 4096, 32, 32, 8, 8), 8, "box"),
    ("box-deep rgb24 on deep", (4096, 4096, 32, 32, 8, 8), 8, "deep"),
    ("box-16x128", (4096, 4096, 256, 32, 0, 0), 8, "box"),
    ("box-16x128 on deep", (4096, 4096, 256, 32, 0, 0), 8, "deep"),
    ("box-10x128", (3840, 4096, 384, 32, 0, 0), 8, "box"),
    ("box-10x128 on deep", (3840, 4096, 384, 32, 0, 0), 8, "deep"),
    ("box-128x16", (4096, 4096, 32, 256, 0, 0), 8, "box"),
    ("box-128x16 on deep", (4096, 4096, 32, 256, 0, 0), 8, "deep"),
]
# the pyramid kernel's sets: (w_in, h_in, ((w_out, h_out), ...), type_in,
# type_out), with_srgb False.  Those of tests/test_torch_pyramid.py (the
# sets of tests/test_pallas_pyramid.py, which hold the plain version against
# numpy_ref and Pallas kernel #9), four that the TPU's gates keep out, one
# with all nine (halvings x, halvings y) slots and a 24bpp set with one
# halving-free axis
_L3 = ((64, 32), (128, 64), (256, 128))
PYRAMID_CHECK_SETS = [
    (512, 512, ((64, 64), (128, 128), (256, 256)), 0, 0),  # row 5
    (512, 512, ((64, 64), (128, 128), (256, 256)), 1, 0),  # BGRA -> RGBA
    (256, 128, ((32, 16), (64, 32), (128, 64)), 2, 3),     # ARGB -> ABGR
    (1280, 320, ((160, 40), (320, 80)), 3, 3),             # 8:1 / 4:1
    (256, 256, ((32, 32), (64, 64)), 0, 0),
    (512, 256, _L3, 4, 0),                                 # unassociated in
    (512, 256, _L3, 5, 1),
    (512, 256, _L3, 0, 4),                                 # unassociated out
    (512, 256, _L3, 8, 8),                                 # RGB24
    (512, 256, _L3, 9, 9),
    (512, 256, _L3, 9, 8),
    (96, 128, ((24, 32), (48, 64)), 0, 0),                 # width not a multiple of 128
    (320, 256, ((40, 32), (80, 64)), 0, 0),
    (2048, 2048, ((256, 256), (512, 512)), 0, 0),          # past the TPU's VMEM budget
    (4096, 512, ((512, 64), (1024, 128)), 0, 0),           # 4096 wide
    (64, 64, tuple((w, h) for w in (32, 16, 8) for h in (32, 16, 8)), 6, 1),
    (24, 40, ((12, 20), (12, 10)), 9, 8),
]
# (index into PYRAMID_CHECK_SETS, byte offset of the input): inputs that are
# not 16- or 4-byte aligned take the kernel's narrower load paths
PYRAMID_UNALIGNED = [(0, 1), (0, 4), (8, 1), (15, 2)]
# suite row 5 (benchmarks/suite.py:82-127): 256 x RGBA premul 512^2 -> (64,
# 128, 256) through make_pyramid_fn
PYRAMID_ROW = ("row 5", (512, 512, (64, 128, 256), 0), 256)
# suite row 5b (suite.py:130-255): a fleet of 10,000 images, (share, (h, w),
# pixel type) per group, 32 templates per group cycled, seed 0, sub-batches
# of at most 192 MiB, through scale_pyramid_mixed; the cold figure on every
# 5th image (2,000)
FLEET_SPEC = [
    (0.30, (512, 512), 0),
    (0.20, (512, 512), 4),
    (0.15, (512, 512), 1),
    (0.20, (512, 512), 8),
    (0.15, (384, 384), 0),
]
FLEET_SIZE, FLEET_TEMPLATES, FLEET_COLD = 10_000, 32, 2_000
FLEET_SIZES, FLEET_BATCH_BYTES = (64, 128, 256), 192 * 2**20
BUSY_ROWS = ["row 0", "row 3e", "row 8", "rgb24", "row 1b", "row 3d", "row 7b", "row 9c",
             "row 6", "row 5"]
# phase 9: cases of each fuzz mode, and the first mode's seed (mode k: + k)
FUZZ_CASES, FUZZ_SEED = 60, 14
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


def bound_ms(in_bytes: int, out_bytes: int) -> float:
    """The least time the card could take: each input byte read once and each
    output byte written once at the HBM peak.  The kernels do a few integer
    operations per byte, so the operations' bound is far below it."""
    return (in_bytes + out_bytes) / (HBM_PEAK_GBS * 1e9) * 1e3


_KERNEL_NAMES = ("box_kernel", "bilinear_kernel", "deep_kernel", "bilinear128_kernel",
                 "pyramid_kernel")


def ptxas_instances(build_log: str) -> list:
    """Each kernel instance in ptxas's -v report: its kernel, template
    arguments (the general kernel's KX, KY, PACKED; the 128bpp kernel's KX,
    KY, MODE, PACKED; the deep box kernel's MODE, PACKED), registers, stack
    frame, spill stores and loads, and static shared memory, in bytes."""
    out, cur = [], None
    for line in build_log.splitlines():
        if "Compiling entry function" in line:
            name = next((k for k in _KERNEL_NAMES if f"{len(k)}{k}" in line), None)
            m = name and re.search(rf"{len(name)}{name}I((?:L[a-z]\d+E)+)E", line)
            cur = None if name is None else {
                "kernel": name,
                "args": ", ".join(re.findall(r"L[a-z](\d+)E", m.group(1))) if m else "",
                "stack": 0, "spill_stores": 0, "spill_loads": 0, "smem": 0}
        elif cur is not None and "stack frame" in line:
            nums = [int(v) for v in re.findall(r"(\d+) bytes", line)]
            cur["stack"], cur["spill_stores"], cur["spill_loads"] = nums[:3]
        elif cur is not None and "Used" in line and "registers" in line:
            cur["registers"] = int(line.split("Used")[1].split()[0])
            m = re.search(r"(\d+) bytes smem", line)
            cur["smem"] = int(m.group(1)) if m else 0
            out.append(cur)
            cur = None
    return out


def make_fleet():
    """The row 5b fleet (suite.py:157-176): images and pixel types."""
    rng = np.random.default_rng(0)
    images, types = [], []
    for share, (h, w), pt in FLEET_SPEC:
        n = int(round(share * FLEET_SIZE))
        nb = 3 if pt >= 8 else 4
        tpl = [rng.integers(0, 256, (h, w, nb), dtype=np.uint8) for _ in range(FLEET_TEMPLATES)]
        images += [tpl[i % FLEET_TEMPLATES] for i in range(n)]
        types += [pt] * n
    return images, types


def fleet_batches(images, types):
    """The sub-batches scale_pyramid_mixed makes of a fleet, as (group key,
    indices, padded size): grouped by (shape, type), at most
    FLEET_BATCH_BYTES each, a remainder padded to the group's size."""
    groups: dict = {}
    for i, (img, pt) in enumerate(zip(images, types)):
        groups.setdefault((img.shape, pt), []).append(i)
    out = []
    for key, idxs in groups.items():
        cap = max(1, min(len(idxs), FLEET_BATCH_BYTES // int(np.prod(key[0]))))
        for c0 in range(0, len(idxs), cap):
            sub = idxs[c0 : c0 + cap]
            out.append((key, sub, cap if c0 > 0 else len(sub)))
    return out


def load_parent(root: str, name: str):
    """The ``smolscale_tpu_torch`` package of another checkout at ``root``
    (for example the parent commit, unpacked with ``git archive``), loaded
    as ``name``, and its ``ops.box``, ``ops.deep``, ``ops.bilinear`` and
    ``ops.bilinear128`` modules.  Its kernels build into
    ``root/build/kernels``."""
    import importlib
    import importlib.util

    pkg = Path(root).resolve() / "smolscale_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        name, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return (mod, *(importlib.import_module(f"{spec.name}.ops.{op}")
                   for op in ("box", "deep", "bilinear", "bilinear128")))


def main(argv: list) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    # with --parent: (label, package, ops.box, ops.deep, ops.bilinear,
    # ops.bilinear128) of each checkout
    parents = []
    if argv[:1] == ["--parent"] and len(argv) >= 2:
        parents = [(Path(root).resolve().name,
                    *load_parent(root, f"parent{k}_smolscale_tpu_torch"))
                   for k, root in enumerate(argv[1:])]
    elif argv:
        print("usage: chip_smoke.py [--parent CHECKOUT [CHECKOUT ...]]", file=sys.stderr)
        return 2

    import smolscale_tpu_torch as stt
    from smolscale_tpu_torch.backends import torch_ops
    from smolscale_tpu_torch.ops import _build, bilinear, bilinear128, box, deep, pyramid
    from smolscale_tpu_torch.utils.timing import cuda_time_ms

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = gpu_line()

    # 1. device
    log(f"[device] {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    log(card)

    # 2. build (with --parent, the other checkouts' kernels at the same time)
    import importlib
    import threading

    parent_builds = [
        threading.Thread(target=importlib.import_module(pkg.__name__ + ".ops._build").library)
        for _, pkg, *_ in parents]
    for t in parent_builds:
        t.start()
    lib_path, build_log, secs = _build.build()
    _build.library()
    for t in parent_builds:
        t.join()
    log(f"[build] {lib_path} in {secs:.1f} s")
    for line in build_log.splitlines():
        if "registers" in line or "spill" in line or "error" in line.lower():
            log(f"[build] {line.strip()}")
    # each kernel's template instances and their registers, and for each
    # instance of the general kernel its stack frame, spills and shared
    # memory, from ptxas's report (an entry line, then its "stack frame"
    # line, then its "Used N registers, ... M bytes smem" line)
    instances = ptxas_instances(build_log)
    for name in _KERNEL_NAMES:
        mine = [r for r in instances if r["kernel"] == name]
        if mine:
            used = [r["registers"] for r in mine]
            log(f"[build] {name}: {len(used)} template instances, {min(used)}-{max(used)} "
                f"registers, stack frames up to {max(r['stack'] for r in mine)} bytes, "
                f"{sum(r['stack'] > 0 for r in mine)} instances with one")
    for r in instances:
        if r["kernel"] in ("box_kernel", "bilinear_kernel", "bilinear128_kernel", "deep_kernel"):
            log(f"[build] {r['kernel']}<{r['args']}>: {r['registers']} registers, "
                f"{r['stack']} bytes stack frame, {r['spill_stores']} + {r['spill_loads']} bytes "
                f"spill stores + loads, {r['smem']} bytes shared memory per block")
    # the deep box and general kernels, and the 128bpp kernel's ROLL
    # instances (FORM 2), keep every value in registers
    for name, form in (("deep_kernel", ""), ("bilinear_kernel", ""),
                       ("bilinear128_kernel", ", 2")):
        mine = [r for r in instances if r["kernel"] == name and r["args"].endswith(form)]
        spilled = [r["args"] for r in mine if r["stack"] or r["spill_stores"] or r["spill_loads"]]
        if not mine or spilled:
            raise AssertionError(f"{name} instances with a stack frame or spills: {spilled} "
                                 f"(of {len(mine)})")

    # 3. kernels against their plain versions
    err = {"box": 0, "bilinear": 0, "deep": 0, "bilinear128": 0, "pyramid": 0}

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

    def box_label(key, plan, x):
        shape = box.launch_shape(plan, x.shape[0], box.form(plan, x.data_ptr()))
        return (f"{key} ({box.FORMS[shape['form']]}, {shape['cw']} columns per warp, "
                f"{shape['wc']} x {shape['splits']} warps)")

    for i, key in enumerate(CHECK_PLANS):
        plan = stt.ScalePlan(*key, False)
        if not box.applicable(plan):
            raise AssertionError(f"{key}: outside the box class")
        x = random_images(key, 1000 + i)
        check("box", box_label(key, plan, x), box.scale_fn(plan, x), box.box_scale_ref(plan, x))
    for key in BOX_UNALIGNED:
        plan = stt.ScalePlan(*key, False)
        imgs = random_images(key, 1500)
        want = box.box_scale_ref(plan, imgs)
        for offset in BOX_OFFSETS:
            flat = torch.empty(imgs.numel() + offset, dtype=torch.uint8, device=dev)
            shifted = flat[offset:].view(imgs.shape)
            shifted.copy_(imgs)
            check("box", f"{box_label(key, plan, shifted)} at byte offset {offset}",
                  box.scale_fn(plan, shifted), want)
    for key, batch in BOX_TALL:
        plan = stt.ScalePlan(*key, False)
        imgs = torch.from_numpy(np.random.default_rng(1600).integers(
            0, 256, (batch, key[1], key[0], 4), dtype=np.uint8)).to(dev)
        check("box", f"{box_label(key, plan, imgs)} batch {batch} "
              f"({batch * plan.height_out} output rows)",
              box.scale_fn(plan, imgs), box.box_scale_ref(plan, imgs))
    for key in BOX_CONST_PLANS:
        plan = stt.ScalePlan(*key, False)
        x = torch.full((2, plan.height_in, plan.width_in, plan.meta_in.n_bytes), 255,
                       dtype=torch.uint8, device=dev)
        got = box.scale_fn(plan, x)
        check("box", f"{box_label(key, plan, x)} constant 255", got, box.box_scale_ref(plan, x))
        log(f"[check] box {key} constant 255: pixel (0, 0) {got[0, 0, 0].tolist()}")
    def bilinear_forms(plan):
        """The general kernel's routes for a plan: (label, form) of its
        direct path's routed form first, then every other form that fits;
        the staged box path alone."""
        if bilinear.stage_table(plan.x, plan.meta_in.n_bytes)[0]:
            return [("staged box", None)]
        chosen = bilinear.direct_form(plan)
        return [(f"{bilinear.FORMS[f]}{' (routed)' if f == chosen else ''}", f)
                for f in sorted(bilinear.direct_forms(plan), key=lambda f: f != chosen)]

    def check_bilinear(label, plan, x, first, n, want):
        for route, form in bilinear_forms(plan):
            if form == bilinear.ROLL:
                tile_w, _, strip, grid_y, grid_z = bilinear.roll_shape(
                    plan.width_out, first, n, x.shape[0])
                tile = f"tile {tile_w} columns, strips of {strip} rows"
            else:
                tile_w, _, grid_y, grid_z = bilinear.launch_shape(
                    plan.width_out, first, n, x.shape[0])
                tile = f"tile {tile_w} x {256 // tile_w}"
            check("bilinear", f"{label} ({route}, {tile}, grid y {grid_y}, z {grid_z})",
                  bilinear.scale_rows_fn(plan, x, first, n, form), want)

    for i, key in enumerate(BILINEAR_CHECK_PLANS + DIRECT_CHECK_PLANS):
        plan = stt.ScalePlan(*key, False)
        if not bilinear.applicable(plan):
            raise AssertionError(f"{key}: outside the bilinear class")
        x = random_images(key, 2000 + i)
        check_bilinear(key, plan, x, 0, plan.height_out, bilinear.bilinear_scale_ref(plan, x))
    for i, (key, first, n) in enumerate(BILINEAR_CHECK_ROWS + DIRECT_CHECK_ROWS):
        plan = stt.ScalePlan(*key, False)
        x = random_images(key, 3000 + i)
        check_bilinear(f"{key} rows [{first}, {first + n})", plan, x, first, n,
                       bilinear.bilinear_scale_ref(plan, x, first, n))
    for key, batch in BILINEAR_TALL:
        plan = stt.ScalePlan(*key, False)
        few = torch.from_numpy(np.random.default_rng(3500).integers(
            0, 256, (7, key[1], key[0], plan.meta_in.n_bytes), dtype=np.uint8)).to(dev)
        reps = -(-batch // 7)
        x = few.repeat(reps, 1, 1, 1)[:batch]
        check_bilinear(f"{key} batch {batch} ({batch * plan.height_out} output rows, 7 images "
                       f"repeated)", plan, x, 0, plan.height_out,
                       bilinear.bilinear_scale_ref(plan, few).repeat(reps, 1, 1, 1)[:batch])
    del few, x
    def deep_label(key, plan, x):
        sh = deep.launch_shape(plan, x.shape[0], address=x.data_ptr())
        return (f"{key} ({deep.FORMS[deep.form(plan, x.data_ptr())]}, {sh['lanes']} lanes x "
                f"{sh['units']} words x {sh['chunks']} chunks, {sh['wc']} x {sh['splits']} warps)")

    for i, key in enumerate(DEEP_CHECK_PLANS):
        plan = stt.ScalePlan(*key)
        if not deep.applicable(plan):
            raise AssertionError(f"{key}: outside the deep box class")
        x = random_images(key, 4000 + i)
        check("deep", deep_label(key, plan, x), deep.scale_fn(plan, x),
              deep.deep_scale_ref(plan, x))
    for key in DEEP_UNALIGNED:
        plan = stt.ScalePlan(*key)
        imgs = random_images(key, 4500)
        want = deep.deep_scale_ref(plan, imgs)
        h = plan.height_out
        for offset in DEEP_OFFSETS:
            flat = torch.empty(imgs.numel() + offset, dtype=torch.uint8, device=dev)
            shifted = flat[offset:].view(imgs.shape)
            shifted.copy_(imgs)
            label = f"{deep_label(key, plan, shifted)} at byte offset {offset}"
            check("deep", label, deep.scale_fn(plan, shifted), want)
            check("deep", f"{label} rows [{h // 3}, {h - 1})",
                  deep.scale_rows_fn(plan, shifted, h // 3, h - 1 - h // 3),
                  want[:, h // 3 : h - 1])
    key, batch = DEEP_TALL
    plan = stt.ScalePlan(*key)
    few = torch.from_numpy(np.random.default_rng(4600).integers(
        0, 256, (7, key[1], key[0], plan.meta_in.n_bytes), dtype=np.uint8)).to(dev)
    reps = -(-batch // 7)
    x = few.repeat(reps, 1, 1, 1)[:batch]
    check("deep", f"{deep_label(key, plan, x)} batch {batch} (7 images repeated)",
          deep.scale_fn(plan, x), deep.deep_scale_ref(plan, few).repeat(reps, 1, 1, 1)[:batch])
    del few, x
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
    def wide_forms(plan):
        """The 128bpp kernel's forms for a plan: (label, form), its routed
        form first, then every other form that fits."""
        chosen = bilinear128.form(plan)
        return [(f"{bilinear128.FORMS[f]}{' (routed)' if f == chosen else ''}", f)
                for f in sorted(bilinear128.forms(plan), key=lambda f: f != chosen)]

    def check_wide(label, plan, x, first, n, want):
        for route, form in wide_forms(plan):
            check("bilinear128", f"{label} ({route})",
                  bilinear128.scale_rows_fn(plan, x, first, n, form), want)

    for i, key in enumerate(WIDE_CHECK_PLANS):
        plan = stt.ScalePlan(*key)
        if not bilinear128.applicable(plan):
            raise AssertionError(f"{key}: outside the 128bpp class")
        x = random_images(key, 6000 + i)
        check_wide(key, plan, x, 0, plan.height_out, bilinear128.bilinear128_scale_ref(plan, x))
    for key in [WIDE_CONST_PLAN, WIDE_CONST_COPY_PLAN] + WIDE_CONST24_PLANS:
        plan = stt.ScalePlan(*key)
        x = torch.full((2, plan.height_in, plan.width_in, plan.meta_in.n_bytes), 255,
                       dtype=torch.uint8, device=dev)
        want = bilinear128.bilinear128_scale_ref(plan, x)
        check_wide(f"{key} constant 255", plan, x, 0, plan.height_out, want)
        log(f"[check] bilinear128 {key} constant 255: pixel (0, 0) {want[0, 0, 0].tolist()}")
    for i, (key, first, n) in enumerate(WIDE_CHECK_ROWS):
        plan = stt.ScalePlan(*key)
        x = random_images(key, 6500 + i)
        check_wide(f"{key} rows [{first}, {first + n})", plan, x, first, n,
                   bilinear128.bilinear128_scale_ref(plan, x, first, n))
    # a 4-byte input that is not 4-byte aligned takes the byte-load paths
    for kind, mod, plain, key in (
        ("box", box, box.box_scale_ref, CHECK_PLANS[0]),
        ("bilinear", bilinear, bilinear.bilinear_scale_ref, BILINEAR_CHECK_PLANS[3]),
        ("deep", deep, deep.deep_scale_ref, DEEP_CHECK_PLANS[2]),
        ("bilinear128", bilinear128, bilinear128.bilinear128_scale_ref, WIDE_CHECK_PLANS[11]),
        # the widened classes: a box past 64:1, COPY and ONE at 128bpp
        ("bilinear", bilinear, bilinear.bilinear_scale_ref, (6500, 100, 100, 50, 0, 0)),
        ("bilinear128", bilinear128, bilinear128.bilinear128_scale_ref,
         (96, 54, 96, 27, 4, 4, False)),
        ("bilinear128", bilinear128, bilinear128.bilinear128_scale_ref,
         (1, 300, 5, 20, 4, 4, True)),
    ):
        plan = plan_of(key)
        imgs = random_images(key, 7)
        flat = torch.empty(imgs.numel() + 1, dtype=torch.uint8, device=dev)
        shifted = flat[1:].view(imgs.shape)
        shifted.copy_(imgs)
        check(kind, f"{key} unaligned", mod.scale_fn(plan, shifted), plain(plan, imgs))
    for kind, mod, plain, keys in (
        ("bilinear", bilinear, bilinear.bilinear_scale_ref, BILINEAR_UNALIGNED),
        ("bilinear128", bilinear128, bilinear128.bilinear128_scale_ref, WIDE_UNALIGNED),
    ):
        for key in keys:
            plan = plan_of(key)
            imgs = random_images(key, 9)
            want = plain(plan, imgs)
            for offset in (1, 2, 3):
                flat = torch.empty(imgs.numel() + offset, dtype=torch.uint8, device=dev)
                shifted = flat[offset:].view(imgs.shape)
                shifted.copy_(imgs)
                h = plan.height_out
                each_form = check_bilinear if kind == "bilinear" else check_wide
                each_form(f"{key} at byte offset {offset}", plan, shifted, 0, h, want)
                each_form(f"{key} at byte offset {offset} rows [{h // 3}, {h - 1})",
                          plan, shifted, h // 3, h - 1 - h // 3, want[:, h // 3 : h - 1])
    key, batch = WIDE_TALL
    plan = plan_of(key)
    imgs = torch.from_numpy(np.random.default_rng(10).integers(
        0, 256, (batch, key[1], key[0], 4), dtype=np.uint8)).to(dev)
    check("bilinear128", f"{key} batch {batch} ({batch * plan.height_out} output rows)",
          bilinear128.scale_fn(plan, imgs), bilinear128.bilinear128_scale_ref(plan, imgs))

    def pyramid_plans(case):
        w, h, outs, ti, to = case
        return tuple(stt.ScalePlan(w, h, wo, ho, ti, to, False) for wo, ho in outs)

    def check_levels(label, got, plain):
        torch.cuda.synchronize()
        if len(got) != len(plain):
            raise AssertionError(f"{label}: {len(got)} levels, plain version {len(plain)}")
        for g, want in zip(got, plain):
            e = max_abs_err(g, want)
            err["pyramid"] = max(err["pyramid"], e)
            if g.shape != want.shape or not torch.equal(g, want):
                raise AssertionError(f"{label}: pyramid kernel level {tuple(want.shape)} "
                                     f"differs from plain version (max abs err {e})")
        log(f"[check] pyramid {label}: kernel == plain, levels "
            f"{[tuple(g.shape) for g in got]}")

    for i, case in enumerate(PYRAMID_CHECK_SETS):
        plans_ = pyramid_plans(case)
        if not pyramid.applicable(plans_):
            raise AssertionError(f"{case}: outside the pyramid class")
        imgs = random_images((case[0], case[1], 0, 0, case[3]), 8000 + i)
        check_levels(case, pyramid.pyramid_fn(plans_, imgs),
                     pyramid.pyramid_scale_ref(plans_, imgs))
    for i, offset in PYRAMID_UNALIGNED:
        case = PYRAMID_CHECK_SETS[i]
        plans_ = pyramid_plans(case)
        imgs = random_images((case[0], case[1], 0, 0, case[3]), 8500 + i)
        flat = torch.empty(imgs.numel() + offset, dtype=torch.uint8, device=dev)
        shifted = flat[offset:].view(imgs.shape)
        shifted.copy_(imgs)
        check_levels(f"{case} at byte offset {offset}", pyramid.pyramid_fn(plans_, shifted),
                     pyramid.pyramid_scale_ref(plans_, imgs))
    # a batch that is not contiguous through the public make_pyramid_fn
    case = PYRAMID_CHECK_SETS[0]
    imgs = random_images((case[0], case[1], 0, 0, case[3]), 8900)
    strided = imgs.transpose(1, 2).contiguous().transpose(1, 2)
    fn = stt.make_pyramid_fn(case[0], case[1], case[3], sizes=[wo for wo, _ in case[2]])
    before = pyramid.launches
    got = fn(strided)
    if strided.is_contiguous() or pyramid.launches != before + 1:
        raise AssertionError("the strided batch did not take one pyramid launch")
    check_levels(f"{case} transposed view through make_pyramid_fn", got, fn(imgs))
    del imgs, flat, shifted, strided

    # 4. main paths at full size, each row's input a view of one random buffer
    all_rows = (MAIN_ROWS + BILINEAR_ROWS + [STREAM_ROW] + DEEP_ROWS + WIDE_ROWS
                + [r[:3] for r in A1_ROWS] + [r[:3] for r in EXTRA_ROWS])
    plans = {name: plan_of(key) for name, key, _ in all_rows}
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    size = max(batch * plans[name].height_in * plans[name].width_in
               * plans[name].meta_in.n_bytes for name, _, batch in all_rows)
    x = torch.from_numpy(rng.integers(0, 256, size, dtype=np.uint8)).to(dev)
    torch.cuda.synchronize()
    log(f"[main] input {tuple(x.shape)} uint8 ({x.numel() / 2**20:.0f} MiB) "
        f"made and uploaded in {time.perf_counter() - t0:.1f} s")
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

    # the widened classes: COPY and ONE at 128bpp, a 64bpp box past 64:1,
    # whole and by rows; box x box past 64:1 on the deep box kernel
    kernel_mods = {"box": box, "bilinear": bilinear, "deep": deep, "bilinear128": bilinear128}
    for mod in kernel_mods.values():
        mod.launches = 0
    outs = {}
    for name, _, _, _, n_chunks in A1_ROWS:
        if not n_chunks:
            outs[name] = stt.scale(plans[name], inputs[name])
            continue
        chunks = list(stt.scale_streamed(plans[name], inputs[name], n_chunks=n_chunks))
        step = -(-plans[name].height_out // n_chunks)
        if [f for f, _ in chunks] != list(range(0, plans[name].height_out, step)):
            raise AssertionError(f"{name}: chunks start at {[f for f, _ in chunks]}")
        outs[name] = torch.cat([chunk for _, chunk in chunks], dim=1)
    torch.cuda.synchronize()
    a1_launches = {k: m.launches for k, m in kernel_mods.items()}
    expect = dict.fromkeys(kernel_mods, 0)
    for _, _, _, kind, n_chunks in A1_ROWS:
        expect[kind] += max(1, n_chunks)
    log(f"[main] kernel launches in the widened classes' main path: {a1_launches}, "
        f"expected {expect}")
    if a1_launches != expect:
        raise AssertionError("the widened classes did not launch their kernels once per row "
                             "and once per chunk")
    for name, _, batch, kind, _ in A1_ROWS:
        check_rows(kind, [(name, None, batch)], outs, kernels[kind][1])
    del outs

    # row 5: one launch of the pyramid kernel for every level of 256 images
    name5, (w5, h5, sizes5, pt5), batch5 = PYRAMID_ROW
    plans5 = tuple(stt.ScalePlan(w5, h5, sz, sz, pt5, pt5, False) for sz in sizes5)
    x5 = view_input(x, plans5[0], batch5)
    pyr_fn = stt.make_pyramid_fn(w5, h5, pt5, sizes=sizes5)
    pyramid.launches = bilinear.launches = 0
    outs5 = pyr_fn(x5)
    torch.cuda.synchronize()
    row5_launches = pyramid.launches
    log(f"[main] pyramid kernel launches in {name5}'s main path: {row5_launches}; bilinear "
        f"kernel launches: {bilinear.launches}")
    if row5_launches != 1 or bilinear.launches != 0:
        raise AssertionError(f"{name5} did not run as one launch of the pyramid kernel")
    check_levels(f"{name5} ({batch5} images)", outs5, pyramid.pyramid_scale_ref(plans5, x5))
    del outs5

    # row 5b: the mixed fleet through scale_pyramid_mixed
    t0 = time.perf_counter()
    images, types = make_fleet()
    batches = fleet_batches(images, types)
    group_plans = {
        key: tuple(stt.ScalePlan(key[0][1], key[0][0], sz, sz, key[1], key[1], False)
                   for sz in FLEET_SIZES)
        for key, _, _ in batches
    }
    log(f"[main] row 5b fleet: {len(images)} images, {len(group_plans)} groups, "
        f"{len(batches)} sub-batches, made in {time.perf_counter() - t0:.1f} s")
    level_kernels = {"box": box, "bilinear": bilinear, "deep": deep,
                     "bilinear128": bilinear128, "pyramid": pyramid}
    plain_of = {"box": box.box_scale_ref, "bilinear": bilinear.bilinear_scale_ref,
                "deep": deep.deep_scale_ref, "bilinear128": bilinear128.bilinear128_scale_ref}

    def kernel_of(plan):
        mod = torch_ops.whole_kernel(plan)
        return next(k for k, m in level_kernels.items() if m is mod)

    expect = dict.fromkeys(level_kernels, 0)
    for key, _, _ in batches:
        if pyramid.applicable(group_plans[key]):
            expect["pyramid"] += 1
        else:
            for p_ in group_plans[key]:
                expect[kernel_of(p_)] += 1
    for mod in level_kernels.values():
        mod.launches = 0
    by_form = {k: dict(m.form_launches) for k, m in (("bilinear", bilinear),
                                                      ("bilinear128", bilinear128))}
    t0 = time.perf_counter()
    fleet = stt.scale_pyramid_mixed(images, types, sizes=FLEET_SIZES,
                                    max_batch_bytes=FLEET_BATCH_BYTES)
    fleet_s = time.perf_counter() - t0
    fleet_launches = {k: m.launches for k, m in level_kernels.items()}
    by_form = {k: {m.FORMS[f]: n - by_form[k][f] for f, n in m.form_launches.items()}
               for k, m in (("bilinear", bilinear), ("bilinear128", bilinear128))}
    log(f"[main] row 5b: {len(images)} pyramids end to end in {fleet_s:.3f} s "
        f"(first call); launches {fleet_launches}, expected {expect}; by form {by_form}")
    if fleet_launches != expect:
        raise AssertionError("row 5b did not launch one pyramid kernel per fused sub-batch "
                             "and one level kernel per level of the others")
    for i, img in enumerate(images):
        want = [(sz, sz, img.shape[2]) for sz in FLEET_SIZES]
        if [o.shape for o in fleet[i]] != want or any(o.dtype != np.uint8 for o in fleet[i]):
            raise AssertionError(f"row 5b image {i}: levels {[o.shape for o in fleet[i]]}")
    probed = set()
    for key, sub, _ in batches:  # the first image of each group
        if key in probed:
            continue
        probed.add(key)
        plans_, img = group_plans[key], torch.from_numpy(images[sub[0]]).to(dev)
        if pyramid.applicable(plans_):
            plain = pyramid.pyramid_scale_ref(plans_, img)
        else:
            plain = tuple(plain_of[kernel_of(p_)](p_, img) for p_ in plans_)
        check_levels(f"row 5b probe image {sub[0]} {key}",
                     [torch.from_numpy(o).to(dev) for o in fleet[sub[0]]], plain)
    del fleet

    for name, _, batch, kind in EXTRA_ROWS:
        kernel_fn, plain_fn = kernels[kind]
        check(kind, f"{name} {plans[name].key} ({batch} images)",
              kernel_fn(plans[name], inputs[name]), plain_fn(plans[name], inputs[name]))

    # 5. times (turns: plain, kernel, kernel, plain)
    def streamed(n_chunks, mod=bilinear):
        def run(plan, xin):
            step = -(-plan.height_out // n_chunks)
            h = plan.height_out
            return [mod.scale_rows_fn(plan, xin, first, min(step, h - first))
                    for first in range(0, h, step)]
        return run

    timed = [(row, *kernels["box"]) for row in MAIN_ROWS]
    timed += [(row, *kernels["bilinear"]) for row in BILINEAR_ROWS]
    timed += [(STREAM_ROW, streamed(STREAM_CHUNKS), bilinear.bilinear_scale_ref)]
    timed += [(row, *kernels["deep"]) for row in DEEP_ROWS]
    # row 9 through the row API, timed as the 4 launches of its chunks
    deep_chunks = f"{DEEP_STREAM_ROW} in {DEEP_STREAM_CHUNKS} chunks"
    plans[deep_chunks], inputs[deep_chunks] = plans[DEEP_STREAM_ROW], inputs[DEEP_STREAM_ROW]
    timed += [((deep_chunks, None, 8), streamed(DEEP_STREAM_CHUNKS, deep), deep.deep_scale_ref)]
    timed += [(row, *kernels["bilinear128"]) for row in WIDE_ROWS]
    timed += [(row[:3], streamed(row[4]) if row[4] else kernels[row[3]][0], kernels[row[3]][1])
              for row in A1_ROWS]
    timed += [(row[:3], *kernels[row[3]]) for row in EXTRA_ROWS]
    # every row takes five kernel turns; the kernel's time is the median of
    # its turns
    box_rows = {r[0] for r in MAIN_ROWS} | {r[0] for r in EXTRA_ROWS if r[3] == "box"}
    deep_rows = ({r[0] for r in DEEP_ROWS} | {deep_chunks}
                 | {r[0] for r in A1_ROWS + EXTRA_ROWS if r[3] == "deep"})
    # the general kernel's rows, and the chunks of those run through the row
    # form
    bilinear_rows = {r[0] for r in BILINEAR_ROWS + A1_ROWS + EXTRA_ROWS
                     if len(r) == 3 or r[3] == "bilinear"} | {stream_name}
    wide_rows = {r[0] for r in WIDE_ROWS} | {r[0] for r in A1_ROWS if r[3] == "bilinear128"}
    chunks_of = {stream_name: STREAM_CHUNKS} | {r[0]: r[4] for r in A1_ROWS if r[4]}
    # beside this tree's kernel, in turns with it: each other checkout's box,
    # deep box, general and 128bpp kernels on their rows (with --parent), and
    # this tree's general kernel in each other form of its direct path that
    # fits the row, and its 128bpp kernel in each other form that fits the
    # row: name -> [(label, kind, fn), ...]
    parent_fns = {}

    def as_rows(mod, plan, n_chunks, form=()):
        """``mod``'s kernel on a row: whole, or in ``n_chunks`` chunks
        through the row form; ``form``: (form,) for one of this tree's
        forms, else ()."""
        if n_chunks:
            step = -(-plan.height_out // n_chunks)
            return lambda xin: [
                mod.scale_rows_fn(plan, xin, first, min(step, plan.height_out - first), *form)
                for first in range(0, plan.height_out, step)]
        return lambda xin: mod.scale_fn(plan, xin, *form)

    for label, parent, parent_box, parent_deep, parent_bil, parent_wide in parents:
        for name in sorted(box_rows | deep_rows | bilinear_rows | wide_rows):
            kind, pmod = (("box", parent_box) if name in box_rows else
                          ("deep", parent_deep) if name in deep_rows else
                          ("bilinear128", parent_wide) if name in wide_rows else
                          ("bilinear", parent_bil))
            pplan = parent.ScalePlan(*plans[name].key)
            if name == deep_chunks:
                fn = partial(streamed(DEEP_STREAM_CHUNKS, parent_deep), pplan)
            else:
                fn = as_rows(pmod, pplan, chunks_of.get(name, 0))
            parent_fns.setdefault(name, []).append((label, kind, fn))
    for name in sorted(bilinear_rows):
        plan = plans[name]
        if bilinear.stage_table(plan.x, plan.meta_in.n_bytes)[0]:
            continue
        for form in bilinear.direct_forms(plan):
            if form != bilinear.direct_form(plan):
                parent_fns.setdefault(name, []).append(
                    (f"this tree's {bilinear.FORMS[form]} form", "bilinear",
                     as_rows(bilinear, plan, chunks_of.get(name, 0), (form,))))
    for name in sorted(wide_rows):
        plan = plans[name]
        for form in bilinear128.forms(plan):
            if form != bilinear128.form(plan):
                parent_fns.setdefault(name, []).append(
                    (f"this tree's {bilinear128.FORMS[form]} form", "bilinear128",
                     as_rows(bilinear128, plan, chunks_of.get(name, 0), (form,))))
    for name, fns_ in parent_fns.items():
        for label, kind, fn in fns_:
            got = fn(inputs[name])
            check(kind, f"{name} on {label}'s {kind} kernel",
                  torch.cat(got, dim=-3) if isinstance(got, list) else got,
                  kernels[kind][1](plans[name], inputs[name]))
    times, bounds = {}, {}
    for (name, _, batch), kernel_fn, plain_fn in timed:
        plan, xin = plans[name], inputs[name]
        p1 = cuda_time_ms(lambda: plain_fn(plan, xin), warmup=1, iters=5)
        ks, ps = [], [[] for _ in parent_fns.get(name, ())]
        for _ in range(5):
            ks.append(cuda_time_ms(lambda: kernel_fn(plan, xin)))
            for turns, (_, _, fn) in zip(ps, parent_fns.get(name, ())):
                turns.append(cuda_time_ms(lambda: fn(xin)))
        p2 = cuda_time_ms(lambda: plain_fn(plan, xin), warmup=1, iters=5)
        k_ms, p_ms = statistics.median(ks), (p1 + p2) / 2
        times[name] = (k_ms, p_ms)
        pix = batch * plan.height_in * plan.width_in
        in_bytes = pix * plan.meta_in.n_bytes
        out_bytes = batch * plan.height_out * plan.width_out * plan.meta_out.n_bytes
        bounds[name] = bound_ms(in_bytes, out_bytes)
        routed = (f" ({bilinear128.FORMS[bilinear128.form(plan)]} routed)"
                  if name in wide_rows else "")
        log(f"[bound] {name}: {bounds[name]:.4f} ms ({in_bytes} + {out_bytes} bytes at "
            f"{HBM_PEAK_GBS:.0f} GB/s); kernel{routed} at {100 * bounds[name] / k_ms:.1f}% of "
            f"it, on {card}")
        for label, ms, turns in (("kernel", k_ms, ks), ("plain", p_ms, (p1, p2))):
            sec = ms / 1e3
            in_gbs, out_gbs = in_bytes / 1e9 / sec, out_bytes / 1e9 / sec
            spread = f", min-max {min(turns):.4f}-{max(turns):.4f}" if len(turns) > 2 else ""
            log(f"[time] {name} {label}: {ms:.4f} ms (turns "
                f"{', '.join(f'{t:.4f}' for t in turns)}{spread}), {pix / 1e6 / sec:.1f} Mpix/s, "
                f"{in_gbs:.1f} GB/s of "
                f"input ({100 * in_gbs / HBM_PEAK_GBS:.1f}% of {HBM_PEAK_GBS:.0f} GB/s), "
                f"{out_gbs:.1f} GB/s of output (in + out "
                f"{100 * (in_gbs + out_gbs) / HBM_PEAK_GBS:.1f}%), on {card}")
        for turns, (label, kind, _) in zip(ps, parent_fns.get(name, ())):
            pm = statistics.median(turns)
            what = label if label.startswith("this tree") else f"{label}'s {kind} kernel"
            log(f"[compare] {name}: {what} {pm:.4f} ms (turns "
                f"{', '.join(f'{t:.4f}' for t in turns)}, min-max {min(turns):.4f}-"
                f"{max(turns):.4f}; {100 * bounds[name] / pm:.1f}% of the bound), this tree "
                f"{k_ms:.4f} ms, in turns; {pm / k_ms:.2f}x, on {card}")

    # the copy row's library call: COPY x COPY between identical formats is
    # the identity, so torch.Tensor.clone gives its bytes; in turns with the
    # general kernel (the port never calls it)
    plan, xin = plans["copy"], inputs["copy"]
    check("bilinear", f"copy {plan.key}: torch.Tensor.clone", xin.clone(),
          bilinear.scale_fn(plan, xin))
    ks, cs = [], []
    for _ in range(5):
        ks.append(cuda_time_ms(lambda: bilinear.scale_fn(plan, xin)))
        cs.append(cuda_time_ms(xin.clone))
    library_ms = {"copy": statistics.median(cs)}
    log(f"[library] copy {plan.key}: torch.Tensor.clone {library_ms['copy']:.4f} ms (turns "
        f"{', '.join(f'{t:.4f}' for t in cs)}, min-max {min(cs):.4f}-{max(cs):.4f}; "
        f"{100 * bounds['copy'] / library_ms['copy']:.1f}% of the bound), the general kernel "
        f"{statistics.median(ks):.4f} ms (turns {', '.join(f'{t:.4f}' for t in ks)}), in "
        f"turns, on {card}")

    # row 5: the pyramid kernel, its plain version, and the same levels level
    # by level on the general kernel (three launches, each reading the batch)
    def levels_on_bilinear():
        for p_ in plans5:
            bilinear.scale_fn(p_, x5)

    p1 = cuda_time_ms(lambda: pyramid.pyramid_scale_ref(plans5, x5), warmup=1, iters=3)
    k1 = cuda_time_ms(lambda: pyramid.pyramid_fn(plans5, x5))
    l1 = cuda_time_ms(levels_on_bilinear)
    k2 = cuda_time_ms(lambda: pyramid.pyramid_fn(plans5, x5))
    l2 = cuda_time_ms(levels_on_bilinear)
    p2 = cuda_time_ms(lambda: pyramid.pyramid_scale_ref(plans5, x5), warmup=1, iters=3)
    k_ms, p_ms, l_ms = (k1 + k2) / 2, (p1 + p2) / 2, (l1 + l2) / 2
    times[name5] = (k_ms, p_ms)
    in_bytes = x5.numel()
    out_bytes = sum(batch5 * p_.height_out * p_.width_out * 4 for p_ in plans5)
    bounds[name5] = bound_ms(in_bytes, out_bytes)
    for label, ms, turns in (("kernel", k_ms, (k1, k2)), ("plain", p_ms, (p1, p2)),
                             ("level by level on bilinear.cu", l_ms, (l1, l2))):
        gbs = (in_bytes + out_bytes) / 1e9 / (ms / 1e3)
        log(f"[time] {name5} {label}: {ms:.4f} ms (turns {turns[0]:.4f}, {turns[1]:.4f}), "
            f"{batch5 / (ms / 1e3):.1f} pyramids/s, {gbs:.1f} GB/s in + out "
            f"({100 * gbs / HBM_PEAK_GBS:.1f}% of {HBM_PEAK_GBS:.0f} GB/s), on {card}")
    log(f"[bound] {name5}: {bounds[name5]:.4f} ms ({in_bytes} + {out_bytes} bytes at "
        f"{HBM_PEAK_GBS:.0f} GB/s); kernel at {100 * bounds[name5] / k_ms:.1f}% of it, "
        f"level by level at {100 * bounds[name5] / l_ms:.1f}%, on {card}")

    # row 5b resident: every sub-batch uploaded first, then all of them
    # called back to back (host clock to a synchronize, and an event pair)
    fns = {key: stt.make_pyramid_fn(key[0][1], key[0][0], key[1], sizes=FLEET_SIZES)
           for key in group_plans}
    resident = []
    for key, sub, size in batches:
        idx = sub + [sub[-1]] * (size - len(sub))
        resident.append((key, fns[key],
                         torch.from_numpy(np.stack([images[i] for i in idx])).to(dev)))
    fleet_in_bytes = sum(xb.numel() for _, _, xb in resident)

    def sweep(group=None):
        for key, fn, xb in resident:
            if group is None or key == group:
                fn(xb)

    sweep()
    torch.cuda.synchronize()
    walls, windows = [], []
    for _ in range(3):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        sweep()
        end.record()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        windows.append(start.elapsed_time(end))
    wall = min(walls)
    log(f"[time] row 5b resident: {len(images) / wall:.1f} pyramids/s ({len(images)} images, "
        f"{len(resident)} sub-batches of {fleet_in_bytes} input bytes, best of 3 sweeps "
        f"{wall * 1e3:.3f} ms host clock, {[round(w, 4) for w in windows]} ms device "
        f"windows), on {card}")
    # each group's share of the sweep, beside its bound; a whole sweep is
    # queued first, so that no group's window waits for the host's enqueue
    marks = []
    sweep()
    for key in group_plans:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        sweep(key)
        end.record()
        marks.append((key, start, end))
    torch.cuda.synchronize()
    for key, start, end in marks:
        xbs = [xb for k, _, xb in resident if k == key]
        n_img = sum(xb.shape[0] for xb in xbs)
        g_in = sum(xb.numel() for xb in xbs)
        g_out = n_img * sum(sz * sz for sz in FLEET_SIZES) * key[0][2]
        ms = start.elapsed_time(end)
        route = ("pyramid kernel" if pyramid.applicable(group_plans[key]) else
                 " + ".join(kernel_of(p_) for p_ in group_plans[key]) + ", level by level")
        log(f"[time] row 5b resident group {key}: {ms:.4f} ms device for {n_img} images "
            f"({len(xbs)} calls, {route}), {n_img / (ms / 1e3):.1f} pyramids/s; bound "
            f"{bound_ms(g_in, g_out):.4f} ms ({g_in} + {g_out} bytes), "
            f"{100 * bound_ms(g_in, g_out) / ms:.1f}% of it, on {card}")
    # 5b's 384^2 group level by level (64^2, 128^2, 256^2 apart) over its
    # sub-batches, on the general kernel, in turns with each other
    # checkout's and with this tree's other forms of the direct path
    key384 = next(k for k in group_plans if k[0][:2] == (384, 384))
    xbs = [xb for k, _, xb in resident if k == key384]
    n384, in384 = sum(xb.shape[0] for xb in xbs), sum(xb.numel() for xb in xbs)
    for p_ in group_plans[key384]:
        if kernel_of(p_) != "bilinear":
            raise AssertionError(f"5b's 384^2 level {p_.key} is not on the general kernel")
        runs = [("this tree", partial(lambda p_: [bilinear.scale_fn(p_, xb) for xb in xbs], p_))]
        for label, parent, _, _, parent_bil, _ in parents:
            runs.append((f"{label}'s general kernel", partial(
                lambda pp: [parent_bil.scale_fn(pp, xb) for xb in xbs],
                parent.ScalePlan(*p_.key))))
        for form in bilinear.direct_forms(p_):
            if form != bilinear.direct_form(p_):
                runs.append((f"this tree's {bilinear.FORMS[form]} form", partial(
                    lambda p_, form: [bilinear.scale_fn(p_, xb, form) for xb in xbs], p_, form)))
        want = runs[0][1]()
        for label, fn in runs[1:]:
            if not all(torch.equal(a, b) for a, b in zip(fn(), want)):
                raise AssertionError(f"5b 384^2 -> {p_.width_out}^2: {label} differs")
        turns = [[] for _ in runs]
        for _ in range(5):
            for t, (_, fn) in zip(turns, runs):
                t.append(cuda_time_ms(fn, warmup=1, iters=5))
        bound = bound_ms(in384, n384 * p_.width_out * p_.height_out * 4)
        for (label, _), t in zip(runs, turns):
            ms = statistics.median(t)
            log(f"[time] 5b 384^2 -> {p_.width_out}^2 level ({n384} images, {len(xbs)} "
                f"launches, {bilinear.FORMS[bilinear.direct_form(p_)]} routed): {label} "
                f"{ms:.4f} ms (turns {', '.join(f'{v:.4f}' for v in t)}, min-max {min(t):.4f}-"
                f"{max(t):.4f}); bound {bound:.4f} ms, {100 * bound / ms:.1f}% of it, on {card}")
    del resident, fns, xbs, want
    cold = list(range(0, len(images), len(images) // FLEET_COLD))[:FLEET_COLD]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stt.scale_pyramid_mixed([images[i] for i in cold], [types[i] for i in cold],
                            sizes=FLEET_SIZES, max_batch_bytes=FLEET_BATCH_BYTES)
    cold_s = time.perf_counter() - t0
    log(f"[time] row 5b cold: {len(cold) / cold_s:.1f} pyramids/s end to end on {len(cold)} "
        f"images ({cold_s:.3f} s: stacking, upload, kernels, download), on {card}")

    # 6. back-to-back calls of the public entry point: host clock for the
    # enqueue, an event pair for the device window
    calls = {name: (lambda plan=plans[name], xin=inputs[name]: stt.scale(plan, xin))
             for name in BUSY_ROWS if name in plans}
    calls[name5] = lambda: pyr_fn(x5)
    for name in BUSY_ROWS:
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for _ in range(10):
            calls[name]()
        end.record()
        host_ms = (time.perf_counter() - t0) * 1e3 / 10
        torch.cuda.synchronize()
        window = start.elapsed_time(end)
        log(f"[busy] {name} unprofiled: host {host_ms:.4f} ms per call to enqueue; "
            f"event window {window:.4f} ms for 10 calls, so the kernel's "
            f"{times[name][0]:.4f} ms x10 fills {100 * 10 * times[name][0] / window:.1f}% "
            f"of it, on {card}")

    # 7. the split over a device list: each result byte-equal to the
    # unsplit scale on card 0; the unsplit results are made first, then the
    # counts set to 0 and the split paths driven
    from smolscale_tpu_torch import cli, parallel

    t_phase = time.perf_counter()
    n_cards = torch.cuda.device_count()
    every = parallel.default_mesh()
    meshes = [("every card", every), ("cuda:0 x2", parallel.default_mesh(devices=[dev] * 2)),
              ("cuda:0 x4", parallel.default_mesh(devices=[dev] * 4))]
    quad = meshes[2][1]
    rows4 = parallel.DeviceMesh(quad.devices, ("rows",))
    grid = parallel.default_mesh(("dp", "rows"), devices=[dev] * 4)
    plan0, x0 = plans["row 0"], inputs["row 0"]
    plan4, x4 = plans[stream_name], inputs[stream_name][0]
    plan_few = stt.ScalePlan(2000, 2000, 7, 3, 0, 0)  # deep box, 3 output rows over 4 shards
    x_few = view_input(x, plan_few, 1)[0]
    plan6, x6 = plans["row 6"], inputs["row 6"]
    fleet_idx = list(range(0, len(images), len(images) // 200))[:200]
    fleet_imgs, fleet_types = [images[i] for i in fleet_idx], [types[i] for i in fleet_idx]
    unsplit = {"row 0": stt.scale(plan0, x0), "row 4": stt.scale(plan4, x4),
               "few": stt.scale(plan_few, x_few), "row 6": stt.scale(plan6, x6),
               "row 5": pyr_fn(x5)}
    fleet_want = stt.scale_pyramid_mixed(fleet_imgs, fleet_types, sizes=FLEET_SIZES)
    parallel.dryrun_multichip(4, dev)
    parallel.dryrun_multichip(16, dev)
    log(f"[split] dryrun_multichip over 4 and 16 entries of {dev}: each flavour == unsplit")

    def same(label, got, want):
        torch.cuda.synchronize()
        if got.device != dev or tuple(got.shape) != tuple(want.shape) or not torch.equal(got, want):
            raise AssertionError(f"[split] {label}: differs from the unsplit scale on {dev}")
        log(f"[split] {label}: == unsplit scale, shape {tuple(got.shape)} on {got.device}")

    split_expect = dict.fromkeys(level_kernels, 0)
    for _, mesh in meshes:
        split_expect["box"] += mesh.shape["dp"]
    split_expect["bilinear"] += 4
    row_kernel = next(m for m in torch_ops.ROW_KERNELS if m.applicable(plan_few))
    split_expect[next(k for k, m in level_kernels.items() if m is row_kernel)] += 3
    split_expect["bilinear128"] += 4
    split_expect["pyramid"] += every.shape["dp"] + quad.shape["dp"]
    fleet_groups = dict.fromkeys((img.shape, pt) for img, pt in zip(fleet_imgs, fleet_types))
    for shape_, pt in fleet_groups:
        gplans = tuple(stt.ScalePlan(shape_[1], shape_[0], sz, sz, pt, pt, False)
                       for sz in FLEET_SIZES)
        if pyramid.applicable(gplans):
            split_expect["pyramid"] += quad.shape["dp"]
        else:
            for p_ in gplans:
                split_expect[kernel_of(p_)] += quad.shape["dp"]
    for mod in level_kernels.values():
        mod.launches = 0
    got = {name: parallel.make_batched_scale(plan0, mesh)(x0) for name, mesh in meshes}
    got["row 4"] = parallel.make_row_sharded_scale(plan4, rows4)(x4)
    got["few"] = parallel.make_row_sharded_scale(plan_few, rows4)(x_few)
    got["row 6"] = parallel.make_sharded_batch_step(plan6, grid)(x6)
    got["row 5 every card"] = stt.make_pyramid_fn(w5, h5, pt5, sizes=sizes5, mesh=every)(x5)
    got["row 5 cuda:0 x4"] = stt.make_pyramid_fn(w5, h5, pt5, sizes=sizes5, mesh=quad)(x5)
    fleet_got = stt.scale_pyramid_mixed(fleet_imgs, fleet_types, sizes=FLEET_SIZES, mesh=quad)
    torch.cuda.synchronize()
    split_launches = {k: m.launches for k, m in level_kernels.items()}
    log(f"[split] kernel launches in the split paths: {split_launches}, expected {split_expect}")
    if split_launches != split_expect:
        raise AssertionError("the split paths did not launch each kernel once per shard")
    for name, mesh in meshes:
        same(f"row 0 {plan0.key} batch 8 through make_batched_scale over {name} "
             f"({mesh.shape['dp']} shards)", got[name], unsplit["row 0"])
    same(f"row 4 {plan4.key} through make_row_sharded_scale over 4 row shards", got["row 4"],
         unsplit["row 4"])
    same(f"{plan_few.key} (3 rows) through make_row_sharded_scale over 4 row shards",
         got["few"], unsplit["few"])
    same(f"row 6 {plan6.key} batch 8 through make_sharded_batch_step on a 2 x 2 mesh",
         got["row 6"], unsplit["row 6"])
    for name in ("row 5 every card", "row 5 cuda:0 x4"):
        for g, w in zip(got[name], unsplit["row 5"]):
            same(f"{name}: make_pyramid_fn(mesh=...) level {tuple(w.shape[1:3])}", g, w)
    for i, (g, w) in enumerate(zip(fleet_got, fleet_want)):
        if not all(np.array_equal(a, b) for a, b in zip(g, w)):
            raise AssertionError(f"[split] fleet image {fleet_idx[i]}: differs from unsplit")
    log(f"[split] scale_pyramid_mixed over cuda:0 x4: {len(fleet_imgs)} images in "
        f"{len(fleet_groups)} groups == unsplit")
    del got, unsplit

    # the split layer's overhead: row 0 over a one-entry mesh beside the
    # unsplit scale, host clock to a synchronize, in turns
    one = parallel.make_batched_scale(plan0, parallel.default_mesh(devices=[dev]))

    def wall_ms(fn, n=30):
        ts = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(ts)

    turns = [wall_ms(lambda: stt.scale(plan0, x0)), wall_ms(lambda: one(x0)),
             wall_ms(lambda: one(x0)), wall_ms(lambda: stt.scale(plan0, x0))]
    log(f"[split] row 0 host clock per call (median of 30, to a synchronize): unsplit "
        f"{(turns[0] + turns[3]) / 2:.4f} ms (turns {turns[0]:.4f}, {turns[3]:.4f}), over a "
        f"one-entry mesh {(turns[1] + turns[2]) / 2:.4f} ms (turns {turns[1]:.4f}, "
        f"{turns[2]:.4f}), on {card}")
    log(f"[split] phase in {time.perf_counter() - t_phase:.1f} s ({n_cards} card(s))")

    # 8. the CLI: check's default sweep for one colour, generate, benchmarks
    import contextlib
    import io

    from smolscale_tpu_torch.utils import png

    t_phase = time.perf_counter()

    def run_cli(argv):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
        return rc, buf.getvalue().splitlines(), time.perf_counter() - t0

    for mod in level_kernels.values():
        mod.launches = 0
    rc, lines, secs = run_cli(["check", "--colors", "1"])
    check_launches = {k: m.launches for k, m in level_kernels.items()}
    for line in [ln for ln in lines if ln.startswith("FAIL")][:20] + lines[-2:]:
        log(f"[cli] {line}")
    n_cases = sum(1 for _ in cli._check_cases(False, 1))
    log(f"[cli] check --colors 1: exit {rc}, {n_cases} cases in {secs:.1f} s, kernel "
        f"launches {check_launches}, on {card}")
    # every case has one output row or column: one launch of the bilinear
    # or the 128bpp kernel each, and none of the box, deep box or pyramid
    if rc != 0:
        raise AssertionError(f"cli check: exit {rc}")
    if (sum(check_launches.values()) != n_cases
            or check_launches["bilinear"] + check_launches["bilinear128"] != n_cases):
        raise AssertionError(f"cli check: {check_launches} kernel launches for {n_cases} "
                             "cases, not one launch of bilinear or bilinear128 each")
    gen_dir = Path(__file__).resolve().parent / "build" / "cli"
    gen_dir.mkdir(parents=True, exist_ok=True)
    src = np.random.default_rng(11).integers(0, 256, (300, 400, 4), dtype=np.uint8)
    png.write_png(gen_dir / "in.png", src)
    rc, lines, secs = run_cli(["generate", str(gen_dir / "in.png"), str(gen_dir / "out"), "3"])
    if rc != 0 or len(lines) != 3:
        raise AssertionError(f"cli generate: exit {rc}, {lines}")
    for path in lines:
        out = png.read_png(path)
        want = stt.scale_simple(src, stt.PixelType.RGBA8_UNASSOCIATED, out.shape[1],
                                out.shape[0], device="cpu").numpy()
        if not np.array_equal(out, want):
            raise AssertionError(f"cli generate: {path} differs from the plain version")
    log(f"[cli] generate: {len(lines)} PNGs of {src.shape} == plain version, {secs:.2f} s")
    for argv in (["benchmark", "--steps", "4", "--reps", "2"], ["benchmark-conv", "--reps", "1"]):
        for mod in level_kernels.values():
            mod.launches = 0
        rc, lines, secs = run_cli(argv)
        if rc != 0:
            raise AssertionError(f"cli {argv[0]}: exit {rc}")
        for line in lines:
            log(f"[cli] {line}")
        log(f"[cli] {' '.join(argv)}: {secs:.1f} s, kernel launches "
            f"{ {k: m.launches for k, m in level_kernels.items()} }, on {card}")
    log(f"[cli] phase in {time.perf_counter() - t_phase:.1f} s")

    # 9. the differential fuzz: FUZZ_CASES cases of every mode at a fixed
    # seed, each through every kernel that takes it against its plain version
    from smolscale_tpu_torch import fuzz

    def fuzz_log(line):
        if ": OK (" not in line:  # a failure, or a case with one
            log(f"[fuzz] {line}")

    t_phase = time.perf_counter()
    fuzz_launches = dict.fromkeys(fuzz.KERNELS, 0)
    box_forms, deep_lanes, wide_forms = set(), set(), set()
    for k, mode in enumerate(fuzz.MODES):
        report = fuzz.run(mode, FUZZ_CASES, FUZZ_SEED + k, dev, log=fuzz_log)
        for line in report.lines():
            log(f"[fuzz] {line}")
        if report.failed():
            raise AssertionError(f"fuzz --{mode}: {report.fails[:10]}, target missed on "
                                 f"cases {report.missed[:10]}")
        for name, n in report.launches.items():
            fuzz_launches[name] += n
        box_forms |= report.cover["box forms"]
        deep_lanes |= report.cover["deep lanes"]
        wide_forms |= report.cover["bilinear128 forms"]
    log(f"[fuzz] {len(fuzz.MODES)} modes x {FUZZ_CASES} cases: launches {fuzz_launches}, box "
        f"forms {sorted(box_forms)}, deep lanes {sorted(deep_lanes)}, 128bpp forms "
        f"{sorted(wide_forms)}, phase in {time.perf_counter() - t_phase:.1f} s, on {card}")
    if (not all(fuzz_launches.values()) or box_forms != set(box.FORMS.values())
            or len(deep_lanes) < 2 or wide_forms != set(bilinear128.FORMS.values())):
        raise AssertionError("the fuzz did not reach every kernel, every box form, more "
                             "than one deep lane count and every 128bpp form")

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
            "launches": box_launches + fleet_launches["box"],
            "max_abs_err": err["box"],
            "ms": times["row 0"][0],
            "plain_ms": times["row 0"][1],
            "bound_ms": bounds["row 0"],
            "bound_by": "bytes",
            "library_ms": None,
        },
        {
            "name": "bilinear_scale",
            "route": "cuda",
            "source": "smolscale_tpu_torch/csrc/bilinear.cu",
            "replaces": "smolscale_tpu/ops/pallas_bilinear.py:1482",
            "launches": bilinear_launches + a1_launches["bilinear"] + fleet_launches["bilinear"],
            "max_abs_err": err["bilinear"],
            "ms": times["row 1b"][0],
            "plain_ms": times["row 1b"][1],
            "bound_ms": bounds["row 1b"],
            "bound_by": "bytes",
            "library_ms": None,
        },
        {
            "name": "deep_box",
            "route": "cuda",
            "source": "smolscale_tpu_torch/csrc/deep.cu",
            "replaces": "smolscale_tpu/ops/pallas_deep.py:238,469,911",
            "launches": deep_launches + a1_launches["deep"] + fleet_launches["deep"],
            "max_abs_err": err["deep"],
            "ms": times["row 9"][0],
            "plain_ms": times["row 9"][1],
            "bound_ms": bounds["row 9"],
            "bound_by": "bytes",
            "library_ms": None,
        },
        {
            "name": "bilinear128_scale",
            "route": "cuda",
            "source": "smolscale_tpu_torch/csrc/bilinear128.cu",
            "replaces": "smolscale_tpu/ops/pallas_128.py:86; smolscale_tpu/ops/pallas_srgb.py:162,415",
            "launches": (wide_launches + a1_launches["bilinear128"]
                         + fleet_launches["bilinear128"]),
            "max_abs_err": err["bilinear128"],
            "ms": times["row 6"][0],
            "plain_ms": times["row 6"][1],
            "bound_ms": bounds["row 6"],
            "bound_by": "bytes",
            "library_ms": None,
        },
        {
            "name": "pyramid_scale",
            "route": "cuda",
            "source": "smolscale_tpu_torch/csrc/pyramid.cu",
            "replaces": "smolscale_tpu/ops/pallas_pyramid.py:276",
            "launches": row5_launches + fleet_launches["pyramid"],
            "max_abs_err": err["pyramid"],
            "ms": times[name5][0],
            "plain_ms": times[name5][1],
            "bound_ms": bounds[name5],
            "bound_by": "bytes",
            "library_ms": None,
        },
    ]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
