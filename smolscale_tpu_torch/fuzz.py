"""Differential fuzz on the card: random plans through every kernel that
takes them, held byte for byte against the kernels' plain versions.

Counterpart of ``benchmarks/fuzz_tpu.py``.  Each case is a plan (or a
pyramid level set), a batch, the input's byte offset and one output row
range, drawn by :func:`draw` from a numpy ``Generator``.  Each case runs
whole through every one of ``box``, ``bilinear``, ``deep`` and
``bilinear128`` whose class holds it (box x box past 64:1 on both ``box.cu``
and ``deep.cu``), its row range through every kernel of
``torch_ops.ROW_KERNELS`` whose class holds it, a level set through
``ops.pyramid.pyramid_fn``, and the public ``scale`` on each plan; a plan
on ``bilinear.cu``'s direct path, or on ``bilinear128.cu`` with 3-byte
input, also runs, whole and by rows, in each of its forms that fits
(``ops.bilinear.direct_forms``, ``ops.bilinear128.forms``) beside the one it
is routed to.  Every result is held against that module's plain version on
the same input on the card; rows against those rows of the plain whole
image.

    python -m smolscale_tpu_torch.fuzz [N] [seed] [--MODE]

Modes (each resamples until its condition holds): none (uniform sizes 16 to
1600 x 1200, outputs up to 2x, all types, sRGB on half), ``--edges`` (tiny
sizes, deep down- and upscales), ``--mixed`` (one axis COPY or ONE),
``--up`` (bilinear upscales on ``bilinear.cu``), ``--box`` (``box.cu``: its
three forms at the edges of its warps, blocks and row splits), ``--deep``
(``deep.cu``: covers on both sides of 16, 32, 64 and 128 words, PREMUL16,
linear light, 3-byte pixels), ``--staged`` (``bilinear.cu``'s staged X box
at its tile edges), ``--s128`` (``bilinear128.cu``: narrow tiles and tile
edges, PREMUL16 on 2 of 4 draws, 3-byte input on 1 of 4), ``--pyramid``
(``pyramid.cu``: 2-3 levels at ratios 2, 4 and 8), ``--tall`` (more than
65,535 output rows in a batch, and more than 65,535 images on ``deep.cu``:
the grid loops) and ``--band``
(the deep-ratio overflow band of ``tests/test_fuzz_differential.py``: spans
of 4,096-65,535 pixels from unassociated input near saturation).
``fuzz_tpu.py``'s ``--boxchunk`` and ``--copyaxes`` are ``--box``'s forms
here, its ``--box3`` is ``--staged``; its ``--vchunk`` aimed at a V matmul
split that only the TPU kernel has, and has no counterpart.

Two faults byte equality alone misses are caught too: before each kernel
call a block of the output's size is filled with 0xA5 and freed, so that
the caching allocator hands it to the kernel's output and a pixel the
kernel never writes shows as a mismatch; and each kernel runs twice on the
same input, and the two results must agree.  A result is ``ok``,
``mismatch`` (differs from the plain version), ``exc`` (raised) or
``flaky`` (the two runs differ); every class but ``ok`` is a failure.

The fuzz runs on the card only: without a CUDA device it raises, since on
the CPU a kernel is its plain version.  :func:`draw` needs no card, so CPU
tests replay it.
"""

from __future__ import annotations

import dataclasses
import math
import sys
import time
from functools import partial

import numpy as np
import torch

import smolscale_tpu_torch as stt
from .backends import torch_ops
from .formats import get_meta
from .ops import bilinear, bilinear128, box, deep, pixels, pyramid
from .plan import ScalePlan

MODES = ("uniform", "edges", "mixed", "up", "box", "deep", "staged", "s128", "pyramid",
         "tall", "band")
# each whole-image kernel with its plain version, in dispatch order
WHOLE = (("box", box, box.box_scale_ref),
         ("bilinear", bilinear, bilinear.bilinear_scale_ref),
         ("deep", deep, deep.deep_scale_ref),
         ("bilinear128", bilinear128, bilinear128.bilinear128_scale_ref))
KERNELS = {"box": box, "bilinear": bilinear, "deep": deep, "bilinear128": bilinear128,
           "pyramid": pyramid}
MAX_INPUT_BYTES = 256 * 2**20
# a batch is this many distinct images repeated: the plain versions run on
# those only (7 divides neither 2^16 nor 65535, so an image taken for another
# past a grid's limit differs)
DISTINCT = 7
POISON = 0xA5
GRID_ROWS = 65535
# the eight plans of tests/test_fuzz_differential.py:67-76
BAND_PLANS = [
    (5000, 2, 1, 2, 4, 4, True),
    (40000, 2, 1, 2, 4, 4, False),
    (4113, 3, 1, 1, 4, 5, True),
    (8191, 2, 1, 1, 6, 7, True),
    (65535, 1, 1, 1, 4, 4, False),
    (33000, 2, 1, 2, 7, 4, False),
    (2, 65535, 2, 1, 5, 5, False),
    (3, 8191, 1, 1, 4, 6, True),
]


@dataclasses.dataclass(frozen=True)
class Case:
    """One draw: plan keys ``(w_in, h_in, w_out, h_out, type_in, type_out,
    with_srgb)`` (two or more: a pyramid level set of one source), the
    batch, the input's byte offset, the output rows ``(first, n)`` of the
    first plan, the seed of the images, the kernel module the mode aims at
    (or None) and whether the images are the overflow band's (channels
    128-255, the last byte 255)."""

    keys: tuple
    batch: int
    offset: int
    rows: tuple
    seed: int
    target: str | None = None
    band: bool = False

    def plans(self) -> tuple:
        return tuple(ScalePlan(*k) for k in self.keys)

    def input_shape(self) -> tuple:
        w, h, _, _, ti = self.keys[0][:5]
        return self.batch, h, w, get_meta(ti).n_bytes


def _int(rng, lo, hi):
    """An int in [lo, hi)."""
    return int(rng.integers(lo, hi))


def _types(rng):
    return _int(rng, 0, 10), _int(rng, 0, 10), bool(rng.integers(0, 2))


def _log_int(rng, lo, hi):
    """An int in [lo, hi], log-uniform."""
    return min(hi, int(math.exp(rng.uniform(math.log(lo), math.log(hi + 1)))))


def _fits(key, batch=1) -> bool:
    w, h, wo, ho, ti, to = key[:6]
    return (max(w, h, wo, ho) <= 65535
            and batch * w * h * get_meta(ti).n_bytes <= MAX_INPUT_BYTES
            and batch * wo * ho * get_meta(to).n_bytes <= MAX_INPUT_BYTES)


def _draw_uniform(rng, index):
    wi, hi = _int(rng, 16, 1600), _int(rng, 16, 1200)
    wo, ho = _int(rng, 1, max(2, wi * 2)), _int(rng, 1, max(2, hi * 2))
    return [(wi, hi, wo, ho, *_types(rng))], None, None


def _draw_edges(rng, index):
    kind = _int(rng, 0, 3)
    if kind == 0:  # tiny everything
        wi, hi, wo, ho = (_int(rng, 1, 64) for _ in range(4))
    elif kind == 1:  # deep downscale (past 8191:1 the gamma falls back)
        wi, hi = _int(rng, 512, 4096), _int(rng, 512, 4096)
        wo, ho = _int(rng, 1, 16), _int(rng, 1, 16)
    else:  # deep upscale from tiny
        wi, hi = _int(rng, 1, 32), _int(rng, 1, 32)
        wo, ho = _int(rng, 64, 2048), _int(rng, 64, 2048)
    return [(wi, hi, wo, ho, *_types(rng))], None, None


def _draw_mixed(rng, index):
    fd_in = _int(rng, 8, 2048)
    fd_out = _int(rng, 1, max(2, fd_in * 2))
    if rng.integers(0, 2):  # ONE: a trivial axis of one input pixel
        td_in, td_out = 1, _int(rng, 1, 512)
    else:  # COPY
        td_in = td_out = _int(rng, 1, 1024)
    if rng.integers(0, 2):
        wi, wo, hi, ho = td_in, td_out, fd_in, fd_out
    else:
        wi, wo, hi, ho = fd_in, fd_out, td_in, td_out
    return [(wi, hi, wo, ho, *_types(rng))], None, None


def _draw_up(rng, index):
    while True:
        wi, hi = _int(rng, 16, 1200), _int(rng, 16, 1200)
        wo = _int(rng, wi, min(2400, wi * 4) + 1)
        ho = _int(rng, 16, max(17, hi * 3))
        key = (wi, hi, wo, ho, _int(rng, 0, 10), _int(rng, 0, 10), False)
        if not _fits(key):
            continue
        plan = ScalePlan(*key)
        if plan.x.filter.is_bilinear and plan.y.filter.is_bilinear and bilinear.applicable(plan):
            return [key], "bilinear", None


# the row spans at which box.launch_shape and deep.launch_shape split a
# warp's rows once more (8 * splits), and one on either side
_SPLIT_EDGES = [8 * s + d for s in (2, 4, 8) for d in (-1, 0, 1)] + [9]


def _span_edge(rng, lo=9, hi=256):
    """A span at a split edge on half of the draws, else in [lo, hi)."""
    return int(rng.choice(_SPLIT_EDGES)) if rng.integers(0, 2) else _int(rng, lo, hi)


def _draw_box(rng, index):
    kind = _int(rng, 0, 3)  # the form aimed at: box.DIRECT, COPY or STAGED
    while True:
        ti, to = _int(rng, 0, 10), _int(rng, 0, 10)
        nb = get_meta(ti).n_bytes
        if kind != box.STAGED and nb != 4:
            continue
        if kind == box.COPY:
            rx, cw = 1, 128
        elif kind == box.DIRECT:  # spans of a multiple of 16 bytes
            rx = 4 * _int(rng, 3, 64)
            cw = 32 // min(32, box._pow2_floor(rx * nb // 16))
        else:
            rx = _int(rng, 9, 256)
            cw = min(32, box._pow2_floor(max(1, box.STAGE_BYTES // (rx * nb))))
        copy_y = kind != box.COPY and rng.integers(0, 4) == 0
        ry = 1 if copy_y else _span_edge(rng)
        ho = _int(rng, 1, 65) if copy_y else _int(rng, 2, 65)
        if rng.integers(0, 2):  # a warp's or a block's edge: k * cw * wc, +- 1
            step = 4 if kind == box.COPY else 1  # COPY rows stay 16-byte multiples
            wo = _int(rng, 1, 5) * cw * (1 << _int(rng, 0, 4)) + step * _int(rng, -1, 2)
        else:
            wo = _int(rng, 2, 300)
        wo = max(wo, 1 if kind == box.COPY else 2)
        key = (rx * wo, ry * ho, wo, ho, ti, to, False)
        if not _fits(key):
            continue
        plan = ScalePlan(*key)
        if box.applicable(plan) and (kind == box.STAGED or box.form(plan) == kind):
            return [key], "box", None


def _draw_deep(rng, index):
    while True:
        ti, to, srgb = _types(rng)
        if rng.integers(0, 3) == 0:  # PREMUL16: unassociated in and out
            ti, to = _int(rng, 4, 8), _int(rng, 4, 8)
        nb = get_meta(ti).n_bytes
        # a cover of about q 16-byte words per span row: lanes 4 up to 16
        # words, 8 up to 32, 16 up to 64, 32 up to 128, then chunks
        if rng.integers(0, 4):
            q = int(rng.choice([16, 17, 32, 33, 64, 65, 128, 129]))
        else:
            q = _int(rng, 130, 700)
        rx = max(9, (q - 1) * 16 // nb + _int(rng, -8, 9))
        wo = _int(rng, 2, 41)
        wi = rx * wo + _int(rng, 0, rx)  # ragged: row skews vary
        ry = _span_edge(rng, 9, 600)
        ho = _int(rng, 2, 41)
        key = (wi, ry * ho + _int(rng, 0, ry), wo, ho, ti, to, srgb)
        if not _fits(key):
            continue
        if deep.applicable(ScalePlan(*key)):
            return [key], "deep", None


def _stage_lanes(plan: ScalePlan) -> int:
    """``bilinear.stage_table``'s lanes for the plan's X axis; -1 where it
    raises (a plan that reaches no kernel: the bilinear run then raises)."""
    try:
        return bilinear.stage_table(plan.x, plan.meta_in.n_bytes)[0]
    except ValueError:
        return -1


def _other_forms(plan: ScalePlan, mod=bilinear) -> list[int]:
    """The forms of ``bilinear.cu``'s direct path (``mod`` ``bilinear``) or
    of ``bilinear128.cu`` that fit the plan, beside the one it is routed to;
    none for a staged X box and for the kernels with one form."""
    if mod is bilinear128:
        return [f for f in bilinear128.forms(plan) if f != bilinear128.form(plan)]
    if mod is not bilinear or _stage_lanes(plan) != 0:
        return []
    return [f for f in bilinear.direct_forms(plan) if f != bilinear.direct_form(plan)]


def _draw_staged(rng, index):
    while True:
        ti, to = _int(rng, 0, 10), _int(rng, 0, 10)
        ratio = rng.uniform(8, 255)
        lanes = 1
        while lanes < 32 and int(ratio) > bilinear.LANE_READS * lanes:
            lanes *= 2
        tile = bilinear.THREADS // lanes
        if rng.integers(0, 2):
            wo = max(1, _int(rng, 1, 5) * tile + _int(rng, -1, 2))
        else:
            wo = _int(rng, 1, 600)
        wi = int(ratio * wo)
        wi += wi % wo == 0  # a non-integer ratio
        hi = _int(rng, 1, 200)
        key = (wi, hi, wo, _int(rng, 1, max(2, 2 * hi)), ti, to, False)
        if not _fits(key):
            continue
        plan = ScalePlan(*key)
        if bilinear.applicable(plan) and _stage_lanes(plan) != 0:
            return [key], "bilinear", None


def _draw_s128(rng, index):
    while True:
        wi, hi = _int(rng, 16, 2400), _int(rng, 16, 2400)
        if rng.integers(0, 2):  # tiles of 1-16 columns
            wo = _int(rng, 1, 17)
        else:  # the edges of 32-column tiles
            wo = 32 * _int(rng, 1, 21) + _int(rng, -1, 2)
        wo = min(wo, 2 * wi)
        ho = _int(rng, 1, max(2, 2 * hi))
        share = _int(rng, 0, 4)
        if share < 2:  # internal PREMUL16
            ti, to, srgb = _int(rng, 4, 8), _int(rng, 4, 8), bool(rng.integers(0, 2))
        elif share == 2:  # 3-byte input: the folded unpack and the h tile
            ti, to, srgb = _int(rng, 8, 10), _int(rng, 0, 10), bool(rng.integers(0, 2))
        else:
            ti, to, srgb = _types(rng)
        key = (wi, hi, wo, ho, ti, to, srgb)
        if _fits(key) and bilinear128.applicable(ScalePlan(*key)):
            return [key], "bilinear128", None


def _draw_pyramid(rng, index):
    while True:
        ratios = [int(r) for r in rng.permutation([2, 4, 8])[: _int(rng, 2, 4)]]
        m = max(ratios)
        wi, hi = m * _int(rng, 1, 2048 // m + 1), m * _int(rng, 1, 1600 // m + 1)
        kind = _int(rng, 0, 3)
        if kind == 0:  # premultiplied in and out
            ti, to = _int(rng, 0, 4), _int(rng, 0, 4)
        elif kind == 1:  # unassociated on one side
            ti, to = _int(rng, 4, 8), _int(rng, 0, 4)
            if rng.integers(0, 2):
                ti, to = to, ti
        else:  # 3-byte pixels
            ti, to = _int(rng, 8, 10), _int(rng, 8, 10)
        keys = [(wi, hi, wi // r, hi // r, ti, to, False) for r in ratios]
        if pyramid.applicable(tuple(ScalePlan(*k) for k in keys)):
            return keys, "pyramid", _int(rng, 1, 9)


def _draw_tall(rng, index):
    target = ("box", "deep", "bilinear", "bilinear128")[_int(rng, 0, 4)]
    while True:
        ti, to = _int(rng, 0, 10), _int(rng, 0, 10)
        srgb = False
        if target == "deep" and rng.integers(0, 2):
            # more than 65,535 images of a tiny deep box plan: grid z loops
            wo, ho, rx, ry = _int(rng, 2, 4), _int(rng, 2, 4), _int(rng, 9, 13), _int(rng, 9, 13)
            key = (rx * wo, ry * ho, wo, ho, ti, to, bool(rng.integers(0, 2)))
            batch = _int(rng, GRID_ROWS + 1, 70001)
        elif target in ("box", "deep"):
            # more than 65,535 output rows in the batch
            ho = _log_int(rng, 2, GRID_ROWS // 9)
            if target == "box" and rng.integers(0, 2):  # COPY x box
                wi = wo = _int(rng, 1, 65)
            else:
                wo = _int(rng, 2, 9)
                wi = _int(rng, 9, 40) * wo
            # about 65,536 / ho images of ry * ho rows within the input cap
            ry_max = min(GRID_ROWS // ho, MAX_INPUT_BYTES // (wi * 4 * (GRID_ROWS + 5 * ho)))
            if ry_max < 9:
                continue
            ry = _log_int(rng, 9, ry_max)
            srgb = target == "deep" and bool(rng.integers(0, 2))
            key = (wi, ry * ho, wo, ho, ti, to, srgb)
            batch = GRID_ROWS // ho + 1 + _int(rng, 0, 4)
        else:
            ho = _int(rng, 8192, GRID_ROWS + 1)
            if target == "bilinear128":
                if rng.integers(0, 4):
                    ti, to = _int(rng, 4, 8), _int(rng, 4, 8)
                else:
                    srgb = True
            key = (_int(rng, 1, 17), _int(rng, 1, GRID_ROWS + 1), _int(rng, 1, 17), ho,
                   ti, to, srgb)
            batch = GRID_ROWS // ho + 1 + _int(rng, 0, 3)
        if _fits(key, batch) and KERNELS[target].applicable(ScalePlan(*key)):
            return [key], target, batch


def _draw_band(rng, index):
    if index < len(BAND_PLANS):
        return [BAND_PLANS[index]], None, None
    while True:
        span = _int(rng, 4096, GRID_ROWS + 1)
        d_out = _int(rng, 1, GRID_ROWS // span + 1)
        d_in = span * d_out + _int(rng, 0, d_out)
        o_in, o_out = _int(rng, 1, 65), _int(rng, 1, 65)
        ti, to, srgb = _int(rng, 4, 8), _int(rng, 0, 10), bool(rng.integers(0, 2))
        if rng.integers(0, 2):
            key = (d_in, o_in, d_out, o_out, ti, to, srgb)
        else:
            key = (o_in, d_in, o_out, d_out, ti, to, srgb)
        if _fits(key):
            return [key], None, None


_DRAW = {"uniform": _draw_uniform, "edges": _draw_edges, "mixed": _draw_mixed,
         "up": _draw_up, "box": _draw_box, "deep": _draw_deep, "staged": _draw_staged,
         "s128": _draw_s128, "pyramid": _draw_pyramid, "tall": _draw_tall,
         "band": _draw_band}


def draw(mode: str, rng: np.random.Generator, index: int = 0) -> Case:
    """Case ``index`` of ``mode``, a pure function of ``rng`` (``--band``
    draws its fixed plans first).  The batch is 1-4 (1-8 for a pyramid,
    past the grid's limits for ``--tall``), the input's byte offset 0 on
    half of the draws and 1-15 on the rest, and the row range random."""
    with torch_ops.transient_plans():
        while True:
            keys, target, batch = _DRAW[mode](rng, index)
            if batch is None:
                batch = _int(rng, 1, 5)
            if _fits(keys[0], batch):
                break
    offset = 0 if rng.integers(0, 2) else _int(rng, 1, 16)
    h_out = keys[0][3]
    first = _int(rng, 0, h_out)
    return Case(tuple(keys), batch, offset, (first, _int(rng, 1, h_out - first + 1)),
                _int(rng, 0, 2**31), target, mode == "band")


# ----------------------------------------------------------------------------
# Running a case on the card
# ----------------------------------------------------------------------------

def card(device=None) -> torch.device:
    """The CUDA device the fuzz runs on; raises without one."""
    if not torch.cuda.is_available():
        raise RuntimeError("the fuzz runs the kernels on the card, and no CUDA device is "
                           "available (on the CPU a kernel is its plain version)")
    dev = torch.device(device if device is not None else "cuda")
    if dev.type != "cuda":
        raise ValueError(f"the fuzz runs on a CUDA device, not {dev}")
    return dev


def make_input(case: Case, device) -> tuple[torch.Tensor, torch.Tensor]:
    """``(distinct, x)``: up to DISTINCT images made on ``device`` from the
    case's seed, and the batch, those images repeated, as a contiguous view
    that starts ``case.offset`` bytes into a larger uint8 buffer."""
    batch, h, w, nb = case.input_shape()
    k = min(batch, DISTINCT)
    gen = torch.Generator(device=device).manual_seed(case.seed)
    distinct = torch.randint(128 if case.band else 0, 256, (k, h, w, nb), generator=gen,
                             dtype=torch.uint8, device=device)
    if case.band:
        distinct[..., -1] = 255  # saturated alpha maximises the sums
    flat = torch.empty(batch * h * w * nb + case.offset, dtype=torch.uint8, device=device)
    x = flat[case.offset:].view(batch, h, w, nb)
    x.copy_(distinct.repeat(-(-batch // k), 1, 1, 1)[:batch])
    return distinct, x


def poison(shapes, device) -> list[int]:
    """Fill a block of each output shape with POISON and free it, in the
    order a kernel allocates its outputs, so that the caching allocator
    hands the same blocks to the kernel: a byte the kernel leaves unwritten
    then reads POISON.  Returns the blocks' addresses."""
    blocks = [torch.full(tuple(s), POISON, dtype=torch.uint8, device=device) for s in shapes]
    return [b.data_ptr() for b in blocks]


def _as_tuple(out) -> tuple:
    return (out,) if isinstance(out, torch.Tensor) else tuple(out)


def _first_diff(got: torch.Tensor, want: torch.Tensor) -> str:
    if got.shape != want.shape:
        return f"shape {tuple(got.shape)}, plain {tuple(want.shape)}"
    diff = (got != want).nonzero()
    at = tuple(diff[0].tolist())
    return (f"{len(diff)} bytes differ, first at {at}: {got[at].item()}, "
            f"plain {want[at].item()}")


def check(run, want) -> tuple[str, str, int]:
    """Classify one kernel on one input: ``(status, detail, poisoned)``.

    ``want()`` gives the plain version's tensor (or tuple of tensors);
    ``run()`` calls the kernel, twice, each time after :func:`poison` of the
    outputs' shapes; ``poisoned`` counts the runs whose outputs took the
    poisoned blocks.  ``exc`` if either raised, ``flaky`` if the two runs
    differ, ``mismatch`` if they differ from the plain version, else
    ``ok``."""
    try:
        expect = _as_tuple(want())
    except Exception as e:  # a plain version that raises is a finding too
        return "exc", f"plain version raised {type(e).__name__}: {str(e)[:160]}", 0
    device = expect[0].device
    outs, poisoned = [], 0
    try:
        for _ in range(2):
            ptrs = poison([t.shape for t in expect], device)
            got = _as_tuple(run())
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            poisoned += [g.data_ptr() for g in got] == ptrs
            outs.append(got)
    except Exception as e:  # the kernel's launch failed or it raised
        return "exc", f"{type(e).__name__}: {str(e)[:160]}", poisoned
    first, second = outs
    if len(first) != len(second) or any(
            a.shape != b.shape or not torch.equal(a, b) for a, b in zip(first, second)):
        return "flaky", "the two runs differ", poisoned
    if len(first) != len(expect):
        return "mismatch", f"{len(first)} outputs, plain {len(expect)}", poisoned
    for k, (g, w) in enumerate(zip(first, expect)):
        if g.shape != w.shape or not torch.equal(g, w):
            return "mismatch", f"output {k}: {_first_diff(g, w)}", poisoned
    return "ok", "", poisoned


def _name(mod) -> str:
    return next(n for n, m in KERNELS.items() if m is mod)


def kernel_runs(case: Case, x: torch.Tensor, distinct: torch.Tensor, cover: dict) -> list:
    """``(label, run, want)`` for every kernel that takes the case (the
    general kernel's direct path in each form that fits), and the public
    ``scale`` on each plan; adds what each run covers (box forms, deep lanes
    and chunks, staged lanes, direct forms, 128bpp tile widths) to
    ``cover``."""
    batch, address = case.batch, x.data_ptr()
    reps = -(-batch // distinct.shape[0])

    def expand(t):
        return t.repeat(reps, 1, 1, 1)[:batch] if reps > 1 else t

    sms = pixels.sm_count(x.device) if x.device.type == "cuda" else pixels.H100_SMS
    plains = {}

    def plain(i, name, plan):
        if (i, name) not in plains:
            ref = next(r for n, _, r in WHOLE if n == name)
            plains[i, name] = expand(ref(plan, distinct))
        return plains[i, name]

    def note(name, plan, n_rows):
        if name == "box":
            cover["box forms"].add(box.FORMS[box.form(plan, address)])
        elif name == "deep":
            shape = deep.launch_shape(plan, batch, n_rows, address, sms)
            cover["deep lanes"].add(shape["lanes"])
            cover["deep chunks"].add(shape["chunks"])
            cover["deep readers"].add(deep.FORMS[deep.form(plan, address)])
        elif name == "bilinear":
            lanes = _stage_lanes(plan)
            cover["bilinear staged lanes"].add(lanes)
            if lanes == 0:
                cover["bilinear forms"].update(
                    bilinear.FORMS[f] for f in [bilinear.direct_form(plan)] + _other_forms(plan))
        elif name == "bilinear128":
            tile_w, _, grid_y, _ = bilinear.launch_shape(plan.width_out, 0, n_rows, batch, sms)
            cover["bilinear128 tile_w"].add(tile_w)
            cover["bilinear128 row loops"].add(
                grid_y * (bilinear.THREADS // tile_w) < n_rows)
            cover["bilinear128 forms"].update(
                bilinear128.FORMS[f] for f in [bilinear128.form(plan)]
                + _other_forms(plan, bilinear128))

    plans = case.plans()
    runs = []
    for i, plan in enumerate(plans):
        for name, mod, _ in WHOLE:
            if mod.applicable(plan):
                note(name, plan, plan.height_out)
                runs.append((f"{name} {plan.key}", partial(mod.scale_fn, plan, x),
                             partial(plain, i, name, plan)))
                for f in _other_forms(plan, mod):
                    runs.append((f"{name} {mod.FORMS[f]} {plan.key}",
                                 partial(mod.scale_fn, plan, x, f),
                                 partial(plain, i, name, plan)))
        runs.append((f"scale {plan.key}", partial(stt.scale, plan, x),
                     lambda i=i, plan=plan: plain(i, _name(torch_ops.whole_kernel(plan)), plan)))
    plan = plans[0]
    first, n = case.rows
    for mod in torch_ops.ROW_KERNELS:
        name = _name(mod)
        if mod.applicable(plan):
            note(name, plan, n)
            for f in [None] + _other_forms(plan, mod):
                runs.append((f"{name}{'' if f is None else ' ' + mod.FORMS[f]} rows "
                             f"[{first}, {first + n}) {plan.key}",
                             partial(mod.scale_rows_fn, plan, x, first, n,
                                     *(() if f is None else (f,))),
                             lambda name=name: plain(0, name, plan)[:, first : first + n]))
    if len(plans) > 1:
        runs.append((f"pyramid {[p.key[2:4] for p in plans]}",
                     partial(pyramid.pyramid_fn, plans, x),
                     lambda: tuple(expand(t) for t in pyramid.pyramid_scale_ref(plans, distinct))))
    return runs


@dataclasses.dataclass
class Report:
    """What a run of the fuzz found and reached."""

    mode: str
    counts: dict = dataclasses.field(
        default_factory=lambda: dict.fromkeys(("ok", "mismatch", "exc", "flaky"), 0))
    fails: list = dataclasses.field(default_factory=list)
    missed: list = dataclasses.field(default_factory=list)  # cases whose target never launched
    launches: dict = dataclasses.field(default_factory=lambda: dict.fromkeys(KERNELS, 0))
    cover: dict = dataclasses.field(default_factory=lambda: {
        k: set() for k in ("box forms", "deep lanes", "deep chunks", "deep readers",
                           "bilinear staged lanes", "bilinear forms", "bilinear128 tile_w",
                           "bilinear128 row loops", "bilinear128 forms")})
    poisoned: int = 0
    runs: int = 0
    cases: int = 0
    seconds: float = 0.0

    def failed(self) -> bool:
        return bool(self.fails or self.missed)

    def lines(self) -> list[str]:
        cover = "; ".join(f"{k} {sorted(v)}" for k, v in self.cover.items())
        return [
            f"COVER: {self.mode}: launches {self.launches}; {cover}; poisoned outputs "
            f"{self.poisoned}/{2 * self.runs} runs; target missed on {len(self.missed)} cases",
            f"SUMMARY: {self.mode}: cases={self.cases} runs={self.runs} "
            "ok={ok} mismatch={mismatch} exc={exc} flaky={flaky}".format(**self.counts)
            + f" in {self.seconds:.1f} s",
            f"FAILS: {self.fails}",
        ]


def run(mode: str, n: int, seed: int, device=None, log=print) -> Report:
    """``n`` cases of ``mode`` from ``seed`` on the card, one line each to
    ``log``; the report's ``lines()`` sum them up."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; one of {MODES}")
    dev = card(device)
    rng = np.random.default_rng(seed)
    report = Report(mode)
    t0 = time.perf_counter()
    before = {k: m.launches for k, m in KERNELS.items()}
    for i in range(n):
        # each case's plans are new: what the kernels cache for them goes
        with torch_ops.transient_plans():
            case = draw(mode, rng, i)
            distinct, x = make_input(case, dev)
            at_start = {k: m.launches for k, m in KERNELS.items()}
            statuses = []
            for label, run_fn, want in kernel_runs(case, x, distinct, report.cover):
                status, detail, poisoned = check(run_fn, want)
                report.counts[status] += 1
                report.runs += 1
                report.poisoned += poisoned
                statuses.append(status)
                if status != "ok":
                    report.fails.append((i, label, status))
                    log(f"[{i}] {label}: {status.upper()} {detail}")
            del distinct, x
        if case.target is not None and KERNELS[case.target].launches == at_start[case.target]:
            report.missed.append(i)
        worst = next((s for s in ("exc", "mismatch", "flaky") if s in statuses), "ok")
        log(f"[{i}] {case.keys} batch {case.batch} offset {case.offset} rows "
            f"{case.rows}: {worst.upper()} ({len(statuses)} runs)")
        report.cases += 1
    report.launches = {k: m.launches - before[k] for k, m in KERNELS.items()}
    report.seconds = time.perf_counter() - t0
    return report


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    flags = [a[2:] for a in argv if a.startswith("--")]
    args = [a for a in argv if not a.startswith("--")]
    if len(flags) > 1 or any(f not in MODES[1:] for f in flags) or len(args) > 2:
        print(f"usage: python -m smolscale_tpu_torch.fuzz [N] [seed] "
              f"[{' | '.join('--' + m for m in MODES[1:])}]", file=sys.stderr)
        return 2
    mode = flags[0] if flags else "uniform"
    n = int(args[0]) if args else 24
    seed = int(args[1]) if len(args) > 1 else 20260816
    dev = card()
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else str(dev)
    print(f"device: {name}; mode {mode}, {n} cases, seed {seed}",
          flush=True)
    report = run(mode, n, seed, dev, log=partial(print, flush=True))
    for line in report.lines():
        print(line, flush=True)
    if report.missed:
        raise RuntimeError(f"--{mode}: the target kernel did not launch on cases "
                           f"{report.missed[:20]}")
    return 1 if report.failed() else 0


if __name__ == "__main__":
    sys.exit(main())
