"""The port's 128bpp class with bilinear or box axes
(smolscale_tpu_torch.ops.bilinear128) against numpy_ref, the JAX package's
Pallas kernels in interpret mode (``pallas_128``, ``pallas_srgb`` and its
24bpp planes form through the dispatcher) and its row API and public API.

On the CPU ``bilinear128.scale_fn`` runs the kernel's plain PyTorch version;
the CUDA kernel itself is compared with it on the card (test_torch_cuda.py,
chip_smoke.py).  All arithmetic is integer: the tolerance is byte equality.
"""

import importlib.util
import json
from pathlib import Path
from unittest import mock

import jax
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import smolscale_tpu
import smolscale_tpu_torch as stt
from portbench import traffic
from smolscale_tpu import plan as ref_plan
from smolscale_tpu.backends import numpy_ref, xla
from smolscale_tpu.ops import pallas_128, pallas_srgb
from smolscale_tpu_torch import luts
from smolscale_tpu_torch.backends import torch_ops
from smolscale_tpu_torch.formats import AlphaType, GammaType, StorageType
from smolscale_tpu_torch.ops import bilinear, bilinear128, box, deep, pixels
from smolscale_tpu_torch.plan import ScalePlan

_ORIG = pl.pallas_call


def _interp_call(*a, **k):
    return _ORIG(*a, **k, interpret=True)


# tests/test_pallas_128.py:25-35, with_srgb last
COMPRESSED = [
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
]
# tests/test_pallas_srgb.py:24-33
LINEAR = [
    (512, 256, 96, 56, 4, 4, True),     # PREMUL16-linear, 2h ladder
    (512, 256, 96, 56, 4, 0, True),     # PREMUL8-linear, unassociated -> premultiplied
    (512, 256, 96, 56, 0, 0, True),     # PREMUL8-linear, premultiplied in
    (512, 256, 96, 56, 2, 5, True),     # premultiplied in -> unassociated out
    (256, 256, 200, 190, 5, 6, True),   # 0h, reorders
    (1100, 300, 80, 100, 4, 4, True),   # box H x bilinear V
    (1024, 512, 128, 64, 4, 4, True),   # uniform 2h ladder
    (1024, 512, 128, 64, 0, 0, True),   # uniform ladder, premultiplied in
    (1024, 300, 128, 30, 8, 8, True),   # 24bpp, ladder H x 10:1 box V
    (1000, 1024, 100, 128, 4, 4, True),  # box H x ladder V
]
# tests/test_pallas_srgb.py:58-63: the 24bpp pack asymmetry both ways
RGB24 = [(512, 256, 96, 56, ti, to, True)
         for ti, to in [(8, 8), (8, 9), (0, 8), (4, 9), (8, 4), (9, 0)]]
# tests/test_pallas_srgb.py:82-86: 24bpp input, the planes feed on the TPU
PLANES = [
    (512, 256, 96, 56, 8, 8, True),
    (512, 256, 96, 56, 9, 9, True),
    (512, 256, 96, 56, 8, 4, True),
    (1024, 300, 128, 30, 8, 0, True),
    (333, 200, 111, 40, 8, 8, True),
]
# tests/test_pallas_128.py:55: unassociated in and out, alpha 1
LOW_ALPHA = (64, 64, 32, 32, 4, 4, False)
# box x box with one output past 255:1: ``(5000, 5000, 1, 40, 0, 0)`` at a
# width the CPU tests and the card's checks can unpack
ONE_OUTPUT = [(2000, 400, 1, 20, 0, 0, False), (2000, 400, 1, 20, 4, 4, True)]
# COPY and ONE axes, which TPU kernels #10-#12 leave to the XLA op graph, at
# each (internal alpha, gamma) mode, beside every other kind in both axis
# orders, and on 24bpp
COPY_ONE = [
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
]
# a constant-255 image through COPY x box at PREMUL16-linear: the box's
# 16-bit mask gives (97, 97, 97, 255) beside the COPY axis too
CONST_COPY = (256, 1100, 256, 80, 4, 4, True)
# the CUDA kernel's tiles on their edges (w_out 1, 7, 64, 255, 256, 257) and
# 3-byte output at PREMUL8 compressed (S128 past 255:1)
EDGES = [
    (64, 100, 1, 90, 4, 4, False),
    (512, 300, 7, 290, 4, 4, True),
    (512, 512, 64, 64, 4, 4, False),
    (1020, 200, 255, 50, 4, 4, True),
    (1024, 200, 256, 50, 0, 0, True),
    (1028, 200, 257, 50, 4, 4, False),
    (520, 300, 2, 40, 8, 9, False),
    (520, 300, 2, 40, 0, 8, False),
]
# ROLL's class (4-byte pixels at PREMUL16 compressed or P8-linear, a 0h
# bilinear V axis beside a bilinear, COPY or ONE X axis) on its edges: a
# downscale by a pixel, a 0h upscale, fleet-5b's 2:1 level, X COPY, ONE and 1h
# and 2h ladders, and output widths 1-9 and 129, in each mode
ROLL_PLANS = [
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
ALL = list(dict.fromkeys(COMPRESSED + LINEAR + RGB24 + PLANES + [LOW_ALPHA] + ONE_OUTPUT
                         + COPY_ONE + [CONST_COPY] + EDGES + ROLL_PLANS))
# more than 65535 output rows in a batch of 3: chip_smoke.py's WIDE_TALL
TALL = ((8, 30000, 8, 30000, 4, 4, False), 3)
# (key, first, n): chip_smoke.py's WIDE_CHECK_ROWS
ROWS = [
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
# suite rows 6, 6b and 7 (benchmarks/suite.py:314-324) and chip_smoke.py's
# 6b-4k and 6b-up cut to a small size
SUITE = [
    (256, 256, 32, 32, 4, 4, True),     # row 6: sRGB, PREMUL16-linear, 2h
    (480, 270, 100, 56, 8, 8, True),    # row 6b: RGB24 sRGB, PREMUL8-linear, 2h
    (256, 256, 32, 32, 4, 4, False),    # row 7: PREMUL16, 2h
    (384, 216, 192, 108, 8, 8, True),   # 6b-4k: RGB24 sRGB, 0h 2:1
    (128, 72, 192, 108, 8, 8, True),    # 6b-up: RGB24 sRGB, 0h upscale
]
# chip_smoke.py's timed 3-byte rows at full size: (plan, routed form)
RGB24_ROWS = [
    ((1920, 1080, 400, 225, 8, 8, True), bilinear128.H_TILE),    # row 6b: 2h x 2h
    ((3840, 2160, 1920, 1080, 8, 8, True), bilinear128.LOOP),    # 6b-4k: 0h 2:1
    ((1280, 720, 1920, 1080, 8, 8, True), bilinear128.LOOP),     # 6b-up: 0h upscale
]


def _id(key):
    return "-".join(map(str, key))


def _images(key, seed, batch=2):
    rng = np.random.default_rng(seed)
    nb = stt.get_meta(key[4]).n_bytes
    return rng.integers(0, 256, (batch, key[1], key[0], nb), dtype=np.uint8)


def _spec(key, imgs):
    rp = ref_plan.ScalePlan(*key)
    return np.stack([numpy_ref.scale(rp, im) for im in imgs])


def _port(key, imgs, first=0, n=None):
    """The plain version through the wrapper; the CPU path launches
    nothing."""
    plan = ScalePlan(*key)
    n = plan.height_out if n is None else n
    before = bilinear128.launches
    got = bilinear128.scale_rows_fn(plan, torch.from_numpy(imgs), first, n)
    assert bilinear128.launches == before
    return got.numpy()


def _interpret(built, fn):
    """``fn()`` with every pallas_call in interpret mode; ``built``, the
    Pallas kernel's cached builder, must have built it."""
    built.cache_clear()
    try:
        with mock.patch.object(pl, "pallas_call", _interp_call):
            out = np.asarray(fn())
        assert built.cache_info().misses >= 1
        return out
    finally:
        built.cache_clear()


@pytest.mark.parametrize("key", ALL, ids=_id)
def test_matches_numpy_ref(key):
    plan = ScalePlan(*key)
    assert bilinear128.applicable(plan) and plan.storage == StorageType.S128
    imgs = _images(key, sum(key))
    assert np.array_equal(_port(key, imgs), _spec(key, imgs))


@pytest.mark.parametrize("key", COMPRESSED, ids=_id)
def test_vs_pallas_128_interpret(key):
    """TPU kernel #10, built for the plan and run in interpret mode."""
    rp = ref_plan.ScalePlan(*key)
    assert pallas_128.applicable(rp)
    imgs = _images(key, sum(key) + 1)
    tpu = _interpret(pallas_128._built, lambda: pallas_128.scale_fn(rp, imgs))
    assert np.array_equal(_port(key, imgs), tpu)


@pytest.mark.parametrize("key", LINEAR + RGB24, ids=_id)
def test_vs_pallas_srgb_interpret(key):
    """TPU kernel #11, built for the plan and run in interpret mode."""
    rp = ref_plan.ScalePlan(*key)
    assert pallas_srgb.applicable(rp)
    imgs = _images(key, sum(key) + 1)
    tpu = _interpret(pallas_srgb._built, lambda: pallas_srgb.scale_fn(rp, imgs))
    assert np.array_equal(_port(key, imgs), tpu)


@pytest.mark.parametrize("key", PLANES, ids=_id)
def test_vs_pallas_srgb_planes_interpret(key):
    """TPU kernel #12 (24bpp u8 planes) through the JAX dispatcher with its
    module switches set, as tests/test_pallas_srgb.py runs it."""
    rp = ref_plan.ScalePlan(*key)
    assert pallas_srgb.applicable(rp) and rp.meta_in.n_bytes == 3
    imgs = _images(key, sum(key) + 1)
    xla._FORCE_PALLAS = True
    xla._RGB24_PLANES = True
    try:
        tpu = _interpret(pallas_srgb._built_planes,
                         lambda: jax.jit(lambda v: xla.scale_fn(rp, v))(imgs))
    finally:
        xla._FORCE_PALLAS = None
        xla._RGB24_PLANES = False
    assert np.array_equal(_port(key, imgs), tpu)


def test_low_alpha_color_preserved():
    """PREMUL16 keeps the colour of a nearly transparent pixel
    (smolscale.c:751-758), as numpy_ref and TPU kernel #10 do."""
    plan = ScalePlan(*LOW_ALPHA)
    assert plan.internal_alpha == AlphaType.PREMUL16
    img = np.zeros((1, 64, 64, 4), dtype=np.uint8)
    img[..., 0] = 200
    img[..., 3] = 1
    got = _port(LOW_ALPHA, img)
    assert np.array_equal(got, _spec(LOW_ALPHA, img))
    rp = ref_plan.ScalePlan(*LOW_ALPHA)
    assert np.array_equal(got, _interpret(pallas_128._built, lambda: pallas_128.scale_fn(rp, img)))
    assert (np.abs(got[..., 0].astype(int) - 200) <= 1).all()


def test_constant_255_keeps_the_16_bit_mask():
    """A box axis at PREMUL16-linear: span sums of 2047*255 normalise past
    16 bits and are masked (numpy_ref._scale_span), so a white image does
    not stay white; the bilinear axis alone would keep it."""
    key = (1100, 300, 80, 100, 4, 4, True)
    imgs = np.full((1, 300, 1100, 4), 255, dtype=np.uint8)
    got = _port(key, imgs)
    assert np.array_equal(got, _spec(key, imgs))
    assert got[0, 0, 0].tolist() == [97, 97, 97, 255]
    key = (512, 256, 96, 56, 4, 4, True)
    assert (_port(key, np.full((1, 256, 512, 4), 255, dtype=np.uint8)) == 255).all()


def test_constant_255_beside_copy():
    """The 16-bit mask stays on the box axis beside a COPY axis, which
    normalises nothing; COPY x COPY keeps a white image white."""
    plan = ScalePlan(*CONST_COPY)
    assert plan.x.filter == stt.FilterType.COPY and plan.y.filter == stt.FilterType.BOX
    imgs = np.full((1, CONST_COPY[1], CONST_COPY[0], 4), 255, dtype=np.uint8)
    got = _port(CONST_COPY, imgs)
    assert np.array_equal(got, _spec(CONST_COPY, imgs))
    assert got[0, 0, 0].tolist() == [97, 97, 97, 255]
    key = (96, 54, 96, 54, 4, 4, True)
    assert (_port(key, np.full((1, 54, 96, 4), 255, dtype=np.uint8)) == 255).all()


@pytest.mark.parametrize("key", COPY_ONE, ids=_id)
def test_copy_one_matches_jax(key):
    """COPY and ONE axes through the public API: the port's dispatch
    reaches this kernel and gives the JAX package's bytes."""
    plan = stt.ScalePlan(*key)
    assert [k for k in torch_ops.WHOLE_KERNELS if k.applicable(plan)] == [bilinear128]
    assert any(ax.filter in (stt.FilterType.COPY, stt.FilterType.ONE) for ax in (plan.x, plan.y))
    imgs = _images(key, sum(key) + 3, batch=1)
    got = stt.scale(plan, torch.from_numpy(imgs))
    assert np.array_equal(got.numpy(), smolscale_tpu.scale(smolscale_tpu.ScalePlan(*key), imgs,
                                                           backend="jax"))


@pytest.mark.parametrize("key,first,n", ROWS, ids=lambda v: _id(v) if isinstance(v, tuple) else str(v))
def test_rows_match_jax(key, first, n):
    imgs = _images(key, sum(key) + first)
    want = smolscale_tpu.scale_rows(smolscale_tpu.ScalePlan(*key), imgs[0], first, n,
                                    backend="jax")
    got = _port(key, imgs, first, n)
    assert got.shape == (2, n, key[2], stt.get_meta(key[5]).n_bytes)
    assert np.array_equal(got[0], want)
    assert np.array_equal(got, _spec(key, imgs)[:, first : first + n])


@pytest.mark.parametrize("key", SUITE, ids=_id)
def test_suite_rows_end_to_end(key):
    """Rows 6, 6b and 7 at a small size through both packages' public
    API: the port's dispatch reaches this kernel and gives the JAX
    package's bytes, whole and streamed."""
    imgs = _images(key, sum(key) + 2)
    plan, rp = stt.ScalePlan(*key), smolscale_tpu.ScalePlan(*key)
    assert bilinear128.applicable(plan)
    assert not any(k.applicable(plan) for k in (box, bilinear, deep))
    got = stt.scale(plan, torch.from_numpy(imgs))
    want = smolscale_tpu.scale(rp, imgs, backend="jax")
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(got.numpy(), _spec(key, imgs))
    chunks = list(stt.scale_streamed(plan, imgs[0], n_chunks=4, device="cpu"))
    assert np.array_equal(torch.cat([c for _, c in chunks]).numpy(), want[0])


def _sweep():
    for w_in, w_out in [(512, 96), (256, 200), (1100, 80), (2048, 8), (600, 2), (1000, 100),
                        (333, 111), (9000, 1), (5000, 1), (64, 32), (300, 300)]:
        for ti, to in [(0, 0), (4, 4), (4, 0), (8, 8), (2, 9), (8, 4)]:
            for srgb in (False, True):
                yield (w_in, w_in // 2 + 7, w_out, w_out + 1, ti, to, srgb)


def test_class_covers_pallas_128_and_srgb():
    """Every plan that TPU kernel #10 or #11 takes and the deep box kernel
    does not, this kernel takes; it also takes S128 plans they refuse for
    their geometry.  No plan of the class raises in the port's dispatch."""
    taken = extra = 0
    for key in _sweep():
        rp, plan = ref_plan.ScalePlan(*key), ScalePlan(*key)
        if (pallas_128.applicable(rp) or pallas_srgb.applicable(rp)) and not deep.applicable(plan):
            assert bilinear128.applicable(plan), key
            taken += 1
        elif bilinear128.applicable(plan) and not deep.applicable(plan):
            extra += 1
        if bilinear128.applicable(plan):
            assert plan.storage == StorageType.S128
            assert any(k.applicable(plan) for k in torch_ops.WHOLE_KERNELS)
            assert any(k.applicable(plan) for k in torch_ops.ROW_KERNELS)
    assert taken > 40 and extra > 0
    assert not bilinear128.applicable(ScalePlan(256, 256, 100, 100, 0, 0))        # 64bpp
    assert bilinear128.applicable(ScalePlan(256, 256, 256, 16, 0, 0, True))       # COPY x box
    assert bilinear128.applicable(ScalePlan(1, 1, 7, 5, 4, 4))                    # ONE x ONE


def test_sum_bounds():
    """csrc/bilinear128.cu holds box span sums in unsigned 32 bits and the
    lerp in int32: the longest span the class admits, of the largest value
    it can hold (65408 at compressed gamma; 2047*255 in linear light, which
    the planner keeps to 8191:1), stays below 2^32; the lerp product and a
    6-halving sum of 24-bit values stay below 2^31."""
    p16 = (255 << 8) | 0x80
    lin = int(luts.FROM_SRGB.max()) * 255
    assert lin == 521985
    for key, top in [((65535, 65535, 1, 1, 4, 4, False), p16),
                     ((8191, 8191, 1, 1, 4, 4, True), lin)]:
        plan = ScalePlan(*key)
        assert bilinear128.applicable(plan)
        assert (plan.gamma == GammaType.SRGB_LINEAR) == key[6]
        for t in bilinear128.tables(plan):
            first, _, _, mid_len, last, _ = t.reshape(6, -1)
            assert (int(mid_len.max()) + 2) * top < 2**32
    assert ScalePlan(8192, 8192, 1, 1, 4, 4, True).gamma == GammaType.SRGB_COMPRESSED
    f_max = max(int(ScalePlan(w, 2, o, 2, 4, 4, True).x.factors.max())
                for w, o in [(512, 96), (256, 200), (1000, 999), (65535, 300)])
    assert f_max <= 256 and lin * f_max < 2**31
    assert 64 * 0xFFFFFF < 2**31


def test_5000_plan_no_longer_raises(monkeypatch):
    """(5000, 5000, 1, 40): box x box with one output column plans into this
    class and dispatches to this kernel, whole and by rows (not computed
    here: 5000^2 in int64 is 800 MB; ONE_OUTPUT holds its stand-ins)."""
    plan = stt.ScalePlan(5000, 5000, 1, 40, 0, 0)
    assert plan.storage == StorageType.S128 and plan.x.filter == stt.FilterType.BOX
    assert bilinear128.applicable(plan) and not deep.applicable(plan)
    calls = []
    monkeypatch.setattr(bilinear128, "scale_fn", lambda p, x: calls.append("whole"))
    monkeypatch.setattr(bilinear128, "scale_rows_fn", lambda p, x, f, n: calls.append("rows"))
    img = torch.zeros((1, 1, 4), dtype=torch.uint8).expand(5000, 5000, 4)
    stt.scale(plan, img)
    stt.scale_rows(plan, img, 3, 2)
    assert calls == ["whole", "rows"]


def test_dispatch_order(monkeypatch):
    """Whole images: box, bilinear, deep, then this kernel; rows: bilinear,
    deep, then this kernel."""
    calls = []
    for mod, name in ((box, "box"), (bilinear, "bilinear"), (deep, "deep"),
                      (bilinear128, "bilinear128")):
        monkeypatch.setattr(mod, "scale_fn", lambda plan, x, name=name: calls.append(name))
        monkeypatch.setattr(mod, "scale_rows_fn",
                            lambda plan, x, f, n, name=name: calls.append(name + " rows"),
                            raising=False)
    img = torch.zeros((2048, 2048, 4), dtype=torch.uint8)
    stt.scale(ScalePlan(2048, 2048, 256, 256, 4, 4), img)         # row 7: PREMUL16 2h
    stt.scale(ScalePlan(2048, 2048, 256, 256, 4, 4, True), img)   # row 6: linear light
    stt.scale(ScalePlan(2048, 2048, 128, 128, 4, 4), img)         # PREMUL16 box x box
    stt.scale(ScalePlan(2048, 2048, 1, 8, 0, 0), img)             # box x box, one column
    stt.scale_rows(ScalePlan(2048, 2048, 256, 256, 4, 4), img, 0, 1)
    stt.scale_rows(ScalePlan(2048, 2048, 8, 8, 0, 0), img, 0, 1)
    assert calls == ["bilinear128", "bilinear128", "deep", "bilinear128",
                     "bilinear128 rows", "deep rows"]


def test_wrapper_rejects_bad_input():
    plan = ScalePlan(512, 256, 96, 56, 4, 4, True)
    with pytest.raises(TypeError):
        bilinear128.scale_fn(plan, torch.zeros((256, 512, 4), dtype=torch.int32))
    with pytest.raises(ValueError):
        bilinear128.scale_fn(plan, torch.zeros((256, 512, 3), dtype=torch.uint8))
    with pytest.raises(ValueError, match="class"):
        bilinear128.scale_fn(ScalePlan(256, 256, 100, 100, 0, 0),
                             torch.zeros((256, 256, 4), dtype=torch.uint8))
    with pytest.raises(ValueError, match="row range"):
        bilinear128.scale_rows_fn(plan, torch.zeros((256, 512, 4), dtype=torch.uint8), 50, 7)
    # a device with no kernel raises instead of falling back
    with pytest.raises(ValueError, match="device"):
        bilinear128.scale_fn(plan, torch.zeros((256, 512, 4), dtype=torch.uint8, device="meta"))


def test_single_image_shape():
    key = RGB24[0]
    imgs = _images(key, 6, batch=1)
    got = bilinear128.scale_fn(ScalePlan(*key), torch.from_numpy(imgs[0]))
    assert tuple(got.shape) == (56, 96, 3)
    assert np.array_equal(got.numpy(), _spec(key, imgs)[0])


def test_kernel_params_follow_plan():
    p = bilinear128._params(ScalePlan(2048, 2048, 256, 256, 4, 4, True), 8, 0, 256)
    assert (p.batch, p.row0, p.n_rows, p.mode) == (8, 0, 256, deep.P16_LINEAR)
    assert (p.kind_x, p.kind_y, p.halvings_x, p.len_x) == (bilinear.BILINEAR,) * 2 + (2, 1024)
    q = bilinear128._params(ScalePlan(1920, 1080, 400, 225, 8, 8, True), 1, 7, 9)
    assert (q.mode, q.row0, q.n_rows, q.nb_in, q.alpha_ch, q.pack24_direct) == (
        deep.P8_LINEAR, 7, 9, 3, 3, 1)
    r = bilinear128._params(ScalePlan(2000, 400, 1, 20, 0, 0), 2, 0, 20)
    assert (r.kind_x, r.kind_y, r.len_x, r.len_y, r.mode) == (
        bilinear.BOX, bilinear.BOX, 1, 20, deep.P8_COMPRESSED)
    assert bilinear128._params(ScalePlan(2048, 2048, 256, 256, 4, 4), 1, 0, 1).mode == deep.P16_COMPRESSED
    c = bilinear128._params(ScalePlan(1, 300, 1, 20, 4, 4, True), 1, 0, 20)   # ONE x box
    assert (c.kind_x, c.kind_y, c.len_x, c.len_y) == (bilinear.ONE, bilinear.BOX, 0, 20)
    c = bilinear128._params(ScalePlan(300, 600, 1, 600, 4, 4), 1, 0, 600)    # box x COPY
    assert (c.kind_x, c.kind_y, c.len_x, c.len_y) == (bilinear.BOX, bilinear.COPY, 1, 0)
    # the grid: one column of 256 rows per block, cut to 16 blocks per SM
    assert (c.tile_w, c.grid_y, c.grid_z) == (1, 3, 1)
    # row 6: 32 x 8 tiles, 8 column tiles x 32 row groups x 8 images (2,048
    # blocks, under 16 per SM on 132); a1-p16-copy: 60 x 135 row groups x 8
    # images cut to 4 row-group blocks, each taking 34 row groups
    q = bilinear128._params(ScalePlan(2048, 2048, 256, 256, 4, 4, True), 8, 0, 256)
    assert (q.tile_w, q.grid_y, q.grid_z) == (32, 32, 8)
    q = bilinear128._params(ScalePlan(1920, 1080, 1920, 1080, 4, 4), 8, 0, 1080, 132)
    assert (q.tile_w, q.grid_y, q.grid_z) == (32, 4, 8)
    q = bilinear128._params(ScalePlan(8, 30000, 7, 30000, 4, 4), 70000, 0, 30000)
    assert (q.tile_w, q.grid_y, q.grid_z) == (8, 1, 65535)
    # the V box's last row at 128bpp: max(frac - 1, 0), as pallas_128's w2p
    plan = ScalePlan(300, 1100, 100, 80, 4, 4)
    assert plan.y.filter == stt.FilterType.BOX
    ty = bilinear128.tables(plan)[1].reshape(6, -1)
    assert np.array_equal(ty[5], np.maximum(plan.y.factors - 1, 0))
    assert (ty[5] < plan.y.factors).any()


def _visits(w_out, n_rows, batch, sms, turn):
    """How often the kernel's loops (csrc/bilinear128.cu
    ``bilinear128_kernel``) visit each output pixel (image, row, column)
    for the grid ``bilinear.launch_shape`` gives LOOP (from row 0), with
    ``turn`` row groups per turn (2 for COPY x COPY)."""
    tile_w, col_tiles, grid_y, grid_z = bilinear.launch_shape(w_out, 0, n_rows, batch, sms)
    tile_h = bilinear.THREADS // tile_w
    step = grid_y * tile_h
    seen = np.zeros((batch, n_rows, w_out), dtype=np.int64)
    for z in range(grid_z):
        images = np.arange(z, batch, grid_z)
        for x in range(col_tiles):
            for t in range(bilinear.THREADS):
                j = x * tile_w + t % tile_w
                if j >= w_out:
                    continue
                for y in range(grid_y):
                    for ir in range(y * tile_h + t // tile_w, n_rows, turn * step):
                        rows = [ir + u * step for u in range(turn) if ir + u * step < n_rows]
                        np.add.at(seen, (images[:, None], np.array(rows)[None, :], j), 1)
    return seen, (tile_w, col_tiles, grid_y, grid_z)


@pytest.mark.parametrize("w_out,n_rows,batch,sms", [
    (1, 300, 2, 1), (7, 290, 3, 132), (64, 64, 5, 2), (255, 50, 2, 1), (256, 50, 1, 132),
    (257, 13, 2, 1), (8, 1000, 3, 1), (33, 9, 4, 132), (1920, 40, 2, 1),
])
@pytest.mark.parametrize("turn", [1, 2])
def test_launch_shape_covers_every_pixel_once(w_out, n_rows, batch, sms, turn):
    """The tiles' edges hold: every output pixel of every image is visited
    exactly once, whether w_out is below, at or past a tile's width, rows
    end inside a tile, or a block takes several row groups."""
    seen, (tile_w, col_tiles, grid_y, grid_z) = _visits(w_out, n_rows, batch, sms, turn)
    assert (seen == 1).all()
    assert tile_w & (tile_w - 1) == 0 and tile_w <= 32 and (tile_w >= w_out or tile_w == 32)
    assert 1 <= grid_y <= 65535 and 1 <= grid_z <= 65535
    assert col_tiles * grid_y * grid_z <= max(bilinear.BLOCKS_PER_SM * sms,
                                              col_tiles * grid_z)


def test_launch_shape_limits():
    """gridDim.y and gridDim.z stop at 65535: a batch past it loops over
    images, and any row count (at most 65535) fits; the tall batch of the
    card's checks (3 x 30,000 rows) plans like any other."""
    for w_out, n_rows, batch in [(1, 65535, 1), (8, 30000, 3), (65535, 65535, 1),
                                 (1, 1, 200_000), (7, 1, 70_000)]:
        tile_w, col_tiles, grid_y, grid_z = bilinear.launch_shape(w_out, 0, n_rows, batch)
        assert grid_y <= 65535 and grid_z == min(batch, 65535)
        assert col_tiles * tile_w >= w_out and col_tiles < 2**31


def test_tall_batch_matches_numpy_ref():
    key, batch = TALL
    imgs = _images(key, 11, batch=batch)
    assert batch * key[3] > 65535
    assert np.array_equal(_port(key, imgs), _spec(key, imgs))


def _smoke():
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_plans_are_held_here():
    """chip_smoke.py holds the kernel against the plain version on the card;
    every plan and row range it checks is held against numpy_ref by a test
    of this file, and its suite rows are this class and no other's; its
    3-byte rows (6b, 6b-4k, 6b-up) are RGB24_ROWS, with the forms they are
    routed to, and its 3-byte unaligned and constant-255 plans fit both
    forms."""
    mod = _smoke()
    assert set(mod.WIDE_CHECK_PLANS) == set(ALL)
    assert set(mod.WIDE_CHECK_ROWS) == set(ROWS)
    assert set(mod.WIDE_UNALIGNED) <= set(ALL) and mod.WIDE_TALL == TALL
    assert mod.WIDE_CONST_PLAN in ALL and mod.WIDE_CONST_COPY_PLAN == CONST_COPY
    assert set(mod.WIDE_CONST24_PLANS) <= set(ALL)
    for key in mod.WIDE_CONST24_PLANS + [k for k in mod.WIDE_UNALIGNED if k[4] >= 8]:
        assert bilinear128.forms(ScalePlan(*key)) == [bilinear128.LOOP, bilinear128.H_TILE]
    for _, key, _ in mod.WIDE_ROWS:
        plan = stt.ScalePlan(*key)
        assert bilinear128.applicable(plan)
        assert not any(k.applicable(plan) for k in (box, bilinear, deep))
    assert {key for _, key, _ in mod.WIDE_ROWS if key[4] >= 8} == {k for k, _ in RGB24_ROWS}
    for key, routed in RGB24_ROWS:
        assert bilinear128.form(ScalePlan(*key)) == routed


# ----------------------------------------------------------------------------
# 3-byte input: the folded unpack table and the H TILE form
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("srgb", [False, True], ids=["compressed", "linear"])
def test_unpack24_table_matches_unpack(srgb):
    """The kernel's per-byte table for 3-byte pixels equals ``pixels.unpack``
    at the constant alpha 255 for all 256 bytes of each channel: the
    identity at PREMUL8 compressed (mode 0), unpremultiply, from_srgb and
    premultiply folded into one entry in PREMUL8 linear (mode 1)."""
    key = (512, 256, 96, 56, 8, 8, True) if srgb else (520, 300, 2, 40, 8, 9, False)
    plan = ScalePlan(*key)
    assert deep.mode(plan) == (deep.P8_LINEAR if srgb else deep.P8_COMPRESSED)
    assert bilinear128.rgb24(plan)
    img = torch.from_numpy(np.repeat(np.arange(256, dtype=np.uint8)[None, :, None], 3, axis=2))
    work = pixels.unpack(plan, img)[0].numpy()
    assert plan.meta_in.alpha == AlphaType.PREMUL8
    table = pixels.unpack24_table(srgb)
    assert table.dtype == np.int32 and table.shape == (256,)
    for c in range(3):
        assert np.array_equal(work[:, c], table)
    assert (work[:, 3] == 255).all()
    assert table.max() == (2040 if srgb else 255)
    assert np.array_equal(pixels.unpack24_lut(torch.device("cpu"), srgb).numpy(), table)


def test_3_byte_input_is_planned_at_premul8():
    """RGB8 and BGR8 are premultiplied (alpha 255), so every plan with
    3-byte input has internal PREMUL8: the folded table (modes 0 and 1) and
    H TILE's 16-bit cells cover all of them; the kernel refuses 3-byte input
    at PREMUL16."""
    for ti in (8, 9):
        for to in range(10):
            for srgb in (False, True):
                for key in [(600, 300, 2, 40), (512, 256, 96, 56), (96, 54, 200, 120)]:
                    plan = ScalePlan(*key, ti, to, srgb)
                    assert plan.internal_alpha == AlphaType.PREMUL8
                    assert deep.mode(plan) in (deep.P8_COMPRESSED, deep.P8_LINEAR)
                    assert bilinear128.rgb24(plan)


def test_unpack24_table_is_the_planes_fold():
    """The linear table equals the two 16-bit halves of row 1 of
    ``pallas_srgb._lut_tables``, the fold TPU kernel #12 gathers from."""
    row = pallas_srgb._lut_tables()[1].astype(np.int64)
    table = pixels.unpack24_table(True)
    assert np.array_equal(table[:128], row & 0xFFFF)
    assert np.array_equal(table[128:], row >> 16)


@pytest.mark.parametrize("key,routed", RGB24_ROWS, ids=lambda v: _id(v) if isinstance(v, tuple) else str(v))
def test_rgb24_rows_route_by_class(key, routed):
    """Row 6b (2h ladders: 4 samples, 1.63 H filters per tap row in LOOP)
    takes H TILE; 6b-4k (0h 2:1, no tap row shared) and 6b-up (0h upscale,
    tap rows shared 2.4-fold, where ``bilinear.cu`` would take its h tile)
    stay on LOOP, the faster form on the card for each."""
    plan = ScalePlan(*key)
    assert bilinear128.forms(plan) == [bilinear128.LOOP, bilinear128.H_TILE]
    assert bilinear128.form(plan) == routed
    assert (routed == bilinear128.H_TILE) == bilinear.deep_v(plan)
    assert bilinear.h_tile_pays(plan) == (routed == bilinear128.H_TILE or key[2] > key[0])
    reuse = bilinear.h_reuse(plan)
    assert (reuse >= 2) == (key[2] > key[0])
    if key == RGB24_ROWS[0][0]:
        # 225 rows in groups of 8 read 40 tap rows at most, 39 on most
        assert (plan.y.halvings, plan.x.halvings) == (2, 2) and 1.6 < reuse < 1.7
        assert bilinear128.h_cells(plan) == 40 * 32


def test_four_byte_plans_keep_loop():
    """4-byte plans outside ROLL's class have one form, LOOP; a 0h PREMUL16
    plan has LOOP and ROLL, routed to ROLL, with ``bilinear.roll_shape``'s
    strips and grid; a form that does not fit raises before any launch."""
    for key in [(2048, 2048, 256, 256, 4, 4, True), (512, 256, 96, 56, 0, 0, True),
                (2048, 2048, 256, 256, 4, 4, False), (512, 256, 96, 56, 0, 8, True)]:
        plan = ScalePlan(*key)
        assert not bilinear128.rgb24(plan) and not bilinear128.rolls(plan)
        assert bilinear128.forms(plan) == [bilinear128.LOOP] == [bilinear128.form(plan)]
    plan = ScalePlan(2048, 2048, 256, 256, 4, 4, True)
    with pytest.raises(ValueError, match="does not fit"):
        bilinear128._params(plan, 8, 0, 256, form=bilinear128.H_TILE)
    with pytest.raises(ValueError, match="does not fit"):
        bilinear128._params(plan, 8, 0, 256, form=bilinear128.ROLL)
    p = bilinear128._params(plan, 8, 0, 256, form=bilinear128.LOOP)
    assert (p.form, p.h_cells) == (bilinear128.LOOP, 0)
    # conv-2160p's PREMUL16 pairs and fleet-5b's 256^2 level, whole and by rows
    for key, batch, first, n in [((3840, 2160, 3839, 2159, 4, 7, False), 64, 0, 2159),
                                 ((512, 512, 256, 256, 4, 4, False), 192, 0, 256),
                                 ((700, 300, 699, 299, 4, 6, False), 2, 37, 200)]:
        plan = ScalePlan(*key)
        assert bilinear128.rolls(plan) and not bilinear128.rgb24(plan)
        assert bilinear128.forms(plan) == [bilinear128.LOOP, bilinear128.ROLL]
        assert bilinear128.form(plan) == bilinear128.ROLL
        with pytest.raises(ValueError, match="does not fit"):
            bilinear128._params(plan, batch, first, n, form=bilinear128.H_TILE)
        r = bilinear128._params(plan, batch, first, n, 132)
        tile_w, _, strip_rows, grid_y, grid_z = bilinear.roll_shape(
            plan.width_out, first, n, batch, 132)
        assert (r.form, r.tile_w, r.strip_rows, r.grid_y, r.grid_z) == (
            bilinear128.ROLL, tile_w, strip_rows, grid_y, grid_z)
        assert (r.row0, r.n_rows, r.mode, r.nb_in, r.nb_out) == (
            first, n, deep.P16_COMPRESSED, 4, 4)
        q = bilinear128._params(plan, batch, first, n, 132, bilinear128.LOOP)
        tile_w, _, grid_y, grid_z = bilinear.launch_shape(plan.width_out, 0, n, batch, 132)
        assert (q.form, q.tile_w, q.grid_y, q.grid_z) == (bilinear128.LOOP, tile_w, grid_y, grid_z)
    # a 3-byte plan whose row groups read more tap rows than the h tile holds
    deep_v = ScalePlan(64, 8000, 64, 30, 8, 8, True)
    assert bilinear128.rgb24(deep_v) and bilinear128.h_cells(deep_v) > bilinear128.H_CELLS
    assert bilinear128.forms(deep_v) == [bilinear128.LOOP] == [bilinear128.form(deep_v)]


def test_h_tile_params_follow_plan():
    """H TILE's grid counts row groups from output row 0
    (``bilinear.launch_shape``), LOOP's from the range's first row; the
    cells are the plan's widest window at the tile's width."""
    plan = ScalePlan(*RGB24_ROWS[0][0])
    p = bilinear128._params(plan, 8, 0, 225, 132)
    assert (p.form, p.h_cells, p.tile_w, p.grid_y, p.grid_z) == (
        bilinear128.H_TILE, 1280, 32, 20, 8)
    assert p.nb_in == 3 and p.mode == deep.P8_LINEAR and p.pack24_direct == 1
    q = bilinear128._params(plan, 8, 13, 30, 132)
    assert (q.tile_w, q.grid_y) == bilinear.launch_shape(400, 13, 30, 8, 132)[::2]
    r = bilinear128._params(plan, 8, 13, 30, 132, bilinear128.LOOP)
    assert (r.form, r.tile_w, r.grid_y) == (bilinear128.LOOP, 32, 4)
    assert r.h_cells == p.h_cells   # the template's; LOOP does not read it


_CONFIGS = Path(__file__).resolve().parent.parent / "portbench" / "configs"


def _config_plans(config):
    data = json.loads((_CONFIGS / f"{config}.json").read_text())
    if "fleet" in data:
        fleet = data["fleet"]
        return [ScalePlan(*g["size"], s, s, g["pixel_type"], g["pixel_type"], fleet["with_srgb"])
                for g in fleet["groups"] for s in fleet["sizes"]]
    return [ScalePlan(*k) for k in traffic.frame_plans(data["frames"])]


# configuration -> its plans that reach bilinear128.cu, those of them in ROLL
ROLL128_ROUTES = {"conv-2160p": (16, 16), "fleet-5b": (3, 1), "frames-2160p": (0, 0),
                  "frames-2160p-srgb": (189, 151)}
# the configurations without linear light: every plan they roll is PREMUL16
PREMUL16_CONFIGS = ["conv-2160p", "fleet-5b", "frames-2160p"]


@pytest.mark.parametrize("config", PREMUL16_CONFIGS)
def test_roll_takes_every_0h_v_premul16_plan_and_nothing_else(config):
    """Each configuration's plans that reach ``bilinear128.cu`` route to
    ROLL exactly where they are PREMUL16 at compressed gamma with a 0h
    bilinear V axis beside a non-box X axis.  conv-2160p: its 16
    unassociated -> unassociated pairs, all of them, and no other pair
    reaches the kernel; fleet-5b: the unassociated group's 256^2 level
    rolls, its 128^2 and 64^2 ladders keep LOOP; frames-2160p: no plan
    reaches the kernel."""
    plans = _config_plans(config)
    on = [p for p in plans if torch_ops.whole_kernel(p) is bilinear128]
    rolled = [p for p in on if bilinear128.form(p) == bilinear128.ROLL]
    assert (len(on), len(rolled)) == ROLL128_ROUTES[config]
    for p in rolled:
        assert bilinear.axis_kind(p.y) == bilinear.BILINEAR and p.y.halvings == 0, p.key
        assert bilinear.axis_kind(p.x) != bilinear.BOX and p.x.halvings <= 2, p.key
        assert deep.mode(p) == deep.P16_COMPRESSED, p.key
        assert p.meta_in.n_bytes == p.meta_out.n_bytes == 4, p.key
    for p in on:
        if p not in rolled:
            assert bilinear128.ROLL not in bilinear128.forms(p) and not bilinear128.rolls(p)
    if config == "conv-2160p":
        assert {p.key[4:6] for p in on} == {(i, o) for i in range(4, 8) for o in range(4, 8)}
    if config == "fleet-5b":
        assert [p.key for p in rolled] == [(512, 512, 256, 256, 4, 4, False)]
        assert {p.key[2] for p in on if p not in rolled} == {64, 128}
        assert all(bilinear128.form(p) == bilinear128.LOOP for p in on if p not in rolled)


@pytest.mark.parametrize("config", ROLL128_ROUTES)
def test_roll_takes_every_0h_v_plan_of_its_modes_and_nothing_else(config):
    """Each configuration's plans that reach ``bilinear128.cu`` route to
    ROLL exactly where they have 4-byte pixels in and out at PREMUL16
    compressed or P8-linear with a 0h bilinear V axis beside a non-box X
    axis.  conv-2160p: its 16 unassociated -> unassociated pairs, all of
    them, and no other pair reaches the kernel; fleet-5b: the unassociated
    group's 256^2 level rolls, its 128^2 and 64^2 ladders keep LOOP;
    frames-2160p: no plan reaches the kernel; frames-2160p-srgb: its 101 0h
    upscales and 50 0h downscales roll, its 25 1h and 13 2h ladders keep
    LOOP."""
    plans = _config_plans(config)
    on = [p for p in plans if torch_ops.whole_kernel(p) is bilinear128]
    rolled = [p for p in on if bilinear128.form(p) == bilinear128.ROLL]
    assert (len(on), len(rolled)) == ROLL128_ROUTES[config]
    for p in rolled:
        assert bilinear.axis_kind(p.y) == bilinear.BILINEAR and p.y.halvings == 0, p.key
        assert bilinear.axis_kind(p.x) != bilinear.BOX and p.x.halvings <= 2, p.key
        assert deep.mode(p) in (deep.P16_COMPRESSED, deep.P8_LINEAR), p.key
        assert p.meta_in.n_bytes == p.meta_out.n_bytes == 4, p.key
    for p in on:
        if p not in rolled:
            assert bilinear128.ROLL not in bilinear128.forms(p) and not bilinear128.rolls(p)
            assert bilinear128.form(p) == bilinear128.LOOP
    if config == "conv-2160p":
        assert {p.key[4:6] for p in on} == {(i, o) for i in range(4, 8) for o in range(4, 8)}
    if config == "fleet-5b":
        assert [p.key for p in rolled] == [(512, 512, 256, 256, 4, 4, False)]
        assert {p.key[2] for p in on if p not in rolled} == {64, 128}
    if config == "frames-2160p-srgb":
        assert all(deep.mode(p) == deep.P8_LINEAR for p in on)
        up = [p for p in rolled if p.height_out > p.height_in]
        assert (len(up), len(rolled) - len(up)) == (101, 50)
        looped = [p for p in on if p not in rolled]
        assert sorted(p.y.halvings for p in looped) == [1] * 25 + [2] * 13


def test_roll_plans_route_to_roll():
    """The card's ROLL checks (chip_smoke.py's) lie in ROLL's class and
    route to it, beside LOOP, in each of its modes: X COPY, ONE and
    BILINEAR of 0, 1 and 2 halvings, and output widths 1-9 and 129 in
    each."""
    for key in ROLL_PLANS:
        plan = ScalePlan(*key)
        assert bilinear128.forms(plan) == [bilinear128.LOOP, bilinear128.ROLL], key
        assert bilinear128.form(plan) == bilinear128.ROLL, key
    for mode in (deep.P16_COMPRESSED, deep.P8_LINEAR):
        keys = [k for k in ROLL_PLANS if deep.mode(ScalePlan(*k)) == mode]
        kinds = {(bilinear.axis_kind(ScalePlan(*k).x), ScalePlan(*k).x.halvings) for k in keys}
        assert kinds == {(bilinear.COPY, 0), (bilinear.ONE, 0), (bilinear.BILINEAR, 0),
                         (bilinear.BILINEAR, 1), (bilinear.BILINEAR, 2)}
        assert {k[2] for k in keys} >= set(range(1, 10)) | {129}
    # P8-linear: premultiplied in and out, and unassociated on either side
    linear = [ScalePlan(*k) for k in ROLL_PLANS if k[6]]
    assert {(p.meta_in.alpha, p.meta_out.alpha) for p in linear} == {
        (AlphaType.PREMUL8, AlphaType.PREMUL8), (AlphaType.PREMUL8, AlphaType.UNASSOCIATED),
        (AlphaType.UNASSOCIATED, AlphaType.PREMUL8)}
    # P8-linear 0h plans outside the class keep LOOP: 3-byte pixels on either
    # side, a box X axis
    for key in [(96, 54, 96, 40, 8, 0, True), (96, 54, 96, 40, 0, 9, True),
                (96, 54, 96, 40, 8, 8, True), (1100, 300, 80, 299, 0, 0, True)]:
        plan = ScalePlan(*key)
        assert deep.mode(plan) == deep.P8_LINEAR and not bilinear128.rolls(plan), key
        assert bilinear128.form(plan) != bilinear128.ROLL, key


def test_roll_lerp_is_lerp():
    """ROLL's lerp, (p*F + q*(256 - F)) >> 8 in unsigned 32 bits, equals
    the lerp ((p - q)*F >> 8) + q (floor shift), masked to 24 bits, for every
    F in [0, 256] and working values below 2^24: every pair of PREMUL16
    values of one channel (c*a, and the alpha (a << 8) | 0x80) with its
    partner's alpha, every pair of P8-linear values (colours 0-2047, alpha
    0-255), and pairs at the 24-bit edges."""
    a = np.arange(256, dtype=np.int64)
    vals = np.unique(np.concatenate([np.outer(a, a).ravel(), (a << 8) | 0x80]))
    edge = np.array([0, 1, 2, 255, 256, 2040, 2047, 65407, 65408, 65535, 2**23, 2**24 - 2,
                     2**24 - 1])
    rng = np.random.default_rng(25)
    c = np.arange(2048, dtype=np.int64)
    p = np.concatenate([rng.choice(vals, 200_000), np.repeat(edge, len(edge)),
                        np.repeat(c, 2048), np.repeat(a, 256)])
    q = np.concatenate([rng.choice(vals, 200_000), np.tile(edge, len(edge)),
                        np.tile(c, 2048), np.tile(a, 256)])
    for f in range(257):
        want = ((((p - q) * f) >> 8) + q) & 0xFFFFFF
        total = p * f + q * (256 - f)
        assert total.max() < 2**32
        assert np.array_equal(total >> 8, want), f


def test_roll_linear_unpack_and_pack_stay_in_32_bits():
    """ROLL's P8-linear unpack (csrc/bilinear128.cu unpack8l, written out
    here) equals ``pixels.unpack`` for every colour byte and alpha, of
    premultiplied and of unassociated input, and gives colours of at most
    2040 and the alpha byte; its unpremultiply's product stays below 2^29.
    A lerp or a halving mean lies between its values, so every value ROLL's
    pack reads is at most 2040 (alpha 255), and the pack's colour times
    INV_DIV_P8L stays below 2^29 (csrc/bilinear128.cu's arithmetic note)."""
    u, al = (v.ravel() for v in np.meshgrid(np.arange(256, dtype=np.int64),
                                            np.arange(256, dtype=np.int64)))
    from_srgb, inv8 = luts.FROM_SRGB.astype(np.int64), luts.INV_DIV_P8.astype(np.int64)
    assert (u * inv8[al]).max() < 2**29
    for premul in (True, False):
        byte = ((u * inv8[al]) >> 13) & 0xFF if premul else u
        got = (((from_srgb[byte] + 1) * ((al << 3) + 1) - 1) >> 11) & 0x7FF
        assert got.max() == 2040
        plan = ScalePlan(8, 8, 16, 16, 0 if premul else 4, 0, True)
        assert deep.mode(plan) == deep.P8_LINEAR
        px = torch.from_numpy(np.stack([u, u, u, al], -1).astype(np.uint8)[None])
        want = pixels.unpack(plan, px)[0].numpy()
        assert np.array_equal(want[:, 0], got) and np.array_equal(want[:, 3], al)
    assert 2040 * int(luts.INV_DIV_P8L.max()) < 2**29


_V_PLANS = sorted({k for k in ALL + SUITE if k[4] >= 8} | {k for k, _ in RGB24_ROWS}
                  | set(_smoke().WIDE_CONST24_PLANS), key=str)


def _v_reads(ay, tab, i):
    """The input rows csrc/bilinear128.cu's vfilter reads for output row i."""
    kind = bilinear.axis_kind(ay)
    if kind in (bilinear.COPY, bilinear.ONE):
        return [i if kind == bilinear.COPY else 0]
    if kind == bilinear.BILINEAR:
        k = 1 << ay.halvings
        ofs = tab[: len(tab) // 2]
        return [r for s in range(i * k, (i + 1) * k) for r in (ofs[s], ofs[s] + 1)]
    first, _, mid, n_mid, last, _ = tab.reshape(6, -1)[:, i]
    return [first, last, *range(mid, mid + n_mid)]


@pytest.mark.parametrize("key", _V_PLANS, ids=_id)
def test_h_cells_cover_every_window(key):
    """Each row group's window lies in the image and holds every tap row its
    output rows read through the 128bpp V table; H TILE fits a plan exactly
    when its widest window at the tile's width is at most H_CELLS, and its
    cells (h_cells) hold every row group's window."""
    plan = ScalePlan(*key)
    assert bilinear128.rgb24(plan)
    tile_w = bilinear.tile_width(plan.width_out)
    tile_h = bilinear.THREADS // tile_w
    win = bilinear.row_windows(plan)
    assert (0 <= win[0]).all() and (win[0] < win[1]).all() and (win[1] <= plan.height_in).all()
    tab = bilinear128.tables(plan)[1]
    for i in range(plan.height_out):
        reads = _v_reads(plan.y, tab, i)
        lo, hi = win[:, i // tile_h]
        assert lo <= min(reads) and max(reads) < hi, i
    cells = bilinear128.h_cells(plan)
    assert cells == int((win[1] - win[0]).max()) * tile_w
    assert (bilinear128.H_TILE in bilinear128.forms(plan)) == (cells <= bilinear128.H_CELLS)
    assert torch.equal(bilinear._windows(plan, torch.device("cpu")),
                       torch.from_numpy(win.reshape(-1)))


def _tile_visits(plan, first, n, batch, sms):
    """How often csrc/bilinear128.cu's ``direct_tile`` loops visit each
    output pixel of rows [first, first + n), and that every cell a V pass
    reads was written in that row group's H pass, for the grid
    ``bilinear.launch_shape`` gives."""
    tile_w, col_tiles, grid_y, grid_z = bilinear.launch_shape(plan.width_out, first, n, batch,
                                                              sms)
    tile_h = bilinear.THREADS // tile_w
    win = bilinear.row_windows(plan)
    tab = bilinear128.tables(plan)[1]
    seen = np.zeros((batch, n, plan.width_out), dtype=np.int64)
    g_first, g_end = first // tile_h, (first + n - 1) // tile_h + 1
    for z in range(grid_z):
        images = np.arange(z, batch, grid_z)
        for y in range(grid_y):
            for g in range(g_first + y, g_end, grid_y):
                r_lo, n_taps = win[0, g], win[1, g] - win[0, g]
                assert n_taps * tile_w <= bilinear128.h_cells(plan)
                # each thread row tr writes cells tr, tr + tile_h, ... of its column
                written = np.zeros(n_taps, dtype=np.int64)
                for tr in range(tile_h):
                    written[tr:n_taps:tile_h] += 1
                assert (written == 1).all()
                for tr in range(tile_h):
                    i = g * tile_h + tr
                    if first <= i < first + n:
                        assert all(0 <= r - r_lo < n_taps for r in _v_reads(plan.y, tab, i))
                        seen[images[:, None], i - first, :] += col_tiles * tile_w >= plan.width_out
    return seen


@pytest.mark.parametrize("key,first,n,batch,sms", [
    ((480, 270, 100, 56, 8, 8, True), 0, 56, 2, 132),
    ((480, 270, 100, 56, 8, 8, True), 13, 30, 3, 1),
    ((128, 72, 192, 108, 8, 8, True), 7, 100, 2, 2),
    ((60, 40, 7, 30, 8, 8, True), 0, 30, 5, 1),      # tile_w 8: 32 rows per group
    ((520, 300, 2, 40, 8, 9, False), 5, 30, 2, 132),  # tile_w 2: 128 rows per group
    ((1920, 1080, 400, 225, 8, 8, True), 0, 225, 8, 132),
])
def test_h_tile_covers_every_pixel_once(key, first, n, batch, sms):
    """H TILE's loops visit every output pixel of the range exactly once,
    whether the range starts or ends inside a row group or a block takes
    several row groups; each row group's H pass writes each of its window's
    cells once, and its V pass reads no cell outside the window."""
    assert (_tile_visits(ScalePlan(*key), first, n, batch, sms) == 1).all()
