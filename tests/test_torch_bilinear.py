"""The port's general 64bpp path (smolscale_tpu_torch.ops.bilinear) against
the JAX package's Pallas bilinear kernel in interpret mode (whole image,
row ranges and the 24bpp planes feed) and against numpy_ref; the row API
(``scale_rows`` / ``scale_streamed``) against the JAX package's.

On the CPU ``bilinear.scale_fn`` runs the kernel's plain PyTorch version; the
CUDA kernel itself is compared with it on the card (test_torch_cuda.py,
chip_smoke.py).  All arithmetic is integer: the tolerance is byte equality.
"""

import importlib.util
import json
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import smolscale_tpu
from portbench import traffic
import smolscale_tpu_torch as stt
from smolscale_tpu import plan as ref_plan
from smolscale_tpu.backends import numpy_ref, xla
from smolscale_tpu.ops import pallas_bilinear, pallas_box
from smolscale_tpu_torch import plan as port_plan
from smolscale_tpu_torch.backends import torch_ops
from smolscale_tpu_torch.ops import bilinear, box
from smolscale_tpu_torch.plan import ScalePlan

_ORIG = pl.pallas_call


def _interp_call(*a, **k):
    return _ORIG(*a, **k, interpret=True)


# the plan lists of tests/test_pallas_bilinear.py
EXACT = [
    (512, 512, 1024, 1024, 5, 0),  # 0h upscale, unassociated input
    (300, 200, 290, 190, 0, 0),    # 0h mild downscale, odd sizes
    (512, 256, 96, 56, 0, 1),      # 2h ladder + reorder
    (700, 500, 123, 77, 2, 3),     # 2h, tails on both axes
    (64, 64, 16, 16, 0, 0),        # 1h
    (1024, 512, 128, 64, 0, 0),    # uniform 2h ladder both
    (1024, 512, 128, 64, 4, 0),    # same, unassociated input
    (1000, 512, 100, 64, 0, 0),    # box H (10:1) x ladder V
    (640, 300, 64, 100, 0, 0),     # box H x general bilinear V
    (1000, 500, 100, 500, 0, 0),   # box H x COPY V
    (512, 1000, 512, 100, 0, 1),   # COPY H x box V
    (555, 300, 55, 300, 2, 0),     # non-integer box H x COPY V
    (700, 1, 123, 9, 0, 0),        # ladder H x ONE V
    (1, 700, 9, 123, 4, 0),        # ONE H x ladder V, unassociated in
    (512, 700, 512, 123, 0, 3),    # COPY H x ladder V
    (300, 260, 300, 260, 5, 2),    # COPY x COPY (pure conversion)
    (1, 1, 64, 32, 0, 0),          # ONE x ONE
]
UNASSOC_OUT = [
    (512, 256, 96, 56, 0, 4),      # 2h ladder, premul -> unassoc
    (512, 512, 1024, 768, 1, 6),   # 0h upscale + reorder, premul -> unassoc
    (1100, 300, 80, 100, 3, 5),    # box H x bilinear V, premul -> unassoc
]
GENERAL_BOX = [
    (1100, 300, 80, 100, 0, 0),    # box H (13.75:1) x bilinear V
    (300, 1100, 100, 80, 4, 1),    # bilinear H x box V, unassociated in
]
BOX_X_BOX = [
    (1100, 1100, 80, 80, 0, 0),    # 13.75:1 box x box
    (1100, 990, 80, 110, 4, 1),    # box x box, mixed ratios, unassociated in
    (700, 700, 50, 50, 0, 4),      # 14:1 box x box, premul -> unassoc
]
# 24bpp endpoints; the TPU runs a 4-byte surrogate plan, reading 24bpp input
# through u8 planes (kernel #5); (384, 256, 3, 2, 8, 9) of the surrogate
# list is a 128:1 integer box, the box kernel's class
RGB24 = [
    (512, 256, 96, 56, 8, 8),      # RGB24 -> RGB24 ladder
    (512, 256, 96, 56, 8, 0),      # RGB24 -> RGBA
    (300, 200, 290, 190, 0, 8),    # RGBA -> RGB24
    (512, 256, 96, 56, 9, 9),      # BGR24 -> BGR24
    (640, 300, 80, 110, 8, 8),     # non-integer box x box
    (512, 300, 512, 60, 8, 9),     # COPY H x box V strip
    (512, 256, 96, 56, 8, 4),      # RGB24 -> unassociated RGBA
    (333, 200, 330, 190, 8, 8),    # 0h both axes, ragged width
]
# a 64bpp box past 64:1 (up to the planner's 255:1) beside each other axis
# kind, outside the deep box kernel's class: the JAX package computes these
# on this Pallas kernel where its geometry fits, else on its XLA op graph
PAST_64 = [
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
]
# (key, first, n): the row form past 64:1, the COPY x 128:1 integer box
# strip among them, which ``scale`` runs on the box kernel
PAST_64_ROWS = [
    ((4096, 512, 4096, 4, 0, 0), 1, 2),
    ((6500, 100, 100, 50, 0, 0), 10, 20),
    ((1, 9000, 3, 40, 0, 0), 39, 1),
]
# the kernel's staged box X axes (16 pixels or more per column) at the edges
# of its column tiles (256 / lanes columns): w_out of 1, T - 1, T and T + 1
# at one lane (T = 256), at 8 lanes (a 128:1 box, T = 32) and at 16 (255:1,
# T = 16), five tiles, either side of the staging threshold (14:1 reads 15
# pixels, 15:1 16) and of two lanes (18:1), 3-byte pixels, unassociated alpha
STAGED = [
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
STAGED_ROWS = [
    ((4112, 64, 257, 16, 0, 0), 5, 7),
    ((4112, 64, 257, 16, 8, 8), 9, 6),
    ((4224, 20, 33, 10, 4, 1), 3, 4),
    ((16400, 8, 1025, 4, 0, 0), 1, 2),
]
# the direct path's tiles (ops/bilinear.launch_shape: tile_w output columns
# by 256 / tile_w rows) on their edges -- w_out 1, 7, 31, 32, 33, 257 and
# 4096 by h_out 1, 7, 8, 9 and 257 -- over each V kind beside each X kind
# that loads directly, rows 3a and 3b's classes at a small size and row 5b's
# 384^2 levels
DIRECT = [
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
# row ranges that start and end inside a row group
DIRECT_ROWS = [
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
# (key, first, n) of test_pallas_rows_exact
ROWS = [
    ((1024, 512, 128, 64, 0, 0), 16, 8),
    ((1024, 512, 128, 64, 0, 0), 0, 64),
    ((1024, 512, 128, 64, 0, 0), 61, 3),
    ((1000, 512, 100, 64, 0, 0), 5, 20),
    ((512, 500, 96, 50, 0, 0), 13, 17),
    ((512, 256, 96, 56, 0, 4), 10, 30),
    ((512, 512, 1024, 1024, 5, 0), 100, 200),
    ((512, 700, 512, 123, 0, 3), 40, 50),
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
    before = bilinear.launches
    got = bilinear.scale_rows_fn(plan, torch.from_numpy(imgs), first, n)
    assert bilinear.launches == before
    assert torch.equal(got, bilinear.bilinear_scale_ref(plan, torch.from_numpy(imgs), first, n))
    return got.numpy()


@pytest.mark.parametrize("key", EXACT + UNASSOC_OUT + GENERAL_BOX + BOX_X_BOX, ids=_id)
def test_bilinear_vs_pallas_interpret(key):
    rp = ref_plan.ScalePlan(*key)
    assert pallas_bilinear.applicable(rp) and bilinear.applicable(ScalePlan(*key))
    imgs = _images(key, sum(key))
    pallas_bilinear._built.cache_clear()
    try:
        with mock.patch.object(pl, "pallas_call", _interp_call):
            tpu = np.asarray(pallas_bilinear.scale_fn(rp, imgs))
    finally:
        pallas_bilinear._built.cache_clear()
    got = _port(key, imgs)
    assert np.array_equal(got, tpu)
    assert np.array_equal(got, _spec(key, imgs))


@pytest.mark.parametrize("key", RGB24, ids=_id)
def test_bilinear_24bpp_vs_pallas_planes(key):
    """The port reads and writes 3-byte pixels directly; the JAX package
    runs the 4-byte surrogate plan, with 24bpp input through the planes
    feed."""
    import jax

    rp = ref_plan.ScalePlan(*key)
    adapted = xla._adapt_24bpp(rp)
    assert adapted is not None and pallas_bilinear.applicable(adapted[0])
    assert not pallas_box.applicable(adapted[0])
    imgs = _images(key, sum(key))
    saved = xla._FORCE_PALLAS, xla._RGB24_PLANES
    xla._FORCE_PALLAS, xla._RGB24_PLANES = True, True
    pallas_bilinear._built.cache_clear()
    pallas_bilinear._built_planes.cache_clear()
    try:
        with mock.patch.object(pl, "pallas_call", _interp_call):
            tpu = np.asarray(jax.jit(lambda v: xla.scale_fn(rp, v))(imgs))
    finally:
        xla._FORCE_PALLAS, xla._RGB24_PLANES = saved
        pallas_bilinear._built.cache_clear()
        pallas_bilinear._built_planes.cache_clear()
    got = _port(key, imgs)
    assert np.array_equal(got, tpu)
    assert np.array_equal(got, _spec(key, imgs))


@pytest.mark.parametrize("key,first,n", ROWS, ids=lambda v: _id(v) if isinstance(v, tuple) else str(v))
def test_rows_vs_pallas_rows(key, first, n):
    rp = ref_plan.ScalePlan(*key)
    imgs = _images(key, sum(key) + first)
    pallas_bilinear._built_rows.cache_clear()
    try:
        with mock.patch.object(pl, "pallas_call", _interp_call):
            tpu = np.asarray(pallas_bilinear.scale_rows_fn(rp, imgs, first, n))
    finally:
        pallas_bilinear._built_rows.cache_clear()
    got = _port(key, imgs, first, n)
    assert got.shape == (2, n, key[2], 4)
    assert np.array_equal(got, tpu)
    assert np.array_equal(got, _spec(key, imgs)[:, first : first + n])


@pytest.mark.parametrize("key", PAST_64, ids=_id)
def test_past_64_matches_jax_and_spec(key):
    """The class past 64:1: the plain version against numpy_ref and the
    JAX package's public API."""
    plan = ScalePlan(*key)
    assert bilinear.applicable(plan)
    assert any(ax.filter == port_plan.FilterType.BOX and ax.dim_in > 64 * ax.dim_out
               for ax in (plan.x, plan.y))
    imgs = _images(key, sum(key))
    got = _port(key, imgs)
    assert np.array_equal(got, _spec(key, imgs))
    assert np.array_equal(got, smolscale_tpu.scale(smolscale_tpu.ScalePlan(*key), imgs,
                                                   backend="jax"))


@pytest.mark.parametrize("key,first,n", PAST_64_ROWS,
                         ids=lambda v: _id(v) if isinstance(v, tuple) else str(v))
def test_past_64_rows_match_jax(key, first, n):
    """Row ranges past 64:1 through the public row API, against the JAX
    package's ``scale_rows`` and ``scale_streamed`` and numpy_ref."""
    plan, rp = ScalePlan(*key), smolscale_tpu.ScalePlan(*key)
    img = _images(key, sum(key) + first, batch=1)[0]
    got = stt.scale_rows(plan, img, first, n, device="cpu")
    assert np.array_equal(got.numpy(), smolscale_tpu.scale_rows(rp, img, first, n, backend="jax"))
    assert np.array_equal(got.numpy(), numpy_ref.scale(rp, img)[first : first + n])
    ours = list(stt.scale_streamed(plan, img, n_chunks=4, device="cpu"))
    theirs = list(smolscale_tpu.scale_streamed(rp, img, n_chunks=4, backend="jax"))
    assert [f for f, _ in ours] == [f for f, _ in theirs]
    assert all(np.array_equal(a.numpy(), np.asarray(b)) for (_, a), (_, b) in zip(ours, theirs))


@pytest.mark.parametrize("key", STAGED, ids=_id)
def test_staged_tile_edges_match_jax_and_spec(key):
    """The plans that put the kernel's column tiles on their edges: the
    plain version against numpy_ref and the JAX package's public API, and
    the tile width they give."""
    plan = ScalePlan(*key)
    assert bilinear.applicable(plan)
    lanes, stages = bilinear.stage_table(plan.x, plan.meta_in.n_bytes)
    assert stages.shape[1] == -(-plan.width_out * lanes // bilinear.THREADS)
    imgs = _images(key, sum(key))
    got = _port(key, imgs)
    assert np.array_equal(got, _spec(key, imgs))
    assert np.array_equal(got, smolscale_tpu.scale(smolscale_tpu.ScalePlan(*key), imgs,
                                                   backend="jax"))


@pytest.mark.parametrize("key,first,n", STAGED_ROWS,
                         ids=lambda v: _id(v) if isinstance(v, tuple) else str(v))
def test_staged_rows_match_spec(key, first, n):
    imgs = _images(key, sum(key) + first)
    assert np.array_equal(_port(key, imgs, first, n), _spec(key, imgs)[:, first : first + n])


@pytest.mark.parametrize(
    "key",
    [
        (80, 96, 37, 41, 0, 4),        # tests/test_api_strides.py's streamed plan
        (64, 64, 33, 29, 5, 0),        # 0h, unassociated in
        (640, 640, 64, 64, 0, 0),      # integer box: rows on the bilinear kernel
        (160, 160, 96, 60, 8, 9),      # RGB24 -> BGR24
    ],
    ids=_id,
)
def test_api_rows_match_jax(key):
    img = _images(key, 3, batch=1)[0]
    plan, rp = ScalePlan(*key), smolscale_tpu.ScalePlan(*key)
    h = key[3]
    first, n = h // 4, h // 2
    want = smolscale_tpu.scale_rows(rp, img, first, n, backend="jax")
    got = stt.scale_rows(plan, img, first, n, device="cpu")
    assert got.dtype == torch.uint8 and np.array_equal(got.numpy(), want)
    # out= takes a view into a larger buffer
    canvas = torch.full((n + 2, key[2], want.shape[-1]), 0xAB, dtype=torch.uint8)
    res = stt.scale_rows(plan, torch.from_numpy(img), first, n, out=canvas[1:-1])
    assert np.array_equal(res.numpy(), want) and np.array_equal(canvas[1:-1].numpy(), want)
    assert (canvas[0] == 0xAB).all() and (canvas[-1] == 0xAB).all()

    def invert(rows):
        return 255 - rows

    for post_fn in (None, invert):
        ours = [(f, r.numpy()) for f, r in
                stt.scale_streamed(plan, img, n_chunks=5, post_fn=post_fn, device="cpu")]
        theirs = list(smolscale_tpu.scale_streamed(rp, img, n_chunks=5, backend="jax",
                                                   post_fn=post_fn))
        assert [f for f, _ in ours] == [f for f, _ in theirs]
        assert all(np.array_equal(a, np.asarray(b)) for (_, a), (_, b) in zip(ours, theirs))
    full = np.concatenate([r for _, r in ours])
    assert np.array_equal(255 - full, smolscale_tpu.scale(rp, img, backend="jax"))


def test_row_range_checks():
    key = (80, 96, 37, 41, 0, 4)
    plan, rp = ScalePlan(*key), smolscale_tpu.ScalePlan(*key)
    img = _images(key, 4, batch=1)[0]
    for first, n in [(-1, 3), (0, 0), (40, 2), (0, 42)]:
        with pytest.raises(ValueError, match="row range"):
            smolscale_tpu.scale_rows(rp, img, first, n, backend="jax")
        with pytest.raises(ValueError, match="row range"):
            stt.scale_rows(plan, img, first, n, device="cpu")
    # more chunks than rows: one row per chunk
    assert [f for f, _ in stt.scale_streamed(plan, img, n_chunks=100, device="cpu")] == list(range(41))


def _axis_pair(dim_in, dim_out):
    """The BOX axis plan of both packages for (dim_in, dim_out), whatever
    filter the planner would pick: ratios below 8:1 give the early-break
    tables (zero strides at the tail) that ScalePlan never builds."""
    pair = []
    for mod in (ref_plan, port_plan):
        ofs, frac, strides, span_mul = mod.precalc_boxes(dim_in, dim_out)
        pair.append(mod.AxisPlan(dim_in, dim_out, mod.FilterType.BOX, 0, dim_out,
                                 ofs, frac, strides, span_mul))
    return pair


@pytest.mark.parametrize(
    "dims",
    [(1100, 80), (4096, 300), (4096, 256), (700, 50), (990, 110), (96, 4), (640, 10),
     (9, 10), (10, 20), (16, 15), (3, 8), (5, 9)],
    ids=lambda d: f"{d[0]}-{d[1]}",
)
def test_box_tables_match_xla(dims):
    ref_ax, port_ax = _axis_pair(*dims)
    assert (port_ax.strides[-1] == 0) == (dims[0] < 8 * dims[1])
    for mine, theirs in ((bilinear.box_h_arrays(port_ax), xla._box_h_arrays(ref_ax)),
                         (bilinear.box_v_arrays(port_ax), xla._box_v_arrays(ref_ax))):
        assert mine.keys() == theirs.keys()
        for name in mine:
            assert np.array_equal(mine[name], theirs[name]), name


def _stage_axes():
    """(id, axis, nb): boxes from 2:1 (the early-break tables) to 255:1 at
    widths that put the tiles on their edges, with 3- and 4-byte pixels."""
    out = []
    for ratio in (2, 3, 7.5, 14, 15, 16, 17, 18, 33, 64.5, 128, 200, 255):
        for dim_out in (1, 7, 15, 16, 17, 31, 32, 33, 255, 256, 257):
            dim_in = int(ratio * dim_out)
            if not dim_out < dim_in <= port_plan.MAX_DIM:
                continue
            ax = _axis_pair(dim_in, dim_out)[1]
            out += [(f"box-{dim_in}-{dim_out}-{nb}", ax, nb) for nb in (3, 4)]
    return out


@pytest.mark.parametrize("name,ax,nb", _stage_axes(), ids=lambda v: v if isinstance(v, str) else "")
def test_stage_table_covers_every_read(name, ax, nb):
    """A box axis whose columns read 16 pixels or more is staged: each
    tile's stretch [lo, hi) holds every input column that the kernel reads
    from the axis table for the tile's outputs, lies in the row, and fits
    the shared-memory budget; lanes are a power of two up to 32.  Shorter
    boxes load directly."""
    lanes, stages = bilinear.stage_table(ax, nb)
    tab = bilinear.axis_table(ax, vertical=False).reshape(6, -1)
    reads = [np.concatenate([[left, right], np.arange(mid, mid + n_mid)])
             for left, _, mid, n_mid, right, _ in tab.T]
    if max(r.max() - r.min() + 1 for r in reads) < bilinear.STAGE_MIN_READS:
        assert lanes == 0 and stages.shape == (2, 0)
        return
    assert lanes in (1, 2, 4, 8, 16, 32)
    per = bilinear.THREADS // lanes
    assert stages.dtype == np.int32 and stages.shape == (2, -(-ax.dim_out // per))
    lo, hi = stages
    assert (0 <= lo).all() and (lo < hi).all() and (hi <= ax.dim_in).all()
    assert ((hi - lo) * nb <= bilinear.STAGE_BYTES).all()
    for j, r in enumerate(reads):
        assert lo[j // per] <= r.min() and r.max() < hi[j // per], j
    # lanes split the pixels between a column's edges into at most
    # LANE_READS each, or fewer where the tile would not fit
    assert lanes == 32 or int(ax.strides.max()) <= bilinear.LANE_READS * lanes


@pytest.mark.parametrize(
    "key",
    [(2048, 2048, 256, 256, 0, 0), (4096, 4096, 1371, 1371, 8, 8), (512, 512, 1024, 1024, 5, 0),
     (4096, 4096, 300, 300, 0, 0), (4096, 4096, 4096, 32, 0, 0), (1, 700, 9, 123, 4, 0)],
    ids=_id,
)
def test_other_axes_load_directly(key):
    """Ladders, upscales, boxes under 16 pixels per column (row 3d's
    13.65:1), COPY and ONE X axes take the direct path: no lanes, no
    stretches."""
    plan = ScalePlan(*key)
    lanes, stages = bilinear.stage_table(plan.x, plan.meta_in.n_bytes)
    assert lanes == 0 and stages.shape == (2, 0)


def test_stage_constants_match_kernel():
    """The staging constants of ops/bilinear.py are the kernel's, those of
    the direct path's forms included."""
    src = (Path(bilinear.__file__).resolve().parent.parent / "csrc" / "bilinear.cu").read_text()
    assert f"constexpr int kThreads = {bilinear.THREADS};" in src
    assert f"constexpr int kStageBytes = {bilinear.STAGE_BYTES};" in src
    assert f"constexpr int kHWords = {bilinear.H_WORDS};" in src
    assert (f"enum Form {{ kLoop = {bilinear.LOOP}, kHTile = {bilinear.H_TILE}, "
            f"kRoll = {bilinear.ROLL} }};") in src


def test_axis_tables_layout():
    plan = ScalePlan(2048, 1100, 256, 80, 0, 0)      # 2h ladder x 13.75:1 box
    tx = bilinear.axis_table(plan.x, vertical=False)
    assert np.array_equal(tx, np.concatenate([plan.x.offsets, plan.x.factors]))
    assert len(tx) == 2 * plan.x.dim_bilin == 2 * 1024
    ty = bilinear.axis_table(plan.y, vertical=True).reshape(6, -1)
    v = bilinear.box_v_arrays(plan.y)
    assert np.array_equal(ty, np.stack([v[k] for k in ("first_idx", "w1", "mid_start",
                                                       "mid_len", "last_idx", "w2")]))
    assert bilinear.axis_table(ScalePlan(64, 64, 64, 32, 0, 0).x, vertical=False).size == 0


def test_kernel_params_follow_plan():
    plan = ScalePlan(2048, 2048, 256, 256, 0, 0)
    lanes, stages = bilinear._stage_tables(plan, torch.device("cpu"))
    assert lanes == 0 and stages.numel() == 0            # a ladder loads directly
    p = bilinear._params(plan, 32, 0, 256, lanes)
    assert (p.batch, p.row0, p.n_rows, p.kind_x, p.kind_y) == (32, 0, 256, bilinear.BILINEAR,
                                                               bilinear.BILINEAR)
    assert (p.halvings_x, p.halvings_y, p.len_x, p.len_y, p.lanes_x) == (2, 2, 1024, 1024, 0)
    # the direct path's tiles, grid and form: 32 x 8 tiles, 32 row groups,
    # cut to 16 blocks per SM of 132 over 8 column tiles and 32 images
    assert (p.tile_w, p.grid_y, p.grid_z) == (32, 8, 32)
    # a 2h ladder's row group of 8 rows reads 64 rows: 64 x 32 words
    assert (p.form, p.h_words) == (bilinear.H_TILE, 2048) == (bilinear.direct_form(plan),
                                                               bilinear.h_words(plan))
    # a row range inside row groups, on 100 SMs, in the LOOP form: 26 row
    # groups, cut to 1600 // (32 column tiles * 8 images)
    up = ScalePlan(512, 512, 1024, 1024, 5, 0)
    r = bilinear._params(up, 8, 100, 200, 0, bilinear.LOOP, 100)
    assert (r.row0, r.n_rows, r.form) == (100, 200, bilinear.LOOP)
    assert (r.tile_w, r.grid_y, r.grid_z) == (32, 6, 8)
    # routed to ROLL: tile rows of 32 threads over 128 columns, strips as
    # long as 16 blocks per SM of 100 leave them (25 over 8 column tiles and
    # 8 images, 8 strips a block: one row each)
    q = bilinear._params(up, 8, 100, 200, 0, sms=100)
    assert q.form == bilinear.ROLL == bilinear.direct_form(up)
    assert (q.tile_w, q.strip_rows, q.grid_y, q.grid_z) == (128, 1, 25, 8)
    h = bilinear._params(up, 8, 100, 200, 0, bilinear.H_TILE, 100)
    assert (h.form, h.tile_w, h.grid_y) == (bilinear.H_TILE, 32, 6)
    # a form that does not fit the plan raises
    with pytest.raises(ValueError, match="form"):
        bilinear._params(ScalePlan(4096, 4096, 4096, 32, 0, 0), 8, 0, 32, 0, bilinear.H_TILE)
    q = bilinear._params(ScalePlan(4096, 1, 300, 7, 9, 5), 2, 3, 4, 0)  # box x ONE
    assert (q.kind_x, q.kind_y, q.len_x, q.len_y, q.row0, q.n_rows) == (
        bilinear.BOX, bilinear.ONE, 300, 0, 3, 4)
    assert q.span_mul_x == ScalePlan(4096, 1, 300, 7, 9, 5).x.span_mul
    assert (q.nb_in, q.nb_out, q.alpha_ch, q.unassoc_in, q.unassoc_out) == (3, 4, 3, 0, 1)
    assert list(q.src) == [0, 1, 2, 3]
    # a 128:1 box: 8 lanes per column, tiles of 32 columns
    strip = ScalePlan(16384, 2048, 128, 1024, 0, 0)
    lanes, stages = bilinear._stage_tables(strip, torch.device("cpu"))
    assert lanes == 8 and bilinear._params(strip, 2, 0, 1024, lanes).lanes_x == 8
    assert stages.view(2, -1)[0].tolist() == [0, 4096, 8192, 12288]
    # a 16:1 box: one lane, one tile of 256 columns
    lanes, stages = bilinear._stage_tables(ScalePlan(4096, 4096, 256, 256, 0, 0),
                                           torch.device("cpu"))
    assert lanes == 1 and stages.tolist() == [0, 4096]


@pytest.mark.parametrize(
    "key,ok",
    [
        ((640, 640, 64, 64, 0, 0), True),      # integer box: both kernels' class
        ((4096, 4096, 300, 300, 0, 0), True),  # non-integer box 13.65:1
        ((6400, 100, 100, 100, 0, 0), True),   # box at exactly 64:1
        ((6500, 100, 100, 100, 0, 0), True),   # box past 64:1 x COPY
        ((6500, 6500, 100, 100, 0, 0), False), # box x box past 64:1: the deep box kernel
        ((6500, 200, 100, 1, 0, 0), True),     # box x box past 64:1, one output row
        ((25500, 100, 100, 100, 0, 0), True),  # 255:1 box x COPY
        ((4096, 512, 16, 2, 0, 0), False),     # 256:1 at 128bpp
        ((256, 256, 100, 100, 4, 4), False),   # PREMUL16
        ((256, 256, 100, 100, 0, 0, True), False),  # sRGB linear
    ],
    ids=lambda v: _id(v) if isinstance(v, tuple) else str(v),
)
def test_applicability_gate(key, ok):
    assert bilinear.applicable(ScalePlan(*key)) == ok


def test_scale_dispatch_order(monkeypatch):
    """Whole images try the box kernel first, then this one; rows go to
    this one for integer box too."""
    calls = []
    monkeypatch.setattr(box, "scale_fn", lambda plan, x: calls.append("box"))
    monkeypatch.setattr(bilinear, "scale_fn", lambda plan, x: calls.append("bilinear"))
    monkeypatch.setattr(bilinear, "scale_rows_fn", lambda plan, x, f, n: calls.append("rows"))
    img = torch.zeros((640, 640, 4), dtype=torch.uint8)
    stt.scale(ScalePlan(640, 640, 64, 64, 0, 0), img)
    stt.scale(ScalePlan(640, 640, 100, 100, 0, 0), img)
    stt.scale_rows(ScalePlan(640, 640, 64, 64, 0, 0), img, 3, 5)
    assert calls == ["box", "bilinear", "rows"]


def test_wrapper_rejects_bad_input():
    plan = ScalePlan(256, 128, 64, 32, 0, 0)
    with pytest.raises(TypeError):
        bilinear.scale_fn(plan, torch.zeros((128, 256, 4), dtype=torch.int32))
    with pytest.raises(ValueError):
        bilinear.scale_fn(plan, torch.zeros((128, 256, 3), dtype=torch.uint8))
    with pytest.raises(ValueError, match="class"):
        bilinear.scale_fn(ScalePlan(256, 256, 16, 16, 4, 4),
                          torch.zeros((256, 256, 4), dtype=torch.uint8))
    with pytest.raises(ValueError, match="row range"):
        bilinear.scale_rows_fn(plan, torch.zeros((128, 256, 4), dtype=torch.uint8), 30, 3)
    # a device with no kernel raises instead of falling back
    with pytest.raises(ValueError, match="device"):
        bilinear.scale_fn(plan, torch.zeros((128, 256, 4), dtype=torch.uint8, device="meta"))


def test_single_image_shape():
    key = (300, 200, 290, 190, 2, 3)
    imgs = _images(key, 6, batch=1)
    got = bilinear.scale_fn(ScalePlan(*key), torch.from_numpy(imgs[0]))
    assert tuple(got.shape) == (190, 290, 4)
    assert np.array_equal(got.numpy(), _spec(key, imgs)[0])


def _smoke():
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_plans_are_held_here():
    """chip_smoke.py holds the kernel against the plain version on the card;
    every plan it checks is held against numpy_ref and the Pallas kernel
    or the JAX package by a test of this file."""
    smoke = _smoke()
    plans = smoke.BILINEAR_CHECK_PLANS + smoke.DIRECT_CHECK_PLANS + smoke.BILINEAR_UNALIGNED
    rows = smoke.BILINEAR_CHECK_ROWS + smoke.DIRECT_CHECK_ROWS
    assert set(plans) <= set(EXACT + UNASSOC_OUT + GENERAL_BOX + BOX_X_BOX + RGB24 + PAST_64
                             + STAGED + DIRECT)
    assert set(rows) <= set(ROWS + PAST_64_ROWS + STAGED_ROWS + DIRECT_ROWS)
    assert set(STAGED) <= set(plans) and set(STAGED_ROWS) <= set(rows)
    assert smoke.DIRECT_CHECK_PLANS == DIRECT and smoke.DIRECT_CHECK_ROWS == DIRECT_ROWS
    assert all(bilinear.applicable(ScalePlan(*k)) for k in plans)


@pytest.mark.parametrize("key", DIRECT, ids=_id)
def test_direct_tile_edges_match_jax_and_spec(key):
    """The plans that put the direct path's tiles on their edges: the plain
    version against numpy_ref and the JAX package's public API; none is a
    staged X box."""
    plan = ScalePlan(*key)
    assert bilinear.applicable(plan)
    assert bilinear.stage_table(plan.x, plan.meta_in.n_bytes)[0] == 0
    imgs = _images(key, sum(key))
    got = _port(key, imgs)
    assert np.array_equal(got, _spec(key, imgs))
    assert np.array_equal(got, smolscale_tpu.scale(smolscale_tpu.ScalePlan(*key), imgs,
                                                   backend="jax"))


@pytest.mark.parametrize("key,first,n", DIRECT_ROWS,
                         ids=lambda v: _id(v) if isinstance(v, tuple) else str(v))
def test_direct_rows_match_spec(key, first, n):
    imgs = _images(key, sum(key) + first)
    assert np.array_equal(_port(key, imgs, first, n), _spec(key, imgs)[:, first : first + n])


def _loop(starts, step, end):
    """Every value of ``for (v = start; v < end; v += step)`` over each
    start, as the kernel's loops run them."""
    return np.concatenate([np.arange(s, end, step) for s in starts] + [np.zeros(0, int)])


def _walk(w_out, first, n, batch, sms=132):
    """How many times csrc/bilinear.cu's direct loops, laid out by
    launch_shape, compute each image, output row and output column.  The
    loops nest independently: blocks z over images (b = z, z + grid_z, ...),
    blocks y over the range's row groups (g = first's group + y, + grid_y,
    ...) with thread row tr of each (i = g * tile_h + tr, kept in [first,
    first + n)), blocks x over column tiles with thread column c (j = x *
    tile_w + c, kept below w_out)."""
    tile_w, col_tiles, grid_y, grid_z = bilinear.launch_shape(w_out, first, n, batch, sms)
    shift = tile_w.bit_length() - 1
    tile_h = bilinear.THREADS >> shift
    assert tile_w == 1 << shift and tile_w <= 32 and tile_w * tile_h == bilinear.THREADS
    images = np.bincount(_loop(range(grid_z), grid_z, batch), minlength=batch)
    g_end = (first + n - 1) // tile_h + 1
    groups = _loop(range(first // tile_h, first // tile_h + grid_y), grid_y, g_end)
    rows = (groups[:, None] * tile_h + np.arange(tile_h)[None, :]).reshape(-1)
    rows = np.bincount(rows[(rows >= first) & (rows < first + n)] - first, minlength=n)
    cols = (np.arange(col_tiles)[:, None] * tile_w + np.arange(tile_w)[None, :]).reshape(-1)
    cols = np.bincount(cols[cols < w_out], minlength=w_out)
    return (tile_w, col_tiles, grid_y, grid_z), images, rows, cols


@pytest.mark.parametrize("w_out", [1, 7, 31, 32, 33, 257, 4096])
@pytest.mark.parametrize("n", [1, 7, 8, 9, 257])
@pytest.mark.parametrize("first", [0, 5, 300])
def test_launch_shape_covers_every_pixel_once(w_out, n, first):
    """Every output pixel of every image is computed exactly once, for row
    ranges from a row group's start and from inside one; grid y and z stay
    below 2^16, grid y holds no block without a row group, and the grid is
    cut to about 16 blocks per SM."""
    for batch in (1, 3):
        (tile_w, col_tiles, grid_y, grid_z), images, rows, cols = _walk(w_out, first, n, batch)
        assert (images == 1).all() and (rows == 1).all() and (cols == 1).all()
        tile_h = bilinear.THREADS // tile_w
        groups = (first + n - 1) // tile_h - first // tile_h + 1
        assert 1 <= grid_y <= min(groups, 65535) and 1 <= grid_z <= 65535
        assert grid_y == groups or col_tiles * grid_y * grid_z <= bilinear.BLOCKS_PER_SM * 132


@pytest.mark.parametrize("w_out,first,n,batch", [(8, 0, 8200, 8), (4, 0, 2, 70000),
                                                 (1, 3, 9, 8000), (4096, 0, 9, 7300)])
def test_launch_shape_covers_tall_batches(w_out, first, n, batch):
    """Batch x rows past 65,535, and batches past 65,535 images: grid z
    loops over images, and every pixel is still computed once."""
    assert batch * n > 65535
    (_, _, grid_y, grid_z), images, rows, cols = _walk(w_out, first, n, batch)
    assert (images == 1).all() and (rows == 1).all() and (cols == 1).all()
    assert grid_y <= 65535 and grid_z == min(batch, 65535)


def _reads(ax, tab, j):
    """The inputs the kernel reads for output ``j`` of an axis from its
    table, as csrc/bilinear.cu's filters walk it."""
    kind = bilinear.axis_kind(ax)
    if kind == bilinear.COPY:
        return [j]
    if kind == bilinear.ONE:
        return [0]
    if kind == bilinear.BILINEAR:
        k = 1 << ax.halvings
        ofs = tab[: len(tab) // 2]
        return [r for s in range(j * k, (j + 1) * k) for r in (ofs[s], ofs[s] + 1)]
    first, _, mid, n_mid, last, _ = tab.reshape(6, -1)[:, j]
    return [first, last, *range(mid, mid + n_mid)]


# every plan of the direct path's tests, the rows chip_smoke.py times on
# it, and the test_api_strides plan
WINDOW_PLANS = DIRECT + [
    (80, 96, 37, 41, 0, 4), (2048, 2048, 256, 256, 0, 0), (512, 512, 1024, 1024, 5, 0),
    (4096, 4096, 1371, 1371, 8, 8), (4096, 4096, 3000, 3000, 8, 8), (4096, 4096, 700, 700, 0, 0),
    (4096, 4096, 300, 300, 0, 0), (8192, 8192, 1024, 1024, 0, 0), (1024, 1024, 1024, 1024, 0, 0),
    (4096, 4096, 4096, 32, 0, 0), (1100, 300, 80, 100, 0, 0), (300, 1100, 100, 80, 4, 1),
    (16, 9000, 8, 8200, 0, 0), (8, 4, 4, 2, 8, 8),
]


@pytest.mark.parametrize("key", WINDOW_PLANS, ids=_id)
def test_direct_windows_hold_every_read(key):
    """Each row group's window [r_lo, r_hi) lies in the image and holds every
    V tap row of each of its output rows, as the kernel's V filter walks the
    plan's V table (H_TILE reads the windows; LOOP does not)."""
    plan = ScalePlan(*key)
    tile_h = bilinear.THREADS // bilinear.tile_width(plan.width_out)
    win = bilinear.row_windows(plan)
    tab = bilinear.axis_table(plan.y, vertical=True)
    assert win.dtype == np.int32 and win.shape == (2, -(-plan.height_out // tile_h))
    assert (0 <= win[0]).all() and (win[0] < win[1]).all() and (win[1] <= plan.height_in).all()
    for i in range(plan.height_out):
        reads = _reads(plan.y, tab, i)
        lo, hi = win[:, i // tile_h]
        assert lo <= min(reads) and max(reads) < hi, i
    assert torch.equal(bilinear._windows(plan, torch.device("cpu")),
                       torch.from_numpy(win.reshape(-1)))


@pytest.mark.parametrize("key", WINDOW_PLANS, ids=_id)
def test_direct_forms_fit_shared_memory(key):
    """H_TILE runs a plan only where its widest row group's taps fit
    kHWords words at the tile's width; its shared memory (h_words, a
    multiple of 4) holds every row group's taps.  ROLL runs exactly the
    0-halving bilinear V axes, up and down, beside a BILINEAR, COPY or ONE X
    axis, and takes them.  The routed form is one that fits."""
    plan = ScalePlan(*key)
    forms, form = bilinear.direct_forms(plan), bilinear.direct_form(plan)
    rows = bilinear.row_windows(plan)
    taps = int((rows[1] - rows[0]).max())
    tile_w = bilinear.tile_width(plan.width_out)
    words = bilinear.h_words(plan)
    assert forms[0] == bilinear.LOOP and form in forms
    assert (bilinear.H_TILE in forms) == (taps * tile_w <= bilinear.H_WORDS)
    assert words % 4 == 0 and taps * tile_w <= words < taps * tile_w + 4
    if bilinear.H_TILE in forms:
        assert words <= bilinear.H_WORDS
    y = plan.y
    roll = (bilinear.axis_kind(y) == bilinear.BILINEAR and y.halvings == 0
            and bilinear.axis_kind(plan.x) != bilinear.BOX)
    assert (bilinear.ROLL in forms) == roll == (form == bilinear.ROLL)


def test_a_deep_v_box_stays_on_loop():
    """a1-strip-rows (COPY x 128:1 box): a row group reads 1,025 rows, past
    the h tile, so only LOOP takes it."""
    plan = ScalePlan(4096, 4096, 4096, 32, 0, 0)
    assert bilinear.direct_forms(plan) == [bilinear.LOOP] == [bilinear.direct_form(plan)]


_CONFIGS = Path(__file__).resolve().parent.parent / "portbench" / "configs"


def _parent_form(plan):
    """The direct path's form before ROLL: H_TILE where it fits and pays."""
    fits = bilinear.h_tile_fits(plan) and bilinear.h_tile_pays(plan)
    return bilinear.H_TILE if fits else bilinear.LOOP


def _levels(fleet):
    return [ScalePlan(*g["size"], s, s, g["pixel_type"], g["pixel_type"], fleet["with_srgb"])
            for g in fleet["groups"] for s in fleet["sizes"]]


# configuration -> its plans, those that route to ROLL (V upscales, V
# downscales) and those that keep the form they had before ROLL
ROLL_ROUTES = {"frames-2160p": (200, 101, 50, 49), "conv-2160p": (100, 0, 100, 0),
               "fleet-5b": (15, 0, 5, 10)}


@pytest.mark.parametrize("config", ROLL_ROUTES)
def test_roll_takes_every_0h_v_axis_and_nothing_else(config):
    """Each configuration's plans whose V axis is a 0-halving bilinear one
    route to ROLL, upscales and downscales alike, and every other plan keeps
    the form it had before ROLL.  frames-2160p: the 101 V upscales and the
    50 0h V downscales; the 25 + 13 V ladders and the 11 box x box plans
    keep theirs.  conv-2160p: every one of the 84 pairs that reach
    ``bilinear.cu``.  fleet-5b: the five 256^2 levels (0h), the 384^2
    group's among them, which the farm runs on ``bilinear.cu``; the 64^2
    and 128^2 ladders keep H TILE."""
    data = json.loads((_CONFIGS / f"{config}.json").read_text())
    plans = (_levels(data["fleet"]) if "fleet" in data
             else [ScalePlan(*k) for k in traffic.frame_plans(data["frames"])])
    rolled = [p for p in plans if bilinear.direct_form(p) == bilinear.ROLL]
    kept = [p for p in plans if p not in rolled]
    assert (len(plans), sum(p.height_out > p.height_in for p in rolled),
            sum(p.height_out < p.height_in for p in rolled), len(kept)) == ROLL_ROUTES[config]
    for p in rolled:
        assert bilinear.axis_kind(p.y) == bilinear.BILINEAR and p.y.halvings == 0, p.key
        assert bilinear.axis_kind(p.x) != bilinear.BOX, p.key
    for p in kept:
        assert bilinear.ROLL not in bilinear.direct_forms(p)
        assert bilinear.direct_form(p) == _parent_form(p), p.key
    on_bilinear = [p for p in plans if torch_ops.whole_kernel(p) is bilinear]
    if config == "conv-2160p":
        assert len(on_bilinear) == 84 and all(p in rolled for p in on_bilinear)
    if config == "fleet-5b":
        level = ScalePlan(384, 384, 256, 256, 0, 0)
        assert level in on_bilinear and level in rolled


def _lerp4(p, q, f):
    """csrc/bilinear.cu's lerp4 in uint32 arithmetic (held in uint64 and cut
    to 32 bits after each sum)."""
    m, g = np.uint64(0xFFFFFFFF), np.uint64(256 - f)
    f = np.uint64(f)
    lo = ((p & np.uint64(0x00FF00FF)) * f + (q & np.uint64(0x00FF00FF)) * g) & m
    hi = (((p >> np.uint64(8)) & np.uint64(0x00FF00FF)) * f
          + ((q >> np.uint64(8)) & np.uint64(0x00FF00FF)) * g) & m
    return ((lo >> np.uint64(8)) & np.uint64(0x00FF00FF)) | (hi & np.uint64(0xFF00FF00))


def test_lerp4_is_lerp_for_every_p_q_and_f():
    """ROLL's lerp of two channels in the 16-bit halves of a word gives, in
    every byte, the byte of ``lerp`` (((p - q)*F >> 8) + q, masked to 8 bits)
    for every p and q in 0..255 and F in 0..256, beside neighbours equal to
    p and q and beside others."""
    p, q = (a.ravel() for a in np.meshgrid(np.arange(256), np.arange(256), indexing="ij"))
    words = [(p, q, p, q, p, q, p, q), (p, q, q, p, 255 - p, 255 - q, 255 - q, 255 - p)]
    for f in range(257):
        want_pq = ((((p - q) * f) >> 8) + q) & 0xFF
        want_qp = ((((q - p) * f) >> 8) + p) & 0xFF
        want_rr = (((((255 - p) - (255 - q)) * f) >> 8) + 255 - q) & 0xFF
        want_ss = (((((255 - q) - (255 - p)) * f) >> 8) + 255 - p) & 0xFF
        for pw, qw, want in (
            (words[0][::2], words[0][1::2], (want_pq,) * 4),
            (words[1][::2], words[1][1::2], (want_pq, want_qp, want_rr, want_ss)),
        ):
            pu = sum(np.uint64(b) << np.uint64(8 * k) for k, b in enumerate(pw))
            qu = sum(np.uint64(b) << np.uint64(8 * k) for k, b in enumerate(qw))
            got = _lerp4(pu.astype(np.uint64), qu.astype(np.uint64), f)
            for k in range(4):
                assert np.array_equal((got >> np.uint64(8 * k)) & np.uint64(0xFF),
                                      want[k].astype(np.uint64)), (f, k)


def _roll_stores(w_out, first, n, batch, nb, sms):
    """How many times csrc/bilinear.cu's ROLL loops, laid out by roll_shape,
    store each image, output row and output column of an output that starts
    on a 16-byte boundary, and check that each word of 4 pixels is stored at
    an aligned address (16 bytes; 3-byte pixels: 4).  Blocks z over images,
    blocks y over strips (a block's thread rows, ``THREADS // lanes``
    strips; s = y * per_block + row, + grid_y * per_block, ...), rows
    [first + s * strip_rows, + strip_rows) of each; in a row whose address
    is ``a`` pixels past the alignment, lane t of column tile x (columns j0
    = x * tile_w + 4t ..) stores the aligned word of 4 pixels from j0 - a
    (lane 0: its pixels j0 .. j0 + 3 - a alone; the last lane also its last
    a pixels), no column at w_out or past."""
    tile_w, col_tiles, strip_rows, grid_y, grid_z = bilinear.roll_shape(
        w_out, first, n, batch, sms)
    lanes = tile_w // bilinear.ROLL_COLS
    per_block = bilinear.THREADS // lanes
    assert lanes == 1 << (lanes.bit_length() - 1) and lanes <= 32 and grid_y < 2**16
    assert col_tiles * tile_w >= w_out > (col_tiles - 1) * tile_w
    strips = -(-n // strip_rows)
    count = np.zeros((batch, n, w_out), dtype=int)
    row_bytes = w_out * nb
    for b in _loop(range(grid_z), grid_z, batch):
        for s in _loop(range(grid_y * per_block), grid_y * per_block, strips):
            for i in range(first + s * strip_rows, min(first + (s + 1) * strip_rows, first + n)):
                base = (b * n + i - first) * row_bytes
                a = (base >> 2) & 3 if nb == 4 else (3 * base) & 3
                for x in range(col_tiles):
                    for t in range(lanes):
                        j0 = x * tile_w + 4 * t
                        cols = []
                        if t > 0 or a == 0:
                            cs = j0 - a
                            if cs + 3 < w_out:
                                assert (base + cs * nb) % (16 if nb == 4 else 4) == 0
                                cols += range(cs, cs + 4)
                            else:
                                cols += [c for c in range(cs, cs + 3) if c < w_out]
                        else:
                            cols += [j0 + k for k in range(4 - a) if j0 + k < w_out]
                        if t == lanes - 1 and a > 0:
                            cols += [j0 + k for k in range(4 - a, 4) if j0 + k < w_out]
                        count[b, i - first, cols] += 1
    return count


@pytest.mark.parametrize("nb", [3, 4])
@pytest.mark.parametrize("w_out", [1, 2, 3, 5, 7, 8, 127, 128, 129, 130, 131, 257])
@pytest.mark.parametrize("first,n,batch,sms", [(0, 9, 2, 132), (5, 30, 1, 132), (3, 40, 3, 1)])
def test_roll_stores_every_pixel_once(nb, w_out, first, n, batch, sms):
    """ROLL's strips and lanes store every output pixel of the range exactly
    once, at every alignment of a row, its words of 4 pixels aligned."""
    assert (_roll_stores(w_out, first, n, batch, nb, sms) == 1).all()


@pytest.mark.parametrize("w_out,n,batch", [(8, 65535, 1), (4096, 65535, 2), (4, 3, 70000),
                                           (3839, 2159, 64), (7296, 4104, 8), (256, 256, 341),
                                           (1, 65535, 1)])
def test_roll_shape_stays_in_the_grid(w_out, n, batch):
    """Tall ranges and batches, conv-2160p's 64 frames, up-2160's 8 and a
    farm sub-batch: grid y and z stay below 2^16, strips are at most
    ROLL_STRIP_ROWS long, every block holds at least one strip, and the
    strips that the blocks' loops walk cover the range once."""
    tile_w, col_tiles, strip_rows, grid_y, grid_z = bilinear.roll_shape(w_out, 0, n, batch)
    per_block = bilinear.THREADS * bilinear.ROLL_COLS // tile_w
    assert grid_y < 2**16 and grid_z < 2**16 and 1 <= strip_rows <= bilinear.ROLL_STRIP_ROWS
    strips = -(-n // strip_rows)
    assert grid_y * per_block - strips < per_block
    walked = _loop(range(grid_y * per_block), grid_y * per_block, strips)
    assert np.array_equal(np.sort(walked), np.arange(strips))
    assert np.array_equal(np.sort(_loop(range(grid_z), grid_z, batch)), np.arange(batch))
