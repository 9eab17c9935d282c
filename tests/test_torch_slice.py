"""The port's public API (smolscale_tpu_torch.scale / scale_simple) on CPU
tensors against the JAX package's public API on its XLA op graph
(``smolscale_tpu.scale(..., backend="jax")`` on the CPU) and numpy_ref.

Small analogues of the suite rows on the ported path: 0 (box x box), 3e
(premultiplied -> unassociated) and 8 (COPY x box) on the box kernel; 1
(2h ladder), 2 (0h upscale, BGRA unassociated -> RGBA), 3a / 3b (RGB24 1h /
0h), 3c (2h) and 3d (non-integer box) on the general kernel; 7b (256:1 at
128bpp), 9 (ragged 341.3:1), 9b (PREMUL16), 9c (sRGB linear light) and 9d
(RGB24) on the deep box kernel; plus 24bpp, unassociated input and a COPY x
COPY repack; and 128bpp plans with a bilinear axis or one output column on
the 128bpp kernel.  The tolerance is byte equality.
"""

import itertools

import numpy as np
import pytest
import torch

import smolscale_tpu
import smolscale_tpu_torch as stt
from smolscale_tpu.backends import numpy_ref
from smolscale_tpu_torch.backends import torch_ops
from smolscale_tpu_torch.formats import PixelType
from smolscale_tpu_torch.ops import bilinear, bilinear128, box, deep

SLICE_PLANS = [
    (256, 256, 16, 16, 0, 0),    # row 0 analogue
    (256, 256, 16, 16, 0, 4),    # row 3e analogue
    (256, 256, 256, 16, 0, 0),   # row 8 analogue
    (160, 90, 16, 9, 8, 8),      # RGB24, width not a multiple of 128
    (320, 160, 32, 16, 4, 1),    # unassociated in, reorder
    (256, 128, 16, 128, 3, 7),   # box x COPY, unassociated out
    (256, 256, 32, 32, 0, 0),    # row 1 analogue: 2h ladder
    (64, 64, 128, 128, 5, 0),    # row 2 analogue: 0h upscale, BGRA unassoc in
    (512, 512, 171, 171, 8, 8),  # row 3a analogue: RGB24 1h
    (512, 512, 375, 375, 8, 8),  # row 3b analogue: RGB24 0h
    (512, 512, 87, 87, 0, 0),    # row 3c analogue: 2h, 5.9:1
    (512, 512, 37, 37, 0, 0),    # row 3d analogue: non-integer box 13.8:1
    (256, 256, 100, 100, 0, 0),  # bilinear
    (300, 300, 22, 22, 0, 0),    # non-integer box
    (64, 64, 64, 64, 0, 1),      # COPY x COPY repack
    (1000, 1000, 7, 7, 0, 0),    # ragged deep box, 142.9:1
    (4096, 512, 16, 2, 0, 0),    # 256:1 box at 128bpp
    (1000, 1000, 15, 15, 0, 0),  # non-integer 64bpp box past 64:1
    (512, 512, 2, 2, 0, 0),      # row 7b analogue: 256:1 at 128bpp
    (1024, 1024, 3, 3, 0, 0),    # row 9 analogue: ragged 341.3:1
    (512, 512, 3, 3, 4, 4),      # row 9b analogue: PREMUL16, 170.7:1
    (572, 572, 2, 2, 0, 0, True),  # row 9c analogue: sRGB linear light, 286:1
    (999, 999, 3, 3, 8, 8),      # row 9d analogue: RGB24, 333:1
    # 128bpp kernel
    (256, 256, 100, 100, 0, 0, True),    # sRGB linear light, bilinear
    (256, 256, 100, 100, 4, 4, False),   # PREMUL16, bilinear
    (4096, 512, 16, 500, 0, 0, False),   # 256:1 box x bilinear at 128bpp
    (2000, 400, 1, 20, 0, 0, False),     # box x box with one output column, 2000:1
]


def _id(key):
    return "-".join(map(str, key))


def _images(key, seed, batch=2):
    nb = stt.get_meta(key[4]).n_bytes
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (batch, key[1], key[0], nb), dtype=np.uint8)


@pytest.mark.parametrize("key", SLICE_PLANS, ids=_id)
def test_scale_matches_jax_and_spec(key):
    imgs = _images(key, sum(key))
    got = stt.scale(stt.ScalePlan(*key), torch.from_numpy(imgs))
    assert got.dtype == torch.uint8 and got.device.type == "cpu"
    jax_out = smolscale_tpu.scale(smolscale_tpu.ScalePlan(*key), imgs, backend="jax")
    assert np.array_equal(got.numpy(), jax_out)
    rp = smolscale_tpu.ScalePlan(*key)
    assert np.array_equal(got.numpy(), np.stack([numpy_ref.scale(rp, im) for im in imgs]))


def test_post_fn_and_out():
    key = SLICE_PLANS[1]
    imgs = _images(key, 3)

    def invert(o):
        return 255 - o

    plan = stt.ScalePlan(*key)
    got = stt.scale(plan, torch.from_numpy(imgs), post_fn=invert)
    want = smolscale_tpu.scale(smolscale_tpu.ScalePlan(*key), imgs, backend="jax",
                               post_fn=invert)
    assert np.array_equal(got.numpy(), want)
    out = torch.zeros((2, 16, 16, 4), dtype=torch.uint8)
    res = stt.scale(plan, torch.from_numpy(imgs), post_fn=invert, out=out)
    assert res is out and np.array_equal(out.numpy(), want)


def test_numpy_input_needs_device(monkeypatch):
    """A numpy input runs on the card unless ``device`` says otherwise: with
    no card every entry point raises rather than run on the CPU, which only
    ``device="cpu"`` (or a CPU tensor) selects."""
    key = SLICE_PLANS[0]
    imgs = _images(key, 4)
    plan = stt.ScalePlan(*key)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (
        lambda: stt.scale(plan, imgs),
        lambda: stt.scale_simple(imgs[0], 0, 16, 16),
        lambda: stt.scale_rows(plan, imgs, 0, 4),
        lambda: next(stt.scale_streamed(plan, imgs)),
        lambda: stt.make_pyramid_fn(256, 256, 0, sizes=(32, 64))(imgs),
        lambda: stt.scale_pyramid_mixed(list(imgs), [0, 0], sizes=(32, 64)),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    got = stt.scale(plan, imgs, device="cpu")
    assert np.array_equal(got.numpy(), stt.scale(plan, torch.from_numpy(imgs)).numpy())
    # a tensor is computed where it lies: a different device is an error
    with pytest.raises(ValueError, match="lies on"):
        stt.scale(plan, torch.from_numpy(imgs), device="meta")


def test_scale_simple():
    imgs = _images((320, 160, 32, 16, 5, 2), 9, batch=1)
    img = imgs[0]
    want = smolscale_tpu.scale_simple(img, 5, 32, 16, 2, backend="jax")
    got = stt.scale_simple(torch.from_numpy(img), stt.PixelType.BGRA8_UNASSOCIATED,
                           32, 16, stt.PixelType.ARGB8_PREMULTIPLIED)
    assert np.array_equal(got.numpy(), want)
    got_np = stt.scale_simple(img, 5, 32, 16, 2, device="cpu")
    assert np.array_equal(got_np.numpy(), want)
    # same format out when none is given; batches keep their leading axis
    batch = torch.from_numpy(_images((256, 256, 16, 16, 1, 1), 2))
    out = stt.scale_simple(batch, 1, 16, 16)
    assert tuple(out.shape) == (2, 16, 16, 4)
    assert np.array_equal(out[1].numpy(), smolscale_tpu.scale_simple(
        batch[1].numpy(), 1, 16, 16, backend="numpy"))


# plans that raised NotImplementedError naming ROADMAP item A3 while no
# kernel took them; ``item`` keeps that name in the tests' ids
FORMER_GAPS = [
    ((256, 256, 256, 16, 0, 0, True), "A3"),     # COPY x box in linear light
    ((6500, 100, 100, 50, 0, 0, False), "A3"),   # 65:1 box x bilinear at 64bpp
    ((300, 600, 1, 600, 4, 4, False), "A3"),     # box x COPY at 128bpp
]
# the kernel that computes each, whole and by rows
FORMER_GAP_KERNEL = {
    (256, 256, 256, 16, 0, 0, True): bilinear128,
    (6500, 100, 100, 50, 0, 0, False): bilinear,
    (300, 600, 1, 600, 4, 4, False): bilinear128,
}


def _kernel_of(plan, kernels):
    return next(k for k in kernels if k.applicable(plan))


@pytest.mark.parametrize("key,item", FORMER_GAPS,
                         ids=lambda v: v if isinstance(v, str) else _id(v))
def test_other_plans_raise(key, item):
    """Plans outside the first slices' classes no longer raise: each reaches
    a kernel and gives the JAX package's and numpy_ref's bytes."""
    plan = stt.ScalePlan(*key)
    assert _kernel_of(plan, torch_ops.WHOLE_KERNELS) is FORMER_GAP_KERNEL[key]
    imgs = _images(key, sum(key))
    got = stt.scale(plan, torch.from_numpy(imgs))
    rp = smolscale_tpu.ScalePlan(*key)
    assert np.array_equal(got.numpy(), smolscale_tpu.scale(rp, imgs, backend="jax"))
    assert np.array_equal(got.numpy(), np.stack([numpy_ref.scale(rp, im) for im in imgs]))


@pytest.mark.parametrize(
    "key",
    [
        (2000, 400, 1, 20, 0, 0, False),     # one output column
        (256, 256, 100, 100, 4, 4, False),   # PREMUL16
        (256, 256, 100, 100, 0, 0, True),    # sRGB linear light
    ],
    ids=_id,
)
def test_128bpp_rows_match_jax_and_spec(key):
    """The same plans by rows and streamed, against the JAX package's row
    API and numpy_ref."""
    img = _images(key, sum(key), batch=1)[0]
    plan, rp = stt.ScalePlan(*key), smolscale_tpu.ScalePlan(*key)
    got = stt.scale_rows(plan, img, 3, 5, device="cpu")
    assert np.array_equal(got.numpy(), smolscale_tpu.scale_rows(rp, img, 3, 5, backend="jax"))
    assert np.array_equal(got.numpy(), numpy_ref.scale(rp, img)[3:8])
    ours = list(stt.scale_streamed(plan, img, n_chunks=3, device="cpu"))
    theirs = list(smolscale_tpu.scale_streamed(rp, img, n_chunks=3, backend="jax"))
    assert [f for f, _ in ours] == [f for f, _ in theirs]
    assert all(np.array_equal(a.numpy(), np.asarray(b)) for (_, a), (_, b) in zip(ours, theirs))


@pytest.mark.parametrize("key,item", [FORMER_GAPS[0], FORMER_GAPS[2]],
                         ids=lambda v: v if isinstance(v, str) else _id(v))
def test_other_plans_raise_for_rows(key, item):
    """The same plans by rows and streamed, on the kernel that takes them
    whole, against the JAX package's row API and numpy_ref."""
    plan, rp = stt.ScalePlan(*key), smolscale_tpu.ScalePlan(*key)
    assert _kernel_of(plan, torch_ops.ROW_KERNELS) is FORMER_GAP_KERNEL[key]
    img = _images(key, sum(key) + 1, batch=1)[0]
    first, n = plan.height_out // 3, plan.height_out // 2
    got = stt.scale_rows(plan, img, first, n, device="cpu")
    assert np.array_equal(got.numpy(), smolscale_tpu.scale_rows(rp, img, first, n, backend="jax"))
    assert np.array_equal(got.numpy(), numpy_ref.scale(rp, img)[first : first + n])
    ours = list(stt.scale_streamed(plan, img, n_chunks=3, device="cpu"))
    theirs = list(smolscale_tpu.scale_streamed(rp, img, n_chunks=3, backend="jax"))
    assert [f for f, _ in ours] == [f for f, _ in theirs]
    assert all(np.array_equal(a.numpy(), np.asarray(b)) for (_, a), (_, b) in zip(ours, theirs))


@pytest.mark.parametrize(
    "key,first,n",
    [
        ((384, 256, 3, 2, 0, 1, False), 1, 1),       # integer box past 64:1: deep by rows
        ((1024, 1024, 3, 3, 0, 0, False), 1, 2),     # row 9 analogue
        ((572, 572, 2, 2, 0, 0, True), 0, 1),        # row 9c analogue
    ],
    ids=lambda v: _id(v) if isinstance(v, tuple) else str(v),
)
def test_deep_rows_match_jax_and_spec(key, first, n):
    """Box x box plans computed by rows, whole-image box kernel class
    included, against the JAX package's row API and numpy_ref."""
    img = _images(key, sum(key) + first, batch=1)[0]
    got = stt.scale_rows(stt.ScalePlan(*key), img, first, n, device="cpu")
    rp = smolscale_tpu.ScalePlan(*key)
    assert np.array_equal(got.numpy(), smolscale_tpu.scale_rows(rp, img, first, n, backend="jax"))
    assert np.array_equal(got.numpy(), numpy_ref.scale(rp, img)[first : first + n])


SWEEP_SIZES = (1, 2, 5, 16, 100, 300, 1000, 5000)
FORMAT_PAIRS = [(ti, to) for ti in PixelType for to in PixelType]


def _coverage_sample():
    """Every (w_in, h_in, w_out, h_out) over ``SWEEP_SIZES`` with and
    without sRGB, each with one of the 100 (in, out) format pairs, which
    the index walks through so that every pair comes up ~80 times: 8,192
    plans of the 819,200 (the whole grid takes minutes to plan)."""
    for c, dims in enumerate(itertools.product(SWEEP_SIZES, repeat=4)):
        for srgb in (False, True):
            yield (*dims, *FORMAT_PAIRS[(c * 37 + srgb * 53) % 100], srgb)


def test_every_plan_reaches_a_kernel():
    """No plan of the sample misses every kernel, whole or by rows, and
    none that the deep box kernel takes past 64:1 goes to the general
    kernel's serial span loop."""
    n = 0
    for key in _coverage_sample():
        plan = stt.ScalePlan(*key)
        assert any(k.applicable(plan) for k in torch_ops.WHOLE_KERNELS), key
        assert any(k.applicable(plan) for k in torch_ops.ROW_KERNELS), key
        if deep.applicable(plan) and any(
            ax.filter == stt.FilterType.BOX and ax.dim_in > 64 * ax.dim_out
            for ax in (plan.x, plan.y)
        ):
            assert not bilinear.applicable(plan), key
        n += 1
    assert n == len(SWEEP_SIZES) ** 4 * 2


def test_dispatch_keeps_deep_and_box(monkeypatch):
    """Box x box past 64:1 with two or more outputs per axis stays on the
    deep box kernel, integer box stays on the box kernel whole, and the
    general kernel takes the rest of 64bpp by rows and whole."""
    calls = []
    for mod in (box, bilinear, deep, bilinear128):
        name = mod.__name__.rsplit(".", 1)[-1]
        monkeypatch.setattr(mod, "scale_fn", lambda plan, x, name=name: calls.append(name))
        monkeypatch.setattr(mod, "scale_rows_fn",
                            lambda plan, x, f, n, name=name: calls.append(name + " rows"),
                            raising=False)
    img = torch.zeros((8, 8, 4), dtype=torch.uint8)
    for key in [
        (6550, 6500, 100, 50, 0, 0),   # 65.5:1 x 130:1 box x box: deep
        (6550, 640, 100, 10, 0, 0),    # 65.5:1 x 64:1: deep
        (6400, 6400, 100, 100, 0, 0),  # integer 64:1: box whole, general by rows
        (200, 6500, 1, 100, 0, 0),     # 200:1 x 65:1, one output column: general
        (4096, 512, 4096, 4, 0, 0),    # COPY x 128:1 integer box (C3)
    ]:
        plan = stt.ScalePlan(*key)
        stt.scale(plan, img)
        stt.scale_rows(plan, img, 0, 1)
    assert calls == ["deep", "deep rows", "deep", "deep rows", "box", "bilinear rows",
                     "bilinear", "bilinear rows", "box", "bilinear rows"]
