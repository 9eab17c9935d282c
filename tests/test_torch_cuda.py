"""The CUDA kernels (box, the general 64bpp kernel, the deep box kernel, the
128bpp kernel and the pyramid kernel) against their plain PyTorch versions,
and the row and pyramid farm APIs, on the card.

Tests marked ``cuda`` skip without a CUDA device.  This file imports no JAX
(of the JAX package it uses only the numpy-only ``numpy_ref`` and planner),
so it also runs on a machine with a GPU and no JAX, without the JAX-side
conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import smolscale_tpu_torch as stt
from portbench.reference import scale as bench_reference
from portbench.reference.plan import ScalePlan as BenchPlan
from smolscale_tpu.backends import numpy_ref
from smolscale_tpu.plan import ScalePlan as RefPlan
from smolscale_tpu_torch import fuzz
from smolscale_tpu_torch.ops import _build, bilinear, bilinear128, box, deep, pixels, pyramid
from smolscale_tpu_torch.utils import timing

PLANS = [
    (256, 128, 16, 8, 0, 0),
    (512, 512, 4, 4, 2, 3),
    (1280, 640, 128, 64, 4, 0),
    (256, 128, 16, 8, 0, 4),
    (256, 128, 16, 8, 0, 8),   # 4 bytes in, 3 out
    (256, 128, 16, 8, 4, 9),
    (256, 128, 256, 8, 8, 8),
    (256, 128, 16, 128, 9, 5),
    (100, 90, 10, 9, 7, 1),
    (2048, 64, 16, 4, 1, 6),   # 128:1 x 16:1
]

BILINEAR_PLANS = [
    (512, 512, 1024, 1024, 5, 0),  # 0h upscale, unassociated in
    (300, 200, 290, 190, 0, 0),    # 0h, odd sizes
    (700, 500, 123, 77, 2, 3),     # 2h, tails
    (64, 64, 16, 16, 0, 0),        # 1h
    (1000, 512, 100, 64, 0, 0),    # box H x ladder V
    (512, 1000, 512, 100, 0, 1),   # COPY H x box V
    (700, 1, 123, 9, 0, 0),        # ladder H x ONE V
    (1, 700, 9, 123, 4, 0),        # ONE H x ladder V
    (300, 260, 300, 260, 5, 2),    # COPY x COPY
    (512, 256, 96, 56, 0, 4),      # unassociated out
    (1100, 990, 80, 110, 4, 1),    # non-integer box x box
    (640, 640, 64, 64, 0, 0),      # integer box (the box kernel's class too)
    (512, 256, 96, 56, 8, 8),      # RGB24 -> RGB24
    (300, 200, 290, 190, 0, 9),    # RGBA -> BGR24
    (640, 300, 80, 110, 8, 4),     # RGB24 box x box -> unassociated RGBA
    (6500, 100, 100, 50, 0, 0),    # 65:1 box x bilinear
    (25500, 10, 100, 7, 0, 0),     # 255:1 box x bilinear
    (130, 2000, 130, 10, 2, 3),    # COPY x 200:1 box
    (9000, 1, 40, 3, 0, 0),        # 225:1 box x ONE
    (200, 650, 1, 10, 0, 0),       # box x box past 64:1, one output column
    (6500, 60, 100, 30, 8, 4),     # RGB24 past 64:1 -> unassociated RGBA
]


def _smoke():
    """chip_smoke.py as a module, for its check lists (7-tuples, with_srgb
    last)."""
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# chip_smoke.py's other general-kernel plans: the staged X axes' tile edges
# (1, 8 and 16 lanes), boxes past 64:1, the ladders and boxes of the TPU
# kernel's tests; its row ranges and unaligned inputs
BILINEAR_PLANS += [k for k in _smoke().BILINEAR_CHECK_PLANS if k not in BILINEAR_PLANS]
BILINEAR_ROWS = _smoke().BILINEAR_CHECK_ROWS
BILINEAR_UNALIGNED = _smoke().BILINEAR_UNALIGNED
# chip_smoke.py's plans on the direct path's tile edges, its row ranges
# inside row groups, its 3-byte inputs at byte offsets 1-3 and its batches
# past 65,535 output rows (and images), run in every form that fits
DIRECT_PLANS = _smoke().DIRECT_CHECK_PLANS
DIRECT_ROWS = _smoke().DIRECT_CHECK_ROWS
DIRECT_UNALIGNED = [k for k in BILINEAR_UNALIGNED if stt.get_meta(k[4]).n_bytes == 3
                    and not bilinear.stage_table(stt.ScalePlan(*k).x, 3)[0]]
BILINEAR_TALL = _smoke().BILINEAR_TALL
DEEP_PLANS = _smoke().DEEP_CHECK_PLANS
# chip_smoke.py's deep box kernel inputs at byte offsets 1-4 and 8, and its
# batch of more than 65535 images
DEEP_UNALIGNED = _smoke().DEEP_UNALIGNED
DEEP_OFFSETS = _smoke().DEEP_OFFSETS
DEEP_TALL = _smoke().DEEP_TALL
WIDE_PLANS = _smoke().WIDE_CHECK_PLANS
WIDE_ROWS = _smoke().WIDE_CHECK_ROWS
WIDE_UNALIGNED = _smoke().WIDE_UNALIGNED
WIDE_TALL = _smoke().WIDE_TALL
WIDE_CONST24 = _smoke().WIDE_CONST24_PLANS
PYRAMID_SETS = _smoke().PYRAMID_CHECK_SETS
# chip_smoke.py's box-kernel plans: the tile edges of ops/box.launch_shape,
# 255:1 axes, spans that are not a multiple of 16 bytes, deep ratios on split
# warps; unaligned inputs, batches past 65535 output rows, constant 255
BOX_PLANS = [k for k in _smoke().CHECK_PLANS if k not in PLANS]
BOX_UNALIGNED = _smoke().BOX_UNALIGNED
BOX_OFFSETS = _smoke().BOX_OFFSETS
BOX_TALL = _smoke().BOX_TALL
BOX_CONST_PLANS = _smoke().BOX_CONST_PLANS


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _id(key):
    return "-".join(map(str, key))


@pytest.mark.cuda
@pytest.mark.parametrize("key", PLANS, ids=_id)
def test_kernel_matches_plain(cuda_device, key):
    plan = stt.ScalePlan(*key)
    rng = np.random.default_rng(sum(key))
    imgs = rng.integers(0, 256, (3, key[1], key[0], plan.meta_in.n_bytes), dtype=np.uint8)
    x = torch.from_numpy(imgs).to(cuda_device)
    before = box.launches
    got = box.scale_fn(plan, x)
    assert box.launches == before + 1
    plain = box.box_scale_ref(plan, x)
    torch.cuda.synchronize()
    assert got.device == cuda_device and torch.equal(got, plain)
    assert np.array_equal(got[2].cpu().numpy(), numpy_ref.scale(RefPlan(*key), imgs[2]))


@pytest.mark.cuda
def test_kernel_input_layouts(cuda_device):
    plan = stt.ScalePlan(256, 128, 16, 8, 0, 0)
    x = torch.randint(0, 256, (2, 128, 256, 4), dtype=torch.uint8, device=cuda_device)
    want = box.box_scale_ref(plan, x)
    # unaligned 4-byte pixels take the kernel's staged form
    flat = torch.empty(x.numel() + 1, dtype=torch.uint8, device=cuda_device)
    shifted = flat[1:].view(x.shape)
    shifted.copy_(x)
    assert torch.equal(box.scale_fn(plan, shifted), want)
    # the kernel takes contiguous input only; the public API makes it so
    strided = torch.empty((2, 128, 512, 4), dtype=torch.uint8, device=cuda_device)[:, :, ::2]
    strided.copy_(x)
    with pytest.raises(ValueError, match="contiguous"):
        box.scale_fn(plan, strided)
    assert torch.equal(stt.scale(plan, strided), want)
    # a single image keeps its shape
    assert torch.equal(stt.scale(plan, x[1]), want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("key", BOX_PLANS, ids=_id)
def test_box_kernel_edges(cuda_device, key):
    plan = stt.ScalePlan(*key)
    rng = np.random.default_rng(sum(key))
    x = torch.from_numpy(rng.integers(0, 256, (2, key[1], key[0], plan.meta_in.n_bytes),
                                      dtype=np.uint8)).to(cuda_device)
    got = box.scale_fn(plan, x)
    torch.cuda.synchronize()
    assert torch.equal(got, box.box_scale_ref(plan, x))


@pytest.mark.cuda
@pytest.mark.parametrize("key", BOX_UNALIGNED, ids=_id)
@pytest.mark.parametrize("offset", BOX_OFFSETS)
def test_box_unaligned_input(cuda_device, key, offset):
    plan = stt.ScalePlan(*key)
    rng = np.random.default_rng(offset)
    x = torch.from_numpy(rng.integers(0, 256, (2, key[1], key[0], plan.meta_in.n_bytes),
                                      dtype=np.uint8)).to(cuda_device)
    flat = torch.empty(x.numel() + offset, dtype=torch.uint8, device=cuda_device)
    shifted = flat[offset:].view(x.shape)
    shifted.copy_(x)
    assert box.form(plan, shifted.data_ptr()) == box.STAGED
    assert torch.equal(box.scale_fn(plan, shifted), box.box_scale_ref(plan, x))


@pytest.mark.cuda
@pytest.mark.parametrize("key,batch", BOX_TALL, ids=lambda v: _id(v) if isinstance(v, tuple) else str(v))
def test_box_tall_batch(cuda_device, key, batch):
    plan = stt.ScalePlan(*key)
    assert batch * plan.height_out > 65535
    x = torch.randint(0, 256, (batch, key[1], key[0], 4), dtype=torch.uint8, device=cuda_device)
    assert torch.equal(box.scale_fn(plan, x), box.box_scale_ref(plan, x))


@pytest.mark.cuda
@pytest.mark.parametrize("key", BOX_CONST_PLANS, ids=_id)
def test_box_constant_255(cuda_device, key):
    plan = stt.ScalePlan(*key)
    x = torch.full((2, key[1], key[0], plan.meta_in.n_bytes), 255, dtype=torch.uint8,
                   device=cuda_device)
    got = box.scale_fn(plan, x)
    assert torch.equal(got, box.box_scale_ref(plan, x))
    assert np.array_equal(got[0].cpu().numpy(), numpy_ref.scale(RefPlan(*key), x[0].cpu().numpy()))


@pytest.mark.cuda
@pytest.mark.parametrize("key", BILINEAR_PLANS, ids=_id)
def test_bilinear_kernel_matches_plain(cuda_device, key):
    plan = stt.ScalePlan(*key)
    rng = np.random.default_rng(sum(key))
    imgs = rng.integers(0, 256, (3, key[1], key[0], plan.meta_in.n_bytes), dtype=np.uint8)
    x = torch.from_numpy(imgs).to(cuda_device)
    before = bilinear.launches
    got = bilinear.scale_fn(plan, x)
    assert bilinear.launches == before + 1
    plain = bilinear.bilinear_scale_ref(plan, x)
    torch.cuda.synchronize()
    assert got.device == cuda_device and torch.equal(got, plain)
    assert np.array_equal(got[2].cpu().numpy(), numpy_ref.scale(RefPlan(*key), imgs[2]))
    # row ranges: a middle one, the last row
    h = plan.height_out
    for first, n in ((h // 3, max(1, h // 2)), (h - 1, 1)):
        rows = bilinear.scale_rows_fn(plan, x, first, n)
        assert torch.equal(rows, plain[:, first : first + n])


@pytest.mark.cuda
@pytest.mark.parametrize("key,first,n", BILINEAR_ROWS,
                         ids=lambda v: _id(v) if isinstance(v, tuple) else str(v))
def test_bilinear_rows_match_plain(cuda_device, key, first, n):
    plan = stt.ScalePlan(*key)
    x = torch.randint(0, 256, (2, key[1], key[0], plan.meta_in.n_bytes), dtype=torch.uint8,
                      device=cuda_device)
    assert torch.equal(bilinear.scale_rows_fn(plan, x, first, n),
                       bilinear.bilinear_scale_ref(plan, x, first, n))


@pytest.mark.cuda
@pytest.mark.parametrize("key", BILINEAR_UNALIGNED, ids=_id)
@pytest.mark.parametrize("offset", [1, 2, 3])
def test_bilinear_unaligned_input(cuda_device, key, offset):
    """Inputs at byte offsets 1-3: stretches with ragged ends, pixels read
    across shared words; whole and by rows."""
    plan = stt.ScalePlan(*key)
    x = torch.randint(0, 256, (2, key[1], key[0], plan.meta_in.n_bytes), dtype=torch.uint8,
                      device=cuda_device)
    want = bilinear.bilinear_scale_ref(plan, x)
    flat = torch.empty(x.numel() + offset, dtype=torch.uint8, device=cuda_device)
    shifted = flat[offset:].view(x.shape)
    shifted.copy_(x)
    assert torch.equal(bilinear.scale_fn(plan, shifted), want)
    h = plan.height_out
    assert torch.equal(bilinear.scale_rows_fn(plan, shifted, h // 2, h - h // 2),
                       want[:, h // 2 :])


def _forms(plan):
    return bilinear.direct_forms(plan)


@pytest.mark.cuda
@pytest.mark.parametrize("key", DIRECT_PLANS, ids=_id)
def test_direct_forms_match_plain(cuda_device, key):
    """Each form of the direct path that fits, whole and on a row range that
    starts inside a row group, against the plain version; the routed form is
    the one ``scale_fn`` takes."""
    plan = stt.ScalePlan(*key)
    x = torch.randint(0, 256, (3, key[1], key[0], plan.meta_in.n_bytes), dtype=torch.uint8,
                      device=cuda_device)
    want = bilinear.bilinear_scale_ref(plan, x)
    h = plan.height_out
    first, n = min(5, h - 1), max(1, h - min(5, h - 1) - 1)
    assert torch.equal(bilinear.scale_fn(plan, x), want)
    for form in _forms(plan):
        before, by_form = bilinear.launches, bilinear.form_launches[form]
        assert torch.equal(bilinear.scale_fn(plan, x, form), want), bilinear.FORMS[form]
        assert torch.equal(bilinear.scale_rows_fn(plan, x, first, n, form),
                           want[:, first : first + n]), bilinear.FORMS[form]
        assert bilinear.launches == before + 2
        assert bilinear.form_launches[form] == by_form + 2


# the direct path's plans in ROLL's class: its edges (f just above 1 and 2,
# w_out not a multiple of 4, 2-row input, one output column, 3-byte pixels,
# unassociated in and out, downscales by a pixel and to just above 0.5x)
# among them, in batches of 3; and fleet-5b's 384^2 -> 256^2 level on one of
# the farm's sub-batches (341 images: several blocks of strips down each)
ROLL_CASES = ([(k, 3) for k in DIRECT_PLANS if bilinear.rolls(stt.ScalePlan(*k))]
              + [((384, 384, 256, 256, 0, 0), 341)])


@pytest.mark.cuda
@pytest.mark.parametrize("key,batch", ROLL_CASES, ids=lambda v: _id(v) if isinstance(v, tuple)
                         else str(v))
def test_roll_matches_plain_on_its_edges(cuda_device, key, batch):
    """ROLL, routed, against the plain version on outputs poisoned first
    (as the fuzz does): whole, from a row in the middle of the whole
    image's first strip, and on ranges that end at the last row, one of
    them a single strip."""
    plan = stt.ScalePlan(*key)
    assert bilinear.direct_form(plan) == bilinear.ROLL
    x = torch.randint(0, 256, (batch, key[1], key[0], plan.meta_in.n_bytes), dtype=torch.uint8,
                      device=cuda_device)
    want = bilinear.bilinear_scale_ref(plan, x)
    h = plan.height_out
    strip = bilinear.roll_shape(plan.width_out, 0, h, batch)[2]
    ranges = [(0, h), (strip // 2, h - strip // 2), (h // 3, h - h // 3), (h - 1, 1)]
    for first, n in ranges:
        shape = (batch, n, plan.width_out, plan.meta_out.n_bytes)
        addr = fuzz.poison([shape], cuda_device)
        before = bilinear.form_launches[bilinear.ROLL]
        got = bilinear.scale_rows_fn(plan, x, first, n)
        assert got.data_ptr() in addr and got.shape == shape
        assert torch.equal(got, want[:, first : first + n]), (first, n)
        assert bilinear.form_launches[bilinear.ROLL] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("key,first,n", DIRECT_ROWS,
                         ids=lambda v: _id(v) if isinstance(v, tuple) else str(v))
def test_direct_rows_match_plain(cuda_device, key, first, n):
    plan = stt.ScalePlan(*key)
    x = torch.randint(0, 256, (2, key[1], key[0], plan.meta_in.n_bytes), dtype=torch.uint8,
                      device=cuda_device)
    want = bilinear.bilinear_scale_ref(plan, x, first, n)
    for form in _forms(plan):
        assert torch.equal(bilinear.scale_rows_fn(plan, x, first, n, form), want)


@pytest.mark.cuda
@pytest.mark.parametrize("key", DIRECT_UNALIGNED, ids=_id)
@pytest.mark.parametrize("offset", [1, 2, 3])
def test_direct_unaligned_3_byte_input(cuda_device, key, offset):
    """3-byte rows at byte offsets 1-3 in every form, whole and by rows."""
    plan = stt.ScalePlan(*key)
    x = torch.randint(0, 256, (2, key[1], key[0], 3), dtype=torch.uint8, device=cuda_device)
    want = bilinear.bilinear_scale_ref(plan, x)
    flat = torch.empty(x.numel() + offset, dtype=torch.uint8, device=cuda_device)
    shifted = flat[offset:].view(x.shape)
    shifted.copy_(x)
    h = plan.height_out
    for form in _forms(plan):
        assert torch.equal(bilinear.scale_fn(plan, shifted, form), want)
        assert torch.equal(bilinear.scale_rows_fn(plan, shifted, h // 3, h - 1 - h // 3, form),
                           want[:, h // 3 : h - 1])


@pytest.mark.cuda
@pytest.mark.parametrize("key,batch", BILINEAR_TALL,
                         ids=lambda v: _id(v) if isinstance(v, tuple) else str(v))
def test_direct_tall_batch(cuda_device, key, batch):
    """More than 65,535 output rows in the batch (grid z at the batch), and
    more than 65,535 images (grid z loops), in every form."""
    plan = stt.ScalePlan(*key)
    assert batch * plan.height_out > 65535
    few = torch.randint(0, 256, (7, key[1], key[0], plan.meta_in.n_bytes), dtype=torch.uint8,
                        device=cuda_device)
    reps = -(-batch // 7)
    x = few.repeat(reps, 1, 1, 1)[:batch]
    want = bilinear.bilinear_scale_ref(plan, few).repeat(reps, 1, 1, 1)[:batch]
    for form in _forms(plan):
        assert torch.equal(bilinear.scale_fn(plan, x, form), want)


@pytest.mark.cuda
def test_bilinear_row_api(cuda_device):
    plan = stt.ScalePlan(512, 512, 1024, 1024, 5, 0)
    x = torch.randint(0, 256, (2, 512, 512, 4), dtype=torch.uint8, device=cuda_device)
    want = bilinear.bilinear_scale_ref(plan, x)
    before = bilinear.launches
    chunks = list(stt.scale_streamed(plan, x, n_chunks=16))
    assert bilinear.launches == before + 16
    assert [f for f, _ in chunks] == list(range(0, 1024, 64))
    assert torch.equal(torch.cat([r for _, r in chunks], dim=1), want)
    out = torch.empty((2, 5, 1024, 4), dtype=torch.uint8, device=cuda_device)
    assert stt.scale_rows(plan, x, 7, 5, out=out) is out
    assert torch.equal(out, want[:, 7:12])
    # unaligned 4-byte pixels take the byte-load path
    flat = torch.empty(x.numel() + 1, dtype=torch.uint8, device=cuda_device)
    shifted = flat[1:].view(x.shape)
    shifted.copy_(x)
    assert torch.equal(stt.scale(plan, shifted), want)
    with pytest.raises(ValueError, match="contiguous"):
        bilinear.scale_fn(plan, x[:, :, ::1].transpose(1, 2))
    with pytest.raises(ValueError, match="row range"):
        bilinear.scale_rows_fn(plan, x, 1020, 5)


@pytest.mark.cuda
def test_rows_past_64_on_bilinear(cuda_device):
    """COPY x a 128:1 integer box: whole images take the box kernel, row
    ranges and streamed chunks the general kernel, with the same bytes."""
    plan = stt.ScalePlan(4096, 512, 4096, 4, 0, 0)
    x = torch.randint(0, 256, (2, 512, 4096, 4), dtype=torch.uint8, device=cuda_device)
    want = bilinear.bilinear_scale_ref(plan, x)
    boxes, rows = box.launches, bilinear.launches
    assert torch.equal(stt.scale(plan, x), want)
    assert torch.equal(stt.scale_rows(plan, x, 1, 2), want[:, 1:3])
    chunks = list(stt.scale_streamed(plan, x, n_chunks=4))
    assert (box.launches, bilinear.launches) == (boxes + 1, rows + 5)
    assert torch.equal(torch.cat([r for _, r in chunks], dim=1), want)


@pytest.mark.cuda
@pytest.mark.parametrize("key", DEEP_PLANS, ids=_id)
def test_deep_kernel_matches_plain(cuda_device, key):
    plan = stt.ScalePlan(*key)
    rng = np.random.default_rng(sum(key))
    imgs = rng.integers(0, 256, (2, key[1], key[0], plan.meta_in.n_bytes), dtype=np.uint8)
    x = torch.from_numpy(imgs).to(cuda_device)
    before = deep.launches
    got = deep.scale_fn(plan, x)
    assert deep.launches == before + 1
    plain = deep.deep_scale_ref(plan, x)
    torch.cuda.synchronize()
    assert got.device == cuda_device and torch.equal(got, plain)
    assert np.array_equal(got[1].cpu().numpy(), numpy_ref.scale(RefPlan(*key), imgs[1]))
    # row ranges: a middle one, the last row
    h = plan.height_out
    for first, n in ((h // 3, max(1, h // 2)), (h - 1, 1)):
        assert torch.equal(deep.scale_rows_fn(plan, x, first, n), plain[:, first : first + n])


@pytest.mark.cuda
def test_deep_row_api(cuda_device):
    plan = stt.ScalePlan(4096, 4096, 12, 12, 0, 0)
    x = torch.randint(0, 256, (2, 4096, 4096, 4), dtype=torch.uint8, device=cuda_device)
    want = deep.deep_scale_ref(plan, x)
    before = deep.launches
    assert torch.equal(stt.scale(plan, x), want)
    chunks = list(stt.scale_streamed(plan, x, n_chunks=4))
    assert deep.launches == before + 5
    assert [f for f, _ in chunks] == [0, 3, 6, 9]
    assert torch.equal(torch.cat([r for _, r in chunks], dim=1), want)
    # unaligned 4-byte pixels take the byte-load path
    flat = torch.empty(x.numel() + 1, dtype=torch.uint8, device=cuda_device)
    shifted = flat[1:].view(x.shape)
    shifted.copy_(x)
    assert torch.equal(stt.scale_rows(plan, shifted, 5, 2), want[:, 5:7])
    with pytest.raises(ValueError, match="contiguous"):
        deep.scale_fn(plan, x.transpose(1, 2))


@pytest.mark.cuda
@pytest.mark.parametrize("key", DEEP_UNALIGNED, ids=_id)
@pytest.mark.parametrize("offset", DEEP_OFFSETS)
def test_deep_unaligned_input(cuda_device, key, offset):
    plan = stt.ScalePlan(*key)
    rng = np.random.default_rng(offset)
    x = torch.from_numpy(rng.integers(0, 256, (2, key[1], key[0], plan.meta_in.n_bytes),
                                      dtype=np.uint8)).to(cuda_device)
    flat = torch.empty(x.numel() + offset, dtype=torch.uint8, device=cuda_device)
    shifted = flat[offset:].view(x.shape)
    shifted.copy_(x)
    want = deep.deep_scale_ref(plan, x)
    assert torch.equal(deep.scale_fn(plan, shifted), want)
    h = plan.height_out
    assert torch.equal(deep.scale_rows_fn(plan, shifted, h // 3, h - 1 - h // 3),
                       want[:, h // 3 : h - 1])


@pytest.mark.cuda
def test_deep_tall_batch(cuda_device):
    key, batch = DEEP_TALL
    plan = stt.ScalePlan(*key)
    few = torch.randint(0, 256, (7, key[1], key[0], plan.meta_in.n_bytes), dtype=torch.uint8,
                        device=cuda_device)
    reps = -(-batch // 7)
    got = deep.scale_fn(plan, few.repeat(reps, 1, 1, 1)[:batch])
    assert batch > 65535 and got.shape[0] == batch
    assert torch.equal(got, deep.deep_scale_ref(plan, few).repeat(reps, 1, 1, 1)[:batch])


@pytest.mark.cuda
def test_box_past_64_goes_to_deep(cuda_device):
    """Box x box past 64:1 is in the box kernel's class; the public entry
    point gives it to the deep box kernel, with the box kernel's bytes."""
    plan = stt.ScalePlan(4096, 1024, 32, 8, 0, 0)
    x = torch.randint(0, 256, (2, 1024, 4096, 4), dtype=torch.uint8, device=cuda_device)
    boxes, deeps = box.launches, deep.launches
    got = stt.scale(plan, x)
    assert (box.launches, deep.launches) == (boxes, deeps + 1)
    assert torch.equal(got, box.scale_fn(plan, x))


@pytest.mark.cuda
@pytest.mark.parametrize("key", [(4096, 1024, 32, 8, 0, 0), (2000, 2000, 7, 7, 0, 0, True)],
                         ids=_id)
def test_deep_on_every_card(cuda_device, key):
    """Blocks of eight split warps need more than 48 KB of shared memory, an
    opt-in that CUDA keeps per device: the same kernel instance, launched
    first on card 0 and then on each other card, gives the plain version's
    bytes on every one."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    plan = stt.ScalePlan(*key)
    assert deep.launch_shape(plan, 2)["splits"] == 8
    x = torch.randint(0, 256, (2, key[1], key[0], 4), dtype=torch.uint8, device=cuda_device)
    want = deep.deep_scale_ref(plan, x).cpu()
    for k in range(torch.cuda.device_count()):
        xk = x.to(torch.device("cuda", k))
        got = deep.scale_fn(plan, xk)
        assert got.device == xk.device and torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("key", WIDE_PLANS, ids=_id)
def test_bilinear128_kernel_matches_plain(cuda_device, key):
    plan = stt.ScalePlan(*key)
    rng = np.random.default_rng(sum(key))
    imgs = rng.integers(0, 256, (2, key[1], key[0], plan.meta_in.n_bytes), dtype=np.uint8)
    x = torch.from_numpy(imgs).to(cuda_device)
    before, routed = bilinear128.launches, bilinear128.form_launches[bilinear128.form(plan)]
    got = bilinear128.scale_fn(plan, x)
    assert bilinear128.launches == before + 1
    assert bilinear128.form_launches[bilinear128.form(plan)] == routed + 1
    plain = bilinear128.bilinear128_scale_ref(plan, x)
    torch.cuda.synchronize()
    assert got.device == cuda_device and torch.equal(got, plain)
    assert np.array_equal(got[1].cpu().numpy(), numpy_ref.scale(RefPlan(*key), imgs[1]))
    # every form that fits (H TILE beside LOOP for 3-byte input, ROLL beside
    # LOOP in its class), whole and on row ranges: a middle one, the last row
    h = plan.height_out
    for form in bilinear128.forms(plan):
        by_form = bilinear128.form_launches[form]
        assert torch.equal(bilinear128.scale_fn(plan, x, form), plain), bilinear128.FORMS[form]
        for first, n in ((h // 3, max(1, h // 2)), (h - 1, 1)):
            assert torch.equal(bilinear128.scale_rows_fn(plan, x, first, n, form),
                               plain[:, first : first + n]), bilinear128.FORMS[form]
        assert bilinear128.form_launches[form] == by_form + 3, bilinear128.FORMS[form]


@pytest.mark.cuda
@pytest.mark.parametrize("key,first,n", WIDE_ROWS,
                         ids=lambda v: _id(v) if isinstance(v, tuple) else str(v))
def test_bilinear128_rows_match_plain(cuda_device, key, first, n):
    plan = stt.ScalePlan(*key)
    x = torch.randint(0, 256, (2, key[1], key[0], plan.meta_in.n_bytes), dtype=torch.uint8,
                      device=cuda_device)
    want = bilinear128.bilinear128_scale_ref(plan, x, first, n)
    for form in bilinear128.forms(plan):
        assert torch.equal(bilinear128.scale_rows_fn(plan, x, first, n, form), want)


@pytest.mark.cuda
@pytest.mark.parametrize("key", WIDE_UNALIGNED, ids=_id)
@pytest.mark.parametrize("offset", [1, 2, 3])
def test_bilinear128_unaligned_input(cuda_device, key, offset):
    """Inputs at byte offsets 1-3 take the byte-load paths (3-byte input in
    every form); whole and by rows."""
    plan = stt.ScalePlan(*key)
    x = torch.randint(0, 256, (2, key[1], key[0], plan.meta_in.n_bytes), dtype=torch.uint8,
                      device=cuda_device)
    want = bilinear128.bilinear128_scale_ref(plan, x)
    flat = torch.empty(x.numel() + offset, dtype=torch.uint8, device=cuda_device)
    shifted = flat[offset:].view(x.shape)
    shifted.copy_(x)
    assert torch.equal(bilinear128.scale_fn(plan, shifted), want)
    h = plan.height_out
    for form in bilinear128.forms(plan):
        assert torch.equal(bilinear128.scale_fn(plan, shifted, form), want)
        assert torch.equal(bilinear128.scale_rows_fn(plan, shifted, h // 2, h - h // 2, form),
                           want[:, h // 2 :])


@pytest.mark.cuda
@pytest.mark.parametrize("key", WIDE_CONST24, ids=_id)
def test_bilinear128_constant_255_3_byte(cuda_device, key):
    """A constant-255 3-byte image in every form: box sums of the largest
    unpacked values, cut to 16 bits in the h tile's cells as in LOOP."""
    plan = stt.ScalePlan(*key)
    x = torch.full((2, key[1], key[0], 3), 255, dtype=torch.uint8, device=cuda_device)
    want = bilinear128.bilinear128_scale_ref(plan, x)
    assert np.array_equal(want[0].cpu().numpy(),
                          numpy_ref.scale(RefPlan(*key), x[0].cpu().numpy()))
    assert bilinear128.H_TILE in bilinear128.forms(plan)
    for form in bilinear128.forms(plan):
        assert torch.equal(bilinear128.scale_fn(plan, x, form), want), bilinear128.FORMS[form]


# frames-2160p-srgb (the sweep2160-srgb-b32 cell) at its published widths:
# 2.0x (0h up) and 0.597x (0h down) on the 128bpp kernel's ROLL, a 2h ladder
# on its LOOP, 0.06x (box x box) on the deep box kernel, all in P8-linear
SRGB_SWEEP = [((3840, 2160, 7680, 4320, 0, 0, True), "bilinear128"),
              ((3840, 2160, 2292, 1289, 0, 0, True), "bilinear128"),
              ((3840, 2160, 496, 279, 0, 0, True), "bilinear128"),
              ((3840, 2160, 229, 129, 0, 0, True), "deep")]


@pytest.mark.cuda
@pytest.mark.parametrize("key,kernel", SRGB_SWEEP,
                         ids=lambda v: _id(v) if isinstance(v, tuple) else v)
def test_srgb_sweep_matches_benchmark_reference(cuda_device, key, kernel):
    """A batch of 2 through ``scale``, byte for byte against the
    benchmark's plain reference; one launch on the routed wrapper, in
    P8-linear (on the 128bpp kernel: ROLL for the 0h plans, LOOP for the
    ladder), and none on another."""
    mods = {"bilinear": bilinear, "box": box, "deep": deep, "bilinear128": bilinear128}
    plan = stt.ScalePlan(*key)
    assert deep.mode(plan) == deep.P8_LINEAR
    gen = torch.Generator().manual_seed(sum(key[:4]))
    x = torch.randint(0, 256, (2, key[1], key[0], 4), dtype=torch.uint8,
                      generator=gen).to(cuda_device)
    launches = {k: m.launches for k, m in mods.items()}
    forms = dict(bilinear128.form_launches)
    got = stt.scale(plan, x)
    torch.cuda.synchronize()
    assert {k: m.launches - launches[k] for k, m in mods.items()} == {
        k: int(k == kernel) for k in mods}
    routed = bilinear128.form(plan) if kernel == "bilinear128" else None
    assert routed == {7680: bilinear128.ROLL, 2292: bilinear128.ROLL,
                      496: bilinear128.LOOP}.get(key[2])
    assert {f: n - forms[f] for f, n in bilinear128.form_launches.items()} == {
        f: int(f == routed) for f in bilinear128.FORMS}
    for b in range(2):
        assert torch.equal(got[b], bench_reference.scale(BenchPlan(*key), x[b]))


# every 4-byte pixel-type pair that plans at P8-linear (a premultiplied side)
ROLL_LINEAR_PAIRS = [(i, o) for i in range(8) for o in range(8) if i < 4 or o < 4]


@pytest.mark.cuda
@pytest.mark.parametrize("pair", ROLL_LINEAR_PAIRS, ids=_id)
def test_roll_linear_matches_plain_and_loop(cuda_device, pair):
    """ROLL in P8-linear on a 0h upscale and a 0h downscale of each pair,
    pixels of alpha 0, 1 and 255 among random ones: byte for byte the plain
    version and LOOP, whole and on a row range that starts and ends inside
    strips; one ROLL launch a call."""
    for key in ((150, 100, 301, 211, *pair, True), (300, 200, 151, 100, *pair, True)):
        plan = stt.ScalePlan(*key)
        assert deep.mode(plan) == deep.P8_LINEAR and bilinear128.form(plan) == bilinear128.ROLL
        gen = torch.Generator().manual_seed(sum(key[:6]))
        x = torch.randint(0, 256, (2, key[1], key[0], 4), dtype=torch.uint8, generator=gen)
        pick = torch.randint(0, 4, x.shape[:3], generator=gen)
        a_ch = pixels.alpha_channel(plan)
        x[..., a_ch] = torch.where(pick == 3, x[..., a_ch],
                                   torch.tensor([0, 1, 255], dtype=torch.uint8)[pick % 3])
        x = x.to(cuda_device)
        want = bilinear128.bilinear128_scale_ref(plan, x)
        before = bilinear128.form_launches[bilinear128.ROLL]
        got = bilinear128.scale_fn(plan, x)
        assert bilinear128.form_launches[bilinear128.ROLL] == before + 1
        assert torch.equal(got, want), key
        assert torch.equal(bilinear128.scale_fn(plan, x, bilinear128.LOOP), want), key
        assert torch.equal(bilinear128.scale_rows_fn(plan, x, 37, 50), want[:, 37:87]), key


@pytest.mark.cuda
def test_bilinear128_tall_batch(cuda_device):
    """More than 65535 output rows in the batch (gridDim.y and gridDim.z
    stop there)."""
    key, batch = WIDE_TALL
    plan = stt.ScalePlan(*key)
    x = torch.randint(0, 256, (batch, key[1], key[0], 4), dtype=torch.uint8, device=cuda_device)
    assert torch.equal(bilinear128.scale_fn(plan, x), bilinear128.bilinear128_scale_ref(plan, x))


@pytest.mark.cuda
def test_bilinear128_row_api(cuda_device):
    plan = stt.ScalePlan(2048, 2048, 256, 256, 4, 4, True)   # row 6
    x = torch.randint(0, 256, (2, 2048, 2048, 4), dtype=torch.uint8, device=cuda_device)
    want = bilinear128.bilinear128_scale_ref(plan, x)
    before = bilinear128.launches
    assert torch.equal(stt.scale(plan, x), want)
    chunks = list(stt.scale_streamed(plan, x, n_chunks=4))
    assert bilinear128.launches == before + 5
    assert [f for f, _ in chunks] == [0, 64, 128, 192]
    assert torch.equal(torch.cat([r for _, r in chunks], dim=1), want)
    # unaligned 4-byte pixels take the byte-load path
    flat = torch.empty(x.numel() + 1, dtype=torch.uint8, device=cuda_device)
    shifted = flat[1:].view(x.shape)
    shifted.copy_(x)
    assert torch.equal(stt.scale_rows(plan, shifted, 5, 2), want[:, 5:7])
    with pytest.raises(ValueError, match="contiguous"):
        bilinear128.scale_fn(plan, x.transpose(1, 2))


@pytest.mark.cuda
def test_bilinear128_3_byte_row_api(cuda_device):
    """Row 6b at its size (H TILE routed): whole and in 4 chunks through the
    public row API, each chunk's row groups counted from output row 0."""
    plan = stt.ScalePlan(1920, 1080, 400, 225, 8, 8, True)
    assert bilinear128.form(plan) == bilinear128.H_TILE
    x = torch.randint(0, 256, (2, 1080, 1920, 3), dtype=torch.uint8, device=cuda_device)
    want = bilinear128.bilinear128_scale_ref(plan, x)
    before = bilinear128.launches
    assert torch.equal(stt.scale(plan, x), want)
    chunks = list(stt.scale_streamed(plan, x, n_chunks=4))
    assert bilinear128.launches == before + 5
    assert torch.equal(torch.cat([r for _, r in chunks], dim=1), want)
    assert torch.equal(stt.scale_rows(plan, x, 61, 3), want[:, 61:64])


def _pyramid_id(case):
    w, h, outs, ti, to = case
    return f"{w}x{h}-" + "-".join(f"{wo}x{ho}" for wo, ho in outs) + f"-{ti}-{to}"


@pytest.mark.cuda
@pytest.mark.parametrize("case", PYRAMID_SETS, ids=_pyramid_id)
def test_pyramid_kernel_matches_plain(cuda_device, case):
    w, h, outs, ti, to = case
    plans = tuple(stt.ScalePlan(w, h, wo, ho, ti, to) for wo, ho in outs)
    nb = plans[0].meta_in.n_bytes
    rng = np.random.default_rng(w + h + ti + to)
    imgs = rng.integers(0, 256, (3, h, w, nb), dtype=np.uint8)
    x = torch.from_numpy(imgs).to(cuda_device)
    before = pyramid.launches
    got = pyramid.pyramid_fn(plans, x)
    assert pyramid.launches == before + 1
    plain = pyramid.pyramid_scale_ref(plans, x)
    torch.cuda.synchronize()
    for p, g, want in zip(plans, got, plain):
        assert g.device == cuda_device and torch.equal(g, want), p.key
    rp = RefPlan(*plans[-1].key)
    assert np.array_equal(got[-1][2].cpu().numpy(), numpy_ref.scale(rp, imgs[2]))
    # byte offsets 1 and 4 take the byte-load and word-load paths; one image
    # keeps its shape
    for offset in (1, 4):
        flat = torch.empty(x.numel() + offset, dtype=torch.uint8, device=cuda_device)
        shifted = flat[offset:].view(x.shape)
        shifted.copy_(x)
        for g, want in zip(pyramid.pyramid_fn(plans, shifted), plain):
            assert torch.equal(g, want)
    for g, want in zip(pyramid.pyramid_fn(plans, x[1]), plain):
        assert torch.equal(g, want[1])
    with pytest.raises(ValueError, match="contiguous"):
        pyramid.pyramid_fn(plans, x.transpose(1, 2).contiguous().transpose(1, 2))


@pytest.mark.cuda
def test_pyramid_farm_on_card(cuda_device):
    """make_pyramid_fn runs a numpy batch on the card by default; a small
    mixed fleet (the row 5b groups, padded sub-batches) gives the CPU's
    bytes."""
    rng = np.random.default_rng(5)
    imgs = rng.integers(0, 256, (3, 512, 512, 4), dtype=np.uint8)
    before = pyramid.launches
    got = stt.make_pyramid_fn(512, 512, 0)(imgs)
    assert pyramid.launches == before + 1
    want = stt.make_pyramid_fn(512, 512, 0, device="cpu")(imgs)
    for g, w in zip(got, want):
        assert g.device.type == "cuda" and np.array_equal(g.cpu().numpy(), w.numpy())
    images, types = [], []
    for (h, w), pt in [((512, 512), 0), ((512, 512), 4), ((512, 512), 1), ((512, 512), 8),
                       ((384, 384), 0)]:
        nb = 3 if pt >= 8 else 4
        images += [rng.integers(0, 256, (h, w, nb), dtype=np.uint8) for _ in range(3)]
        types += [pt] * 3
    cap = 2 * 512 * 512 * 4
    got = stt.scale_pyramid_mixed(images, types, sizes=(64, 128, 256), max_batch_bytes=cap)
    want = stt.scale_pyramid_mixed(images, types, sizes=(64, 128, 256), max_batch_bytes=cap,
                                   device="cpu")
    for g, w in zip(got, want):
        assert all(np.array_equal(a, b) for a, b in zip(g, w))


@pytest.mark.cuda
def test_pyramid_fn_takes_strided_batch(cuda_device):
    """A transposed view of a CUDA batch through make_pyramid_fn: one
    pyramid launch, the levels of the contiguous batch."""
    x = torch.randint(0, 256, (3, 512, 512, 4), dtype=torch.uint8, device=cuda_device)
    strided = x.transpose(1, 2).contiguous().transpose(1, 2)
    fn = stt.make_pyramid_fn(512, 512, 0)
    want = fn(x)
    before = pyramid.launches
    got = fn(strided)
    assert pyramid.launches == before + 1
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.cuda
def test_pyramid_mixed_type_out_and_srgb(cuda_device):
    """scale_pyramid_mixed forwards pixel_type_out and with_srgb: the card
    gives the CPU's bytes, in linear light as in compressed gamma."""
    rng = np.random.default_rng(6)
    images = [rng.integers(0, 256, (256, 256, 4), dtype=np.uint8) for _ in range(3)]
    images.append(rng.integers(0, 256, (128, 192, 3), dtype=np.uint8))
    types = [0, 0, 4, 8]
    for srgb in (False, True):
        kw = dict(sizes=(32, 64), pixel_type_out=1, with_srgb=srgb)
        got = stt.scale_pyramid_mixed(images, types, **kw)
        want = stt.scale_pyramid_mixed(images, types, device="cpu", **kw)
        for g, w in zip(got, want):
            assert all(np.array_equal(a, b) for a, b in zip(g, w))


@pytest.mark.cuda
def test_cuda_timer(cuda_device):
    x = torch.zeros(1 << 20, device=cuda_device)
    ms = timing.cuda_time_ms(lambda: x.add_(1), warmup=1, iters=5)
    assert ms > 0


def test_cuda_timer_refuses_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        timing.cuda_time_ms(lambda: None)


# a plan of each kernel class, scaled through ``scale``
SPAN_PLANS = {
    box: (256, 128, 16, 8, 0, 0),
    bilinear: (300, 200, 290, 190, 0, 0),
    deep: (6550, 650, 100, 10, 0, 0),
    bilinear128: (256, 256, 32, 32, 4, 4, True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("module", [*SPAN_PLANS, pyramid], ids=lambda m: m.__name__.split(".")[-1])
def test_wrapper_spans_on_the_card(cuda_device, module):
    """Under the profiler each kernel wrapper opens its tables, alloc and
    launch spans once a call, on the host: no device event carries a
    span's name."""
    from torch.profiler import ProfilerActivity, profile

    if module is pyramid:
        fn = stt.make_pyramid_fn(512, 512, 0)
        x = torch.zeros((2, 512, 512, 4), dtype=torch.uint8, device=cuda_device)
        call = lambda: fn(x)  # noqa: E731
    else:
        key = SPAN_PLANS[module]
        plan = stt.ScalePlan(*key)
        x = torch.zeros((1, key[1], key[0], plan.meta_in.n_bytes), dtype=torch.uint8,
                        device=cuda_device)
        call = lambda: stt.scale(plan, x)  # noqa: E731
    call()
    torch.cuda.synchronize()
    before, launched = timing.span_totals(), module.launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    after = timing.span_totals()
    assert module.launches == launched + 1
    for name in ("smolscale.tables", "smolscale.alloc", "smolscale.launch"):
        got = after[name]["count"] - before.get(name, {"count": 0})["count"]
        assert got == 1, name
    events = list(prof.profiler.kineto_results.events())
    on_device = [e.name() for e in events if "CUDA" in str(e.device_type())]
    assert on_device and not [n for n in on_device if n.startswith("smolscale.")]
    assert {"smolscale.tables", "smolscale.launch"} <= {e.name() for e in events}


def test_build_digest_follows_headers(monkeypatch, tmp_path):
    """The build stamp hashes every file under csrc/, so an edited header
    that a source includes rebuilds the library."""
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = _build._digest()
    assert _build._digest() == before
    (tmp_path / "h.cuh").write_text("// two\n")
    assert _build._digest() != before
    assert [p.name for p in _build._sources()] == ["k.cu"]


def test_build_needs_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.find_nvcc()


def _split_meshes(n_entries):
    from smolscale_tpu_torch import parallel

    cards = [torch.device("cuda", k) for k in range(torch.cuda.device_count())]
    return parallel, [parallel.default_mesh(), parallel.default_mesh(devices=[cards[0]] * n_entries)]


@pytest.mark.cuda
def test_split_on_every_card(cuda_device):
    """The batch and row splits over a mesh of every card (and over one card
    listed four times): each result lies on card 0 and equals the unsplit
    scale there, byte for byte; the farm splits the same way."""
    parallel, meshes = _split_meshes(4)
    for mesh in meshes:
        n = mesh.shape["dp"]
        plan = stt.ScalePlan(4096, 1024, 256, 64, 0, 0)          # box kernel
        x = torch.randint(0, 256, (2 * n, 1024, 4096, 4), dtype=torch.uint8, device=cuda_device)
        got = parallel.make_batched_scale(plan, mesh)(x)
        assert got.device == cuda_device and torch.equal(got, stt.scale(plan, x))
        for key in [(2048, 2048, 256, 256, 0, 0), (640, 2000, 16, 3, 4, 4, True),
                    (700, 500, 123, 77, 8, 8)]:                  # general, deep, 3-byte
            plan = stt.ScalePlan(*key)
            rows = parallel.DeviceMesh(mesh.devices, ("rows",))
            xi = x.view(-1)[: key[1] * key[0] * plan.meta_in.n_bytes].view(
                key[1], key[0], plan.meta_in.n_bytes)
            got = parallel.make_row_sharded_scale(plan, rows)(xi)
            assert got.device == cuda_device and torch.equal(got, stt.scale(plan, xi)), key
        grid = parallel.default_mesh(("dp", "rows"), devices=list(mesh.devices))
        plan = stt.ScalePlan(2048, 1024, 300, 77, 4, 0, True)     # 128bpp by rows
        xb = x.view(-1)[: 2 * grid.shape["dp"] * 1024 * 2048 * 4].view(-1, 1024, 2048, 4)
        got = parallel.make_sharded_batch_step(plan, grid)(xb)
        assert torch.equal(got, stt.scale(plan, xb))
        xp = x.view(-1)[: 4 * n * 512 * 512 * 4].view(4 * n, 512, 512, 4)
        before = pyramid.launches
        levels = stt.make_pyramid_fn(512, 512, 0, mesh=mesh)(xp)
        assert pyramid.launches == before + n
        want = stt.make_pyramid_fn(512, 512, 0)(xp)
        assert all(g.device == cuda_device and torch.equal(g, w) for g, w in zip(levels, want))


@pytest.mark.cuda
def test_split_fleet_and_dryrun_on_card(cuda_device):
    """scale_pyramid_mixed over a mesh gives the unsplit fleet's bytes; the
    dry run's four plans split over one card listed 4 and 16 times."""
    parallel, meshes = _split_meshes(3)
    rng = np.random.default_rng(8)
    images = [rng.integers(0, 256, (256, 256, 4), dtype=np.uint8) for _ in range(5)]
    images += [rng.integers(0, 256, (192, 128, 3), dtype=np.uint8) for _ in range(2)]
    types = [0, 0, 4, 0, 0, 8, 8]
    want = stt.scale_pyramid_mixed(images, types, sizes=(32, 64))
    for mesh in meshes:
        got = stt.scale_pyramid_mixed(images, types, sizes=(32, 64), mesh=mesh,
                                      max_batch_bytes=2 * 256 * 256 * 4)
        for g, w in zip(got, want):
            assert all(np.array_equal(a, b) for a, b in zip(g, w))
    for n in (4, 16):
        parallel.dryrun_multichip(n, device=cuda_device)


@pytest.mark.cuda
def test_cli_on_card(cuda_device, monkeypatch, tmp_path, capsys):
    """check on the card over a cut ladder (every case one launch of the
    bilinear or the 128bpp kernel, against the plain versions on the CPU),
    generate, and one benchmark line."""
    from smolscale_tpu_torch import cli
    from smolscale_tpu_torch.ops import bilinear128 as b128
    from smolscale_tpu_torch.utils import png

    monkeypatch.setattr(cli, "_check_sizes", lambda full: [1, 2, 3, 63, 64, 255, 256, 257])
    before = bilinear.launches + b128.launches
    assert cli.main(["check", "--colors", "1"]) == 0
    assert "FAIL" not in capsys.readouterr().out
    n_cases = sum(1 for _ in cli._check_cases(False, 1))
    assert bilinear.launches + b128.launches - before == n_cases
    png.write_png(tmp_path / "in.png", np.random.default_rng(1).integers(
        0, 256, (60, 80, 4), dtype=np.uint8))
    assert cli.main(["generate", str(tmp_path / "in.png"), str(tmp_path / "out"), "2"]) == 0
    assert png.read_png(tmp_path / "out-40x30.png").shape == (30, 40, 4)
    assert cli.main(["benchmark", "--steps", "1", "--reps", "1"]) == 0
    assert "device=cuda" in capsys.readouterr().out


@pytest.mark.cuda
@pytest.mark.parametrize("mode", fuzz.MODES)
def test_fuzz_on_card(cuda_device, mode, capsys):
    """A few cases of each fuzz mode: every kernel that takes a case agrees
    with its plain version, and the mode's target kernel launched."""
    flag = [] if mode == "uniform" else [f"--{mode}"]
    assert fuzz.main(["6", "14", *flag]) == 0
    assert "mismatch=0 exc=0 flaky=0" in capsys.readouterr().out
