"""The port's box path (smolscale_tpu_torch.ops.box) against the JAX
package's Pallas box kernel in interpret mode and against numpy_ref.

On the CPU ``box.scale_fn`` runs the kernel's plain PyTorch version; the
CUDA kernel itself is compared with it on the card (test_torch_cuda.py,
chip_smoke.py).  All arithmetic is integer: the tolerance is byte equality.
"""

import importlib.util
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from smolscale_tpu.backends import numpy_ref
from smolscale_tpu.ops import pallas_box
from smolscale_tpu.plan import ScalePlan as RefPlan
from smolscale_tpu_torch.ops import box, pixels
from smolscale_tpu_torch.plan import ScalePlan

_ORIG = pl.pallas_call


def _interp_call(*a, **k):
    return _ORIG(*a, **k, interpret=True)


# the plans of tests/test_pallas_box.py
EXACT = [
    (256, 128, 16, 8, 0, 0),     # 16:1 both axes
    (384, 256, 3, 2, 0, 1),      # deep ratio, format reorder
    (512, 512, 4, 4, 2, 3),      # ARGB->ABGR
    (1280, 640, 128, 64, 1, 1),  # 10:1
    (4096, 128, 256, 8, 0, 0),   # 16:1, wide
    (3840, 120, 384, 12, 2, 3),  # 10:1 + reorder
]
UNASSOC_IN = [(256, 128, 16, 8, ti, to) for ti, to in [(4, 0), (5, 1), (6, 2)]] + [
    (1280, 640, 128, 64, 4, 0),
]
UNASSOC_OUT = [(256, 128, 16, 8, ti, to) for ti, to in [(0, 4), (1, 7), (2, 5), (3, 6)]]
COPY_AXES = [
    (256, 128, 256, 8, 0, 0),    # COPY-H x box-V 16:1
    (256, 128, 16, 128, 0, 0),   # box-H 16:1 x COPY-V
    (384, 64, 384, 4, 2, 3),     # COPY-H x box-V, ARGB->ABGR
    (384, 64, 3, 64, 1, 1),      # deep box-H x COPY-V
    (256, 60, 256, 6, 1, 0),     # COPY-H x box-V 10:1, unassoc in
    (256, 64, 16, 64, 0, 1),     # box-H x COPY-V, unassoc-out
    (3840, 120, 384, 120, 2, 3), # wide box-H x COPY-V
]
PLANES_24 = [
    (256, 128, 16, 8, 8, 8),     # RGB24->RGB24 16:1
    (384, 256, 3, 2, 9, 9),      # BGR24 deep ratio
    (512, 512, 4, 4, 8, 0),      # RGB24->RGBA
    (256, 128, 16, 8, 8, 4),     # RGB24->unassoc RGBA
    (256, 128, 256, 8, 8, 8),    # RGB24 COPY-H x box-V
    (256, 128, 16, 128, 9, 8),   # BGR24 box-H x COPY-V
    (384, 64, 384, 4, 8, 0),     # COPY-H x box-V, RGB24->RGBA
]
# 4-byte input, 3-byte output: the TPU runs the 4-byte surrogate plan and
# slices off alpha; the port's kernel unpacks 4 channels and stores 3
OUT_24 = [
    (256, 128, 16, 8, 0, 8),     # RGBA premul -> RGB24
    (256, 128, 16, 8, 4, 9),     # RGBA unassoc -> BGR24
    (384, 64, 384, 4, 5, 8),     # COPY-H x box-V, BGRA unassoc -> RGB24
]
# plans the TPU kernel leaves to XLA (width % 128, row tiling, VMEM budget)
# that the port's kernel takes
PORT_ONLY = [
    (100, 90, 10, 9, 0, 0),
    (99, 200, 9, 20, 5, 3),
    (1000, 1250, 10, 25, 0, 0),
    (128, 16016, 128, 1001, 0, 0),
    (160, 90, 16, 9, 9, 4),
    (117, 36, 13, 36, 7, 1),
]


def _id(key):
    return "-".join(map(str, key))


def _images(key, seed, batch=2):
    plan = ScalePlan(*key)
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (batch, key[1], key[0], plan.meta_in.n_bytes), dtype=np.uint8)


def _spec(key, imgs):
    rp = RefPlan(*key)
    return np.stack([numpy_ref.scale(rp, im) for im in imgs])


def _port(key, imgs):
    plan = ScalePlan(*key)
    x = torch.from_numpy(imgs)
    ref = box.box_scale_ref(plan, x)
    before = box.launches
    got = box.scale_fn(plan, x)
    assert box.launches == before  # the CPU path launches nothing
    assert torch.equal(ref, got)
    return got.numpy()


@pytest.mark.parametrize("key", EXACT + UNASSOC_IN + UNASSOC_OUT + COPY_AXES, ids=_id)
def test_box_vs_pallas_interpret(key):
    imgs = _images(key, sum(key))
    rp = RefPlan(*key)
    assert pallas_box.applicable(rp) and box.applicable(ScalePlan(*key))
    pallas_box._built.cache_clear()
    try:
        with mock.patch.object(pl, "pallas_call", _interp_call):
            tpu = np.asarray(pallas_box.scale_fn(rp, imgs))
    finally:
        pallas_box._built.cache_clear()
    got = _port(key, imgs)
    assert np.array_equal(got, tpu)
    assert np.array_equal(got, _spec(key, imgs))


@pytest.mark.parametrize("key", PLANES_24 + OUT_24, ids=_id)
def test_box_24bpp_vs_pallas_planes(key):
    """24bpp endpoints: the TPU runs a 4-byte surrogate plan, reading 24bpp
    input through u8 planes and slicing 24bpp output; the port reads and
    writes the 3-byte pixels directly."""
    import jax

    from smolscale_tpu.backends import xla

    rp = RefPlan(*key)
    adapted = xla._adapt_24bpp(rp)
    assert adapted is not None and pallas_box.applicable(adapted[0])
    imgs = _images(key, sum(key))
    saved = xla._FORCE_PALLAS, xla._RGB24_PLANES
    xla._FORCE_PALLAS, xla._RGB24_PLANES = True, True
    pallas_box._built.cache_clear()
    pallas_box._built_planes.cache_clear()
    try:
        with mock.patch.object(pl, "pallas_call", _interp_call):
            tpu = np.asarray(jax.jit(lambda v: xla.scale_fn(rp, v))(imgs))
    finally:
        xla._FORCE_PALLAS, xla._RGB24_PLANES = saved
        pallas_box._built.cache_clear()
        pallas_box._built_planes.cache_clear()
    got = _port(key, imgs)
    assert np.array_equal(got, tpu)
    assert np.array_equal(got, _spec(key, imgs))


@pytest.mark.parametrize("key", PORT_ONLY, ids=_id)
def test_box_port_only_plans(key):
    assert not pallas_box.applicable(RefPlan(*key))
    assert box.applicable(ScalePlan(*key))
    imgs = _images(key, sum(key), batch=1)
    assert np.array_equal(_port(key, imgs), _spec(key, imgs))


def _smoke():
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _smoke_check_plans():
    return _smoke().CHECK_PLANS


@pytest.mark.parametrize(
    "key", [k for k in _smoke_check_plans() if k[0] * k[1] <= 1 << 20], ids=_id
)
def test_chip_smoke_plans_match_spec(key):
    """chip_smoke.py holds the kernel against the plain version on the card;
    this holds the plain version against numpy_ref for the same plans (all
    but the full-size 4096^2 strip, whose class COPY_AXES covers)."""
    assert box.applicable(ScalePlan(*key))
    imgs = _images(key, sum(key))
    assert np.array_equal(_port(key, imgs), _spec(key, imgs))


@pytest.mark.parametrize(
    "key",
    [k for k in _smoke_check_plans() if k[0] * k[1] <= 1 << 20
     and pallas_box.applicable(RefPlan(*k)) and k not in EXACT + COPY_AXES],
    ids=_id,
)
def test_chip_smoke_plans_match_pallas(key):
    """chip_smoke.py's box plans that the Pallas box kernel also takes: the
    plain version against it in interpret mode."""
    imgs = _images(key, sum(key))
    pallas_box._built.cache_clear()
    try:
        with mock.patch.object(pl, "pallas_call", _interp_call):
            tpu = np.asarray(pallas_box.scale_fn(RefPlan(*key), imgs))
    finally:
        pallas_box._built.cache_clear()
    assert np.array_equal(_port(key, imgs), tpu)


def _launch_cases():
    """(plan key, batch, input byte address): chip_smoke.py's box check plans
    at its batch of 2, its unaligned inputs at each offset, its tall batches,
    and the suite's box rows and the two extra box rows at batch 8."""
    smoke = _smoke()
    cases = [(k, 2, 0) for k in smoke.CHECK_PLANS]
    cases += [(k, 2, off) for k in smoke.BOX_UNALIGNED for off in smoke.BOX_OFFSETS]
    cases += [(k, batch, 0) for k, batch in smoke.BOX_TALL]
    rows = smoke.MAIN_ROWS + [r[:3] for r in smoke.EXTRA_ROWS if r[3] == "box"]
    cases += [(key, batch, 0) for _, key, batch in rows]
    return cases


def _case_id(case):
    key, batch, address = case
    return f"{_id(key)}-b{batch}-at{address}"


@pytest.mark.parametrize("case", _launch_cases(), ids=_case_id)
def test_launch_shape_covers_every_pixel_once(case):
    """Walks csrc/box.cu's loops as ops/box.launch_shape lays them out, in
    plain Python: every output pixel is stored once (columns by block x,
    column warp and lane; rows and images by the grid-stride loops on y and
    z), the split warps' row ranges tile each span's rows once, the lanes
    of a span cover its words (direct) or pixels (staged) once, a staged
    stretch fits its slot, and the form follows the alignment rules."""
    key, batch, address = case
    plan = ScalePlan(*key)
    assert box.applicable(plan)
    nb = plan.meta_in.n_bytes
    rx, drop_x = box._span(plan.x)
    ry, drop_y = box._span(plan.y)
    kind = box.form(plan, address)
    sh = box.launch_shape(plan, batch, kind)
    w_out, h_out = plan.width_out, plan.height_out
    cw, wc, splits, rps = sh["cw"], sh["wc"], sh["splits"], sh["rows_per_split"]
    # grid and block limits
    assert sh["grid_y"] < 2**16 and sh["grid_z"] < 2**16 and sh["grid_x"] < 2**31
    assert wc * splits <= pixels.MAX_WARPS and splits <= ry
    # the forms: 16-byte words straight from device memory only where a
    # lane's words hold whole spans (direct) or four whole columns (COPY) of
    # 16-byte aligned rows
    aligned = address % 16 == 0 and plan.width_in * nb % 16 == 0
    if kind == box.DIRECT:
        assert nb == 4 and aligned and rx * nb % 16 == 0
    elif kind == box.COPY:
        assert nb == 4 and aligned and plan.x.filter.name == "COPY" and w_out % 4 == 0
    else:
        assert kind == box.STAGED and (not aligned or nb == 3 or rx * nb % 16 != 0)
        assert cw * rx * nb <= box.STAGE_BYTES
    # columns: block x, column warp, lane group
    cols = np.zeros(w_out, int)
    for bx in range(sh["grid_x"]):
        for wcol in range(wc):
            j0 = (bx * wc + wcol) * cw
            if kind == box.COPY:
                for lane in range(32):
                    j = j0 + 4 * lane
                    if j < w_out:
                        cols[j : j + 4] += 1
            else:
                for grp in range(cw):
                    if j0 + grp < w_out:
                        cols[j0 + grp] += 1
    assert (cols == 1).all()
    # output rows and images: grid-stride loops on y and z
    for n, grid in ((h_out, sh["grid_y"]), (batch, sh["grid_z"])):
        seen = np.zeros(n, int)
        for start in range(grid):
            seen[start::grid] += 1
        assert (seen == 1).all()
    # the split warps' input rows, on a full span and on the last (dropped) one
    for rows in {ry, ry - int(drop_y)}:
        seen = np.zeros(rows, int)
        for split in range(splits):
            seen[split * rps : min(split * rps + rps, rows)] += 1
        assert (seen == 1).all()
    # a span's lanes: direct, one or two 16-byte words each; staged, pixels
    if kind != box.COPY:
        lanes = 32 // cw
        if kind == box.DIRECT:
            q = rx * nb // 16
            words = 2 if q > lanes else 1
            assert words == (2 if rx // 4 > 32 // cw else 1) and q <= 2 * lanes
            got = sorted(g + lanes * m for g in range(lanes) for m in range(words)
                         if g + lanes * m < q)
            assert got == list(range(q))
        else:
            got = sorted(k for g in range(lanes) for k in range(g, rx, lanes))
            assert got == list(range(rx))


@pytest.mark.parametrize(
    "key,batch,want",
    [
        ((4096, 4096, 256, 256, 0, 0), 8, (box.DIRECT, 8, 8, 1)),      # row 0
        ((4096, 4096, 4096, 256, 0, 0), 8, (box.COPY, 128, 8, 1)),     # row 8
        ((4096, 4096, 256, 256, 8, 8), 8, (box.STAGED, 32, 4, 2)),     # rgb24
        ((3840, 2160, 384, 216, 0, 0), 8, (box.STAGED, 32, 8, 1)),     # box-10
        ((4096, 4096, 32, 32, 0, 0), 8, (box.DIRECT, 1, 2, 4)),        # box-deep
        ((4080, 4080, 16, 16, 0, 0), 8, (box.STAGED, 2, 1, 8)),        # 255:1
    ],
    ids=["row0", "row8", "rgb24", "box-10", "box-deep", "255-1"],
)
def test_launch_shape_of_the_rows(key, batch, want):
    """The form and warp layout each timed row takes: (form, columns per
    warp, column warps, split warps); the deep ratios fill the card with
    split warps, at least WAVE_WARPS warps per SM."""
    plan = ScalePlan(*key)
    sh = box.launch_shape(plan, batch, box.form(plan))
    assert (sh["form"], sh["cw"], sh["wc"], sh["splits"]) == want
    warps = sh["grid_x"] * sh["wc"] * sh["splits"] * plan.height_out * batch
    assert warps >= min(pixels.WAVE_WARPS * pixels.H100_SMS,
                        -(-plan.width_out // sh["cw"]) * plan.height_out * batch * 8)


def test_single_image_shape():
    key = (256, 128, 16, 8, 0, 1)
    imgs = _images(key, 5, batch=1)
    got = box.scale_fn(ScalePlan(*key), torch.from_numpy(imgs[0]))
    assert tuple(got.shape) == (8, 16, 4)
    assert np.array_equal(got.numpy(), _spec(key, imgs)[0])


@pytest.mark.parametrize(
    "key",
    [
        (256, 128, 16, 8, 4, 4),     # unassoc -> unassoc: PREMUL16 / 128bpp
        (256, 128, 16, 8, 0, 0, True),  # sRGB linear: 128bpp
        (250, 128, 16, 8, 0, 0),     # non-integer ratio
        (256, 128, 64, 32, 0, 0),    # bilinear
        (256, 128, 256, 128, 0, 1),  # COPY x COPY repack
        (256, 128, 1, 8, 0, 0),      # one output column
    ],
    ids=_id,
)
def test_applicability_gate(key):
    assert not box.applicable(ScalePlan(*key))
    assert not pallas_box.applicable(RefPlan(*key))


def test_uniform_box_matches_xla():
    from smolscale_tpu.backends import xla

    for dim_in, dim_out in [(256, 16), (250, 16), (4096, 256), (100, 10), (81, 9),
                            (16016, 1001), (9, 1), (300, 7)]:
        mine = ScalePlan(dim_in, 1, dim_out, 1, 0, 0).x
        ref = RefPlan(dim_in, 1, dim_out, 1, 0, 0).x
        if ref.filter.name == "BOX":
            assert box.uniform_box(mine) == xla._box_uniform_applicable(ref)
        else:
            assert not box.uniform_box(mine)


def test_wrapper_rejects_bad_input():
    plan = ScalePlan(256, 128, 16, 8, 0, 0)
    with pytest.raises(TypeError):
        box.scale_fn(plan, torch.zeros((128, 256, 4), dtype=torch.int32))
    with pytest.raises(ValueError):
        box.scale_fn(plan, torch.zeros((128, 256, 3), dtype=torch.uint8))
    with pytest.raises(ValueError):
        box.scale_fn(ScalePlan(256, 128, 64, 32, 0, 0),
                     torch.zeros((128, 256, 4), dtype=torch.uint8))
    # a device with no box kernel raises instead of falling back
    with pytest.raises(ValueError):
        box.scale_fn(plan, torch.zeros((128, 256, 4), dtype=torch.uint8, device="meta"))


def test_kernel_params_follow_plan():
    """The launch parameters the CUDA kernel receives, for the headline and
    a 24bpp -> unassociated BGRA plan."""
    p = box._params(ScalePlan(4096, 4096, 256, 256, 0, 0), 8)
    assert (p.batch, p.rx, p.ry, p.box_x, p.box_y, p.drop_x, p.drop_y) == (8, 16, 16, 1, 1, 1, 1)
    assert p.span_mul_x == p.span_mul_y == 2**24 // 16
    assert (p.nb_in, p.nb_out, p.alpha_ch, p.unassoc_in, p.unassoc_out) == (4, 4, 3, 0, 0)
    assert list(p.src) == [0, 1, 2, 3]
    assert (p.form, p.cw, p.wc, p.splits, p.rows_per_split) == (box.DIRECT, 8, 8, 1, 16)
    assert (p.grid_x, p.grid_y, p.grid_z) == (4, 256, 8)
    assert box._params(ScalePlan(4096, 4096, 256, 256, 0, 0), 8, address=4).form == box.STAGED
    q = box._params(ScalePlan(256, 128, 256, 8, 9, 5), 1)
    assert (q.rx, q.box_x, q.drop_x, q.ry, q.box_y) == (1, 0, 0, 16, 1)
    assert q.form == box.STAGED
    assert (q.nb_in, q.nb_out, q.alpha_ch, q.unassoc_out) == (3, 4, 3, 1)
    # BGR8 bytes (2,1,0) -> BGRA8 bytes (2,1,0,3): same byte order, alpha appended
    assert list(q.src) == [0, 1, 2, 3]
