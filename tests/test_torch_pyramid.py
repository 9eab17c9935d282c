"""The port's thumbnail-pyramid class (smolscale_tpu_torch.ops.pyramid) and
farm API (smolscale_tpu_torch.pyramid) against numpy_ref, the JAX package's
Pallas pyramid kernel #9 in interpret mode (``pallas_pyramid``, its 24bpp
form through ``pyramid_dispatch``) and the JAX package's farm API on the CPU.

On the CPU ``pyramid.pyramid_fn`` runs the kernel's plain PyTorch version;
the CUDA kernel itself is compared with it on the card (test_torch_cuda.py,
chip_smoke.py).  All arithmetic is integer: the tolerance is byte equality.
"""

from unittest import mock

import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from smolscale_tpu import pyramid as jax_pyramid
from smolscale_tpu.backends import numpy_ref
from smolscale_tpu.ops import pallas_pyramid
from smolscale_tpu.plan import ScalePlan as RefPlan
from smolscale_tpu_torch import make_pyramid_fn, scale_pyramid_mixed
from smolscale_tpu_torch import plan as port_plan
from smolscale_tpu_torch.ops import pyramid
from smolscale_tpu_torch.plan import ScalePlan

_ORIG = pl.pallas_call


def _interp_call(*a, **k):
    return _ORIG(*a, **k, interpret=True)


def _sets(w, h, outs, ti, to):
    port = tuple(ScalePlan(w, h, wo, ho, ti, to, False) for wo, ho in outs)
    ref = tuple(RefPlan(w, h, wo, ho, ti, to, False) for wo, ho in outs)
    return port, ref


def _square(w, h, sizes, ti=0, to=0, srgb=False):
    return tuple(ScalePlan(w, h, s, s, ti, to, srgb) for s in sizes)


def _id(case):
    return "-".join(str(v) for v in (case[0], case[1], *(wo for wo, _ in case[2]), *case[3:]))


_LEVELS3 = ((64, 32), (128, 64), (256, 128))
# tests/test_pallas_pyramid.py: test_pyramid_exact (:36-44), the applicable
# sets of test_pyramid_unassoc_exact (:102-111) and the 24bpp sets of
# test_pyramid_24bpp_planes_exact (:128), which the TPU runs through its
# planes feed; (w, h, ((w_out, h_out), ...), type_in, type_out)
FOUR_BYTE = [
    (512, 512, ((64, 64), (128, 128), (256, 256)), 0, 0),  # row 5
    (512, 512, ((64, 64), (128, 128), (256, 256)), 1, 0),  # BGRA -> RGBA
    (256, 128, ((32, 16), (64, 32), (128, 64)), 2, 3),     # ARGB -> ABGR
    (1280, 320, ((160, 40), (320, 80)), 3, 3),             # 8:1 / 4:1
    (512, 256, _LEVELS3, 4, 0),                            # unassociated in
    (512, 256, _LEVELS3, 5, 1),                            # unassociated BGRA in
    (512, 256, _LEVELS3, 0, 4),                            # unassociated out
]
RGB24 = [(512, 256, _LEVELS3, ti, to) for ti, to in [(8, 8), (9, 9), (9, 8)]]


def _random(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _pallas(ref_plans, imgs, planes):
    pallas_pyramid._built.cache_clear()
    try:
        with mock.patch.object(pl, "pallas_call", _interp_call):
            if planes:
                import jax.numpy as jnp

                outs = pallas_pyramid.pyramid_dispatch(ref_plans)(jnp.asarray(imgs))
            else:
                outs = pallas_pyramid.pyramid_fn(ref_plans, imgs)
        return [np.asarray(o) for o in outs]
    finally:
        pallas_pyramid._built.cache_clear()


@pytest.mark.parametrize("case", FOUR_BYTE + RGB24, ids=_id)
def test_plain_matches_pallas_and_spec(case):
    w, h, outs, ti, to = case
    plans, ref_plans = _sets(*case)
    assert pyramid.applicable(plans)
    planes = plans[0].meta_in.n_bytes == 3
    assert pallas_pyramid.applicable(ref_plans) != planes
    imgs = _random((2, h, w, plans[0].meta_in.n_bytes), sum(case[:2]) + ti + to)
    got = pyramid.pyramid_scale_ref(plans, torch.from_numpy(imgs))
    assert len(got) == len(plans)
    for p, rp, g, want in zip(plans, ref_plans, got, _pallas(ref_plans, imgs, planes)):
        assert g.shape == (2, p.height_out, p.width_out, p.meta_out.n_bytes)
        assert np.array_equal(g.numpy(), want), p.key
        spec = np.stack([numpy_ref.scale(rp, im) for im in imgs])
        assert np.array_equal(g.numpy(), spec), p.key


def test_plain_unbatched_matches_pallas():
    """An unbatched image (test_pyramid_u32_view_and_squeeze) gives unbatched
    levels."""
    case = (256, 256, ((32, 32), (64, 64)), 0, 0)
    plans, ref_plans = _sets(*case)
    img = _random((256, 256, 4), 7)
    got = pyramid.pyramid_fn(plans, torch.from_numpy(img))
    want = _pallas(ref_plans, np.ascontiguousarray(img).view(np.uint32)[..., 0], False)
    for p, rp, g, wt in zip(plans, ref_plans, got, want):
        assert g.shape == (p.height_out, p.width_out, 4)
        assert np.array_equal(g.numpy(), wt)
        assert np.array_equal(g.numpy(), numpy_ref.scale(rp, img))


def test_unassociated_both_sides_is_out():
    """RGBA unassociated in and out runs at PREMUL16: out of both classes
    (test_pyramid_unassoc_exact's (4, 5) case), level by level."""
    plans, ref_plans = _sets(512, 256, _LEVELS3, 4, 5)
    assert not pyramid.applicable(plans)
    assert not pallas_pyramid.applicable(ref_plans)
    assert pallas_pyramid.pyramid_dispatch(ref_plans) is None


def test_pyramid_fn_device_rule():
    plans = _square(256, 256, (32, 64))
    imgs = torch.from_numpy(_random((2, 256, 256, 4), 3))
    before = pyramid.launches
    got = pyramid.pyramid_fn(plans, imgs)
    assert pyramid.launches == before  # the CPU runs the plain version
    for g, want in zip(got, pyramid.pyramid_scale_ref(plans, imgs)):
        assert torch.equal(g, want)
    with pytest.raises(ValueError, match="no pyramid kernel"):
        pyramid.pyramid_fn(plans, imgs.to("meta"))
    with pytest.raises(ValueError, match="outside the pyramid kernel's class"):
        pyramid.pyramid_fn(_square(256, 256, (32,)), imgs)
    with pytest.raises(ValueError, match="does not match plan"):
        pyramid.pyramid_fn(plans, imgs[..., :3])


def test_applicable_gates():
    """test_pallas_pyramid.py::test_applicable_gates on the port's class.  It
    differs from the TPU's in the TPU gates it drops (width a multiple of
    128, height of 8, the 12 MiB VMEM budget): 2048^2 -> (256^2, 512^2),
    96x128 -> (24x32, 48x64) and 320x256 -> (40x32, 80x64) are in."""
    assert pyramid.applicable(_square(512, 512, (64, 128, 256)))
    assert not pyramid.applicable(_square(512, 512, (32, 256)))  # 16:1 is a box
    assert not pyramid.applicable(_square(512, 512, (64, 128), srgb=True))
    assert not pyramid.applicable(_square(512, 512, (64, 128), 4, 4))  # PREMUL16
    assert pyramid.applicable(_square(512, 512, (64, 128), 4, 0))
    assert pyramid.applicable(_square(512, 512, (64, 128), 0, 4))
    assert not pyramid.applicable(_square(512, 512, (64,)))  # one level
    assert not pyramid.applicable(_square(512, 512, (64, 64)))  # duplicate shape
    assert not pyramid.applicable(_square(320, 512, (40, 80)))  # 512 -> 40 is a box
    assert pyramid.applicable(_square(2048, 2048, (256, 512)))
    in_port_only = [
        (2048, 2048, ((256, 256), (512, 512)), 0, 0),
        (96, 128, ((24, 32), (48, 64)), 0, 0),
        (320, 256, ((40, 32), (80, 64)), 0, 0),
    ]
    for case in in_port_only:
        plans, ref_plans = _sets(*case)
        assert pyramid.applicable(plans) and not pallas_pyramid.applicable(ref_plans)
    # test_pyramid.py's 96x128 -> (16, 32): 96 -> 16 is no uniform ladder
    assert not pyramid.applicable(_square(96, 128, (16, 32)))
    # 24bpp in and out only: 3 bytes in, 4 out is out, as in pyramid_dispatch
    assert pyramid.applicable(_square(512, 512, (64, 128), 8, 9))
    assert not pyramid.applicable(_square(512, 512, (64, 128), 8, 0))
    assert not pyramid.applicable(_square(512, 512, (64, 128), 0, 8))


@pytest.mark.parametrize("case", FOUR_BYTE + RGB24, ids=_id)
def test_class_contains_tpu_class(case):
    """Every set the TPU fuses (``pyramid_dispatch`` is not None) is in the
    port's class, and each level's kernel slot is its own."""
    plans, ref_plans = _sets(*case)
    assert pallas_pyramid.pyramid_dispatch(ref_plans) is not None
    assert pyramid.applicable(plans)
    assert len({pyramid.slot(p) for p in plans}) == len(plans)


# the sweep of every width 8-700 and every output below it, in four parts
# of about the same cost
_SWEEP = [(8, 441), (441, 556), (556, 636), (636, 701)]


@pytest.mark.parametrize("lo,hi", _SWEEP)
def test_uniform_ladders_are_nested(lo, hi):
    """Every axis the planner makes a uniform f = 128 ladder (the TPU's
    ``_lad128``) has d = 2, o0 = 0 and dim_in == 2 * (dim_out << n): the
    levels' windows are nested and aligned, and ``nested_ladder`` holds on
    exactly those axes."""
    n_ladders = 0
    for dim_in in range(lo, hi):
        for dim_out in range(-(-dim_in // 8), dim_in):
            filt, _, n, dim_bilin = port_plan.pick_filter_params(dim_in, dim_out, False)
            if not filt.is_bilinear:
                continue
            ax, _ = port_plan._make_axis_plan(dim_in, dim_out, False)
            lad = pallas_pyramid._lad128(ax)
            assert pyramid.nested_ladder(ax) == (lad is not None), (dim_in, dim_out)
            if lad is not None:
                n_ladders += 1
                assert lad == (2, 128, 0) and dim_in == 2 * (dim_out << n), (dim_in, dim_out)
    assert n_ladders > 0


# ----------------------------------------------------------------------------
# The farm API against the JAX package's, on the CPU
# ----------------------------------------------------------------------------

def _assert_levels_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else g
        assert g.dtype == np.uint8 and np.array_equal(g, np.asarray(w))


def test_make_pyramid_fn_matches_jax():
    """tests/test_pyramid.py::test_pyramid_exact (levels 96 -> 16 are no
    uniform ladder: level by level on the bilinear kernel)."""
    imgs = _random((4, 128, 96, 4), 55)
    got = make_pyramid_fn(96, 128, 0, sizes=(16, 32), device="cpu")(imgs)
    _assert_levels_equal(got, jax_pyramid.make_pyramid_fn(96, 128, 0, sizes=(16, 32))(imgs))
    for k, s in enumerate((16, 32)):
        plan = RefPlan(96, 128, s, s, 0, 0, False)
        for i in range(4):
            assert np.array_equal(got[k][i].numpy(), numpy_ref.scale(plan, imgs[i]))


def test_make_pyramid_fn_fused_and_level_by_level_agree():
    """A tensor runs where it lies; the fused class and the level-by-level
    path give the same bytes as the JAX farm."""
    imgs = _random((2, 128, 128, 4), 5)
    for sizes, fused in (((16, 32, 64), True), ((24, 48), False)):
        assert pyramid.applicable(_square(128, 128, sizes, 1, 3)) == fused
        fn = make_pyramid_fn(128, 128, 1, sizes=sizes, pixel_type_out=3)
        got = fn(torch.from_numpy(imgs))
        want = jax_pyramid.make_pyramid_fn(128, 128, 1, sizes=sizes, pixel_type_out=3)(imgs)
        _assert_levels_equal(got, want)
    with pytest.raises(ValueError, match="lies on"):
        make_pyramid_fn(128, 128, 0, sizes=(32, 64), device="meta")(torch.from_numpy(imgs))


def test_make_pyramid_fn_takes_strided_input():
    """A batch that is not contiguous (a transposed view) gives the levels
    of its contiguous copy on the fused path, as on the level-by-level one
    (the JAX farm takes any array)."""
    imgs = torch.from_numpy(_random((2, 128, 128, 4), 6))
    strided = imgs.transpose(1, 2).contiguous().transpose(1, 2)
    assert not strided.is_contiguous() and torch.equal(strided, imgs)
    for sizes in ((16, 32, 64), (24, 48)):
        fn = make_pyramid_fn(128, 128, 0, sizes=sizes)
        _assert_levels_equal(fn(strided), fn(imgs))


def _fleet_equal(got, want, n):
    assert len(got) == len(want) == n
    for g, w in zip(got, want):
        assert isinstance(g, tuple) and len(g) == len(w)
        _assert_levels_equal(g, w)


def test_mixed_fleet_matches_jax():
    """tests/test_pyramid.py::test_mixed_fleet."""
    rng = np.random.default_rng(55)
    images = [rng.integers(0, 256, (64, 64, 4), np.uint8) for _ in range(3)]
    images.append(rng.integers(0, 256, (32, 48, 3), np.uint8))
    got = scale_pyramid_mixed(images, [0, 0, 4, 8], sizes=(8, 16), device="cpu")
    _fleet_equal(got, jax_pyramid.scale_pyramid_mixed(images, [0, 0, 4, 8], sizes=(8, 16)), 4)
    assert got[3][0].shape == (8, 8, 3)
    assert np.array_equal(
        got[2][1], numpy_ref.scale(RefPlan(64, 64, 16, 16, 4, 4, False), images[2]))


def test_mixed_fleet_forwards_type_out_and_srgb():
    """``pixel_type_out`` and ``with_srgb`` reach every group's plans, as the
    JAX farm's ``**kw`` does: the fused class (RGBA premul 64^2 -> 8, 16,
    BGRA out) leaves the pyramid kernel in linear light."""
    rng = np.random.default_rng(57)
    images = [rng.integers(0, 256, (64, 64, 4), np.uint8) for _ in range(2)]
    images.append(rng.integers(0, 256, (32, 48, 3), np.uint8))
    types = [0, 4, 8]
    assert pyramid.applicable(_square(64, 64, (8, 16), 0, 1))
    assert not pyramid.applicable(_square(64, 64, (8, 16), 0, 1, srgb=True))
    for srgb in (False, True):
        got = scale_pyramid_mixed(images, types, sizes=(8, 16), device="cpu",
                                  pixel_type_out=1, with_srgb=srgb)
        want = jax_pyramid.scale_pyramid_mixed(images, types, sizes=(8, 16),
                                               pixel_type_out=1, with_srgb=srgb)
        _fleet_equal(got, want, 3)
        assert got[2][1].shape == (16, 16, 4)
        plan = RefPlan(48, 32, 16, 16, 8, 1, srgb)
        assert np.array_equal(got[2][1], numpy_ref.scale(plan, images[2]))


def test_mixed_fleet_bounded_batches_pad_and_order(monkeypatch):
    """tests/test_pyramid.py::test_mixed_fleet_bounded_batches: sub-batches of
    at most ``max_batch_bytes``, a group's remainder padded by repeating its
    last image, results in input order and equal to the unbounded run and
    the JAX package's."""
    rng = np.random.default_rng(56)
    images = [rng.integers(0, 256, (64, 64, 4), np.uint8) for _ in range(5)]
    images += [rng.integers(0, 256, (32, 48, 3), np.uint8) for _ in range(3)]
    types = [0, 4, 0, 0, 4, 8, 8, 8]
    from smolscale_tpu_torch import pyramid as farm

    calls = []
    real = farm.make_pyramid_fn

    def spy(*a, **k):
        fn = real(*a, **k)

        def wrapped(x):
            calls.append((a[:3], tuple(x.shape)))
            return fn(x)

        return wrapped

    monkeypatch.setattr(farm, "make_pyramid_fn", spy)
    got = scale_pyramid_mixed(images, types, sizes=(8, 16), max_batch_bytes=2 * 64 * 64 * 4,
                              device="cpu")
    # 64^2 RGBA: [0, 2] + [3 padded to 2]; unassociated: [1, 4]; RGB24: 7 fit
    assert calls == [
        ((64, 64, 0), (2, 64, 64, 4)), ((64, 64, 0), (2, 64, 64, 4)),
        ((64, 64, 4), (2, 64, 64, 4)), ((48, 32, 8), (3, 32, 48, 3)),
    ]
    want = jax_pyramid.scale_pyramid_mixed(images, types, sizes=(8, 16),
                                           max_batch_bytes=2 * 64 * 64 * 4)
    _fleet_equal(got, want, 8)
    _fleet_equal(got, scale_pyramid_mixed(images, types, sizes=(8, 16), device="cpu"), 8)
    for i, img in enumerate(images):
        plan = RefPlan(img.shape[1], img.shape[0], 8, 8, types[i], types[i], False)
        assert np.array_equal(got[i][0], numpy_ref.scale(plan, img))


def test_row5_small_matches_jax():
    """Suite row 5 (benchmarks/suite.py:82-127) at batch 2: RGBA premul 512^2
    -> (64, 128, 256), one fused call."""
    imgs = _random((2, 512, 512, 4), 0)
    assert pyramid.applicable(_square(512, 512, (64, 128, 256)))
    got = make_pyramid_fn(512, 512, 0, device="cpu")(imgs)
    assert [tuple(g.shape) for g in got] == [(2, s, s, 4) for s in (64, 128, 256)]
    _assert_levels_equal(got, jax_pyramid.make_pyramid_fn(512, 512, 0)(imgs))


# suite.py:157-163: (share, (h, w), pixel type) and whether the group is in
# the fused class
ROW5B_GROUPS = [
    (0.30, (512, 512), 0, True),
    (0.20, (512, 512), 4, False),   # unassociated in and out: PREMUL16
    (0.15, (512, 512), 1, True),
    (0.20, (512, 512), 8, True),    # RGB24
    (0.15, (384, 384), 0, False),   # 384 -> 256 is 0h
]


def test_row5b_small_matches_jax():
    """Suite row 5b (suite.py:130-255) at two images per group, through
    ``scale_pyramid_mixed``, against the JAX package's."""
    sizes = (64, 128, 256)
    rng = np.random.default_rng(0)
    images, types = [], []
    for _, (h, w), pt, fused in ROW5B_GROUPS:
        assert pyramid.applicable(_square(w, h, sizes, pt, pt)) == fused
        nb = 3 if pt >= 8 else 4
        images += [rng.integers(0, 256, (h, w, nb), dtype=np.uint8) for _ in range(2)]
        types += [pt, pt]
    order = [0, 9, 2, 5, 7, 1, 3, 8, 4, 6]  # groups interleaved
    images, types = [images[i] for i in order], [types[i] for i in order]
    got = scale_pyramid_mixed(images, types, sizes=sizes, device="cpu")
    _fleet_equal(got, jax_pyramid.scale_pyramid_mixed(images, types, sizes=sizes), 10)
