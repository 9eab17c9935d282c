"""The port's deep box class (smolscale_tpu_torch.ops.deep) against numpy_ref,
the JAX package's Pallas deep kernels in interpret mode (uniform,
span-centric and chunk-centric) and its row API; the unpack and pack of
every (internal alpha, gamma) pair (``ops/pixels.py``) against
``numpy_ref.unpack`` / ``pack``.

On the CPU ``deep.scale_fn`` runs the kernel's plain PyTorch version; the
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

import smolscale_tpu
import smolscale_tpu_torch as stt
from smolscale_tpu import plan as ref_plan
from smolscale_tpu.backends import numpy_ref, xla
from smolscale_tpu.ops import pallas_deep
from smolscale_tpu_torch.backends import torch_ops
from smolscale_tpu_torch.formats import AlphaType, GammaType, StorageType
from smolscale_tpu_torch.ops import bilinear, bilinear128, box, deep, pixels
from smolscale_tpu_torch.plan import ScalePlan

_ORIG = pl.pallas_call


def _interp_call(*a, **k):
    return _ORIG(*a, **k, interpret=True)


# the three plan lists of tests/test_pallas_deep.py, with_srgb last
COMPRESSED = [
    (1024, 1024, 8, 8, 0, 0, False),    # 128:1, 64bpp band
    (2048, 2048, 8, 8, 0, 0, False),    # 256:1, 128bpp PREMUL8
    (2048, 2048, 8, 8, 4, 4, False),    # 256:1, PREMUL16
    (2048, 2048, 8, 8, 4, 0, False),    # unassociated in -> premultiplied
    (2048, 1024, 8, 8, 1, 6, False),    # reorders, 256:1 x 128:1
    (1024, 4096, 8, 4, 0, 0, False),    # 1024 rows per span
    (1024, 4096, 8, 4, 4, 4, False),    # same, PREMUL16
    (1024, 3072, 8, 4, 4, 0, False),    # 768 rows per span
    (2000, 2000, 12, 12, 0, 0, False),  # ragged spans, 166.7:1
    (2000, 2000, 12, 12, 4, 4, False),  # ragged PREMUL16
    (1000, 900, 9, 10, 4, 0, False),    # ragged 64bpp band, unassociated in
    (513, 700, 5, 7, 2, 3, False),      # ragged, odd sizes, reorders
]
LINEAR = [
    (1024, 1024, 8, 8, 4, 4, True),     # PREMUL16 linear, uniform 128:1
    (1024, 1024, 8, 8, 4, 0, True),     # PREMUL8 linear, unassociated in
    (1024, 1024, 8, 8, 0, 0, True),     # PREMUL8 linear, premultiplied in
    (1000, 900, 9, 10, 4, 4, True),     # ragged PREMUL16 linear
    (1198, 475, 13, 2, 0, 9, True),     # 24bpp out: the pack asymmetry
    (1198, 900, 5, 7, 8, 4, True),      # 24bpp in
    (1842, 1538, 10, 15, 0, 0, True),   # a span ending on a TPU chunk edge
    (3516, 745, 54, 6, 9, 8, True),     # 3 * w_out > 128, linear
    (2816, 480, 48, 4, 4, 4, True),     # same, PREMUL16
]
RGB24 = [
    (1024, 1024, 8, 8, 8, 8, False),
    (1024, 1024, 8, 8, 9, 0, False),
    (2000, 2000, 12, 12, 8, 8, False),
    (2000, 2000, 12, 12, 8, 4, False),
    (258, 732, 2, 5, 8, 8, False),
    (1024, 1024, 8, 8, 8, 8, True),     # pack24 direct
    (1198, 900, 5, 7, 8, 4, True),
    (258, 732, 2, 5, 8, 8, True),
]
# sums past 2^31 in the H box; the 16-bit mask after the 128bpp normalisation
WIDE = [
    (10000, 64, 2, 2, 4, 4, True),
    (5000, 5000, 2, 40, 0, 0, False),
]
# spans shorter than a warp's 32 lanes and a block's 16 warps
SHORT = [
    (256, 256, 16, 16, 4, 4, False),
    (256, 256, 16, 16, 0, 0, True),
    (300, 200, 30, 20, 4, 4, True),
    (99, 200, 9, 20, 8, 4, True),
]
# (key, first, n): chip_smoke.py's DEEP_CHECK_ROWS
ROWS = [
    ((1842, 1538, 10, 15, 0, 0, True), 5, 3),  # from the span starting on row 512
    ((1842, 1538, 10, 15, 0, 0, True), 4, 1),  # the span ending on row 512
    ((2000, 2000, 12, 12, 4, 4, False), 3, 6),
    ((1024, 4096, 8, 4, 0, 0, False), 1, 2),
    ((3516, 745, 54, 6, 9, 8, True), 0, 1),
    ((2048, 1024, 8, 8, 1, 6, False), 7, 1),   # the last row
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
    before = deep.launches
    got = deep.scale_rows_fn(plan, torch.from_numpy(imgs), first, n)
    assert deep.launches == before
    return got.numpy()


@pytest.mark.parametrize("key", COMPRESSED + LINEAR + RGB24 + WIDE + SHORT, ids=_id)
def test_deep_matches_numpy_ref(key):
    assert deep.applicable(ScalePlan(*key))
    imgs = _images(key, sum(key))
    assert np.array_equal(_port(key, imgs), _spec(key, imgs))


@pytest.mark.parametrize(
    "key,kernel",
    [
        ((2048, 2048, 8, 8, 4, 4, False), "_built"),             # uniform (#6)
        ((1842, 1538, 10, 15, 0, 0, True), "_built_chunked"),    # chunk-centric (#8)
        ((258, 732, 2, 5, 8, 8, False), "_built_general"),       # span-centric (#7)
        ((3516, 745, 54, 6, 9, 8, True), "_built_chunked"),      # unpacked linear H
        ((258, 732, 2, 5, 8, 8, False), "_built_chunked"),
    ],
    ids=lambda v: _id(v) if isinstance(v, tuple) else v,
)
def test_deep_vs_pallas_interpret(key, kernel):
    """Each of the three Pallas deep kernels, built for the plan and run in
    interpret mode, gives the port's bytes."""
    rp = ref_plan.ScalePlan(*key)
    assert pallas_deep.applicable(rp)
    imgs = _images(key, sum(key) + 1)
    built = getattr(pallas_deep, kernel)
    built.cache_clear()
    try:
        with mock.patch.object(pl, "pallas_call", _interp_call):
            tpu = np.asarray(built(rp, imgs.shape[0])(imgs))
    finally:
        built.cache_clear()
    assert np.array_equal(_port(key, imgs), tpu)


def test_constant_255_keeps_the_16_bit_mask():
    """PREMUL16 linear values reach 2047*255; the 128bpp normalisation masks
    to 16 bits, so a white image does not stay white (numpy_ref)."""
    key = WIDE[0]
    imgs = np.full((1, key[1], key[0], 4), 255, dtype=np.uint8)
    got = _port(key, imgs)
    assert np.array_equal(got, _spec(key, imgs))
    assert got[0, 0, 0].tolist() == [97, 97, 97, 255]
    t = deep.tables(ScalePlan(*key))[0].reshape(6, -1)
    assert int(t[3].max() + 2) * 2047 * 255 > 2**31


@pytest.mark.parametrize("key,first,n", ROWS, ids=lambda v: _id(v) if isinstance(v, tuple) else str(v))
def test_rows_match_jax(key, first, n):
    imgs = _images(key, sum(key) + first)
    want = smolscale_tpu.scale_rows(smolscale_tpu.ScalePlan(*key), imgs[0], first, n,
                                    backend="jax")
    got = _port(key, imgs, first, n)
    assert got.shape == (2, n, key[2], stt.get_meta(key[5]).n_bytes)
    assert np.array_equal(got[0], want)
    assert np.array_equal(got, _spec(key, imgs)[:, first : first + n])


def test_row_api():
    key = (2000, 2000, 12, 12, 4, 4, False)
    img = _images(key, 5, batch=1)[0]
    plan, rp = ScalePlan(*key), smolscale_tpu.ScalePlan(*key)
    ours = [(f, r.numpy()) for f, r in stt.scale_streamed(plan, img, n_chunks=5, device="cpu")]
    theirs = list(smolscale_tpu.scale_streamed(rp, img, n_chunks=5, backend="jax"))
    assert [f for f, _ in ours] == [f for f, _ in theirs] == [0, 3, 6, 9]
    assert all(np.array_equal(a, np.asarray(b)) for (_, a), (_, b) in zip(ours, theirs))
    full = np.concatenate([r for _, r in ours])
    assert np.array_equal(full, smolscale_tpu.scale(rp, img, backend="jax"))
    canvas = torch.zeros((4, 12, 4), dtype=torch.uint8)
    res = stt.scale_rows(plan, torch.from_numpy(img), 8, 4, out=canvas)
    assert res is canvas and np.array_equal(canvas.numpy(), full[8:12])


def _sweep():
    for dims in [(1024, 8), (2000, 12), (1000, 7), (4096, 16), (513, 5), (300, 30),
                 (258, 2), (700, 9), (10000, 2), (5000, 1), (20000, 1100)]:
        for ti, to in [(0, 0), (4, 4), (4, 0), (8, 8), (2, 9)]:
            for srgb in (False, True):
                yield (dims[0], dims[0] + 3, dims[1], dims[1] + 1, ti, to, srgb)


def test_class_covers_pallas_deep():
    """Every plan the Pallas deep kernels take, the port's kernel takes; it
    also takes plans they refuse for VMEM or chunk shape."""
    taken = refused = 0
    for key in _sweep():
        rp, plan = ref_plan.ScalePlan(*key), ScalePlan(*key)
        if pallas_deep.applicable(rp):
            assert deep.applicable(plan), key
            taken += 1
        elif deep.applicable(plan):
            refused += 1
    assert taken > 50 and refused > 0
    assert not deep.applicable(ScalePlan(5000, 5000, 1, 40, 0, 0))   # one output column
    assert not deep.applicable(ScalePlan(256, 256, 100, 100, 4, 4))  # bilinear axes


@pytest.mark.parametrize("dims", [(2048, 8), (2000, 12), (10000, 2), (1538, 15), (745, 6),
                                  (1000, 9), (96, 4)], ids=lambda d: f"{d[0]}-{d[1]}")
def test_tables_match_xla(dims):
    """The box tables at both storages: H as xla._box_h_arrays, V as
    xla._box_v_arrays, with the last weight max(w2 - 1, 0) at 128bpp (the
    TPU's ``w2p``, pallas_deep.py:1264)."""
    ref_ax = ref_plan._make_axis_plan(*dims, False)[0]
    port_ax = ScalePlan(dims[0], 2, dims[1], 2, 0, 0).x
    for storage in (StorageType.S64, StorageType.S128):
        t = bilinear.axis_table(port_ax, vertical=True, storage=storage).reshape(6, -1)
        v = xla._box_v_arrays(ref_ax)
        w2p = v["w2"] if storage == StorageType.S64 else np.maximum(v["w2"] - 1, 0)
        names = ("first_idx", "w1", "mid_start", "mid_len", "last_idx")
        assert np.array_equal(t[:5], np.stack([v[k] for k in names]))
        assert np.array_equal(t[5], w2p)
    h = bilinear.box_h_arrays(port_ax)
    for k, want in xla._box_h_arrays(ref_ax).items():
        assert np.array_equal(h[k], want), k


def test_sums_fit_32_bits():
    """csrc/deep.cu holds its sums in 32 bits: the widest linear H span
    (8191:1, the sRGB cutoff) of PREMUL16 linear values, and the widest
    compressed one of PREMUL16 values."""
    for key, top in [((8191 * 2, 4, 2, 2, 4, 4, True), 2047 * 255),
                     ((65535, 4, 2, 2, 4, 4, False), (255 << 8) | 0x80)]:
        plan = ScalePlan(*key)
        assert plan.internal_alpha == AlphaType.PREMUL16
        assert (plan.gamma == GammaType.SRGB_LINEAR) == key[6]
        t = deep.tables(plan)[0].reshape(6, -1)
        assert (int(t[3].max()) + 2) * top < 2**32
    assert ScalePlan(8192 * 2, 4, 2, 2, 4, 4, True).gamma == GammaType.SRGB_COMPRESSED


def _work_order(plan, planes):
    """numpy_ref's canonical (4, H, W) planes as the port's (H, W, 4) work
    channels (input byte order, alpha last for 24bpp)."""
    layout = plan.meta_in.layout
    order = [layout[k] if k < len(layout) else 3 for k in range(4)]
    return np.stack([planes[ch] for ch in order], axis=-1)


@pytest.mark.parametrize("srgb", [False, True], ids=["compressed", "srgb"])
def test_unpack_pack_match_numpy_ref(srgb):
    """Every (internal alpha, gamma) pair the planner produces, over the
    10x10 format matrix."""
    rng = np.random.default_rng(11)
    seen = set()
    for ti in range(10):
        for to in range(10):
            key = (64, 32, 16, 8, ti, to, srgb)
            plan, rp = ScalePlan(*key), ref_plan.ScalePlan(*key)
            seen.add((plan.internal_alpha, plan.gamma))
            img = rng.integers(0, 256, (5, 7, plan.meta_in.n_bytes), dtype=np.uint8)
            got = pixels.unpack(plan, torch.from_numpy(img)).numpy()
            assert np.array_equal(got, _work_order(plan, numpy_ref.unpack(rp, img))), key
            planes = rng.integers(0, 0x10000, (4, 5, 7), dtype=np.int64)
            got = pixels.pack(plan, torch.from_numpy(_work_order(plan, planes)))
            assert np.array_equal(got.numpy(), numpy_ref.pack(rp, planes)), key
    linear = GammaType.SRGB_LINEAR if srgb else GammaType.SRGB_COMPRESSED
    assert seen == {(AlphaType.PREMUL8, linear), (AlphaType.PREMUL16, linear)}


def test_dispatch_order(monkeypatch):
    """Whole images: box, bilinear, then this kernel; rows: bilinear, then
    this kernel."""
    calls = []
    for mod, name in ((box, "box"), (bilinear, "bilinear"), (deep, "deep")):
        monkeypatch.setattr(mod, "scale_fn", lambda plan, x, name=name: calls.append(name))
        monkeypatch.setattr(mod, "scale_rows_fn",
                            lambda plan, x, f, n, name=name: calls.append(name + " rows"),
                            raising=False)
    img = torch.zeros((2048, 2048, 4), dtype=torch.uint8)
    stt.scale(ScalePlan(2048, 2048, 256, 256, 0, 0), img)   # integer 8:1 box -> bilinear
    stt.scale(ScalePlan(2048, 2048, 128, 128, 0, 0), img)   # integer 16:1 box
    stt.scale(ScalePlan(2048, 2048, 8, 8, 0, 0), img)       # 256:1
    stt.scale(ScalePlan(2048, 2048, 128, 128, 4, 4), img)   # PREMUL16
    stt.scale_rows(ScalePlan(2048, 2048, 128, 128, 0, 0), img, 0, 1)
    stt.scale_rows(ScalePlan(2048, 2048, 8, 8, 0, 0), img, 0, 1)
    assert calls == ["bilinear", "box", "deep", "deep", "bilinear rows", "deep rows"]


@pytest.mark.parametrize(
    "key,item",
    [
        ((256, 256, 256, 16, 0, 0, True), "A3"),      # COPY x box, linear
        ((6500, 100, 100, 50, 0, 0, False), "A3"),    # 65:1 box x bilinear at 64bpp
    ],
    ids=lambda v: v if isinstance(v, str) else _id(v),
)
def test_roadmap_item(key, item):
    """Plans beside this class that no kernel took while ROADMAP item
    ``item`` was open: COPY x box in linear light goes to the 128bpp
    kernel, a 65:1 box beside a bilinear axis at 64bpp to the general
    kernel, and each gives numpy_ref's bytes."""
    plan = ScalePlan(*key)
    kernel = bilinear128 if plan.storage == StorageType.S128 else bilinear
    assert [k for k in torch_ops.WHOLE_KERNELS if k.applicable(plan)] == [kernel]
    assert [k for k in torch_ops.ROW_KERNELS if k.applicable(plan)] == [kernel]
    imgs = _images(key, sum(key), batch=1)
    got = stt.scale(plan, torch.from_numpy(imgs))
    assert np.array_equal(got.numpy(), _spec(key, imgs))


# chip_smoke.py times this kernel on this plan for TPU kernel #7
GENERAL_ROW = (4096, 4096, 32, 480, 0, 0, False)


def test_general_kernel_row(monkeypatch):
    """``pallas_deep.scale_fn`` builds ``_built_general`` (#7) only where
    ``_chunk_centric`` gives None, which takes a V span shorter than 8 rows:
    a box axis (past 8:1) has none, so no plan of a sweep of the class
    reaches it, and ``GENERAL_ROW`` reaches it under the module's timing
    knob ``_ABLATE = "general"``.  ``GENERAL_ROW`` is a 4096^2 plan with
    the class's shortest spans (8-9 rows, the chunk-centric kernel's least
    chunk height), not uniform, which the port gives to this kernel."""
    rng = np.random.default_rng(7)
    swept = 0
    for _ in range(300):
        h_out = int(rng.integers(2, 512))
        w_out = int(rng.integers(2, 512))
        rp = ref_plan.ScalePlan(4096, 4096, w_out, h_out, 0, 0, False)
        if pallas_deep.applicable(rp) and not pallas_deep._uniform_deep(rp):
            assert pallas_deep._chunk_centric(rp) is not None, (w_out, h_out)
            swept += 1
    assert swept > 100
    rp = ref_plan.ScalePlan(*GENERAL_ROW)
    assert pallas_deep.applicable(rp) and not pallas_deep._uniform_deep(rp)
    assert pallas_deep._chunk_centric(rp) == (8, 512)
    built = []
    for name in ("_built", "_built_chunked", "_built_general"):
        monkeypatch.setattr(pallas_deep, name,
                            lambda plan, batch, name=name: built.append(name) or (lambda x: x))
    imgs = np.zeros((1, 4096, 4096, 4), dtype=np.uint8)
    pallas_deep.scale_fn(rp, imgs)
    monkeypatch.setattr(pallas_deep, "_ABLATE", "general")
    pallas_deep.scale_fn(rp, imgs)
    assert built == ["_built_chunked", "_built_general"]
    plan = ScalePlan(*GENERAL_ROW)
    assert [k for k in torch_ops.WHOLE_KERNELS if k.applicable(plan)] == [deep]


@pytest.mark.parametrize(
    "key",
    [
        (2000, 400, 1, 20, 0, 0, False),     # one output column, past 255:1
        (256, 256, 100, 100, 4, 4, False),   # PREMUL16, bilinear
        (4096, 512, 16, 500, 0, 0, False),   # 128bpp box x bilinear
        (256, 256, 100, 100, 0, 0, True),    # linear, bilinear
    ],
    ids=_id,
)
def test_beside_the_class_runs_on_bilinear128(key):
    """128bpp plans outside this class (a bilinear axis, or a box axis with
    one output) go to the 128bpp kernel, which gives numpy_ref's bytes."""
    plan = ScalePlan(*key)
    assert not deep.applicable(plan) and bilinear128.applicable(plan)
    imgs = _images(key, sum(key), batch=1)
    got = stt.scale(plan, torch.from_numpy(imgs))
    assert np.array_equal(got.numpy(), _spec(key, imgs))


def test_wrapper_rejects_bad_input():
    plan = ScalePlan(2048, 1024, 8, 4, 0, 0)
    with pytest.raises(TypeError):
        deep.scale_fn(plan, torch.zeros((1024, 2048, 4), dtype=torch.int32))
    with pytest.raises(ValueError):
        deep.scale_fn(plan, torch.zeros((1024, 2048, 3), dtype=torch.uint8))
    with pytest.raises(ValueError, match="class"):
        deep.scale_fn(ScalePlan(256, 256, 100, 100, 0, 0),
                      torch.zeros((256, 256, 4), dtype=torch.uint8))
    with pytest.raises(ValueError, match="row range"):
        deep.scale_rows_fn(plan, torch.zeros((1024, 2048, 4), dtype=torch.uint8), 3, 2)
    # a device with no kernel raises instead of falling back
    with pytest.raises(ValueError, match="device"):
        deep.scale_fn(plan, torch.zeros((1024, 2048, 4), dtype=torch.uint8, device="meta"))


def test_single_image_shape():
    key = (1198, 475, 13, 2, 0, 9, True)
    imgs = _images(key, 6, batch=1)
    got = deep.scale_fn(ScalePlan(*key), torch.from_numpy(imgs[0]))
    assert tuple(got.shape) == (2, 13, 3)
    assert np.array_equal(got.numpy(), _spec(key, imgs)[0])


def test_kernel_params_follow_plan():
    p = deep._params(ScalePlan(4096, 4096, 16, 16, 0, 0), 8, 0, 16)
    assert (p.batch, p.row0, p.n_rows, p.mode, p.warps) == (8, 0, 16, deep.P8_COMPRESSED, 16)
    assert (p.work_mask, p.out_mask) == (0xFFFFFF, 0xFFFF)              # 256:1 is 128bpp
    q = deep._params(ScalePlan(1024, 1024, 8, 8, 9, 4, True), 2, 3, 4)   # BGR24 linear
    assert (q.mode, q.row0, q.n_rows, q.nb_in, q.alpha_ch, q.unassoc_out) == (
        deep.P8_LINEAR, 3, 4, 3, 3, 1)
    assert deep._params(ScalePlan(2048, 2048, 8, 8, 4, 4, True), 1, 0, 8).mode == deep.P16_LINEAR
    assert deep._params(ScalePlan(1024, 1024, 8, 8, 0, 0), 1, 0, 8).out_mask == 0xFF
    assert deep.warps(ScalePlan(258, 20, 2, 2, 0, 0)) == 11                  # 10 rows + 1 edge
    direct = ScalePlan(1024, 1024, 8, 8, 8, 8, True)
    assert direct.pack24_linear_direct and deep._params(direct, 1, 0, 8).pack24_direct == 1


def test_lut_table_layout():
    t = pixels.lut_table(torch.device("cpu")).numpy()
    assert len(t) == 256 * 5 + 2048
    ofs = 0
    for name in pixels.LUT_NAMES:
        want = getattr(stt.luts, name)
        assert np.array_equal(t[ofs : ofs + len(want)], want), name
        ofs += len(want)


def _smoke():
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_plans_are_held_here():
    """chip_smoke.py holds the kernel against the plain version on the card;
    every plan and row range it checks is held against numpy_ref by a test
    of this file, and its suite rows are the deep class."""
    mod = _smoke()
    assert set(mod.DEEP_CHECK_PLANS) <= set(COMPRESSED + LINEAR + RGB24 + WIDE + SHORT)
    assert set(mod.DEEP_CHECK_ROWS) == set(ROWS)
    assert mod.DEEP_CONST_PLAN in WIDE
    for _, key, _ in mod.DEEP_ROWS:
        plan = stt.ScalePlan(*key)
        assert deep.applicable(plan)
        assert not bilinear.applicable(plan) and not box.applicable(plan)
