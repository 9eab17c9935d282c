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
    (1000, 900, 9, 10, 4, 0, True),     # ragged PREMUL8 linear, unassociated in
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
    (1000, 900, 9, 10, 8, 8, False),    # ragged RGB24 (chip_smoke.py's DEEP_UNALIGNED)
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
# csrc/deep.cu's mapping on its edges (chip_smoke.py): covers of 16/17,
# 32/33, 64/65 and 128/129 words, column warps and blocks, split rows; spans
# of 25 and 129 pixels and of 516 bytes; ragged spans at every start mod 16;
# 3-byte pixels in and out at each mode the planner gives them
EDGES = [
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
    (250, 90, 10, 9, 0, 0, False),
    (1290, 300, 10, 30, 0, 0, False),
    (1720, 200, 10, 20, 8, 8, False),
    (1001, 90, 7, 9, 8, 8, False),
    (1001, 90, 7, 9, 0, 0, False),
    (2060, 100, 2, 10, 8, 8, True),
    (999, 333, 11, 3, 8, 8, False),
    (999, 333, 11, 3, 9, 9, True),
    (999, 333, 11, 3, 0, 8, True),
    (999, 333, 11, 3, 8, 0, True),
]
# a batch of more than 65535 images (chip_smoke.py's DEEP_TALL)
TALL = [(20, 20, 2, 2, 0, 0, False)]
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


@pytest.mark.parametrize("key", COMPRESSED + LINEAR + RGB24 + WIDE + SHORT + EDGES + TALL, ids=_id)
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
    """Whole images: box, bilinear, then this kernel, but box x box past
    64:1 with 4-byte input and an x axis past 64:1 to this kernel first;
    rows: bilinear, then this kernel."""
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
    stt.scale(ScalePlan(2048, 2048, 16, 16, 0, 0), img)     # integer 128:1 box: deep first
    stt.scale(ScalePlan(2048, 2048, 32, 32, 0, 0), img)     # integer 64:1 box
    stt.scale_rows(ScalePlan(2048, 2048, 128, 128, 0, 0), img, 0, 1)
    stt.scale_rows(ScalePlan(2048, 2048, 8, 8, 0, 0), img, 0, 1)
    assert calls == ["bilinear", "box", "deep", "deep", "deep", "box", "bilinear rows",
                     "deep rows"]
    # box x box past 64:1 is in the box kernel's class too; the deep box
    # kernel takes it first where its x spans are deep and its input pixels
    # 4 bytes (PERF.md: 4096^2 -> 32^2 and -> 32 x 256 run faster there),
    # the box kernel RGB24 and a narrow x box beside a deep y box
    assert box.applicable(ScalePlan(2048, 2048, 16, 16, 0, 0))
    for key, kernel in [
        ((2048, 2048, 16, 16, 0, 0), deep),     # 128:1 x 128:1
        ((2048, 2048, 16, 16, 0, 8), deep),     # 4 bytes in, 3 out
        ((2048, 2048, 16, 128, 0, 0), deep),    # 128:1 x 16:1
        ((2048, 2048, 16, 16, 8, 8), box),      # RGB24
        ((2048, 2048, 16, 16, 8, 0), box),      # 3 bytes in, 4 out
        ((2048, 2048, 128, 16, 0, 0), box),     # 16:1 x 128:1
        ((3840, 4096, 384, 32, 0, 0), box),     # 10:1 x 128:1
        ((2048, 2048, 16, 16, 4, 4), deep),     # PREMUL16: the box kernel's class holds none
    ]:
        plan = ScalePlan(*key)
        assert box.applicable(plan) == (plan.internal_alpha == AlphaType.PREMUL8), key
        assert torch_ops.whole_kernel(plan) is kernel, key


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
    assert (p.batch, p.row0, p.n_rows, p.mode) == (8, 0, 16, deep.P8_COMPRESSED)
    assert (p.work_mask, p.out_mask) == (0xFFFFFF, 0xFFFF)              # 256:1 is 128bpp
    # row 7b: 64 words per span row, 16 lanes of 4 words, 2 columns per
    # warp, 8 split warps of 33 rows of the 257
    assert (p.form, p.lanes, p.units, p.cw, p.chunks) == (deep.PACKED, 16, 4, 2, 1)
    assert (p.wc, p.splits, p.rows_per_split) == (1, 8, 33)
    assert (p.grid_x, p.grid_y, p.grid_z) == (8, 16, 8)
    q = deep._params(ScalePlan(1024, 1024, 8, 8, 9, 4, True), 2, 3, 4)   # BGR24 linear
    assert (q.mode, q.row0, q.n_rows, q.nb_in, q.alpha_ch, q.unassoc_out) == (
        deep.P8_LINEAR, 3, 4, 3, 3, 1)
    assert (q.form, q.lanes, q.units, q.splits, q.grid_y, q.grid_z) == (deep.RGB, 8, 3, 8, 4, 2)
    assert deep._params(ScalePlan(2048, 2048, 8, 8, 4, 4, True), 1, 0, 8).mode == deep.P16_LINEAR
    assert deep._params(ScalePlan(1024, 1024, 8, 8, 0, 0), 1, 0, 8).out_mask == 0xFF
    assert deep._params(ScalePlan(1024, 1024, 8, 8, 0, 0), 1, 0, 8, address=2).form == deep.SHIFTED
    assert deep.span_rows(ScalePlan(258, 20, 2, 2, 0, 0)) == 11             # 10 rows + 1 edge
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
    held = set(COMPRESSED + LINEAR + RGB24 + WIDE + SHORT + EDGES)
    assert set(mod.DEEP_CHECK_PLANS) <= held and set(EDGES) <= set(mod.DEEP_CHECK_PLANS)
    assert set(mod.DEEP_UNALIGNED) <= held and mod.DEEP_TALL[0] in TALL
    assert set(mod.DEEP_OFFSETS) == {1, 2, 3, 4, 8} and mod.DEEP_TALL[1] > 65535
    assert set(mod.DEEP_CHECK_ROWS) == set(ROWS)
    assert mod.DEEP_CONST_PLAN in WIDE
    for _, key, _ in mod.DEEP_ROWS:
        plan = stt.ScalePlan(*key)
        assert deep.applicable(plan)
        assert not bilinear.applicable(plan) and not box.applicable(plan)


def _launch_cases():
    """(plan key, batch, output rows per launch or None, input byte address):
    chip_smoke.py's deep check plans at its batch of 2, its unaligned inputs
    at each offset, its tall batch, and every timed deep row: the suite's
    deep rows, row 9 by chunks, the plan of TPU kernel #7 and box-deep."""
    smoke = _smoke()
    cases = [(k, 2, None, 0) for k in smoke.DEEP_CHECK_PLANS]
    cases += [(k, 2, None, off) for k in smoke.DEEP_UNALIGNED for off in smoke.DEEP_OFFSETS]
    cases.append((smoke.DEEP_TALL[0], smoke.DEEP_TALL[1], None, 0))
    cases += [(key, batch, None, 0) for _, key, batch in smoke.DEEP_ROWS]
    key9 = dict((r[0], r[1]) for r in smoke.DEEP_ROWS)[smoke.DEEP_STREAM_ROW]
    step = -(-ScalePlan(*key9).height_out // smoke.DEEP_STREAM_CHUNKS)
    cases.append((key9, 8, step, 0))
    cases += [(r[1], r[2], None, 0) for r in smoke.A1_ROWS + smoke.EXTRA_ROWS if r[3] == "deep"]
    return cases


def _case_id(case):
    key, batch, n, address = case
    return f"{_id(key)}-b{batch}-n{n}-at{address}"


@pytest.mark.parametrize("case", _launch_cases(), ids=_case_id)
def test_launch_shape_covers_every_pixel_once(case):
    """Walks csrc/deep.cu's loops as ops/deep.launch_shape lays them out, in
    plain Python: every output pixel is stored once (columns by block x,
    column warp and lane group; rows and images by the grid-stride loops on
    y and z, both grids below 2^16), the split warps' row ranges tile each V
    span's rows once, and in every input row skew the lanes' aligned 16-byte
    words (g + lanes * (units * chunk + w)) cover each span's mid range once,
    their masks keeping exactly its pixels (4-byte) or bytes (3-byte), with
    the word phases of the 3-byte reader and the extra word of the SHIFTED
    one where a kept pixel needs it."""
    key, batch, n_rows, address = case
    plan = ScalePlan(*key)
    assert deep.applicable(plan)
    nb = plan.meta_in.n_bytes
    w_out, h_out = plan.width_out, plan.height_out
    n = h_out if n_rows is None else n_rows
    sh = deep.launch_shape(plan, batch, n, address)
    lanes, units, cw, chunks = sh["lanes"], sh["units"], sh["cw"], sh["chunks"]
    wc, splits, rps = sh["wc"], sh["splits"], sh["rows_per_split"]
    assert sh["grid_y"] < 2**16 and sh["grid_z"] < 2**16 and sh["grid_x"] < 2**31
    assert wc * splits <= pixels.MAX_WARPS and lanes * cw == 32 and 4 <= lanes <= 32
    assert 1 <= units <= deep.MAX_UNITS
    kind = deep.form(plan, address)
    assert (kind == deep.RGB) == (nb == 3)
    assert nb == 3 or (kind == deep.PACKED) == (address % 4 == 0)
    # columns: block x, column warp, lane group
    cols = np.zeros(w_out, int)
    for bx in range(sh["grid_x"]):
        for wcol in range(wc):
            for grp in range(cw):
                j = (bx * wc + wcol) * cw + grp
                if j < w_out:
                    cols[j] += 1
    assert (cols == 1).all()
    # output rows and images: grid-stride loops on y and z
    for count, grid in ((n, sh["grid_y"]), (batch, sh["grid_z"])):
        seen = np.zeros(count, int)
        for start in range(grid):
            seen[start::grid] += 1
        assert (seen == 1).all()
    tx, ty = (t.reshape(6, -1).astype(np.int64) for t in deep.tables(plan))
    # the split warps' input rows of each V span
    for i in range(h_out):
        first, mid, mid_len, last = ty[0][i], ty[2][i], ty[3][i], ty[4][i]
        r_end = max(last + 1, mid + mid_len)
        seen = np.zeros(r_end - first, int)
        for s in range(splits):
            t0 = s * rps
            seen[t0 : min(t0 + rps, r_end - first)] += 1
        assert (seen == 1).all()
    # each span's words in each row skew, and what their masks keep
    for skew in deep.row_skews(plan, address):
        for j in range(w_out):
            mid, mid_end = tx[2][j], tx[2][j] + tx[3][j]
            lo, hi = skew + mid * nb, skew + mid_end * nb
            u0, u_end = lo >> 4, (hi + 15) >> 4
            got = sorted(u for c in range(chunks) for w in range(units) for g in range(lanes)
                         if (u := u0 + g + lanes * (units * c + w)) < u_end)
            assert got == list(range(u0, u_end))
            if nb == 4:
                s4 = skew & 3
                kept = [(16 * u + 4 * k + s4 - skew) // 4 for u in got for k in range(4)
                        if lo <= 16 * u + 4 * k + s4 < hi]
                assert kept == list(range(mid, mid_end))
                for u in got:  # a kept pixel reaching into the next word has it read
                    if s4 and lo <= 16 * u + 12 + s4 < hi:
                        assert 16 * u + 16 < hi
            else:
                kept = [16 * u + b for u in got for b in range(16) if lo <= 16 * u + b < hi]
                assert kept == list(range(lo, hi))
                for u in got:  # word k's first byte is channel (phase + k) mod 3
                    ph = (16 * u - skew + 48) % 3
                    assert all((ph + k) % 3 == (16 * u + 4 * k - skew) % 3 for k in range(4))
