"""The port's split over a device list (smolscale_tpu_torch.parallel, the
farm's ``mesh``) against the JAX package's ``parallel`` (JAX on the CPU,
the 8 virtual devices of conftest) and numpy_ref.

The port's meshes here list the CPU 1-16 times: the split logic (slices,
row ranges, gathering in order) is the same on a list of cards, where
tests/test_torch_cuda.py and chip_smoke.py run it.  All arithmetic is
integer: the tolerance is byte equality.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from smolscale_tpu import parallel as jax_parallel
from smolscale_tpu import pyramid as jax_pyramid
from smolscale_tpu.backends import numpy_ref
from smolscale_tpu.plan import ScalePlan as RefPlan
from smolscale_tpu_torch import make_pyramid_fn, parallel, scale_pyramid_mixed
from smolscale_tpu_torch.plan import ScalePlan

# tests/test_parallel.py:19-27
ROW_PLANS = [
    (40, 37, 30, 29, 0, 0, False),   # bilinear 0h V
    (50, 100, 10, 11, 4, 4, False),  # box V, premul16
    (64, 64, 16, 16, 0, 0, False),   # bilinear 1h V
    (33, 64, 9, 64, 0, 8, True),     # copy V, srgb, 24bpp out
    (20, 1, 10, 7, 0, 0, False),     # one V
    (64, 2000, 16, 7, 0, 0, False),  # deep box V (>255:1)
]
# tests/test_parallel.py:66-86 (uneven over 8 shards), and h_out 3 over 4
UNEVEN = [
    ((40, 80, 20, 9, 0, 0, False), 8),
    ((64, 300, 16, 13, 0, 1, False), 8),
    ((48, 48, 24, 30, 4, 4, False), 8),
    ((64, 300, 16, 3, 0, 0, False), 4),
]


def _random(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _cpu_mesh(n, names=("rows",)):
    return parallel.default_mesh(names, devices=["cpu"] * n)


def _jax_mesh(n, names=("rows",)):
    return jax_parallel.default_mesh(names, devices=jax.devices("cpu")[:n])


def _spec(key, imgs):
    plan = RefPlan(*key)
    if imgs.ndim == 3:
        return numpy_ref.scale(plan, imgs)
    return np.stack([numpy_ref.scale(plan, im) for im in imgs])


@pytest.mark.parametrize("key", ROW_PLANS, ids=lambda k: "-".join(map(str, k)))
def test_row_split_matches_jax_and_spec(key):
    img = _random((key[1], key[0], 3 if key[4] >= 8 else 4), sum(key[:4]))
    want = _spec(key, img)
    assert np.array_equal(
        np.asarray(jax_parallel.make_row_sharded_scale(RefPlan(*key), _jax_mesh(4))(img)), want)
    for n in (1, 2, 3, 4):
        got = parallel.make_row_sharded_scale(ScalePlan(*key), _cpu_mesh(n))(img)
        assert got.dtype == torch.uint8 and np.array_equal(got.numpy(), want), n


@pytest.mark.parametrize("key,n", UNEVEN, ids=lambda v: "-".join(map(str, v)) if isinstance(v, tuple) else str(v))
def test_row_split_uneven(key, n):
    """Output rows not divisible by the shard count, and fewer rows than
    shards' worth (h_out 3 over 4: one row per shard, the last has none)."""
    assert key[3] % n
    img = _random((key[1], key[0], 4), key[3])
    want = _spec(key, img)
    assert np.array_equal(
        np.asarray(jax_parallel.make_row_sharded_scale(RefPlan(*key), _jax_mesh(n))(img)), want)
    got = parallel.make_row_sharded_scale(ScalePlan(*key), _cpu_mesh(n))(img)
    assert np.array_equal(got.numpy(), want)


def test_row_ranges():
    assert parallel.sharding._row_ranges(9, 8) == [(0, 2), (2, 2), (4, 2), (6, 2), (8, 1)]
    assert parallel.sharding._row_ranges(3, 4) == [(0, 1), (1, 1), (2, 1)]
    assert parallel.sharding._row_ranges(30, 8) == [(4 * s, 4 if s < 7 else 2) for s in range(8)]


def test_row_split_of_a_batch():
    """A batch through the row split: each shard computes its rows of every
    image."""
    key = (40, 37, 30, 29, 4, 0, False)
    imgs = _random((3, 37, 40, 4), 3)
    got = parallel.make_row_sharded_scale(ScalePlan(*key), _cpu_mesh(4))(imgs)
    assert np.array_equal(got.numpy(), _spec(key, imgs))


@pytest.mark.parametrize("shape", [None, (4, 2), (2, 4)], ids=str)
def test_2d_step_matches_jax_and_spec(shape):
    """tests/test_parallel.py::test_2d_sharded_batch_step and
    test_2d_mesh_both_orientations."""
    key = (40, 37, 30, 29, 4, 0, False) if shape is None else (40, 74, 30, 29, 4, 0, False)
    names = ("dp", "rows")
    if shape is None:
        mesh, jmesh, batch = _cpu_mesh(4, names), _jax_mesh(4, names), 4
    else:
        mesh = parallel.DeviceMesh(np.array(["cpu"] * 8, dtype=object).reshape(shape), names)
        jmesh = Mesh(np.asarray(jax.devices("cpu")[:8]).reshape(shape), names)
        batch = 8
    assert mesh.shape == dict(jmesh.shape)
    imgs = _random((batch, key[1], key[0], 4), batch)
    want = _spec(key, imgs)
    assert np.array_equal(
        np.asarray(jax_parallel.make_sharded_batch_step(RefPlan(*key), jmesh)(imgs)), want)
    got = parallel.make_sharded_batch_step(ScalePlan(*key), mesh)(imgs)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_batched_dp_matches_jax_and_spec(n):
    """tests/test_parallel.py::test_batched_dp; a tensor input too."""
    key = (40, 37, 30, 29, 4, 0, False)
    imgs = _random((8, 37, 40, 4), 8)
    want = _spec(key, imgs)
    jmesh = _jax_mesh(n, ("dp",))
    assert np.array_equal(
        np.asarray(jax_parallel.make_batched_scale(RefPlan(*key), jmesh)(imgs)), want)
    fn = parallel.make_batched_scale(ScalePlan(*key), _cpu_mesh(n, ("dp",)))
    assert np.array_equal(fn(imgs).numpy(), want)
    assert np.array_equal(fn(torch.from_numpy(imgs)).numpy(), want)


def test_batch_not_divisible_raises():
    fn = parallel.make_batched_scale(ScalePlan(40, 37, 30, 29, 0, 0), _cpu_mesh(4, ("dp",)))
    with pytest.raises(ValueError, match="does not split"):
        fn(_random((6, 37, 40, 4), 1))
    with pytest.raises(ValueError, match="batch"):
        fn(_random((37, 40, 4), 1))
    step = parallel.make_sharded_batch_step(ScalePlan(40, 37, 30, 29, 0, 0),
                                            _cpu_mesh(4, ("dp", "rows")))
    with pytest.raises(ValueError, match="does not split"):
        step(_random((3, 37, 40, 4), 1))


def _factor(n):
    """sharding.py:38-44: the largest divisor of n up to sqrt(n) first."""
    return next((c, n // c) for c in range(int(np.sqrt(n)), 0, -1) if n % c == 0)


@pytest.mark.parametrize("names", [("dp", "rows"), ("rows", "dp")], ids="-".join)
def test_default_mesh_shapes(names):
    for n in range(1, 17):
        mesh = parallel.default_mesh(names, devices=["cpu"] * n)
        assert tuple(mesh.shape[a] for a in names) == _factor(n) == mesh.devices.shape
        if n <= 8:
            assert mesh.shape == dict(_jax_mesh(n, names).shape)
    assert {n: _factor(n) for n in (4, 6, 7, 8, 16)} == {
        4: (2, 2), 6: (2, 3), 7: (1, 7), 8: (2, 4), 16: (4, 4)}
    one = parallel.default_mesh(names[:1], devices=["cpu"] * 5)
    assert one.shape == {names[0]: 5} and all(d == torch.device("cpu") for d in one.devices)


def test_mesh_rules(monkeypatch):
    """No card: default_mesh raises rather than fall back to the CPU; a mesh
    holds one device type; its axes are named."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        parallel.default_mesh()
    with pytest.raises(ValueError, match="one type"):
        parallel.DeviceMesh(np.array(["cpu", "meta"], dtype=object), ("dp",))
    with pytest.raises(ValueError, match="does not fit"):
        parallel.DeviceMesh(np.array(["cpu"] * 4, dtype=object), ("dp", "rows"))
    with pytest.raises(ValueError, match="not 'rows'"):
        parallel.make_row_sharded_scale(ScalePlan(40, 37, 30, 29, 0, 0), _cpu_mesh(2, ("dp",)))


def test_mesh_along_picks_the_axes():
    devs = np.array([torch.device("cpu", 0)] * 6, dtype=object).reshape(2, 3)
    mesh = parallel.DeviceMesh(devs, ("dp", "rows"))
    assert mesh.along("rows").shape == (3,) and mesh.along("dp").shape == (2,)
    assert mesh.along("rows", "dp").shape == (3, 2)


@pytest.mark.parametrize("n", [8, 16])
def test_dryrun_multichip(n):
    """One fully split step over n entries (2 x 4 and 4 x 4), each flavour
    byte-equal to the unsplit scale; the JAX package's dry run on its four
    plans against numpy_ref is tests/test_parallel.py's."""
    parallel.dryrun_multichip(n, "cpu")
    mesh = parallel.default_mesh(("dp", "rows"), devices=["cpu"] * n)
    key = (64, 2000, 16, 7, 0, 0, False)
    img = _random((2000, 64, 4), n)
    rows = parallel.make_row_sharded_scale(ScalePlan(*key), _cpu_mesh(n))
    assert np.array_equal(rows(img).numpy(), _spec(key, img))
    step = parallel.make_sharded_batch_step(ScalePlan(48, 40, 24, 18, 4, 0, True), mesh)
    imgs = _random((2 * mesh.shape["dp"], 40, 48, 4), n + 1)
    assert np.array_equal(step(imgs).numpy(), _spec((48, 40, 24, 18, 4, 0, True), imgs))


def test_dryrun_multichip_needs_a_card_by_default(monkeypatch):
    """No card and no device: the dry run raises rather than run on the
    CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        parallel.dryrun_multichip(4)


def test_dryrun_multichip_fails_on_a_wrong_split(monkeypatch):
    """The dry run's check can fail: a row split that drops its last shard
    raises."""
    ranges = parallel.sharding._row_ranges
    monkeypatch.setattr(parallel.sharding, "_row_ranges", lambda h, n: ranges(h, n)[:-1])
    with pytest.raises((AssertionError, RuntimeError)):
        parallel.dryrun_multichip(4, "cpu")


@pytest.mark.parametrize("sizes", [(8, 16, 24), (16, 32)], ids=str)
def test_split_pyramid_matches_jax_and_spec(sizes):
    """tests/test_parallel.py::test_sharded_pyramid, and a set in the fused
    class (the pyramid kernel's plain version on each slice)."""
    imgs = _random((8, 64, 64, 4), len(sizes))
    jfn = jax_pyramid.make_pyramid_fn(64, 64, 0, sizes=sizes, mesh=_jax_mesh(8, ("dp",)))
    want = [np.asarray(o) for o in jfn(imgs)]
    for n in (1, 2, 4):
        got = make_pyramid_fn(64, 64, 0, sizes=sizes, mesh=_cpu_mesh(n, ("dp",)))(imgs)
        assert len(got) == len(sizes)
        for lvl, w, s in zip(got, want, sizes):
            assert np.array_equal(lvl.numpy(), w)
            assert np.array_equal(lvl[5].numpy(), _spec((64, 64, s, s, 0, 0, False), imgs[5]))


def test_split_pyramid_mixed_pads_and_orders():
    """scale_pyramid_mixed over a mesh: groups whose sizes do not divide by
    the axis are padded, results stay in input order and equal the unsplit
    run and the JAX farm's (whose groups must divide: 4 and 2 images over
    2 devices)."""
    rng = np.random.default_rng(9)
    images = [rng.integers(0, 256, (64, 64, 4), np.uint8) for _ in range(5)]
    images += [rng.integers(0, 256, (32, 48, 3), np.uint8) for _ in range(2)]
    types = [0, 0, 4, 0, 0, 8, 8]
    want = scale_pyramid_mixed(images, types, sizes=(8, 16), device="cpu")
    for n, cap in ((2, None), (3, None), (4, 3 * 64 * 64 * 4)):
        got = scale_pyramid_mixed(images, types, sizes=(8, 16), max_batch_bytes=cap,
                                  mesh=_cpu_mesh(n, ("dp",)))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert all(np.array_equal(a, b) for a, b in zip(g, w))
    even = [0, 1, 3, 4, 5, 6]
    jax_got = jax_pyramid.scale_pyramid_mixed(
        [images[i] for i in even], [types[i] for i in even], sizes=(8, 16),
        mesh=_jax_mesh(2, ("dp",)))
    for i, j in zip(even, jax_got):
        assert all(np.array_equal(a, np.asarray(b)) for a, b in zip(want[i], j))
