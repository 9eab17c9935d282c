"""The benchmark's plain reference against the specification it was
translated from (``smolscale_tpu/backends/numpy_ref.py``, numpy only) and
against the port's plain versions, on random plans over the size x format x
sRGB grid; and its control, which has to differ."""

import random

import numpy as np
import pytest
import torch

from portbench.reference import scale as ref
from portbench.reference.plan import ScalePlan


def _plans(n, seed):
    r = random.Random(seed)
    out = []
    for _ in range(n):
        wi, hi = r.randint(1, 300), r.randint(1, 300)
        wo = r.choice([r.randint(1, 40), r.randint(1, 600), wi])
        ho = r.choice([r.randint(1, 40), r.randint(1, 600), hi])
        out.append((wi, hi, wo, ho, r.randint(0, 9), r.randint(0, 9), r.random() < 0.4))
    # the cells' own shapes, cut down: 5b's levels, the sweep's extremes
    out += [(64, 64, s, s, pt, pt, False) for s in (8, 16, 32) for pt in (0, 1, 4, 8)]
    out += [(48, 48, s, s, 0, 0, False) for s in (8, 16, 32)]
    out += [(384, 216, 3, 2, 0, 0, False), (384, 216, 768, 432, 0, 0, False)]
    return out


def _img(plan_args, rng, batch=2):
    nb = 3 if plan_args[4] >= 8 else 4
    return rng.integers(0, 256, (batch, plan_args[1], plan_args[0], nb), dtype=np.uint8)


@pytest.mark.parametrize("chunk", range(4))
def test_reference_equals_numpy_spec(chunk):
    from smolscale_tpu.backends import numpy_ref
    from smolscale_tpu.plan import ScalePlan as SpecPlan

    rng = np.random.default_rng(chunk)
    for args in _plans(40, chunk):
        img = _img(args, rng)
        want = np.stack([numpy_ref.scale(SpecPlan(*args), im) for im in img])
        got = ref.scale(ScalePlan(*args), torch.from_numpy(img)).numpy()
        assert np.array_equal(want, got), args


@pytest.mark.parametrize("chunk", range(2))
def test_reference_equals_port_plain_versions(chunk):
    import smolscale_tpu_torch as stt

    rng = np.random.default_rng(10 + chunk)
    for args in _plans(30, 10 + chunk):
        img = torch.from_numpy(_img(args, rng))
        want = stt.scale(stt.ScalePlan(*args), img, device="cpu")
        assert torch.equal(ref.scale(ScalePlan(*args), img), want), args


def test_control_differs_on_every_filtering_plan():
    rng = np.random.default_rng(5)
    differ = 0
    for args in _plans(40, 5):
        plan = ScalePlan(*args)
        img = torch.from_numpy(_img(args, rng, batch=4))
        same = torch.equal(ref.scale(plan, img), ref.scale(plan, img, exact=False))
        differ += not same
    assert differ >= 30


def test_reference_rejects_a_wrong_shape():
    with pytest.raises(ValueError):
        ref.scale(ScalePlan(8, 8, 4, 4, 0, 0), torch.zeros((8, 9, 4), dtype=torch.uint8))
