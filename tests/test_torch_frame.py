"""The launch frame the five kernel wrappers share (``ops/_kernel.py``), on
the CPU: each public function's device rule and byte counter, and the
launch-shape constants the wrappers share against the kernels' sources.
The launch itself (spans, ``launches``) is held on the card by
``tests/test_torch_cuda.py::test_wrapper_spans_on_the_card``."""

from __future__ import annotations

import importlib
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from smolscale_tpu_torch.ops import _kernel, bilinear, bilinear128, box, deep, pixels, pyramid
from smolscale_tpu_torch.plan import ScalePlan
from smolscale_tpu_torch.utils import timing

OPS = Path(_kernel.__file__).resolve().parent
CSRC = OPS.parent / "csrc"

# a plan of each kernel class (pyramid: a level set), its public function and
# the kernel's name in errors
CASES = {
    box: ((256, 128, 16, 8, 0, 0), box.scale_fn, "box"),
    bilinear: ((300, 200, 290, 190, 0, 0), bilinear.scale_fn, "bilinear"),
    deep: ((520, 260, 4, 2, 0, 0), deep.scale_fn, "deep box"),
    bilinear128: ((256, 256, 32, 32, 4, 4, True), bilinear128.scale_fn, "128bpp"),
    pyramid: ([(256, 256, s, s, 0, 0) for s in (32, 64)], pyramid.pyramid_fn, "pyramid"),
}
MODULES = list(CASES)


def _case(module):
    key, fn, name = CASES[module]
    if module is pyramid:
        plan = [ScalePlan(*k) for k in key]
        shape = (key[0][1], key[0][0], plan[0].meta_in.n_bytes)
    else:
        plan = ScalePlan(*key)
        shape = (key[1], key[0], plan.meta_in.n_bytes)
    imgs = torch.randint(0, 256, (2, *shape), dtype=torch.uint8,
                         generator=torch.Generator().manual_seed(7))
    return plan, imgs, fn, name


def _name(module) -> str:
    return module.__name__.rsplit(".", 1)[1]


@pytest.mark.parametrize("module", MODULES, ids=_name)
def test_no_kernel_for_other_devices(module):
    plan, imgs, fn, name = _case(module)
    before = module.launches
    with pytest.raises(ValueError, match=f"no {name} kernel for device meta"):
        fn(plan, imgs.to("meta"))
    assert module.launches == before


@pytest.mark.parametrize("module", MODULES, ids=_name)
def test_cpu_runs_the_plain_version_and_counts_bytes(module):
    """A CPU tensor runs the plain version, launches nothing and, under a
    profiler, counts the bytes handed in and returned under the module's
    name; with no profiler it counts nothing."""
    plan, imgs, fn, _ = _case(module)
    refs = {box: box.box_scale_ref, bilinear: bilinear.bilinear_scale_ref,
            deep: deep.deep_scale_ref, bilinear128: bilinear128.bilinear128_scale_ref,
            pyramid: pyramid.pyramid_scale_ref}
    want = refs[module](plan, imgs)
    want = want if isinstance(want, tuple) else (want,)
    before, launched = timing.counter_totals(), module.launches
    got = fn(plan, imgs)
    assert timing.counter_totals() == before
    with profile(activities=[ProfilerActivity.CPU]):
        again = fn(plan, imgs[0])
    assert module.launches == launched
    got = got if isinstance(got, tuple) else (got,)
    again = again if isinstance(again, tuple) else (again,)
    assert len(got) == len(want) == len(again)
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, w) and torch.equal(a, w[0])
    added = timing.counter_totals()[_name(module)] - before.get(_name(module), 0)
    assert added == imgs[0].numel() + sum(w[0].numel() for w in want)


def test_only_the_kernel_modules_count_launches():
    """``portbench`` sums every int ``launches`` of ``ops.*``: the five
    kernel modules hold one each, beside their frame, and no other module
    under ``ops/`` does; no wrapper keeps a loader or launch of its own."""
    for path in sorted(OPS.glob("*.py")):
        mod = importlib.import_module(f"smolscale_tpu_torch.ops.{path.stem}")
        counts = isinstance(getattr(mod, "launches", None), int)
        assert counts == (mod in CASES), path.name
        if mod in CASES:
            assert isinstance(mod.KERNEL, _kernel.Kernel)
            assert not hasattr(mod, "_entry") and not hasattr(mod, "_launch")


@pytest.mark.parametrize("source,name,value", [
    ("box.cu", "kMaxWarps", pixels.MAX_WARPS),
    ("deep.cu", "kMaxWarps", pixels.MAX_WARPS),
    ("bilinear128.cu", "kThreads", bilinear.THREADS),
])
def test_shared_launch_constants_match_kernels(source, name, value):
    """The launch-shape constants the wrappers share are each kernel's."""
    assert f"constexpr int {name} = {value};" in (CSRC / source).read_text()
