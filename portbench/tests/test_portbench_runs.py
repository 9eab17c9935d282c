"""Whole runs of the harness on the CPU at small sizes, past its look for a
card: sound runs come out correct; the control (the reference in float32)
and the faults the cells can have (an answer altered where it is produced,
half of a batch left out) come out not correct.  Then what a run loads:
nothing of JAX or the JAX package, and the reference nothing of the port."""

import subprocess
import sys
import time

import pytest
import torch

import smolscale_tpu_torch as stt
from portbench import control, entries, harness, spec
from portbench.run import FORBIDDEN
from smolscale_tpu_torch import pyramid as farm
from smolscale_tpu_torch.backends import torch_ops
from smolscale_tpu_torch.ops import pyramid as pyramid_op

FRAMES = {"frames": {"width": 64, "height": 36, "scales": {"from": 0.01, "to": 2.0, "steps": 6},
                     "pixel_types": [[0, 0], [8, 4]], "with_srgb": False}}
FLEET = {"fleet": {"images": 40, "templates": 4, "sizes": [4, 8, 16], "with_srgb": False,
                   "groups": [{"share": 0.30, "size": [32, 32], "pixel_type": 0},
                              {"share": 0.20, "size": [32, 32], "pixel_type": 4},
                              {"share": 0.15, "size": [32, 32], "pixel_type": 1},
                              {"share": 0.20, "size": [32, 32], "pixel_type": 8},
                              {"share": 0.15, "size": [24, 24], "pixel_type": 0}]}}
# the three cells' entries, at sizes a test can hold (the fleet's sub-batches
# capped so that groups are cut and padded)
CELLS = {
    "sweep-b2": ({"entry": "scale", "batch": 2, "resident_frames": 4, "check_requests": 3}, FRAMES),
    "sweep-b1": ({"entry": "scale", "batch": 1, "single_image": True, "resident_frames": 4,
                  "check_requests": 3}, FRAMES),
    "farm-resident": ({"entry": "pyramid_sweep", "max_batch_bytes": 20480, "check_requests": 2},
                      FLEET),
}
METRICS = [m["name"] for m in spec.benchmark()["end_to_end"]]


def run(cell, program=stt, traced=False, device="cpu", seed=3_123_456_789, seconds=0.3):
    workload, config = CELLS[cell]
    names = METRICS + ([m["name"] for m in spec.benchmark()["per_layer"]] if traced else [])
    return harness.run(cell, workload, config, names, seed, seconds, traced,
                       torch.device(device), program, time.perf_counter())


def _alter_byte(out):
    out = out.clone()
    out.view(-1)[out.numel() // 2] ^= 1
    return out


def _alter_each_image(out):
    out = out.clone()
    flat = out.view(out.shape[0] if out.dim() == 4 else 1, -1)
    flat[:, flat.shape[1] // 2] ^= 1
    return out


def _half_batch(out):
    """The first half of the batch computed, the rest never written."""
    if out.dim() < 4 or out.shape[0] < 2:
        return torch.zeros_like(out)
    out = out.clone()
    out[out.shape[0] // 2 :] = 0
    return out


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    res = run(cell)
    assert res["correct"], res["checks"]
    assert res["checks"]["images_compared"]["value"] >= 1
    assert set(res["metrics"]) == set(METRICS)
    assert list(res)[-1] == "checks"
    parts = res["setup_parts"]
    assert list(parts) == ["imports", "device", "library", "inputs", "warm", "rehearse"]
    assert sum(parts.values()) == pytest.approx(res["metrics"]["setup_s"]["value"], abs=0.05)


@pytest.mark.parametrize("seed", [11, 12, 13, 14])
def test_a_fault_in_one_plan_is_caught_on_every_seed(seed, monkeypatch):
    """A sweep keeps one image of every plan's first request: a fault in
    the smallest plan alone fails every seed."""
    impl = torch_ops._scale_fn_impl
    monkeypatch.setattr(torch_ops, "_scale_fn_impl", lambda p, x: (
        _alter_each_image(impl(p, x)) if p.width_out == 43 else impl(p, x)))
    frames = {"frames": {**FRAMES["frames"], "scales": {"from": 0.01, "to": 2.0, "steps": 3},
                         "pixel_types": [[0, 0]]}}  # plans to 43x24, 85x48, 128x72
    workload = {**CELLS["sweep-b2"][0], "check_requests": 1}
    res = harness.run("sweep-b2", workload, frames, METRICS, seed, 1.5, False,
                      torch.device("cpu"), stt, time.perf_counter())
    assert not res["correct"], res["checks"]


def test_the_untraced_stretch_takes_whole_passes():
    class Fake:
        pass_requests = 3

        def __init__(self, fail_at=None):
            self.calls, self.fail_at = [], fail_at

        def call(self, i):
            if i == self.fail_at:
                raise RuntimeError("launch failed")
            self.calls.append(i)

        def ready(self, outs):
            pass

    fake = Fake()
    assert len(harness._stretch(fake, 5, 0.0)) == 3 and fake.calls == [5, 6, 7]
    assert len(harness._stretch(Fake(fail_at=6), 5, 0.0)) == 1


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_is_correct(cell):
    res = run(cell, traced=True)
    assert res["correct"] and "breakdown" in res
    # no card: the device's metrics find nothing to read, and are left out
    assert "device_idle_pct" not in res["metrics"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    res = run(cell, program=control)
    assert not res["correct"]
    assert res["checks"]["max_byte_diff"]["value"] >= 1


@pytest.mark.parametrize("fault", [_alter_byte, _half_batch], ids=["altered", "half_batch"])
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(cell, fault, monkeypatch):
    scale_impl, fused = torch_ops._scale_fn_impl, pyramid_op.pyramid_fn
    monkeypatch.setattr(torch_ops, "_scale_fn_impl", lambda p, x: fault(scale_impl(p, x)))
    monkeypatch.setattr(pyramid_op, "pyramid_fn",
                        lambda plans, x: tuple(fault(o) for o in fused(plans, x)))
    assert farm.pyramid_op is pyramid_op
    res = run(cell)
    assert not res["correct"], res["checks"]


def test_a_request_that_raises_fails_the_run(monkeypatch):
    """A raise before the window ends the run with no result; one in the
    window fails each request it hits."""
    impl, rehearse, armed = torch_ops._scale_fn_impl, entries.Frames.rehearse, []

    def flaky(p, x):
        if armed:
            raise RuntimeError("kernel launch failed")
        return impl(p, x)

    def arm_after(self, keep):
        rehearse(self, keep)
        armed.append(True)

    monkeypatch.setattr(torch_ops, "_scale_fn_impl", flaky)
    monkeypatch.setattr(entries.Frames, "rehearse", arm_after)
    res = run("sweep-b2")
    assert not res["correct"] and res["failed"] == res["attempted"] > 0
    with pytest.raises(RuntimeError):
        run("sweep-b2")


def _loaded_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print(' '.join(sorted({n.split('.')[0] for n in sys.modules})))"],
                         capture_output=True, text=True, check=True, cwd=spec.ROOT)
    return set(out.stdout.split())


def test_a_run_loads_no_jax():
    code = (
        "import time, torch\nimport portbench.run\nfrom portbench import harness, control\n"
        "import smolscale_tpu_torch as stt\n"
        f"FR = {FRAMES!r}\nFL = {FLEET!r}\n"
        "for w, c in [({'entry': 'scale', 'batch': 1, 'single_image': True, "
        "'resident_frames': 1, 'check_requests': 1}, FR), ({'entry': 'pyramid_sweep', "
        "'max_batch_bytes': None, 'check_requests': 1}, FL)]:\n"
        "    for prog in (stt, control):\n"
        "        harness.run('x', w, c, ['mpix_per_s'], 1, 0.05, True, torch.device('cpu'), prog, "
        "time.perf_counter(), log=open('/dev/null', 'w'))\n")
    loaded = _loaded_after(code)
    assert "smolscale_tpu_torch" in loaded
    assert not loaded & set(FORBIDDEN)


def test_reference_loads_nothing_of_the_port():
    loaded = _loaded_after("import portbench.reference.scale, portbench.control")
    assert not loaded & {"smolscale_tpu_torch", *FORBIDDEN}


def test_forbidden_names_are_compared_whole():
    from portbench.run import forbidden_modules

    assert forbidden_modules(["smolscale_tpu_torch", "smolscale_tpu_torch.ops", "jaxtyping"]) == []
    assert forbidden_modules(["smolscale_tpu.plan", "jax.numpy", "flax"]) == \
        ["flax", "jax", "smolscale_tpu"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_small_runs_on_the_card(cell, card):
    assert run(cell, device=card)["correct"]
    assert run(cell, device=card, traced=True)["metrics"].get("device_idle_pct") is not None
    assert not run(cell, program=control, device=card)["correct"]
