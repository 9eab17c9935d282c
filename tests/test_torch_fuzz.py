"""The port's differential fuzz (``smolscale_tpu_torch.fuzz``) on the CPU.

The fuzz itself runs on the card; here its generator is replayed: every
mode's draws land in the class the mode aims at, and the drawn plans,
batches and row ranges through the port's plain versions (``scale`` and
``scale_rows`` with ``device="cpu"``) equal ``numpy_ref`` of the JAX
package, as do the eight overflow-band plans of
``tests/test_fuzz_differential.py``.  The classifier is held to fake
kernels: one that flips a byte, raises, alternates, or skips an output
pixel that only the poisoned allocator exposes.  The tolerance is byte
equality.
"""

import dataclasses

import numpy as np
import pytest
import torch

import smolscale_tpu_torch as stt
from smolscale_tpu.backends import numpy_ref
from smolscale_tpu.plan import ScalePlan as RefPlan
from smolscale_tpu_torch import fuzz
from smolscale_tpu_torch.backends import torch_ops
from smolscale_tpu_torch.ops import bilinear, bilinear128, box, deep, pyramid
from smolscale_tpu_torch.plan import FilterType, ScalePlan
from test_fuzz_differential import _DEEP_CASES

DRAWS = 200


def _draws(mode, seed=7, n=DRAWS):
    rng = np.random.default_rng(seed)
    return [fuzz.draw(mode, rng, i) for i in range(n)]


def _in_class(mode, case):
    """Whether ``case`` lies in the class that ``mode`` aims at."""
    plans = case.plans()
    plan = plans[0]
    wi, hi, wo, ho = plan.key[:4]
    if mode == "uniform":
        return 16 <= wi < 1600 and 16 <= hi < 1200 and wo < max(2, 2 * wi)
    if mode == "edges":
        return (max(wi, hi, wo, ho) < 64 or (min(wi, hi) >= 512 and max(wo, ho) < 16)
                or (max(wi, hi) < 32 and min(wo, ho) >= 64))
    if mode == "mixed":
        trivial = (FilterType.COPY, FilterType.ONE)
        return plan.x.filter in trivial or plan.y.filter in trivial
    if mode == "up":
        return (plan.x.filter.is_bilinear and plan.y.filter.is_bilinear and wo >= wi
                and bilinear.applicable(plan))
    if mode == "box":
        return box.applicable(plan)
    if mode == "deep":
        return deep.applicable(plan)
    if mode == "staged":
        return (bilinear.applicable(plan) and plan.x.filter == FilterType.BOX
                and bilinear.stage_table(plan.x, plan.meta_in.n_bytes)[0] > 0)
    if mode == "s128":
        return bilinear128.applicable(plan)
    if mode == "pyramid":
        return 2 <= len(plans) <= 3 and pyramid.applicable(plans) and case.batch <= 8
    if mode == "tall":
        return (case.batch * ho > fuzz.GRID_ROWS
                and fuzz.KERNELS[case.target].applicable(plan))
    assert mode == "band"
    span = max(wi / wo, hi / ho)
    return plan.meta_in.n_bytes == 4 and plan.pixel_type_in >= 4 and span >= 4096


@pytest.mark.parametrize("mode", fuzz.MODES)
def test_draws_land_in_the_class(mode):
    """200 draws of each mode from a fixed seed lie in its class, fit the
    input cap, and carry a row range inside the first plan's output."""
    with torch_ops.transient_plans():
        cases = _draws(mode)
        for case in cases:
            assert _in_class(mode, case), case
            first, n = case.rows
            assert 0 <= first and n >= 1 and first + n <= case.keys[0][3]
            assert 0 <= case.offset < 16
            assert np.prod(case.input_shape()) <= fuzz.MAX_INPUT_BYTES
            assert 1 <= case.batch <= (8 if mode == "pyramid" else 4) or mode == "tall"
    assert {c.offset == 0 for c in cases} == {True, False}


def test_draws_reach_every_launch_shape():
    """Between them, ``--box`` reaches the box kernel's three forms,
    ``--deep`` three or more lane counts and more than one chunk, and
    ``--staged`` a staged X tile; ``--tall`` a batch past the grid's
    limit on the deep box kernel; ``--band`` starts with the eight plans
    of tests/test_fuzz_differential.py."""
    with torch_ops.transient_plans():
        forms = {box.form(c.plans()[0], c.offset) for c in _draws("box")}
        assert forms == {box.DIRECT, box.COPY, box.STAGED}
        shapes = [deep.launch_shape(c.plans()[0], c.batch, address=c.offset)
                  for c in _draws("deep")]
        assert len({s["lanes"] for s in shapes}) >= 3
        assert max(s["chunks"] for s in shapes) > 1
        lanes = {bilinear.stage_table(c.plans()[0].x, c.plans()[0].meta_in.n_bytes)[0]
                 for c in _draws("staged")}
        assert min(lanes) > 0 and len(lanes) >= 3
    tall = _draws("tall")
    assert any(c.target == "deep" and c.batch > fuzz.GRID_ROWS for c in tall)
    assert {c.target for c in tall} == {"box", "deep", "bilinear", "bilinear128"}
    assert fuzz.BAND_PLANS == _DEEP_CASES
    assert [c.keys[0] for c in _draws("band", n=8)] == _DEEP_CASES


def test_direct_draws_reach_every_form():
    """The modes that reach ``bilinear.cu``'s direct path draw plans that
    route to each of its forms, and plans that fit each form; the fuzz runs
    a direct plan in every form that fits (``_other_forms`` beside the
    routed one), and nothing else for a staged X box."""
    routed, fitting = set(), set()
    with torch_ops.transient_plans():
        for mode in ("uniform", "edges", "mixed", "up", "tall"):
            for case in _draws(mode):
                plan = case.plans()[0]
                if not bilinear.applicable(plan) or fuzz._stage_lanes(plan) != 0:
                    continue
                forms = bilinear.direct_forms(plan)
                assert sorted([bilinear.direct_form(plan)] + fuzz._other_forms(plan)) == forms
                routed.add(bilinear.direct_form(plan))
                fitting.update(forms)
        staged = _draws("staged")[0].plans()[0]
        assert fuzz._other_forms(staged) == []
    assert routed == fitting == {bilinear.LOOP, bilinear.H_TILE, bilinear.ROLL}


def test_s128_draws_run_3_byte_input_in_every_form():
    """``--s128`` draws 3-byte input on a fixed share of its cases, routed
    to each of ``bilinear128.cu``'s forms; each such case runs, whole and
    by rows, in every form that fits, and a 4-byte case in LOOP only, or in
    ROLL and LOOP where it lies in ROLL's class (some of the draws do)."""
    routed, three, runs_by_form, rolled = set(), 0, set(), 0
    with torch_ops.transient_plans():
        for case in _draws("s128"):
            plan = case.plans()[0]
            if plan.meta_in.n_bytes != 3:
                roll = bilinear128.form(plan) == bilinear128.ROLL
                rolled += roll
                assert fuzz._other_forms(plan, bilinear128) == ([bilinear128.LOOP] if roll else [])
                continue
            three += 1
            forms = bilinear128.forms(plan)
            assert sorted([bilinear128.form(plan)] + fuzz._other_forms(plan, bilinear128)) == forms
            routed.add(bilinear128.form(plan))
            if len(forms) == 2 and len(runs_by_form) < 4:
                x = torch.zeros(case.input_shape(), dtype=torch.uint8)
                cover = dataclasses.asdict(fuzz.Report("s128"))["cover"]
                labels = [label for label, _, _ in fuzz.kernel_runs(case, x, x[:1], cover)]
                other = bilinear128.FORMS[fuzz._other_forms(plan, bilinear128)[0]]
                assert f"bilinear128 {other} {plan.key}" in labels
                assert any(lb.startswith(f"bilinear128 {other} rows") for lb in labels)
                assert cover["bilinear128 forms"] == {"loop", "h tile"}
                runs_by_form.add(len(runs_by_form))
    assert three >= DRAWS // 8 and routed == {bilinear128.LOOP, bilinear128.H_TILE}
    assert runs_by_form and rolled >= DRAWS // 40


def test_draw_is_a_function_of_the_generator():
    a, b = _draws("deep", seed=3, n=20), _draws("deep", seed=3, n=20)
    assert a == b and a != _draws("deep", seed=4, n=20)


# the area of a replayed case, in input and in output pixels over its
# distinct images, kept small so that each case takes well under a second
REPLAY_PIXELS = 150_000


def _replay_case(mode, seed):
    """The first draw of ``mode`` from ``seed`` within REPLAY_PIXELS, with
    its batch cut to the distinct images the fuzz holds its plain versions
    on."""
    rng = np.random.default_rng(seed)
    for i in range(2000):
        case = fuzz.draw(mode, rng, i)
        k = min(case.batch, fuzz.DISTINCT)
        if all(k * max(w * h, wo * ho) <= REPLAY_PIXELS for w, h, wo, ho in
               (key[:4] for key in case.keys)):
            return dataclasses.replace(case, batch=k)
    raise AssertionError(f"no {mode} draw within {REPLAY_PIXELS} pixels")


@pytest.mark.parametrize("seed", [11, 12, 13])
@pytest.mark.parametrize("mode", fuzz.MODES)
def test_replay_matches_numpy_ref(mode, seed):
    """A drawn plan, batch, byte offset and row range through the port's
    public ``scale`` and ``scale_rows`` on the CPU (the plain versions)
    equals numpy_ref image by image; a pyramid set level by level."""
    case = _replay_case(mode, seed)
    with torch_ops.transient_plans():
        distinct, x = fuzz.make_input(case, torch.device("cpu"))
        assert x.data_ptr() - x.untyped_storage().data_ptr() == case.offset
        assert torch.equal(x, distinct) and x.is_contiguous()
        imgs = x.numpy()
        for key in case.keys:
            rp = RefPlan(*key)
            want = np.stack([numpy_ref.scale(rp, im) for im in imgs])
            got = stt.scale(ScalePlan(*key), x, device="cpu")
            assert np.array_equal(got.numpy(), want), key
        first, n = case.rows
        want = np.stack([numpy_ref.scale(RefPlan(*case.keys[0]), im) for im in imgs])
        got = stt.scale_rows(ScalePlan(*case.keys[0]), x, first, n, device="cpu")
        assert np.array_equal(got.numpy(), want[:, first : first + n])


@pytest.mark.parametrize("key", fuzz.BAND_PLANS, ids=str)
def test_band_plans_match_numpy_ref(key):
    """The deep-ratio overflow band (PREMUL16 sums near 2^32 over spans of
    4,113-65,535 pixels), on images made as test_fuzz_differential.py makes
    them: every plain version whose class holds the plan, and ``scale`` on
    the CPU, equal numpy_ref."""
    rng = np.random.default_rng(hash(key) & 0xFFFF)
    img = rng.integers(128, 256, (key[1], key[0], 4), dtype=np.uint8)
    img[..., -1] = 255
    want = numpy_ref.scale(RefPlan(*key), img)
    plan = ScalePlan(*key)
    x = torch.from_numpy(img)
    ran = 0
    with torch_ops.transient_plans():
        for _, mod, ref in fuzz.WHOLE:
            if mod.applicable(plan):
                assert np.array_equal(ref(plan, x).numpy(), want), mod.__name__
                ran += 1
        assert np.array_equal(stt.scale(plan, x, device="cpu").numpy(), want)
    assert ran >= 1


# ----------------------------------------------------------------------------
# The classifier
# ----------------------------------------------------------------------------

WANT = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (2, 3, 5, 4), dtype=np.uint8))


@pytest.fixture
def allocator(monkeypatch):
    """A stand-in for the card's caching allocator: ``fuzz.poison`` fills the
    blocks it hands out next; a fake kernel takes its output from
    ``pool``, which holds the last run's bytes until the poison fills it."""
    pool = [WANT.clone()]

    def poison(shapes, device):
        assert [tuple(s) for s in shapes] == [tuple(WANT.shape)]
        pool[0].fill_(fuzz.POISON)
        return [pool[0].data_ptr()]

    monkeypatch.setattr(fuzz, "poison", poison)
    return pool


def _flip():
    out = WANT.clone()
    out[1, 2, 3, 0] ^= 1
    return out


def _raise():
    raise RuntimeError("launch failed")


def _alternate(calls=[0]):
    calls[0] += 1
    return WANT.clone() if calls[0] % 2 else _flip()


def _skipper(pool):
    def run():
        out = pool[0]
        out.view(-1)[4:] = WANT.view(-1)[4:]  # every pixel but the first
        return out
    return run


def test_check_classes(allocator):
    assert fuzz.check(lambda: WANT.clone(), lambda: WANT)[:2] == ("ok", "")
    status, detail, _ = fuzz.check(_flip, lambda: WANT)
    assert status == "mismatch" and "(1, 2, 3, 0)" in detail
    assert fuzz.check(_raise, lambda: WANT)[0] == "exc"
    assert fuzz.check(_alternate, lambda: WANT)[0] == "flaky"
    assert fuzz.check(lambda: WANT, _raise)[0] == "exc"  # the plain version raised
    assert fuzz.check(lambda: (WANT, WANT), lambda: WANT)[0] == "mismatch"


def test_poison_exposes_an_unwritten_pixel(allocator, monkeypatch):
    """A kernel that skips a pixel is right by chance on memory that still
    holds an earlier run's bytes; the poison makes it a mismatch."""
    status, detail, poisoned = fuzz.check(_skipper(allocator), lambda: WANT)
    assert (status, poisoned) == ("mismatch", 2)
    assert f": {fuzz.POISON}," in detail
    allocator[0].copy_(WANT)
    monkeypatch.setattr(fuzz, "poison", lambda shapes, device: [])
    assert fuzz.check(_skipper(allocator), lambda: WANT)[0] == "ok"


def test_poison_hands_back_its_blocks():
    """On the CPU too, the blocks are filled and freed."""
    ptrs = fuzz.poison([(2, 3), (4,)], torch.device("cpu"))
    assert len(ptrs) == 2 and all(ptrs)


CASE = fuzz.Case(keys=((8, 6, 4, 3, 0, 0, False),), batch=2, offset=3, rows=(1, 2), seed=5)


def _fake_main(monkeypatch, run, target=None):
    monkeypatch.setattr(fuzz, "card", lambda device=None: torch.device("cpu"))
    monkeypatch.setattr(fuzz, "draw",
                        lambda mode, rng, i=0: dataclasses.replace(CASE, target=target))
    monkeypatch.setattr(fuzz, "kernel_runs",
                        lambda case, x, distinct, cover: [("fake", run, lambda: WANT)])
    return fuzz.main(["3", "1", "--box"])


@pytest.mark.parametrize("run", [_flip, _raise, _alternate, None],
                         ids=["mismatch", "exc", "flaky", "unwritten"])
def test_main_exits_1_on_each_failure(allocator, monkeypatch, capsys, run):
    assert _fake_main(monkeypatch, run or _skipper(allocator)) == 1
    out = capsys.readouterr().out
    assert "SUMMARY: box: cases=3 runs=3" in out and "FAILS: [(0, 'fake'," in out


def test_main_exits_0_when_every_run_agrees(allocator, monkeypatch, capsys):
    assert _fake_main(monkeypatch, lambda: WANT.clone()) == 0
    out = capsys.readouterr().out
    assert "ok=3 mismatch=0 exc=0 flaky=0" in out and "FAILS: []" in out


def test_main_raises_when_the_target_never_launched(allocator, monkeypatch):
    with pytest.raises(RuntimeError, match="did not launch"):
        _fake_main(monkeypatch, lambda: WANT.clone(), target="box")


def test_fuzz_needs_a_card(monkeypatch):
    """No card: the fuzz raises rather than hold the plain versions against
    themselves; a bad flag is a usage error."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fuzz.main(["2"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fuzz.run("box", 1, 0)
    assert fuzz.main(["--nope"]) == 2


def test_nested_transient_scopes_with_equal_entries():
    """Two open scopes whose added entries compare equal (both empty):
    closing the inner one leaves the outer one open and working."""
    plan = ScalePlan(51, 7, 103, 9, 2, 2)
    n0 = bilinear._tables.cache_len()
    with torch_ops.transient_plans():
        with torch_ops.transient_plans():
            pass
        bilinear._tables(plan, torch.device("cpu"))
        assert bilinear._tables.cache_len() == n0 + 1
    assert bilinear._tables.cache_len() == n0
