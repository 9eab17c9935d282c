"""The port's CLI (smolscale_tpu_torch.cli) and PNG codec
(smolscale_tpu_torch.utils.png) against the JAX package's
(smolscale_tpu.cli, smolscale_tpu.utils.png), on the CPU.

``check`` on the card holds each case against the plain versions on the
CPU (tests/test_torch_cuda.py, chip_smoke.py); here it runs with
``--device cpu`` on a cut sweep.
"""

import re
import struct
import zlib

import numpy as np
import pytest
import torch

from smolscale_tpu import cli as jax_cli
from smolscale_tpu.utils import png as jax_png
from smolscale_tpu_torch import cli
from smolscale_tpu_torch.backends import torch_ops
from smolscale_tpu_torch.ops import bilinear, bilinear128, deep, pyramid
from smolscale_tpu_torch.plan import ScalePlan
from smolscale_tpu_torch.utils import png

RNG = np.random.default_rng(13)


def _image(c, h=23, w=31):
    return RNG.integers(0, 256, (h, w) if c == 1 else (h, w, c), np.uint8)


@pytest.mark.parametrize("c", [1, 3, 4])
def test_png_writes_the_jax_bytes(tmp_path, c):
    img = _image(c)
    png.write_png(tmp_path / "port.png", img)
    jax_png.write_png(tmp_path / "jax.png", img)
    assert (tmp_path / "port.png").read_bytes() == (tmp_path / "jax.png").read_bytes()
    for path in ("port.png", "jax.png"):
        assert np.array_equal(png.read_png(tmp_path / path), img)
        assert np.array_equal(jax_png.read_png(tmp_path / path), img)


def _filter_row(ftype, line, prev, c):
    """PNG spec 9.2, the encoder's side: line and prev as int arrays."""
    out = np.empty_like(line)
    for i in range(len(line)):
        a = line[i - c] if i >= c else 0
        b = prev[i]
        cc = prev[i - c] if i >= c else 0
        if ftype == 0:
            pred = 0
        elif ftype == 1:
            pred = a
        elif ftype == 2:
            pred = b
        elif ftype == 3:
            pred = (a + b) >> 1
        else:
            p = a + b - cc
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - cc)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else cc)
        out[i] = (line[i] - pred) & 0xFF
    return out


def _write_filtered(path, img, ftypes):
    """A PNG whose row y uses filter ftypes[y % len(ftypes)]."""
    h, w, c = img.shape
    prev = np.zeros(w * c, dtype=np.int64)
    raw = b""
    for y in range(h):
        line = img[y].reshape(-1).astype(np.int64)
        ft = ftypes[y % len(ftypes)]
        raw += bytes([ft]) + _filter_row(ft, line, prev, c).astype(np.uint8).tobytes()
        prev = line
    color_type = {1: 0, 3: 2, 4: 6}[c]

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw)))
        f.write(chunk(b"IEND", b""))


@pytest.mark.parametrize("ftypes", [(0,), (1,), (2,), (3,), (4,), (0, 1, 2, 3, 4)], ids=str)
@pytest.mark.parametrize("c", [1, 3, 4])
def test_png_reads_every_filter(tmp_path, ftypes, c):
    img = _image(c, 9, 13)
    img3 = img[:, :, None] if c == 1 else img
    path = tmp_path / "f.png"
    _write_filtered(path, img3, ftypes)
    got = png.read_png(path)
    assert got.dtype == np.uint8 and np.array_equal(got, img)
    assert np.array_equal(got, jax_png.read_png(path))


def test_png_rejects(tmp_path):
    (tmp_path / "x.png").write_bytes(b"not a png")
    with pytest.raises(ValueError, match="not a PNG"):
        png.read_png(tmp_path / "x.png")
    _write_filtered(tmp_path / "bad.png", _image(3, 2, 2), (5,))
    with pytest.raises(ValueError, match="filter 5"):
        png.read_png(tmp_path / "bad.png")


@pytest.mark.parametrize("full", [False, True])
def test_check_sizes_match_jax(full):
    assert cli._check_sizes(full) == jax_cli._check_sizes(full)


@pytest.mark.parametrize("srgb", [False, True])
@pytest.mark.parametrize("c", [3, 4])
def test_generate_matches_jax(tmp_path, c, srgb):
    src = tmp_path / "in.png"
    png.write_png(src, _image(c, 24, 36))
    extra = ["--srgb"] if srgb else []
    assert cli.main(["--device", "cpu", "generate", str(src), str(tmp_path / "port"), "3"]
                    + extra) == 0
    assert jax_cli.main(["--backend", "numpy", "generate", str(src), str(tmp_path / "jax"),
                         "3"] + extra) == 0
    for size in ("12x8", "24x16", "36x24"):
        port = (tmp_path / f"port-{size}.png").read_bytes()
        assert port == (tmp_path / f"jax-{size}.png").read_bytes(), size


def test_generate_gray(tmp_path, capsys):
    src = tmp_path / "gray.png"
    png.write_png(src, _image(1, 10, 20))
    assert cli.main(["--device", "cpu", "generate", str(src), str(tmp_path / "g"), "2"]) == 0
    assert capsys.readouterr().out.split() == [str(tmp_path / "g-10x5.png"),
                                               str(tmp_path / "g-20x10.png")]
    assert png.read_png(tmp_path / "g-10x5.png").shape == (5, 10, 3)


@pytest.fixture
def short_sweep(monkeypatch):
    """The check's size ladder cut to a few boundary sizes (the default
    ladder's cases take about 13 s per colour here)."""
    monkeypatch.setattr(cli, "_check_sizes", lambda full: [1, 2, 3, 63, 64, 255, 256, 257])
    return monkeypatch


def test_check_on_cpu_passes(short_sweep, capsys):
    assert cli.main(["--device", "cpu", "check", "--colors", "2"]) == 0
    out = capsys.readouterr().out
    n = 2 * (8 * 4 + 2 * len(range(1, 65536, 655)) * 3)
    assert f"check: {n}/{n} ok on cpu" in out
    assert "color 0:" in out and "color 4:" in out and "FAIL" not in out


def test_check_fails_on_one_flipped_byte(short_sweep, capsys):
    """The check can fail: a scale that flips the last byte of a case's
    output (the edge that the invariance does not hold) exits 1."""
    real = cli._scale

    def flipped(plan, img, device):
        out = real(plan, img, device).copy()
        if (plan.width_in, plan.height_in, plan.width_out) == (65535, 1, 257):
            out[-1, -1, -1] ^= 1
        return out

    short_sweep.setattr(cli, "_scale", flipped)
    assert cli.main(["--device", "cpu", "check", "--colors", "1"]) == 1
    out = capsys.readouterr().out
    assert out.count("FAIL") == 1 and "FAIL 65535x1->257x1" in out


# the ops layer's per-plan caches
PLAN_CACHES = (bilinear._tables, bilinear._stage_tables, bilinear._windows, bilinear._plan_params,
               bilinear128._tables, deep._tables, deep.span_words, deep.span_rows,
               pyramid._applicable)


def test_check_keeps_the_table_caches_bounded(short_sweep):
    """check forgets what the kernels cached for its plans, and keeps what
    another caller cached before it ran, a plan of the sweep included."""
    cpu = torch.device("cpu")
    kept = bilinear._tables(ScalePlan(65535, 1, 257, 1, 2, 2), cpu)
    before = [c.cache_len() for c in PLAN_CACHES]
    assert cli.main(["--device", "cpu", "check", "--colors", "1"]) == 0
    assert [c.cache_len() for c in PLAN_CACHES] == before
    assert bilinear._tables(ScalePlan(65535, 1, 257, 1, 2, 2), cpu) is kept


def test_transient_plans_forget_only_their_own_entries():
    """The plain versions fill the per-plan caches; a scope drops what was
    made inside it, nested scopes included, and nothing made before."""
    cpu = torch.device("cpu")
    old, new, inner = (ScalePlan(w, 7, 2 * w + 1, 9, 2, 2) for w in (51, 52, 53))  # bilinear
    img = np.zeros((7, 53, 4), np.uint8)
    n0 = bilinear._tables.cache_len()
    cli._plain(old, img[:, :51].copy())
    assert bilinear._tables.cache_len() == n0 + 1
    with torch_ops.transient_plans():
        cli._plain(old, img[:, :51].copy())
        cli._plain(new, img[:, :52].copy())
        with torch_ops.transient_plans():
            cli._plain(inner, img)
            assert bilinear._tables.cache_len() == n0 + 3
        assert bilinear._tables.cache_len() == n0 + 2
    assert bilinear._tables.cache_len() == n0 + 1


def test_check_needs_a_device_without_card(monkeypatch):
    """No card and no --device: the check raises rather than run on the
    CPU."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["check"])


def _shape(text):
    """Each line with its numbers replaced by N."""
    return [re.sub(r"-?\d+(\.\d+)?", "N", line) for line in text.splitlines()]


def _small_plans(monkeypatch, mod, plan_cls):
    """benchmark-conv's 3840x2160 -> 3839x2159 cut 40-fold on each axis."""
    monkeypatch.setattr(mod, "ScalePlan",
                        lambda w, h, wo, ho, *a: plan_cls(w // 40, h // 40, wo // 40, ho // 40, *a))


def test_benchmark_lines_match_jax(monkeypatch, capsys, tmp_path):
    argv = ["benchmark", "--width", "64", "--height", "48", "--steps", "3", "--reps", "1",
            "--samples", str(tmp_path / "s.txt")]
    assert cli.main(["--device", "cpu"] + argv) == 0
    port = capsys.readouterr().out
    assert jax_cli.main(["--backend", "numpy"] + argv) == 0
    jax = capsys.readouterr().out
    # the JAX summary line goes to the stdout bound when its module loaded
    assert _shape(port)[1:6] == _shape(jax)[1:6] and _shape(port)[6:] == ["N N N"]
    assert port.splitlines()[0] == "# 64x48 proportional sweep, 3 steps, device=cpu"
    sizes = [[line.split("\t")[:3] for line in out.splitlines()[2:5]] for out in (port, jax)]
    assert sizes[0] == sizes[1]
    assert len((tmp_path / "s.txt").read_text().splitlines()) == 3


def test_benchmark_conv_lines_match_jax(monkeypatch, capsys):
    from smolscale_tpu.plan import ScalePlan as RefPlan

    _small_plans(monkeypatch, cli, ScalePlan)
    _small_plans(monkeypatch, jax_cli, RefPlan)
    assert cli.main(["--device", "cpu", "benchmark-conv", "--reps", "1"]) == 0
    port = capsys.readouterr().out.splitlines()
    assert jax_cli.main(["--backend", "numpy", "benchmark-conv", "--reps", "1"]) == 0
    jax = capsys.readouterr().out.splitlines()
    assert port[0].startswith(jax[0]) and port[0].endswith("device=cpu")
    assert len(port) == len(jax) == 11
    for i, line in enumerate(port[1:]):
        assert re.fullmatch(rf"t{i}: ( *\d+)( +\d+){{9}}", line), line
        assert len(line) == len(jax[1 + i]) or all(len(v) >= 7 for v in line[4:].split(" "))


def test_print_average_matches_jax(capsys):
    import io

    pps = list(RNG.uniform(1e6, 1e9, 37))
    jax_out = io.StringIO()
    assert cli._print_average(pps) == jax_cli._print_average(pps, file=jax_out)
    assert capsys.readouterr().out == jax_out.getvalue()


def test_plot_needs_matplotlib(monkeypatch):
    import builtins

    real = builtins.__import__

    def no_mpl(name, *a, **k):
        if name.startswith("matplotlib"):
            raise ImportError(name)
        return real(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_mpl)
    with pytest.raises(RuntimeError, match="needs matplotlib"):
        cli._plot_samples([(1, 1, 1.0, 1.0)], "x.png", "t")
