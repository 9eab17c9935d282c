"""The port and its smoke script stand without JAX: the machine with the GPU
has none installed."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "smolscale_tpu_torch"

_NO_JAX = (
    "import sys\n"
    "{imports}\n"
    "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.'))\n"
    "assert not bad, bad\n"
)


def _run(code, **kw):
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120, **kw)


def test_port_imports_no_jax():
    imports = "\n".join([
        "import smolscale_tpu_torch",
        "import smolscale_tpu_torch.ops.box",
        "import smolscale_tpu_torch.ops.bilinear",
        "import smolscale_tpu_torch.ops.deep",
        "import smolscale_tpu_torch.ops.bilinear128",
        "import smolscale_tpu_torch.ops.pixels",
        "import smolscale_tpu_torch.ops.pyramid",
        "import smolscale_tpu_torch.pyramid",
        "import smolscale_tpu_torch.ops._build",
        "import smolscale_tpu_torch.backends.torch_ops",
        "import smolscale_tpu_torch.utils.timing",
        "import smolscale_tpu_torch.utils.png",
        "import smolscale_tpu_torch.parallel",
        "import smolscale_tpu_torch.cli",
        "import smolscale_tpu_torch.fuzz",
        "assert not any(m == 'smolscale_tpu' or m.startswith('smolscale_tpu.')"
        " for m in sys.modules), 'the port imported the JAX package'",
    ])
    res = _run(_NO_JAX.format(imports=imports))
    assert res.returncode == 0, res.stderr


def test_chip_smoke_imports_no_jax():
    """chip_smoke.py and the numpy spec it checks against import no JAX."""
    imports = "import chip_smoke\nimport smolscale_tpu.backends.numpy_ref"
    res = _run(_NO_JAX.format(imports=imports))
    assert res.returncode == 0, res.stderr


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")), ids=lambda p: p.name)
def test_port_sources_name_no_jax(path):
    pattern = re.compile(r"^\s*(import|from)\s+(jax|smolscale_tpu)(\.|\s|$)", re.M)
    assert not pattern.search(path.read_text())


def test_chip_smoke_fails_without_cuda():
    """Without a CUDA device the smoke script exits non-zero and prints no
    result line."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, env=env)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
