"""Build the package's CUDA kernels with ``nvcc`` and load them with ctypes.

Each of ``csrc/*.cu`` compiles to an object with its own ``nvcc``, all at
once, and the objects link into one shared library with a plain C
interface, ``build/kernels/libsmolscale_torch_kernels.so`` under the
repository root, on first use.  A stamp beside the library holds a hash of
the flags and of every file under ``csrc/`` (sources and the ``.cuh``
headers they include), so an edited source or header rebuilds and an
unchanged tree loads at once.  The library is written under a temporary
name and renamed into place, so processes that build at the same time never
load a half written file.

Nothing here runs at import time: this module is imported on machines
without ``nvcc`` or a GPU, where only the kernels' plain versions run.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
LIB_NAME = "libsmolscale_torch_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


def find_nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH): the CUDA "
            "kernels cannot be built"
        )
    return found


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    """A hash of the flags and of every file under ``csrc/`` (the headers
    the sources include as well as the sources), by name and bytes."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(p for p in CSRC.rglob("*") if p.is_file()):
        h.update(path.relative_to(CSRC).as_posix().encode())
        h.update(path.read_bytes())
    return h.hexdigest()


def build() -> tuple[Path, str, float]:
    """Compile ``csrc/*.cu`` unless an up-to-date library exists.

    Returns the library's path, nvcc's output (that of the build that made
    the library, kept beside it, when nothing was built now) and the seconds
    spent building.  Raises if nvcc fails."""
    sources = _sources()
    lib = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / (LIB_NAME + ".sha256")
    report = BUILD_DIR / (LIB_NAME + ".log")
    digest = _digest()
    if lib.is_file() and stamp.is_file() and stamp.read_text() == digest:
        return lib, report.read_text() if report.is_file() else "", 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="nvcc", dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / (src.stem + ".o") for src in sources]
        cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                for obj, src in zip(objs, sources)]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True) for cmd in cmds]
        logs = [proc.communicate()[0] for proc in procs]
        for cmd, proc, out in zip(cmds, procs, logs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}")
        part = Path(tmp) / LIB_NAME
        cmd = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(part), *map(str, objs)]
        res = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}): {' '.join(cmd)}\n{res.stdout}")
        os.replace(part, lib)
    log = "".join(logs) + res.stdout
    report.write_text(log)
    stamp.write_text(digest)
    return lib, log, time.perf_counter() - t0


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    lib_path, _, _ = build()
    return ctypes.CDLL(str(lib_path))
