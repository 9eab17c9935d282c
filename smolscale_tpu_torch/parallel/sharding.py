"""Splitting a scale over a list of devices: image batches and output rows.

Counterpart of ``smolscale_tpu.parallel.sharding`` (``default_mesh``,
``make_batched_scale``, ``make_row_sharded_scale``,
``make_sharded_batch_step``) and of ``__graft_entry__.dryrun_multichip``.
The reference's only parallelism is caller-driven threads over contiguous
output-row chunks with a shared read-only context (smol-mt, test.c:839-883;
contract smolscale.h:70-74).  Here:

* **batch axis ("dp")**: each device scales its slice of the image batch;
  no communication.
* **row axis ("rows")**: each device computes a contiguous range of output
  rows through the row API (``torch_ops.scale_rows_fn``), which computes
  only those rows from the whole image, replicated on every device.

Both compose on a two-axis mesh.  A mesh is a numpy array of
``torch.device`` with a name per axis; a device may appear more than once,
so one card (or the CPU) can run the split.  Each shard's copy and launch
are queued on its device's current stream under ``torch.cuda.device``, and
the copies that gather the results on the mesh's first device, in shard
order, are queued too: no shard waits for another on the host.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..backends import torch_ops
from ..plan import ScalePlan


class DeviceMesh:
    """Devices laid out over named axes: ``devices`` is array-like with one
    dimension per name.  ``shape`` maps each name to its size, as
    ``jax.sharding.Mesh.shape`` does."""

    def __init__(self, devices, axis_names):
        src = np.asarray(devices, dtype=object)
        arr = np.empty(src.shape, dtype=object)
        for idx in np.ndindex(arr.shape):
            arr[idx] = _device(src[idx])
        self.axis_names = tuple(axis_names)
        if arr.ndim != len(self.axis_names) or arr.size == 0:
            raise ValueError(f"mesh of shape {arr.shape} does not fit axes {self.axis_names}")
        if len({d.type for d in arr.flat}) != 1:
            raise ValueError("a mesh holds devices of one type")
        self.devices = arr
        self.shape = dict(zip(self.axis_names, arr.shape))

    @property
    def first(self) -> torch.device:
        """The device that results are gathered on."""
        return self.devices.flat[0]

    def along(self, *axes: str) -> np.ndarray:
        """The devices over ``axes`` in that order, at index 0 of every other
        axis (a shard replicated over the other axes runs once)."""
        for a in axes:
            if a not in self.axis_names:
                raise ValueError(f"mesh has axes {self.axis_names}, not {a!r}")
        order = [self.axis_names.index(a) for a in axes]
        rest = [i for i in range(len(self.axis_names)) if i not in order]
        arr = np.transpose(self.devices, order + rest)
        return arr.reshape(arr.shape[: len(axes)] + (-1,))[..., 0]

    def __repr__(self) -> str:
        return f"DeviceMesh({self.shape}, {[str(d) for d in self.devices.flat]})"


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def default_mesh(axis_names=("dp",), devices=None) -> DeviceMesh:
    """A mesh over ``devices``, by default every CUDA device (raises without
    one: a CPU mesh exists only where ``devices`` names CPU devices).  With
    two axis names the devices are split as evenly as possible, the first
    axis the smaller: 4 -> 2 x 2, 6 -> 2 x 3, 7 -> 1 x 7, 8 -> 2 x 4."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("default_mesh needs a CUDA device; pass devices= for a CPU mesh")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    flat = np.asarray(list(devices), dtype=object)
    if len(axis_names) == 1:
        return DeviceMesh(flat, axis_names)
    if len(axis_names) != 2:
        raise ValueError(f"default_mesh takes one or two axis names, not {axis_names}")
    n = flat.size
    a = next(c for c in range(int(np.sqrt(n)), 0, -1) if n % c == 0)
    return DeviceMesh(flat.reshape(a, n // a), axis_names)


def _on(dev: torch.device):
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def _to(x, dev: torch.device) -> torch.Tensor:
    """``x`` (a tensor or a numpy array) on ``dev``, a copy to a card queued
    without waiting."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(dev, non_blocking=dev.type == "cuda")


def _batch_of(imgs, n: int, axis: str) -> int:
    if len(imgs.shape) != 4:
        raise ValueError(f"expected a batch (B, H, W, nb), got shape {tuple(imgs.shape)}")
    b = imgs.shape[0]
    if b % n:
        raise ValueError(f"batch of {b} images does not split over {n} devices of axis {axis!r}")
    return b // n


def _row_ranges(h_out: int, n_shards: int) -> list[tuple[int, int]]:
    """Shard s's output rows ``(first, count)``: ``[s*n, s*n + count)`` with
    ``n = ceil(h_out / n_shards)`` and ``count = min(n, h_out - s*n)``; a
    shard past the end has no rows and is left out (the JAX package clamps
    it to ``h_out - 1`` and trims the duplicates; the row API raises on an
    empty range)."""
    n = -(-h_out // n_shards)
    return [(s * n, min(n, h_out - s * n)) for s in range(n_shards) if s * n < h_out]


def split_batch(fn, mesh: DeviceMesh, axis: str = "dp"):
    """``fn`` (a batch tensor -> a tensor or a tuple of tensors on its
    device) with the batch split over ``axis``: slice k runs on the k-th
    device of the axis, and each output is gathered on ``mesh.first``."""
    devices = list(mesh.along(axis))

    def run(imgs):
        per = _batch_of(imgs, len(devices), axis)
        outs = []
        for k, dev in enumerate(devices):
            with _on(dev):
                outs.append(fn(_to(imgs[k * per : (k + 1) * per], dev)))
        return _gather(outs, mesh.first, dim=0)

    return run


def _gather(outs: list, dev: torch.device, dim: int):
    if isinstance(outs[0], tuple):
        return tuple(_gather([o[i] for o in outs], dev, dim) for i in range(len(outs[0])))
    return torch.cat([o.to(dev, non_blocking=dev.type == "cuda") for o in outs], dim=dim)


def make_batched_scale(plan: ScalePlan, mesh: DeviceMesh, axis: str = "dp"):
    """A function ``(B, H, W, nb_in) uint8 -> (B, h, w, nb_out) uint8`` with
    the batch split over ``axis`` (B divisible by its size, else
    ``ValueError``): image slice k is copied to the axis's k-th device and
    scaled there by the kernel, every slice queued before any result is
    gathered.  The output lies on the mesh's first device, slices in order:
    the counterpart of the JAX version's global array."""
    return split_batch(lambda x: torch_ops.scale_fn(plan, x), mesh, axis)


def _rows_on(plan: ScalePlan, grid: np.ndarray, imgs, dev0: torch.device) -> torch.Tensor:
    """Output rows of ``imgs`` (one image or a batch), split over the
    devices of ``grid`` in order, gathered on ``dev0``."""
    ranges = _row_ranges(plan.height_out, len(grid))
    copies, parts = {}, []
    for (first, count), dev in zip(ranges, grid):
        with _on(dev):
            if dev not in copies:
                copies[dev] = _to(imgs, dev)
            parts.append(torch_ops.scale_rows_fn(plan, copies[dev], first, count))
    return _gather(parts, dev0, dim=-3)


def make_row_sharded_scale(plan: ScalePlan, mesh: DeviceMesh, axis: str = "rows"):
    """A function ``(H, W, nb_in)`` (or a batch) ``-> (h, w, nb_out)`` uint8
    with the output rows split over ``axis`` (smol-mt analogue): shard s
    computes rows ``[s*n, s*n + count)``, ``n = ceil(h / n_shards)``, on the
    axis's s-th device from the whole input, copied to each device once.
    Shards past the last row compute nothing.  The rows are gathered on the
    mesh's first device, in order."""
    grid = list(mesh.along(axis))
    return lambda img: _rows_on(plan, grid, img, mesh.first)


def make_sharded_batch_step(plan: ScalePlan, mesh: DeviceMesh,
                            batch_axis: str = "dp", row_axis: str = "rows"):
    """The batch split over ``batch_axis`` and each slice's output rows over
    ``row_axis``: ``(B, H, W, nb_in) -> (B, h, w, nb_out)`` uint8, gathered on
    the mesh's first device."""
    grid = mesh.along(batch_axis, row_axis)

    def run(imgs):
        per = _batch_of(imgs, grid.shape[0], batch_axis)
        parts = [_rows_on(plan, list(row), imgs[k * per : (k + 1) * per], mesh.first)
                 for k, row in enumerate(grid)]
        return torch.cat(parts, dim=0)

    return run


def dryrun_multichip(n_devices: int, device=None) -> None:
    """One fully split step over a mesh of ``n_devices`` entries of
    ``device`` (``"dp" x "rows"``), on the four plans of
    ``__graft_entry__.dryrun_multichip``: a 2D step on a format-converting
    sRGB bilinear plan, and row splits of a box plan, a deep box plan with
    uneven rows and a COPY x box strip.  Each result must equal the
    unsplit ``scale`` on one device, byte for byte; raises otherwise.
    ``device`` is by default the card, and without one this raises: the
    CPU runs only when ``device="cpu"`` says so."""
    devices = [torch_ops.numpy_device(device)] * n_devices
    mesh = default_mesh(("dp", "rows"), devices=devices)
    rows_mesh = default_mesh(("rows",), devices=devices)
    dev = mesh.first
    rng = np.random.default_rng(0)

    def whole(plan, x):
        return torch_ops.scale_fn(plan, torch_ops.as_tensor(x, dev))

    def same(label, got, want):
        if tuple(got.shape) != tuple(want.shape) or not torch.equal(got, want):
            raise AssertionError(f"dryrun_multichip({n_devices}): {label} differs from "
                                 "the unsplit scale")

    plan = ScalePlan(48, 40, 24, 18, 4, 0, True)  # convert + sRGB + bilinear
    imgs = rng.integers(0, 256, (2 * mesh.shape["dp"], 40, 48, 4), dtype=np.uint8)
    same("2D step", make_sharded_batch_step(plan, mesh)(imgs), whole(plan, imgs))
    for plan, shape in (
        (ScalePlan(64, 96, 8, 12, 0, 0, False), (96, 64, 4)),      # box
        (ScalePlan(64, 2000, 16, 7, 0, 0, False), (2000, 64, 4)),  # deep box, uneven rows
        (ScalePlan(64, 64, 64, 8, 0, 1, False), (64, 64, 4)),      # COPY x box strip
    ):
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        same(f"rows of {plan.key}", make_row_sharded_scale(plan, rows_mesh)(img),
             whole(plan, img))
