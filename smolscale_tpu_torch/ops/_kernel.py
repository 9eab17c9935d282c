"""The launch frame that the port's five kernel wrappers share (``ops/box.py``,
``bilinear.py``, ``deep.py``, ``bilinear128.py`` and ``pyramid.py``).

A wrapper makes one :class:`Kernel` where its module loads and keeps what is
its own: its class, host tables, parameter block, plain version and a step
that names the device buffers in its C entry's order.  The frame owns the
rest: the input checks, the device rule of the public call (the plain
version on the CPU, the kernel on a CUDA device), the outputs, the device
guard, the ctypes entry (looked up on the first launch: nothing here loads
the library at import, so the CPU needs no ``nvcc``), the launch on the
current stream, its error, the wrapper module's ``launches`` counter, the
byte counter and the three host spans of a launch.
"""

from __future__ import annotations

import ctypes
import sys

import torch

from ..utils.timing import counter, span
from . import pixels

# the host spans of each launch: the outputs' allocation; the device's entry,
# the per-plan tables and the parameter block; the launch
ALLOC_SPAN = span("smolscale.alloc")
TABLES_SPAN = span("smolscale.tables")
LAUNCH_SPAN = span("smolscale.launch")


class Kernel:
    """One kernel of ``csrc/`` behind the wrapper module named ``module``.

    ``name`` names the kernel in errors and ``applicable`` is its plan class
    (for :meth:`check`).  ``symbol`` is its C entry in the kernels' library:
    ``n_ptrs`` device pointers, a pointer to a ``params`` structure and a
    stream in, a CUDA error code out.  ``plain(plan, imgs, *args)`` is the
    plain version (one output or a tuple); ``step(plan, batch, outs, device,
    *args)`` gives a launch's device buffers in the entry's order (a tensor,
    or None for a null pointer) and its parameter block; ``launched(params)``,
    where given, follows each launch that succeeded.  The byte counter takes
    the module's last name."""

    def __init__(self, module: str, name: str, symbol: str, n_ptrs: int, params: type,
                 plain, step, applicable=None, launched=None):
        self.name = name
        self.bytes = counter(module.rsplit(".", 1)[1])
        self._module = sys.modules[module]
        self._symbol = symbol
        self._argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.POINTER(params), ctypes.c_void_p]
        self._plain, self._step = plain, step
        self._applicable, self._launched = applicable, launched
        self._fn = None

    def _entry(self):
        from ._build import library

        fn = getattr(library(), self._symbol)
        fn.argtypes = self._argtypes
        fn.restype = ctypes.c_int
        self._fn = fn
        return fn

    def check(self, plan, imgs: torch.Tensor, first: int | None = None,
              n: int | None = None) -> None:
        """Raise unless the plan is in the kernel's class, ``imgs`` fits it and
        [first, first + n), where given, is a range of its output rows."""
        if not self._applicable(plan):
            raise ValueError(f"plan {plan.key} is outside the {self.name} kernel's class")
        pixels.check_input(plan, imgs)
        if first is not None and (first < 0 or n < 1 or first + n > plan.height_out):
            raise ValueError(f"row range [{first}, {first + n}) outside [0, {plan.height_out})")

    def __call__(self, plan, imgs: torch.Tensor, shapes, *args):
        """The outputs, one of (h, w, nb) uint8 per shape of ``shapes`` for
        each image of ``imgs`` (the batch axis kept where ``imgs`` has one),
        on the device where ``imgs`` lies; ``args`` go to the plain version
        and the step."""
        kind = imgs.device.type
        if kind == "cuda":
            if not imgs.is_contiguous():
                raise ValueError(f"the {self.name} kernel takes contiguous input")
            batch = imgs if imgs.dim() == 4 else imgs[None]
            device = imgs.device
            with ALLOC_SPAN:
                outs = [torch.empty((batch.shape[0], *s), dtype=torch.uint8, device=device)
                        for s in shapes]
            with TABLES_SPAN, torch.cuda.device(device):
                bufs, params = self._step(plan, batch, outs, device, *args)
                TABLES_SPAN.end()
                with LAUNCH_SPAN:
                    err = (self._fn or self._entry())(
                        *[b if b is None else b.data_ptr() for b in bufs],
                        ctypes.byref(params), torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise RuntimeError(f"{self.name} kernel launch failed: CUDA error {err}")
            self._module.launches += 1
            if self._launched is not None:
                self._launched(params)
            if imgs.dim() == 3:
                outs = [o[0] for o in outs]
        elif kind == "cpu":
            outs = self._plain(plan, imgs, *args)
            if not isinstance(outs, tuple):
                outs = (outs,)
        else:
            raise ValueError(f"no {self.name} kernel for device {imgs.device}")
        self.bytes.add(imgs, *outs)
        return outs
