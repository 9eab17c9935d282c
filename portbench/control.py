"""The control: the plain reference put in the program's place, with its
filters in float32 rounded to nearest (``reference.scale(...,
exact=False)``).  It offers the entry points the cells drive, so a run
with ``--control 1`` goes through the same window, sample and comparison
as a run of the port, and has to come out ``correct: false``.
"""

from __future__ import annotations

import torch

from .reference import scale as _reference
from .reference.plan import ScalePlan


def scale(plan: ScalePlan, img: torch.Tensor) -> torch.Tensor:
    """Image by image: the reference's int64 planes of a batch of 8 frames
    at 2x would not fit on the card beside what a run holds."""
    if img.dim() == 3:
        return _reference.scale(plan, img, exact=False)
    return torch.stack([_reference.scale(plan, im, exact=False) for im in img])


def make_pyramid_fn(width_in, height_in, pixel_type_in, sizes=(64, 128, 256),
                    with_srgb=False, device=None):
    plans = [ScalePlan(width_in, height_in, s, s, pixel_type_in, pixel_type_in, with_srgb)
             for s in sizes]

    def fn(x):
        return tuple(torch.cat([_reference.scale(p, part, exact=False) for part in x.split(16)])
                     for p in plans)

    return fn
