"""The benchmark's one traffic generator: what a cell's requests are, from
its configuration file, its workload file and the seed.

Two kinds of configuration:

- frames (``"frames"`` key): a source size, the output sizes of the
  upstream proportional sweep's step rule, the pixel type pairs and sRGB.  A cell's requests cycle through every (size, pixel
  pair) plan in a seeded order.
- a fleet (``"fleet"`` key): groups of images (share, size, pixel type),
  a number of templates per group, the pyramid's level sizes.  The fleet's
  images are placed in a seeded order, then grouped and cut into sub-batches
  as the farm (``scale_pyramid_mixed``) does it.

The seed changes the pixels and the order of the work, never its sizes: a
run on any seed does the same set of requests.
"""

from __future__ import annotations

import numpy as np


def rng(seed: int, stream: int = 0) -> np.random.Generator:
    """A numpy generator for ``seed`` (any whole number) and a sub-stream."""
    return np.random.default_rng([int(seed) & (2**64 - 1), stream])


# --- frames ---------------------------------------------------------------


def frame_sizes(frames: dict) -> list[tuple[int, int]]:
    """Output sizes of a frames configuration: the proportional sweep of
    ``"scales"`` (bench.sh:41-52 and the port's ``cli.py benchmark``): f =
    from + (to - from) * i / steps for i = 1 .. steps, each side
    ``max(1, int(side * f))``."""
    sc = frames["scales"]
    w, h, lo, hi, steps = frames["width"], frames["height"], sc["from"], sc["to"], sc["steps"]
    out = []
    for i in range(1, steps + 1):
        f = lo + (hi - lo) * i / steps
        out.append((max(1, int(w * f)), max(1, int(h * f))))
    return out


def frame_plans(frames: dict) -> list[tuple]:
    """Every plan of a frames configuration as ScalePlan arguments
    ``(w_in, h_in, w_out, h_out, type_in, type_out, srgb)``, sizes outer,
    pixel pairs inner."""
    w, h, srgb = frames["width"], frames["height"], bool(frames.get("with_srgb", False))
    return [(w, h, wo, ho, int(ti), int(to), srgb)
            for wo, ho in frame_sizes(frames) for ti, to in frames["pixel_types"]]


def cycle_order(n: int, seed: int) -> np.ndarray:
    """The order in which a cell visits its ``n`` plans: one seeded
    permutation, repeated."""
    return rng(seed, 1).permutation(n)


# --- fleets ---------------------------------------------------------------


def group_counts(fleet: dict) -> list[int]:
    """Images per group: ``round(share * images)``, as the 5b suite row
    (benchmarks/suite.py:157-176) counts them."""
    return [int(round(g["share"] * fleet["images"])) for g in fleet["groups"]]


def image_shape(group: dict) -> tuple[int, int, int]:
    w, h = group["size"]
    return (int(h), int(w), 3 if int(group["pixel_type"]) >= 8 else 4)


def fleet_images(fleet: dict, seed: int) -> list[tuple[int, int]]:
    """Each image of the fleet as (group, template): group by group, the
    templates cycled (image i of a group is template i % templates), then
    the whole fleet in a seeded order."""
    n_tpl = fleet["templates"]
    images = [(g, i % n_tpl) for g, n in enumerate(group_counts(fleet)) for i in range(n)]
    order = rng(seed, 2).permutation(len(images))
    return [images[k] for k in order]


def sub_batches(keys: list, max_batch_bytes: int | None) -> list[tuple]:
    """The sub-batches ``scale_pyramid_mixed`` makes of images with these
    (shape, pixel type) keys, as (key, indices, padded size): grouped by key
    in order of first appearance, at most ``max_batch_bytes`` of input each,
    a remainder padded to the group's sub-batch size (by repeating its last
    image)."""
    groups: dict = {}
    for i, key in enumerate(keys):
        groups.setdefault(key, []).append(i)
    out = []
    for key, idxs in groups.items():
        cap = len(idxs)
        if max_batch_bytes is not None:
            cap = max(1, min(cap, int(max_batch_bytes) // int(np.prod(key[0]))))
        for c0 in range(0, len(idxs), cap):
            sub = idxs[c0 : c0 + cap]
            out.append((key, sub, cap if c0 > 0 else len(sub)))
    return out


def pixels(shape) -> int:
    return int(shape[0]) * int(shape[1])


def sample(n_expected: int, k: int, seed: int) -> set[int]:
    """The requests whose outputs the run keeps and compares: ``k`` drawn
    from the seed among the first ``n_expected`` (all of them if fewer)."""
    n_expected = max(1, int(n_expected))
    if n_expected <= k:
        return set(range(n_expected))
    return {int(i) for i in rng(seed, 4).choice(n_expected, size=k, replace=False)}
