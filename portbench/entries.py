"""How a cell drives the program, one class per entry point named in a
workload file (``"entry"``), and how it judges what came out.

Each entry makes its inputs on the device from the seed, warms the shapes
its traffic uses, runs request ``i`` through the program's public entry
point, counts each request's pixels and bytes from its shapes, and, once the
window has closed, compares the outputs it kept with the plain reference
(``portbench.reference``), which works the plans and tables out again from
the same inputs.

``program`` is what the window drives: the port's package
(``smolscale_tpu_torch``), or the control (``portbench.control``) put in its
place.  It provides ``ScalePlan``, ``scale`` and ``make_pyramid_fn``.
"""

from __future__ import annotations

import time

import torch

from . import traffic
from .reference import scale as reference
from .reference.plan import ScalePlan as RefPlan


def generator(device: torch.device, seed: int, stream: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream) & (2**63 - 1))
    return g


def random_bytes(shape, device, gen) -> torch.Tensor:
    return torch.randint(0, 256, shape, dtype=torch.uint8, device=device, generator=gen)


def byte_diff(got: torch.Tensor, want: torch.Tensor) -> int:
    """The largest difference of one byte between two uint8 tensors of one
    shape; 256 when the shapes differ."""
    if tuple(got.shape) != tuple(want.shape):
        return 256
    if got.numel() == 0:
        return 0
    return int((got.to(want.device, torch.int16) - want.to(torch.int16)).abs().max())


class Entry:
    """What every entry provides to the harness."""

    pass_requests = 1  # requests in one pass over every shape of the traffic
    one_frame: dict = {}  # request -> the one image of its outputs kept and compared

    def warm(self) -> float:
        """Run every shape of the traffic once; the seconds of one request
        in a second pass, for how many a window will hold."""
        for i in range(self.pass_requests):
            self.ready(self.call(i))
        t0 = time.perf_counter()
        for i in range(self.pass_requests):
            self.ready(self.call(i))
        return (time.perf_counter() - t0) / self.pass_requests

    def rehearse(self, keep) -> None:
        """Run the requests to be kept, holding their outputs as the window
        will, and a pass beside them, so that the card's allocator holds
        blocks for both before the window opens."""
        held = [self.call(i) for i in sorted(keep)]
        self.ready(held)
        for i in sorted(set(self.one_frame) - set(keep)):
            outs = self.call(i)
            self.ready(outs)
            held.append(self.frame_of(i, outs))
        for i in range(self.pass_requests):
            self.ready(self.call(i))
        del held

    def call(self, i: int):
        raise NotImplementedError

    def frame_of(self, i: int, outs):
        """What the run keeps of request ``i``'s outputs when it is in
        ``one_frame``."""
        raise NotImplementedError

    def ready(self, outs) -> None:
        """Wait until request's outputs are ready for the caller."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def work(self, i: int) -> tuple[int, int]:
        """(pixels, bytes) of request ``i``: input and output of its real
        images, each counted once."""
        raise NotImplementedError

    def release(self) -> None:
        """Drop the program's inputs, before the reference runs."""

    def check(self, kept: dict) -> tuple[int, int]:
        """(largest byte difference, images compared) over the kept
        requests' outputs."""
        raise NotImplementedError


class Frames(Entry):
    """``"entry": "scale"``: each request scales ``batch`` resident frames
    (one ``(H, W, nb)`` frame with ``"single_image"``) at the next plan of
    the configuration's cycle, through ``scale``.  Besides its sample of
    whole requests, a run keeps one image, drawn from the seed, of the first
    request of every plan, so that every plan of the cycle is compared in
    every run."""

    def __init__(self, config, workload, seed, device, program):
        fr = config["frames"]
        self.device, self.program = device, program
        self.args = traffic.frame_plans(fr)
        self.plans = [program.ScalePlan(*a) for a in self.args]
        self.order = traffic.cycle_order(len(self.args), seed)
        self.batch = int(workload["batch"])
        self.single = bool(workload.get("single_image", False))
        self.n_frames = int(workload["resident_frames"])
        if self.n_frames % self.batch or (self.single and self.batch != 1):
            raise ValueError("resident_frames must be a multiple of batch, and batch 1 "
                             "with single_image")
        gen = generator(device, seed, 0)
        self.frames = {}
        for nb in sorted({3 if a[4] >= 8 else 4 for a in self.args}):
            self.frames[nb] = random_bytes((self.n_frames, fr["height"], fr["width"], nb),
                                           device, gen)
        self.pass_requests = len(self.order)
        picks = traffic.rng(seed, 5).integers(0, self.batch, len(self.order))
        self.one_frame = {i: int(b) for i, b in enumerate(picks)}

    def _input(self, i):
        """Request ``i``'s plan arguments and input: the next ``batch`` of
        the resident frames, a view (``resident_frames`` is a multiple of
        ``batch``)."""
        a = self.args[self.order[i % len(self.order)]]
        frames = self.frames[3 if a[4] >= 8 else 4]
        k = (i * self.batch) % self.n_frames
        return a, frames[k] if self.single else frames[k : k + self.batch]

    def call(self, i):
        _, x = self._input(i)
        return self.program.scale(self.plans[self.order[i % len(self.order)]], x)

    def frame_of(self, i, outs):
        b = self.one_frame[i]
        return b, outs if self.single else outs[b].clone()

    def work(self, i):
        a = self.args[self.order[i % len(self.order)]]
        n = 1 if self.single else self.batch
        nb_in, nb_out = (3 if a[4] >= 8 else 4), (3 if a[5] >= 8 else 4)
        px_in, px_out = a[0] * a[1], a[2] * a[3]
        return n * (px_in + px_out), n * (px_in * nb_in + px_out * nb_out)

    def check(self, kept):
        worst, n = 0, 0
        for i, out in kept.items():
            a, x = self._input(i)
            plan = RefPlan(*a)
            xs = x[None] if self.single else x
            if isinstance(out, tuple):  # one image of the request, from frame_of
                b, frame = out
                worst = max(worst, byte_diff(frame, reference.scale(plan, xs[b])))
                n += 1
                continue
            outs = out[None] if self.single else out
            if outs.shape[0] != xs.shape[0]:
                return 256, n
            for b in range(xs.shape[0]):
                worst = max(worst, byte_diff(outs[b], reference.scale(plan, xs[b])))
                n += 1
        return worst, n


class PyramidSweep(Entry):
    """``"entry": "pyramid_sweep"``: the whole fleet resident on the card,
    grouped and cut into padded sub-batches as ``scale_pyramid_mixed`` does
    it; a request is one sweep, every sub-batch through its group's
    ``make_pyramid_fn``, then one wait."""

    def __init__(self, config, workload, seed, device, program):
        self.fleet = config["fleet"]
        self.device, self.program = device, program
        self.sizes = tuple(int(s) for s in self.fleet["sizes"])
        self.srgb = bool(self.fleet.get("with_srgb", False))
        self.keys = [(traffic.image_shape(g), int(g["pixel_type"])) for g in self.fleet["groups"]]
        gen = generator(device, seed, 1)
        self.templates = [random_bytes((self.fleet["templates"], *shape), device, gen)
                          for shape, _ in self.keys]
        images = traffic.fleet_images(self.fleet, seed)
        subs = traffic.sub_batches([self.keys[g] for g, _ in images],
                                   workload.get("max_batch_bytes"))
        group_of = {key: g for g, key in enumerate(self.keys)}
        self.fns = {key: program.make_pyramid_fn(key[0][1], key[0][0], key[1], sizes=self.sizes,
                                                 with_srgb=self.srgb, device=device)
                    for key in group_of}
        self.subs = []  # (group, template ids of the real images, input)
        for key, idx, size in subs:
            g = group_of[key]
            tpl = [images[k][1] for k in idx]
            pad = tpl + [tpl[-1]] * (size - len(tpl))
            ids = torch.tensor(pad, device=device)
            self.subs.append((g, ids[: len(tpl)], self.templates[g][ids]))
        per_image = [self.image_work(g) for g, _ in images]
        self.sweep_work = (sum(p for p, _ in per_image), sum(b for _, b in per_image))

    def image_work(self, g):
        shape, _ = self.keys[g]
        px_in, px_out = traffic.pixels(shape), sum(s * s for s in self.sizes)
        return px_in + px_out, (px_in + px_out) * shape[2]

    def reference_levels(self) -> list:
        """Each group's templates' levels by the reference, per level size:
        every image of the fleet is one of them."""
        out = []
        for (shape, pt), tpl in zip(self.keys, self.templates):
            h, w, _ = shape
            out.append([torch.cat([reference.scale(RefPlan(w, h, s, s, pt, pt, self.srgb), t)
                                   for t in tpl.split(8)]) for s in self.sizes])
        return out

    def call(self, i):
        return [self.fns[self.keys[g]](x) for g, _, x in self.subs]

    def work(self, i):
        return self.sweep_work

    def release(self):
        self.subs = [(g, ids, None) for g, ids, _ in self.subs]

    def check(self, kept):
        ref = self.reference_levels()
        worst, n = 0, 0
        for outs in kept.values():
            if len(outs) != len(self.subs):
                return 256, n
            for (g, ids, _), levels in zip(self.subs, outs):
                if len(levels) != len(self.sizes):
                    return 256, n
                for want, got in zip(ref[g], levels):
                    worst = max(worst, byte_diff(got[: len(ids)], want[ids]))
                n += len(ids)
        return worst, n


ENTRIES = {"scale": Frames, "pyramid_sweep": PyramidSweep}
