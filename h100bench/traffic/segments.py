"""Runs from rest, replayed: the one driver of the solver cells.

A segment bins the seed's inputs (``bin_state``, which users pay at every
run's start) and then steps ``segment_steps`` steps of the workload's
solver: ``wcsph`` (``solvers.wcsph_binned.step``) or ``pbf``
(``solvers.pbf.step`` with the workload's knobs), each step followed by
the workload's ``frame`` when it has one (``render.splat.render_binned_u8``,
its sum kept on the device as a preview's consumer would read it). Where the
workload has ``obstacles`` (``reference/obstacles.py`` gives the entry's
form), the step takes them, made by ``scenes.obstacles.make``. Every
segment does the same work, whatever the program's speed.

With ``spans`` each call into the program is a named range of the
profiler: ``h100bench.bin``, ``h100bench.step``, ``h100bench.frame``.
"""

from __future__ import annotations

import contextlib

import torch

from h100bench.reference import sph


def obstacles(work: dict, like: torch.Tensor):
    """The program's obstacles of the workload's ``obstacles`` entry, in the
    dtype and on the device of ``like``."""
    from sph_pie_torch.scenes import obstacles as obs_lib

    obs, dim = work["obstacles"], like.shape[1]

    def motion(shape):
        return (shape.get("lin", [0.0] * dim), shape.get("amp", [0.0] * dim),
                shape.get("freq", 0.0), shape.get("phase", 0.0))

    spheres, boxes = obs.get("spheres", []), obs.get("boxes", [])
    return obs_lib.make(
        dim, spheres=[(s["center"], s["radius"]) for s in spheres],
        boxes=[(b["lo"], b["hi"]) for b in boxes], stiffness=obs["stiffness"],
        damping=obs["damping"], ramp_dist=obs["ramp_dist"],
        sphere_motions=[motion(s) for s in spheres], box_motions=[motion(b) for b in boxes],
        dtype=like.dtype, device=like.device)


class Driver:
    def __init__(self, cfg: dict, work: dict, builder, inp, spans: bool = False):
        from sph_pie_torch.neighbors import binned as nb
        from sph_pie_torch.render import splat
        from sph_pie_torch.solvers import pbf, wcsph_binned

        self.params, self.grid, self.state = builder.program(cfg, inp)
        self.n = inp.pos.shape[0]
        self.segment_steps = work["segment_steps"]
        self.frame = work.get("frame")
        self.spans = spans
        self._nb, self._splat = nb, splat
        self.obstacles = obstacles(work, inp.pos) if "obstacles" in work else None
        solver = work["solver"]
        if solver["name"] == "wcsph":
            self._step = lambda b: wcsph_binned.step(self.params, self.grid, b, self.obstacles)
        elif solver["name"] == "pbf":
            knobs = {k: v for k, v in solver.items() if k != "name"}
            pp = pbf.make_pbf_params(**knobs, dtype=inp.pos.dtype, device=inp.pos.device)
            self._step = lambda b: pbf.step(self.params, self.grid, pp, b, self.obstacles)
        else:
            raise ValueError(f"segments: no solver {solver['name']!r}")
        p = sph.physics(cfg)
        dev, dt = inp.pos.device, inp.pos.dtype
        self._lo = torch.tensor(p.bound_min, dtype=dt, device=dev) - 5.0 * p.h
        self._hi = torch.tensor(p.bound_max, dtype=dt, device=dev) + 5.0 * p.h
        self.checksum = torch.zeros((), dtype=torch.int64, device=dev)
        self.last_frame = None

    def _span(self, name: str):
        return torch.profiler.record_function(name) if self.spans else contextlib.nullcontext()

    def begin(self):
        """A segment's start: the inputs binned."""
        with self._span("h100bench.bin"):
            return self._nb.bin_state(self.grid, self.state)

    def step(self, b):
        with self._span("h100bench.step"):
            b = self._step(b)
        if self.frame is not None:
            with self._span("h100bench.frame"):
                f = self._splat.render_binned_u8(self.grid, b, **self.frame)
                self.checksum += f.sum(dtype=torch.int64)
            self.last_frame = f
        return b

    def particles(self, b) -> dict:
        """Per particle, in input order: pos, vel, rho (the step's density),
        cell (the padded-grid cell of its slot) and alive (it has a slot);
        and the state's clock, time (the simulated seconds the obstacles
        move by)."""
        S = self.grid.num_slots
        alive = b.slot_of < S
        slot = torch.clamp(b.slot_of, 0, S - 1).to(torch.int64)
        return {"pos": b.pos[slot], "vel": b.vel[slot], "rho": b.density[slot],
                "cell": slot // self.grid.cap, "alive": alive, "time": b.sim_time.clone()}

    def failed(self, b) -> torch.Tensor:
        """1 on the device where the state fails: a position not finite or
        outside the box +- 5 h, or overflow > 0; else 0. No host read."""
        pos = b.pos
        out = (b.valid[:, None] & ((pos < self._lo) | (pos > self._hi))).any()
        return (~torch.isfinite(pos).all() | out | (b.overflow > 0)).to(torch.int64)

    @staticmethod
    def rebins(b) -> torch.Tensor:
        """Rebins since the segment's bin, on the device."""
        return b.n_rebins.to(torch.int64)
