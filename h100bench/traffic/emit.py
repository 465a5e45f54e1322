"""A stream filling an empty tank through the scene runner's epochs,
replayed.

``epochs``' runs with the scene's emitter, in ``solvers.run.run_epochs``'
order: a segment emits the rows due at step 0
(``scenes.emitter.emit_due``) and bins them; every ``epoch_steps`` steps
the state is unbinned to its rows (``neighbors.binned.unbin``), the rows
due by then are emitted, each where its spawn velocity would have carried
it since its spawn step and only where no active row is nearer than the
program's clearance (``emit_due`` given dt and ``CLEARANCE`` h, as
``run_epochs`` gives them), and the state is binned again (``bin_state``)
with the clock at the epoch's first step times dt. The stream is the
seed's (the builder's ``schedule``); the obstacles are the configuration's
(its ``obstacles`` entry, in ``reference/obstacles.py``'s form), in the
step of every slot. Rebins and overflow are summed over the epochs as in
``epochs``.

With ``spans`` a segment's start is the named range ``h100bench.bin``, a
boundary ``h100bench.epoch``; the program's ``sph.emit`` lies inside each.
"""

from __future__ import annotations

import torch

from h100bench.traffic import epochs, segments


class Driver(epochs.Driver):
    def __init__(self, cfg: dict, work: dict, builder, inp, spans: bool = False):
        from sph_pie_torch.scenes import emitter

        super().__init__(cfg, work, builder, inp, spans)
        self._em = emitter
        self._rule = (self.params.dt, emitter.CLEARANCE * self.params.h)
        self.schedule = builder.schedule(inp)
        self.obstacles = segments.obstacles(cfg, inp.pos)

    def begin(self):
        """A segment's start: the rows due at step 0 emitted into the empty
        scene and binned."""
        self._k = 0
        self._rebins = self._overflow = self._zero
        with self._span("h100bench.bin"):
            state = self._em.emit_due(self.state, self.schedule, 0, *self._rule)
            return self._nb.bin_state(self.grid, state, sim_time=0.0)

    def step(self, b):
        k = self._k
        if k and k % self.epoch_steps == 0:
            with self._span("h100bench.epoch"):
                self._rebins = self._rebins + b.n_rebins
                self._overflow = torch.maximum(self._overflow, b.overflow.to(torch.int64))
                state = self._nb.unbin(self.grid, b, self.state.capacity)
                state = self._em.emit_due(state, self.schedule, k, *self._rule)
                b = self._nb.bin_state(self.grid, state, sim_time=float(k) * self.params.dt)
        self._k = k + 1
        return segments.Driver.step(self, b)
