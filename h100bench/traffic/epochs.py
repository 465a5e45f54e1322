"""Runs from rest through the scene runner's epochs, replayed.

``segments``' runs (a segment bins the seed's inputs, then steps
``segment_steps`` steps of the workload's solver, with its obstacles),
cut into epochs of ``epoch_steps`` steps as ``solvers.run.run_epochs``
runs a scene: every ``epoch_steps`` steps the state is unbinned to its
rows (``neighbors.binned.unbin``) and binned again (``bin_state``) with
the clock set to the epoch's first step times dt. The epoch's own bin
restarts the state's ``n_rebins`` and ``overflow``, so the driver keeps
their sum and their largest value over the segment's epochs on the
device.

With ``spans`` each boundary is the named range ``h100bench.epoch``.
"""

from __future__ import annotations

import torch

from h100bench.traffic import segments


class Driver(segments.Driver):
    def __init__(self, cfg: dict, work: dict, builder, inp, spans: bool = False):
        super().__init__(cfg, work, builder, inp, spans)
        self.epoch_steps = work["epoch_steps"]
        self._k = 0
        self._zero = torch.zeros((), dtype=torch.int64, device=inp.pos.device)
        self._rebins = self._overflow = self._zero

    def begin(self):
        self._k = 0
        self._rebins = self._overflow = self._zero
        return super().begin()

    def step(self, b):
        if self._k and self._k % self.epoch_steps == 0:
            with self._span("h100bench.epoch"):
                self._rebins = self._rebins + b.n_rebins
                self._overflow = torch.maximum(self._overflow, b.overflow.to(torch.int64))
                state = self._nb.unbin(self.grid, b, self.state.capacity)
                b = self._nb.bin_state(self.grid, state, sim_time=float(self._k) * self.params.dt)
        self._k += 1
        return super().step(b)

    def failed(self, b) -> torch.Tensor:
        """As ``segments``', with the overflow of every epoch's bin."""
        return torch.maximum(super().failed(b), (self._overflow > 0).to(torch.int64))

    def rebins(self, b) -> torch.Tensor:
        """Rebins since the segment's bin, over its epochs, on the device."""
        return self._rebins + b.n_rebins.to(torch.int64)
