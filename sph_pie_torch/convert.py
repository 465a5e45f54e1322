"""Carry parameters and state between the JAX reference and the port.

The inputs are the reference objects' fields as a mapping of name ->
numpy array (or plain Python value), e.g.
``{f.name: np.asarray(getattr(obj, f.name)) for f in dataclasses.fields(obj)}``,
and ``dataclasses.asdict(grid)`` for a grid. The outputs are the port's
objects on a given device. ``to_numpy`` goes back, for comparisons.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np
import torch

from sph_pie_torch.core.params import ARRAY_FIELDS, FluidParams
from sph_pie_torch.core.state import ParticleState
from sph_pie_torch.neighbors.binned import BinnedGrid, BinnedState

_GRID_FIELDS = tuple(f.name for f in dataclasses.fields(BinnedGrid))


def _tensor(v, device) -> torch.Tensor:
    """numpy -> tensor of the same dtype (a copy that owns its memory)."""
    return torch.tensor(np.asarray(v), device=device)


def fluid_params(
    fields: Mapping[str, Any], *, device: torch.device | str
) -> FluidParams:
    """FluidParams from its array fields plus its four static flags."""
    return FluidParams(
        dim=int(fields["dim"]),
        eos_gamma=int(fields["eos_gamma"]),
        use_xsph=bool(fields["use_xsph"]),
        use_cohesion=bool(fields["use_cohesion"]),
        **{k: _tensor(fields[k], device) for k in ARRAY_FIELDS},
    )


def binned_grid(fields: Mapping[str, Any]) -> BinnedGrid:
    """BinnedGrid from ``dataclasses.asdict`` of the reference grid.

    The reference's TPU layout and scheduling knobs (window_mode,
    home_tier, adaptive_rows, scan_unroll, symmetric_fold, pair_kernel,
    skip_empty_blocks) are dropped: the port computes the one-sided sums
    whatever they say."""
    return BinnedGrid(
        **{
            k: tuple(fields[k]) if isinstance(fields[k], (list, tuple)) else fields[k]
            for k in _GRID_FIELDS
            if k in fields
        }
    )


def particle_state(
    fields: Mapping[str, Any], *, device: torch.device | str
) -> ParticleState:
    return ParticleState(
        **{
            f.name: _tensor(fields[f.name], device)
            for f in dataclasses.fields(ParticleState)
        }
    )


def binned_state(
    fields: Mapping[str, Any], *, device: torch.device | str
) -> BinnedState:
    """All 13 fields, the 0-d ``travel``/``overflow``/``n_rebins``/
    ``sim_time`` included."""
    return BinnedState(
        **{
            f.name: _tensor(fields[f.name], device)
            for f in dataclasses.fields(BinnedState)
        }
    )


def to_numpy(obj) -> dict[str, Any]:
    """A port dataclass -> {field: numpy array or plain value}."""
    return {
        f.name: (
            getattr(obj, f.name).detach().cpu().numpy()
            if isinstance(getattr(obj, f.name), torch.Tensor)
            else getattr(obj, f.name)
        )
        for f in dataclasses.fields(obj)
    }
