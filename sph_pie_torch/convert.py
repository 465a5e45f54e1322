"""Carry parameters and state between the JAX reference and the port.

The inputs are the reference objects' fields as a mapping of name ->
numpy array (or plain Python value), e.g.
``{f.name: np.asarray(getattr(obj, f.name)) for f in dataclasses.fields(obj)}``,
and ``dataclasses.asdict(grid)`` for a grid. The outputs are the port's
objects on a given device. ``scene`` takes a whole reference Scene and
reads its fields the same way. ``to_numpy`` goes back, for comparisons.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np
import torch

from sph_pie_torch.core.params import ARRAY_FIELDS, FluidParams
from sph_pie_torch.core.state import ParticleState
from sph_pie_torch.neighbors.binned import BinnedGrid, BinnedState
from sph_pie_torch.neighbors.grid import GridSpec
from sph_pie_torch.scenes.builders import Scene
from sph_pie_torch.scenes.emitter import EmitterSchedule
from sph_pie_torch.scenes.obstacles import Obstacles
from sph_pie_torch.solvers import pbf

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


def pbf_params(fields: Mapping[str, Any], *, device: torch.device | str) -> pbf.PbfParams:
    """PbfParams from its array fields plus its four static values."""
    return pbf.PbfParams(
        iters=int(fields["iters"]),
        epilogue=str(fields["epilogue"]),
        use_vorticity=bool(fields["use_vorticity"]),
        s_corr_n=int(fields["s_corr_n"]),
        **{k: _tensor(fields[k], device) for k in pbf.ARRAY_FIELDS},
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


def obstacles(fields: Mapping[str, Any], *, device: torch.device | str) -> Obstacles:
    """All 15 fields, the 0-d constants included."""
    return Obstacles(
        **{f.name: _tensor(fields[f.name], device) for f in dataclasses.fields(Obstacles)}
    )


def emitter_schedule(
    fields: Mapping[str, Any], *, device: torch.device | str
) -> EmitterSchedule:
    return EmitterSchedule(
        **{
            f.name: _tensor(fields[f.name], device)
            for f in dataclasses.fields(EmitterSchedule)
        }
    )


def fields_of(obj) -> dict[str, Any]:
    """A reference dataclass's fields: arrays as numpy, plain values kept
    (the input form of the converters above)."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        out[f.name] = v if isinstance(v, (bool, int, float, str, tuple)) else np.asarray(v)
    return out


def scene(ref, *, device: torch.device | str) -> Scene:
    """The port's Scene from a reference Scene: params, both grids, state,
    obstacles, emitter schedule and boundary ghosts, carried as numpy."""
    return Scene(
        name=ref.name,
        params=fluid_params(fields_of(ref.params), device=device),
        gspec=GridSpec(**dataclasses.asdict(ref.gspec)),
        bgrid=binned_grid(dataclasses.asdict(ref.bgrid)),
        state=particle_state(fields_of(ref.state), device=device),
        obstacles=(
            None if ref.obstacles is None
            else obstacles(fields_of(ref.obstacles), device=device)
        ),
        emitter=(
            None if ref.emitter is None
            else emitter_schedule(fields_of(ref.emitter), device=device)
        ),
        boundary=(
            None if ref.boundary is None
            else tuple(_tensor(a, device) for a in ref.boundary)
        ),
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
