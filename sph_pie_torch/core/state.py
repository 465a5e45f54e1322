"""Struct-of-arrays particle state: every field is a ``[capacity, ...]``
tensor with an ``active`` mask, so a scene keeps one static capacity."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sph_pie_torch.utils.struct import replace


@dataclasses.dataclass(frozen=True)
class ParticleState:
    """SoA particle state. All tensors share leading dim = capacity."""

    pos: torch.Tensor       # [N, dim] position
    vel: torch.Tensor       # [N, dim] velocity
    mass: torch.Tensor      # [N]      per-particle mass
    density: torch.Tensor   # [N]      most recent SPH density estimate
    pressure: torch.Tensor  # [N]      most recent EOS pressure
    active: torch.Tensor    # [N]      bool, slot carries a live particle

    @property
    def capacity(self) -> int:
        return self.pos.shape[0]

    @property
    def dim(self) -> int:
        return self.pos.shape[1]

    @property
    def dtype(self) -> torch.dtype:
        return self.pos.dtype

    def n_active(self) -> torch.Tensor:
        return self.active.sum()


def allocate(
    capacity: int,
    dim: int,
    dtype: torch.dtype = torch.float32,
    device: torch.device | str = "cuda",
) -> ParticleState:
    """All-inactive state with static capacity."""

    def z(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    return ParticleState(
        pos=z(capacity, dim),
        vel=z(capacity, dim),
        mass=z(capacity),
        density=z(capacity),
        pressure=z(capacity),
        active=torch.zeros(capacity, dtype=torch.bool, device=device),
    )


def from_positions(
    pos,
    *,
    capacity: int | None = None,
    vel=None,
    mass: float = 1.0,
    dtype: torch.dtype = torch.float32,
    device: torch.device | str = "cuda",
) -> ParticleState:
    """Build a state from an [n, dim] position array, padding to capacity."""
    pos = torch.as_tensor(np.asarray(pos), dtype=dtype, device=device)
    n, dim = pos.shape
    cap = int(capacity) if capacity is not None else n
    if cap < n:
        raise ValueError(f"capacity {cap} < particle count {n}")
    st = allocate(cap, dim, dtype, device)
    st.pos[:n] = pos
    if vel is not None:
        st.vel[:n] = torch.as_tensor(np.asarray(vel), dtype=dtype, device=device)
    st.mass[:n] = torch.as_tensor(mass, dtype=dtype, device=device)
    st.active[:n] = True
    return st


def astype(state: ParticleState, dtype: torch.dtype) -> ParticleState:
    """Cast all float fields to ``dtype`` (active mask stays bool)."""
    return replace(
        state,
        **{
            f.name: getattr(state, f.name).to(dtype)
            for f in dataclasses.fields(state)
            if getattr(state, f.name).is_floating_point()
        },
    )
