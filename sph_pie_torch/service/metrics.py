"""Per-step and per-run simulation metrics.

The metric set is physical: counts, energies, density statistics and
extremes of the active particles, computed on the state's device and
returned to the host as a small dict of Python scalars.
"""

from __future__ import annotations

import torch

from sph_pie_torch.core.state import ParticleState

# The flat export row.
METRIC_COLUMNS = (
    "step",
    "time",
    "n_active",
    "mean_density",
    "max_density",
    "min_density",
    "max_speed",
    "mean_speed",
    "kinetic_energy",
    "potential_energy",
    "momentum_x",
    "momentum_y",
    "momentum_z",
    "com_x",
    "com_y",
    "com_z",
)


def _state_metrics(state: ParticleState, gravity: torch.Tensor) -> dict:
    """Device tensors of the metrics. Density statistics are over the
    active rows whose density is not NaN; with none, they are NaN."""
    act = state.active
    actf = act.to(state.pos.dtype)
    n = torch.clamp(actf.sum(), min=1.0)
    m = torch.where(act, state.mass, 0.0)
    v2 = (state.vel * state.vel).sum(-1)
    speed = torch.sqrt(v2) * actf
    rho = torch.where(act, state.density, torch.nan)
    seen = ~torch.isnan(rho)
    nan = rho.new_tensor(torch.nan)
    g_norm = torch.sqrt((gravity * gravity).sum())
    # potential energy against the gravity direction
    g_hat = gravity / torch.clamp(g_norm, min=1e-12)
    height = -(state.pos * g_hat).sum(-1)
    mom = (m[:, None] * state.vel).sum(0)
    com = (m[:, None] * state.pos).sum(0) / torch.clamp(m.sum(), min=1e-12)
    return {
        "n_active": act.sum(dtype=torch.int32),
        "mean_density": torch.nanmean(rho),
        "max_density": torch.where(seen.any(), torch.where(seen, rho, -torch.inf).amax(), nan),
        "min_density": torch.where(seen.any(), torch.where(seen, rho, torch.inf).amin(), nan),
        "max_speed": speed.amax(),
        "mean_speed": speed.sum() / n,
        "kinetic_energy": 0.5 * (m * v2).sum(),
        "potential_energy": g_norm * (m * height).sum(),
        "momentum": mom,
        "com": com,
    }


@torch.no_grad()
def state_metrics(state: ParticleState, params, step: int = 0) -> dict:
    """Host-side dict of Python scalars for one state snapshot."""
    raw = _state_metrics(state, params.gravity)
    dim = state.dim
    out = {"step": int(step), "time": float(params.dt) * int(step),
           "n_active": int(raw["n_active"])}
    for k in ("mean_density", "max_density", "min_density", "max_speed", "mean_speed",
              "kinetic_energy", "potential_energy"):
        out[k] = float(raw[k])
    mom = [float(x) for x in raw["momentum"]] + [0.0] * (3 - dim)
    com = [float(x) for x in raw["com"]] + [0.0] * (3 - dim)
    out.update(momentum_x=mom[0], momentum_y=mom[1], momentum_z=mom[2])
    out.update(com_x=com[0], com_y=com[1], com_z=com[2])
    return out


def metric_row(metrics: dict) -> list:
    """Flatten a metrics dict to the METRIC_COLUMNS order."""
    return [metrics.get(c, "") for c in METRIC_COLUMNS]


def aggregate_run_stats(step_metrics: list[dict]) -> dict:
    """Aggregate statistics (mean, max, min of each numeric key but step and
    time) over a run's recorded metric rows."""
    if not step_metrics:
        return {"samples": 0}
    keys = [k for k in step_metrics[0] if k not in ("step", "time")]
    out = {"samples": len(step_metrics)}
    for k in keys:
        vals = [m[k] for m in step_metrics if isinstance(m.get(k), (int, float))]
        if not vals:
            continue
        out[f"{k}_avg"] = sum(vals) / len(vals)
        out[f"{k}_max"] = max(vals)
        out[f"{k}_min"] = min(vals)
    return out
