"""Shared helpers of the port's parity tests (sph_pie_torch vs sph_pie_tpu).

The JAX package is the reference: a test builds its inputs there (or from
a numpy seed), carries them to the port through ``sph_pie_torch.convert``
as numpy arrays, runs both, and compares.
"""

from __future__ import annotations

import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import torch

from sph_pie_torch import convert

# The suite runs in several worker processes on a few CPUs: one thread each.
torch.set_num_threads(1)


def jax_fields(obj) -> dict:
    """A reference dataclass's fields as numpy arrays / plain values."""
    return {
        f.name: (
            getattr(obj, f.name)
            if isinstance(getattr(obj, f.name), (bool, int, str, tuple))
            else np.asarray(getattr(obj, f.name))
        )
        for f in dataclasses.fields(obj)
    }


def port_inputs(scene, b):
    """(params, grid, binned state) of the port from reference objects."""
    return (
        convert.fluid_params(jax_fields(scene.params), device="cpu"),
        convert.binned_grid(dataclasses.asdict(scene.bgrid)),
        convert.binned_state(jax_fields(b), device="cpu"),
    )


def scaled_err(got, want) -> float:
    """max |got - want| / max |want| (scale-normalised absolute error)."""
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def load_script(name: str):
    """``scripts/<name>.py`` of the reference, loaded by path (``scripts/`` is
    no package)."""
    path = Path(__file__).resolve().parents[1] / "scripts" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
