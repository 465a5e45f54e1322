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


# A reference dataclass's fields as numpy arrays / plain values.
jax_fields = convert.fields_of


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


def assert_same(port_obj, ref_obj) -> None:
    """Every field of a port dataclass equal to the reference's, exactly
    (values and dtypes)."""
    got, want = convert.to_numpy(port_obj), jax_fields(ref_obj)
    assert got.keys() == want.keys()
    for k in want:
        assert np.array_equal(np.asarray(got[k]), np.asarray(want[k])), k
        if isinstance(got[k], np.ndarray):
            assert got[k].dtype == np.asarray(want[k]).dtype, k


def assert_held(got_state, want_state, tol: float) -> None:
    """A port ParticleState against a reference one: active masks equal,
    positions of the active rows within ``tol``."""
    got, want = convert.to_numpy(got_state), jax_fields(want_state)
    act = np.asarray(want["active"])
    assert np.array_equal(got["active"], act)
    if act.any():
        assert np.abs(got["pos"][act] - np.asarray(want["pos"])[act]).max() <= tol
