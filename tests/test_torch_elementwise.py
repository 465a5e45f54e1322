"""Port vs reference: smoothing kernels and the Tait EOS, elementwise.

Seeded r in [0, 1.2h] (plus r = 0, h/2 and h exactly), in 2D and 3D.
Tolerance: rtol 1e-12 in float64, 1e-6 in float32 (one or two roundings
apart: the two frameworks may evaluate integer powers differently), with
an absolute floor of rtol * max|value| for values that cancel to ~0 at the
support edge.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity  # noqa: F401  (pins torch to one thread)
from sph_pie_torch.core.params import make_params as t_make_params
from sph_pie_torch.kernels import eos as t_eos
from sph_pie_torch.kernels import smoothing as t_sm
from sph_pie_tpu.core.params import make_params as j_make_params
from sph_pie_tpu.kernels import eos as j_eos
from sph_pie_tpu.kernels import smoothing as j_sm

H = 0.0367


def _dtypes(f64):
    return (
        (jnp.float64, torch.float64, 1e-12)
        if f64
        else (jnp.float32, torch.float32, 1e-6)
    )


def _x64(f64):
    return jax.enable_x64() if f64 else contextlib.nullcontext()


def _close(got, want, rtol):
    want = np.asarray(want)
    np.testing.assert_allclose(
        got.numpy(), want, rtol=rtol, atol=rtol * np.abs(want).max()
    )


@pytest.mark.parametrize("f64", [False, True], ids=["f32", "f64"])
@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize(
    "fn", ["poly6", "spiky_grad_mag", "visc_lap", "cohesion"]
)
def test_smoothing_matches_reference(fn, dim, f64):
    jd, td, rtol = _dtypes(f64)
    rng = np.random.default_rng(11 + dim)
    r = np.concatenate([[0.0, 0.5 * H, H], rng.uniform(0.0, 1.2 * H, 4096)])
    arg = r * r if fn == "poly6" else r
    with _x64(f64):
        want = np.asarray(
            getattr(j_sm, fn)(dim, jnp.asarray(H, jd), jnp.asarray(arg, jd))
        )
    got = getattr(t_sm, fn)(dim, torch.tensor(H, dtype=td), torch.tensor(arg, dtype=td))
    assert got.dtype == td
    _close(got, want, rtol)


@pytest.mark.parametrize("f64", [False, True], ids=["f32", "f64"])
@pytest.mark.parametrize("dim", [2, 3])
def test_tait_pressure_matches_reference(dim, f64):
    """Includes densities below rest, where the clamp at 0 holds."""
    jd, td, rtol = _dtypes(f64)
    rng = np.random.default_rng(5 + dim)
    rho = rng.uniform(900.0, 1100.0, 4096)
    kw = dict(dim=dim, h=H, dt=1e-4, sound_speed=40.0)
    with _x64(f64):
        want = np.asarray(
            j_eos.tait_pressure(j_make_params(**kw, dtype=jd), jnp.asarray(rho, jd))
        )
    got = t_eos.tait_pressure(
        t_make_params(**kw, dtype=td, device="cpu"), torch.tensor(rho, dtype=td)
    )
    assert (got.numpy() == 0).sum() == (want == 0).sum() > 0
    _close(got, want, rtol)
