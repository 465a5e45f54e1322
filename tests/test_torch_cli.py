"""Port vs reference: ``python -m sph_pie_torch simulate`` and the metrics
it prints (``sph_pie_torch/service/metrics.py``), on the CPU."""

import json
import math
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from sph_pie_torch.__main__ import main as tmain
from sph_pie_torch.core import state as tstate
from sph_pie_torch.scenes import config as tconfig
from sph_pie_torch.service import metrics as tmetrics
from sph_pie_torch.solvers import run as trun
from sph_pie_tpu.__main__ import main as jmain
from sph_pie_tpu.core.state import ParticleState
from sph_pie_tpu.scenes import config as jconfig
from sph_pie_tpu.service import metrics as jmetrics

ROOT = Path(__file__).resolve().parents[1]
FAUCET = "config/scene-faucet-2d.json"


def _close(got: dict, want: dict, rel: float) -> None:
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k]
        if isinstance(w, float) and math.isnan(w):
            assert math.isnan(g), k
        else:
            assert g == pytest.approx(w, rel=rel, abs=1e-9), k


def test_simulate_prints_the_reference_metrics(capsys, monkeypatch):
    """The faucet scene file, 50 steps: the port's CLI on the CPU prints the
    reference CLI's keys, its ``n_active``, ``step`` and ``overflow``, and
    every other metric within 1e-6 relative (float32; both runs are the
    same epochs of the same scene)."""
    monkeypatch.chdir(ROOT)
    jmain(["simulate", FAUCET, "--steps", "50"])
    want = json.loads(capsys.readouterr().out)
    assert tmain(["simulate", FAUCET, "--steps", "50", "--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out)
    assert got["n_active"] == want["n_active"] > 0
    assert (got["step"], got["overflow"]) == (want["step"], want["overflow"]) == (50, 0)
    _close(got, want, 1e-6)


def test_simulate_by_builder_name(capsys):
    assert tmain(["simulate", "emitter_2d", "--steps", "1", "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["n_active"] > 0 and out["overflow"] == 0
    with pytest.raises(SystemExit):
        tmain(["simulate", "no_such_scene", "--device", "cpu"])


def test_help_names_what_is_not_ported(capsys):
    with pytest.raises(SystemExit):
        tmain(["--help"])
    text = capsys.readouterr().out
    assert "simulate" in text and "'serve' and 'verify'" in text


def _to_ref(st) -> ParticleState:
    return ParticleState(**{k: jnp.asarray(v.numpy()) for k, v in vars(st).items()})


def test_state_metrics_match_reference_on_the_same_state():
    """``state_metrics`` of one state (the faucet after 100 steps, and a
    state with no active row, whose density statistics are NaN) against the
    reference's on the same arrays: 1e-6 relative (float32 summation
    order); ``metric_row`` and ``aggregate_run_stats`` equal."""
    scene = tconfig.load_scene_file(ROOT / FAUCET, device="cpu")
    jscene = jconfig.load_scene_file(ROOT / FAUCET)
    st, _ = trun.run_scene(scene, 100)
    rows = []
    for state, step in ((st, 100), (tstate.allocate(64, 2, device="cpu"), 0)):
        got = tmetrics.state_metrics(state, scene.params, step=step)
        want = jmetrics.state_metrics(_to_ref(state), jscene.params, step=step)
        _close(got, want, 1e-6)
        assert tmetrics.metric_row(got)[:3] == jmetrics.metric_row(want)[:3]
        rows.append((got, want))
    assert math.isnan(rows[1][0]["max_density"]) and math.isnan(rows[1][0]["min_density"])
    assert tmetrics.METRIC_COLUMNS == jmetrics.METRIC_COLUMNS
    got_agg = tmetrics.aggregate_run_stats([rows[0][0], rows[0][0]])
    assert got_agg == jmetrics.aggregate_run_stats([rows[0][0], rows[0][0]])
    assert tmetrics.aggregate_run_stats([]) == {"samples": 0}
    assert np.isfinite(got_agg["kinetic_energy_avg"])
