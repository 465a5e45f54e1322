"""The program's phase spans and host-read counters on the CPU.

``utils.profiling.annotate`` records a ``sph.*`` span only while a profiler
records, and is otherwise one shared no-op context; each step records its
phases in order, a rebin nested in its check; ``maybe_rebin.checks`` and
``drift_reads`` count the check's two host reads; and a step's result is
the same bits with and without a profiler recording. The scene runner's
emission records ``sph.emit`` once an epoch and ``emit_due.calls`` counts
it, with the same bits as the emission without its span.
"""

import pytest
import torch
from torch.autograd import DeviceType

from sph_pie_torch.scenes import builders as tb
from sph_pie_torch.scenes import emitter
from sph_pie_torch.solvers import pbf, run, wcsph_binned
from sph_pie_torch.utils import profiling
from sph_pie_torch.utils.struct import replace

CHECK, PREDICT, PROJECT = "sph.rebin_check", "sph.predict", "sph.project"

# Each solver's step, and the top-level spans one step records, in order.
STEPS = {
    "wcsph": (None, [CHECK, "sph.density", "sph.forces", "sph.integrate"]),
    "pbf_ride": (dict(iters=2, sor=0.9, proj_cap_h=0.0625, epilogue="ride"),
                 [CHECK, PREDICT] + [CHECK, PROJECT] * 2 + [CHECK, "sph.epilogue"]),
    # "gather" stashes the step-start state before the entry check.
    "pbf_gather": (dict(iters=3, epilogue="gather"),
                   [PREDICT, CHECK, PREDICT] + [CHECK, PROJECT] * 3 + [CHECK, "sph.epilogue"]),
}


@pytest.fixture(scope="module")
def scene():
    return tb.dam_break_2d(300, device="cpu")


def stepper(scene, solver: str):
    knobs = STEPS[solver][0]
    if knobs is None:
        return lambda b: wcsph_binned.step(scene.params, scene.bgrid, b)
    pp = pbf.make_pbf_params(**knobs, dtype=scene.state.pos.dtype, device="cpu")
    return lambda b: pbf.step(scene.params, scene.bgrid, pp, b)


def checked(scene, travel_thr: float, drift_skins: float):
    """The binned scene with ``travel`` at ``travel_thr`` times the check's
    threshold (skin/2) and one moving particle ``drift_skins`` skins from
    its bin-time position."""
    g = scene.bgrid
    b = scene.binned_state()
    thr = 0.5 * g.skin
    slot = int(torch.nonzero(b.valid)[len(b.valid.nonzero()) // 2])
    pos = b.pos.clone()
    pos[slot, 0] += drift_skins * g.skin
    return replace(b, pos=pos, travel=torch.full_like(b.travel, travel_thr * thr))


def spans(prof) -> list[tuple[str, float, float]]:
    """The host's ``sph.*`` spans of a profile, in time order."""
    out = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
           if e.name.startswith("sph.") and e.device_type != DeviceType.CUDA]
    return sorted(out, key=lambda s: s[1])


def top_level(got: list[tuple[str, float, float]]) -> list[str]:
    """The names of the spans that no earlier span encloses."""
    out, end = [], float("-inf")
    for name, a, b in got:
        if a >= end:
            out.append(name)
            end = b
    return out


def test_annotate_without_a_profiler_is_one_shared_no_op():
    a, b = profiling.annotate("sph.a"), profiling.annotate("sph.b")
    assert a is b
    with a as got:
        assert got is None
    with profiling.device_trace() as prof:
        with profiling.annotate("sph.inside"):
            torch.ones(8).sum()
    with profiling.annotate("sph.after"):
        torch.ones(8).sum()
    assert [s[0] for s in spans(prof)] == ["sph.inside"]


@pytest.mark.parametrize("solver", STEPS)
def test_step_without_a_profiler_opens_no_span(scene, solver, monkeypatch):
    """No ``record_function`` is made, rebin included."""
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    b = checked(scene, 1.1, 0.6)
    out = stepper(scene, solver)(b)
    assert int(out.n_rebins) > int(b.n_rebins)


@pytest.mark.parametrize("solver", STEPS)
def test_step_records_its_phases_in_order(scene, solver):
    step = stepper(scene, solver)
    with profiling.device_trace() as prof:
        step(scene.binned_state())
    assert top_level(spans(prof)) == STEPS[solver][1]


def test_rebin_nests_in_its_check(scene):
    with profiling.device_trace() as prof:
        out = stepper(scene, "wcsph")(checked(scene, 1.1, 0.6))
    assert int(out.n_rebins) == 1
    got = spans(prof)
    assert [s[0] for s in got] == [CHECK, "sph.rebin", "sph.density", "sph.forces",
                                   "sph.integrate"]
    (_, c0, c1), (_, r0, r1) = got[:2]
    assert c0 <= r0 <= r1 <= c1
    assert top_level(got) == STEPS["wcsph"][1]


@pytest.mark.parametrize("travel_thr,drift_skins,moved", [
    (0.9, 0.0, (1, 0, 0)),
    (1.1, 0.1, (1, 1, 0)),
    (1.1, 0.6, (1, 1, 1)),
], ids=["below", "above_small_drift", "above_large_drift"])
def test_rebin_check_counts_its_host_reads(scene, travel_thr, drift_skins, moved):
    """(checks, drift_reads, n_rebins) move by exactly ``moved``."""
    mr = wcsph_binned.maybe_rebin
    b = checked(scene, travel_thr, drift_skins)
    before = (mr.checks, mr.drift_reads)
    out = mr(scene.bgrid, b)
    assert (mr.checks - before[0], mr.drift_reads - before[1],
            int(out.n_rebins) - int(b.n_rebins)) == moved


@pytest.mark.parametrize("solver", STEPS)
def test_step_is_the_same_bits_under_the_profiler(scene, solver):
    step = stepper(scene, solver)
    b = checked(scene, 1.1, 0.6)
    plain = step(b)
    with profiling.device_trace():
        traced = step(b)
    assert int(plain.n_rebins) > int(b.n_rebins)
    for k, v in vars(plain).items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, getattr(traced, k)), k


# The faucet at 256 rows: three epochs of 40 steps emit at steps 0 and 80.
FAUCET_STEPS, FAUCET_EPOCH = 120, 40


@pytest.fixture(scope="module")
def faucet():
    return tb.emitter_2d(256, device="cpu")


def run_faucet(faucet):
    return run.run_scene(faucet, FAUCET_STEPS, epoch_steps=FAUCET_EPOCH)[0]


def test_emission_records_one_span_an_epoch(faucet):
    """Inside a trace, ``run_scene`` records ``sph.emit`` at each epoch's
    start, before the epoch's steps, and ``emit_due.calls`` counts each."""
    epochs = FAUCET_STEPS // FAUCET_EPOCH
    before = emitter.emit_due.calls
    with profiling.device_trace() as prof:
        st = run_faucet(faucet)
    assert emitter.emit_due.calls - before == epochs
    top = top_level(spans(prof))
    assert top.count("sph.emit") == epochs
    starts = [i for i, name in enumerate(top) if name == "sph.emit"]
    assert starts == [i * (1 + FAUCET_EPOCH * 4) for i in range(epochs)]
    assert int(st.active.sum()) == 6


def emit_due_unspanned(state, em, step_count, dt, clearance):
    """``emitter.emit_due``'s arithmetic with no span and no counter."""
    due = (em.spawn_step >= 0) & (em.spawn_step <= step_count) & ~state.active
    late = (step_count - em.spawn_step).to(em.spawn_pos.dtype) * dt
    pos = em.spawn_pos + em.spawn_vel * late[:, None]
    due = emitter.clear(due, pos, state, clearance)
    d2 = due[:, None]
    return replace(
        state,
        pos=torch.where(d2, pos, state.pos),
        vel=torch.where(d2, em.spawn_vel, state.vel),
        mass=torch.where(due, em.spawn_mass, state.mass),
        active=state.active | due,
    )


def test_emission_is_the_same_bits_with_its_span(faucet, monkeypatch):
    """With no profiler recording no ``record_function`` is made; the state
    is the same bits as under a profiler and as with the emission before
    its span."""
    with profiling.device_trace():
        traced = run_faucet(faucet)

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler recording")

    with monkeypatch.context() as m:
        m.setattr(torch.profiler, "record_function", refuse)
        plain = run_faucet(faucet)
    monkeypatch.setattr(emitter, "emit_due", emit_due_unspanned)
    before = run_faucet(faucet)
    for k, v in vars(plain).items():
        assert torch.equal(v, getattr(traced, k)), k
        assert torch.equal(v, getattr(before, k)), k
