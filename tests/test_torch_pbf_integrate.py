"""PBF's per-slot passes (``solvers/integrate.py``: ``project``,
``pbf_velocity``, ``pbf_mix``).

On the CPU each must give the bits of the torch lines ``pbf.step`` ran
before they became modes of the update kernel (``old_project``,
``old_velocity`` and the three ``old_*`` lines after a fold below, copied
from it) and launch nothing. The card tests hold each mode of
``csrc/integrate.cu`` against its plain version on the card, bit for bit, NaN
rows included, and one PBF step's ``sph.project`` and ``sph.epilogue`` spans
to the folds, the new launches, the scratch fill and the clock's add: no
torch pass over the slots.

The cases: 2D and 3D, a periodic channel (an axis without walls, with
displacements of half a period and of a whole one), frozen boundary slots,
float32 and float64, with slots past the walls, displacements past the
projection cap and under it, speeds past the clamp, virgin rows (no previous
density), a NaN row in each input, and the step-start positions as the
"ride" epilogue reads them (the vel slots) and as "gather" reads them (owner
gathers of a stash).

    python -m pytest tests/test_torch_pbf_integrate.py -m card --noconftest  # on a card
"""

import numpy as np
import pytest
import torch

from h100bench import spans, tracing
from sph_pie_torch.neighbors import binned as nb
from sph_pie_torch.scenes import builders as tb
from sph_pie_torch.solvers import integrate, pbf
from sph_pie_torch.solvers.wcsph import clamp_speed
from sph_pie_torch.solvers.wcsph_binned import wall_axes

CASES = ("2d", "2d_frozen", "3d", "3d_frozen", "3d_periodic")
MODES = ("project", "velocity_ride", "velocity_gather", "mix_fused", "mix_vorticity", "mix_xsph")
DTYPES = (torch.float32, torch.float64)
COUNTERS = ("project", "pbf_velocity", "pbf_mix")


def launches() -> tuple[int, ...]:
    return tuple(getattr(integrate, c).launches for c in COUNTERS)


def fmask(grid, b):
    return (b.valid & ~nb.frozen_mask(grid, b))[:, None]


def old_project(params, grid, b, dx, sor, proj_cap):
    """One projection's apply in ``pbf.step`` from dx_fold's sum, as it was
    written before the kernel."""
    periodic = any(grid.periodic)
    walls = wall_axes(grid)
    if periodic:
        wall_mask = nb.axis_vector(walls, torch.bool, b.pos.device)[None, :]

    def clip_box(x):
        c = torch.clamp(x, params.bound_min, params.bound_max)
        return torch.where(wall_mask, c, x) if periodic else c

    v = fmask(grid, b)
    dx = sor * dx
    n = torch.sqrt(torch.clamp((dx * dx).sum(-1, keepdim=True), min=1e-30))
    dx = torch.where(v, dx * torch.clamp(proj_cap / n, max=1.0), 0.0)
    x = clip_box(b.pos + dx)
    travel = b.travel + torch.sqrt(torch.clamp((dx * dx).sum(-1).amax(), min=0.0))
    return torch.where(v, x, b.pos), travel


def old_velocity(params, grid, b, pos0, rho_prev):
    """The epilogue's lines from x* = ``b.pos`` to the velocity before the
    final fold, as they were written before the kernel."""
    valid = fmask(grid, b)
    x_star = b.pos
    m_rho = b.mass / torch.where(rho_prev > 0, rho_prev, params.rest_density)
    disp = x_star - pos0
    if any(grid.periodic):
        order = grid.axis_order or tuple(range(grid.dim))
        lengths = [
            grid.dims[order.index(sa)] * grid.cell_size
            if grid.periodic[order.index(sa)]
            else 0.0
            for sa in range(grid.dim)
        ]
        L = nb.axis_vector(lengths, disp.dtype, disp.device)[None, :]
        safe_L = torch.where(L > 0, L, 1.0)
        disp = torch.where(L > 0, disp - L * torch.round(disp / safe_L), disp)
    new_vel = torch.where(valid, disp / params.dt, 0.0)
    return m_rho, clamp_speed(params, new_vel)


def old_fused(params, grid, b, new_vel, rho, dv):
    """After the fused density + XSPH fold."""
    valid = fmask(grid, b)
    floor = 1e-6 * params.rest_density
    rho = torch.maximum(torch.where(b.valid, rho, 0.0), floor)
    new_vel = new_vel + params.xsph_eps * torch.where(valid, dv, 0.0)
    return rho, torch.where(valid, clamp_speed(params, new_vel), 0.0)


def old_vorticity(params, grid, pp, b, new_vel, f_vort):
    """After the vorticity folds."""
    valid = fmask(grid, b)
    new_vel = new_vel + (pp.vort_eps * params.dt) * torch.where(valid, f_vort, 0.0)
    return torch.where(valid, clamp_speed(params, new_vel), 0.0)


def old_xsph(params, grid, b, new_vel, dv):
    """After the XSPH fold that follows the vorticity folds."""
    valid = fmask(grid, b)
    new_vel = new_vel + params.xsph_eps * torch.where(valid, dv, 0.0)
    return torch.where(valid, clamp_speed(params, new_vel), 0.0)


def make_case(name: str, dtype, device: str, seed: int = 5):
    """(params, grid, state, PBF knobs, inputs by name) of a small scene:
    occupied slots jittered by up to h/2 (some past a wall); a dx sum of
    N(0, 0.1 h) on every slot (past the cap h/16 on most moving slots,
    under it on some); step-start positions dt N(0, 30) m/s behind
    (many speeds past the 40 m/s clamp), on a periodic axis also whole
    periods away and, in two slots, half a period (round to even gives 0);
    a previous density of 900-1100 with virgin rows (0); a velocity N(0,
    30), a sum N(0, 300) and a fold density as the epilogue's folds give
    them; a NaN row in each input, each in its own moving slot."""
    frozen = 1 if "frozen" in name else 0
    if name.startswith("2d"):
        s = tb.dam_break_2d(200, dtype=dtype, device=device, wall_layers=frozen,
                            xsph_eps=0.1)
    elif "periodic" in name:
        s = tb.dam_break_3d_periodic(400, dtype=dtype, device=device)
    else:
        s = tb.dam_break_3d(400, dtype=dtype, device=device, wall_layers=frozen)
    params, grid, b = s.params, s.bgrid, s.binned_state()
    rng = np.random.default_rng(seed)
    S, dim = b.pos.shape
    h, dt = float(params.h), float(params.dt)

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    moving = torch.nonzero(fmask(grid, b)[:, 0]).flatten().tolist()
    pos = b.pos + t(rng.uniform(-0.5, 0.5, (S, dim)) * h) * b.valid[:, None]
    pos0 = pos - dt * t(rng.normal(0.0, 30.0, (S, dim)))
    lengths = integrate.periods(grid, dtype, device)
    if lengths is not None:
        pos0 = pos0 + lengths * t(rng.integers(-1, 2, (S, dim)))
        axis = int(torch.nonzero(lengths).flatten()[0])
        half = 0.5 * lengths[axis]
        for slot, (x, x0) in zip(moving[3:5], ((half, 0.0), (0.0, half)), strict=True):
            pos[slot, axis], pos0[slot, axis] = x, x0  # x* - x0 = +-L/2 exactly
    b = nb.BinnedState(**{**vars(b), "pos": pos, "travel": t(0.01)})
    rho_prev = t(rng.uniform(900.0, 1100.0, S)) * t(rng.uniform(0, 1, S) > 0.1)
    inputs = {
        "dx": t(rng.normal(0.0, 0.1 * h, (S, dim))),
        "pos0": pos0,
        "rho_prev": rho_prev,
        "vel": t(rng.normal(0.0, 30.0, (S, dim))),
        "dv": t(rng.normal(0.0, 300.0, (S, dim))),
        "rho": t(rng.uniform(900.0, 1100.0, S)),
    }
    for slot, key in zip(moving, ("dx", "pos0", "rho_prev", "vel", "dv", "rho")):
        inputs[key][slot] = float("nan")
    pp = pbf.make_pbf_params(iters=2, sor=0.9, proj_cap_h=0.0625, vort_eps=0.3, dtype=dtype,
                             device=device)
    return params, grid, b, pp, inputs


def gathered(b, pos0, rho_prev):
    """(x0, rho_prev) as the "gather" epilogue reads them: owner gathers of
    a stash indexed by owner (``pbf.step``'s lines)."""
    K = int(b.owner.max()) + 1
    stash_pos = pos0.new_zeros((K, pos0.shape[1]))
    stash_rho = rho_prev.new_zeros(K)
    live = b.owner >= 0
    stash_pos[b.owner[live].long()] = pos0[live]
    stash_rho[b.owner[live].long()] = rho_prev[live]
    own = torch.clamp(b.owner, 0, stash_pos.shape[0] - 1).to(torch.int64)
    return stash_pos[own], stash_rho[own]


def proj_cap_of(params, grid, pp):
    return torch.clamp(pp.proj_cap_h * params.h, max=0.5 * grid.skin)


def run_mode(mode: str, case, plain: bool):
    """(new, old) outputs of ``mode`` on ``case``: the entry point (or its
    plain version) and the old lines."""
    params, grid, b, pp, x = case
    P = (lambda fn: getattr(integrate, f"{fn}_plain")) if plain else (
        lambda fn: getattr(integrate, fn))
    if mode == "project":
        args = (x["dx"], pp.sor, proj_cap_of(params, grid, pp))
        new = P("project")(params, grid, b, wall_axes(grid), *args)
        return new, old_project(params, grid, b, *args)
    if mode.startswith("velocity"):
        pos0, rho_prev = x["pos0"], x["rho_prev"]
        if mode == "velocity_ride":
            b = nb.BinnedState(**{**vars(b), "vel": pos0, "density": rho_prev})
            pos0, rho_prev = b.vel, b.density
        else:
            pos0, rho_prev = gathered(b, pos0, rho_prev)
        new = P("pbf_velocity")(params, grid, b, pos0, rho_prev)
        return new, old_velocity(params, grid, b, pos0, rho_prev)
    mix = P("pbf_mix")
    if mode == "mix_fused":
        new = mix(params, grid, b, x["vel"], x["dv"], params.xsph_eps, x["rho"])
        return new, old_fused(params, grid, b, x["vel"], x["rho"], x["dv"])
    if mode == "mix_vorticity":
        new = mix(params, grid, b, x["vel"], x["dv"], pp.vort_eps * params.dt)
        return new, (None, old_vorticity(params, grid, pp, b, x["vel"], x["dv"]))
    new = mix(params, grid, b, x["vel"], x["dv"], params.xsph_eps)
    return new, (None, old_xsph(params, grid, b, x["vel"], x["dv"]))


def same_bits(a, b) -> bool:
    """Equal bit for bit (NaN payloads too), or both None."""
    if a is None or b is None:
        return a is None and b is None
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    it = torch.int32 if a.dtype == torch.float32 else torch.int64
    return torch.equal(a.contiguous().view(it), b.contiguous().view(it))


def test_cases_exercise_every_branch():
    """The cases reach what they are named for: frozen slots, an axis
    without walls with half-period displacements, slots whose applied
    displacement leaves the box, displacements past the cap and under it,
    speeds past the clamp, virgin rows and a NaN row in each input; the
    XSPH weight is on."""
    for name in CASES:
        params, grid, b, pp, x = make_case(name, torch.float64, "cpu")
        move = fmask(grid, b)[:, 0]
        assert float(params.xsph_eps) > 0
        assert bool(nb.frozen_mask(grid, b).any()) == ("frozen" in name)
        assert (wall_axes(grid) is not None) == ("periodic" in name)
        d = pp.sor * x["dx"][move]
        n = torch.linalg.vector_norm(d, dim=-1)
        cap = proj_cap_of(params, grid, pp)
        assert bool((n > cap).any()) and bool((n < cap).any())
        y = b.pos[move] + d * torch.clamp(cap / n, max=1.0)[:, None]
        assert bool(((y < params.bound_min) | (y > params.bound_max)).any())
        v = (b.pos - x["pos0"])[move] / params.dt
        assert bool(((v * v).sum(-1) > params.max_speed**2).any())
        assert bool(((x["vel"] * x["vel"]).sum(-1)[move] > params.max_speed**2).any())
        assert bool((x["rho_prev"][b.valid] == 0).any())
        for key, t in x.items():
            rows = torch.isnan(t.reshape(t.shape[0], -1)).any(-1)
            assert rows.sum() == 1 and bool(move[rows].all()), key
        if "periodic" in name:
            L = integrate.periods(grid, torch.float64, "cpu")
            q = (b.pos - x["pos0"]) / torch.where(L > 0, L, 1.0)
            assert bool((q.abs() == 0.5).any()) and bool((q.abs() > 0.5).any())


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("mode", MODES)
def test_cpu_gives_the_old_lines(mode, name, dtype):
    before = launches()
    new, old = run_mode(mode, make_case(name, dtype, "cpu"), plain=False)
    assert all(same_bits(n, o) for n, o in zip(new, old, strict=True))
    assert launches() == before


def test_cpu_step_launches_nothing():
    """``pbf.step`` on CPU tensors takes the plain versions: no launch."""
    s = tb.dam_break_2d(200, dtype=torch.float64, device="cpu")
    before = launches()
    pbf.step(s.params, s.bgrid, pbf.flagship_params(dtype=torch.float64, device="cpu"),
             s.binned_state())
    assert launches() == before


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the card tests run on the H100")
    return "cuda"


@pytest.mark.card
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("mode", MODES)
def test_kernel_gives_the_plain_bits(card, mode, name, dtype):
    case = make_case(name, dtype, card)
    before = launches()
    got, _ = run_mode(mode, case, plain=False)
    want, _ = run_mode(mode, case, plain=True)
    torch.cuda.synchronize()
    k = 0 if mode == "project" else 1 if mode.startswith("velocity") else 2
    assert launches() == tuple(c + (i == k) for i, c in enumerate(before))
    assert all(same_bits(g, w) for g, w in zip(got, want, strict=True)), [
        (g - w).abs().nan_to_num(0.0).max().item() if g is not None else None
        for g, w in zip(got, want, strict=True)]


# The aten operations that may take a whole per-slot tensor inside the
# spans: they make a new tensor like it and run nothing on the card.
ALLOCATIONS = {"aten::empty_like", "aten::empty", "aten::empty_strided"}


@pytest.mark.card
def test_step_enqueues_no_torch_pass_over_the_slots(card):
    """One flagship ``pbf.step`` under the profiler: its ``sph.project``
    spans enqueue the two folds and one ``project`` launch each, its
    ``sph.epilogue`` the density + XSPH fold and the two epilogue launches;
    no aten operation inside them takes a per-slot tensor but to allocate
    one like it, and nothing on the card there reduces but the kernels."""
    s = tb.dam_break_3d(400, dtype=torch.float32, device=card)
    grid, b = s.bgrid, s.binned_state()
    pp = pbf.flagship_params(device=card)
    b = pbf.step(s.params, grid, pp, b)  # builds and warms up
    before = launches()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA],
                                record_shapes=True) as prof:
        pbf.step(s.params, grid, pp, b)
        torch.cuda.synchronize()
    assert launches() == (before[0] + pp.iters, before[1] + 1, before[2] + 1)
    sl = tracing.reduce(prof, 1, 0.0)
    S = grid.num_slots
    for span, n_spans, kernels in (("sph.project", pp.iters, {"integrate_slots<": 1,
                                                             "pbf_walk<": 2}),
                                   ("sph.epilogue", 1, {"integrate_slots<": 2,
                                                        "pbf_runs<": 1})):
        got = spans.ops_in(sl, span)
        assert got is not None and got[1] == n_spans, "enqueues and device ops do not pair"
        names = [name for name, _, _ in got[0]]
        for kernel, per_span in kernels.items():
            assert sum(kernel in n for n in names) == per_span * n_spans, (span, names)
        rest = [n for n in names if not any(k in n for k in kernels)]
        assert not any("reduce" in n.lower() for n in rest), (span, rest)
        windows = sorted((s0, e0) for n, s0, e0 in sl.host if n == span)
        passes = [
            e.name for e in prof.events()
            if e.name.startswith("aten::") and e.name not in ALLOCATIONS
            and any(a <= e.time_range.start and e.time_range.end <= z for a, z in windows)
            and any(len(shape) > 0 and shape[0] == S for shape in e.input_shapes)
        ]
        assert not passes, (span, passes)
