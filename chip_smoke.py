"""Drive the PyTorch/CUDA port (``sph_pie_torch``) on one NVIDIA card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phase A builds the CUDA kernels from ``sph_pie_torch/csrc`` and holds each
against its plain PyTorch version on the card, on a 3D dam break (100k
particles, cap 40, cohesion and XSPH on) and a 2D dam break (4096, cap 32)
advanced 10 steps; the 2D run is also checked end to end against the same
10 steps on the CPU (plain versions only), and a 2D scene binned into
cap-8 cells checks the placement of overfull cells against the CPU.
Density and forces are also checked where their staged windows pass slot
0 and slot S (a 3D 20k scene with two particles binned into the first and
the last interior cell, in float32 and float64), in float64 on the 2D
scene, and on the full cap-8 cells of the overfull scene. ``expand`` is
also held bit for bit against its plain version on ragged inputs made from a
seed (4 to 8 columns, caps 8, 32 and 40 through its 16-byte arm and cap 5
through its per-slot arm, both dtypes, more overfull cells than the
reference kernel's slack absorbs, rows that would pass K, K = 0, inputs
that start off a 16-byte boundary).

Phase A also holds the four kernels of the reference's drop-in and
hardware-harness paths against their plain versions: both window
densities and the tensor-core forces (both arms) on a cap-32 3D dam break
(100k, skin 0.25, no cohesion) and the 2D one, the center-slab density
(dense, compact at K = 32 and K = 4) on the cap-40 3D dam break. The
unmasked window density is also checked on that 3D state after some of its
empty slots were given positions of their own inside the fluid, at cap 32
(its runs arm) and rebinned at cap 30 (its one-thread-per-slot arm).

Phase B drives the main path at the flagship size — ``dam_break_3d(1M)``,
``bin_state``, 5 warm steps, 3 timed reps of 20 steps — with every launch
counter reset just before and read just after, then times each kernel
against its plain version on the final state and checks them again there.

Phase C drives the path of those four kernels at 1M, with their launch
counters reset just before and read just after: C1 is the scene of
``scripts/micro_mxu_vmem.py`` (``dam_break_3d(1M)`` at skin 0.25, cap 32,
no cohesion) advanced 5 steps, with density and pressure from ``density``,
through ``density_cap32``, ``density_window`` and ``forces_mma`` in both
arms; C2 is Phase B's final state through the center-slab arms (dense,
and compact at K = 32 and at K = 4, which truncates there). Each output is
then checked against its plain version (and ``density_cap32`` and the
float32 ``forces_mma`` against the main path's ``density`` and
``forces``), and each kernel is timed against its plain version.

Any failed check raises, so the script exits non-zero; it also exits
non-zero, printing no result, when no CUDA device is available. On success
the line before the last is a JSON object with one entry per kernel (its
launches on its path, error, ms, plain ms, ``bound_ms``: the least time of
its work on this state at the card's published peaks, ``bound_by`` and
``library_ms``), and the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

# Error bounds, each with its reason.
DENSITY_RTOL = 1e-5   # f32, summation order only (gather vs fold)
FORCES_ATOL = 1e-5    # f32, scale-normalised: max|diff| / max|plain|
DENSITY_RTOL_F64 = 1e-12  # the f64 arms, summation order only
FORCES_ATOL_F64 = 1e-10   # f64, scale-normalised
TRAJ_ATOL = 1e-5      # f32 max |dpos| after 10 steps, card vs CPU, domain ~1 m
WINDOW_RTOL = 1e-5    # window densities, f32, summation order only; also
                      # density_cap32 vs density (h from the grid vs params.h:
                      # equal up to rounding)
SLAB_RTOL = 1e-5      # center slab, f32, summation order only (r^2 and the
                      # in-support test are bit-equal in kernel and plain)
MMA_F32_ATOL = 1e-5   # forces_mma f32 (3xTF32) vs its plain version (float64
                      # contraction), scale-normalised; also vs forces
                      # (moment form vs direct sum, h rounding)
MMA_BF16_ATOL = 1e-3  # forces_mma bf16 vs its bf16 plain version, scale-
                      # normalised: 1-ulp f32 differences in a plane or a
                      # feature can flip a bf16 rounding
C_STEPS = 5           # C1: steps before the kernels run (micro_mxu_vmem.py)
SLAB_K = 32           # compact K at 1M (micro_compact.py's default)
SLAB_K_CUT = 4        # a compact K that truncates at 1M, so the first-K rule
                      # is checked there too (K = 32 truncates nothing there)

# The least time of a kernel's work (bound_ms): the larger of its bytes (each
# input read once, each output written once) over the memory rate and its
# operations over the float32 rate outside the tensor cores. Published peaks
# of one H100 SXM at its 700 W limit (NVIDIA's data sheet).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
# Float operations per pair in support, counted in the kernels' pair math:
# density: r^2 (3 sub, 3 mul, 2 add), q, m (c6 q q q), the sum: 14.
DENSITY_PAIR_FLOPS = 14
# forces: r^2 (8), rsqrt, r, q, q^2 C_s, the pressure term (3), 1/r, the
# viscous weight (2), per axis dv and two multiply-adds (15): 34; cohesion
# adds 11, XSPH 11 (its weight 5, per axis a multiply-add).
FORCES_PAIR_FLOPS, COHESION_FLOPS, XSPH_FLOPS = 34, 11, 11

KERNELS = {
    "density": (
        "sph_pie_torch/csrc/density.cu",
        "sph_pie_tpu/neighbors/pallas_sym.py:408",
    ),
    "forces": (
        "sph_pie_torch/csrc/forces.cu",
        "sph_pie_tpu/neighbors/pallas_pair.py:462",
    ),
    "expand": (
        "sph_pie_torch/csrc/expand.cu",
        "sph_pie_tpu/neighbors/pallas_rebin.py:91",
    ),
    "density_cap32": (
        "sph_pie_torch/csrc/density.cu",
        "sph_pie_tpu/neighbors/pallas_pair.py:292",
    ),
    "density_window": (
        "sph_pie_torch/csrc/density.cu",
        "sph_pie_tpu/neighbors/pallas_density.py:91",
    ),
    "center_slab_dense": (
        "sph_pie_torch/csrc/center_slab.cu",
        "scripts/micro_compact.py:106",
    ),
    "center_slab_compact": (
        "sph_pie_torch/csrc/center_slab.cu",
        "scripts/micro_compact.py:106",
    ),
    "forces_mma": (
        "sph_pie_torch/csrc/forces_mma.cu",
        "scripts/micro_mxu_vmem.py:248",
    ),
    "forces_mma_bf16": (
        "sph_pie_torch/csrc/forces_mma.cu",
        "scripts/micro_mxu_vmem.py:248",
    ),
}


class CheckFailed(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def cuda_ms(fn, reps: int, warm: int = 1) -> float:
    """Mean device time of ``fn()`` in ms, by CUDA events over ``reps``."""
    for _ in range(warm):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def timed(fn):
    """(fn(), device ms of that one call) by CUDA events. The plain versions
    run for a second or more, so each is timed in the call that checks it."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


@contextlib.contextmanager
def counting_syncs(counts: list[int]):
    """Count implicit device-to-host syncs (torch's sync debug mode warns
    at each one) inside the block; appends the count to ``counts``."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode("default")
    counts.append(sum("synchroniz" in str(w.message) for w in caught))


def differing_fields(card, cpu) -> list[str]:
    """Names of the fields where a card state and a CPU state differ."""
    return [k for k in vars(cpu) if not torch.equal(getattr(card, k).cpu(), getattr(cpu, k))]


def scaled(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| / max |want| (scale-normalised absolute error)."""
    return ((got - want).abs().max() / want.abs().max().clamp(min=1e-30)).item()


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    """(least ms for the work, what bounds it: "bytes" or "operations")."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def pairs_in_support(grid, b, h2) -> int:
    """Pairs of an occupied home slot and an occupied slot of its slab
    windows with r^2 < h^2: the pair work that state ``b`` needs."""
    from sph_pie_torch.neighbors import binned as nb

    def pair(carry, home, w):
        _, r2 = nb._r2(grid.dim, home, w)
        return (carry[0] + ((r2 < h2) & (w["mass"][:, None, :] != 0)).sum(2),)

    fields = {**nb._planar("p", b.pos), "mass": b.mass}
    init = torch.zeros_like(b.mass, dtype=torch.int64)
    (n,) = nb.slab_fold(grid, fields, pair, (init,))
    return int(n[b.mass != 0].sum())


def empty_home_pairs(grid, b, h2) -> int:
    """Pairs of an empty home slot (at pos 0) and an occupied window slot
    within h of the origin: the extra work of a kernel without valid mask."""
    C, cap = grid.num_cells, grid.cap
    near = ((b.mass != 0) & ((b.pos * b.pos).sum(1) < h2)).nonzero()[:, 0] // cap
    empty = cap - (b.mass.reshape(C, cap) != 0).sum(1)
    # slot j lies in a window of cell c iff c = cell(j) - shift - o, o in -1..1
    offs = torch.tensor([sh + o for sh in grid.slab_shifts() for o in (-1, 0, 1)],
                        device=near.device)
    c = near[:, None] - offs[None, :]
    return int(empty[c.clamp(0, C - 1)][(c >= 0) & (c < C)].sum())


def center_slab_pairs(inputs, h2) -> torch.Tensor:
    """[C, cap] candidates in support (r^2 < h^2, m > 0) per home slot of
    the center-slab inputs, all home slots included."""
    hx, hy, hz, _, wx, wy, wz, wm = inputs
    C, cap = hx.shape
    out = torch.empty_like(hx, dtype=torch.int64)
    chunk = max(1, 8 * 1024 * 1024 // (3 * cap * cap))
    for c0 in range(0, C, chunk):
        sl = slice(c0, c0 + chunk)
        r2 = ((wx[sl][:, None, :] - hx[sl][:, :, None]) ** 2
              + (wy[sl][:, None, :] - hy[sl][:, :, None]) ** 2
              + (wz[sl][:, None, :] - hz[sl][:, :, None]) ** 2)
        out[sl] = ((r2 < h2) & (wm[sl][:, None, :] > 0)).sum(2)
    return out


def kernel_row(name: str, launches: int, err: float, ms: float, p_ms: float,
               least: tuple[float, str]) -> dict:
    """One entry of the ``{"kernels": [...]}`` line. No single PyTorch call
    computes any of these functions (a cut-off sum over slab windows, the
    slot placement of ``expand``), so ``library_ms`` is null."""
    src, replaces = KERNELS[name]
    print(f"  {name:19s} kernel {ms:.3f} ms, plain {p_ms:.3f} ms, bound {least[0]:.4f} ms "
          f"({least[1]})")
    return {
        "name": name, "route": "cuda", "source": src, "replaces": replaces,
        "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": p_ms,
        "bound_ms": least[0], "bound_by": least[1], "library_ms": None,
    }


def compare_kernels(params, grid, b, rtol=DENSITY_RTOL, atol=FORCES_ATOL, with_expand=True):
    """Each kernel against its plain version on state ``b``; raises past a
    bound. Returns ({name: max abs error}, {name: plain ms} of density and
    forces, ``b`` with density and pressure from the density kernel)."""
    from sph_pie_torch.kernels import eos
    from sph_pie_torch.neighbors import binned as nb
    from sph_pie_torch.neighbors.density import density, density_plain
    from sph_pie_torch.neighbors.expand import expand, expand_plain
    from sph_pie_torch.neighbors.forces import forces, forces_plain
    from sph_pie_torch.utils.struct import replace

    out, plain = {}, {}
    v = b.valid
    rk = density(params, grid, b)
    rp, plain["density"] = timed(lambda: density_plain(params, grid, b))
    rel = ((rk - rp).abs()[v] / rp[v]).max().item()
    out["density"] = (rk - rp).abs().max().item()
    print(f"  density  max rel err {rel:.3e} (bound {rtol:g}), max abs {out['density']:.3e}")
    check(rel <= rtol and torch.equal(rk[~v], rp[~v]), "density kernel disagrees")

    b = replace(b, density=rk, pressure=eos.tait_pressure(params, rk))
    ak, xk = forces(params, grid, b)
    (ap, xp), plain["forces"] = timed(lambda: forces_plain(params, grid, b))
    ea, ex = scaled(ak, ap), scaled(xk, xp)
    out["forces"] = max((ak - ap).abs().max().item(), (xk - xp).abs().max().item())
    print(f"  forces   acc scaled err {ea:.3e}, xsph scaled err {ex:.3e} (bound {atol:g})")
    check(ea <= atol and ex <= atol, "forces kernel disagrees")
    if not with_expand:
        return out, plain, b

    pos, vel, mass, alive = nb._compact(grid, b)
    owner = torch.arange(pos.shape[0], dtype=torch.int32, device=pos.device)
    srt = nb.sort_rows(grid, pos, vel, mass, owner, alive)
    args = (srt.first, srt.count, srt.rows, srt.owner, grid.cap)
    (dk, ok_), (dp, op) = expand(*args), expand_plain(*args)
    same = torch.equal(dk, dp) and torch.equal(ok_, op)
    out["expand"] = (dk - dp).abs().max().item()
    print(f"  expand   equal to plain: {same} (bound: exact)")
    check(same, "expand kernel disagrees")
    return out, plain, b


def phase_a() -> None:
    from sph_pie_torch.neighbors import binned as nb
    from sph_pie_torch.scenes import dam_break_2d, dam_break_3d
    from sph_pie_torch.solvers import wcsph_binned
    from sph_pie_torch.utils.struct import replace

    print("== Phase A: kernels against their plain versions (float32)")
    for make, n in ((dam_break_3d, 100_000), (dam_break_2d, 4096)):
        s = make(n, device="cuda")
        b = wcsph_binned.simulate(s.params, s.bgrid, s.binned_state(), 10)
        print(f" {s.name}({n}): {int(s.state.n_active())} particles, cap {s.bgrid.cap}, "
              f"cohesion {s.params.use_cohesion}, xsph {s.params.use_xsph}")
        check(int(b.overflow) == 0, f"{s.name}: overflow")
        compare_kernels(s.params, s.bgrid, b)

        # expand through rebin, on nudged positions: card vs CPU, exact
        rng = np.random.default_rng(3)
        noise = torch.as_tensor(
            rng.uniform(-0.4, 0.4, tuple(b.pos.shape)) * s.bgrid.skin,
            dtype=b.pos.dtype, device="cuda",
        )
        bn = replace(b, pos=b.pos + noise * b.valid[:, None])
        on_card = nb.rebin(s.bgrid, bn)
        on_cpu = nb.rebin(s.bgrid, type(bn)(**{k: t.cpu() for k, t in vars(bn).items()}))
        diff = differing_fields(on_card, on_cpu)
        print(f"  rebin    card == CPU in all 13 fields: {not diff} {diff or ''}"
              f"(overflow {int(on_card.overflow)})")
        check(not diff, f"rebin differs from the CPU in {diff}")

        if s.bgrid.dim == 2:  # end to end: 10 steps on the card vs the CPU
            sc = make(n, device="cpu")
            bc = wcsph_binned.simulate(sc.params, sc.bgrid, sc.binned_state(), 10)
            cap = s.state.capacity
            pg = nb.unbin(s.bgrid, b, cap).pos.cpu()
            err = (pg - nb.unbin(sc.bgrid, bc, cap).pos).abs().max().item()
            print(f"  10 steps card vs CPU: max |dpos| {err:.3e} (bound {TRAJ_ATOL:g})")
            check(err <= TRAJ_ATOL, "trajectory differs from the CPU")

    edge_runs()
    print(" expand on ragged rows:")
    expand_cases()

    # The float64 arms of density and forces on the 2D state.
    s = dam_break_2d(4096, dtype=torch.float64, device="cuda")
    b = wcsph_binned.simulate(s.params, s.bgrid, s.binned_state(), 10)
    print(f" {s.name}(4096) float64: cap {s.bgrid.cap}")
    compare_kernels(s.params, s.bgrid, b, DENSITY_RTOL_F64, FORCES_ATOL_F64, with_expand=False)

    # Overfull cells: a 2D dam break binned into cap-8 cells drops rows.
    s = dam_break_2d(400, bcap=8, device="cuda")
    on_card = s.binned_state()
    on_cpu = dam_break_2d(400, bcap=8, device="cpu").binned_state()
    diff = differing_fields(on_card, on_cpu)
    print(f" dam_break_2d(400, cap 8): bin_state card == CPU in all 13 fields: {not diff} "
          f"{diff or ''}(overflow {int(on_card.overflow)})")
    check(not diff and int(on_card.overflow) > 0, f"overflowing bin_state differs in {diff}")
    # full cells at the smallest cap: the smallest staged spans
    compare_kernels(s.params, s.bgrid, on_card, with_expand=False)


def ragged_rows(rng, C: int, cap: int, ncol: int, dtype, cut: str):
    """(first, count, rows, owner) of C cells on the card: counts up to cap
    with stretches of empty cells, every twelfth cell overfull by up to 2 cap
    rows. ``cut``: "past K" drops the last rows of the last cell, "K == 0"
    drops all rows, "unaligned" starts rows and owner 4 or 8 bytes past a
    16-byte boundary. Returns also the most rows dropped in 128 cells."""
    count = rng.integers(0, cap + 1, C)
    count[rng.integers(0, 2, -(-C // 150)).repeat(150)[:C] == 1] = 0
    over = rng.choice(C, C // 12, replace=False)
    count[over] = cap + rng.integers(1, 2 * cap + 1, len(over))
    count[-1] = cap
    first = np.cumsum(count) - count
    K = int(count.sum())
    if cut == "past K":
        K -= cap // 2
    elif cut == "K == 0":
        K = 0
    dropped = np.add.reduceat(np.maximum(count - cap, 0), np.arange(0, C, 128)).max()
    pad = cut == "unaligned"
    rows = torch.as_tensor(rng.normal(size=K * ncol + pad), dtype=dtype, device="cuda")
    owner = torch.as_tensor(rng.permutation(K + pad), dtype=torch.int32, device="cuda")
    rows, owner = rows[int(pad):].view(K, ncol), owner[int(pad):]
    check(not pad or (rows.data_ptr() % 16 and owner.data_ptr() % 16), "views start aligned")
    first, count = (torch.as_tensor(a, dtype=torch.int32, device="cuda") for a in (first, count))
    return (first, count, rows, owner), int(dropped)


def expand_cases() -> None:
    """``expand`` against ``expand_plain``, bit for bit, in both arms."""
    from sph_pie_torch import _native
    from sph_pie_torch.neighbors import runs
    from sph_pie_torch.neighbors.expand import expand, expand_plain

    rng = np.random.default_rng(11)
    C = 3001
    ran = set()
    for cap in (8, 32, 40, 5):
        for dt in (torch.float32, torch.float64):
            n, most = 0, 0
            for ncol in (5, 6, 7, 8):
                for cut in ("none", "past K", "K == 0", "unaligned"):
                    args, dropped = ragged_rows(rng, C, cap, ncol, dt, cut)
                    (dk, ok_), (dp, op) = expand(*args, cap), expand_plain(*args, cap)
                    check(torch.equal(dk, dp) and torch.equal(ok_, op),
                          f"expand disagrees: cap {cap}, ncol {ncol}, {dt}, {cut}")
                    # the arm the launcher takes for these outputs, by its own rule
                    R = _native.library().sph_expand_run_cells(
                        dk.data_ptr(), ok_.data_ptr(), cap, ncol, dk.element_size())
                    check(R == runs.expand_run_cells(cap, ncol, dk.element_size(), dk, ok_),
                          f"the launcher's runs of {R} cells are not runs.py's")
                    n, most = n + 1, max(most, dropped)
            arm = f"16-byte arm, runs of {R} cells" if R > 0 else "per-slot arm"
            ran.add(R > 0)
            print(f"  expand cap {cap:2d} {str(dt):13s} {arm}: {n} cases equal to plain; up to "
                  f"{most} rows dropped in 128 cells ({most / cap:.1f} caps)")
            check(most > 4 * cap, "too few overfull cells")
    check(ran == {True, False}, "both arms of expand must run")


def window_moved_empties(params, grid, b) -> None:
    """``density_window`` where empty slots do not all sit at zero: in cells
    that hold particles, some empty slots get positions of their own beside
    a particle of the cell (two of them the same one) and one gets a
    particle's position itself. Then the same particles rebinned into cells
    of cap 30, which the runs do not take."""
    import dataclasses

    from sph_pie_torch.neighbors import binned as nb
    from sph_pie_torch.neighbors import runs
    from sph_pie_torch.neighbors.density_window import density_window, density_window_plain
    from sph_pie_torch.utils.struct import replace

    floor = 1e-6 * float(params.rest_density)
    for g, state in ((grid, b), (dataclasses.replace(grid, cap=30), None)):
        if state is None:
            pos, vel, mass, alive = nb._compact(grid, b)
            owner = torch.arange(pos.shape[0], dtype=torch.int32, device=pos.device)
            state = nb._bin_rows(g, pos, vel, mass, owner, alive)
        C, cap = g.num_cells, g.cap
        occ = (state.mass.reshape(C, cap) != 0).sum(1)
        cells = ((occ > 0) & (occ < cap - 2)).nonzero()[:, 0]
        cells = cells[:: max(1, len(cells) // 64)]
        real = cells * cap                  # the cell's first slot holds a particle
        empty = cells * cap + occ[cells]    # its first empty slot, and two more
        pos = state.pos.clone()
        h = float(params.h)
        pos[empty] = pos[real] + 0.3 * h
        pos[empty + 1] = pos[real] + 0.3 * h
        pos[empty + 2] = pos[real] - 0.2 * h
        pos[empty[0] + 2] = pos[real[0]]
        moved = torch.cat([empty, empty + 1, empty + 2])
        check(bool((state.mass[moved] == 0).all() and (state.mass[real] != 0).all()),
              "moved slots must be empty")
        st = replace(state, pos=pos)
        rk, rp = density_window(params, g, st), density_window_plain(params, g, st)
        rel = ((rk - rp).abs() / rp).max().item()
        arm = "runs" if runs.stageable(cap, st.pos, st.mass) else "thread per slot"
        print(f"  density_window cap {cap} ({arm}), {len(moved)} empty slots moved into the fluid: "
              f"max rel err {rel:.3e} over all {rk.numel()} slots (bound {WINDOW_RTOL:g}); "
              f"moved slots above the floor: {int((rk[moved] > 2 * floor).sum())}")
        check(rel <= WINDOW_RTOL, f"density_window disagrees at cap {cap}")
        check(bool((rk[moved] > 2 * floor).all()), "a moved empty slot gathered nothing")


def edge_runs() -> None:
    """Density and forces where the staged windows pass slot 0 and slot S:
    two particles of a 3D dam break (20k, cap 40, whose grid puts the first
    and the last interior cell inside runs that start and end there) moved
    past opposite corners of the box are binned into those cells. In
    float32 and in float64: the float64 3D forces layout (~62 KB) is the one
    that raises the CTA's shared memory above its 48 KB default."""
    from sph_pie_torch.neighbors import binned as nb
    from sph_pie_torch.neighbors import runs
    from sph_pie_torch.scenes import dam_break_3d
    from sph_pie_torch.utils.struct import replace

    for dt, rtol, atol in ((torch.float32, DENSITY_RTOL, FORCES_ATOL),
                           (torch.float64, DENSITY_RTOL_F64, FORCES_ATOL_F64)):
        s = dam_break_3d(20_000, dtype=dt, device="cuda")
        g = s.bgrid
        pos = s.state.pos.clone()
        pos[0], pos[1] = -1.0, 2.0
        b = nb.bin_state(g, replace(s.state, pos=pos), s.boundary)
        occ = (b.mass.reshape(g.num_cells, g.cap) != 0).any(1).nonzero()[:, 0]
        first, last = int(occ[0]), int(occ[-1])
        sh = g.slab_shifts()
        R = runs.run_cells(g.cap)
        below = (first // R * R + min(sh) - 1) * g.cap
        past = (last // R * R + R + max(sh) + 1) * g.cap
        print(f" {s.name}(20000) {dt}: runs of {R} cells at cells {first} and {last}: windows "
              f"from slot {below} to {past} of {g.num_slots}")
        check(below < 0 and past > g.num_slots, "the edge runs do not pass slot 0 and S")
        compare_kernels(s.params, g, b, rtol, atol, with_expand=False)


def with_density(params, grid, b):
    """``b`` with density and pressure from the main path's ``density``."""
    from sph_pie_torch.kernels import eos
    from sph_pie_torch.neighbors.density import density
    from sph_pie_torch.utils.struct import replace

    rho = density(params, grid, b)
    return replace(b, density=rho, pressure=eos.tait_pressure(params, rho))


def micro_outputs(params, grid, b) -> dict:
    """Both window densities and both ``forces_mma`` arms, by the kernels."""
    from sph_pie_torch.micro.forces_mma import forces_mma
    from sph_pie_torch.neighbors.density_window import density_cap32, density_window

    return {
        "density_cap32": density_cap32(params, grid, b),
        "density_window": density_window(params, grid, b),
        "forces_mma": forces_mma(params, grid, b),
        "forces_mma_bf16": forces_mma(params, grid, b, bf16=True),
    }


def check_micro(params, grid, b, outs: dict) -> dict:
    """``micro_outputs`` against their plain versions, ``density_cap32``
    against ``density`` and the float32 ``forces_mma`` against ``forces``
    on valid slots; raises past a bound. Returns ({name: max abs error vs
    plain}, {name: plain ms})."""
    from sph_pie_torch.micro.forces_mma import forces_mma_plain
    from sph_pie_torch.neighbors.density import density
    from sph_pie_torch.neighbors.density_window import (
        density_cap32_plain,
        density_window_plain,
    )
    from sph_pie_torch.neighbors.forces import forces

    errs, plain_ms = {}, {}
    v = b.valid
    for name, plain in (("density_cap32", density_cap32_plain), ("density_window", density_window_plain)):
        rk = outs[name]
        rp, plain_ms[name] = timed(lambda: plain(params, grid, b))
        rel = ((rk - rp).abs() / rp).max().item()  # rp >= the floor > 0
        errs[name] = (rk - rp).abs().max().item()
        print(f"  {name:15s} max rel err {rel:.3e} over all {rk.numel()} slots (bound {WINDOW_RTOL:g})")
        check(rel <= WINDOW_RTOL, f"{name} kernel disagrees")
    rd = density(params, grid, b)
    rel = ((outs["density_cap32"] - rd).abs()[v] / rd[v]).max().item()
    print(f"  density_cap32 vs density on valid slots: max rel {rel:.3e} (bound {WINDOW_RTOL:g})")
    check(rel <= WINDOW_RTOL, "density_cap32 disagrees with density")

    af, xf = forces(params, grid, b)
    for name, bf16, bound in (("forces_mma", False, MMA_F32_ATOL), ("forces_mma_bf16", True, MMA_BF16_ATOL)):
        ak, xk = outs[name]
        (ap, xp), plain_ms[name] = timed(lambda: forces_mma_plain(params, grid, b, bf16=bf16))
        ea, ex = scaled(ak, ap), scaled(xk, xp)
        errs[name] = max((ak - ap).abs().max().item(), (xk - xp).abs().max().item())
        print(f"  {name:15s} acc scaled err {ea:.3e}, xsph {ex:.3e} (bound {bound:g})")
        check(ea <= bound and ex <= bound, f"{name} kernel disagrees")
        fa = scaled(ak[v], af[v])
        fx = scaled(xk[v], xf[v]) if params.use_xsph else float("nan")
        if bf16:
            print(f"    vs forces on valid slots (printed only): acc {fa:.3e}, xsph {fx:.3e}")
        else:
            print(f"    vs forces on valid slots: acc {fa:.3e}, xsph {fx:.3e} (bound {MMA_F32_ATOL:g})")
            check(fa <= MMA_F32_ATOL and not fx > MMA_F32_ATOL, "forces_mma disagrees with forces")
    return errs, plain_ms


def check_slab(grid, inputs, dense, compact: dict) -> dict:
    """Center-slab kernel outputs (dense, {K: compact}) against their plain
    versions; raises past a bound. Returns ({name: max abs error}, {name:
    plain ms}, compact at K = SLAB_K)."""
    from sph_pie_torch.micro.center_slab import (
        center_slab_compact_plain,
        center_slab_dense_plain,
    )

    def err(label, got, want):
        nz = want != 0
        rel = ((got - want).abs()[nz] / want[nz]).max().item()
        zeros = torch.equal(got[~nz], want[~nz])
        print(f"  center slab {label:12s} max rel err {rel:.3e} (bound {SLAB_RTOL:g}), "
              f"zeros equal: {zeros}")
        check(rel <= SLAB_RTOL and zeros, f"center slab {label} kernel disagrees")
        return (got - want).abs().max().item()

    plain_ms = {}
    dp, plain_ms["center_slab_dense"] = timed(lambda: center_slab_dense_plain(grid, inputs))
    errs = {"center_slab_dense": err("dense", dense, dp), "center_slab_compact": 0.0}
    cuts = {}
    for K, ck in compact.items():
        cp, t = timed(lambda: center_slab_compact_plain(grid, inputs, K))
        if K == SLAB_K:
            plain_ms["center_slab_compact"] = t
        e = err(f"compact K={K}", ck, cp)
        cuts[K] = int((cp < dp * (1 - 1e-6)).sum())
        print(f"    K={K} truncates {cuts[K]} of {cp.numel()} home slots")
        errs["center_slab_compact"] = max(errs["center_slab_compact"], e)
    k = min(cuts)
    check(cuts[k] > 0, f"compact K={k} truncates nothing: the first-K rule went unchecked")
    return errs, plain_ms


def phase_a_micro() -> None:
    from sph_pie_torch.micro.center_slab import (
        center_slab_compact,
        center_slab_dense,
        center_slab_inputs,
    )
    from sph_pie_torch.scenes import dam_break_2d, dam_break_3d
    from sph_pie_torch.solvers import wcsph_binned

    print("== Phase A: window densities, forces_mma and the center slab against their plain versions")
    cap32_3d = dict(skin_frac=0.25, bcap=32, surface_tension=0.0)
    for make, n, kw in ((dam_break_3d, 100_000, cap32_3d), (dam_break_2d, 4096, {})):
        s = make(n, device="cuda", **kw)
        b = wcsph_binned.simulate(s.params, s.bgrid, s.binned_state(), 10)
        print(f" {s.name}({n}): cap {s.bgrid.cap}, skin {s.bgrid.skin / s.params.h.item():.2f} h, "
              f"cohesion {s.params.use_cohesion}, xsph {s.params.use_xsph}")
        check(int(b.overflow) == 0, f"{s.name}: overflow")
        b = with_density(s.params, s.bgrid, b)
        check_micro(s.params, s.bgrid, b, micro_outputs(s.params, s.bgrid, b))
        if s.bgrid.dim == 3:
            window_moved_empties(s.params, s.bgrid, b)

    s = dam_break_3d(100_000, device="cuda")
    b = wcsph_binned.simulate(s.params, s.bgrid, s.binned_state(), 10)
    print(f" {s.name}(100000): cap {s.bgrid.cap}, center slab")
    inputs = center_slab_inputs(s.bgrid, b)
    compact = {K: center_slab_compact(s.bgrid, inputs, K) for K in (32, 4)}
    check_slab(s.bgrid, inputs, center_slab_dense(s.bgrid, inputs), compact)


def phase_c(main_path) -> list[dict]:
    from sph_pie_torch.micro import center_slab as cs
    from sph_pie_torch.micro.forces_mma import forces_mma
    from sph_pie_torch.neighbors import density_window as dw
    from sph_pie_torch.neighbors.density import density
    from sph_pie_torch.neighbors.forces import forces
    from sph_pie_torch.scenes import dam_break_3d
    from sph_pie_torch.solvers import wcsph_binned

    print("== Phase C: the window-density, forces_mma and center-slab path at 1M")
    t0 = time.perf_counter()
    s = dam_break_3d(1_000_000, skin_frac=0.25, bcap=32, surface_tension=0.0, xsph_eps=0.05,
                     device="cuda")
    p, g = s.params, s.bgrid
    check(not p.use_cohesion and g.cap == 32, "C1 scene: cap 32, no cohesion")
    b = wcsph_binned.simulate(p, g, s.binned_state(), C_STEPS)
    b = with_density(p, g, b)
    torch.cuda.synchronize()
    n = int(s.state.n_active())
    print(f" C1: dam_break_3d(1M, skin 0.25, cap 32, no cohesion), {n} particles, cells "
          f"{g.num_cells}, slots {g.num_slots}, overflow {int(b.overflow)}, after {C_STEPS} steps "
          f"({time.perf_counter() - t0:.2f} s)")
    check(int(b.overflow) == 0, "C1: overflow")
    p2, g2, b2 = main_path
    print(f" C2: Phase B's final state, cap {g2.cap}, cells {g2.num_cells}")

    dw.density_cap32.launches = dw.density_window.launches = 0
    cs.center_slab_dense.launches = cs.center_slab_compact.launches = 0
    forces_mma.launches = {"f32": 0, "bf16": 0}
    # ---- the path of the four kernels: counts start at 0 here ----
    outs = micro_outputs(p, g, b)
    inputs = cs.center_slab_inputs(g2, b2)
    dense = cs.center_slab_dense(g2, inputs)
    compact = {K: cs.center_slab_compact(g2, inputs, K) for K in (SLAB_K, SLAB_K_CUT)}
    torch.cuda.synchronize()
    launches = {
        "density_cap32": dw.density_cap32.launches,
        "density_window": dw.density_window.launches,
        "center_slab_dense": cs.center_slab_dense.launches,
        "center_slab_compact": cs.center_slab_compact.launches,
        "forces_mma": forces_mma.launches["f32"],
        "forces_mma_bf16": forces_mma.launches["bf16"],
    }
    # ---- counts read here ----
    print(f" launches: {launches}")
    want = {name: 1 for name in launches} | {"center_slab_compact": len(compact)}
    check(launches == want, f"launches {launches} != {want}")

    errs, plain = check_micro(p, g, b, outs)
    slab_errs, slab_plain = check_slab(g2, inputs, dense, compact)
    errs.update(slab_errs)
    plain.update(slab_plain)
    print(f" peak device memory so far {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")

    kernels = {
        "density_cap32": lambda: dw.density_cap32(p, g, b),
        "density_window": lambda: dw.density_window(p, g, b),
        "center_slab_dense": lambda: cs.center_slab_dense(g2, inputs),
        "center_slab_compact": lambda: cs.center_slab_compact(g2, inputs, SLAB_K),
        "forces_mma": lambda: forces_mma(p, g, b),
        "forces_mma_bf16": lambda: forces_mma(p, g, b, bf16=True),
    }
    S1, S2 = g.num_slots, g2.num_slots
    h2 = p.h * p.h
    pairs = pairs_in_support(g, b, h2)  # h from the grid agrees up to rounding
    extra = empty_home_pairs(g, b, h2)
    per_home = center_slab_pairs(inputs, cs._consts(g2)[0])
    mma_flops = pairs * (FORCES_PAIR_FLOPS + XSPH_FLOPS)
    least = {
        "density_cap32": bound(S1 * 21, pairs * DENSITY_PAIR_FLOPS),
        "density_window": bound(S1 * 20, (pairs + extra) * DENSITY_PAIR_FLOPS),
        # home pos, window pos and mass in; density out
        "center_slab_dense": bound(S2 * 64, int(per_home.sum()) * DENSITY_PAIR_FLOPS),
        "center_slab_compact": bound(
            S2 * 64, int(per_home.clamp(max=SLAB_K).sum()) * DENSITY_PAIR_FLOPS),
        "forces_mma": bound(S1 * 60, mma_flops),
        "forces_mma_bf16": bound(S1 * 60, mma_flops),
    }
    print(f" pairs in support: C1 {pairs} (+{extra} of empty home slots), C2 center slab "
          f"{int(per_home.sum())}")
    rows = [kernel_row(name, launches[name], errs[name], cuda_ms(kernel, 10), plain[name],
                       least[name])
            for name, kernel in kernels.items()]
    # the new kernels beside the main path's density.cu and forces.cu, same states
    print(f"  on C1: density.cu {cuda_ms(lambda: density(p, g, b), 10):.3f} ms, "
          f"forces.cu {cuda_ms(lambda: forces(p, g, b), 10):.3f} ms; on C2: "
          f"density.cu {cuda_ms(lambda: density(p2, g2, b2), 10):.3f} ms, "
          f"density_window {cuda_ms(lambda: dw.density_window(p2, g2, b2), 10):.3f} ms")
    return rows


def phase_b() -> tuple[list[dict], tuple]:
    from sph_pie_torch.neighbors import binned as nb
    from sph_pie_torch.neighbors import runs
    from sph_pie_torch.neighbors.density import density
    from sph_pie_torch.neighbors.expand import expand, expand_plain
    from sph_pie_torch.neighbors.forces import forces
    from sph_pie_torch.scenes import dam_break_3d
    from sph_pie_torch.solvers import wcsph_binned

    print("== Phase B: main path, dam_break_3d(1_000_000)")
    t0 = time.perf_counter()
    s = dam_break_3d(1_000_000, device="cuda")
    n = int(s.state.n_active())
    g = s.bgrid
    print(f" particles {n}, cells {g.num_cells} ({'x'.join(map(str, g.dims))} interior), "
          f"cap {g.cap}, slots {g.num_slots}; scene built in {time.perf_counter() - t0:.2f} s")
    check(n == 995_328, "flagship particle count")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    warm, steps, reps = 5, 20, 3
    syncs: list[int] = []
    for k in (density, forces, expand):
        k.launches = 0
    # ---- the main path: counts start at 0 here ----
    b = s.binned_state()
    b = wcsph_binned.simulate(s.params, g, b, warm)
    torch.cuda.synchronize()
    rebins0 = int(b.n_rebins)
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with counting_syncs(syncs):
            b = wcsph_binned.simulate(s.params, g, b, steps)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3 / steps)
    launches = {k.__name__: k.launches for k in (density, forces, expand)}
    # ---- counts read here ----
    peak = torch.cuda.max_memory_allocated()
    ms = statistics.median(walls)
    run = warm + steps * reps
    rebins = int(b.n_rebins) - rebins0
    print(f" ms/step median {ms:.3f} (reps {', '.join(f'{w:.3f}' for w in walls)})")
    print(f" particle-steps/s {n / (ms / 1e3):.4e}")
    print(f" rebins in timed steps {rebins} / {steps * reps}, total since bin {int(b.n_rebins)}, "
          f"overflow {int(b.overflow)}")
    print(f" peak device memory {peak / 2**30:.3f} GiB")
    print(f" host syncs in timed steps {sum(syncs)} ({sum(syncs) / (steps * reps):.3f}/step)")
    print(f" launches over {run} steps: {launches}")

    valid = b.valid
    pos = b.pos[valid]
    h = float(s.params.h)
    lo, hi = s.params.bound_min - 5 * h, s.params.bound_max + 5 * h
    check(bool(torch.isfinite(b.pos).all()), "non-finite position")
    check(bool(((pos >= lo) & (pos <= hi)).all()), "position outside the box +- 5h")
    check(int(b.overflow) == 0, "overflow at 1M")
    check(launches["density"] == run and launches["forces"] == run,
          f"density/forces launches {launches} != steps run {run}")
    check(launches["expand"] >= 1, "expand never launched")

    print(" kernels against their plain versions on the final state:")
    errs, plain, b = compare_kernels(s.params, g, b)
    pos_c, vel_c, mass_c, alive = nb._compact(g, b)
    owner = torch.arange(pos_c.shape[0], dtype=torch.int32, device="cuda")
    srt = nb.sort_rows(g, pos_c, vel_c, mass_c, owner, alive)
    ex_args = (srt.first, srt.count, srt.rows, srt.owner, g.cap)
    timings = {
        "density": (cuda_ms(lambda: density(s.params, g, b), 10), plain["density"]),
        "forces": (cuda_ms(lambda: forces(s.params, g, b), 10), plain["forces"]),
        "expand": (cuda_ms(lambda: expand(*ex_args), 10), cuda_ms(lambda: expand_plain(*ex_args), 10)),
    }
    p, S, dim, es = s.params, g.num_slots, g.dim, b.pos.element_size()
    pairs = pairs_in_support(g, b, p.h * p.h)
    pair_flops = FORCES_PAIR_FLOPS + COHESION_FLOPS * p.use_cohesion + XSPH_FLOPS * p.use_xsph
    ncol, K = srt.rows.shape[1], srt.rows.shape[0]
    least = {
        # pos, mass, valid in; rho out
        "density": bound(S * (dim * es + es + 1 + es), pairs * DENSITY_PAIR_FLOPS),
        # pos, vel, mass, density, pressure in; acc, xsph out
        "forces": bound(S * (2 * dim * es + 3 * es + 2 * dim * es), pairs * pair_flops),
        # first, count, rows, owner in; dense rows, owner out
        "expand": bound(g.num_cells * 8 + K * (ncol * es + 4) + S * (ncol * es + 4), 0),
    }
    R = runs.run_cells(g.cap)
    occ = (b.mass.reshape(g.num_cells, g.cap) != 0).any(1)
    n_runs = -(-g.num_cells // R)
    busy = int(torch.nn.functional.pad(occ, (0, n_runs * R - g.num_cells)).reshape(n_runs, R)
               .any(1).sum())
    print(f" pairs in support on the final state: {pairs} ({pairs / n:.2f} per particle); "
          f"runs of {R} cells with an occupied home slot: {busy} of {n_runs}")
    rows = [kernel_row(name, launches[name], errs[name], k_ms, p_ms, least[name])
            for name, (k_ms, p_ms) in timings.items()]
    return rows, (s.params, g, b)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs a CUDA card",
              file=sys.stderr)
        return 1
    from sph_pie_torch import _native

    print(card_line())
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    _native.library()
    print(f"kernel build + load {time.perf_counter() - t0:.2f} s ({_native.library_path().name})",
          flush=True)
    torch.manual_seed(0)
    seconds = {}
    with torch.no_grad():
        for name, phase in (("A", phase_a), ("A micro", phase_a_micro)):
            t0 = time.perf_counter()
            phase()
            seconds[name] = time.perf_counter() - t0
        t0 = time.perf_counter()
        rows, main_path = phase_b()
        seconds["B"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        rows += phase_c(main_path)
        seconds["C"] = time.perf_counter() - t0
    print("phase seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
