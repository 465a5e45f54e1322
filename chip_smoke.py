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
seed (3 to 8 columns, caps 8, 32 and 40 through its 16-byte arm and cap 5
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
(its runs arm) and rebinned at cap 30 (its one-thread-per-slot arm). The
tensor-core forces and the center slab, which pack occupied slots, are also
checked where packing could break them: with every empty slot given a
position and a velocity of its own inside the fluid (which must change no
result bit of an occupied slot), on a hand-made state whose cells hold
exactly 1, 16, 17 and 32 particles beside windows with all 96 slots
occupied, with particles in the first and the last cell of the grid (windows
that pass slot 0 and slot S) and with distinct particles at one position, and
the center slab also rebinned at cap 30 and on inputs that start off a
16-byte boundary (its one-thread-per-slot arm, whose bits its other arm must
give).

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

Phase D drives the PBF solver and the frame renderer. D1 is BASELINE
config #4 as ``bench.py``'s ``pbf_3d_1m_render`` row runs it:
``dam_break_3d(1M)`` under ``flagship_params()`` (the "ride" epilogue), a
``render_binned_u8`` frame after every step whose sum is consumed on the
device, with the ``expand`` and ``density`` launch counters reset just
before and read just after; it prints ms/step, particle-steps/s, rebins and
checks, host syncs, peak memory, and then the time of each fold and of one
frame on the final state. D2 runs ``dam_break_3d(20k)`` for 5 PBF steps on
the card and on the CPU under the flagship, the "gather" epilogue,
vorticity confinement (whose final density is the ``density`` kernel) and
a scene without XSPH, and holds card against CPU, ride against gather, and
the card's frames (``splat``, ``splat_binned`` and their uint8 forms)
against the CPU's.

Phase E drives the scene runner (``solvers/run.py``: emission, binning,
steps and unbinning epoch by epoch) with obstacles and emitters. E1 is
BASELINE config #2 as ``bench.py``'s ``emitter_2d_4k`` row runs it:
``emitter_2d(4096)``, ``run_scene`` for 100 steps warm, then 3 reps of 500,
each with a scalar read inside the timed window; it prints steps/s, the
particles emitted, host syncs and the launches of ``density``, ``forces``
and ``expand``, holds the card against the CPU (400 steps in float64, 100
in float32) and runs 2,000 steps, until the stream lies on the sphere, for
the penetration gate of ``tests/test_scenes.py``. E2 runs every scene file of ``config/`` through
``load_scene_file`` and ``run_scene`` (the two emitter scenes against the
CPU) and ``python -m sph_pie_torch simulate dam_break_2d`` in-process. E3
runs the epoch loop at 1M with a stirring sphere (WCSPH, then PBF), times
one obstacle term and one epoch boundary, and holds PBF epochs against
``pbf.simulate`` at 20k. E1 and E3 also print a ``torch.profiler`` window
of one epoch: device kernels a step and the device's busy share. E4 runs ``simulate_adaptive`` on the card and on
the CPU.

Any failed check raises, so the script exits non-zero; it also exits
non-zero, printing no result, when no CUDA device is available. On success
the line before the last is a JSON object with one entry per kernel (its
launches on its path, error, ms, plain ms, ``bound_ms``: the least time of
its work on this state at the card's published peaks, ``bound_by`` and
``library_ms``), and the last line is ``{"ok": true, "device": {...}}``. The
center slab's and ``forces_mma``'s bytes are those any implementation must
touch: a window without mass decides its cell's zeros by its masses alone,
and an empty slot is known by its mass alone.
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
PBF_TRAJ_ATOL = 1e-5  # D2: f32 max |dpos| after 5 PBF steps, card vs CPU (the
                      # folds sum in another order on each), domain ~1 m
RIDE_GATHER_ATOL = 1e-6  # D2: the two epilogues on the card (tests/test_pbf.py)
FRAME_ATOL = 1e-5     # D2: float frames card vs CPU, scale-normalised: the
                      # card's splat adds by atomics, in no fixed order
U8_SHARE = 1e-3       # D2: u8 frames card vs CPU: at most one count apart, on at
                      # most this share of the pixels (a float 1 ulp apart can
                      # cross a truncation step)
D_WARM, D_STEPS, D_REPS = 1, 2, 3  # D1: PBF steps before timing; timed steps x reps
D2_STEPS = 5          # D2: PBF steps on the card and on the CPU
FRAME = dict(resolution=(256, 256), axis=1, gain=50.0)  # bench.py's in-loop frame
E1_WARM, E1_STEPS, E1_REPS = 100, 500, 3  # E1: bench.py's _measure_emitter
E1_F64_STEPS = 400    # E1: float64 card vs CPU, 8 epochs
E1_CONTACT_STEPS = 2000  # E1: the stream meets the sphere after ~1,300 steps
EMIT_F64_ATOL = 1e-9  # E1: f64 max |dpos| after 400 steps, card vs CPU: the
                      # kernels sum in another order than the plain folds;
                      # the CPU tests hold the plain versions to the reference
                      # at this bound over such rolls
E2_STEPS = 200        # E2: the emitter scene files, card vs CPU
E2_DAM_STEPS = 100    # E2: the dam-break files and the CLI run
E3_EPOCHS, E3_EPOCH_STEPS = 2, 50  # E3: the epoch loop at 1M
E3_PBF_STEPS = 2      # E3: one PBF epoch at 1M
E3_PBF_N, E3_PBF_EPOCHS, E3_PBF_EPOCH_STEPS = 20_000, 2, 5  # E3: PBF epochs vs simulate
PBF_EPOCH_ATOL = 1e-4  # E3: f32 max |dpos|, epochs vs one roll: the boundary
                       # forces a rebin the roll lacks, a summation-order
                       # change PBF's projection amplifies over the 5 steps
                       # after it (10x D2's card-vs-CPU bound; the reference's
                       # 3e-3 is over 60 steps, tests/test_scenes.py); a
                       # dropped density payload shows at >= 1e-2
E4_N, E4_STEPS = 600, 120  # E4: simulate_adaptive to t_end = 120 dt

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


def mma_tiles(grid, b) -> dict:
    """Pair evaluations of ``forces_mma`` on state ``b``: per home cell with
    a particle and per slab, its occupied homes rounded up to the 16-row
    tile times the occupied slots of its three window cells rounded up to
    the k-step (8 in TF32, 16 in bf16), beside the dense 32 x 96."""
    C, cap = grid.num_cells, grid.cap
    occ = (b.mass.reshape(C, cap) != 0).sum(1)
    live = occ > 0
    rows = (occ + 15) // 16 * 16
    reach = max(abs(sh) for sh in grid.slab_shifts()) + 1
    padded = torch.nn.functional.pad(occ, (reach, reach))
    out = {"cells": int(live.sum()), "f32": 0, "bf16": 0, "skipped": 0}
    for sh in grid.slab_shifts():
        K = sum(padded[reach + sh + o : reach + sh + o + C] for o in (-1, 0, 1))
        out["f32"] += int((rows * ((K + 7) // 8 * 8))[live].sum())
        out["bf16"] += int((rows * ((K + 15) // 16 * 16))[live].sum())
        out["skipped"] += int((K[live] == 0).sum())
    out["dense"] = out["cells"] * len(grid.slab_shifts()) * cap * 3 * cap
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
    from sph_pie_torch.neighbors.density import density, density_plain
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

    out["expand"] = expand_equal(grid, rebin_rows(grid, b), "")
    return out, plain, b


def rebin_rows(grid, b, light: bool = False, carry_density: bool = False):
    """The sorted rows that ``rebin(grid, b, light, carry_density)`` places."""
    from sph_pie_torch.neighbors import binned as nb

    pos, vel, mass, alive, dens = nb._compact(grid, b, light, carry_density)
    owner = torch.arange(pos.shape[0], dtype=torch.int32, device=pos.device)
    return nb.sort_rows(grid, pos, vel, mass, owner, alive, density=dens)


def expand_equal(grid, srt, label: str) -> float:
    """``expand`` against ``expand_plain`` on sorted rows, bit for bit;
    returns the max abs difference (0)."""
    from sph_pie_torch.neighbors.expand import expand, expand_plain

    args = (srt.first, srt.count, srt.rows, srt.owner, grid.cap)
    (dk, ok_), (dp, op) = expand(*args), expand_plain(*args)
    same = torch.equal(dk, dp) and torch.equal(ok_, op)
    print(f"  expand{label} {srt.rows.shape[0]} rows x {srt.rows.shape[1]} columns into "
          f"{dk.shape[0]} slots, equal to plain: {same} (bound: exact)")
    check(same, f"expand kernel disagrees{label}")
    return (dk - dp).abs().max().item()


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
            for ncol in (3, 4, 5, 6, 7, 8):
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


def rebinned(grid, b, cap: int):
    """(grid, state) of the particles of ``b`` binned into cells of ``cap``."""
    import dataclasses

    from sph_pie_torch.neighbors import binned as nb

    g = dataclasses.replace(grid, cap=cap)
    pos, vel, mass, alive, _ = nb._compact(grid, b)
    owner = torch.arange(pos.shape[0], dtype=torch.int32, device=pos.device)
    return g, nb._bin_rows(g, pos, vel, mass, owner, alive)


def window_moved_empties(params, grid, b) -> None:
    """``density_window`` where empty slots do not all sit at zero: in cells
    that hold particles, some empty slots get positions of their own beside
    a particle of the cell (two of them the same one) and one gets a
    particle's position itself. Then the same particles rebinned into cells
    of cap 30, which the runs do not take."""
    from sph_pie_torch.neighbors import runs
    from sph_pie_torch.neighbors.density_window import density_window, density_window_plain
    from sph_pie_torch.utils.struct import replace

    floor = 1e-6 * float(params.rest_density)
    for g, state in ((grid, b), rebinned(grid, b, 30)):
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


def empties_moved(b, rng):
    """``b`` with every empty slot given a position inside the fluid's
    bounding box and a velocity of its own."""
    from sph_pie_torch.utils.struct import replace

    empty = (b.mass == 0)[:, None]
    lo, hi = b.pos[b.mass != 0].min(0).values, b.pos[b.mass != 0].max(0).values
    u, v = (torch.as_tensor(rng.uniform(size=tuple(b.pos.shape)), dtype=b.pos.dtype, device="cuda")
            for _ in range(2))
    return replace(b, pos=torch.where(empty, lo + (hi - lo) * u, b.pos),
                   vel=torch.where(empty, 2 * v - 1, b.vel))


def tile_edge_state(params, grid, m0: float, rng):
    """A hand-made cap-32 3D state for what packing can break. Home cells
    with exactly 1, 16, 17 and 32 particles (the edges of the 16-row tiles),
    each beside a slab window whose 96 slots are all occupied (the most
    columns), the cell of 32 also inside a full center-slab window;
    particles in the first two and the last two cells of the grid, whose
    windows pass slot 0 and slot S; and in each home cell of more than one
    particle two particles at one position (r^2 == 0 off the diagonal), which
    a third in the next cell shares. Cells fill from their first slot, as
    the placement fills them. All positions lie in one cube of side 1.2 h,
    so most pairs of a window are in support whatever cell they sit in: the
    kernels take the slots as they are given."""
    import dataclasses

    from sph_pie_torch.neighbors import binned as nb

    g = dataclasses.replace(grid, dims=(4, 4, 46), block_cells=0)
    C, cap, (s0, s1, _) = g.num_cells, g.cap, g.strides
    check(cap == 32, "tile_edge_state: cap 32")
    count = np.zeros(C, dtype=np.int64)
    homes = {2 * s0 + 2 * s1 + z: m for z, m in ((5, 1), (15, 16), (25, 17), (35, 32))}
    for c, m in homes.items():
        count[c] = m
        count[c + s0 - 1 : c + s0 + 2] = cap       # a full window one slab over
        if m == cap:
            count[c - 1 : c + 2] = cap             # and a full center-slab window
    count[[0, 1, C - 2, C - 1]] = [7, cap, 20, 3]
    h = float(g.cell_size - g.skin)
    S = C * cap
    occ = (np.arange(cap)[None, :] < count[:, None]).reshape(S)
    pos = rng.uniform(0.0, 1.2 * h, (S, 3)) * occ[:, None]
    for c, m in homes.items():
        if m > 1:
            pos[c * cap + 1] = pos[(c + 1) * cap] = pos[c * cap]
    f = lambda a, dt=torch.float32: torch.as_tensor(a, dtype=dt, device="cuda")
    rho0 = float(params.rest_density)
    b = nb.BinnedState(
        pos=f(pos), vel=f(rng.uniform(-1.0, 1.0, (S, 3)) * occ[:, None]), mass=f(m0 * occ),
        density=f(rho0 * (1 + 0.05 * rng.uniform(-1.0, 1.0, S))),
        pressure=f(rng.uniform(0.0, 1e3, S)), valid=f(occ, torch.bool),
        owner=f(np.where(occ, np.arange(S), -1), torch.int32),
        slot_of=f(np.flatnonzero(occ), torch.int32), bin_pos=f(pos),
        travel=f(0.0), overflow=f(0, torch.int32), n_rebins=f(0, torch.int32), sim_time=f(0.0),
    )
    per_cell = (b.mass.reshape(C, cap) != 0).sum(1)
    check(sorted(per_cell[list(homes)].tolist()) == [1, 16, 17, 32], "home cells of 1, 16, 17, 32")
    return g, b


def slab_arms_equal(grid, inputs) -> None:
    """The center slab's two arms give the same bits: the same inputs, copied
    to start 4 bytes past a 16-byte boundary, go through the per-slot arm."""
    from sph_pie_torch.micro.center_slab import (
        center_slab_compact,
        center_slab_dense,
        group_arm,
    )

    def shifted(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        buf[1:] = t.reshape(-1)
        return buf[1:].view_as(t)

    off = tuple(shifted(t) for t in inputs)
    check(group_arm(grid, inputs) and not group_arm(grid, off),
          "the two layouts must take the two arms")
    same = [torch.equal(center_slab_dense(grid, inputs), center_slab_dense(grid, off))]
    same += [torch.equal(center_slab_compact(grid, inputs, K), center_slab_compact(grid, off, K))
             for K in (SLAB_K, SLAB_K_CUT)]
    print(f"  center slab cap {grid.cap}: groups arm == per-slot arm bit for bit (dense, K={SLAB_K}, "
          f"K={SLAB_K_CUT}): {same}")
    check(all(same), "the center slab's arms differ")


def packing_cases(params, grid, b, slab_grid, slab_b) -> None:
    """``forces_mma`` (both arms) and the center slab (both arms) where
    packing occupied slots could break them. ``b`` is the cap-32 3D state,
    ``slab_b`` the cap-40 one."""
    from sph_pie_torch.micro.center_slab import (
        center_slab_compact,
        center_slab_dense,
        center_slab_inputs,
        group_arm,
    )
    from sph_pie_torch.micro.forces_mma import forces_mma

    rng = np.random.default_rng(17)

    def slab(g, inputs):
        return center_slab_dense(g, inputs), {K: center_slab_compact(g, inputs, K)
                                               for K in (SLAB_K, SLAB_K_CUT)}

    # (a) empty slots with positions and velocities of their own: mass 0
    # must keep them out of every sum.
    moved = empties_moved(b, rng)
    n_empty = int((b.mass == 0).sum())
    print(f" packing: {n_empty} empty slots of the cap-{grid.cap} state moved into the fluid")
    outs = {"forces_mma": forces_mma(params, grid, moved),
            "forces_mma_bf16": forces_mma(params, grid, moved, bf16=True)}
    check_forces_mma(params, grid, moved, outs)
    for bf16, name in ((False, "forces_mma"), (True, "forces_mma_bf16")):
        same = all(torch.equal(x, y) for x, y in zip(outs[name], forces_mma(params, grid, b, bf16=bf16)))
        print(f"    {name}: equal bit for bit to the kernel on the unmoved state: {same}")
        check(same, f"{name}: moved empty slots changed a result")
    moved = empties_moved(slab_b, rng)
    inputs, inputs0 = center_slab_inputs(slab_grid, moved), center_slab_inputs(slab_grid, slab_b)
    dense, compact = slab(slab_grid, inputs)
    check_slab(slab_grid, inputs, dense, compact)
    dense0, compact0 = slab(slab_grid, inputs0)
    home = inputs0[3] != 0   # an empty home slot moves, and its sum with it
    same = torch.equal(dense[home], dense0[home]) and all(
        torch.equal(compact[K][home], compact0[K][home]) for K in compact)
    print(f"    center slab: occupied home slots equal bit for bit to the unmoved state: {same}")
    check(same, "center slab: moved empty slots changed an occupied slot's sum")
    slab_arms_equal(slab_grid, inputs)

    # (b, c, d) tile edges, full windows, windows past slot 0 and S, r^2 == 0
    g, st = tile_edge_state(params, grid, float(b.mass.max()), rng)
    C, cap = g.num_cells, g.cap
    print(f" packing: hand-made state, cells of 1, 16, 17, 32 beside full windows, particles in "
          f"cells 0, 1, {C - 2}, {C - 1} of {C}, coincident particles")
    check_forces_mma(params, g, st, {"forces_mma": forces_mma(params, g, st),
                                      "forces_mma_bf16": forces_mma(params, g, st, bf16=True)})
    inputs = center_slab_inputs(g, st)
    check_slab(g, inputs, *slab(g, inputs))
    slab_arms_equal(g, inputs)

    # (e) a cap that is no multiple of 4: the center slab's per-slot arm
    g30, st = rebinned(slab_grid, slab_b, 30)
    inputs = center_slab_inputs(g30, st)
    check(not group_arm(g30, inputs), "cap 30 must take the per-slot arm")
    print(f" packing: center slab rebinned at cap {g30.cap} (per-slot arm), overflow {int(st.overflow)}")
    check_slab(g30, inputs, *slab(g30, inputs))


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
    from sph_pie_torch.neighbors.density import density
    from sph_pie_torch.neighbors.density_window import (
        density_cap32_plain,
        density_window_plain,
    )

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

    mma_errs, mma_ms = check_forces_mma(params, grid, b, outs)
    errs.update(mma_errs)
    plain_ms.update(mma_ms)
    return errs, plain_ms


def check_forces_mma(params, grid, b, outs: dict):
    """Both ``forces_mma`` arms against their plain versions, and the
    float32 arm against ``forces`` on valid slots; raises past a bound.
    Returns ({name: max abs error vs plain}, {name: plain ms})."""
    from sph_pie_torch.micro.forces_mma import forces_mma_plain
    from sph_pie_torch.neighbors.forces import forces

    errs, plain_ms = {}, {}
    v = b.valid
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
            cap32 = (s.params, s.bgrid, b)

    s = dam_break_3d(100_000, device="cuda")
    b = wcsph_binned.simulate(s.params, s.bgrid, s.binned_state(), 10)
    print(f" {s.name}(100000): cap {s.bgrid.cap}, center slab")
    inputs = center_slab_inputs(s.bgrid, b)
    compact = {K: center_slab_compact(s.bgrid, inputs, K) for K in (32, 4)}
    check_slab(s.bgrid, inputs, center_slab_dense(s.bgrid, inputs), compact)
    packing_cases(*cap32, s.bgrid, b)


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
    # The center slab's inputs are pre-expanded, and a window without mass
    # decides its cell's zeros by its masses alone: what any implementation
    # must touch is the window mass and the output of every slot (16 bytes)
    # and the home and window positions (48 bytes a slot) only of the cells
    # whose window holds mass. (Every input once, 64 bytes a slot, is more
    # than this kernel reads.)
    massy = int((inputs[7] != 0).any(1).sum())
    slab_bytes = S2 * 16 + massy * g2.cap * 48
    # forces_mma likewise: mass in and acc and xsph out for every slot (28
    # bytes), pos, vel, density and pressure (32 bytes) only of the occupied
    # slots. (Every input once, 60 bytes a slot, is more than it reads.)
    occupied = int((b.mass != 0).sum())
    mma_bytes = S1 * 28 + occupied * 32
    least = {
        # masked, as density: mass in and rho out for every slot (8 bytes),
        # pos of the occupied slots (12)
        "density_cap32": bound(S1 * 8 + occupied * 12, pairs * DENSITY_PAIR_FLOPS),
        # unmasked: every slot gets a sum from its own stored position, so
        # pos (12) and mass (4) in and rho (4) out of every slot
        "density_window": bound(S1 * 20, (pairs + extra) * DENSITY_PAIR_FLOPS),
        "center_slab_dense": bound(slab_bytes, int(per_home.sum()) * DENSITY_PAIR_FLOPS),
        "center_slab_compact": bound(
            slab_bytes, int(per_home.clamp(max=SLAB_K).sum()) * DENSITY_PAIR_FLOPS),
        "forces_mma": bound(mma_bytes, mma_flops),
        "forces_mma_bf16": bound(mma_bytes, mma_flops),
    }
    print(f" pairs in support: C1 {pairs} (+{extra} of empty home slots), C2 center slab "
          f"{int(per_home.sum())}; C2 cells with mass in their center-slab window {massy} of "
          f"{g2.num_cells}; C1 occupied slots {occupied} of {S1}")
    tiles = mma_tiles(g, b)
    print(f" forces_mma on C1: {tiles['cells']} of {g.num_cells} cells hold a particle; pair "
          f"evaluations in padded tiles f32 {tiles['f32']} ({tiles['f32'] / tiles['dense']:.3f} of "
          f"the dense {tiles['dense']}), bf16 {tiles['bf16']} "
          f"({tiles['bf16'] / tiles['dense']:.3f}); {tiles['skipped']} cell-slabs without mass")
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
    srt = rebin_rows(g, b)
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
    occupied = int((b.mass != 0).sum())
    least = {
        # what any implementation must touch: mass in and rho out for every
        # slot, pos only of the occupied slots (valid follows from mass)
        "density": bound(S * 2 * es + occupied * dim * es, pairs * DENSITY_PAIR_FLOPS),
        # mass in, acc and xsph out for every slot; pos, vel, density and
        # pressure only of the occupied slots
        "forces": bound(S * (es + 2 * dim * es) + occupied * (2 * dim + 2) * es,
                        pairs * pair_flops),
        # first, count, rows, owner in; dense rows, owner out
        "expand": bound(g.num_cells * 8 + K * (ncol * es + 4) + S * (ncol * es + 4), 0),
    }
    R = runs.run_cells(g.cap)
    occ = (b.mass.reshape(g.num_cells, g.cap) != 0).any(1)
    n_runs = -(-g.num_cells // R)
    busy = int(torch.nn.functional.pad(occ, (0, n_runs * R - g.num_cells)).reshape(n_runs, R)
               .any(1).sum())
    print(f" pairs in support on the final state: {pairs} ({pairs / n:.2f} per particle); "
          f"runs of {R} cells with an occupied home slot: {busy} of {n_runs}; occupied slots "
          f"{occupied} of {S}")
    rows = [kernel_row(name, launches[name], errs[name], k_ms, p_ms, least[name])
            for name, (k_ms, p_ms) in timings.items()]
    return rows, (s.params, g, b), ms


def pbf_roll(params, grid, pp, b, steps: int, checksum):
    """``steps`` PBF steps, each followed by the in-loop frame of bench.py's
    ``pbf_3d_1m_render`` row, whose sum is added to ``checksum`` on the
    device (the frame is consumed, and no step waits for it)."""
    from sph_pie_torch.render import splat
    from sph_pie_torch.solvers import pbf

    for _ in range(steps):
        b = pbf.step(params, grid, pp, b)
        checksum = checksum + splat.render_binned_u8(grid, b, **FRAME).sum(dtype=torch.int64)
    return b, checksum


def fold_inputs(params, grid, pp, b):
    """The three fold calls of a flagship step under ``pp``, on state ``b``."""
    from sph_pie_torch.neighbors import binned as nb
    from sph_pie_torch.solvers import pbf

    fields = {**nb._planar("p", b.pos), "mass": b.mass}
    lam, _ = pbf._lambda_fold(params, pp, grid, fields)
    m_rho = b.mass / torch.where(b.density > 0, b.density, params.rest_density)
    return {
        "lambda": lambda: pbf._lambda_fold(params, pp, grid, fields),
        "dx": lambda: pbf._dx_fold(params, pp, grid, {**fields, "lam": lam}),
        "density+XSPH": lambda: pbf._density_xsph_fold(params, grid, b.pos, b.vel, b.mass, m_rho),
    }


def phase_d1() -> None:
    from sph_pie_torch.neighbors.density import density
    from sph_pie_torch.neighbors.expand import expand
    from sph_pie_torch.render import splat
    from sph_pie_torch.scenes import dam_break_3d
    from sph_pie_torch.solvers import pbf

    print("== Phase D1: PBF flagship (ride), dam_break_3d(1_000_000), a frame every step")
    t0 = time.perf_counter()
    s = dam_break_3d(1_000_000, device="cuda")
    p, g, pp = s.params, s.bgrid, pbf.flagship_params()
    n = int(s.state.n_active())
    print(f" particles {n}, cap {g.cap}, skin {g.skin / float(p.h):.2f} h, iters {pp.iters}, "
          f"sor {float(pp.sor):g}, epilogue {pp.epilogue}, xsph {p.use_xsph}; frame "
          f"{FRAME['resolution']} axis {FRAME['axis']} gain {FRAME['gain']}; scene built in "
          f"{time.perf_counter() - t0:.2f} s")
    check(n == 995_328, "flagship particle count")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    syncs: list[int] = []
    walls = []
    expand.launches = density.launches = 0
    # ---- the PBF path: counts start at 0 here ----
    b = s.binned_state()
    b, checksum = pbf_roll(p, g, pp, b, D_WARM, b.n_rebins.new_zeros((), dtype=torch.int64))
    torch.cuda.synchronize()
    rebins0 = int(b.n_rebins)
    for _ in range(D_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with counting_syncs(syncs):
            b, checksum = pbf_roll(p, g, pp, b, D_STEPS, checksum)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3 / D_STEPS)
    launches = {"expand": expand.launches, "density": density.launches}
    # ---- counts read here ----
    peak = torch.cuda.max_memory_allocated()
    run, timed_steps = D_WARM + D_STEPS * D_REPS, D_STEPS * D_REPS
    ms = statistics.median(walls)
    rebins = int(b.n_rebins)
    print(f" ms/step median {ms:.1f} over {D_REPS} reps of {D_STEPS} steps after {D_WARM} warm "
          f"(reps {', '.join(f'{w:.1f}' for w in walls)}), frame included")
    print(f" particle-steps/s {n / (ms / 1e3):.4e}")
    print(f" rebins fired {rebins} in {run} steps ({rebins - rebins0} in the timed steps) of "
          f"{(pp.iters + 2) * run} checks ({pp.iters + 2} a step); overflow {int(b.overflow)}")
    print(f" host syncs in timed steps {sum(syncs)} ({sum(syncs) / timed_steps:.2f}/step)")
    print(f" launches over {run} steps: {launches} (expand: bin_state + one per rebin)")
    print(f" peak device memory {peak / 2**30:.3f} GiB")

    frame = splat.render_binned_u8(g, b, **FRAME)
    lit = int((frame > 0).sum())
    print(f" frames' checksum {int(checksum)}; last frame {tuple(frame.shape)}, {lit} pixels lit")
    h = float(p.h)
    lo, hi = p.bound_min - 5 * h, p.bound_max + 5 * h
    pos = b.pos[b.valid]
    check(bool(torch.isfinite(b.pos).all()), "PBF: non-finite position")
    check(bool(((pos >= lo) & (pos <= hi)).all()), "PBF: position outside the box +- 5h")
    check(int(b.overflow) == 0, "PBF: overflow at 1M")
    check(launches["expand"] == 1 + rebins, f"expand launches {launches} != 1 + rebins {rebins}")
    check(launches["density"] == 0, "the flagship step launches no density kernel")
    check(lit > 0 and int(checksum) > 0, "the frames are dark")

    # expand at the row widths of PBF's rebins at 1M: ride (pos | vel |
    # density | mass) and light (pos | mass), from the final state.
    for light, carry in ((False, True), (True, False)):
        srt = rebin_rows(g, b, light, carry)
        expand_equal(g, srt, " (light)" if light else " (ride)")
        check(srt.rows.shape[1] == (4 if light else 8), "PBF rebin row width")

    # Each fold once on the final state, then the frame, by CUDA events.
    folds = {name: timed(fn)[1] for name, fn in fold_inputs(p, g, pp, b).items()}
    frame_ms = cuda_ms(lambda: splat.render_binned_u8(g, b, **FRAME), 10)
    print(" fold ms on the final state: " + ", ".join(f"{k} {v:.1f}" for k, v in folds.items())
          + f"; frame {frame_ms:.3f} ms")
    print(f" occupied cells {int((b.mass.reshape(g.num_cells, g.cap) != 0).any(1).sum())} of "
          f"{g.num_cells}")


def pbf_cases(device: str, n: int) -> dict:
    """{name: (scene, final state)} of ``D2_STEPS`` PBF steps on
    ``dam_break_3d(n)`` float32 under the four checked configurations."""
    from sph_pie_torch.scenes import dam_break_3d
    from sph_pie_torch.solvers import pbf

    configs = {
        "flagship": ({}, pbf.flagship_params(device=device)),
        "gather": ({}, pbf.flagship_params(epilogue="gather", device=device)),
        "vorticity": ({}, pbf.make_pbf_params(iters=2, vort_eps=5.0, device=device)),
        "no xsph": ({"xsph_eps": 0.0}, pbf.flagship_params(device=device)),
    }
    out = {}
    for name, (kw, pp) in configs.items():
        s = dam_break_3d(n, device=device, **kw)
        b = pbf.simulate(s.params, s.bgrid, pp, s.binned_state(), D2_STEPS)
        out[name] = (s, b)
    return out


def phase_d2() -> None:
    from sph_pie_torch.neighbors import binned as nb
    from sph_pie_torch.neighbors.density import density
    from sph_pie_torch.render import splat

    n = 20_000
    print(f"== Phase D2: PBF and the frames, card against CPU, dam_break_3d({n}) float32, "
          f"{D2_STEPS} steps")
    density.launches = 0
    card = pbf_cases("cuda", n)
    torch.cuda.synchronize()
    check(density.launches == 2 * D2_STEPS, f"density launches {density.launches}")
    t0 = time.perf_counter()
    cpu = pbf_cases("cpu", n)
    print(f" CPU runs {time.perf_counter() - t0:.1f} s; density kernel launches on the card "
          f"{density.launches} (vorticity and no xsph: one a step each)")
    for name, (s, b) in card.items():
        sc, bc = cpu[name]
        cap = s.state.capacity
        u, uc = nb.unbin(s.bgrid, b, cap), nb.unbin(sc.bgrid, bc, cap)
        err = (u.pos.cpu() - uc.pos).abs().max().item()
        verr = scaled(u.vel.cpu(), uc.vel)
        print(f"  {name:9s} max |dpos| {err:.3e} (bound {PBF_TRAJ_ATOL:g}), vel scaled "
              f"{verr:.3e} (printed only); rebins card {int(b.n_rebins)} CPU {int(bc.n_rebins)}; "
              f"overflow {int(b.overflow)}")
        check(err <= PBF_TRAJ_ATOL, f"PBF {name}: card differs from the CPU")
        check(int(b.n_rebins) == int(bc.n_rebins) and int(b.overflow) == 0,
              f"PBF {name}: rebins or overflow")
    (s, b), (_, bg) = card["flagship"], card["gather"]
    cap = s.state.capacity
    ur, ug = nb.unbin(s.bgrid, b, cap), nb.unbin(s.bgrid, bg, cap)
    rg = max((getattr(ur, k) - getattr(ug, k)).abs().max().item() for k in ("pos", "vel"))
    print(f"  ride vs gather on the card: max |d| pos, vel {rg:.3e} (bound {RIDE_GATHER_ATOL:g}); "
          f"rebins {int(b.n_rebins)}")
    check(rg <= RIDE_GATHER_ATOL, "ride and gather differ on the card")

    # The frames of the flagship state: the card's against the CPU's.
    g, st = s.bgrid, nb.unbin(s.bgrid, b, cap)
    bc = type(b)(**{k: t.cpu() for k, t in vars(b).items()})
    stc = type(st)(**{k: t.cpu() for k, t in vars(st).items()})
    m = float(st.mass.max())
    ext = ((0.0, 1.0), (0.0, 0.75))
    pairs = {
        "splat": (splat.splat(st.pos, st.mass, st.active, ext, (256, 256), 1),
                  splat.splat(stc.pos, stc.mass, stc.active, ext, (256, 256), 1)),
        "splat_binned": (splat.splat_binned(g, b, (256, 256), 1),
                         splat.splat_binned(g, bc, (256, 256), 1)),
    }
    for name, (got, want) in pairs.items():
        e = scaled(got.cpu(), want)
        print(f"  {name:14s} card vs CPU scaled err {e:.3e} (bound {FRAME_ATOL:g})")
        check(e <= FRAME_ATOL, f"{name}: card differs from the CPU")
    u8 = {
        "render_u8": (splat.render_u8(st.pos, st.mass, st.active, ext, (256, 256), 1, 1.0 / m),
                      splat.render_u8(stc.pos, stc.mass, stc.active, ext, (256, 256), 1, 1.0 / m)),
        "render_binned_u8": (splat.render_binned_u8(g, b, **FRAME),
                             splat.render_binned_u8(g, bc, **FRAME)),
    }
    for name, (got, want) in u8.items():
        d = (got.cpu().int() - want.int()).abs()
        share = (d > 0).float().mean().item()
        print(f"  {name:16s} card vs CPU: max {int(d.max())} count, {share:.2e} of pixels differ "
              f"(bound 1 count on {U8_SHARE:g}); {int((want > 0).sum())} lit")
        check(int(d.max()) <= 1 and share <= U8_SHARE, f"{name}: card differs from the CPU")


def path_kernels():
    """The three kernels of the main path and the epoch loop."""
    from sph_pie_torch.neighbors.density import density
    from sph_pie_torch.neighbors.expand import expand
    from sph_pie_torch.neighbors.forces import forces

    return density, forces, expand


def reset_launches() -> None:
    for k in path_kernels():
        k.launches = 0


def read_launches() -> dict:
    return {k.__name__: k.launches for k in path_kernels()}


def check_in_box(params, st, overflow, what: str) -> None:
    """A run's gates: overflow 0, every active position finite and inside
    the box +- 5h."""
    h = float(params.h)
    lo, hi = params.bound_min - 5 * h, params.bound_max + 5 * h
    pos = st.pos[st.active]
    check(int(overflow) == 0, f"{what}: overflow {int(overflow)}")
    check(bool(torch.isfinite(pos).all()), f"{what}: non-finite position")
    check(bool(((pos >= lo) & (pos <= hi)).all()), f"{what}: position outside the box +- 5h")


def card_vs_cpu(card, cpu, what: str, atol: float) -> float:
    """Final flat states of one run on the card and on the CPU: n_active and
    the active mask equal, max |dpos| of the active rows within ``atol``."""
    act = cpu.active
    same = torch.equal(card.active.cpu(), act)
    err = (card.pos.cpu()[act] - cpu.pos[act]).abs().max().item() if bool(act.any()) else 0.0
    print(f"  {what}: n_active card {int(card.active.sum())} CPU {int(act.sum())}, active masks "
          f"equal: {same}, max |dpos| {err:.3e} (bound {atol:g})")
    check(same and err <= atol, f"{what}: card differs from the CPU")
    return err


def device_profile(fn, steps: int, label: str) -> None:
    """Run ``fn`` once under ``torch.profiler`` and print its device work:
    kernels (and copies) a step, the device's busy share of the wall time
    (the union of their intervals) and the five largest by device time.
    Measured apart from the timed runs: the profiler adds host time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not evs:
        print(f" {label} profile: no device events recorded (device time not measured)")
        return
    spans = sorted((e.time_range.start, e.time_range.end) for e in evs)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    by_name: dict[str, list[float]] = {}
    for e in evs:
        by_name.setdefault(e.name, []).append(e.time_range.elapsed_us())
    top = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:5]
    print(f" {label} profile over {steps} steps: {len(evs) / steps:.1f} device kernels and "
          f"copies a step, device busy {busy / 1e3:.3f} of {wall_us / 1e3:.3f} ms wall "
          f"({busy / wall_us:.3f}); by device time: " + "; ".join(
              f"{name[:48]} x{len(t)} {sum(t) / 1e3:.3f} ms" for name, t in top))


def phase_e1() -> None:
    from sph_pie_torch.scenes import emitter_2d
    from sph_pie_torch.solvers import run as run_lib

    print("== Phase E1: BASELINE config #2, emitter_2d(4096) through run_scene (bench.py's "
          "emitter_2d_4k row)")
    s = emitter_2d(4096, device="cuda")
    g = s.bgrid
    print(f" capacity {s.state.capacity}, cap {g.cap}, cells {g.num_cells}, dt "
          f"{float(s.params.dt):.4e} s, rows due by the last epoch (step 450): "
          f"{int(((s.emitter.spawn_step >= 0) & (s.emitter.spawn_step <= 450)).sum())}")
    syncs: list[int] = []
    walls = []
    torch.cuda.synchronize()
    reset_launches()
    # ---- the epoch-loop path: counts start at 0 here ----
    st, _ = run_lib.run_scene(s, E1_WARM)
    torch.cuda.synchronize()
    for _ in range(E1_REPS):
        t0 = time.perf_counter()
        with counting_syncs(syncs):
            st, overflow = run_lib.run_scene(s, E1_STEPS)
            float(st.pos[0, 0])  # a scalar read inside the timed window, as bench.py
        walls.append(time.perf_counter() - t0)
    launches = read_launches()
    # ---- counts read here ----
    med = statistics.median(walls)
    run = E1_WARM + E1_STEPS * E1_REPS
    emitted = int(st.active.sum())
    print(f" steps/s median {E1_STEPS / med:.1f} (wall s per {E1_STEPS} steps: "
          f"{', '.join(f'{w:.4f}' for w in walls)})")
    print(f" particles emitted {emitted}, overflow {int(overflow)}, host syncs "
          f"{sum(syncs) / (E1_STEPS * E1_REPS):.3f}/step")
    print(f" launches over {run} steps ({run // 50} epochs): {launches}")
    check_in_box(s.params, st, overflow, "E1")
    check(emitted > 0, "E1: nothing emitted")
    check(launches["density"] == run and launches["forces"] == run,
          f"E1: density/forces launches {launches} != steps {run}")
    check(launches["expand"] >= run // 50, "E1: expand launches below one per epoch")
    device_profile(lambda: run_lib.run_scene(s, 50), 50, "E1 one epoch")

    for dt, steps, atol in ((torch.float64, E1_F64_STEPS, EMIT_F64_ATOL),
                            (torch.float32, E1_WARM, TRAJ_ATOL)):
        card, _ = run_lib.run_scene(emitter_2d(4096, dtype=dt, device="cuda"), steps)
        cpu, _ = run_lib.run_scene(emitter_2d(4096, dtype=dt, device="cpu"), steps)
        card_vs_cpu(card, cpu, f"{steps} steps {dt}", atol)

    # Long enough for the stream to land on the sphere: the penetration
    # bound of tests/test_scenes.py.
    st, overflow = run_lib.run_scene(s, E1_CONTACT_STEPS)
    check_in_box(s.params, st, overflow, f"E1 {E1_CONTACT_STEPS} steps")
    d = torch.sqrt(((st.pos[st.active] - 0.5) ** 2).sum(-1))
    gap = 0.12 - 3 * float(s.params.h)
    print(f" {E1_CONTACT_STEPS} steps: {int(st.active.sum())} particles, {int((d < 0.12 + 0.01).sum())} "
          f"within 0.01 m of the sphere, closest to its center {d.min().item():.4f} m (radius "
          f"0.12, bound > {gap:.4f})")
    check(bool((d < 0.13).any()), "E1: the stream never reached the sphere")
    check(bool((d > gap).all()), "E1: the stream penetrates the sphere")


def phase_e2() -> None:
    import contextlib
    import io
    from pathlib import Path

    from sph_pie_torch import __main__ as cli
    from sph_pie_torch.scenes.config import load_scene_file
    from sph_pie_torch.solvers import run as run_lib

    print("== Phase E2: the scene files through load_scene_file and run_scene, and the CLI")
    reset_launches()
    for path in sorted((Path(__file__).resolve().parent / "config").glob("scene-*.json")):
        s = load_scene_file(path, device="cuda")
        steps = E2_STEPS if s.emitter is not None else E2_DAM_STEPS
        t0 = time.perf_counter()
        st, overflow = run_lib.run_scene(s, steps)
        torch.cuda.synchronize()
        print(f" {path.name}: {steps} steps in {time.perf_counter() - t0:.2f} s, "
              f"n_active {int(st.active.sum())} of {s.state.capacity}, overflow {int(overflow)}")
        check_in_box(s.params, st, overflow, path.name)
        if s.emitter is None:
            continue
        cpu, _ = run_lib.run_scene(load_scene_file(path, device="cpu"), steps)
        card_vs_cpu(st, cpu, f"{path.name} {steps} steps", TRAJ_ATOL)
        if "twin" in path.name:
            spawn, x0 = s.emitter.spawn_step, s.emitter.spawn_pos[:, 0]
            left, right = (spawn >= 0) & (x0 < 0.5), (spawn >= 0) & (x0 > 0.5)
            first = (int(spawn[left].min()), int(spawn[right].min()))
            x = st.pos[st.active, 0]
            fired = (int((x < 0.5).sum()), int((x > 0.5).sum()))
            print(f"  twin jets: first rows at steps {first}; active left / right {fired}")
            check(first[1] > first[0] and min(fired) > 0, "twin jets: both nozzles must fire, "
                  "the delayed one later")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["simulate", "dam_break_2d", "--steps", str(E2_DAM_STEPS)])
    m = json.loads(out.getvalue())
    print(f" python -m sph_pie_torch simulate dam_break_2d --steps {E2_DAM_STEPS}: rc {rc}, "
          f"n_active {m['n_active']}, overflow {m['overflow']}, max_speed {m['max_speed']:.4f}, "
          f"mean_density {m['mean_density']:.3f}")
    check(rc == 0 and m["overflow"] == 0 and m["n_active"] > 0, "CLI run")
    check(all(np.isfinite(v) for v in m.values()), "CLI: a metric is not finite")
    print(f" launches in E2: {read_launches()}")


def phase_e3(b_ms: float) -> None:
    from sph_pie_torch.neighbors import binned as nb
    from sph_pie_torch.scenes import dam_break_3d, emitter, obstacles
    from sph_pie_torch.solvers import pbf
    from sph_pie_torch.solvers import run as run_lib

    print("== Phase E3: the epoch loop at 1M with a stirring sphere, dam_break_3d(1_000_000)")
    s = dam_break_3d(1_000_000, device="cuda")
    p, g = s.params, s.bgrid
    dt = float(p.dt)
    # radius 0.05 in the column, swinging 0.05 m along x with a period of 40 steps
    obs = obstacles.make(3, spheres=[([0.15, 0.2, 0.3], 0.05)],
                         sphere_motions=[([0.0, 0.0, 0.0], [0.05, 0.0, 0.0], 1.0 / (40 * dt), 0.0)],
                         device="cuda")
    em = emitter.no_emitter(s.state.capacity, 3, device="cuda")
    steps = E3_EPOCHS * E3_EPOCH_STEPS
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    # ---- the epoch loop at 1M: counts start at 0 here ----
    t0 = time.perf_counter()
    st, overflow = run_lib.run_epochs(p, g, s.state, em, obs, E3_EPOCH_STEPS, E3_EPOCHS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    # ---- counts read here ----
    peak = torch.cuda.max_memory_allocated()
    ms = wall * 1e3 / steps
    print(f" WCSPH {E3_EPOCHS} epochs of {E3_EPOCH_STEPS} steps: {ms:.3f} ms/step (Phase B "
          f"{b_ms:.3f} ms/step on this card), peak {peak / 2**30:.3f} GiB, launches {launches}")
    check_in_box(p, st, overflow, "E3 WCSPH")
    check(launches["density"] == steps and launches["forces"] == steps,
          f"E3: density/forces launches {launches} != steps {steps}")
    check(launches["expand"] >= E3_EPOCHS, "E3: expand launches below one per epoch")

    b = nb.bin_state(g, st, s.boundary, sim_time=float(steps) * p.dt)
    accel_ms = cuda_ms(lambda: obstacles.accel(obs, b.pos, b.vel, b.sim_time), 10)

    def boundary():
        flat = emitter.emit_due(nb.unbin(g, b, s.state.capacity), em, steps)
        return nb.bin_state(g, flat, s.boundary, sim_time=float(steps) * p.dt)

    boundary_ms = cuda_ms(boundary, 3)
    print(f" one obstacle term over {g.num_slots} slots {accel_ms:.3f} ms; one epoch boundary "
          f"(unbin + emit_due + bin_state) {boundary_ms:.3f} ms, {boundary_ms / E3_EPOCH_STEPS:.3f} "
          f"ms a step over an epoch of {E3_EPOCH_STEPS}")
    d = torch.sqrt(((st.pos[st.active] - torch.tensor([0.15 + 0.05 * float(np.sin(
        2 * np.pi * steps / 40)), 0.2, 0.3], device="cuda")) ** 2).sum(-1))
    print(f" particles inside the sphere at the end: {int((d < 0.05).sum())} (closest "
          f"{d.min().item():.4f} m, radius 0.05, h {float(p.h):.4f})")
    del b
    device_profile(lambda: run_lib.run_epochs(p, g, s.state, em, obs, 10, 1), 10,
                   "E3 one epoch of 10 steps")

    reset_launches()
    t0 = time.perf_counter()
    st, overflow = run_lib.run_epochs(p, g, s.state, em, obs, E3_PBF_STEPS, 1,
                                      pbf_params=pbf.flagship_params())
    torch.cuda.synchronize()
    print(f" PBF flagship, 1 epoch of {E3_PBF_STEPS} steps with the sphere: "
          f"{(time.perf_counter() - t0) * 1e3 / E3_PBF_STEPS:.1f} ms/step, launches "
          f"{read_launches()}")
    check_in_box(p, st, overflow, "E3 PBF")
    del st, s

    s = dam_break_3d(E3_PBF_N, device="cuda")
    pp = pbf.flagship_params()
    steps = E3_PBF_EPOCHS * E3_PBF_EPOCH_STEPS
    ep, ov = run_lib.run_epochs(s.params, s.bgrid, s.state, None, None, E3_PBF_EPOCH_STEPS,
                                E3_PBF_EPOCHS, pbf_params=pp)
    roll = pbf.simulate(s.params, s.bgrid, pp, s.binned_state(), steps)
    direct = nb.unbin(s.bgrid, roll, s.state.capacity)
    act = direct.active
    err = (ep.pos[act] - direct.pos[act]).abs().max().item()
    rho = ep.density[act] / s.params.rest_density
    print(f" PBF epochs ({E3_PBF_EPOCHS} x {E3_PBF_EPOCH_STEPS}) vs pbf.simulate ({steps}) at "
          f"{E3_PBF_N}: max |dpos| {err:.3e} (bound {PBF_EPOCH_ATOL:g}); rho / rho0 after the "
          f"epochs {rho.min().item():.4f} to {rho.max().item():.4f}")
    check(torch.equal(ep.active, act) and err <= PBF_EPOCH_ATOL, "E3: PBF epochs differ from the roll")
    check(bool((rho > 0.5).all()), "E3: density lost at the epoch boundary")
    check_in_box(s.params, ep, ov, "E3 PBF 20k")


def phase_e4() -> None:
    from sph_pie_torch.neighbors import binned as nb
    from sph_pie_torch.neighbors.density import density
    from sph_pie_torch.scenes import dam_break_2d
    from sph_pie_torch.solvers import adaptive

    print(f"== Phase E4: simulate_adaptive, dam_break_2d({E4_N}) to t_end = {E4_STEPS} dt, card "
          "and CPU")
    ks = {}
    for dev in ("cuda", "cpu"):
        s = dam_break_2d(E4_N, device=dev)
        base = float(s.params.dt)
        t_end = E4_STEPS * base
        reset_launches()
        b, t, k, dt_last = adaptive.simulate_adaptive(s.params, s.bgrid, s.binned_state(), t_end)
        st = nb.unbin(s.bgrid, b, s.state.capacity)
        ks[dev] = k
        print(f"  {dev}: t {float(t):.6e} of {t_end:.6e}, steps {k}, dt_last {float(dt_last):.4e} "
              f"(clamp [{0.05 * base:.4e}, {base:.4e}]), density launches {density.launches}")
        check(float(t) >= t_end * (1 - 1e-6) and k >= E4_STEPS, f"E4 {dev}: t_end not reached")
        check(0.05 * base * (1 - 1e-6) <= float(dt_last) <= base * (1 + 1e-6),
              f"E4 {dev}: dt_last outside its clamp")
        check_in_box(s.params, st, b.overflow, f"E4 {dev}")
        check(dev == "cpu" or density.launches == k, "E4: one density launch a step")
    check(abs(ks["cuda"] - ks["cpu"]) <= 1, f"E4: step counts {ks} differ by more than one")


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
        rows, main_path, b_ms = phase_b()
        seconds["B"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        rows += phase_c(main_path)
        seconds["C"] = time.perf_counter() - t0
        del main_path
        for name, phase in (("D1", phase_d1), ("D2", phase_d2), ("E1", phase_e1),
                            ("E2", phase_e2), ("E3", lambda: phase_e3(b_ms)), ("E4", phase_e4)):
            t0 = time.perf_counter()
            phase()
            seconds[name] = time.perf_counter() - t0
    print("phase seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
