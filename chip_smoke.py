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

Phase F drives periodic domains and the utilities. F1 is the periodic
channel ``dam_break_3d_periodic(1M)`` (984,960 particles, 86 x 34 x 65
cells periodic along y, cap 40, 8,490,240 slots) through the WCSPH main
path as Phase B runs it, with the launch counters reset just before and read
just after: ``wrap_ghosts`` fills the ghost planes after every rebin check,
so ``density.cu`` and ``forces.cu`` see occupied ghost homes and
candidates, and ``expand.cu`` places rows folded into the primary box. It
prints ms/step beside Phase B's, rebins and host syncs, one wrap's time
and the occupied ghost slots, the peak memory beside
``membudget.budget``'s reckoning, and then holds the three kernels against
their plain versions on the final state with its ghost planes populated.
F2 holds the card against the CPU: the channel at 20k (20 WCSPH steps, 2
PBF steps under each epilogue, ride against gather) and the fully periodic
2D box of ``tests/test_periodic.py`` in float64 for 300 steps, in which
particles cross a seam. F3 runs the gather engine (``solvers/wcsph.simulate``) on
``dam_break_2d(4096)`` for 200 steps on both devices in float64 and
float32. F4 checkpoints F1's state, resumes 10 steps from the file and from
memory (bit for bit), rotates a ``CheckpointManager``, times F1's step
with ``profiling.StepTimer`` and traces one with ``device_trace``.

Phase G drives ``parallel/``: spatial shards of the cells on a mesh inside
this process (one card holds them all). G1 runs Phase B's scene on 4
shards through the halo step and the sharded step (5 warm + 20 timed
steps each, then 225 more through the flow's first rebin), with the
launch counters reset just before and read just after (``density.cu`` and
``forces.cu`` once a shard a step, on each shard's home range; ``expand.cu``
for the binning and each rebin); it prints ms/step beside Phase B's, the
exchanges' time, rebins, host syncs and peak memory, holds the result
against the single card (bit for bit, and in owner order), each shard's kernels
against their plain twins, a rebin over the mesh against the single
card's, and times the step with its exchanges and then its pair kernels
taken out. G2 runs the balanced step on 8 shards (density and positions
against the single card), G3 steps the 16M dam break's grid geometry on 8
shards, G4 runs ``dryrun_multichip(8)``, and G5 a process group on NCCL
of one rank per card, in this process, against the in-process mesh.

Phase H drives the service (``sph_pie_torch/service/``) on the card. H1
serves an ``App(device="cuda")`` on a port of localhost in this process,
logs in, reads ``/api/health`` (it must name the card), submits a
``dam_break_3d`` run with ``params {"n_target": 1000000}`` and executes 200
steps with a step row every 50 over HTTP, with the launch counters reset
just before and read just after: rows at 50, 100, 150 and 200 with
995,328 active and overflow 0, ``density`` and ``forces`` launched 200
times, ``expand`` at least once, and a final checkpoint that
``load_state`` reads back; it prints the run's ms/step with the scene
build and the checkpoint timed apart. It then runs a PBF run through
``params.solver`` and holds the preview PNG of ``dam_break_2d`` against the
same preview from an ``App(device="cpu")``. H2 runs ``python -m
sph_pie_torch serve`` as a process (config port 0), reads its address line
and its ``/api/health``, and terminates it. H3 runs ``python -m
sph_pie_torch verify`` as a process on the card: the 4k / 1000-step float64
trajectory contract against the native C++ oracle within 1e-3, overflow 0,
1000 launches each of ``density`` and ``forces``. H1's launches are added
to rows 1-3 of the kernels line.

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
import functools
import json
import os
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
F_N = 1_000_000       # F1: dam_break_3d_periodic(1M): 984,960 particles
F_WARM, F_STEPS, F_REPS = 5, 20, 3  # F1: as Phase B
F2_N, F2_STEPS, F2_PBF_STEPS = 20_000, 20, 2  # F2: the channel on card and CPU
PERIODIC_TRAJ_ATOL = 1e-5  # F2: f32 max |dpos| after 20 WCSPH or 2 PBF steps, card vs
                           # CPU (the kernels sum in another order than the plain
                           # folds), domain ~1 m: Phase A's and D2's bound
F2_BOX_STEPS = 300    # F2: the 2D box of tests/test_periodic.py, drifting 0.5 m/s
BOX_F64_ATOL = 1e-9   # F2: f64 max |dpos| of the box, card vs CPU (E1's f64 bound)
F3_N, F3_STEPS = 4096, 200  # F3: the gather engine, dam_break_2d(4096)
GATHER_F64_ATOL = 1e-9  # F3: f64 max |dpos| after 200 steps, card vs CPU
GATHER_F32_ATOL = 1e-4  # F3: f32 max |dpos| after 200 steps, card vs CPU: the
                        # card's reductions sum in another order, 20x Phase A's
                        # 10 steps, so 10x its bound
F4_RESUME = 10        # F4: steps resumed from a checkpoint of F1's state
G_N = 1_000_000       # G1, G2: dam_break_3d(1M), Phase B's scene
G_SHARDS = 4          # G1: 267,812 cells, 66,953 a shard
G_WARM, G_STEPS = 5, 20  # G1: as one rep of Phase B, timed
G_MORE = 225          # G1: then on, untimed, through the flow's first rebins
G_BAL_SHARDS = 8      # G2, G3, G4: BASELINE config #5's 8-way split
G_BAL_STEPS = 5       # G2: the balanced step
G16_STEPS = 2         # G3: steps of the 16M geometry
G_ABLATE_STEPS, G_ABLATE_ROUNDS = 10, 3  # G1: steps of each ablated step, rounds
G_TRAJ_ATOL = 1e-5    # G1, G2: f32 max |dpos| against the single card in owner
                      # order: a rebin on another step (the halo step's
                      # one-stage trigger) reorders the candidates of the
                      # sums, a rounding-level change; F2's bound
G_DENSITY_RTOL = 1e-5  # G2: balanced density against the single card, f32;
                       # the reference's own bar (tests/test_halo.py)
H_N = 1_000_000       # H1: dam_break_3d(1M) over HTTP, Phase B's scene
H_STEPS, H_RECORD = 200, 50  # H1: steps executed, a step row every 50
H_PBF_N, H_PBF_STEPS = 20_000, 10  # H1: a PBF run (params.solver), D2's size
H_PREVIEW = 50        # H1: preview steps, dam_break_2d(2048), card App vs CPU App;
                      # held at D2's u8 bound (U8_SHARE)
H_POLL_S = 0.25       # H1: run status polls
H_PASSWORD = "Str0ng-Passw0rd!"  # H1: the admin's password after the forced reset
H_SERVE_TIMEOUT = 180  # H2: seconds to the address line
H_VERIFY_TIMEOUT = 480  # H3: seconds for verify (engine + the O(N^2) oracle on the host)

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


def ghost_slots(grid) -> torch.Tensor:
    """[S] bool: the slot's cell lies in the ghost ring of a periodic axis."""
    cells = torch.arange(grid.num_cells, device="cuda")
    ghost = torch.zeros_like(cells, dtype=torch.bool)
    for per, pd, st in zip(grid.periodic, grid.padded_dims, grid.strides):
        if per:
            c = (cells // st) % pd
            ghost |= (c == 0) | (c == pd - 1)
    return ghost.repeat_interleave(grid.cap)


def phase_f1(b_ms: float):
    """The periodic channel at full width through density.cu, forces.cu and
    expand.cu; returns (scene, final binned state) for F4."""
    from sph_pie_torch.neighbors import binned as nb
    from sph_pie_torch.neighbors.density import density
    from sph_pie_torch.neighbors.forces import forces
    from sph_pie_torch.neighbors.expand import expand
    from sph_pie_torch.scenes import dam_break_3d_periodic
    from sph_pie_torch.solvers import wcsph_binned
    from sph_pie_torch.utils import membudget

    print(f"== Phase F1: periodic channel, dam_break_3d_periodic({F_N:_}) float32, y periodic")
    t0 = time.perf_counter()
    s = dam_break_3d_periodic(F_N, device="cuda")
    g = s.bgrid
    n = int(s.state.n_active())
    y_len = g.dims[1] * g.cell_size
    print(f" particles {n}, dims {'x'.join(map(str, g.dims))} (padded "
          f"{'x'.join(map(str, g.padded_dims))}), periodic {g.periodic}, cap {g.cap}, cells "
          f"{g.num_cells}, slots {g.num_slots}, y period {y_len:.6f} m; scene built in "
          f"{time.perf_counter() - t0:.2f} s")
    check(n == 984_960 and g.dims == (86, 34, 65) and g.num_slots == 8_490_240,
          "periodic channel geometry")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    syncs: list[int] = []
    walls = []
    reset_launches()
    # ---- the periodic main path: counts start at 0 here ----
    b = s.binned_state()
    b = wcsph_binned.simulate(s.params, g, b, F_WARM)
    torch.cuda.synchronize()
    rebins0 = int(b.n_rebins)
    for _ in range(F_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with counting_syncs(syncs):
            b = wcsph_binned.simulate(s.params, g, b, F_STEPS)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3 / F_STEPS)
    launches = read_launches()
    # ---- counts read here ----
    peak = torch.cuda.max_memory_allocated()
    run = F_WARM + F_STEPS * F_REPS
    ms = statistics.median(walls)
    rebins = int(b.n_rebins)
    print(f" ms/step median {ms:.3f} (reps {', '.join(f'{w:.3f}' for w in walls)}); Phase B "
          f"(dam_break_3d(1M), no wrap) {b_ms:.3f} in this run")
    print(f" particle-steps/s {n / (ms / 1e3):.4e}; rebins {rebins} in {run} steps "
          f"({rebins - rebins0} in the timed {F_STEPS * F_REPS}), overflow {int(b.overflow)}; "
          f"host syncs {sum(syncs) / (F_STEPS * F_REPS):.3f}/step")
    reckon = membudget.budget(g, n)
    print(f" peak device memory {peak / 2**30:.3f} GiB; membudget reckoning for this grid "
          f"{reckon.total_bytes / 2**30:.3f} GiB ({reckon.row()})")
    print(f" launches over {run} steps: {launches} (density == forces == {run}, expand == 1 + "
          f"{rebins} rebins)")
    check(launches["density"] == run and launches["forces"] == run,
          f"F1: density/forces launches {launches} != steps {run}")
    check(launches["expand"] == 1 + rebins, f"F1: expand launches {launches['expand']} != 1 + "
          f"{rebins} rebins")
    check(int(b.overflow) == 0, "F1: overflow")
    check(bool(torch.isfinite(b.pos[b.valid]).all()), "F1: non-finite position")
    st = nb.unbin(g, b, s.state.capacity)
    check(int(st.active.sum()) == n, "F1: the active count changed")
    h, skin = float(s.params.h), g.skin
    pos = st.pos[st.active]
    lo, hi = s.params.bound_min - 5 * h, s.params.bound_max + 5 * h
    xz = [0, 2]
    check(bool(((pos[:, xz] >= lo[xz]) & (pos[:, xz] <= hi[xz])).all()),
          "F1: x or z outside the box +- 5h")
    y0 = g.origin[1]
    check(bool(((pos[:, 1] >= y0 - skin) & (pos[:, 1] <= y0 + y_len + skin)).all()),
          "F1: y outside [origin - skin, origin + L + skin]")

    wrapped = nb.wrap_ghosts(g, b)
    ghost = ghost_slots(g)
    occ_ghost = int((wrapped.valid & ghost).sum())
    occ_in = int((wrapped.valid & ~ghost).sum())
    wrap_ms = cuda_ms(lambda: nb.wrap_ghosts(g, b), 10)
    print(f" wrap_ghosts {wrap_ms:.3f} ms a call (CUDA events, mean of 10); occupied slots: "
          f"interior {occ_in}, ghost {occ_ghost} (+{occ_ghost / occ_in:.2%})")
    check(occ_ghost > 0, "F1: no occupied ghost slot")

    print(" kernels against their plain versions on the final state, ghost planes populated:")
    errs, plain, bk = compare_kernels(s.params, g, wrapped)
    k_ms = {"density": cuda_ms(lambda: density(s.params, g, bk), 10),
            "forces": cuda_ms(lambda: forces(s.params, g, bk), 10)}
    srt = rebin_rows(g, b)
    e_ms = cuda_ms(lambda: expand(srt.first, srt.count, srt.rows, srt.owner, g.cap), 10)
    rest = ms - wrap_ms - k_ms["density"] - k_ms["forces"]
    print(f" time split of a step: wrap {wrap_ms:.3f}, density {k_ms['density']:.3f}, forces "
          f"{k_ms['forces']:.3f}, expand {e_ms:.3f} ms a rebin x {rebins / run:.3f} rebins a "
          f"step, the rest {rest:.3f} ms (of {ms:.3f}); plain density {plain['density']:.1f}, "
          f"forces {plain['forces']:.1f} ms")
    return s, b


def periodic_box(device: str, dtype):
    """The fully periodic 2D box of tests/test_periodic.py (250 random
    particles, drifting 0.5 m/s along x) after ``F2_BOX_STEPS`` WCSPH steps:
    (start positions, final flat state, final binned state, period)."""
    from sph_pie_torch.core.params import make_params
    from sph_pie_torch.core.state import from_positions
    from sph_pie_torch.neighbors import binned as nb
    from sph_pie_torch.solvers import wcsph_binned

    rng = np.random.default_rng(0)
    h, L, n = 0.1, 8 * 0.1 * 1.25, 250
    pos = rng.uniform(0, L, size=(n, 2))
    params = make_params(dim=2, h=h, dt=1e-4, bound_min=[0, 0], bound_max=[L, L],
                         viscosity=0.05, dtype=dtype, device=device)
    grid = nb.binned_grid_from_bounds([0, 0], [L, L], h=h, cap=32, skin_frac=0.25,
                                      max_particles=n, periodic=(True, True))
    st = from_positions(pos, capacity=n, vel=np.zeros_like(pos) + [0.5, 0.0], mass=1.0,
                        dtype=dtype, device=device)
    b = wcsph_binned.simulate(params, grid, nb.bin_state(grid, st), F2_BOX_STEPS)
    return pos, nb.unbin(grid, b, n), b, L


def channel_runs(device: str) -> tuple:
    """F2's runs of ``dam_break_3d_periodic(F2_N)`` float32 on one device:
    (scene, {"wcsph" | "ride" | "gather": final binned state})."""
    from sph_pie_torch.scenes import dam_break_3d_periodic
    from sph_pie_torch.solvers import pbf, wcsph_binned

    s = dam_break_3d_periodic(F2_N, device=device)
    out = {"wcsph": wcsph_binned.simulate(s.params, s.bgrid, s.binned_state(), F2_STEPS)}
    for ep in ("ride", "gather"):
        pp = pbf.flagship_params(epilogue=ep, device=device)
        out[ep] = pbf.simulate(s.params, s.bgrid, pp, s.binned_state(), F2_PBF_STEPS)
    return s, out


def phase_f2() -> None:
    from sph_pie_torch.neighbors import binned as nb

    print(f"== Phase F2: periodic runs, card against CPU: dam_break_3d_periodic({F2_N}) float32, "
          f"{F2_STEPS} WCSPH and {F2_PBF_STEPS} PBF steps; the 2D periodic box, float64")
    s, card = channel_runs("cuda")
    t0 = time.perf_counter()
    _, host = channel_runs("cpu")
    print(f" CPU runs {time.perf_counter() - t0:.1f} s")
    g, cap = s.bgrid, s.state.capacity
    print(f" particles {int(s.state.n_active())}, dims {g.dims}, slots {g.num_slots}")
    for name in ("wcsph", "ride", "gather"):
        bk, bh = card[name], host[name]
        card_vs_cpu(nb.unbin(g, bk, cap), nb.unbin(g, bh, cap),
                    f"{name}: rebins card {int(bk.n_rebins)} CPU {int(bh.n_rebins)}",
                    PERIODIC_TRAJ_ATOL)
        check(int(bk.n_rebins) == int(bh.n_rebins) and int(bk.overflow) == 0,
              f"F2 {name}: rebins or overflow")
    ur, ug = nb.unbin(g, card["ride"], cap), nb.unbin(g, card["gather"], cap)
    rg = max((getattr(ur, k) - getattr(ug, k)).abs().max().item() for k in ("pos", "vel"))
    print(f"  ride vs gather on the card: max |d| pos, vel {rg:.3e} (bound {RIDE_GATHER_ATOL:g})")
    check(rg <= RIDE_GATHER_ATOL, "F2: ride and gather differ on the card")

    x0, card_st, b, L = periodic_box("cuda", torch.float64)
    _, cpu_st, bc, _ = periodic_box("cpu", torch.float64)
    x1 = cpu_st.pos.numpy()
    crossed = int(((x1 < 0) | (x1 >= L) | (np.abs(x1 - x0) > L / 2)).any(1).sum())
    print(f"  2D box, {F2_BOX_STEPS} steps: {crossed} particles crossed a seam, rebins card "
          f"{int(b.n_rebins)} CPU {int(bc.n_rebins)}, overflow {int(b.overflow)}")
    check(crossed >= 1 and int(b.n_rebins) == int(bc.n_rebins) >= 1 and int(b.overflow) == 0,
          "F2: the box crossed no seam, or rebins or overflow differ")
    card_vs_cpu(card_st, cpu_st, "2D box float64", BOX_F64_ATOL)


def phase_f3() -> None:
    from sph_pie_torch.scenes import dam_break_2d
    from sph_pie_torch.solvers import wcsph

    print(f"== Phase F3: the gather engine, wcsph.simulate on dam_break_2d({F3_N}), "
          f"{F3_STEPS} steps, card and CPU")
    for dt, atol in ((torch.float64, GATHER_F64_ATOL), (torch.float32, GATHER_F32_ATOL)):
        runs = {}
        for dev in ("cuda", "cpu"):
            s = dam_break_2d(F3_N, dtype=dt, device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runs[dev] = wcsph.simulate(s.params, s.gspec, s.state, F3_STEPS)
            torch.cuda.synchronize()
            if dev == "cuda":
                wall = time.perf_counter() - t0
                print(f"  {dt}: {F3_STEPS / wall:.1f} steps/s on the card, cap {s.gspec.cap}, "
                      f"cells {s.gspec.num_cells}")
                check_in_box(s.params, runs[dev], 0, f"F3 {dt}")
        card_vs_cpu(runs["cuda"], runs["cpu"], f"{F3_STEPS} steps {dt}", atol)


def phase_f4(f1) -> None:
    import tempfile
    from pathlib import Path

    from sph_pie_torch.neighbors import binned as nb
    from sph_pie_torch.scenes import dam_break_2d
    from sph_pie_torch.solvers import wcsph_binned
    from sph_pie_torch.utils import checkpoint, profiling

    s, b = f1
    g, p = s.bgrid, s.params
    print("== Phase F4: checkpoint, resume, rotation, StepTimer and device_trace on F1's state")
    st = nb.unbin(g, b, s.state.capacity)
    with tempfile.TemporaryDirectory(dir=Path(__file__).resolve().parent,
                                     prefix=".chip_smoke_") as d:
        t0 = time.perf_counter()
        path = checkpoint.save_state(Path(d) / "f1.npz", st, p, step=int(b.n_rebins))
        t_save = time.perf_counter() - t0
        t0 = time.perf_counter()
        st2, p2, _, _ = checkpoint.load_state(path, device="cuda")
        t_load = time.perf_counter() - t0
        same = [k for k in vars(st) if not torch.equal(getattr(st, k), getattr(st2, k))]
        print(f"  save {t_save:.2f} s ({path.stat().st_size / 2**20:.1f} MiB), load "
              f"{t_load:.2f} s; fields that differ after the round trip: {same}")
        check(not same, "F4: the checkpoint changed the state")
        mem = wcsph_binned.simulate(p, g, nb.bin_state(g, st), F4_RESUME)
        disk = wcsph_binned.simulate(p2, g, nb.bin_state(g, st2), F4_RESUME)
        diff = [k for k in vars(mem) if not torch.equal(getattr(mem, k), getattr(disk, k))]
        print(f"  resumed {F4_RESUME} steps from the file and from memory: fields that differ "
              f"{diff} (bound: none)")
        check(not diff, "F4: a resume from the checkpoint differs from one from memory")

        small = dam_break_2d(F3_N, device="cuda")
        mgr = checkpoint.CheckpointManager(Path(d) / "rot", keep=2)
        for step in (10, 20, 30):
            mgr.save(small.state, small.params, step=step)
        kept = sorted(q.name for q in (Path(d) / "rot").glob("ckpt_*.npz"))
        _, _, latest, _ = mgr.restore_latest(device="cuda")
        print(f"  CheckpointManager(keep=2) after steps 10, 20, 30: {kept}, restores step {latest}")
        check(kept == ["ckpt_20.npz", "ckpt_30.npz"] and latest == 30, "F4: rotation")

    timer = profiling.StepTimer()
    for _ in range(10):
        with timer.time("F1 step", device="cuda") as out:
            b = wcsph_binned.step(p, g, b)
            out["result"] = b.pos
    stt = timer.stats()["F1 step"]
    print(f"  StepTimer (CUDA events), 10 F1 steps: p50 {stt['p50_ms']:.3f} ms, mean "
          f"{stt['mean_ms']:.3f}, max {stt['max_ms']:.3f}")
    with profiling.device_trace() as prof:
        with profiling.annotate("F1 step"):
            b = wcsph_binned.step(p, g, b)
            torch.cuda.synchronize()
    from torch.autograd import DeviceType

    evs = prof.events()
    dev = [e for e in evs if e.device_type == DeviceType.CUDA]
    spans = [e for e in evs if e.name == "F1 step"]
    print(f"  device_trace of one F1 step: {len(dev)} device kernels and copies, "
          f"{sum(e.time_range.elapsed_us() for e in dev) / 1e3:.3f} device ms, span 'F1 step' "
          f"recorded {len(spans)} time(s)")
    check(len(spans) >= 1, "F4: the annotate span is missing from the trace")


@functools.cache
def card() -> str:
    return card_line()


def gline(text: str) -> None:
    """A line of Phases G and H, with the card's name and power limit."""
    print(f"{text} [{card()}]", flush=True)


def shard_kernels_vs_plain(mesh, params, grid, st) -> None:
    """Each shard's ``density.cu`` and ``forces.cu`` on its home range
    against their plain twins (the fold with the buffer's margins as
    halos), after fresh exchanges, at Phase A's bounds."""
    from sph_pie_torch.kernels import eos
    from sph_pie_torch.neighbors.density import density, density_plain
    from sph_pie_torch.neighbors.forces import forces, forces_plain
    from sph_pie_torch.parallel import comm, sharding

    live = [s for s in st.shards if s.cells]
    comm.exchange(mesh, st.shards, ("pos", "vel", "mass"))
    worst = [0.0, 0.0, 0.0]
    for s in live:
        v = sharding.view(s)
        rk, rp = density(params, grid, v, home=s.home), density_plain(params, grid, v, home=s.home)
        ok = v.valid
        rel = ((rk - rp).abs()[ok] / rp[ok]).max().item() if bool(ok.any()) else 0.0
        check(rel <= DENSITY_RTOL and torch.equal(rk[~ok], rp[~ok]),
              f"shard {s.index}: density kernel disagrees ({rel:.3e})")
        worst[0] = max(worst[0], rel)
        inv_rho = 1.0 / rk
        s.field("inv_rho").copy_(inv_rho)
        s.field("pr2").copy_(eos.tait_pressure(params, rk) * inv_rho * inv_rho)
        s.field("m_rho").copy_(s.field("mass") * inv_rho)
    comm.exchange(mesh, st.shards, ("pr2", "m_rho", "inv_rho"))
    for s in live:
        v, per = sharding.view(s), (s.buf["inv_rho"], s.buf["pr2"], s.buf["m_rho"])
        ak, xk = forces(params, grid, v, home=s.home, per_slot=per)
        ap, xp = forces_plain(params, grid, v, home=s.home, per_slot=per)
        ea, ex = scaled(ak, ap), scaled(xk, xp)
        check(ea <= FORCES_ATOL and ex <= FORCES_ATOL,
              f"shard {s.index}: forces kernel disagrees ({ea:.3e}, {ex:.3e})")
        worst[1], worst[2] = max(worst[1], ea), max(worst[2], ex)
    gline(f"  each of {len(live)} shards against its plain twin (margins as halos): density "
          f"max rel {worst[0]:.3e} (bound {DENSITY_RTOL:g}), forces acc {worst[1]:.3e}, xsph "
          f"{worst[2]:.3e} scaled (bound {FORCES_ATOL:g})")


def owner_dpos(grid, got, want, capacity: int) -> float:
    """max |dpos| of the active particles in owner order; active sets equal."""
    from sph_pie_torch.neighbors import binned as nb

    a, b = nb.unbin(grid, got, capacity), nb.unbin(grid, want, capacity)
    check(torch.equal(a.active, b.active), "the active particles differ")
    return (a.pos[b.active] - b.pos[b.active]).abs().max().item()


def g_ablate(mesh, params, grid, st) -> None:
    """Where a G1 step's time goes: steps of the sharded step as it runs,
    with its exchanges made no-ops, and with its pair kernels' outputs
    served from a cache, in turns (``G_ABLATE_ROUNDS`` rounds of
    ``G_ABLATE_STEPS`` steps each; medians). Each ablation times the real
    step with one phase taken out; the state is not checked afterwards."""
    from sph_pie_torch.parallel import comm, sharding

    step = sharding.sharded_step(mesh, params, grid)
    real_exchange, real_kernels = comm.exchange, (sharding.density, sharding.forces)
    cache = {}
    for s in st.shards:
        v = sharding.view(s)
        per = (s.buf["inv_rho"], s.buf["pr2"], s.buf["m_rho"])
        cache[("d", s.index)] = real_kernels[0](params, grid, v, home=s.home)
        cache[("f", s.index)] = real_kernels[1](params, grid, v, home=s.home, per_slot=per)
    index = {s.buf["pos"].data_ptr(): s.index for s in st.shards}

    def no_exchange():
        comm.exchange = lambda *a, **k: None

    def no_kernels():
        sharding.density = lambda p, g, v, home: cache[("d", index[v.pos.data_ptr()])]
        sharding.forces = lambda p, g, v, home, per_slot: cache[("f", index[v.pos.data_ptr()])]

    times = {"full": [], "no exchange": [], "no kernels": []}
    for _ in range(G_ABLATE_ROUNDS):
        for name, take_out in (("full", lambda: None), ("no exchange", no_exchange),
                               ("no kernels", no_kernels)):
            take_out()
            try:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(G_ABLATE_STEPS):
                    st = step(st)
                torch.cuda.synchronize()
                times[name].append((time.perf_counter() - t0) * 1e3 / G_ABLATE_STEPS)
            finally:
                comm.exchange = real_exchange
                sharding.density, sharding.forces = real_kernels
    med = {k: statistics.median(v) for k, v in times.items()}
    gline(f"  G1 ablation, sharded step, {G_ABLATE_ROUNDS} rounds of {G_ABLATE_STEPS} steps in "
          f"turns, medians: as it runs {med['full']:.3f} ms/step; without the exchanges "
          f"{med['no exchange']:.3f} (they cost {med['full'] - med['no exchange']:.3f}); without "
          f"density.cu and forces.cu {med['no kernels']:.3f} (they cost "
          f"{med['full'] - med['no kernels']:.3f}); rounds "
          + "; ".join(f"{k} " + ", ".join(f"{t:.3f}" for t in v) for k, v in times.items()))


def phase_g1(b_ms: float) -> None:
    """The 1M flagship on a 4-shard in-process mesh, through the halo step
    and the sharded step."""
    from sph_pie_torch.neighbors import binned as nb
    from sph_pie_torch.parallel import balance, comm, halo, sharding
    from sph_pie_torch.scenes import dam_break_3d
    from sph_pie_torch.solvers import wcsph_binned

    s = dam_break_3d(G_N, device="cuda")
    g, n = s.bgrid, int(s.state.n_active())
    mesh = comm.make_mesh(G_SHARDS, device="cuda")
    hc = nb.halo_cells(g)
    gline(f"== Phase G1: dam_break_3d({G_N:_}) on {G_SHARDS} in-process shards: {n} particles, "
          f"{g.num_cells} cells ({g.num_cells // G_SHARDS} a shard), halo {hc} cells (strides "
          f"{g.strides}), cap {g.cap}")
    run = G_WARM + G_STEPS + G_MORE
    ref = wcsph_binned.simulate(s.params, g, s.binned_state(), run)
    budget = balance.hbm_budget_bytes(n, n_dev=G_SHARDS)
    makers = {
        "halo": lambda: halo.make_halo_step(mesh, s.params, g)[0],
        "sharded": lambda: sharding.sharded_step(mesh, s.params, g),
    }
    for name, make in makers.items():
        step = make()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        syncs: list[int] = []
        reset_launches()
        # ---- the parallel path: counts start at 0 here ----
        st = sharding.shard_binned(mesh, g, s.binned_state())
        for _ in range(G_WARM):
            st = step(st)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with counting_syncs(syncs):
            for _ in range(G_STEPS):
                st = step(st)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / G_STEPS
        for _ in range(G_MORE):
            st = step(st)
        torch.cuda.synchronize()
        launches = read_launches()
        # ---- counts read here ----
        peak = torch.cuda.max_memory_allocated()
        rebins = int(st.n_rebins)
        ex_ms = sum(cuda_ms(lambda k=k: comm.exchange(mesh, st.shards, k), 10)
                    for k in (("pos", "vel", "mass"), ("pr2", "m_rho", "inv_rho")))
        gline(f" G1 {name}: ms/step {ms:.3f} over {G_STEPS} steps after {G_WARM} (Phase B "
              f"{b_ms:.3f} in this run), then {G_MORE} more; exchanges {ex_ms:.3f} ms a step "
              f"(CUDA events, both); rebins {rebins} in {run} steps, overflow "
              f"{int(st.overflow)}; host syncs {sum(syncs) / G_STEPS:.3f}/step (timed steps)")
        gline(f"  launches over {run} steps: {launches} (density == forces == {G_SHARDS} x "
              f"{run}, expand == 1 + {rebins} rebins); peak device memory "
              f"{peak / 2**30:.3f} GiB, hbm_budget_bytes per device "
              f"{budget['per_device_gb']:.3f} GB ({budget['bytes_per_slot']} B a slot)")
        check(launches["density"] == G_SHARDS * run and launches["forces"] == G_SHARDS * run,
              f"G1 {name}: density/forces launches {launches} != {G_SHARDS} x {run}")
        check(launches["expand"] == 1 + rebins and rebins >= 1,
              f"G1 {name}: expand launches {launches}, rebins {rebins}")
        out = sharding.gather_binned(mesh, g, st)
        err = owner_dpos(g, out, ref, s.state.capacity)
        same = all(torch.equal(getattr(out, k), getattr(ref, k))
                   for k in ("pos", "vel", "density", "pressure", "owner"))
        gline(f"  against the single card in owner order: max |dpos| {err:.3e} (bound "
              f"{G_TRAJ_ATOL:g}); rebins single card {int(ref.n_rebins)}; every slot field "
              f"bit-equal to the single card: {same}")
        check(int(st.overflow) == 0 and err <= G_TRAJ_ATOL, f"G1 {name}: differs from one card")
        check(bool(torch.isfinite(out.pos).all()), f"G1 {name}: non-finite position")
        del out
    shard_kernels_vs_plain(mesh, s.params, g, st)
    t_gather = cuda_ms(lambda: sharding.gather_binned(mesh, g, st), 5)
    b = sharding.gather_binned(mesh, g, st)
    t_rebin = cuda_ms(lambda: nb.rebin(g, b), 5)
    b2 = nb.rebin(g, b)
    t_split = cuda_ms(lambda: sharding._put(mesh, st, b2), 5)
    sharded_rebin = sharding._global(mesh, g, st, lambda bb: nb.rebin(g, bb))
    back = sharding.gather_binned(mesh, g, sharded_rebin)
    same = all(torch.equal(getattr(back, k), getattr(b2, k)) for k in sharding.SLOT_FIELDS)
    gline(f"  a rebin over the mesh: gather {t_gather:.3f} + rebin {t_rebin:.3f} + split "
          f"{t_split:.3f} ms (CUDA events, mean of 5); split back bit-equal to the single "
          f"card's rebin: {same}")
    check(same, "G1: the rebin over the mesh differs")
    del b, b2, back
    device_profile(lambda: sharding.sharded_simulate(mesh, s.params, g)(sharded_rebin, 5), 5,
                   f"G1 sharded [{card()}]")
    g_ablate(mesh, s.params, g, sharded_rebin)


def phase_g2() -> None:
    """The balanced step on 8 shards of the flagship, against the single card."""
    from sph_pie_torch.neighbors import binned as nb
    from sph_pie_torch.parallel import balance, comm
    from sph_pie_torch.scenes import dam_break_3d
    from sph_pie_torch.solvers import wcsph_binned

    s = dam_break_3d(G_N, device="cuda")
    g = s.bgrid
    mesh = comm.make_mesh(G_BAL_SHARDS, device="cuda")
    b0 = s.binned_state()
    counts = balance.cell_counts(g, b0).cpu().numpy()
    c_cap = max(3 * g.num_cells // G_BAL_SHARDS, nb.halo_cells(g) + 1)
    starts = balance.balanced_splits(counts, G_BAL_SHARDS, c_cap)
    equal = np.linspace(0, g.num_cells, G_BAL_SHARDS + 1).astype(np.int64)
    bf, bf_eq = balance.balance_factor(counts, starts), balance.balance_factor(counts, equal)
    widths = np.diff(starts)
    gline(f"== Phase G2: balanced step, dam_break_3d({G_N:_}) on {G_BAL_SHARDS} shards, c_cap "
          f"{c_cap}: starts {starts.tolist()} (widths {widths.tolist()}, halo "
          f"{nb.halo_cells(g)}); balance {bf:.3f}x, equal-cells {bf_eq:.3f}x")
    init_fn, step_fn, finish_fn = balance.make_balanced_step(mesh, s.params, g, c_cap)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    # ---- the balanced path: counts start at 0 here ----
    bs = init_fn(b0, starts)
    t0 = time.perf_counter()
    for _ in range(G_BAL_STEPS):
        bs = step_fn(bs)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / G_BAL_STEPS
    launches = read_launches()
    # ---- counts read here ----
    live = int((widths > 0).sum())
    out = finish_fn(bs, b0)
    ref = wcsph_binned.simulate(s.params, g, b0, G_BAL_STEPS)
    check(int(ref.n_rebins) == 0, "G2: the single card rebinned; slot comparison invalid")
    v = ref.valid
    rel = ((out.density - ref.density).abs()[v] / ref.density[v]).max().item()
    err = (out.pos - ref.pos)[v].abs().max().item()
    gline(f" G2: {ms:.3f} ms/step over {G_BAL_STEPS} steps, peak {torch.cuda.max_memory_allocated() / 2**30:.3f} "
          f"GiB; launches {launches} (density == forces == {live} shards x {G_BAL_STEPS}); "
          f"against the single card: density max rel {rel:.3e} (bound {G_DENSITY_RTOL:g}), "
          f"max |dpos| {err:.3e} (bound {G_TRAJ_ATOL:g})")
    check(launches["density"] == live * G_BAL_STEPS == launches["forces"],
          f"G2: launches {launches}")
    check(rel <= G_DENSITY_RTOL and err <= G_TRAJ_ATOL, "G2: balanced step differs from one card")


def phase_g3() -> None:
    """The 16M dam break's grid geometry, placed on 8 shards and stepped."""
    from sph_pie_torch.parallel import balance, comm, dryrun, sharding
    from sph_pie_torch.utils import membudget

    mesh = comm.make_mesh(G_BAL_SHARDS, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, g, st = dryrun.state_16m(mesh)
    built = time.perf_counter() - t0
    reset_launches()
    # ---- the 16M geometry's path: counts start at 0 here ----
    step = sharding.sharded_step(mesh, params, g)
    t0 = time.perf_counter()
    for _ in range(G16_STEPS):
        st = step(st)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / G16_STEPS
    launches = read_launches()
    # ---- counts read here ----
    peak = torch.cuda.max_memory_allocated()
    out = sharding.gather_binned(mesh, g, st)
    k = int(st.slot_of.shape[0])
    full = membudget.dam_break_budget(16_000_000, n_devices=G_BAL_SHARDS)
    hbm = balance.hbm_budget_bytes(16_000_000, n_dev=G_BAL_SHARDS)
    gline(f"== Phase G3: the 16M geometry, grid {g.dims}, cap {g.cap}, {g.num_slots:,} slots, "
          f"{k:,} particles (a 4 dx lattice) on {G_BAL_SHARDS} shards: built {built:.2f} s, "
          f"{G16_STEPS} sharded steps at {ms:.3f} ms/step, launches {launches}, overflow "
          f"{int(out.overflow)}")
    gline(f"  peak device memory {peak / 2**30:.3f} GiB (one card holds all 8 shards, the whole "
          f"state and its gathered copy); membudget.dam_break_budget(16M, 8) per card "
          f"{full.total_bytes / 2**30:.3f} GiB at cap {40} ({full.row()}); hbm_budget_bytes "
          f"per device {hbm['per_device_gb']:.3f} GB of {hbm['h100_hbm_gb']:g}")
    check(launches["density"] == launches["forces"] == G_BAL_SHARDS * G16_STEPS,
          f"G3: launches {launches}")
    check(int(out.overflow) == 0 and bool(torch.isfinite(out.pos).all()), "G3: bad state")
    check(full.fits and hbm["fits"], "G3: 16M does not fit the budget")


def phase_g4() -> None:
    """``dryrun_multichip(8)`` on the card, its lines tagged with the card."""
    import io

    from sph_pie_torch.parallel import dryrun

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = dryrun.dryrun_multichip(G_BAL_SHARDS, device="cuda")
    gline(f"== Phase G4: dryrun_multichip({G_BAL_SHARDS}) on the card")
    for line in buf.getvalue().splitlines():
        gline(f"  {line}")
    check(set(out) == {"balanced", "shape", "pbf", "periodic"}, "G4: a leg is missing")


def phase_g5() -> None:
    """The process-group mesh on NCCL, one rank per card, in this process
    through a FileStore, against the in-process mesh."""
    import shutil
    import tempfile
    from pathlib import Path

    import torch.distributed as dist

    from sph_pie_torch.parallel import comm, halo, sharding
    from sph_pie_torch.scenes import dam_break_3d

    world = torch.cuda.device_count()
    check(world == 1, f"G5 runs one rank in this process; the machine has {world} cards")
    s = dam_break_3d(G_N, device="cuda")
    g = s.bgrid
    d = tempfile.mkdtemp(dir=Path(__file__).resolve().parent, prefix=".chip_smoke_")
    try:
        store = dist.FileStore(os.path.join(d, "store"), world)
        dist.init_process_group("nccl", store=store, rank=0, world_size=world)
        try:
            mesh = comm.make_mesh(device="cuda", group=dist.group.WORLD)
            step, _ = halo.make_halo_step(mesh, s.params, g)
            st = sharding.shard_binned(mesh, g, s.binned_state())
            for _ in range(5):
                st = step(st)
            got = sharding.gather_binned(mesh, g, st)
            torch.cuda.synchronize()
        finally:
            dist.destroy_process_group()
    finally:
        shutil.rmtree(d, ignore_errors=True)
    local = comm.make_mesh(1, device="cuda")
    step, _ = halo.make_halo_step(local, s.params, g)
    st = sharding.shard_binned(local, g, s.binned_state())
    for _ in range(5):
        st = step(st)
    want = sharding.gather_binned(local, g, st)
    differ = [k for k in sharding.SLOT_FIELDS + ("travel", "sim_time")
              if not torch.equal(getattr(got, k), getattr(want, k))]
    gline(f"== Phase G5: NCCL process group, world size {world} (FileStore, this process), "
          f"5 halo steps of dam_break_3d({G_N:_}): fields that differ from a 1-shard in-process "
          f"mesh: {differ}. With one card no exchange crossed processes: the group's pmax and "
          f"all_gather ran on one rank, a run across cards needs a machine with two or more")
    check(not differ, "G5: the NCCL mesh differs from the in-process mesh")


class Client:
    """JSON over HTTP with one session cookie (urllib: no dependency)."""

    def __init__(self, base: str):
        self.base, self.cookie = base, None

    def raw(self, method: str, path: str, body=None, timeout: float = 120) -> tuple[int, bytes]:
        import urllib.error
        import urllib.request

        req = urllib.request.Request(
            self.base + path, method=method,
            data=json.dumps(body).encode() if body is not None else None,
            headers={"Content-Type": "application/json"},
        )
        if self.cookie:
            req.add_header("Cookie", self.cookie)
        try:
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                status, data, set_cookie = resp.status, resp.read(), resp.headers.get("Set-Cookie")
        except urllib.error.HTTPError as e:
            status, data, set_cookie = e.code, e.read(), e.headers.get("Set-Cookie")
        if set_cookie:
            self.cookie = set_cookie.split(";")[0]
        return status, data

    def req(self, method: str, path: str, body=None, expect: int = 200) -> dict:
        status, data = self.raw(method, path, body)
        check(status == expect, f"{method} {path}: {status} != {expect}: {data[:300]!r}")
        return json.loads(data)

    def login_admin(self) -> None:
        from sph_pie_torch.service.users import DEFAULT_TEMP_PASSWORD

        self.req("POST", "/api/auth/login",
                 {"email": "admin@local", "password": DEFAULT_TEMP_PASSWORD})
        self.req("POST", "/api/auth/password",
                 {"currentPassword": DEFAULT_TEMP_PASSWORD, "password": H_PASSWORD})

    def execute(self, name: str, scene: str, params: dict, steps: int, record_every: int,
                timeout: float = 600) -> tuple[dict, float]:
        """Create a run, execute it, poll until it ends; (run, seconds from
        the execute request to the end seen)."""
        rid = self.req("POST", "/api/runs", {"name": name, "scene": scene, "runDate": "2026-10-17",
                                             "params": params}, 201)["run"]["id"]
        t0 = time.perf_counter()
        self.req("POST", f"/api/runs/{rid}/execute", {"steps": steps, "recordEvery": record_every},
                 202)
        while time.perf_counter() - t0 < timeout:
            run = self.req("GET", f"/api/runs/{rid}")["run"]
            if run.get("status") in ("completed", "failed"):
                break
            time.sleep(H_POLL_S)
        check(run.get("status") == "completed", f"{name}: run {run.get('status')}: {run.get('error')}")
        return run, time.perf_counter() - t0


def png_pixels(data: bytes) -> np.ndarray:
    """uint8 [H, W] of the service's 8-bit grayscale PNG (rows filter 0)."""
    import struct
    import zlib

    check(data[:8] == b"\x89PNG\r\n\x1a\n", "not a PNG")
    i, idat, shape = 8, b"", None
    while i < len(data):
        (n,) = struct.unpack(">I", data[i:i + 4])
        tag, body = data[i + 4:i + 8], data[i + 8:i + 8 + n]
        if tag == b"IHDR":
            w, h = struct.unpack(">II", body[:8])
            shape = (h, w)
        elif tag == b"IDAT":
            idat += body
        i += 12 + n
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(shape[0], shape[1] + 1)
    return rows[:, 1:]


@contextlib.contextmanager
def served(app):
    """``app`` on an ephemeral port of localhost, in a thread; the client."""
    import threading

    from sph_pie_torch.service.api import make_server

    srv = make_server(app, "127.0.0.1", 0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        yield Client(f"http://127.0.0.1:{srv.server_port}")
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)
        app.registry.get_provider().dispose()


def phase_h1(b_ms: float) -> dict:
    """The service in this process: a 1M dam break submitted over HTTP and
    executed on the card, a PBF run, and a preview frame against the CPU's."""
    import shutil
    import tempfile
    from pathlib import Path

    from sph_pie_torch.service.api import App
    from sph_pie_torch.utils.checkpoint import load_state

    print(f"== Phase H1: the service on the card, dam_break_3d({H_N:_}) submitted over HTTP, "
          f"{H_STEPS} steps, a record every {H_RECORD}", flush=True)
    root = Path(__file__).resolve().parent
    d = Path(tempfile.mkdtemp(dir=root, prefix=".chip_smoke_"))
    try:
        app = App(config_path=d / "cfg.json", data_dir=str(d), env={}, device="cuda")
        with served(app) as c:
            c.login_admin()
            health = c.req("GET", "/api/health")
            dev = health["device"]
            gline(f"  /api/health device {dev}, storage {health['storage']['provider']}")
            check(dev["backend"] == "cuda" and torch.cuda.get_device_name(0) in dev["devices"][0],
                  f"H1: health does not name the card: {dev}")

            reset_launches()
            # ---- the service path: counts start at 0 here ----
            run, wall = c.execute("h1-flagship", "dam_break_3d", {"n_target": H_N}, H_STEPS,
                                  H_RECORD)
            launches = read_launches()
            # ---- counts read here ----
            rows, timing = run["steps"], run["timing"]
            ms = timing["stepSeconds"] * 1e3 / H_STEPS
            gline(f"  run {run['status']} in {wall:.2f} s from the execute request: scene build "
                  f"{timing['buildSeconds']:.3f} s, {H_STEPS} steps {timing['stepSeconds']:.3f} s "
                  f"= {ms:.3f} ms/step (Phase B {b_ms:.3f}; epochs of {H_RECORD} steps, each "
                  f"binned and unbinned, one read of the metrics a record), checkpoint "
                  f"{timing['checkpointSeconds']:.3f} s")
            marks = [run["startedAt"]] + [r["recordedAt"] for r in rows]
            print(f"  ms a step in each epoch of {H_RECORD} (step rows' and the run's start "
                  "timestamps, ms resolution; bin_state, the steps, unbin, the metrics read, "
                  "the row write): " + ", ".join(
                      f"{(b - a) / H_RECORD:.2f}" for a, b in zip(marks, marks[1:])))
            print("  step rows: " + "; ".join(
                f"{r['step']}: n_active {r['n_active']}, overflow {r['overflow']}, kinetic energy "
                f"{r['kinetic_energy']:.4e}, max speed {r['max_speed']:.4f}" for r in rows))
            print(f"  launches over the run: {launches}")
            check([r["step"] for r in rows] == list(range(H_RECORD, H_STEPS + 1, H_RECORD)),
                  "H1: step rows")
            check(all(r["n_active"] == 995_328 and r["overflow"] == 0 for r in rows),
                  "H1: n_active or overflow")
            check(rows[-1]["kinetic_energy"] > 0, "H1: the dam did not move")
            check(launches["density"] == launches["forces"] == H_STEPS and launches["expand"] >= 1,
                  f"H1: launches {launches} (density and forces {H_STEPS} each, expand >= 1)")
            (ckpt,) = (d / "checkpoints" / run["id"]).glob("ckpt_*.npz")
            st, params, step, _ = load_state(ckpt, device=app.device)
            n_ckpt = int(st.active.sum())
            print(f"  checkpoint {ckpt.name} ({ckpt.stat().st_size / 2**20:.1f} MiB): step {step}, "
                  f"n_active {n_ckpt}")
            check(step == H_STEPS and n_ckpt == rows[-1]["n_active"], "H1: the checkpoint")
            del st, params

            pbf, pbf_wall = c.execute("h1-pbf", "dam_break_3d",
                                      {"n_target": H_PBF_N, "solver": "pbf"}, H_PBF_STEPS,
                                      H_PBF_STEPS // 2)
            last = pbf["steps"][-1]
            gline(f"  PBF run (solver pbf, dam_break_3d({H_PBF_N:_})): {pbf['status']} in "
                  f"{pbf_wall:.2f} s, steps {[r['step'] for r in pbf['steps']]}, n_active "
                  f"{last['n_active']}, overflow {last['overflow']}, kinetic energy "
                  f"{last['kinetic_energy']:.4e}")
            check(last["overflow"] == 0 and last["kinetic_energy"] > 0
                  and [r["step"] for r in pbf["steps"]] == [H_PBF_STEPS // 2, H_PBF_STEPS],
                  "H1: the PBF run")

            t0 = time.perf_counter()
            status, png = c.raw("GET", f"/api/scenes/dam_break_2d/preview.png?steps={H_PREVIEW}")
            t_png = time.perf_counter() - t0
            check(status == 200, f"H1: preview {status}")
        cpu_app = App(config_path=d / "cpu" / "cfg.json", data_dir=str(d / "cpu"), env={},
                      device="cpu")
        want = png_pixels(cpu_app.preview_frame("dam_break_2d", H_PREVIEW)).astype(int)
        cpu_app.registry.get_provider().dispose()
        got = png_pixels(png).astype(int)
        diff = np.abs(got - want)
        share = float((diff > 0).mean())
        gline(f"  preview dam_break_2d steps={H_PREVIEW}: {t_png:.3f} s; card vs CPU App: max "
              f"{int(diff.max())} count, {share:.2e} of pixels differ (bound 1 count on "
              f"{U8_SHARE:g}); {int((want > 0).sum())} lit")
        check(got.shape == want.shape and int(diff.max()) <= 1 and share <= U8_SHARE,
              "H1: the card's preview differs from the CPU's")
    finally:
        shutil.rmtree(d, ignore_errors=True)
    return launches


def cli(args: list[str], cwd) -> subprocess.Popen:
    """``python -m sph_pie_torch <args>`` in ``cwd``, this checkout first on
    the path; stdout piped, stderr to ``cwd/stderr.txt``."""
    from pathlib import Path

    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(root)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    return subprocess.Popen(
        [sys.executable, "-m", "sph_pie_torch", *args], cwd=cwd, env=env,
        stdout=subprocess.PIPE, stderr=open(Path(cwd) / "stderr.txt", "w"), text=True,
    )


def stderr_tail(cwd) -> str:
    from pathlib import Path

    return Path(cwd, "stderr.txt").read_text()[-2000:]


def phase_h2() -> None:
    """``python -m sph_pie_torch serve`` as a process: its address line, then
    ``/api/health`` naming the card; terminated."""
    import select
    import shutil
    import tempfile
    from pathlib import Path

    print("== Phase H2: python -m sph_pie_torch serve (a process, config port 0)", flush=True)
    d = tempfile.mkdtemp(dir=Path(__file__).resolve().parent, prefix=".chip_smoke_")
    try:
        Path(d, "cfg.json").write_text(json.dumps({"port": 0}))
        t0 = time.perf_counter()
        proc = cli(["serve", "--config", "cfg.json"], d)
        try:
            ready, _, _ = select.select([proc.stdout], [], [], H_SERVE_TIMEOUT)
            line = proc.stdout.readline().strip() if ready else ""
            t_up = time.perf_counter() - t0
            check(line.startswith("sph-pie-torch service on http://"),
                  f"H2: no address line in {H_SERVE_TIMEOUT} s: {line!r}\n{stderr_tail(d)}")
            health = Client(line.split(" on ")[1]).req("GET", "/api/health")
        finally:
            proc.terminate()
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
            proc.stdout.close()
        gline(f"  '{line}' after {t_up:.2f} s; /api/health device {health['device']}; exit "
              f"{proc.returncode} on terminate")
        check(health["device"]["backend"] == "cuda"
              and torch.cuda.get_device_name(0) in health["device"]["devices"][0],
              f"H2: health does not name the card: {health['device']}")
    finally:
        shutil.rmtree(d, ignore_errors=True)


def phase_h3() -> None:
    """``python -m sph_pie_torch verify`` on the card (its default): the 4k /
    1000-step float64 contract against the native oracle."""
    import shutil
    import tempfile
    from pathlib import Path

    print("== Phase H3: python -m sph_pie_torch verify (the card, float64, 4k / 1000 steps)",
          flush=True)
    d = tempfile.mkdtemp(dir=Path(__file__).resolve().parent, prefix=".chip_smoke_")
    try:
        proc = cli(["verify"], d)
        try:
            out, _ = proc.communicate(timeout=H_VERIFY_TIMEOUT)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            raise
        lines = out.splitlines()
        for line in lines[:-1]:
            print(f"  {line}")
        check(proc.returncode == 0 and lines, f"H3: verify exited {proc.returncode}\n{out}\n"
              f"{stderr_tail(d)}")
        r = json.loads(lines[-1])
    finally:
        shutil.rmtree(d, ignore_errors=True)
    gline(f"  {r['particles']} particles, {r['steps']} steps on {r['device']}: max |dx| "
          f"{r['max_abs_dx']:.3e}, rms {r['rms']:.3e} against the {r['oracle']} oracle (bound "
          f"{r['tol']:g}), overflow {r['overflow']}, launches {r['launches']}; engine "
          f"{r['engine_s']:.2f} s, oracle {r['oracle_s']:.2f} s")
    check(r["ok"] and r["device"].startswith("cuda") and r["oracle"] == "native"
          and r["max_abs_dx"] < 1e-3 and r["overflow"] == 0
          and r["launches"]["density"] == r["launches"]["forces"] == r["steps"] == 1000,
          f"H3: the contract failed: {r}")


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
        t0 = time.perf_counter()
        f1 = phase_f1(b_ms)
        seconds["F1"] = time.perf_counter() - t0
        for name, phase in (("F2", phase_f2), ("F3", phase_f3), ("F4", lambda: phase_f4(f1))):
            t0 = time.perf_counter()
            phase()
            seconds[name] = time.perf_counter() - t0
        del f1
        for name, phase in (("G1", lambda: phase_g1(b_ms)), ("G2", phase_g2), ("G3", phase_g3),
                            ("G4", phase_g4), ("G5", phase_g5)):
            t0 = time.perf_counter()
            phase()
            seconds[name] = time.perf_counter() - t0
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        service = phase_h1(b_ms)
        seconds["H1"] = time.perf_counter() - t0
        for row in rows:
            row["launches"] += service.get(row["name"], 0)  # the path of rows 1-3
        for name, phase in (("H2", phase_h2), ("H3", phase_h3)):
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
