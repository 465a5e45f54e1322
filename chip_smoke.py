"""Drive the PyTorch/CUDA port (``sph_pie_torch``) on one NVIDIA card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phase A builds the CUDA kernels from ``sph_pie_torch/csrc`` and holds each
against its plain PyTorch version on the card, on a 3D dam break (100k
particles, cap 40, cohesion and XSPH on) and a 2D dam break (4096, cap 32)
advanced 10 steps; the 2D run is also checked end to end against the same
10 steps on the CPU (plain versions only), and a 2D scene binned into
cap-8 cells checks the placement of overfull cells against the CPU.

Phase B drives the main path at the flagship size — ``dam_break_3d(1M)``,
``bin_state``, 5 warm steps, 3 timed reps of 20 steps — with every launch
counter reset just before and read just after, then times each kernel
against its plain version on the final state and checks them again there.

Any failed check raises, so the script exits non-zero; it also exits
non-zero, printing no result, when no CUDA device is available. On success
the line before the last is a JSON object with one entry per kernel, and
the last line is ``{"ok": true, "device": {...}}``.
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
TRAJ_ATOL = 1e-5      # f32 max |dpos| after 10 steps, card vs CPU, domain ~1 m

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


def compare_kernels(params, grid, b):
    """Each kernel against its plain version on state ``b``; raises past a
    bound. Returns ({name: max abs error}, ``b`` with density and pressure
    from the density kernel)."""
    from sph_pie_torch.kernels import eos
    from sph_pie_torch.neighbors import binned as nb
    from sph_pie_torch.neighbors.density import density, density_plain
    from sph_pie_torch.neighbors.expand import expand, expand_plain
    from sph_pie_torch.neighbors.forces import forces, forces_plain
    from sph_pie_torch.utils.struct import replace

    out = {}
    v = b.valid
    rk, rp = density(params, grid, b), density_plain(params, grid, b)
    rel = ((rk - rp).abs()[v] / rp[v]).max().item()
    out["density"] = (rk - rp).abs().max().item()
    print(f"  density  max rel err {rel:.3e} (bound {DENSITY_RTOL:g}), max abs {out['density']:.3e}")
    check(rel <= DENSITY_RTOL and torch.equal(rk[~v], rp[~v]), "density kernel disagrees")

    b = replace(b, density=rk, pressure=eos.tait_pressure(params, rk))
    (ak, xk), (ap, xp) = forces(params, grid, b), forces_plain(params, grid, b)
    ea = ((ak - ap).abs().max() / ap.abs().max()).item()
    ex = ((xk - xp).abs().max() / xp.abs().max().clamp(min=1e-30)).item()
    out["forces"] = max((ak - ap).abs().max().item(), (xk - xp).abs().max().item())
    print(f"  forces   acc scaled err {ea:.3e}, xsph scaled err {ex:.3e} (bound {FORCES_ATOL:g})")
    check(ea <= FORCES_ATOL and ex <= FORCES_ATOL, "forces kernel disagrees")

    pos, vel, mass, alive = nb._compact(grid, b)
    owner = torch.arange(pos.shape[0], dtype=torch.int32, device=pos.device)
    srt = nb.sort_rows(grid, pos, vel, mass, owner, alive)
    args = (srt.first, srt.count, srt.rows, srt.owner, grid.cap)
    (dk, ok_), (dp, op) = expand(*args), expand_plain(*args)
    same = torch.equal(dk, dp) and torch.equal(ok_, op)
    out["expand"] = (dk - dp).abs().max().item()
    print(f"  expand   equal to plain: {same} (bound: exact)")
    check(same, "expand kernel disagrees")
    return out, b


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

    # Overfull cells: a 2D dam break binned into cap-8 cells drops rows.
    on_card = dam_break_2d(400, bcap=8, device="cuda").binned_state()
    on_cpu = dam_break_2d(400, bcap=8).binned_state()
    diff = differing_fields(on_card, on_cpu)
    print(f" dam_break_2d(400, cap 8): bin_state card == CPU in all 13 fields: {not diff} "
          f"{diff or ''}(overflow {int(on_card.overflow)})")
    check(not diff and int(on_card.overflow) > 0, f"overflowing bin_state differs in {diff}")


def phase_b() -> list[dict]:
    from sph_pie_torch.neighbors import binned as nb
    from sph_pie_torch.neighbors.density import density, density_plain
    from sph_pie_torch.neighbors.expand import expand, expand_plain
    from sph_pie_torch.neighbors.forces import forces, forces_plain
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
    errs, b = compare_kernels(s.params, g, b)
    pos_c, vel_c, mass_c, alive = nb._compact(g, b)
    owner = torch.arange(pos_c.shape[0], dtype=torch.int32, device="cuda")
    srt = nb.sort_rows(g, pos_c, vel_c, mass_c, owner, alive)
    ex_args = (srt.first, srt.count, srt.rows, srt.owner, g.cap)
    timings = {
        "density": (
            cuda_ms(lambda: density(s.params, g, b), 10),
            cuda_ms(lambda: density_plain(s.params, g, b), 2),
        ),
        "forces": (
            cuda_ms(lambda: forces(s.params, g, b), 10),
            cuda_ms(lambda: forces_plain(s.params, g, b), 2),
        ),
        "expand": (cuda_ms(lambda: expand(*ex_args), 10), cuda_ms(lambda: expand_plain(*ex_args), 10)),
    }
    rows = []
    for name, (k_ms, p_ms) in timings.items():
        print(f"  {name:8s} kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms")
        src, replaces = KERNELS[name]
        rows.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[name], "max_abs_err": errs[name], "ms": k_ms,
            "plain_ms": p_ms,
        })
    return rows


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
    with torch.no_grad():
        phase_a()
        rows = phase_b()
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
