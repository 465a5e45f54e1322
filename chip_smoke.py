"""Drive the PyTorch/CUDA port (``sph_pie_torch``) on one NVIDIA card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phase A builds the CUDA kernels from ``sph_pie_torch/csrc`` and holds each
against its plain PyTorch version on the card, on a 3D dam break (100k
particles, cap 40, cohesion and XSPH on) and a 2D dam break (4096, cap 32)
advanced 10 steps; the 2D run is also checked end to end against the same
10 steps on the CPU (plain versions only), and a 2D scene binned into
cap-8 cells checks the placement of overfull cells against the CPU.

Phase A also holds the four kernels of the reference's drop-in and
hardware-harness paths against their plain versions: both window
densities and the tensor-core forces (both arms) on a cap-32 3D dam break
(100k, skin 0.25, no cohesion) and the 2D one, the center-slab density
(dense, compact at K = 32 and K = 4) on the cap-40 3D dam break.

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
    ea, ex = scaled(ak, ap), scaled(xk, xp)
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
    on valid slots; raises past a bound. Returns {name: max abs error vs
    plain}."""
    from sph_pie_torch.micro.forces_mma import forces_mma_plain
    from sph_pie_torch.neighbors.density import density
    from sph_pie_torch.neighbors.density_window import (
        density_cap32_plain,
        density_window_plain,
    )
    from sph_pie_torch.neighbors.forces import forces

    errs = {}
    v = b.valid
    for name, plain in (("density_cap32", density_cap32_plain), ("density_window", density_window_plain)):
        rk, rp = outs[name], plain(params, grid, b)
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
        (ak, xk), (ap, xp) = outs[name], forces_mma_plain(params, grid, b, bf16=bf16)
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
    return errs


def check_slab(grid, inputs, dense, compact: dict) -> dict:
    """Center-slab kernel outputs (dense, {K: compact}) against their plain
    versions; raises past a bound. Returns {name: max abs error}."""
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

    dp = center_slab_dense_plain(grid, inputs)
    errs = {"center_slab_dense": err("dense", dense, dp), "center_slab_compact": 0.0}
    cuts = {}
    for K, ck in compact.items():
        cp = center_slab_compact_plain(grid, inputs, K)
        e = err(f"compact K={K}", ck, cp)
        cuts[K] = int((cp < dp * (1 - 1e-6)).sum())
        print(f"    K={K} truncates {cuts[K]} of {cp.numel()} home slots")
        errs["center_slab_compact"] = max(errs["center_slab_compact"], e)
    k = min(cuts)
    check(cuts[k] > 0, f"compact K={k} truncates nothing: the first-K rule went unchecked")
    return errs


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

    s = dam_break_3d(100_000, device="cuda")
    b = wcsph_binned.simulate(s.params, s.bgrid, s.binned_state(), 10)
    print(f" {s.name}(100000): cap {s.bgrid.cap}, center slab")
    inputs = center_slab_inputs(s.bgrid, b)
    compact = {K: center_slab_compact(s.bgrid, inputs, K) for K in (32, 4)}
    check_slab(s.bgrid, inputs, center_slab_dense(s.bgrid, inputs), compact)


def plain_ms(fn) -> float:
    """Device time of a plain version: one rep where it takes over 1 s."""
    ms = cuda_ms(fn, 1, warm=0)
    return ms if ms > 1000 else cuda_ms(fn, 3, warm=0)


def phase_c(main_path) -> list[dict]:
    from sph_pie_torch.micro import center_slab as cs
    from sph_pie_torch.micro.forces_mma import forces_mma, forces_mma_plain
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

    errs = check_micro(p, g, b, outs)
    errs.update(check_slab(g2, inputs, dense, compact))
    print(f" peak device memory so far {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")

    timings = {
        "density_cap32": (lambda: dw.density_cap32(p, g, b), lambda: dw.density_cap32_plain(p, g, b)),
        "density_window": (lambda: dw.density_window(p, g, b), lambda: dw.density_window_plain(p, g, b)),
        "center_slab_dense": (lambda: cs.center_slab_dense(g2, inputs),
                              lambda: cs.center_slab_dense_plain(g2, inputs)),
        "center_slab_compact": (lambda: cs.center_slab_compact(g2, inputs, SLAB_K),
                                lambda: cs.center_slab_compact_plain(g2, inputs, SLAB_K)),
        "forces_mma": (lambda: forces_mma(p, g, b), lambda: forces_mma_plain(p, g, b)),
        "forces_mma_bf16": (lambda: forces_mma(p, g, b, bf16=True),
                            lambda: forces_mma_plain(p, g, b, bf16=True)),
    }
    rows = []
    for name, (kernel, plain) in timings.items():
        k_ms, p_ms = cuda_ms(kernel, 10), plain_ms(plain)
        print(f"  {name:19s} kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms")
        src, replaces = KERNELS[name]
        rows.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[name], "max_abs_err": errs[name], "ms": k_ms,
            "plain_ms": p_ms,
        })
    # the new kernels beside the main path's density.cu and forces.cu, same states
    print(f"  on C1: density.cu {cuda_ms(lambda: density(p, g, b), 10):.3f} ms, "
          f"forces.cu {cuda_ms(lambda: forces(p, g, b), 10):.3f} ms; on C2: "
          f"density.cu {cuda_ms(lambda: density(p2, g2, b2), 10):.3f} ms, "
          f"density_window {cuda_ms(lambda: dw.density_window(p2, g2, b2), 10):.3f} ms")
    return rows


def phase_b() -> tuple[list[dict], tuple]:
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
    with torch.no_grad():
        phase_a()
        phase_a_micro()
        rows, main_path = phase_b()
        rows += phase_c(main_path)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
