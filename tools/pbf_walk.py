"""Measure PBF's lambda and dx kernels (``csrc/pbf.cu``) on one CUDA card.

Run from the repository root:

    python3 tools/pbf_walk.py check
        builds the kernels, prints the compiler's report of the PBF kernels
        and runs ``chip_smoke.py``'s Phase A PBF checks (a short first call)
    python3 tools/pbf_walk.py turns --parent DIR
        DIR holds another tree's ``sph_pie_torch`` (say, the parent commit's,
        unpacked by ``git archive``). Runs D1 -- ``dam_break_3d(1M)`` under
        ``flagship_params()`` with a 256 x 256 frame a step, 5 warm steps
        then 3 reps of 20, as ``chip_smoke.py`` runs it -- in four processes
        in turns: DIR, this tree, this tree, DIR. Each prints its ms/step,
        host syncs, peak memory and, on the final state, the fold ms of
        lambda and dx (this tree: dx through lambda's words and dx's own
        test walk). Then holds this tree's lambda and dx outputs bit for bit
        against DIR's on the final state. With ``--split``, the first DIR
        process also times ablation variants of DIR's ``pbf.cu`` (its
        first design: the split of a launch into staging and packing, the
        r^2 tests, the pair math and the stores), and the first process of
        this tree variants of its own (the walk: the same split, and its
        launch shapes).

Every line ends with the card's name and power limit. Variants are built
by ``nvcc`` from patched copies of ``pbf.cu`` in a temporary directory;
nothing of the tree is changed.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# Ablations of the first design (pbf_runs) on lambda (op 0) and dx (op 1).
# The runtime guard n_pow == -7 is never true, so the guarded code is
# compiled but never runs.
RUNS_WALK = "for (int jb = sm.start[lc]; jb < j1; jb += 32) {"
RUNS_PAIRS = """        for (; hit; hit &= hit - 1) {
          const int j = jb + __ffs(hit) - 1;
          const Rec<T> p = sm.prec[j];
          op.pair(part, xi, ei, p, sm.gidx[j], r2_of<T, DIM>(xi, p), a);
        }"""
RUNS_TEST = "if (r2_of<T, DIM>(xi, sm.prec[j]) < h2) hit |= 1u << (j - jb);"
STORE_PATCHES = [
    ("op.finish(a, sm.acc + r * NA, sm.he[r], out0 + i);",
     "{ if (a.n_pow == -7) op.finish(a, sm.acc + r * NA, sm.he[r], out0 + i); }"),
    ("op.zero(a, out0 + i);", "{ if (a.n_pow == -7) op.zero(a, out0 + i); }"),
]
RUNS_VARIANTS = {
    "full": [],
    "stage+pack+stores": [(RUNS_WALK, RUNS_WALK.replace("jb < j1", "jb < j1 && a.n_pow == -7"))],
    "+tests": [(RUNS_PAIRS, "        part[0] += T(__popc(hit));")],
    "pairs on every candidate": [(RUNS_TEST, "hit |= 1u << (j - jb);")],
    "no stores": STORE_PATCHES,
}
# The walk (pbf_walk): lambda tests and writes words, dx reads them.
WALK_GROUPS = "for (int w0 = 0; w0 < nw; w0 += kGroupWords) {"
LAMBDA_PAIR = "op.pair_with(part, xi, ei, p, T(0), r2_of<T, DIM>(xi, p));"
DX_PAIR = "op.pair_with(part, xi, ei, p, sm.pex[j], r2_of<T, DIM>(xi, p));"
WALK_STORE = "store_words(wo + "
WALK_FINISH = ("op.finish(a, sm.acc + (off + __popc(m & (bit - 1u))) * NA, Rec<T>{}, "
               "out0 + i);")
# lambda's pair math after a whole group's tests, over the group's bits in
# one loop, as dx runs it (a warp paced by its busiest lane once a group,
# not once a word)
LAMBDA_PER_WORD = """            hw[q] = hit;
            for (; hit; hit &= hit - 1) {
              const int j = jb + __ffs(hit) - 1;
              const Rec<T> p = sm.prec[j];
              op.pair_with(part, xi, ei, p, T(0), r2_of<T, DIM>(xi, p));
            }
          }
          store_words(wo + (out0 + i) * M + s * nw + w0, nw - w0, vec, hw);"""
LAMBDA_PER_GROUP = """            hw[q] = hit;
          }
          store_words(wo + (out0 + i) * M + s * nw + w0, nw - w0, vec, hw);
          unsigned long long m0 = hw[0] | static_cast<unsigned long long>(hw[1]) << 32;
          unsigned long long m1 = hw[2] | static_cast<unsigned long long>(hw[3]) << 32;
          int jm = jg;
          while (m0 | m1) {
            if (m0 == 0) {
              m0 = m1;
              m1 = 0;
              jm += 64;
            }
            const int j = jm + __ffsll(static_cast<long long>(m0)) - 1;
            m0 &= m0 - 1;
            const Rec<T> p = sm.prec[j];
            op.pair_with(part, xi, ei, p, T(0), r2_of<T, DIM>(xi, p));
          }"""


def stages(k: int) -> tuple[str, str]:
    return "constexpr int kWalkStages = 1;", f"constexpr int kWalkStages = {k};"


WALK_VARIANTS = {
    "full": [],
    "stage+pack+stores": [(WALK_GROUPS, WALK_GROUPS.replace("w0 < nw", "w0 < nw && a.n_pow == -7"))],
    "no pair math": [(LAMBDA_PAIR, "part[0] += p.v[3];"), (DX_PAIR, "part[0] += p.v[3];")],
    "no stores": [(WALK_FINISH, "{ if (a.n_pow == -7) " + WALK_FINISH + " }"), STORE_PATCHES[1],
                  (WALK_STORE, "if (a.n_pow == -7) " + WALK_STORE)],
    "lambda's pairs after each group": [(LAMBDA_PER_WORD, LAMBDA_PER_GROUP)],
    "2 stages": [stages(2)],
    "runs of 8 cells": [("  const int run = sph::run_cells(cap);\n  sph::Carve carve(nullptr);  "
                         "// counts the bytes of the layout\n  const WalkSmem",
                         "  const int run = sph::kHomeSlots / cap < 8 ? sph::kHomeSlots / cap : 8;\n"
                         "  sph::Carve carve(nullptr);\n  const WalkSmem")],
    "64 threads": [("__launch_bounds__(sph::kRunThreads)\npbf_walk(",
                    "__launch_bounds__(64)\npbf_walk("),
                   ("kernel<<<static_cast<unsigned>(runs), sph::kRunThreads, carve.off, st>>>(\n"
                    "      a, wi, wo,",
                    "kernel<<<static_cast<unsigned>(runs), 64, carve.off, st>>>(\n      a, wi, wo,")],
}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def say(text: str, card: str) -> None:
    print(f"{text} [{card}]", flush=True)


def build_variants(src_dir: Path, variants: dict, work: Path) -> dict:
    """{name: path of the shared library} of ``pbf.cu`` with each
    variant's patches, all compiled at once."""
    from sph_pie_torch import _native

    nvcc = _native.find_nvcc()
    src = (src_dir / "pbf.cu").read_text()
    jobs = {}
    for k, (name, patches) in enumerate(variants.items()):
        text = src
        for old, new in patches:
            if old not in text:
                raise RuntimeError(f"variant {name!r}: no {old!r} in {src_dir / 'pbf.cu'}")
            text = text.replace(old, new)
        cu, so = work / f"v{k}.cu", work / f"v{k}.so"
        cu.write_text(text)
        cmd = [nvcc, *(f for f in _native.NVCC_FLAGS if f not in ("-Xptxas", "-v")),
               "-I", str(src_dir), "-shared", "-o", str(so), str(cu)]
        jobs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (so, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"variant {name!r} failed to build:\n{log}")
        out[name] = so
    return out


def time_variants(libs: dict, calls: dict, card: str) -> None:
    """Each call of ``calls`` ({label: fn}) under each variant library,
    by CUDA events; the kernel library is swapped in for the calls."""
    import chip_smoke as cs
    from sph_pie_torch import _native

    own = _native.library()
    for name, so in libs.items():
        lib = ctypes.CDLL(str(so))
        for sym, argtypes in _native._SIGNATURES.items():
            if sym.startswith("sph_pbf") and hasattr(lib, sym):
                getattr(lib, sym).argtypes = argtypes
                getattr(lib, sym).restype = ctypes.c_int
        _native._lib = lib
        try:
            ms = {label: cs.cuda_ms(fn, 10) for label, fn in calls.items()}
        finally:
            _native._lib = own
        say(f"  variant {name:28s} " + ", ".join(f"{k} {v:.3f} ms" for k, v in ms.items()), card)


def d1(root: Path, tag: str, save: Path, variants: str | None) -> None:
    """D1 on the tree at ``root``; its final state's lambda and dx outputs
    to ``save``."""
    sys.path.insert(0, str(root))
    sys.path.insert(1, str(ROOT))
    import torch

    import chip_smoke as cs
    from sph_pie_torch import _native
    from sph_pie_torch.neighbors import pbf_folds as pf
    from sph_pie_torch.scenes import dam_break_3d
    from sph_pie_torch.solvers import pbf

    assert Path(pf.__file__).resolve().is_relative_to(root.resolve()), pf.__file__
    card = card_line()
    t0 = time.perf_counter()
    _native.library()
    say(f"{tag}: {root}: kernel build + load {time.perf_counter() - t0:.1f} s", card)
    torch.manual_seed(0)
    with torch.no_grad():
        s = dam_break_3d(1_000_000, device="cuda")
        p, g, pp = s.params, s.bgrid, pbf.flagship_params()
        n = int(s.state.n_active())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        b = s.binned_state()
        b, checksum = cs.pbf_roll(p, g, pp, b, cs.D_WARM,
                                  b.n_rebins.new_zeros((), dtype=torch.int64))
        walls, syncs = [], []
        for _ in range(cs.D_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with cs.counting_syncs(syncs):
                b, checksum = cs.pbf_roll(p, g, pp, b, cs.D_STEPS, checksum)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3 / cs.D_STEPS)
        peak = torch.cuda.max_memory_allocated()
        timed_steps = cs.D_STEPS * cs.D_REPS
        say(f"{tag}: D1 ms/step median {statistics.median(walls):.3f} (reps "
            f"{', '.join(f'{w:.3f}' for w in walls)}), host syncs {sum(syncs) / timed_steps:.2f}"
            f"/step, rebins {int(b.n_rebins)}, overflow {int(b.overflow)}, peak "
            f"{peak / 2**30:.3f} GiB, particles {n}", card)

        out = pf.lambda_fold(p, pp, g, b.pos, b.mass)
        lam, rho = out[:2]
        words = out[2] if len(out) > 2 else None
        dx = pf.dx_fold(p, pp, g, b.pos, b.mass, lam, *(() if words is None else (words,)))
        ms = {"lambda": cs.cuda_ms(lambda: pf.lambda_fold(p, pp, g, b.pos, b.mass), 10)}
        if words is not None:
            ms["dx (words)"] = cs.cuda_ms(lambda: pf.dx_fold(p, pp, g, b.pos, b.mass, lam, words),
                                          10)
        ms["dx (test walk)"] = cs.cuda_ms(lambda: pf.dx_fold(p, pp, g, b.pos, b.mass, lam), 10)
        pairs = cs.pairs_in_support(g, b, p.h * p.h)
        least = cs.pbf_bounds(g, b, pairs)
        say(f"{tag}: fold ms on the final state: "
            + ", ".join(f"{k} {v:.3f}" for k, v in ms.items())
            + f"; bounds lambda {least['lambda'][0]:.4f}, dx {least['dx'][0]:.4f} ms; pairs "
            f"{pairs}", card)
        occ = b.mass != 0
        torch.save({"occ": occ.cpu(), **{k: v[occ].cpu() for k, v in (
            ("pos", b.pos), ("lam", lam), ("rho", rho), ("dx", dx))}}, save)

        if variants:
            src = Path(_native.CSRC)
            table = RUNS_VARIANTS if variants == "runs" else WALK_VARIANTS
            t0 = time.perf_counter()
            with tempfile.TemporaryDirectory() as work:
                libs = build_variants(src, table, Path(work))
                say(f"{tag}: {len(libs)} variants of {src / 'pbf.cu'} built in "
                    f"{time.perf_counter() - t0:.1f} s", card)
                calls = {"lambda": lambda: pf.lambda_fold(p, pp, g, b.pos, b.mass)}
                if words is None:
                    calls["dx"] = lambda: pf.dx_fold(p, pp, g, b.pos, b.mass, lam)
                else:
                    calls["dx (words)"] = lambda: pf.dx_fold(p, pp, g, b.pos, b.mass, lam, words)
                time_variants(libs, calls, card)


def turns(parent: Path, split: bool) -> int:
    import torch

    card = card_line()
    with tempfile.TemporaryDirectory() as tmp:
        order = [("parent", parent, "runs"), ("PR", ROOT, "walk"), ("PR", ROOT, None),
                 ("parent", parent, None)]
        saved = []
        for k, (tag, root, var) in enumerate(order):
            save = Path(tmp) / f"{k}.pt"
            cmd = [sys.executable, __file__, "d1", "--root", str(root), "--tag", f"{tag} #{k}",
                   "--save", str(save)] + (["--variants", var] if split and var else [])
            rc = subprocess.run(cmd, env={**os.environ, "PYTHONPATH": ""}).returncode
            if rc:
                print(f"{tag} run failed with code {rc}", flush=True)
                return rc
            saved.append((tag, torch.load(save)))
        ref = saved[0][1]
        for tag, got in saved[1:]:
            same = {k: torch.equal(got[k], ref[k]) for k in ("occ", "pos", "lam", "rho", "dx")}
            err = {k: (got[k] - ref[k]).abs().max().item() for k in ("lam", "dx")
                   if same["occ"]}
            say(f"{tag} against parent #0 on D1's final state, occupied slots: equal bit for "
                f"bit {same}; max |diff| {err}", card)
    return 0


def check() -> int:
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs
    from sph_pie_torch import _native

    t0 = time.perf_counter()
    _native.library()
    print(f"kernel build + load {time.perf_counter() - t0:.1f} s", flush=True)
    log = _native.library_path().with_suffix(".log").read_text().splitlines()
    for k, line in enumerate(log):
        if "Compiling entry function" in line and "pbf_" in line:
            print(line.strip()[:160])
            print("  " + " | ".join(x.strip() for x in log[k + 1:k + 4]))
    with torch.no_grad():
        cs.phase_a_pbf()
    print(f"[{card_line()}]")
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="mode", required=True)
    sub.add_parser("check")
    t = sub.add_parser("turns")
    t.add_argument("--parent", type=Path, required=True)
    t.add_argument("--split", action="store_true")
    d = sub.add_parser("d1")
    d.add_argument("--root", type=Path, required=True)
    d.add_argument("--tag", required=True)
    d.add_argument("--save", type=Path, required=True)
    d.add_argument("--variants", choices=("runs", "walk"))
    args = ap.parse_args()
    if args.mode == "check":
        return check()
    if args.mode == "turns":
        return turns(args.parent.resolve(), args.split)
    d1(args.root.resolve(), args.tag, args.save, args.variants)
    return 0


if __name__ == "__main__":
    sys.exit(main())
