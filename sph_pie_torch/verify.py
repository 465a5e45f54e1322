"""The trajectory contract: a 2D dam break of ~4k particles in float64, 1000
steps of the binned WCSPH engine on the given device, against the native
C++ oracle (the NumPy one where no C++ toolchain is found), within 1e-3.

``python -m sph_pie_torch verify`` runs it at full size on the card (the
float64 arms of ``density.cu`` and ``forces.cu``); ``--device cpu`` runs
the plain versions. ``run`` takes the size and the steps, so tests run it
small. It prints which oracle ran, the error, the launches of the
engine's kernels, both times and a digest of each side's final positions
(so two runs show which side moved), and returns them.
"""

from __future__ import annotations

import hashlib
import time

import numpy as np
import torch

from sph_pie_torch import native
from sph_pie_torch.neighbors import binned as nb
from sph_pie_torch.neighbors.density import density
from sph_pie_torch.neighbors.expand import expand
from sph_pie_torch.neighbors.forces import forces
from sph_pie_torch.oracle import oracle_from_scene
from sph_pie_torch.scenes import builders
from sph_pie_torch.service.executor import service_device
from sph_pie_torch.solvers import wcsph_binned

N_TARGET = 4096
STEPS = 1000
TOL = 1e-3
KERNELS = (density, forces, expand)


def digest(pos: np.ndarray) -> str:
    """16 hex digits of the SHA-256 of float64 positions: equal bits, equal
    digest."""
    return hashlib.sha256(np.ascontiguousarray(pos, np.float64).tobytes()).hexdigest()[:16]


def run(n_target: int = N_TARGET, steps: int = STEPS,
        device: torch.device | str = "cuda") -> dict:
    """Roll the engine and the oracle from one scene; ``ok`` when the largest
    position difference is under ``TOL`` and nothing overflowed."""
    device = service_device(device)
    scene = builders.dam_break_2d(n_target=n_target, dtype=torch.float64, device=device)
    n = int(scene.state.n_active())
    print(f"engine: {n} particles, {steps} steps (f64) on {device}...", flush=True)
    before = [k.launches for k in KERNELS]
    t0 = time.perf_counter()
    b = wcsph_binned.simulate(scene.params, scene.bgrid, scene.binned_state(), steps)
    overflow = int(b.overflow)  # host sync fence
    engine_s = time.perf_counter() - t0
    launches = {k.__name__: k.launches - n0 for k, n0 in zip(KERNELS, before)}
    print(f"engine done in {engine_s:.2f}s overflow={overflow} launches={launches}", flush=True)
    st = nb.unbin(scene.bgrid, b, scene.state.capacity)
    got = st.pos[st.active].cpu().numpy()

    py = oracle_from_scene(scene, dtype=np.float64)
    t0 = time.perf_counter()
    if native.available():
        oracle = "native"
        print("oracle: native C++ ...", flush=True)
        want, _ = native.oracle_run(scene.params, py.pos, py.vel, py.mass, steps)
    else:
        oracle = "numpy"
        print(f"oracle: NumPy fallback (slow; {native.build_error()}) ...", flush=True)
        want = py.run(steps)
    oracle_s = time.perf_counter() - t0
    print(f"oracle done in {oracle_s:.2f}s", flush=True)

    err = float(np.abs(got - want).max())
    rms = float(np.sqrt(((got - want) ** 2).mean()))
    ok = err < TOL and overflow == 0
    digests = {"engine_digest": digest(got), "oracle_digest": digest(want)}
    print(f"final positions: engine digest {digests['engine_digest']}, oracle digest "
          f"{digests['oracle_digest']}", flush=True)
    print(f"max |dx| = {err:.3e}  rms = {rms:.3e}  tol = {TOL}  -> "
          f"{'PASS' if ok else 'FAIL'}", flush=True)
    return {
        "ok": ok, "device": str(device), "particles": n, "steps": steps, "tol": TOL,
        "max_abs_dx": err, "rms": rms, "overflow": overflow, "launches": launches,
        "oracle": oracle, "engine_s": engine_s, "oracle_s": oracle_s, **digests,
    }
