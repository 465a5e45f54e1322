"""ctypes binding + lazy build of the native C++ oracle.

``oracle.cpp`` is compiled with g++ on first use (-O3 -fopenmp) into
``sph_pie_torch/_build/``, under a name keyed by a hash of the source, the
flags that built it and the host's CPU as ``-march=native`` resolves it (so
a ``_build/`` copied to another host is never reused there), written to a
temporary name and renamed, so concurrent builders never load a torn file.
Without a toolchain ``available()`` is False and ``build_error()`` says
why. ``gxx_build`` also
builds the piedb document server (``service/storage/piedb_provider.py``).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np
import torch

_DIR = Path(__file__).resolve().parent
BUILD_DIR = _DIR.parent / "_build"
_SRC = _DIR / "oracle.cpp"
_ORACLE_FLAGS = (
    ["-O3", "-march=native", "-fopenmp"],
    ["-O3", "-fopenmp"],  # -march=native unsupported on some hosts
    ["-O2"],              # no OpenMP available
)
_lock = threading.Lock()
_lib = None
_build_error: str | None = None

# Must match struct Params in oracle.cpp.
PARAMS_LAYOUT = (
    "h dt rho0 c0 mu xsph_eps st gamma B vcap bk bc "
    "gx gy gz bminx bminy bminz bmaxx bmaxy bmaxz"
).split()


@functools.cache
def host_cpu() -> str:
    """The host's CPU as g++ sees it: the target options (``-march=`` and
    every ISA extension) that ``-march=native`` turns on here; empty
    without g++."""
    try:
        out = subprocess.run(["g++", "-march=native", "-Q", "--help=target"],
                             capture_output=True, text=True, timeout=60)
    except (subprocess.SubprocessError, OSError):
        return ""
    return out.stdout if out.returncode == 0 else ""


def build_path(src: Path, stem: str, suffix: str, cmd: list[str]) -> Path:
    """``BUILD_DIR/<stem>-<hash><suffix>``: the hash keys the command, the
    source and the host's CPU."""
    digest = hashlib.sha256(" ".join(cmd).encode() + src.read_bytes())
    digest.update(host_cpu().encode())
    return BUILD_DIR / f"{stem}-{digest.hexdigest()[:16]}{suffix}"


def gxx_build(src: Path, stem: str, suffix: str, flag_sets, extra=()) -> tuple[Path | None, str | None]:
    """Compile ``src`` with the first of ``flag_sets`` that works (plus
    ``extra``) into ``BUILD_DIR/<stem>-<hash><suffix>``; an existing output
    for the same source and flags is reused. Returns (path, None), or
    (None, the last error) when every flag set fails."""
    error = None
    with _lock:
        for flags in flag_sets:
            cmd = ["g++", *flags, *extra, str(src)]
            out = build_path(src, stem, suffix, cmd)
            if out.exists():
                return out, None
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f".{out.name}.{os.getpid()}.tmp")
            try:
                subprocess.run([*cmd, "-o", str(tmp)], check=True, capture_output=True,
                               timeout=180)
                os.replace(tmp, out)  # atomic: another process may build the same file
                return out, None
            except (subprocess.SubprocessError, FileNotFoundError, OSError) as e:
                error = str(e)
                tmp.unlink(missing_ok=True)
    return None, error


def _load():
    global _lib, _build_error
    if _lib is not None:
        return _lib
    path, _build_error = gxx_build(_SRC, "liboracle", ".so", _ORACLE_FLAGS, ("-shared", "-fPIC"))
    if path is None:
        return None
    lib = ctypes.CDLL(str(path))
    lib.sph_oracle_run.argtypes = [
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
    ]
    lib.sph_oracle_run.restype = None
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def build_error() -> str | None:
    return _build_error


def _values(v) -> list[float]:
    v = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v
    return list(np.asarray(v, np.float64))


def pack_params(params) -> np.ndarray:
    """FluidParams -> the packed float64 layout of struct Params."""
    dim = int(params.dim)
    g = _values(params.gravity) + [0.0] * (3 - dim)
    bmin = _values(params.bound_min) + [0.0] * (3 - dim)
    bmax = _values(params.bound_max) + [0.0] * (3 - dim)
    vals = [
        float(params.h),
        float(params.dt),
        float(params.rest_density),
        float(params.sound_speed),
        float(params.viscosity),
        float(params.xsph_eps),
        float(params.surface_tension),
        float(params.eos_gamma),
        float(params.eos_stiffness),
        float(params.max_speed),
        float(params.boundary_stiffness),
        float(params.boundary_damping),
        *g,
        *bmin,
        *bmax,
    ]
    if len(vals) != len(PARAMS_LAYOUT):
        raise ValueError(f"pack_params: {len(vals)} values for {len(PARAMS_LAYOUT)} fields")
    return np.asarray(vals, np.float64)


def oracle_run(params, pos, vel, mass, steps: int):
    """Run the native oracle; returns (pos, vel) float64 copies."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native oracle unavailable: {_build_error}")
    pos = np.ascontiguousarray(pos, np.float64).copy()
    vel = np.ascontiguousarray(vel, np.float64).copy()
    mass = np.ascontiguousarray(mass, np.float64)
    n, dim = pos.shape
    lib.sph_oracle_run(dim, n, int(steps), pos, vel, mass, pack_params(params))
    return pos, vel
