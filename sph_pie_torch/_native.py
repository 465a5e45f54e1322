"""Build and load the hand-written CUDA kernels of ``csrc/``.

The sources compile with ``nvcc`` into one shared library with a plain C
interface (no PyTorch headers, so a build takes seconds), loaded with
``ctypes``: one ``nvcc -c`` per source, all started together, then one
link. The build happens at the first kernel call, into ``_build/`` beside
this file, under a name keyed by a hash of the sources and flags: an
edited source rebuilds, an unchanged one loads the existing library.

There is no fallback: without ``nvcc``, or when the build fails, ``build``
raises with the compiler's output.

One lock guards the build and the load: the threads of one process (a
service's run worker and a preview request) build once and load one file.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
_DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# Every launcher returns cudaGetLastError() and takes the stream last;
# sph_expand_run_cells launches nothing and returns the placement's rule.
_SIGNATURES = {
    "sph_expand_run_cells": [_P, _P, _I, _I, _I],
    "sph_density_window_f32": [_P] * 5 + [_L, _I, _I, _L, _L, _P],
    "sph_center_slab_f32": [_P] * 8 + [_L, _I, _F, _F, _I, _P],
    "sph_forces_mma_f32": [_P] * 9 + [_L, _I, _L, _L, _I] + [_F] * 5 + [_P],
    **{
        f"sph_expand_{t}": [_P, _P, _P, _P, _P, _P, _L, _I, _I, _L, _P]
        for t in ("f32", "f64")
    },
    # density and forces: ... S, cap, dim, s0, s1, first home cell, home cells
    **{
        f"sph_density_{t}": [_P, _P, _P, _P, _P, _L, _I, _I, _L, _L, _L, _L, _P]
        for t in ("f32", "f64")
    },
    **{
        f"sph_forces_{t}": [
            _P, _P, _P, _P, _P, _P, _P, _P, _P, _L, _I, _I, _L, _L, _L, _L, _I, _I, _P
        ]
        for t in ("f32", "f64")
    },
}
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
# build() names its objects by process: two threads of one process building
# at once would write and unlink the same files.
_lock = threading.RLock()
_lib: ctypes.CDLL | None = None


def find_nvcc() -> str:
    """Path of ``nvcc``: on PATH, else the CUDA toolkit's default place."""
    found = shutil.which("nvcc")
    if found:
        return found
    if os.access(_DEFAULT_NVCC, os.X_OK):
        return _DEFAULT_NVCC
    raise RuntimeError(
        "nvcc not found (PATH, /usr/local/cuda/bin): the CUDA kernels are "
        "built from sph_pie_torch/csrc at first use and need the CUDA toolkit"
    )


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libsph_kernels_{digest.hexdigest()[:16]}.so"


def build(nvcc: str | None = None) -> Path:
    """Compile ``csrc/*.cu`` unless a library for these sources exists.

    Each source compiles in its own ``nvcc`` process, all at once, so the
    build takes about as long as the slowest source; the objects are then
    linked. The compiler's report (registers, spills per kernel) is kept
    beside the library as ``.log``."""
    with _lock:
        return _build(nvcc)


def _build(nvcc: str | None) -> Path:
    out = library_path()
    if out.exists():
        return out
    nvcc = nvcc or find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    stem = f"{out.stem}.{os.getpid()}"
    tmp = out.with_name(f"{stem}.tmp")
    jobs = []
    for src in (s for s in _sources() if s.suffix == ".cu"):
        obj = BUILD_DIR / f"{stem}.{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((obj, cmd, proc))
    try:
        report = [(cmd, proc.communicate()[0], proc.returncode) for _, cmd, proc in jobs]
        if all(rc == 0 for _, _, rc in report):
            link = [nvcc, "-shared", "-o", str(tmp), *(str(obj) for obj, _, _ in jobs)]
            proc = subprocess.run(link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            report.append((link, proc.stdout, proc.returncode))
        for cmd, text, rc in report:
            if rc != 0:
                raise RuntimeError(f"nvcc failed with code {rc}:\n{' '.join(cmd)}\n{text}")
    finally:
        for obj, _, proc in jobs:
            if proc.poll() is None:  # interrupted while waiting: stop the rest
                proc.kill()
                proc.wait()
            obj.unlink(missing_ok=True)
    out.with_suffix(".log").write_text("".join(text for _, text, _ in report))
    os.replace(tmp, out)  # atomic: concurrent builders never load a torn file
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def launch(kernel: str, dtype: torch.dtype, *args) -> None:
    """Call launcher ``sph_<kernel>_<f32|f64>`` on the current stream.

    Tensors in ``args`` pass as device pointers; the caller has checked
    their device, dtype, shape and contiguity."""
    name = f"sph_{kernel}_{_SUFFIX.get(dtype)}"
    if name not in _SIGNATURES:
        raise TypeError(f"{kernel}: no CUDA kernel for {dtype}")
    fn = getattr(library(), name)
    c_args = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    err = fn(*c_args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with error {err}")


def check_cuda(kernel: str, dtype: torch.dtype, device: torch.device, **tensors) -> None:
    """Raise unless every tensor is contiguous, on ``device``, and of
    ``dtype`` (float arguments) or its declared integer/bool type."""
    for name, (t, want) in tensors.items():
        want = dtype if want is None else want
        if t.device != device or t.dtype != want or not t.is_contiguous():
            raise ValueError(
                f"{kernel}: {name} must be a contiguous {want} tensor on "
                f"{device}, got {t.dtype} on {t.device} "
                f"(contiguous={t.is_contiguous()})"
            )
