"""Build and load the hand-written CUDA kernels of ``csrc/``.

The sources compile with ``nvcc`` into one shared library with a plain C
interface (no PyTorch headers, so a build takes seconds), loaded with
``ctypes``. The build happens at the first kernel call, into ``_build/``
beside this file, under a name keyed by a hash of the sources and flags:
an edited source rebuilds, an unchanged one loads the existing library.

There is no fallback: without ``nvcc``, or when the build fails, ``build``
raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
_DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# Every launcher returns cudaGetLastError() and takes the stream last.
_SIGNATURES = {
    **{
        f"sph_expand_{t}": [_P, _P, _P, _P, _P, _P, _L, _I, _I, _L, _P]
        for t in ("f32", "f64")
    },
    **{
        f"sph_density_{t}": [_P, _P, _P, _P, _P, _L, _I, _I, _L, _L, _P]
        for t in ("f32", "f64")
    },
    **{
        f"sph_forces_{t}": [
            _P, _P, _P, _P, _P, _P, _P, _P, _P, _L, _I, _I, _L, _L, _I, _I, _P
        ]
        for t in ("f32", "f64")
    },
}
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


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

    The compiler's report (registers, spills per kernel) is kept beside the
    library as ``.log``."""
    out = library_path()
    if out.exists():
        return out
    nvcc = nvcc or find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp)]
    cmd += [str(s) for s in _sources() if s.suffix == ".cu"]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed with code {proc.returncode}:\n{' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}"
        )
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)  # atomic: concurrent builders never load a torn file
    return out


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def launch(kernel: str, dtype: torch.dtype, *args) -> None:
    """Call launcher ``sph_<kernel>_<f32|f64>`` on the current stream.

    Tensors in ``args`` pass as device pointers; the caller has checked
    their device, dtype, shape and contiguity."""
    if dtype not in _SUFFIX:
        raise TypeError(f"{kernel}: the CUDA kernel takes float32 or float64, got {dtype}")
    fn = getattr(library(), f"sph_{kernel}_{_SUFFIX[dtype]}")
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
