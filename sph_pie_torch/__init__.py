"""sph_pie_torch — the PyTorch + CUDA port of the binned WCSPH engine.

The JAX package beside it is the reference: module and function names
match it one for one (``core/params.py``,
``neighbors/binned.py``, ``solvers/wcsph_binned.py``, ...), and the tests
run both packages on the same inputs. The pair sums and the rebin
placement are hand-written CUDA kernels (``csrc/``), built for ``sm_90a``
at first use; every kernel has a plain PyTorch version in the same module,
which runs for tensors on the CPU.

This package imports neither JAX nor the JAX package.
"""

__version__ = "0.1.0"
