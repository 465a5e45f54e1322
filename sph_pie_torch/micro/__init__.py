"""Counterparts of the kernels in the JAX package's ``scripts/micro_*.py``
measurement harnesses (the harness scripts themselves are not ported)."""
