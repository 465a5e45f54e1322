"""The plain reference that decides ``correct``.

Plain PyTorch over compact particle arrays ([N, dim], particle order), with
an exact neighbour search (``neighbors.pairs``: every ordered pair, self
included, with r^2 < h^2) in place of the program's binned slots. The
equations are those of the deployment's solver, written down again from
their definitions (Mueller et al. 2003 kernels, the Tait EOS, Akinci-style
cohesion, XSPH, Macklin & Mueller 2013 PBF). It imports neither the program
(``sph_pie_torch``) nor the JAX package, and takes nothing the program made:
its parameters come from the configuration file, its inputs from the
harness (``scenes``), the same tensors the program is handed.

Every function computes in the dtype of the positions it is given: float64
for the reference, bfloat16 for the control.
"""
