"""Center-slab poly6 density per home slot, dense or compacted to K pairs.

Counterpart of the JAX package's ``scripts/micro_compact.py:106``
``_make_arm`` and its two bodies (3D only, h = ``cell_size - skin``):

  * ``_dense_kernel`` → ``center_slab_dense``: for each home slot, the sum
    of ``m_j (c6 q) q q``, q = max(h^2 - r^2, 0), over all 3*cap slots of
    the cell's center-slab window (cells c-1, c, c+1; shift 0 only);
  * ``_compact_kernel`` → ``center_slab_compact``: the same sum over only
    the first K candidates with r^2 < h^2 and m_j > 0, in window order.
    Where more than K candidates are in support the two differ: K is part
    of the result, not only of the speed.

No valid mask and no floor, as the arms have none. The inputs are those of
``micro_compact.py:140-159`` (``center_slab_inputs``) without the TPU's
128-lane padding, so outputs are [C, cap].

Each wrapper launches the CUDA kernel (``csrc/center_slab.cu``) for CUDA
tensors and runs its ``*_plain`` twin (chunked over cells) for CPU
tensors; any other device raises. Float32 only. The kernel's launcher
takes a layout that ``group_arm`` admits (a cap that is a multiple of 4 up
to 384, every tensor it is given starting on a 16-byte boundary) through its
arm over groups of cells, which reads only the masses of a group of windows
without mass and walks only candidates with mass, and any other layout
through its one-thread-per-slot arm; both give the same bits.
"""

from __future__ import annotations

import torch

from sph_pie_torch import _native
from sph_pie_torch.kernels import smoothing
from sph_pie_torch.neighbors import binned as nb
from sph_pie_torch.neighbors import runs

# Cells per chunk of the plain version: bounds its [chunk, cap, 3cap] temporaries.
_PAIR_BUDGET = 8 * 1024 * 1024


def center_slab_inputs(grid: nb.BinnedGrid, b: nb.BinnedState) -> tuple[torch.Tensor, ...]:
    """(hx, hy, hz, hm, wx, wy, wz, wm): home pos and mass [C, cap] and the
    center-slab window's pos and mass [C, 3*cap], as
    ``slab_windows(grid, x)[grid.slab_shifts().index(0)]`` gives it (slots
    outside [0, S) read as zeros)."""
    if grid.dim != 3:
        raise ValueError(f"center slab: 3D only, got dim {grid.dim}")
    C, cap = grid.num_cells, grid.cap

    def window(x):
        z = x.new_zeros((cap,) + x.shape[1:])
        return nb._window_view(torch.cat([z, x, z]), C, cap)

    wpos, wmass = window(b.pos), window(b.mass)
    home = [b.pos[:, k].reshape(C, cap).contiguous() for k in range(3)]
    win = [wpos[..., k].contiguous() for k in range(3)]
    return (*home, b.mass.reshape(C, cap).contiguous(), *win, wmass.contiguous())


def _consts(grid: nb.BinnedGrid) -> tuple[float, float]:
    """(h^2, poly6 coeff) in double, h from the grid as ``micro_compact``."""
    h = float(grid.cell_size - grid.skin)
    return h * h, smoothing.poly6_coeff(3, h)


def _check(name: str, grid: nb.BinnedGrid, inputs, K: int | None) -> None:
    C, cap = grid.num_cells, grid.cap
    want = [(C, cap)] * 4 + [(C, 3 * cap)] * 4
    if len(inputs) != 8 or [tuple(t.shape) for t in inputs] != want:
        raise ValueError(f"{name}: inputs must be center_slab_inputs(grid, b)")
    if any(t.dtype != torch.float32 for t in inputs):
        raise TypeError(f"{name}: takes float32 inputs")
    if K is not None and K < 1:
        raise ValueError(f"{name}: K must be >= 1, got {K}")


def _plain(grid: nb.BinnedGrid, inputs, K: int | None) -> torch.Tensor:
    h2, c6 = (torch.tensor(v, dtype=torch.float32, device=inputs[0].device) for v in _consts(grid))
    hx, hy, hz, _, wx, wy, wz, wm = inputs
    C, cap = hx.shape
    out = torch.empty_like(hx)
    chunk = max(1, _PAIR_BUDGET // (3 * cap * cap))
    for c0 in range(0, C, chunk):
        sl = slice(c0, c0 + chunk)
        dx = wx[sl][:, None, :] - hx[sl][:, :, None]
        dy = wy[sl][:, None, :] - hy[sl][:, :, None]
        dz = wz[sl][:, None, :] - hz[sl][:, :, None]
        r2 = dx * dx + dy * dy + dz * dz                    # [chunk, cap, 3cap]
        q = torch.clamp(h2 - r2, min=0.0)
        m = wm[sl][:, None, :]
        term = c6 * q * q * q * m
        if K is not None:  # the first K in-support candidates, window order
            take = (r2 < h2) & (m > 0.0)
            take &= torch.cumsum(take, dim=2, dtype=torch.int32) <= K
            term = torch.where(take, term, 0.0)
        out[sl] = term.sum(2)
    return out


def center_slab_dense_plain(grid: nb.BinnedGrid, inputs) -> torch.Tensor:
    """[C, cap] center-slab density over all window candidates."""
    _check("center_slab_dense", grid, inputs, None)
    return _plain(grid, inputs, None)


def center_slab_compact_plain(grid: nb.BinnedGrid, inputs, K: int = 32) -> torch.Tensor:
    """[C, cap] center-slab density over the first K candidates in support."""
    _check("center_slab_compact", grid, inputs, K)
    return _plain(grid, inputs, K)


def group_arm(grid: nb.BinnedGrid, inputs, out: torch.Tensor | None = None) -> bool:
    """The launcher's rule (``go`` in ``csrc/center_slab.cu``): True where
    it takes its arm over groups of cells, False where it takes its
    one-thread-per-slot arm. It looks at the cap and at the seven tensors it
    is given, home mass not among them, and at the output, which the
    wrappers allocate (and the allocator aligns)."""
    hx, hy, hz, _, wx, wy, wz, wm = inputs
    given = (hx, hy, hz, wx, wy, wz, wm) + (() if out is None else (out,))
    return runs.stageable(grid.cap, *given)


def _launch(name: str, grid: nb.BinnedGrid, inputs, K: int) -> torch.Tensor:
    dev = inputs[0].device
    _native.check_cuda(
        name, torch.float32, dev, **{f"input{n}": (t, None) for n, t in enumerate(inputs)}
    )
    out = torch.empty_like(inputs[0])
    h2, c6 = _consts(grid)
    hx, hy, hz, _, wx, wy, wz, wm = inputs
    _native.launch(
        "center_slab", torch.float32, hx, hy, hz, wx, wy, wz, wm, out,
        grid.num_slots, grid.cap, h2, c6, K,
    )
    return out


def center_slab_dense(grid: nb.BinnedGrid, inputs) -> torch.Tensor:
    """``center_slab_dense_plain`` on the CPU; the dense kernel on the card."""
    if not _native.on_card("center_slab_dense", inputs[0]):
        return center_slab_dense_plain(grid, inputs)
    _check("center_slab_dense", grid, inputs, None)
    out = _launch("center_slab_dense", grid, inputs, 0)
    center_slab_dense.launches += 1
    return out


def center_slab_compact(grid: nb.BinnedGrid, inputs, K: int = 32) -> torch.Tensor:
    """``center_slab_compact_plain`` on the CPU; the compact kernel on the card."""
    if not _native.on_card("center_slab_compact", inputs[0]):
        return center_slab_compact_plain(grid, inputs, K)
    _check("center_slab_compact", grid, inputs, K)
    out = _launch("center_slab_compact", grid, inputs, int(K))
    center_slab_compact.launches += 1
    return out


center_slab_dense.launches = 0
center_slab_compact.launches = 0
