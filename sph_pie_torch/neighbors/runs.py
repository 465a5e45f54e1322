"""Runs of cells: the work unit of the staged pair kernels and of the
rebin placement.

``csrc/density.cu`` and ``csrc/forces.cu`` give one CTA
to a run of R consecutive cells of the padded grid, in flat (row-major)
order, so along the contiguous last axis. For each slab the run's window
is (R+2)*cap contiguous slots, which the bulk copy engine moves into shared
memory as one span per field (pos and mass). The spans must start and end
on 16-byte boundaries, so the cap is a multiple of 4 (the scene builders
round it to 8) and pos and mass start on a 16-byte boundary. R is
``RUN_CELLS``, fewer where a run's home slots would pass ``HOME_SLOTS``,
which is also the largest cap: every layout up to it fits in the shared
memory of one CTA. The masked density and the forces raise on any other
layout (``check_staging``); the unmasked window density then takes its
one-thread-per-slot arm instead (``stageable`` is its launcher's rule).

``csrc/expand.cu`` gives one CTA to a run of cells of at most
``EXPAND_SLOTS`` slots, whose rows and owners are one span of the output
each, assembled in at most ``EXPAND_BYTES`` of shared memory and written
with 16-byte stores; ``expand_run_cells`` is its launcher's rule for that
arm, which the per-slot arm backs up.

All constants are those of ``csrc/common.cuh``.
"""

from __future__ import annotations

import torch

RUN_CELLS = 5     # kRunCells
HOME_SLOTS = 384  # kHomeSlots
EXPAND_SLOTS = 640        # kExpandSlots
EXPAND_BYTES = 48 * 1024  # kExpandBytes


def run_cells(cap: int) -> int:
    """Cells per run at this cap, as the kernels choose it."""
    return min(RUN_CELLS, HOME_SLOTS // cap)


def stageable(cap: int, *tensors: torch.Tensor) -> bool:
    """True for a layout the bulk copies take: a cap that is a multiple of 4
    in [4, ``HOME_SLOTS``] and tensors that start on 16-byte boundaries."""
    return cap % 4 == 0 and 0 < cap <= HOME_SLOTS and all(
        t.data_ptr() % 16 == 0 for t in tensors
    )


def expand_run_cells(cap: int, ncol: int, itemsize: int, *outputs: torch.Tensor) -> int:
    """Cells per run of the placement's 16-byte arm for these outputs, 0
    where the kernel takes its per-slot arm: a cap that is not a multiple of
    4 (a cell's rows and its int32 owners then do not both end on 16-byte
    boundaries), an output that does not start on one, or a cell whose span
    does not fit in ``EXPAND_BYTES``. The inputs may start anywhere."""
    if cap <= 0 or cap % 4 or ncol <= 0 or any(t.data_ptr() % 16 for t in outputs):
        return 0
    per_cell = cap * (ncol * itemsize + 4) + 8
    return min((EXPAND_BYTES - 64) // per_cell, max(EXPAND_SLOTS // cap, 1))


def check_staging(kernel: str, cap: int, **tensors: torch.Tensor) -> None:
    """Raise on a layout the bulk copies cannot take: a cap that is not a
    multiple of 4 in [4, ``HOME_SLOTS``], or a tensor whose data does not
    start on a 16-byte boundary."""
    if not stageable(cap):
        raise ValueError(
            f"{kernel}: the staged kernel takes a cap that is a multiple of 4 in "
            f"[4, {HOME_SLOTS}], got {cap}"
        )
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(
                f"{kernel}: {name} must start on a 16-byte boundary for the bulk "
                f"copies, starts at {t.data_ptr():#x}"
            )
