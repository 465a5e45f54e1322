"""Runs of cells: the work unit of the staged pair kernels.

``csrc/density.cu`` (its masked arm) and ``csrc/forces.cu`` give one CTA
to a run of R consecutive cells of the padded grid, in flat (row-major)
order, so along the contiguous last axis. For each slab the run's window
is (R+2)*cap contiguous slots, which the bulk copy engine moves into shared
memory as one span per field (pos and mass). The spans must start and end
on 16-byte boundaries, so the cap is a multiple of 4 (the scene builders
round it to 8) and pos and mass start on a 16-byte boundary. R is
``RUN_CELLS``, fewer where a run's home slots would pass ``HOME_SLOTS``,
which is also the largest cap: every layout up to it fits in the shared
memory of one CTA. Both constants are those of ``csrc/common.cuh``.
"""

from __future__ import annotations

import torch

RUN_CELLS = 5     # kRunCells
HOME_SLOTS = 384  # kHomeSlots


def run_cells(cap: int) -> int:
    """Cells per run at this cap, as the kernels choose it."""
    return min(RUN_CELLS, HOME_SLOTS // cap)


def check_staging(kernel: str, cap: int, **tensors: torch.Tensor) -> None:
    """Raise on a layout the bulk copies cannot take: a cap that is not a
    multiple of 4 in [4, ``HOME_SLOTS``], or a tensor whose data does not
    start on a 16-byte boundary."""
    if cap % 4 or not 0 < cap <= HOME_SLOTS:
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
