"""Rebin placement: cell-sorted rows -> dense padded slots.

Counterpart of the JAX package's ``neighbors/pallas_rebin.py``
``expand``. After the stable sort by cell id, ``_bin_rows`` holds K
sorted rows plus each cell's ``first`` row and row ``count``; slot
``(c, r)`` takes row ``first[c] + r`` when ``r < min(count[c], cap)``, and
is empty (zeros, owner -1) otherwise. Those are the scatter path's exact semantics: a cell
with more than ``cap`` rows keeps its first ``cap``, with no limit on how
many cells overflow.

``expand`` launches the CUDA kernel (``csrc/expand.cu``) for CUDA tensors
and runs ``expand_plain`` for CPU tensors; any other device raises. The
kernel has two arms, chosen in its launcher by shape and alignment
(``runs.expand_run_cells`` is the same rule): runs of cells whose rows and
owners leave through 16-byte stores, for a cap that is a multiple of 4 (caps
8, 32, 40: every cap the scenes are made with) in either dtype, and one
thread per slot for any other cap. The inputs may start on any element
boundary in both arms; the outputs are allocated here and start aligned.
"""

from __future__ import annotations

import torch

from sph_pie_torch import _native


def expand_plain(
    first: torch.Tensor,
    count: torch.Tensor,
    rows: torch.Tensor,
    owner: torch.Tensor,
    cap: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """[K, NCOL] sorted rows -> ([C*cap, NCOL] dense rows, [C*cap] owner).

    An empty slot, and a slot whose row ``first[c] + r`` does not exist
    (>= K), reads a row of zeros with owner -1 appended behind the K rows."""
    k = rows.shape[0]
    rank = torch.arange(cap, dtype=torch.int64, device=rows.device)
    src = first.to(torch.int64)[:, None] + rank[None, :]
    keep = (rank[None, :] < torch.clamp(count.to(torch.int64), max=cap)[:, None]) & (src < k)
    src = torch.where(keep, src, k).reshape(-1)
    dense = torch.cat([rows, rows.new_zeros((1, rows.shape[1]))])[src]
    return dense, torch.cat([owner, owner.new_full((1,), -1)])[src]


def expand(
    first: torch.Tensor,
    count: torch.Tensor,
    rows: torch.Tensor,
    owner: torch.Tensor,
    cap: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``expand_plain`` on the CPU; the ``expand`` CUDA kernel on the card.

    ``first``/``count``: [C] int32; ``rows``: [K, NCOL] float32/float64;
    ``owner``: [K] int32."""
    if not _native.on_card("expand", rows):
        return expand_plain(first, count, rows, owner, cap)
    _native.check_cuda(
        "expand", rows.dtype, rows.device,
        first=(first, torch.int32), count=(count, torch.int32),
        rows=(rows, None), owner=(owner, torch.int32),
    )
    num_cells, (k, ncol) = first.shape[0], rows.shape
    if count.shape != first.shape or owner.shape != (k,):
        raise ValueError("expand: first/count must be [C] and owner [K]")
    dense = torch.empty((num_cells * cap, ncol), dtype=rows.dtype, device=rows.device)
    owner_d = torch.empty(num_cells * cap, dtype=torch.int32, device=rows.device)
    _native.launch(
        "expand", rows.dtype, first, count, rows, owner, dense, owner_d,
        num_cells, cap, ncol, k,
    )
    expand.launches += 1
    return dense, owner_d


expand.launches = 0
