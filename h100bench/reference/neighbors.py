"""Exact neighbour pairs: every ordered pair (i, j), i == j included, with
|x_i - x_j|^2 < h^2 computed in the positions' dtype.

A uniform grid of cell size h (cell ids in float64 and int64 whatever the
positions' dtype) holds every such pair within adjacent cells; the
candidates of a block of particles are the particles of its 3^dim
neighbour cells, made with ``repeat_interleave`` and filtered by the
distance test.
"""

from __future__ import annotations

import itertools

import torch

# Candidate pairs made at once: bounds the temporaries to a few hundred MB.
CANDIDATES_PER_BLOCK = 1 << 25


def pairs(pos: torch.Tensor, h: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(i, j), int64 [P] each: the pairs in support."""
    n, dim = pos.shape
    dev = pos.device
    x = pos.to(torch.float64)
    cell = torch.floor((x - x.min(0).values) / h).to(torch.int64)
    dims = cell.max(0).values + 3  # one empty cell each side: no bounds test
    cell = cell + 1
    strides = [1] * dim
    for a in range(dim - 2, -1, -1):
        strides[a] = strides[a + 1] * int(dims[a + 1])
    stride = torch.tensor(strides, dtype=torch.int64, device=dev)
    key = (cell * stride).sum(1)
    order = torch.argsort(key)
    skey = key[order]
    offsets = [sum(o * s for o, s in zip(off, strides))
               for off in itertools.product((-1, 0, 1), repeat=dim)]
    h2 = h * h

    # Candidates of each particle: the particles of its neighbour cells.
    first = [torch.searchsorted(skey, key + o) for o in offsets]
    count = [torch.searchsorted(skey, key + o, right=True) - f for o, f in zip(offsets, first)]
    most = int(sum(count).max())
    block = max(1, CANDIDATES_PER_BLOCK // max(most, 1))
    out_i, out_j = [], []
    for b0 in range(0, n, block):
        ids = torch.arange(b0, min(n, b0 + block), device=dev)
        for f, c in zip(first, count):
            beg, cnt = f[ids], c[ids]
            ii = torch.repeat_interleave(ids, cnt)
            start = torch.repeat_interleave(beg - (torch.cumsum(cnt, 0) - cnt), cnt)
            jj = order[start + torch.arange(ii.shape[0], device=dev)]
            d = pos[ii] - pos[jj]
            keep = (d * d).sum(1) < h2
            out_i.append(ii[keep])
            out_j.append(jj[keep])
    return torch.cat(out_i), torch.cat(out_j)


def fold(n: int, i: torch.Tensor, terms: torch.Tensor) -> torch.Tensor:
    """sum over j of the pair terms [P, ...] into [n, ...] rows by i."""
    out = terms.new_zeros((n,) + tuple(terms.shape[1:]))
    return out.index_add_(0, i, terms)
