"""Meshes of shards along the leading cell axis, and their three operations.

The port's counterpart of the JAX package's ``jax.sharding.Mesh``,
``lax.ppermute`` and ``lax.pmax`` (``parallel/halo.py`` and
``parallel/balance.py`` there). The binned slots are cell-major, so a
contiguous range of cells is a contiguous range of slots: shard ``d`` owns
the cells ``[starts[d], starts[d+1])`` of the padded grid (a 1-D spatial
decomposition along the grid's leading axis).

A ``Mesh`` is one of two kinds:

  * in-process (``group`` None): all ``n`` shards live in this process on
    one ``device``. This is the counterpart of the reference's virtual
    devices, and the only kind a machine with one card can run;
  * process group: one shard per rank of a ``torch.distributed`` group,
    NCCL on the card (rank r on ``cuda:r``) or gloo on the CPU.

The step code is written once against both, through three operations:

  * ``exchange``: the rows of the cells just before and just after each
    shard's home cells land in place in the margins of its buffers, from
    the shards that hold them (the lattice neighbours, and the shards
    beyond where a neighbour is thinner than a margin); the margins past
    the grid's ends stay zero, the zero padding of the whole grid;
  * ``pmax``: the largest of one scalar per shard (all-reduce MAX);
  * ``gather`` / ``split``: between the global slot layout and the shards.

Each shard keeps one persistent buffer per exchanged field, laid out as
``[margin | home cells | margin | spare]`` with ``margin = halo_cells``
cells, so its home rows are a view into the middle and an exchange copies
only margin rows. The hi margin follows the last home cell whatever the
buffer's size (``Layout.alloc`` cells between the margins; the balanced
split allocates more than a shard holds). A process group packs the fields
going from one shard to another into one message: an exchange between
shards thicker than their margins is two messages out and two in.
CUDA tensors never pass through the host: gloo with a CUDA device raises.
"""

from __future__ import annotations

import dataclasses
import functools

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``n`` shards: in this process on ``device`` (``group`` None), or one
    per rank of ``group``, this process holding shard ``rank``."""

    n: int
    device: torch.device
    group: object | None = None  # torch.distributed ProcessGroup
    rank: int = 0

    @property
    def held(self) -> list[int]:
        """The shards this process holds."""
        return list(range(self.n)) if self.group is None else [self.rank]

    def peer(self, d: int) -> int:
        """Global rank of the process that holds shard ``d``."""
        return dist.get_global_rank(self.group, d)


def make_mesh(
    n_devices: int | None = None,
    device: torch.device | str = "cuda",
    group=None,
) -> Mesh:
    """A mesh of ``n_devices`` shards on ``device`` (default 1), or one shard
    per rank of ``group``, where ``n_devices`` must be its size (None takes
    it). A process group on NCCL holds its shard on ``cuda:rank``; on gloo
    only on the CPU. Raises without a card for a CUDA device."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_mesh: no CUDA device (pass device='cpu' for the CPU)")
    if group is None:
        n = 1 if n_devices is None else int(n_devices)
        if n < 1:
            raise ValueError(f"a mesh needs at least one shard, got {n}")
        return Mesh(n=n, device=device)
    size, rank = dist.get_world_size(group), dist.get_rank(group)
    n = size if n_devices is None else int(n_devices)
    if n != size:
        raise ValueError(f"requested {n} devices, the process group has {size}")
    backend = dist.get_backend(group)
    if backend == "gloo" and device.type != "cpu":
        raise ValueError("gloo moves CPU tensors only; use NCCL for CUDA shards")
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError("NCCL moves CUDA tensors only")
        device = torch.device("cuda", rank)
    return Mesh(n=n, device=device, group=group, rank=rank)


@dataclasses.dataclass(frozen=True)
class Transfer:
    """Rows ``[src_row, src_row + rows)`` of shard ``src``'s buffers go to
    rows ``[dst_row, dst_row + rows)`` of shard ``dst``'s (a margin)."""

    src: int
    dst: int
    src_row: int
    dst_row: int
    rows: int


@dataclasses.dataclass(frozen=True)
class Layout:
    """Where the shards' cells lie: shard ``d`` holds the cells
    ``[starts[d], starts[d+1])``; every buffer has ``margin`` cells each
    side of ``alloc`` cells of home room."""

    starts: tuple[int, ...]
    cap: int
    margin: int
    alloc: int

    def cells(self, d: int) -> int:
        return self.starts[d + 1] - self.starts[d]

    @functools.cached_property
    def transfers(self) -> tuple[Transfer, ...]:
        """What an exchange copies: for every shard with cells, the home
        rows of each other shard that its margins cover (the cells just
        before its first and just after its last home cell). A margin
        wider than its neighbour takes rows of the shards beyond; margin
        cells past the grid's ends are left as they are (zeros)."""
        n, m, cap = len(self.starts) - 1, self.margin, self.cap
        out = []
        for d in range(n):
            w = self.cells(d)
            if not w:
                continue
            first, end = self.starts[d], self.starts[d + 1]
            # (global cells of a margin, the buffer cell of its first cell)
            for lo, hi, at in ((first - m, first, 0), (end, end + m, m + w)):
                for e in range(n):
                    a, b = max(lo, self.starts[e]), min(hi, self.starts[e + 1])
                    if e == d or a >= b:
                        continue
                    out.append(Transfer(
                        src=e, dst=d, src_row=(a - self.starts[e] + m) * cap,
                        dst_row=(a - lo + at) * cap, rows=(b - a) * cap,
                    ))
        return tuple(out)


def make_layout(starts, cap: int, margin: int, alloc: int | None = None) -> Layout:
    """Check and freeze a split of the cells from cell 0."""
    starts = tuple(int(s) for s in starts)
    widths = [b - a for a, b in zip(starts, starts[1:])]
    if starts[0] != 0 or any(w < 0 for w in widths):
        raise ValueError(f"starts {starts} are not a split from cell 0")
    alloc = max(widths) if alloc is None else int(alloc)
    if max(widths) > alloc:
        raise ValueError(f"a shard of {max(widths)} cells passes its room of {alloc}")
    return Layout(starts=starts, cap=int(cap), margin=int(margin), alloc=alloc)


@dataclasses.dataclass
class Shard:
    """One shard: ``buf`` holds the exchanged fields in margined buffers,
    ``loc`` the fields of its home slots only."""

    index: int
    layout: Layout
    buf: dict[str, torch.Tensor]
    loc: dict[str, torch.Tensor]

    @property
    def cells(self) -> int:
        return self.layout.cells(self.index)

    @property
    def home(self) -> tuple[int, int]:
        """(first home cell, home cells) in the buffer, for the kernels."""
        return self.layout.margin, self.cells

    def _rows(self, c0: int, c1: int) -> slice:
        cap = self.layout.cap
        return slice(c0 * cap, c1 * cap)

    def field(self, name: str) -> torch.Tensor:
        """The home rows of a field (a view into its buffer)."""
        if name in self.loc:
            return self.loc[name]
        m = self.layout.margin
        return self.buf[name][self._rows(m, m + self.cells)]

    def lo(self, name: str) -> torch.Tensor:
        """The lo margin: the cells just before the home cells."""
        return self.buf[name][self._rows(0, self.layout.margin)]

    def hi(self, name: str) -> torch.Tensor:
        """The hi margin: the cells just after the last home cell."""
        m = self.layout.margin
        return self.buf[name][self._rows(m + self.cells, 2 * m + self.cells)]


def make_shards(
    mesh: Mesh,
    layout: Layout,
    buf_specs: dict[str, tuple[tuple[int, ...], torch.dtype]],
    loc_specs: dict[str, tuple[tuple[int, ...], torch.dtype]],
) -> list[Shard]:
    """Zeroed shards of the held indices: ``buf_specs`` / ``loc_specs`` map
    a field name to its (trailing shape, dtype)."""
    cap, m = layout.cap, layout.margin
    out = []
    for d in mesh.held:
        rows = layout.cells(d) * cap
        buf = {
            k: torch.zeros(((2 * m + layout.alloc) * cap,) + tail, dtype=dt, device=mesh.device)
            for k, (tail, dt) in buf_specs.items()
        }
        loc = {
            k: torch.zeros((rows,) + tail, dtype=dt, device=mesh.device)
            for k, (tail, dt) in loc_specs.items()
        }
        out.append(Shard(index=d, layout=layout, buf=buf, loc=loc))
    return out


def exchange(mesh: Mesh, shards: list[Shard], names) -> None:
    """Fill the margins of fields ``names`` of every held shard with the
    rows of the shards that hold those cells (``Layout.transfers``), in
    place. A process group sends one packed message per pair of shards."""
    names = tuple(names)
    if not shards:
        return
    plan = shards[0].layout.transfers
    if mesh.group is None:
        for t in plan:
            src, dst = shards[t.src], shards[t.dst]
            for k in names:
                dst.buf[k][t.dst_row : t.dst_row + t.rows].copy_(
                    src.buf[k][t.src_row : t.src_row + t.rows])
        return
    (s,) = shards
    ops, landing = [], []
    for t in plan:
        if t.src == s.index:
            out = torch.cat([s.buf[k][t.src_row : t.src_row + t.rows].reshape(-1)
                             for k in names])
            ops.append(dist.P2POp(dist.isend, out, mesh.peer(t.dst), mesh.group))
        elif t.dst == s.index:
            views = [s.buf[k][t.dst_row : t.dst_row + t.rows] for k in names]
            flat = views[0].new_empty(sum(v.numel() for v in views))
            ops.append(dist.P2POp(dist.irecv, flat, mesh.peer(t.src), mesh.group))
            landing.append((flat, views))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    for flat, views in landing:
        at = 0
        for v in views:
            v.copy_(flat[at : at + v.numel()].view_as(v))
            at += v.numel()


def pmax(mesh: Mesh, values: list[torch.Tensor]) -> torch.Tensor:
    """The largest of the held shards' 0-d ``values``, over the mesh."""
    top = torch.stack(values).amax()
    if mesh.group is not None:
        dist.all_reduce(top, op=dist.ReduceOp.MAX, group=mesh.group)
    return top


def gather(mesh: Mesh, layout: Layout, parts: list[torch.Tensor]) -> torch.Tensor:
    """The global [S, ...] tensor from the held shards' home rows ``parts``
    (in the order of ``mesh.held``)."""
    if mesh.group is None:
        return torch.cat(parts)
    (part,) = parts
    cap, n = layout.cap, mesh.n
    most = max(layout.cells(d) for d in range(n)) * cap
    wire = part.to(torch.uint8) if part.dtype == torch.bool else part
    pad = wire.new_zeros((most,) + wire.shape[1:])
    pad[: wire.shape[0]] = wire
    got = [torch.empty_like(pad) for _ in range(n)]
    dist.all_gather(got, pad, group=mesh.group)
    out = torch.cat([g[: layout.cells(d) * cap] for d, g in enumerate(got)])
    return out.to(torch.bool) if part.dtype == torch.bool else out


def split(mesh: Mesh, layout: Layout, x: torch.Tensor) -> list[torch.Tensor]:
    """The held shards' home rows of a global [S, ...] tensor (views)."""
    cap = layout.cap
    return [x[layout.starts[d] * cap : layout.starts[d + 1] * cap] for d in mesh.held]
