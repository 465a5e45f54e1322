"""Lambda's hit words and their route to dx (``neighbors/pbf_folds.py``) on
the CPU.

On the card the lambda kernel writes, for each home slot, one 32-bit word
per 32 candidates of each slab window, and the dx kernel walks them in place
of its own distance tests (``csrc/pbf.cu``, held bit for bit against the
test walk by ``chip_smoke.py``). Here: the word count, the checks the
launchers make on words before any launch, the plain folds' words (none)
and dx's ignoring them, ``pbf.step`` handing each projection's words from
its lambda call to its dx call through ``fold``, and an int32 per-slot
field through ``mesh_fold``'s split, exchange and gather, in process and
across 4 gloo ranks."""

import re
from pathlib import Path

import pytest
import torch
import torch.multiprocessing as mp

import _torch_gloo
from sph_pie_torch import _native
from sph_pie_torch.neighbors import pbf_folds as pf
from sph_pie_torch.parallel import comm
from sph_pie_torch.scenes import builders as tb
from sph_pie_torch.solvers import pbf as tp


@pytest.mark.parametrize("dim,cap,want", [
    (2, 8, 3), (2, 16, 6), (2, 32, 9), (3, 8, 9), (3, 32, 27), (3, 40, 36), (3, 44, 45),
    (3, 384, 324),
])
def test_words_per_slot(dim, cap, want):
    """M = 3^(dim-1) ceil(3 cap / 32): a slab's candidates are the occupied
    slots of three cells, at most 3 cap, one bit each."""
    assert pf.words_per_slot(dim, cap) == want


def test_word_rule_is_the_kernels():
    """The launcher's rule is the kernel's: ``slab_words`` in csrc/pbf.cu,
    times the 3 or 9 slabs that ``launch_walk`` checks ``n_words`` against."""
    src = (Path(_native.CSRC) / "pbf.cu").read_text()
    assert "inline int slab_words(int cap) { return (3 * cap + 31) / 32; }" in src
    assert re.search(r"n_words != \(dim == 2 \? 3 : 9\) \* slab_words\(cap\)", src)


def _scene(dim: int):
    return (tb.dam_break_2d(300, device="cpu") if dim == 2
            else tb.dam_break_3d(1500, device="cpu"))


@pytest.mark.parametrize("dim", [2, 3])
def test_plain_lambda_keeps_no_words_and_dx_ignores_them(dim):
    """On the CPU ``lambda_fold`` returns the plain fold's (lambda, rho) and
    words of 0 columns; ``dx_fold`` and ``dx_fold_plain`` give the same
    bits with any words or none."""
    s = _scene(dim)
    b, g = s.binned_state(), s.bgrid
    pp = tp.flagship_params(device="cpu")
    lam, rho, words = pf.lambda_fold(s.params, pp, g, b.pos, b.mass)
    want = pf.lambda_fold_plain(s.params, pp, g, b.pos, b.mass)
    assert torch.equal(lam, want[0]) and torch.equal(rho, want[1])
    assert words.shape == (g.num_slots, 0) and words.dtype == torch.int32
    junk = torch.randint(-2**31, 2**31 - 1, (g.num_slots, pf.words_per_slot(dim, g.cap)),
                         dtype=torch.int32, generator=torch.Generator().manual_seed(dim))
    dx = pf.dx_fold(s.params, pp, g, b.pos, b.mass, lam)
    for w in (words, junk):
        assert torch.equal(pf.dx_fold(s.params, pp, g, b.pos, b.mass, lam, w), dx)
        assert torch.equal(pf.dx_fold_plain(s.params, pp, g, b.pos, b.mass, lam, w), dx)


@pytest.mark.parametrize("bad", ["columns", "rows", "dtype", "strided"])
def test_launcher_checks_words_before_any_launch(bad):
    """The walk's launcher raises on words that are not a contiguous int32
    [S, M] tensor of the inputs' device, before it reaches a kernel."""
    s = _scene(3)
    b, g = s.binned_state(), s.bgrid
    S, m = g.num_slots, pf.words_per_slot(3, g.cap)
    words = {
        "columns": torch.zeros((S, m - 1), dtype=torch.int32),
        "rows": torch.zeros((S - g.cap, m), dtype=torch.int32),
        "dtype": torch.zeros((S, m), dtype=torch.int64),
        "strided": torch.zeros((m, S), dtype=torch.int32).t(),
    }[bad]
    prm = pf._prm(b.pos.dtype, 1.0, 1.0)
    with pytest.raises(ValueError, match="words"):
        pf._checked("dx", g, b.pos, b.mass, prm, None, a=b.mass, words=words)
    pf._checked("dx", g, b.pos, b.mass, prm, None, a=b.mass,
                words=torch.zeros((S, m), dtype=torch.int32))


@pytest.mark.parametrize("config", ["flagship", "vorticity", "gather"])
def test_step_hands_lambdas_words_to_its_dx(config):
    """Each projection of ``pbf.step`` passes the words its lambda call
    returned, the very tensor, to its dx call through ``fold``: here a
    recording fold hands out marked words in place of the CPU's empty ones,
    and the state is the plain step's."""
    s = tb.dam_break_2d(200, device="cpu")
    pp = {"flagship": lambda: tp.flagship_params(device="cpu"),
          "vorticity": lambda: tp.make_pbf_params(iters=2, vort_eps=5.0, device="cpu"),
          "gather": lambda: tp.flagship_params(epilogue="gather", device="cpu")}[config]()
    handed, got = [], []

    def recording(fn, *args, **fields):
        out = pf.whole_grid(fn, *args, **fields)
        if fn is pf.lambda_fold:
            mark = torch.full((fields["mass"].shape[0], 1), len(handed), dtype=torch.int32)
            handed.append(mark)
            return out[:2] + (mark,)
        if fn is pf.dx_fold:
            got.append(fields["words"])
        return out

    b = tp.step(s.params, s.bgrid, pp, s.binned_state(), fold=recording)
    want = tp.step(s.params, s.bgrid, pp, s.binned_state())
    assert len(handed) == pp.iters and len(got) == pp.iters
    assert all(g_ is h_ for g_, h_ in zip(got, handed))
    assert all(torch.equal(getattr(b, k), getattr(want, k)) for k in vars(want))


@pytest.mark.parametrize("dim", [2, 3])
def test_mesh_fold_carries_an_int_field(dim):
    """An int32 per-slot field (the position bits, values past 2^24) goes
    through ``mesh_fold`` on 4 in-process CPU shards: each shard's buffer,
    margins included, holds its rows' bits, and the gathered home rows are
    the whole field."""
    s = _scene(dim)
    want = s.binned_state().pos.view(torch.int32)
    assert int(want.abs().max()) > 2**24
    got = _torch_gloo.fold_bits(comm.make_mesh(4, device="cpu"), s)
    assert got.dtype == torch.int32 and torch.equal(got, want)


def test_mesh_fold_carries_an_int_field_across_gloo_ranks(tmp_path):
    """The same across 4 gloo ranks, one shard each: a process group packs
    each margin message by concatenation, one message per dtype, so the
    int32 field keeps its bits."""
    world = 4
    mp.start_processes(
        _torch_gloo.worker,
        args=(world, str(tmp_path / "store"), str(tmp_path), "bits", 0, 1024),
        nprocs=world, start_method="spawn", join=True,
    )
    scene = _torch_gloo.padded_scene(1024, world, viscosity=0.05)
    want = scene.binned_state().pos.view(torch.int32)
    for r in range(world):
        assert torch.equal(torch.load(tmp_path / f"rank{r}.pt")["bits"], want)
