"""The frozen least-time arithmetic gives ``PERF.md``'s bounds on the
sizes recorded there (D1's and Phase B's final states)."""

from __future__ import annotations

import pytest
import torch

from h100bench import roofline

S, N = 10_712_480, 995_328            # slots and particles at 1M
D1_PAIRS = 32_878_346                 # pairs in support, D1's final state


@pytest.mark.parametrize("op, ms", [("lambda", 0.0419), ("dx", 0.0559),
                                    ("density_xsph", 0.0723), ("vorticity", 0.0595),
                                    ("vorticity_eta", 0.0559)])
def test_pbf_bounds_on_d1(op, ms):
    least, by = roofline.pbf_bounds(S, N, 3, 4, D1_PAIRS)[op]
    assert by == "bytes" and round(least, 4) == ms


def test_density_and_forces_on_phase_b():
    """97.6 MB -> 0.0291 ms and 331.8 MB -> 0.0990 ms, both by bytes; the
    flops 0.418 and 1.673 GFLOP of ~29.9M pairs."""
    pairs = 1.673e9 / 56
    least, by = roofline.density_bound(S, N, 3, 4, pairs)
    assert by == "bytes" and round(least, 4) == 0.0291
    least, by = roofline.forces_bound(S, N, 3, 4, pairs, True, True)
    assert by == "bytes" and round(least, 4) == 0.0990
    assert round(pairs * roofline.DENSITY_PAIR_FLOPS / 1e9, 3) == 0.418


def test_bound_takes_the_larger():
    assert roofline.bound(3.35e9, 0) == (1.0, "bytes")
    assert roofline.bound(0, 67e9) == (1.0, "operations")


def test_pairs_in_support_counts_ordered_pairs_and_self():
    pos = torch.tensor([[0.0, 0.0], [0.5, 0.0], [2.0, 0.0]])
    assert roofline.pairs_in_support(pos, 1.0) == 3 + 2
