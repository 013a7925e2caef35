"""The frozen traversal bound against hand-counted cases."""
import pytest
import torch

from gdbench import roofline

W = 64
SLAB = 22 * W * 4 + 24     # bytes of one cluster: its slots and its box


def _case():
    cb = torch.tensor([[0.0, 0, 0, 1, 1, 1], [2.0, 0, 0, 3, 1, 1]])
    o = torch.tensor([[-1.0, 0.5, 0.5], [-1.0, 0.5, 0.5], [-1.0, 5, 5]])
    d = torch.tensor([[1.0, 0, 0]] * 3)
    mint = torch.zeros(3)
    maxt = torch.full((3,), 1e30)
    valid = torch.tensor([True, False, False])
    t = torch.tensor([1.5, 3e38, 3e38])
    prim = torch.tensor([5, -1, -1])
    return cb, (o, d, mint, maxt), valid, t, prim


def test_closest_counts_the_boxes_before_the_hit():
    cb, rays, valid, t, prim = _case()
    # ray 0 hits at t 1.5: only cluster 0 (entered at t 1) is needed;
    # ray 1 misses: both; ray 2 passes no box
    ms, by = roofline.traversal_bound(rays, valid, t, prim, None, cb, W)
    flops = 3 * W * roofline.FLOPS_LINEAR_MT
    nbytes = 3 * 48 + 2 * SLAB
    assert by == "bytes"
    assert ms == pytest.approx(nbytes / 3.35e12 * 1e3)
    assert flops / 67e12 < nbytes / 3.35e12


def test_any_hit_counts_one_cluster_for_an_occluded_ray():
    cb, rays, valid, t, prim = _case()
    occ = torch.tensor([True, False, False])
    ms, by = roofline.traversal_bound(rays, valid, t, prim, occ, cb, W)
    # ray 0 occluded: one pair (its hit's cluster 0); ray 1: both
    assert ms == pytest.approx((3 * 33 + 2 * SLAB) / 3.35e12 * 1e3)


def test_operations_bound_when_pairs_outnumber_slabs():
    cb = torch.tensor([[0.0, 0, 0, 1, 1, 1]])
    n = 10_000
    o = torch.tensor([[-1.0, 0.5, 0.5]]).repeat(n, 1)
    d = torch.tensor([[1.0, 0, 0]]).repeat(n, 1)
    z = torch.zeros(n)
    ms, by = roofline.traversal_bound(
        (o, d, z, torch.full((n,), 1e30)), torch.zeros(n, dtype=torch.bool),
        torch.full((n,), 3e38), torch.full((n,), -1), None, cb, W)
    assert by == "operations"
    assert ms == pytest.approx(n * W * 44 / 67e12 * 1e3)


def test_peaks_are_the_published_ones():
    assert roofline.peaks() == (67e12, 3.35e12)
