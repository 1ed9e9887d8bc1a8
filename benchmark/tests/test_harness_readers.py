"""The readers' reductions: the union of device intervals, the idle share,
the breakdown, and the traversal's needed work on a hand-counted scene."""

from __future__ import annotations

import math

import pytest
import torch

from benchmark import readers, roofline, run


def test_union_counts_overlaps_once():
    assert readers.union_ns([(0, 10), (5, 15), (20, 30), (22, 25), (30, 31)]) == 26
    assert readers.union_ns([]) == 0


def test_idle_share_is_the_complement_of_the_union():
    rec = run.Record(prepare_s=0.0, pulses=1, stretch_ns=(0, 100),
                     device_events=[("a", 10, 40), ("b", 30, 50), ("c", 90, 120), ("d", -5, 5)])
    # busy: [0, 5] + [10, 50] + [90, 100] = 55 of 100
    assert readers.device_idle_pct(rec) == pytest.approx(45.0)
    assert readers.launches_per_pulse(rec) == 4.0
    assert readers.device_idle_pct(run.Record(prepare_s=0.0)) is None


def test_the_window_reader_takes_all_its_time_over_all_its_cpis():
    read = run.reader("cpi_s.imaging")
    assert read(run.Record(prepare_s=0.0, window_s=49.5, cpis=15)) == pytest.approx(3.3)
    assert read(run.Record(prepare_s=0.0)) is None


def test_breakdown_names_gaps_by_the_overlapping_host_operator():
    rec = run.Record(prepare_s=0.0, stretch_ns=(0, 100),
                     device_events=[("k1", 0, 10), ("k2", 60, 100), ("k1", 10, 20)],
                     host_events=[("aten::nonzero", 15, 55), ("aten::add", 55, 58)])
    b = run.breakdown(rec)
    assert b["device_ops"] == [["k2", pytest.approx(40e-9)], ["k1", pytest.approx(20e-9)]]
    assert b["idle_gaps"] == [["aten::nonzero", pytest.approx(40e-9)]]


def _pack(corners):
    """A [16, T] pack with the normal rows filled (zero for padding)."""
    c = torch.as_tensor(corners, dtype=torch.float32)
    n = torch.linalg.cross(c[:, 0] - c[:, 2], c[:, 1] - c[:, 0])
    pack = torch.zeros(16, c.shape[0])
    pack[:3] = n.T
    return pack


def test_needed_work_on_a_hand_counted_scene():
    # two clusters of two columns: cluster 0 holds one triangle at z = 0 and
    # a padding column, cluster 1 two triangles at z = -10
    tri = lambda z: [[-1, -1, z], [1, -1, z], [0, 1, z]]
    pad = [[0, 0, 0]] * 3
    pack = _pack([tri(0.0), pad, tri(-10.0), tri(-10.0)])
    mn = torch.tensor([[-1.0, -1.0, 0.0], [-1.0, -1.0, -10.0]])
    mx = torch.tensor([[1.0, 1.0, 0.0], [1.0, 1.0, -10.0]])
    # rays from z = 5 straight down: 0 hits the top triangle (cluster 1 lies
    # beyond the hit), 1 misses the top one inside its box (no hit anywhere:
    # both boxes), 2 misses both boxes, 3 is dead
    origin = torch.tensor([[0.0, 0.0, 5.0], [0.9, 0.9, 5.0], [5.0, 5.0, 5.0], [0.0, 0.0, 5.0]]).T
    direction = torch.tensor([[0.0, 0.0, -1.0]] * 3 + [[0.0, 0.0, 0.0]]).T
    tmin = torch.full((4,), 0.005)
    hit_t = torch.tensor([5.0, math.inf, math.inf, math.inf])
    w = roofline.needed_work(origin, direction, tmin, pack, mn, mx, hit_t, cluster_size=2)
    assert w["boxes"] == 3  # ray 0: cluster 0; ray 1: clusters 0 and 1
    assert w["pairs"] == 1 + (1 + 2)
    assert w["ops"] == roofline.MT_OPS * 4 + roofline.SLAB_OPS * 3
    assert w["bytes"] == 4 * (7 * 4 + 16 * 4 + 6 * 2) + 16 * 4
    assert w["bound_by"] == "bytes"
    assert w["bound_s"] == pytest.approx(w["bytes"] / roofline.HBM_RATE)
