"""Tiny cells of the benchmark for CPU tests: the real configuration files
cut to a few hundred triangles, a 5^3 fan and four pulses."""

from __future__ import annotations

import copy
import math

import pytest
import torch

from benchmark.run import Cell, load_cell

TINY = dict(n=21, num_rays=5, pulses=4)
SEED = 2**31 + 12345  # a seed wider than 31 bits


def tiny(cell: Cell, moving: bool = False, skew: bool = False) -> Cell:
    """``cell`` cut to the TINY sizes.  ``moving`` sends the plate across
    the nadir ray within the CPI (10 m a pulse), so that its pulses
    differ; ``skew`` moves the radar off the axis and tilts the plate, so
    that the received lanes' float32 lengths are not exact."""
    cell = copy.deepcopy(cell)
    cfg, tr = cell.config, cell.traffic
    cfg["targets"][0]["terrain"]["n"] = TINY["n"]
    tr.update(num_rays=TINY["num_rays"], pulses=TINY["pulses"], warm_pulses=1, profile_pulses=2)
    if moving:
        cfg["targets"][1]["path"] = [[0.0, [-20.0, 0.0, 400.0]], [0.002, [20.0, 0.0, 400.0]]]
    if skew:
        for part in [cfg["transmitter"]] + cfg["receivers"]:
            part["position"] = [3.3, 1.7, 3999.7]
        cfg["targets"][1]["attitude"]["roll"] = 0.01
    return cell


def dielectric(cell: Cell, clear_below: bool = False, tilt: bool = False) -> Cell:
    """``terrain-1M.fan63`` made ``rts_tpu_torch/bench.py``'s dielectric
    scene (BASELINE config 3): a 200 m x 200 m x 2 m slab of index 1.5 and
    reflection 0.5 at 1 km over the terrain, a second receiver under it
    looking up, ``max_refr_depth`` 2.  ``clear_below`` moves the terrain
    6 km aside, so that the chains that refract through the slab near the
    nadir reach that receiver (over the terrain they meet it first);
    ``tilt`` tips the slab by 0.01 rad, so that the received lanes'
    float32 lengths are not exact."""
    cell = copy.deepcopy(cell)
    cfg = cell.config
    cfg["params"]["max_refr_depth"] = 2
    cfg["receivers"].append({"position": [0.0, 0.0, 100.0], "azimuth": 0.0, "elevation": math.pi / 2,
                             "sphere": [60.0, 1.4, 1.4]})
    cfg["targets"][1].update(rect=[2.0, 200.0, 200.0], path=[[0.0, [0.0, 0.0, 1000.0]]], refl_coeff=0.5,
                             refr_index=1.5)
    if clear_below:
        cfg["targets"][0]["path"] = [[0.0, [6010.0, 0.0, 0.0]]]
    if tilt:
        cfg["targets"][1]["attitude"]["pitch"] += 0.01
    return cell


def one_card(cell: Cell) -> Cell:
    """``cell`` on one card: its traffic without the mesh."""
    cell = copy.deepcopy(cell)
    cell.traffic["mesh"] = None
    cell.chips = 1
    return cell


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture
def terrain_cell():
    return tiny(load_cell("terrain-1M.fan63"))


@pytest.fixture
def imaging_cell():
    return tiny(one_card(load_cell("imaging-1M.cpi256.split4")))

