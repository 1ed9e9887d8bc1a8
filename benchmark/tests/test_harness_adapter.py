"""The adapter hands the program every key of a configuration file's
transmitter, receivers and targets, and refuses by name a key it would
not pass on."""

from __future__ import annotations

import copy

import pytest

from benchmark import adapter
from benchmark.run import load_cell
from conftest import SEED, dielectric, tiny

CELLS = ["terrain-1M.fan63", "imaging-1M.cpi256.split4"]


@pytest.mark.parametrize("name", CELLS)
def test_both_configurations_load_unchanged(name):
    cell = load_cell(name)
    w, params = adapter.world(cell.config, cell.traffic, SEED)
    assert len(w.targets) == len(cell.config["targets"]) and len(w.receivers) == len(cell.config["receivers"])
    assert [t.refr_index for t in w.targets] == [1.0, 1.0]
    assert [t.refl_coeff for t in w.targets] == [t["refl_coeff"] for t in cell.config["targets"]]
    assert params.max_refr_depth == 0 and params.num_rays == cell.traffic["num_rays"]


def test_the_adapter_passes_refr_index():
    cell = dielectric(tiny(load_cell("terrain-1M.fan63")))
    w, params = adapter.world(cell.config, cell.traffic, SEED)
    assert [t.refr_index for t in w.targets] == [1.0, 1.5]
    assert [t.refl_coeff for t in w.targets] == [0.9, 0.5]
    assert params.max_refr_depth == 2 and len(w.receivers) == 2


def test_the_adapter_passes_sphere_params():
    cell = tiny(load_cell("terrain-1M.fan63"))
    cell.config["targets"][1] = {"shape": "sphere", "sphere_params": [2, 60.0], "path": [[0.0, [0.0, 0.0, 400.0]]],
                                 "refl_coeff": 0.9}
    w, _ = adapter.world(cell.config, cell.traffic, SEED)
    assert w.targets[1].shape == "sphere" and w.targets[1].sphere_params == (2, 60.0)


@pytest.mark.parametrize("where", ["transmitter", "receiver", "target", "terrain", "params", "rect on terrain"])
def test_the_adapter_refuses_an_unknown_key(where):
    config = copy.deepcopy(load_cell("terrain-1M.fan63").config)
    part, key = {"transmitter": (config["transmitter"], "beamwidth"), "receiver": (config["receivers"][0], "gain"),
                 "target": (config["targets"][1], "rcs"), "terrain": (config["targets"][0]["terrain"], "seed"),
                 "params": (config["params"], "start_time"),
                 "rect on terrain": (config["targets"][0], "rect")}[where]
    part[key] = 1.0
    with pytest.raises(ValueError, match=repr(key)):
        adapter.world(config, {"pulses": 4, "num_rays": 5}, SEED)
