"""The plain reference agrees with the port at a tiny size, reflecting and
refracting, and keeps its reflect-only outputs bit for bit; and the check
rejects the two controls: the program with its float64 replay off (on a
scene whose received lanes are not exact in float32) and the reference
traced in bfloat16 in the program's place."""

from __future__ import annotations

import hashlib

import pytest
import torch

from benchmark import check as C
from benchmark.controls import readings
from benchmark.reference import reference_cpi
from benchmark.run import load_cell
from conftest import SEED, dielectric, one_card, tiny

CELLS = ["terrain-1M.fan63", "imaging-1M.cpi256.split4"]

# sha256 (first 32 hex digits) of the reference's lanes, aggregates and
# map at the tiny sizes, as the reflect-only reference gave them before it
# learnt to refract
REFLECT_ONLY = {
    "terrain": "990190d70cc86452c2dea0dd1ad5a09b",
    "imaging.moving": "d8097e69407dd1677a643192dc0c094d",
    "imaging.skew": "05ecbf9dee2a187084ab0b1507e40688",
}


def _world(name: str):
    """A tiny cell by name: the two benchmark cells, and ``rts_tpu_torch/
    bench.py``'s dielectric scene over the terrain (as BASELINE config 3:
    no refracted chain reaches a receiver) and with the ground below the
    slab cleared (refracted chains do)."""
    if name in CELLS:
        return tiny(one_card(load_cell(name)))
    return dielectric(tiny(load_cell("terrain-1M.fan63")), clear_below=name == "dielectric.clear")


def _refracted_received(cell) -> int:
    lanes = reference_cpi(cell.config, cell.traffic, SEED, torch.device("cpu")).lanes
    return int(((lanes.received >= 0) & (lanes.refr_depth > 0)).sum())


@pytest.mark.parametrize("name", CELLS + ["dielectric", "dielectric.clear"])
def test_reference_agrees_with_the_port(name):
    cell = _world(name)
    got = readings(cell, SEED, torch.device("cpu"), sound_only=True)["sound"]
    assert C.verdict(got), got
    assert got["rx_differ"] == 0 and got["lanes_far"] == 0
    assert got["phase_rad"] < 1e-7 and got["rx_power_rel"] < 1e-7
    if name == "dielectric.clear":
        assert _refracted_received(cell) > 0


@pytest.mark.parametrize("case", sorted(REFLECT_ONLY))
def test_reference_keeps_its_reflect_only_outputs(case):
    name, _, kw = case.partition(".")
    cell = tiny(one_card(load_cell(CELLS[0] if name == "terrain" else CELLS[1])), **({kw: True} if kw else {}))
    ref = reference_cpi(cell.config, cell.traffic, SEED, torch.device("cpu"))
    h = hashlib.sha256()
    for field in ("received", "power", "doppler", "delay", "ray_length", "refl_depth", "path"):
        h.update(getattr(ref.lanes, field).contiguous().numpy().tobytes())
    for x in ref.agg:
        h.update(x.contiguous().numpy().tobytes())
    if ref.map is not None:
        h.update(ref.map.contiguous().numpy().tobytes())
    assert h.hexdigest()[:32] == REFLECT_ONLY[case]
    assert ref.lanes.received.shape[1] == 5**3 and not ref.lanes.refr_depth.any()


def test_controls_fail_the_check():
    got = readings(tiny(one_card(load_cell("imaging-1M.cpi256.split4")), skew=True), SEED, torch.device("cpu"))
    assert C.verdict(got["sound"]), got["sound"]
    assert not C.verdict(got["refine_off"])
    assert got["refine_off"]["phase_rad"] > 100 * C.LIMITS["phase_rad"]
    assert not C.verdict(got["ref_bf16"])
    assert got["ref_bf16"]["lanes_far"] > C.LIMITS["lanes_far"]
    assert got["ref_bf16"]["map_rel"] > C.LIMITS["map_rel"]


def test_controls_fail_the_check_on_a_refracting_world():
    # the slab tipped, so that the refracted chains' float32 lengths are
    # not exact; they are the world's only received lanes
    cell = dielectric(tiny(load_cell("terrain-1M.fan63")), clear_below=True, tilt=True)
    assert _refracted_received(cell) > 0
    got = readings(cell, SEED, torch.device("cpu"))
    assert C.verdict(got["sound"]), got["sound"]
    assert not C.verdict(got["refine_off"])
    assert got["refine_off"]["phase_rad"] > 100 * C.LIMITS["phase_rad"]
    assert not C.verdict(got["ref_bf16"])
    assert got["ref_bf16"]["rx_differ"] > 0 and got["ref_bf16"]["lanes_far"] > C.LIMITS["lanes_far"]
