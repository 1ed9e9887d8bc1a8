"""The plain reference agrees with the port at a tiny size, and the check
rejects the two controls: the program with its float64 replay off (on a
scene whose received lanes are not exact in float32) and the reference
traced in bfloat16 in the program's place."""

from __future__ import annotations

import pytest

from benchmark import check as C
from benchmark.controls import readings
from benchmark.run import load_cell
from conftest import SEED, one_card, tiny

CELLS = ["terrain-1M.fan63", "imaging-1M.cpi256.split4"]


@pytest.mark.parametrize("name", CELLS)
def test_reference_agrees_with_the_port(name):
    import torch

    got = readings(tiny(one_card(load_cell(name))), SEED, torch.device("cpu"), sound_only=True)["sound"]
    assert C.verdict(got), got
    assert got["rx_differ"] == 0 and got["lanes_far"] == 0
    assert got["phase_rad"] < 1e-7 and got["rx_power_rel"] < 1e-7


def test_controls_fail_the_check():
    import torch

    got = readings(tiny(one_card(load_cell("imaging-1M.cpi256.split4")), skew=True), SEED, torch.device("cpu"))
    assert C.verdict(got["sound"]), got["sound"]
    assert not C.verdict(got["refine_off"])
    assert got["refine_off"]["phase_rad"] > 100 * C.LIMITS["phase_rad"]
    assert not C.verdict(got["ref_bf16"])
    assert got["ref_bf16"]["lanes_far"] > C.LIMITS["lanes_far"]
    assert got["ref_bf16"]["map_rel"] > C.LIMITS["map_rel"]
