"""The benchmark's plain reference: a CPI traced, aggregated and rendered
again in float64 from a configuration file's data and the run's seed.

It imports neither jax nor any module of the program under test.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from benchmark.reference.render import render_map
from benchmark.reference.scene import build_scene
from benchmark.reference.tracer import Aggregate, Geometry, Lanes, aggregate, trace_pulse


class ReferenceCpi(NamedTuple):
    lanes: Lanes  # [P, R] fields
    agg: Aggregate  # [P, R] fields
    map: torch.Tensor | None  # [P, Ns] when the traffic renders


def _stack(items):
    return type(items[0])(*(torch.stack(f) for f in zip(*items)))


def window_start(config: dict, render: dict) -> float:
    """The receive window opens at the round trip to ``window_margin_m``
    above the ground under the transmitter."""
    tx_z = float(config["transmitter"]["position"][2])
    return 2.0 * (tx_z - float(render["window_margin_m"])) / float(config["params"]["c"])


def reference_cpi(config: dict, traffic: dict, seed: int, device, dtype=torch.float64) -> ReferenceCpi:
    """The reference's whole CPI for ``config`` under ``traffic`` at ``seed``;
    the trace computes in ``dtype``."""
    scene = build_scene(config, seed)
    geo = Geometry(scene, device, dtype)
    times = scene.pulse_times(int(traffic["pulses"]))
    pos, vel = scene.motion(times)
    rx_pos = [r["position"] for r in config["receivers"]]
    c, carrier = float(config["params"]["c"]), float(config["transmitter"]["carrier"])
    lanes, agg = [], []
    for k in range(len(times)):
        if k and np.array_equal(pos[k], pos[k - 1]) and np.array_equal(vel[k], vel[k - 1]):
            lanes.append(lanes[-1])  # the same inputs as the pulse before: the same lanes
            agg.append(agg[-1])
            continue
        lanes.append(trace_pulse(geo, scene, int(traffic["num_rays"]), pos[k], vel[k], rx_pos))
        agg.append(aggregate(lanes[-1], carrier, c))
    lanes, agg = _stack(lanes), _stack(agg)
    rmap = None
    render = traffic.get("render")
    if render:
        tx = config["transmitter"]
        rmap = render_map(agg, lanes.received, int(render["rx"]), render, float(tx["pulse_length"]),
                          float(tx["chirp_rate"]), bool(render["compress"]), window_start(config, render))
    return ReferenceCpi(lanes, agg, rmap)
