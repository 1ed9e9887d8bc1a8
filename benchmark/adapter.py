"""The one adapter from a configuration file's data to the program's input.

``world(config, traffic, seed)`` builds the ``rts_tpu_torch.sim.World``
and ``Parameters`` that a configuration file describes, its terrain drawn
from ``seed``; ``prepare(...)`` hands them to ``prepare_cpi`` with the
file's options.  The reference reads the same file on its own.
"""

from __future__ import annotations

import json
from pathlib import Path as FsPath

import torch

ROOT = FsPath(__file__).resolve().parent


def load(kind: str, name: str) -> dict:
    """``benchmark/<kind>/<name>.json`` as a dict."""
    return json.loads((ROOT / kind / f"{name}.json").read_text())


def world(config: dict, traffic: dict, seed: int):
    """(World, Parameters) of ``config`` with ``traffic``'s pulses and fan."""
    from rts_tpu_torch import Parameters
    from rts_tpu_torch.sim import (AttitudePath, Path, RadarSignal, Receiver, RotationPath, Target,
                                   Transmitter, World)

    def path(waypoints):
        if len(waypoints) == 1:
            return Path.fixed(*waypoints[0][1])
        return Path.linear([(t, tuple(p)) for t, p in waypoints])

    tx = config["transmitter"]
    w = World()
    w.add(Transmitter(
        path=Path.fixed(*tx["position"]),
        rotation=RotationPath(azimuth=tx["azimuth"], elevation=tx["elevation"]),
        wave=RadarSignal(carrier=tx["carrier"], chirp_rate=tx["chirp_rate"], length=tx["pulse_length"]),
        pulse_count=int(traffic["pulses"]), prf=tx["prf"], tx_span=tuple(tx["tx_span"]),
    ))
    for rx in config["receivers"]:
        w.add(Receiver(path=Path.fixed(*rx["position"]),
                       rotation=RotationPath(azimuth=rx["azimuth"], elevation=rx["elevation"]),
                       sphere=tuple(rx["sphere"])))
    for t in config["targets"]:
        att = AttitudePath(**t.get("attitude", {}))
        if t["shape"] == "terrain":
            g = t["terrain"]
            shape = dict(terrain=(int(g["n"]), float(g["extent"]), float(g["peak"]), int(seed)))
        elif t["shape"] == "rect":
            shape = dict(rect=tuple(t["rect"]))
        else:
            raise ValueError(f"unknown target shape {t['shape']!r}")
        w.add(Target(shape=t["shape"], path=path(t["path"]), attitude=att, refl_coeff=t["refl_coeff"], **shape))
    p = config["params"]
    params = Parameters(num_rays=int(traffic["num_rays"]), max_refl_depth=int(p["max_refl_depth"]),
                        max_refr_depth=int(p["max_refr_depth"]), c=float(p["c"]),
                        cw_sample_rate=float(p["cw_sample_rate"]))
    return w, params


def prepare(config: dict, traffic: dict, seed: int, device, **override):
    """``prepare_cpi``'s (base, batch, cfg, spec) for the cell on ``device``;
    ``override`` replaces options of the file (the controls' refine=False)."""
    from rts_tpu_torch.sim import prepare_cpi

    w, params = world(config, traffic, seed)
    options = {**config["options"], **override}
    return prepare_cpi(w, params, dtype=torch.float32, device=device, **options)


def render(config: dict, traffic: dict, out):
    """The compressed range-Doppler map of the traffic's receiver, rendered
    by the program, on the device (None when the traffic renders nothing)."""
    spec = traffic.get("render")
    if not spec:
        return None
    from benchmark.reference import window_start
    from rts_tpu_torch.sim.render import RenderGrid, render_cpi_result

    tx = config["transmitter"]
    grid = RenderGrid(sample_rate=float(spec["sample_rate"]), num_samples=int(spec["num_samples"]),
                      window_start=window_start(config, spec))
    rd, _ = render_cpi_result(out, int(spec["rx"]), grid, pulse_length=float(tx["pulse_length"]),
                              chirp_rate=float(tx["chirp_rate"]), compress=bool(spec["compress"]))
    return rd
