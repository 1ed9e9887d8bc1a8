"""The one adapter from a configuration file's data to the program's input.

``world(config, traffic, seed)`` builds the ``rts_tpu_torch.sim.World``
and ``Parameters`` that a configuration file describes, its terrain drawn
from ``seed``; ``prepare(...)`` hands them to ``prepare_cpi`` with the
file's options.  It refuses, by name, a key of the transmitter, a
receiver, a target, its terrain or the params that it does not pass on.
The reference reads the same file on its own.
"""

from __future__ import annotations

import json
from pathlib import Path as FsPath

import torch

ROOT = FsPath(__file__).resolve().parent


def load(kind: str, name: str) -> dict:
    """``benchmark/<kind>/<name>.json`` as a dict."""
    return json.loads((ROOT / kind / f"{name}.json").read_text())


# the keys the adapter passes on, by part; any other key is refused, so that
# a configuration file carries no number the program never sees
TX_KEYS = {"position", "azimuth", "elevation", "carrier", "chirp_rate", "pulse_length", "prf", "tx_span"}
RX_KEYS = {"position", "azimuth", "elevation", "sphere"}
TARGET_KEYS = {"shape", "path", "attitude", "refl_coeff", "refr_index"}
SHAPE_KEYS = {"terrain": "terrain", "rect": "rect", "sphere": "sphere_params"}
TERRAIN_KEYS = {"n", "extent", "peak"}  # its seed is the run's
PARAM_KEYS = {"max_refl_depth", "max_refr_depth", "c", "cw_sample_rate"}


def _refuse_unknown(part: dict, known: set, where: str) -> None:
    extra = sorted(set(part) - known)
    if extra:
        raise ValueError(f"{where}: the adapter does not pass {', '.join(map(repr, extra))} to the program")


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
    _refuse_unknown(tx, TX_KEYS, "transmitter")
    w = World()
    w.add(Transmitter(
        path=Path.fixed(*tx["position"]),
        rotation=RotationPath(azimuth=tx["azimuth"], elevation=tx["elevation"]),
        wave=RadarSignal(carrier=tx["carrier"], chirp_rate=tx["chirp_rate"], length=tx["pulse_length"]),
        pulse_count=int(traffic["pulses"]), prf=tx["prf"], tx_span=tuple(tx["tx_span"]),
    ))
    for k, rx in enumerate(config["receivers"]):
        _refuse_unknown(rx, RX_KEYS, f"receiver {k}")
        w.add(Receiver(path=Path.fixed(*rx["position"]),
                       rotation=RotationPath(azimuth=rx["azimuth"], elevation=rx["elevation"]),
                       sphere=tuple(rx["sphere"])))
    for k, t in enumerate(config["targets"]):
        if t["shape"] not in SHAPE_KEYS:
            raise ValueError(f"target {k}: unknown shape {t['shape']!r}")
        key = SHAPE_KEYS[t["shape"]]
        _refuse_unknown(t, TARGET_KEYS | {key}, f"target {k} ({t['shape']})")
        if t["shape"] == "terrain":
            g = t["terrain"]
            _refuse_unknown(g, TERRAIN_KEYS, f"target {k} (terrain)")
            shape = dict(terrain=(int(g["n"]), float(g["extent"]), float(g["peak"]), int(seed)))
        elif t["shape"] == "rect":
            shape = dict(rect=tuple(t["rect"]))
        else:
            shape = dict(sphere_params=(int(t[key][0]), float(t[key][1])))
        w.add(Target(shape=t["shape"], path=path(t["path"]), attitude=AttitudePath(**t.get("attitude", {})),
                     refl_coeff=t["refl_coeff"], refr_index=float(t.get("refr_index", 1.0)), **shape))
    p = config["params"]
    _refuse_unknown(p, PARAM_KEYS, "params")
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
