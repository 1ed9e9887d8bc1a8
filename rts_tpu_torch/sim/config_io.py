"""Scene/config file loading: JSON, TOML, and FERS-style XML (counterpart
of ``rts_tpu.sim.config_io``: the same schema, building this package's
``World``).

The reference's configuration lives in the external simulator's XML files
(rsParameters is "XML-driven in FERS/SOARS", SURVEY.md §5).  This module
is the self-contained replacement: one declarative document describes
``Parameters`` plus the whole ``World`` (transmitters, receivers, targets,
antennas, RCS models, motion paths).

Document schema (JSON/TOML; XML uses the same element names):

    parameters: {num_rays, max_refl_depth, max_refr_depth, c, start_time,
                 cw_sample_rate, interpolate_smooth}
    transmitters: [{name, position|waypoints, rotation, wave, prf,
                    pulse_count, tx_span, antenna}]
    receivers:    [{name, position|waypoints, rotation, sphere,
                    noise_temperature, antenna}]
    targets:      [{name, shape, rect|sphere|files|terrain, position|
                    waypoints, attitude, refl_coeff, refr_index, rcs}]

antenna: {type: isotropic|sinc|gaussian|squarehorn|parabolic|table, ...}
rcs:     {type: iso|table, ...}
"""

from __future__ import annotations

import json
import xml.etree.ElementTree as ET
from typing import Tuple

from rts_tpu_torch.config import Parameters
from rts_tpu_torch.physics.antenna import (
    GaussianAntenna,
    IsotropicAntenna,
    ParabolicAntenna,
    SincAntenna,
    SquareHornAntenna,
    TableAntenna,
)
from rts_tpu_torch.physics.rcs import IsoRCS, PlateRCS, SphereRCS, TableRCS
from rts_tpu_torch.sim.paths import AttitudePath, Path, RotationPath
from rts_tpu_torch.sim.waveform import RadarSignal
from rts_tpu_torch.sim.world import Receiver, Target, Transmitter, World

_ANTENNAS = {
    "isotropic": IsotropicAntenna,
    "sinc": SincAntenna,
    "gaussian": GaussianAntenna,
    "squarehorn": SquareHornAntenna,
    "parabolic": ParabolicAntenna,
}


def _antenna(spec) -> object:
    if not spec:
        return IsotropicAntenna()
    kind = spec.get("type", "isotropic").lower()
    kw = {k: v for k, v in spec.items() if k != "type"}
    if kind == "table":
        return TableAntenna(**kw)
    if kind not in _ANTENNAS:
        raise ValueError(f"unknown antenna type {kind!r}")
    return _ANTENNAS[kind](**kw)


def _rcs(spec) -> object:
    if not spec:
        return IsoRCS()
    kind = spec.get("type", "iso").lower()
    if kind in ("iso", "isotropic", "constant"):
        return IsoRCS(sigma=float(spec.get("sigma", 1.0)))
    if kind == "table":
        return TableRCS.from_arrays(spec["az_grid"], spec["el_grid"], spec["table"])
    if kind == "sphere":
        return SphereRCS(radius=float(spec.get("radius", 1.0)))
    if kind == "plate":
        return PlateRCS(width=float(spec.get("width", 1.0)), height=float(spec.get("height", 1.0)))
    raise ValueError(f"unknown rcs type {kind!r}")


def _path(spec) -> Path:
    if "waypoints" in spec:
        wps = [(float(t), tuple(map(float, p))) for t, p in spec["waypoints"]]
        interp = spec.get("interp", "linear")
        if interp == "cubic":
            return Path.cubic(wps)
        return Path.linear(wps)
    pos = spec.get("position", (0.0, 0.0, 0.0))
    return Path.fixed(*pos)


def _rotation(spec) -> RotationPath:
    spec = spec or {}
    return RotationPath(
        azimuth=float(spec.get("azimuth", 0.0)),
        elevation=float(spec.get("elevation", 0.0)),
        azimuth_rate=float(spec.get("azimuth_rate", 0.0)),
        elevation_rate=float(spec.get("elevation_rate", 0.0)),
    )


def _attitude(spec) -> AttitudePath:
    spec = spec or {}
    return AttitudePath(
        yaw=float(spec.get("yaw", 0.0)),
        pitch=float(spec.get("pitch", 0.0)),
        roll=float(spec.get("roll", 0.0)),
        yaw_rate=float(spec.get("yaw_rate", 0.0)),
        pitch_rate=float(spec.get("pitch_rate", 0.0)),
        roll_rate=float(spec.get("roll_rate", 0.0)),
    )


def world_from_dict(doc: dict) -> Tuple[World, Parameters]:
    params = Parameters(**doc.get("parameters", {}))
    world = World()
    for t in doc.get("transmitters", []):
        wave_spec = t.get("wave", {})
        world.add(
            Transmitter(
                name=t.get("name", "tx"),
                path=_path(t),
                rotation=_rotation(t.get("rotation")),
                antenna=_antenna(t.get("antenna")),
                wave=RadarSignal(
                    name=wave_spec.get("name", "pulse"),
                    carrier=float(wave_spec.get("carrier", 10e9)),
                    power=float(wave_spec.get("power", 1.0)),
                    length=float(wave_spec.get("length", 1e-6)),
                    temperature=float(wave_spec.get("temperature", 0.0)),
                ),
                prf=float(t.get("prf", 1000.0)),
                pulse_count=int(t.get("pulse_count", 1)),
                start_time=float(t.get("start_time", 0.0)),
                tx_span=tuple(map(float, t.get("tx_span", (0.1, 0.1, 0.0)))),
            )
        )
    for r in doc.get("receivers", []):
        world.add(
            Receiver(
                name=r.get("name", "rx"),
                path=_path(r),
                rotation=_rotation(r.get("rotation")),
                antenna=_antenna(r.get("antenna")),
                sphere=tuple(map(float, r.get("sphere", (5.0, 1.0, 1.0)))),
                noise_temperature=float(r.get("noise_temperature", 0.0)),
            )
        )
    for g in doc.get("targets", []):
        shape = g.get("shape", "sphere")
        world.add(
            Target(
                name=g.get("name", "target"),
                path=_path(g),
                attitude=_attitude(g.get("attitude")),
                shape=shape,
                rect=tuple(map(float, g.get("rect", (1.0, 1.0, 1.0)))),
                sphere_params=tuple(g.get("sphere", (2, 1.0))),
                files=tuple(g.get("files", ("", ""))),
                terrain=tuple(g.get("terrain", (64, 1000.0, 50.0, 0))),
                refl_coeff=float(g.get("refl_coeff", 1.0)),
                refr_index=float(g.get("refr_index", 1.0)),
                rcs_model=_rcs(g.get("rcs")),
            )
        )
    return world, params


# ---------------------------------------------------------------------------
# XML (FERS-flavored): elements mirror the dict schema; lists/tuples are
# whitespace-separated text, waypoints are <waypoint time="t">x y z</waypoint>.


def _xml_value(el):
    text = (el.text or "").strip()
    if len(el):
        d = {}
        for child in el:
            if child.tag == "waypoint":
                d.setdefault("waypoints", []).append(
                    [float(child.get("time", 0.0)), [float(x) for x in child.text.split()]]
                )
            elif child.tag in d:
                pass
            else:
                d[child.tag] = _xml_value(child)
        d.update({k: _parse_scalar(v) for k, v in el.attrib.items()})
        return d
    if " " in text:
        try:
            return [_parse_scalar(x) for x in text.split()]
        except ValueError:
            return text
    return _parse_scalar(text)


def _parse_scalar(s):
    if isinstance(s, (int, float, list)):
        return s
    sl = s.strip().lower()
    if sl in ("true", "false"):
        return sl == "true"
    try:
        return int(s)
    except ValueError:
        pass
    try:
        return float(s)
    except ValueError:
        return s


def world_from_xml(text: str) -> Tuple[World, Parameters]:
    root = ET.fromstring(text)
    doc: dict = {"parameters": {}, "transmitters": [], "receivers": [], "targets": []}
    for el in root:
        if el.tag == "parameters":
            doc["parameters"] = _xml_value(el)
        elif el.tag == "transmitter":
            doc["transmitters"].append(_xml_value(el))
        elif el.tag == "receiver":
            doc["receivers"].append(_xml_value(el))
        elif el.tag == "target":
            doc["targets"].append(_xml_value(el))
    return world_from_dict(doc)


def load_world(path: str) -> Tuple[World, Parameters]:
    """Load (World, Parameters) from .json, .toml, or .xml."""
    with open(path, "rb") as fh:
        raw = fh.read()
    if path.endswith(".json"):
        return world_from_dict(json.loads(raw))
    if path.endswith(".toml"):
        import tomllib

        return world_from_dict(tomllib.loads(raw.decode()))
    if path.endswith(".xml"):
        return world_from_xml(raw.decode())
    raise ValueError(f"unsupported config format: {path}")
