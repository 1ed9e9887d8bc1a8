"""World model: transmitters, receivers, targets.

Self-contained implementation of the host-simulator surface the
reference assumes but does not ship (SURVEY.md §2.3) — every method RTS
calls exists here, both pythonic and with reference-shaped CamelCase
aliases.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from rts_tpu_torch.geometry import file_mesh, rect_mesh, sphere_mesh
from rts_tpu_torch.geometry.mesh import Mesh
from rts_tpu_torch.physics.antenna import IsotropicAntenna
from rts_tpu_torch.physics.rcs import IsoRCS
from rts_tpu_torch.sim.paths import AttitudePath, Path, RotationPath
from rts_tpu_torch.sim.response import Response
from rts_tpu_torch.sim.waveform import RadarSignal, TransmitterPulse


@dataclasses.dataclass
class Transmitter:
    """Pulse source.  ``tx_span`` = (azimuth span, elevation span, launch
    range) steering the N^3 fan (GetTxSpan, ray_tracer.cpp:818)."""

    name: str = "tx"
    path: Path = dataclasses.field(default_factory=Path)
    rotation: RotationPath = dataclasses.field(default_factory=RotationPath)
    antenna: object = dataclasses.field(default_factory=IsotropicAntenna)
    wave: RadarSignal = dataclasses.field(default_factory=RadarSignal)
    prf: float = 1000.0
    pulse_count: int = 1
    pulse_times: Optional[tuple] = None  # explicit schedule overrides prf
    start_time: float = 0.0
    tx_span: tuple = (0.1, 0.1, 0.0)

    def pulse_time(self, k: int) -> float:
        if self.pulse_times is not None:
            return float(self.pulse_times[k])
        return self.start_time + k / self.prf

    # --- reference-shaped API -------------------------------------------
    def GetPulseCount(self) -> int:  # noqa: N802
        return self.pulse_count if self.pulse_times is None else len(self.pulse_times)

    def GetPulse(self, signal: TransmitterPulse, k: int) -> None:  # noqa: N802
        signal.wave = self.wave
        signal.time = self.pulse_time(k)

    def GetTxSpan(self):  # noqa: N802
        return self.tx_span

    def GetPosition(self, t):  # noqa: N802
        return self.path.position(t)

    def GetRotation(self, t):  # noqa: N802
        return self.rotation.azel(t)

    def GetGain(self, az, el, rotation, wavelength):  # noqa: N802
        return self.antenna.gain(az, el, rotation[0], rotation[1], wavelength)


@dataclasses.dataclass
class Receiver:
    """Capture sphere + antenna.  ``sphere`` = (radius, theta span, phi
    span) (GetRxSphere, ray_tracer.cpp:832)."""

    name: str = "rx"
    path: Path = dataclasses.field(default_factory=Path)
    rotation: RotationPath = dataclasses.field(default_factory=RotationPath)
    antenna: object = dataclasses.field(default_factory=IsotropicAntenna)
    sphere: tuple = (5.0, 1.0, 1.0)
    noise_temperature: float = 0.0
    responses: List[Response] = dataclasses.field(default_factory=list)

    def add_response(self, response: Response) -> None:
        self.responses.append(response)

    # --- reference-shaped API -------------------------------------------
    def GetRxSphere(self):  # noqa: N802
        return self.sphere

    def GetNoiseTemperature(self):  # noqa: N802
        return self.noise_temperature

    def SetNoiseTemperature(self, temp) -> None:  # noqa: N802
        self.noise_temperature = float(temp)

    def GetPosition(self, t):  # noqa: N802
        return self.path.position(t)

    def GetRotation(self, t):  # noqa: N802
        return self.rotation.azel(t)

    def GetGain(self, az, el, rotation, wavelength):  # noqa: N802
        return self.antenna.gain(az, el, rotation[0], rotation[1], wavelength)

    def AddResponse(self, response: Response) -> None:  # noqa: N802
        self.add_response(response)


@dataclasses.dataclass
class Target:
    """Scattering body: mesh shape + material + RCS model.

    ``shape`` is 'rect' (w, h, d), 'sphere' (subdivs, radius) or 'file'
    (vertex file, normal file) — the three generator families of
    ray_tracer.cpp:226-504.
    """

    name: str = "target"
    path: Path = dataclasses.field(default_factory=Path)
    attitude: AttitudePath = dataclasses.field(default_factory=AttitudePath)
    shape: str = "sphere"
    rect: tuple = (1.0, 1.0, 1.0)
    sphere_params: tuple = (2, 1.0)  # (subdivs, radius)
    files: tuple = ("", "")  # (vertex file, normal file)
    terrain: tuple = (64, 1000.0, 50.0, 0)  # (n, extent, peak height, seed) — extension
    refl_coeff: float = 1.0
    refr_index: float = 1.0
    rcs_model: object = dataclasses.field(default_factory=IsoRCS)

    def base_mesh(self, *, strict_parity: bool = True) -> Mesh:
        """Mesh rotated by the t=0 attitude (ray_tracer.cpp:956-987)."""
        yaw, pitch, roll = self.attitude.ypr(0.0)
        if self.shape == "rect":
            return rect_mesh(*self.rect, yaw=yaw, pitch=pitch, roll=roll, strict_parity=strict_parity)
        if self.shape == "sphere":
            mesh, _ = sphere_mesh(
                int(self.sphere_params[0]), self.sphere_params[1],
                yaw=yaw, pitch=pitch, roll=roll, strict_parity=strict_parity,
            )
            return mesh
        if self.shape == "file":
            return file_mesh(self.files[0], self.files[1], yaw=yaw, pitch=pitch, roll=roll, strict_parity=strict_parity)
        if self.shape == "terrain":
            from rts_tpu_torch.geometry import terrain_mesh

            n, extent, peak, seed = self.terrain
            return terrain_mesh(
                int(n), extent, peak, seed=int(seed),
                yaw=yaw, pitch=pitch, roll=roll, strict_parity=strict_parity,
            )
        raise ValueError(f"unknown target shape {self.shape!r}")

    # --- reference-shaped API -------------------------------------------
    def GetPosition(self, t):  # noqa: N802
        return self.path.position(t)

    def GetTargetRotation(self, t):  # noqa: N802
        return self.attitude.ypr(t)

    def GetRotating(self) -> bool:  # noqa: N802
        return self.attitude.is_rotating

    def GetShape(self) -> str:  # noqa: N802
        return self.shape

    def GetRect(self):  # noqa: N802
        return self.rect

    def GetSphere(self):  # noqa: N802
        return self.sphere_params

    def GetFile(self):  # noqa: N802
        return self.files

    def GetReflCoeff(self) -> float:  # noqa: N802
        return self.refl_coeff

    def GetRefrIndex(self) -> float:  # noqa: N802
        return self.refr_index

    def GetRCS(self, az_sum, el_sum, wavelength):  # noqa: N802
        return self.rcs_model.rcs(az_sum, el_sum, wavelength)


@dataclasses.dataclass
class World:
    """Scene container (rsworld equivalent, ray_tracer.cpp:639-644)."""

    transmitters: List[Transmitter] = dataclasses.field(default_factory=list)
    receivers: List[Receiver] = dataclasses.field(default_factory=list)
    targets: List[Target] = dataclasses.field(default_factory=list)

    def add(self, obj) -> "World":
        if isinstance(obj, Transmitter):
            self.transmitters.append(obj)
        elif isinstance(obj, Receiver):
            self.receivers.append(obj)
        elif isinstance(obj, Target):
            self.targets.append(obj)
        else:
            raise TypeError(f"cannot add {type(obj).__name__} to World")
        return self
