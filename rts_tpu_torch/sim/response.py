"""Responses: the tracer's hand-off to signal rendering.

Equivalent of the external ``Response`` / ``InterpPoint`` pair the
reference builds per unique propagation path (ray_tracer.cpp:1312-1320):
one interpolation point carrying (power, time, delay, doppler, phase,
noise temperature), attached to a receiver.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np


@dataclasses.dataclass
class InterpPoint:
    power: float
    time: float
    delay: float
    doppler: float
    phase: float
    noise_temperature: float


@dataclasses.dataclass
class Response:
    wave: object  # RadarSignal
    transmitter: object  # Transmitter
    points: List[InterpPoint] = dataclasses.field(default_factory=list)

    def add_interp_point(self, point: InterpPoint) -> None:
        self.points.append(point)

    # reference-shaped alias
    def AddInterpPoint(self, point: InterpPoint) -> None:  # noqa: N802
        self.add_interp_point(point)

    @property
    def start_time(self) -> float:
        return min(p.time for p in self.points) if self.points else 0.0


def responses_to_arrays(responses) -> dict:
    """Flatten a response list into NumPy arrays (export convenience)."""
    pts = [p for r in responses for p in r.points]
    return {
        "power": np.array([p.power for p in pts]),
        "time": np.array([p.time for p in pts]),
        "delay": np.array([p.delay for p in pts]),
        "doppler": np.array([p.doppler for p in pts]),
        "phase": np.array([p.phase for p in pts]),
        "noise_temperature": np.array([p.noise_temperature for p in pts]),
    }
