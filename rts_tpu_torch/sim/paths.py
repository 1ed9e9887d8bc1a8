"""Motion and attitude paths.

Stands in for the FERS path machinery the reference calls through
``GetPosition(t)`` / ``GetRotation(t)`` / ``GetTargetRotation(t)``
(ray_tracer.cpp:881, 888, 941-948, 956-958, 1001-1003).  Position paths
are NumPy-vectorised over ``t`` (host preparation); ``RotationPath.azel``
also takes a torch tensor, because receiver gains are evaluated at per-ray
arrival times on the device (ray_tracer.cpp:1234-1235).

Interpolation kinds mirror FERS: static, linear, cubic (natural spline;
second derivatives precomputed with NumPy at construction).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _natural_spline_m(ts: np.ndarray, ys: np.ndarray) -> np.ndarray:
    """Second derivatives of a natural cubic spline through (ts, ys)."""
    n = len(ts)
    if n < 3:
        return np.zeros_like(ys)
    h = np.diff(ts)
    a = np.zeros((n, n))
    b = np.zeros(n if ys.ndim == 1 else (n, ys.shape[1]))
    a[0, 0] = a[-1, -1] = 1.0
    for i in range(1, n - 1):
        a[i, i - 1] = h[i - 1] / 6
        a[i, i] = (h[i - 1] + h[i]) / 3
        a[i, i + 1] = h[i] / 6
        b[i] = (ys[i + 1] - ys[i]) / h[i] - (ys[i] - ys[i - 1]) / h[i - 1]
    return np.linalg.solve(a, b)


@dataclasses.dataclass(frozen=True)
class Path:
    """Position path: waypoints (t_i, xyz_i) with static/linear/cubic
    interpolation.  Times outside the waypoint span clamp to the ends."""

    times: tuple = (0.0,)
    positions: tuple = ((0.0, 0.0, 0.0),)
    interp: str = "static"
    _m2: tuple = dataclasses.field(default=None, compare=False)

    @classmethod
    def fixed(cls, x, y, z) -> "Path":
        return cls(times=(0.0,), positions=((float(x), float(y), float(z)),), interp="static")

    @classmethod
    def linear(cls, waypoints) -> "Path":
        ts, ps = zip(*waypoints)
        return cls(times=tuple(map(float, ts)), positions=tuple(tuple(map(float, p)) for p in ps), interp="linear")

    @classmethod
    def cubic(cls, waypoints) -> "Path":
        ts, ps = zip(*waypoints)
        ts = np.asarray(ts, float)
        ps = np.asarray(ps, float)
        m2 = _natural_spline_m(ts, ps)
        return cls(
            times=tuple(ts.tolist()),
            positions=tuple(map(tuple, ps.tolist())),
            interp="cubic",
            _m2=tuple(map(tuple, m2.tolist())),
        )

    def position(self, t):
        """[..., 3] position at time(s) t."""
        t = np.asarray(t)
        ts = np.asarray(self.times)
        ps = np.asarray(self.positions)
        if self.interp == "static" or len(self.times) == 1:
            return np.broadcast_to(ps[0], t.shape + (3,))
        tc = np.clip(t, ts[0], ts[-1])
        i = np.clip(np.searchsorted(ts, tc, side="right") - 1, 0, len(self.times) - 2)
        h = ts[i + 1] - ts[i]
        u = (tc - ts[i]) / h
        if self.interp == "linear":
            return ps[i] + (ps[i + 1] - ps[i]) * u[..., None]
        m2 = np.asarray(self._m2)
        a, b = 1.0 - u, u
        return (
            a[..., None] * ps[i]
            + b[..., None] * ps[i + 1]
            + ((a**3 - a) * h**2 / 6.0)[..., None] * m2[i]
            + ((b**3 - b) * h**2 / 6.0)[..., None] * m2[i + 1]
        )

    # reference-shaped alias
    def GetPosition(self, t):  # noqa: N802
        return self.position(t)


@dataclasses.dataclass(frozen=True)
class RotationPath:
    """Boresight rotation: fixed (azimuth, elevation) plus constant rates
    (FERS fixed-rate rotation)."""

    azimuth: float = 0.0
    elevation: float = 0.0
    azimuth_rate: float = 0.0
    elevation_rate: float = 0.0

    def azel(self, t):
        if not torch.is_tensor(t):
            t = np.asarray(t)
        az = self.azimuth + self.azimuth_rate * t
        el = self.elevation + self.elevation_rate * t
        return az, el

    def GetRotation(self, t):  # noqa: N802
        return self.azel(t)

    @property
    def is_rotating(self) -> bool:
        return self.azimuth_rate != 0.0 or self.elevation_rate != 0.0


@dataclasses.dataclass(frozen=True)
class AttitudePath:
    """Target yaw/pitch/roll attitude with constant rates
    (GetTargetRotation / GetRotating, ray_tracer.cpp:956-958, 993)."""

    yaw: float = 0.0
    pitch: float = 0.0
    roll: float = 0.0
    yaw_rate: float = 0.0
    pitch_rate: float = 0.0
    roll_rate: float = 0.0

    def ypr(self, t):
        return (
            self.yaw + self.yaw_rate * t,
            self.pitch + self.pitch_rate * t,
            self.roll + self.roll_rate * t,
        )

    def GetTargetRotation(self, t):  # noqa: N802
        return self.ypr(t)

    @property
    def is_rotating(self) -> bool:
        return any(r != 0.0 for r in (self.yaw_rate, self.pitch_rate, self.roll_rate))
