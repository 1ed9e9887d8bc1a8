"""Vec3 / SVec3 value types — the host-simulator vector surface.

The reference relies on FERS's ``Vec3`` (Cartesian) and ``SVec3``
(spherical: length, azimuth, elevation) classes plus a ``d3_to_V3``
converter (ray_tracer.cpp:881, 1199-1215).  These are plain-Python
equivalents (a copy of ``rts_tpu.core.vectypes``) so code written against
that API ports directly; the engine itself uses flat tensors.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class Vec3:
    x: float = 0.0
    y: float = 0.0
    z: float = 0.0

    def __add__(self, o: "Vec3") -> "Vec3":
        return Vec3(self.x + o.x, self.y + o.y, self.z + o.z)

    def __sub__(self, o: "Vec3") -> "Vec3":
        return Vec3(self.x - o.x, self.y - o.y, self.z - o.z)

    def __mul__(self, s) -> "Vec3":
        if isinstance(s, Vec3):  # dot product, FERS operator semantics
            return self.x * s.x + self.y * s.y + self.z * s.z
        return Vec3(self.x * s, self.y * s, self.z * s)

    __rmul__ = __mul__

    def __truediv__(self, s: float) -> "Vec3":
        return Vec3(self.x / s, self.y / s, self.z / s)

    def __neg__(self) -> "Vec3":
        return Vec3(-self.x, -self.y, -self.z)

    @property
    def length(self) -> float:
        return math.sqrt(self.x**2 + self.y**2 + self.z**2)

    def cross(self, o: "Vec3") -> "Vec3":
        return Vec3(
            self.y * o.z - self.z * o.y,
            self.z * o.x - self.x * o.z,
            self.x * o.y - self.y * o.x,
        )

    def tuple(self):
        return (self.x, self.y, self.z)


@dataclasses.dataclass(frozen=True)
class SVec3:
    """Spherical vector: (length, azimuth, elevation)."""

    length: float = 0.0
    azimuth: float = 0.0
    elevation: float = 0.0

    @classmethod
    def from_cartesian(cls, v: Vec3) -> "SVec3":
        r = v.length
        az = math.atan2(v.y, v.x)
        el = math.atan2(v.z, math.sqrt(v.x**2 + v.y**2)) if r > 0 else 0.0
        return cls(r, az, el)

    def to_cartesian(self) -> Vec3:
        ce = math.cos(self.elevation)
        return Vec3(
            self.length * ce * math.cos(self.azimuth),
            self.length * ce * math.sin(self.azimuth),
            self.length * math.sin(self.elevation),
        )


def svec3(v) -> SVec3:
    """SVec3(Vec3) constructor-style helper (the reference's implicit
    conversion at ray_tracer.cpp:1205-1210)."""
    if isinstance(v, Vec3):
        return SVec3.from_cartesian(v)
    return SVec3.from_cartesian(Vec3(*v))


def d3_to_v3(d) -> Vec3:
    """double3 -> Vec3 (ray_tracer.cpp:1199 d3_to_V3 equivalent)."""
    return Vec3(float(d[0]), float(d[1]), float(d[2]))
