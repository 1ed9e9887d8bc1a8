"""Radar cross-section models (counterpart of ``rts_tpu.physics.rcs``).

The reference calls an external ``Target::GetRCS(azAngleSum, elAngleSum,
wavelength)`` per recorded bounce (ray_tracer.cpp:1226) where the angle
arguments are the *sums* of the arrival and departure angles recorded by
the tracer ("half-angle approximation", ray_tracer.cpp:865 comment).
Every model is a callable ``rcs(az_sum, el_sum, wavelength) -> sigma`` on
tensors (a Python number is taken as a float64 tensor), in the dtype and
on the device of ``az_sum``.  ``aspect_free`` marks the models that ignore
their angles: ``prepare_cpi`` reads it to decide whether the tracer
records them.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


def _tensor(x):
    return x if torch.is_tensor(x) else torch.tensor(x, dtype=torch.float64)


def _full(az_sum, value):
    az_sum = _tensor(az_sum)
    return torch.full(az_sum.shape, value, dtype=az_sum.dtype, device=az_sum.device)


@dataclasses.dataclass(frozen=True)
class IsoRCS:
    """Aspect-independent RCS (sigma in m^2)."""

    aspect_free = True

    sigma: float = 1.0

    def rcs(self, az_sum, el_sum, wavelength):
        return _full(az_sum, self.sigma)

    def GetRCS(self, az_sum, el_sum, wavelength):  # noqa: N802
        return self.rcs(az_sum, el_sum, wavelength)


@dataclasses.dataclass(frozen=True)
class SphereRCS:
    """Optical-region conducting sphere: sigma = pi r^2, aspect-free."""

    aspect_free = True

    radius: float = 1.0

    def rcs(self, az_sum, el_sum, wavelength):
        return _full(az_sum, math.pi * self.radius**2)

    def GetRCS(self, az_sum, el_sum, wavelength):  # noqa: N802
        return self.rcs(az_sum, el_sum, wavelength)


@dataclasses.dataclass(frozen=True)
class PlateRCS:
    """Flat rectangular plate (physical optics): peak 4*pi*A^2/lambda^2 at
    specular, sinc^2 falloff with the bistatic half-angle off broadside."""

    width: float = 1.0
    height: float = 1.0

    def rcs(self, az_sum, el_sum, wavelength):
        az_sum, el_sum = _tensor(az_sum), _tensor(el_sum)
        a = self.width * self.height
        peak = 4.0 * math.pi * a**2 / wavelength**2
        # bistatic half-angles (the recorded sums are arrival+departure)
        xa = 2.0 * math.pi * self.width / wavelength * torch.sin(az_sum / 2.0)
        xe = 2.0 * math.pi * self.height / wavelength * torch.sin(el_sum / 2.0)

        def sinc(x):
            small = torch.abs(x) < 1e-9
            safe = torch.where(small, 1.0, x)
            return torch.where(small, 1.0, torch.sin(safe) / safe)

        return peak * sinc(xa) ** 2 * sinc(xe) ** 2

    def GetRCS(self, az_sum, el_sum, wavelength):  # noqa: N802
        return self.rcs(az_sum, el_sum, wavelength)


@dataclasses.dataclass(frozen=True)
class TableRCS:
    """Bilinear interpolation over a (bistatic half-angle) az/el table.

    The lookup angle is half the recorded angle sum — the bisector
    direction of the arrival/departure pair.  Angles are wrapped into
    the table's periodic domain [-pi, pi) x [-pi/2, pi/2] and clamped to
    the grids' ends.
    """

    az_grid: tuple  # strictly increasing, radians
    el_grid: tuple
    table: tuple  # [n_el][n_az] sigma values

    @classmethod
    def from_arrays(cls, az_grid, el_grid, table) -> "TableRCS":
        az = np.asarray(az_grid, float)
        el = np.asarray(el_grid, float)
        tb = np.asarray(table, float)
        if tb.shape != (el.size, az.size):
            raise ValueError("table shape must be (n_el, n_az)")
        return cls(
            az_grid=tuple(az.tolist()),
            el_grid=tuple(el.tolist()),
            table=tuple(map(tuple, tb.tolist())),
        )

    def rcs(self, az_sum, el_sum, wavelength):
        az_sum, el_sum = _tensor(az_sum), _tensor(el_sum)
        like = dict(dtype=az_sum.dtype, device=az_sum.device)
        az = torch.tensor(self.az_grid, **like)
        el = torch.tensor(self.el_grid, **like)
        tb = torch.tensor(self.table, **like)
        a = (az_sum / 2.0 + math.pi) % (2 * math.pi) - math.pi
        e = torch.clamp(el_sum.to(az_sum.dtype) / 2.0, el[0], el[-1])
        a = torch.clamp(a, az[0], az[-1])

        # jnp.searchsorted(side="left") is torch.searchsorted(right=False)
        ia = torch.clamp(torch.searchsorted(az, a.contiguous()) - 1, 0, az.numel() - 2)
        ie = torch.clamp(torch.searchsorted(el, e.contiguous()) - 1, 0, el.numel() - 2)
        wa = (a - az[ia]) / (az[ia + 1] - az[ia])
        we = (e - el[ie]) / (el[ie + 1] - el[ie])
        v00 = tb[ie, ia]
        v01 = tb[ie, ia + 1]
        v10 = tb[ie + 1, ia]
        v11 = tb[ie + 1, ia + 1]
        return (
            v00 * (1 - wa) * (1 - we)
            + v01 * wa * (1 - we)
            + v10 * (1 - wa) * we
            + v11 * wa * we
        )

    def GetRCS(self, az_sum, el_sum, wavelength):  # noqa: N802
        return self.rcs(az_sum, el_sum, wavelength)
