"""Radar cross-section models (counterpart of ``rts_tpu.physics.rcs``).

Every model is a callable ``rcs(az_sum, el_sum, wavelength) -> sigma`` on
tensors, where the angle arguments are the per-bounce sums of arrival and
departure angles recorded by the tracer (ray_tracer.cpp:1226).

Only ``IsoRCS`` — the model of the production scenes — has a torch
``rcs`` yet.  The other models keep their classes, parameters and
``aspect_free`` flags (``prepare_cpi`` reads them to decide whether the
tracer records angles) and raise until they are ported (ROADMAP A.8).
"""

from __future__ import annotations

import dataclasses

import torch


def _not_ported(name: str):
    raise NotImplementedError(
        f"{name}.rcs is not ported to rts_tpu_torch yet (ROADMAP A.8); "
        "use IsoRCS or the JAX package"
    )


@dataclasses.dataclass(frozen=True)
class IsoRCS:
    """Aspect-independent RCS (sigma in m^2)."""

    aspect_free = True

    sigma: float = 1.0

    def rcs(self, az_sum, el_sum, wavelength):
        return torch.full(az_sum.shape, self.sigma, dtype=az_sum.dtype, device=az_sum.device)

    def GetRCS(self, az_sum, el_sum, wavelength):  # noqa: N802
        return self.rcs(az_sum, el_sum, wavelength)


@dataclasses.dataclass(frozen=True)
class SphereRCS:
    """Optical-region conducting sphere: sigma = pi r^2, aspect-free."""

    aspect_free = True

    radius: float = 1.0

    def rcs(self, az_sum, el_sum, wavelength):
        _not_ported("SphereRCS")


@dataclasses.dataclass(frozen=True)
class PlateRCS:
    """Flat rectangular plate (physical optics)."""

    width: float = 1.0
    height: float = 1.0

    def rcs(self, az_sum, el_sum, wavelength):
        _not_ported("PlateRCS")


@dataclasses.dataclass(frozen=True)
class TableRCS:
    """Bilinear interpolation over a (bistatic half-angle) az/el table."""

    az_grid: tuple
    el_grid: tuple
    table: tuple

    def rcs(self, az_sum, el_sum, wavelength):
        _not_ported("TableRCS")
