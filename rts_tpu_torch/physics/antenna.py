"""Antenna gain patterns (counterpart of ``rts_tpu.physics.antenna``).

Every model is a callable

    gain(az, el, bore_az, bore_el, wavelength) -> linear gain

on tensors, with (az, el) the spherical angles of the evaluation direction
and (bore_az, bore_el) the antenna boresight; arguments broadcast.

Only ``IsotropicAntenna`` — the model of the production scenes — has a
torch ``gain`` yet.  The other models keep their classes and parameters
(so a World describes the same scene in both packages) and raise until
they are ported (ROADMAP A.8).
"""

from __future__ import annotations

import dataclasses

import torch


def _not_ported(name: str):
    raise NotImplementedError(
        f"{name}.gain is not ported to rts_tpu_torch yet (ROADMAP A.8); "
        "use IsotropicAntenna or the JAX package"
    )


def _shape(x):
    return tuple(x.shape) if torch.is_tensor(x) else ()


@dataclasses.dataclass(frozen=True)
class IsotropicAntenna:
    def gain(self, az, el, bore_az, bore_el, wavelength):
        return torch.ones(
            torch.broadcast_shapes(_shape(az), _shape(bore_az)),
            dtype=az.dtype, device=az.device,
        )


@dataclasses.dataclass(frozen=True)
class SincAntenna:
    """G(theta) = alpha * |sinc(beta * theta)|^gamma (FERS 'sinc')."""

    alpha: float = 1.0
    beta: float = 1.0
    gamma: float = 2.0

    def gain(self, az, el, bore_az, bore_el, wavelength):
        _not_ported("SincAntenna")


@dataclasses.dataclass(frozen=True)
class GaussianAntenna:
    """G = exp(-(d_az^2 * az_scale + d_el^2 * el_scale)) (FERS 'gaussian')."""

    az_scale: float = 1.0
    el_scale: float = 1.0

    def gain(self, az, el, bore_az, bore_el, wavelength):
        _not_ported("GaussianAntenna")


@dataclasses.dataclass(frozen=True)
class SquareHornAntenna:
    """Square aperture horn, G0 = 4*pi*d^2/lambda^2 (FERS 'squarehorn')."""

    dimension: float = 1.0

    def gain(self, az, el, bore_az, bore_el, wavelength):
        _not_ported("SquareHornAntenna")


@dataclasses.dataclass(frozen=True)
class ParabolicAntenna:
    """Circular parabolic dish, G = G0 * (2 J1(x)/x)^2 (FERS 'parabolic')."""

    diameter: float = 1.0

    def gain(self, az, el, bore_az, bore_el, wavelength):
        _not_ported("ParabolicAntenna")


@dataclasses.dataclass(frozen=True)
class TableAntenna:
    """Gain from a 1-D off-angle table (linear interpolation)."""

    angles: tuple
    gains: tuple

    def gain(self, az, el, bore_az, bore_el, wavelength):
        _not_ported("TableAntenna")
