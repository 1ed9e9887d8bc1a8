"""Antenna gain patterns (counterpart of ``rts_tpu.physics.antenna``).

The reference calls external ``GetGain(direction, rotation, wavelength)``
on transmitters and receivers (ray_tracer.cpp:1233-1235); the pattern
family lives in the absent SOARS/FERS layer (SURVEY.md §2.3).  Every model
is a callable

    gain(az, el, bore_az, bore_el, wavelength) -> linear gain

on tensors, with (az, el) the spherical angles of the evaluation direction
and (bore_az, bore_el) the antenna boresight; arguments broadcast.  A
Python number among them is taken in the dtype and on the device of the
tensor arguments, as JAX takes a weakly typed scalar.

``off_angle`` is the great-circle angle between direction and boresight.
"""

from __future__ import annotations

import dataclasses
import math

import torch


def _shape(x):
    return tuple(x.shape) if torch.is_tensor(x) else ()


def _tensors(*xs):
    """``xs`` as tensors: a Python number becomes a 0-d tensor of the dtype
    and device of the first tensor among them (float64 on the CPU if
    none is)."""
    like = next((x for x in xs if torch.is_tensor(x)), None)
    dtype = like.dtype if like is not None else torch.float64
    device = like.device if like is not None else "cpu"
    return tuple(x if torch.is_tensor(x) else torch.tensor(x, dtype=dtype, device=device) for x in xs)


def off_angle(az, el, bore_az, bore_el):
    """Great-circle angle between (az, el) and (bore_az, bore_el)."""
    az, el, bore_az, bore_el = _tensors(az, el, bore_az, bore_el)
    c = torch.cos(el) * torch.cos(bore_el) * torch.cos(az - bore_az) + torch.sin(el) * torch.sin(bore_el)
    return torch.arccos(torch.clamp(c, -1.0, 1.0))


def _wrap(a):
    """``a`` wrapped into [-pi, pi); ``%`` on tensors is floor-mod, as jnp's."""
    return (a + math.pi) % (2 * math.pi) - math.pi


def _sinc(x, eps):
    """sin(x)/x, 1 where |x| < eps."""
    small = torch.abs(x) < eps
    return torch.where(small, 1.0, torch.sin(x) / torch.where(small, 1.0, x))


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
        th = off_angle(az, el, bore_az, bore_el)
        return self.alpha * torch.abs(_sinc(self.beta * th, 1e-12)) ** self.gamma


@dataclasses.dataclass(frozen=True)
class GaussianAntenna:
    """G = exp(-(d_az^2 * az_scale + d_el^2 * el_scale)) (FERS 'gaussian')."""

    az_scale: float = 1.0
    el_scale: float = 1.0

    def gain(self, az, el, bore_az, bore_el, wavelength):
        az, el, bore_az, bore_el = _tensors(az, el, bore_az, bore_el)
        daz = _wrap(az - bore_az)
        dele = el - bore_el
        return torch.exp(-(daz**2 * self.az_scale + dele**2 * self.el_scale))


@dataclasses.dataclass(frozen=True)
class SquareHornAntenna:
    """Square aperture horn: G0 * sinc^2 of the projected angle, with
    G0 = 4*pi*d^2/lambda^2 (FERS 'squarehorn')."""

    dimension: float = 1.0  # aperture edge length [m]

    def gain(self, az, el, bore_az, bore_el, wavelength):
        th = off_angle(az, el, bore_az, bore_el)
        ge = 4.0 * math.pi * self.dimension**2 / wavelength**2
        x = math.pi * self.dimension / wavelength * torch.sin(th)
        return ge * _sinc(x, 1e-12) ** 2


def _j1(x):
    """Bessel J1 via the Abramowitz & Stegun 9.4 rational approximations
    (|err| < 1e-7 relative to scipy), as ``rts_tpu``."""
    ax = torch.abs(x)
    small = ax < 3.0
    t = (x / 3.0) ** 2
    p_small = x * (
        0.5
        + t
        * (
            -0.56249985
            + t * (0.21093573 + t * (-0.03954289 + t * (0.00443319 + t * (-0.00031761 + t * 0.00001109))))
        )
    )
    ax_safe = torch.where(small, 3.0, ax)
    u = 3.0 / ax_safe
    f1 = 0.79788456 + u * (
        0.00000156 + u * (0.01659667 + u * (0.00017105 + u * (-0.00249511 + u * (0.00113653 - u * 0.00020033))))
    )
    th = ax_safe - 2.35619449 + u * (
        0.12499612 + u * (0.00005650 + u * (-0.00637879 + u * (0.00074348 + u * (0.00079824 - u * 0.00029166))))
    )
    p_big = torch.sign(x) * f1 * torch.cos(th) / torch.sqrt(ax_safe)
    return torch.where(small, p_small, p_big)


@dataclasses.dataclass(frozen=True)
class ParabolicAntenna:
    """Circular parabolic dish: G = G0 * (2 J1(x)/x)^2,
    x = pi*d*sin(theta)/lambda, G0 = (pi*d/lambda)^2 (FERS 'parabolic')."""

    diameter: float = 1.0

    def gain(self, az, el, bore_az, bore_el, wavelength):
        th = off_angle(az, el, bore_az, bore_el)
        g0 = (math.pi * self.diameter / wavelength) ** 2
        x = math.pi * self.diameter * torch.sin(th) / wavelength
        safe = torch.abs(x) > 1e-8
        x_s = torch.where(safe, x, 1.0)
        pat = torch.where(safe, 2.0 * _j1(x_s) / x_s, 1.0)
        return g0 * pat**2


def interp(x, xp, fp):
    """``jnp.interp``: piecewise-linear through (xp, fp), clamped to fp[0]
    below xp[0] and fp[-1] above xp[-1]; xp increasing.  In x's dtype."""
    xp = torch.as_tensor(xp, dtype=x.dtype, device=x.device)
    fp = torch.as_tensor(fp, dtype=x.dtype, device=x.device)
    i = torch.clamp(torch.searchsorted(xp, x.contiguous(), right=True), 1, xp.numel() - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    dx0 = torch.abs(dx) <= torch.finfo(x.dtype).eps ** 2  # np.spacing(eps), as jnp.interp
    f = torch.where(dx0, fp[i - 1], fp[i - 1] + (delta / torch.where(dx0, 1.0, dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


@dataclasses.dataclass(frozen=True)
class TableAntenna:
    """Gain from a 1-D off-angle table (linear interpolation, clamped at
    the ends)."""

    angles: tuple  # increasing, radians, starting at 0
    gains: tuple

    def gain(self, az, el, bore_az, bore_el, wavelength):
        return interp(off_angle(az, el, bore_az, bore_el), self.angles, self.gains)
