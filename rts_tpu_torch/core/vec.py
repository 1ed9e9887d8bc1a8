"""3-vector math on components-major ``[3, ...]`` tensors.

Counterpart of ``rts_tpu.core.vec``'s lanes-last helpers: batched vectors
keep their components on the LEADING axis ([3, L]) so every lane-indexed
operation is ``x[..., idx]`` and neighbouring lanes sit on neighbouring
addresses.  Each helper performs the same operations in the same order as
the JAX one, so results agree to rounding.
"""

from __future__ import annotations

import math

import torch


def dot3c(a, b):
    """Dot product over the leading component axis."""
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def length3c(a):
    return torch.sqrt(dot3c(a, a))


def normalize3c(a):
    """Unit vector over the leading component axis (exact norm, no eps)."""
    return a / length3c(a)[None]


def sph_to_cart(azi, ele):
    """Spherical (azimuth, elevation) to unit Cartesian, trailing axis
    (ray_tracer.cu:132-139): x = cos(azi)cos(ele), y = sin(azi)cos(ele),
    z = sin(ele)."""
    ce = torch.cos(ele)
    return torch.stack([torch.cos(azi) * ce, torch.sin(azi) * ce, torch.sin(ele)], dim=-1)


def normalize3(a):
    """Unit vector over the trailing axis."""
    return a / torch.sqrt((a * a).sum(-1, keepdim=True))


def cross3(a, b):
    """a x b over the trailing axis, component by component."""
    return torch.stack(
        [
            a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
            a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
            a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
        ],
        dim=-1,
    )


def wrap_angle(angle):
    """Normalise an angle to (-pi, pi] like the while-loops at
    ray_tracer.cu:53-57 (the JAX package's closed form)."""
    two_pi = 2.0 * math.pi
    return angle - two_pi * torch.floor((angle + math.pi) / two_pi)


def angle_in_range(test, a, b):
    """Circular interval membership test (ray_tracer.cu:60-69): True iff
    ``test`` lies strictly between ``a`` and ``b`` going the short way
    around the circle."""
    a = wrap_angle(a - test)
    b = wrap_angle(b - test)
    return (a * b < 0.0) & ((a - b).abs() < math.pi)

