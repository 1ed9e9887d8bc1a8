"""3-vector math on tensors (counterpart of ``rts_tpu.core.vec``).

The engine's batched vectors keep their components on the LEADING axis
([3, L], the ``*3c`` helpers) so every lane-indexed operation is
``x[..., idx]`` and neighbouring lanes sit on neighbouring addresses; the
other helpers work over the trailing axis (``[..., 3]``).  Each helper performs the same operations in the same order as
the JAX one, so results agree to rounding.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def dot3(a, b):
    """Dot product over the trailing axis (dotd3)."""
    return (a * b).sum(-1)


def mag_squared3(a):
    """Squared magnitude over the trailing axis (magsquared3)."""
    return (a * a).sum(-1)


def length3(a):
    """Euclidean length over the trailing axis (lengthd3)."""
    return torch.sqrt((a * a).sum(-1))


def dot3c(a, b):
    """Dot product over the leading component axis."""
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def length3c(a):
    return torch.sqrt(dot3c(a, a))


def normalize3c(a):
    """Unit vector over the leading component axis (exact norm, no eps)."""
    return a / length3c(a)[None]


def cross3c(a, b):
    """a x b over the leading component axis."""
    return torch.stack([
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    ])


def sph_to_cart(azi, ele):
    """Spherical (azimuth, elevation) to unit Cartesian, trailing axis
    (ray_tracer.cu:132-139): x = cos(azi)cos(ele), y = sin(azi)cos(ele),
    z = sin(ele)."""
    ce = torch.cos(ele)
    return torch.stack([torch.cos(azi) * ce, torch.sin(azi) * ce, torch.sin(ele)], dim=-1)


def cart_to_sph(v):
    """Cartesian to (azimuth, elevation) over the trailing axis
    (normal_shader.cu:117-124): azi = atan2(y, x), ele = atan2(z,
    hypot(x, y)); returns ``[..., 2]``."""
    azi = torch.atan2(v[..., 1], v[..., 0])
    ele = torch.atan2(v[..., 2], torch.sqrt(v[..., 0] ** 2 + v[..., 1] ** 2))
    return torch.stack([azi, ele], dim=-1)


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


def reflect3(i, n):
    """Specular reflection of ``i`` about ``n`` over the trailing axis, OptiX
    ``reflect`` (normal_shader.cu:296): ``r = i - 2 n (n . i)``."""
    return i - 2.0 * n * dot3(i, n)[..., None]


def refract3(i, n, ior):
    """Snell refraction with OptiX ``refract`` semantics over the trailing
    axis (normal_shader.cu:212).  ``ior`` is the index ratio n2/n1; a
    back-face ray (i . n > 0) flips the normal and uses ``eta = ior``,
    else ``eta = 1/ior``.  Returns ``(direction, ok)``: ``ok`` is False
    on total internal reflection, where the direction is zeros."""
    ior = torch.as_tensor(ior, dtype=i.dtype, device=i.device)
    ndotv = dot3(i, n)
    backface = ndotv > 0.0
    eta = torch.where(backface, ior, 1.0 / ior)
    nn = torch.where(backface[..., None], -n, n)
    neg_ndotv = torch.where(backface, -ndotv, ndotv)
    k = 1.0 - eta * eta * (1.0 - neg_ndotv * neg_ndotv)
    ok = k >= 0.0
    k_safe = torch.where(ok, k, 0.0)
    r = eta[..., None] * i - (eta * neg_ndotv + torch.sqrt(k_safe))[..., None] * nn
    r = torch.where(ok[..., None], normalize3(r), torch.zeros_like(r))
    return r, ok


def triangle_area(p1, p2, p3) -> float:
    """Heron's-formula triangle area of three host points (C2 host util,
    ray_tracer.cpp:104-116; the reference keeps it for a commented-out
    mesh statistic at :196)."""
    a = float(np.linalg.norm(np.subtract(p2, p1)))
    b = float(np.linalg.norm(np.subtract(p3, p2)))
    c = float(np.linalg.norm(np.subtract(p1, p3)))
    s = (a + b + c) / 2.0
    return float(np.sqrt(max(s * (s - a) * (s - b) * (s - c), 0.0)))


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

