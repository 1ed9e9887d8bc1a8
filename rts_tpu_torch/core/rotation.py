"""Rotation matrices and vertex rotation.

Equivalent of the host helpers at ray_tracer.cpp:119-170 plus the ray-fan
boresight rotations at ray_tracer.cu:172-203.

Every function takes an ``xp`` array-module argument so the same math runs
as NumPy on the host (mesh preparation, float64) and as ``torch`` on
device tensors (the per-pulse fan rotation, engine/fan.py).
"""

from __future__ import annotations

import numpy as np


def rot_zyx(yaw, pitch, roll, xp=np):
    """Combined rotation matrix R = Rz(yaw) @ Ry(pitch) @ Rx(roll).

    Matches ``vertex_rotation`` (ray_tracer.cpp:156-162): anti-clockwise
    looking down each axis, applied in Rz*Ry*Rx order.
    """
    cy, sy = xp.cos(yaw), xp.sin(yaw)
    cp, sp = xp.cos(pitch), xp.sin(pitch)
    cr, sr = xp.cos(roll), xp.sin(roll)
    zero = xp.zeros_like(cy)
    one = xp.ones_like(cy)
    rx = xp.stack(
        [
            xp.stack([one, zero, zero], -1),
            xp.stack([zero, cr, -sr], -1),
            xp.stack([zero, sr, cr], -1),
        ],
        -2,
    )
    ry = xp.stack(
        [
            xp.stack([cp, zero, sp], -1),
            xp.stack([zero, one, zero], -1),
            xp.stack([-sp, zero, cp], -1),
        ],
        -2,
    )
    rz = xp.stack(
        [
            xp.stack([cy, -sy, zero], -1),
            xp.stack([sy, cy, zero], -1),
            xp.stack([zero, zero, one], -1),
        ],
        -2,
    )
    return rz @ ry @ rx


def rotate_points(points, rot, xp=np):
    """Rotate ``[..., N, 3]`` points by ``[..., 3, 3]`` matrix ``rot``.

    Equals the reference's transpose(R @ transpose(V)) dance at
    ray_tracer.cpp:166, i.e. ``V @ R^T``.
    """
    return points @ xp.swapaxes(rot, -1, -2)


def vertex_rotation(vertices, yaw, pitch, roll, *, strict_parity: bool = True, xp=np):
    """Rotate vertices (or unit normals) by yaw/pitch/roll.

    With ``strict_parity`` the angles are first rounded to float32 exactly
    like the ``float`` parameters of ray_tracer.cpp:156, then the trig and
    matmuls run in float64 (matching the reference's double math on
    float-narrowed angles).
    """
    if strict_parity:
        yaw = np.float64(np.float32(yaw))
        pitch = np.float64(np.float32(pitch))
        roll = np.float64(np.float32(roll))
    rot = rot_zyx(
        xp.asarray(yaw, dtype=vertices.dtype),
        xp.asarray(pitch, dtype=vertices.dtype),
        xp.asarray(roll, dtype=vertices.dtype),
        xp=xp,
    )
    return rotate_points(vertices, rot, xp=xp)


def rot_z(angle, xp=np):
    """Rotation about the z axis (right-hand rule), ray_tracer.cu:173-175."""
    c, s = xp.cos(angle), xp.sin(angle)
    zero = xp.zeros_like(c)
    one = xp.ones_like(c)
    return xp.stack(
        [
            xp.stack([c, -s, zero], -1),
            xp.stack([s, c, zero], -1),
            xp.stack([zero, zero, one], -1),
        ],
        -2,
    )


def rot_axis_reversed(axis, angle, xp=np):
    """Rotation about an arbitrary unit ``axis`` with the *reversed* sine
    signs used for the Tx elevation rotation (ray_tracer.cu:192-196).

    The reference flips the sign of every sin term of the standard
    axis-angle (Rodrigues) matrix so that positive elevation tips the beam
    the way RTS expects; we reproduce that exactly.
    """
    c, s = xp.cos(angle), xp.sin(angle)
    x, y, z = axis[..., 0], axis[..., 1], axis[..., 2]
    oc = 1.0 - c
    return xp.stack(
        [
            xp.stack([c + x * x * oc, x * y * oc + z * s, x * z * oc - y * s], -1),
            xp.stack([y * x * oc - z * s, c + y * y * oc, y * z * oc + x * s], -1),
            xp.stack([z * x * oc + y * s, z * y * oc - x * s, c + z * z * oc], -1),
        ],
        -2,
    )
