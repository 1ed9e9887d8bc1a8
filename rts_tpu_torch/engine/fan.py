"""Launch-fan generation (counterpart of ``rts_tpu.engine.fan``).

Vectorised equivalent of the per-thread direction computation in the ray
generation program (ray_tracer.cu:144-209): a Cartesian-interpolated
N x N x N grid between the beam-corner unit vectors, azimuth rotation
about z, then elevation rotation about the azimuth-rotated y axis using
the reversed-sine axis-angle matrix.  Ray order matches
``rayIndex = iz*N^2 + iy*N + ix`` (ray_tracer.cu:151).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from rts_tpu_torch.core.rotation import rot_axis_reversed, rot_z
from rts_tpu_torch.core.vec import normalize3, normalize3c, sph_to_cart


def _spread3(v):
    v = v.astype(np.uint64)
    v = (v * np.uint64(0x00010001)) & np.uint64(0xFF0000FF)
    v = (v * np.uint64(0x00000101)) & np.uint64(0x0F00F00F)
    v = (v * np.uint64(0x00000011)) & np.uint64(0xC30C30C3)
    v = (v * np.uint64(0x00000005)) & np.uint64(0x49249249)
    return v


def _spread2(v):
    v = v.astype(np.uint64)
    v = (v | (v << np.uint64(8))) & np.uint64(0x00FF00FF)
    v = (v | (v << np.uint64(4))) & np.uint64(0x0F0F0F0F)
    v = (v | (v << np.uint64(2))) & np.uint64(0x33333333)
    v = (v | (v << np.uint64(1))) & np.uint64(0x55555555)
    return v


@functools.lru_cache(maxsize=32)
def fan_tile_perm(num_rays: int, mode: str = "morton3") -> np.ndarray:
    """Tiling permutation of the N^3 fan indices (host NumPy).

    In the launch order (rayIndex = iz*N^2 + iy*N + ix) a ray tile is a
    long thin angular strip; in a Morton order it is a compact patch that
    overlaps fewer clusters.  ``trace_fan`` permutes the result back.
    ``morton3`` interleaves (iz, iy, ix); ``morton2`` interleaves (iz, iy),
    the two direction-bearing axes, with ix (the launch-range stretch)
    as the minor raster axis."""
    n = num_rays
    iz, iy, ix = np.meshgrid(np.arange(n), np.arange(n), np.arange(n), indexing="ij")
    if mode == "morton2":
        bits = max(int(np.ceil(np.log2(max(n, 2)))), 1)
        code = (
            ((_spread2(iz.ravel()) << np.uint64(1)) | _spread2(iy.ravel())) << np.uint64(bits)
        ) | ix.ravel().astype(np.uint64)
    else:
        code = (
            (_spread3(iz.ravel()) << np.uint64(2))
            | (_spread3(iy.ravel()) << np.uint64(1))
            | _spread3(ix.ravel())
        )
    return np.argsort(code, kind="stable")


def generate_fan_c(num_rays: int, tx_dir, tx_span, dtype=torch.float32, device="cuda"):
    """Primary ray directions [3, N^3] (components-major).

    ``tx_dir`` = (azimuth, elevation) boresight (floats or 0-d tensors);
    ``tx_span`` = (azimuth span, elevation span, launch range).  The
    directions are the unnormalised double3-analogue the tracer
    propagates (ray_tracer.cu:203).  The rotations are applied as explicit
    component products, in the same order as the JAX code.  The fan is
    built on ``device``, the card unless the caller asks for another.
    """
    as_t = lambda x: torch.as_tensor(x, dtype=dtype, device=device)
    az = as_t(tx_dir[0])
    el = as_t(tx_dir[1])
    n = num_rays

    if n == 1:
        return sph_to_cart(az, el)[:, None]

    az_span = as_t(tx_span[0])
    el_span = as_t(tx_span[1])
    launch_range = as_t(tx_span[2])

    beam_start = sph_to_cart(-az_span / 2, -el_span / 2)
    beam_end = sph_to_cart(az_span / 2, el_span / 2)

    idx = torch.arange(n, dtype=dtype, device=device)
    dx = beam_start[0] + ((beam_end[0] * (1 + launch_range)) - beam_start[0]) / (n - 1) * idx
    dy = beam_start[1] + (beam_end[1] - beam_start[1]) / (n - 1) * idx
    dz = beam_start[2] + (beam_end[2] - beam_start[2]) / (n - 1) * idx

    d = torch.stack(
        torch.broadcast_tensors(dx[None, None, :], dy[None, :, None], dz[:, None, None]),
        dim=0,
    ).reshape(3, -1)
    d = normalize3c(d)

    def rot_c(m, v):  # [3,3] @ [3, L] as explicit component products
        return torch.stack(
            [
                m[0, 0] * v[0] + m[0, 1] * v[1] + m[0, 2] * v[2],
                m[1, 0] * v[0] + m[1, 1] * v[1] + m[1, 2] * v[2],
                m[2, 0] * v[0] + m[2, 1] * v[1] + m[2, 2] * v[2],
            ],
            dim=0,
        )

    rz = rot_z(az, xp=torch)
    d = normalize3c(rot_c(rz, d))
    orth = normalize3(rz[:, 1])
    r1 = rot_axis_reversed(orth, el, xp=torch)
    return rot_c(r1, d)  # not renormalised (ray_tracer.cu:203)


def generate_fan(num_rays: int, tx_dir, tx_span, dtype=torch.float32, device="cuda"):
    """Primary ray directions [N^3, 3] (row layout, for host code; the
    engine reads ``generate_fan_c``)."""
    return generate_fan_c(num_rays, tx_dir, tx_span, dtype=dtype, device=device).T
