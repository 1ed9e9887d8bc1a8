"""Terrain heightfield mesh (framework extension).

The reference ships only rect/sphere/file generators
(ray_tracer.cpp:226-504); BASELINE config 4 benchmarks a >=1M-triangle
terrain with per-frame refit and occlusion, so the framework provides a
native heightfield generator: an (n x n) vertex grid over a square
extent, z = height(x, y), triangulated into 2(n-1)^2 triangles with
smooth per-vertex normals from the analytic central-difference gradient.
"""

from __future__ import annotations

import numpy as np

from rts_tpu_torch.core.rotation import vertex_rotation
from rts_tpu_torch.geometry.mesh import Mesh


def fractal_heights(n: int, *, seed: int = 0, octaves: int = 6, roughness: float = 0.55):
    """Diamond-square-style fractal heights in [0, 1], [n, n]."""
    rng = np.random.default_rng(seed)
    h = np.zeros((n, n))
    amp = 1.0
    for o in range(octaves):
        k = min(n, 2 ** (o + 2))
        coarse = rng.standard_normal((k, k))
        # bilinear upsample to n x n
        xi = np.linspace(0, k - 1, n)
        x0 = np.clip(xi.astype(int), 0, k - 2)
        fx = xi - x0
        rows = coarse[x0][:, x0] * (1 - fx)[None, :] + coarse[x0][:, x0 + 1] * fx[None, :]
        rows2 = coarse[x0 + 1][:, x0] * (1 - fx)[None, :] + coarse[x0 + 1][:, x0 + 1] * fx[None, :]
        h += amp * (rows * (1 - fx)[:, None] + rows2 * fx[:, None])
        amp *= roughness
    h -= h.min()
    peak = h.max()
    return h / peak if peak > 0 else h


def terrain_mesh(
    n: int,
    extent: float,
    peak_height: float,
    *,
    heights: np.ndarray | None = None,
    seed: int = 0,
    yaw: float = 0.0,
    pitch: float = 0.0,
    roll: float = 0.0,
    strict_parity: bool = True,
) -> Mesh:
    """Heightfield mesh: n x n vertices over [−extent/2, extent/2]^2 in
    the x-y plane, z = peak_height * heights.  2(n-1)^2 triangles.

    ``heights``: optional [n, n] array in [0, 1]; fractal noise otherwise.
    Rotation semantics match the reference generators (t=0 attitude,
    float-narrowed angles under ``strict_parity``).
    """
    if n < 2:
        raise ValueError("terrain needs n >= 2")
    if heights is None:
        heights = fractal_heights(n, seed=seed)
    heights = np.asarray(heights, np.float64)
    if heights.shape != (n, n):
        raise ValueError(f"heights must be [{n}, {n}]")

    xs = np.linspace(-extent / 2, extent / 2, n)
    xv, yv = np.meshgrid(xs, xs, indexing="ij")
    zv = peak_height * heights
    verts = np.stack([xv, yv, zv], axis=-1).reshape(-1, 3)

    # smooth normals from the central-difference gradient of z(x, y)
    step = extent / (n - 1)
    gx = np.gradient(zv, step, axis=0)
    gy = np.gradient(zv, step, axis=1)
    normals = np.stack([-gx, -gy, np.ones_like(zv)], axis=-1).reshape(-1, 3)
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)

    # two triangles per cell, CCW seen from +z
    i = np.arange(n - 1)
    ii, jj = np.meshgrid(i, i, indexing="ij")
    v00 = (ii * n + jj).ravel()
    v10 = ((ii + 1) * n + jj).ravel()
    v01 = (ii * n + jj + 1).ravel()
    v11 = ((ii + 1) * n + jj + 1).ravel()
    tris = np.concatenate(
        [np.stack([v00, v10, v11], axis=1), np.stack([v00, v11, v01], axis=1)], axis=0
    ).astype(np.int32)

    if yaw or pitch or roll:
        verts = vertex_rotation(verts, yaw, pitch, roll, strict_parity=strict_parity)
        normals = vertex_rotation(normals, yaw, pitch, roll, strict_parity=strict_parity)

    return Mesh(verts, tris, normals)
