"""Icosphere mesh generator — vectorised parity port of ray_tracer.cpp:300-426.

The reference subdivides an icosahedron face-by-face, appending (duplicate)
midpoint vertices, then deduplicates with a ``std::set`` (exact double
equality, lexicographic order) and remaps faces.  We vectorise each
subdivision generation with NumPy but keep the exact same vertex ordering
and arithmetic so the resulting mesh is bit-identical: midpoints of a
shared edge are computed as (a+b)/2 in the same operand order or the
commutative-equal one, so exact-equality dedup behaves identically, and
``np.unique(axis=0)`` reproduces the set's lexicographic ordering.
"""

from __future__ import annotations

import numpy as np

from rts_tpu_torch.core.rotation import vertex_rotation
from rts_tpu_torch.geometry.mesh import Mesh

_ICO_FACES = np.array(
    [
        [0, 11, 5],
        [0, 5, 1],
        [0, 1, 7],
        [0, 7, 10],
        [0, 10, 11],
        [1, 5, 9],
        [5, 11, 4],
        [11, 10, 2],
        [10, 7, 6],
        [7, 1, 8],
        [3, 9, 4],
        [3, 4, 2],
        [3, 2, 6],
        [3, 6, 8],
        [3, 8, 9],
        [4, 9, 5],
        [2, 4, 11],
        [6, 2, 10],
        [8, 6, 7],
        [9, 8, 1],
    ],
    dtype=np.int64,
)


def _ico_vertices() -> np.ndarray:
    t = (1.0 + np.sqrt(5.0)) / 2.0
    v = np.array(
        [
            [-1, t, 0],
            [1, t, 0],
            [-1, -t, 0],
            [1, -t, 0],
            [0, -1, t],
            [0, 1, t],
            [0, -1, -t],
            [0, 1, -t],
            [t, 0, -1],
            [t, 0, 1],
            [-t, 0, -1],
            [-t, 0, 1],
        ],
        dtype=np.float64,
    )
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def sphere_mesh(
    subdivs: int,
    radius: float,
    yaw=0.0,
    pitch=0.0,
    roll=0.0,
    *,
    strict_parity: bool = True,
):
    """Icosphere with ``20 * 4**subdivs`` faces, scaled by ``radius``.

    Returns ``(mesh, num_triangles)`` where ``num_triangles`` mirrors the
    reference's out-parameter (face count *before* face dedup,
    ray_tracer.cpp:394).  Vertex normals are the rotated unit vertices
    (ray_tracer.cpp:409) — radius scaling happens after and does not touch
    them (ray_tracer.cpp:421-425).
    """
    v = _ico_vertices()
    f = _ICO_FACES.copy()

    for _ in range(subdivs):
        tri = v[f]  # [F, 3(corner), 3(xyz)]
        # Midpoints in the reference's append order: (t0,t1), (t1,t2), (t2,t0)
        # per face, faces in order (ray_tracer.cpp:364-370).
        mids = np.stack(
            [
                (tri[:, 0] + tri[:, 1]) / 2.0,
                (tri[:, 1] + tri[:, 2]) / 2.0,
                (tri[:, 2] + tri[:, 0]) / 2.0,
            ],
            axis=1,
        )  # [F, 3, 3]
        mids = mids / np.linalg.norm(mids, axis=-1, keepdims=True)

        base = v.shape[0]
        idx = base + 3 * np.arange(f.shape[0], dtype=np.int64)
        a, b, c = idx, idx + 1, idx + 2

        # Subdivision faces in the reference's order (ray_tracer.cpp:373-378).
        f_new = np.empty((f.shape[0] * 4, 3), dtype=np.int64)
        f_new[0::4] = np.stack([f[:, 0], a, c], axis=1)
        f_new[1::4] = np.stack([f[:, 1], b, a], axis=1)
        f_new[2::4] = np.stack([f[:, 2], c, b], axis=1)
        f_new[3::4] = np.stack([a, b, c], axis=1)

        v = np.concatenate([v, mids.reshape(-1, 3)], axis=0)
        f = f_new

    num_triangles = int(f.shape[0])

    # Exact-equality dedup with lexicographic ordering = std::set semantics
    # (ray_tracer.cpp:397-403).
    verts_unique, ix = np.unique(v, axis=0, return_inverse=True)

    verts = np.asarray(
        vertex_rotation(verts_unique, yaw, pitch, roll, strict_parity=strict_parity),
        dtype=np.float64,
    )
    vert_normals = verts.copy()

    f = ix[f]
    f = np.unique(f, axis=0)  # sorted unique rows = std::set on faces (:417-418)

    if strict_parity:
        radius = np.float64(np.float32(radius))
    verts = verts * radius

    return Mesh(verts=verts, tris=f.astype(np.int32), normals=vert_normals), num_triangles
