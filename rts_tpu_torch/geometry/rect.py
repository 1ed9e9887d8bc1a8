"""Box ("rect") mesh generator — parity port of ray_tracer.cpp:226-297."""

from __future__ import annotations

import numpy as np

from rts_tpu_torch.core.rotation import vertex_rotation
from rts_tpu_torch.geometry.mesh import Mesh

# Triangle winding exactly as ray_tracer.cpp:249-260.
_RECT_TRIS = np.array(
    [
        [0, 1, 2],
        [1, 3, 2],
        [2, 3, 7],
        [2, 7, 6],
        [1, 7, 3],
        [1, 5, 7],
        [6, 7, 4],
        [7, 5, 4],
        [0, 4, 1],
        [1, 4, 5],
        [2, 6, 4],
        [0, 2, 4],
    ],
    dtype=np.int32,
)

# Corner signs for the 8 vertices (ray_tracer.cpp:235-242).
_RECT_SIGNS = np.array(
    [
        [+1, -1, -1],
        [+1, +1, -1],
        [+1, -1, +1],
        [+1, +1, +1],
        [-1, -1, -1],
        [-1, +1, -1],
        [-1, -1, +1],
        [-1, +1, +1],
    ],
    dtype=np.float64,
)


def rect_mesh(w, h, d, yaw=0.0, pitch=0.0, roll=0.0, *, strict_parity: bool = True) -> Mesh:
    """Axis-aligned box of extents (w, h, d), rotated by yaw/pitch/roll.

    Returns a per-face-normal mesh (12 normals > 8 verts — the rect quirk
    the intersector keys off, triangle_mesh.cu:178).  Face normals are
    computed from the *rotated* vertices, as in the reference
    (ray_tracer.cpp:263-296).

    With ``strict_parity`` the half-extents are computed in float32
    (``w*+0.5f`` on float parameters, ray_tracer.cpp:235-242).
    """
    if strict_parity:
        half = np.array(
            [np.float32(w) * np.float32(0.5), np.float32(h) * np.float32(0.5), np.float32(d) * np.float32(0.5)],
            dtype=np.float32,
        ).astype(np.float64)
    else:
        half = np.array([w, h, d], dtype=np.float64) * 0.5

    verts = _RECT_SIGNS * half
    verts = np.asarray(vertex_rotation(verts, yaw, pitch, roll, strict_parity=strict_parity), dtype=np.float64)

    # Face normals from the rotated vertices.
    p0 = verts[_RECT_TRIS[:, 0]]
    v1 = verts[_RECT_TRIS[:, 1]] - p0
    v2 = verts[_RECT_TRIS[:, 2]] - p0
    fn = np.cross(v1, v2)
    fn /= np.linalg.norm(fn, axis=-1, keepdims=True)

    return Mesh(verts=verts, tris=_RECT_TRIS.copy(), normals=fn)
