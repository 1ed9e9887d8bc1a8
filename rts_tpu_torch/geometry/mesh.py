"""Triangle mesh container.

Host-side (NumPy, float64) representation produced by the generators and
consumed by the scene compiler.  Mirrors the (verts, tris, vert_normals)
triple the reference passes around (ray_tracer.cpp:950-953) including its
"rect quirk": when there are more normals than vertices the normals array
is *per-face*, indexed by primitive id instead of vertex id
(triangle_mesh.cu:177-180).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Mesh:
    verts: np.ndarray  # [V, 3] float64
    tris: np.ndarray  # [T, 3] int32 vertex indices
    normals: np.ndarray  # [V, 3] per-vertex OR [T, 3] per-face (rect quirk)

    def __post_init__(self):
        self.verts = np.asarray(self.verts, dtype=np.float64)
        self.tris = np.asarray(self.tris, dtype=np.int32)
        self.normals = np.asarray(self.normals, dtype=np.float64)

    @property
    def num_tris(self) -> int:
        return int(self.tris.shape[0])

    @property
    def num_verts(self) -> int:
        return int(self.verts.shape[0])

    @property
    def face_normal_mode(self) -> bool:
        """True when normals are per-face (the reference's
        ``normals.size() > verts.size()`` test, triangle_mesh.cu:178)."""
        return self.normals.shape[0] > self.verts.shape[0]

    def corner_normals(self) -> np.ndarray:
        """Per-corner normals ``[T, 3, 3]`` — the engine-facing layout.

        For per-face meshes every corner carries the face normal, so
        barycentric interpolation degenerates to the face normal exactly
        as the reference special-case does (triangle_mesh.cu:178-180).
        """
        if self.face_normal_mode:
            return np.repeat(self.normals[:, None, :], 3, axis=1)
        return self.normals[self.tris]

    def translated(self, offset) -> "Mesh":
        """New mesh displaced by ``offset`` (ray_tracer.cpp:1010-1014)."""
        return Mesh(self.verts + np.asarray(offset, dtype=np.float64), self.tris, self.normals)
