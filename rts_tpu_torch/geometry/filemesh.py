"""File ("triangle soup") mesh loader — parity port of ray_tracer.cpp:429-504.

Format: one triangle per line, ``x y z, x y z, x y z,`` — vertex
coordinates in the vertices file and per-vertex normals in the normals
file.  Triangles are implicit: triangle ``i`` uses vertices ``3i..3i+2``
(ray_tracer.cpp:444-451).  Both vertices and normals are rotated by the
target's yaw/pitch/roll (ray_tracer.cpp:476,503).
"""

from __future__ import annotations

import numpy as np

from rts_tpu_torch.core.rotation import vertex_rotation
from rts_tpu_torch.geometry.mesh import Mesh


def _read_triplets(path: str) -> np.ndarray:
    with open(path, "r") as fh:
        text = fh.read()
    vals = np.array(text.replace(",", " ").split(), dtype=np.float64)
    if vals.size % 9 != 0:
        raise ValueError(f"{path}: expected 9 values per line (3 vertices), got {vals.size} total")
    return vals.reshape(-1, 3)


def file_mesh(v_file: str, n_file: str, yaw=0.0, pitch=0.0, roll=0.0, *, strict_parity: bool = True) -> Mesh:
    verts = _read_triplets(v_file)
    normals = _read_triplets(n_file)
    if normals.shape != verts.shape:
        raise ValueError("vertex and normal files disagree on triangle count")

    tris = np.arange(verts.shape[0], dtype=np.int32).reshape(-1, 3)

    verts = np.asarray(vertex_rotation(verts, yaw, pitch, roll, strict_parity=strict_parity), dtype=np.float64)
    normals = np.asarray(vertex_rotation(normals, yaw, pitch, roll, strict_parity=strict_parity), dtype=np.float64)
    return Mesh(verts=verts, tris=tris, normals=normals)


def write_mesh_files(mesh: Mesh, v_file: str, n_file: str) -> None:
    """Serialise a mesh into the reference's text format (testing helper).

    Expands indexed vertices/normals into per-triangle soup; per-face
    normal meshes write the face normal at all three corners.
    """
    corners = mesh.verts[mesh.tris]  # [T, 3, 3]
    normals = mesh.corner_normals()  # [T, 3, 3]
    for path, data in ((v_file, corners), (n_file, normals)):
        with open(path, "w") as fh:
            for row in data.reshape(-1, 9):
                fh.write(
                    "{:.17g} {:.17g} {:.17g}, {:.17g} {:.17g} {:.17g}, {:.17g} {:.17g} {:.17g},\n".format(*row)
                )
