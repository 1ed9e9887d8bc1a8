"""Scene compiler: per-target meshes -> flat, device-ready arrays.

The reference keeps one OptiX geometry instance per target, each with its
own vertex/normal buffers and material variables (ray_tracer.cpp:1017-1117).
The device layout is a single flat triangle soup in device memory:

  * ``tri_verts``   [T, 3, 3]  corner positions (gathered, not indexed —
                               the engine streams triangles, and corner
                               gathering on-device would randomize memory
                               access; T is padded to ``pad_to``)
  * ``tri_normals`` [T, 3, 3]  corner normals (per-face meshes repeat the
                               face normal at all corners, reproducing the
                               rect special case of triangle_mesh.cu:178)
  * ``tri_target``  [T]        owning target id (-1 for padding)
  * per-target material/motion arrays [NT]

Padding triangles have all-zero corners: the Möller–Trumbore denominator
is 0 there, every comparison fails, and they can never be hit.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from rts_tpu_torch.geometry.mesh import Mesh


@dataclasses.dataclass
class SceneArrays:
    """Flat scene ready for upload.  NumPy on host; the engine converts to
    device tensors (possibly downcast) in ``engine.animate.scene_base``."""

    tri_verts: np.ndarray  # [T, 3, 3] float64
    tri_normals: np.ndarray  # [T, 3, 3] float64
    tri_target: np.ndarray  # [T] int32, -1 = padding
    target_refl_coeff: np.ndarray  # [NT] float64 (normal_shader.cu d_targReflCoeff)
    target_refr_index: np.ndarray  # [NT] float64 (d_targRefrIndex)
    target_velocity: np.ndarray  # [NT, 3] float64 (dbuf_targ_vel)
    num_real_tris: int

    @property
    def num_tris(self) -> int:
        return int(self.tri_verts.shape[0])

    @property
    def num_targets(self) -> int:
        return int(self.target_refl_coeff.shape[0])


def compile_scene(
    meshes: Sequence[Mesh],
    refl_coeffs: Sequence[float],
    refr_indices: Sequence[float],
    velocities: Sequence[np.ndarray] | None = None,
    *,
    pad_to: int = 1,
) -> SceneArrays:
    """Flatten per-target meshes into one triangle soup.

    ``pad_to`` rounds the triangle count up (e.g. to the engine tile size)
    with unhittable degenerate triangles.
    """
    nt = len(meshes)
    if velocities is None:
        velocities = [np.zeros(3)] * nt
    # Target-less scenes (direct Tx->Rx only) still need one dummy row so
    # device-side per-target gathers have a valid (never-hit) index.
    if nt == 0:
        return SceneArrays(
            tri_verts=np.zeros((pad_to, 3, 3)),
            tri_normals=np.zeros((pad_to, 3, 3)),
            tri_target=np.full(pad_to, -1, np.int32),
            target_refl_coeff=np.zeros(1),
            target_refr_index=np.ones(1),
            target_velocity=np.zeros((1, 3)),
            num_real_tris=0,
        )

    verts_list, norms_list, tgt_list = [], [], []
    for i, mesh in enumerate(meshes):
        verts_list.append(mesh.verts[mesh.tris])  # [Ti, 3, 3]
        norms_list.append(mesh.corner_normals())
        tgt_list.append(np.full(mesh.num_tris, i, dtype=np.int32))

    tri_verts = np.concatenate(verts_list, axis=0) if verts_list else np.zeros((0, 3, 3))
    tri_normals = np.concatenate(norms_list, axis=0) if norms_list else np.zeros((0, 3, 3))
    tri_target = np.concatenate(tgt_list, axis=0) if tgt_list else np.zeros((0,), np.int32)

    t_real = tri_verts.shape[0]
    t_pad = ((t_real + pad_to - 1) // pad_to) * pad_to if t_real else pad_to
    if t_pad > t_real:
        pad = t_pad - t_real
        tri_verts = np.concatenate([tri_verts, np.zeros((pad, 3, 3))], axis=0)
        tri_normals = np.concatenate([tri_normals, np.zeros((pad, 3, 3))], axis=0)
        tri_target = np.concatenate([tri_target, np.full(pad, -1, np.int32)], axis=0)

    return SceneArrays(
        tri_verts=np.ascontiguousarray(tri_verts, dtype=np.float64),
        tri_normals=np.ascontiguousarray(tri_normals, dtype=np.float64),
        tri_target=tri_target,
        target_refl_coeff=np.asarray(refl_coeffs, dtype=np.float64),
        target_refr_index=np.asarray(refr_indices, dtype=np.float64),
        target_velocity=np.asarray(velocities, dtype=np.float64).reshape(nt, 3),
        num_real_tris=t_real,
    )
