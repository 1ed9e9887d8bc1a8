"""Triangle clustering: the acceleration structure.

The reference outsources acceleration to OptiX's per-pulse BVH rebuild
(ray_tracer.cpp:1125-1130).  Pointer-chasing tree traversal is the wrong
shape for a vector machine, so the TPU design is a flat two-level scheme:

  1. HOST (once per topology): sort triangles along a Morton space-filling
     curve of their centroids and cut the order into fixed-size clusters
     of ``cluster_size`` triangles.  Spatially-local clusters -> tight
     AABBs.  This is a pure *permutation* — correctness never depends on
     it, only traversal efficiency does.
  2. DEVICE (per pulse): recompute cluster AABBs from the animated
     vertices (the "refit" analogue — no rebuild, ever) and run the
     clustered traversal kernel: each ray tile slab-tests every cluster
     AABB and only runs the Möller–Trumbore tile test where the test
     passes (rts_tpu_torch.ops.cluster_trace).

The host half is the NumPy code of ``rts_tpu.accel.cluster`` carried over
(the JAX package cannot be imported where there is no jax); its Morton
order is the NumPy path, which ``rts_tpu`` documents as bit-identical to
its native one.
"""

from __future__ import annotations

import numpy as np
import torch


def _expand_bits(v: np.ndarray) -> np.ndarray:
    """Spread the low 10 bits of v so consecutive bits are 3 apart
    (standard 30-bit Morton interleave)."""
    v = v.astype(np.uint64)
    v = (v * np.uint64(0x00010001)) & np.uint64(0xFF0000FF)
    v = (v * np.uint64(0x00000101)) & np.uint64(0x0F00F00F)
    v = (v * np.uint64(0x00000011)) & np.uint64(0xC30C30C3)
    v = (v * np.uint64(0x00000005)) & np.uint64(0x49249249)
    return v


def morton_order(tri_verts: np.ndarray, tri_target: np.ndarray | None = None) -> np.ndarray:
    """Permutation sorting triangles by the Morton code of their centroid.

    ``tri_verts``: [T, 3, 3].  Degenerate all-zero triangles (padding)
    sort wherever their centroid lands — harmless, they can never be hit.

    With ``tri_target``, triangles sort by (target id, Morton code) —
    TARGET-MAJOR.  Morton codes are computed on the BASE (unanimated)
    mesh, where every target's geometry sits at its model origin: a
    global sort interleaves co-located targets, so after per-pulse
    animation every cluster's AABB spans ALL targets (measured r6: each
    cluster of a 4-sphere scene stretched ~1700 m and 87% of ray tiles
    overlapped ~every supergroup, collapsing traversal into the scalar
    sweep).  Target-major keys keep clusters single-target (at most one
    straddling cluster per target boundary)."""
    c = tri_verts.mean(axis=1)  # [T, 3]
    lo = c.min(axis=0)
    span = c.max(axis=0) - lo
    span[span == 0] = 1.0
    q = np.clip(((c - lo) / span) * 1023.0, 0, 1023).astype(np.uint64)
    code = (_expand_bits(q[:, 0]) << np.uint64(2)) | (
        _expand_bits(q[:, 1]) << np.uint64(1)
    ) | _expand_bits(q[:, 2])
    perm = np.argsort(code, kind="stable").astype(np.int64)
    if tri_target is not None and np.unique(tri_target).size > 1:
        # a STABLE sort by target of the Morton-ordered permutation IS
        # the (target, morton) composite order
        perm = perm[np.argsort(tri_target[perm], kind="stable")]
    return perm


def cluster_reorder(scene, cluster_size: int = 256):
    """Reorder a SceneArrays into Morton-clustered layout, padding the
    triangle count to a multiple of ``cluster_size``.

    Returns a new SceneArrays (same dataclass) whose triangle arrays are
    permuted; per-target arrays are untouched.
    """
    from rts_tpu_torch.geometry.scene import SceneArrays

    t_real = scene.num_real_tris
    perm = morton_order(scene.tri_verts[:t_real], scene.tri_target[:t_real])
    tv = scene.tri_verts[:t_real][perm]
    tn = scene.tri_normals[:t_real][perm]
    tt = scene.tri_target[:t_real][perm]

    t_pad = -(-max(t_real, 1) // cluster_size) * cluster_size
    if t_pad > t_real:
        pad = t_pad - t_real
        tv = np.concatenate([tv, np.zeros((pad, 3, 3))], axis=0)
        tn = np.concatenate([tn, np.zeros((pad, 3, 3))], axis=0)
        tt = np.concatenate([tt, np.full(pad, -1, np.int32)], axis=0)

    return SceneArrays(
        tri_verts=np.ascontiguousarray(tv),
        tri_normals=np.ascontiguousarray(tn),
        tri_target=np.ascontiguousarray(tt),
        target_refl_coeff=scene.target_refl_coeff,
        target_refr_index=scene.target_refr_index,
        target_velocity=scene.target_velocity,
        num_real_tris=t_real,
    )


def cluster_aabbs(tri_p0, tri_e0, tri_e1, cluster_size: int, tri_target=None):
    """Per-cluster AABBs [C, 3] from the engine's edge representation
    ([T, 3] tensors): v0 = p0, v1 = p0 + e0, v2 = p0 - e1 (see
    engine.types.derive_tri_arrays).

    With ``tri_target``, padding triangles (target < 0, all-zero corners)
    are masked out so they cannot pull the trailing cluster's box to the
    origin, and all-padding clusters get the self-rejecting [+inf, +inf]
    sentinel (an inverted box would be un-inverted by the slab test's
    min/max — see ops/cluster_trace)."""
    t = tri_p0.shape[0]
    c = t // cluster_size
    v0 = tri_p0.reshape(c, cluster_size, 3)
    v1 = (tri_p0 + tri_e0).reshape(c, cluster_size, 3)
    v2 = (tri_p0 - tri_e1).reshape(c, cluster_size, 3)
    if tri_target is None:
        mn = torch.minimum(torch.minimum(v0.amin(1), v1.amin(1)), v2.amin(1))
        mx = torch.maximum(torch.maximum(v0.amax(1), v1.amax(1)), v2.amax(1))
        return mn, mx
    big = 3.0e38
    pad = (tri_target < 0).reshape(c, cluster_size, 1)
    lo = lambda v: torch.where(pad, big, v).amin(1)
    hi = lambda v: torch.where(pad, -big, v).amax(1)
    mn = torch.minimum(torch.minimum(lo(v0), lo(v1)), lo(v2))
    mx = torch.maximum(torch.maximum(hi(v0), hi(v1)), hi(v2))
    inv = mn > mx
    mn = torch.where(inv, float("inf"), mn)
    mx = torch.where(inv, float("inf"), mx)
    return mn, mx
