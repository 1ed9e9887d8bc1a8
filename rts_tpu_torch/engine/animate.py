"""Per-pulse scene animation: static base mesh + per-pulse rigid transforms
(counterpart of ``rts_tpu.engine.animate``).

The reference rebuilds every target mesh on the host each pulse and marks
the BVH dirty (ray_tracer.cpp:936-1146, 1125-1130).  Here the scene is
compiled ONCE (topology and t=0-rotated geometry are time-invariant) and
the per-pulse rigid transform (rotation + translation) is applied to the
triangle soup on the device: for the clustered path straight into the
traversal kernel's packed [16, T] field layout, with the cluster boxes
refitted from per-cluster base boxes (``animate_packed``); for the
brute-force path into a ``DeviceScene`` whose intersection vectors are
re-derived from the moved corners (``animate_scene``).

Transform semantics match the reference: the base mesh already carries
the t=0 attitude; a rotating target gets the extra R(yaw,pitch,roll at t)
applied ON TOP (composite, ray_tracer.cpp:993-1007), then the centre
translation (:1010-1014).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from rts_tpu_torch.engine.types import DeviceScene, derive_tri_arrays
from rts_tpu_torch.geometry.scene import SceneArrays


class SceneBase(NamedTuple):
    """Time-invariant scene: target-frame triangle soup + materials.

    ``tri_verts_t`` is the [9, T] corner-component layout (row =
    corner*3 + axis) the packed animation reads component by component.
    """

    tri_verts: torch.Tensor  # [T, 3, 3] corner positions (t=0 attitude, origin-centred)
    tri_verts_t: torch.Tensor  # [9, T] same data, component-major
    tri_corner_normals: torch.Tensor  # [T, 3, 3] (t=0 attitude — rotated per hit)
    tri_target: torch.Tensor  # [T] int32, -1 padding
    # Hit-shading table [T, 10]: cols 0-8 the corner normals, col 9 the
    # target id as a float (exact: |NT| << 2^23).
    shade_pack: torch.Tensor
    target_refl: torch.Tensor  # [NT]
    target_refr: torch.Tensor  # [NT]
    # Per-cluster, per-target BASE AABBs ([C, NT, 3] + validity [C, NT])
    # for the O(C*NT) corner-transform refit; None unless built with a
    # ``cluster_size`` (the clustered engine).
    cl_mn: torch.Tensor | None = None
    cl_mx: torch.Tensor | None = None
    cl_valid: torch.Tensor | None = None
    # float64 copies for the precision replay (engine/replay.py); None
    # unless built with ``with_f64=True``.  The JAX package keeps f32
    # residuals (``*_lo``) here for its double-single replay instead.
    tri_verts_f64: torch.Tensor | None = None  # [T, 3, 3]
    tri_corner_normals_f64: torch.Tensor | None = None  # [T, 3, 3]
    target_refl_f64: torch.Tensor | None = None  # [NT]
    target_refr_f64: torch.Tensor | None = None  # [NT]

    @property
    def num_targets(self) -> int:
        return int(self.target_refl.shape[0])


def scene_base(
    scene: SceneArrays, cluster_size: int = 0, dtype=torch.float32, device="cuda",
    with_f64: bool = False,
) -> SceneBase:
    """Upload a scene to ``device`` (the card unless the caller asks for
    another); with a ``cluster_size`` (a cluster-reordered scene, the
    clustered engine) also build its per-cluster, per-target base boxes
    (host NumPy, as in the JAX package); with ``with_f64`` also the
    float64 copies the replay reads."""
    tv = np.asarray(scene.tri_verts)
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    f = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)
    extra = {}
    if cluster_size:
        # base boxes over the SAME dtype-rounded vertices the per-pulse pack
        # transform consumes, so the corner refit stays conservative
        tv_r = tv.astype(np_dtype).astype(np.float64)  # [T, 3, 3]
        tt = np.asarray(scene.tri_target)
        nt = max(len(scene.target_refl_coeff), 1)
        c = tv.shape[0] // cluster_size
        pts = tv_r.reshape(c, cluster_size, 3, 3)
        tid = tt.reshape(c, cluster_size)
        mn = np.full((c, nt, 3), np.inf)
        mx = np.full((c, nt, 3), -np.inf)
        valid = np.zeros((c, nt), bool)
        for j in range(nt):
            m = (tid == j)[..., None, None]  # [c, cs, 1, 1]
            mn[:, j] = np.where(m, pts, np.inf).min(axis=(1, 2))
            mx[:, j] = np.where(m, pts, -np.inf).max(axis=(1, 2))
            valid[:, j] = (tid == j).any(axis=1)
        extra = dict(cl_mn=f(mn), cl_mx=f(mx), cl_valid=torch.as_tensor(valid, device=device))
    if with_f64:
        d = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float64), device=device)
        extra.update(tri_verts_f64=d(tv), tri_corner_normals_f64=d(scene.tri_normals),
                     target_refl_f64=d(scene.target_refl_coeff), target_refr_f64=d(scene.target_refr_index))
    nrm = np.asarray(scene.tri_normals, np_dtype).reshape(-1, 9)
    shade = np.concatenate([nrm, np.asarray(scene.tri_target, np_dtype)[:, None]], axis=1)
    return SceneBase(
        tri_verts=f(tv),
        tri_verts_t=f(tv.reshape(-1, 9).T),
        tri_corner_normals=f(scene.tri_normals),
        tri_target=torch.as_tensor(scene.tri_target, dtype=torch.int32, device=device),
        shade_pack=f(shade),
        target_refl=f(scene.target_refl_coeff),
        target_refr=f(scene.target_refr_index),
        **extra,
    )


def animate_scene(
    base: SceneBase,
    rot: torch.Tensor,  # [NT, 3, 3] extra attitude rotation at pulse time
    pos: torch.Tensor,  # [NT, 3] target centres at pulse time
    vel: torch.Tensor,  # [NT, 3] finite-difference velocities
) -> DeviceScene:
    """Rigid-transform the soup and re-derive the intersection vectors
    (the brute-force path).  Padding triangles (target -1) stay all-zero
    and unhittable.  The JAX ``einsum``s are written out as three products
    and two adds per component, left to right."""
    nt = base.target_refl.shape[0]
    tid = base.tri_target.clamp(0, nt - 1).long()
    r = rot[tid][:, None]  # [T, 1, 3, 3]
    shift = torch.where((base.tri_target >= 0)[:, None], pos[tid], 0.0)
    verts = torch.stack([_dot3_rows(r, i, base.tri_verts) for i in range(3)], dim=-1)
    verts = verts + shift[:, None, :]
    normals = torch.stack([_dot3_rows(r, i, base.tri_corner_normals) for i in range(3)], dim=-1)
    p0, e0, e1, n, c1, c0, np0 = derive_tri_arrays(verts)
    return DeviceScene(
        tri_p0=p0,
        tri_e0=e0,
        tri_e1=e1,
        tri_n=n,
        tri_c1=c1,
        tri_c0=c0,
        tri_np0=np0,
        tri_corner_normals=normals,
        tri_target=base.tri_target,
        target_refl=base.target_refl,
        target_refr=base.target_refr,
        target_vel=vel,
    )


class ClusterScene(NamedTuple):
    """Per-pulse scene in the clustered engine's layout.

    Traversal reads the packed [16, T] field matrix and cluster AABBs;
    shading rotates gathered base normals by the per-target attitude at
    hit time (O(lanes), not O(T): rotation commutes with barycentric
    interpolation).
    """

    tri_pack: torch.Tensor  # [16, T] rows: n(3) c1(3) c0(3) e1(3) e0(3) np0
    aabb_mn: torch.Tensor  # [C, 3]
    aabb_mx: torch.Tensor  # [C, 3]
    base_corner_normals: torch.Tensor  # [T, 3, 3] t=0 attitude (static)
    shade_pack: torch.Tensor  # [T, 10] corner normals + target-as-float
    rot: torch.Tensor  # [NT, 3, 3] extra attitude rotation this pulse
    tri_target: torch.Tensor  # [T] int32
    target_refl: torch.Tensor  # [NT]
    target_refr: torch.Tensor  # [NT]
    target_vel: torch.Tensor  # [NT, 3]


def _dot3_rows(r, i, b):
    """sum_j r[..., i, j] * b[..., j], left to right (the JAX einsum's
    three products and two adds)."""
    return r[..., i, 0] * b[..., 0] + r[..., i, 1] * b[..., 1] + r[..., i, 2] * b[..., 2]


def animate_packed(
    base: SceneBase,
    rot: torch.Tensor,  # [NT, 3, 3]
    pos: torch.Tensor,  # [NT, 3]
    vel: torch.Tensor,  # [NT, 3]
) -> ClusterScene:
    """Rigid-transform straight into the traversal kernel's layout.

    The JAX package gathers the per-triangle rotation and translation
    with one-hot matmuls (a TPU gather workaround); here they are plain
    indexing, ``rot9[tid]``, which selects the same values exactly.
    """
    nt = base.target_refl.shape[0]
    tid = base.tri_target.clamp(0, nt - 1).long()
    pad = base.tri_target < 0
    dtype = base.tri_verts_t.dtype
    rot9 = rot.reshape(nt, 9).to(dtype)[tid].T  # [9, T]
    pos_t = pos.to(dtype)
    s = torch.where(pad[None, :], 0.0, pos_t[tid].T)  # [3, T]
    r = rot9
    v = base.tri_verts_t  # [9, T], rows corner*3 + axis

    def corner(c):
        bx, by, bz = v[3 * c + 0], v[3 * c + 1], v[3 * c + 2]
        return torch.stack([
            r[0] * bx + r[1] * by + r[2] * bz + s[0],
            r[3] * bx + r[4] * by + r[5] * bz + s[1],
            r[6] * bx + r[7] * by + r[8] * bz + s[2],
        ], dim=-1)

    verts = torch.stack([corner(0), corner(1), corner(2)], dim=1)  # [T, 3, 3]
    _, e0, e1, n, c1, c0, np0 = derive_tri_arrays(verts)
    tri_pack = torch.cat([n.T, c1.T, c0.T, e1.T, e0.T, np0[None]], dim=0)

    # Corner refit: transform the per-cluster per-target BASE boxes by
    # the rigid motion — O(C*NT) instead of a min/max over all T animated
    # vertices.  For box [mn, mx] under x -> R x + s the tight bound is
    #   mn'_i = sum_j min(R_ij mn_j, R_ij mx_j) + s_i  (and max for mx').
    rot_d = rot.to(dtype)
    rp = torch.clamp(rot_d, min=0.0)[None]  # [1, NT, 3, 3]
    rn = torch.clamp(rot_d, max=0.0)[None]
    cv = base.cl_valid[..., None]
    cmn = torch.where(cv, base.cl_mn, 0.0)  # [C, NT, 3]
    cmx = torch.where(cv, base.cl_mx, 0.0)
    new_mn = torch.stack(
        [_dot3_rows(rp, i, cmn) + _dot3_rows(rn, i, cmx) for i in range(3)], dim=-1
    ) + pos_t[None]
    new_mx = torch.stack(
        [_dot3_rows(rp, i, cmx) + _dot3_rows(rn, i, cmn) for i in range(3)], dim=-1
    ) + pos_t[None]
    # dilate by the f32 transform rounding bound so the box still contains
    # every per-triangle-transformed vertex (~1e-5 relative: culling-
    # negligible, far above any few-ulp discrepancy)
    span = (cmx - cmn).abs().amax(dim=-1, keepdim=True)
    eps = 1e-5 * (new_mn.abs() + new_mx.abs() + span) + 1e-4
    new_mn = new_mn - eps
    new_mx = new_mx + eps
    big = 3.0e38
    aabb_mn = torch.where(cv, new_mn, big).amin(dim=1)  # [C, 3]
    aabb_mx = torch.where(cv, new_mx, -big).amax(dim=1)
    none_valid = ~base.cl_valid.any(dim=1)[:, None]
    aabb_mn = torch.where(none_valid, float("inf"), aabb_mn)
    aabb_mx = torch.where(none_valid, float("inf"), aabb_mx)

    return ClusterScene(
        tri_pack=tri_pack,
        aabb_mn=aabb_mn,
        aabb_mx=aabb_mx,
        base_corner_normals=base.tri_corner_normals,
        shade_pack=base.shade_pack,
        rot=rot,
        tri_target=base.tri_target,
        target_refl=base.target_refl,
        target_refr=base.target_refr,
        target_vel=vel,
    )


def attitude_rotations(
    targets,
    times: np.ndarray,  # [P] pulse times
    start_time: float,
) -> np.ndarray:
    """Host-side [P, NT, 3, 3] extra-rotation matrices.

    Identity unless the target is rotating AND t > start_time
    (ray_tracer.cpp:996-1003); the time-varying angles are double
    precision (unlike the float-narrowed t=0 angles).
    """
    p, nt = len(times), len(targets)
    times = np.asarray(times, np.float64)
    out = np.tile(np.eye(3), (p, max(nt, 1), 1, 1))
    live = times > start_time
    for j, targ in enumerate(targets):
        if not targ.attitude.is_rotating or not live.any():
            continue
        # constant-rate attitude: vectorise rot_zyx over the pulse axis
        yaw, pitch, roll = (np.broadcast_to(a, times.shape) for a in targ.attitude.ypr(times))
        cy, sy = np.cos(yaw), np.sin(yaw)
        cp, sp = np.cos(pitch), np.sin(pitch)
        cr, sr = np.cos(roll), np.sin(roll)
        rz = np.zeros((p, 3, 3))
        rz[:, 0, 0], rz[:, 0, 1] = cy, -sy
        rz[:, 1, 0], rz[:, 1, 1] = sy, cy
        rz[:, 2, 2] = 1.0
        ry = np.zeros((p, 3, 3))
        ry[:, 0, 0], ry[:, 0, 2] = cp, sp
        ry[:, 1, 1] = 1.0
        ry[:, 2, 0], ry[:, 2, 2] = -sp, cp
        rx = np.zeros((p, 3, 3))
        rx[:, 0, 0] = 1.0
        rx[:, 1, 1], rx[:, 1, 2] = cr, -sr
        rx[:, 2, 1], rx[:, 2, 2] = sr, cr
        r = rz @ ry @ rx  # Rz·Ry·Rx (ray_tracer.cpp:156-170)
        out[live, j] = r[live]
    return out


def target_motion(
    targets,
    times: np.ndarray,  # [P]
    sample_time: float,
) -> tuple[np.ndarray, np.ndarray]:
    """Host-side positions [P, NT, 3] and finite-difference velocities
    [P, NT, 3] (ray_tracer.cpp:941-948)."""
    p, nt = len(times), len(targets)
    times = np.asarray(times, np.float64)
    pos = np.zeros((p, max(nt, 1), 3))
    vel = np.zeros((p, max(nt, 1), 3))
    for j, targ in enumerate(targets):
        a = np.asarray(targ.GetPosition(times), np.float64).reshape(p, 3)
        b = np.asarray(targ.GetPosition(times + sample_time), np.float64).reshape(p, 3)
        pos[:, j] = a
        vel[:, j] = (b - a) / sample_time
    return pos, vel
