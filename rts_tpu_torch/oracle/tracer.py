"""Slow, exact NumPy reference tracer ("the oracle"), a copy of
``rts_tpu.oracle.tracer`` on the port's own host modules, so that a
machine without jax holds the port's engine to it.

Implements the complete physics contract of the reference device pipeline
(SURVEY.md §2.4) in plain double precision with explicit recursion, so the
vectorised engine can be validated ray-by-ray against it (SURVEY.md §4
item 3).  It stays NumPy: an independent reference, not a second engine.
Each block cites the behaviour it reproduces:

  * ray fan           — ray_tracer.cu:144-209
  * closest hit       — normal_shader.cu:128-340 (reflect/refract/Doppler/
                        path & RCS-angle recording, depth budgets)
  * triangle test     — triangle_mesh.cu:121-199 (double Möller–Trumbore
                        with the reference's edge/sign conventions)
  * miss              — ray_tracer.cu:260-477 (receiver spheres with
                        pole-wrapped angle windows; Earth termination)

Precision model ("strict parity"): the reference is double precision
*except* where OptiX forces float32 — the reported hit distance ``hit_t``
(normal_shader.cu:24,150-153), reflected/refracted directions computed
from the float3 ray (normal_shader.cu:296,212), the refraction index
ratio (:209), and the receiver-capture angles computed with ``atan2f``
(ray_tracer.cu:326-329).  ``strict_parity=True`` reproduces those
narrowings; ``False`` runs everything in float64.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from rts_tpu_torch.config import Parameters
from rts_tpu_torch.core.constants import (
    EARTH_RADIUS,
    NOT_RECEIVED,
    RCS_ANGLE_SENTINEL,
    SCENE_EPS,
    SCENE_EPS_R,
)
from rts_tpu_torch.core.rotation import rot_axis_reversed, rot_z
from rts_tpu_torch.geometry.scene import SceneArrays
from rts_tpu_torch.physics.receiver_geom import RxSphereGeometry

RT_DEFAULT_MAX = float(np.float32(1e27))


# --------------------------------------------------------------------------
# small helpers


def _sph_to_cart(azi: float, ele: float) -> np.ndarray:
    return np.array(
        [np.cos(azi) * np.cos(ele), np.sin(azi) * np.cos(ele), np.sin(ele)], dtype=np.float64
    )


def _cart_to_sph(v: np.ndarray) -> tuple[float, float]:
    return (
        float(np.arctan2(v[1], v[0])),
        float(np.arctan2(v[2], np.hypot(v[0], v[1]))),
    )


def _norm(v: np.ndarray) -> np.ndarray:
    return v / np.linalg.norm(v)


def _wrap(a: float) -> float:
    while a < -np.pi:
        a += 2 * np.pi
    while a > np.pi:
        a -= 2 * np.pi
    return a


def _angle_in_range(test: float, a: float, b: float) -> bool:
    a = _wrap(a - test)
    b = _wrap(b - test)
    if a * b >= 0:
        return False
    return abs(a - b) < np.pi


def _reflect_f32(i: np.ndarray, n: np.ndarray) -> np.ndarray:
    i32 = i.astype(np.float32)
    n32 = n.astype(np.float32)
    return (i32 - np.float32(2.0) * n32 * np.dot(i32, n32)).astype(np.float64)


def _reflect_f64(i: np.ndarray, n: np.ndarray) -> np.ndarray:
    return i - 2.0 * n * np.dot(i, n)


def _refract(i: np.ndarray, n: np.ndarray, ior: float, f32: bool):
    """OptiX ``refract`` semantics (see rts_tpu_torch.core.vec.refract3)."""
    dt = np.float32 if f32 else np.float64
    i = i.astype(dt)
    n = n.astype(dt)
    ior = dt(ior)
    ndotv = np.dot(i, n)
    if ndotv > 0:
        eta = ior
        nn = -n
        neg_ndotv = -ndotv
    else:
        eta = dt(1.0) / ior
        nn = n
        neg_ndotv = ndotv
    k = dt(1.0) - eta * eta * (dt(1.0) - neg_ndotv * neg_ndotv)
    if k < 0:
        return np.zeros(3), False
    r = eta * i - (eta * neg_ndotv + np.sqrt(k)) * nn
    r = r / np.sqrt(np.dot(r, r))
    return r.astype(np.float64), True


# --------------------------------------------------------------------------
# per-ray mutable state (the PerRayData analogue, ray_tracer.h:13-28)


@dataclasses.dataclass
class _Prd:
    ray_length: float = 0.0
    refr_prev: float = 1.0  # refrIndex.x
    refr_cur: float = 1.0  # refrIndex.y
    refl_depth: int = 0
    refr_depth: int = 0
    max_ray_index: int = 0
    direction: np.ndarray = None  # double3 rayDirection
    first_hit: np.ndarray = None
    prev_hit: np.ndarray = None  # origin until first bounce
    power: float = 0.0
    doppler: float = 0.0
    received: int = NOT_RECEIVED
    end: bool = False

    def copy(self) -> "_Prd":
        c = dataclasses.replace(self)
        c.direction = self.direction.copy()
        c.first_hit = self.first_hit.copy()
        c.prev_hit = self.prev_hit.copy()
        return c


@dataclasses.dataclass
class OracleResult:
    ray_length: np.ndarray  # [R]
    power: np.ndarray  # [R]
    doppler: np.ndarray  # [R]
    received: np.ndarray  # [R] int
    refl_depth: np.ndarray  # [R]
    refr_depth: np.ndarray  # [R]
    first_hit: np.ndarray  # [R, 3]
    prev_hit: np.ndarray  # [R, 3]
    path: np.ndarray  # [R, depth_total] int, -1 empty
    rcs_angle: np.ndarray  # [R, depth_total, 2], sentinel -1e6


# --------------------------------------------------------------------------
# fan generation


def generate_fan(params: Parameters, tx_dir, tx_span) -> np.ndarray:
    """Primary ray directions [N^3, 3] (double, pre-float-narrowing).

    Grid order: rayIndex = iz*N^2 + iy*N + ix (ray_tracer.cu:151); the
    x index also sweeps the "launch range" stretch of the x endpoint
    (ray_tracer.cu:167).  Boresight: azimuth rotation about z, then
    elevation about the azimuth-rotated y axis with reversed-sine
    axis-angle matrix (ray_tracer.cu:172-203).
    """
    n = params.num_rays
    az, el = float(tx_dir[0]), float(tx_dir[1])
    az_span, el_span, launch_range = (float(x) for x in tx_span)

    if n == 1:
        return _sph_to_cart(az, el)[None, :]

    beam_start = _sph_to_cart(-az_span / 2, -el_span / 2)
    beam_end = _sph_to_cart(az_span / 2, el_span / 2)

    ix = np.arange(n, dtype=np.float64)
    dx = beam_start[0] + ((beam_end[0] * (1 + launch_range)) - beam_start[0]) / (n - 1) * ix
    dy = beam_start[1] + (beam_end[1] - beam_start[1]) / (n - 1) * ix
    dz = beam_start[2] + (beam_end[2] - beam_start[2]) / (n - 1) * ix

    # rayIndex = iz*N^2 + iy*N + ix — build with broadcasting in that order.
    d = np.stack(
        np.broadcast_arrays(
            dx[None, None, :], dy[None, :, None], dz[:, None, None]
        ),
        axis=-1,
    ).reshape(-1, 3)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)

    rz = np.asarray(rot_z(np.float64(az)))
    d = d @ rz.T
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    orth = _norm(rz[:, 1])  # azimuth-rotated y axis
    r1 = np.asarray(rot_axis_reversed(orth, np.float64(el)))
    return d @ r1.T  # NOT renormalised (ray_tracer.cu:203)


# --------------------------------------------------------------------------
# the tracer


class _Tracer:
    def __init__(self, scene: SceneArrays, params: Parameters, tx_origin, rx: RxSphereGeometry, strict_parity: bool):
        self.scene = scene
        self.p = params
        self.tx_origin = np.asarray(tx_origin, dtype=np.float64)
        self.rx = rx
        self.sp = strict_parity
        self.n3 = params.rays_per_fan
        self.ray_total = params.ray_total
        self.depth_total = params.depth_total
        # device-side depth budgets: "stop index" semantics
        self.max_refl_dev = params.max_refl_depth + 1  # ray_tracer.cpp:776
        self.max_refr_dev = params.max_refr_depth

        dt = self.depth_total
        r = self.ray_total
        self.res = OracleResult(
            ray_length=np.zeros(r),
            power=np.zeros(r),
            doppler=np.zeros(r),
            received=np.full(r, NOT_RECEIVED, dtype=np.int64),
            refl_depth=np.zeros(r, dtype=np.int64),
            refr_depth=np.zeros(r, dtype=np.int64),
            first_hit=np.zeros((r, 3)),
            prev_hit=np.zeros((r, 3)),
            path=np.full((r, dt), -1, dtype=np.int64),
            rcs_angle=np.full((r, dt, 2), RCS_ANGLE_SENTINEL),
        )

        # Hoisted triangle data.
        tv = scene.tri_verts
        self.p0 = tv[:, 0]
        self.e0 = tv[:, 1] - tv[:, 0]  # p1 - p0
        self.e1 = tv[:, 0] - tv[:, 2]  # p0 - p2
        self.geom_n = np.cross(self.e1, self.e0)

    # -- closest-hit search over the flat soup (stands in for BVH+intersect)

    def _closest_hit(self, origin: np.ndarray, direction: np.ndarray, tmin: float):
        with np.errstate(divide="ignore", invalid="ignore"):
            denom = self.geom_n @ direction
            e2 = (self.p0 - origin) / denom[:, None]
            i = np.cross(np.broadcast_to(direction, e2.shape), e2)
            beta = np.sum(i * self.e1, axis=-1)
            gamma = np.sum(i * self.e0, axis=-1)
            t = np.sum(self.geom_n * e2, axis=-1)
        valid = (
            (t < RT_DEFAULT_MAX)
            & (t > tmin)
            & (beta >= 0.0)
            & (gamma >= 0.0)
            & (beta + gamma <= 1.0)
            & (self.scene.tri_target >= 0)
        )
        if not np.any(valid):
            return None
        t_masked = np.where(valid, t, np.inf)
        k = int(np.argmin(t_masked))
        return k, float(t[k]), float(beta[k]), float(gamma[k])

    def _shading_normal(self, k: int, beta: float, gamma: float) -> np.ndarray:
        if self.p.interpolate_smooth:
            n0, n1, n2 = self.scene.tri_normals[k]
            n = n1 * beta + n2 * gamma + n0 * (1.0 - beta - gamma)
        else:
            n = self.geom_n[k]
        return _norm(n)

    # -- recursion

    def trace(self, ray_dir_f32: np.ndarray, prd: _Prd, tmin: float, ray_index: int):
        hit = self._closest_hit(prd.prev_hit, prd.direction, tmin)
        if hit is None:
            self._miss(prd)
        else:
            self._hit(hit, ray_dir_f32, prd, ray_index)

    def _hit(self, hit, ray_dir_f32: np.ndarray, prd: _Prd, ray_index: int):
        k, t, beta, gamma = hit
        scene, p, res = self.scene, self.p, self.res
        targ = int(scene.tri_target[k])

        # entry gate (normal_shader.cu:134)
        if prd.end or not (
            prd.refr_depth < self.max_refr_dev or prd.refl_depth < self.max_refl_dev - 1
        ):
            return

        # path record (normal_shader.cu:139-146) — skipped for the trapped
        # chain (refr_depth == 1)
        if prd.refr_depth != 1:
            col = prd.refl_depth + prd.refr_depth
            if col < self.max_refr_dev + self.max_refl_dev - 1:
                res.path[ray_index + prd.max_ray_index, col] = targ

        hit_t = float(np.float32(t)) if self.sp else t  # hit_t is float32
        hit_point = prd.prev_hit + hit_t * prd.direction
        prd.ray_length += hit_t

        # power legs (normal_shader.cu:159-173)
        if prd.refl_depth == 0 and prd.refr_depth == 0:
            prd.first_hit = hit_point.copy()
            leg = hit_point - self.tx_origin
            if np.linalg.norm(leg) >= SCENE_EPS:
                prd.power = 1.0 / (np.dot(leg, leg) * 4.0 * np.pi)
            else:
                prd.end = True
        else:
            leg = hit_point - prd.prev_hit
            if np.linalg.norm(leg) >= SCENE_EPS_R:
                prd.power *= 1.0 / (np.dot(leg, leg) * 4.0 * np.pi)
            else:
                prd.end = True

        prd.prev_hit = hit_point.copy()

        normal = self._shading_normal(k, beta, gamma)
        normal_f = normal.astype(np.float32).astype(np.float64) if self.sp else normal
        v_targ = scene.target_velocity[targ]
        refl_coeff = float(scene.target_refl_coeff[targ])

        # ---- refraction (normal_shader.cu:191-281)
        prd_refr = prd.copy()
        prd_refr.refr_prev = prd_refr.refr_cur
        if (
            abs(refl_coeff) != 1.0
            and prd_refr.refr_depth < self.max_refr_dev
            and prd_refr.refl_depth == 0
        ):
            if prd_refr.refr_prev == 1:
                prd_refr.refr_cur = float(scene.target_refr_index[targ])
            else:
                prd_refr.refr_cur = 1.0
            # index ratio is narrowed to float on device (normal_shader.cu:209)
            ratio = prd_refr.refr_cur / prd_refr.refr_prev
            if self.sp:
                ratio = float(np.float32(ratio))
            new_dir, ok = _refract(ray_dir_f32, normal_f, ratio, f32=self.sp)
            if ok:
                current = prd_refr.max_ray_index + self.n3
                prd_refr.max_ray_index = current

                # pre-filled "trapped"/"exiting" path chains
                # (normal_shader.cu:221-239) — only at the very first
                # refraction of a primary ray
                if prd_refr.refr_depth == 0 and current == self.n3:
                    for i in range(self.max_refl_dev + self.max_refr_dev - 1):
                        res.path[ray_index + current, i] = targ
                    for j in range(self.max_refl_dev):
                        row = ray_index + (j + 2) * current
                        for i in range(j + 2):
                            res.path[row, i] = targ

                if prd_refr.refl_depth + 1 < self.max_refl_dev:
                    prd_refr.power *= 1.0 - abs(refl_coeff)
                prd_refr.refr_depth += 1

                k0 = _norm(prd_refr.direction)
                prd_refr.direction = new_dir.copy()
                k1 = _norm(prd_refr.direction)
                prd_refr.doppler += float(np.dot(v_targ, k1 - k0))

                row = ray_index + current
                col = prd_refr.refl_depth + (prd_refr.refr_depth - 1)
                k0s, k1s = _cart_to_sph(k0), _cart_to_sph(-k1)
                res.rcs_angle[row, col, 0] = k0s[0] + k1s[0]
                res.rcs_angle[row, col, 1] = k0s[1] + k1s[1]

                self.trace(new_dir, prd_refr, SCENE_EPS, ray_index)

                self._store(ray_index + current, prd_refr)

        # ---- reflection (normal_shader.cu:286-333)
        prd.refl_depth += 1
        prd.refr_cur = prd_refr.refr_prev
        prd.refr_prev = prd_refr.refr_prev

        if prd.refl_depth < self.max_refl_dev:
            if self.sp:
                new_dir = _reflect_f32(ray_dir_f32, normal_f)
            else:
                new_dir = _reflect_f64(ray_dir_f32, normal_f)
            prd.power *= refl_coeff

            k0 = _norm(prd.direction)
            prd.direction = new_dir.copy()
            k1 = _norm(prd.direction)
            prd.doppler += float(np.dot(v_targ, k1 - k0))

            row = ray_index + prd.max_ray_index
            col = (prd.refl_depth - 1) + prd.refr_depth
            k0s, k1s = _cart_to_sph(k0), _cart_to_sph(-k1)
            res.rcs_angle[row, col, 0] = k0s[0] + k1s[0]
            res.rcs_angle[row, col, 1] = k0s[1] + k1s[1]

            self.trace(new_dir, prd, SCENE_EPS_R, ray_index)

        if prd.refl_depth + 1 >= self.max_refl_dev and prd.refr_depth >= self.max_refr_dev:
            prd.end = True

    def _miss(self, prd: _Prd):
        rx = self.rx
        if not prd.end:
            for rx_i in range(rx.centre.shape[0]):
                c = rx.centre[rx_i]
                o = prd.prev_hit
                d = prd.direction
                a_q = float(np.dot(d, d))
                b_q = 2.0 * float(np.dot(o - c, d))
                c_q = float(np.dot(o, o) + np.dot(c, c) - 2.0 * np.dot(c, o) - rx.radius[rx_i] ** 2)
                disc = b_q * b_q - 4 * a_q * c_q
                if disc <= 0:
                    continue
                sq = np.sqrt(disc)
                roots = [(-b_q - sq) / (2 * a_q), (-b_q + sq) / (2 * a_q)]
                received_root = 2
                for i, ti in enumerate(roots):
                    if ti >= 0 and prd.ray_length + ti > SCENE_EPS and prd.ray_length + ti > SCENE_EPS_R:
                        end_point = o + ti * d
                        rel = end_point - c
                        if self.sp:
                            # atan2f on device (ray_tracer.cu:326-329)
                            theta = float(
                                np.arctan2(np.float32(rel[1]), np.float32(rel[0]), dtype=np.float32)
                            )
                            phi = float(
                                np.arctan2(
                                    np.float32(rel[2]),
                                    np.float32(np.sqrt(rel[1] ** 2 + rel[0] ** 2)),
                                    dtype=np.float32,
                                )
                            )
                        else:
                            theta = float(np.arctan2(rel[1], rel[0]))
                            phi = float(np.arctan2(rel[2], np.hypot(rel[0], rel[1])))

                        if phi < -np.pi / 2:
                            theta += np.pi
                            phi = -np.pi - phi
                        if phi > np.pi / 2:
                            theta += np.pi
                            phi = np.pi - phi

                        max_t1 = float(rx.max_theta[rx_i])
                        min_t1 = float(rx.min_theta[rx_i])
                        max_t2, min_t2 = max_t1, min_t1
                        max_p1 = float(rx.max_phi[rx_i])
                        min_p1 = float(rx.min_phi[rx_i])
                        max_p2, min_p2 = max_p1, min_p1

                        # pole wrap: second (theta, phi) region
                        # (ray_tracer.cu:352-368)
                        if min_p1 < -np.pi / 2:
                            max_t2 += np.pi
                            min_t2 += np.pi
                            max_p2 = -np.pi - min_p1
                            min_p2 = -np.pi / 2
                            min_p1 = -np.pi / 2
                        if max_p1 > np.pi / 2:
                            max_t2 += np.pi
                            min_t2 += np.pi
                            min_p2 = np.pi - max_p1
                            max_p2 = np.pi / 2
                            max_p1 = np.pi / 2

                        if (
                            _angle_in_range(theta, min_t1, max_t1)
                            and _angle_in_range(phi, min_p1, max_p1)
                        ) or (
                            _angle_in_range(theta, min_t2, max_t2)
                            and _angle_in_range(phi, min_p2, max_p2)
                        ):
                            if received_root == 2:
                                received_root = i
                            elif roots[received_root] > ti:
                                received_root = i

                if received_root < 2:
                    prd.end = True
                    ti = roots[received_root]
                    end_point = o + ti * d
                    if prd.refl_depth == 0 and prd.refr_depth == 0:
                        rx_range = end_point - self.tx_origin
                        if np.linalg.norm(rx_range) >= SCENE_EPS:
                            prd.power = 1.0 / (4 * np.pi * 4 * np.pi * np.dot(rx_range, rx_range))
                            prd.doppler = 0.0
                            prd.ray_length += ti
                            prd.received = rx_i
                    else:
                        rx_range = end_point - o
                        if np.linalg.norm(rx_range) >= SCENE_EPS_R:
                            prd.power *= 1.0 / (np.dot(rx_range, rx_range) * 4 * np.pi * 4 * np.pi)
                            prd.ray_length += ti
                            prd.received = rx_i

        # Earth-sphere termination (ray_tracer.cu:438-477)
        if not prd.end:
            o, d = prd.prev_hit, prd.direction
            a_q = float(np.dot(d, d))
            b_q = 2.0 * float(np.dot(o, d))
            c_q = float(np.dot(o, o)) - EARTH_RADIUS**2
            disc = b_q * b_q - 4 * a_q * c_q
            if disc > 0:
                sq = np.sqrt(disc)
                for ti in ((-b_q - sq) / (2 * a_q), (-b_q + sq) / (2 * a_q)):
                    if ti >= 0 and prd.ray_length > 0:
                        prd.end = True
                        prd.ray_length += ti  # both valid roots add (quirk)

    def _store(self, slot: int, prd: _Prd):
        res = self.res
        res.refl_depth[slot] = prd.refl_depth
        res.refr_depth[slot] = prd.refr_depth
        res.ray_length[slot] = prd.ray_length
        res.first_hit[slot] = prd.first_hit
        res.prev_hit[slot] = prd.prev_hit
        res.power[slot] = prd.power
        res.doppler[slot] = prd.doppler
        res.received[slot] = prd.received


def trace_pulse(
    scene: SceneArrays,
    params: Parameters,
    tx_origin,
    tx_dir,
    tx_span,
    rx_geom: RxSphereGeometry,
    *,
    strict_parity: bool = True,
) -> OracleResult:
    """Trace one pulse: the oracle equivalent of one rtContextLaunch3D
    (ray_tracer.cpp:1165) over the N^3 fan, including refraction slots."""
    tracer = _Tracer(scene, params, tx_origin, rx_geom, strict_parity)
    dirs = generate_fan(params, tx_dir, tx_span)
    origin = np.asarray(tx_origin, dtype=np.float64)

    for ray_index in range(params.rays_per_fan):
        d = dirs[ray_index]
        d_f32 = (_norm(d).astype(np.float32).astype(np.float64)) if strict_parity else _norm(d)
        prd = _Prd(
            direction=d.copy(),
            first_hit=np.zeros(3),
            prev_hit=origin.copy(),
        )
        tracer.trace(d_f32, prd, SCENE_EPS, ray_index)
        tracer._store(ray_index, prd)

    return tracer.res
