"""Wavefront multi-bounce tracer (counterpart of ``rts_tpu.engine.wavefront``).

All ray chains advance in lock-step as lanes through a fixed number of
segment iterations; terminated lanes are masked, never compacted.  Gates
mirror the reference's closest-hit program (normal_shader.cu: entry gate
:134, path record :139-146, power legs :159-173, refraction :191-281,
reflection :286-333) and miss program (ray_tracer.cu:260-477).

Refraction keeps the reference's static slot layout (ray_tracer.cpp:
608-633): a chain in lane ``l`` spawns its child at lane ``l + N^3``, so
primaries live in [0, N^3), the trapped first-refraction chains in
[N^3, 2N^3) and the exiting second-refraction chains in [2N^3, 3N^3).
Lanes from 3N^3 to the result's ``ray_total`` exist only as pre-filled
path rows (normal_shader.cu:231-239) and stay empty.

Two intersectors feed the loop, as in the JAX package: the brute-force
one over a ``DeviceScene`` (``accel="brute"``, any dtype; the default and,
in float64, the parity engine) and the clustered CUDA traversal over a
``ClusterScene`` (``accel="cluster"``, float32).  ``strict_parity``
applies the reference's float32 narrowing points (``_q32``): the hit
distance, the shading normal, the bounce and refraction directions and
the atan2 form of the receiver window test.

The JAX package's ``lax.cond`` branches become Python ``if``s on counts
read back from the device, and its ``fori_loop``s Python loops.

On float32 CUDA state (``shade_on_card``) a segment's miss and closest-hit
programs are one launch of the hand-written kernel ``ops/csrc/shade.cu``
(``shade_cuda``), bit-identical to ``_process_miss`` and ``_process_hit``,
which stay as the CPU, float64 and parity path and as its oracle; in the
two segments that spawn refracted children the kernel runs the miss
program and ``_process_hit`` the closest-hit program with the spawn.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from rts_tpu_torch.core.constants import EARTH_RADIUS, SCENE_EPS, SCENE_EPS_R
from rts_tpu_torch.accel.cluster import cluster_aabbs
from rts_tpu_torch.core.vec import angle_in_range, dot3c, normalize3c
from rts_tpu_torch.engine.animate import ClusterScene
from rts_tpu_torch.engine.fan import fan_tile_perm, generate_fan_c
from rts_tpu_torch.engine.intersect import closest_hit_bruteforce
from rts_tpu_torch.engine.types import DeviceScene, RxGeomDevice, TraceConfig
from rts_tpu_torch.ops import cluster_trace as CT
from rts_tpu_torch.ops.cluster_trace import closest_hit_clustered
from rts_tpu_torch.utils.timing import count, profiling, trace_annotation

PI = math.pi


class LaneState(NamedTuple):
    """Per-chain state (the PerRayData analogue); lanes are the LAST axis
    of every leaf and 3-vectors are components-major [3, L]."""

    origin: torch.Tensor  # [3, L] segment origin
    direction: torch.Tensor  # [3, L] propagation direction
    seg_dir: torch.Tensor  # [3, L] the OptiX ray.direction
    tmin: torch.Tensor  # [L]
    ray_length: torch.Tensor  # [L]
    power: torch.Tensor  # [L]
    doppler: torch.Tensor  # [L]
    refr_prev: torch.Tensor  # [L] refrIndex.x
    refr_cur: torch.Tensor  # [L] refrIndex.y
    refl_depth: torch.Tensor  # [L] int32
    refr_depth: torch.Tensor  # [L] int32
    slot_base: torch.Tensor  # [L] int32
    received: torch.Tensor  # [L] int32
    first_hit: torch.Tensor  # [3, L]
    end: torch.Tensor  # [L] bool
    active: torch.Tensor  # [L] bool
    born: torch.Tensor  # [L] bool
    tri_seq: torch.Tensor  # [W, L] int32 triangle hit at each chain step, -1 none
    cap_bits: torch.Tensor  # [L] int32 bit rx: captured by rx
    cap_root0_bits: torch.Tensor  # [L] int32 bit rx: the near root captured


class TraceBuffers(NamedTuple):
    path: torch.Tensor  # [D, R] int32
    rcs: torch.Tensor  # [2, D, R]


class TraceResult(NamedTuple):
    """Per-pulse outputs; lanes are the LAST axis of every leaf."""

    ray_length: torch.Tensor  # [R]
    power: torch.Tensor  # [R]
    doppler: torch.Tensor  # [R]
    received: torch.Tensor  # [R] int32
    refl_depth: torch.Tensor  # [R] int32
    refr_depth: torch.Tensor  # [R] int32
    first_hit: torch.Tensor  # [3, R]
    prev_hit: torch.Tensor  # [3, R]
    path: torch.Tensor  # [D, R] int32
    rcs: torch.Tensor  # [2, D, R]
    tri_seq: torch.Tensor  # [W, R] int32
    cap_bits: torch.Tensor  # [R] int32
    cap_root0_bits: torch.Tensor  # [R] int32
    ray_length_lo: torch.Tensor  # [R] f32 residual of ray_length (replay output; zeros here)


def _q32(x, cfg: TraceConfig):
    """The reference's float32 narrowing points (a no-op unless
    strict_parity with a wider engine dtype)."""
    if cfg.strict_parity:
        return x.to(torch.float32).to(x.dtype)
    return x


def _reflect(i, n, cfg: TraceConfig):
    """OptiX reflect on the float3 ray (normal_shader.cu:296), [3, L]."""
    if cfg.strict_parity:
        i32, n32 = i.to(torch.float32), n.to(torch.float32)
        return (i32 - 2.0 * n32 * dot3c(i32, n32)[None]).to(i.dtype)
    return i - 2.0 * n * dot3c(i, n)[None]


def _refract(i, n, ior, cfg: TraceConfig):
    """OptiX refract (normal_shader.cu:212), float32 under strict parity;
    [3, L] vectors.  A backface hit (i . n > 0) flips the normal and
    inverts the index ratio; k < 0 is total internal reflection (ok =
    False).  Returns (unit direction, ok)."""
    dtype = i.dtype
    if cfg.strict_parity:
        i, n, ior = i.to(torch.float32), n.to(torch.float32), ior.to(torch.float32)
    ndotv = dot3c(i, n)
    backface = ndotv > 0.0
    eta = torch.where(backface, ior, 1.0 / ior)
    nn = torch.where(backface, -n, n)
    neg_ndotv = torch.where(backface, -ndotv, ndotv)
    k = 1.0 - eta * eta * (1.0 - neg_ndotv * neg_ndotv)
    ok = k >= 0.0
    r = eta[None] * i - (eta * neg_ndotv + torch.sqrt(torch.where(ok, k, 0.0)))[None] * nn
    r = r / torch.sqrt(torch.clamp(dot3c(r, r), min=1e-300 if r.dtype == torch.float64 else 1e-30))[None]
    return r.to(dtype), ok


def _shift_down(a, n3: int):
    """Move lane l to lane l + n3 (zero-fill the first n3 lanes); lanes
    are the last axis."""
    return torch.cat([torch.zeros(a.shape[:-1] + (n3,), dtype=a.dtype, device=a.device), a[..., :-n3]], -1)


def _shift_to_rows(a, off: int, rows: int):
    """a[..., i] at lane i + off of a zero buffer with ``rows`` lanes."""
    take = min(rows - off, a.shape[-1])
    zeros = lambda k: torch.zeros(a.shape[:-1] + (k,), dtype=a.dtype, device=a.device)
    return torch.cat([zeros(off), a[..., :take], zeros(rows - off - take)], -1)


def _cart_to_sph2(v):
    azi = torch.atan2(v[1], v[0])
    ele = torch.atan2(v[2], torch.sqrt(v[0] ** 2 + v[1] ** 2))
    return azi, ele


def _scatter_col(buf, col, value, mask):
    """Masked per-lane write buf[..., col[l], l] = value[..., l] where mask,
    on the first ``mask.shape[0]`` lanes of ``buf`` (the result buffers
    are ``ray_total`` wide; the lanes traced are fewer with refraction)."""
    lanes = mask.shape[0]
    if buf.shape[-1] > lanes:
        out = buf.clone()
        out[..., :lanes] = _scatter_col(buf[..., :lanes], col, value, mask)
        return out
    d = buf.shape[-2]
    rows = torch.arange(d, device=buf.device)[:, None]
    sel = mask[None, :] & (rows == col[None, :])
    if buf.dim() == 3:
        sel = sel[None]
        value = value[:, None, :]
    else:
        value = value[None, :]
    return torch.where(sel, value.to(buf.dtype), buf)


def _process_hit(state: LaneState, bufs: TraceBuffers, hit, hit_mask,
                 scene: ClusterScene | DeviceScene, tx_origin, cfg: TraceConfig, n3: int,
                 spawn: bool = True):
    """Closest-hit program (normal_shader.cu:128-340).  A ``ClusterScene``
    shades from the static base normals rotated per lane; a
    ``DeviceScene`` holds world-frame normals already.

    With refraction on and ``spawn``, a chain's first hit on a target
    whose reflection coefficient is not +-1 also spawns its refracted
    child ``n3`` lanes down.  ``spawn=False`` skips that work; it is only
    valid after the first two segments, where no lane can spawn (it needs
    refl_depth == 0 and refr_depth < max_refr_dev), and it lets the
    narrow late segments trace a block of lanes that the shift does not
    fit.  The spawn, and the children's landing, are ``rts.refract``
    spans."""
    tri = hit.tri.clamp(0, scene.tri_target.shape[0] - 1).long()
    nt = scene.target_refl.shape[0]
    clustered = isinstance(scene, ClusterScene)
    if clustered and cfg.interpolate_smooth:
        # the kernel's emitted winner rows (shade_emit) or the [T, 10]
        # gather: equal on found lanes; the rest are gate-masked below
        shade = hit.shade if hit.shade is not None else scene.shade_pack[tri].T  # [10, L]
        targ = shade[9].to(torch.int32)
        cn = shade[:9].reshape(3, 3, -1)  # [corner, comp, L]
    else:
        targ = scene.tri_target[tri]
    targ_safe = targ.clamp(0, nt - 1).long()

    def tgather(a):  # per-lane target attributes: [NT] -> [L], [NT, k] -> [k, L]
        g = a.to(state.origin.dtype)[targ_safe]
        return g if a.dim() == 1 else g.T

    gate = (
        hit_mask
        & ~state.end
        & ((state.refr_depth < cfg.max_refr_dev) | (state.refl_depth < cfg.max_refl_dev - 1))
    )

    # --- path record (normal_shader.cu:139-146)
    col = state.refl_depth + state.refr_depth
    rec = gate & (state.refr_depth != 1) & (col < cfg.depth_total)
    path = _scatter_col(bufs.path, col, targ, rec)
    tri_seq = _scatter_col(state.tri_seq, col, hit.tri, gate)

    # --- geometry update
    hit_t = torch.where(gate, _q32(hit.t, cfg), 0.0)
    hit_point = state.origin + hit_t[None] * state.direction
    ray_length = state.ray_length + hit_t

    first = gate & (state.refl_depth == 0) & (state.refr_depth == 0)
    leg = torch.where(first, hit_point - tx_origin[:, None], hit_point - state.origin)
    leg_sq = dot3c(leg, leg)
    eps = torch.where(first, SCENE_EPS, SCENE_EPS_R)
    ok_leg = torch.sqrt(leg_sq) >= eps
    four_pi = 4.0 * PI
    power = state.power
    power = torch.where(first & ok_leg, 1.0 / (leg_sq * four_pi), power)
    power = torch.where(gate & ~first & ok_leg, power / (leg_sq * four_pi), power)
    end = state.end | (gate & ~ok_leg)

    first_hit = torch.where(first, hit_point, state.first_hit)
    origin = torch.where(gate, hit_point, state.origin)

    # --- shading normal (triangle_mesh.cu:174-194)
    if cfg.interpolate_smooth:
        if not clustered:
            cn = scene.tri_corner_normals[tri].permute(1, 2, 0)  # [corner, comp, L], world frame
        nrm = cn[1] * hit.beta[None] + cn[2] * hit.gamma[None] + cn[0] * (1.0 - hit.beta - hit.gamma)[None]
        if clustered:
            # rotate the interpolated BASE normal per lane (rotation is
            # linear, so this equals rotating all T normals per pulse)
            r9 = tgather(scene.rot.reshape(-1, 9))  # [9, L]
            nrm = torch.stack(
                [
                    r9[0] * nrm[0] + r9[1] * nrm[1] + r9[2] * nrm[2],
                    r9[3] * nrm[0] + r9[4] * nrm[1] + r9[5] * nrm[2],
                    r9[6] * nrm[0] + r9[7] * nrm[1] + r9[8] * nrm[2],
                ],
                dim=0,
            )
    elif clustered:
        nrm = scene.tri_pack[0:3][:, tri]  # geometric normal, already world-frame
    else:
        nrm = scene.tri_n[tri].T
    nrm = normalize3c(nrm)
    normal_f = _q32(torch.where(torch.isfinite(nrm), nrm, 0.0), cfg)

    v_targ = tgather(scene.target_vel)  # [3, L]
    refl_c = tgather(scene.target_refl)  # [L]
    k0 = normalize3c(state.direction)
    k0 = torch.where(torch.isfinite(k0), k0, 0.0)
    if cfg.rcs_angles:
        k0_azi, k0_ele = _cart_to_sph2(k0)

    # --- refraction spawn (normal_shader.cu:191-281)
    refr_prev_new = state.refr_cur  # prd_refr.refrIndex.x = old .y
    rcs = bufs.rcs
    spawning = cfg.refraction_on and spawn
    if spawning:
        with trace_annotation("rts.refract"):
            can = gate & (refl_c.abs() != 1.0) & (state.refr_depth < cfg.max_refr_dev) & (state.refl_depth == 0)
            refr_cur_child = torch.where(refr_prev_new == 1.0, tgather(scene.target_refr), 1.0)
            ratio = _q32(refr_cur_child / refr_prev_new, cfg)
            refr_dir, refr_ok = _refract(state.seg_dir, normal_f, ratio, cfg)
            spawn_mask = can & refr_ok
            if profiling():  # a primary's child is trapped, a trapped chain's exits
                primary = state.slot_base == 0
                count("refract.spawned.trapped", (spawn_mask & primary).sum())
                count("refract.spawned.exiting", (spawn_mask & ~primary).sum())
                count("refract.tir", (can & ~refr_ok).sum())
            child_power = torch.where(state.refl_depth + 1 < cfg.max_refl_dev, power * (1.0 - refl_c.abs()), power)
            k1 = normalize3c(refr_dir)
            lanes = spawn_mask.shape[0]
            ones = torch.ones(lanes, dtype=torch.bool, device=gate.device)
            child = LaneState(
                origin=hit_point,
                direction=refr_dir,
                seg_dir=refr_dir,
                tmin=torch.full((lanes,), SCENE_EPS, dtype=hit_point.dtype, device=gate.device),
                ray_length=ray_length,
                power=child_power,
                doppler=state.doppler + dot3c(v_targ, k1 - k0),
                refr_prev=refr_prev_new,
                refr_cur=refr_cur_child,
                refl_depth=state.refl_depth,
                refr_depth=state.refr_depth + 1,
                slot_base=state.slot_base + n3,
                received=state.received,
                first_hit=first_hit,
                end=end,
                active=ones,
                born=ones,
                tri_seq=tri_seq,
                cap_bits=state.cap_bits,
                cap_root0_bits=state.cap_root0_bits,
            )
            if cfg.rcs_angles:
                # refraction RCS angles -> the child's row (normal_shader.cu:259-265)
                k1_azi, k1_ele = _cart_to_sph2(-k1)
                rcs_val = torch.stack([k0_azi + k1_azi, k0_ele + k1_ele], dim=0)
                child_col = state.refl_depth + state.refr_depth  # refl + (refr + 1) - 1
                rcs = _scatter_col(rcs, _shift_down(child_col, n3), _shift_down(rcs_val, n3),
                                   _shift_down(spawn_mask, n3))

            # pre-filled trapped and exiting path rows (normal_shader.cu:221-239)
            prefill = spawn_mask & (state.refr_depth == 0) & (state.slot_base == 0)
            r_rows = path.shape[1]
            # the trapped row (slot 1): every column
            path = torch.where(_shift_to_rows(prefill, n3, r_rows)[None], _shift_to_rows(targ, n3, r_rows)[None],
                               path)
            # the exiting rows (slots j + 2, j = 0 .. max_refl_dev - 1): columns 0 .. j + 1
            cols = torch.arange(cfg.depth_total, device=path.device)[:, None]
            for j in range(cfg.max_refl_dev):
                off = (j + 2) * n3
                if off >= r_rows:
                    break
                rows = _shift_to_rows(prefill, off, r_rows)
                tg = _shift_to_rows(targ, off, r_rows)
                path = torch.where(rows[None] & (cols < min(j + 2, cfg.depth_total)), tg[None], path)

    # --- reflection (normal_shader.cu:286-333)
    refl_depth = torch.where(gate, state.refl_depth + 1, state.refl_depth)
    refr_prev = torch.where(gate, refr_prev_new, state.refr_prev)
    refr_cur = torch.where(gate, refr_prev_new, state.refr_cur)

    do_refl = gate & (refl_depth < cfg.max_refl_dev)
    refl_dir = _reflect(state.seg_dir, normal_f, cfg)
    power = torch.where(do_refl, power * refl_c, power)
    k1r = normalize3c(refl_dir)
    k1r = torch.where(torch.isfinite(k1r), k1r, 0.0)
    doppler = state.doppler + torch.where(do_refl, dot3c(v_targ, k1r - k0), 0.0)
    direction = torch.where(do_refl, refl_dir, state.direction)
    seg_dir = torch.where(do_refl, refl_dir, state.seg_dir)
    tmin = torch.where(do_refl, SCENE_EPS_R, state.tmin)

    if cfg.rcs_angles:
        # reflection RCS angles -> own row (normal_shader.cu:319-326)
        k1r_azi, k1r_ele = _cart_to_sph2(-k1r)
        rcs_val = torch.stack([k0_azi + k1r_azi, k0_ele + k1r_ele], dim=0)
        rcs = _scatter_col(rcs, (refl_depth - 1) + state.refr_depth, rcs_val, do_refl)

    merged = state._replace(
        origin=origin,
        direction=direction,
        seg_dir=seg_dir,
        tmin=tmin,
        ray_length=ray_length,
        power=power,
        doppler=doppler,
        refr_prev=refr_prev,
        refr_cur=refr_cur,
        refl_depth=refl_depth,
        first_hit=first_hit,
        end=end,
        active=do_refl | (~hit_mask & state.active),
        tri_seq=tri_seq,
    )
    if spawning:
        with trace_annotation("rts.refract"):
            # the children move n3 lanes down (the uniform shift, not a scatter)
            land = _shift_down(spawn_mask, n3)
            merged = LaneState(*(torch.where(land, _shift_down(c, n3), s) for c, s in zip(child, merged)))
    return merged, TraceBuffers(path=path, rcs=rcs)


def _process_miss(state: LaneState, miss_mask, rx: RxGeomDevice, tx_origin, cfg: TraceConfig):
    """Miss program (ray_tracer.cu:260-477): receiver-sphere capture with
    the pole-wrapped acceptance windows, then Earth-sphere termination.
    The window test is the JAX package's sector form (no per-lane atan2),
    or under strict parity the reference's float32 atan2 with the phi
    fold and ``angle_in_range``."""
    four_pi_sq = (4.0 * PI) * (4.0 * PI)
    m_entry = miss_mask & ~state.end

    ray_length = state.ray_length
    power = state.power
    doppler = state.doppler
    received = state.received
    end = state.end
    cap_bits = state.cap_bits
    cap_root0_bits = state.cap_root0_bits

    d = state.direction
    a_q = dot3c(d, d)
    o = state.origin

    for rx_i in range(rx.num_rx):
        c = rx.centre[rx_i][:, None]  # [3, 1]
        b_q = 2.0 * dot3c(o - c, d)
        c_q = dot3c(o, o) + dot3c(c, c) - 2.0 * dot3c(o, c) - rx.radius[rx_i] ** 2
        disc = b_q * b_q - 4.0 * a_q * c_q
        has = m_entry & (disc > 0.0)
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        t0 = (-b_q - sq) / (2.0 * a_q)
        t1 = (-b_q + sq) / (2.0 * a_q)

        # acceptance windows with the pole-wrapped second region (cu:342-388)
        max_t1 = rx.max_theta[rx_i]
        min_t1 = rx.min_theta[rx_i]
        max_p1 = rx.max_phi[rx_i]
        min_p1 = rx.min_phi[rx_i]
        max_t2, min_t2, max_p2, min_p2 = max_t1, min_t1, max_p1, min_p1

        w_low = min_p1 < -PI / 2
        max_t2 = torch.where(w_low, max_t2 + PI, max_t2)
        min_t2 = torch.where(w_low, min_t2 + PI, min_t2)
        max_p2 = torch.where(w_low, -PI - min_p1, max_p2)
        min_p2 = torch.where(w_low, -PI / 2, min_p2)
        min_p1 = torch.where(w_low, -PI / 2, min_p1)

        w_high = max_p1 > PI / 2
        max_t2 = torch.where(w_high, max_t2 + PI, max_t2)
        min_t2 = torch.where(w_high, min_t2 + PI, min_t2)
        min_p2 = torch.where(w_high, PI - max_p1, min_p2)
        max_p2 = torch.where(w_high, PI / 2, max_p2)
        max_p1 = torch.where(w_high, PI / 2, max_p1)

        if not cfg.strict_parity:
            win_sc = [
                (torch.sin(a), torch.cos(a), torch.sin(b), torch.cos(b),
                 torch.sin(a) * torch.cos(b) - torch.cos(a) * torch.sin(b))
                for (a, b) in ((min_t1, max_t1), (min_p1, max_p1), (min_t2, max_t2), (min_p2, max_p2))
            ]

        def _sector(u, v, sc):
            """angle_in_range(atan2(v, u), a, b) without the atan2 (see
            rts_tpu.engine.wavefront._process_miss)."""
            sa, ca, sb, cb, sab = sc
            wa = u * sa - v * ca
            wb = u * sb - v * cb
            return (wa * wb < 0.0) & (wa * sab > 0.0)

        def _root_captured(ti):
            okt = (ti >= 0.0) & (ray_length + ti > SCENE_EPS) & (ray_length + ti > SCENE_EPS_R)
            rel = o + ti[None] * d - c
            if cfg.strict_parity:
                f32 = torch.float32
                theta = torch.atan2(rel[1].to(f32), rel[0].to(f32)).to(rel.dtype)
                phi = torch.atan2(rel[2].to(f32), torch.sqrt(rel[1] ** 2 + rel[0] ** 2).to(f32)).to(rel.dtype)
                # fold phi into [-pi/2, pi/2] (cu:332-340)
                low = phi < -PI / 2
                theta = torch.where(low, theta + PI, theta)
                phi = torch.where(low, -PI - phi, phi)
                high = phi > PI / 2
                theta = torch.where(high, theta + PI, theta)
                phi = torch.where(high, PI - phi, phi)
                in_win = (angle_in_range(theta, min_t1, max_t1) & angle_in_range(phi, min_p1, max_p1)) | (
                    angle_in_range(theta, min_t2, max_t2) & angle_in_range(phi, min_p2, max_p2)
                )
                return okt & in_win
            x, yy, z = rel[0], rel[1], rel[2]
            rho = torch.sqrt(x * x + yy * yy)
            x = torch.where((x == 0.0) & (yy == 0.0), 1.0, x)
            in_win = (_sector(x, yy, win_sc[0]) & _sector(rho, z, win_sc[1])) | (
                _sector(x, yy, win_sc[2]) & _sector(rho, z, win_sc[3])
            )
            return okt & in_win

        cap0 = has & _root_captured(t0)
        cap1 = has & _root_captured(t1)
        cap = cap0 | cap1
        t_cap = torch.where(cap0, t0, t1)
        end = end | cap  # set before the epsilon gates (cu:396)

        ep = o + t_cap[None] * d
        direct = (state.refl_depth == 0) & (state.refr_depth == 0)
        rx_range_direct = ep - tx_origin[:, None]
        rx_range_ind = ep - o
        len_dir = torch.sqrt(dot3c(rx_range_direct, rx_range_direct))
        len_ind = torch.sqrt(dot3c(rx_range_ind, rx_range_ind))
        cap_dir = cap & direct & (len_dir >= SCENE_EPS)
        cap_ind = cap & ~direct & (len_ind >= SCENE_EPS_R)

        power = torch.where(cap_dir, 1.0 / (four_pi_sq * dot3c(rx_range_direct, rx_range_direct)), power)
        doppler = torch.where(cap_dir, 0.0, doppler)
        power = torch.where(cap_ind, power / (dot3c(rx_range_ind, rx_range_ind) * four_pi_sq), power)
        got = cap_dir | cap_ind
        ray_length = torch.where(got, ray_length + t_cap, ray_length)
        received = torch.where(got, rx_i, received)
        bit = 1 << rx_i
        cap_bits = torch.where(got, cap_bits | bit, cap_bits)
        cap_root0_bits = torch.where(got & cap0, cap_root0_bits | bit, cap_root0_bits)

    # Earth-sphere termination (cu:438-477)
    e = miss_mask & ~end
    b_q = 2.0 * dot3c(o, d)
    c_q = dot3c(o, o) - EARTH_RADIUS**2
    disc = b_q * b_q - 4.0 * a_q * c_q
    has = e & (disc > 0.0)
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    for t_e in ((-b_q - sq) / (2.0 * a_q), (-b_q + sq) / (2.0 * a_q)):
        valid = has & (t_e >= 0.0) & (state.ray_length > 0.0)
        ray_length = torch.where(valid, ray_length + t_e, ray_length)
        end = end | valid

    return state._replace(
        ray_length=ray_length,
        power=power,
        doppler=doppler,
        received=received,
        end=end,
        active=torch.where(miss_mask, False, state.active),
        cap_bits=cap_bits,
        cap_root0_bits=cap_root0_bits,
    )


_SHADE_MAX_RX = 31  # the capture bits are int32, one a receiver


class ShadeTables(NamedTuple):
    """The operands of ``csrc/shade.cu`` that no segment of a trace
    changes, checked once a trace (``shade_tables``): the normal table
    ``tab[i * ts + k * cs]`` (k = corner * 3 + component, 9 the target)
    and how it is read, the per-target tables, the receivers and the
    transmitter."""

    tab: torch.Tensor
    ts: int
    cs: int
    smooth: bool  # interpolate the three corner normals
    shade_rows: bool  # a ClusterScene's shade rows: the target in column 9, the normal rotated by its attitude
    tri_target: torch.Tensor
    target_refl: torch.Tensor
    target_vel: torch.Tensor
    rot: torch.Tensor  # a DeviceScene's target_vel in its place: read only with ``shade_rows``
    rx: RxGeomDevice
    tx_origin: torch.Tensor


def shade_on_card(x, cfg: TraceConfig) -> bool:
    """Whether a segment whose lane state ``x`` (a leaf of it) holds is
    shaded by ``csrc/shade.cu``: float32 on a CUDA device, outside the
    parity engine's float32 narrowing form (``strict_parity``).  Float64
    state, CPU tensors and the parity engine run ``_process_miss`` and
    ``_process_hit``."""
    return x.device.type == "cuda" and x.dtype == torch.float32 and not cfg.strict_parity


def shade_shape(lanes: int, rows: int, num_rx: int, num_tris: int, num_targets: int) -> None:
    """ValueError for a ``csrc/shade.cu`` call it does not take: no lane,
    result buffers narrower than the lanes, more receivers than its int32
    capture bits hold (31), no triangle or no target to shade from.  Any
    ``tri_seq`` width and path depth is taken."""
    if lanes < 1:
        raise ValueError(f"the shading kernel takes at least one lane; got {lanes}")
    if rows < lanes:
        raise ValueError(f"the path and RCS buffers ({rows} lanes) are narrower than the {lanes} lanes traced")
    if not 0 <= num_rx <= _SHADE_MAX_RX:
        raise ValueError(f"the shading kernel takes at most {_SHADE_MAX_RX} receivers (int32 capture bits); "
                         f"got {num_rx}")
    if num_tris < 1 or num_targets < 1:
        raise ValueError(f"the shading kernel needs a triangle and a target; got {num_tris} triangles, "
                         f"{num_targets} targets")


def shade_tables(scene: ClusterScene | DeviceScene, rx: RxGeomDevice, tx_origin, cfg: TraceConfig) -> ShadeTables:
    """The scene's, receivers' and transmitter's operands of
    ``shade_cuda``, contiguous and checked (ValueError otherwise)."""
    clustered = isinstance(scene, ClusterScene)
    n_tris, nt, nr = scene.tri_target.shape[0], scene.target_refl.shape[0], rx.num_rx
    if clustered and cfg.interpolate_smooth:  # a triangle's shade row
        tab, ts, cs, shape = scene.shade_pack, 10, 1, (n_tris, 10)
    elif clustered:  # rows 0-2 of the pack: the world-frame geometric normal
        tab, ts, cs, shape = scene.tri_pack, 1, n_tris, (16, n_tris)
    elif cfg.interpolate_smooth:
        tab, ts, cs, shape = scene.tri_corner_normals, 9, 1, (n_tris, 3, 3)
    else:
        tab, ts, cs, shape = scene.tri_n, 3, 1, (n_tris, 3)
    rot = scene.rot if clustered else scene.target_vel
    tab, tri_target, refl_c, vel, rot, tx_origin = (x.contiguous() for x in (
        tab, scene.tri_target, scene.target_refl, scene.target_vel, rot, tx_origin))
    rx = RxGeomDevice(*(x.contiguous() for x in rx))
    dev, f32 = tab.device, torch.float32
    for name, x, dt, shp in (
        ("normal table", tab, f32, shape), ("tri_target", tri_target, torch.int32, (n_tris,)),
        ("target_refl", refl_c, f32, (nt,)), ("target_vel", vel, f32, (nt, 3)),
        ("rot", rot, f32, (nt, 3, 3) if clustered else (nt, 3)),
        ("rx.centre", rx.centre, f32, (nr, 3)), ("rx.radius", rx.radius, f32, (nr,)),
        ("rx.min_theta", rx.min_theta, f32, (nr,)), ("rx.max_theta", rx.max_theta, f32, (nr,)),
        ("rx.min_phi", rx.min_phi, f32, (nr,)), ("rx.max_phi", rx.max_phi, f32, (nr,)),
        ("tx_origin", tx_origin, f32, (3,)),
    ):
        CT._check(name, x, dt, shp, dev)
    smooth = cfg.interpolate_smooth
    return ShadeTables(tab, ts, cs, smooth, clustered and smooth, tri_target, refl_c, vel, rot, rx, tx_origin)


def shade_cuda(state: LaneState, bufs: TraceBuffers, hit, scene: ClusterScene | DeviceScene,
               rx: RxGeomDevice, tx_origin, cfg: TraceConfig, miss_only: bool = False,
               tables: ShadeTables | None = None):
    """One segment's ``_process_miss`` then, unless ``miss_only``, its
    ``_process_hit`` without the refraction spawn, as one launch of
    ``csrc/shade.cu``, bit-identical to them on float32 CUDA state.
    The kernel updates ``state`` and ``bufs`` in place (each lane its
    own) and returns them; it adds 1 to the counter ``shade.calls``.
    ``miss_only`` is the spawn segments' half: ``_process_hit`` with the
    spawn follows it there.  ``tables`` is ``shade_tables(scene, rx,
    tx_origin, cfg)``, made here when not given (a trace makes it once).
    A call outside the kernel's limits raises ValueError (``shade_shape``)
    before anything is checked or built."""
    lanes = state.origin.shape[1]
    path, rcs = bufs
    rows, n_tris, nt = path.shape[-1], scene.tri_target.shape[0], scene.target_refl.shape[0]
    shade_shape(lanes, rows, rx.num_rx, n_tris, nt)
    tb = tables or shade_tables(scene, rx, tx_origin, cfg)
    tab, ts, cs, by_lane = tb.tab, tb.ts, tb.cs, tb.shade_rows and hit.shade is not None
    if by_lane:  # the traversal's emitted winner rows [10, lanes], a view
        tab, ts, cs = hit.shade, hit.shade.stride(1), hit.shade.stride(0)
    dev = state.origin.device
    f32, i32, b8 = torch.float32, torch.int32, torch.bool
    if tb.tab.device != dev:
        raise ValueError(f"the shading kernel's tables are on {tb.tab.device}, the lanes on {dev}")
    width, depth = state.tri_seq.shape[0], path.shape[0]
    written = [x.data_ptr() for x in (
        state.origin, state.direction, state.seg_dir, state.tmin, state.ray_length, state.power, state.doppler,
        state.refr_prev, state.refl_depth, state.received, state.first_hit, state.end, state.active,
        state.tri_seq, state.cap_bits, state.cap_root0_bits, path, rcs) if x.numel()]
    if len(set(written)) != len(written):
        raise ValueError("the shading kernel writes the lane state in place: its fields must not share memory")
    if by_lane and (tab.device != dev or tab.dtype != f32 or tab.shape != (10, lanes)):
        raise ValueError(f"hit.shade must be float32 [10, {lanes}] on {dev}; got {tab.dtype} "
                         f"{tuple(tab.shape)} on {tab.device}")
    for name, x, dt, shp in (
        ("origin", state.origin, f32, (3, lanes)), ("direction", state.direction, f32, (3, lanes)),
        ("seg_dir", state.seg_dir, f32, (3, lanes)), ("tmin", state.tmin, f32, (lanes,)),
        ("ray_length", state.ray_length, f32, (lanes,)), ("power", state.power, f32, (lanes,)),
        ("doppler", state.doppler, f32, (lanes,)), ("refr_prev", state.refr_prev, f32, (lanes,)),
        ("refr_cur", state.refr_cur, f32, (lanes,)), ("refl_depth", state.refl_depth, i32, (lanes,)),
        ("refr_depth", state.refr_depth, i32, (lanes,)), ("received", state.received, i32, (lanes,)),
        ("first_hit", state.first_hit, f32, (3, lanes)), ("end", state.end, b8, (lanes,)),
        ("active", state.active, b8, (lanes,)), ("tri_seq", state.tri_seq, i32, (width, lanes)),
        ("cap_bits", state.cap_bits, i32, (lanes,)), ("cap_root0_bits", state.cap_root0_bits, i32, (lanes,)),
        ("hit.t", hit.t, f32, (lanes,)), ("hit.tri", hit.tri, i32, (lanes,)),
        ("hit.beta", hit.beta, f32, (lanes,)), ("hit.gamma", hit.gamma, f32, (lanes,)),
        ("hit.found", hit.found, b8, (lanes,)), ("path", path, i32, (depth, rows)),
        ("rcs", rcs, f32, (2, depth, rows)),
    ):
        CT._check(name, x, dt, shp, dev)
    lib = CT._load()
    with torch.cuda.device(dev):
        err = lib.shade_launch(
            *(x.data_ptr() for x in (
                state.origin, state.direction, state.seg_dir, state.tmin, state.ray_length, state.power,
                state.doppler, state.refr_prev, state.refr_cur, state.refl_depth, state.refr_depth,
                state.received, state.first_hit, state.end, state.active, state.tri_seq, state.cap_bits,
                state.cap_root0_bits, hit.t, hit.tri, hit.beta, hit.gamma, hit.found, tab, tb.tri_target,
                tb.rot, tb.target_refl, tb.target_vel, *tb.rx, tb.tx_origin, path, rcs)),
            lanes, rows, width, depth, tb.rx.num_rx, n_tris, nt, cfg.max_refl_dev, cfg.max_refr_dev, ts, cs,
            int(miss_only), int(cfg.rcs_angles), int(tb.smooth), int(tb.shade_rows), int(by_lane),
            SCENE_EPS, SCENE_EPS_R, EARTH_RADIUS**2, 4.0 * PI, (4.0 * PI) * (4.0 * PI),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"shade kernel launch failed: cudaError {err}")
    count("shade.calls", 1)
    return state, bufs


def _lane_sort_key(state: LaneState):
    """Sort key of the lane compaction (``TraceConfig.compact_lanes``), in
    int64 holding the JAX package's uint32 key: bit 31 = dead; below it
    the interleaved Morton code of the bounce DIRECTION (5 bits an axis,
    major) and ORIGIN (5 bits an axis, minor), so that re-formed ray tiles
    have compact frusta (secondary rays share origins but scatter in
    direction)."""
    o = state.origin  # [3, L]
    live = state.active
    big = 3.0e38
    lo = torch.where(live, o, big).amin(1)
    hi = torch.where(live, o, -big).amax(1)
    span = torch.where(hi > lo, hi - lo, 1.0)
    qo = torch.clamp((o - lo[:, None]) / span[:, None] * 31.0, 0.0, 31.0).to(torch.int64)
    d = normalize3c(state.direction)
    d = torch.where(torch.isfinite(d), d, 0.0)
    qd = torch.clamp((d + 1.0) * 15.5, 0.0, 31.0).to(torch.int64)

    def spread5(v):  # interleave 5 bits with stride 3
        v = (v | (v << 8)) & 0x0100F
        v = (v | (v << 4)) & 0x10C30C3
        return (v | (v << 2)) & 0x1249249

    def morton5(q):
        return (spread5(q[0]) << 2) | (spread5(q[1]) << 1) | spread5(q[2])

    code = (morton5(qd) << 15) | morton5(qo)
    return torch.where(live, code, code | (1 << 31))


def _init_state(cfg: TraceConfig, tx_origin, dirs) -> LaneState:
    """The lanes of a block of ``dirs`` [3, F] primaries: F of them, or 3F
    with refraction on (the trapped and exiting slots, unborn)."""
    n3 = dirs.shape[1]
    lanes = 3 * n3 if cfg.refraction_on else n3  # only chains that can exist
    dtype, dev = dirs.dtype, dirs.device
    i32 = torch.int32
    zeros = lambda *s, dt=dtype: torch.zeros(s, dtype=dt, device=dev)
    full = lambda s, v, dt=dtype: torch.full(s, v, dtype=dt, device=dev)
    pad = lambda a: a if lanes == n3 else torch.cat([a, zeros(3, lanes - n3)], 1)
    active = torch.zeros(lanes, dtype=torch.bool, device=dev)
    active[:n3] = True
    return LaneState(
        origin=tx_origin.to(dtype)[:, None].expand(3, lanes).clone(),
        direction=pad(dirs.clone()),  # the narrow segments write state in place
        seg_dir=pad(_q32(normalize3c(dirs), cfg)),
        tmin=full((lanes,), SCENE_EPS),
        ray_length=zeros(lanes),
        power=zeros(lanes),
        doppler=zeros(lanes),
        refr_prev=full((lanes,), 1.0),
        refr_cur=full((lanes,), 1.0),
        refl_depth=zeros(lanes, dt=i32),
        refr_depth=zeros(lanes, dt=i32),
        slot_base=zeros(lanes, dt=i32),
        received=full((lanes,), -1, i32),
        first_hit=zeros(3, lanes),
        end=zeros(lanes, dt=torch.bool),
        active=active,
        born=active.clone(),
        tri_seq=full((cfg.tri_seq_width, lanes), -1, i32),
        cap_bits=zeros(lanes, dt=i32),
        cap_root0_bits=zeros(lanes, dt=i32),
    )


def _narrow_budget(cfg: TraceConfig, tiles_full: int) -> int:
    """Live-tile budget of the narrow late segments (compact_narrow)."""
    if cfg.compact_narrow == -1:
        return max(8, tiles_full // 24)  # AUTO, the JAX package's measured choice
    return -(-tiles_full // cfg.compact_narrow)


def _live_tiles(active, tiles_full: int, rt: int):
    """[tiles_full] bool: the full ray tiles that hold a live lane."""
    return active[: tiles_full * rt].reshape(tiles_full, rt).any(1)


@functools.cache
def _live_counter_names(seg: int) -> tuple[str, str]:
    return f"segment.live_lanes.{seg}", f"segment.live_tiles.{seg}"


def _count_live_on_device(names, active, tiles_full: int, rt: int) -> None:
    """Count a segment's live lanes and live full tiles where the host holds
    neither: on the device, and only while a profiler records."""
    if profiling():
        count(names[0], active.sum())
        count(names[1], _live_tiles(active, tiles_full, rt).sum())


def _permute_lanes(state: LaneState, bufs: TraceBuffers, perm):
    """Every lane-indexed leaf at ``perm``; the buffers' lanes past the
    traced ones stay where they are."""
    lanes = perm.shape[0]
    front = lambda b: torch.cat([b[..., :lanes][..., perm], b[..., lanes:]], -1)
    return LaneState(*(a[..., perm] for a in state)), TraceBuffers(*(front(b) for b in bufs))


def trace_fan(
    scene: ClusterScene | DeviceScene,
    rx: RxGeomDevice,
    tx_origin,
    fan_dirs,  # [3, F] primary ray directions
    cfg: TraceConfig,
    traverse=None,  # phase-2 function for closest_hit_clustered (default: kernel on CUDA)
) -> TraceResult:
    """Trace a block of primary rays through all bounces.

    The result is ``slot_multiplier * F`` lanes wide (the reference's
    ``rayTotal`` buffer, ray_tracer.cpp:626); lanes past the traced ones
    keep their zero-fill values (ray_tracer.cu:227-240).

    ``accel="brute"`` intersects a ``DeviceScene`` by brute force;
    ``accel="cluster"`` runs the clustered traversal over a
    ``ClusterScene``, or over a ``DeviceScene`` packed and boxed on the
    fly (the sequential driver's clustered option).  On the clustered
    path three options re-form the ray tiles, each undone before the
    result is assembled: ``fan_order`` traces a full fan in a Morton tile
    order; ``compact_lanes`` sorts the lanes (dead last, live by a Morton
    key) once the spawn segments are over; ``compact_narrow`` traces a
    late segment whose live ray tiles fit its budget as those tiles only
    (plus the partial tail tile), with the rows written back.  Tile
    membership is kept within a run, so a narrow segment equals the
    full-width trace; the two orders may break an exact t tie the other
    way (the traversal visits a tile's clusters in another order).

    Each segment is an ``rts.segment`` span.  The counters
    ``segment.live_lanes.<seg>`` and ``segment.live_tiles.<seg>`` take the
    live lanes and live full ray tiles entering it (the spawn segment's
    from the fan, a narrow segment's from the counts it reads on the host,
    the others' on the device while a profiler records), and
    ``segment.narrow`` the segments traced as their live tiles only, and
    ``shade.calls`` the shading kernel's launches (one a segment traced on
    float32 CUDA state).
    With refraction on, the spawn is an ``rts.refract`` span, and while a
    profiler records the device counts ``refract.spawned.trapped``,
    ``refract.spawned.exiting`` (children born, by slot), ``refract.tir``
    (lanes that could refract but met total internal reflection) and
    ``rx.received.primary``, ``.trapped``, ``.exiting`` (received lanes,
    by slot).
    """
    dtype = scene[0].dtype  # tri_pack (ClusterScene) or tri_p0 (DeviceScene)
    dev = fan_dirs.device
    tx_origin = torch.as_tensor(tx_origin, dtype=dtype, device=dev)
    n3 = fan_dirs.shape[1]
    clustered = cfg.accel == "cluster"
    fan_perm = None
    if clustered and cfg.fan_tiling and n3 == cfg.rays_per_fan and cfg.num_rays > 4:
        fan_perm = torch.as_tensor(fan_tile_perm(cfg.num_rays, cfg.fan_order), device=dev)
        fan_dirs = fan_dirs[:, fan_perm]
    ray_total = cfg.slot_multiplier * n3
    state = _init_state(cfg, tx_origin, fan_dirs.to(dtype))
    bufs = TraceBuffers(
        path=torch.full((cfg.depth_total, ray_total), -1, dtype=torch.int32, device=dev),
        rcs=torch.full((2, cfg.depth_total, ray_total), -1000000.0, dtype=dtype, device=dev),
    )

    if clustered:
        if isinstance(scene, ClusterScene):
            tri_pack, mn, mx, shade_pack = scene.tri_pack, scene.aabb_mn, scene.aabb_mx, scene.shade_pack
        else:
            # a DeviceScene: pack the fields and box the clusters here
            tri_pack = torch.cat([scene.tri_n.T, scene.tri_c1.T, scene.tri_c0.T, scene.tri_e1.T,
                                  scene.tri_e0.T, scene.tri_np0[None]]).to(torch.float32)
            mn, mx = cluster_aabbs(scene.tri_p0, scene.tri_e0, scene.tri_e1, cfg.cluster_size,
                                   tri_target=scene.tri_target)
            shade_pack = None
        # the kernel emits the winner's shade row only where the smooth-
        # shading consumer reads it (the JAX gate, minus its 32-row pack
        # condition)
        emit_shade = cfg.shade_emit and cfg.interpolate_smooth and shade_pack is not None

        def hit_fn(origin, direction, tmin):
            return closest_hit_clustered(
                origin, direction, tmin, tri_pack, mn, mx, tx_origin,
                cluster_size=cfg.cluster_size, ray_tile=cfg.ray_tile, group_size=cfg.group_size,
                super_size=cfg.super_size, sub_tiles=cfg.sub_tiles, candidates=cfg.candidates,
                mt_group=cfg.mt_group, mt_union=cfg.mt_union, mt_tail=cfg.mt_tail,
                mt_prune=cfg.mt_prune, cand_order=cfg.cand_order, resident_cap=cfg.resident_cap,
                p1_fanout=cfg.p1_fanout, p1_super_k=cfg.p1_super_k,
                p1_fanout0=cfg.p1_fanout0, p1_super_k0=cfg.p1_super_k0,
                emit_shade=emit_shade, shade_pack=shade_pack, traverse=traverse,
            )
    else:

        def hit_fn(origin, direction, tmin):
            return closest_hit_bruteforce(
                origin.T, direction.T, tmin, scene.tri_p0, scene.tri_e0, scene.tri_e1,
                scene.tri_n, scene.tri_c1, scene.tri_c0, scene.tri_np0, tri_chunk=cfg.tri_chunk,
            )

    on_card = shade_on_card(state.origin, cfg)
    tables = shade_tables(scene, rx, tx_origin, cfg) if on_card else None

    def body(state, bufs, spawn):
        # dead lanes trace with a zero direction: the slab tests drop them
        live_dir = torch.where(state.active, state.direction, 0.0)
        hit = hit_fn(state.origin, live_dir, state.tmin)
        if on_card and not (spawn and cfg.refraction_on):
            return shade_cuda(state, bufs, hit, scene, rx, tx_origin, cfg, tables=tables)
        hit_mask = state.active & hit.found
        if on_card:  # a spawn segment: the kernel's miss half, then the spawning hit
            state, _ = shade_cuda(state, bufs, hit, scene, rx, tx_origin, cfg, miss_only=True, tables=tables)
        else:
            state = _process_miss(state, state.active & ~hit.found, rx, tx_origin, cfg)
        return _process_hit(state, bufs, hit, hit_mask, scene, tx_origin, cfg, n3, spawn=spawn)

    # Children spawn only in the first segments (a primary's first hit is
    # segment 1, its trapped child's segment 2); after them the lane order
    # is free and the spawn work is skipped.
    spawn_segments = min(cfg.num_segments, 2 if cfg.refraction_on else 1)
    lanes = state.origin.shape[1]
    rt = cfg.ray_tile
    tiles_full = lanes // rt
    narrow = cfg.compact_narrow not in (0, 1) and clustered
    nt = _narrow_budget(cfg, tiles_full) if narrow else tiles_full
    lane_perm = None
    for seg in range(cfg.num_segments):
        with trace_annotation("rts.segment"):
            live_names = _live_counter_names(seg)
            if seg == 0:  # the spawn segment holds the whole fan
                count(live_names[0], n3)
                count(live_names[1], min(tiles_full, -(-n3 // rt)))
            if seg < spawn_segments:
                if seg:
                    _count_live_on_device(live_names, state.active, tiles_full, rt)
                state, bufs = body(state, bufs, spawn=True)
                continue
            if seg == spawn_segments and cfg.compact_lanes and clustered:
                lane_perm = torch.argsort(_lane_sort_key(state), stable=True)
                state, bufs = _permute_lanes(state, bufs, lane_perm)
            if nt >= tiles_full:
                _count_live_on_device(live_names, state.active, tiles_full, rt)
                state, bufs = body(state, bufs, spawn=False)
                continue
            n_live = int(state.active.sum())
            count(live_names[0], n_live)
            if n_live == 0:
                count(live_names[1], 0)
                continue  # every update is gated on active: a dead segment is a no-op
            live_t = _live_tiles(state.active, tiles_full, rt)
            n_tiles = int(live_t.sum())
            count(live_names[1], n_tiles)
            if n_tiles > nt:
                state, bufs = body(state, bufs, spawn=False)
                continue
            count("segment.narrow", 1)
            # live tiles first (stable, by tile index), then the partial tail
            t_order = torch.argsort((~live_t).to(torch.int8), stable=True)[:nt]
            rows = (t_order[:, None] * rt + torch.arange(rt, device=dev)).reshape(-1)
            rows = torch.cat([rows, torch.arange(tiles_full * rt, lanes, device=dev)])
            s_n, b_n = body(
                LaneState(*(a[..., rows] for a in state)),
                TraceBuffers(path=bufs.path[..., rows], rcs=bufs.rcs[..., rows]),
                spawn=False,
            )
            for a, b in zip(state, s_n):
                a[..., rows] = b
            bufs.path[..., rows] = b_n.path
            bufs.rcs[..., rows] = b_n.rcs
    if lane_perm is not None:
        inv = torch.empty_like(lane_perm)
        inv[lane_perm] = torch.arange(lanes, device=dev)
        state, bufs = _permute_lanes(state, bufs, inv)
    if cfg.refraction_on and profiling():
        got = state.received >= 0
        for s, name in enumerate(("rx.received.primary", "rx.received.trapped", "rx.received.exiting")):
            count(name, got[s * n3:(s + 1) * n3].sum())

    def fill(x, value):
        if lanes == ray_total:
            return x
        return torch.cat([x, torch.full(x.shape[:-1] + (ray_total - lanes,), value, dtype=x.dtype,
                                        device=dev)], -1)

    res = TraceResult(
        ray_length=fill(state.ray_length, 0.0),
        power=fill(state.power, 0.0),
        doppler=fill(state.doppler, 0.0),
        received=fill(state.received, -1),
        refl_depth=fill(state.refl_depth, 0),
        refr_depth=fill(state.refr_depth, 0),
        first_hit=fill(state.first_hit, 0.0),
        # never-spawned slots report the zero-fill prevHitPoint (cu:234)
        prev_hit=fill(torch.where(state.born, state.origin, 0.0), 0.0),
        path=bufs.path,
        rcs=bufs.rcs,
        tri_seq=fill(state.tri_seq, -1),
        cap_bits=fill(state.cap_bits, 0),
        cap_root0_bits=fill(state.cap_root0_bits, 0),
        ray_length_lo=torch.zeros(ray_total, dtype=dtype, device=dev),
    )
    if fan_perm is None:
        return res
    # back to the launch order, in every slot
    inv = torch.argsort(fan_perm)
    rows = torch.cat([s * n3 + inv for s in range(cfg.slot_multiplier)])
    return TraceResult(*(a[..., rows] for a in res))


def trace_pulse(
    scene: DeviceScene,
    rx: RxGeomDevice,
    tx_origin,
    tx_dir,  # (azimuth, elevation) boresight
    tx_span,  # (azimuth span, elevation span, launch range)
    cfg: TraceConfig,
) -> TraceResult:
    """Trace one full pulse: the analogue of rtContextLaunch3D
    (ray_tracer.cpp:1165) plus all recursive bounces, on the scene's
    device and in its dtype."""
    p0 = scene.tri_p0
    fan = generate_fan_c(cfg.num_rays, tx_dir, tx_span, dtype=p0.dtype, device=p0.device)
    return trace_fan(scene, rx, tx_origin, fan, cfg)
