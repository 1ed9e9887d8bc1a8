"""Wavefront multi-bounce tracer, reflections only (counterpart of
``rts_tpu.engine.wavefront``).

All ray chains advance in lock-step as lanes through a fixed number of
segment iterations; terminated lanes are masked, never compacted.  Gates
mirror the reference's closest-hit program (normal_shader.cu: entry gate
:134, path record :139-146, power legs :159-173, reflection :286-333) and
miss program (ray_tracer.cu:260-477).

Two intersectors feed the loop, as in the JAX package: the brute-force
one over a ``DeviceScene`` (``accel="brute"``, any dtype; the default and,
in float64, the parity engine) and the clustered CUDA traversal over a
``ClusterScene`` (``accel="cluster"``, float32).  ``strict_parity``
applies the reference's float32 narrowing points (``_q32``): the hit
distance, the shading normal, the bounce direction and the atan2 form of
the receiver window test.

The JAX package's ``lax.cond`` branches become Python ``if``s on counts
read back from the device, and its ``fori_loop``s Python loops.
Refraction (the +N^3 child-lane shift), Morton fan tiling and lane
compaction are not ported yet: ``trace_fan`` refuses them (ROADMAP A.4).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from rts_tpu_torch.core.constants import EARTH_RADIUS, SCENE_EPS, SCENE_EPS_R
from rts_tpu_torch.accel.cluster import cluster_aabbs
from rts_tpu_torch.core.vec import angle_in_range, dot3c, normalize3c
from rts_tpu_torch.engine.animate import ClusterScene
from rts_tpu_torch.engine.fan import generate_fan_c
from rts_tpu_torch.engine.intersect import closest_hit_bruteforce
from rts_tpu_torch.engine.types import DeviceScene, RxGeomDevice, TraceConfig
from rts_tpu_torch.ops.cluster_trace import closest_hit_clustered

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


def _cart_to_sph2(v):
    azi = torch.atan2(v[1], v[0])
    ele = torch.atan2(v[2], torch.sqrt(v[0] ** 2 + v[1] ** 2))
    return azi, ele


def _scatter_col(buf, col, value, mask):
    """Masked per-lane write buf[..., col[l], l] = value[..., l] where mask."""
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
                 scene: ClusterScene | DeviceScene, tx_origin, cfg: TraceConfig):
    """Closest-hit program (normal_shader.cu:128-340), reflection only.
    A ``ClusterScene`` shades from the static base normals rotated per
    lane; a ``DeviceScene`` holds world-frame normals already."""
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

    # --- reflection (normal_shader.cu:286-333)
    refr_prev_new = state.refr_cur
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

    rcs = bufs.rcs
    if cfg.rcs_angles:
        # reflection RCS angles -> own row (normal_shader.cu:319-326)
        k0_azi, k0_ele = _cart_to_sph2(k0)
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


def _init_state(cfg: TraceConfig, tx_origin, dirs) -> LaneState:
    n3 = dirs.shape[1]  # dirs [3, F]
    dtype, dev = dirs.dtype, dirs.device
    i32 = torch.int32
    zeros = lambda *s, dt=dtype: torch.zeros(s, dtype=dt, device=dev)
    full = lambda s, v, dt=dtype: torch.full(s, v, dtype=dt, device=dev)
    active = torch.ones(n3, dtype=torch.bool, device=dev)
    return LaneState(
        origin=tx_origin.to(dtype)[:, None].expand(3, n3).clone(),
        direction=dirs.clone(),  # the narrow segments write state in place
        seg_dir=_q32(normalize3c(dirs), cfg),
        tmin=full((n3,), SCENE_EPS),
        ray_length=zeros(n3),
        power=zeros(n3),
        doppler=zeros(n3),
        refr_prev=full((n3,), 1.0),
        refr_cur=full((n3,), 1.0),
        refl_depth=zeros(n3, dt=i32),
        refr_depth=zeros(n3, dt=i32),
        slot_base=zeros(n3, dt=i32),
        received=full((n3,), -1, i32),
        first_hit=zeros(3, n3),
        end=zeros(n3, dt=torch.bool),
        active=active,
        born=active.clone(),
        tri_seq=full((cfg.tri_seq_width, n3), -1, i32),
        cap_bits=zeros(n3, dt=i32),
        cap_root0_bits=zeros(n3, dt=i32),
    )


def _narrow_budget(cfg: TraceConfig, tiles_full: int) -> int:
    """Live-tile budget of the narrow late segments (compact_narrow)."""
    if cfg.compact_narrow == -1:
        return max(8, tiles_full // 24)  # AUTO, the JAX package's measured choice
    return -(-tiles_full // cfg.compact_narrow)


def trace_fan(
    scene: ClusterScene | DeviceScene,
    rx: RxGeomDevice,
    tx_origin,
    fan_dirs,  # [3, F] primary ray directions
    cfg: TraceConfig,
    traverse=None,  # phase-2 function for closest_hit_clustered (default: kernel on CUDA)
) -> TraceResult:
    """Trace a block of primary rays through all bounces.

    ``accel="brute"`` intersects a ``DeviceScene`` by brute force;
    ``accel="cluster"`` runs the clustered traversal over a
    ``ClusterScene``, or over a ``DeviceScene`` packed and boxed on the
    fly (the sequential driver's clustered option).  ``compact_narrow``
    keeps the JAX package's narrow late segments on the clustered path:
    once the live ray tiles of a segment after the first fit the budget,
    only those tiles (plus the partial tail tile) are traced and the rows
    written back.  Tile membership is preserved, so results are identical
    to the full-width trace.
    """
    if cfg.refraction_on:
        raise NotImplementedError("refraction is not ported to rts_tpu_torch yet (ROADMAP A.4)")
    for flag, name in ((cfg.fan_tiling, "fan_order"), (cfg.compact_lanes, "compact_lanes")):
        if flag:
            raise NotImplementedError(f"TraceConfig.{name} is not ported to rts_tpu_torch yet (ROADMAP A.4)")
    dtype = scene[0].dtype  # tri_pack (ClusterScene) or tri_p0 (DeviceScene)
    tx_origin = torch.as_tensor(tx_origin, dtype=dtype, device=fan_dirs.device)
    n3 = fan_dirs.shape[1]
    state = _init_state(cfg, tx_origin, fan_dirs.to(dtype))
    bufs = TraceBuffers(
        path=torch.full((cfg.depth_total, n3), -1, dtype=torch.int32, device=fan_dirs.device),
        rcs=torch.full((2, cfg.depth_total, n3), -1000000.0, dtype=dtype, device=fan_dirs.device),
    )

    if cfg.accel == "cluster":
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

    def body(state, bufs):
        # dead lanes trace with a zero direction: the slab tests drop them
        live_dir = torch.where(state.active, state.direction, 0.0)
        hit = hit_fn(state.origin, live_dir, state.tmin)
        hit_mask = state.active & hit.found
        miss_mask = state.active & ~hit.found
        state = _process_miss(state, miss_mask, rx, tx_origin, cfg)
        return _process_hit(state, bufs, hit, hit_mask, scene, tx_origin, cfg)

    rt = cfg.ray_tile
    tiles_full = n3 // rt
    narrow = cfg.compact_narrow not in (0, 1) and cfg.accel == "cluster"
    nt = _narrow_budget(cfg, tiles_full) if narrow else tiles_full
    for seg in range(cfg.num_segments):
        if seg == 0 or nt >= tiles_full:
            state, bufs = body(state, bufs)
            continue
        n_live = int(state.active.sum())
        if n_live == 0:
            continue  # every update is gated on active: a dead segment is a no-op
        live_t = state.active[: tiles_full * rt].reshape(tiles_full, rt).any(1)
        if int(live_t.sum()) > nt:
            state, bufs = body(state, bufs)
            continue
        # live tiles first (stable, by tile index), then the partial tail
        t_order = torch.argsort((~live_t).to(torch.int8), stable=True)[:nt]
        rows = (t_order[:, None] * rt + torch.arange(rt, device=t_order.device)).reshape(-1)
        rows = torch.cat([rows, torch.arange(tiles_full * rt, n3, device=rows.device)])
        s_n, b_n = body(
            LaneState(*(a[..., rows] for a in state)),
            TraceBuffers(path=bufs.path[..., rows], rcs=bufs.rcs[..., rows]),
        )
        for a, b in zip(state, s_n):
            a[..., rows] = b
        bufs.path[..., rows] = b_n.path
        bufs.rcs[..., rows] = b_n.rcs

    return TraceResult(
        ray_length=state.ray_length,
        power=state.power,
        doppler=state.doppler,
        received=state.received,
        refl_depth=state.refl_depth,
        refr_depth=state.refr_depth,
        first_hit=state.first_hit,
        # never-spawned slots report the zero-fill prevHitPoint (cu:234)
        prev_hit=torch.where(state.born, state.origin, 0.0),
        path=bufs.path,
        rcs=bufs.rcs,
        tri_seq=state.tri_seq,
        cap_bits=state.cap_bits,
        cap_root0_bits=state.cap_root0_bits,
        ray_length_lo=torch.zeros_like(state.ray_length),
    )


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
