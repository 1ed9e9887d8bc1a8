"""Float64 path replay: the f32 engine's route to the 1e-6 power/phase bar
(counterpart of ``rts_tpu.engine.replay``).

The f32 wavefront makes every DISCRETE decision: which triangle wins each
segment (``TraceResult.tri_seq``), which receivers capture a lane and with
which quadratic root (``cap_bits``/``cap_root0_bits``).  This module
replays the CONTINUOUS quantities along that recorded chain in float64 on
the device (fan direction, animated hit-triangle corners, the
Moller-Trumbore t, leg lengths, spreading power, Doppler, smooth-normal
interpolation, the receiver-sphere quadratic), so received lanes get
ray lengths, power and Doppler with f64 precision.  The JAX package does
the same in double-single arithmetic (``rts_tpu.core.ds``) because the
TPU has no f64; the card has it natively, so there is no ds layer here.

Only received lanes are replayed (compacted to a ``replay_cap`` block
first, as in the JAX package), decisions and discrete fields pass
through untouched, and the refined ray length is returned as the f32
pair (``ray_length``, ``ray_length_lo``) the JAX package returns, with
``ray_length + ray_length_lo`` equal to the f64 length to ~2^-48.

Refraction happens only at a chain's first intersection (refl_depth ==
0, normal_shader.cu:191-281), so the refracting steps are static per
slot of the lane layout: slot 0 reflects at every recorded step, slot 1
(the trapped chains) refracts at step 0, slot 2 (the exiting chains) at
steps 0 and 1; every later step reflects.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from rts_tpu_torch.engine.compact import received_first_idx, take_lanes
from rts_tpu_torch.utils.timing import count, profiling, trace_annotation

FOUR_PI = 4.0 * math.pi


def _dot(a, b):
    """Per-lane dot of two [3, L] component tensors."""
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _cross(a, b):
    return torch.stack([
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    ])


def _unit(v):
    return v / torch.sqrt(_dot(v, v))


def _refract(i, n, ior):
    """OptiX refract in f64 (``engine.wavefront._refract`` without the
    strict-parity narrowing): the backface flip, and k clamped at 0 (a
    lane the f32 trace refracted has k >= 0 up to rounding)."""
    ndotv = _dot(i, n)
    backface = ndotv > 0.0
    eta = torch.where(backface, ior, 1.0 / ior)
    nn = torch.where(backface, -n, n)
    neg_ndotv = torch.where(backface, -ndotv, ndotv)
    k = 1.0 - eta * eta * (1.0 - neg_ndotv * neg_ndotv)
    return _unit(eta * i - (eta * neg_ndotv + torch.sqrt(torch.clamp(k, min=0.0))) * nn)


def _rotate(r, v):
    """Per-lane r [L, 3, 3] @ v [3, L] -> [3, L]."""
    return torch.stack([_dot(r[:, i].T, v) for i in range(3)])


def _fan_dirs(num_rays: int, tx_span, fan_rot, bore, f_idx):
    """Primary direction [3, L] of the fan cells ``f_idx`` in f64 (the
    grid of ``engine.fan.generate_fan_c`` rotated by the pulse's composed
    rotation ``fan_rot``; the boresight when ``num_rays == 1``)."""
    lanes = f_idx.shape[0]
    if num_rays == 1:
        return bore[:, None].expand(3, lanes)
    n = num_rays
    az_span, el_span, launch_range = (float(v) for v in tx_span)
    bs = np.array([math.cos(-el_span / 2) * math.cos(-az_span / 2),
                   math.cos(-el_span / 2) * math.sin(-az_span / 2), math.sin(-el_span / 2)])
    be = np.array([math.cos(el_span / 2) * math.cos(az_span / 2),
                   math.cos(el_span / 2) * math.sin(az_span / 2), math.sin(el_span / 2)])
    step = np.array([(be[0] * (1.0 + launch_range) - bs[0]) / (n - 1),
                     (be[1] - bs[1]) / (n - 1), (be[2] - bs[2]) / (n - 1)])
    idx = (f_idx % n, (f_idx // n) % n, f_idx // (n * n))
    raw = torch.stack([float(bs[a]) + float(step[a]) * idx[a].to(torch.float64) for a in range(3)])
    return _rotate(fan_rot.expand(lanes, 3, 3), _unit(raw))


def replay_refine(base, res, cfg, extras, *, tx_span, fan_block: int | None = None, fan_offset: int = 0):
    """Re-evaluate ray_length/power/doppler along the recorded chains.

    ``base`` is a SceneBase built with its f64 fields (``scene_base(...,
    with_f64=True)``), ``res`` the pulse's f32 TraceResult and ``extras``
    the pulse's row of ``engine.cpi.RefineExtras``.  Returns ``res`` with
    refined ray_length (+ ray_length_lo), power and doppler on received
    lanes; every other lane and every discrete field passes through.

    ``res`` traced the ``fan_block`` fan cells from ``fan_offset`` on (a
    ray block of a split fan; by default the whole fan, N^3 from 0): lane
    ``l`` is slot ``l // fan_block`` of fan cell ``fan_offset + l %
    fan_block``.

    With ``cfg.replay_cap`` smaller than the lane count, the received
    lanes (in lane order) are gathered to a block of ``replay_cap`` lanes
    and only they are replayed.  The received count is read on the host
    first, and a pulse that received more than the cap grows its block to
    the count rounded up to a multiple of the cap
    (``sim.check_replay_overflow`` warns of it).  Every received lane is
    refined, whatever the cap.

    The call is the ``rts.replay`` span.  The counters ``replay.lanes``
    (received lanes refined) and ``replay.overflow`` (those of them past
    the cap) take the count the capped path reads on the host; without a
    cap every lane is replayed, and the received ones are counted on the
    device while a profiler records.  ``replay.unrefined`` (received lanes
    left in float32) is 0 on both paths.
    """
    if extras is None or base.tri_verts_f64 is None:
        raise ValueError("refine=True needs the float64 replay state: build it with "
                         "sim.prepare_cpi(..., refine=True)")
    with trace_annotation("rts.replay"):
        fan_block = cfg.rays_per_fan if fan_block is None else fan_block
        total = res.ray_length.shape[0]
        cap = min(cfg.replay_cap, total) if cfg.replay_cap else total
        if cap >= total:
            if profiling():
                count("replay.lanes", (res.received >= 0).sum())
            count("replay.unrefined", 0)
            return _replay_core(base, res, cfg, extras, tx_span, fan_block, fan_offset, lane_ids=None)

        # the block holds every received lane: the cap, or the received
        # count rounded up to a multiple of it
        received = int((res.received >= 0).sum())
        size = min(cap * max(1, -(-received // cap)), total)
        idx = received_first_idx(res.received, size)
        sub = type(res)(*(take_lanes(a, idx) for a in res))
        sub = sub._replace(received=take_lanes(res.received, idx, fill=-1))
        out = _replay_core(base, sub, cfg, extras, tx_span, fan_block, fan_offset, lane_ids=idx)
        count("replay.lanes", received)
        count("replay.overflow", max(received - cap, 0))
        count("replay.unrefined", 0)
        merged = {}
        for name in ("ray_length", "ray_length_lo", "power", "doppler"):
            a = getattr(res, name).clone()
            a[idx[:received]] = getattr(out, name)[:received]  # filler slots past the count are dropped
            merged[name] = a
        return res._replace(**merged)


def _replay_core(base, res, cfg, extras, tx_span, fan_block, fan_offset, lane_ids):
    f64 = torch.float64
    dev = res.ray_length.device
    lanes = res.ray_length.shape[0]
    nt = base.target_refl.shape[0]
    lane = torch.arange(lanes, device=dev) if lane_ids is None else lane_ids.long()
    slot = lane // fan_block  # 0 primary, 1 trapped, 2 exiting
    f_idx = fan_offset + lane % fan_block  # a child keeps its primary's fan cell

    d_raw = _fan_dirs(cfg.num_rays, tx_span, extras.fan_rot, extras.bore, f_idx)
    direction = d_raw  # step 0's t is parametric in the unnormalised direction
    seg_dir = _unit(d_raw) if cfg.num_rays > 1 else d_raw
    txo = extras.tx_origin[:, None].expand(3, lanes)
    origin = txo
    rl = torch.zeros(lanes, dtype=f64, device=dev)
    power = torch.ones(lanes, dtype=f64, device=dev)
    dop = torch.zeros(lanes, dtype=f64, device=dev)
    refr_cur = torch.ones(lanes, dtype=f64, device=dev)  # refrIndex.y; .x is its previous value

    for c in range(res.tri_seq.shape[0]):
        tri = res.tri_seq[c]
        have = tri >= 0
        tri_s = tri.clamp(0, base.tri_verts_f64.shape[0] - 1).long()
        targ = base.tri_target[tri_s].clamp(0, nt - 1).long()
        rot = extras.rot[targ]  # [L, 3, 3]
        shift = extras.pos[targ].T  # [3, L]
        v0, v1, v2 = (_rotate(rot, base.tri_verts_f64[tri_s, k].T) + shift for k in range(3))
        e0 = v1 - v0
        e1 = v0 - v2
        nrm_g = _cross(e1, e0)  # geometric normal (reference convention)
        q = v0 - origin
        denom = _dot(nrm_g, direction)
        t = _dot(nrm_g, q) / denom
        hp = origin + direction * t
        leg = hp - (txo if c == 0 else origin)
        spread = 1.0 / (_dot(leg, leg) * FOUR_PI)
        power_new = spread if c == 0 else power * spread

        if cfg.interpolate_smooth:
            beta = _dot(direction, _cross(q, e1)) / denom
            gamma = _dot(direction, _cross(q, e0)) / denom
            cn = base.tri_corner_normals_f64[tri_s]  # [L, corner, comp]
            nrm_b = cn[:, 1].T * beta + cn[:, 2].T * gamma + cn[:, 0].T * (1.0 - beta - gamma)
            nrm = _rotate(rot, nrm_b)  # rotation is linear: interpolate, then rotate
        else:
            nrm = nrm_g
        nrm = _unit(nrm)

        k0 = _unit(direction)
        # reflect: r = i - 2 n (i . n), not renormalised (engine semantics)
        d_new = seg_dir - nrm * (2.0 * _dot(seg_dir, nrm))
        refl_c = base.target_refl_f64[targ]
        if cfg.refraction_on and c < 2:
            # refract at the slot's static refraction steps; the engine
            # tests the index against 1 in its f32 value
            refract_here = (slot >= 1) if c == 0 else (slot == 2)
            at_unity = refr_cur.to(torch.float32) == 1.0
            refr_cur_child = torch.where(at_unity, base.target_refr_f64[targ], 1.0)
            d_new = torch.where(refract_here, _refract(seg_dir, nrm, refr_cur_child / refr_cur), d_new)
            # the refracted share (1 - |rc|) unless the reflection budget
            # is spent (normal_shader.cu:244-246)
            share = 1.0 - refl_c.abs() if cfg.max_refl_dev > 1 else torch.ones_like(refl_c)
            refl_c = torch.where(refract_here, share, refl_c)
            refr_cur = torch.where(have & refract_here, refr_cur_child, refr_cur)
        power_new = power_new * refl_c
        dop_new = dop + _dot(extras.vel[targ].T, _unit(d_new) - k0)

        rl = torch.where(have, rl + t, rl)
        power = torch.where(have, power_new, power)
        dop = torch.where(have, dop_new, dop)
        origin = torch.where(have, hp, origin)
        direction = torch.where(have, d_new, direction)
        seg_dir = torch.where(have, d_new, seg_dir)

    # receiver capture legs (the miss stage's quadratic, the recorded root)
    four_pi_sq = FOUR_PI * FOUR_PI
    direct = (res.refl_depth == 0) & (res.refr_depth == 0)
    a_q = _dot(direction, direction)
    for rx_i in range(extras.rx_radius.shape[0]):
        got = (res.cap_bits & (1 << rx_i)) != 0
        root0 = (res.cap_root0_bits & (1 << rx_i)) != 0
        oc = origin - extras.rx_centre[rx_i][:, None]
        b_q = _dot(oc, direction)  # b / 2
        c_q = _dot(oc, oc) - extras.rx_radius[rx_i] ** 2
        sq = torch.sqrt(torch.clamp(b_q * b_q - a_q * c_q, min=0.0))
        t_cap = torch.where(root0, -b_q - sq, -b_q + sq) / a_q
        ep = origin + direction * t_cap
        rng = torch.where(direct, ep - txo, ep - origin)
        rng_sq = _dot(rng, rng)
        power = torch.where(got & direct, 1.0 / (four_pi_sq * rng_sq), power)
        power = torch.where(got & ~direct, power / (rng_sq * four_pi_sq), power)
        dop = torch.where(got & direct, 0.0, dop)
        rl = torch.where(got, rl + t_cap, rl)

    # merge refined values into received lanes only
    received = res.received >= 0
    out_dtype = res.ray_length.dtype
    rl_hi = rl.to(out_dtype)
    return res._replace(
        ray_length=torch.where(received, rl_hi, res.ray_length),
        ray_length_lo=torch.where(received, (rl - rl_hi.to(f64)).to(out_dtype), 0.0),
        power=torch.where(received, power.to(out_dtype), res.power),
        doppler=torch.where(received, dop.to(out_dtype), res.doppler),
    )
