"""The plain reference of a CPI: every lane traced again in float64.

A straightforward wavefront tracer in plain PyTorch, written from the
radar tracer's published semantics (ray generation, closest hit with the
double Moller-Trumbore test, reflection with smooth normals, capture by
the receivers' spheres and windows, the Earth-sphere termination, the
post-processing and the coherent multipath aggregation).  It takes
isotropic antennas and isotropic RCS.

With refraction on (``max_refr_depth`` 2) it keeps the tracer's static
slot layout: a chain's refracted child lives one slot (N^3 lanes) below
it, so the primaries fill [0, N^3), the chains trapped in a target after
their first refraction [N^3, 2N^3), and the chains that refracted out of
it again [2N^3, 3N^3).  The result is ``max_refl_depth + 3`` slots wide,
as the tracer's ray buffer is; the slots past the third are never traced.

To stay fast it finds each ray's candidate triangles through boxes of
its own: each target's triangles are sorted by a Morton code of their
centroids and cut into blocks of ``BLOCK`` triangles, the blocks into
groups of ``GROUP``; a ray is tested against every triangle of every
block whose box (padded by a millimetre) it enters, inside every group
whose box it enters.  That prunes no triangle a ray can hit, so the closest hit is
the brute-force one.  Identical launch directions (the fan repeats each
direction along its launch-range axis when that range is 0) are traced
once and broadcast back to their lanes.

``dtype`` is the type the trace computes in: float64 for the reference,
bfloat16 for the control that stands in for a lower-precision traversal.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from benchmark.reference.scene import EARTH_RADIUS, SCENE_EPS, Scene, fan_directions

BLOCK = 128
GROUP = 32  # blocks a group box holds
_PAD = 1e-3  # box padding [m]
_T_MAX = float(np.float32(1e27))  # the tracer's default ray extent
_PAIR_CHUNK = 1 << 15  # (ray, block) pairs tested at once


class Lanes(NamedTuple):
    """One pulse's lanes after the trace and the post-processing ([R])."""

    received: torch.Tensor  # int64, -1 = not received
    power: torch.Tensor  # post-processed power of received lanes, traced power elsewhere
    doppler: torch.Tensor  # Doppler [Hz] of received lanes, the raw sum elsewhere
    delay: torch.Tensor  # ray length / c
    ray_length: torch.Tensor
    refl_depth: torch.Tensor
    path: torch.Tensor  # [R, D] target of each recorded hit, -1 empty
    refr_depth: torch.Tensor  # refractions the lane's chain took (0, 1, 2)


class Aggregate(NamedTuple):
    """The coherent multipath aggregate of each lane ([R])."""

    npath: torch.Tensor
    power: torch.Tensor
    delay: torch.Tensor
    phase: torch.Tensor
    doppler: torch.Tensor
    path_match: torch.Tensor
    emit: torch.Tensor


def _morton(c: np.ndarray) -> np.ndarray:
    q = np.clip(((c - c.min(0)) / np.maximum(np.ptp(c, 0), 1e-30) * 1023).astype(np.int64), 0, 1023)
    code = np.zeros(len(c), np.int64)
    for b in range(10):
        for k in range(3):
            code |= ((q[:, k] >> b) & 1) << (3 * b + k)
    return code


class Geometry:
    """The scene's triangles on ``device``, their blocks and the blocks'
    groups.  Targets move by translation only, so a pose shifts the base
    corners and boxes of each target by its centre."""

    def __init__(self, scene: Scene, device, dtype=torch.float64):
        self.device = device
        self.dtype = dtype
        blocks, groups = [], []
        for j in range(len(scene.refl)):
            idx = np.flatnonzero(scene.target == j)
            idx = idx[np.argsort(_morton(scene.corners[idx].mean(1)), kind="stable")]
            rows = np.concatenate([idx, np.full((-len(idx)) % BLOCK, -1)]).reshape(-1, BLOCK)
            first = sum(len(b) for b in blocks)
            blocks.append(rows)
            ids = np.arange(first, first + len(rows))
            groups.append(np.concatenate([ids, np.full((-len(ids)) % GROUP, -1)]).reshape(-1, GROUP))
        t = lambda a: torch.as_tensor(a, device=device)
        self.block_tris = t(np.concatenate(blocks))  # [B, BLOCK], -1 pad
        self.group_blocks = t(np.concatenate(groups))  # [G, GROUP], -1 pad
        f64 = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float64), device=device)
        c = f64(scene.corners)
        self.normals = f64(scene.normals)
        self.target = t(scene.target)
        self.refl = f64(scene.refl)
        self.refr = f64(scene.refr)
        self.block_target = self.target[self.block_tris[:, 0]]
        self.group_target = self.block_target[self.group_blocks[:, 0]]
        self.p0, self.e0, self.e1 = c[:, 0], c[:, 1] - c[:, 0], c[:, 0] - c[:, 2]
        self.n = torch.linalg.cross(self.e1, self.e0)
        live = (self.block_tris >= 0)[:, :, None, None]
        bc = c[self.block_tris.clamp(min=0)]
        self.block_mn = torch.where(live, bc, math.inf).amin((1, 2)) - _PAD
        self.block_mx = torch.where(live, bc, -math.inf).amax((1, 2)) + _PAD
        gl = (self.group_blocks >= 0)[:, :, None]
        gb = self.group_blocks.clamp(min=0)
        self.group_mn = torch.where(gl, self.block_mn[gb], math.inf).amin(1)
        self.group_mx = torch.where(gl, self.block_mx[gb], -math.inf).amax(1)

    def pose(self, pos: np.ndarray):
        """(p0, e0, e1, n) in the trace's type, and the float64 boxes of the
        blocks and groups, with the targets centred at ``pos`` [NT, 3]."""
        shift = torch.as_tensor(np.asarray(pos, np.float64), device=self.device)
        t = lambda a: a.to(self.dtype)
        tris = (t(self.p0 + shift[self.target]), t(self.e0), t(self.e1), t(self.n))
        bs, gs = shift[self.block_target], shift[self.group_target]
        return tris, (self.block_mn + bs, self.block_mx + bs, self.group_mn + gs, self.group_mx + gs)


def _slab(o, d, mn, mx):
    """[R, K] entry and exit distances of R rays into boxes ([R or 1, K, 3],
    float64)."""
    o, d = o[:, None, :], d[:, None, :]
    inside = (mn <= o) & (o <= mx)
    t1 = (mn - o) / d
    t2 = (mx - o) / d
    zero = d == 0
    lo = torch.where(zero, torch.where(inside, -math.inf, math.inf), torch.minimum(t1, t2))
    hi = torch.where(zero, torch.where(inside, math.inf, -math.inf), torch.maximum(t1, t2))
    return lo.amax(-1), hi.amin(-1)


def closest_hit(geo: Geometry, tris, boxes, o, d, tmin, live):
    """(found, t, tri, beta, gamma) [R] of rays ``o + t d`` over the
    triangles, the nearest valid hit beyond ``tmin``; ties go to the lower
    triangle index.  ``live`` masks the rays to trace."""
    r = o.shape[0]
    dev = o.device
    dt = geo.dtype
    best = torch.full((r,), math.inf, dtype=torch.float64, device=dev)
    best_tri = torch.full((r,), -1, dtype=torch.int64, device=dev)
    rows = torch.nonzero(live).reshape(-1)
    mn, mx, gmn, gmx = boxes
    pairs = []
    o64, d64 = o.double(), d.double()
    step = max(1, (1 << 22) // max(gmn.shape[0], 1))
    for s in range(0, rows.numel(), step):
        rr = rows[s:s + step]
        lo, hi = _slab(o64[rr], d64[rr], gmn[None], gmx[None])
        ri, gi = torch.nonzero((lo <= hi) & (hi >= tmin[rr, None].double()), as_tuple=True)
        for q in range(0, ri.numel(), _PAIR_CHUNK):
            rq = rr[ri[q:q + _PAIR_CHUNK]]
            blk = geo.group_blocks[gi[q:q + _PAIR_CHUNK]]  # [n, GROUP]
            safe = blk.clamp(min=0)
            lo, hi = _slab(o64[rq], d64[rq], mn[safe], mx[safe])
            hit = (lo <= hi) & (hi >= tmin[rq, None].double()) & (blk >= 0)
            pi, bj = torch.nonzero(hit, as_tuple=True)
            pairs.append((rq[pi], blk[pi, bj]))
    if not pairs:
        return best < math.inf, best, best_tri, best, best
    ray_of = torch.cat([p[0] for p in pairs])
    blk_of = torch.cat([p[1] for p in pairs])
    p0, e0, e1, n = tris
    oc, dc, tm = o.to(dt), d.to(dt), tmin.to(dt)
    found_t, found_tri, found_ray = [], [], []
    for s in range(0, ray_of.numel(), _PAIR_CHUNK):
        ray = ray_of[s:s + _PAIR_CHUNK, None].expand(-1, BLOCK)
        tri = geo.block_tris[blk_of[s:s + _PAIR_CHUNK]]
        t, valid = _moller_trumbore(p0, e0, e1, n, tri, oc[ray], dc[ray], tm[ray])
        t = torch.where(valid, t.double(), math.inf)
        tmin_pair, k = t.min(1)
        keep = tmin_pair < math.inf
        found_t.append(tmin_pair[keep])
        found_tri.append(tri.gather(1, k[:, None])[:, 0][keep])
        found_ray.append(ray[:, 0][keep])
    ft, ftri, fray = torch.cat(found_t), torch.cat(found_tri), torch.cat(found_ray)
    best.scatter_reduce_(0, fray, ft, "amin")
    win = ft == best[fray]
    big = torch.full_like(best_tri, 1 << 62)
    best_tri = big.scatter_reduce(0, fray[win], ftri[win], "amin")
    found = best < math.inf
    best_tri = torch.where(found, best_tri, -1)
    # the winner's barycentrics, evaluated again on its own
    wt = best_tri.clamp(min=0)[:, None]
    bg = _moller_trumbore(p0, e0, e1, n, wt, oc[:, None], dc[:, None], tm[:, None], bary=True)
    return found, best, best_tri, bg[0][:, 0].double(), bg[1][:, 0].double()


def _moller_trumbore(p0, e0, e1, n, tri, o, d, tmin, bary: bool = False):
    """The double Moller-Trumbore test of the radar tracer on [..] pairs:
    e2 = (p0 - o) / (n . d), i = d x e2, beta = i . e1, gamma = i . e0,
    t = n . e2; no back-face culling."""
    safe = tri.clamp(min=0)
    tp0, te0, te1, tn = p0[safe], e0[safe], e1[safe], n[safe]
    denom = (tn * d).sum(-1)
    e2 = (tp0 - o) / denom[..., None]
    i = torch.linalg.cross(d, e2, dim=-1)
    beta = (i * te1).sum(-1)
    gamma = (i * te0).sum(-1)
    if bary:
        return beta, gamma
    t = (tn * e2).sum(-1)
    valid = ((t < _T_MAX) & (t > tmin) & (beta >= 0) & (gamma >= 0) & (beta + gamma <= 1) & (tri >= 0))
    return t, valid


def _norm(v):
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)


def _wrap(a):
    for _ in range(3):
        a = torch.where(a < -math.pi, a + 2 * math.pi, a)
        a = torch.where(a > math.pi, a - 2 * math.pi, a)
    return a


def _in_range(test, a, b):
    a, b = _wrap(a - test), _wrap(b - test)
    return (a * b < 0) & ((a - b).abs() < math.pi)


def _capture(sph, o, d, ray_length):
    """(captured, root) of rays leaving ``o`` along ``d`` into one capture
    sphere: the nearest root ahead whose point lies in the window."""
    c = torch.as_tensor(sph.centre, dtype=o.dtype, device=o.device)
    a = (d * d).sum(-1)
    b = 2.0 * ((o - c) * d).sum(-1)
    cq = (o * o).sum(-1) + (c * c).sum() - 2.0 * (c * o).sum(-1) - sph.radius ** 2
    disc = b * b - 4 * a * cq
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    roots = ((-b - sq) / (2 * a), (-b + sq) / (2 * a))
    max_t2, min_t2 = sph.max_theta, sph.min_theta
    max_p1, min_p1 = sph.max_phi, sph.min_phi
    max_p2, min_p2 = max_p1, min_p1
    if min_p1 < -math.pi / 2:
        max_t2, min_t2 = max_t2 + math.pi, min_t2 + math.pi
        max_p2, min_p2, min_p1 = -math.pi - min_p1, -math.pi / 2, -math.pi / 2
    if max_p1 > math.pi / 2:
        max_t2, min_t2 = max_t2 + math.pi, min_t2 + math.pi
        min_p2, max_p2, max_p1 = math.pi - max_p1, math.pi / 2, math.pi / 2
    ok = []
    for ti in roots:
        rel = o + ti[:, None] * d - c
        theta = torch.atan2(rel[:, 1], rel[:, 0])
        phi = torch.atan2(rel[:, 2], torch.sqrt(rel[:, 0] ** 2 + rel[:, 1] ** 2))
        flip_lo, flip_hi = phi < -math.pi / 2, phi > math.pi / 2
        theta = torch.where(flip_lo | flip_hi, theta + math.pi, theta)
        phi = torch.where(flip_lo, -math.pi - phi, torch.where(flip_hi, math.pi - phi, phi))
        window = ((_in_range(theta, sph.min_theta, sph.max_theta) & _in_range(phi, min_p1, max_p1))
                  | (_in_range(theta, min_t2, max_t2) & _in_range(phi, min_p2, max_p2)))
        ok.append((disc > 0) & (ti >= 0) & (ray_length + ti > SCENE_EPS) & window)
    root = torch.where(ok[0], roots[0], roots[1])
    return ok[0] | ok[1], root


def _refract(i, n, ratio):
    """OptiX ``refract`` of unit ``i`` at unit normal ``n`` [R, 3] with the
    index ratio ``ratio`` [R]: a hit from behind (i . n > 0) flips the
    normal and takes the ratio as it is, a hit from the front its inverse.
    Returns (unit direction, ok); ok is False under total internal
    reflection (k < 0)."""
    ndotv = (i * n).sum(-1)
    behind = ndotv > 0.0
    eta = torch.where(behind, ratio, 1.0 / ratio)
    nn = torch.where(behind[:, None], -n, n)
    cos = torch.where(behind, -ndotv, ndotv)
    k = 1.0 - eta * eta * (1.0 - cos * cos)
    r = eta[:, None] * i - (eta * cos + torch.sqrt(torch.clamp(k, min=0.0)))[:, None] * nn
    return _norm(r), k >= 0.0


def trace_pulse(geo: Geometry, scene: Scene, num_rays: int, pos, vel, rx_pos) -> Lanes:
    """Every lane of one pulse, with the targets at ``pos`` moving at
    ``vel`` ([NT, 3]) and the receivers at ``rx_pos`` ([NR, 3])."""
    dev, dt = geo.device, geo.dtype
    tx = scene.tx
    max_refl = int(scene.params["max_refl_depth"]) + 1  # the tracer's stop index
    max_refr = int(scene.params.get("max_refr_depth", 0))  # 0, or 2 with refraction
    depth = max_refl - 1 + max_refr  # path columns, indexed by refl_depth + refr_depth
    slots = 3 if max_refr else 1  # primaries, then the trapped and the exiting chains
    dirs_all = fan_directions(num_rays, tx["azimuth"], tx["elevation"], tx["tx_span"])
    dirs, inverse = np.unique(dirs_all, axis=0, return_inverse=True)
    u = len(dirs)
    r = slots * u  # lane s * u + j: fan direction j in slot s
    f = lambda a: torch.as_tensor(np.asarray(a, np.float64), dtype=dt, device=dev)
    tris, boxes = geo.pose(pos)
    v_t = f(vel)
    refl, refr = geo.refl.to(dt), geo.refr.to(dt)
    txo = f(tx["position"])
    o = txo.expand(r, 3).clone()
    d = f(dirs).repeat(slots, 1)  # a child's slot is written over when it is born
    ray_dir = _norm(d)
    tmin = torch.full((r,), SCENE_EPS, dtype=dt, device=dev)
    # A slot that no chain is born into keeps what the tracer's zero-filled
    # buffers hold (and the program documents as its output there): not
    # received, zero power, length and Doppler.
    zeros = torch.zeros(r, dtype=dt, device=dev)
    ray_length, power, doppler = zeros.clone(), zeros.clone(), zeros.clone()
    refr_cur = torch.ones(r, dtype=dt, device=dev)  # the index the chain travels in
    refl_depth = torch.zeros(r, dtype=torch.int64, device=dev)
    refr_depth = torch.zeros(r, dtype=torch.int64, device=dev)
    received = torch.full((r,), -1, dtype=torch.int64, device=dev)
    path = torch.full((r, depth), -1, dtype=torch.int64, device=dev)
    end = torch.zeros(r, dtype=torch.bool, device=dev)
    active = torch.arange(r, device=dev) < u
    four_pi = 4.0 * math.pi
    while bool(active.any()):
        found, t, tri, beta, gamma = closest_hit(geo, tris, boxes, o, d, tmin, active)
        t, beta, gamma = t.to(dt), beta.to(dt), gamma.to(dt)
        miss = active & ~found
        direct = (refl_depth == 0) & (refr_depth == 0)
        if bool(miss.any()):
            open_ = miss & ~end
            for k, sph in enumerate(scene.rx):
                got, ti = _capture(sph, o, d, ray_length)
                got = got & open_
                end = end | got
                end_point = o + ti[:, None] * d
                rr = torch.where(direct[:, None], end_point - txo, end_point - o)
                far = torch.linalg.vector_norm(rr, dim=-1) >= SCENE_EPS
                take = got & far
                inv = 1.0 / (four_pi * four_pi * (rr * rr).sum(-1))
                power = torch.where(take, torch.where(direct, inv, power * inv), power)
                doppler = torch.where(take & direct, 0.0, doppler)
                ray_length = torch.where(take, ray_length + ti, ray_length)
                received = torch.where(take, k, received)
            earth = miss & ~end
            a = (d * d).sum(-1)
            b = 2.0 * (o * d).sum(-1)
            cq = (o * o).sum(-1) - EARTH_RADIUS ** 2
            disc = b * b - 4 * a * cq
            sq = torch.sqrt(torch.clamp(disc, min=0.0))
            for ti in ((-b - sq) / (2 * a), (-b + sq) / (2 * a)):
                ok = earth & (disc > 0) & (ti >= 0) & (ray_length > 0)
                end = end | ok
                ray_length = torch.where(ok, ray_length + ti, ray_length)
        # a hit is shaded while the chain may still refract or reflect
        gate = active & found & ~end & ((refr_depth < max_refr) | (refl_depth < max_refl - 1))
        active = gate
        if not bool(gate.any()):
            break
        targ = geo.target[tri.clamp(min=0)]
        col = refl_depth + refr_depth
        rec = gate & (refr_depth != 1) & (col < depth)  # a trapped chain's row is written at its birth
        path = torch.where(rec[:, None] & (torch.arange(depth, device=dev) == col[:, None]),
                           targ[:, None], path)
        hit_point = o + t[:, None] * d
        ray_length = torch.where(gate, ray_length + t, ray_length)
        leg = torch.where(direct[:, None], hit_point - txo, hit_point - o)
        far = torch.linalg.vector_norm(leg, dim=-1) >= SCENE_EPS
        inv = 1.0 / ((leg * leg).sum(-1) * four_pi)
        power = torch.where(gate & far, torch.where(direct, inv, power * inv), power)
        end = end | (gate & ~far)
        cn = geo.normals[tri.clamp(min=0)].to(dt)  # [R, 3 corners, 3]
        w0 = 1.0 - beta - gamma
        normal = _norm(cn[:, 1] * beta[:, None] + cn[:, 2] * gamma[:, None] + cn[:, 0] * w0[:, None])
        rc = refl[targ]
        born = None
        if max_refr:
            # a chain's first hit, before it reflected, on a target that does
            # not reflect all: the refracted share goes on one slot down
            # (total internal reflection spawns nothing); the index it
            # enters is the target's from outside, 1 from inside
            can = gate & (rc.abs() != 1.0) & (refr_depth < max_refr) & (refl_depth == 0)
            into = torch.where(refr_cur == 1.0, refr[targ], 1.0)
            bent, ok = _refract(ray_dir, normal, into / refr_cur)
            spawn = can & ok
            share = power * (1.0 - rc.abs()) if max_refl > 1 else power
            # the child's (o, d, ray_dir, tmin, ray_length, power, doppler,
            # refr_cur, refl_depth, refr_depth, end), from before the reflection
            child = (hit_point, bent, bent, torch.full_like(tmin, SCENE_EPS), ray_length, share,
                     doppler + (v_t[targ] * (_norm(bent) - _norm(d))).sum(-1), into, refl_depth,
                     refr_depth + 1, end)
            born = torch.roll(spawn, u, 0)
            # a primary's spawn writes the rows of its trapped child (every
            # column) and of its exiting grandchild (the first two)
            prim = torch.roll(spawn & (refr_depth == 0), u, 0)
            path = torch.where(prim[:, None], torch.roll(targ, u, 0)[:, None], path)
            prim2 = torch.roll(prim, u, 0)[:, None] & (torch.arange(depth, device=dev) < 2)
            path = torch.where(prim2, torch.roll(targ, 2 * u, 0)[:, None], path)
        o = torch.where(gate[:, None], hit_point, o)
        refl_depth = torch.where(gate, refl_depth + 1, refl_depth)
        reflects = gate & (refl_depth < max_refl)
        new_dir = ray_dir - 2.0 * normal * (ray_dir * normal).sum(-1, keepdim=True)
        power = torch.where(reflects, power * rc, power)
        doppler = torch.where(reflects, doppler + (v_t[targ] * (_norm(new_dir) - _norm(d))).sum(-1), doppler)
        d = torch.where(reflects[:, None], new_dir, d)
        ray_dir = torch.where(reflects[:, None], new_dir, ray_dir)
        tmin = torch.where(reflects, SCENE_EPS, tmin)
        active = reflects
        if born is not None:  # the children land one slot down, born active
            own = (o, d, ray_dir, tmin, ray_length, power, doppler, refr_cur, refl_depth, refr_depth, end)
            o, d, ray_dir, tmin, ray_length, power, doppler, refr_cur, refl_depth, refr_depth, end = (
                torch.where(born.view(-1, *[1] * (x.dim() - 1)), torch.roll(c, u, 0), x) for c, x in zip(child, own))
            active = active | born
    # post-processing: isotropic gains and RCS, lambda^2, relativistic Doppler
    c = float(scene.params["c"])
    carrier = float(tx["carrier"])
    valid = received >= 0
    wavelength = c / carrier
    power = torch.where(valid, power * wavelength ** 2, power)
    x = (doppler / 2.0) / c
    doppler = torch.where(valid, carrier * (2.0 * x / (1.0 - x)), doppler)
    back = torch.as_tensor(inverse.reshape(-1), device=dev)
    n3 = back.numel()
    back = torch.cat([s * u + back for s in range(slots)])
    # the slots past the traced ones (max_refl_depth + 3 in all with
    # refraction) are never traced: the zero fill, path rows empty
    pad = (max_refl - 1) * n3 if max_refr else 0
    g = lambda a, fill: torch.cat([a[back].double() if a.is_floating_point() else a[back],
                                   torch.full((pad,) + a.shape[1:], fill, dtype=torch.float64 if
                                              a.is_floating_point() else a.dtype, device=dev)])
    ray_length = g(ray_length, 0.0)
    return Lanes(received=g(received, -1), power=g(power, 0.0), doppler=g(doppler, 0.0), delay=ray_length / c,
                 ray_length=ray_length, refl_depth=g(refl_depth, 0), path=g(path, -1),
                 refr_depth=g(refr_depth, 0))


def aggregate(lanes: Lanes, carrier: float, c: float) -> Aggregate:
    """Coherent multipath aggregation: a received lane groups with the lanes
    of its receiver that recorded the same targets (a direct lane, with no
    hit, with every lane of its receiver); a group's power is its mean
    voltage squared, its delay, phase and Doppler the means, its match the
    lowest lane id; the lane that is its group's match emits."""
    r = lanes.received.shape[0]
    dev = lanes.received.device
    npath = torch.zeros(r, dtype=torch.float64, device=dev)
    power, delay = lanes.power.clone(), lanes.delay.clone()
    phase = torch.zeros(r, dtype=torch.float64, device=dev)
    doppler = lanes.doppler.clone()
    match = torch.full((r,), r + 1, dtype=torch.int64, device=dev)
    idx = torch.nonzero(lanes.received >= 0).reshape(-1)
    if idx.numel():
        rx, pth = lanes.received[idx], lanes.path[idx]
        direct = (lanes.refl_depth[idx] == 0) & (lanes.refr_depth[idx] == 0)
        same = (rx[:, None] == rx[None, :]) & (direct[:, None] | (pth[:, None, :] == pth[None, :, :]).all(-1))
        w = same.double()
        n = w.sum(1)
        d = lanes.delay[idx]
        ph = -torch.remainder(d * 2 * math.pi * carrier, 2 * math.pi)
        npath[idx] = n
        power[idx] = ((w @ torch.sqrt(lanes.power[idx])) / n) ** 2
        delay[idx] = (w @ d) / n
        phase[idx] = (w @ ph) / n
        doppler[idx] = (w @ lanes.doppler[idx]) / n
        match[idx] = torch.where(same, idx[None, :], r + 1).amin(1)
    emit = (lanes.received >= 0) & (match == torch.arange(r, device=dev))
    return Aggregate(npath, power, delay, phase, doppler, match, emit)
