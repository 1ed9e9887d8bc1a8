"""The traversal kernel's yardstick: the work a closest hit needs, counted
from a call's inputs and its answers, and the card's published peaks.

A call of ``closest_hit_clustered`` takes rays ([3, L] origins and
directions, [L] near limits; a dead lane has a zero direction), the
triangles in their packed [16, T] columns (normal first) and one box per
cluster of ``cluster_size`` columns.  Whatever implements it, an exact
closest hit must test, for each live ray, every triangle of every cluster
whose box the ray enters nearer than the hit it returns (or anywhere, when
it returns none), and must find those clusters: one slab test each.

* MT work: ``MT_OPS`` per (ray, triangle) pair;
* box tests: ``SLAB_OPS`` per (ray, cluster) pair;
* bytes: each input read once, each output (t, triangle, beta, gamma)
  written once.

The bound of a call is the larger of its operations over ``FP32_PEAK``
and its bytes over ``HBM_RATE``.  No sweep is counted apart: a swept tile
needs the same clusters, found through the hierarchy's boxes, and the
count above is what any exact traversal of them needs.
"""

from __future__ import annotations

import torch

# NVIDIA H100 SXM data sheet, at its 700 W limit: float32 outside the
# tensor cores, and the HBM3 rate
FP32_PEAK = 67e12
HBM_RATE = 3.35e12
MT_OPS = 38  # a Moller-Trumbore column: 37 multiplies, adds, subtracts and a reciprocal
SLAB_OPS = 22  # a slab test: 6 subtracts, 6 multiplies, 10 minima and maxima
_GROUP = 32  # clusters per coarse box of the counting walk
_CHUNK = 1 << 24  # elements of one [rays, boxes] test


def needed_work(origin, direction, tmin, tri_pack, aabb_mn, aabb_mx, hit_t, cluster_size: int) -> dict:
    """{"pairs", "boxes", "bytes", "ops", "bound_s", "bound_by"} of one call."""
    o = origin.T.double()
    d = direction.T.double()
    live = (d != 0).any(1)
    o, d = o[live], d[live]
    tm = tmin.double()[live]
    limit = hit_t.double()[live]  # +inf where no hit: the ray's whole extent
    c = aabb_mn.shape[0]
    mn, mx = aabb_mn.double(), aabb_mx.double()
    real = (tri_pack[:3].abs().sum(0) > 0).reshape(c, cluster_size).sum(1).double()
    g = -(-c // _GROUP)
    pad = g * _GROUP - c
    if pad:
        mn = torch.cat([mn, mn.new_full((pad, 3), torch.inf)])
        mx = torch.cat([mx, mx.new_full((pad, 3), -torch.inf)])
        real = torch.cat([real, real.new_zeros(pad)])
    gmn = mn.reshape(g, _GROUP, 3).amin(1)
    gmx = mx.reshape(g, _GROUP, 3).amax(1)
    pairs = torch.zeros((), dtype=torch.float64, device=o.device)
    boxes = torch.zeros((), dtype=torch.float64, device=o.device)
    step = max(1, _CHUNK // g)
    for s in range(0, o.shape[0], step):
        sl = slice(s, s + step)
        ri, gi = torch.nonzero(_enter(o[sl], d[sl], tm[sl], limit[sl], gmn[None], gmx[None]), as_tuple=True)
        ri = ri + s
        for q in range(0, ri.numel(), max(1, _CHUNK // _GROUP)):
            rq, gq = ri[q:q + _CHUNK // _GROUP], gi[q:q + _CHUNK // _GROUP]
            cl = gq[:, None] * _GROUP + torch.arange(_GROUP, device=o.device)  # [n, GROUP]
            hit = _enter(o[rq], d[rq], tm[rq], limit[rq], mn[cl], mx[cl])
            boxes += hit.sum()
            pairs += (hit * real[cl]).sum()
    lanes = origin.shape[1]
    nbytes = 4 * (7 * lanes + tri_pack.numel() + 6 * c) + 16 * lanes
    ops = MT_OPS * float(pairs) + SLAB_OPS * float(boxes)
    t_ops, t_bytes = ops / FP32_PEAK, nbytes / HBM_RATE
    return {"pairs": float(pairs), "boxes": float(boxes), "bytes": float(nbytes), "ops": ops,
            "bound_s": max(t_ops, t_bytes), "bound_by": "ops" if t_ops >= t_bytes else "bytes"}


def _enter(o, d, tmin, limit, mn, mx):
    """[n, K] whether each of n rays enters each of its K boxes ([n or 1, K,
    3]) between ``tmin`` and ``limit`` (float64 slab test; an empty box,
    min > max, is never entered)."""
    o, d = o[:, None, :], d[:, None, :]
    inside = (mn <= o) & (o <= mx)
    t1, t2 = (mn - o) / d, (mx - o) / d
    zero = d == 0
    lo = torch.where(zero, torch.where(inside, -torch.inf, torch.inf), torch.minimum(t1, t2)).amax(-1)
    hi = torch.where(zero, torch.where(inside, torch.inf, -torch.inf), torch.maximum(t1, t2)).amin(-1)
    return (lo <= hi) & (hi >= tmin[:, None]) & (lo <= limit[:, None]) & (mn[..., 0] <= mx[..., 0])
