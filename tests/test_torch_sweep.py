"""The traversal's sweep (K2) walked per ray sub-block, on the CPU.

The CUDA kernel sweeps a tile as sub_tiles independent walks, one per ray
sub-block (``rts_tpu_torch/ops/csrc/mt_traverse.cu``, ``sweep_kernel``),
where the plain version (``mt_traverse_reference``) and ``rts_tpu``'s
Pallas kernel walk the whole tile at once.  Two things make that exact,
and both are held here on the CPU (the kernel itself is held to the plain
version on the card, ``tests/test_torch_kernel.py``):

(a) the premise: the group and supergroup boxes that ``closest_hit_clustered``
    builds nest their members' boxes under the slab test, so a ray that
    fails a group or supergroup box fails each member's box, with the same
    or any smaller running best; on random rays with zero and subnormal
    direction components and origins on box faces, in the port's slab test
    and in ``rts_tpu``'s ``_slab_overlap``;
(b) the walk: a test-local plain model of the kernel's sweep -- each
    sub-block walks supergroups, groups and clusters alone with its own
    rays' running bests, boxes first tested 32 at a time and tested again
    at their turn, a cluster's columns split over column slices that merge
    on (t, scan position), the counters the union of what the sub-blocks
    passed -- gives ``mt_traverse_reference``'s hits and counters bit for
    bit, on the sweep-only scenes of ``tests/test_torch_traversal.py``
    (where the plain version is held to ``rts_tpu``'s interpret-mode sweep)
    and on a slice of the moving-shell scene.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rts_tpu.ops import cluster_trace as JCT

import rts_tpu_torch.sim as ts
from rts_tpu_torch import Parameters as TParameters
from rts_tpu_torch.core.constants import SCENE_EPS
from rts_tpu_torch.engine.animate import animate_packed
from rts_tpu_torch.engine.fan import generate_fan_c
from rts_tpu_torch.ops import cluster_trace as TCT
from rts_tpu_torch.ops import closest_hit_clustered, mt_traverse_reference
from test_torch_moving import KNOBS as MOVING_KNOBS
from test_torch_moving import moving_world
from test_torch_traversal import _MODES, CS, RT, _rays, _scene, _t

torch.set_num_threads(1)

BIG = 3.0e38


def _captured(args, kw):
    """The phase-2 operands (inp, shape) closest_hit_clustered hands to the
    traversal."""
    calls = []

    def keep(inp, shape):
        calls.append((inp, shape))
        return mt_traverse_reference(inp, shape)

    closest_hit_clustered(*args, traverse=keep, **kw)
    return calls[0]


def _traversal_scene(mode):
    """A sweep scene of tests/test_torch_traversal.py: its sphere and plate,
    its rays and the knobs of ``mode``."""
    pack, mn, mx = _scene()
    o, d, tmin = _rays()
    kw = {**dict(cluster_size=CS, ray_tile=RT, group_size=8, super_size=1), **_MODES[mode]}
    return _captured((_t(o), _t(d), _t(tmin), _t(pack), _t(mn), _t(mx), torch.zeros(3)), kw)


def _moving_scene():
    """Segment 1 of pulse 0 of the moving-shell scene (tests/test_torch_moving.py)
    at subdivision 4 (20 clusters of 1,024 triangles) and a 9^3 fan, at
    its knobs, with every tile sent to the sweep."""
    base, batch, cfg, spec = ts.prepare_cpi(moving_world(ts, subdivisions=4, pulses=1),
                                            TParameters(num_rays=9, max_refl_depth=2),
                                            device="cpu", **{**MOVING_KNOBS, "refine": False})
    scene = animate_packed(base, batch.rot[0], batch.pos[0], batch.vel[0])
    fan = generate_fan_c(cfg.num_rays, (batch.tx_dir[0, 0], batch.tx_dir[0, 1]), spec.tx_span,
                         device="cpu")
    origin = batch.tx_origin[0][:, None].expand(3, fan.shape[1]).contiguous()
    tmin = torch.full((fan.shape[1],), SCENE_EPS)
    kw = dict(cluster_size=cfg.cluster_size, ray_tile=cfg.ray_tile, group_size=cfg.group_size,
              super_size=cfg.super_size, sub_tiles=cfg.sub_tiles, candidates=cfg.candidates,
              mt_group=cfg.mt_group, mt_tail=cfg.mt_tail, mt_prune=cfg.mt_prune,
              p1_fanout=cfg.p1_fanout, p1_super_k=cfg.p1_super_k)
    inp, shape = _captured((origin, fan, tmin, scene.tri_pack, scene.aabb_mn, scene.aabb_mx,
                            batch.tx_origin[0]), kw)
    meta = inp.meta.clone()
    meta[:, 1] = 1
    return inp._replace(meta=meta), shape


# ---------------------------------------------------------------- (a) premise


def _premise_rays(rng, mn, mx, n=2048):
    """Rays [3, n] with origins in and around the boxes, an eighth of them
    on a face of a random box, and directions of which an eighth have a zero
    component, an eighth a subnormal one (1/d overflows to inf), and 8 are
    dead; tmin, and running bests from tiny to the no-hit sentinel."""
    fin = torch.isfinite(mn).all(1)
    lo, hi = mn[fin].amin(0).numpy(), mx[fin].amax(0).numpy()
    span = hi - lo
    o = rng.uniform(lo - 0.5 * span, hi + 0.5 * span, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    e = n // 8
    boxes = np.flatnonzero(fin.numpy())
    pick = rng.choice(boxes, e)
    ax = rng.integers(0, 3, e)
    face = np.where(rng.random(e) < 0.5, mn.numpy()[pick, ax], mx.numpy()[pick, ax])
    o[np.arange(e), ax] = face
    d[e:2 * e, 0] = 0.0
    d[2 * e:3 * e, 1] = np.where(rng.random(e) < 0.5, 1e-40, -1e-40).astype(np.float32)
    d[:e][rng.random(e) < 0.5, 2] = 1e-40  # subnormal on a face: (mn - o) * inf is NaN
    d[-8:] = 0.0
    tmin = np.full(n, 0.005, np.float32)
    best = np.where(rng.random(n) < 0.3, BIG, rng.uniform(0.0, 2.0 * float(span.max()), n))
    return (torch.as_tensor(o.T.copy()), torch.as_tensor(d.T.copy()), torch.as_tensor(tmin),
            torch.as_tensor(best.astype(np.float32)))


def _passes(o, d, tmin, best, mn, mx):
    """The port's slab test (the kernel's ``slab``): [rays, boxes]."""
    alive = (d[0] * d[0] + d[1] * d[1] + d[2] * d[2]) > 0.0
    return TCT._slab_rays(o, d, tmin, alive, mn, mx, best[:, None])


_PREMISE_CASES = {
    # the traversal scene at two levels: groups of 4 clusters, supergroups of 2 groups
    "sphere_g4_s2": dict(group_size=4, super_size=2),
    "sweep_supergroups": dict(group_size=2, super_size=2),
    "moving_g16": None,  # the moving scene's own knobs: groups of 16 clusters of 1,024
}


@pytest.mark.parametrize("case", sorted(_PREMISE_CASES))
def test_group_boxes_nest_their_clusters(case):
    """Every ray that fails a group box fails each member cluster's box,
    and one that fails a supergroup box each member group's, at the same
    running best and at any smaller one; in the port's slab test and in
    rts_tpu's _slab_overlap, which agree bit for bit but on rays with a
    subnormal direction component (XLA's CPU backend reads those as zero)."""
    if _PREMISE_CASES[case] is None:
        inp, shape = _moving_scene()
    else:
        pack, mn, mx = _scene()
        o, d, tmin = _rays()
        kw = dict(cluster_size=CS, ray_tile=RT, sub_tiles=4, candidates=0, **_PREMISE_CASES[case])
        inp, shape = _captured((_t(o), _t(d), _t(tmin), _t(pack), _t(mn), _t(mx), torch.zeros(3)), kw)
    gs, ss = shape.group_size, shape.super_size
    rng = np.random.default_rng(sorted(_PREMISE_CASES).index(case))
    o, d, tmin, best = _premise_rays(rng, inp.mn, inp.mx)
    smaller = best * torch.as_tensor(rng.uniform(0.0, 1.0, best.shape[0]).astype(np.float32))
    levels = ((inp.mn, inp.mx), (inp.g_mn, inp.g_mx), (inp.s_mn, inp.s_mx))
    for b in (best, smaller):
        p_c, p_g, p_s = (_passes(o, d, tmin, b, lo, hi) for lo, hi in levels)
        assert not bool((p_c & ~p_g.repeat_interleave(gs, 1)).any())
        assert not bool((p_g & ~p_s.repeat_interleave(ss, 1)).any())
        assert int(p_c.sum()) > 100 and bool((~p_g).any())
    # a smaller best never passes a box the larger one failed
    for lo, hi in levels:
        assert not bool((_passes(o, d, tmin, smaller, lo, hi) & ~_passes(o, d, tmin, best, lo, hi)).any())
    # the NaN corner occurs: 1/d is inf on an axis where o lies on a face
    inv = 1.0 / torch.where(d == 0.0, 1.0, d)
    on_face = ((o[:, :, None] == inp.mn.T[:, None, :]) | (o[:, :, None] == inp.mx.T[:, None, :])).any(-1)
    assert bool((torch.isinf(inv) & on_face).any())

    # rts_tpu's own slab test on the same rays and group / supergroup boxes
    slab = jax.jit(jax.vmap(JCT._slab_overlap, in_axes=(None, None, None, None, 0, 0)))
    sub = (d != 0.0) & (d.abs() < 1.1754944e-38)  # subnormal components
    normal = ~sub.any(0)
    jo, jd, jt, jb = (jnp.asarray(np.ascontiguousarray(x.numpy().T if x.dim() == 2 else x.numpy()))
                      for x in (o, d, tmin, best))
    j_c, j_g, j_s = (torch.as_tensor(np.array(slab(jo, jd, jt, jb, jnp.asarray(lo.numpy()),
                                                     jnp.asarray(hi.numpy()))).T)
                     for lo, hi in levels)
    assert not bool((j_c & ~j_g.repeat_interleave(gs, 1)).any())
    assert not bool((j_g & ~j_s.repeat_interleave(ss, 1)).any())
    for j, (lo, hi) in zip((j_c, j_g, j_s), levels):
        assert torch.equal(j[normal], _passes(o, d, tmin, best, lo, hi)[normal])


# ------------------------------------------------------------------- (b) walk


def _chunk_slices(cs, slices, chunk=128):
    """[slices, cs] bool: the columns of a cluster that each column slice
    scans, as the kernel splits every chunk of 128 columns (whole groups of
    four columns, one contiguous run a slice)."""
    owner = torch.empty(cs, dtype=torch.long)
    for c0 in range(0, cs, chunk):
        groups = (min(cs, c0 + chunk) - c0) // 4
        for k in range(slices):
            owner[c0 + 4 * (k * groups // slices):c0 + 4 * ((k + 1) * groups // slices)] = k
    return owner[None, :] == torch.arange(slices)[:, None]


def _sub_block_sweep(inp, shape, slices):
    """Test-local plain model of the kernel's sweep: (t, tri, beta, gamma)
    per lane of the swept tiles (others left at the no-hit values), the
    swept tiles' counters, the swept tiles, and whether some sub-block
    passed other clusters than its tile's union; every tile sweeps when
    k_max == 0.

    Each sub-block walks the hierarchy alone with its own rays: supergroups
    in s_order, in batches of 32 tested with the rays' current running
    bests (only those some ray passes are tested again at their turn), a
    passed supergroup's groups in g_order, their clusters in batches of 32
    alike.  A cluster that some ray of the sub-block passes at its turn is
    evaluated for every ray of the sub-block, its columns split over
    ``slices`` slices that each keep their own running best; a ray's running
    best is the least of its slices'.  At the end the slices merge on (t,
    scan position), the position being (clusters evaluated before) x cs +
    column.  A tile's counters are the groups (supergroups when super_size
    == 1) and clusters that any of its sub-blocks passed."""
    rt, cs, st = shape.ray_tile, shape.cluster_size, shape.sub_tiles
    gs, ss = shape.group_size, shape.super_size
    rs = rt // st
    lanes = inp.origin.shape[1]
    tiles = lanes // rt
    swept = inp.meta[:, 1] != 0 if shape.k_max > 0 else torch.ones(tiles, dtype=torch.bool)
    s_order, g_order = inp.s_order.tolist(), inp.g_order.tolist()
    n_super = len(s_order)
    out = [torch.full((lanes,), BIG), torch.zeros(lanes, dtype=torch.int32), torch.zeros(lanes),
           torch.zeros(lanes)]
    stats = torch.zeros((tiles, 2), dtype=torch.int32)
    gate = _chunk_slices(cs, slices)[:, None, :]  # [S, 1, cs]
    apart = False
    for tile in torch.nonzero(swept).reshape(-1).tolist():
        groups, clusters, own = set(), set(), []
        for sub in range(st):
            own.append(set())
            ln = slice(tile * rt + sub * rs, tile * rt + (sub + 1) * rs)
            o, d, tmin = inp.origin[:, ln], inp.direction[:, ln], inp.tmin[ln]
            alive = (d[0] * d[0] + d[1] * d[1] + d[2] * d[2]) > 0.0
            m = torch.stack([d[1] * o[2] - d[2] * o[1], d[2] * o[0] - d[0] * o[2],
                             d[0] * o[1] - d[1] * o[0]])
            best = (torch.full((slices, rs), BIG), torch.zeros((slices, rs), dtype=torch.int32),
                    torch.zeros((slices, rs)), torch.zeros((slices, rs)))
            rank = {}

            def passed(bmn, bmx):  # [B]: some ray of the sub-block passes, at its running best
                rb = best[0].amin(0)[:, None]
                return TCT._slab_rays(o, d, tmin, alive, bmn, bmx, rb).any(0)

            def prefiltered(ids, bmn, bmx):
                return [i for i, p in zip(ids, passed(bmn[ids], bmx[ids]).tolist()) if p]

            def evaluate(c):
                rank[c] = len(rank)
                cols = c * cs + torch.arange(cs, dtype=torch.int32)
                f = inp.tri_pack[:, cols.long()].reshape(16, 1, 1, cs)
                rep = lambda a: a[:, None, :, None].expand(3, slices, rs, 1)
                TCT._mt_window(rep(o), rep(d), rep(m), tmin[None, :, None].expand(slices, rs, 1),
                               f, gate, cols[None, None, :].expand(slices, 1, cs), best)

            for b0 in range(0, n_super, 32):
                for sg in prefiltered(s_order[b0:b0 + 32], inp.s_mn, inp.s_mx):
                    if not bool(passed(inp.s_mn[sg:sg + 1], inp.s_mx[sg:sg + 1])):
                        continue
                    if ss == 1:
                        groups.add(sg)
                    for grp in [sg] if ss == 1 else g_order[sg * ss:(sg + 1) * ss]:
                        if ss > 1:
                            if not bool(passed(inp.g_mn[grp:grp + 1], inp.g_mx[grp:grp + 1])):
                                continue
                            groups.add(grp)
                        for c0 in range(grp * gs, (grp + 1) * gs, 32):
                            ids = list(range(c0, min(c0 + 32, (grp + 1) * gs)))
                            for c in prefiltered(ids, inp.mn, inp.mx):
                                if bool(passed(inp.mn[c:c + 1], inp.mx[c:c + 1])):
                                    clusters.add(c)
                                    own[-1].add(c)
                                    evaluate(c)
            # merge the slices on (t, scan position)
            t, tri = best[0], best[1]
            ranks = torch.zeros(inp.mn.shape[0], dtype=torch.int64)
            for c, k in rank.items():
                ranks[c] = k
            pos = torch.where(t < BIG, ranks[tri.long() // cs] * cs + tri.long() % cs, 2**62)
            first = torch.where(t == t.amin(0), pos, 2**63 - 1).argmin(0)
            for x, y in zip(out, best):
                x[ln] = y.gather(0, first[None])[0]
        stats[tile] = torch.tensor([len(groups), len(clusters)])
        apart = apart or any(x != clusters for x in own)
    return out, stats, swept, apart


_WALK_SCENES = ("sweep_only", "sweep_supergroups", "moving")


@pytest.mark.parametrize("slices", [1, 4, 16])
@pytest.mark.parametrize("scene", _WALK_SCENES)
def test_sub_block_walk_matches_tile_walk(scene, slices):
    """The per-sub-block walk with column slices gives the tile walk's hits
    (t, tri, beta, gamma) and work counters bit for bit."""
    inp, shape = _moving_scene() if scene == "moving" else _traversal_scene(scene)
    (t, tri, beta, gamma), stats, swept, apart = _sub_block_sweep(inp, shape, slices)
    ref = mt_traverse_reference(inp, shape)
    lanes = swept.repeat_interleave(shape.ray_tile)
    assert bool(swept.all())
    assert int((ref[0][lanes] < BIG).sum()) > (40 if scene == "moving" else 60)
    for a, b in zip((t, tri, beta, gamma), ref[:4]):
        assert torch.equal(a[lanes], b[lanes])
    assert torch.equal(stats[swept], ref[5][swept])
    assert apart  # some sub-block passed fewer clusters than its tile: the walks differ
