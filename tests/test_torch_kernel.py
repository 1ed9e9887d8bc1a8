"""The traversal's CUDA kernel against its plain PyTorch version, on the card
(modes K1/K2, the K3 prune, the K4 shade emit, the K5 live pack and the K6
per-candidate windows, and the work counters), at every mapping of ray
sub-blocks onto the kernel's warps and blocks, and on exact ties: in the
candidate windows and across clusters of the sweep's visit order.

Marked ``gpu``: skips where there is no CUDA card (the plain version's tie
rule is also checked on the CPU, unmarked).  This file imports
neither jax nor rts_tpu, so it also runs on a machine without them:

    python -m pytest --noconftest -m gpu tests/test_torch_kernel.py

(``--noconftest``: the suite's conftest configures jax.)  Both versions
round every product and use IEEE division, so t/beta/gamma must be
bit-equal, not merely close.
"""

import numpy as np
import pytest
import torch

from rts_tpu_torch.accel import cluster_reorder
from rts_tpu_torch.engine.animate import animate_packed, scene_base
from rts_tpu_torch.geometry import rect_mesh, sphere_mesh
from rts_tpu_torch.geometry.scene import compile_scene
from rts_tpu_torch.ops import cluster_trace as TCT
from rts_tpu_torch.ops import closest_hit_clustered, mt_traverse_reference

CS, RT = 128, 128
_MODES = {
    "candidates_g8_tail": dict(candidates=48, mt_group=8, mt_tail=True, sub_tiles=8),
    "sweep_only": dict(candidates=0, sub_tiles=4),
    "forced_overflow": dict(candidates=16, mt_group=4, p1_fanout=2, p1_super_k=1, sub_tiles=4),
    "sweep_supergroups": dict(candidates=0, group_size=2, super_size=2, sub_tiles=2),
}


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _scene(device, subdiv=3, cs=CS):
    mesh, _ = sphere_mesh(subdiv, 50.0)
    plate = rect_mesh(2.0, 150.0, 150.0).translated([300.0, 100.0, 0.0])
    scene = compile_scene([mesh.translated([900.0, 0.0, 0.0]), plate], [0.9, 0.7], [1.0, 1.0])
    base = scene_base(cluster_reorder(scene, cluster_size=cs), cs, device=device)
    eye = torch.eye(3, device=device).expand(2, 3, 3)
    zero = torch.zeros((2, 3), device=device)
    return animate_packed(base, eye, zero, zero)


def _silhouette_rays(device, l=3 * RT, seed=3):
    """Rays from the origin into the sphere's silhouette (front faces hit
    first, so the mt_prune gate skips the back-face windows)."""
    rng = np.random.default_rng(seed)
    d = np.stack([np.ones(l), rng.uniform(-0.04, 0.04, l), rng.uniform(-0.04, 0.04, l)]).astype(np.float32)
    t = lambda a: torch.as_tensor(a, device=device)
    return t(np.zeros((3, l), np.float32)), t(d), t(np.full(l, 0.005, np.float32))


def _rays(device, l=3 * RT, seed=0):
    rng = np.random.default_rng(seed)
    o = np.zeros((3, l), np.float32)
    o[:, l // 2 :] = rng.uniform(-100, 1000, (3, l - l // 2))
    d = np.zeros((3, l), np.float32)
    q = l // 4
    d[:, :q] = np.stack([np.ones(q), rng.uniform(-0.1, 0.1, q), rng.uniform(-0.1, 0.1, q)])
    d[:, q:-8] = rng.normal(size=(3, l - q - 8))
    aim = np.array([[900.0], [0.0], [0.0]]) + rng.uniform(-40, 40, (3, 40))
    d[:, l // 2 : l // 2 + 40] = aim - o[:, l // 2 : l // 2 + 40]
    t = lambda a: torch.as_tensor(a, device=device)
    return t(o), t(d), t(np.full(l, 0.005, np.float32))


@pytest.mark.gpu
@pytest.mark.parametrize("mode", sorted(_MODES))
def test_cuda_kernel_matches_plain(cuda_device, mode):
    sc = _scene(cuda_device)
    o, d, tmin = _rays(cuda_device)
    args = (o, d, tmin, sc.tri_pack, sc.aabb_mn, sc.aabb_mx, torch.zeros(3, device=cuda_device))
    kw = dict(cluster_size=CS, ray_tile=RT, group_size=8, super_size=1)
    kw.update(_MODES[mode])
    before = TCT.mt_traverse.launches
    got = closest_hit_clustered(*args, **kw)
    torch.cuda.synchronize()
    assert TCT.mt_traverse.launches == before + 1
    ref = closest_hit_clustered(*args, traverse=mt_traverse_reference, **kw)
    assert int(ref.found.sum()) > 60
    for name in ("found", "tri", "t", "beta", "gamma"):
        a, b = getattr(got, name), getattr(ref, name)
        assert torch.equal(a, b), (mode, name, (a != b).sum().item())


_FIELDS = ("found", "tri", "t", "beta", "gamma")


@pytest.mark.gpu
@pytest.mark.parametrize("group", [1, 4])
def test_cuda_kernel_prune_matches_plain(cuda_device, group):
    """K3: the kernel with mt_prune equals the plain version with it, and
    the kernel without it, bit for bit."""
    sc = _scene(cuda_device, subdiv=4)
    args = (*_silhouette_rays(cuda_device), sc.tri_pack, sc.aabb_mn, sc.aabb_mx,
            torch.zeros(3, device=cuda_device))
    kw = dict(cluster_size=CS, ray_tile=RT, group_size=8, super_size=1, candidates=48,
              mt_group=group, mt_tail=True, sub_tiles=8 if group > 1 else 4)
    before = TCT.mt_traverse.mode_launches["K3"]
    got = closest_hit_clustered(*args, mt_prune=True, **kw)
    torch.cuda.synchronize()
    assert TCT.mt_traverse.mode_launches["K3"] == before + 1
    ref = closest_hit_clustered(*args, mt_prune=True, traverse=mt_traverse_reference, **kw)
    off = closest_hit_clustered(*args, **kw)
    assert int(ref.found.sum()) > 300
    for name in _FIELDS:
        for other, what in ((ref, "plain"), (off, "no prune")):
            a, b = getattr(got, name), getattr(other, name)
            assert torch.equal(a, b), (what, name, (a != b).sum().item())


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["candidates_g8_tail", "sweep_only"])
def test_cuda_kernel_shade_matches_plain(cuda_device, mode):
    """K4: the kernel's emitted shade rows equal the plain gather bit for
    bit, and the hit is the one without the emit."""
    sc = _scene(cuda_device)
    o, d, tmin = _rays(cuda_device)
    args = (o, d, tmin, sc.tri_pack, sc.aabb_mn, sc.aabb_mx, torch.zeros(3, device=cuda_device))
    kw = dict(cluster_size=CS, ray_tile=RT, group_size=8, super_size=1, **_MODES[mode])
    before = TCT.mt_traverse.mode_launches["K4"]
    got = closest_hit_clustered(*args, emit_shade=True, shade_pack=sc.shade_pack, **kw)
    torch.cuda.synchronize()
    assert TCT.mt_traverse.mode_launches["K4"] == before + 1
    ref = closest_hit_clustered(*args, emit_shade=True, shade_pack=sc.shade_pack,
                                traverse=mt_traverse_reference, **kw)
    off = closest_hit_clustered(*args, **kw)
    assert off.shade is None and int(ref.found.sum()) > 60
    assert torch.equal(got.shade.view(torch.int32), ref.shade.view(torch.int32))
    for name in _FIELDS:
        assert torch.equal(getattr(got, name), getattr(off, name)), name


@pytest.mark.gpu
@pytest.mark.parametrize("cap", [64, 2], ids=["live_pack", "live_set_overflow"])
def test_cuda_kernel_resident_matches_plain(cuda_device, cap):
    """K5: windows staged from the live pack equal the plain version's and
    the default kernel's, bit for bit; at cap 2 every tile sweeps."""
    sc = _scene(cuda_device)
    o, d, tmin = _rays(cuda_device)
    args = (o, d, tmin, sc.tri_pack, sc.aabb_mn, sc.aabb_mx, torch.zeros(3, device=cuda_device))
    kw = dict(cluster_size=CS, ray_tile=RT, group_size=8, super_size=1, candidates=64, mt_group=8,
              sub_tiles=8)
    before = TCT.mt_traverse.mode_launches["K5"]
    got, stats = closest_hit_clustered(*args, resident_cap=cap, with_stats=True, **kw)
    torch.cuda.synchronize()
    assert TCT.mt_traverse.mode_launches["K5"] == before + 1
    ref, ref_stats = closest_hit_clustered(*args, resident_cap=cap, with_stats=True,
                                           traverse=mt_traverse_reference, **kw)
    off = closest_hit_clustered(*args, **kw)
    assert int(ref.found.sum()) > 60
    assert torch.equal(stats, ref_stats)
    for name in _FIELDS:
        for other, what in ((ref, "plain"), (off, "default")):
            a, b = getattr(got, name), getattr(other, name)
            assert torch.equal(a, b), (what, name, (a != b).sum().item())


@pytest.mark.gpu
@pytest.mark.parametrize("group, prune", [(8, False), (4, True)], ids=["g8", "g4_prune"])
def test_cuda_kernel_per_candidate_matches_plain(cuda_device, group, prune):
    """K6, and K6 with the K3 prune on the shell scene: the kernel equals
    the plain version and the default kernel bit for bit."""
    sc = _scene(cuda_device, subdiv=4 if prune else 3)
    rays = _silhouette_rays(cuda_device) if prune else _rays(cuda_device)
    args = (*rays, sc.tri_pack, sc.aabb_mn, sc.aabb_mx, torch.zeros(3, device=cuda_device))
    kw = dict(cluster_size=CS, ray_tile=RT, group_size=8, super_size=1, candidates=48,
              mt_group=group, sub_tiles=8)
    before = dict(TCT.mt_traverse.mode_launches)
    got = closest_hit_clustered(*args, mt_union=False, mt_prune=prune, **kw)
    torch.cuda.synchronize()
    assert TCT.mt_traverse.mode_launches["K6"] == before["K6"] + 1
    assert TCT.mt_traverse.mode_launches["K3"] == before["K3"] + int(prune)
    ref = closest_hit_clustered(*args, mt_union=False, mt_prune=prune,
                                traverse=mt_traverse_reference, **kw)
    off = closest_hit_clustered(*args, **kw)
    assert int(ref.found.sum()) > 60
    for name in _FIELDS:
        for other, what in ((ref, "plain"), (off, "default")):
            a, b = getattr(got, name), getattr(other, name)
            assert torch.equal(a, b), (what, name, (a != b).sum().item())


# The candidate grid's block holds one ray sub-block (rs = ray_tile /
# sub_tiles rays), or one warp of 32 / rs sub-blocks when rs < 32, once per
# column slice: each geometry below maps its sub-blocks differently onto
# warps and blocks (rs 128 fills 512 threads with four slices).
_GEOMS = {
    "rs16": dict(cs=128, ray_tile=128, sub_tiles=8, mt_group=8, mt_tail=True, mt_prune=False),
    "rs32": dict(cs=128, ray_tile=128, sub_tiles=4, mt_group=8, mt_tail=True, mt_prune=False),
    "rs64": dict(cs=256, ray_tile=256, sub_tiles=4, mt_group=4, mt_tail=True, mt_prune=False),
    "rs64_moving": dict(cs=1024, ray_tile=512, sub_tiles=8, mt_group=1, mt_tail=True, mt_prune=True),
    "rs128": dict(cs=128, ray_tile=512, sub_tiles=4, mt_group=8, mt_tail=True, mt_prune=False),
}
_CAND_MODES = {
    "K1": dict(mt_prune=False),
    "K3": dict(mt_prune=True),
    "K5": dict(resident_cap=64),
    "K6": dict(mt_union=False),
}


def _mixed_rays(device, l):
    """Half silhouette rays (the prune skips back-face windows), half the
    general set (misses, dead lanes, rays from inside the scene)."""
    a, b = _silhouette_rays(device, l // 2), _rays(device, l - l // 2)
    return tuple(torch.cat([x, y], dim=-1).contiguous() for x, y in zip(a, b))


@pytest.mark.gpu
@pytest.mark.parametrize("mode", sorted(_CAND_MODES))
@pytest.mark.parametrize("geom", sorted(_GEOMS))
def test_cuda_kernel_sub_block_mapping(cuda_device, geom, mode):
    """Every candidate mode at every mapping of sub-blocks onto warps: the
    kernel equals the plain version (hits and work counters) and the
    geometry's default mode, bit for bit."""
    knobs = dict(_GEOMS[geom])
    cs = knobs.pop("cs")
    sc = _scene(cuda_device, subdiv=4, cs=cs)
    rays = _mixed_rays(cuda_device, 3 * knobs["ray_tile"])
    args = (*rays, sc.tri_pack, sc.aabb_mn, sc.aabb_mx, torch.zeros(3, device=cuda_device))
    kw = dict(cluster_size=cs, group_size=8, super_size=1, candidates=48, **knobs)
    opts = {**kw, **_CAND_MODES[mode]}
    before = TCT.mt_traverse.launches
    got, stats = closest_hit_clustered(*args, with_stats=True, **opts)
    torch.cuda.synchronize()
    assert TCT.mt_traverse.launches == before + 1
    ref, ref_stats = closest_hit_clustered(*args, with_stats=True, traverse=mt_traverse_reference,
                                           **opts)
    default = closest_hit_clustered(*args, **kw)
    assert int(ref.found.sum()) > 200
    assert torch.equal(stats, ref_stats)
    for name in _FIELDS:
        for other, what in ((ref, "plain"), (default, "default mode")):
            a, b = getattr(got, name), getattr(other, name)
            assert torch.equal(a, b), (what, name, (a != b).sum().item())


def _tie_inputs(device, order, ray_tile, sub_tiles, tiles=2):
    """Three clusters of 128 columns that hold one triangle X three times:
    at columns 5 and 77 of cluster 0 and at column 3 of cluster 1 (every
    other column is all zeros, which never hits).  Each tile's candidate
    list is ``order``, every sub-block gated in, entries 0; the sweep
    visits the clusters in ``order`` too (groups of one cluster, equal
    boxes).  Rays from the origin into X."""
    cs, c = 128, 3
    f32 = torch.float32
    p0, p1, p2 = (torch.tensor(v, dtype=f32) for v in ([500.0, -50.0, -50.0],
                                                         [500.0, 60.0, -40.0],
                                                         [500.0, 0.0, 70.0]))
    cross = torch.linalg.cross
    e0, e1 = p1 - p0, p0 - p2
    n = cross(e1, e0)
    col = torch.cat([n, cross(p0, e1), cross(p0, e0), e1, e0, (n * p0).sum().reshape(1)])
    pack = torch.zeros((16, c * cs), dtype=f32)
    for j in (5, 77, cs + 3):
        pack[:, j] = col
    lanes = tiles * ray_tile
    rng = np.random.default_rng(7)
    d = np.stack([np.ones(lanes), rng.uniform(-0.05, 0.05, lanes), rng.uniform(-0.05, 0.05, lanes)])
    box = torch.tensor([[490.0, -60.0, -60.0]] * c), torch.tensor([[510.0, 70.0, 80.0]] * c)
    k = len(order)
    i32 = torch.int32
    t = lambda a, dt=f32: torch.as_tensor(a, dtype=dt).to(device).contiguous()
    inp = TCT.TraversalInputs(
        t(np.zeros((3, lanes))), t(d), t(np.full(lanes, 0.005)), t(pack), t(box[0]), t(box[1]),
        t(box[0]), t(box[1]), t(box[0]), t(box[1]), t(list(order) + [2], i32), t(np.arange(c), i32),
        t(np.tile(order, (tiles, 1)), i32), t(np.tile([k, 0], (tiles, 1)), i32),
        t(np.full((tiles, k), 2**sub_tiles - 1), i32), t(np.zeros((tiles, k)), i32),
        t(np.zeros((0, 10))), t(np.zeros((16, 0))), t(np.zeros(0), i32),
    )
    return inp, cs


@pytest.mark.gpu
@pytest.mark.parametrize("window", ["union_g2", "g1", "per_candidate"])
@pytest.mark.parametrize("order", [(0, 1), (1, 0)], ids=["near_first", "far_first"])
@pytest.mark.parametrize("ray_tile, sub_tiles", [(128, 8), (128, 4), (512, 8)])
def test_cuda_kernel_exact_tie_first_column_wins(cuda_device, window, order, ray_tile, sub_tiles):
    """An exact t tie among copies of one triangle: the first column of the
    first window that holds a copy wins, in the kernel as in the plain
    version (guards any split or merge of a ray's column scan)."""
    inp, cs = _tie_inputs(cuda_device, list(order), ray_tile, sub_tiles)
    g, union = {"union_g2": (2, True), "g1": (1, True), "per_candidate": (2, False)}[window]
    shape = TCT.TraversalShape(ray_tile, cs, 1, 1, sub_tiles, 2, g, False, mt_prune=True,
                               mt_union=union)
    got = TCT.mt_traverse(inp, shape)
    torch.cuda.synchronize()
    ref = mt_traverse_reference(inp, shape)
    found = ref[0] < 3.0e38
    assert int(found.sum()) > ray_tile
    first = 5 if order[0] == 0 else cs + 3
    assert bool((ref[1][found] == first).all())
    for a, b, name in zip(got[:4], ref[:4], ("t", "tri", "beta", "gamma")):
        assert torch.equal(a, b), (name, (a != b).sum().item())
    assert torch.equal(got[5], ref[5])


@pytest.mark.gpu
def test_cuda_kernel_refuses_a_pack_of_partial_clusters(cuda_device):
    """The 16-byte copies of the pack need rows that are whole clusters
    (a multiple of 4 columns): a tri_pack of another width is a ValueError,
    not a misaligned copy on the card."""
    inp, cs = _tie_inputs(cuda_device, [0, 1], 128, 4)
    inp = inp._replace(tri_pack=inp.tri_pack[:, :-2].contiguous())
    shape = TCT.TraversalShape(128, cs, 1, 1, 4, 2, 1, False)
    with pytest.raises(ValueError, match="cluster_size"):
        TCT.mt_traverse(inp, shape)


@pytest.mark.parametrize("window", ["union_g2", "g1", "per_candidate"])
@pytest.mark.parametrize("order", [(0, 1), (1, 0)], ids=["near_first", "far_first"])
def test_plain_exact_tie_first_column_wins(window, order):
    """The rule the kernel is held to, in the plain version on the CPU: of
    three copies of one triangle (two in one cluster, one in the other),
    the first column of the first window that holds a copy wins, and the
    result does not depend on how the candidates are cut into windows."""
    inp, cs = _tie_inputs(torch.device("cpu"), list(order), 128, 4)
    g, union = {"union_g2": (2, True), "g1": (1, True), "per_candidate": (2, False)}[window]
    shape = TCT.TraversalShape(128, cs, 1, 1, 4, 2, g, False, mt_prune=True, mt_union=union)
    t, tri, beta, gamma, _, stats = mt_traverse_reference(inp, shape)
    found = t < 3.0e38
    assert int(found.sum()) > 128
    assert bool((tri[found] == (5 if order[0] == 0 else cs + 3)).all())
    assert torch.equal(stats, torch.full((2, 2), 2, dtype=torch.int32))
    base = mt_traverse_reference(inp, shape._replace(mt_group=1, mt_union=True))
    for a, b in zip((t, tri, beta, gamma), base[:4]):
        assert torch.equal(a, b)


# The sweep (K2) runs one block per ray sub-block of a swept tile (or per
# 32 / rs sub-blocks when rs < 32), each walking the hierarchy alone, beside
# the candidate grid or alone (sweep-only).
_SWEEP_GEOMS = {"rs16": (128, 8), "rs32": (128, 4), "rs64": (512, 8), "rs128": (512, 4)}


def _captured(args, kw):
    """The phase-2 operands closest_hit_clustered hands to the traversal."""
    calls = []
    closest_hit_clustered(*args, traverse=lambda inp, shape: calls.append((inp, shape))
                          or mt_traverse_reference(inp, shape), **kw)
    return calls[0]


def _with_swept(inp, swept):
    """inp with meta's overflow flag set on the tiles in ``swept`` only."""
    meta = inp.meta.clone()
    meta[:, 1] = 0
    meta[swept, 1] = 1
    return inp._replace(meta=meta)


def _assert_bit_equal(got, ref):
    for a, b, name in zip(got, ref, ("t", "tri", "beta", "gamma", "shade", "stats")):
        if b is not None:
            assert torch.equal(a, b), (name, (a != b).sum().item())


@pytest.mark.gpu
@pytest.mark.parametrize("swept", ["one_tile", "every_tile", "sweep_only"])
@pytest.mark.parametrize("cs", [128, 1024])
@pytest.mark.parametrize("geom", sorted(_SWEEP_GEOMS))
def test_cuda_sweep_mapping(cuda_device, geom, cs, swept):
    """The sweep at every mapping of sub-blocks onto warps (rs below, at and
    above 32), at 128- and 1024-column clusters (one and eight staged
    chunks), with one swept tile of three beside candidate tiles, with every
    one of 40 tiles swept in a candidate call, and sweep-only: hits and work
    counters bit-equal to the plain version, and the sweep's own device
    counts of calls and swept tiles."""
    rt, st = _SWEEP_GEOMS[geom]
    sc = _scene(cuda_device, subdiv=4, cs=cs)
    tiles = 3 if swept == "one_tile" else 40
    args = (*_mixed_rays(cuda_device, tiles * rt), sc.tri_pack, sc.aabb_mn, sc.aabb_mx,
            torch.zeros(3, device=cuda_device))
    kw = dict(cluster_size=cs, ray_tile=rt, sub_tiles=st, group_size=4, super_size=1,
              candidates=0 if swept == "sweep_only" else 48, mt_group=1)
    inp, shape = _captured(args, kw)
    if swept != "sweep_only":
        inp = _with_swept(inp, [1] if swept == "one_tile" else slice(None))
    n_swept = int((inp.meta[:, 1] != 0).sum())
    counts = TCT.mt_traverse.sweep_counts.to(cuda_device).clone()
    got = TCT.mt_traverse(inp, shape)
    torch.cuda.synchronize()
    ref = mt_traverse_reference(inp, shape)
    assert int((ref[0] < 3.0e38).sum()) > tiles * rt // 8
    _assert_bit_equal(got, ref)
    assert TCT.mt_traverse.sweep_counts.tolist() == [int(counts[0]) + 1, int(counts[1]) + n_swept]


@pytest.mark.gpu
@pytest.mark.parametrize("call", ["overflow", "sweep_only"])
def test_cuda_sweep_sub_blocks_diverge(cuda_device, call):
    """Sub-blocks of one tile aimed at the sphere, at the plate, up into
    nothing and everywhere: they pass different groups (so one walks whole
    groups that another skips) and the kernel still equals the plain
    version, hits and work counters (the union of what the sub-blocks
    passed), bit for bit."""
    sc = _scene(cuda_device)
    rng = np.random.default_rng(5)
    rs = 32
    d = np.zeros((3, 4, rs), np.float32)
    d[:, 0] = np.stack([np.ones(rs), rng.uniform(-0.05, 0.05, rs), rng.uniform(-0.05, 0.05, rs)])
    d[:, 1] = (np.array([300.0, 100.0, 0.0])[:, None] + rng.uniform(-60, 60, (3, rs))) / 300.0
    d[:, 2] = np.stack([rng.uniform(-0.1, 0.1, rs), rng.uniform(-0.1, 0.1, rs), np.ones(rs)])
    d[:, 3] = rng.normal(size=(3, rs))
    d = np.tile(d.reshape(3, 4 * rs), (1, 3))
    t = lambda a: torch.as_tensor(a, device=cuda_device)
    args = (t(np.zeros_like(d)), t(d), t(np.full(d.shape[1], 0.005, np.float32)), sc.tri_pack,
            sc.aabb_mn, sc.aabb_mx, torch.zeros(3, device=cuda_device))
    kw = dict(cluster_size=CS, ray_tile=RT, sub_tiles=4, group_size=2, super_size=2,
              candidates=0 if call == "sweep_only" else 16, mt_group=4, p1_fanout=2, p1_super_k=1)
    inp, shape = _captured(args, kw)
    assert bool((inp.meta[:, 1] != 0).all())
    big = torch.full((rs, 1), 3.0e38, device=cuda_device)
    o, dd, tmin = inp.origin[:, :rs], inp.direction, inp.tmin[:rs]
    passed = [TCT._slab_rays(o, dd[:, k * rs:(k + 1) * rs], tmin, torch.ones(rs, dtype=torch.bool,
                                                                                 device=cuda_device),
                             inp.g_mn, inp.g_mx, big).any(0) for k in range(4)]
    # the plate's and the upward sub-blocks are gated out of groups that
    # the sphere's enters, and in at others
    for k in (1, 2):
        assert bool((passed[0] & ~passed[k]).any()) and bool(passed[k].any())
    got = TCT.mt_traverse(inp, shape)
    torch.cuda.synchronize()
    ref = mt_traverse_reference(inp, shape)
    assert int((ref[0] < 3.0e38).sum()) > 60
    _assert_bit_equal(got, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("call", ["few_swept", "every_tile_swept", "sweep_only"])
@pytest.mark.parametrize("order", [(0, 1), (1, 0)], ids=["near_first", "far_first"])
@pytest.mark.parametrize("ray_tile, sub_tiles", [(128, 8), (128, 4), (512, 8)])
def test_cuda_sweep_exact_tie_first_visited_wins(cuda_device, call, order, ray_tile, sub_tiles):
    """An exact t tie across two clusters in the sweep's visit order: the
    first column of the first cluster visited wins, in the kernel as in the
    plain version (guards the slices' merge on (t, scan position) across
    clusters), in one swept tile beside a candidate tile, in 40 swept tiles
    of a candidate call and in a sweep-only call of 40 tiles."""
    tiles = 2 if call == "few_swept" else 40
    inp, cs = _tie_inputs(cuda_device, list(order), ray_tile, sub_tiles, tiles)
    inp = _with_swept(inp, [0] if call == "few_swept" else slice(None))
    shape = TCT.TraversalShape(ray_tile, cs, 1, 1, sub_tiles, 0 if call == "sweep_only" else 2,
                               1, False)
    got = TCT.mt_traverse(inp, shape)
    torch.cuda.synchronize()
    ref = mt_traverse_reference(inp, shape)
    found = ref[0] < 3.0e38
    assert int(found.sum()) > ray_tile
    assert bool((ref[1][found] == (5 if order[0] == 0 else cs + 3)).all())
    _assert_bit_equal(got, ref)
