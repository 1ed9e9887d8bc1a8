"""The traversal's CUDA kernel against its plain PyTorch version, on the card
(modes K1/K2, the K3 prune, the K4 shade emit, the K5 live pack and the K6
per-candidate windows, and the work counters), at every mapping of ray
sub-blocks onto the kernel's warps and blocks, and on exact ties: in the
candidate windows and across clusters of the sweep's visit order.  Phase
1's kernel (``csrc/phase1.cu``) against ``_tile_candidates`` on the CPU,
element for element, at the shapes of the benchmark's cells and the bench's
and at the kernel's edges, and through ``closest_hit_clustered``.  The
bounce loop's shading kernel (``csrc/shade.cu``) against ``_process_miss``
and ``_process_hit`` on the card, on random segments and on every segment
of CPIs of the benchmark's configurations (``benchmark/configs``).

Marked ``gpu``: skips where there is no CUDA card (the plain version's tie
rule is also checked on the CPU, unmarked).  This file imports
neither jax nor rts_tpu, so it also runs on a machine without them:

    python -m pytest --noconftest -m gpu tests/test_torch_kernel.py

(``--noconftest``: the suite's conftest configures jax.)  Both versions
round every product and use IEEE division, so t/beta/gamma must be
bit-equal, not merely close.
"""

import math

import numpy as np
import pytest
import torch

from rts_tpu_torch.accel import cluster_reorder
from rts_tpu_torch.engine import wavefront as W
from rts_tpu_torch.engine.animate import animate_packed, scene_base
from rts_tpu_torch.geometry import rect_mesh, sphere_mesh
from rts_tpu_torch.geometry.scene import compile_scene
from rts_tpu_torch.ops import cluster_trace as TCT
from rts_tpu_torch.ops import closest_hit_clustered, mt_traverse_reference
from rts_tpu_torch.utils import timing

CS, RT = 128, 128
_MODES = {
    "candidates_g8_tail": dict(candidates=48, mt_group=8, mt_tail=True, sub_tiles=8),
    "sweep_only": dict(candidates=0, sub_tiles=4),
    "forced_overflow": dict(candidates=16, mt_group=4, p1_fanout=2, p1_super_k=1, sub_tiles=4),
    "sweep_supergroups": dict(candidates=0, group_size=2, super_size=2, sub_tiles=2),
}


def _calls(mode=None) -> int:
    """The kernel calls counted so far: all, or those of one mode."""
    return timing.counters().get("traverse.calls" if mode is None else f"traverse.calls.{mode}", 0)


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
    before = _calls()
    got = closest_hit_clustered(*args, **kw)
    torch.cuda.synchronize()
    assert _calls() == before + 1
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
    before = _calls("K3")
    got = closest_hit_clustered(*args, mt_prune=True, **kw)
    torch.cuda.synchronize()
    assert _calls("K3") == before + 1
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
    before = _calls("K4")
    got = closest_hit_clustered(*args, emit_shade=True, shade_pack=sc.shade_pack, **kw)
    torch.cuda.synchronize()
    assert _calls("K4") == before + 1
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
    before = _calls("K5")
    got, stats = closest_hit_clustered(*args, resident_cap=cap, with_stats=True, **kw)
    torch.cuda.synchronize()
    assert _calls("K5") == before + 1
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
    before = {m: _calls(m) for m in ("K3", "K6")}
    got = closest_hit_clustered(*args, mt_union=False, mt_prune=prune, **kw)
    torch.cuda.synchronize()
    assert _calls("K6") == before["K6"] + 1
    assert _calls("K3") == before["K3"] + int(prune)
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
    before = _calls()
    got, stats = closest_hit_clustered(*args, with_stats=True, **opts)
    torch.cuda.synchronize()
    assert _calls() == before + 1
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


# Phase 1: (seed, box count, rays, ray_tile, sub_tiles, k_max, options).  The
# first seven are tests/test_torch_traversal.py's test_phase1_bit_identical
# cases; "level0*" force level 0 on through _P1_L0_MIN_S; "terrain_cell" and
# "imaging_cell" are the benchmark cells' knobs on a box set big enough for
# level 0 at the default threshold; "bench_moving" is bench.py's moving
# shells' (kf = 32 x 16 = 512 member slots, k 128).
_P1_CASES = {
    "dense": (1, 96, 256, 64, 4, 64, dict(p1_fanout=4, p1_super_k=24)),
    "list_padding": (2, 96, 256, 64, 4, 96, dict(p1_fanout=4, p1_super_k=24)),
    "narrow_list": (3, 96, 256, 64, 4, 64, dict(p1_fanout=4, p1_super_k=3)),
    "overflow": (4, 96, 256, 64, 4, 64, dict(p1_fanout=4, p1_super_k=2)),
    "sentinels": (5, 96, 256, 64, 4, 64, dict(p1_fanout=4, p1_super_k=24)),
    "mask_order": (6, 96, 256, 64, 4, 64, dict(p1_fanout=4, p1_super_k=24, cand_order="mask")),
    "chunked": (7, 96, 256, 64, 4, 64, dict(p1_fanout=4, p1_super_k=24)),
    "level0": (11, 96, 256, 64, 4, 64, dict(p1_fanout=2, p1_super_k=48)),
    "level0_overflow": (11, 96, 256, 64, 4, 64, dict(p1_fanout=2, p1_super_k=48, p1_super_k0=1)),
    "terrain_cell": (12, 2000, 2048, 512, 8, 48, dict(p1_fanout=8, p1_super_k=10)),
    "imaging_cell": (13, 2000, 1024, 128, 2, 32, dict(p1_fanout=8, p1_super_k=10)),
    "bench_moving": (14, 1280, 1024, 512, 8, 128, dict(p1_fanout=16, p1_super_k=32)),
    "ray_tile32_sub_tiles32": (15, 96, 256, 32, 32, 64, dict(p1_fanout=4, p1_super_k=24)),
    "ray_tile1024": (16, 400, 2048, 1024, 8, 64, dict(p1_fanout=4, p1_super_k=24)),
    "nan": (17, 96, 256, 64, 4, 64, dict(p1_fanout=4, p1_super_k=24)),
}


def _p1_inputs(case):
    """Random boxes and rays (axis-aligned, dead and boxed-in lanes among
    them) as in test_phase1_bit_identical; "sentinels" ends the box list
    with +inf rows; "nan" flattens boxes in x (plates) and puts every other
    ray's origin on one, inside it in y and z, with a denormal x direction:
    the slab's (mn - o) * (1 / d) and (mx - o) * (1 / d) are 0 * inf = NaN,
    which misses the box where minima and maxima propagate NaN and, where
    they drop it (fminf / fmaxf), leaves the x axis out and overlaps."""
    seed, c, l, *_ = _P1_CASES[case]
    rng = np.random.default_rng(seed)
    lo = rng.uniform(-300.0, 300.0, (c, 3)).astype(np.float32)
    hi = lo + rng.uniform(1, 100, (c, 3)).astype(np.float32)
    o = rng.uniform(-350.0, 350.0, (3, l)).astype(np.float32)
    d = rng.normal(size=(3, l)).astype(np.float32)
    d[1:, :16] = 0.0
    d[:, -8:] = 0.0
    o[:, 16:24] = 0.0
    if case == "sentinels":
        lo[-7:] = np.inf
        hi[-7:] = np.inf
    if case == "nan":
        face = rng.integers(0, c, l // 2)
        hi[face, 0] = lo[face, 0]
        o[0, ::2] = lo[face, 0]
        o[1:, ::2] = ((lo[face, 1:] + hi[face, 1:]) * 0.5).T
        d[0, ::2] = np.float32(1e-45)
    return o, d, np.full(l, 0.005, np.float32), lo, hi


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(_P1_CASES))
def test_cuda_phase1_matches_plain(cuda_device, case, monkeypatch):
    """cand/meta/bits/ent of the kernel equal _tile_candidates' on the CPU
    (the version held to rts_tpu), element for element; one counted call."""
    _, _, _, rt, st, k, kw = _P1_CASES[case]
    if case.startswith("level0"):
        monkeypatch.setattr(TCT, "_P1_L0_MIN_S", 8)
    if case == "chunked":
        monkeypatch.setattr(TCT, "_P1_CHUNK_ELEMS", rt * 96)  # one tile per chunk
    cpu = [torch.as_tensor(a) for a in _p1_inputs(case)]
    before = timing.counters().get("phase1.calls", 0)
    got = TCT.tile_candidates(*(a.to(cuda_device) for a in cpu), rt, st, k, **kw)
    torch.cuda.synchronize()
    assert timing.counters().get("phase1.calls", 0) == before + 1
    ref = TCT._tile_candidates(*cpu, rt, st, k, **kw)
    meta = ref[1]
    if case in ("overflow", "level0_overflow"):
        assert meta[:, 1].any()
    else:
        assert meta[:, 0].max() > 2
    if case.endswith("_cell"):  # level 0 at the default threshold
        assert TCT.phase1_shape(cpu[0].shape[1], cpu[3].shape[0], rt, st, k, **kw).s0 > 0
    for a, b, name in zip(got, ref, ("cand", "meta", "bits", "ent")):
        assert torch.equal(a.cpu(), b), (case, name, (a.cpu() != b).sum().item())


def _plain_phase1_on_cpu(*args, **kw):
    """_tile_candidates on CPU copies of a CUDA call's operands, its
    results back on the card."""
    dev = args[0].device
    cpu = [a.cpu() if isinstance(a, torch.Tensor) else a for a in args]
    return tuple(x.to(dev) for x in TCT._tile_candidates(*cpu, **kw))


@pytest.mark.gpu
@pytest.mark.parametrize("knobs", ["cells", "mask_level0"])
def test_cuda_phase1_closest_hit_matches_plain_phase1(cuda_device, knobs, monkeypatch):
    """closest_hit_clustered through the phase-1 kernel equals it with the
    plain phase 1 (the same traversal kernel after it): tri, found and t
    bit for bit."""
    sc = _scene(cuda_device, subdiv=4)
    rays = _mixed_rays(cuda_device, 3 * 512)
    args = (*rays, sc.tri_pack, sc.aabb_mn, sc.aabb_mx, torch.zeros(3, device=cuda_device))
    kw = dict(cluster_size=CS, ray_tile=512, group_size=8, super_size=1, sub_tiles=8,
              candidates=48, mt_group=8, mt_tail=True, p1_fanout=8, p1_super_k=10)
    if knobs == "mask_level0":
        monkeypatch.setattr(TCT, "_P1_L0_MIN_S", 2)
        kw.update(cand_order="mask", p1_fanout=2, p1_super_k=16)
    before = timing.counters().get("phase1.calls", 0)
    got = closest_hit_clustered(*args, **kw)
    torch.cuda.synchronize()
    assert timing.counters().get("phase1.calls", 0) == before + 1
    monkeypatch.setattr(TCT, "tile_candidates", _plain_phase1_on_cpu)
    ref = closest_hit_clustered(*args, **kw)
    assert int(ref.found.sum()) > 200
    for name in ("tri", "found", "t"):
        a, b = getattr(got, name), getattr(ref, name)
        assert torch.equal(a, b), (knobs, name, (a != b).sum().item())


# ---------------------------------------------------------------------------
# The bounce loop's shading: csrc/shade.cu (engine.wavefront.shade_cuda)
# against _process_miss and _process_hit on the same card, on every
# LaneState field and the path and RCS buffers, bit for bit (float32
# compared as its bits, so that NaN and -0.0 count).


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _plain_segment(state, bufs, hit, scene, rx, tx_origin, cfg, miss_only=False):
    """One shade_cuda call's plain version, on copies of its operands:
    _process_miss, then unless ``miss_only`` _process_hit without the spawn."""
    state = W.LaneState(*(a.clone() for a in state))
    bufs = W.TraceBuffers(*(b.clone() for b in bufs))
    hit_mask = state.active & hit.found
    state = W._process_miss(state, state.active & ~hit.found, rx, tx_origin, cfg)
    if miss_only:
        return state, bufs
    return W._process_hit(state, bufs, hit, hit_mask, scene, tx_origin, cfg, state.origin.shape[1], spawn=False)


def _assert_segment_equal(got, ref, what):
    names = (*W.LaneState._fields, *W.TraceBuffers._fields)
    for name, a, b in zip(names, (*got[0], *got[1]), (*ref[0], *ref[1])):
        assert a.dtype == b.dtype and a.shape == b.shape, (what, name)
        differ = int((_bits(a) != _bits(b)).sum())
        assert differ == 0, (what, name, f"{differ} of {b.numel()} differ")


class _HeldToPlain:
    """Stands in for wavefront.shade_cuda: each call runs ``kernel`` (the
    real one) and holds it to _plain_segment on copies of the operands;
    ``calls`` keeps each call's (lanes, miss_only)."""

    def __init__(self, monkeypatch, kernel=None):
        self.kernel = kernel or W.shade_cuda
        self.calls = []
        monkeypatch.setattr(W, "shade_cuda", self)

    def __call__(self, state, bufs, hit, scene, rx, tx_origin, cfg, miss_only=False, tables=None):
        ref = _plain_segment(state, bufs, hit, scene, rx, tx_origin, cfg, miss_only)
        got = self.kernel(state, bufs, hit, scene, rx, tx_origin, cfg, miss_only, tables)
        _assert_segment_equal(got, ref, (len(self.calls), miss_only))
        self.calls.append((state.origin.shape[1], miss_only))
        return got


def _shade_calls() -> int:
    return timing.counters().get("shade.calls", 0)


# the benchmark's configurations (benchmark/configs) at a fan of n^3 rays:
# (configuration, n, pulses, TraceConfig changes)
_SHADE_CELLS = {
    "terrain_cell": ("terrain-1M", 63, 2, {}),
    "split_shape": ("imaging-1M", 31, 2, {}),
    "dielectric_cell": ("dielectric-1M", 63, 1, {}),
    "rcs_angles_flat_normals": ("terrain-1M", 31, 1, dict(rcs_angles=True, interpolate_smooth=False)),
    "rcs_angles_shade_emit": ("dielectric-1M", 31, 1, dict(rcs_angles=True, shade_emit=True)),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(_SHADE_CELLS))
def test_cuda_shade_matches_plain_in_a_cpi(cuda_device, case, monkeypatch):
    """Every segment of a CPI of the benchmark's configurations: the kernel
    equals the plain programs on each one's operands (the terrain's narrow
    segment on its gathered rows; the dielectric's two spawn segments in
    their miss half, with its two receivers' windows wrapped at both
    poles); one shade.calls a launch, one launch a traced segment."""
    import dataclasses

    from benchmark import adapter
    from rts_tpu_torch.engine.cpi import trace_cpi

    config, n, pulses, change = _SHADE_CELLS[case]
    traffic = {**adapter.load("traffic", "fan63"), "num_rays": n, "pulses": pulses}
    base, batch, cfg, spec = adapter.prepare(adapter.load("configs", config), traffic, 1900000003, cuda_device)
    cfg = dataclasses.replace(cfg, **change)
    held = _HeldToPlain(monkeypatch)
    calls, traversals, narrow = _shade_calls(), _calls(), timing.counters().get("segment.narrow", 0)
    trace_cpi(base, batch, cfg, spec)
    torch.cuda.synchronize()
    assert _shade_calls() - calls == len(held.calls) == _calls() - traversals
    spawn_halves = sum(m for _, m in held.calls)
    assert spawn_halves == (2 * pulses if cfg.refraction_on else 0)
    assert len(held.calls) >= pulses * (cfg.num_segments - 1)
    lanes = n**3 * (3 if cfg.refraction_on else 1)
    if case == "terrain_cell":
        assert timing.counters().get("segment.narrow", 0) > narrow
        assert min(l for l, _ in held.calls) < lanes  # a narrow segment's gathered rows
    else:
        assert max(l for l, _ in held.calls) == lanes
    if config == "dielectric-1M":  # one receiver wraps below the south pole, the other above the north
        geo = batch.rx_geom
        assert bool((geo.min_phi < -math.pi / 2).any()) and bool((geo.max_phi > math.pi / 2).any())


def _slab_scene(device, cs=128):
    """A dielectric slab and a sphere, Morton-clustered and padded to
    ``cs``, with two receivers whose windows wrap at the poles: one below
    the slab looking down, one beside it looking up."""
    from rts_tpu_torch.engine.types import RxGeomDevice, scene_to_device
    from rts_tpu_torch.physics import rx_sphere_geometry

    mesh, _ = sphere_mesh(2, 40.0)
    slab = rect_mesh(10.0, 300.0, 300.0).translated([500.0, 0.0, 0.0])
    scene = compile_scene([slab, mesh.translated([700.0, 150.0, 0.0])], [0.5, 0.9], [1.5, 1.0],
                          [np.array([0.0, 20.0, 0.0]), np.array([-30.0, 0.0, 5.0])])
    ds = scene_to_device(cluster_reorder(scene, cluster_size=cs), torch.float32, device)
    geo = rx_sphere_geometry(rx_pos=np.array([[0.0, 0.0, 0.0], [900.0, 0.0, -50.0]]), rx_azimuth=np.zeros(2),
                             rx_elevation=np.array([-1.4, 1.4]), sphere_radius=np.array([30.0, 60.0]),
                             theta_span=np.array([1.5, 1.5]), phi_span=np.array([1.2, 1.2]))
    return ds, RxGeomDevice.from_host(geo, device=device)


@pytest.mark.gpu
@pytest.mark.parametrize("accel", ["brute", "cluster"])
@pytest.mark.parametrize("smooth", [True, False], ids=["smooth", "flat"])
def test_cuda_shade_matches_plain_device_scene(cuda_device, accel, smooth, monkeypatch):
    """A float32 DeviceScene (world-frame normals, no attitude table),
    traced by brute force and clustered, with refraction and two
    receivers: every segment equal to the plain programs."""
    from rts_tpu_torch.engine.types import TraceConfig

    ds, rx = _slab_scene(cuda_device)
    assert bool((rx.min_phi < -math.pi / 2).any()) and bool((rx.max_phi > math.pi / 2).any())
    cfg = TraceConfig(num_rays=15, max_refl_dev=3, max_refr_dev=2, interpolate_smooth=smooth, accel=accel,
                      cluster_size=128, ray_tile=128, sub_tiles=4, candidates=32, mt_group=4, tri_chunk=256)
    held = _HeldToPlain(monkeypatch)
    calls = _shade_calls()
    W.trace_pulse(ds, rx, [0.0, 0.0, 0.0], [0.0, 0.0], [0.3, 0.3, 0.0], cfg)
    torch.cuda.synchronize()
    assert _shade_calls() - calls == len(held.calls) == cfg.num_segments
    assert [m for _, m in held.calls] == [True, True] + [False] * (cfg.num_segments - 2)


def _random_segment(device, cfg, scene_kind, num_rx, rows_pad=0, seed=5):
    """A segment's operands drawn at random: lanes (not a whole number of
    blocks) with NaN, infinite and zero directions, dead and ended lanes,
    every depth, garbage triangle ids and barycentrics where nothing was
    found; lanes aimed at the receivers (spheres whose windows wrap at the
    poles), from inside the Earth sphere so that the rest of the misses end
    there.  Returns (state, bufs, hit, scene, rx, tx_origin)."""
    from rts_tpu_torch.engine.intersect import HitResult
    from rts_tpu_torch.engine.types import RxGeomDevice, scene_to_device

    rng = np.random.default_rng(seed)
    l = 3 * 256 + 37
    if scene_kind.startswith("cluster"):
        mesh, _ = sphere_mesh(3, 50.0)
        plate = rect_mesh(2.0, 150.0, 150.0).translated([300.0, 100.0, 0.0])
        scene = compile_scene([mesh.translated([900.0, 0.0, 0.0]), plate], [0.9, 0.7], [1.0, 1.5])
        base = scene_base(cluster_reorder(scene, cluster_size=CS), CS, device=device)
        q, _ = np.linalg.qr(rng.normal(size=(2, 3, 3)))
        scene = animate_packed(base, torch.as_tensor(q, dtype=torch.float32, device=device),
                               torch.as_tensor(rng.normal(size=(2, 3)) * 10, dtype=torch.float32, device=device),
                               torch.as_tensor(rng.normal(size=(2, 3)) * 30, dtype=torch.float32, device=device))
    else:
        mesh, _ = sphere_mesh(2, 50.0)
        scene = scene_to_device(compile_scene([mesh, rect_mesh(2.0, 150.0, 150.0)], [0.9, -0.7], [1.0, 1.5],
                                              [np.array([1.0, -2.0, 3.0]), np.array([0.0, 5.0, 0.0])]),
                                torch.float32, device)
    n_tris = scene.tri_target.shape[0]
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    i = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=device)
    b = lambda a: torch.as_tensor(np.asarray(a, bool), device=device)
    centres = np.array([[0.0, 0.0, 300.0], [0.0, 0.0, -300.0]])[:num_rx]
    # windows the short way round: theta through 0 and through pi
    rx = RxGeomDevice(f(centres), f([60.0, 80.0][:num_rx]), f([-1.5, 1.6][:num_rx]), f([1.5, -1.6][:num_rx]),
                      f([-math.pi / 2 - 0.7, -0.2][:num_rx]), f([0.3, math.pi / 2 + 0.7][:num_rx]))
    o = rng.uniform(-500.0, 500.0, (3, l))
    d = rng.normal(size=(3, l))
    if num_rx:  # half the lanes aimed into a receiver's sphere
        k = rng.integers(0, num_rx, l // 2)
        d[:, : l // 2] = (centres[k] + rng.uniform(-40.0, 40.0, (l // 2, 3))).T - o[:, : l // 2]
    seg_dir = d / np.linalg.norm(d, axis=0)
    d[:, -12:-8] = np.nan
    d[0, -8:-4] = np.inf
    d[:, -4:] = 0.0
    refl = rng.integers(0, cfg.max_refl_dev + 1, l)
    refr = rng.integers(0, cfg.max_refr_dev + 1, l)
    refl[: l // 4], refr[: l // 4] = 0, 0  # direct legs and first hits
    width = cfg.tri_seq_width
    ray_length = rng.uniform(0.0, 1000.0, l)
    ray_length[::7] = 0.0
    doppler = rng.normal(size=l)
    doppler[::11] = -0.0
    state = W.LaneState(
        origin=f(o), direction=f(d), seg_dir=f(seg_dir), tmin=f(np.full(l, 0.005)),
        ray_length=f(ray_length), power=f(rng.uniform(1e-9, 1e-3, l)), doppler=f(doppler),
        refr_prev=f(rng.choice([1.0, 1.5], l)), refr_cur=f(rng.choice([1.0, 1.5], l)),
        refl_depth=i(refl), refr_depth=i(refr), slot_base=i(np.zeros(l)), received=i(rng.integers(-1, 2, l)),
        first_hit=f(rng.normal(size=(3, l))), end=b(rng.random(l) < 0.15), active=b(rng.random(l) < 0.85),
        born=b(np.ones(l)), tri_seq=i(rng.integers(-1, n_tris, (width, l))), cap_bits=i(rng.integers(0, 4, l)),
        cap_root0_bits=i(rng.integers(0, 4, l)),
    )
    found = rng.random(l) < 0.5
    tri = np.where(found, rng.integers(0, n_tris, l), rng.choice([-1, 0, n_tris + 5], l))
    beta = rng.uniform(0.0, 0.5, l)
    gamma = rng.uniform(0.0, 0.5, l)
    beta[~found & (rng.random(l) < 0.3)] = np.nan
    shade = None
    if scene_kind == "cluster_emit":  # the traversal's rows: [10, lanes] of a wider buffer, zero where none won
        rows10 = torch.zeros((10, l + 64), dtype=torch.float32, device=device)
        rows10[:, :l] = torch.where(b(found)[None], scene.shade_pack[i(np.clip(tri, 0, n_tris - 1)).long()].T, 0.0)
        shade = rows10[:, :l]
    hit = HitResult(t=f(np.where(found, rng.uniform(0.1, 800.0, l), np.inf)), tri=i(tri), beta=f(beta),
                    gamma=f(gamma), found=b(found), shade=shade)
    rows = l + rows_pad
    bufs = W.TraceBuffers(path=i(rng.integers(-1, 2, (cfg.depth_total, rows))),
                          rcs=f(rng.normal(size=(2, cfg.depth_total, rows))))
    return state, bufs, hit, scene, rx, f([10.0, -20.0, 5.0])


@pytest.mark.gpu
@pytest.mark.parametrize("refraction", [False, True], ids=["reflect", "refract"])
@pytest.mark.parametrize("rcs_angles", [True, False], ids=["rcs", "no_rcs"])
@pytest.mark.parametrize("scene_kind", ["cluster_gather", "cluster_emit", "cluster_flat", "device_smooth",
                                        "device_flat"])
def test_cuda_shade_matches_plain_random_segment(cuda_device, scene_kind, rcs_angles, refraction):
    """One segment of random operands: every LaneState field and both
    buffers (wider than the lanes) equal the plain programs', in each
    normal source (the shade_pack gather, the emitted rows, the flat pack
    normal, a DeviceScene's corner and flat normals); captures by both
    receivers, direct and indirect, and Earth terminations among them."""
    from rts_tpu_torch.engine.types import TraceConfig

    cfg = TraceConfig(num_rays=9, max_refl_dev=3, max_refr_dev=2 if refraction else 0, accel="cluster",
                      interpolate_smooth=not scene_kind.endswith("flat"), rcs_angles=rcs_angles)
    state, bufs, hit, scene, rx, tx = _random_segment(cuda_device, cfg, scene_kind, 2, rows_pad=29)
    before = W.LaneState(*(a.clone() for a in state))
    ref = _plain_segment(state, bufs, hit, scene, rx, tx, cfg)
    calls = _shade_calls()
    got = W.shade_cuda(state, bufs, hit, scene, rx, tx, cfg)
    torch.cuda.synchronize()
    assert _shade_calls() == calls + 1
    _assert_segment_equal(got, ref, scene_kind)
    s = ref[0]
    miss = before.active & ~hit.found & ~before.end
    captured = miss & (s.power != before.power)
    direct = (before.refl_depth == 0) & (before.refr_depth == 0)
    for r in range(2):
        assert int((captured & (s.received == r)).sum()) > 3, r
    assert int((captured & direct).sum()) > 3 and int((captured & ~direct).sum()) > 3
    assert int((miss & ~captured & s.end).sum()) > 20  # the Earth sphere's
    assert int((before.active & hit.found & (s.refl_depth > before.refl_depth)).sum()) > 50


@pytest.mark.gpu
@pytest.mark.parametrize("num_rx", [0, 1, 2])
@pytest.mark.parametrize("miss_only", [True, False], ids=["miss_half", "whole"])
def test_cuda_shade_matches_plain_receivers(cuda_device, num_rx, miss_only):
    """Zero, one and two receivers, the spawn segments' miss half and the
    whole segment, buffers as wide as the lanes (a narrow segment's)."""
    from rts_tpu_torch.engine.types import TraceConfig

    cfg = TraceConfig(num_rays=9, max_refl_dev=3, max_refr_dev=2, accel="cluster")
    state, bufs, hit, scene, rx, tx = _random_segment(cuda_device, cfg, "cluster_gather", num_rx, seed=6)
    ref = _plain_segment(state, bufs, hit, scene, rx, tx, cfg, miss_only)
    _assert_segment_equal(W.shade_cuda(state, bufs, hit, scene, rx, tx, cfg, miss_only), ref, (num_rx, miss_only))
