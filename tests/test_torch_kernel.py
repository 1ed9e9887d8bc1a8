"""The traversal's CUDA kernel against its plain PyTorch version, on the card
(modes K1/K2, the K3 prune, the K4 shade emit, the K5 live pack and the K6
per-candidate windows, and the work counters).

Marked ``gpu``: skips where there is no CUDA card.  This file imports
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


def _scene(device, subdiv=3):
    mesh, _ = sphere_mesh(subdiv, 50.0)
    plate = rect_mesh(2.0, 150.0, 150.0).translated([300.0, 100.0, 0.0])
    scene = compile_scene([mesh.translated([900.0, 0.0, 0.0]), plate], [0.9, 0.7], [1.0, 1.0])
    base = scene_base(cluster_reorder(scene, cluster_size=CS), CS, device=device)
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
