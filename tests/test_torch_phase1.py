"""Phase 1's dispatcher (``tile_candidates``) on the CPU: CPU tensors take
the plain version and count no kernel call; the kernel's shape limits
raise before anything is built or launched; and the kernel's name stays
out of the traversal kernel's readers.  The kernel itself is held to the
plain version on the card (tests/test_torch_kernel.py, marker ``gpu``).
This file imports neither jax nor rts_tpu.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.readers import TRAVERSAL_KERNELS
from rts_tpu_torch.accel import cluster_reorder
from rts_tpu_torch.engine.animate import animate_packed, scene_base
from rts_tpu_torch.geometry import rect_mesh, sphere_mesh
from rts_tpu_torch.geometry.scene import compile_scene
from rts_tpu_torch.ops import closest_hit_clustered
from rts_tpu_torch.ops import cluster_trace as TCT
from rts_tpu_torch.utils import timing

_CSRC = Path(TCT.__file__).resolve().parent / "csrc"

# (ray_tile, sub_tiles, k_max, options); "level0" forces level 0 on
_CASES = {
    "dense": (64, 4, 64, dict(p1_fanout=4, p1_super_k=24)),
    "overflow": (64, 4, 64, dict(p1_fanout=4, p1_super_k=2)),
    "mask_order": (64, 4, 64, dict(p1_fanout=4, p1_super_k=24, cand_order="mask")),
    "level0": (64, 4, 64, dict(p1_fanout=2, p1_super_k=48, p1_super_k0=1)),
    "ray_tile32_sub_tiles32": (32, 32, 64, dict(p1_fanout=4, p1_super_k=24)),
}


def _inputs(seed=1, c=96, l=256):
    rng = np.random.default_rng(seed)
    lo = rng.uniform(-300.0, 300.0, (c, 3)).astype(np.float32)
    hi = lo + rng.uniform(1, 100, (c, 3)).astype(np.float32)
    o = rng.uniform(-350.0, 350.0, (3, l)).astype(np.float32)
    d = rng.normal(size=(3, l)).astype(np.float32)
    d[1:, :16] = 0.0
    d[:, -8:] = 0.0
    return [torch.as_tensor(a) for a in (o, d, np.full(l, 0.005, np.float32), lo, hi)]


def _phase1_calls() -> int:
    return timing.counters().get("phase1.calls", 0)


@pytest.mark.parametrize("case", sorted(_CASES))
def test_cpu_tensors_take_the_plain_phase1(case, monkeypatch):
    """tile_candidates on CPU tensors returns _tile_candidates' lists and
    neither builds nor counts a kernel call."""
    rt, st, k, kw = _CASES[case]
    if case == "level0":
        monkeypatch.setattr(TCT, "_P1_L0_MIN_S", 8)
    monkeypatch.setattr(TCT, "_load", lambda: pytest.fail("the CPU path loaded the kernel"))
    args = _inputs(seed=len(case))
    before = _phase1_calls()
    got = TCT.tile_candidates(*args, rt, st, k, **kw)
    ref = TCT._tile_candidates(*args, rt, st, k, **kw)
    assert _phase1_calls() == before
    assert ref[1][:, 0].max() > 1
    for a, b, name in zip(got, ref, ("cand", "meta", "bits", "ent")):
        assert a.dtype == torch.int32 and torch.equal(a, b), name


def test_cpu_closest_hit_counts_no_phase1_call():
    """closest_hit_clustered on the CPU runs phase 1 in plain PyTorch: the
    counter phase1.calls stays where it was."""
    mesh, _ = sphere_mesh(2, 50.0)
    plate = rect_mesh(2.0, 150.0, 150.0).translated([300.0, 100.0, 0.0])
    scene = compile_scene([mesh.translated([900.0, 0.0, 0.0]), plate], [0.9, 0.7], [1.0, 1.0])
    base = scene_base(cluster_reorder(scene, cluster_size=128), 128, device="cpu")
    eye, zero = torch.eye(3).expand(2, 3, 3), torch.zeros((2, 3))
    sc = animate_packed(base, eye, zero, zero)
    rng = np.random.default_rng(0)
    d = torch.as_tensor(np.stack([np.ones(256), rng.uniform(-0.1, 0.1, 256),
                                  rng.uniform(-0.1, 0.1, 256)]).astype(np.float32))
    before = _phase1_calls()
    hit = closest_hit_clustered(torch.zeros((3, 256)), d, torch.full((256,), 0.005), sc.tri_pack,
                                sc.aabb_mn, sc.aabb_mx, torch.zeros(3), cluster_size=128,
                                ray_tile=128, candidates=16)
    assert int(hit.found.sum()) > 0
    assert _phase1_calls() == before


# (lanes, clusters, ray_tile, sub_tiles, k_max, options) the kernel refuses
_REFUSED = {
    "ray_tile_over_1024": (2048, 96, 2048, 8, 48, {}),
    "ray_tile_0": (256, 96, 0, 1, 48, {}),
    "sub_tiles_over_32": (256, 96, 128, 64, 48, {}),
    "sub_tiles_not_dividing": (256, 96, 128, 3, 48, {}),
    "partial_tile": (300, 96, 128, 4, 48, {}),
    "no_tile": (64, 96, 128, 4, 48, {}),
    "k_max_0": (256, 96, 128, 4, 0, {}),
    "no_cluster": (256, 0, 128, 4, 48, {}),
    "mask_sub_tiles_over_16": (256, 96, 128, 32, 48, dict(cand_order="mask")),
    "unknown_order": (256, 96, 128, 4, 48, dict(cand_order="far")),
    "shared_memory": (256, 1 << 24, 128, 4, 48, dict(p1_fanout=8)),
}


@pytest.mark.parametrize("case", sorted(_REFUSED))
def test_phase1_kernel_limits_raise_before_a_launch(case, monkeypatch):
    """A call outside the kernel's limits raises ValueError in
    phase1_shape, and the CUDA wrapper raises it before it checks, builds
    or launches anything."""
    lanes, c, rt, st, k, kw = _REFUSED[case]
    with pytest.raises(ValueError):
        TCT.phase1_shape(lanes, c, rt, st, k, **kw)
    monkeypatch.setattr(TCT, "_load", lambda: pytest.fail("loaded the kernel"))
    monkeypatch.setattr(TCT, "_check", lambda *a: pytest.fail("checked operands"))
    o = torch.zeros((3, lanes))
    box = torch.zeros((c, 3)) if c < 4096 else torch.zeros((1, 3)).expand(c, 3)
    with pytest.raises(ValueError):
        TCT._tile_candidates_cuda(o, o, torch.zeros(lanes), box, box, rt, st, k, **kw)


def test_phase1_sizes_at_the_terrain_cell():
    """The terrain cell's heavy call (63^3 rays in 489 tiles of 512 over
    the 1M terrain's 7,872 padded clusters, fanout 8, super_k 10, k 48)
    takes level 0: 123 level-0 boxes, 12 admitted, 96 level-1 boxes, 10
    admitted, 80 member slots, in a few KiB of shared memory."""
    shp = TCT.phase1_shape(489 * 512, 7872, 512, 8, 48, p1_fanout=8, p1_super_k=10)
    assert (shp.tiles, shp.s, shp.s0, shp.k0, shp.n_s, shp.ks, shp.kf, shp.k_eff) == (
        489, 984, 123, 12, 984, 10, 80, 48)
    assert shp.smem == 4 * (6 * 123 + 123 + 12 + 96 + 10 + 2 * 80 + 3 * 48)


def test_plain_phase1_and_the_kernel_are_sized_in_one_place(monkeypatch):
    """_tile_candidates takes its sizes from phase1_sizes, and phase1_shape
    (the kernel's sizes, its shared memory among them) is phase1_sizes'
    answer once the kernel's limits pass: one derivation for both paths."""
    seen, inner = [], TCT.phase1_sizes
    monkeypatch.setattr(TCT, "phase1_sizes", lambda *a: seen.append(inner(*a)) or seen[-1])
    TCT._tile_candidates(*_inputs(), 64, 4, 64, p1_fanout=4, p1_super_k=24)
    shp = TCT.phase1_shape(256, 96, 64, 4, 64, p1_fanout=4, p1_super_k=24)
    assert seen == [shp, shp] and (shp.tiles, shp.s, shp.ks, shp.kf, shp.k_eff) == (4, 24, 24, 96, 64)


def _globals(path):
    return re.findall(r"__global__\s+(?:void\s+)?(?:__launch_bounds__\([^)]*\)\s+)?(?:void\s+)?(\w+)\s*\(",
                      path.read_text())


def test_no_other_kernel_is_read_as_the_traversal():
    """benchmark/readers.py matches TRAVERSAL_KERNELS as substrings of
    kernel names into mt_traverse_roofline: only the traversal's own two
    kernels may match, and phase 1's kernels none."""
    names = {p.name: _globals(p) for p in sorted(_CSRC.glob("*.cu"))}
    assert set(names["phase1.cu"]) == {"phase1_boxes_kernel", "phase1_kernel"}
    assert {"cand_kernel", "sweep_kernel"} <= set(names["mt_traverse.cu"])
    for file, kernels in names.items():
        for name in kernels:
            hits = [k for k in TRAVERSAL_KERNELS if k in name]
            assert not hits or (file == "mt_traverse.cu" and name in TRAVERSAL_KERNELS), (file, name)
