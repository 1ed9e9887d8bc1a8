"""The port's clustered traversal against rts_tpu's (Pallas in interpret mode).

Phase 1 (``_tile_candidates``: candidate lists, counts, sub-block bits
and the mt_prune entry table) must be bit-identical: it is compares,
min/max, one multiply per slab and a floor, with no operation whose
rounding the two frameworks could order differently.  Phase 2 (the MT
traversal, with and without the mt_prune window prune) must
find the same triangles (``tri``/``found`` identical).  Its t, beta and
gamma are held to a few ulps, not bit equality, because XLA's CPU backend
contracts a*b + c into fused multiply-adds (the port, like the CUDA
kernel, rounds every product), and beta/gamma are differences of nearly
equal dot products at ~1 km, which amplifies a one-ulp change of an
operand: t is held to rtol 4e-6 (~32 ulp) and beta/gamma to an absolute
2e-5 of their [0, 1] range.  The prune is exact, so the port with it
equals the port without it bit for bit; the emitted shade rows are exact
copies of the shade table, so they equal rts_tpu's bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rts_tpu.accel import cluster_aabbs as j_cluster_aabbs
from rts_tpu.accel import cluster_reorder as j_cluster_reorder
from rts_tpu.engine.types import scene_to_device
from rts_tpu.geometry import rect_mesh, sphere_mesh
from rts_tpu.geometry.scene import compile_scene
from rts_tpu.ops import closest_hit_clustered as j_closest_hit
from rts_tpu.ops import cluster_trace as JCT
from rts_tpu.ops import pack_tri_fields

from rts_tpu_torch.ops import cluster_trace as TCT
from rts_tpu_torch.ops import closest_hit_clustered, mt_traverse_reference
from rts_tpu_torch.utils import timing

torch.set_num_threads(1)

CS, RT = 128, 128
T_RTOL = 4e-6
BARY_ATOL = 2e-5


def _t(a, dtype=None):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _random_boxes(rng, c, spread=300.0):
    lo = rng.uniform(-spread, spread, (c, 3)).astype(np.float32)
    hi = lo + rng.uniform(1, 100, (c, 3)).astype(np.float32)
    return lo, hi


def _random_rays_c(rng, l, spread=350.0):
    o = rng.uniform(-spread, spread, (3, l)).astype(np.float32)
    d = rng.normal(size=(3, l)).astype(np.float32)
    d[1:, :16] = 0.0  # axis-aligned
    d[:, -8:] = 0.0  # dead lanes
    o[:, 16:24] = 0.0
    tmin = np.full(l, 0.005, np.float32)
    return o, d, tmin


_P1_OUT = ("cand", "meta", "bits", "ent")


def _both_candidates(o, d, tmin, lo, hi, rt, st, k, **kw):
    j = JCT._tile_candidates(jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmin),
                             jnp.asarray(lo), jnp.asarray(hi), rt, st, k, **kw)
    t = TCT._tile_candidates(_t(o), _t(d), _t(tmin), _t(lo), _t(hi), rt, st, k, **kw)
    return [np.asarray(a) for a in j], [a.numpy() for a in t]


@pytest.mark.parametrize(
    "case",
    ["dense", "list_padding", "narrow_list", "overflow", "sentinels", "mask_order", "chunked"],
)
def test_phase1_bit_identical(case, monkeypatch):
    """cand/meta/bits/ent equal rts_tpu's, element for element, on random
    boxes and rays (axis-aligned, dead and boxed-in lanes included), with
    the mask candidate order and with level 2 run in chunks of tiles."""
    rng = np.random.default_rng({"dense": 1, "list_padding": 2, "narrow_list": 3,
                                 "overflow": 4, "sentinels": 5, "mask_order": 6,
                                 "chunked": 7}[case])
    c = 96
    lo, hi = _random_boxes(rng, c)
    if case == "sentinels":
        lo[-7:] = np.inf
        hi[-7:] = np.inf
    o, d, tmin = _random_rays_c(rng, 256)
    kw = dict(p1_fanout=4, p1_super_k=24)
    k = 64
    if case == "list_padding":
        k = 96  # wider than any tile's count: every list is padded
    elif case == "narrow_list":
        kw = dict(p1_fanout=4, p1_super_k=3)  # k_eff = 12 < k_max: zero-padded tail
    elif case == "overflow":
        kw = dict(p1_fanout=4, p1_super_k=2)  # admission cap far below the overlaps
    elif case == "mask_order":
        kw["cand_order"] = "mask"
    elif case == "chunked":
        monkeypatch.setattr(TCT, "_P1_CHUNK_ELEMS", 64 * 96)  # one tile per chunk
    j, t = _both_candidates(o, d, tmin, lo, hi, 64, 4, k, **kw)
    if case == "overflow":
        assert j[1][:, 1].any()
    else:
        assert j[1][:, 0].max() > 2
    # padding slots hold 2**30 and real entries are floored 1/16 m units
    assert (j[3] == 2**30).any() and (j[3] < 2**30).any()
    for a, b, name in zip(j, t, _P1_OUT):
        np.testing.assert_array_equal(b, a, err_msg=name)


def test_phase1_level0_bit_identical(monkeypatch):
    """The level-0 pass (big scenes) forced on through the threshold, in
    both packages, with and without level-0 overflow."""
    rng = np.random.default_rng(11)
    lo, hi = _random_boxes(rng, 96)
    o, d, tmin = _random_rays_c(rng, 256)
    monkeypatch.setattr(JCT, "_P1_L0_MIN_S", 8)
    monkeypatch.setattr(TCT, "_P1_L0_MIN_S", 8)
    for k0 in (None, 1):
        j, t = _both_candidates(o, d, tmin, lo, hi, 64, 4, 64,
                                p1_fanout=2, p1_super_k=48, p1_super_k0=k0)
        assert j[1][:, 0].max() > 2
        if k0 == 1:
            assert j[1][:, 1].any()
        for a, b, name in zip(j, t, _P1_OUT):
            np.testing.assert_array_equal(b, a, err_msg=f"{name} k0={k0}")


def _scene(with_shade=False, subdiv=3):
    """A closed sphere shell (its back faces occluded by its front faces)
    and a plate; with ``with_shade`` also the [T, 10] shade table."""
    mesh, _ = sphere_mesh(subdiv, 50.0)
    plate = rect_mesh(2.0, 150.0, 150.0).translated([300.0, 100.0, 0.0])
    scene = compile_scene([mesh.translated([900.0, 0.0, 0.0]), plate], [0.9, 0.7], [1.0, 1.0])
    dev = scene_to_device(j_cluster_reorder(scene, cluster_size=CS), dtype=jnp.float32)
    mn, mx = j_cluster_aabbs(dev.tri_p0, dev.tri_e0, dev.tri_e1, CS, xp=jnp)
    pack = pack_tri_fields(dev.tri_n, dev.tri_c1, dev.tri_c0, dev.tri_e1, dev.tri_e0, dev.tri_np0)
    if not with_shade:
        return pack, mn, mx
    shade = jnp.concatenate([dev.tri_corner_normals.reshape(-1, 9),
                             dev.tri_target.astype(jnp.float32)[:, None]], axis=1)
    return pack, mn, mx, shade


def _rays(l=3 * RT, seed=0):
    rng = np.random.default_rng(seed)
    o = np.zeros((3, l), np.float32)
    o[:, l // 2 :] = rng.uniform(-100, 1000, (3, l - l // 2))
    d = np.zeros((3, l), np.float32)
    q = l // 4
    d[:, :q] = np.stack([np.ones(q), rng.uniform(-0.1, 0.1, q), rng.uniform(-0.1, 0.1, q)])
    d[:, q:-8] = rng.normal(size=(3, l - q - 8))
    aim = np.array([[900.0], [0.0], [0.0]]) + rng.uniform(-40, 40, (3, 40))
    d[:, l // 2 : l // 2 + 40] = aim - o[:, l // 2 : l // 2 + 40]
    return o, d, np.full(l, 0.005, np.float32)


_MODES = {
    "candidates_g8_tail": dict(candidates=48, mt_group=8, mt_tail=True, sub_tiles=8),
    "sweep_only": dict(candidates=0, sub_tiles=4),
    "forced_overflow": dict(candidates=16, mt_group=4, p1_fanout=2, p1_super_k=1, sub_tiles=4),
    "sweep_supergroups": dict(candidates=0, group_size=2, super_size=2, sub_tiles=2),
}


@pytest.mark.parametrize("mode", sorted(_MODES))
def test_traversal_matches_rts_tpu(mode):
    """closest_hit_clustered, plain version on the CPU, against rts_tpu's
    Pallas kernel in interpret mode on identical inputs."""
    pack, mn, mx = _scene()
    o, d, tmin = _rays()
    sort_origin = np.zeros(3, np.float32)
    kw = dict(cluster_size=CS, ray_tile=RT, group_size=8, super_size=1)
    kw.update(_MODES[mode])
    ref = j_closest_hit(jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmin), pack, mn, mx,
                        jnp.asarray(sort_origin), components=True, interpret=True, **kw)
    got = closest_hit_clustered(_t(o), _t(d), _t(tmin), _t(pack), _t(mn), _t(mx),
                                _t(sort_origin), **kw)
    found = np.asarray(ref.found)
    assert found.sum() > 60
    np.testing.assert_array_equal(got.found.numpy(), found)
    np.testing.assert_array_equal(got.tri.numpy()[found], np.asarray(ref.tri)[found])
    np.testing.assert_allclose(got.t.numpy()[found], np.asarray(ref.t)[found], rtol=T_RTOL)
    for name in ("beta", "gamma"):
        np.testing.assert_allclose(getattr(got, name).numpy()[found],
                                   np.asarray(getattr(ref, name))[found], rtol=0, atol=BARY_ATOL)
    if mode == "forced_overflow":
        # the overflow really sent tiles to the sweep
        lp = o.shape[1]
        _, meta, _, _ = TCT._tile_candidates(_t(o), _t(d), _t(tmin), _t(mn), _t(mx), RT, 4, 16,
                                             p1_fanout=2, p1_super_k=1)
        assert meta[:, 1].any() and lp % RT == 0


_PRUNE_MODES = {
    # the moving scene's knobs: one cluster per window, no tail window
    "g1": dict(candidates=48, mt_group=1, mt_tail=True, sub_tiles=4),
    "g4_tail": dict(candidates=48, mt_group=4, mt_tail=True, sub_tiles=8),
}


def _count_evaluated(monkeypatch):
    """Count the (ray, column) pairs the plain version's windows gate in."""
    seen = [0]
    inner = TCT._mt_window

    def counting(o, d, m, tmin, f, gate, tri_ids, best):
        seen[0] += int(torch.broadcast_to(gate, tmin.shape[:-1] + (f.shape[-1],)).sum())
        return inner(o, d, m, tmin, f, gate, tri_ids, best)

    monkeypatch.setattr(TCT, "_mt_window", counting)
    return seen


@pytest.mark.parametrize("mode", sorted(_PRUNE_MODES))
def test_mt_prune_matches_rts_tpu(mode, monkeypatch):
    """K3: the running-best window prune on a shell scene, against
    rts_tpu's kernel with mt_prune=True (tri/found identical, t/beta/gamma
    to the stated tolerances), and against the port without the prune,
    bit for bit, while the prune really skips windows."""
    pack, mn, mx = _scene(subdiv=4)  # 40 clusters: some lie wholly behind the front faces
    # rays from the origin into the sphere's silhouette: front-face hits
    # put every running best before the back-face clusters' entries
    rng = np.random.default_rng(3)
    l = 3 * RT
    o = np.zeros((3, l), np.float32)
    d = np.stack([np.ones(l), rng.uniform(-0.04, 0.04, l), rng.uniform(-0.04, 0.04, l)]).astype(np.float32)
    tmin = np.full(l, 0.005, np.float32)
    kw = dict(cluster_size=CS, ray_tile=RT, group_size=8, super_size=1, **_PRUNE_MODES[mode])
    args = (_t(o), _t(d), _t(tmin), _t(pack), _t(mn), _t(mx), torch.zeros(3))
    ref = j_closest_hit(jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmin), pack, mn, mx,
                        jnp.zeros(3, jnp.float32), components=True, interpret=True,
                        mt_prune=True, **kw)
    seen = _count_evaluated(monkeypatch)
    got = closest_hit_clustered(*args, mt_prune=True, **kw)
    pruned = seen[0]
    plain = closest_hit_clustered(*args, **kw)
    assert pruned < seen[0] - pruned  # the gate fired: fewer pairs than without it
    found = np.asarray(ref.found)
    assert found.sum() > 60
    np.testing.assert_array_equal(got.found.numpy(), found)
    np.testing.assert_array_equal(got.tri.numpy()[found], np.asarray(ref.tri)[found])
    np.testing.assert_allclose(got.t.numpy()[found], np.asarray(ref.t)[found], rtol=T_RTOL)
    for name in ("beta", "gamma"):
        np.testing.assert_allclose(getattr(got, name).numpy()[found],
                                   np.asarray(getattr(ref, name))[found], rtol=0, atol=BARY_ATOL)
    for name in ("t", "tri", "beta", "gamma", "found"):
        assert torch.equal(getattr(got, name), getattr(plain, name)), name


def _tie_scene(order):
    """Three clusters of CS columns holding one triangle X three times: at
    columns 5 and 77 of cluster 0 and at column 3 of cluster 1 (every
    other column is all zeros, which never hits); cluster 2 lies behind
    the rays.  ``order`` names the cluster whose box the rays enter first.
    Rays from the origin into X."""
    p0, p1, p2 = (np.array(v, np.float32) for v in ([500, -50, -50], [500, 60, -40], [500, 0, 70]))
    e0, e1 = p1 - p0, p0 - p2
    n = np.cross(e1, e0)
    col = np.concatenate([n, np.cross(p0, e1), np.cross(p0, e0), e1, e0, [n @ p0]])
    pack = np.zeros((16, 3 * CS), np.float32)
    for j in (5, 77, CS + 3):
        pack[:, j] = col
    near, far = [490.0, -60.0, -60.0], [495.0, -60.0, -60.0]
    mn = np.array([near, far, [-1010.0, -5.0, -5.0]] if order == 0 else
                  [far, near, [-1010.0, -5.0, -5.0]], np.float32)
    mx = np.array([[510.0, 70.0, 80.0]] * 2 + [[-1000.0, 5.0, 5.0]], np.float32)
    rng = np.random.default_rng(7)
    l = 2 * RT
    d = np.stack([np.ones(l), rng.uniform(-0.05, 0.05, l), rng.uniform(-0.05, 0.05, l)]).astype(np.float32)
    return pack, mn, mx, np.zeros((3, l), np.float32), d, np.full(l, 0.005, np.float32)


_TIE_WINDOWS = {
    "union_g2": dict(mt_group=2),
    "g1": dict(mt_group=1),
    "per_candidate": dict(mt_group=2, mt_union=False),
}


@pytest.mark.parametrize("window", sorted(_TIE_WINDOWS))
@pytest.mark.parametrize("order", [0, 1], ids=["near_first", "far_first"])
def test_exact_tie_matches_rts_tpu(window, order):
    """An exact t tie among copies of one triangle, two in the cluster the
    rays enter first or second and one in the other: the first column of
    the first candidate that holds a copy wins in rts_tpu's kernel and in
    the port's plain version alike (the rule the CUDA kernel is held to,
    tests/test_torch_kernel.py)."""
    pack, mn, mx, o, d, tmin = _tie_scene(order)
    kw = dict(cluster_size=CS, ray_tile=RT, group_size=8, super_size=1, sub_tiles=4,
              candidates=4, mt_prune=True, **_TIE_WINDOWS[window])
    ref = j_closest_hit(jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmin), jnp.asarray(pack),
                        jnp.asarray(mn), jnp.asarray(mx), jnp.zeros(3, jnp.float32),
                        components=True, interpret=True, **kw)
    got = closest_hit_clustered(_t(o), _t(d), _t(tmin), _t(pack), _t(mn), _t(mx), torch.zeros(3), **kw)
    found = np.asarray(ref.found)
    assert found.sum() > RT
    np.testing.assert_array_equal(got.found.numpy(), found)
    np.testing.assert_array_equal(np.asarray(ref.tri)[found], 5 if order == 0 else CS + 3)
    np.testing.assert_array_equal(got.tri.numpy(), np.asarray(ref.tri))


@pytest.mark.parametrize("mode", ["candidates_g8_tail", "forced_overflow", "sweep_only"])
def test_emit_shade_matches_rts_tpu(mode):
    """K4: HitResult.shade is the winner's shade_pack row (zeros where no
    triangle won), equal to rts_tpu's kernel-emitted rows, in candidate,
    overflow-to-sweep and sweep-only tiles; the hit itself is unchanged."""
    pack, mn, mx, shade = _scene(with_shade=True)
    o, d, tmin = _rays()
    kw = dict(cluster_size=CS, ray_tile=RT, group_size=8, super_size=1, **_MODES[mode])
    pack32 = jnp.concatenate([pack, shade.T, jnp.zeros((6, pack.shape[1]), jnp.float32)])
    ref = j_closest_hit(jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmin), pack32, mn, mx,
                        jnp.zeros(3, jnp.float32), components=True, interpret=True,
                        emit_shade=True, **kw)
    args = (_t(o), _t(d), _t(tmin), _t(pack), _t(mn), _t(mx), torch.zeros(3))
    got = closest_hit_clustered(*args, emit_shade=True, shade_pack=_t(shade), **kw)
    plain = closest_hit_clustered(*args, **kw)
    assert plain.shade is None and got.shade.shape == (10, o.shape[1])
    for name in ("t", "tri", "beta", "gamma", "found"):
        assert torch.equal(getattr(got, name), getattr(plain, name)), name
    found = got.found.numpy()
    assert found.sum() > 60
    np.testing.assert_array_equal(got.shade.numpy()[:, found], np.asarray(shade)[got.tri.numpy()[found]].T)
    assert (got.shade.numpy()[:, ~found] == 0.0).all()
    np.testing.assert_array_equal(got.shade.numpy(), np.asarray(ref.shade))


@pytest.mark.parametrize("option", [dict(emit_shade=True)], ids=["emit_shade_without_table"])
def test_unported_options_raise(option):
    """Every traversal option of rts_tpu runs (tests/test_torch_modes.py);
    the shade emit without its table is refused."""
    pack, mn, mx = _scene()
    o, d, tmin = _rays(l=RT)
    with pytest.raises(ValueError, match="shade_pack"):
        closest_hit_clustered(_t(o), _t(d), _t(tmin), _t(pack), _t(mn), _t(mx),
                              cluster_size=CS, ray_tile=RT, **option)


def test_cpu_tensors_take_the_plain_version():
    """On CPU tensors the wrapper runs mt_traverse_reference and never
    counts a kernel launch."""
    pack, mn, mx = _scene()
    o, d, tmin = _rays(l=RT)
    before = timing.counters().get("traverse.calls", 0)
    args = (_t(o), _t(d), _t(tmin), _t(pack), _t(mn), _t(mx))
    kw = dict(cluster_size=CS, ray_tile=RT, candidates=16, mt_group=4)
    a = closest_hit_clustered(*args, **kw)
    b = closest_hit_clustered(*args, traverse=mt_traverse_reference, **kw)
    assert timing.counters().get("traverse.calls", 0) == before
    assert a.shade is None and b.shade is None
    for name in ("t", "tri", "beta", "gamma", "found"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
