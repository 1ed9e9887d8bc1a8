"""The traversal's last two kernel modes: the port's plain version on the
CPU against rts_tpu's kernel in interpret mode, on the scene and rays of
test_torch_traversal (tests/test_torch_options.py has the mask candidate
order, the work counters and the modes through prepare_cpi).

- K5 (``resident_cap``): candidate windows read a compacted pack of the
  live clusters; a live set over the cap sends every tile to the sweep.
- K6 (``mt_union=False``): one window per candidate, each gated by its own
  bits, with and without the mt_prune window prune.

Tolerances as in test_torch_traversal (tri/found identical, t rtol
T_RTOL, beta/gamma atol BARY_ATOL): XLA's CPU backend contracts FMAs in
rts_tpu's kernel, the port rounds every product.  Each mode also equals
the port's default traversal bit for bit: none of them changes a hit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rts_tpu.ops import closest_hit_clustered as j_closest_hit

from rts_tpu_torch.ops import cluster_trace as TCT
from rts_tpu_torch.ops import closest_hit_clustered
from test_torch_traversal import BARY_ATOL, CS, RT, T_RTOL, _rays, _scene, _t

torch.set_num_threads(1)

_FIELDS = ("t", "tri", "beta", "gamma", "found")


def _silhouette_rays(l=3 * RT, seed=3):
    """Rays from the origin into the sphere's silhouette: front-face hits
    put the running bests before the back-face clusters' entries."""
    rng = np.random.default_rng(seed)
    d = np.stack([np.ones(l), rng.uniform(-0.04, 0.04, l), rng.uniform(-0.04, 0.04, l)])
    return np.zeros((3, l), np.float32), d.astype(np.float32), np.full(l, 0.005, np.float32)


def _both(rays, scene, **kw):
    """rts_tpu's kernel (interpret mode) and the port's plain version, with
    the port's default traversal on the same inputs: (ref, got, default)."""
    o, d, tmin = rays
    pack, mn, mx = scene
    kw = dict(cluster_size=CS, ray_tile=RT, group_size=8, super_size=1, **kw)
    ref = j_closest_hit(jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmin), pack, mn, mx,
                        jnp.zeros(3, jnp.float32), components=True, interpret=True, **kw)
    args = (_t(o), _t(d), _t(tmin), _t(pack), _t(mn), _t(mx), torch.zeros(3))
    got = closest_hit_clustered(*args, **kw)
    default = {k: v for k, v in kw.items()
               if k not in ("resident_cap", "mt_union", "cand_order", "mt_prune")}
    return ref, got, closest_hit_clustered(*args, **default)


def _assert_matches(ref, got, default, min_found=60):
    found = np.asarray(ref.found)
    assert found.sum() > min_found
    np.testing.assert_array_equal(got.found.numpy(), found)
    np.testing.assert_array_equal(got.tri.numpy()[found], np.asarray(ref.tri)[found])
    np.testing.assert_allclose(got.t.numpy()[found], np.asarray(ref.t)[found], rtol=T_RTOL)
    for name in ("beta", "gamma"):
        np.testing.assert_allclose(getattr(got, name).numpy()[found],
                                   np.asarray(getattr(ref, name))[found], rtol=0, atol=BARY_ATOL)
    for name in _FIELDS:
        assert torch.equal(getattr(got, name), getattr(default, name)), name


@pytest.mark.parametrize("cap, group", [(256, 8), (64, 4), (2, 8)])
def test_resident_matches_rts_tpu(cap, group):
    """K5 (tests/test_cluster_trace.py's resident cases): windows from the
    live pack, and at cap 2 the live-set overflow to the sweep."""
    before = TCT.mt_traverse.resident_overflows.clone()
    ref, got, default = _both(_rays(), _scene(), candidates=64, mt_group=group, resident_cap=cap)
    _assert_matches(ref, got, default)
    assert int(TCT.mt_traverse.resident_overflows - before) == (cap == 2)


@pytest.mark.parametrize("group, prune", [(4, False), (8, False), (2, True)],
                         ids=["g4", "g8", "g2_prune"])
def test_per_candidate_windows_match_rts_tpu(group, prune):
    """K6, and K6 with the K3 prune on the shell scene whose back faces the
    front faces occlude (tests/test_cluster_trace.py's mt_union=False
    cases)."""
    if prune:
        ref, got, default = _both(_silhouette_rays(), _scene(subdiv=4), candidates=48,
                                  mt_group=group, mt_union=False, mt_prune=True, sub_tiles=4)
    else:
        ref, got, default = _both(_rays(), _scene(), candidates=48, mt_group=group,
                                  mt_union=False, sub_tiles=8)
    _assert_matches(ref, got, default)
