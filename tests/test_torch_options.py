"""The traversal options around the kernel modes: the mask candidate order,
the work counters and K5's live-set overflow decision, the port's plain
version on the CPU against rts_tpu (kernel in interpret mode, phase 1
eagerly); and K5 and K6 through prepare_cpi and trace_cpi.

Tolerances as in test_torch_traversal: tri/found identical, t rtol T_RTOL,
beta/gamma atol BARY_ATOL (XLA's CPU backend contracts FMAs in rts_tpu's
kernel, the port rounds every product).  The options change no hit, so
each also equals the port's default bit for bit.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rts_tpu.sim as js
from rts_tpu import Parameters as JParameters
from rts_tpu.ops import closest_hit_clustered as j_closest_hit
from rts_tpu.ops import cluster_trace as JCT

import rts_tpu_torch.sim as ts
from rts_tpu_torch import Parameters as TParameters
from rts_tpu_torch.engine.cpi import trace_cpi
from rts_tpu_torch.ops import closest_hit_clustered, mt_traverse_reference
from test_torch_cpi import terrain_world
from test_torch_modes import _FIELDS, _assert_matches, _both
from test_torch_traversal import CS, RT, _rays, _scene, _t

torch.set_num_threads(1)

DEVICE = "cpu"  # the port's entry points default to the card


@pytest.mark.parametrize("group", [2, 4])
def test_mask_order_matches_rts_tpu(group):
    """cand_order="mask" (tests/test_cluster_trace.py's mask cases)."""
    ref, got, default = _both(_rays(), _scene(), candidates=64, mt_group=group, cand_order="mask")
    _assert_matches(ref, got, default)


_STATS_MODES = {
    "forced_overflow": dict(candidates=16, mt_group=4, p1_fanout=2, p1_super_k=1, sub_tiles=4),
    "sweep_supergroups": dict(candidates=0, group_size=2, super_size=2, sub_tiles=2),
}


@pytest.mark.parametrize("mode", sorted(_STATS_MODES))
def test_stats_match_rts_tpu(mode):
    """with_stats: a candidate tile's counters equal rts_tpu's; a swept
    tile's are at most rts_tpu's (the port's sweep processes a cluster at
    once, the TPU's one step later, so its running best is never fresher)."""
    pack, mn, mx = _scene()
    o, d, tmin = _rays()
    kw = dict(cluster_size=CS, ray_tile=RT, group_size=8, super_size=1)
    kw.update(_STATS_MODES[mode])
    ref, ref_stats = j_closest_hit(jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmin), pack, mn, mx,
                                   jnp.zeros(3, jnp.float32), components=True, interpret=True,
                                   with_stats=True, **kw)
    metas = []

    def capture(inp, shape):
        metas.append(inp.meta)
        return mt_traverse_reference(inp, shape)

    args = (_t(o), _t(d), _t(tmin), _t(pack), _t(mn), _t(mx), torch.zeros(3))
    got, stats = closest_hit_clustered(*args, with_stats=True, traverse=capture, **kw)
    np.testing.assert_array_equal(got.tri.numpy(), closest_hit_clustered(*args, **kw).tri.numpy())
    ref_stats = np.asarray(ref_stats)
    stats = stats.numpy()
    assert stats.shape == ref_stats.shape == (o.shape[1] // RT, 2)
    swept = metas[0][:, 1].numpy() != 0
    assert swept.any() and (stats[swept].sum(0) > 0).all()
    np.testing.assert_array_equal(stats[~swept], ref_stats[~swept])
    assert (stats[swept] <= ref_stats[swept]).all()
    if (~swept).any():
        np.testing.assert_array_equal(stats[~swept, 0], metas[0][~swept, 0].numpy())


@pytest.mark.parametrize("below", [True, False], ids=["cap_below_live_set", "cap_at_live_set"])
def test_resident_overflow_decision_matches_rts_tpu(below):
    """K5's live set counts the distinct ids of every tile's list, overflow
    tiles' lists and the zeros of empty tiles included: the port sends the
    same tiles to the sweep as rts_tpu's live set would, and remaps the
    candidates to the live slots of the sorted distinct ids."""
    pack, mn, mx = _scene()
    o, d, tmin = _rays(l=4 * RT)
    d[:, -RT:] = 0.0  # an empty tile: its list is zeros
    kw = dict(candidates=16, mt_group=4, p1_fanout=2, p1_super_k=2, sub_tiles=4)
    c_pad = -(-mn.shape[0] // 8) * 8
    pad = lambda a: np.concatenate([np.asarray(a), np.full((c_pad - a.shape[0], 3), np.inf, np.float32)])
    cand, meta, _, _ = JCT._tile_candidates(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmin), jnp.asarray(pad(mn)), jnp.asarray(pad(mx)),
        RT, 4, 16, p1_fanout=2, p1_super_k=2)
    cand, meta = np.asarray(cand), np.asarray(meta)
    live = np.unique(cand)
    assert meta[:, 1].any() and not meta[:, 1].all()  # some tiles overflow on their own
    cap = live.size - 1 if below else live.size
    seen = []

    def capture(inp, shape):
        seen.append(inp)
        return mt_traverse_reference(inp, shape)

    args = (_t(o), _t(d), _t(tmin), _t(pack), _t(mn), _t(mx), torch.zeros(3))
    got = closest_hit_clustered(*args, cluster_size=CS, ray_tile=RT, group_size=8, super_size=1,
                                resident_cap=cap, traverse=capture, **kw)
    inp = seen[0]
    np.testing.assert_array_equal(inp.meta[:, 1].numpy() != 0, (meta[:, 1] != 0) | (live.size > cap))
    np.testing.assert_array_equal(inp.live_tab.numpy(), live[:cap])
    if not below:
        np.testing.assert_array_equal(inp.live_tab.numpy()[inp.cand.numpy()], cand)
        np.testing.assert_array_equal(inp.live_pack.numpy(),
                                      np.asarray(pack)[:, (live[:, None] * CS + np.arange(CS)).reshape(-1)])
    plain = closest_hit_clustered(*args, cluster_size=CS, ray_tile=RT, group_size=8, super_size=1, **kw)
    for name in _FIELDS:
        assert torch.equal(getattr(got, name), getattr(plain, name)), name


_CPI_KW = dict(preset="production", refine=False, cluster_size=128, ray_tile=128)


@pytest.fixture(scope="module")
def default_cpi():
    state = ts.prepare_cpi(terrain_world(ts), TParameters(num_rays=9, max_refl_depth=2),
                           device=DEVICE, **_CPI_KW)
    return trace_cpi(*state)


@pytest.mark.parametrize("option", [dict(resident_cap=512), dict(mt_union=False)],
                         ids=["resident_cap", "mt_union_off"])
def test_terrain_cpi_modes_bit_identical(default_cpi, option):
    """The terrain CPI through prepare_cpi with K5 or K6 equals the default
    CPI in every output, bit for bit."""
    base, batch, cfg, spec = ts.prepare_cpi(terrain_world(ts), TParameters(num_rays=9, max_refl_depth=2),
                                            device=DEVICE, **_CPI_KW, **option)
    assert all(getattr(cfg, k) == v for k, v in option.items())
    got = trace_cpi(base, batch, cfg, spec)
    assert int((got.received >= 0).sum()) > 0
    for name, a, b in zip(got._fields, got, default_cpi):
        for x, y in (zip(a, b) if isinstance(a, tuple) else [(a, b)]):
            assert torch.equal(x, y), name


@pytest.mark.parametrize("option", [dict(resident_cap=256), dict(mt_union=False), dict(cand_order="mask")],
                         ids=["resident_cap", "mt_union_off", "mask_order"])
def test_prepare_cpi_config_equals_rts_tpu(option):
    """prepare_cpi accepts the three options and builds rts_tpu's config."""
    params = dict(num_rays=5, max_refl_depth=2)
    _, _, jcfg, _ = js.prepare_cpi(terrain_world(js), JParameters(**params), dtype=jnp.float32,
                                   **_CPI_KW, **option)
    _, _, tcfg, _ = ts.prepare_cpi(terrain_world(ts), TParameters(**params), device=DEVICE,
                                   **_CPI_KW, **option)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
