"""Morton fan tiling (``fan_order``) and lane compaction (``compact_lanes``)
in the port against rts_tpu.

Both options re-form the clustered traversal's ray tiles and undo the
permutation before the result is assembled.  ``fan_tile_perm`` and the
row-layout ``generate_fan`` must equal rts_tpu's.  Through ``trace_fan``
(the clustered f32 path; rts_tpu's Pallas kernel in interpret mode) each
option must give rts_tpu's result with the same option: the same tiles,
so every discrete output identical and the continuous ones within
tests/test_torch_cpi.py's f32 bounds (XLA contracts FMAs under jit, the
port rounds every product), but for the power of refracted children:
their 2 m legs inside the slab start at hit points known to a few ulp of
~1 km coordinates (~6e-5 m), and the 1/r^2 spreading of so short a leg
turns that into ~1e-4 (measured 3.7e-4 at most), held to 1e-3.  Against the port's own raster trace
the result must be the same up to exact-t ties: a tile visits its
clusters in an order that depends on its rays, so a ray through an edge
or vertex two triangles share may take the other triangle.  Every lane
whose triangle chain matches the raster trace's is bit-identical in every
output; a lane whose chain differs must part from it, at its first
differing step, on two triangles that share a corner.  Both with
refraction off (a terrain, BASELINE config 4 cut to ~1k triangles) and on
(the same terrain under a dielectric slab, config 3).
"""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rts_tpu.sim as js
from rts_tpu import Parameters as JParameters
from rts_tpu.engine import wavefront as JW
from rts_tpu.engine.animate import animate_packed as j_animate
from rts_tpu.engine.fan import fan_tile_perm as j_perm
from rts_tpu.engine.fan import generate_fan as j_generate_fan
from rts_tpu.engine.fan import generate_fan_c as j_fan

import rts_tpu_torch.engine.wavefront as TW
from rts_tpu_torch import convert
from rts_tpu_torch.engine.animate import ClusterScene
from rts_tpu_torch.engine.fan import fan_tile_perm as t_perm
from rts_tpu_torch.engine.fan import generate_fan as t_generate_fan

torch.set_num_threads(1)

DEVICE = "cpu"  # the port's entry points default to the card
CARRIER = 10e9


@pytest.mark.parametrize("mode", ["morton2", "morton3"])
@pytest.mark.parametrize("n", [2, 5, 9, 16, 63])
def test_fan_tile_perm_matches(n, mode):
    got, ref = t_perm(n, mode), j_perm(n, mode)
    np.testing.assert_array_equal(got, ref)
    assert sorted(got.tolist()) == list(range(n**3))


def test_generate_fan_matches():
    az, el = np.float32(0.3), np.float32(-0.2)
    ref = np.asarray(j_generate_fan(5, (jnp.float32(az), jnp.float32(el)), (0.15, 0.1, 0.0), dtype=jnp.float32))
    got = t_generate_fan(5, (torch.tensor(az), torch.tensor(el)), (0.15, 0.1, 0.0), device=DEVICE)
    assert got.shape == (125, 3)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=2.4e-7)  # the sin/cos may differ by an ulp


def world(S, refraction):
    """A terrain 4 km under a Tx/Rx looking down; with ``refraction`` the
    dielectric slab of bench.py --scene dielectric (200 m, refl 0.5,
    index 1.5) at 1 km and a forward Rx looking up, at 100 m (above this
    cut's 60 m peaks; rts_tpu_torch/bench.py's stands at 600 m)."""
    w = S.World()
    down = S.RotationPath(elevation=-math.pi / 2)
    w.add(S.Transmitter(path=S.Path.fixed(0.0, 0.0, 4000.0), wave=S.RadarSignal(carrier=CARRIER),
                        pulse_count=1, prf=1000.0, tx_span=(0.15, 0.15, 0.0), rotation=down))
    w.add(S.Receiver(path=S.Path.fixed(0.0, 0.0, 4000.0), sphere=(25.0, 1.2, 1.2), rotation=down))
    w.add(S.Target(shape="terrain", terrain=(24, 1500.0, 60.0, 3), path=S.Path.fixed(0.0, 0.0, 0.0),
                   refl_coeff=0.9))
    if refraction:
        w.add(S.Receiver(path=S.Path.fixed(0.0, 0.0, 100.0), rotation=S.RotationPath(elevation=math.pi / 2),
                         sphere=(60.0, 1.4, 1.4)))
        w.add(S.Target(shape="rect", rect=(2.0, 200.0, 200.0), attitude=S.AttitudePath(pitch=math.pi / 2),
                       path=S.Path.fixed(0.0, 0.0, 1000.0), refl_coeff=0.5, refr_index=1.5))
    else:
        w.add(S.Target(shape="rect", rect=(2.0, 60.0, 60.0), attitude=S.AttitudePath(pitch=math.pi / 2),
                       path=S.Path.fixed(0.0, 0.0, 400.0), refl_coeff=0.9))
    return w


_STATE = {}


def state(refraction):
    """rts_tpu's pulse-0 operands of trace_fan (the production knobs at a
    9^3 fan and 32-ray tiles), and the port's copies of them."""
    if refraction not in _STATE:
        params = JParameters(num_rays=9, max_refl_depth=2, max_refr_depth=2 if refraction else 0)
        jb, jbat, jcfg, jspec = js.prepare_cpi(world(js, refraction), params, dtype=jnp.float32,
                                               preset="production", refine=False, cluster_size=128,
                                               ray_tile=32, compact_narrow=0, interpret=True)
        jsc = j_animate(jb, jbat.rot[0], jbat.pos[0], jbat.vel[0], 128)
        fan = j_fan(jcfg.num_rays, (jbat.tx_dir[0, 0], jbat.tx_dir[0, 1]), jspec.kwargs()["tx_span"],
                    dtype=jnp.float32)
        rx = type(jbat.rx_geom)(*(a[0] for a in jbat.rx_geom))
        j_args = (jsc, rx, jbat.tx_origin[0], fan)
        t_args = (ClusterScene(*(convert.tensor(getattr(jsc, f), DEVICE) for f in ClusterScene._fields)),
                  convert.rx_geom(rx, DEVICE), convert.tensor(jbat.tx_origin[0], DEVICE),
                  convert.tensor(fan, DEVICE))
        cfg = convert.trace_config(jcfg)
        corners = convert.scene_base(jb, device=DEVICE).tri_verts
        _STATE[refraction] = dict(jcfg=jcfg, j_args=j_args, t_args=t_args, cfg=cfg, corners=corners,
                                  raster=TW.trace_fan(*t_args, cfg))
    return _STATE[refraction]


def share_a_corner(corners, a: int, b: int) -> bool:
    ca, cb = corners[a], corners[b]  # [3 corners, 3]
    return bool((ca[:, None, :] == cb[None, :, :]).all(-1).any())


OPTIONS = {"morton2": dict(fan_order="morton2"), "morton3": dict(fan_order="morton3"),
           "compact_lanes": dict(compact_lanes=True)}


@pytest.mark.parametrize("refraction", [False, True], ids=["reflection", "refraction"])
@pytest.mark.parametrize("option", list(OPTIONS))
def test_option_matches_rts_tpu_and_raster(option, refraction):
    s = state(refraction)
    jcfg = dataclasses.replace(s["jcfg"], **OPTIONS[option])
    ref = JW.trace_fan(*s["j_args"], jcfg)
    got = TW.trace_fan(*s["t_args"], convert.trace_config(jcfg))
    rec = np.asarray(ref.received)
    assert (rec >= 0).sum() > 0
    assert got.received.shape[0] == jcfg.ray_total
    if refraction:
        assert (np.asarray(ref.refr_depth) == 2).any()
    # against rts_tpu with the same option: the same tiles
    for name in ("received", "path", "tri_seq", "refl_depth", "refr_depth", "cap_bits", "cap_root0_bits"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(ref, name)), err_msg=name)
    np.testing.assert_allclose(got.ray_length.numpy(), np.asarray(ref.ray_length), rtol=1e-5)
    n3 = jcfg.rays_per_fan
    for lanes, rtol in ((slice(0, n3), 5e-5), (slice(n3, None), 1e-3)):
        np.testing.assert_allclose(got.power.numpy()[lanes], np.asarray(ref.power)[lanes], rtol=rtol, atol=0)
    np.testing.assert_allclose(got.doppler.numpy(), np.asarray(ref.doppler), rtol=1e-5, atol=1e-6)

    # against the port's raster trace, up to exact-t ties
    raster = s["raster"]
    same = (got.tri_seq == raster.tri_seq).all(0)
    for name, a, b in zip(got._fields, got, raster):
        assert torch.equal(a[..., same], b[..., same]), name
    parted = torch.nonzero(~same).reshape(-1).tolist()
    assert len(parted) <= 0.05 * got.received.shape[0]
    for lane in parted:
        c = int(torch.nonzero(got.tri_seq[:, lane] != raster.tri_seq[:, lane])[0])
        a, b = int(got.tri_seq[c, lane]), int(raster.tri_seq[c, lane])
        assert a >= 0 and b >= 0 and share_a_corner(s["corners"], a, b), (lane, c, a, b)
