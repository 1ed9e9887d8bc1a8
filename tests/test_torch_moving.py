"""The moving-shell CPI (BASELINE config 2, ``bench.py --scene moving``) cut
to a small size, in the port against rts_tpu.

Four icospheres on linear radial paths at the fan nodes 12, 9, 15 and 3,
a monostatic radar, and the scene's traversal knobs: 1024-triangle
clusters, 128-wide candidate lists, one cluster per MT window, the
mt_prune window prune (K3), the float64 precision replay (refine=True,
replay_cap=128, agg_cap=1024) and the narrow late segments.  Cut: the
spheres at subdivision 2 (320 triangles each) instead of 7, a 7^3 fan
instead of 63^3, 2 pulses.

Discrete outputs (received lanes, path rows, emit, npath, path_match) must
equal rts_tpu's (Pallas traversal in interpret mode), with delay, power
and Doppler to the tolerances of tests/test_torch_cpi.py.  The phase is
held to the 1e-6 contract against rts_tpu's float64 dense engine: on
this scene rts_tpu's own double-single replay is 6.9e-5 rad from that
engine (ROADMAP C), so its phase is not the yardstick.  The shade emit
(K4) and the prune are exact: the port's CPI with either switched is
bit-identical to the one without.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rts_tpu.sim as js
from rts_tpu import Parameters as JParameters
from rts_tpu.engine.cpi import trace_cpi as j_trace_cpi

import rts_tpu_torch.sim as ts
from rts_tpu_torch import Parameters as TParameters
from rts_tpu_torch.engine.cpi import trace_cpi
from rts_tpu_torch.engine.fan import generate_fan_c
from test_torch_cpi import _j_trace, _t_trace

torch.set_num_threads(1)

PARAMS = dict(num_rays=7, max_refl_depth=2)
KNOBS = dict(accel="cluster", cluster_size=1024, candidates=128, mt_group=1, p1_fanout=16,
             p1_super_k=32, mt_prune=True, ray_tile=512, sub_tiles=8, mt_tail=True,
             compact_narrow=-1, refine=True, replay_cap=128, agg_cap=1024)
# (fan node of a 3^3 fan, range m, radial speed m/s), bench.py:169-174
SPHERES = ((12, 900.0, -50.0), (9, 1400.0, 80.0), (15, 2000.0, -140.0), (3, 2600.0, 30.0))
DEVICE = "cpu"  # the port's entry points default to the card


def moving_world(S, subdivisions=2, pulses=2):
    w = S.World()
    w.add(S.Transmitter(path=S.Path.fixed(0, 0, 0), wave=S.RadarSignal(carrier=10e9),
                        pulse_count=pulses, prf=1000.0, tx_span=(0.15, 0.15, 0.0)))
    w.add(S.Receiver(path=S.Path.fixed(0, 0, 0), sphere=(25.0, 1.2, 1.2)))
    nodes = generate_fan_c(3, (0.0, 0.0), (0.15, 0.15, 0.0), device=DEVICE).T.double().numpy()
    for node, rng, speed in SPHERES:
        d = nodes[node] / np.linalg.norm(nodes[node])
        w.add(S.Target(path=S.Path.linear([(0.0, tuple(rng * d)), (1.0, tuple((rng + speed) * d))]),
                       shape="sphere", sphere_params=(subdivisions, 60.0), refl_coeff=0.9))
    return w


@pytest.fixture(scope="module")
def runs():
    jstate = js.prepare_cpi(moving_world(js), JParameters(**PARAMS), dtype=jnp.float32, interpret=True,
                            **KNOBS)
    ref, ref_path = _j_trace(*jstate)
    b64, bat64, cfg64, spec64 = js.prepare_cpi(moving_world(js), JParameters(**PARAMS), dtype=jnp.float64)
    state = ts.prepare_cpi(moving_world(ts), TParameters(**PARAMS), device=DEVICE, **KNOBS)
    return dict(ref=ref, ref_path=ref_path, f64=j_trace_cpi(b64, bat64, cfg64, spec64), state=state,
                port=trace_cpi(*state))


def test_moving_slice_matches_rts_tpu(runs):
    base, batch, cfg, spec = runs["state"]
    assert base.tri_verts.shape[0] == 4 * 320 + 768  # padded to whole 1024-triangle clusters
    ref, got = runs["ref"], runs["port"]
    outs, paths = _t_trace(base, batch, cfg, spec)
    assert all(torch.equal(o.received, got.received[p]) for p, o in enumerate(outs))
    rec = np.asarray(ref.received)
    f = rec >= 0
    assert f.sum(axis=1).min() >= 8  # every sphere returns in every pulse
    np.testing.assert_array_equal(got.received.numpy(), rec)
    np.testing.assert_array_equal(paths.numpy(), np.asarray(runs["ref_path"]))
    for name in ("emit", "npath", "path_match"):
        np.testing.assert_array_equal(getattr(got.agg, name).numpy(), np.asarray(getattr(ref.agg, name)),
                                      err_msg=name)
    np.testing.assert_allclose(got.delay.numpy()[f], np.asarray(ref.delay)[f], rtol=1e-5)
    np.testing.assert_allclose(got.power.numpy()[f], np.asarray(ref.power)[f], rtol=5e-5)
    np.testing.assert_allclose(got.doppler.numpy()[f], np.asarray(ref.doppler)[f], rtol=1e-5, atol=1e-3)
    # the precision contract, against the f64 engine
    f64 = runs["f64"]
    np.testing.assert_array_equal(np.asarray(f64.received), rec)
    ph = got.agg.phase.double().numpy() + got.agg.phase_lo.double().numpy()
    d = np.abs(ph[f] - np.asarray(f64.agg.phase, np.float64)[f])
    assert np.minimum(d, 2 * np.pi - d).max() < 1e-6
    for a, b in ((f64.power, got.power), (f64.agg.power, got.agg.power)):
        assert np.abs(b.double().numpy()[f] / np.asarray(a, np.float64)[f] - 1.0).max() < 1e-6


@pytest.mark.parametrize("switch", ["shade_emit", "mt_prune"])
def test_moving_cpi_exact_switches(runs, switch):
    """shade_emit=True (kernel-emitted shade rows) and mt_prune=False give
    the production CPI bit for bit (the counterpart of
    tests/test_shade_emit.py::test_emit_shade_cpi_bit_identical)."""
    base, batch, cfg, spec = runs["state"]
    flipped = dataclasses.replace(cfg, **{switch: not getattr(cfg, switch)})
    other = trace_cpi(base, batch, flipped, spec)
    got = runs["port"]
    assert int((got.received >= 0).sum()) > 0
    for name, a, b in zip(got._fields, got, other):
        for x, y in (zip(a, b) if isinstance(a, tuple) else [(a, b)]):
            assert torch.equal(x, y), name
