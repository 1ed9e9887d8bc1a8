"""The slice end to end: prepare_cpi(preset="production", refine=False) and
trace_cpi in the port against rts_tpu (Pallas traversal in interpret
mode), with rts_tpu's state carried over through ``convert``.

Discrete outputs — received, agg.emit, agg.npath, agg.path_match and the
path rows — must be identical.  Continuous outputs differ by rounding:
rts_tpu's trace runs under jit, where XLA contracts a*b + c into fused
multiply-adds (the port rounds every product), and cancellation in the
triangle cross products and the MT numerators amplifies that to ~1e-6 of
a ray length.  So delay is held to rtol 1e-5, power to rtol 5e-5 (power
goes as 1/r^4) and Doppler to rtol 1e-5.  Phase is range-limited in f32
without the replay (one ulp of an 8 km path is ~0.1 rad at 10 GHz), so it
is compared only on lanes whose delay agrees bit for bit, to 1e-5 rad
(rts_tpu reduces it in double-single arithmetic, the port in float64).
"""

import dataclasses
import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rts_tpu.sim as js
from rts_tpu import Parameters as JParameters
from rts_tpu.engine.cpi import make_pulse_fn as j_make_pulse_fn
from rts_tpu.engine.cpi import map_pulses

import rts_tpu_torch.sim as ts
from rts_tpu_torch import Parameters as TParameters
from rts_tpu_torch import convert
from rts_tpu_torch.engine.cpi import make_pulse_fn, pulse_args, trace_cpi
from rts_tpu_torch.sim import check_replay_overflow

torch.set_num_threads(1)

DEVICE = "cpu"  # the port's entry points default to the card


def terrain_world(S):
    """bench.py's terrain scene (BASELINE config 4) cut to ~1.7k triangles."""
    w = S.World()
    down = S.RotationPath(elevation=-math.pi / 2)
    w.add(S.Transmitter(path=S.Path.fixed(0.0, 0.0, 4000.0), wave=S.RadarSignal(carrier=10e9),
                        pulse_count=2, prf=1000.0, tx_span=(0.15, 0.15, 0.0), rotation=down))
    w.add(S.Receiver(path=S.Path.fixed(0.0, 0.0, 4000.0), sphere=(25.0, 1.2, 1.2), rotation=down))
    w.add(S.Target(shape="terrain", terrain=(30, 1500.0, 300.0, 3), path=S.Path.fixed(0.0, 0.0, 0.0),
                   refl_coeff=0.9))
    w.add(S.Target(shape="rect", rect=(2.0, 60.0, 60.0), attitude=S.AttitudePath(pitch=math.pi / 2),
                   path=S.Path.linear([(0.0, (0.0, 0.0, 400.0)), (1.0, (3.0, 0.0, 440.0))]),
                   refl_coeff=0.9))
    return w


def plate_world(S):
    """A moving, yawing plate and a sphere in front of a monostatic radar."""
    w = S.World()
    w.add(S.Transmitter(path=S.Path.fixed(0, 0, 0), wave=S.RadarSignal(carrier=10e9),
                        pulse_count=2, prf=1000.0, tx_span=(0.1, 0.1, 0.0)))
    w.add(S.Receiver(path=S.Path.fixed(0, 0, 0), sphere=(5.0, 1.0, 1.0)))
    w.add(S.Target(path=S.Path.linear([(0.0, (1000.0, 0.0, 0.0)), (1.0, (1060.0, 0.0, 0.0))]),
                   attitude=S.AttitudePath(yaw_rate=0.1), shape="rect", rect=(2.0, 200.0, 200.0),
                   refl_coeff=0.9))
    w.add(S.Target(path=S.Path.fixed(700, 40, 0), shape="sphere", sphere_params=(2, 20.0),
                   refl_coeff=0.8))
    return w


@partial(jax.jit, static_argnames=("cfg", "spec"))
def _j_trace(base, batch, cfg, spec):
    """rts_tpu's trace_cpi, returning each pulse's path rows as well."""
    one_pulse, aggregate = j_make_pulse_fn(base, cfg, **spec.kwargs())

    def full(rot, pos, vel, rxg, rxp, txo, txd, t, refine=None):
        res, power, doppler, delay = one_pulse(rot, pos, vel, rxg, rxp, txo, txd, t, refine)
        return aggregate(res, power, doppler, delay), res.path

    return map_pulses(full, batch, cfg)


def _t_trace(base, batch, cfg, spec):
    """The port's pulse loop, returning each pulse's path rows as well."""
    one_pulse, aggregate = make_pulse_fn(base, cfg, spec)
    outs, paths = [], []
    for p in range(batch.times.shape[0]):
        res, power, doppler, delay = one_pulse(*pulse_args(batch, p))
        outs.append(aggregate(res, power, doppler, delay))
        paths.append(res.path)
    return outs, torch.stack(paths)


@pytest.mark.parametrize("world, num_rays", [(terrain_world, 9), (plate_world, 5)],
                         ids=["terrain_plate", "moving_plate"])
def test_slice_matches_rts_tpu(world, num_rays):
    kw = dict(preset="production", refine=False, cluster_size=128, ray_tile=128)
    jb, jbat, jcfg, jspec = js.prepare_cpi(world(js), JParameters(num_rays=num_rays, max_refl_depth=2),
                                           dtype=jnp.float32, interpret=True, **kw)
    ref, ref_path = _j_trace(jb, jbat, jcfg, jspec)
    base, batch = convert.scene_base(jb, device=DEVICE), convert.pulse_batch(jbat, device=DEVICE)
    cfg, spec = convert.trace_config(jcfg), convert.cpi_spec(jspec)
    # the port's own front end builds the same state from its own World
    tb, tbat, tcfg, _ = ts.prepare_cpi(world(ts), TParameters(num_rays=num_rays, max_refl_depth=2),
                                       device=DEVICE, **kw)
    assert tcfg == dataclasses.replace(cfg, interpret=False)  # the Pallas interpreter flag
    assert all(torch.equal(a, b) for a, b in zip(tb, base) if a is not None)
    assert tb.tri_verts_f64 is None and base.tri_verts_f64 is None  # refine=False: no f64 state
    assert all(torch.equal(a, b) for a, b in zip(tbat, batch) if torch.is_tensor(a))
    assert all(torch.equal(a, b) for a, b in zip(tbat.rx_geom, batch.rx_geom))

    outs, paths = _t_trace(base, batch, cfg, spec)
    got = trace_cpi(base, batch, cfg, spec)
    for p, o in enumerate(outs):  # trace_cpi is the same pulse loop
        assert torch.equal(o.received, got.received[p]) and torch.equal(o.agg.emit, got.agg.emit[p])

    rec = np.asarray(ref.received)
    f = rec >= 0
    assert f.sum() >= 2
    np.testing.assert_array_equal(got.received.numpy(), rec)
    np.testing.assert_array_equal(paths.numpy(), np.asarray(ref_path))
    for name in ("emit", "npath", "path_match"):
        np.testing.assert_array_equal(getattr(got.agg, name).numpy(), np.asarray(getattr(ref.agg, name)),
                                      err_msg=name)
    np.testing.assert_allclose(got.delay.numpy()[f], np.asarray(ref.delay)[f], rtol=1e-5)
    np.testing.assert_allclose(got.power.numpy()[f], np.asarray(ref.power)[f], rtol=5e-5)
    np.testing.assert_allclose(got.doppler.numpy()[f], np.asarray(ref.doppler)[f], rtol=1e-5, atol=1e-6)
    e = np.asarray(ref.agg.emit)
    for name, rtol in (("delay", 1e-5), ("power", 5e-5), ("doppler", 1e-5)):
        np.testing.assert_allclose(getattr(got.agg, name).numpy()[e], np.asarray(getattr(ref.agg, name))[e],
                                   rtol=rtol, atol=1e-6, err_msg=name)
    same_len = e & (got.agg.delay.numpy() == np.asarray(ref.agg.delay))
    np.testing.assert_allclose(got.agg.phase.numpy()[same_len], np.asarray(ref.agg.phase)[same_len],
                               rtol=0, atol=1e-5)
    assert (check_replay_overflow(got, cfg) == f.sum(axis=1)).all()


def test_run_cpi_attaches_one_response_per_emitted_path():
    world = plate_world(ts)
    out = ts.run_cpi(world, TParameters(num_rays=5, max_refl_depth=2), preset="production",
                     refine=False, cluster_size=128, ray_tile=128, device=DEVICE)
    assert int(out.agg.emit.sum()) > 0
    assert sum(len(rx.responses) for rx in world.receivers) == int(out.agg.emit.sum())
