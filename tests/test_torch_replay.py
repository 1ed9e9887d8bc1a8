"""The port's float64 precision replay (refine=True) against rts_tpu.

The contract is the JAX package's (tests/test_replay.py:assert_north_star,
BASELINE.json): per-ray power, aggregated power and phase within 1e-6 of
rts_tpu's float64 dense engine, with every decision identical.  The port
replays in native float64 on the device; rts_tpu replays in double-single
arithmetic.  Against rts_tpu's ds replay (Pallas traversal in interpret
mode, state carried over through ``convert``) the discrete outputs must be
identical and the continuous ones agree to what the two precisions allow:
the phase to 5e-7 rad (measured 1.46e-7 on this scene, the ds replay's
own distance from the f64 engine being 1.43e-7), power, delay and Doppler
to the f32 rounding of their outputs.
"""

import dataclasses
import math
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rts_tpu.sim as js
from rts_tpu import Parameters as JParameters
from rts_tpu.engine.cpi import make_pulse_fn as j_make_pulse_fn
from rts_tpu.engine.cpi import trace_cpi as j_trace_cpi

import rts_tpu_torch.sim as ts
from rts_tpu_torch import Parameters as TParameters
from rts_tpu_torch import convert
from rts_tpu_torch.engine.cpi import make_pulse_fn, pulse_args, trace_cpi
from rts_tpu_torch.sim import check_replay_overflow

torch.set_num_threads(1)

TWO_PI = 2.0 * math.pi
PARAMS = dict(num_rays=5, max_refl_depth=2)
CLUSTER = dict(accel="cluster", cluster_size=128, ray_tile=128)
DEVICE = "cpu"  # the port's entry points default to the card


def world(S):
    """A moving, yawing plate (flat shading) and a moving sphere (smooth
    shading) seen by a monostatic and a bistatic receiver."""
    w = S.World()
    w.add(S.Transmitter(path=S.Path.fixed(0, 0, 0), wave=S.RadarSignal(carrier=10e9),
                        pulse_count=2, prf=1000.0, tx_span=(0.1, 0.1, 0.0)))
    w.add(S.Receiver(path=S.Path.fixed(0, 0, 0), sphere=(5.0, 1.0, 1.0)))
    w.add(S.Receiver(path=S.Path.fixed(50, -50, 0), sphere=(15.0, 1.4, 1.4)))
    w.add(S.Target(path=S.Path.linear([(0.0, (1000.0, 0.0, 0.0)), (1.0, (1050.0, 0.0, 0.0))]),
                   attitude=S.AttitudePath(yaw_rate=0.1), shape="rect", rect=(2.0, 200.0, 200.0),
                   refl_coeff=0.9))
    w.add(S.Target(path=S.Path.linear([(0.0, (800.0, 100.0, 0.0)), (1.0, (790.0, 104.0, 2.0))]),
                   shape="sphere", sphere_params=(2, 30.0), refl_coeff=0.8))
    return w


def phase_err(a, b):
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return np.minimum(d, TWO_PI - d)


def full_phase(agg):
    return np.asarray(agg.phase, np.float64) + np.asarray(agg.phase_lo, np.float64)


@pytest.fixture(scope="module")
def runs():
    """rts_tpu's f64 dense engine and its ds-refined clustered CPI, and the
    port's refined CPI from its own front end and from rts_tpu's state."""
    b64, bat64, cfg64, spec64 = js.prepare_cpi(world(js), JParameters(**PARAMS), dtype=jnp.float64)
    f64 = j_trace_cpi(b64, bat64, cfg64, spec64)
    jstate = js.prepare_cpi(world(js), JParameters(**PARAMS), dtype=jnp.float32, refine=True,
                            interpret=True, **CLUSTER)
    ds = j_trace_cpi(*jstate)
    tstate = ts.prepare_cpi(world(ts), TParameters(**PARAMS), refine=True, device=DEVICE, **CLUSTER)
    jb, jbat, jcfg, jspec = jstate
    carried = (convert.scene_base(jb, device=DEVICE), convert.pulse_batch(jbat, device=DEVICE),
               convert.trace_config(jcfg),
               convert.cpi_spec(jspec))
    return dict(f64=f64, ds=ds, state=tstate, port=trace_cpi(*tstate), carried=trace_cpi(*carried))


@pytest.mark.parametrize("which", ["port", "carried"])
def test_refined_cpi_meets_the_contract(runs, which):
    """Power, aggregated power and phase within 1e-6 of the f64 engine,
    received lanes identical (assert_north_star)."""
    ref, fine = runs["f64"], runs[which]
    got = np.asarray(ref.received) >= 0
    assert got.sum() >= 5
    np.testing.assert_array_equal(fine.received.numpy(), np.asarray(ref.received))
    assert phase_err(np.asarray(ref.agg.phase)[got], full_phase(fine.agg)[got]).max() < 1e-6
    for a, b in ((ref.power, fine.power), (ref.agg.power, fine.agg.power)):
        rel = np.abs(b.double().numpy()[got] / np.asarray(a, np.float64)[got] - 1.0)
        assert rel.max() < 1e-6


def test_refined_cpi_matches_rts_tpu(runs):
    """Against rts_tpu's ds-refined CPI: decisions identical, continuous
    outputs to the tolerances of the module docstring."""
    ds, got = runs["ds"], runs["port"]
    f = np.asarray(ds.received) >= 0
    np.testing.assert_array_equal(got.received.numpy(), np.asarray(ds.received))
    for name in ("emit", "npath", "path_match"):
        np.testing.assert_array_equal(getattr(got.agg, name).numpy(), np.asarray(getattr(ds.agg, name)),
                                      err_msg=name)
    e = np.asarray(ds.agg.emit)
    assert phase_err(full_phase(got.agg)[e], full_phase(ds.agg)[e]).max() < 5e-7
    np.testing.assert_allclose(got.power.numpy()[f], np.asarray(ds.power)[f], rtol=2e-7)
    np.testing.assert_allclose(got.delay.numpy()[f], np.asarray(ds.delay)[f], rtol=2e-7)
    np.testing.assert_allclose(got.doppler.numpy()[f], np.asarray(ds.doppler)[f], rtol=2e-7, atol=1e-3)
    for name in ("power", "delay", "doppler"):
        np.testing.assert_allclose(getattr(got.agg, name).numpy()[e], np.asarray(getattr(ds.agg, name))[e],
                                   rtol=2e-7, atol=1e-3, err_msg=name)


def test_plain_f32_fails_the_bar(runs):
    """The contract has teeth: without the replay the port's f32 phase is
    orders of magnitude off, and its power misses 1e-6 too."""
    base, batch, cfg, spec = runs["state"]
    plain = trace_cpi(base, batch, dataclasses.replace(cfg, refine=False), spec)
    ref = runs["f64"]
    got = np.asarray(ref.received) >= 0
    np.testing.assert_array_equal(plain.received.numpy(), np.asarray(ref.received))
    assert phase_err(np.asarray(ref.agg.phase)[got], full_phase(plain.agg)[got]).max() > 1e-4
    assert (plain.agg.phase_lo == 0).all()
    rel = np.abs(plain.power.double().numpy()[got] / np.asarray(ref.power, np.float64)[got] - 1.0)
    assert rel.max() > 1e-6


def test_ray_length_matches_f64_engine(runs):
    """ray_length + ray_length_lo of one pulse equals the f64 engine's
    ray length to 1e-7 m over ~2 km paths (f32 alone is ~1e-4 m off)."""
    b64, bat64, cfg64, spec64 = js.prepare_cpi(world(js), JParameters(**PARAMS), dtype=jnp.float64)
    one, _ = j_make_pulse_fn(b64, cfg64, **spec64.kwargs())
    args = jax.tree.map(lambda a: a[0], (bat64.rot, bat64.pos, bat64.vel, bat64.rx_geom, bat64.rx_pos,
                                         bat64.tx_origin, bat64.tx_dir, bat64.times))
    r64 = one(*args)[0]
    base, batch, cfg, spec = runs["state"]
    res = make_pulse_fn(base, cfg, spec)[0](*pulse_args(batch, 0))[0]
    got = np.asarray(r64.received) >= 0
    assert got.sum() > 0
    rl = res.ray_length.double().numpy() + res.ray_length_lo.double().numpy()
    assert np.abs(rl[got] - np.asarray(r64.ray_length)[got]).max() < 1e-7
    assert (res.ray_length_lo.numpy()[~got] == 0).all()


@pytest.mark.parametrize("cap", ["count", 4, 1])
def test_replay_cap_compaction_identical(runs, cap):
    """A replay_cap block replays exactly what the full-lane replay does:
    one as large as the received count, and one below it, which grows to
    hold the lanes past the cap (the JAX package leaves them float32)."""
    base, batch, cfg, spec = runs["state"]
    counts = (runs["port"].received >= 0).sum(1)
    if cap == "count":
        cap = int(counts.max())
    else:
        assert int(counts.min()) > 2 * cap  # the block grows to more than twice the cap
    full = trace_cpi(base, batch, dataclasses.replace(cfg, replay_cap=0), spec)
    capped = trace_cpi(base, batch, dataclasses.replace(cfg, replay_cap=cap), spec)
    for name in ("power", "doppler", "delay", "received"):
        assert torch.equal(getattr(full, name), getattr(capped, name)), name
    for name in ("phase", "phase_lo", "power"):
        assert torch.equal(getattr(full.agg, name), getattr(capped.agg, name)), name


def test_replay_cap_overflow_warns(runs):
    """A cap below the received count (a replay block grown past it) is
    surfaced loudly; a big enough cap, or 0 (replay every lane), stays
    silent."""
    base, batch, cfg, spec = runs["state"]
    small = dataclasses.replace(cfg, replay_cap=4)
    out = trace_cpi(base, batch, small, spec)
    counts = check_replay_overflow(out, cfg, warn=False)
    assert counts.max() > 4
    with pytest.warns(UserWarning, match="replay cap overflow"):
        check_replay_overflow(out, small)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        check_replay_overflow(out, dataclasses.replace(cfg, replay_cap=0))
        check_replay_overflow(out, dataclasses.replace(cfg, replay_cap=int(counts.max())))


def test_refine_without_f64_state_raises(runs):
    """A refine=True config over a batch prepared without the replay's
    float64 state fails with a message, not deep inside the replay."""
    base, batch, cfg, spec = runs["state"]
    with pytest.raises(ValueError, match="float64 replay state"):
        trace_cpi(base, batch._replace(refine=None), cfg, spec)
