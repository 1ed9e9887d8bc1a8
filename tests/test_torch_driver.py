"""The port's sequential driver ``rts_tpu_torch.sim.run`` against
``rts_tpu.sim.run``.

The worlds are those of tests/test_driver.py (a monostatic plate: fixed,
receding, yawing over four pulses) and the README's quick start (a moving
icosphere).  Both drivers run float64 brute force, their default, on the
CPU.  The responses each receiver collects must agree one to one: the
same count in the same order; power, delay and time to rtol 1e-9, Doppler
to rtol 1e-9 (atol 1e-6 Hz), phase to 1e-7 rad (the engines' ray lengths
differ by FMA rounding, ~1e-14 relative) and the noise temperature
exactly.  ``accel="cluster"`` in float32 is held to float32 brute force
as tests/test_driver.py:132 holds rts_tpu's, and ``run_all_cpi`` to one
``run_cpi`` per transmitter.
"""

import copy

import numpy as np
import pytest
import torch

import rts_tpu.sim as js
from rts_tpu import Parameters as JParameters

import rts_tpu_torch.sim as ts
from rts_tpu_torch import Parameters as TParameters

torch.set_num_threads(1)

DEVICE = "cpu"  # the port's entry points default to the card
C = 299792458.0
CARRIER = 10e9


def plate_world(S, num_pulses=1, target_speed=None, rotating=False):
    w = S.World()
    w.add(S.Transmitter(name="tx0", path=S.Path.fixed(0, 0, 0),
                        wave=S.RadarSignal(carrier=CARRIER, temperature=30.0), pulse_count=num_pulses,
                        prf=1000.0, tx_span=(0.1, 0.1, 0.0)))
    w.add(S.Receiver(name="rx0", path=S.Path.fixed(0, 0, 0), sphere=(5.0, 1.0, 1.0), noise_temperature=70.0))
    if target_speed is not None:
        tpath = S.Path.linear([(0.0, (1000.0, 0.0, 0.0)), (1.0, (1000.0 + target_speed, 0.0, 0.0))])
    else:
        tpath = S.Path.fixed(1000, 0, 0)
    att = S.AttitudePath(yaw_rate=0.1) if rotating else S.AttitudePath()
    w.add(S.Target(name="plate", path=tpath, attitude=att, shape="rect", rect=(2.0, 200.0, 200.0),
                   refl_coeff=0.9))
    return w


def readme_world(S, pulses):
    """README.md's quick-start world (its 64 pulses cut to ``pulses``)."""
    w = S.World()
    w.add(S.Transmitter(path=S.Path.fixed(0, 0, 0), wave=S.RadarSignal(carrier=10e9), pulse_count=pulses,
                        prf=1000.0, tx_span=(0.1, 0.1, 0.0)))
    w.add(S.Receiver(path=S.Path.fixed(0, 0, 0), sphere=(5.0, 1.0, 1.0)))
    w.add(S.Target(shape="sphere", sphere_params=(4, 10.0),
                   path=S.Path.linear([(0.0, (900, 0, 0)), (1.0, (950, 0, 0))]), refl_coeff=0.9))
    return w


def points(world):
    return [[r.points[0] for r in rx.responses] for rx in world.receivers]


def assert_same_responses(got, ref):
    for g_rx, r_rx in zip(points(got), points(ref), strict=True):
        assert len(g_rx) == len(r_rx)
        for g, r in zip(g_rx, r_rx):
            for f in ("power", "delay", "time"):
                np.testing.assert_allclose(getattr(g, f), getattr(r, f), rtol=1e-9, atol=0, err_msg=f)
            np.testing.assert_allclose(g.doppler, r.doppler, rtol=1e-9, atol=1e-6)
            d = abs(g.phase - r.phase)
            assert min(d, 2 * np.pi - d) < 1e-7
            assert g.noise_temperature == r.noise_temperature


CASES = {
    "fixed_plate": (lambda S: plate_world(S), dict(num_rays=3, max_refl_depth=2)),
    "moving_plate": (lambda S: plate_world(S, target_speed=100.0), dict(num_rays=3, max_refl_depth=2)),
    "rotating_plate": (lambda S: plate_world(S, num_pulses=4, rotating=True), dict(num_rays=3, max_refl_depth=2)),
    "readme_sphere": (lambda S: readme_world(S, pulses=4), dict(num_rays=9, max_refl_depth=2)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_run_matches_rts_tpu(case):
    make, params = CASES[case]
    jw, tw = make(js), make(ts)
    js_sum = js.run(jw, JParameters(**params))
    ts_sum = ts.run(tw, TParameters(**params), device=DEVICE)
    assert ts_sum.total_received == js_sum.total_received > 0
    assert [(p.pulse, p.received_rays, p.responses) for p in ts_sum.pulses] == [
        (p.pulse, p.received_rays, p.responses) for p in js_sum.pulses]
    assert_same_responses(tw, jw)


def test_run_boresight_analytic():
    """tests/test_driver.py's analytic single-ray plate, on the port."""
    w = plate_world(ts)
    s = ts.run(w, TParameters(num_rays=1, max_refl_depth=2), device=DEVICE)
    assert s.total_received == 1 and len(w.receivers[0].responses) == 1
    p = w.receivers[0].responses[0].points[0]
    assert abs(p.delay - 2 * 999.0 / C) < 1e-15
    wl = C / CARRIER
    exp = (1 / (4 * np.pi * 999.0**2)) * 0.9 * (1 / ((4 * np.pi) ** 2 * 999.0**2)) * wl**2
    np.testing.assert_allclose(p.power, exp, rtol=1e-12)
    assert abs(p.phase + np.mod(p.delay * 2 * np.pi * CARRIER, 2 * np.pi)) < 1e-9
    assert p.doppler == 0.0 and p.noise_temperature == 100.0


def test_run_clustered_matches_brute():
    """accel='cluster' (the plain traversal on the CPU) == brute, float32."""
    w1 = plate_world(ts, num_pulses=2)
    w2 = copy.deepcopy(w1)
    params = TParameters(num_rays=3, max_refl_depth=2)
    ts.run(w1, params, dtype=torch.float32, device=DEVICE)
    ts.run(w2, params, dtype=torch.float32, device=DEVICE, accel="cluster", cluster_size=128)
    p1 = [p for rx in points(w1) for p in rx]
    p2 = [p for rx in points(w2) for p in rx]
    assert len(p1) == len(p2) > 0
    for a, b in zip(sorted(p1, key=lambda p: p.delay), sorted(p2, key=lambda p: p.delay)):
        np.testing.assert_allclose(a.power, b.power, rtol=5e-5)
        np.testing.assert_allclose(a.delay, b.delay, rtol=1e-6)


def test_run_all_cpi_is_run_cpi_per_transmitter():
    w = plate_world(ts, num_pulses=2, target_speed=50.0)
    w.add(ts.Transmitter(name="tx1", path=ts.Path.fixed(0, 10, 0), wave=ts.RadarSignal(carrier=9e9),
                         pulse_count=2, prf=1000.0, tx_span=(0.1, 0.1, 0.0)))
    params = TParameters(num_rays=3, max_refl_depth=2)
    outs = ts.run_all_cpi(w, params, dtype=torch.float64, device=DEVICE, attach_responses=False)
    assert len(outs) == 2
    for i, out in enumerate(outs):
        one = ts.run_cpi(w, params, tx_index=i, dtype=torch.float64, device=DEVICE, attach_responses=False)
        for a, b in zip(out, one):
            if isinstance(a, tuple):
                assert all(torch.equal(x, y) for x, y in zip(a, b))
            else:
                assert torch.equal(a, b)
    assert (outs[0].received >= 0).any()
