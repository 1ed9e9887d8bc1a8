"""The port's range-Doppler rendering (rts_tpu_torch.sim.render) against
rts_tpu's, on the same inputs, on a converted trace, and for the slice as
a whole (a terrain_imaging scene traced and rendered in each package).

Maps are held within 1e-5 of the map's peak with the same argmax (the
port sums only the valid lanes of a pulse, rts_tpu every lane with the
masked ones adding zero: the order of the sums differs, and the two
libraries' complex exp differ in the last ulp).  Measured on the CPU
(``pytest -s`` prints every error):
at most 3.0e-7 of the peak on the synthetic lanes, 1.4e-8 on a converted
trace, 2.5e-10 from the driver's responses.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rts_tpu.sim as js
import rts_tpu.sim.render as jr
from rts_tpu import Parameters as JParameters

import rts_tpu_torch.sim as ts
import rts_tpu_torch.sim.render as tr
from rts_tpu_torch import Parameters as TParameters
from rts_tpu_torch import convert

from test_torch_driver import plate_world

torch.set_num_threads(1)

DEVICE = "cpu"
C = 299792458.0
FS = 50e6
PL = 4e-6
CHIRP = 5e12
GRID = dict(sample_rate=FS, num_samples=1024, window_start=2 * (4000 - 450) / C)
MAP_TOL = 1e-5


def lfm_samples():
    t = np.arange(int(round(PL * FS))) / FS
    return np.exp(1j * np.pi * CHIRP * t * t)


def waves(name):
    """(rts_tpu wave or None, port wave or None, chirp_rate) for a waveform."""
    if name == "stored":
        return (js.RadarSignal.from_samples(lfm_samples(), FS), ts.RadarSignal.from_samples(lfm_samples(), FS),
                0.0)
    return None, None, CHIRP if name == "lfm" else 0.0


def lanes(p=16, k=64, seed=0):
    """Seeded f32 lanes as a traced CPI holds them: powers, delays inside
    the receive window, phases, Dopplers, and a validity mask."""
    rng = np.random.default_rng(seed)
    start = GRID["window_start"]
    return (rng.uniform(0.1, 1.0, (p, k)).astype(np.float32),
            (start + rng.uniform(0.0, 15e-6, (p, k))).astype(np.float32),
            rng.uniform(-np.pi, np.pi, (p, k)).astype(np.float32),
            rng.uniform(-1000.0, 1000.0, (p, k)).astype(np.float32),
            rng.random((p, k)) < 0.5)


def held_map(got, ref, what):
    """A port map (tensor) within MAP_TOL of the rts_tpu map's peak, with
    the same argmax; returns the error relative to the peak."""
    got, ref = got.cpu().numpy(), np.asarray(ref)
    assert got.shape == ref.shape, what
    peak = np.abs(ref).max()
    err = np.abs(got - ref).max() / peak
    assert err <= MAP_TOL, f"{what}: {err:.3e} of the peak"
    assert np.argmax(got) == np.argmax(ref), what
    print(f"{what}: {err:.3e} of the peak")  # shown under pytest -s
    return err


@pytest.mark.parametrize("range_window", [None, "taylor", "hamming"])
@pytest.mark.parametrize("wave", ["cw", "lfm", "stored"])
def test_render_functions_match_rts_tpu(wave, range_window):
    jw, tw, chirp = waves(wave)
    grid_j, grid_t = jr.RenderGrid(**GRID), tr.RenderGrid(**GRID)
    arrs = lanes()
    kw = dict(pulse_length=PL, chirp_rate=chirp, tx_power=2.0)
    ref = jr.synthesize_cpi(*(jnp.asarray(a) for a in arrs), grid_j, wave=jw, **kw)
    got = tr.synthesize_cpi(*(torch.as_tensor(a) for a in arrs), grid_t, wave=tw, **kw)
    assert got.dtype == torch.complex64 and got.shape == (16, GRID["num_samples"])
    held_map(got.abs(), np.abs(ref), "samples")
    one = tr.synthesize_pulse(*(torch.as_tensor(a[3]) for a in arrs), grid_t, wave=tw, **kw)
    held_map(one.abs(), np.abs(np.asarray(ref)[3]), "synthesize_pulse")
    rep_j = jr.waveform_replica(grid_j, pulse_length=PL, chirp_rate=chirp, wave=jw)
    rep_t = tr.waveform_replica(grid_t, pulse_length=PL, chirp_rate=chirp, wave=tw, device=DEVICE)
    np.testing.assert_allclose(rep_t.numpy(), np.asarray(rep_j), rtol=0, atol=1e-6)
    comp_j = jr.pulse_compress(ref, rep_j, window=range_window)
    comp_t = tr.pulse_compress(got, rep_t, window=range_window)
    held_map(comp_t.abs(), np.abs(comp_j), "pulse_compress")
    for slow in ("hann", "rect"):
        held_map(tr.range_doppler_map(comp_t, window=slow), jr.range_doppler_map(comp_j, window=slow),
                 f"range_doppler_map {slow}")


def test_windows_match_rts_tpu():
    for n in (16, 1024):
        np.testing.assert_array_equal(tr.taylor_window(n), jr.taylor_window(n))
        np.testing.assert_array_equal(tr.hamming_window(n), jr.hamming_window(n))
    assert torch.equal(tr.taylor_window(8, xp=torch), torch.as_tensor(jr.taylor_window(8)))
    rep = np.asarray(jr.waveform_replica(jr.RenderGrid(**GRID), pulse_length=PL, chirp_rate=CHIRP))
    for window in ("taylor", "hamming"):
        np.testing.assert_array_equal(tr._band_weighting(rep, window), np.asarray(jr._band_weighting(rep, window, np)))
    with pytest.raises(ValueError, match="range window"):
        tr._band_weighting(rep, "kaiser")
    with pytest.raises(ValueError, match="window"):
        tr.range_doppler_map(torch.zeros((4, 8), dtype=torch.complex128), window="kaiser")


def test_empty_pulses_render_zero():
    power, delay, phase, doppler, _ = lanes(p=4, k=8)
    none = np.zeros((4, 8), bool)
    got = tr.synthesize_cpi(*(torch.as_tensor(a) for a in (power, delay, phase, doppler, none)),
                            tr.RenderGrid(**GRID))
    assert got.dtype == torch.complex64 and float(got.abs().max()) == 0.0


def test_render_cpi_result_on_a_converted_trace():
    """One rts_tpu trace, carried over by convert.cpi_result, rendered by
    both packages: the moving plate of tests/test_render.py, 32 pulses."""
    num_pulses, speed = 32, 5.0
    jout = js.run_cpi(plate_world(js, num_pulses=num_pulses, target_speed=speed),
                      JParameters(num_rays=3, max_refl_depth=2), dtype=jnp.float64, attach_responses=False)
    out = convert.cpi_result(jout, device=DEVICE)
    assert torch.equal(out.agg.emit, torch.as_tensor(np.array(jout.agg.emit)))
    grid = dict(sample_rate=FS, num_samples=512, window_start=6.0e-6)
    for kw in (dict(pulse_length=1.0 / FS), dict(pulse_length=PL, chirp_rate=CHIRP, compress=True,
                                                  range_window="taylor")):
        rd_j, s_j = jr.render_cpi_result(jout, 0, jr.RenderGrid(**grid), **kw)
        rd_t, s_t = tr.render_cpi_result(out, 0, tr.RenderGrid(**grid), **kw)
        held_map(rd_t, rd_j, f"render_cpi_result {kw}")
        held_map(s_t.abs(), np.abs(s_j), "its samples")
    # the target's Doppler row, as tests/test_render.py predicts it
    rd = tr.render_cpi_result(out, 0, tr.RenderGrid(**grid), pulse_length=1.0 / FS)[0].numpy()
    fd = 10e9 * ((1 - speed / C) / (1 + speed / C) - 1)
    row = np.unravel_index(np.argmax(rd), rd.shape)[0]
    assert abs(row - (num_pulses // 2 + round(fd / (1000.0 / num_pulses)))) <= 1


def imaging_world(S, tris=2000, pulses=8):
    """examples/terrain_imaging.py's scene (BASELINE configs 4+5): a fractal
    terrain of ~``tris`` triangles and a moving 30 m plate under a
    chirped radar 4 km up."""
    n = max(2, round(math.sqrt(tris / 2)) + 1)
    alt = 4000.0
    w = S.World()
    w.add(S.Transmitter(path=S.Path.fixed(0, 0, alt), rotation=S.RotationPath(elevation=-math.pi / 2),
                        wave=S.RadarSignal(carrier=10e9, chirp_rate=CHIRP, length=PL), pulse_count=pulses,
                        prf=2000.0, tx_span=(0.15, 0.15, 0.0)))
    w.add(S.Receiver(path=S.Path.fixed(0, 0, alt), rotation=S.RotationPath(elevation=-math.pi / 2),
                     sphere=(30.0, 1.2, 1.2)))
    w.add(S.Target(shape="terrain", terrain=(n, 12000.0, 300.0, 3), refl_coeff=0.9))
    w.add(S.Target(shape="rect", rect=(2.0, 30.0, 30.0), attitude=S.AttitudePath(pitch=math.pi / 2),
                   path=S.Path.linear([(0.0, (0.0, 0.0, 400.0)), (1.0, (12.0, 0.0, 400.0))]), refl_coeff=0.9))
    return w


def test_slice_terrain_imaging_matches_rts_tpu():
    """The slice as a whole: a ~2k-triangle terrain_imaging scene, 8 pulses
    at 5^3 rays through the clustered engine with the replay, rendered to
    a compressed range-Doppler map in each package.  Measured on the CPU:
    decisions identical, the maps 3.6e-8 of the peak apart."""
    params = dict(num_rays=5, max_refl_depth=2)
    kw = dict(accel="cluster", cluster_size=128, refine=True, attach_responses=False)
    jout = js.run_cpi(imaging_world(js), JParameters(**params), interpret=True, **kw)
    out = ts.run_cpi(imaging_world(ts), TParameters(**params), device=DEVICE, **kw)
    assert int((out.received >= 0).sum()) > 0
    np.testing.assert_array_equal(out.received.numpy(), np.asarray(jout.received))
    np.testing.assert_array_equal(out.agg.emit.numpy(), np.asarray(jout.agg.emit))
    render = dict(pulse_length=PL, chirp_rate=CHIRP, compress=True, range_window="taylor")
    rd_j = jr.render_cpi_result(jout, 0, jr.RenderGrid(**GRID), **render)[0]
    rd_t = tr.render_cpi_result(out, 0, tr.RenderGrid(**GRID), **render)[0]
    held_map(rd_t, rd_j, "terrain_imaging map")
    # the strongest return: the plate 400 m up, 3.6 km down, at ~0 Doppler
    row, col = np.unravel_index(int(rd_t.argmax()), rd_t.shape)
    assert abs((GRID["window_start"] + col / FS) * C / 2 - 3600.0) < 10.0
    assert row == 8 // 2


def test_responses_to_map_matches_rts_tpu():
    """The driver's Response objects rendered by each package."""
    num_pulses = 8
    worlds = [plate_world(S, num_pulses=num_pulses, target_speed=20.0) for S in (js, ts)]
    js.run(worlds[0], JParameters(num_rays=3, max_refl_depth=2))
    ts.run(worlds[1], TParameters(num_rays=3, max_refl_depth=2), device=DEVICE)
    times = [k / 1000.0 for k in range(num_pulses)]
    grid = dict(sample_rate=FS, num_samples=512, window_start=6.0e-6)
    rd_j, _ = jr.responses_to_map(worlds[0].receivers[0].responses, times, jr.RenderGrid(**grid),
                                  pulse_length=2e-7)
    rd_t, s_t = tr.responses_to_map(worlds[1].receivers[0].responses, times, tr.RenderGrid(**grid),
                                    pulse_length=2e-7, device=DEVICE)
    assert s_t.device.type == DEVICE and float(s_t.abs().max()) > 0
    held_map(rd_t, rd_j, "responses_to_map")


def test_thermal_noise_power_and_reproducibility():
    t, b = 290.0, 50e6
    samples = torch.zeros((64, 4096), dtype=torch.complex64)
    draw = lambda seed: tr.add_thermal_noise(samples, t, b, torch.Generator().manual_seed(seed))
    noisy = draw(0)
    assert noisy.dtype == torch.complex64
    measured = float((noisy.abs() ** 2).double().mean())
    np.testing.assert_allclose(measured, tr.BOLTZMANN * t * b, rtol=0.02)
    assert tr.BOLTZMANN == jr.BOLTZMANN
    assert torch.equal(draw(0), noisy)
    assert not torch.equal(draw(1), noisy)
