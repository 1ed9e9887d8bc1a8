"""The port's f64 engine (brute force through the bounce loop) against
rts_tpu's jitted ``trace_pulse`` and the NumPy float64 oracle.

The scenes are those of tests/test_engine_vs_oracle.py that reflect only
(the fuzz scenes run with max_refr_depth=0); its refraction scenes are in
tests/test_torch_refraction.py.
Both engines trace in float64 on the CPU from the same compiled scene and
receiver geometry.  Without strict parity every discrete output (received,
refl/refr depth, path rows) is identical and the continuous ones,
including the per-bounce RCS angle sums ``rcs``, agree to rtol 1e-9 (the
oracle test's ``assert_match``).  Under strict parity (the reference's
float32 narrowing points) the discrete outputs are identical and the
continuous ones agree to 5e-6, the float32 floor that XLA's FMA
contraction sets (tests/test_engine_vs_oracle.py:198-218).

``prepare_cpi`` with its bare defaults (float32 and float64 brute force)
and under ``preset="parity"`` is held to rts_tpu's ``trace_cpi`` on a
moving two-target world.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rts_tpu.sim as js
from rts_tpu.config import Parameters as JParameters
from rts_tpu.engine import RxGeomDevice as JRx
from rts_tpu.engine import TraceConfig as JConfig
from rts_tpu.engine import scene_to_device as j_scene_to_device
from rts_tpu.engine import trace_pulse as j_trace_pulse
from rts_tpu.engine.cpi import trace_cpi as j_trace_cpi
from rts_tpu.geometry import rect_mesh, sphere_mesh
from rts_tpu.geometry.scene import compile_scene
from rts_tpu.oracle import trace_pulse as oracle_trace
from rts_tpu.physics import rx_sphere_geometry

import rts_tpu_torch.sim as ts
from rts_tpu_torch import Parameters as TParameters
from rts_tpu_torch import convert
from rts_tpu_torch.engine.cpi import trace_cpi
from rts_tpu_torch.engine.types import RxGeomDevice, scene_to_device
from rts_tpu_torch.engine.wavefront import trace_pulse

torch.set_num_threads(1)

DEVICE = "cpu"  # the port's entry points default to the card
RTOL = 1e-9
STRICT_TOL = 5e-6
CPI_TOL = {("float64", False): RTOL, ("float64", True): STRICT_TOL}
F32_TOL = {"power": 5e-5, "delay": 1e-5, "doppler": 1e-5}
TWO_PI = 2.0 * np.pi


def _rx(pos, az, el, radius, span=1.0):
    n = len(pos)
    return rx_sphere_geometry(
        rx_pos=np.asarray(pos, np.float64).reshape(n, 3), rx_azimuth=np.asarray(az, np.float64),
        rx_elevation=np.asarray(el, np.float64), sphere_radius=np.asarray(radius, np.float64),
        theta_span=np.full(n, span), phi_span=np.full(n, span),
    )


def _mono(radius=5.0):
    return _rx([[0, 0, 0]], [0.0], [0.0], [radius])


def _pole(el):
    mesh = rect_mesh(2.0, 300.0, 300.0, pitch=np.pi - el).translated(
        [1000.0 * np.cos(el), 0.0, 1000.0 * np.sin(el)])
    rx = _rx([[0, 0, 0]], [0.0], [el], [5.0], span=1.2)
    return compile_scene([mesh], [0.9], [1.0]), (3, 2), [0.0, el], [0.2, 0.2, 0.0], rx


def _fuzz(seed):
    rng = np.random.default_rng(seed)
    meshes, refls, refrs, vels = [], [], [], []
    for _ in range(rng.integers(2, 4)):
        if rng.random() < 0.5:
            m, _ = sphere_mesh(1, rng.uniform(10, 40))
        else:
            m = rect_mesh(rng.uniform(1, 5), rng.uniform(50, 150), rng.uniform(50, 150),
                          yaw=rng.uniform(-0.4, 0.4), pitch=rng.uniform(-0.4, 0.4))
        meshes.append(m.translated([rng.uniform(500, 1500), rng.uniform(-200, 200), rng.uniform(-100, 100)]))
        refls.append(rng.uniform(0.3, 1.0))
        refrs.append(rng.uniform(1.0, 2.0))
        vels.append(rng.uniform(-80, 80, 3))
    scene = compile_scene(meshes, refls, refrs, vels)
    rx = rx_sphere_geometry(
        rx_pos=rng.uniform(-50, 50, (2, 3)), rx_azimuth=rng.uniform(-0.3, 0.3, 2),
        rx_elevation=rng.uniform(-0.3, 0.3, 2), sphere_radius=np.array([20.0, 30.0]),
        theta_span=np.array([1.2, 1.5]), phi_span=np.array([1.2, 1.5]),
    )
    tx = rng.uniform(-10, 10, 3)
    return scene, (3, 2), [rng.uniform(-0.2, 0.2), rng.uniform(-0.2, 0.2)], [0.25, 0.25, 0.0], rx, tx


def _scene(name):
    """(scene, (num_rays, max_refl_depth), tx_dir, tx_span, rx[, tx_origin])."""
    plate = lambda w, h, **kw: rect_mesh(2.0, w, h, **kw)
    ball = sphere_mesh(2, 10.0)[0]
    if name == "plate_single_ray":
        return (compile_scene([plate(200.0, 200.0).translated([1000.0, 0, 0])], [0.9], [1.0],
                              [np.array([50.0, 10.0, 0.0])]), (1, 2), [0.0, 0.0], [0.1, 0.1, 0.0], _mono())
    if name == "plate_fan":
        return (compile_scene([plate(400.0, 400.0).translated([1000.0, 0, 0])], [1.0], [1.0],
                              [np.array([-100.0, 0.0, 0.0])]), (3, 2), [0.0, 0.0], [0.05, 0.05, 0.0],
                _mono(20.0))
    if name == "moving_sphere":
        return (compile_scene([ball.translated([800.0, 0, 0])], [1.0], [1.0], [np.array([-150.0, 30.0, 5.0])]),
                (3, 2), [0.0, 0.0], [0.03, 0.03, 0.0], _mono(15.0))
    if name == "offset_boresight":
        pos = 600.0 * np.array([np.cos(0.5) * np.cos(0.2), np.sin(0.5) * np.cos(0.2), np.sin(0.2)])
        return (compile_scene([ball.translated(pos)], [0.8], [1.0], [np.zeros(3)]), (3, 1), [0.5, 0.2],
                [0.05, 0.05, 0.0], _rx([[0, 0, 0]], [0.5], [0.2], [10.0]))
    if name == "earth_termination":
        return (compile_scene([plate(300.0, 300.0, yaw=-np.pi / 4).translated([1000.0, 0, 0])], [1.0], [1.0],
                              [np.zeros(3)]), (3, 2), [0.0, 0.0], [0.02, 0.02, 0.0], _mono())
    if name == "two_plates":
        m1 = plate(120.0, 120.0, yaw=-np.pi / 4).translated([500.0, 0.0, 0.0])
        m2 = plate(120.0, 120.0, yaw=np.pi / 4).translated([500.0, 300.0, 0.0])
        return (compile_scene([m1, m2], [1.0, 0.7], [1.0, 1.0], [np.zeros(3), np.zeros(3)]), (3, 3),
                [0.0, 0.0], [0.02, 0.02, 0.0], _mono())
    if name == "direct":
        return (compile_scene([plate(50.0, 50.0).translated([1000.0, 3000.0, 0.0])], [1.0], [1.0],
                              [np.zeros(3)]), (3, 1), [0.0, 0.0], [0.05, 0.05, 0.0],
                _rx([[900.0, 0, 0]], [np.pi], [0.0], [8.0]))
    if name == "corridor":
        p1 = plate(300.0, 300.0).translated([1000.0, 0.0, 0.0])
        p2 = plate(300.0, 300.0).translated([-500.0, 0.0, 0.0])
        return (compile_scene([p1, p2], [1.0, -1.0], [1.0, 1.0], [np.array([40.0, 5.0, 0.0]), np.zeros(3)]),
                (3, 2), [0.0, 0.0], [0.05, 0.05, 0.0], _mono(25.0))
    if name == "zero_reflections":
        return (compile_scene([plate(200.0, 200.0).translated([1000.0, 0, 0])], [1.0], [1.0], [np.zeros(3)]),
                (2, 0), [0.0, 0.0], [0.05, 0.05, 0.0], _mono())
    if name == "no_receivers":
        return (compile_scene([plate(200.0, 200.0).translated([1000.0, 0, 0])], [1.0], [1.0], [np.zeros(3)]),
                (2, 2), [0.0, 0.0], [0.05, 0.05, 0.0], rx_sphere_geometry(np.zeros((0, 3)), [], [], [], [], []))
    if name == "pole_up":
        return _pole(1.45)
    if name == "pole_down":
        return _pole(-1.45)
    if name == "north_star":
        mesh, _ = sphere_mesh(3, 40.0)
        return (compile_scene([mesh.translated([900.0, 0, 0])], [0.9], [1.0], [np.array([30.0, 5.0, 0.0])]),
                (5, 2), [0.0, 0.0], [0.12, 0.12, 0.0], _mono(10.0))
    return _fuzz(int(name.split("_")[1]))


SCENES = ["plate_single_ray", "plate_fan", "moving_sphere", "offset_boresight", "earth_termination",
          "two_plates", "direct", "corridor", "zero_reflections", "no_receivers", "pole_up", "pole_down",
          "north_star", "fuzz_7", "fuzz_21", "fuzz_99"]
STRICT = ["plate_fan", "moving_sphere", "north_star", "pole_up", "fuzz_21"]


@functools.lru_cache(maxsize=None)
def _run(name, strict):
    """(port, rts_tpu, oracle) results of one scene, in the engine's
    lanes-last layout (the oracle's rows transposed); each scene is traced
    once for both comparisons."""
    scene, (n, depth), tx_dir, tx_span, rx, *tx = _scene(name)
    tx_origin = np.asarray(tx[0] if tx else np.zeros(3), np.float64)
    params = JParameters(num_rays=n, max_refl_depth=depth)
    jcfg = JConfig.from_parameters(params, strict_parity=strict, tri_chunk=64)
    tx_dir = tuple(float(x) for x in tx_dir)
    tx_span = tuple(float(x) for x in tx_span)
    ref = j_trace_pulse(j_scene_to_device(scene, dtype=jnp.float64), JRx.from_host(rx, dtype=jnp.float64),
                        jnp.asarray(tx_origin), tx_dir, tx_span, jcfg)
    got = trace_pulse(scene_to_device(scene, dtype=torch.float64, device=DEVICE),
                      RxGeomDevice.from_host(rx, dtype=torch.float64, device=DEVICE),
                      torch.as_tensor(tx_origin), tx_dir, tx_span, convert.trace_config(jcfg))
    o = oracle_trace(scene, params, tx_origin, tx_dir, tx_span, rx, strict_parity=strict)
    orc = dict(received=o.received, refl_depth=o.refl_depth, refr_depth=o.refr_depth, path=o.path.T,
               ray_length=o.ray_length, power=o.power, doppler=o.doppler, first_hit=o.first_hit.T,
               prev_hit=o.prev_hit.T, rcs=np.transpose(o.rcs_angle, (2, 1, 0)))
    return got, {f: np.asarray(getattr(ref, f)) for f in orc}, orc


DISCRETE = ("received", "refl_depth", "refr_depth", "path")
CONTINUOUS = ("ray_length", "power", "doppler", "first_hit", "prev_hit", "rcs")


@pytest.mark.parametrize("against", ["rts_tpu", "oracle"])
@pytest.mark.parametrize("name", SCENES)
def test_f64_engine_matches(name, against):
    """assert_match of tests/test_engine_vs_oracle.py, rcs included."""
    got, ref, orc = _run(name, strict=False)
    exp = ref if against == "rts_tpu" else orc
    for f in DISCRETE:
        np.testing.assert_array_equal(getattr(got, f).numpy(), exp[f], err_msg=f)
    for f in CONTINUOUS:
        atol = 1e-300 if f == "power" else 1e-9
        np.testing.assert_allclose(getattr(got, f).numpy(), exp[f], rtol=RTOL, atol=atol, err_msg=f)
    if name != "zero_reflections":
        assert (exp["received"] >= 0).any() or (exp["refl_depth"] > 0).any()  # the scene is seen


@pytest.mark.parametrize("against", ["rts_tpu", "oracle"])
@pytest.mark.parametrize("name", STRICT)
def test_strict_parity_matches(name, against):
    """The float32 narrowing points: decisions identical, continuous
    outputs at the float32 floor."""
    got, ref, orc = _run(name, strict=True)
    exp = ref if against == "rts_tpu" else orc
    for f in DISCRETE:
        np.testing.assert_array_equal(getattr(got, f).numpy(), exp[f], err_msg=f)
    rec = exp["received"] >= 0
    assert rec.any()
    for f in ("ray_length", "power"):
        np.testing.assert_allclose(getattr(got, f).numpy()[rec], exp[f][rec], rtol=STRICT_TOL, err_msg=f)
    if against == "rts_tpu":
        # every lane (not just received ones): the narrowed directions
        # carry the floor over Earth-radius legs too
        for f in ("ray_length", "power", "first_hit", "prev_hit"):
            atol = 0.0 if f == "power" else 1e-6  # power is ~1e-16 W
            np.testing.assert_allclose(getattr(got, f).numpy(), exp[f], rtol=STRICT_TOL, atol=atol, err_msg=f)


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


@pytest.mark.parametrize(
    "dtype, options",
    [("float64", {}), ("float32", {}), ("float64", {"preset": "parity"})],
    ids=["bare_f64", "bare_f32", "parity"],
)
def test_prepare_cpi_matches_rts_tpu(dtype, options):
    """prepare_cpi + trace_cpi against rts_tpu's: every decision identical;
    power, delay and Doppler to rtol 1e-9 in float64 and 5e-6 under strict
    parity.  Bare float32 is held as tests/test_torch_cpi.py holds the f32
    kernel path (delay and Doppler 1e-5, power 5e-5): the receiver-sphere
    solve cancels ~1e6 m^2 terms, so XLA's FMA contraction moves a ray
    length by ~4e-6 relative and power, going as 1/r^4, by ~1.6e-5.  The
    f64 phase to 1e-7 rad (the two engines' ray lengths differ by FMA
    rounding, ~1e-14 relative over ~2 km, ~5e-9 rad at 10 GHz)."""
    params = dict(num_rays=5, max_refl_depth=2)
    ref = j_trace_cpi(*js.prepare_cpi(world(js), JParameters(**params), dtype=getattr(jnp, dtype), **options))
    state = ts.prepare_cpi(world(ts), TParameters(**params), dtype=getattr(torch, dtype), device=DEVICE,
                           **options)
    assert state[2].accel == "brute" and state[0].cl_mn is None
    got = trace_cpi(*state)
    rec = np.asarray(ref.received) >= 0
    assert rec.sum() >= 5
    np.testing.assert_array_equal(got.received.numpy(), np.asarray(ref.received))
    for f in ("emit", "npath", "path_match"):
        np.testing.assert_array_equal(getattr(got.agg, f).numpy(), np.asarray(getattr(ref.agg, f)), err_msg=f)
    tol = CPI_TOL.get((dtype, bool(options)))
    rtol = dict.fromkeys(F32_TOL, tol) if tol else F32_TOL
    # power (~4e-19 W here) and delay (~6.5e-6 s) are held by rtol alone;
    # Doppler gets a 1e-6 Hz floor for lanes near zero radial speed
    for f, atol in (("power", 0.0), ("delay", 0.0), ("doppler", 1e-6)):
        np.testing.assert_allclose(getattr(got, f).numpy()[rec], np.asarray(getattr(ref, f))[rec],
                                   rtol=rtol[f], atol=atol, err_msg=f)
        np.testing.assert_allclose(getattr(got.agg, f).numpy()[rec], np.asarray(getattr(ref.agg, f))[rec],
                                   rtol=rtol[f], atol=atol, err_msg="agg " + f)
    if dtype == "float64":
        d = np.abs(got.agg.phase.numpy() - np.asarray(ref.agg.phase))[rec]
        assert np.minimum(d, TWO_PI - d).max() < 1e-7
