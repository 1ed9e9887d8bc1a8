"""Refraction in the port (rts_tpu_torch) against rts_tpu.

The refracted child of a chain's first hit on a dielectric target lives
N^3 lanes below its parent (trapped chains in [N^3, 2N^3), exiting chains
in [2N^3, 3N^3)); the results are ``ray_total`` lanes wide, and the lanes
past 3N^3 hold only the pre-filled path rows.

- ``_refract`` against rts_tpu's, run eagerly (no jit, so XLA rounds
  every operation alone, as PyTorch does): total internal reflection
  identical, directions to 2 ulp (PyTorch's CPU ``sqrt`` is not correctly
  rounded: 508 of 1e5 uniform f32 inputs differ from NumPy's by an ulp,
  XLA's none); the lane shifts equal.
- The f64 brute-force engine on the refraction scenes of
  tests/test_engine_vs_oracle.py (the slab seen by two receivers, the
  single-ray slab, the three fuzz scenes with max_refr_depth=2) against
  rts_tpu's jitted f64 engine and the NumPy oracle: every discrete output
  identical (against rts_tpu also the triangle chains and capture bits),
  the continuous ones, RCS angle sums included, to rtol 1e-9 and the
  phase to 1e-7 rad (the engines differ by FMA rounding, ~1e-14 of a ray
  length).
- The clustered f32 path (``trace_fan``) on a terrain under a dielectric
  slab (BASELINE config 3 cut to ~1k triangles) against rts_tpu's
  interpret-mode Pallas path, with narrow late segments that fire after
  the two spawn segments: discrete outputs identical, ray length and
  Doppler to rtol 1e-5 and power to 5e-5 (tests/test_torch_cpi.py's f32
  bounds: XLA contracts FMAs under jit, the port rounds every product).
- The refined CPI (f32 traversal + f64 replay) against rts_tpu's f64
  engine: decisions identical, power, aggregated power and phase within
  1e-6 (tests/test_replay.py:83's contract).
- ``sim.run`` and ``run_cpi`` with refraction against rts_tpu's
  (tests/test_driver.py:115, tests/test_cpi.py:40).
"""

import copy
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rts_tpu.sim as js
from rts_tpu import Parameters as JParameters
from rts_tpu.engine import RxGeomDevice as JRx
from rts_tpu.engine import TraceConfig as JConfig
from rts_tpu.engine import scene_to_device as j_scene_to_device
from rts_tpu.engine import trace_pulse as j_trace_pulse
from rts_tpu.engine import wavefront as JW
from rts_tpu.engine.animate import animate_packed as j_animate
from rts_tpu.engine.cpi import trace_cpi as j_trace_cpi
from rts_tpu.engine.fan import generate_fan_c as j_fan
from rts_tpu.geometry import rect_mesh, sphere_mesh
from rts_tpu.geometry.scene import compile_scene
from rts_tpu.oracle import trace_pulse as oracle_trace
from rts_tpu.physics import rx_sphere_geometry

import rts_tpu_torch.engine.wavefront as TW
import rts_tpu_torch.sim as ts
from rts_tpu_torch import Parameters as TParameters
from rts_tpu_torch import convert
from rts_tpu_torch.engine.animate import ClusterScene
from rts_tpu_torch.engine.cpi import trace_cpi
from rts_tpu_torch.engine.types import RxGeomDevice, TraceConfig, scene_to_device
from rts_tpu_torch.sim import check_replay_overflow

torch.set_num_threads(1)

DEVICE = "cpu"  # the port's entry points default to the card
RTOL = 1e-9
C = 299792458.0
CARRIER = 10e9
TWO_PI = 2.0 * math.pi


def phase_err(a, b):
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return np.minimum(d, TWO_PI - d)


# ---------------------------------------------------------------- _refract


def _incidences(dtype, seed=0, n=4000):
    """Unit incidences and normals: front and back faces, grazing angles
    (total internal reflection at ratio 1.5 from inside), a ratio per lane
    of 1.5, 1/1.5 or a random index."""
    rng = np.random.default_rng(seed)
    i = rng.normal(size=(3, n))
    i /= np.linalg.norm(i, axis=0)
    nrm = rng.normal(size=(3, n))
    nrm /= np.linalg.norm(nrm, axis=0)
    ior = rng.choice([1.5, 1.0 / 1.5, 1.33], size=n) * np.where(rng.random(n) < 0.2, rng.uniform(0.8, 1.2, n), 1.0)
    return (i.astype(dtype), nrm.astype(dtype), ior.astype(dtype))


@pytest.mark.parametrize("dtype, strict", [("float32", False), ("float64", False), ("float64", True)],
                         ids=["f32", "f64", "strict_parity"])
def test_refract_matches_rts_tpu(dtype, strict):
    i, n, ior = _incidences(dtype)
    jcfg = JConfig(num_rays=3, max_refl_dev=3, max_refr_dev=2, strict_parity=strict)
    with jax.disable_jit():
        jr, jok = JW._refract(jnp.asarray(i), jnp.asarray(n), jnp.asarray(ior), jcfg)
    tr, tok = TW._refract(torch.as_tensor(i), torch.as_tensor(n), torch.as_tensor(ior),
                          convert.trace_config(jcfg))
    jok = np.asarray(jok)
    assert tr.dtype == getattr(torch, dtype)
    assert (~jok).sum() > 50 and jok.sum() > 1000  # TIR and refraction both exercised
    assert ((i * n).sum(0) > 0).sum() > 1000  # backface hits
    np.testing.assert_array_equal(tok.numpy(), jok)
    ulp2 = 2.4e-7 if dtype == "float32" or strict else 4.5e-16  # unit components: 2 ulp of 1
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=0, atol=ulp2)
    np.testing.assert_allclose(np.linalg.norm(tr.numpy(), axis=0), 1.0, rtol=1e-6)


def test_lane_shifts_match_rts_tpu():
    rng = np.random.default_rng(1)
    a = rng.integers(-5, 5, size=(2, 3, 12)).astype(np.int32)
    np.testing.assert_array_equal(TW._shift_down(torch.as_tensor(a), 4).numpy(),
                                  np.asarray(JW._shift_down(jnp.asarray(a), 4)))
    for off, rows in ((4, 20), (8, 20), (16, 20), (0, 12)):
        np.testing.assert_array_equal(TW._shift_to_rows(torch.as_tensor(a), off, rows).numpy(),
                                      np.asarray(JW._shift_to_rows(jnp.asarray(a), off, rows)))


# ----------------------------------------- the f64 engine on the oracle's scenes


def _slab_rx():
    return rx_sphere_geometry(
        rx_pos=np.array([[0.0, 0.0, 0.0], [2000.0, 0.0, 0.0]]), rx_azimuth=np.array([0.0, np.pi]),
        rx_elevation=np.array([0.0, 0.0]), sphere_radius=np.array([8.0, 8.0]),
        theta_span=np.array([1.0, 1.0]), phi_span=np.array([1.0, 1.0]),
    )


def _fuzz(seed):
    """tests/test_engine_vs_oracle.py:339 (test_random_scene)."""
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
    return scene, 3, tx, [rng.uniform(-0.2, 0.2), rng.uniform(-0.2, 0.2)], [0.25, 0.25, 0.0], rx


def _scene(name):
    """(scene, num_rays, tx_origin, tx_dir, tx_span, rx); max_refl_depth=2,
    max_refr_depth=2."""
    slab = rect_mesh(10.0, 300.0, 300.0).translated([500.0, 0.0, 0.0])
    if name == "slab_multistatic":  # tests/test_engine_vs_oracle.py:165
        return (compile_scene([slab], [0.5], [1.5], [np.array([0.0, 20.0, 0.0])]), 2, np.zeros(3),
                [0.0, 0.0], [0.01, 0.01, 0.0], _slab_rx())
    if name == "single_ray_slab":  # :181
        return compile_scene([slab], [0.5], [1.5], [np.zeros(3)]), 1, np.zeros(3), [0.0, 0.0], [0.01, 0.01, 0.0], _slab_rx()
    return _fuzz(int(name.split("_")[1]))


SCENES = ["slab_multistatic", "single_ray_slab", "fuzz_7", "fuzz_21", "fuzz_99"]
_CACHE = {}


def _run(name):
    """(port, rts_tpu, oracle) results of one scene in the engine's
    lanes-last layout (the oracle's rows transposed), traced once."""
    if name not in _CACHE:
        scene, n, tx_origin, tx_dir, tx_span, rx = _scene(name)
        params = JParameters(num_rays=n, max_refl_depth=2, max_refr_depth=2)
        jcfg = JConfig.from_parameters(params, tri_chunk=64)
        tx_dir = tuple(float(x) for x in tx_dir)
        tx_span = tuple(float(x) for x in tx_span)
        ref = j_trace_pulse(j_scene_to_device(scene, dtype=jnp.float64), JRx.from_host(rx, dtype=jnp.float64),
                            jnp.asarray(tx_origin, jnp.float64), tx_dir, tx_span, jcfg)
        got = TW.trace_pulse(scene_to_device(scene, dtype=torch.float64, device=DEVICE),
                             RxGeomDevice.from_host(rx, dtype=torch.float64, device=DEVICE),
                             torch.as_tensor(tx_origin, dtype=torch.float64), tx_dir, tx_span,
                             convert.trace_config(jcfg))
        o = oracle_trace(scene, params, tx_origin, tx_dir, tx_span, rx, strict_parity=False)
        orc = dict(received=o.received, refl_depth=o.refl_depth, refr_depth=o.refr_depth, path=o.path.T,
                   ray_length=o.ray_length, power=o.power, doppler=o.doppler, first_hit=o.first_hit.T,
                   prev_hit=o.prev_hit.T, rcs=np.transpose(o.rcs_angle, (2, 1, 0)))
        _CACHE[name] = got, {f: np.asarray(v) for f, v in ref._asdict().items()}, orc, jcfg
    return _CACHE[name]


@pytest.mark.parametrize("against", ["rts_tpu", "oracle"])
@pytest.mark.parametrize("name", SCENES)
def test_f64_engine_matches(name, against):
    got, ref, orc, jcfg = _run(name)
    exp = ref if against == "rts_tpu" else orc
    assert got.received.shape[0] == jcfg.ray_total == 5 * jcfg.rays_per_fan
    discrete = ["received", "refl_depth", "refr_depth", "path"]
    if against == "rts_tpu":
        discrete += ["tri_seq", "cap_bits", "cap_root0_bits"]
    for f in discrete:
        np.testing.assert_array_equal(getattr(got, f).numpy(), exp[f], err_msg=f)
    for f in ("ray_length", "power", "doppler", "first_hit", "prev_hit", "rcs"):
        atol = 1e-300 if f == "power" else 1e-9
        np.testing.assert_allclose(getattr(got, f).numpy(), exp[f], rtol=RTOL, atol=atol, err_msg=f)
    rec = exp["received"] >= 0
    k = TWO_PI * CARRIER / C
    ph = lambda length: -np.mod(np.asarray(length, np.float64)[rec] * k, TWO_PI)
    assert phase_err(ph(got.ray_length.numpy()), ph(exp["ray_length"])).max(initial=0.0) < 1e-7
    n3 = jcfg.rays_per_fan
    assert (exp["refr_depth"] > 0).any()  # children were traced
    assert (exp["path"][:, 3 * n3:] >= 0).any()  # and pre-filled rows past the traced lanes
    assert (exp["received"][3 * n3:] < 0).all()


# ------------------------------------- the clustered f32 path, narrow segments


def dielectric_world(S, pulses=2, n=24, extent=1500.0, peak=60.0):
    """bench.py --scene dielectric (BASELINE config 3, bench.py:75-116) cut
    to ~1k terrain triangles: Tx and a monostatic Rx 4 km up looking down,
    a forward Rx looking up at 100 m (above this cut's 60 m peaks;
    bench.py's stands at 600 m), a 200 m dielectric slab (refl 0.5,
    index 1.5) pitched flat at 1 km over the terrain."""
    w = S.World()
    down = S.RotationPath(elevation=-math.pi / 2)
    w.add(S.Transmitter(path=S.Path.fixed(0.0, 0.0, 4000.0), wave=S.RadarSignal(carrier=CARRIER),
                        pulse_count=pulses, prf=1000.0, tx_span=(0.15, 0.15, 0.0), rotation=down))
    w.add(S.Receiver(path=S.Path.fixed(0.0, 0.0, 4000.0), sphere=(25.0, 1.2, 1.2), rotation=down))
    w.add(S.Receiver(path=S.Path.fixed(0.0, 0.0, 100.0), rotation=S.RotationPath(elevation=math.pi / 2),
                     sphere=(60.0, 1.4, 1.4)))
    w.add(S.Target(shape="terrain", terrain=(n, extent, peak, 3), path=S.Path.fixed(0.0, 0.0, 0.0),
                   refl_coeff=0.9))
    w.add(S.Target(shape="rect", rect=(2.0, 200.0, 200.0), attitude=S.AttitudePath(pitch=math.pi / 2),
                   path=S.Path.fixed(0.0, 0.0, 1000.0), refl_coeff=0.5, refr_index=1.5))
    return w


def test_clustered_narrow_matches_rts_tpu():
    """One pulse through both packages' trace_fan on the same animated
    scene; compact_narrow=2 traces the late segments narrow (after the
    two spawn segments, with the budget counted over the 3N^3 lanes)."""
    kw = dict(preset="production", refine=False, cluster_size=128, ray_tile=32, compact_narrow=2,
              interpret=True)
    jb, jbat, jcfg, jspec = js.prepare_cpi(dielectric_world(js), JParameters(num_rays=9, max_refl_depth=2,
                                                                              max_refr_depth=2),
                                           dtype=jnp.float32, **kw)
    assert jcfg.num_segments == 6 and jcfg.refraction_on
    p = 1
    jsc = j_animate(jb, jbat.rot[p], jbat.pos[p], jbat.vel[p], 128)
    fan = j_fan(jcfg.num_rays, (jbat.tx_dir[p, 0], jbat.tx_dir[p, 1]), jspec.kwargs()["tx_span"],
                dtype=jnp.float32)
    rx = type(jbat.rx_geom)(*(a[p] for a in jbat.rx_geom))
    ref = JW.trace_fan(jsc, rx, jbat.tx_origin[p], fan, jcfg)
    widths = []
    real = TW.closest_hit_clustered

    def spy(origin, *a, **k):
        widths.append(origin.shape[1])
        return real(origin, *a, **k)

    TW.closest_hit_clustered = spy
    try:
        got = TW.trace_fan(ClusterScene(*(convert.tensor(getattr(jsc, f), DEVICE) for f in ClusterScene._fields)),
                           convert.rx_geom(rx, DEVICE), convert.tensor(jbat.tx_origin[p], DEVICE),
                           convert.tensor(fan, DEVICE), convert.trace_config(jcfg))
    finally:
        TW.closest_hit_clustered = real
    n3 = jcfg.rays_per_fan
    # two full-width spawn segments over the 3N^3 lanes, then narrow ones
    assert widths[:2] == [3 * n3, 3 * n3] and min(widths[2:]) < 3 * n3
    rec = np.asarray(ref.received)
    assert (rec >= 0).sum() > 0 and (np.asarray(ref.refr_depth) == 2).any()
    for name in ("received", "path", "tri_seq", "refl_depth", "refr_depth", "cap_bits", "cap_root0_bits"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(ref, name)), err_msg=name)
    np.testing.assert_allclose(got.ray_length.numpy(), np.asarray(ref.ray_length), rtol=1e-5)
    np.testing.assert_allclose(got.power.numpy(), np.asarray(ref.power), rtol=5e-5, atol=0)
    np.testing.assert_allclose(got.doppler.numpy(), np.asarray(ref.doppler), rtol=1e-5, atol=1e-6)
    for name in ("first_hit", "prev_hit"):  # hit points carry t's error along ~4 km: 1 cm
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                   rtol=1e-5, atol=1e-2, err_msg=name)


# -------------------------------------------------- the refined CPI's contract


def refraction_world(S, pulses=2):
    """tests/test_replay.py:83: a 200 m plate at 1 km made dielectric (refl
    0.6, index 1.5), a monostatic Rx and a forward Rx behind the plate."""
    w = S.World()
    w.add(S.Transmitter(name="tx0", path=S.Path.fixed(0, 0, 0),
                        wave=S.RadarSignal(carrier=CARRIER, temperature=30.0), pulse_count=pulses,
                        prf=1000.0, tx_span=(0.1, 0.1, 0.0)))
    w.add(S.Receiver(name="rx0", path=S.Path.fixed(0, 0, 0), sphere=(5.0, 1.0, 1.0), noise_temperature=70.0))
    w.add(S.Target(name="plate", path=S.Path.fixed(1000, 0, 0), shape="rect", rect=(2.0, 200.0, 200.0),
                   refl_coeff=0.6, refr_index=1.5))
    w.add(S.Receiver(name="rx1", path=S.Path.fixed(2000, 0, 0), rotation=S.RotationPath(azimuth=np.pi),
                     sphere=(8.0, 1.5, 1.5)))
    return w


PARAMS = dict(num_rays=3, max_refl_depth=2, max_refr_depth=2)


@pytest.fixture(scope="module")
def contract_runs():
    f64 = j_trace_cpi(*js.prepare_cpi(refraction_world(js), JParameters(**PARAMS), dtype=jnp.float64))
    kw = dict(refine=True, accel="cluster", cluster_size=128, ray_tile=128)
    tstate = ts.prepare_cpi(refraction_world(ts), TParameters(**PARAMS), device=DEVICE, **kw)
    jb, jbat, jcfg, jspec = js.prepare_cpi(refraction_world(js), JParameters(**PARAMS), dtype=jnp.float32,
                                           interpret=True, **kw)
    carried = (convert.scene_base(jb, device=DEVICE), convert.pulse_batch(jbat, device=DEVICE),
               convert.trace_config(jcfg), convert.cpi_spec(jspec))
    return dict(f64=f64, state=tstate, port=trace_cpi(*tstate), carried=trace_cpi(*carried))


@pytest.mark.parametrize("which", ["port", "carried"])
def test_refined_refraction_meets_the_contract(contract_runs, which):
    ref, fine = contract_runs["f64"], contract_runs[which]
    got = np.asarray(ref.received) >= 0
    n3 = PARAMS["num_rays"] ** 3
    assert got[:, n3:3 * n3].sum() > 0  # refracted lanes are received
    assert set(np.asarray(ref.received)[got].tolist()) == {0, 1}  # by both receivers
    np.testing.assert_array_equal(fine.received.numpy(), np.asarray(ref.received))
    for name in ("emit", "npath", "path_match"):
        np.testing.assert_array_equal(getattr(fine.agg, name).numpy(), np.asarray(getattr(ref.agg, name)),
                                      err_msg=name)
    # the CPI's per-lane outputs are ray_total wide; past 3 N^3 nothing is
    # received, emitted or given power by post-processing and aggregation
    assert fine.received.shape == (2, 5 * n3)
    past = slice(3 * n3, None)
    assert (fine.received[:, past] < 0).all() and not fine.agg.emit[:, past].any()
    assert (fine.power[:, past] == 0).all() and (fine.agg.npath[:, past] == 0).all()
    full = np.asarray(fine.agg.phase, np.float64) + np.asarray(fine.agg.phase_lo, np.float64)
    assert phase_err(np.asarray(ref.agg.phase)[got], full[got]).max() < 1e-6
    for a, b in ((ref.power, fine.power), (ref.agg.power, fine.agg.power)):
        rel = np.abs(b.double().numpy()[got] / np.asarray(a, np.float64)[got] - 1.0)
        assert rel.max() < 1e-6
    # check_replay_overflow counts the lanes of both receivers
    assert (check_replay_overflow(fine, contract_runs["state"][2], warn=False) == got.sum(1)).all()


# ----------------------------------------------------------- front ends


def test_run_with_refraction_matches_rts_tpu():
    """tests/test_driver.py:115: the sequential driver, f64 brute force."""
    def world(S):
        w = refraction_world(S, pulses=1)
        w.receivers[1].path = S.Path.fixed(0, 200, 0)  # the driver test's second receiver
        w.receivers[1].sphere = (5.0, 1.5, 1.5)
        w.receivers[1].rotation = S.RotationPath()
        return w

    jw, tw = world(js), world(ts)
    params = dict(num_rays=3, max_refl_depth=2, max_refr_depth=2)
    jsum = js.run(jw, JParameters(**params))
    tsum = ts.run(tw, TParameters(**params), device=DEVICE)
    assert tsum.total_received == jsum.total_received > 0 and tsum.total_responses > 0
    assert [(p.received_rays, p.responses) for p in tsum.pulses] == [
        (p.received_rays, p.responses) for p in jsum.pulses]
    for g_rx, r_rx in zip(tw.receivers, jw.receivers, strict=True):
        assert len(g_rx.responses) == len(r_rx.responses)
        for g, r in zip(g_rx.responses, r_rx.responses):
            g, r = g.points[0], r.points[0]
            for f in ("power", "delay", "time"):
                np.testing.assert_allclose(getattr(g, f), getattr(r, f), rtol=RTOL, atol=0, err_msg=f)
            np.testing.assert_allclose(g.doppler, r.doppler, rtol=RTOL, atol=1e-6)
            assert phase_err(g.phase, r.phase) < 1e-7


def test_run_cpi_matches_run_with_refraction():
    """tests/test_cpi.py:40: the CPI front end and the sequential driver
    give the same responses (both f64 brute force in the port), and the
    CPI equals rts_tpu's."""
    w1 = refraction_world(ts, pulses=1)
    w2 = copy.deepcopy(w1)
    ts.run(w1, TParameters(**PARAMS), device=DEVICE)
    out = ts.run_cpi(w2, TParameters(**PARAMS), dtype=torch.float64, device=DEVICE)
    ref = js.run_cpi(refraction_world(js, pulses=1), JParameters(**PARAMS), dtype=jnp.float64,
                     attach_responses=False)
    np.testing.assert_array_equal(out.received.numpy(), np.asarray(ref.received))
    np.testing.assert_array_equal(out.agg.emit.numpy(), np.asarray(ref.agg.emit))
    np.testing.assert_allclose(out.agg.power.numpy(), np.asarray(ref.agg.power), rtol=RTOL, atol=0)
    pts = lambda w: sorted((p for rx in w.receivers for r in rx.responses for p in r.points),
                           key=lambda p: (p.time, p.delay))
    p1, p2 = pts(w1), pts(w2)
    assert len(p1) == len(p2) > 0
    for a, b in zip(p1, p2):
        np.testing.assert_allclose(a.power, b.power, rtol=1e-12)
        np.testing.assert_allclose(a.delay, b.delay, rtol=1e-12)
        assert phase_err(a.phase, b.phase) < 1e-9
        np.testing.assert_allclose(a.doppler, b.doppler, rtol=1e-12, atol=1e-12)
        assert a.noise_temperature == b.noise_temperature


def test_f32_brute_cpi_with_refraction_matches_rts_tpu():
    """prepare_cpi's bare float32 defaults (the brute-force engine) with
    refraction against rts_tpu's: decisions identical, delay and Doppler to
    tests/test_torch_cpi.py's f32 bounds, power to 5e-5 on primaries and
    1e-3 on refracted children (their short legs inside the plate carry
    XLA's FMA rounding, as in tests/test_torch_fan_tiling.py)."""
    ref = j_trace_cpi(*js.prepare_cpi(refraction_world(js), JParameters(**PARAMS), dtype=jnp.float32))
    state = ts.prepare_cpi(refraction_world(ts), TParameters(**PARAMS), device=DEVICE)
    assert state[2].accel == "brute" and state[0].tri_verts.dtype == torch.float32
    got = trace_cpi(*state)
    rec = np.asarray(ref.received) >= 0
    n3 = PARAMS["num_rays"] ** 3
    assert rec[:, n3:].sum() > 0
    np.testing.assert_array_equal(got.received.numpy(), np.asarray(ref.received))
    for name in ("emit", "npath", "path_match"):
        np.testing.assert_array_equal(getattr(got.agg, name).numpy(), np.asarray(getattr(ref.agg, name)),
                                      err_msg=name)
    for f, rtol, atol in (("delay", 1e-5, 0.0), ("doppler", 1e-5, 1e-6)):
        np.testing.assert_allclose(getattr(got, f).numpy()[rec], np.asarray(getattr(ref, f))[rec], rtol=rtol,
                                   atol=atol, err_msg=f)
    child = np.zeros_like(rec)
    child[:, n3:] = True
    for lanes, rtol in ((rec & ~child, 5e-5), (rec & child, 1e-3)):
        np.testing.assert_allclose(got.power.numpy()[lanes], np.asarray(ref.power)[lanes], rtol=rtol, atol=0)


def test_trace_config_refraction_shapes():
    cfg = TraceConfig.from_parameters(TParameters(num_rays=63, max_refl_depth=2, max_refr_depth=2))
    assert (cfg.slot_multiplier, cfg.num_segments, cfg.depth_total) == (5, 6, 4)
    assert cfg.ray_total == 5 * 63**3 == 1_250_235
