"""The port's NumPy float64 oracle (``rts_tpu_torch.oracle``) against
``rts_tpu.oracle``, and the port's f64 engine against the port's oracle.

Both oracles are the same float64 NumPy code on host modules that the
port copied, so they are held equal bit for bit (``assert_array_equal``)
on every field, on the scenes of ``tests/test_oracle.py`` and
``tests/test_engine_vs_oracle.py`` built in each package from the same
NumPy inputs.  The port's brute-force f64 engine is held to the port's
oracle with ``assert_match``'s rules (``tests/test_engine_vs_oracle.py:44-60``):
discrete outputs equal, continuous ones within rtol 1e-9.
"""

import numpy as np
import pytest
import torch

import rts_tpu_torch.geometry as t_geom
from rts_tpu_torch.config import Parameters as TParameters
from rts_tpu_torch.engine.types import RxGeomDevice, TraceConfig, scene_to_device
from rts_tpu_torch.engine.wavefront import trace_pulse as t_trace_pulse
from rts_tpu_torch.geometry.scene import compile_scene as t_compile_scene
from rts_tpu_torch.oracle import aggregation as t_aggregation
from rts_tpu_torch.oracle import generate_fan as t_generate_fan
from rts_tpu_torch.oracle import trace_pulse as t_oracle
from rts_tpu_torch.physics import rx_sphere_geometry as t_rx_geom

import rts_tpu.geometry as j_geom
from rts_tpu.config import Parameters as JParameters
from rts_tpu.geometry.scene import compile_scene as j_compile_scene
from rts_tpu.oracle import aggregation as j_aggregation
from rts_tpu.oracle import generate_fan as j_generate_fan
from rts_tpu.oracle import trace_pulse as j_oracle
from rts_tpu.physics import rx_sphere_geometry as j_rx_geom

torch.set_num_threads(1)

DEVICE = "cpu"
RTOL = 1e-9  # tests/test_engine_vs_oracle.py's
PKG = {"port": (t_geom, t_compile_scene, t_rx_geom, TParameters),
       "rts_tpu": (j_geom, j_compile_scene, j_rx_geom, JParameters)}


def _rx(rx_geom, pos, az, radius, spans=(1.0, 1.0)):
    n = len(pos)
    return rx_geom(rx_pos=np.asarray(pos, float), rx_azimuth=np.asarray(az, float),
                   rx_elevation=np.zeros(n), sphere_radius=np.full(n, radius),
                   theta_span=np.full(n, spans[0]), phi_span=np.full(n, spans[1]))


def scene(name: str, pkg: str):
    """(scene, params, tx_origin, tx_dir, tx_span, rx) of ``name`` built with
    ``pkg``'s host modules."""
    G, compile_scene, rx_geom, P = PKG[pkg]
    mono = _rx(rx_geom, [[0.0, 0.0, 0.0]], [0.0], 5.0)
    slab_rx = _rx(rx_geom, [[0.0, 0.0, 0.0], [2000.0, 0.0, 0.0]], [0.0, np.pi], 8.0)
    z = [0.0, 0.0, 0.0]
    if name == "plate_one_ray":  # test_oracle.py TestSingleBounce
        s = compile_scene([G.rect_mesh(2.0, 200.0, 200.0).translated([1000.0, 0, 0])], [0.8], [1.0], [np.zeros(3)])
        return s, P(num_rays=1, max_refl_depth=1), z, [0.0, 0.0], [0.1, 0.1, 0.0], mono
    if name == "plate_fan_doppler":  # TestPlateMonostatic.test_fan_27_rays
        s = compile_scene([G.rect_mesh(2.0, 400.0, 400.0).translated([1000.0, 0, 0])], [1.0], [1.0],
                          [np.array([-100.0, 0.0, 0.0])])
        return s, P(num_rays=3, max_refl_depth=2), z, [0.0, 0.0], [0.05, 0.05, 0.0], _rx(rx_geom, [z], [0.0], 20.0)
    if name == "miss_everything":  # TestSingleBounce.test_miss_everything
        s = compile_scene([G.rect_mesh(2.0, 20.0, 20.0).translated([0, 1000.0, 0])], [1.0], [1.0], [np.zeros(3)])
        return s, P(num_rays=3, max_refl_depth=2), z, [0.0, 0.0], [0.05, 0.05, 0.0], mono
    if name == "sphere_fan":  # TestSphereTarget.test_moving_sphere_fan: the 27-ray sphere fan
        mesh, _ = G.sphere_mesh(2, 10.0)
        s = compile_scene([mesh.translated([800.0, 0.0, 0.0])], [1.0], [1.0], [np.array([-150.0, 30.0, 5.0])])
        return s, P(num_rays=3, max_refl_depth=2), z, [0.0, 0.0], [0.03, 0.03, 0.0], _rx(rx_geom, [z], [0.0], 15.0)
    if name == "tilted_plate_earth":  # TestMultiBounceCorner.test_tilted_plate_earth_termination
        s = compile_scene([G.rect_mesh(2.0, 300.0, 300.0, yaw=-np.pi / 4).translated([1000.0, 0, 0])], [1.0], [1.0],
                          [np.zeros(3)])
        return s, P(num_rays=3, max_refl_depth=2), z, [0.0, 0.0], [0.02, 0.02, 0.0], mono
    if name == "two_plates":  # TestMultiBounceCorner.test_two_plates_double_bounce
        m1 = G.rect_mesh(2.0, 120.0, 120.0, yaw=-np.pi / 4).translated([500.0, 0.0, 0.0])
        m2 = G.rect_mesh(2.0, 120.0, 120.0, yaw=np.pi / 4).translated([500.0, 300.0, 0.0])
        s = compile_scene([m1, m2], [1.0, 0.7], [1.0, 1.0], [np.zeros(3), np.zeros(3)])
        return s, P(num_rays=3, max_refl_depth=3), z, [0.0, 0.0], [0.02, 0.02, 0.0], mono
    if name == "direct":  # TestDirect.test_direct_transmission
        s = compile_scene([G.rect_mesh(2.0, 50.0, 50.0).translated([1000.0, 3000.0, 0.0])], [1.0], [1.0],
                          [np.zeros(3)])
        return (s, P(num_rays=3, max_refl_depth=1), z, [0.0, 0.0], [0.05, 0.05, 0.0],
                _rx(rx_geom, [[900.0, 0.0, 0.0]], [np.pi], 8.0))
    if name == "dielectric_slab":  # TestRefraction.test_dielectric_slab_multistatic: two receivers
        s = compile_scene([G.rect_mesh(10.0, 300.0, 300.0).translated([500.0, 0, 0])], [0.5], [1.5],
                          [np.array([0.0, 20.0, 0.0])])
        return s, P(num_rays=2, max_refl_depth=2, max_refr_depth=2), z, [0.0, 0.0], [0.01, 0.01, 0.0], slab_rx
    if name == "slab_one_ray":  # test_oracle.py TestRefraction
        s = compile_scene([G.rect_mesh(10.0, 300.0, 300.0).translated([500.0, 0, 0])], [0.5], [1.5], [np.zeros(3)])
        return (s, P(num_rays=1, max_refl_depth=2, max_refr_depth=2), z, [0.0, 0.0], [0.1, 0.1, 0.0],
                _rx(rx_geom, [[0.0, 0.0, 0.0], [2000.0, 0.0, 0.0]], [0.0, np.pi], 5.0))
    raise KeyError(name)


SCENES = ["plate_one_ray", "plate_fan_doppler", "miss_everything", "sphere_fan", "tilted_plate_earth",
          "two_plates", "direct", "dielectric_slab", "slab_one_ray"]
ENGINE_SCENES = ["sphere_fan", "two_plates", "dielectric_slab"]  # chip_smoke.py phase v's


@pytest.mark.parametrize("strict", [True, False], ids=["strict", "f64"])
@pytest.mark.parametrize("name", SCENES)
def test_oracle_equals_rts_tpu_oracle(name, strict):
    s_t, p_t, *args_t = scene(name, "port")
    s_j, p_j, *args_j = scene(name, "rts_tpu")
    for a, b in zip(vars(s_t).values(), vars(s_j).values()):  # the same host scene in both packages
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    got = t_oracle(s_t, p_t, *args_t, strict_parity=strict)
    ref = j_oracle(s_j, p_j, *args_j, strict_parity=strict)
    assert list(vars(got)) == list(vars(ref))
    for field in vars(ref):
        np.testing.assert_array_equal(getattr(got, field), getattr(ref, field), err_msg=field)
    if name != "miss_everything":
        assert (ref.received >= 0).any() or (ref.refl_depth > 0).any()


def test_generate_fan_equals_rts_tpu():
    for n, tx_dir, span in ((1, (0.3, -0.1), (0.1, 0.1, 0.0)), (5, (0.5, 0.2), (0.05, 0.08, 0.0)),
                            (4, (-1.0, 0.4), (0.2, 0.1, 0.5))):
        np.testing.assert_array_equal(t_generate_fan(TParameters(num_rays=n), tx_dir, span),
                                      j_generate_fan(JParameters(num_rays=n), tx_dir, span))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_aggregate_equals_rts_tpu(seed):
    """Seeded received rays with repeated paths (so that groups combine)."""
    rng = np.random.default_rng(seed)
    m, d = 200, 3
    args = (rng.integers(0, 2, m), rng.integers(0, 3, m), rng.integers(0, 2, m), rng.integers(-1, 2, (m, d)),
            rng.uniform(1e-12, 1e-9, m), rng.uniform(1000.0, 1100.0, m), rng.normal(0.0, 50.0, m))
    got = t_aggregation.aggregate(*args, cspeed=299792458.0, carrier=10e9)
    ref = j_aggregation.aggregate(*args, cspeed=299792458.0, carrier=10e9)
    assert (ref.npath > 1).any()
    for field in vars(ref):
        np.testing.assert_array_equal(getattr(got, field), getattr(ref, field), err_msg=field)


@pytest.mark.parametrize("name", ENGINE_SCENES)
def test_f64_engine_matches_port_oracle(name):
    """assert_match (tests/test_engine_vs_oracle.py:44-60) between the
    port's brute-force f64 engine and the port's own oracle."""
    s, params, tx_origin, tx_dir, tx_span, rx = scene(name, "port")
    o = t_oracle(s, params, tx_origin, tx_dir, tx_span, rx, strict_parity=False)
    cfg = TraceConfig.from_parameters(params, strict_parity=False, tri_chunk=64)
    e = t_trace_pulse(scene_to_device(s, dtype=torch.float64, device=DEVICE),
                      RxGeomDevice.from_host(rx, dtype=torch.float64, device=DEVICE),
                      torch.as_tensor(np.asarray(tx_origin, np.float64)), tuple(tx_dir), tuple(tx_span), cfg)
    if name == "sphere_fan":
        assert (o.received >= 0).sum() > 0
    if name == "two_plates":
        assert (o.refl_depth >= 2).sum() > 0  # double-bounce chains exist
    if name == "dielectric_slab":
        assert (o.refr_depth == 2).sum() > 0  # exiting chains exist
    for f in ("received", "refl_depth", "refr_depth"):
        np.testing.assert_array_equal(getattr(e, f).numpy(), getattr(o, f), err_msg=f)
    np.testing.assert_array_equal(e.path.numpy().T, o.path, err_msg="path")
    for f, atol in (("ray_length", 1e-9), ("power", 1e-300), ("doppler", 1e-9)):
        np.testing.assert_allclose(getattr(e, f).numpy(), getattr(o, f), rtol=RTOL, atol=atol, err_msg=f)
    for f in ("first_hit", "prev_hit"):
        np.testing.assert_allclose(getattr(e, f).numpy().T, getattr(o, f), rtol=RTOL, atol=1e-9, err_msg=f)
    np.testing.assert_allclose(np.transpose(e.rcs.numpy(), (2, 1, 0)), o.rcs_angle, rtol=RTOL, atol=1e-9,
                               err_msg="rcs")
