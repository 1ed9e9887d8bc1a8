"""The port's antenna and RCS models and on-device receiver geometry
against rts_tpu's, alone and through a traced CPI.

Tolerances, relative to the model's peak over the sample: float64 within
1e-10, float32 within 1e-3.  ``acos`` near 1 is ill-conditioned and
rts_tpu's gains run under jit (XLA contracts FMAs), so an f32
``off_angle`` moves by up to ~sqrt(2 ulp) = 3.5e-4 rad near the boresight
between two correct implementations, and a narrow beam (the 1 m dish at
3 cm) turns that into a share of its peak.  Measured on the CPU (``pytest
-s`` prints every error): float32 gains at most 3.0e-4 of the peak (the
dish) over 1e6 uniform directions, float64 6.1e-13.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rts_tpu.physics.antenna as ja
import rts_tpu.physics.rcs as jr
import rts_tpu.sim as js
from rts_tpu import Parameters as JParameters
from rts_tpu.engine.cpi import trace_cpi as j_trace_cpi
from rts_tpu.physics.receiver_geom import rx_sphere_geometry_device as j_rx_geom_device

import rts_tpu_torch.physics.antenna as ta
import rts_tpu_torch.physics.rcs as tr
import rts_tpu_torch.sim as ts
from rts_tpu_torch import Parameters as TParameters
from rts_tpu_torch.engine.cpi import trace_cpi as t_trace_cpi
from rts_tpu_torch.physics.receiver_geom import rx_sphere_geometry_device as t_rx_geom_device

from test_torch_driver import plate_world

torch.set_num_threads(1)

DEVICE = "cpu"
WAVELENGTH = 299792458.0 / 10e9
N_DIRS = 1_000_000
BORE = (0.3, -0.2)
TOL = {"f64": 1e-10, "f32": 1e-3}
DTYPES = {"f64": (np.float64, torch.float64), "f32": (np.float32, torch.float32)}

# the parameters examples/scene.xml, tests/test_config_io.py and
# tests/test_driver.py:174-190 use, and a table of each kind
ANTENNAS = {
    "sinc": dict(alpha=2.0, beta=1.0, gamma=2.0),
    "gaussian": dict(az_scale=8.0, el_scale=8.0),
    "squarehorn": dict(dimension=0.3),
    "parabolic": dict(diameter=1.0),
    "table": dict(angles=(0.0, 0.1, 0.3, 0.8, 1.5), gains=(30.0, 25.0, 6.0, 0.5, 0.01)),
}
ANTENNA_CLASS = {"sinc": "SincAntenna", "gaussian": "GaussianAntenna", "squarehorn": "SquareHornAntenna",
                 "parabolic": "ParabolicAntenna", "table": "TableAntenna"}
_AZ = tuple(np.linspace(-np.pi, np.pi, 13).tolist())
_EL = tuple(np.linspace(-np.pi / 2, np.pi / 2, 7).tolist())
_TABLE = tuple(map(tuple, np.random.default_rng(7).uniform(0.5, 5.0, (7, 13)).tolist()))
RCS = {
    "sphere": ("SphereRCS", dict(radius=2.0)),
    "plate": ("PlateRCS", dict(width=2.0, height=3.0)),
    "table": ("TableRCS", dict(az_grid=_AZ, el_grid=_EL, table=_TABLE)),
}


def directions(dtype, n=N_DIRS):
    """Uniform over the sphere's angles, and the boresight itself; in
    float64 half of them within ~0.05 rad of the boresight (the main
    lobes), where an f32 ``off_angle`` is least well conditioned."""
    rng = np.random.default_rng(0)
    m = n // 2 if dtype == np.float64 else n - 1
    az = np.concatenate([rng.uniform(-np.pi, np.pi, m), BORE[0] + rng.normal(0, 0.05, n - m - 1), [BORE[0]]])
    el = np.concatenate([rng.uniform(-np.pi / 2, np.pi / 2, m), BORE[1] + rng.normal(0, 0.05, n - m - 1),
                         [BORE[1]]])
    return az.astype(dtype), el.astype(dtype)


def held(got, ref, dtype_id, what):
    """``got`` within TOL of the peak of |ref| (float64 values)."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, what
    peak = np.abs(ref).max()
    err = np.abs(got - ref).max() / peak
    assert err <= TOL[dtype_id], f"{what}: {err:.3e} of the peak {peak:.4g}"
    print(f"{what} {dtype_id}: {err:.3e} of the peak")  # shown under pytest -s
    return err


@pytest.mark.parametrize("dtype_id", ["f64", "f32"])
@pytest.mark.parametrize("name", sorted(ANTENNAS))
def test_antenna_matches_rts_tpu(name, dtype_id):
    npd, tdt = DTYPES[dtype_id]
    az, el = directions(npd)
    kw = ANTENNAS[name]
    jmodel = getattr(ja, ANTENNA_CLASS[name])(**kw)
    ref = jax.jit(lambda a, e: jmodel.gain(a, e, *BORE, WAVELENGTH))(jnp.asarray(az), jnp.asarray(el))
    got = getattr(ta, ANTENNA_CLASS[name])(**kw).gain(torch.as_tensor(az), torch.as_tensor(el), *BORE, WAVELENGTH)
    assert got.dtype == tdt and got.device.type == DEVICE
    held(got.numpy(), ref, dtype_id, name)
    # boresight tensors on the device, as the CPI passes them
    bore = [torch.tensor(b, dtype=tdt) for b in BORE]
    again = getattr(ta, ANTENNA_CLASS[name])(**kw).gain(torch.as_tensor(az), torch.as_tensor(el), *bore,
                                                       WAVELENGTH)
    held(again.numpy(), ref, dtype_id, f"{name} with tensor boresight")


@pytest.mark.parametrize("dtype_id", ["f64", "f32"])
def test_off_angle_and_wrap_match_rts_tpu(dtype_id):
    npd, tdt = DTYPES[dtype_id]
    az, el = directions(npd)
    ref = np.asarray(ja.off_angle(jnp.asarray(az), jnp.asarray(el), *BORE))
    got = ta.off_angle(torch.as_tensor(az), torch.as_tensor(el), *BORE)
    assert got.dtype == tdt
    # acos near 1 turns the cosine's last ulp into ~sqrt(2 ulp) rad (3.5e-4
    # in f32): hold the cosine, the well-conditioned quantity, to a few ulp
    np.testing.assert_allclose(np.cos(got.numpy().astype(np.float64)), np.cos(ref.astype(np.float64)),
                               rtol=0, atol=1e-15 if dtype_id == "f64" else 5e-7)
    a = np.array([-7.0, -math.pi, -1.0, 0.0, 3.0, math.pi, 9.5], npd)
    np.testing.assert_allclose(ta._wrap(torch.as_tensor(a)).numpy(), np.asarray(ja._wrap(jnp.asarray(a))),
                               rtol=0, atol=1e-12 if dtype_id == "f64" else 1e-6)
    x = np.linspace(-20.0, 20.0, 4001).astype(npd)  # both branches of the A&S fit, and 0
    held(ta._j1(torch.as_tensor(x)).numpy(), ja._j1(jnp.asarray(x)), dtype_id, "_j1")


def test_table_antenna_clamps_outside_the_table():
    kw = ANTENNAS["table"]
    th = np.array([0.0, 0.025, 0.05, 1.0, 1.5, 2.5, 3.1])  # past the last angle: the last gain
    az = BORE[0] + th  # at the boresight's elevation the off-angle is ~|d_az| cos(el)
    ref = np.asarray(ja.TableAntenna(**kw).gain(jnp.asarray(az), jnp.full(az.shape, BORE[1]), *BORE, 0.03))
    got = ta.TableAntenna(**kw).gain(torch.as_tensor(az), torch.full(az.shape, BORE[1], dtype=torch.float64),
                                     *BORE, 0.03).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12)
    assert got[0] == 30.0 and got[-1] == got[-2] == 0.01
    # interp at, between, below and above the knots, as jnp.interp
    x = torch.tensor([-1.0, 0.0, 0.1, 0.6, 1.0, 1.5, 9.0], dtype=torch.float64)
    np.testing.assert_allclose(ta.interp(x, kw["angles"], kw["gains"]).numpy(),
                               np.interp(x.numpy(), kw["angles"], kw["gains"]), rtol=1e-14)


def rcs_samples(dtype, n=N_DIRS):
    """Angle sums over twice the half-angle domain and past it (the table
    wraps azimuth and clamps elevation)."""
    rng = np.random.default_rng(1)
    return (rng.uniform(-3 * np.pi, 3 * np.pi, n).astype(dtype),
            rng.uniform(-1.5 * np.pi, 1.5 * np.pi, n).astype(dtype))


@pytest.mark.parametrize("dtype_id", ["f64", "f32"])
@pytest.mark.parametrize("name", sorted(RCS))
def test_rcs_matches_rts_tpu(name, dtype_id):
    npd, tdt = DTYPES[dtype_id]
    cls, kw = RCS[name]
    az, el = rcs_samples(npd)
    jm, tm = getattr(jr, cls)(**kw), getattr(tr, cls)(**kw)
    assert getattr(tm, "aspect_free", False) == getattr(jm, "aspect_free", False)
    ref = jm.rcs(jnp.asarray(az), jnp.asarray(el), WAVELENGTH)
    got = tm.rcs(torch.as_tensor(az), torch.as_tensor(el), WAVELENGTH)
    assert got.dtype == tdt and got.shape == az.shape
    held(got.numpy(), ref, dtype_id, name)
    held(tm.GetRCS(torch.as_tensor(az), torch.as_tensor(el), WAVELENGTH).numpy(), ref, dtype_id,
         f"{name}.GetRCS")


def test_table_rcs_wraps_and_clamps():
    cls, kw = RCS["table"]
    jm, tm = jr.TableRCS(**kw), tr.TableRCS(**kw)
    # half-angles: pi + 0.1 wraps to -pi + 0.1; elevation past +-pi/2 clamps
    az = np.array([2 * (np.pi + 0.1), 2 * (-np.pi + 0.1), 0.0, 2 * _AZ[3], 1.0])
    el = np.array([0.0, 0.0, 2 * (np.pi / 2 + 0.4), 2 * _EL[2], -4.0])
    ref = np.asarray(jm.rcs(jnp.asarray(az), jnp.asarray(el), 0.03))
    got = tm.rcs(torch.as_tensor(az), torch.as_tensor(el), 0.03).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-12)
    assert got[0] == pytest.approx(got[1], rel=1e-12)
    assert got[3] == pytest.approx(_TABLE[2][3], rel=1e-12)  # on a knot: the table's value
    assert got[2] == pytest.approx(np.interp(0.0, _AZ, _TABLE[-1]), rel=1e-12)


def test_table_rcs_from_arrays():
    az, el = np.array(_AZ), np.array(_EL)
    table = np.asarray(_TABLE)
    got, ref = tr.TableRCS.from_arrays(az, el, table), jr.TableRCS.from_arrays(az, el, table)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert got == tr.TableRCS(**RCS["table"][1])
    with pytest.raises(ValueError, match="table shape"):
        tr.TableRCS.from_arrays(az, el, table.T)
    # scalars in, as rts_tpu's plate peak check (tests/test_driver.py:189)
    pl = tr.PlateRCS(width=2.0, height=3.0)
    assert float(pl.rcs(0.0, 0.0, WAVELENGTH)) == pytest.approx(4 * np.pi * 36.0 / WAVELENGTH**2, rel=1e-15)


@pytest.mark.parametrize("dtype_id", ["f64", "f32"])
def test_rx_sphere_geometry_device_matches_rts_tpu(dtype_id):
    npd, tdt = DTYPES[dtype_id]
    rng = np.random.default_rng(3)
    p, nr = 5, 3
    args = (rng.uniform(-500, 500, (p, nr, 3)), rng.uniform(-np.pi, np.pi, (p, nr)),
            rng.uniform(-1.2, 1.2, (p, nr)), rng.uniform(1, 40, (p, nr)), rng.uniform(0.5, 2, (p, nr)),
            rng.uniform(0.5, 2, (p, nr)))
    ref = j_rx_geom_device(*args, dtype=npd)
    got = t_rx_geom_device(*args, dtype=tdt, device=DEVICE)
    tol = dict(rtol=1e-13, atol=1e-12) if dtype_id == "f64" else dict(rtol=2e-6, atol=2e-5)
    for f in dataclasses.fields(ref):
        a = getattr(got, f.name)
        assert a.dtype == tdt and a.device.type == DEVICE, f.name
        np.testing.assert_allclose(a.numpy(), np.asarray(getattr(ref, f.name)), err_msg=f.name, **tol)


def test_prepare_cpi_rx_geom_on_device_matches_rts_tpu():
    """prepare_cpi(rx_geom_on_device=True) against rts_tpu's batch and
    against the port's own host prep, as tests/test_cpi.py:129-155 holds
    rts_tpu's; both trace to the same captures; refine=True refuses."""
    params = dict(num_rays=3, max_refl_depth=2)
    world = lambda S: plate_world(S, num_pulses=3, rotating=True, target_speed=40.0)
    jstate = js.prepare_cpi(world(js), JParameters(**params), dtype=jnp.float64, rx_geom_on_device=True)
    tstate = ts.prepare_cpi(world(ts), TParameters(**params), dtype=torch.float64, device=DEVICE,
                            rx_geom_on_device=True)
    host = ts.prepare_cpi(world(ts), TParameters(**params), dtype=torch.float64, device=DEVICE)
    for name in ("centre", "radius", "min_theta", "max_theta", "min_phi", "max_phi"):
        got = getattr(tstate[1].rx_geom, name)
        assert got.dtype == torch.float64 and got.shape == getattr(host[1].rx_geom, name).shape
        np.testing.assert_allclose(got.numpy(), np.asarray(getattr(jstate[1].rx_geom, name)), rtol=1e-13,
                                   atol=1e-12, err_msg=name)
        # the host prep narrows its trig to float32, as the reference
        np.testing.assert_allclose(got.numpy(), getattr(host[1].rx_geom, name).numpy(), rtol=1e-6, atol=5e-6,
                                   err_msg=name)
    for name in ("rot", "pos", "vel", "rx_pos", "tx_origin", "tx_dir", "times"):
        np.testing.assert_array_equal(getattr(tstate[1], name).numpy(), np.asarray(getattr(jstate[1], name)))
    got, ref = t_trace_cpi(*tstate), j_trace_cpi(*jstate)
    assert int((got.received >= 0).sum()) > 0
    np.testing.assert_array_equal(got.received.numpy(), np.asarray(ref.received))
    np.testing.assert_allclose(got.power.numpy(), np.asarray(ref.power), rtol=1e-9, atol=0)
    for S, kw in ((js, dict(dtype=jnp.float32)), (ts, dict(device=DEVICE))):
        P = JParameters if S is js else TParameters
        with pytest.raises(ValueError, match="rx_geom_on_device"):
            S.prepare_cpi(world(S), P(**params), refine=True, rx_geom_on_device=True, **kw)


def model_world(S):
    """A Sinc Tx, a Gaussian Rx beside it and a parabolic Rx 50 m off that
    the plate's +-0.025 rad rays reach, a turning plate with a plate RCS
    and a sphere with a sphere RCS (the plate's RCS is aspect-dependent:
    the tracer records the per-bounce angle sums)."""
    A = ja if S is js else ta
    R = jr if S is js else tr
    w = S.World()
    w.add(S.Transmitter(path=S.Path.fixed(0, 0, 0), wave=S.RadarSignal(carrier=10e9), pulse_count=3,
                        prf=1000.0, tx_span=(0.1, 0.1, 0.0), antenna=A.SincAntenna(alpha=2.0, beta=3.0),
                        rotation=S.RotationPath(azimuth=0.001)))
    w.add(S.Receiver(path=S.Path.fixed(0, 0, 0), sphere=(5.0, 1.0, 1.0),
                     antenna=A.GaussianAntenna(az_scale=8.0, el_scale=8.0)))
    w.add(S.Receiver(path=S.Path.fixed(0, 50, 0), sphere=(20.0, 1.5, 1.5), antenna=A.ParabolicAntenna(diameter=0.2),
                     rotation=S.RotationPath(azimuth=0.02, elevation=0.01)))
    w.add(S.Target(path=S.Path.linear([(0.0, (1000.0, 0.0, 0.0)), (1.0, (1040.0, 0.0, 0.0))]),
                   attitude=S.AttitudePath(yaw_rate=0.01), shape="rect", rect=(2.0, 200.0, 200.0),
                   refl_coeff=0.9, rcs_model=R.PlateRCS(width=2.0, height=3.0)))
    w.add(S.Target(path=S.Path.fixed(700, -40, 0), shape="sphere", sphere_params=(2, 8.0), refl_coeff=0.7,
                   rcs_model=R.SphereRCS(radius=2.0)))
    return w


def test_models_through_a_traced_cpi_match_rts_tpu():
    """The models in post-processing: the port's f64 CPI against rts_tpu's
    (rcs_angles auto-detected on): decisions identical, power and Doppler
    within 1e-9."""
    params = dict(num_rays=5, max_refl_depth=2)
    ref = js.run_cpi(model_world(js), JParameters(**params), dtype=jnp.float64, attach_responses=False)
    got = ts.run_cpi(model_world(ts), TParameters(**params), dtype=torch.float64, device=DEVICE,
                     attach_responses=False)
    cfg = ts.prepare_cpi(model_world(ts), TParameters(**params), dtype=torch.float64, device=DEVICE)[2]
    assert cfg.rcs_angles
    rec = np.asarray(ref.received) >= 0
    assert {0, 1} <= set(np.asarray(ref.received)[rec].tolist())  # both receivers
    for name in ("received",):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(ref, name)))
    for name in ("emit", "npath", "path_match"):
        np.testing.assert_array_equal(getattr(got.agg, name).numpy(), np.asarray(getattr(ref.agg, name)))
    for a, b in ((got.power, ref.power), (got.agg.power, ref.agg.power)):
        np.testing.assert_allclose(a.numpy()[rec], np.asarray(b)[rec], rtol=1e-9, atol=0)
    for a, b in ((got.doppler, ref.doppler), (got.agg.doppler, ref.agg.doppler)):
        np.testing.assert_allclose(a.numpy()[rec], np.asarray(b)[rec], rtol=1e-9, atol=1e-9)
    # the models moved the power: the same scene with isotropic models differs
    iso = model_world(ts)
    iso.transmitters[0].antenna = ta.IsotropicAntenna()
    for t in iso.targets:
        t.rcs_model = tr.IsoRCS()
    plain = ts.run_cpi(iso, TParameters(**params), dtype=torch.float64, device=DEVICE, attach_responses=False)
    assert not np.allclose(plain.power.numpy()[rec], got.power.numpy()[rec], rtol=1e-3, atol=0)
