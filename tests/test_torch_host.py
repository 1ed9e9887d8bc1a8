"""Host layer of the port (rts_tpu_torch) against rts_tpu, and port hygiene.

Everything compared here is host NumPy carried over from rts_tpu, or its
float32 rounding, so every array must be EQUAL, not merely close.
"""

import dataclasses
import inspect
import math
import pathlib
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rts_tpu.accel as j_accel
import rts_tpu.geometry as j_geom
import rts_tpu.sim as js
from rts_tpu import Parameters as JParameters
from rts_tpu.geometry.scene import compile_scene as j_compile_scene

import rts_tpu_torch.accel as t_accel
import rts_tpu_torch.geometry as t_geom
import rts_tpu_torch.sim as ts
from rts_tpu_torch import Parameters as TParameters
from rts_tpu_torch import convert
from rts_tpu_torch.geometry.scene import compile_scene as t_compile_scene
from rts_tpu_torch.physics import antenna as t_antenna
from rts_tpu_torch.physics import rcs as t_rcs

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "rts_tpu_torch"
DEVICE = "cpu"  # the port's entry points default to the card


def test_port_imports_every_module_without_jax():
    """Every module of rts_tpu_torch imports with jax blocked, and none
    pulls in rts_tpu."""
    code = (
        "import sys, importlib, pkgutil\n"
        "sys.modules['jax'] = None\n"
        "import rts_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(rts_tpu_torch.__path__, 'rts_tpu_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "assert not any(m == 'rts_tpu' or m.startswith('rts_tpu.') for m in sys.modules)\n"
        "print(len(names))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 49


def test_no_port_module_names_jax():
    pattern = re.compile(r"^\s*(import jax|from jax|import rts_tpu\b|from rts_tpu[ .])", re.M)
    offenders = [str(p.relative_to(REPO)) for p in PORT.rglob("*.py") if pattern.search(p.read_text())]
    assert offenders == []


def test_entry_points_default_to_the_card(monkeypatch):
    """prepare_cpi, run_cpi, scene_base, generate_fan_c, the device
    receiver geometry, the render's host-fed entry points, run_sweep and
    the convert functions build on "cuda" unless the caller asks for
    another device; so does the CLI."""
    from rts_tpu_torch.__main__ import main
    from rts_tpu_torch.engine.animate import scene_base
    from rts_tpu_torch.engine.fan import generate_fan_c
    from rts_tpu_torch.physics.receiver_geom import rx_sphere_geometry_device
    from rts_tpu_torch.sim.render import responses_to_map, waveform_replica
    from rts_tpu_torch.sim.sweep import run_sweep

    fns = [ts.prepare_cpi, ts.run_cpi, scene_base, generate_fan_c, convert.tensor, convert.f64,
           convert.scene_base, convert.rx_geom, convert.refine_extras, convert.pulse_batch,
           convert.lane_aggregate, convert.cpi_result, rx_sphere_geometry_device, waveform_replica,
           responses_to_map, run_sweep]
    for fn in fns:
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__qualname__
    seen = []
    monkeypatch.setattr(ts, "run", lambda world, params, **kw: seen.append(kw["device"]))
    monkeypatch.setattr(ts, "run_all_cpi", lambda world, params, **kw: seen.append(kw["device"]))
    scene = str(REPO / "examples" / "scene.xml")
    for argv in (["run", scene], ["run", scene, "--cpi"], ["run", scene, "--device", "cpu"]):
        assert main(argv) == 0
    assert seen == ["cuda", "cuda", "cpu"]


def _meshes(geom, case):
    if case == "sphere_plate":
        sphere, _ = geom.sphere_mesh(2, 50.0, yaw=0.3, roll=-0.2)
        plate = geom.rect_mesh(2.0, 150.0, 150.0, pitch=0.4).translated([300.0, 100.0, 0.0])
        return [sphere.translated([900.0, 0.0, 0.0]), plate]
    if case == "terrain_plate":
        terrain = geom.terrain_mesh(24, 3000.0, 200.0, seed=3)
        return [terrain, geom.rect_mesh(2.0, 60.0, 60.0, pitch=math.pi / 2)]
    raise ValueError(case)


@pytest.mark.parametrize("case", ["sphere_plate", "terrain_plate"])
def test_scene_and_clustering_equal(case):
    """compile_scene, morton_order and cluster_reorder give equal arrays."""
    refl, refr = [0.9, 0.7], [1.0, 1.5]
    j = j_compile_scene(_meshes(j_geom, case), refl, refr, pad_to=8)
    t = t_compile_scene(_meshes(t_geom, case), refl, refr, pad_to=8)
    for f in dataclasses.fields(j):
        np.testing.assert_array_equal(getattr(t, f.name), getattr(j, f.name), err_msg=f.name)
    n = j.num_real_tris
    np.testing.assert_array_equal(
        t_accel.morton_order(t.tri_verts[:n], t.tri_target[:n]),
        j_accel.morton_order(j.tri_verts[:n], j.tri_target[:n]),
    )
    jr = j_accel.cluster_reorder(j, cluster_size=128)
    tr = t_accel.cluster_reorder(t, cluster_size=128)
    for f in dataclasses.fields(jr):
        np.testing.assert_array_equal(getattr(tr, f.name), getattr(jr, f.name), err_msg=f.name)
    # device cluster boxes from the edge representation (min/max only)
    p0 = jr.tri_verts[:, 0].astype(np.float32)
    e0 = (jr.tri_verts[:, 1] - jr.tri_verts[:, 0]).astype(np.float32)
    e1 = (jr.tri_verts[:, 0] - jr.tri_verts[:, 2]).astype(np.float32)
    jmn, jmx = j_accel.cluster_aabbs(jnp.asarray(p0), jnp.asarray(e0), jnp.asarray(e1), 128,
                                     xp=jnp, tri_target=jnp.asarray(jr.tri_target))
    tmn, tmx = t_accel.cluster_aabbs(torch.as_tensor(p0), torch.as_tensor(e0), torch.as_tensor(e1),
                                     128, tri_target=torch.as_tensor(jr.tri_target))
    np.testing.assert_array_equal(tmn.numpy(), np.asarray(jmn))
    np.testing.assert_array_equal(tmx.numpy(), np.asarray(jmx))


def make_world(S, pulses=3):
    """Both packages' World, same scene: a moving, rotating plate, a
    sphere, a steered receiver and a second receiver."""
    w = S.World()
    w.add(S.Transmitter(path=S.Path.fixed(0, 0, 0), wave=S.RadarSignal(carrier=10e9),
                        pulse_count=pulses, prf=1000.0, tx_span=(0.1, 0.1, 0.0),
                        rotation=S.RotationPath(azimuth=0.01, azimuth_rate=0.5)))
    w.add(S.Receiver(path=S.Path.fixed(0, 0, 0), sphere=(5.0, 1.0, 1.0)))
    w.add(S.Receiver(path=S.Path.linear([(0.0, (10.0, 5.0, 0.0)), (1.0, (12.0, 5.0, 1.0))]),
                     sphere=(8.0, 1.2, 0.8), rotation=S.RotationPath(elevation=0.05)))
    w.add(S.Target(path=S.Path.linear([(0.0, (1000.0, 0.0, 0.0)), (1.0, (1040.0, 0.0, 0.0))]),
                   attitude=S.AttitudePath(yaw_rate=0.2), shape="rect", rect=(2.0, 200.0, 200.0),
                   refl_coeff=0.9))
    w.add(S.Target(path=S.Path.fixed(900, 150, 20), shape="sphere", sphere_params=(2, 30.0),
                   refl_coeff=0.7))
    return w


@pytest.mark.parametrize("refine", [False, True], ids=["f32", "refine"])
def test_prepare_cpi_state_equal_and_convert(refine):
    """The host arrays of prepare_cpi (scene, rot/pos/vel, rx geometry,
    times, tx geometry) and the config equal rts_tpu's, and convert.py
    carries rts_tpu's state over to the same tensors.  With refine=True
    the port's float64 replay state equals rts_tpu's double-single pairs
    (hi + lo) to the ds residual's own rounding, ~2^-48 relative."""
    kw = dict(preset="production", refine=refine, cluster_size=128, ray_tile=128)
    jb, jbat, jcfg, jspec = js.prepare_cpi(make_world(js), JParameters(num_rays=5, max_refl_depth=2),
                                           dtype=jnp.float32, **kw)
    tb, tbat, tcfg, tspec = ts.prepare_cpi(make_world(ts), TParameters(num_rays=5, max_refl_depth=2),
                                           device=DEVICE, **kw)
    for name, t in tb._asdict().items():
        if not name.endswith("_f64"):
            np.testing.assert_array_equal(t.numpy(), np.asarray(getattr(jb, name)), err_msg=name)
    for name, t in tbat._asdict().items():
        if name == "rx_geom":
            for g, tg in t._asdict().items():
                np.testing.assert_array_equal(tg.numpy(), np.asarray(getattr(jbat.rx_geom, g)), err_msg=g)
        elif name != "refine":
            np.testing.assert_array_equal(t.numpy(), np.asarray(getattr(jbat, name)), err_msg=name)
    assert not np.allclose(tbat.rot.numpy()[1:], np.eye(3))  # the rotation is exercised
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert convert.trace_config(jcfg) == tcfg
    cb = convert.scene_base(jb, device=DEVICE)
    cbat = convert.pulse_batch(jbat, device=DEVICE)
    f64 = [f for f in tb._fields if f.endswith("_f64")]
    assert all(torch.equal(getattr(cb, f), getattr(tb, f)) for f in tb._fields if f not in f64)
    assert all(torch.equal(a, b) for a, b in zip(cbat.rx_geom, tbat.rx_geom))
    assert all(torch.equal(a, b) for a, b in zip(cbat, tbat) if torch.is_tensor(a))
    if not refine:
        assert tbat.refine is None and cbat.refine is None
        assert all(getattr(tb, f) is None and getattr(cb, f) is None for f in f64)
        return
    pairs = [(getattr(cb, f), getattr(tb, f)) for f in f64] + list(zip(cbat.refine, tbat.refine))
    assert len(pairs) == 4 + 8
    for name, (a, b) in zip(f64 + list(tbat.refine._fields), pairs):
        assert a.dtype == b.dtype == torch.float64, name
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-13, atol=1e-13, err_msg=name)
    # the f32 state is the f64 state rounded
    np.testing.assert_array_equal(tb.tri_verts.numpy(), tb.tri_verts_f64.numpy().astype(np.float32))
    np.testing.assert_array_equal(tbat.pos.numpy(), tbat.refine.pos.numpy().astype(np.float32))
    cspec = convert.cpi_spec(jspec)
    assert cspec._replace(rx_rotation_fns=()) == tspec._replace(rx_rotation_fns=())
    t = torch.linspace(0.0, 0.01, 5)
    for f, g in zip(cspec.rx_rotation_fns, tspec.rx_rotation_fns):
        for a, b in zip(f(t), g(t)):
            assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))


@pytest.mark.parametrize(
    "options",
    [
        dict(preset="production", rx_geom_on_device=True),
        dict(preset="production", refraction=True, rx_geom_on_device=True),
        dict(accel="brute", refraction=True, rx_geom_on_device=True),
        dict(preset="parity", rx_geom_on_device=True),
        dict(preset="production", fan_order="morton2", rx_geom_on_device=True),
    ],
    ids=["rx_geom_on_device", "refraction", "brute", "strict_parity", "fan_order"],
)
def test_prepare_cpi_refuses_unported(options):
    """On-device receiver geometry with each option, against rts_tpu.  The
    name dates from when the port refused these: with the production
    preset (refine=True) both packages refuse, with a ValueError; the
    brute-force and parity engines prepare, and their batches equal
    rts_tpu's (the geometry to a few float32 ulp: each library's trig)."""
    options = dict(options)
    refraction = options.pop("refraction", False)
    params = dict(num_rays=3, max_refl_depth=1, max_refr_depth=2 if refraction else 0)
    if options.get("preset") == "production":
        for S, P, kw in ((js, JParameters, dict(dtype=jnp.float32)), (ts, TParameters, dict(device=DEVICE))):
            with pytest.raises(ValueError, match="rx_geom_on_device=True is incompatible with refine=True"):
                S.prepare_cpi(make_world(S, pulses=1), P(**params), **kw, **options)
        return
    jbase, jbat, jcfg, _ = js.prepare_cpi(make_world(js), JParameters(**params), dtype=jnp.float32, **options)
    tbase, tbat, tcfg, _ = ts.prepare_cpi(make_world(ts), TParameters(**params), device=DEVICE, **options)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.strict_parity == (options.get("preset") == "parity") and tcfg.accel == "brute"
    for name, t in tbase._asdict().items():
        if t is not None:
            np.testing.assert_array_equal(t.numpy(), np.asarray(getattr(jbase, name)), err_msg=name)
    for name, t in tbat._asdict().items():
        if name == "rx_geom":
            for g, tg in t._asdict().items():
                assert tg.dtype == torch.float32, g
                np.testing.assert_allclose(tg.numpy(), np.asarray(getattr(jbat.rx_geom, g)), rtol=2e-6,
                                           atol=2e-6, err_msg=g)
        elif name != "refine":
            np.testing.assert_array_equal(t.numpy(), np.asarray(getattr(jbat, name)), err_msg=name)
    assert tbat.refine is None


def test_iso_models_match_rts_tpu():
    rng = np.random.default_rng(0)
    az, el = rng.normal(size=(2, 3, 7)).astype(np.float32)
    j = js.world.IsotropicAntenna().gain(jnp.asarray(az), jnp.asarray(el), 0.1, 0.2, 0.03)
    t = t_antenna.IsotropicAntenna().gain(torch.as_tensor(az), torch.as_tensor(el), 0.1, 0.2, 0.03)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert t.dtype == torch.float32
    from rts_tpu.physics.rcs import IsoRCS as JIsoRCS

    j = JIsoRCS(sigma=2.5).rcs(jnp.asarray(az), jnp.asarray(el), 0.03)
    t = t_rcs.IsoRCS(sigma=2.5).rcs(torch.as_tensor(az), torch.as_tensor(el), 0.03)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize(
    "model",
    [t_antenna.SincAntenna(), t_antenna.GaussianAntenna(), t_antenna.SquareHornAntenna(),
     t_antenna.ParabolicAntenna(), t_antenna.TableAntenna((0.0, 1.0), (1.0, 0.5)),
     t_rcs.SphereRCS(), t_rcs.PlateRCS(), t_rcs.TableRCS((0.0, 1.0), (0.0, 1.0), ((1, 1), (1, 1)))],
    ids=lambda m: type(m).__name__,
)
def test_unported_models_raise(model):
    """Each model with its default parameters against rts_tpu's on seeded
    float64 angles, within 1e-10 of the peak.  The name dates from when
    the port's models raised; tests/test_torch_physics.py holds them at
    the scenes' parameters in both types."""
    import rts_tpu.physics.antenna as j_antenna
    import rts_tpu.physics.rcs as j_rcs

    rng = np.random.default_rng(4)
    a, b = rng.uniform(-2.0, 2.0, (2, 64))
    jmod = j_antenna if hasattr(model, "gain") else j_rcs
    ref = getattr(jmod, type(model).__name__)(**dataclasses.asdict(model))
    if hasattr(model, "gain"):
        got = model.gain(torch.as_tensor(a), torch.as_tensor(b), 0.1, -0.2, 0.03)
        want = np.asarray(ref.gain(jnp.asarray(a), jnp.asarray(b), 0.1, -0.2, 0.03))
    else:
        got = model.rcs(torch.as_tensor(a), torch.as_tensor(b), 0.03)
        want = np.asarray(ref.rcs(jnp.asarray(a), jnp.asarray(b), 0.03))
    assert got.dtype == torch.float64 and got.shape == want.shape
    assert np.abs(got.numpy() - want).max() <= 1e-10 * np.abs(want).max()
