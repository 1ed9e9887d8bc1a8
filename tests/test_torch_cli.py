"""The port's scene-file front end against rts_tpu's: config_io, export,
the CLI, run_sweep, utils/ and vectypes.

Worlds loaded by both packages must be equal field for field; the CLI's
printed counts and the saved responses' discrete fields equal, their
floats within 1e-9 relative and the phase within 1e-8 rad (both run the
f64 sequential driver); the port's
clustered CPI with the f64 replay within the reference's 1e-6 power/phase
contract of the f64 driver.
"""

import dataclasses
import json
import pathlib

import numpy as np
import pytest
import torch

import rts_tpu.core.vectypes as jv
import rts_tpu.geometry as j_geom
import rts_tpu.sim.config_io as jc
import rts_tpu.sim.export as je
import rts_tpu.utils as ju
from rts_tpu import Parameters as JParameters
from rts_tpu.__main__ import main as j_main
from rts_tpu.geometry.scene import compile_scene as j_compile_scene
from rts_tpu.sim.sweep import SweepCase as JSweepCase
from rts_tpu.sim.sweep import run_sweep as j_run_sweep

import rts_tpu_torch.core.vectypes as tv
import rts_tpu_torch.geometry as t_geom
import rts_tpu_torch.sim as ts
import rts_tpu_torch.sim.config_io as tc
import rts_tpu_torch.sim.export as te
import rts_tpu_torch.utils as tu
from rts_tpu_torch import Parameters as TParameters
from rts_tpu_torch.__main__ import main as t_main
from rts_tpu_torch.geometry.scene import compile_scene as t_compile_scene
from rts_tpu_torch.sim.sweep import SweepCase, run_sweep

import rts_tpu.sim as js
from test_config_io import DOC, XML_DOC
from test_torch_driver import plate_world

torch.set_num_threads(1)

DEVICE = "cpu"
SCENE_XML = pathlib.Path(__file__).resolve().parents[1] / "examples" / "scene.xml"
TOML_DOC = """
[parameters]
num_rays = 1
max_refl_depth = 2

[[transmitters]]
name = "tx0"
position = [0, 0, 0]
pulse_count = 1
prf = 1000.0
tx_span = [0.1, 0.1, 0.0]
wave = { carrier = 10e9, temperature = 30.0 }
antenna = { type = "parabolic", diameter = 0.5 }

[[receivers]]
name = "rx0"
position = [0, 0, 0]
sphere = [5.0, 1.0, 1.0]
noise_temperature = 70.0
antenna = { type = "table", angles = [0.0, 0.1, 1.0], gains = [3.0, 2.0, 0.1] }

[[targets]]
name = "plate"
shape = "rect"
rect = [2.0, 200.0, 200.0]
position = [1000, 0, 0]
refl_coeff = 0.9
rcs = { type = "table", az_grid = [-3.0, 0.0, 3.0], el_grid = [-1.0, 1.0], table = [[1, 2, 3], [4, 5, 6]] }

[[targets]]
shape = "sphere"
sphere = [1, 5.0]
waypoints = [[0.0, [900, 0, 0]], [1.0, [950, 0, 0]]]
interp = "cubic"
attitude = { yaw_rate = 0.5 }
rcs = { type = "plate", width = 2.0, height = 3.0 }
"""


def plain(x):
    """A World (dataclasses all the way down) as nested (class name,
    fields) tuples and lists, for equality across the two packages."""
    if dataclasses.is_dataclass(x):
        return type(x).__name__, {f.name: plain(getattr(x, f.name)) for f in dataclasses.fields(x)}
    if isinstance(x, (list, tuple)):
        return [plain(y) for y in x]
    if isinstance(x, np.ndarray):
        return x.tolist()
    return x


@pytest.mark.parametrize("doc", ["dict", "xml", "json", "toml", "scene.xml"])
def test_config_io_builds_the_same_world(doc, tmp_path):
    if doc == "dict":
        (jw, jp), (tw, tp) = jc.world_from_dict(DOC), tc.world_from_dict(DOC)
    elif doc == "xml":
        (jw, jp), (tw, tp) = jc.world_from_xml(XML_DOC), tc.world_from_xml(XML_DOC)
    else:
        path = {"json": tmp_path / "scene.json", "toml": tmp_path / "scene.toml", "scene.xml": SCENE_XML}[doc]
        if doc == "json":
            path.write_text(json.dumps(DOC))
        elif doc == "toml":
            path.write_text(TOML_DOC)
        (jw, jp), (tw, tp) = jc.load_world(str(path)), ts.load_world(str(path))
    assert dataclasses.asdict(tp) == dataclasses.asdict(jp)
    assert plain(tw) == plain(jw)
    assert type(tw) is ts.World and type(tp) is TParameters
    assert tw.targets and all(type(t.rcs_model).__module__ == "rts_tpu_torch.physics.rcs" for t in tw.targets)
    (tmp_path / "scene.yaml").write_text("parameters: {}")
    with pytest.raises(ValueError, match="unsupported config format"):
        tc.load_world(str(tmp_path / "scene.yaml"))


def test_config_io_refuses_unknown_models():
    for key, spec, what in (("transmitters", {"antenna": {"type": "dipole"}}, "antenna"),
                            ("targets", {"rcs": {"type": "cone"}}, "rcs")):
        doc = json.loads(json.dumps(DOC))
        doc[key][0].update(spec)
        for mod in (jc, tc):
            with pytest.raises(ValueError, match=f"unknown {what} type"):
                mod.world_from_dict(doc)


def run_both_clis(tmp_path, capsys, scene, *args):
    """rts_tpu's and the port's CLI on the same arguments (the port on the
    CPU): their printed lines, the saved file's path last."""
    out = []
    for name, main, extra in (("jax", j_main, []), ("port", t_main, ["--device", DEVICE])):
        npz = str(tmp_path / f"{name}.npz") if args and args[0] == "run" else None
        argv = list(args) + [str(scene)] + (["--out", npz] if npz else []) + (extra if npz else [])
        assert main(argv) == 0
        out.append((capsys.readouterr().out.replace(npz or "\0", "OUT"), npz))
    return out


def test_cli_info_prints_the_same(tmp_path, capsys):
    scene = tmp_path / "scene.json"
    scene.write_text(json.dumps(DOC))
    for path in (scene, SCENE_XML):
        (j_out, _), (t_out, _) = run_both_clis(tmp_path, capsys, path, "info")
        assert t_out == j_out and "transmitters (1)" in t_out


def _sorted(data):
    order = np.lexsort((data["delay"], data["time"], data["rx_index"]))
    return {k: (v[order] if isinstance(v, np.ndarray) and v.shape[:1] == order.shape else v)
            for k, v in data.items()}


@pytest.mark.parametrize("scene", ["doc", "scene.xml"])
def test_cli_run_matches_rts_tpu(scene, tmp_path, capsys):
    """The default run (the f64 sequential driver) through both CLIs: the
    same counts printed, and the saved responses equal (floats within
    1e-9 relative, the phase within 1e-8 rad)."""
    path = SCENE_XML
    if scene == "doc":
        path = tmp_path / "scene.json"
        path.write_text(json.dumps(DOC))
    (j_out, j_npz), (t_out, t_npz) = run_both_clis(tmp_path, capsys, path, "run")
    assert t_out == j_out and "responses: " in t_out and "responses: 0" not in t_out
    jd, td = _sorted(je.load_responses(j_npz)), _sorted(te.load_responses(t_npz))
    assert sorted(td) == sorted(jd)
    for k in ("rx_index", "tx_name", "carrier", "noise_temperature", "meta"):
        assert np.array_equal(td[k], jd[k]) if k != "meta" else td[k] == jd[k], k
    for k in ("power", "time", "delay", "doppler"):
        np.testing.assert_allclose(td[k], jd[k], rtol=1e-9, atol=0, err_msg=k)
    # the phase is 2 pi L / lambda reduced mod 2 pi, ~4e5 rad at 2 km: an
    # ulp of an f64 path length is ~1e-10 rad (measured 1.3e-9 rad apart on
    # the radome's refracted chains)
    np.testing.assert_allclose(td["phase"], jd["phase"], rtol=0, atol=1e-8)


def test_cli_cpi_paths_hold_the_contract(tmp_path, capsys):
    """examples/scene.xml (Gaussian Tx, dielectric radome, two receivers)
    through the port's CLI on the CPU: --cpi with the f64 replay, brute
    force and clustered, print rts_tpu's driver's counts, and their
    responses meet the 1e-6 power/phase contract against the port's f64
    driver."""
    assert t_main(["run", str(SCENE_XML), "--out", str(tmp_path / "ref.npz"), "--device", DEVICE]) == 0
    ref_out = capsys.readouterr().out.replace(str(tmp_path / "ref.npz"), "OUT")
    ref = _sorted(te.load_responses(str(tmp_path / "ref.npz")))
    for accel in ("brute", "cluster"):
        npz = str(tmp_path / f"{accel}.npz")
        assert t_main(["run", str(SCENE_XML), "--cpi", "--accel", accel, "--refine", "--out", npz,
                       "--device", DEVICE]) == 0
        assert capsys.readouterr().out.replace(npz, "OUT") == ref_out
        got = _sorted(te.load_responses(npz))
        np.testing.assert_array_equal(got["rx_index"], ref["rx_index"])
        np.testing.assert_allclose(got["power"], ref["power"], rtol=1e-6, atol=0)
        dphi = np.abs(got["phase"] - ref["phase"]) % (2 * np.pi)
        assert np.minimum(dphi, 2 * np.pi - dphi).max() < 1e-6, accel


@pytest.mark.parametrize("ext", ["npz", "h5"])
def test_export_round_trips_and_matches_rts_tpu(ext, tmp_path):
    if ext == "h5" and not je.HAVE_HDF5:
        pytest.skip("h5py not in image")
    params = dict(num_rays=3, max_refl_depth=2)
    worlds = [plate_world(S, num_pulses=2, target_speed=40.0) for S in (js, ts)]
    js.run(worlds[0], JParameters(**params))
    ts.run(worlds[1], TParameters(**params), device=DEVICE)
    jp, tp = str(tmp_path / f"j.{ext}"), str(tmp_path / f"t.{ext}")
    je.save_responses(jp, worlds[0])
    te.save_responses(tp, worlds[1])
    jd, td = je.load_responses(jp), te.load_responses(tp)
    assert sorted(td) == sorted(jd) and td["meta"] == jd["meta"]
    assert td["power"].shape[0] > 0
    for k in ("rx_index", "tx_name", "carrier", "noise_temperature"):
        np.testing.assert_array_equal(td[k], jd[k], err_msg=k)
    for k in ("power", "time", "delay", "doppler", "phase"):
        np.testing.assert_allclose(td[k], jd[k], rtol=1e-9, atol=1e-12, err_msg=k)
    # a traced CPI: the same keys (agg_phase_lo included), the same lanes
    import jax.numpy as jnp
    from rts_tpu.engine.cpi import trace_cpi as j_trace_cpi
    from rts_tpu_torch.engine.cpi import trace_cpi as t_trace_cpi

    worlds = [plate_world(S, num_pulses=2, target_speed=40.0) for S in (js, ts)]
    jst = js.prepare_cpi(worlds[0], JParameters(**params), dtype=jnp.float64)
    tst = ts.prepare_cpi(worlds[1], TParameters(**params), dtype=torch.float64, device=DEVICE)
    je.save_cpi(jp, j_trace_cpi(*jst), times=jst[1].times)
    te.save_cpi(tp, t_trace_cpi(*tst), times=tst[1].times)
    jd, td = je.load_cpi(jp), te.load_cpi(tp)
    assert sorted(td) == sorted(jd) and "agg_phase_lo" in td
    for k in jd:
        assert td[k].dtype == jd[k].dtype and td[k].shape == jd[k].shape, k
        if td[k].dtype.kind in "biu":
            np.testing.assert_array_equal(td[k], jd[k], err_msg=k)
        else:
            np.testing.assert_allclose(td[k], jd[k], rtol=1e-9, atol=1e-9, err_msg=k)


def test_export_h5_needs_h5py(tmp_path, monkeypatch):
    monkeypatch.setattr(te, "HAVE_HDF5", False)
    w = plate_world(ts)
    with pytest.raises(RuntimeError, match="h5py not available"):
        te.save_responses(str(tmp_path / "r.h5"), w)
    with pytest.raises(RuntimeError, match="h5py not available"):
        te.load_cpi(str(tmp_path / "r.hdf5"))


def _cases(S, P, n):
    def mk(speed):
        return lambda: (plate_world(S, target_speed=speed), P(num_rays=1, max_refl_depth=2))

    return [(JSweepCase if S is js else SweepCase)(name=f"v{k}", build=mk(float(10 * k))) for k in range(n)]


def test_run_sweep_shards_resumes_and_matches_rts_tpu(tmp_path):
    cases = _cases(ts, TParameters, 4)
    out = str(tmp_path / "port")
    r0 = run_sweep(cases, out, shard=(0, 2), device=DEVICE)
    assert r0.completed == ["v0", "v2"]
    r1 = run_sweep(cases, out, shard=(1, 2), device=DEVICE)
    assert r1.completed == ["v1", "v3"]
    r2 = run_sweep(cases, out, shard=(0, 1), device=DEVICE)
    assert r2.completed == [] and sorted(r2.skipped) == ["v0", "v1", "v2", "v3"]
    r3 = run_sweep(cases[3:], out, overwrite=True, device=DEVICE)
    assert r3.completed == ["v3"]
    data = te.load_cpi(f"{out}/v3.npz")
    assert (data["received"] >= 0).sum() > 0 and "times" in data
    ref = j_run_sweep(_cases(js, JParameters, 4)[3:], str(tmp_path / "jax"))
    assert ref.completed == ["v3"]
    jd = je.load_cpi(str(tmp_path / "jax" / "v3.npz"))
    assert sorted(data) == sorted(jd)
    np.testing.assert_array_equal(data["received"], jd["received"])
    np.testing.assert_allclose(data["agg_power"], jd["agg_power"], rtol=1e-5)
    with pytest.raises(TypeError, match="make_mesh"):  # the split itself: tests/test_torch_sharding.py
        run_sweep(cases, out, mesh=object(), device=DEVICE)


def test_validate_messages_match_rts_tpu():
    for G, compile_scene, U in ((j_geom, j_compile_scene, ju), (t_geom, t_compile_scene, tu)):
        mesh, _ = G.sphere_mesh(2, 5.0)
        assert U.validate_scene(compile_scene([mesh], [0.9], [1.0])) == []
    msgs = []
    for G, compile_scene, U, S, P in ((j_geom, j_compile_scene, ju, js, JParameters),
                                      (t_geom, t_compile_scene, tu, ts, TParameters)):
        got = []
        mesh, _ = G.sphere_mesh(1, 5.0)
        scene = compile_scene([mesh], [0.9], [1.0])
        scene.tri_verts[0, 0, 0] = np.nan
        for fn in (lambda: U.validate_scene(scene),
                   lambda: U.validate_scene(compile_scene([mesh], [0.9], [-1.0])),
                   lambda: U.validate_scene(compile_scene([mesh, mesh], [1.5, 0.9], [1.0, 1.0]), strict=True)):
            with pytest.raises(U.SceneValidationError) as err:
                fn()
            got.append(str(err.value))
        got.append(U.validate_scene(compile_scene([mesh], [1.5], [1.0])))
        w = plate_world(S)
        got += [U.validate_world(w, P(num_rays=3)), U.validate_world(w, P(num_rays=4))]
        w.receivers[0].sphere = (0.0, 1.0, 1.0)
        w2 = plate_world(S)
        w2.transmitters = []
        w3 = plate_world(S)
        w3.targets = []
        got.append(U.validate_world(w3, P()))
        for world in (w, w2):
            with pytest.raises(U.SceneValidationError) as err:
                U.validate_world(world, P())
            got.append(str(err.value))
        msgs.append(got)
    assert msgs[1] == msgs[0]
    assert any("boresight" in m for m in msgs[1][5]) and "refractive" in msgs[1][1]


def test_vectypes_match_rts_tpu():
    a, b = (1.5, -2.0, 0.25), (0.3, 4.0, -1.0)
    for ops in (lambda V: V.Vec3(*a) + V.Vec3(*b), lambda V: V.Vec3(*a) - V.Vec3(*b),
                lambda V: V.Vec3(*a) * 2.5, lambda V: 2.5 * V.Vec3(*a), lambda V: V.Vec3(*a) / 4.0,
                lambda V: -V.Vec3(*a), lambda V: V.Vec3(*a).cross(V.Vec3(*b)),
                lambda V: V.svec3(V.Vec3(*a)).to_cartesian(), lambda V: V.d3_to_v3(np.array(b))):
        assert ops(tv).tuple() == ops(jv).tuple()
    assert tv.Vec3(*a) * tv.Vec3(*b) == jv.Vec3(*a) * jv.Vec3(*b)
    assert tv.Vec3(*a).length == jv.Vec3(*a).length
    assert dataclasses.astuple(tv.svec3(b)) == dataclasses.astuple(jv.svec3(b))
    assert dataclasses.astuple(tv.SVec3.from_cartesian(tv.Vec3())) == (0.0, 0.0, 0.0)
