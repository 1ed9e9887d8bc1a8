"""The port's bench (``python -m rts_tpu_torch.bench``) against the repo's
``bench.py``, on the CPU at small sizes.

``bench.py`` is run as it stands: its ``main`` with ``build`` and the
trace stubbed records the arguments each leg builds (the CLI, ``--tiny``
and the cpi256 leg's overrides); its ``build`` runs with
``rts_tpu.sim.prepare_cpi`` wrapped to record the world, the parameters
and the options, and to run the Pallas traversal in interpret mode.

For each of the four scenes (terrain and dielectric at ``--tris 2000``,
moving at 4000, sphere at 1280; ``--rays 5 --pulses 2``) the port's world
equals bench.py's bit for bit (every field of every transmitter,
receiver and target, the moving spheres' float32-placed centres
included, and each target's mesh; bench.py's dielectric forward receiver
moved to the port's 600 m, ``FORWARD_RX``), its ``prepare_cpi`` options
equal bench.py's, and the two CPIs built from them hold the same tensors.  The
traced CPIs agree in every discrete output (received lanes, the chains'
triangles, path rows, emit, npath, path_match); continuous outputs are
held to the tolerances that tests/test_torch_cpi.py states: delay rtol
1e-5, power rtol 5e-5, Doppler rtol 1e-5 (atol 1e-6), and the phase on
lanes whose delay agrees bit for bit to 1e-5 rad.
"""

import argparse
import dataclasses
import importlib.util
import math
import os
import sys
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rts_tpu.engine.cpi as jcpi
import rts_tpu.sim as js
from rts_tpu.engine.cpi import make_pulse_fn as j_make_pulse_fn

import rts_tpu_torch.bench as tbench
from rts_tpu_torch import convert
from rts_tpu_torch.engine.cpi import make_pulse_fn, pulse_args

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(__file__), "..")
SIZES = {"terrain": 2000, "dielectric": 2000, "moving": 4000, "sphere": 1280}
# The port's one departure from bench.py's worlds: the dielectric scene's
# forward receiver at 600 m, where bench.py has it at 100 m, inside the
# terrain's heights under the slab.  The parity of the CPIs and traces is
# taken with bench.py's receiver moved there too.
FORWARD_RX = {"dielectric": (100.0, 600.0)}


def _load_bench_py():
    spec = importlib.util.spec_from_file_location("bench_py", os.path.join(ROOT, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JBENCH = _load_bench_py()


def _argv(scene):
    return ["--scene", scene, "--tris", str(SIZES[scene]), "--rays", "5", "--pulses", "2"]


class _Cfg(NamedTuple):
    rays_per_fan: int = 27
    num_segments: int = 4
    refine: bool = False
    replay_cap: int = 0


class _Out(NamedTuple):
    power: object
    received: object


def _jax_legs(monkeypatch, argv):
    """The args of every build() call of bench.py's main for ``argv``, the
    traces stubbed."""
    legs = []

    def build(args):
        legs.append(vars(args).copy())
        return None, None, _Cfg(), None, 320

    monkeypatch.setattr(JBENCH, "build", build)
    monkeypatch.setattr(jcpi, "trace_cpi", lambda *a: _Out(jnp.ones(3), jnp.zeros((2, 27), jnp.int32)))
    monkeypatch.setattr(jax.config, "update", lambda *a, **k: None)  # bench.py sets its compile cache
    monkeypatch.setattr(sys, "argv", ["bench.py", *argv])
    JBENCH.main()
    return legs


def _port_legs(monkeypatch, argv):
    legs = []

    def build(args):
        legs.append(vars(args).copy())
        return None, None, _Cfg(), None, 320

    monkeypatch.setattr(tbench, "build", build)
    monkeypatch.setattr(tbench, "trace_cpi", lambda *a: _Out(torch.ones(3), torch.zeros((2, 27), dtype=torch.int32)))
    record = tbench.main([*argv, "--device", "cpu"])
    for leg in legs:
        assert leg.pop("device") == torch.device("cpu")
    return legs, record


@pytest.mark.parametrize("argv", [
    [],
    ["--tiny"],
    ["--scene", "moving"],
    ["--scene", "dielectric", "--ray-tile", "256", "--replay-cap", "32", "--no-mt-union"],
    ["--scene", "sphere", "--candidates", "0", "--agg-cap", "0", "--resident-cap", "64", "--no-cpi256"],
], ids=["defaults", "tiny", "moving", "dielectric-flags", "sphere-flags"])
def test_cli_and_cpi256_leg_match_bench_py(monkeypatch, capsys, argv):
    """Every flag and default of bench.py, --tiny's overrides and the
    cpi256 leg's (31^3, 256 pulses, the terrain knobs only off the shell
    scenes, the caps unless set): each build() sees the same arguments."""
    jlegs = _jax_legs(monkeypatch, argv)
    tlegs, record = _port_legs(monkeypatch, argv)
    assert tlegs == jlegs
    assert len(jlegs) == (1 if "--tiny" in argv or "--no-cpi256" in argv else 2)
    assert set(record) == {"metric", "value", "unit", "device"} | ({"cpi256_seconds"} if len(jlegs) == 2 else set())
    assert record["device"] == "cpu"


@pytest.fixture(scope="module")
def built():
    """Per scene, bench.py's and the port's (world, params, options, state)."""
    cache = {}

    def get(scene):
        if scene in cache:
            return cache[scene]
        jcalls, tcalls = [], []
        real_j, real_t = js.prepare_cpi, tbench.prepare_cpi

        def j_recording(w, params, **kw):
            if scene in FORWARD_RX:
                old, new = FORWARD_RX[scene]
                assert w.receivers[1].path == js.Path.fixed(0.0, 0.0, old)
                w.receivers[1].path = js.Path.fixed(0.0, 0.0, new)
            jcalls.append((w, params, dict(kw)))
            return real_j(w, params, interpret=True, **kw)

        def t_recording(w, params, **kw):
            tcalls.append((w, params, dict(kw)))
            return real_t(w, params, **kw)

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(js, "prepare_cpi", j_recording)
            mp.setattr(tbench, "prepare_cpi", t_recording)
            jstate = JBENCH.build(_bench_py_args(scene))[:4]
            tstate = tbench.build(tbench.parse_args([*_argv(scene), "--device", "cpu"]))[:4]
        (jw, jp, jkw), = jcalls
        (tw, tp, tkw), = tcalls
        cache[scene] = dict(j=(jw, jp, jkw, jstate), t=(tw, tp, tkw, tstate))
        return cache[scene]

    return get


def _bench_py_args(scene):
    """bench.py's parsed args for the scene's argv (its own parser)."""
    with pytest.MonkeyPatch.context() as mp:
        return argparse.Namespace(**_jax_legs(mp, [*_argv(scene), "--no-cpi256"])[0])


def _same(a, b, where: str) -> None:
    """Bit-for-bit equality of two worlds' parts, the JAX package's and the
    port's classes taken by name."""
    assert type(a).__name__ == type(b).__name__, where
    if dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            _same(getattr(a, f.name), getattr(b, f.name), f"{where}.{f.name}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes(), where
    elif isinstance(a, float):
        assert np.float64(a).tobytes() == np.float64(b).tobytes(), (where, a, b)
    elif isinstance(a, (bool, int, str, type(None))):
        assert a == b, (where, a, b)
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _same(a[k], b[k], f"{where}.{k}")
    else:  # a physics model or waveform object
        _same(vars(a), vars(b), where)


@pytest.mark.parametrize("scene", list(SIZES))
def test_world_matches_bench_py(built, scene):
    (jw, jp, _, _), (tw, tp, _, _) = built(scene)["j"], built(scene)["t"]
    for kind in ("transmitters", "receivers", "targets"):
        _same(getattr(jw, kind), getattr(tw, kind), kind)
    for i, (a, b) in enumerate(zip(jw.targets, tw.targets)):
        _same(a.base_mesh(), b.base_mesh(), f"targets[{i}] mesh")
    assert dataclasses.asdict(jp) == dataclasses.asdict(tp)
    if scene == "moving":  # the four centres, placed on the float32 3^3 fan's nodes
        assert len(tw.targets) == 4 and all(t.path.interp == "linear" for t in tw.targets)


@pytest.mark.parametrize("scene", list(SIZES))
def test_prepare_cpi_matches_bench_py(built, scene):
    """The same options, and CPI states equal tensor for tensor (the f64
    replay state to the double-single pairs' ~2^-48 precision)."""
    (_, _, jkw, (jb, jbat, jcfg, jspec)), (_, _, tkw, (tb, tbat, tcfg, tspec)) = built(scene)["j"], built(scene)["t"]
    assert jkw.pop("dtype") is jnp.float32 and tkw.pop("dtype") is torch.float32
    assert tkw.pop("device") == "cpu"
    assert jkw == tkw
    assert tcfg == dataclasses.replace(convert.trace_config(jcfg), interpret=False)
    cb, cbat = convert.scene_base(jb, device="cpu"), convert.pulse_batch(jbat, device="cpu")
    for name in tb._fields:
        a, b = getattr(tb, name), getattr(cb, name)
        if name.endswith("_f64"):
            torch.testing.assert_close(a, b, rtol=1e-14, atol=0, msg=name)
        elif a is not None:
            assert torch.equal(a, b), name
    for name in tbat._fields:
        if name == "refine":
            for f, a, b in zip(tbat.refine._fields, tbat.refine, cbat.refine):
                torch.testing.assert_close(a, b, rtol=1e-14, atol=1e-300, msg=f)
        elif name == "rx_geom":
            assert all(torch.equal(a, b) for a, b in zip(tbat.rx_geom, cbat.rx_geom))
        else:
            assert torch.equal(getattr(tbat, name), getattr(cbat, name)), name
    assert tspec.tx_span == tuple(jspec.kwargs()["tx_span"]) and tspec.num_rx == jspec.kwargs()["num_rx"]


@partial(jax.jit, static_argnames=("cfg", "spec"))
def _j_trace(base, batch, cfg, spec):
    """rts_tpu's trace_cpi, with each pulse's path rows and chains."""
    one_pulse, aggregate = j_make_pulse_fn(base, cfg, **spec.kwargs())

    def full(rot, pos, vel, rxg, rxp, txo, txd, t, refine=None):
        res, power, doppler, delay = one_pulse(rot, pos, vel, rxg, rxp, txo, txd, t, refine)
        return aggregate(res, power, doppler, delay), res.path, res.tri_seq

    return jcpi.map_pulses(full, batch, cfg)


@pytest.mark.parametrize("scene", list(SIZES))
def test_trace_matches_rts_tpu(built, scene):
    jstate, (base, batch, cfg, spec) = built(scene)["j"][3], built(scene)["t"][3]
    ref, ref_path, ref_seq = _j_trace(*jstate)
    one_pulse, aggregate = make_pulse_fn(base, cfg, spec)
    outs, paths, seqs = [], [], []
    for p in range(batch.times.shape[0]):
        res, power, doppler, delay = one_pulse(*pulse_args(batch, p))
        outs.append(aggregate(res, power, doppler, delay))
        paths.append(res.path)
        seqs.append(res.tri_seq)
    rec = np.asarray(ref.received)
    f = rec >= 0
    assert f.sum(axis=1).min() >= 1  # every pulse receives
    np.testing.assert_array_equal(torch.stack([o.received for o in outs]).numpy(), rec)
    np.testing.assert_array_equal(torch.stack(seqs).numpy(), np.asarray(ref_seq), err_msg="tri_seq")
    np.testing.assert_array_equal(torch.stack(paths).numpy(), np.asarray(ref_path), err_msg="path rows")
    got = lambda name: torch.stack([getattr(o, name) for o in outs]).numpy()
    gagg = lambda name: torch.stack([getattr(o.agg, name) for o in outs]).numpy()
    for name in ("emit", "npath", "path_match"):
        np.testing.assert_array_equal(gagg(name), np.asarray(getattr(ref.agg, name)), err_msg=name)
    np.testing.assert_allclose(got("delay")[f], np.asarray(ref.delay)[f], rtol=1e-5)
    np.testing.assert_allclose(got("power")[f], np.asarray(ref.power)[f], rtol=5e-5)
    np.testing.assert_allclose(got("doppler")[f], np.asarray(ref.doppler)[f], rtol=1e-5, atol=1e-6)
    e = np.asarray(ref.agg.emit)
    for name, rtol in (("delay", 1e-5), ("power", 5e-5), ("doppler", 1e-5)):
        np.testing.assert_allclose(gagg(name)[e], np.asarray(getattr(ref.agg, name))[e],
                                   rtol=rtol, atol=1e-6, err_msg=name)
    same_len = e & (gagg("delay") == np.asarray(ref.agg.delay))
    phase = gagg("phase").astype(np.float64) + gagg("phase_lo").astype(np.float64)
    ref_phase = np.asarray(ref.agg.phase, np.float64) + np.asarray(ref.agg.phase_lo, np.float64)
    d = np.abs(phase - ref_phase)[same_len]
    assert same_len.any() and np.minimum(d, 2 * math.pi - d).max() < 1e-5


def test_tiny_end_to_end(capsys):
    record = tbench.main(["--tiny", "--device", "cpu"])
    assert set(record) == {"metric", "value", "unit", "device"}  # no vs_baseline, no cpi256
    assert record["metric"] == "rays_per_sec_per_chip" and record["unit"] == "rays/s"
    assert record["device"] == "cpu" and math.isfinite(record["value"]) and record["value"] > 0
    err = capsys.readouterr().err
    assert "320 tris, 27 rays/pulse x 2 pulses" in err
    assert int(err.split(", received ")[1].split(",")[0]) > 0


def test_stats_prints_the_traversal_line(capsys):
    tbench.main(["--scene", "terrain", "--tris", "2000", "--rays", "5", "--pulses", "2", "--repeat", "1",
                 "--no-cpi256", "--stats", "--device", "cpu"])
    err = capsys.readouterr().err
    line = next(ln for ln in err.splitlines() if ln.startswith("# traversal stats (segment 1): "))
    assert "tiles, groups visited/tile mean" in line and "clusters processed/tile mean" in line
    assert "# replay: received lanes a pulse" in err


def test_refuses_without_cuda(monkeypatch):
    """No fallback: without a card and without --device cpu it exits non-zero."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        tbench.main(["--tiny"])
    assert exc.value.code not in (0, None)


@pytest.mark.parametrize("name", ["bench.py", "contract.py"])
def test_imports_neither_jax_nor_rts_tpu(name):
    with open(os.path.join(ROOT, "rts_tpu_torch", name)) as fh:
        imports = [ln.split()[1] for ln in fh if ln.lstrip().startswith(("import ", "from "))]
    assert imports and not any(m == "jax" or m.startswith(("jax.", "rts_tpu.")) or m == "rts_tpu"
                               for m in imports), imports
