"""The pulse x ray split of a CPI (``rts_tpu_torch.parallel``) on the CPU,
over gloo ranks spawned by ``torch.multiprocessing``, against the port's
``trace_cpi`` and ``rts_tpu``'s ``trace_cpi_sharded`` on conftest's 8
virtual CPU devices.

A spawned rank re-imports this module, so only ``torch``, ``numpy`` and
``rts_tpu_torch`` are imported at module level: ``rts_tpu`` (and jax) is
imported inside the test functions, in the parent process only.  One
spawn of 4 ranks serves this module: every case on the meshes (4, 1),
(2, 2) and (1, 4).  ``tests/test_torch_sharding_caps.py`` runs the (1, 3)
mesh with the caps firing, the divisibility errors and
``run_sweep(mesh=...)`` on 3 ranks with this module's rank worker.

Against the port's ``trace_cpi`` the split is held bit for bit: every
field of the ``CpiResult``.  Against ``rts_tpu`` the discrete outputs are
held equal and the continuous ones to the tolerances of
``tests/test_torch_cpi.py`` (XLA contracts a*b + c into FMAs under jit on
the CPU; the port rounds every product).  The port's CPU brute-force
intersector contracts through the CPU's BLAS, which rounds a block's
leftover rows (fewer than ~4) through another micro-kernel than full
ones; so its fans here split into blocks of whole multiples of 8 lanes
(8^3 into 128 and 256).  The clustered traversal has no BLAS, and its
15^3 fan splits into three blocks of 1,125.
"""

from __future__ import annotations

import os
import warnings

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import rts_tpu_torch.sim as ts
from rts_tpu_torch import Parameters as TParameters
from rts_tpu_torch.engine.cpi import make_pulse_fn, pulse_args, trace_cpi
from rts_tpu_torch.engine.wavefront import TraceResult
from rts_tpu_torch.parallel import make_mesh, regather_lanes, trace_cpi_sharded
from rts_tpu_torch.sim.sweep import SweepCase, run_sweep

torch.set_num_threads(1)

DEVICE = "cpu"  # the port's entry points default to the card
MESHES_4 = [(4, 1), (2, 2), (1, 4)]
FIELDS = ("power", "doppler", "delay", "received")


def split_world(S, pulses: int, refraction: bool = False, rx_radius: float = 60.0):
    """A receding plate at 1 km in front of a monostatic radar whose
    capture sphere (60 m) receives the 8^3 fan's central returns; with
    ``refraction`` the plate is dielectric and a second receiver 300 m
    behind it catches the exiting chains."""
    w = S.World()
    w.add(S.Transmitter(name="tx0", path=S.Path.fixed(0, 0, 0), wave=S.RadarSignal(carrier=10e9),
                        pulse_count=pulses, prf=1000.0, tx_span=(0.1, 0.1, 0.0)))
    w.add(S.Receiver(name="rx0", path=S.Path.fixed(0, 0, 0), sphere=(rx_radius, 1.0, 1.0)))
    w.add(S.Target(name="plate", path=S.Path.linear([(0.0, (1000.0, 0.0, 0.0)), (1.0, (1050.0, 0.0, 0.0))]),
                   shape="rect", rect=(2.0, 200.0, 200.0), refl_coeff=0.6 if refraction else 0.9,
                   refr_index=1.5 if refraction else 1.0))
    w.add(S.Target(name="ball", path=S.Path.fixed(700, 40, 0), shape="sphere", sphere_params=(2, 20.0),
                   refl_coeff=0.8))
    if refraction:
        w.add(S.Receiver(name="rx1", path=S.Path.fixed(1300, 0, 0), sphere=(60.0, 1.5, 1.5)))
    return w


def wide_world(S, pulses: int):
    """split_world with a 120 m capture sphere: at 9^3 every ray block of
    three receives lanes (45, 108 and 45 a pulse)."""
    return split_world(S, pulses, rx_radius=120.0)


def yaw_world(S, pulses: int):
    """tests/test_parallel.py's make_world(rotating=True, target_speed=50):
    a yawing, receding plate at 1 km, a 5 m capture sphere."""
    w = S.World()
    w.add(S.Transmitter(name="tx0", path=S.Path.fixed(0, 0, 0),
                        wave=S.RadarSignal(carrier=10e9, temperature=30.0), pulse_count=pulses, prf=1000.0,
                        tx_span=(0.1, 0.1, 0.0)))
    w.add(S.Receiver(name="rx0", path=S.Path.fixed(0, 0, 0), sphere=(5.0, 1.0, 1.0), noise_temperature=70.0))
    w.add(S.Target(name="plate", path=S.Path.linear([(0.0, (1000.0, 0.0, 0.0)), (1.0, (1050.0, 0.0, 0.0))]),
                   attitude=S.AttitudePath(yaw_rate=0.1), shape="rect", rect=(2.0, 200.0, 200.0),
                   refl_coeff=0.9))
    return w


# name: (world, pulses, Parameters kwargs, prepare_cpi kwargs); "dtype" is
# a name, made a torch or a jnp dtype by each package's caller
CASES = {
    "brute_f64": (split_world, 8, dict(num_rays=8, max_refl_depth=2), dict(dtype="float64")),
    "cluster": (split_world, 4, dict(num_rays=8, max_refl_depth=2),
                dict(dtype="float32", accel="cluster", cluster_size=128, ray_tile=128)),
    "compact_narrow": (split_world, 4, dict(num_rays=8, max_refl_depth=2),
                       dict(dtype="float32", accel="cluster", cluster_size=64, ray_tile=64, compact_narrow=2)),
    "refraction": (lambda S, p: split_world(S, p, refraction=True), 4,
                   dict(num_rays=8, max_refl_depth=2, max_refr_depth=2), dict(dtype="float64")),
}
# the (1, 3) mesh: rts_tpu's mid-shape test with the caps of the replay and
# the capped post-processing set below and above the counts (CAP_PROBE)
CAP_KNOBS = dict(dtype="float32", accel="cluster", cluster_size=128, ray_tile=128, sub_tiles=2, candidates=16,
                 mt_group=4, compact_narrow=2, refine=True)
CAP_PARAMS = dict(num_rays=15, max_refl_depth=2)


def _prepare(S, P, world, pulses, params, knobs, dtype):
    return S.prepare_cpi(world(S, pulses), P(**params), **{**knobs, "dtype": dtype})


def _port_state(name, extra=None):
    world, pulses, params, knobs = CASES[name] if extra is None else extra
    kw = {k: v for k, v in knobs.items() if k != "dtype"}
    return _prepare(ts, TParameters, world, pulses, params, {**kw, "device": DEVICE},
                    getattr(torch, knobs["dtype"]))


def _flat(out) -> dict:
    return {**{k: getattr(out, k) for k in FIELDS}, **{f"agg.{k}": v for k, v in out.agg._asdict().items()}}


def _cap_case(cap: int, world=yaw_world, num_rays: int = 15):
    return (world, 1, {**CAP_PARAMS, "num_rays": num_rays}, {**CAP_KNOBS, "replay_cap": cap, "agg_cap": cap})


def _rank(rank: int, world_size: int, init_file: str, out_dir: str, jobs: list) -> None:
    """One gloo rank: every job's split trace, saved as ``<job>_<rank>.pt``
    (a flat dict of the CpiResult's fields, or of the error raised)."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank, world_size=world_size)
    try:
        for tag, kind, arg, shape in jobs:
            mesh = make_mesh(*shape, device_type="cpu")
            if kind == "sweep":
                report = run_sweep(_sweep_cases(), os.path.join(out_dir, tag), mesh=mesh, device=DEVICE)
                torch.save({"completed": torch.tensor(len(report.completed))}, f"{out_dir}/{tag}_{rank}.pt")
                continue
            state = _port_state(*arg)
            if kind == "error":  # a batch the mesh cannot divide
                try:
                    trace_cpi_sharded(*state, mesh)
                except ValueError as exc:
                    torch.save({"error": str(exc)}, f"{out_dir}/{tag}_{rank}.pt")
                continue
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")  # the replay-overflow UserWarning
                out = trace_cpi_sharded(*state, mesh)
            torch.save(_flat(out), f"{out_dir}/{tag}_{rank}.pt")
    finally:
        dist.destroy_process_group()


def _spawn(tmp, world_size: int, jobs: list) -> dict:
    """Run ``jobs`` on ``world_size`` spawned gloo ranks; each job's result
    by tag, after checking that every rank returned the same one."""
    out_dir = str(tmp)
    mp.spawn(_rank, args=(world_size, f"{out_dir}/init", out_dir, jobs), nprocs=world_size, join=True)
    results = {}
    for tag, kind, _, _ in jobs:
        per_rank = [torch.load(f"{out_dir}/{tag}_{r}.pt", weights_only=True) for r in range(world_size)]
        for other in per_rank[1:]:
            assert other.keys() == per_rank[0].keys()
            for k in per_rank[0]:
                same = per_rank[0][k] == other[k] if isinstance(other[k], str) else torch.equal(
                    per_rank[0][k], other[k])
                assert same, f"{tag}: ranks disagree on {k}"
        results[tag] = per_rank[0]
    return results


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    jobs = [(f"{name}_{p}x{r}", "trace", (name,), (p, r)) for name in CASES for p, r in MESHES_4]
    return _spawn(tmp_path_factory.mktemp("world4"), 4, jobs)


def _sweep_cases():
    return [SweepCase(f"c{k}", (lambda k=k: (split_world(ts, 3 + 3 * k), TParameters(num_rays=8, max_refl_depth=2))))
            for k in range(2)]


def _jax_sharded(name_or_case, shape) -> dict:
    """rts_tpu's trace_cpi_sharded on the same world, as numpy arrays."""
    import jax.numpy as jnp

    import rts_tpu.sim as js
    from rts_tpu import Parameters as JParameters
    from rts_tpu.parallel import make_mesh as j_make_mesh
    from rts_tpu.parallel import shard_batch, trace_cpi_sharded as j_sharded

    world, pulses, params, knobs = CASES[name_or_case] if isinstance(name_or_case, str) else name_or_case
    kw = {k: v for k, v in knobs.items() if k != "dtype"}
    if kw.get("accel") == "cluster":
        kw["interpret"] = True
    base, batch, cfg, spec = _prepare(js, JParameters, world, pulses, params, kw, getattr(jnp, knobs["dtype"]))
    mesh = j_make_mesh(*shape)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        out = j_sharded(base, shard_batch(batch, mesh), cfg, spec, mesh)
    return {**{k: np.asarray(getattr(out, k)) for k in FIELDS},
            **{f"agg.{k}": np.asarray(v) for k, v in out.agg._asdict().items()}}


def _assert_bit_identical(got: dict, ref: dict, what: str):
    assert got.keys() == ref.keys()
    for k in ref:
        assert torch.equal(got[k], ref[k]), f"{what}: {k} differs"


def _assert_matches_rts_tpu(got: dict, ref: dict, f64: bool):
    """Discrete outputs equal; continuous ones as tests/test_torch_cpi.py
    holds them in f32 (phase on the path groups whose lanes' delays all
    agree bit for bit: an ulp of an f32 path is ~0.1 rad), or in f64 to 1e-12 relative (delay)
    and 1e-11 (power and Doppler: a refracted child's 1/r^2 over a short
    leg carries the FMA difference) and 1e-8 rad (phase)."""
    for k in ("received", "agg.emit", "agg.npath", "agg.path_match"):
        np.testing.assert_array_equal(got[k].numpy(), ref[k], err_msg=k)
    rec = ref["received"] >= 0
    emit = ref["agg.emit"]
    assert rec.sum() > 0
    tol = (dict(delay=(1e-12, 0.0), power=(1e-11, 0.0), doppler=(1e-11, 1e-9)) if f64 else
           dict(delay=(1e-5, 0.0), power=(5e-5, 0.0), doppler=(1e-5, 1e-6)))
    for k, (rtol, atol) in tol.items():
        np.testing.assert_allclose(got[k].numpy()[rec], ref[k][rec], rtol=rtol, atol=atol, err_msg=k)
        np.testing.assert_allclose(got[f"agg.{k}"].numpy()[emit], ref[f"agg.{k}"][emit], rtol=rtol, atol=atol,
                                   err_msg=f"agg.{k}")
    phase = emit.copy()
    if not f64:  # only path groups whose every lane's delay agrees bit for bit
        for p in range(emit.shape[0]):
            match = ref["agg.path_match"][p]
            parted = rec[p] & (got["delay"][p].numpy() != ref["delay"][p])
            phase[p] &= ~np.isin(match, match[parted])
    d_phase = np.angle(np.exp(1j * (got["agg.phase"].numpy()[phase].astype(np.float64) - ref["agg.phase"][phase])))
    assert np.abs(d_phase).max(initial=0.0) <= (1e-8 if f64 else 1e-5), "agg.phase"


@pytest.mark.parametrize("shape", MESHES_4, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("name", list(CASES))
def test_split_equals_trace_cpi(spawned, name, shape):
    got = spawned[f"{name}_{shape[0]}x{shape[1]}"]
    ref = _flat(trace_cpi(*_port_state(name)))
    assert int((ref["received"] >= 0).sum()) > 0
    if name == "refraction":  # exiting chains reach the second receiver
        assert bool((ref["received"] == 1).any())
    _assert_bit_identical(got, ref, f"{name} on {shape}")


@pytest.mark.parametrize("name", list(CASES))
def test_split_matches_rts_tpu(spawned, name):
    """rts_tpu's own split on the (2, 2) mesh against the port's; rts_tpu's
    split equals its single-device trace (tests/test_parallel.py)."""
    got = spawned[f"{name}_2x2"]
    ref = _jax_sharded(name, (2, 2))
    _assert_matches_rts_tpu(got, ref, f64=CASES[name][3]["dtype"] == "float64")


def test_regather_lanes_in_one_process_equals_the_ranks(spawned):
    """Ray blocks traced in one process through make_pulse_fn(fan_slice)
    and put back by regather_lanes: the spawned (1, 4) split's result."""
    base, batch, cfg, spec = _port_state("refraction")
    k = 4
    _, aggregate = make_pulse_fn(base, cfg, spec)
    blocks = [make_pulse_fn(base, cfg, spec, fan_slice=(k, i))[0] for i in range(k)]
    outs = []
    for p in range(batch.times.shape[0]):
        parts = [one(*pulse_args(batch, p)) for one in blocks]
        whole = [regather_lanes([part[j] for part in parts], cfg.slot_multiplier, cfg.rays_per_fan // k)
                 for j in range(1, 4)]
        res = TraceResult(*(regather_lanes([part[0][j] for part in parts], cfg.slot_multiplier,
                                           cfg.rays_per_fan // k) for j in range(len(TraceResult._fields))))
        outs.append(_flat(aggregate(res, *whole)))
    got = {key: torch.stack([o[key] for o in outs]) for key in outs[0]}
    _assert_bit_identical(got, spawned["refraction_1x4"], "regather_lanes in one process")


def test_regather_lanes_layout():
    """Block k's lane slot * F + f lands on slot * (K * F) + k * F + f."""
    k, slots, f = 3, 2, 5
    blocks = [torch.tensor([[s * 1000 + b * 100 + i for s in range(slots) for i in range(f)]]) for b in range(k)]
    got = regather_lanes(blocks, slots, f)
    want = torch.tensor([[s * 1000 + b * 100 + i for s in range(slots) for b in range(k) for i in range(f)]])
    assert torch.equal(got, want)


def test_backend_must_match_the_device(tmp_path):
    """A CPU scene on a mesh whose groups run gloo is fine; a CUDA mesh
    device type with CPU tensors refuses before any collective."""
    from rts_tpu_torch.parallel import sharding

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/init", rank=0, world_size=1)
    try:
        mesh = make_mesh(1, 1, device_type="cpu")
        sharding._check_backend(mesh, torch.device("cpu"))
        with pytest.raises(ValueError, match="nccl"):
            sharding._check_backend(mesh, torch.device("cuda"))
        with pytest.raises(ValueError, match="need 2 devices, have 1"):
            make_mesh(2, 1, device_type="cpu")
    finally:
        dist.destroy_process_group()


def test_pulse_fn_without_a_split_is_unchanged():
    """fan_slice=(1, 0) is the whole fan: the same pulse, bit for bit."""
    base, batch, cfg, spec = _port_state("cluster")
    one, agg = make_pulse_fn(base, cfg, spec)
    one1, _ = make_pulse_fn(base, cfg, spec, fan_slice=(1, 0))
    a, b = agg(*one(*pulse_args(batch, 1))), agg(*one1(*pulse_args(batch, 1)))
    _assert_bit_identical(_flat(a), _flat(b), "fan_slice=(1, 0)")
