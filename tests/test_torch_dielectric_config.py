"""BASELINE config 3 as the benchmark's configuration ``dielectric-1M``
(``benchmark/configs/dielectric-1M.json``), cut small, on the CPU.

A receiver captures a chain only where the chain leaves the scene (the
miss program), so over the terrain the exiting refraction chains, which
head down, reach the forward receiver only where the terrain throws them
back up past the slab.  The receiver sits 600 m up, above every peak and
under the slab; at 201 x 201 vertices and a 15^3 fan the terrain of seed
7 throws two fan directions a pulse into its window.  There:

- the port's lanes and aggregates agree with the benchmark's float64
  reference (``benchmark.check``), and the forward receiver receives
  refracted lanes; with the receiver at 100 m, where ``bench.py`` had it
  (its sphere reaching 220 m, into the terrain), both agree again and no
  refracted lane is received;
- under ``torch.profiler`` the refraction spawn is an ``rts.refract``
  span inside the spawn segments, and the counters equal what the pulses'
  results show: children born and lanes received, by slot; without
  refraction neither the span nor a counter appears;
- with a replay cap below the received count, the lanes past it, the
  refracted ones among them, are replayed too (the block grows to hold
  them): the CPI is the full-lane replay's;
- ``rts_tpu_torch/bench.py --scene dielectric`` builds the
  configuration's CPI (its terrain seed 3) tensor for tensor.
"""

import copy
import dataclasses

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import adapter
from benchmark import check as C
from benchmark.reference import reference_cpi
from benchmark.run import load_cell
from rts_tpu_torch import bench as tbench
from rts_tpu_torch.engine.cpi import CpiResult, _stack, make_pulse_fn, pulse_args, trace_cpi
from rts_tpu_torch.utils import timing

torch.set_num_threads(2)

CPU = torch.device("cpu")
SEED = 7
N, PULSES = 15, 2
N3 = N**3
SLOTS = ("primary", "trapped", "exiting")


def cell(rx_height: float = 600.0, n: int = 201):
    """The configuration at ``n`` x ``n`` terrain vertices, an N^3 fan and
    PULSES pulses, its forward receiver at ``rx_height``."""
    c = copy.deepcopy(load_cell("dielectric-1M.fan63"))
    c.config["targets"][0]["terrain"]["n"] = n
    c.config["receivers"][1]["position"][2] = rx_height
    c.traffic.update(num_rays=N, pulses=PULSES)
    return c


def _spans_and_counters(fn):
    """(fn's value, the rts.* spans as (name, start_ns, end_ns), the
    counters) of ``fn()`` under the profiler."""
    timing.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        value = fn()
    spans = [(e.name(), e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
             if e.name().startswith("rts.")]
    return value, spans, timing.counters()


def _untraced(state):
    """The CPI traced pulse by pulse as ``trace_cpi`` traces it, with each
    pulse's refraction depths [P, R]."""
    base, batch, cfg, spec = state
    one_pulse, aggregate = make_pulse_fn(base, cfg, spec)
    outs, depths = [], []
    for p in range(batch.times.shape[0]):
        res, power, doppler, delay = one_pulse(*pulse_args(batch, p))
        outs.append(aggregate(res, power, doppler, delay))
        depths.append(res.refr_depth)
    return _stack(outs), torch.stack(depths)


@pytest.fixture(scope="module")
def runs():
    """Per receiver height, the untraced CPI, its refraction depths and the
    reference; at 600 m also the CPI traced under the profiler."""
    got = {}
    for z in (600.0, 100.0):
        c = cell(z)
        state = adapter.prepare(c.config, c.traffic, SEED, CPU)
        out, depth = _untraced(state)
        got[z] = dict(out=out, depth=depth, ref=reference_cpi(c.config, c.traffic, SEED, CPU))
        if z == 600.0:
            got[z]["traced"] = _spans_and_counters(lambda: trace_cpi(*state))
    return got


def _refracted_at_forward_rx(received) -> int:
    """Lanes past the primaries' slot received by the forward receiver."""
    return int((received[:, N3:] == 1).sum())


@pytest.mark.parametrize("rx_height", [600.0, 100.0])
def test_the_port_agrees_with_the_reference(runs, rx_height):
    run = runs[rx_height]
    numbers = C.compare(C.from_program(run["out"], None), run["ref"])
    assert C.verdict(numbers), numbers
    assert numbers["rx_differ"] == 0 and numbers["lanes_far"] == 0
    assert numbers["rx_power_rel"] < 1e-7 and numbers["phase_rad"] < 1e-7, numbers
    lanes = run["ref"].lanes
    ref_refracted = int(((lanes.received == 1) & (lanes.refr_depth > 0)).sum())
    assert _refracted_at_forward_rx(run["out"].received) == ref_refracted
    if rx_height == 600.0:
        assert ref_refracted > 0
        assert (run["depth"][:, N3:][run["out"].received[:, N3:] >= 0] > 0).all()
    else:
        assert ref_refracted == 0


def test_a_traced_cpi_equals_the_untraced_one(runs):
    run = runs[600.0]
    traced = run["traced"][0]
    for name in CpiResult._fields:
        a, b = getattr(traced, name), getattr(run["out"], name)
        if isinstance(a, tuple):
            assert all(torch.equal(x, y) for x, y in zip(a, b)), name
        else:
            assert torch.equal(a, b), name


def test_the_refraction_spawn_is_a_span_inside_the_spawn_segments(runs):
    _, spans, _ = runs[600.0]["traced"]
    refract = [s for s in spans if s[0] == "rts.refract"]
    segments = [s for s in spans if s[0] == "rts.segment"]
    # two spawn segments a pulse, each the spawn and the children's landing
    assert len(refract) == 4 * PULSES
    assert all(any(g[1] <= s[1] and s[2] <= g[2] for g in segments) for s in refract)


def _from_result(run) -> dict:
    """The counters' values as the pulses' results give them."""
    depth, received = run["depth"], run["out"].received
    slot = lambda a, s: a[:, s * N3:(s + 1) * N3]
    want = {"refract.spawned.trapped": int((slot(depth, 1) == 1).sum()),
            "refract.spawned.exiting": int((slot(depth, 2) == 2).sum())}
    for s, name in enumerate(SLOTS):
        want[f"rx.received.{name}"] = int((slot(received, s) >= 0).sum())
    return want


@pytest.mark.parametrize("name", ["refract.spawned.trapped", "refract.spawned.exiting"]
                         + [f"rx.received.{s}" for s in SLOTS])
def test_the_counters_equal_the_result(runs, name):
    run = runs[600.0]
    counted = run["traced"][2]
    assert counted[name] == _from_result(run)[name]
    if name in ("refract.spawned.trapped", "refract.spawned.exiting", "rx.received.exiting"):
        assert counted[name] > 0


def test_no_lane_meets_total_internal_reflection_at_the_slab(runs):
    # the fan meets the slab's faces within 0.08 rad of their normal, far
    # inside the critical angle of an index of 1.5 (0.73 rad)
    assert runs[600.0]["traced"][2]["refract.tir"] == 0


@pytest.mark.parametrize("cap", [1, 2])
def test_a_replay_cap_below_the_received_count_refines_every_lane(cap):
    """The refracted chains past the cap are replayed too, in a block grown
    to hold them: the result is the full-lane replay's, lane for lane."""
    c = cell()
    c.config["options"]["replay_cap"] = cap
    state = adapter.prepare(c.config, c.traffic, SEED, CPU)
    got, spans, counted = _spans_and_counters(lambda: trace_cpi(*state))
    base, batch, cfg, spec = state
    full = trace_cpi(base, batch, dataclasses.replace(cfg, replay_cap=0), spec)
    received = (full.received >= 0).sum(1).tolist()
    assert min(received) > 2 * cap and _refracted_at_forward_rx(full.received) > 0
    assert counted["replay.lanes"] == sum(received) and counted["replay.unrefined"] == 0
    assert counted["replay.overflow"] == sum(r - cap for r in received)
    for name in CpiResult._fields:
        a, b = getattr(got, name), getattr(full, name)
        if isinstance(a, tuple):
            assert all(torch.equal(x, y) for x, y in zip(a, b)), name
        else:
            assert torch.equal(a, b), name


def test_without_refraction_neither_the_span_nor_a_counter_appears():
    c = copy.deepcopy(load_cell("terrain-1M.fan63"))
    c.config["targets"][0]["terrain"]["n"] = 21
    c.traffic.update(num_rays=5, pulses=2)
    state = adapter.prepare(c.config, c.traffic, SEED, CPU)
    _, spans, counted = _spans_and_counters(lambda: trace_cpi(*state))
    assert spans and "rts.refract" not in {s[0] for s in spans}
    assert not [k for k in counted if k.startswith(("refract.", "rx."))]


def test_bench_py_builds_the_configuration():
    """bench.py's dielectric scene (terrain seed 3, at --tris 2000) and the
    configuration file give the same CPI."""
    args = tbench.parse_args(["--scene", "dielectric", "--tris", "2000", "--rays", "5", "--pulses", "2",
                              "--device", "cpu"])
    w, params = tbench.scene(args)
    assert [r.path.position(0.0)[2] for r in w.receivers] == [4000.0, 600.0]
    got = tbench.build(args)[:4]
    c = copy.deepcopy(load_cell("dielectric-1M.fan63"))
    c.config["targets"][0]["terrain"]["n"] = w.targets[0].terrain[0]
    c.traffic.update(num_rays=5, pulses=2)
    options = {**c.config["options"], "replay_cap": tbench.options(args)["replay_cap"]}
    assert options == tbench.options(args)
    want = adapter.prepare({**c.config, "options": options}, c.traffic, 3, CPU)
    (gb, gbat, gcfg, gspec), (wb, wbat, wcfg, wspec) = got, want
    _same_tensors(gb, wb)
    _same_tensors(gbat, wbat)
    assert gcfg == wcfg
    for name in ("tx_span", "carrier", "cspeed", "num_rx"):
        assert getattr(gspec, name) == getattr(wspec, name), name


def _same_tensors(a, b):
    """Every tensor leaf of two (nested) tuples equal; None where None."""
    assert type(a) is type(b)
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b)
    elif isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same_tensors(x, y)
    else:
        assert a is None and b is None
