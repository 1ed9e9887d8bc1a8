"""The port's spans and counters (``rts_tpu_torch.utils.timing``).

Under ``torch.profiler`` a CPI records its spans where the layers of a
pulse run; without one no span is entered and no counter is computed on
the device, and the result is bit for bit the traced run's.  The counters
agree with what the result shows, and the host's counts agree with the
device's.
"""

import dataclasses
import math

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import rts_tpu_torch.sim as ts
from rts_tpu_torch import Parameters
from rts_tpu_torch.engine.cpi import trace_cpi
from rts_tpu_torch.utils import timing

torch.set_num_threads(1)

# 9^3 rays in tiles of 32: 22 full tiles, so the narrow segments (a budget
# of 8 tiles under compact_narrow=-1) trace the few live ones
PARAMS = dict(num_rays=9, max_refl_depth=2)
OPTIONS = dict(accel="cluster", cluster_size=128, ray_tile=32, refine=True, replay_cap=4, compact_narrow=-1)


def world():
    """A moving, yawing plate and a sphere in front of a monostatic radar,
    two pulses."""
    S = ts
    w = S.World()
    w.add(S.Transmitter(path=S.Path.fixed(0, 0, 0), wave=S.RadarSignal(carrier=10e9),
                        pulse_count=2, prf=1000.0, tx_span=(0.1, 0.1, 0.0)))
    w.add(S.Receiver(path=S.Path.fixed(0, 0, 0), sphere=(5.0, 1.0, 1.0)))
    w.add(S.Target(path=S.Path.linear([(0.0, (1000.0, 0.0, 0.0)), (1.0, (1050.0, 0.0, 0.0))]),
                   attitude=S.AttitudePath(yaw_rate=0.1), shape="rect", rect=(2.0, 40.0, 40.0),
                   refl_coeff=0.9))
    w.add(S.Target(path=S.Path.linear([(0.0, (800.0, 100.0, 0.0)), (1.0, (790.0, 104.0, 2.0))]),
                   shape="sphere", sphere_params=(2, 30.0), refl_coeff=0.8))
    return w


def _traced(state):
    """(result, the rts.* spans as (name, start_ns, end_ns), counters) of
    one CPI under the profiler."""
    timing.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = trace_cpi(*state)
    spans = [(e.name(), e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
             if e.name().startswith("rts.")]
    return out, spans, timing.counters()


@pytest.fixture(scope="module")
def runs():
    """The host paths traced; the device paths (``replay_cap=0``,
    ``compact_narrow=0``) traced, and untraced with the span's profiler
    region refused."""
    base, batch, cfg, spec = ts.prepare_cpi(world(), Parameters(**PARAMS), device="cpu", **OPTIONS)
    device_cfg = dataclasses.replace(cfg, replay_cap=0, compact_narrow=0)
    host = _traced((base, batch, cfg, spec))
    device = _traced((base, batch, device_cfg, spec))

    def refuse(*args, **kw):
        raise AssertionError("a profiler region entered without a profiler")

    timing.reset()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(timing, "_REGION", refuse)
        mp.setattr(torch.profiler, "record_function", refuse)
        plain = trace_cpi(base, batch, device_cfg, spec)
    kept = dict(timing._device)
    return dict(cfg=cfg, host=host, device=device, plain=(plain, kept, timing.counters()))


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_a_traced_cpi_records_its_spans_per_pulse(runs):
    _, spans, _ = runs["host"]
    cfg = runs["cfg"]
    names = [s[0] for s in spans]
    pulses = 2
    assert names.count("rts.cpi") == 1
    assert names.count("rts.pulse") == pulses
    assert names.count("rts.segment") == pulses * cfg.num_segments
    for name in ("rts.animate", "rts.replay", "rts.postprocess", "rts.aggregate"):
        assert names.count(name) == pulses, name
    cpi = next(s for s in spans if s[0] == "rts.cpi")
    segments = [s for s in spans if s[0] == "rts.segment"]
    assert all(_inside(s, cpi) for s in spans)
    for pulse in (s for s in spans if s[0] == "rts.pulse"):
        assert sum(_inside(s, pulse) for s in segments) == cfg.num_segments
    inner = [s for s in spans if s[0] in ("rts.phase1", "rts.traverse")]
    assert inner and all(any(_inside(s, seg) for seg in segments) for s in inner)
    assert names.count("rts.phase1") == names.count("rts.traverse")


def test_without_a_profiler_no_span_is_entered_and_nothing_is_counted_on_the_device(runs):
    plain, kept, counted = runs["plain"]
    traced = runs["device"][0]
    for name in plain._fields:
        a, b = getattr(plain, name), getattr(traced, name)
        if isinstance(a, tuple):
            assert all(torch.equal(x, y) for x, y in zip(a, b)), name
        else:
            assert torch.equal(a, b), name
    assert kept == {}
    assert "replay.lanes" not in counted and counted["replay.unrefined"] == 0
    assert sorted(k for k in counted if k.startswith("segment.")) == ["segment.live_lanes.0",
                                                                     "segment.live_tiles.0"]


def test_replay_counters_match_the_result(runs):
    cap = OPTIONS["replay_cap"]
    out, _, counted = runs["host"]
    received = (out.received >= 0).sum(1).tolist()
    assert max(received) > cap
    # every received lane is refined, those past the cap in a grown block
    assert counted["replay.lanes"] == sum(received)
    assert counted["replay.overflow"] == sum(max(c - cap, 0) for c in received) > 0
    assert counted["replay.unrefined"] == 0
    out, _, counted = runs["device"]  # no cap: every received lane is refined
    assert counted["replay.lanes"] == int((out.received >= 0).sum())
    assert counted["replay.unrefined"] == 0


def test_live_lane_counters_agree_between_the_host_and_the_device(runs):
    cfg = runs["cfg"]
    host, device = runs["host"][2], runs["device"][2]
    assert host.get("segment.narrow", 0) > 0 and "segment.narrow" not in device
    live = lambda c: {k: v for k, v in c.items() if k.startswith("segment.live_")}
    assert len(live(host)) == 2 * cfg.num_segments
    assert live(host) == live(device)
    assert host["segment.live_lanes.0"] == 2 * PARAMS["num_rays"] ** 3
    assert host["segment.live_tiles.0"] == 2 * math.floor(PARAMS["num_rays"] ** 3 / OPTIONS["ray_tile"])
    assert 0 < host["segment.live_lanes.1"] < host["segment.live_lanes.0"]


def test_trace_annotation_is_one_check_without_a_profiler(monkeypatch):
    checks = []
    enabled = torch.autograd._profiler_enabled

    def counted():
        checks.append(1)
        return enabled()

    def refuse(*args, **kw):
        raise AssertionError("a profiler region entered without a profiler")

    monkeypatch.setattr(torch.autograd, "_profiler_enabled", counted)
    monkeypatch.setattr(timing, "_REGION", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    first, second = timing.trace_annotation("rts.a"), timing.trace_annotation("rts.b")
    assert first is second and len(checks) == 2
    with first:
        pass
    monkeypatch.undo()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timing.trace_annotation("rts.render"):
            torch.ones(4).sum()
    assert any(e.key == "rts.render" for e in prof.key_averages())


def test_the_counter_registry():
    timing.reset()
    timing.count("a", 2)
    timing.count("a", 3)
    timing.count("d", torch.tensor(7))  # no profiler: dropped
    assert timing.counters() == {"a": 5}
    with profile(activities=[ProfilerActivity.CPU]):
        timing.count("d", torch.tensor(7))
        timing.count("d", torch.tensor(4, dtype=torch.int32))
    assert timing.counters() == {"a": 5, "d": 11}
    assert not timing._device and timing.counters() == {"a": 5, "d": 11}
    timing.reset()
    assert timing.counters() == {}
