"""The span readers (``benchmark.spans``) on a hand-made record, the
existing readers unchanged by the spans, and ``benchmark.layers`` end to
end on the CPU's tiny cells."""

from __future__ import annotations

import pytest
import torch

from benchmark import layers, readers, run, spans
from conftest import SEED, tiny

NS = 1e-6  # ms a nanosecond


def _record() -> spans.SpanRecord:
    """Two pulses in a stretch of 1000 ns: per pulse a segment holding phase
    1 and the kernel, the replay, post-processing and aggregation; then the
    final gather.  Device events with the times of their launches."""
    sp = [("rts.cpi", 2, 998),
          ("rts.pulse", 10, 490), ("rts.segment", 20, 200), ("rts.phase1", 30, 80), ("rts.traverse", 80, 120),
          ("rts.replay", 200, 300), ("rts.postprocess", 300, 350), ("rts.aggregate", 350, 400),
          ("rts.pulse", 500, 890), ("rts.segment", 510, 700), ("rts.phase1", 520, 560), ("rts.traverse", 560, 600),
          ("rts.replay", 700, 800), ("rts.postprocess", 800, 850), ("rts.aggregate", 850, 880),
          ("rts.gather.pulse", 900, 995)]
    dev = [(("memset", 5, 8), None), (("k1", 50, 90), 40), (("k2", 85, 95), 70), (("cand_kernel", 100, 150), 90),
           (("k3", 300, 310), 250), (("k4", 600, 620), 530), (("nccl", 950, 990), 910)]
    return spans.SpanRecord(
        prepare_s=1.0, pulses=2, host_ops=3, stretch_ns=(0, 1000), spans=sp,
        device_events=[d for d, _ in dev], launches=[t for _, t in dev],
        host_events=[("aten::where", 35, 45), ("aten::add", 150, 190), ("aten::mul", 600, 700)],
        counters={"replay.unrefined": 0}, gather_ms=[3.0, 1.5, 2.0, 5.0])


def test_partition_cuts_the_covered_time_by_the_innermost_span():
    sp = [("a", 0, 100), ("b", 10, 20), ("c", 30, 40), ("d", 35, 38), ("e", 120, 130)]
    assert spans.partition(sp) == [(0, 10, 0), (10, 20, 1), (20, 30, 0), (30, 35, 2), (35, 38, 3), (38, 40, 2),
                                   (40, 100, 0), (120, 130, 4)]


def test_the_readers_on_a_known_record():
    rec = _record()
    assert spans.phase1_ms(rec) == pytest.approx((50 + 40) / 2 * NS)
    assert spans.phase1_busy_ms(rec) == pytest.approx((95 - 50 + 20) / 2 * NS)  # k1, k2 overlap
    assert spans.shade_ms(rec) == pytest.approx((180 - 90 + 190 - 80) / 2 * NS)
    assert spans.replay_ms(rec) == pytest.approx(200 / 2 * NS)
    assert spans.post_ms(rec) == pytest.approx((50 + 50 + 50 + 30) / 2 * NS)
    assert spans.launched_busy_ms(rec, "rts.gather.pulse") == pytest.approx(40 * NS)
    assert spans.exchange_ms(rec) == 1.5
    assert spans.rank_skew_ms(rec) == 3.5
    assert spans.clock_check(rec) == {"events": 1, "launch_recorded": 1, "launched_inside": 1, "started_after": 1,
                                      "lead_us_min": pytest.approx(0.02)}  # started 20 ns after the span


def test_the_readers_return_none_without_their_spans():
    plain = run.Record(prepare_s=1.0, pulses=2, stretch_ns=(0, 1000))
    empty = spans.SpanRecord(prepare_s=1.0, pulses=2, stretch_ns=(0, 1000), spans=[("rts.pulse", 10, 20)])
    for rec in (plain, empty):
        for name in layers.READERS:
            assert getattr(spans, name)(rec) is None, name
    assert spans.layers(plain) is None


def test_the_layer_table_partitions_the_stretch():
    rec = _record()
    table = spans.layers(rec)
    phase1 = table["rts.phase1"]
    assert phase1["calls"] == 1.0 and phase1["aten_ops"] == 0.5
    assert phase1["host_self_ms"] == pytest.approx(45 * NS)
    assert phase1["busy_ms"] == pytest.approx(32.5 * NS)
    assert phase1["idle_ms"] == pytest.approx((20 + 40) / 2 * NS)  # (30, 50) and (520, 560)
    assert table["rts.segment"]["aten_ops"] == 1.0
    assert table[spans.UNLINKED]["busy_ms"] == pytest.approx(1.5 * NS)
    assert table[spans.NO_SPAN]["host_self_ms"] == pytest.approx(2 * NS)
    total = lambda key: sum(r[key] for r in table.values()) * rec.pulses
    assert total("host_self_ms") == pytest.approx(1000 * NS)
    assert total("idle_ms") == pytest.approx(1000 * NS - readers.busy_ns(rec) * NS)
    assert total("aten_ops") == len(rec.host_events)


def test_idle_gaps_carry_their_span_and_keep_their_lengths():
    rec = _record()
    named, plain = spans.named_gaps(rec), run.breakdown(rec)["idle_gaps"]
    assert [g[1] for g in named] == [g[1] for g in plain]
    for (label, _), (op, _) in zip(named, plain):
        assert label == op if op.startswith("host") else label.endswith("/" + op)
    assert named[0] == ["rts.segment/aten::mul", pytest.approx(330e-9)]  # (620, 950)
    assert named[1] == ["host (no aten operator)", pytest.approx(290e-9)]  # (310, 600)


def test_the_existing_readers_ignore_the_spans():
    rec = _record()
    plain = run.Record(prepare_s=rec.prepare_s, pulses=rec.pulses, host_ops=rec.host_ops,
                       device_events=rec.device_events, host_events=rec.host_events, stretch_ns=rec.stretch_ns)
    for read in (readers.device_idle_pct, readers.host_ops_per_pulse, readers.launches_per_pulse,
                 readers.render_ms, readers.prepare_s, readers.busy_ns):
        assert read(rec) == read(plain)
    assert run.breakdown(rec) == run.breakdown(plain)


def test_span_events_read_the_profilers_host_regions():
    from torch.profiler import ProfilerActivity, profile

    from rts_tpu_torch.utils.timing import trace_annotation

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace_annotation("rts.pulse"):
            with trace_annotation("rts.phase1"):
                torch.ones(4).sum()
    sp, device, launches = spans.span_events(prof)
    assert [s[0] for s in sp] == ["rts.pulse", "rts.phase1"]
    assert sp[0][1] <= sp[1][1] < sp[1][2] <= sp[0][2]
    assert device == launches == []


class _Event:
    def __init__(self, name):
        self._name = name

    def name(self):
        return self._name


def test_runtime_calls_are_told_by_name():
    assert spans._runtime(_Event("cudaLaunchKernel")) and spans._runtime(_Event("cuLaunchKernelEx"))
    assert not any(spans._runtime(_Event(n)) for n in ("aten::cumsum", "cutlass::gemm", "rts.phase1"))


def test_the_skew_bounds_come_from_launches_and_pageable_copies():
    # calls: a launch at 100, a blocking copy's call 200-260, a pinned copy's call 300-305
    calls = [("cudaLaunchKernel", 100, 104, 1), ("cudaMemcpyAsync", 200, 260, 2), ("cudaMemcpyAsync", 300, 305, 3)]
    device = [("kernel", 103, 150, 1), ("Memcpy DtoH (Device -> Pageable)", 230, 258, 2),
              ("Memcpy DtoH (Device -> Pinned)", 310, 320, 3), ("nccl", 5, 9, 99)]
    got = spans.skew_bounds(device, calls, windows=[(0, 250), (250, 400)])
    assert got == {"offset_us_max": pytest.approx(0.003), "launches": 3, "offset_us_min": pytest.approx(-0.002),
                   "copies": 1, "calls": 3, "windows": 1, "crossed": 0,
                   "offset_us_range": [pytest.approx(-0.002), pytest.approx(0.003)]}
    assert spans.skew_bounds(device[3:], calls) == {"offset_us_max": None, "launches": 0, "offset_us_min": None,
                                                    "copies": 0, "calls": 3, "windows": 0, "crossed": 0,
                                                    "offset_us_range": None}


def test_layers_end_to_end_on_the_cpu():
    result = layers.run_layers(tiny(run.load_cell("terrain-1M.fan63")), SEED, 0.1, device="cpu")
    table = result["layers"]
    assert table["rts.pulse"]["calls"] == 1.0 and table["rts.cpi"]["calls"] == 0.5  # 2 pulses
    assert table["rts.phase1"]["calls"] == table["rts.traverse"]["calls"] > 0
    assert result["counters"]["replay.unrefined"] == 0
    assert result["counters"]["segment.live_lanes.0"] == 2 * 5**3
    assert all(result["metrics"][m] is not None for m in ("phase1_ms", "shade_ms", "replay_ms", "post_ms"))
    assert result["metrics"]["exchange_ms"] is None


def test_layers_on_the_split_gathers_every_ranks_exchange():
    result = layers.run_layers(tiny(run.load_cell("imaging-1M.cpi256.split4")), SEED, 0.1, device="cpu")
    assert len(result["ranks"]) == 4
    assert all(r["gather_pulse_ms"] is not None for r in result["ranks"])
    assert result["metrics"]["exchange_ms"] is not None and result["metrics"]["rank_skew_ms"] is not None
    assert result["layers"]["rts.gather.pulse"]["calls"] == 0.5
