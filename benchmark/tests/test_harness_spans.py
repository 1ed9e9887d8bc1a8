"""The span readers (``benchmark.spans``) on a hand-made record, the
existing readers unchanged by the spans, and a traced run's spans,
counters and span metrics end to end on the CPU's tiny cells."""

from __future__ import annotations

import dataclasses
import json

import pytest
import torch

from benchmark import readers, run, spans
from conftest import SEED, tiny

NS = 1e-6  # ms a nanosecond
SPAN_METRICS = ("shade_ms.trace", "replay_ms.trace", "post_ms.trace", "phase1_busy_ms.trace", "exchange_ms.imaging",
                "rank_skew_ms.imaging")


def _record() -> run.Record:
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
    return run.Record(
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
    assert spans.phase1_busy_ms(rec) == pytest.approx((95 - 50 + 20) / 2 * NS)  # k1, k2 overlap
    assert spans.shade_ms(rec) == pytest.approx((180 - 90 + 190 - 80) / 2 * NS)
    assert spans.replay_ms(rec) == pytest.approx(200 / 2 * NS)
    assert spans.post_ms(rec) == pytest.approx((50 + 50 + 50 + 30) / 2 * NS)
    assert spans.launched_busy_ms(rec, "rts.gather.pulse") == pytest.approx(40 * NS)
    assert spans.exchange_ms(rec) == 1.5
    assert spans.rank_skew_ms(rec) == 3.5
    for name, want in [("shade_ms.trace", spans.shade_ms(rec)), ("phase1_busy_ms.trace", spans.phase1_busy_ms(rec)),
                       ("exchange_ms.imaging", 1.5), ("rank_skew_ms.imaging", 3.5)]:
        assert run.reader(name)(rec) == want, name  # each metric file is its reader
    assert spans.clock_check(rec) == {"events": 1, "launch_recorded": 1, "launched_inside": 1, "started_after": 1,
                                      "lead_us_min": pytest.approx(0.02)}  # started 20 ns after the span


def test_the_readers_return_none_without_their_spans():
    plain = run.Record(prepare_s=1.0, pulses=2, stretch_ns=(0, 1000))
    empty = run.Record(prepare_s=1.0, pulses=2, stretch_ns=(0, 1000), spans=[("rts.pulse", 10, 20)])
    for rec in (plain, empty):
        for name in SPAN_METRICS:
            assert run.reader(name)(rec) is None, name
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
    named = run.breakdown(rec)["idle_gaps"]
    plain = run.breakdown(dataclasses.replace(rec, spans=[]))["idle_gaps"]  # named by operator alone
    assert named == spans.named_gaps(rec)
    assert [g[1] for g in named] == [g[1] for g in plain]
    for (label, _), (op, _) in zip(named, plain):
        assert label == op if op.startswith("host") else label.endswith("/" + op)
    assert named[0] == ["rts.segment/aten::mul", pytest.approx(330e-9)]  # (620, 950)
    assert named[1] == ["host (no aten operator)", pytest.approx(290e-9)]  # (310, 600)
    crossed = run.breakdown(dataclasses.replace(rec, skew={"crossed": 1}))["idle_gaps"]
    assert [g[1] for g in crossed] == [g[1] for g in named]
    assert all(g[0].startswith("(not named: the clocks crossed") for g in crossed)


def test_the_existing_readers_ignore_the_spans():
    rec = _record()
    plain = run.Record(prepare_s=rec.prepare_s, pulses=rec.pulses, host_ops=rec.host_ops,
                       device_events=rec.device_events, host_events=rec.host_events, stretch_ns=rec.stretch_ns)
    for read in (readers.device_idle_pct, readers.host_ops_per_pulse, readers.launches_per_pulse,
                 readers.render_ms, readers.prepare_s, readers.busy_ns):
        assert read(rec) == read(plain)
    got, want = run.breakdown(rec), run.breakdown(plain)
    assert got["device_ops"] == want["device_ops"]
    assert [g[1] for g in got["idle_gaps"]] == [g[1] for g in want["idle_gaps"]]


def test_span_events_read_the_profilers_host_regions():
    from torch.profiler import ProfilerActivity, profile

    from rts_tpu_torch.utils.timing import trace_annotation

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace_annotation("rts.pulse"):
            with trace_annotation("rts.phase1"):
                torch.ones(4).sum()
    ev = run._events(prof)
    sp = ev["spans"]
    assert [s[0] for s in sp] == ["rts.pulse", "rts.phase1"]
    assert sp[0][1] <= sp[1][1] < sp[1][2] <= sp[0][2]
    assert ev["device"] == ev["launches"] == ev["ids"] == []
    assert [h[0] for h in ev["host"]] and all(h[0].startswith("aten::") for h in ev["host"])


def test_runtime_calls_are_told_by_name():
    assert run._runtime("cudaLaunchKernel") and run._runtime("cuLaunchKernelEx")
    assert not any(run._runtime(n) for n in ("aten::cumsum", "cutlass::gemm", "rts.phase1"))


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


def _traced(cell, capfd) -> tuple:
    """A ``--trace 1`` run of ``cell`` on the CPU: (its result, the
    ``# layers:``, ``# counters:`` and ``# clock:`` lines read back)."""
    result = run.run_cell(cell, SEED, 0.1, True, device="cpu")
    err = capfd.readouterr().err
    lines = {k: json.loads(line.split(": ", 1)[1]) for line in err.splitlines()
             for k in ("layers", "counters", "clock") if line.startswith(f"# {k}: ")}
    return result, lines


def test_layers_end_to_end_on_the_cpu(capfd):
    result, lines = _traced(tiny(run.load_cell("terrain-1M.fan63")), capfd)
    table, counters = lines["layers"], lines["counters"]
    assert result["correct"] is True
    assert table["rts.pulse"]["calls"] == 1.0 and table["rts.cpi"]["calls"] == 0.5  # 2 pulses
    assert table["rts.phase1"]["calls"] == table["rts.traverse"]["calls"] > 0
    assert counters["replay.unrefined"] == 0
    assert counters["segment.live_lanes.0"] == 2 * 5**3
    assert counters["replay.lanes"] > 0  # the plate's returns, refined
    m = result["metrics"]
    assert all(m[k]["value"] > 0 and m[k]["unit"] == "ms" for k in ("shade_ms.trace", "replay_ms.trace",
                                                                     "post_ms.trace"))
    assert m["phase1_busy_ms.trace"]["value"] == 0.0  # no device events on the CPU
    assert "exchange_ms.imaging" not in m and lines["clock"]["gather_ms"] == []
    assert all(not g[0].startswith("(no span)") for g in result["breakdown"]["idle_gaps"])


def test_layers_on_the_split_gathers_every_ranks_exchange(capfd):
    result, lines = _traced(tiny(run.load_cell("imaging-1M.cpi256.split4")), capfd)
    assert result["correct"] is True
    assert len(lines["clock"]["gather_ms"]) == 4 and all(g is not None for g in lines["clock"]["gather_ms"])
    m = result["metrics"]
    assert m["exchange_ms.imaging"]["value"] == min(lines["clock"]["gather_ms"])
    assert m["rank_skew_ms.imaging"]["value"] == max(lines["clock"]["gather_ms"]) - min(lines["clock"]["gather_ms"])
    assert lines["layers"]["rts.gather.pulse"]["calls"] == 0.5
    assert "shade_ms.trace" not in m  # the terrain cell's
