"""The cell ``dielectric-1M.fan63`` (BASELINE config 3) loads through
``load_cell`` and the adapter with no key refused, reports the terrain
cell's metrics, the peak memory and the refraction span's two, whose readers read the
``rts.refract`` spans of a record and nothing where it has none; and a
tiny cut of it runs end to end, traced, on the CPU."""

from __future__ import annotations

import json

import pytest

from benchmark import adapter, run
from conftest import SEED, tiny

NAME = "dielectric-1M.fan63"
NS = 1e-6  # ms a nanosecond


def test_the_cell_loads_and_the_adapter_passes_every_key():
    cell = run.load_cell(NAME)
    assert cell.chips == 1 and cell.traffic == run.load_cell("terrain-1M.fan63").traffic
    assert cell.config["reduced"] == []
    w, params = adapter.world(cell.config, cell.traffic, SEED)
    assert [t.refr_index for t in w.targets] == [1.0, 1.5]
    assert [t.refl_coeff for t in w.targets] == [0.9, 0.5]
    assert [r.path.position(0.0)[2] for r in w.receivers] == [4000.0, 600.0]
    assert params.max_refr_depth == 2 and params.max_refl_depth == 2 and params.num_rays == 63


def test_the_cell_reports_the_terrain_cells_metrics_and_the_refraction_spans():
    cell, terrain = run.load_cell(NAME), run.load_cell("terrain-1M.fan63")
    # and the peak memory of the 3N^3 lane slots
    assert [m["name"] for m in cell.end_to_end] == [m["name"] for m in terrain.end_to_end] + ["peak_mem_gb"]
    names = [m["name"] for m in cell.per_layer]
    assert names == [m["name"] for m in terrain.per_layer] + ["refract_ms.trace", "refract_busy_ms.trace"]


def _record(with_refract: bool = True) -> run.Record:
    """Two pulses, each a segment holding two refraction spans (the spawn
    and the children's landing); device events with their launches."""
    sp = [("rts.pulse", 0, 400), ("rts.segment", 10, 200), ("rts.refract", 50, 80), ("rts.refract", 120, 130),
          ("rts.pulse", 500, 900), ("rts.segment", 510, 700), ("rts.refract", 550, 590), ("rts.refract", 650, 660)]
    if not with_refract:
        sp = [s for s in sp if s[0] != "rts.refract"]
    dev = [(("k1", 60, 90), 55), (("k2", 85, 100), 70), (("k3", 125, 140), 125), (("k4", 140, 150), 100),
           (("k5", 560, 600), 560)]
    return run.Record(prepare_s=1.0, pulses=2, stretch_ns=(0, 1000), spans=sp,
                      device_events=[d for d, _ in dev], launches=[t for _, t in dev])


def test_the_refraction_readers_on_a_known_record():
    rec = _record()
    assert run.reader("refract_ms.trace")(rec) == pytest.approx((30 + 10 + 40 + 10) / 2 * NS)
    # k1 and k2 overlap; k4 was launched outside the spans
    assert run.reader("refract_busy_ms.trace")(rec) == pytest.approx((100 - 60 + 15 + 40) / 2 * NS)


@pytest.mark.parametrize("name", ["refract_ms.trace", "refract_busy_ms.trace"])
def test_the_refraction_readers_read_nothing_without_the_span(name):
    assert run.reader(name)(_record(with_refract=False)) is None


def test_a_tiny_cut_runs_end_to_end_traced(capsys):
    cell = tiny(run.load_cell(NAME))
    result = run.run_cell(cell, SEED, 0.5, True, device="cpu")
    assert run.emit(result) == 0
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert line["correct"] is True
    assert {"refract_ms.trace", "refract_busy_ms.trace", "host_ops_per_pulse.trace"} <= set(line["metrics"])
    counters = json.loads(next(ln for ln in err.splitlines() if ln.startswith("# counters: "))[len("# counters: "):])
    assert counters["refract.spawned.trapped"] > 0 and counters["replay.unrefined"] == 0
    layers = json.loads(next(ln for ln in err.splitlines() if ln.startswith("# layers: "))[len("# layers: "):])
    assert layers["rts.refract"]["calls"] == 4  # a pulse: two spawn segments, two regions each
