"""A configuration, a traffic mix and a per-layer metric that exist only as
new files are found by name, and a tiny cell made of them runs end to end
on the CPU through the harness's internal entry."""

from __future__ import annotations

import json
import shutil

import pytest

from benchmark import adapter, run
from conftest import SEED, TINY


@pytest.fixture
def new_files(tmp_path, monkeypatch):
    """A copy of the benchmark's folder with one more configuration, traffic
    mix and metric reader, the harness pointed at it."""
    src = run.ROOT / "benchmark"
    dst = tmp_path / "benchmark"
    for kind in ("configs", "traffic", "metrics"):
        shutil.copytree(src / kind, dst / kind)
    cfg = json.loads((src / "configs" / "imaging-1M.json").read_text())
    cfg["targets"][0]["terrain"]["n"] = TINY["n"]
    (dst / "configs" / "small-terrain.json").write_text(json.dumps(cfg))
    (dst / "traffic" / "burst4.json").write_text(json.dumps(dict(
        num_rays=TINY["num_rays"], pulses=TINY["pulses"], mesh=None, warm_pulses=1, profile_pulses=2,
        render={"rx": 0, "sample_rate": 50e6, "num_samples": 256, "window_margin_m": 450.0, "compress": True})))
    (dst / "metrics" / "pulses_traced.py").write_text(
        '"""pulses_traced: the pulses of the profiled stretch."""\n\n\ndef read(record):\n'
        '    return float(record.pulses) if record.pulses else None\n')
    bench = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "small-terrain", "source": "a test", "file": "benchmark/configs/small-terrain.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "small-terrain.burst4", "config": "small-terrain", "traffic": "burst4",
                               "chips": 1, "why": "a test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "imaging-1M.cpi256.split4" in m.get("workloads", []):
            m["workloads"].append("small-terrain.burst4")
    bench["per_layer"].append({"name": "pulses_traced", "unit": "pulses", "better": "higher",
                               "source": "device_trace", "layer": "pulse loop", "moves": "peak_mem_gb",
                               "workloads": ["small-terrain.burst4"]})
    monkeypatch.setattr(run, "ROOT", tmp_path)
    monkeypatch.setattr(adapter, "ROOT", dst)
    return bench


def test_new_files_are_found_by_name(new_files):
    cell = run.load_cell("small-terrain.burst4", new_files)
    assert cell.config["targets"][0]["terrain"]["n"] == TINY["n"]
    assert cell.traffic["pulses"] == TINY["pulses"]
    assert cell.chips == 1
    assert [m["name"] for m in cell.end_to_end] == ["setup_s", "peak_mem_gb"]
    names = [m["name"] for m in cell.per_layer]
    assert "pulses_traced" in names and "mt_traverse_roofline" not in names
    assert run.reader("pulses_traced")(run.Record(prepare_s=1.0, pulses=2)) == 2.0


@pytest.mark.parametrize("trace", [0, 1])
def test_tiny_cell_runs_end_to_end(new_files, trace, capsys):
    cell = run.load_cell("small-terrain.burst4", new_files)
    result = run.run_cell(cell, SEED, 0.5, bool(trace), device="cpu")
    assert run.emit(result) == 0
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    required = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[:5] == required
    assert set(line) - set(required) <= {"breakdown", "checked"} and list(line)[-1] == "checked"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    want = {"setup_s", "peak_mem_gb"} if not trace else {"prepare_s", "host_ops_per_pulse.imaging", "render_ms",
                                                         "cpi_s.imaging", "pulses_traced"}
    assert set(line["metrics"]) == want
    assert line["device"]["platform"] == "cpu" and line["device"]["count"] == 1
    tail = err.strip().splitlines()[-len(line["checked"]):]
    assert [t.split()[0] for t in tail] == list(line["checked"])
    assert all(" limit " in t for t in tail)
