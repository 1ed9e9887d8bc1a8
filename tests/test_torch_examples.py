"""The port's examples (examples/torch_*.py) end to end on the CPU, at
reduced sizes where they take sizes, as tests/test_examples.py runs the
JAX ones."""

import os
import runpy
import sys
import tempfile

import pytest
import torch

torch.set_num_threads(1)

EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")


def _run(monkeypatch, capsys, name, *argv):
    monkeypatch.setattr(sys, "argv", [name, *argv, "--device", "cpu"])
    runpy.run_path(os.path.join(EXAMPLES, name), run_name="__main__")
    return capsys.readouterr().out


def test_torch_from_xml_example(capsys, monkeypatch, tmp_path):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    out = _run(monkeypatch, capsys, "torch_from_xml.py")
    assert "total responses:" in out
    assert "rx_mono: " in out
    assert (tmp_path / "responses.npz").exists()


def test_torch_monostatic_sphere_example(capsys, monkeypatch, tmp_path):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    out = _run(monkeypatch, capsys, "torch_monostatic_sphere.py")
    received = int(out.split("received rays across CPI:")[1].split()[0])
    assert received > 0
    assert "range-Doppler peak:" in out
    assert (tmp_path / "cpi_result.npz").exists()


def test_torch_terrain_imaging_example(capsys, monkeypatch):
    out = _run(monkeypatch, capsys, "torch_terrain_imaging.py", "--tris", "8000", "--pulses", "4", "--rays", "5")
    assert "received" in out and "strongest compressed return" in out
    # the strongest return is the moving plate 400 m up, 3,600 m below the radar
    rng = float(out.split("range ~")[1].split()[0])
    assert abs(rng - 3600.0) < 10.0


@pytest.mark.parametrize("name", ["torch_from_xml.py", "torch_monostatic_sphere.py", "torch_terrain_imaging.py"])
def test_examples_import_neither_jax_nor_rts_tpu(name):
    with open(os.path.join(EXAMPLES, name)) as fh:
        imports = [ln.split()[1] for ln in fh if ln.startswith(("import ", "from "))]
    assert not any(m == "jax" or m.startswith(("jax.", "rts_tpu.")) or m == "rts_tpu" for m in imports), imports
