"""The command line refuses to run without a card, a run refuses to print
a result when jax, jaxlib, flax or the JAX package is loaded, and a run
over several ranks leaves no process behind."""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

from benchmark import run
from conftest import SEED, tiny


def test_cli_exits_nonzero_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "terrain-1M.fan63", "--seed",
                           str(2**31 + 5), "--seconds", "1", "--trace", "0"], cwd=run.ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 2
    assert proc.stdout == ""
    assert "needs 1 CUDA card" in proc.stderr


def test_forbidden_modules_compare_whole_top_level_names():
    names = {"jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "rts_tpu", "rts_tpu.sim.cpi",
             "rts_tpu_torch", "rts_tpu_torch.sim", "jaxtyping", "numpy"}
    assert run.forbidden_modules(names) == ["flax.linen", "jax", "jax.numpy", "jaxlib.xla_client", "rts_tpu",
                                            "rts_tpu.sim.cpi"]
    assert run.forbidden_modules({"rts_tpu_torch.engine", "torch"}) == []


def test_emit_refuses_when_a_forbidden_module_is_loaded(monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "rts_tpu.sim", object())
    result = {"correct": True, "attempted": 1, "failed": 0, "metrics": {}, "device": {}, "checked": {}}
    assert run.emit(result) == 3
    out, err = capsys.readouterr()
    assert out == "" and "rts_tpu.sim" in err


def _children() -> list:
    """The pids of this process's live children (zombies included)."""
    me = str(os.getpid())
    kids = []
    for d in Path("/proc").iterdir():
        if d.name.isdigit():
            try:
                stat = (d / "stat").read_text()
            except OSError:
                continue
            if stat.rsplit(")", 1)[1].split()[1] == me:
                kids.append(int(d.name))
    return kids


def test_split_run_leaves_no_process():
    # the ranks are spawned, which starts multiprocessing's resource tracker
    cell = tiny(run.load_cell("imaging-1M.cpi256.split4"))
    assert _children() == []
    assert run.run_cell(cell, SEED, 0.3, False, device="cpu")["correct"] is True
    assert _children() == []
