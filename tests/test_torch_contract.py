"""The port's contract check (``python -m rts_tpu_torch.contract``) on the
CPU, and its two traces against rts_tpu's on ``scripts/verify_contract.py``'s
scene.

- ``--device cpu`` on both variants meets the 1e-6 bar with received
  lanes, and refracted receptions under ``--refr``.
- The port's scene equals verify_contract.py's field for field.
- The reference (the port's float64 brute-force engine on the CPU) meets
  rts_tpu's float64 engine (x64 is on under tests/conftest.py): discrete
  outputs equal; power and aggregated power to rtol 1e-9; the aggregated
  phase to 1e-9 relative to a turn (2 pi rad).
- The production trace of the plain variant equals rts_tpu's production
  trace (the Pallas traversal in interpret mode) in every discrete output.
- The comparison has teeth: a power moved by 2e-6 fails the bar, a
  changed decision raises.
"""

import contextlib
import importlib.util
import io
import json
import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rts_tpu.sim as js
from rts_tpu.engine.cpi import trace_cpi as j_trace_cpi

import rts_tpu_torch.contract as tcontract
from test_torch_bench import _same

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(__file__), "..")
PULSES = 4
VARIANTS = pytest.mark.parametrize("refr", [False, True], ids=["plain", "refr"])


def _load_verify_contract():
    spec = importlib.util.spec_from_file_location("verify_contract",
                                                  os.path.join(ROOT, "scripts", "verify_contract.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


VC = _load_verify_contract()


@pytest.fixture(scope="module")
def runs():
    """Per variant, ``main(["--device", "cpu"])``'s record, the JSON line it
    printed, and the two traces it compared (the production trace and the
    f64 reference, both on the CPU)."""
    cache = {}

    def get(refr):
        if refr not in cache:
            seen, out = {}, io.StringIO()
            real_prod, real_ref = tcontract.production, tcontract.reference
            with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(out):
                mp.setattr(tcontract, "production", lambda *a: seen.setdefault("prod", real_prod(*a)))
                mp.setattr(tcontract, "reference", lambda *a: seen.setdefault("f64", real_ref(*a)))
                record = tcontract.main(["--device", "cpu"] + (["--refr"] if refr else []))
            cache[refr] = dict(record=record, line=out.getvalue(), prod=seen["prod"][0], f64=seen["f64"])
        return cache[refr]

    return get


@VARIANTS
def test_contract_on_the_cpu(runs, refr):
    record = runs(refr)["record"]
    assert record["ok"] and record["platform"] == "cpu" and record["received"] > 0
    assert max(record[k] for k in ("max_rel_power", "max_rel_agg_power", "max_phase_rad")) < record["bar"] == 1e-6
    assert (record["refracted"] > 0) if refr else "refracted" not in record
    assert json.loads(runs(refr)["line"]) == record


@VARIANTS
def test_scene_matches_verify_contract(refr):
    jw, jp = VC.make_scene(PULSES, refr=refr)
    tw, tp = tcontract.make_scene(PULSES, refr=refr)
    for kind in ("transmitters", "receivers", "targets"):
        _same(getattr(jw, kind), getattr(tw, kind), kind)
    for i, (a, b) in enumerate(zip(jw.targets, tw.targets)):
        _same(a.base_mesh(), b.base_mesh(), f"targets[{i}] mesh")
    assert vars(jp) == vars(tp)


@VARIANTS
def test_reference_matches_rts_tpu_f64(runs, refr):
    w, params = VC.make_scene(PULSES, refr=refr)
    ref = j_trace_cpi(*js.prepare_cpi(w, params, dtype=jnp.float64))
    got = runs(refr)["f64"]
    assert got.power.dtype == torch.float64
    rec = np.asarray(ref.received) >= 0
    assert rec.sum() > 0
    np.testing.assert_array_equal(got.received.numpy(), np.asarray(ref.received))
    for f in ("emit", "npath", "path_match"):
        np.testing.assert_array_equal(getattr(got.agg, f).numpy(), np.asarray(getattr(ref.agg, f)), err_msg=f)
    np.testing.assert_allclose(got.power.numpy()[rec], np.asarray(ref.power)[rec], rtol=1e-9, atol=0)
    np.testing.assert_allclose(got.agg.power.numpy()[rec], np.asarray(ref.agg.power)[rec], rtol=1e-9, atol=0)
    d = np.abs(got.agg.phase.numpy() - np.asarray(ref.agg.phase))[rec]
    assert np.minimum(d, 2 * math.pi - d).max() < 1e-9 * 2 * math.pi


def test_production_matches_rts_tpu(runs):
    """The plain variant; under --refr the production trace's decisions
    are held to the f64 reference by the contract itself, and that
    reference to rts_tpu's f64 engine above."""
    w, params = VC.make_scene(PULSES)
    ref = j_trace_cpi(*js.prepare_cpi(w, params, dtype=jnp.float32, preset="production", interpret=True))
    got = runs(False)["prod"]
    assert int((got.received >= 0).sum()) > 0
    np.testing.assert_array_equal(got.received.numpy(), np.asarray(ref.received))
    for f in ("emit", "npath", "path_match"):
        np.testing.assert_array_equal(getattr(got.agg, f).numpy(), np.asarray(getattr(ref.agg, f)), err_msg=f)


def test_compare_has_teeth(runs):
    out, ref = runs(False)["prod"], runs(False)["f64"]
    assert tcontract.compare(out, ref, refr=False)["ok"]
    moved = out._replace(power=out.power * (1 + 2e-6))
    record = tcontract.compare(moved, ref, refr=False)
    assert not record["ok"] and record["max_rel_power"] > 1e-6
    lane = int(torch.nonzero(ref.received[0] >= 0)[0])
    flipped = out.received.clone()
    flipped[0, lane] = -1
    with pytest.raises(AssertionError, match="received"):
        tcontract.compare(out._replace(received=flipped), ref, refr=False)


def test_refuses_without_cuda(monkeypatch):
    """No fallback: without a card and without --device cpu it exits non-zero."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        tcontract.main([])
    assert exc.value.code not in (0, None)
