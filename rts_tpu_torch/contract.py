"""The 1e-6 power/phase contract on the card (counterpart of the repo's
``scripts/verify_contract.py``).

    python -m rts_tpu_torch.contract [--pulses 4] [--refr] [--device cuda]

Traces a bench-style scene with the full production configuration
(``preset="production"``: the clustered CUDA traversal, candidate lists,
the float64 replay and its cap) on ``--device``, and holds per-lane
power, aggregated power and the aggregated phase to the port's float64
brute-force engine run on the host CPU, off the card.  Received lanes
must be identical; power, aggregated power (relative) and the wrapped
phase must each stay under 1e-6.  Reference precision contract:
ray_tracer.h:13-28 (doubles end to end), aggregation.cu:59-60 (double
delay and phase).  ``--refr`` makes the plate dielectric and adds a
forward receiver behind it, and asserts that a refracted lane is
received.

One process does both traces (no platform or precision switch to set
before start-up).  Without a CUDA card and without ``--device cpu`` it
exits non-zero.  Prints one JSON line and exits 1 on a violation;
``main(argv)`` returns the record.
"""

from __future__ import annotations

import argparse
import json
import math
import sys

import torch

from rts_tpu_torch.bench import device_line, require_device
from rts_tpu_torch.config import Parameters
from rts_tpu_torch.engine.cpi import trace_cpi
from rts_tpu_torch.sim import (AttitudePath, Path, RadarSignal, Receiver, RotationPath, Target,
                               Transmitter, World, check_replay_overflow, prepare_cpi)

BAR = 1e-6


def make_scene(num_pulses: int, refr: bool = False):
    """verify_contract.py's scene: a moving icosphere and a rotating plate
    (dielectric, with a forward receiver behind it, under ``refr``)."""
    w = World()
    w.add(
        Transmitter(
            name="tx0",
            path=Path.fixed(0, 0, 0),
            wave=RadarSignal(carrier=10e9),
            pulse_count=num_pulses,
            prf=1000.0,
            tx_span=(0.12, 0.12, 0.0),
        )
    )
    w.add(Receiver(name="rx0", path=Path.fixed(0, 0, 0), sphere=(25.0, 1.2, 1.2)))
    # moving icosphere + rotating plate: time-varying geometry breaks the
    # t=0 symmetry that can leave f32 ray lengths accidentally near-exact.
    # refr variant: the ball moves off the boresight corridor so the
    # central rays reach the dielectric plate (and rx1 behind it)
    ball_y = 250.0 if refr else 0.0
    w.add(
        Target(
            name="ball",
            path=Path.linear([(0.0, (900.0, ball_y, 0.0)), (1.0, (950.0, ball_y + 4.0, 2.0))]),
            shape="sphere",
            sphere_params=(4, 40.0),
            refl_coeff=0.9,
        )
    )
    w.add(
        Target(
            name="plate",
            path=Path.fixed(1200, 30, 0),
            attitude=AttitudePath(yaw_rate=0.05),
            shape="rect",
            rect=(2.0, 120.0, 120.0),
            refl_coeff=0.5 if refr else 0.7,
            refr_index=1.5 if refr else 1.0,
        )
    )
    if refr:
        # forward receiver directly behind the dielectric plate on the
        # boresight line: the exact centre ray refracts straight through
        # the slab into rx1
        w.add(
            Receiver(
                name="rx1",
                path=Path.fixed(2400, 0, 0),
                rotation=RotationPath(azimuth=math.pi),
                sphere=(20.0, 1.5, 1.5),
            )
        )
    params = Parameters(num_rays=9, max_refl_depth=2, max_refr_depth=2 if refr else 0)
    return w, params


def production(num_pulses: int, refr: bool, device):
    """The production trace of the scene on ``device``: (result, its
    received lanes a pulse)."""
    w, params = make_scene(num_pulses, refr=refr)
    base, batch, cfg, spec = prepare_cpi(w, params, dtype=torch.float32, preset="production", device=device)
    out = trace_cpi(base, batch, cfg, spec)
    return out, check_replay_overflow(out, cfg)


def reference(num_pulses: int, refr: bool):
    """The float64 brute-force trace of the scene on the host CPU."""
    w, params = make_scene(num_pulses, refr=refr)
    return trace_cpi(*prepare_cpi(w, params, dtype=torch.float64, device="cpu"))


def compare(out, ref, *, refr: bool, num_rays: int = 9) -> dict:
    """verify_contract.py's comparison of a production trace with the f64
    reference: received lanes equal (raises otherwise), and the maxima of
    the relative power, relative aggregated power and wrapped phase
    errors over the received lanes."""
    host = lambda a: a.detach().cpu()
    rec_ref, rec = host(ref.received), host(out.received)
    record = {}
    if refr:
        n3 = num_rays ** 3
        nref = int((rec_ref[:, n3:] >= 0).sum())
        if nref == 0:
            raise AssertionError("no refracted lanes received: the dielectric variant is vacuous")
        print(f"# refracted-lane receptions: {nref}", file=sys.stderr)
        record["refracted"] = nref
    if not torch.equal(rec, rec_ref):
        raise AssertionError(f"received (discrete decisions) differ on {int((rec != rec_ref).sum())} lanes")
    got = rec_ref >= 0
    n = int(got.sum())
    if n == 0:
        raise AssertionError("the scene received nothing: vacuous")
    rel = lambda a, b: float((host(a).double()[got] / host(b).double()[got] - 1.0).abs().max())
    phase = lambda agg: host(agg.phase).double() + host(agg.phase_lo).double()
    dph = (phase(out.agg) - phase(ref.agg))[got].abs()
    dph = float(torch.minimum(dph, 2 * math.pi - dph).max())
    rel_power, rel_agg = rel(out.power, ref.power), rel(out.agg.power, ref.agg.power)
    return {
        "received": n,
        **record,
        "max_rel_power": rel_power,
        "max_rel_agg_power": rel_agg,
        "max_phase_rad": dph,
        "bar": BAR,
        "ok": bool(rel_power < BAR and rel_agg < BAR and dph < BAR),
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m rts_tpu_torch.contract")
    ap.add_argument("--pulses", type=int, default=4)
    ap.add_argument("--refr", action="store_true", help="dielectric variant: refraction chains + forward Rx")
    ap.add_argument("--device", default="cuda", help="torch device of the production trace (default: cuda)")
    args = ap.parse_args(argv)
    dev = require_device(args.device, "rts_tpu_torch.contract")

    out, counts = production(args.pulses, args.refr, dev)
    print(f"traced {args.pulses} pulses on {dev} (production config, {int(counts.sum())} received)",
          file=sys.stderr)
    if dev.type != "cuda":
        print("WARNING: not a CUDA device: this run does not check the card's kernel", file=sys.stderr)
    record = {"platform": device_line(dev),
              **compare(out, reference(args.pulses, args.refr), refr=args.refr)}
    print(json.dumps(record), flush=True)
    if not record["ok"]:
        print("CONTRACT VIOLATED on the device", file=sys.stderr)
    return record


if __name__ == "__main__":
    sys.exit(0 if main()["ok"] else 1)
