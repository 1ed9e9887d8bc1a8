"""Time the clustered main paths of two checkouts of this repository in
turns on one card.

    python3 chip_turns.py OLD NEW

OLD and NEW are directories that each hold a checkout of the repository
(for example an earlier commit unpacked with ``git archive`` under the
ignored ``build/``, and ``.``).  One child process runs each turn, in the
order OLD, NEW, NEW, OLD, NEW, OLD, OLD, NEW (each side as often first as
last); it imports that checkout's ``rts_tpu_torch`` and
``chip_smoke`` (its worlds and knobs), builds the checkout's kernel, and
prepares two CPIs of ``chip_smoke.PULSES`` pulses at a 63^3 fan: the
terrain-1M (BASELINE config 4, ``preset="production"``) and the
moving-1.3M (config 2, ``chip_smoke.MOVING_KNOBS``).  It traces each CPI
once to warm up and RUNS times timed, and prints the least and the median
ms/pulse, and the PyTorch operators and device events of one pulse under
``torch.profiler`` (the work the host issues and the device runs).  The
last lines are a JSON object per turn and the card's name and power
limit.  Needs a CUDA card: without one it exits non-zero.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

RUNS = 5

TURN = r"""
import json, sys, time
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
import chip_smoke as S
from rts_tpu_torch import Parameters
from rts_tpu_torch.engine.cpi import make_pulse_fn, pulse_args, trace_cpi
from rts_tpu_torch.sim import prepare_cpi

dev = torch.device("cuda")
params = Parameters(num_rays=S.NUM_RAYS, max_refl_depth=2)
out = {"tree": sys.argv[1]}
for name, world, knobs in (("terrain", S.terrain_world(S.PULSES, S.TRIS), dict(preset="production")),
                           ("moving", S.moving_world(S.PULSES), S.MOVING_KNOBS)):
    state = prepare_cpi(world, params, device=dev, **knobs)
    trace_cpi(*state)
    runs = []
    for _ in range(int(sys.argv[2])):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trace_cpi(*state)
        torch.cuda.synchronize()
        runs.append(1e3 * (time.perf_counter() - t0) / S.PULSES)
    out[name] = runs
    one, agg = make_pulse_fn(state[0], state[2], state[3])
    args = pulse_args(state[1], 0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        agg(*one(*args))
        torch.cuda.synchronize()
    events = prof.key_averages()
    out[name + "_ops"] = sum(e.count for e in events if e.key.startswith("aten::"))
    out[name + "_device_events"] = sum(e.count for e in events
                                       if getattr(e, "device_type", None) == DeviceType.CUDA)
    del state, one, agg, args
print(json.dumps(out))
"""


def main() -> int:
    if len(sys.argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    try:
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, check=True)
    except (OSError, subprocess.CalledProcessError):
        print("chip_turns: no CUDA card", file=sys.stderr)
        return 2
    old, new = (os.path.abspath(d) for d in sys.argv[1:])
    results = []
    for tree in (old, new, new, old, new, old, old, new):
        run = subprocess.run([sys.executable, "-c", TURN, tree, str(RUNS)], cwd=tree, capture_output=True,
                             text=True)
        if run.returncode != 0:
            print(run.stdout, run.stderr, file=sys.stderr)
            return 1
        results.append(json.loads(run.stdout.strip().splitlines()[-1]))
        r = results[-1]
        print(f"{tree}: " + ", ".join(f"{k} {min(r[k]):.1f} ms/pulse at least, {statistics.median(r[k]):.1f} "
                                      f"median, {r[k + '_ops']} operators and {r[k + '_device_events']} "
                                      f"device events a pulse" for k in ("terrain", "moving")), flush=True)
    for r in results:
        print(json.dumps(r))
    print(card.stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
