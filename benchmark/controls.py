"""The readings that the check's limits are set from, on the card.

    python3 -m benchmark.controls --workload terrain-1M.fan63 --seeds 11,12,13 [--sound-only]

For each seed, in one process: the cell's CPI through the program on one
card as the configuration states it (the sound reading; a split cell's
mesh is not used), and two controls, each judged
by ``benchmark.check.compare`` against the float64 reference:

* ``refine_off``: the program's own lower-precision path, the float64
  replay switched off (``refine=False``: received lanes keep float32);
* ``ref_bf16``: the reference put in the program's place and traced in
  bfloat16, the precision below the float32 traversal.

Prints one JSON line per seed and reading.  The benchmark's runs do not
run this; ``benchmark/tests/test_harness_reference.py`` keeps it at a size
a CPU test holds.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch


def readings(cell, seed: int, dev, sound_only: bool = False) -> dict:
    """{"sound": numbers, ["refine_off": numbers, "ref_bf16": numbers]} of
    one seed."""
    from benchmark import check as C
    from benchmark.reference import reference_cpi
    from benchmark.run import Program, _sync

    out = {}
    kinds = [("sound", {})] + ([] if sound_only else [("refine_off", {"refine": False})])
    results = {}
    for kind, override in kinds:
        prog = Program(cell, seed, dev, override=override)
        cpi = prog.trace()
        results[kind] = C.from_program(cpi, prog.render(cpi))
        del prog, cpi
        _sync(dev)
    ref = reference_cpi(cell.config, cell.traffic, seed, dev)
    for kind, got in results.items():
        out[kind] = C.compare(got, ref)
    if not sound_only:
        low = reference_cpi(cell.config, cell.traffic, seed, dev, dtype=torch.bfloat16)
        out["ref_bf16"] = C.compare(C.from_reference(low), ref)
    return out


def main(argv=None) -> int:
    from benchmark.run import load_cell

    ap = argparse.ArgumentParser(prog="python3 -m benchmark.controls")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--sound-only", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("benchmark.controls: no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device(args.device, 0) if args.device == "cuda" else torch.device("cpu")
    cell = load_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        for kind, numbers in readings(cell, seed, dev, args.sound_only).items():
            print(json.dumps({"workload": args.workload, "seed": seed, "reading": kind, **numbers}), flush=True)
        print(f"# seed {seed}: {time.perf_counter() - t0:.1f} s", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
