"""The layers of a pulse of one benchmark cell, read from the program's
spans and counters.

    python3 -m benchmark.layers --workload terrain-1M.fan63 --seed 7 [--seconds 5] [--json layers.json]

Each rank makes the cell's set-up, warm-up and window as ``benchmark.run``
does (``benchmark.run.Program``, ``benchmark.run.window``: ``--seconds``,
one CPI at least), resets the program's counters, and traces
``profile_pulses`` pulses under ``torch.profiler``, the stretch of a
``--trace 1`` run, with the window's last CPI still held; there is no
check.  On standard error:
a ``# layers:`` line (``benchmark.spans.layers``: for each span, a
pulse's calls, host self ms, aten operators, device busy ms of what it
launched, device idle ms inside it; and the counters), the idle gaps named
by span, the per-layer numbers of ``benchmark.spans``, and the clock check
(``cand_kernel`` events launched inside an ``rts.traverse`` span, and
started after it; the bounds of ``benchmark.spans.skew_bounds`` on the
device clock's offset from the host's).  On a split, each rank's device ms under
``rts.gather.pulse`` travels to rank 0.  The last line of standard output
is all of it as JSON.

The ranks are spawned and joined by ``benchmark.run.run_cell``, with this
module's ``layer_rank`` in place of the benchmark's ``run_rank``.
"""

from __future__ import annotations

import argparse
import collections
import json
import sys

import torch

from benchmark import run, spans

_RUN_RANK_MAIN = run._rank_main  # the harness's own, kept before run_layers swaps it
READERS = ("phase1_ms", "phase1_busy_ms", "shade_ms", "replay_ms", "post_ms", "exchange_ms", "rank_skew_ms")


def profile_layers(prog: run.Program, barrier=None) -> spans.SpanRecord:
    """The traced stretch of ``benchmark.run.profile`` (the traversal calls
    captured too) with the program's spans, each device event's launch and
    the counters kept."""
    from torch.profiler import ProfilerActivity, record_function
    from torch.profiler import profile as torch_profile

    from rts_tpu_torch.utils import timing

    n = int(prog.cell.traffic["profile_pulses"])
    shards = prog.mesh.size(0) if prog.mesh is not None else 1
    batch = prog.pulses(n * shards)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if prog.dev.type == "cuda" else [])
    timing.reset()
    with run._Capture():  # holds the traversal calls' tensors, as a traced benchmark run does
        if barrier:
            barrier()
        with torch_profile(activities=acts) as prof:
            with record_function("benchmark.stretch"):
                prog.trace(batch)
                run._sync(prog.dev)
    record = spans.SpanRecord(prepare_s=prog.prepare_s, pulses=n, counters=timing.counters())
    record.host_events, device, record.stretch_ns = run._events(prof)
    record.spans, device_too, launches = spans.span_events(prof)
    record.skew = spans.clock_skew(prof, [(s, e) for name, s, e in record.spans if name == "rts.pulse"])
    if device_too != device:
        raise RuntimeError("benchmark.layers: the device events differ from benchmark.run's")
    lo, hi = record.stretch_ns
    kept = [k for k, ev in enumerate(device) if ev[2] > lo and ev[1] < hi]
    record.device_events = [device[k] for k in kept]
    record.launches = [launches[k] for k in kept]
    record.host_events = [ev for ev in record.host_events if lo <= ev[1] < hi]
    record.host_ops = len(record.host_events)
    return record


def layer_rank(cell: run.Cell, seed: int, seconds: float, trace: bool, dev, mesh=None, barrier=None,
               t_start: float = 0.0) -> dict | None:
    """One process's part: ``benchmark.run.run_rank``'s arguments, this
    module's result (on rank 0)."""
    rank = torch.distributed.get_rank() if mesh is not None else 0
    prog = run.Program(cell, seed, dev, mesh)
    prog.warm(False)
    held = run.window(prog, seconds, False, barrier)
    record = profile_layers(prog, barrier)
    del held
    mine = spans.launched_busy_ms(record, "rts.gather.pulse")
    wall_ms = (record.stretch_ns[1] - record.stretch_ns[0]) * 1e-6
    table = spans.layers(record)
    ranks = [(mine, wall_ms, table)]
    if mesh is not None:
        ranks = [None] * torch.distributed.get_world_size()
        torch.distributed.all_gather_object(ranks, (mine, wall_ms, table))
    if rank != 0:
        return None
    record.gather_ms = [r[0] for r in ranks] if mesh is not None else []
    return {
        "workload": cell.name, "seed": seed, "pulses": record.pulses, "host_ops": record.host_ops,
        "device_events": len(record.device_events),
        "launches_missing": dict(collections.Counter(
            ev[0][:80] for ev, t in zip(record.device_events, record.launches) if t is None)),
        "stretch_ms": wall_ms, "layers": table, "counters": record.counters,
        "idle_gaps": spans.named_gaps(record), "metrics": {name: getattr(spans, name)(record) for name in READERS},
        "clock": {**spans.clock_check(record), **record.skew},
        "ranks": [{"gather_pulse_ms": r[0], "stretch_ms": r[1], "layers": r[2]} for r in ranks],
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type,
    }


def _rank_main(*args) -> None:
    run.run_rank = layer_rank
    _RUN_RANK_MAIN(*args)


def run_layers(cell: run.Cell, seed: int, seconds: float = 0.0, device: str = "cuda") -> dict:
    """``layer_rank``'s result for ``cell``, on one card or on the ranks
    that ``benchmark.run.run_cell`` spawns."""
    saved = run.run_rank, run._rank_main
    run.run_rank, run._rank_main = layer_rank, _rank_main
    try:
        return run.run_cell(cell, seed, seconds, True, device)
    finally:
        run.run_rank, run._rank_main = saved


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.layers")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=5.0, help="the window before the stretch")
    ap.add_argument("--json", default=None, help="also write the result to this file")
    args = ap.parse_args(argv)
    cell = run.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"benchmark.layers: {args.workload} needs {cell.chips} CUDA card(s)", file=sys.stderr)
        return 2
    result = run_layers(cell, args.seed % (1 << 63), args.seconds)
    print("# layers: " + json.dumps({**result["layers"], "counters": result["counters"]}), file=sys.stderr)
    print("# idle gaps: " + json.dumps(result["idle_gaps"]), file=sys.stderr)
    print("# per layer: " + json.dumps(result["metrics"]), file=sys.stderr)
    print("# clock: " + json.dumps(result["clock"]), file=sys.stderr, flush=True)
    line = json.dumps(result)
    if args.json:
        with open(args.json, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
