"""One run of one benchmark cell of rts_tpu_torch.

    python3 -m benchmark.run --workload terrain-1M.fan63 --seed 7 --seconds 10 --trace 0

Reads ``BENCHMARK.json`` at the checkout's root, the cell's configuration
(``benchmark/configs/<config>.json``) and traffic
(``benchmark/traffic/<traffic>.json``), and runs on the card(s):

* set-up: the world made from the configuration and ``--seed`` (the
  terrain's fractal heights), ``prepare_cpi``, the traversal kernel loaded
  from its build under ``build/`` inside the checkout, and a warm-up of
  ``warm_pulses`` pulses of the cell's own CPI (and of its map's shapes);
* the window, a closed loop: the prepared CPI traced (and its map rendered
  and copied to the host) back to back, a new CPI started only while the
  median CPI time so far fits in what remains of ``--seconds``, the first
  always;
* with ``--trace 1``, ``profile_pulses`` pulses of the same CPI under
  ``torch.profiler`` (the traversal calls captured, the program's counters
  reset before and read after), read by the readers in
  ``benchmark/metrics/`` that ``BENCHMARK.json`` lists for the cell; on
  standard error a ``# layers:`` line (``benchmark.spans.layers``, rank
  0's: each span's calls, host self ms, aten operators, device busy ms of
  what it launched and device idle ms inside it, a pulse), a
  ``# counters:`` line and a ``# clock:`` line (the bounds on the device
  clock's offset from the host's; on a split, each rank's device ms under
  ``rts.gather.pulse``);
* the check: the last CPI, and every CPI of the window by fingerprint,
  against the plain reference (``benchmark/reference``, ``benchmark/check``).

The last line of standard output is the result's JSON object; the numbers
compared, each beside its limit, are the last lines of standard error.
Without a card, or with fewer cards than the cell asks for, it exits 2 and
prints no result; it exits 3 and prints no result when jax, jaxlib, flax
or the JAX package is loaded once the window has closed.
"""

from __future__ import annotations

import time

_T0 = time.time()  # the process's start, as near as Python gets to it

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "rts_tpu")
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
os.environ.setdefault("USE_FLAX", "0")

import torch  # noqa: E402


def forbidden_modules(names=None) -> list:
    """Loaded modules whose top-level name (before the first dot) is one of
    ``FORBIDDEN``, compared whole: ``rts_tpu_torch`` is not ``rts_tpu``."""
    names = sys.modules if names is None else names
    return sorted({n for n in names if n.split(".", 1)[0] in FORBIDDEN})


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: list  # BENCHMARK.json entries this cell reports
    per_layer: list


def load_cell(name: str, bench: dict | None = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its data files."""
    from benchmark.adapter import load

    bench = bench or json.loads((ROOT / "BENCHMARK.json").read_text())
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise SystemExit(f"benchmark.run: no workload {name!r} in BENCHMARK.json")
    w = work[name]
    applies = lambda m: name in m.get("workloads", [name])
    e2e = [m for m in bench["end_to_end"] if applies(m)]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if applies(m) and m["moves"] in reported]
    return Cell(name, load("configs", w["config"]), load("traffic", w["traffic"]), int(w["chips"]), e2e, layer)


def reader(metric: str):
    """``read`` of ``benchmark/metrics/<metric>.py``."""
    path = ROOT / "benchmark" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark.metrics.{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclasses.dataclass
class Record:
    """What the traced run hands the metric readers."""

    prepare_s: float
    pulses: int = 0  # pulses this process traced in the profiled stretch
    host_ops: int = 0  # aten operators the profiler saw there
    device_events: list = dataclasses.field(default_factory=list)  # (name, start_ns, end_ns)
    host_events: list = dataclasses.field(default_factory=list)  # aten (name, start_ns, end_ns)
    stretch_ns: tuple = (0, 0)
    traversal_calls: list = dataclasses.field(default_factory=list)
    render_s: list = dataclasses.field(default_factory=list)
    window_s: float = 0.0  # the window's seconds, first CPI's start to last CPI's end
    cpis: int = 0  # the window's CPIs
    spans: list = dataclasses.field(default_factory=list)  # the program's rts.* (name, start_ns, end_ns)
    launches: list = dataclasses.field(default_factory=list)  # per device event: its launch's start_ns, or None
    counters: dict = dataclasses.field(default_factory=dict)  # rts_tpu_torch.utils.timing.counters()
    skew: dict = dataclasses.field(default_factory=dict)  # spans.skew_bounds: the device clock's offset
    gather_ms: list = dataclasses.field(default_factory=list)  # per rank: device ms under rts.gather.pulse


def _tree(fn, x):
    if x is None:
        return None
    if isinstance(x, tuple):
        return type(x)(*(_tree(fn, a) for a in x))
    return fn(x)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def fingerprint(out) -> torch.Tensor:
    """An int64 sum of the bits of every field of a CpiResult, on its device."""
    leaves = []
    _tree(leaves.append, out)
    bits = {1: torch.uint8, 4: torch.int32, 8: torch.int64}
    sums = [(x.contiguous().view(bits[x.element_size()]) if x.dtype != torch.bool else x).sum(dtype=torch.int64)
            for x in leaves]
    return torch.stack(sums)


class Program:
    """The program under test for one cell on one device (one rank of a mesh)."""

    def __init__(self, cell: Cell, seed: int, dev, mesh=None, override=None):
        from benchmark import adapter

        self.cell, self.dev, self.mesh = cell, dev, mesh
        _sync(dev)
        t0 = time.perf_counter()
        self.state = adapter.prepare(cell.config, cell.traffic, seed, dev, **(override or {}))
        _sync(dev)
        self.prepare_s = time.perf_counter() - t0

    def trace(self, batch=None):
        from rts_tpu_torch.engine.cpi import trace_cpi

        base, full, cfg, spec = self.state
        batch = full if batch is None else batch
        if self.mesh is None:
            return trace_cpi(base, batch, cfg, spec)
        from rts_tpu_torch.parallel import trace_cpi_sharded

        return trace_cpi_sharded(base, batch, cfg, spec, self.mesh)

    def render(self, out):
        from benchmark import adapter

        return adapter.render(self.cell.config, self.cell.traffic, out)

    def pulses(self, n: int):
        """The first ``n`` pulses of the prepared CPI as a batch."""
        return _tree(lambda a: a[:n], self.state[1])

    def warm(self, renders: bool):
        """A few pulses of the CPI; then, so that the window's first CPI finds
        the allocator's blocks cached, as many per-pulse results as a CPI
        holds before it stacks them and a result of the CPI's full shape
        (rendered, for a map's FFT plans), all freed again."""
        t = self.cell.traffic
        shards = self.mesh.size(0) if self.mesh is not None else 1
        out = self.trace(self.pulses(int(t["warm_pulses"]) * shards))
        p = int(t["pulses"])
        one = _tree(lambda x: x[0], out)
        held = [_tree(torch.empty_like, one) for _ in range(p // shards)]
        reps = -(-p // out.received.shape[0])
        full = _tree(lambda x: x.repeat((reps,) + (1,) * (x.dim() - 1))[:p], out)
        if renders:
            self.render(full).cpu()
        _sync(self.dev)
        del held, full


def window(prog: Program, seconds: float, renders: bool, barrier=None):
    """The closed loop.  Returns (last CpiResult, its map on the host, the
    fingerprints of every CPI, CPI seconds, render seconds, window start,
    window end on the host's monotonic clock, window start on its wall
    clock)."""
    dev = prog.dev
    times, render_s, prints = [], [], []
    out = rmap = None
    go = True
    if barrier:
        barrier()
    wall0, t0 = time.time(), time.perf_counter()
    while go:
        c0 = time.perf_counter()
        out = rmap = None
        out = prog.trace()
        if renders:
            _sync(dev)
            r0 = time.perf_counter()
            rmap = prog.render(out).cpu()
            render_s.append(time.perf_counter() - r0)
        prints.append(fingerprint(out))
        _sync(dev)
        if barrier:
            barrier()
        c1 = time.perf_counter()
        times.append(c1 - c0)
        go = c1 - t0 + statistics.median(times) <= seconds
        if barrier:
            go = barrier(go)
    return out, rmap, prints, times, render_s, t0, c1, wall0


class _Capture:
    """Wraps the closest-hit call the bounce loop makes, keeping each call's
    inputs and answers (references only: no device work)."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        from rts_tpu_torch.engine import wavefront

        self.mod = wavefront
        self.orig = wavefront.closest_hit_clustered

        def wrapped(origin, direction, tmin, tri_pack, aabb_mn, aabb_mx, *args, **kw):
            hit = self.orig(origin, direction, tmin, tri_pack, aabb_mn, aabb_mx, *args, **kw)
            self.calls.append((origin, direction, tmin, tri_pack, aabb_mn, aabb_mx, hit.t,
                               int(kw.get("cluster_size", 256))))
            return hit

        wavefront.closest_hit_clustered = wrapped
        return self

    def __exit__(self, *exc):
        self.mod.closest_hit_clustered = self.orig


def _runtime(name: str) -> bool:
    """Whether a host event of the profiler's is a call into the CUDA API
    (``cudaLaunchKernel``, ``cuLaunchKernel``, a copy, a synchronisation),
    told by its name: some builds give the events no activity type."""
    return name.startswith("cuda") or (name.startswith("cu") and name[2:3].isupper())


def _events(prof) -> dict:
    """The profiler's raw events, read once, as (name, start_ns, end_ns):
    ``host`` the aten operators, ``device`` the device events, ``stretch``
    the ``benchmark.stretch`` region, ``spans`` the program's ``rts.*``
    regions; ``launches``, for each device event, the start of the runtime
    call that launched it (failing that, of the operator it is linked to),
    None where the profiler recorded neither; and, for the clocks' offset,
    ``ids`` each device event's correlation id and ``calls`` the runtime
    calls as (name, start_ns, end_ns, correlation id)."""
    from torch.autograd import DeviceType

    out = dict(host=[], device=[], stretch=(0, 0), spans=[], ids=[], calls=[])
    runtime, ops, links = {}, {}, []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        s = e.start_ns() if hasattr(e, "start_ns") else 1000 * e.start_us()
        d = e.duration_ns() if hasattr(e, "duration_ns") else 1000 * e.duration_us()
        if e.device_type() == DeviceType.CUDA:
            if name != "benchmark.stretch" and not (hasattr(e, "is_user_annotation") and e.is_user_annotation()):
                out["device"].append((name, s, s + d))
                out["ids"].append(e.correlation_id())
                links.append(e.linked_correlation_id())
        elif _runtime(name):
            runtime[e.correlation_id()] = s
            out["calls"].append((name, s, s + d, e.correlation_id()))
        else:
            ops[e.correlation_id()] = s
            if name == "benchmark.stretch":
                out["stretch"] = (s, s + d)
            elif name.startswith("aten::"):
                out["host"].append((name, s, s + d))
            elif name.startswith("rts."):
                out["spans"].append((name, s, s + d))
    out["launches"] = [runtime.get(c, ops.get(linked) if linked else None) for c, linked in zip(out["ids"], links)]
    return out


def profile(prog: Program, record: Record, barrier=None):
    """``profile_pulses`` pulses of the CPI (each rank's share of that many
    pulses a rank) under the profiler, the traversal calls captured, the
    program's counters reset before and read after."""
    from torch.profiler import ProfilerActivity, record_function
    from torch.profiler import profile as torch_profile

    from benchmark.spans import skew_bounds
    from rts_tpu_torch.utils import timing

    n = int(prog.cell.traffic["profile_pulses"])
    shards = prog.mesh.size(0) if prog.mesh is not None else 1
    batch = prog.pulses(n * shards)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if prog.dev.type == "cuda" else [])
    timing.reset()
    with _Capture() as cap:
        if barrier:
            barrier()
        with torch_profile(activities=acts) as prof:
            with record_function("benchmark.stretch"):
                prog.trace(batch)
                _sync(prog.dev)
    record.counters = timing.counters()
    ev = _events(prof)
    lo, hi = record.stretch_ns = ev["stretch"]
    record.spans = [sp for sp in ev["spans"] if lo <= sp[1] < hi]
    record.skew = skew_bounds([dv + (c,) for dv, c in zip(ev["device"], ev["ids"])], ev["calls"],
                              [(s, e) for name, s, e in record.spans if name == "rts.pulse"])
    kept = [k for k, dv in enumerate(ev["device"]) if dv[2] > lo and dv[1] < hi]
    record.device_events = [ev["device"][k] for k in kept]
    record.launches = [ev["launches"][k] for k in kept]
    record.host_events = [h for h in ev["host"] if lo <= h[1] < hi]
    record.host_ops = len(record.host_events)
    record.pulses = n
    record.traversal_calls = cap.calls


def breakdown(record: Record) -> dict:
    """The ten device operations that took most time, and the ten longest
    idle gaps of the device, each named by the host operator that overlaps
    it most and the span open at that operator's start
    (``spans.named_gaps``); where the host's and the device's clocks
    crossed on some pulse (``spans.skew_bounds``), the gaps are measured
    but not named."""
    from benchmark.spans import named_gaps

    ops = {}
    for name, s, e in record.device_events:
        ops[name] = ops.get(name, 0.0) + (e - s) * 1e-9
    gaps = named_gaps(record)
    if record.skew.get("crossed"):
        gaps = [[f"(not named: the clocks crossed on {record.skew['crossed']} pulses)", g] for _, g in gaps]
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k[:160], v] for k, v in top], "idle_gaps": gaps}


def check(cell: Cell, seed: int, out, rmap, prints, dev) -> tuple:
    """(numbers, CPIs that failed): the last CPI against the reference, the
    others by their fingerprints against it."""
    from benchmark import check as C
    from benchmark.reference import reference_cpi

    ref = reference_cpi(cell.config, cell.traffic, seed, dev)
    numbers = C.compare(C.from_program(out, rmap), ref)
    last = prints[-1]
    same = [bool(torch.equal(p, last)) for p in prints]
    ok = C.verdict(numbers)
    failed = sum(1 for s in same if not (s and ok))
    return numbers, failed


def _card_line(dev) -> str:
    if dev.type != "cuda":
        return dev.type
    import subprocess

    try:
        return subprocess.run(["nvidia-smi", f"--id={dev.index or 0}", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True, check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return torch.cuda.get_device_name(dev)


def run_rank(cell: Cell, seed: int, seconds: float, trace: bool, dev, mesh=None, barrier=None,
             t_start: float = _T0) -> dict | None:
    """One process's part of a run; the result (on rank 0) as a dict."""
    from benchmark import check as C

    rank = torch.distributed.get_rank() if mesh is not None else 0
    renders = bool(cell.traffic.get("render")) and rank == 0
    t_ready = time.time()
    prog = Program(cell, seed, dev, mesh)
    t_prep = time.time()
    prog.warm(renders)
    t_warm = time.time()
    out, rmap, prints, times, render_s, t0, t1, wall0 = window(prog, seconds, renders, barrier)
    setup_s = wall0 - t_start
    if dev.type == "cuda":
        _sync(dev)
        peak = torch.cuda.max_memory_allocated(dev)
    else:
        peak = 0
    record = Record(prepare_s=prog.prepare_s, render_s=render_s, window_s=t1 - t0, cpis=len(times))
    busy = window_ns = 0
    exchange = None
    if trace:
        from benchmark.readers import busy_ns
        from benchmark.spans import launched_busy_ms

        profile(prog, record, barrier)
        busy, window_ns = busy_ns(record), record.stretch_ns[1] - record.stretch_ns[0]
        exchange = launched_busy_ms(record, "rts.gather.pulse")
    if mesh is not None:
        gathered = [None] * torch.distributed.get_world_size()
        torch.distributed.all_gather_object(gathered, (peak, busy, window_ns, exchange))
        peak = max(g[0] for g in gathered)
        busy = sum(g[1] for g in gathered) / len(gathered)
        window_ns = sum(g[2] for g in gathered) / len(gathered)
        record.gather_ms = [g[3] for g in gathered]
    if rank != 0:
        return None
    metrics = {}
    window_s, n_cpi = record.window_s, record.cpis
    values = {"setup_s": setup_s, "peak_mem_gb": peak / 1e9,
              "rays_per_s": int(cell.traffic["num_rays"]) ** 3 * int(cell.traffic["pulses"]) * n_cpi / window_s}
    if not trace:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        for m in cell.per_layer:
            v = reader(m["name"])(record)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    result = {"attempted": n_cpi, "metrics": metrics,
              "device": {"platform": "gpu" if dev.type == "cuda" else dev.type,
                         "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type,
                         "count": cell.chips, "memory_peak_bytes": int(peak)}}
    if trace:
        from benchmark.spans import clock_check, layers

        result["device"].update(busy_s=busy * 1e-9, window_s=window_ns * 1e-9)
        result["breakdown"] = breakdown(record)
        print("# layers: " + json.dumps(layers(record)), file=sys.stderr)
        print("# counters: " + json.dumps(record.counters), file=sys.stderr)
        print("# clock: " + json.dumps({**clock_check(record), **record.skew, "gather_ms": record.gather_ms}),
              file=sys.stderr, flush=True)
    print(f"# set-up parts: start to here {t_ready - t_start:.3f} s (imports, the card's context, ranks "
          f"spawned), prepare_cpi with its world {t_prep - t_ready:.3f} s, warm-up (kernel build "
          f"or load, {cell.traffic['warm_pulses']} pulses a rank, allocator, map) {t_warm - t_prep:.3f} s",
          file=sys.stderr, flush=True)
    print(f"# {cell.name} seed {seed}: {n_cpi} CPI in {window_s:.3f} s {[round(x, 4) for x in times]}, "
          f"set-up {setup_s:.3f} s (prepare_cpi {prog.prepare_s:.3f} s), peak {peak / 1e9:.2f} GB, "
          f"{_card_line(dev)}", file=sys.stderr, flush=True)
    record.traversal_calls = []
    del prog, record
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    c0 = time.perf_counter()
    numbers, failed = check(cell, seed, out, rmap, prints, dev)
    print(f"# check: {time.perf_counter() - c0:.1f} s, {failed} of {n_cpi} CPI failed", file=sys.stderr, flush=True)
    result["correct"] = failed == 0
    result["failed"] = failed
    result["checked"] = {k: {"value": v, "limit": C.LIMITS[k]} for k, v in numbers.items()}
    return result


def emit(result: dict) -> int:
    """Print the numbers compared (stderr) and the result line (stdout);
    refuse to print it when a forbidden module is loaded."""
    found = forbidden_modules()
    if found:
        print(f"benchmark.run: forbidden modules loaded: {', '.join(found)}", file=sys.stderr, flush=True)
        return 3
    for k, v in result["checked"].items():
        print(f"{k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr, flush=True)
    ordered = {k: result[k] for k in ("correct", "attempted", "failed", "metrics", "device")}
    if "breakdown" in result:
        ordered["breakdown"] = result["breakdown"]
    ordered["checked"] = result["checked"]
    print(json.dumps(ordered), flush=True)
    return 0


def _rank_main(rank: int, cell: Cell, seed: int, seconds: float, trace: bool, init: str, device: str,
               queue, t_start: float) -> None:
    import torch.distributed as dist

    from rts_tpu_torch.parallel import make_mesh

    world = cell.chips
    if device == "cuda":
        torch.cuda.set_device(rank)
        dev = torch.device("cuda", rank)
    else:
        torch.set_num_threads(1)
        dev = torch.device("cpu")
    dist.init_process_group("nccl" if device == "cuda" else "gloo", init_method=init, rank=rank,
                            world_size=world)
    try:
        mesh_spec = cell.traffic["mesh"]
        mesh = make_mesh(int(mesh_spec["pulse_shards"]), int(mesh_spec["ray_shards"]), device_type=device)

        def barrier(flag=None):
            _sync(dev)
            if flag is None:
                dist.barrier()
                return None
            box = [flag]
            dist.broadcast_object_list(box, src=0)
            return box[0]

        if device == "cuda":  # rank 0 builds the kernel; the others load what it built
            from rts_tpu_torch.ops import cluster_trace

            if rank == 0:
                cluster_trace.build_kernel()
            dist.barrier()
        result = run_rank(cell, seed, seconds, trace, dev, mesh, barrier, t_start)
        found = forbidden_modules()
        if rank == 0:
            queue.put((result, found))
        elif found:
            print(f"benchmark.run rank {rank}: forbidden modules loaded: {', '.join(found)}", file=sys.stderr)
    finally:
        dist.destroy_process_group()


def _stop_resource_tracker() -> None:
    """Stop and reap the resource tracker that spawning the ranks started.

    Left alone, it ends only after this process has exited, outliving the
    run.  Its users (the ranks, the queue's semaphore) are gone by now: the
    collection lets the semaphore unregister before the tracker's pipe is
    closed, so that nothing starts it again at exit."""
    import gc
    from multiprocessing import resource_tracker

    gc.collect()
    resource_tracker._resource_tracker._stop()


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: str = "cuda") -> dict:
    """Run ``cell`` once on ``device`` ("cuda", or "cpu" for a rehearsal);
    the result dict that ``emit`` prints."""
    if cell.chips == 1 or not cell.traffic.get("mesh"):
        dev = torch.device("cuda", 0) if device == "cuda" else torch.device("cpu")
        if device == "cuda":
            torch.cuda.set_device(dev)
        return run_rank(cell, seed, seconds, trace, dev)
    import tempfile

    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    queue = ctx.SimpleQueue()
    fd, path = tempfile.mkstemp(prefix="benchmark_pg_")
    os.close(fd)
    os.unlink(path)  # the file store makes it anew
    try:  # rank 0's result is a few kilobytes: its pipe write ends before the join
        mp.spawn(_rank_main, args=(cell, seed, seconds, trace, f"file://{path}", device, queue, _T0),
                 nprocs=cell.chips, join=True)
        result, found = queue.get()
    finally:
        if os.path.exists(path):
            os.unlink(path)
        del queue
        _stop_resource_tracker()
    if found:
        raise SystemExit(f"benchmark.run: forbidden modules loaded in rank 0: {', '.join(found)}")
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark.run: {args.workload} needs {cell.chips} CUDA card(s); {have} found", file=sys.stderr)
        return 2
    seed = args.seed % (1 << 63)
    result = run_cell(cell, seed, args.seconds, bool(args.trace))
    return emit(result)


if __name__ == "__main__":
    sys.exit(main())
