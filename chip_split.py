"""The pulse x ray split of a CPI across the cards of one host.

    python3 chip_split.py                      # on the cards, NCCL
    python3 chip_split.py --device cpu --tris 2000 --pulses 12 --rays 5 --terrain-rays 9   # a gloo rehearsal

Two runs, each with one process per card (``torch.multiprocessing``; the
rendezvous is a ``file://`` under the ignored ``build/``):

  * BASELINE config 5 (``chip_smoke.py`` phase p: ``examples/
    terrain_imaging.py``'s scene at the 1M terrain, 256 pulses, 31^3 rays,
    the production preset at ``bench.py``'s cpi256 knobs) on every card,
    split over the pulses (an (R, 1) mesh of R ranks): 31^3 is prime to
    every small block count, so its fan does not split;
  * BASELINE config 4 (``chip_smoke.py`` phase 3: the 1M terrain at 63^3,
    the production preset, 6 pulses) on 3 cards, split over the pulses
    (3, 1) and over the rays (1, 3).

Every rank prepares the CPI and traces it whole on its own card with
``trace_cpi``, the reference; then ``parallel.trace_cpi_sharded`` traces
it split over each mesh, and every rank's result must equal its own
``trace_cpi`` bit for bit.  Each mesh is made, and its communicators set
up by an untimed run, before the CPIs are timed in turns (whole, each
mesh, each mesh in reverse, whole), in seconds per CPI from the first
rank's start to the last rank's end, beside the K1 launches of each rank.  Rank
0 prints a line per run stamped with every card's name and power limit, a
JSON line per scene, and ``{"ok": true, ...}`` last.  Without a CUDA
card, and without ``--device cpu``, it exits non-zero before printing
any result.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

ROOT = os.path.dirname(os.path.abspath(__file__))


def cards() -> str:
    import subprocess

    return "; ".join(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                                    capture_output=True, text=True, check=True).stdout.strip().splitlines())


def _rank(rank: int, job: dict, init: str, stamp_line: str) -> None:
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from rts_tpu_torch import Parameters
    from rts_tpu_torch.engine.cpi import trace_cpi
    from rts_tpu_torch.ops import cluster_trace as CT
    from rts_tpu_torch.parallel import make_mesh, trace_cpi_sharded
    from rts_tpu_torch.sim import prepare_cpi
    from rts_tpu_torch.utils import timing

    cuda = job["device"] == "cuda"
    if cuda:
        torch.cuda.set_device(rank)
        dev = torch.device("cuda", rank)
    else:
        torch.set_num_threads(1)
        dev = torch.device("cpu")
    dist.init_process_group("nccl" if cuda else "gloo", init_method=f"file://{init}", rank=rank,
                            world_size=job["ranks"])

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)
        dist.barrier()

    def say(msg: str) -> None:
        if rank == 0:
            print(f"[{stamp_line}] {msg}", flush=True)

    try:
        if cuda:  # rank 0 builds the kernel; the others load what it built
            if rank == 0:
                CT.build_kernel()
            dist.barrier()
            CT._load()
        t0 = time.perf_counter()
        params = Parameters(num_rays=job["rays"], max_refl_depth=2)
        if job["scene"] == "config 5":
            state = prepare_cpi(cs.imaging_world(job["pulses"], job["tris"]), params, preset="production",
                                device=dev, **cs.IMAGING_KNOBS)
        else:
            state = prepare_cpi(cs.terrain_world(job["pulses"], job["tris"]), params, preset="production",
                                device=dev)
        say(f"{job['scene']}: prepare_cpi on each of {job['ranks']} ranks: {int(state[0].tri_verts.shape[0])} "
            f"triangles, {job['pulses']} pulses x {job['rays']}^3 rays, {time.perf_counter() - t0:.2f} s")

        # one mesh per shape, made before any timing: a process group's NCCL
        # communicators are set up at its first collective (the warm run)
        meshes = {shape: make_mesh(*shape, device_type=job["device"]) for shape in job["meshes"]}

        def run(mesh_shape):
            """One CPI, whole on each rank's card or split over the mesh:
            (result, seconds from the first start to the last end, this
            rank's K1 launches)."""
            mesh = None if mesh_shape is None else meshes[mesh_shape]
            timing.reset()
            sync()
            t0 = time.perf_counter()
            out = trace_cpi(*state) if mesh is None else trace_cpi_sharded(*state, mesh)
            sync()
            return out, time.perf_counter() - t0, timing.counters().get("traverse.calls", 0)

        ref, _, _ = run(None)  # warm, and the reference each split is held to
        for shape in job["meshes"]:  # warm each mesh's communicators
            run(shape)
        times = {}
        for shape in [None, *job["meshes"], *reversed(job["meshes"]), None]:
            out, seconds, launches = run(shape)
            if not cs.same_result(out, ref):
                raise AssertionError(f"rank {rank}: the CPI on {shape or 'one card'} differs from trace_cpi's")
            counts = [0] * job["ranks"]
            dist.all_gather_object(counts, launches)
            name = "whole" if shape is None else f"{shape[0]}x{shape[1]}"
            times.setdefault(name, []).append(seconds)
            say(f"{job['scene']}: {'trace_cpi on each card' if shape is None else f'trace_cpi_sharded, {name} mesh'}"
                f": {seconds:.3f} s per {job['pulses']}-pulse CPI, bit-identical to trace_cpi; K1 launches by "
                f"rank {counts}")
            if cuda and shape is not None and min(counts) == 0:
                raise AssertionError(f"a rank never launched K1 on the {name} mesh")
        whole = min(times["whole"])
        if rank == 0:
            print(json.dumps({**{k: job[k] for k in ("scene", "device", "ranks", "pulses", "rays")}, "seconds": times,
                              "speedup": {k: whole / min(v) for k, v in times.items()}}), flush=True)
    finally:
        dist.destroy_process_group()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--tris", type=int, default=1_000_000)
    ap.add_argument("--pulses", type=int, default=256, help="config 5's; the terrain CPI takes 6")
    ap.add_argument("--rays", type=int, default=31, help="config 5's fan")
    ap.add_argument("--terrain-rays", type=int, default=63, help="config 4's fan (its cube divides by 3)")
    args = ap.parse_args()
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("chip_split: no CUDA device; this script runs on the cards (or --device cpu)", file=sys.stderr)
            return 2
        ranks = torch.cuda.device_count()
        stamp_line = cards()
    else:
        ranks = 4
        stamp_line = "cpu"
    if ranks < 3 or args.pulses % ranks or args.terrain_rays ** 3 % 3:
        print(f"chip_split: {ranks} cards, {args.pulses} pulses, {args.terrain_rays}^3 rays: needs 3 cards or "
              "more, pulses that divide among them and terrain rays that divide by 3", file=sys.stderr)
        return 2
    jobs = [dict(scene="config 5", ranks=ranks, pulses=args.pulses, rays=args.rays, meshes=[(ranks, 1)]),
            dict(scene="config 4", ranks=3, pulses=6, rays=args.terrain_rays, meshes=[(3, 1), (1, 3)])]
    build = os.path.join(ROOT, "build")
    os.makedirs(build, exist_ok=True)
    for job in jobs:
        job.update(device=args.device, tris=args.tris)
        init = os.path.join(build, f"chip_split_pg_{os.getpid()}")
        try:
            mp.spawn(_rank, args=(job, init, stamp_line), nprocs=job["ranks"], join=True)
        finally:
            if os.path.exists(init):
                os.unlink(init)
    print(stamp_line)
    if args.device == "cuda":
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                                 "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
