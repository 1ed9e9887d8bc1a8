"""Chip smoke run of the PyTorch/CUDA port (rts_tpu_torch) on one GPU.

    python3 chip_smoke.py

Drives the port's main path — the production CPI of the 1M-triangle
terrain scene (BASELINE config 4) — through its public entry points, and
fails with a non-zero exit at the first error.  There is no CPU fallback:
without a CUDA card it exits non-zero before printing any result.

Phases (each line stamped with the card's name and power limit):
  1. build the traversal kernel (csrc/mt_traverse.cu) from source;
  2. kernel against its plain PyTorch version: the segment-1 rays of one
     pulse of the terrain scene at the production knobs, and a small scene
     sweep-only (candidates=0); tri/found must be identical and t/beta/
     gamma bit-equal (both round every product and divide in IEEE);
  3. main path: prepare_cpi(preset="production", refine=False,
     device="cuda") and trace_cpi over 8 pulses at a 63^3 fan; checks
     received > 0, finite power, kernel launches counted, and a second
     run bit-identical (deterministic reductions);
  4. one pulse of the main path through the plain traversal: received,
     emit and path rows must equal the kernel run's.

The line before the card line is a JSON object with the kernel's launches,
error and times; the last line is the JSON result.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import torch

NUM_RAYS = 63
PULSES = 8
TRIS = 1_000_000  # the main path's terrain
SMALL_TRIS = 20_000  # the sweep-mode check's terrain
DEVICE = "cuda"


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def stamp(card: str, msg: str) -> None:
    print(f"[{card}] {msg}", flush=True)


def terrain_world(pulses: int, tris: int):
    """BASELINE config 4 (bench.py --scene terrain): a ~1M-triangle fractal
    terrain plus a 60 m calibration plate, Tx/Rx at 4 km looking down."""
    from rts_tpu_torch.sim import (AttitudePath, Path, RadarSignal, Receiver, RotationPath,
                                   Target, Transmitter, World)

    n = max(2, round(math.sqrt(tris / 2)) + 1)
    w = World()
    w.add(Transmitter(path=Path.fixed(0.0, 0.0, 4000.0), wave=RadarSignal(carrier=10e9),
                      pulse_count=pulses, prf=1000.0, tx_span=(0.15, 0.15, 0.0),
                      rotation=RotationPath(elevation=-math.pi / 2)))
    w.add(Receiver(path=Path.fixed(0.0, 0.0, 4000.0), sphere=(25.0, 1.2, 1.2),
                   rotation=RotationPath(elevation=-math.pi / 2)))
    w.add(Target(shape="terrain", terrain=(n, 12000.0, 300.0, 3),
                 path=Path.fixed(0.0, 0.0, 0.0), refl_coeff=0.9))
    w.add(Target(shape="rect", rect=(2.0, 60.0, 60.0), attitude=AttitudePath(pitch=math.pi / 2),
                 path=Path.fixed(0.0, 0.0, 400.0), refl_coeff=0.9))
    return w


def time_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps calls, by CUDA events."""
    fn()
    sync()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    sync()
    return start.elapsed_time(end) / reps


def sync() -> None:
    torch.cuda.synchronize()


def bit_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.dtype.is_floating_point:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def compare_hits(got, ref, what: str) -> float:
    for name in ("found", "tri"):
        if not torch.equal(getattr(got, name), getattr(ref, name)):
            raise AssertionError(f"{what}: {name} differs from the plain version")
    err = 0.0
    f = ref.found
    for name in ("t", "beta", "gamma"):
        a, b = getattr(got, name)[f], getattr(ref, name)[f]
        err = max(err, float((a - b).abs().max()) if a.numel() else 0.0)
        if not bit_equal(a, b):
            raise AssertionError(f"{what}: {name} not bit-equal (max abs err {err})")
    return err


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from rts_tpu_torch import Parameters
    from rts_tpu_torch.core.constants import SCENE_EPS
    from rts_tpu_torch.engine.animate import animate_packed
    from rts_tpu_torch.engine.cpi import make_pulse_fn, trace_cpi
    from rts_tpu_torch.engine.fan import generate_fan_c
    from rts_tpu_torch.ops import cluster_trace as CT
    from rts_tpu_torch.sim import prepare_cpi

    dev = torch.device(DEVICE)
    card = card_line()
    torch.manual_seed(0)

    # ---- 1. build
    t0 = time.perf_counter()
    lib = CT.build_kernel(verbose=True)
    CT._load()
    stamp(card, f"phase 1 build: {lib.name} in {time.perf_counter() - t0:.2f} s")

    # ---- 2. kernel against plain
    def segment1(tris, **options):
        """CPI state and the segment-1 closest_hit_clustered arguments of
        pulse 0, for a terrain world of ~tris triangles."""
        t0 = time.perf_counter()
        state = prepare_cpi(terrain_world(PULSES, tris), Parameters(num_rays=NUM_RAYS, max_refl_depth=2),
                            preset="production", refine=False, device=dev, **options)
        base, batch, cfg, spec = state
        scene = animate_packed(base, batch.rot[0], batch.pos[0], batch.vel[0])
        fan = generate_fan_c(cfg.num_rays, (batch.tx_dir[0, 0], batch.tx_dir[0, 1]), spec.tx_span,
                             device=dev)
        origin = batch.tx_origin[0][:, None].expand(3, fan.shape[1]).contiguous()
        tmin = torch.full((fan.shape[1],), SCENE_EPS, device=dev)
        knobs = dict(cluster_size=cfg.cluster_size, ray_tile=cfg.ray_tile,
                     group_size=cfg.group_size, super_size=cfg.super_size,
                     sub_tiles=cfg.sub_tiles, candidates=cfg.candidates, mt_group=cfg.mt_group,
                     mt_tail=cfg.mt_tail, p1_fanout=cfg.p1_fanout, p1_super_k=cfg.p1_super_k)
        args = (origin, fan, tmin, scene.tri_pack, scene.aabb_mn, scene.aabb_mx, batch.tx_origin[0])
        stamp(card, f"prepare_cpi: {int(base.tri_verts.shape[0])} triangles, "
                    f"{cfg.rays_per_fan} rays/pulse, {time.perf_counter() - t0:.2f} s")
        return state, args, knobs

    def check(args, knobs, what):
        """Kernel against plain on one segment; times of each version on
        the same phase-1 lists (captured from the kernel's call)."""
        got = CT.closest_hit_clustered(*args, **knobs)
        ref = CT.closest_hit_clustered(*args, traverse=CT.mt_traverse_reference, **knobs)
        sync()
        err = compare_hits(got, ref, what)
        captured = []

        def capture(inp, shape):
            captured.append((inp, shape))
            return CT.mt_traverse(inp, shape)

        CT.closest_hit_clustered(*args, traverse=capture, **knobs)
        inp, shape = captured[0]
        ms = time_ms(lambda: CT.mt_traverse(inp, shape), 20)
        plain_ms = time_ms(lambda: CT.mt_traverse_reference(inp, shape), 2)
        stamp(card, f"phase 2 {what}: {int(got.found.sum())} of {args[1].shape[1]} rays hit, "
                    f"{inp.meta.shape[0]} tiles ({int(inp.meta[:, 1].sum())} swept), tri/found "
                    f"identical, t/beta/gamma bit-equal; kernel {ms:.3f} ms, plain "
                    f"{plain_ms:.3f} ms per call")
        return err, ms, plain_ms

    (base, batch, cfg, spec), hit_args, knobs = segment1(TRIS)
    err, ms, plain_ms = check(hit_args, knobs, "terrain segment 1")
    # sweep mode: a small terrain with candidates=0 (every tile walks the
    # supergroup/group/cluster hierarchy)
    _, s_args, s_knobs = segment1(SMALL_TRIS, candidates=0)
    err = max(err, check(s_args, s_knobs, "sweep mode (candidates=0)")[0])

    # ---- 3. main path
    CT.mt_traverse.launches = 0
    sync()
    t0 = time.perf_counter()
    out = trace_cpi(base, batch, cfg, spec)
    sync()
    first_s = time.perf_counter() - t0
    launches = CT.mt_traverse.launches
    received = int((out.received >= 0).sum())
    if launches == 0:
        raise AssertionError("the main path never launched the traversal kernel")
    if received == 0:
        raise AssertionError("no ray was received")
    if not bool(torch.isfinite(out.power).all() and torch.isfinite(out.agg.power).all()):
        raise AssertionError("non-finite power")
    P, R = PULSES, cfg.rays_per_fan
    if tuple(out.received.shape) != (P, R) or tuple(out.agg.emit.shape) != (P, R):
        raise AssertionError(f"unexpected result shape {tuple(out.received.shape)}")
    t0 = time.perf_counter()
    again = trace_cpi(base, batch, cfg, spec)
    sync()
    second_s = time.perf_counter() - t0
    for name, a, b in zip(out._fields, out, again):
        pairs = zip(a, b) if isinstance(a, tuple) else [(a, b)]
        if not all(bit_equal(x, y) for x, y in pairs):
            raise AssertionError(f"second run differs in {name}: reductions are not deterministic")
    best_s = min(first_s, second_s)
    stamp(card, f"phase 3 main path: {P} pulses x {R} rays, {received} received lanes, "
                f"{int(out.agg.emit.sum())} emitted paths, {launches} kernel launches; "
                f"{1e3 * best_s / P:.1f} ms/pulse, {P * R / best_s:.4g} rays/s "
                f"(first run {first_s:.2f} s, second {second_s:.2f} s, bit-identical)")

    # ---- 4. one pulse through the plain traversal, against the kernel
    rx0 = type(batch.rx_geom)(*(a[0] for a in batch.rx_geom))
    pulse0 = (batch.rot[0], batch.pos[0], batch.vel[0], rx0, batch.rx_pos[0],
              batch.tx_origin[0], batch.tx_dir[0], batch.times[0])
    runs = []
    for traverse in (None, CT.mt_traverse_reference):
        one_pulse, aggregate = make_pulse_fn(base, cfg, spec, traverse=traverse)
        res, power, doppler, delay = one_pulse(*pulse0)
        runs.append((res, aggregate(res, power, doppler, delay)))
    (res_k, out_k), (res_p, out_p) = runs
    for name, a, b in (("received", res_k.received, res_p.received),
                       ("path rows", res_k.path, res_p.path),
                       ("emit", out_k.agg.emit, out_p.agg.emit),
                       ("trace_cpi pulse 0", out_k.received, out.received[0])):
        if not torch.equal(a, b):
            raise AssertionError(f"plain-traversal pulse differs in {name}")
    stamp(card, f"phase 4 plain-traversal pulse: received ({int((res_p.received >= 0).sum())} "
                "lanes), path rows and emit identical to the kernel run")

    print(json.dumps({"kernels": [{
        "name": "mt_traverse",
        "route": "cuda",
        "source": "rts_tpu_torch/ops/csrc/mt_traverse.cu",
        "replaces": "rts_tpu/ops/cluster_trace.py:249",
        "launches": launches,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
