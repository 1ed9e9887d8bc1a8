"""Chip smoke run of the PyTorch/CUDA port (rts_tpu_torch) on one GPU.

    python3 chip_smoke.py

Drives the port's main paths through their public entry points and fails
with a non-zero exit at the first error: the production CPI of the
1M-triangle terrain (BASELINE config 4), the 256-pulse CPI of the same
terrain rendered to a compressed range-Doppler map (config 5), the
same CPI with the
traversal's live-cluster pack (K5, ``bench.py --resident-cap``) and with
per-candidate windows (K6, ``--no-mt-union``), the moving-shell CPI of
four 1.31M-triangle icospheres (BASELINE config 2, ``bench.py --scene
moving``), the default entry points: the f64 brute-force engine and
parity preset on the sphere scene (config 1), held to the 1e-6 contract
against the production preset, and the sequential driver on README.md's
quick start; and the dielectric CPI with refraction (config 3,
``bench.py --scene dielectric``); the physics models, and the CLI on
examples/scene.xml; the config-5 CPI split over a process mesh, the
terrain CPI in ray blocks, the native host geometry, the NumPy oracle
against the card, the port's examples, its bench and its contract check.  There is no CPU fallback: without a
CUDA card it exits non-zero before printing any result.

Phases (each line stamped with the card's name and power limit):
  1. build the kernels (csrc/mt_traverse.cu, csrc/phase1.cu, csrc/shade.cu) from source, with the
     compiler's register report; the candidate and sweep grids' blocks and
     warps per SM at the two paths' shapes;
  2. kernel against its plain PyTorch version: the segment-1 rays of one
     pulse of the terrain scene at the production knobs, and a small scene
     sweep-only (candidates=0); tri/found must be identical and t/beta/
     gamma bit-equal (both round every product and divide in IEEE);
  3. terrain main path: prepare_cpi(preset="production", device="cuda")
     (refine=True: the float64 replay) and trace_cpi over 8 pulses at a
     63^3 fan; checks received > 0, finite power, kernel launches counted,
     and a second run bit-identical (deterministic reductions); the swept
     tiles of every launch, as the kernel counts them on the device;
  4. one terrain pulse through the plain traversal: received, emit and
     path rows must equal the kernel run's;
  5. the shading kernel (csrc/shade.cu, engine.wavefront.shade_cuda) on
     every segment of pulse 0 of the terrain CPI (63^3, its narrow segment
     on the gathered rows), the dielectric CPI (config 3: the two spawn
     segments' miss half and the four whole segments) and config 5 (31^3,
     the cpi256 knobs): each launch's operands as the pulse gave them, the
     kernel on copies against _process_miss and _process_hit on copies,
     every LaneState field and both buffers bit for bit; the kernel's
     device time (torch.profiler), its wrapper's host time, the plain
     programs' time, launches and device time on the card, and the bound:
     the bytes that call's lanes must move over the memory rate.  Runs
     alone as python3 -c "import chip_smoke as s, torch; s.shade_phases(s.card_line(), torch.device('cuda'))"
  a. moving scene, segment 1 of pulse 0 at its knobs (mt_prune=True, K3):
     kernel against plain (tri/found identical, t/beta/gamma bit-equal),
     and the kernel with the prune against the kernel without it; the
     segment's swept tiles alone (the sweep, K2: against plain, with its
     pairs and bound) and its candidate tiles alone (the candidate grid);
  b. the same with emit_shade=True (K4): shade bit-equal to the plain gather;
  c. moving main path: 8 pulses with refine=True; received > 0, finite,
     K3 launches and the sweep's calls and swept tiles counted, a second run
     bit-identical, no replay-cap overflow; ms/pulse and rays/s;
  d. one moving pulse with shade_emit=True against the gather: identical
     received lanes, path rows and emit; K4 launches counted;
  e. one moving pulse refined against unrefined: every decision identical;
     the largest change in power and phase, and the replay's time;
  f. terrain segment 1 with resident_cap=512 (K5): kernel against plain and
     against phase 2's kernel, bit for bit; the live set and the swept
     tiles; K1 and K5 timed in turns; then resident_cap=8, whose live set
     overflows, so that every tile sweeps: against plain (with its pairs
     and bound), bit-equal to the sweep-only kernel, and to K1 up to exact
     t ties (the sweep visits the clusters in another order, and a tie goes
     to the first visited);
  g. terrain segment 1 with mt_union=False (K6) and with cand_order="mask":
     each against plain; K6 bit-equal to phase 2, the mask order up to
     exact t ties; K1 and K6 in turns;
  h. moving segment 1 with mt_group=4, mt_union=False, mt_prune=True (K6
     with the prune, at a window K1 cannot stage): against plain and
     bit-equal to phase a;
  i. the terrain CPI through prepare_cpi with resident_cap=512 and with
     mt_union=False, 8 pulses each: bit-identical to phase 3, K5/K6
     launches counted, no live-set overflow, a second run bit-identical;
  j. profile: torch.profiler over one warm pulse of each main path (the
     terrain at the production preset, the moving shells at MOVING_KNOBS,
     after phase m the dielectric CPI of phase n, and in phase p config
     5): device time against the wall, the kernel's share of device time,
     the five largest operators by device time; the aten operators issued
     and the five largest by their own host time.  Printed only; it gates
     nothing;
  k. the default entry point: prepare_cpi(dtype=float64) with no options
     (the brute-force engine) and with preset="parity" on the sphere scene
     (BASELINE config 1, its icosphere cut to 20,480 triangles), one pulse
     at a 63^3 fan: a second run (through the pulse function, under the
     profiler) bit-identical, ms/pulse, pairs/s, device launches; the
     float32 defaults through run_all_cpi; segment 1 on 4,096 rays against
     the port on the CPU (tri/found identical, t/beta/gamma within 1e-12);
  l. the 1e-6 power/phase contract on the card: the production preset (the
     f32 kernel with the sphere knobs, and the f64 replay) against phase k's
     f64 trace: received lanes and path rows identical (a lane that differs
     is printed with the f64 engine's barycentrics and passes only if, at
     the first chain step where the two sides hit another triangle, the
     f64 hit lies within 1e-5 of its triangle's edge), per-lane power, aggregated power and phase
     within 1e-6; the same on the moving scene at subdivision 5, 1 pulse;
  m. README.md's quick start (sequential driver rts_tpu_torch.sim.run, f64
     brute force, 64 pulses) on the card against the same run on the CPU:
     the same responses, power, delay, Doppler and phase within 1e-9;
  n. the dielectric main path (BASELINE config 3: the 1M terrain under a
     200 m dielectric slab, two receivers; 3 x 63^3 lanes, 6 segments,
     results 5 x 63^3 wide) through prepare_cpi(preset="production"), 8
     pulses: the lanes each receiver receives a pulse, counted on a trace
     without the replay, set the replay cap (the smallest power of two at
     or above the most, at least 128); with the replay received > 0,
     finite, K1 launches counted, no lane past 3 x 63^3 received, a second
     run bit-identical, and every decision that of the trace without the
     replay; ms/pulse and rays/s (a ray is a launch cell with its
     children); one pulse with each segment's lanes traced, live lanes by
     slot and swept tiles; the kernel against plain on its segment-2 (the
     trapped children) and segment-3 (the exiting children) operands, bit
     for bit, with times, pairs and bounds; one pulse with
     fan_order="morton2" and one with compact_lanes=True against raster,
     bit-identical on every lane whose chain of triangles is raster's, a
     lane that parts doing so on triangles that share a corner (an exact t
     tie), and segment 1 held by compare_ties;
  o. the 1e-6 contract of phase l, 1 pulse at 63^3 against the card's own
     f64 brute-force engine, the edge-tie rule followed into the refracted
     children's chains: on config 3 with its terrain cut to ~20k triangles
     (DIELECTRIC_CUT_TRIS), and on the dielectric plate of
     tests/test_replay.py:83, whose forward receiver must receive exiting
     chains;
  p. BASELINE config 5 (examples/terrain_imaging.py's scene at the 1M
     terrain with its moving 30 m plate; 256 pulses at 2 kHz, 31^3 rays,
     LFM 5e12 Hz/s over 4 us) through run_cpi(preset="production") at
     bench.py's cpi256 knobs (ray_tile 128, sub_tiles 2, candidates 32,
     replay_cap 64, raised to the smallest power of two at or above the
     most lanes a pulse receives if that overflows it, agg_cap 1024):
     seconds per CPI on a warm second run (bit-identical), received lanes
     a pulse, K1 launches and swept tiles, peak device memory; then
     render_cpi_result (compressed, Taylor range window): its ms and peak
     memory, the map within 1e-5 of its peak of the same render of the
     same CpiResult on the CPU with the same argmax, the strongest
     return's range and Doppler; K1 against plain on pulse 0's segment-1
     operands, bit for bit, with time, pairs and bound; the occupancy at
     (128, 2); a profile of one pulse (phase j);
  q. every antenna and RCS model on 1e6 seeded directions, card against
     CPU, within 1e-3 of the model's peak in float32 and 1e-10 in
     float64; the terrain CPI of phase 3 unrefined with
     rx_geom_on_device=True against False: the geometry within rtol 1e-6
     / atol 5e-6, received lanes identical but for lanes printed with
     their distance to the acceptance window's edge, which must be
     within 1e-5 rad;
  r. the CLI (rts_tpu_torch.__main__.main) on examples/scene.xml: run
     --cpi --accel cluster --refine on the card against --device cpu
     (power and phase within 1e-6), the default run (the f64 driver)
     within 1e-9 (phase m's rule), the same counts printed; the saved
     .npz read back equal to a run's in-memory responses; info;
  s. phase p's config-5 CPI through the pulse x ray split
     (parallel.trace_cpi_sharded on make_mesh(1, 1), a process group of
     one NCCL rank): bit-identical to phase p's trace_cpi, as many K1
     launches (768), its seconds per CPI beside trace_cpi's before it
     (phase p's warm run) and after it;
  t. phase 3's terrain CPI (config 4, 63^3, the production preset), 2
     pulses, traced whole and in 3 and in 9 ray blocks (make_pulse_fn(
     fan_slice=...)) put back by parallel.sharding.regather_lanes on the
     card and aggregated: received lanes, path rows and emit identical to
     the whole pulses, every lane of the same chain of triangles bit-equal
     (power and phase included), a lane that parts doing so on an exact-t
     tie (compare_pulse_ties), counted; K1 launches per block, and ms per
     pulse of each split against the whole pulse in turns (whole, 3, 9, 9,
     3, whole);
  u. the native host geometry (rts_tpu_torch.native, built with g++): the
     Morton permutation of the 999,698-triangle terrain equal with and
     without the library (RTS_NO_NATIVE), both host times; load_triplets
     equal to the NumPy parser on a mesh from write_mesh_files;
  v. the card's f64 brute-force engine against the port's NumPy oracle
     (rts_tpu_torch.oracle) on three scenes of
     tests/test_engine_vs_oracle.py (the 27-ray sphere fan, the two-plate
     double bounce, the dielectric slab with two receivers), with
     assert_match's rules: discrete outputs equal, continuous ones within
     rtol 1e-9;
  w. the port's examples on the card (examples/torch_*.py, the terrain
     one at 20,000 triangles, 8 pulses, 7^3 rays): each prints its
     closing line;
  x. the port's bench (rts_tpu_torch.bench.main, in process; BENCH_RUNS):
     --tiny; config 4 at full width (--scene terrain --pulses 8 --repeat 2
     --no-cpi256 --stats: 999,698 triangles, 63^3); config 1 at bench.py's
     full width (--scene sphere --pulses 2 --repeat 1 --no-cpi256:
     1,310,720 triangles, 63^3, the shell knobs, K3 and the sweep on the
     tiles that overflow): each run's printed lines and record, a finite
     rays/s and received lanes, K1 and K3 launches, swept tiles and peak
     device memory; the terrain's second trace_cpi bit-identical to its
     first;
  y. the port's contract check (rts_tpu_torch.contract.main) on the
     card, plain and --refr: the production trace on the card against the
     float64 brute-force engine on the host CPU; its record must be ok;
  z. phase 1's kernel (csrc/phase1.cu) on every closest_hit_clustered
     call of pulse 0 of the terrain CPI (config 4) and of config 5 at the
     cpi256 knobs: the cand/meta/bits/ent its launch in the main path gave
     phase 2, equal to _tile_candidates' on the CPU; the kernel's time and
     the plain version's on the card, and the kernel's bound.  Runs alone as
     python3 -c "import chip_smoke as s, torch; s.phase1_phases(s.card_line(), torch.device('cuda'))"

Each kernel-against-plain phase (2, a, b, f, g, h) counts the (ray,
column) pairs the plain version evaluates and the distinct clusters whose
columns they read.  Modes whose hits are bit-identical on the same inputs
compute the same function (K1, K5 and K6 on terrain segment 1; K3, K4 and
K6 + K3 on moving segment 1), so each of them gets the bound of the
fewest pairs and clusters that any of them evaluated: its FP32 operations
and the bytes it must move, the least time the card could take (the
larger of the operations over the FP32 peak and the bytes over the memory
rate), which of the two binds, and the kernel's share of it; and the
kernel's picoseconds per pair it evaluated.

The line before the card line is a JSON object with the kernel's modes,
their launches in the main paths, errors, times and bounds (K1 with the
dielectric segment-2 and segment-3 calls and config 5's segment 1, its
launches by path, the split config-5 CPI, the ray blocks and the bench's
terrain among them; K3 with its launches by path, the moving CPI and the
bench's sphere;
the sweep, K2, with each of its
three calls: terrain-20k sweep-only, the terrain overflow, the moving
swept tiles; phase 1's kernel with phase z's calls and its launches by
path, the phase1.calls counter of every main-path run above, each equal
to that run's traversal calls; the shading kernel with phase 5's calls,
its launches by path and its time and bound a pulse of each path, the
shade.calls counter of every main-path run that reads phase1.calls, each
equal to that run's traversal calls, or on the bench's brute-force --tiny
run to its pulses times segments); the last line is the JSON result.
"""

from __future__ import annotations

import ctypes
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
import warnings

import torch

NUM_RAYS = 63
PULSES = 8
TRIS = 1_000_000  # the terrain path's terrain
SMALL_TRIS = 20_000  # the sweep-mode check's terrain
MOVING_SUBDIV = 7  # 4 icospheres x 327,680 triangles
DEVICE = "cuda"
# the moving scene's knobs (bench.py:33-43, 201-231): shell clusters, the
# running-best window prune, the replay and the capped post-processing.
# replay_cap is 256, not the bench's 128: at a 63^3 fan each sphere
# returns the 63 identical-direction copies of its centre ray, 252 lanes
# a pulse, and a cap of 128 would grow the replay's block to 256.
MOVING_KNOBS = dict(accel="cluster", cluster_size=1024, candidates=128, mt_group=1, p1_fanout=16,
                    p1_super_k=32, mt_prune=True, ray_tile=512, sub_tiles=8, mt_tail=True,
                    compact_narrow=-1, refine=True, replay_cap=256, agg_cap=1024)
RESIDENT_CAP = 512  # K5's live pack: 512 x 128 x 16 x 4 B = 4.2 MB, room for every segment
# BASELINE config 1 (bench.py --scene sphere) for the brute-force phases k
# and l, its icosphere cut from the bench's 1.3M triangles to subdivision 5
# (20,480): brute force costs rays x triangles pairs a segment.
SPHERE_SUBDIV = 5
# the sphere scene's traversal knobs (bench.py:41-42) for phase l's
# production side, with the moving scene's replay cap
SPHERE_KNOBS = dict(cluster_size=1024, candidates=128, mt_group=1, p1_fanout=16, p1_super_k=32,
                    mt_prune=True, replay_cap=256)
CPU_CHECK_RAYS = 4096  # phase k's segment-1 rays held to the port on the CPU
EDGE_TIE = 1e-5  # phase l: a lane whose decision differs must pass this close to a triangle edge
README_PULSES = 64  # phase m: README.md's quick start as written
# phase o: BASELINE config 3's terrain cut for the contract against the f64
# brute-force engine (its cost is lanes x triangles: 3 x 63^3 x 20k a segment)
DIELECTRIC_CUT_TRIS = 20_000
# BASELINE config 5 (phase p): examples/terrain_imaging.py's scene at the
# 1M terrain, bench.py's cpi256 pulses, fan and knobs (bench.py:394-422)
IMAGING_PULSES = 256
IMAGING_RAYS = 31
IMAGING_KNOBS = dict(ray_tile=128, sub_tiles=2, candidates=32, replay_cap=64, agg_cap=1024)
IMAGING_ALT, IMAGING_PRF, IMAGING_FS = 4000.0, 2000.0, 50e6
IMAGING_CHIRP, IMAGING_PULSE = 5e12, 4e-6  # LFM: 20 MHz over 4 us
MODEL_DIRS = 1_000_000  # phase q: directions each physics model is held on
SPLIT_PULSES = 2  # phase t: terrain pulses traced whole and in ray blocks
RAY_BLOCKS = (3, 9)  # phase t: 63^3 = 3^6 x 7^3 divides into both
ORACLE_RTOL = 1e-9  # phase v: assert_match's (tests/test_engine_vs_oracle.py:25)
EXAMPLE_TRIS = 20_000  # phase w: torch_terrain_imaging.py's terrain
# phase x: rts_tpu_torch.bench's runs, configs 4 and 1 at bench.py's full width
BENCH_RUNS = (("tiny", ["--tiny"]),
              ("terrain-1M", ["--scene", "terrain", "--pulses", "8", "--repeat", "2", "--no-cpi256", "--stats"]),
              ("sphere-1.31M", ["--scene", "sphere", "--pulses", "2", "--repeat", "1", "--no-cpi256"]))
# The card's published peaks (NVIDIA's H100 SXM data sheet, at 700 W): FP32
# outside the tensor cores, and the HBM rate.
FP32_PEAK = 67e12
HBM_RATE = 3.35e12
MT_OPS = 38  # per (ray, column): 37 multiplies, adds, subtracts and a reciprocal (mt_columns)
SLAB_OPS = 22  # per (ray, box): 6 subtracts, 6 multiplies, 10 minima/maxima (slab)
P1_SLAB_OPS = 24  # per (ray, box) of phase 1: 6 subtracts, 6 multiplies, 12 minima/maxima (phase1.cu:slab)


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


def sphere_world(pulses: int):
    """BASELINE config 1 (bench.py --scene sphere, bench.py:186-196): one
    icosphere of 60 m radius at 900 m receding at 50 m/s, a monostatic
    radar at the origin with a 25 m capture sphere."""
    from rts_tpu_torch.sim import Path, RadarSignal, Receiver, Target, Transmitter, World

    w = World()
    w.add(Transmitter(path=Path.fixed(0, 0, 0), wave=RadarSignal(carrier=10e9), pulse_count=pulses,
                      prf=1000.0, tx_span=(0.15, 0.15, 0.0)))
    w.add(Receiver(path=Path.fixed(0, 0, 0), sphere=(25.0, 1.2, 1.2)))
    w.add(Target(path=Path.linear([(0.0, (900.0, 0.0, 0.0)), (1.0, (950.0, 0.0, 0.0))]), shape="sphere",
                 sphere_params=(SPHERE_SUBDIV, 60.0), refl_coeff=0.9))
    return w


def readme_world():
    """README.md's quick-start world (README.md:50-57): a 10 m icosphere
    (5,120 triangles) receding from 900 m, 64 pulses, a monostatic radar."""
    from rts_tpu_torch.sim import Path, RadarSignal, Receiver, Target, Transmitter, World

    w = World()
    w.add(Transmitter(path=Path.fixed(0, 0, 0), wave=RadarSignal(carrier=10e9), pulse_count=README_PULSES,
                      prf=1000.0, tx_span=(0.1, 0.1, 0.0)))
    w.add(Receiver(path=Path.fixed(0, 0, 0), sphere=(5.0, 1.0, 1.0)))
    w.add(Target(shape="sphere", sphere_params=(4, 10.0),
                 path=Path.linear([(0.0, (900, 0, 0)), (1.0, (950, 0, 0))]), refl_coeff=0.9))
    return w


def moving_world(pulses: int, subdiv: int | None = None):
    """BASELINE config 2 (bench.py --scene moving): four icospheres of 60 m
    radius (subdivision ``subdiv``, MOVING_SUBDIV unless given) on linear
    radial paths through the nodes 12, 9, 15 and 3 of a 3^3 fan
    (directions every odd fan contains), a monostatic radar at the origin
    with a 25 m capture sphere."""
    import numpy as np

    from rts_tpu_torch.engine.fan import generate_fan
    from rts_tpu_torch.sim import Path, RadarSignal, Receiver, Target, Transmitter, World

    w = World()
    w.add(Transmitter(path=Path.fixed(0, 0, 0), wave=RadarSignal(carrier=10e9), pulse_count=pulses,
                      prf=1000.0, tx_span=(0.15, 0.15, 0.0)))
    w.add(Receiver(path=Path.fixed(0, 0, 0), sphere=(25.0, 1.2, 1.2)))
    nodes = generate_fan(3, (0.0, 0.0), (0.15, 0.15, 0.0), device="cpu").double().numpy()
    for node, rng, speed in ((12, 900.0, -50.0), (9, 1400.0, 80.0), (15, 2000.0, -140.0),
                             (3, 2600.0, 30.0)):
        d = nodes[node] / np.linalg.norm(nodes[node])
        w.add(Target(path=Path.linear([(0.0, tuple(rng * d)), (1.0, tuple((rng + speed) * d))]),
                     shape="sphere", sphere_params=(subdiv or MOVING_SUBDIV, 60.0), refl_coeff=0.9))
    return w


def dielectric_world(pulses: int, tris: int):
    """BASELINE config 3, ``rts_tpu_torch.bench``'s dielectric scene at
    ~``tris`` triangles: the terrain of config 4 (12 km, 300 m peaks) under
    a 200 m dielectric slab (2 m thick, pitched flat, at 1 km; refl 0.5,
    index 1.5), Tx and a monostatic Rx 4 km up looking down, a forward Rx
    at 600 m looking up (capture sphere (60, 1.4, 1.4)), 10 GHz."""
    from rts_tpu_torch import bench

    args = bench.parse_args(["--scene", "dielectric", "--tris", str(tris), "--pulses", str(pulses)])
    return bench.scene(args)[0]


def dielectric_plate_world(pulses: int):
    """tests/test_replay.py:83's world: a 200 m plate 2 m thick at 1 km made
    dielectric (refl 0.6, index 1.5) before a monostatic radar at the
    origin (capture sphere (5, 1, 1)), and a forward Rx 2 km out looking
    back (capture sphere (8, 1.5, 1.5)) that the exiting chains reach."""
    from rts_tpu_torch.sim import Path, RadarSignal, Receiver, RotationPath, Target, Transmitter, World

    w = World()
    w.add(Transmitter(path=Path.fixed(0, 0, 0), wave=RadarSignal(carrier=10e9), pulse_count=pulses,
                      prf=1000.0, tx_span=(0.1, 0.1, 0.0)))
    w.add(Receiver(path=Path.fixed(0, 0, 0), sphere=(5.0, 1.0, 1.0)))
    w.add(Receiver(path=Path.fixed(2000, 0, 0), rotation=RotationPath(azimuth=math.pi), sphere=(8.0, 1.5, 1.5)))
    w.add(Target(path=Path.fixed(1000, 0, 0), shape="rect", rect=(2.0, 200.0, 200.0), refl_coeff=0.6,
                 refr_index=1.5))
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


def in_turns(a, b, reps: int = 20):
    """Times of two calls taken in turns in one process, a, b, b, a:
    ((a1, a2), (b1, b2))."""
    a1, b1, b2, a2 = (time_ms(fn, reps) for fn in (a, b, b, a))
    return (a1, a2), (b1, b2)


def plain_counted(fn, cs: int):
    """fn() with the plain traversal's windows counted: (its result, the
    (ray, column) pairs the windows gate in, the distinct clusters whose
    columns they read)."""
    from rts_tpu_torch.ops import cluster_trace as CT

    pairs, ids = [], []
    inner = CT._mt_window

    def counting(o, d, m, tmin, f, gate, tri_ids, best):
        g = torch.broadcast_to(gate, tmin.shape[:-1] + (f.shape[-1],))
        pairs.append(g.sum())
        ids.append(torch.where(g.any(1), tri_ids[:, 0] // cs, -1).reshape(-1))
        return inner(o, d, m, tmin, f, gate, tri_ids, best)

    CT._mt_window = counting
    out = fn()
    CT._mt_window = inner
    clusters = torch.unique(torch.cat(ids)) if ids else torch.empty(0)
    n_pairs = int(torch.stack(pairs).sum()) if pairs else 0
    return out, n_pairs, int((clusters >= 0).sum())


def bound(inp, shape, stats, pairs: int, clusters: int) -> dict:
    """The least time the card could take for one traversal call that
    evaluates ``pairs`` (ray, column) pairs over ``clusters`` distinct
    clusters: the larger of its FP32 operations over the FP32 peak and the
    bytes it must move over the memory rate.  Operations: MT_OPS per pair,
    and on swept tiles SLAB_OPS per ray and tested box (every supergroup
    box, then the cluster boxes of each visited group: super_size 1).
    Bytes: the rays, the clusters' pack columns, the candidate lists and
    outputs, each once (and the boxes when a tile sweeps)."""
    lanes = inp.origin.shape[1]
    rt, cs = shape.ray_tile, shape.cluster_size
    tiles = lanes // rt
    swept = (inp.meta[:, 1] != 0) if shape.k_max > 0 else torch.ones(tiles, dtype=torch.bool,
                                                                       device=inp.meta.device)
    n_swept = int(swept.sum())
    ops = MT_OPS * pairs
    nbytes = 28 * lanes + clusters * cs * 16 * 4  # o, d, tmin; the pack columns read
    nbytes += inp.cand.numel() * 4 * (3 if shape.mt_prune else 2) + inp.meta.numel() * 4
    nbytes += inp.live_tab.numel() * 4 + (16 + (40 if shape.emit_shade else 0)) * lanes + tiles * 8
    if n_swept:
        if shape.super_size != 1:
            raise ValueError("the sweep's box count is written for super_size == 1")
        tests = n_swept * inp.s_mn.shape[0] + shape.group_size * int(stats[swept, 0].sum())
        ops += SLAB_OPS * rt * tests
        nbytes += (inp.mn.shape[0] + inp.g_mn.shape[0] + inp.s_mn.shape[0]) * 24
    t_ops, t_bytes = ops / FP32_PEAK, nbytes / HBM_RATE
    return {"ops": ops, "bytes": nbytes, "bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def entry(name: str, replaces: str, launches: int, r: dict) -> dict:
    """One kernel mode's object of the kernels JSON line."""
    return {"name": name, "route": "cuda", "source": "rts_tpu_torch/ops/csrc/mt_traverse.cu",
            "replaces": f"rts_tpu/ops/cluster_trace.py:{replaces}", "launches": launches,
            "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None,
            "pairs": r["pairs"], "bound_pairs": r["bound_pairs"],
            "ps_per_pair": 1e9 * r["ms"] / r["pairs"]}


def sweep_calls(card: str, calls) -> list:
    """The sweep's calls for its kernels entry, each stamped: time, plain
    time, pairs, bound, share and ps per pair."""
    out = []
    for r in calls:
        out.append({k: r[k] for k in ("what", "err", "ms", "plain_ms", "pairs", "bound_ms", "bound_by")}
                   | {"ps_per_pair": 1e9 * r["ms"] / r["pairs"]})
        stamp(card, f"K2 {r['what']}: {r['ms']:.4f} ms, plain {r['plain_ms']:.3f} ms, {r['pairs']} "
                    f"pairs, bound {r['bound_ms']:.4f} ms by {r['bound_by']} "
                    f"({100 * r['bound_ms'] / r['ms']:.2f}%), {1e9 * r['ms'] / r['pairs']:.3f} ps/pair")
    return out


def reset_counts(dev) -> None:
    """Every launch count of the traversal kernel to 0."""
    from rts_tpu_torch.ops import cluster_trace as CT
    from rts_tpu_torch.utils import timing

    timing.reset()
    CT.mt_traverse.sweep_counts = torch.zeros(2, dtype=torch.int32, device=dev)


def kernel_calls(mode=None) -> int:
    """The traversal kernel's calls counted since the last reset (the
    ``traverse.calls`` counters of ``rts_tpu_torch.utils.timing``): all of
    them, or those of one mode ("K3" ... "K6")."""
    from rts_tpu_torch.utils import timing

    return timing.counters().get("traverse.calls" if mode is None else f"traverse.calls.{mode}", 0)


def phase1_calls(what: str) -> int:
    """Phase 1's kernel launches since reset_counts (the ``phase1.calls``
    counter of ``rts_tpu_torch.utils.timing``), on a path whose every
    traversal call has candidates: one launch a call, so it must equal
    kernel_calls() (both 0 on a brute-force run, as the bench's --tiny)."""
    from rts_tpu_torch.utils import timing

    n = timing.counters().get("phase1.calls", 0)
    if n != kernel_calls():
        raise AssertionError(f"{what}: {n} phase-1 kernel launches against {kernel_calls()} traversal calls")
    return n


def shade_calls(what: str, segments: int | None = None) -> int:
    """The shading kernel's launches since reset_counts (the ``shade.calls``
    counter): one launch a segment traced on float32 CUDA state, so it must
    equal ``segments``, by default that run's traversal calls (one a
    segment traced on a clustered path; both 0 on the CPU)."""
    from rts_tpu_torch.utils import timing

    n = timing.counters().get("shade.calls", 0)
    want = kernel_calls() if segments is None else segments
    if n != want:
        raise AssertionError(f"{what}: {n} shading kernel launches against {want} segments traced")
    return n


def sweep_counts():
    """(calls that swept a tile, swept tiles) since reset_counts, as the
    kernel counted them on the device."""
    from rts_tpu_torch.ops import cluster_trace as CT

    calls, tiles = CT.mt_traverse.sweep_counts.tolist()
    return calls, tiles


def check_call(inp, shape, what: str) -> dict:
    """The kernel against its plain version on one call's phase-2 operands:
    t/tri/beta/gamma and the work counters bit-equal; the kernel's time
    (20 calls), the plain time (1), the pairs and clusters the plain
    version evaluated and the call's bound from them."""
    from rts_tpu_torch.ops import cluster_trace as CT

    got = CT.mt_traverse(inp, shape)
    ref, pairs, clusters = plain_counted(lambda: CT.mt_traverse_reference(inp, shape), shape.cluster_size)
    sync()
    for name, a, b in zip(("t", "tri", "beta", "gamma", "stats"), got[:4] + got[5:], ref[:4] + ref[5:]):
        if not bit_equal(a, b):
            raise AssertionError(f"{what}: {name} differs from the plain version")
    f = ref[0] < 3.0e38
    return dict(what=what, pairs=pairs, clusters=clusters,
                err=max(float((a[f] - b[f]).abs().max()) if bool(f.any()) else 0.0
                        for a, b in zip((got[0], got[2], got[3]), (ref[0], ref[2], ref[3]))),
                ms=time_ms(lambda: CT.mt_traverse(inp, shape), 20),
                plain_ms=time_ms(lambda: CT.mt_traverse_reference(inp, shape), 1),
                **bound(inp, shape, got[5], pairs, clusters))


def bits_of(x: torch.Tensor) -> torch.Tensor:
    """A float32 tensor as its bits (so that NaN and -0.0 compare), other
    dtypes as they are."""
    return x.view(torch.int32) if x.dtype.is_floating_point else x


def bit_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return torch.equal(bits_of(a), bits_of(b))


def compare_hits(got, ref, what: str, against: str = "the plain version") -> float:
    for name in ("found", "tri"):
        if not torch.equal(getattr(got, name), getattr(ref, name)):
            raise AssertionError(f"{what}: {name} differs from {against}")
    err = 0.0
    f = ref.found
    for name in ("t", "beta", "gamma"):
        a, b = getattr(got, name)[f], getattr(ref, name)[f]
        err = max(err, float((a - b).abs().max()) if a.numel() else 0.0)
        if not bit_equal(a, b):
            raise AssertionError(f"{what}: {name} not bit-equal to {against} (max abs err {err})")
    return err


def compare_ties(got, ref, what: str, against: str) -> int:
    """Hits of two traversals that visit the clusters in different orders:
    found identical and t bit-equal on every lane; tri/beta/gamma bit-equal
    except on lanes that name another triangle at the same distance (an
    exact tie, e.g. a ray through an edge two triangles share, which the
    visit order breaks).  Returns the number of tie lanes."""
    if not torch.equal(got.found, ref.found):
        raise AssertionError(f"{what}: found differs from {against}")
    f = ref.found
    if not bit_equal(got.t[f], ref.t[f]):
        raise AssertionError(f"{what}: t not bit-equal to {against}")
    same = f & (got.tri == ref.tri)
    for name in ("beta", "gamma"):
        if not bit_equal(getattr(got, name)[same], getattr(ref, name)[same]):
            raise AssertionError(f"{what}: {name} not bit-equal to {against} where tri agrees")
    return int((f & ~same).sum())


def compare_pulse_ties(got, ref, corners, what: str, against: str) -> int:
    """Two traces of one pulse whose ray tiles differ (another fan order,
    the lane compaction): every lane whose chain of triangles equals the
    other's bit-equal in every output; a lane whose chain differs must part
    from it, at its first differing step, on two triangles that share a
    corner (an exact t tie, which the visit order breaks).  Returns the
    number of lanes that part."""
    same = (got.tri_seq == ref.tri_seq).all(0)
    for name, a, b in zip(got._fields, got, ref):
        if not bit_equal(a[..., same], b[..., same]):
            raise AssertionError(f"{what}: {name} differs from {against} on lanes of the same chain")
    parted = torch.nonzero(~same).reshape(-1)
    if parted.numel():
        diff = got.tri_seq[:, parted] != ref.tri_seq[:, parted]
        step = diff.int().argmax(0)
        a = got.tri_seq[step, parted].long()
        b = ref.tri_seq[step, parted].long()
        if bool(((a < 0) | (b < 0)).any()):
            raise AssertionError(f"{what}: a lane hits where {against} misses")
        ca, cb = corners[a], corners[b]  # [lanes, 3 corners, 3]
        if not bool((ca[:, :, None, :] == cb[:, None, :, :]).all(-1).any((1, 2)).all()):
            raise AssertionError(f"{what}: a lane parts from {against} on triangles that share no corner")
    return int(parted.numel())


def same_result(a, b) -> bool:
    """Every leaf of two results (nested named tuples) bit-equal."""
    if isinstance(a, tuple):
        return all(same_result(x, y) for x, y in zip(a, b))
    return bit_equal(a, b)


def brute_index(cl_base, brute_base) -> torch.Tensor:
    """Each triangle of a cluster-reordered scene base, as its index in the
    brute-force engine's base (original order), matched on its target and
    its corners; -1 for padding."""
    def keys(base):
        corners = base.tri_verts.to(torch.float32).reshape(-1, 9).cpu().numpy()
        return [(int(t), c.tobytes()) for t, c in zip(base.tri_target.tolist(), corners)]

    where = {k: j for j, k in enumerate(keys(brute_base))}
    return torch.tensor([where[k] if k[0] >= 0 else -1 for k in keys(cl_base)], dtype=torch.int64)


def first_pulse(res):
    """Pulse 0 of a result stacked over pulses (nested named tuples)."""
    if isinstance(res, tuple):
        return type(res)(*(first_pulse(x) for x in res))
    return res[0]


def device_us(e) -> float:
    """An event's device time in microseconds (the name torch.profiler
    gives it depends on the version)."""
    return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)


def annotation(e) -> bool:
    """Whether a profiler event is a span of the program's (``rts.*``) or
    another user annotation, not an operator, a kernel or a copy."""
    return bool(getattr(e, "is_user_annotation", False)) or e.key.startswith("rts.")


def profile_pulse(card: str, what: str, pulse) -> None:
    """Phase j: torch.profiler over one warm call of ``pulse`` (one pulse of
    a main path): device time against the wall, the traversal kernel's
    share of device time, the five largest operators by device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    pulse()
    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pulse()
        sync()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    # spans are left out: a user annotation also shows on the device's
    # timeline, as an event as long as its region
    events = [e for e in prof.key_averages() if device_us(e) > 0 and not annotation(e)]
    # device time is counted on the device's own events (kernels, copies);
    # an operator's self device time is the same time seen from the host
    on_device = [e for e in events if getattr(e, "device_type", None) == DeviceType.CUDA]
    ops = [e for e in events if getattr(e, "device_type", None) != DeviceType.CUDA]
    busy_ms = sum(device_us(e) for e in on_device) / 1e3
    if busy_ms == 0:
        stamp(card, f"phase j {what}: the profiler recorded no device time ({wall_ms:.1f} ms wall)")
        return
    kern_ms = sum(device_us(e) for e in on_device if "cand_kernel" in e.key or "sweep_kernel" in e.key) / 1e3
    stamp(card, f"phase j {what}: one warm pulse, {wall_ms:.1f} ms wall under the profiler, "
                f"{busy_ms:.1f} ms of device time ({100 * busy_ms / wall_ms:.1f}% of the wall; the "
                f"two traversal grids may overlap); the traversal kernel {kern_ms:.2f} ms "
                f"({100 * kern_ms / busy_ms:.1f}% of device time); the largest operators by device time:")
    for e in sorted(ops, key=device_us, reverse=True)[:5]:
        stamp(card, f"phase j {what}:   {device_us(e) / 1e3:9.3f} ms  {e.count:6d} calls  {e.key[:90]}")
    # the host's side: operators issued and the five largest by their own host time
    host = [e for e in prof.key_averages()
            if getattr(e, "device_type", None) != DeviceType.CUDA and not annotation(e)]
    aten = sum(e.count for e in host if e.key.startswith("aten::"))
    stamp(card, f"phase j {what}: {aten} aten operators issued, {sum(e.self_cpu_time_total for e in host) / 1e3:.1f} "
                f"ms of host time under the profiler; the largest by their own host time:")
    for e in sorted(host, key=lambda e: e.self_cpu_time_total, reverse=True)[:5]:
        stamp(card, f"phase j {what}:   {e.self_cpu_time_total / 1e3:9.3f} ms  {e.count:6d} calls  {e.key[:90]}")


def device_launches(fn):
    """(kernels and copies the device ran, their device time in ms) in one
    call of fn, by torch.profiler; (None, None) when the profiler recorded
    no device event."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        sync()
    on_device = [e for e in prof.key_averages()
                 if getattr(e, "device_type", None) == DeviceType.CUDA and not annotation(e)]
    if not on_device:
        return None, None
    return sum(e.count for e in on_device), sum(device_us(e) for e in on_device) / 1e3


def f64_pulse(state, p):
    """Pulse p of an f64 brute-force CPI through the pulse function
    trace_cpi runs: (its trace, per-lane power, aggregate, each segment's
    closest hits)."""
    from rts_tpu_torch.engine import wavefront as W
    from rts_tpu_torch.engine.cpi import make_pulse_fn, pulse_args

    hits = []
    inner = W.closest_hit_bruteforce

    def keeping(*a, **kw):
        hits.append(inner(*a, **kw))
        return hits[-1]

    W.closest_hit_bruteforce = keeping
    try:
        one, agg = make_pulse_fn(state[0], state[2], state[3])
        res, pw, dp, dl = one(*pulse_args(state[1], p))
        return res, pw, agg(res, pw, dp, dl), hits
    finally:
        W.closest_hit_bruteforce = inner


def divergence(seq64, seq32, hits, lane: int, n3: int):
    """(chain step, the f64 hit's distance to its triangle's nearest edge)
    at the first step where the two sides' chains of triangles part; the
    distance is inf where the f64 side missed there or the chains do not
    part (a decision that no triangle edge explains).  Chain step c is
    segment c's hit, traced in the lane itself, or for a refracted child's
    first steps in its parent's lane, n3 lanes up a slot; a lane past the
    traced ones holds a primary's pre-filled path row."""
    if lane >= 3 * n3:
        lane %= n3
    seq64, seq32 = seq64[:, lane], seq32[:, lane]
    steps = torch.nonzero(seq64 != seq32).reshape(-1).tolist()
    if not steps or int(seq64[steps[0]]) < 0:
        return (steps or [None])[0], float("inf")
    c = steps[0]
    at = lane - max(0, min(lane // n3, 2) - c) * n3
    h = hits[c]
    if int(h.tri[at]) != int(seq64[c]):
        raise AssertionError(f"lane {lane}'s chain step {c} is not segment {c}'s hit in lane {at}")
    b, g = float(h.beta[at]), float(h.gamma[at])
    return c, min(b, g, 1.0 - b - g)


def contract(card: str, dev, what: str, f64_base, f64_pulses, prod_state, phase: str = "l") -> dict:
    """The 1e-6 power/phase contract of the production preset (f32 kernel
    + f64 replay, ``prod_state``) against the card's own f64 brute-force
    engine (``f64_pulses`` from f64_pulse): received lanes, path rows and
    depths identical but for lanes whose chains part on an edge tie (the
    f64 hit within EDGE_TIE of its triangle's edge where the two sides'
    triangles first differ; printed); on the other received lanes, power,
    aggregated power and phase within 1e-6."""
    from rts_tpu_torch.engine.cpi import make_pulse_fn, pulse_args
    from rts_tpu_torch.utils import timing

    to_brute = brute_index(prod_state[0], f64_base).to(dev)
    n3 = prod_state[2].rays_per_fan
    timing.reset()
    worst = dict(power=0.0, agg_power=0.0, phase=0.0)
    compared = ties = parted = 0
    for p, (res64, pw64, out64, hits) in enumerate(f64_pulses):
        one, agg = make_pulse_fn(prod_state[0], prod_state[2], prod_state[3])
        res32, pw32, dp32, dl32 = one(*pulse_args(prod_state[1], p))
        out32 = agg(res32, pw32, dp32, dl32)
        n_rec = int((res32.received >= 0).sum())
        if n_rec > prod_state[2].replay_cap:
            raise AssertionError(f"phase {phase} {what}: {n_rec} lanes received, above the replay cap "
                                 f"{prod_state[2].replay_cap}")
        differ = ((res64.received != res32.received) | (res64.path != res32.path).any(0)
                  | (res64.refl_depth != res32.refl_depth) | (res64.refr_depth != res32.refr_depth))
        seq32 = torch.where(res32.tri_seq >= 0, to_brute[res32.tri_seq.clamp(min=0).long()], -1)
        parted += int(((seq32 != res64.tri_seq).any(0) & ~differ).sum())
        for lane in torch.nonzero(differ).reshape(-1).tolist():
            step, edge = divergence(res64.tri_seq, seq32, hits, lane, n3)
            if ties < 20 or edge > EDGE_TIE:  # the first 20, and any that fails
                tl = lane if lane < 3 * n3 else lane % n3
                chain = [(s_, int(h.tri[tl]), float(h.beta[tl]), float(h.gamma[tl]))
                         for s_, h in enumerate(hits) if bool(h.found[tl])]
                stamp(card, f"phase {phase} {what} pulse {p} lane {lane}: received {int(res64.received[lane])} "
                            f"(f64) / {int(res32.received[lane])} (production), path "
                            f"{res64.path[:, lane].tolist()} / {res32.path[:, lane].tolist()}; the f64 hits "
                            f"(segment, triangle, beta, gamma) {chain}; the chains part at step {step}, "
                            f"where the f64 hit lies {edge:.3e} from its triangle's nearest edge")
            if edge > EDGE_TIE:
                raise AssertionError(f"phase {phase} {what}: lane {lane}'s decision differs {edge:.3e} from "
                                     f"the triangle edge where the chains part (more than {EDGE_TIE})")
            ties += 1
        # compare the groups no differing lane belongs to
        ok = (res64.received >= 0) & ~differ
        for o_ in (out64, out32):
            ok &= ~torch.isin(o_.agg.path_match, o_.agg.path_match[differ])
        rel = lambda a, b: float((a[ok].double() / b[ok].double() - 1.0).abs().max()) if bool(ok.any()) else 0.0
        worst["power"] = max(worst["power"], rel(pw32, pw64))
        worst["agg_power"] = max(worst["agg_power"], rel(out32.agg.power, out64.agg.power))
        ph = (out32.agg.phase.double() + out32.agg.phase_lo.double() - out64.agg.phase - out64.agg.phase_lo).abs()
        ph = torch.minimum(ph, 2 * math.pi - ph)[ok]
        worst["phase"] = max(worst["phase"], float(ph.max()) if ph.numel() else 0.0)
        compared += int(ok.sum())
    if kernel_calls() == 0:
        raise AssertionError(f"phase {phase} {what}: the production side never launched the traversal kernel")
    if compared == 0:
        raise AssertionError(f"phase {phase} {what}: no received lane to compare")
    stamp(card, f"phase {phase} {what}: {len(f64_pulses)} pulse(s), production preset (f32 kernel, "
                f"{kernel_calls()} launches, + f64 replay) against the card's f64 brute-force "
                f"engine: decisions identical but for {ties} printed edge-tie lanes (on {parted} more lanes "
                f"the two chains hit other triangles, to the same decisions); on {compared} received "
                f"lanes the largest error is power {worst['power']:.3e}, aggregated power "
                f"{worst['agg_power']:.3e} (relative), phase {worst['phase']:.3e} rad")
    if max(worst.values()) >= 1e-6:
        raise AssertionError(f"phase {phase} {what}: the 1e-6 power/phase contract fails: {worst}")
    return dict(worst, compared=compared, ties=ties, parted=parted)


def dielectric_phases(card: str, dev) -> dict:
    """Phases n and o, and phase j's dielectric profile: BASELINE config 3
    at full width through the production preset, and the 1e-6 contract on
    its cut.  Returns what the kernels line adds: the path's kernel
    launches, its calls that swept a tile and their swept tiles, and K1's
    segment-2 and segment-3 calls."""
    from rts_tpu_torch import Parameters
    from rts_tpu_torch.engine import wavefront as W
    from rts_tpu_torch.engine.cpi import make_pulse_fn, pulse_args, trace_cpi
    from rts_tpu_torch.engine.fan import fan_tile_perm
    from rts_tpu_torch.ops import cluster_trace as CT
    from rts_tpu_torch.sim import check_replay_overflow, prepare_cpi

    t_n = time.perf_counter()
    params = Parameters(num_rays=NUM_RAYS, max_refl_depth=2, max_refr_depth=2)

    def with_replay_cap(state, phase):
        """The state with the smallest power-of-two replay cap (at least
        128) at or above the most lanes a pulse receives, counted on a
        trace without the replay; and that trace."""
        base_, batch_, cfg_, spec_ = state
        plain_ = trace_cpi(base_, batch_, dataclasses.replace(cfg_, refine=False), spec_)
        per_rx = [(plain_.received == i).sum(1).tolist() for i in range(spec_.num_rx)]
        most = int((plain_.received >= 0).sum(1).max())
        cap = max(128, 1 << max(0, most - 1).bit_length())
        stamp(card, f"phase {phase}: lanes received per pulse by the monostatic Rx {per_rx[0]}, by the "
                    f"forward Rx {per_rx[1]}; replay cap {cap}, the smallest power of two at or above "
                    f"{most} and at least 128 (bench.py's is 128, the production preset's 256)")
        return (base_, batch_, dataclasses.replace(cfg_, replay_cap=cap), spec_), plain_

    # ---- n. the dielectric main path: 3 x 63^3 lanes, 6 segments
    t0 = time.perf_counter()
    state = prepare_cpi(dielectric_world(PULSES, TRIS), params, preset="production", device=dev)
    prep_s = time.perf_counter() - t0
    n3, P = state[2].rays_per_fan, PULSES
    R = state[2].ray_total
    if (state[2].num_segments, R) != (6, 5 * n3):
        raise AssertionError(f"phase n: {state[2].num_segments} segments, {R} result lanes")
    stamp(card, f"phase n dielectric (config 3): {int(state[0].tri_verts.shape[0])} triangles, {n3} rays "
                f"a pulse traced as {3 * n3} lanes (primaries, trapped and exiting children) over "
                f"{state[2].num_segments} segments, results {R} lanes wide; prepare_cpi {prep_s:.2f} s")
    state, plain = with_replay_cap(state, "n")
    base, batch, cfg, spec = state
    reset_counts(dev)
    sync()
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message="replay cap overflow")  # fails the run
        t0 = time.perf_counter()
        out = trace_cpi(*state)
        sync()
        first_s = time.perf_counter() - t0
        launches = kernel_calls()
        p1 = phase1_calls("phase n")
        shade = shade_calls("phase n")
        sweeps, swept = sweep_counts()
        check_replay_overflow(out, cfg)
    received = int((out.received >= 0).sum())
    if launches == 0:
        raise AssertionError("the dielectric path never launched the traversal kernel")
    if received == 0 or tuple(out.received.shape) != (P, R):
        raise AssertionError(f"phase n: {received} lanes received, shape {tuple(out.received.shape)}")
    if bool((out.received[:, 3 * n3:] >= 0).any()):
        raise AssertionError("phase n: a lane past the traced ones was received")
    if not all(bool(torch.isfinite(a).all()) for a in (out.power, out.doppler, out.delay, *out.agg)
               if a.dtype.is_floating_point):
        raise AssertionError("phase n: a non-finite output")
    t0 = time.perf_counter()
    again = trace_cpi(*state)
    sync()
    second_s = time.perf_counter() - t0
    if not same_result(out, again):
        raise AssertionError("second dielectric run differs: not deterministic")
    for name, a, b in (("received", out.received, plain.received), ("emit", out.agg.emit, plain.agg.emit),
                       ("npath", out.agg.npath, plain.agg.npath),
                       ("path_match", out.agg.path_match, plain.agg.path_match)):
        if not torch.equal(a, b):
            raise AssertionError(f"phase n: the replay changed a decision: {name}")
    best_s = min(first_s, second_s)
    by_slot = [int((out.received[:, k * n3:(k + 1) * n3] >= 0).sum()) for k in range(3)]
    stamp(card, f"phase n dielectric main path (refine=True): {P} pulses x {n3} rays, {received} received "
                f"lanes ({by_slot[0]} primary, {by_slot[1]} trapped, {by_slot[2]} exiting), "
                f"{int(out.agg.emit.sum())} emitted paths, {launches} kernel launches ({sweeps} of them "
                f"swept {swept} tiles in all); {1e3 * best_s / P:.1f} ms/pulse, {P * n3 / best_s:.4g} rays/s "
                f"(a ray is a launch cell with its children; first run {first_s:.2f} s, second "
                f"{second_s:.2f} s, bit-identical; the replay changed no decision)")
    del again, plain

    # one pulse with its segments seen: each segment's kernel operands and
    # its live lanes by slot (a lane's slot rides in its slot_base), taken
    # where the segment's miss program starts: the shading kernel on the
    # card, _process_miss elsewhere (each segment runs one of the two)
    calls, live = [], []
    inner_hit, inner_miss, inner_shade = W.closest_hit_clustered, W._process_miss, W.shade_cuda

    def hit_spy(*a, **k):
        def keep(inp, shape):
            calls.append((inp, shape))
            return CT.mt_traverse(inp, shape)

        return inner_hit(*a, **{**k, "traverse": keep})

    def live_spy(inner):
        def spy(st, *a, **k):
            live.append(torch.bincount((st.slot_base // n3).long()[st.active], minlength=3))
            return inner(st, *a, **k)

        return spy

    args0 = pulse_args(batch, 0)
    one, agg = make_pulse_fn(base, cfg, spec)
    W.closest_hit_clustered, W._process_miss, W.shade_cuda = hit_spy, live_spy(inner_miss), live_spy(inner_shade)
    try:
        res0 = one(*args0)[0]
    finally:
        W.closest_hit_clustered, W._process_miss, W.shade_cuda = inner_hit, inner_miss, inner_shade
    if not torch.equal(res0.received, out.received[0]) or len(calls) < 3:
        raise AssertionError(f"phase n: the seen pulse differs from trace_cpi's, or {len(calls)} segments")
    for i, ((inp, _), lv) in enumerate(zip(calls, live)):
        stamp(card, f"phase n segment {i + 1}: {inp.origin.shape[1]} lanes traced ({inp.meta.shape[0]} "
                    f"tiles, {int((inp.meta[:, 1] != 0).sum())} swept); live lanes by slot (primary, "
                    f"trapped, exiting) {lv.tolist()}")
    k1_calls = []
    for i, what in ((1, "segment 2, the trapped children"), (2, "segment 3, the exiting children")):
        inp, shape = calls[i]
        r = check_call(inp, shape, f"dielectric {what}")
        r.update(tiles=int(inp.meta.shape[0]), swept_tiles=int((inp.meta[:, 1] != 0).sum()),
                 live_lanes=int(live[i].sum()))
        k1_calls.append(r)
        stamp(card, f"phase n {r['what']}: kernel bit-equal to plain (t/tri/beta/gamma, counters); "
                    f"{r['tiles']} tiles ({r['swept_tiles']} swept), {r['live_lanes']} live lanes; kernel "
                    f"{r['ms']:.4f} ms, plain {r['plain_ms']:.3f} ms; {r['pairs']} pairs over {r['clusters']} "
                    f"clusters; bound {r['bound_ms']:.4f} ms by {r['bound_by']} "
                    f"({100 * r['bound_ms'] / r['ms']:.2f}%), {1e9 * r['ms'] / r['pairs']:.3f} ps/pair")
    del calls, live, res0

    # Morton fan tiling and the lane compaction: one pulse each against
    # raster, up to exact t ties (both re-form the ray tiles)
    def seen_pulse(c):
        hits = []

        def keep(*a, **k):
            hits.append(inner_hit(*a, **k))
            return hits[-1]

        W.closest_hit_clustered = keep
        try:
            return make_pulse_fn(base, c, spec)[0](*args0)[0], hits
        finally:
            W.closest_hit_clustered = inner_hit

    raster_cfg = dataclasses.replace(cfg, refine=False)
    ref_res, ref_hits = seen_pulse(raster_cfg)
    perm = torch.as_tensor(fan_tile_perm(NUM_RAYS, "morton2"), device=dev)
    morton_lanes = torch.cat([k * n3 + perm for k in range(3)])
    take = lambda h, idx: type(h)(*(None if x is None else x[..., idx] for x in h))
    for what, option in (("fan_order='morton2'", dict(fan_order="morton2")),
                         ("compact_lanes=True", dict(compact_lanes=True))):
        res, hits = seen_pulse(dataclasses.replace(raster_cfg, **option))
        # segment 1: the morton order traces the raster lanes permuted; the
        # compaction sorts the lanes only after the spawn segments
        seg1 = ref_hits[0] if "compact_lanes" in option else take(ref_hits[0], morton_lanes)
        ties1 = compare_ties(hits[0], seg1, f"phase n {what} segment 1", "raster")
        parted = compare_pulse_ties(res, ref_res, base.tri_verts, f"phase n {what}", "raster")
        stamp(card, f"phase n {what}: one pulse against raster: segment 1 equal but for {ties1} exact-t "
                    f"tie lanes; the whole pulse bit-identical on every lane whose chain of triangles "
                    f"is raster's, and {parted} lanes part from it on triangles that share a corner")
    del ref_res, ref_hits

    # ---- j. profile one warm dielectric pulse
    try:
        profile_pulse(card, "dielectric", lambda: agg(*one(*args0)))
    except Exception as exc:  # the phase measures; it gates nothing
        stamp(card, f"phase j dielectric: the profiler failed: {exc!r}")
    del base, batch, out, one, agg, args0, state
    t_o = time.perf_counter()

    # ---- o. the 1e-6 contract on config 3 cut to DIELECTRIC_CUT_TRIS
    # triangles, whose receivers see only primaries, and on the dielectric
    # plate of tests/test_replay.py:83, whose forward Rx sees exiting chains
    for what, world, need_children in (
            ("dielectric (config 3, terrain cut to {} triangles)", lambda: dielectric_world(1, DIELECTRIC_CUT_TRIS),
             False),
            ("dielectric plate ({} triangles), forward Rx behind it", lambda: dielectric_plate_world(1), True)):
        f64_state = prepare_cpi(world(), params, dtype=torch.float64, device=dev)
        prod, _ = with_replay_cap(prepare_cpi(world(), params, preset="production", device=dev), "o")
        sync()
        t0 = time.perf_counter()
        f64 = f64_pulse(f64_state, 0)
        sync()
        f64_s = time.perf_counter() - t0
        n_tris = int(f64_state[0].tri_verts.shape[0])
        rec = f64[0].received >= 0
        by_slot = [int(rec[k * n3:(k + 1) * n3].sum()) for k in range(3)]
        if need_children and by_slot[2] == 0:
            raise AssertionError(f"phase o {what.format(n_tris)}: no exiting chain received")
        r = contract(card, dev, what.format(n_tris), f64_state[0], [f64], prod, phase="o")
        pairs = f64_state[2].num_segments * 3 * n3 * n_tris
        stamp(card, f"phase o {what.format(n_tris)}: received lanes by slot (primary, trapped, exiting) "
                    f"{by_slot}, {r['compared']} compared; the f64 brute-force pulse {f64_s:.2f} s "
                    f"({pairs:.4g} pairs at most, {pairs / f64_s:.4g} pairs/s)")
        del f64_state, prod, f64
    stamp(card, f"phases n and o: {t_o - t_n:.1f} s, {time.perf_counter() - t_o:.1f} s")
    return dict(launches=launches, p1=p1, shade=shade, sweeps=sweeps, swept=swept, calls=k1_calls)


def brute_phases(card: str, dev, params) -> None:
    """Phases k, l and m: the brute-force engine, the f64 parity engine and
    the sequential driver, the port's default entry points."""
    from rts_tpu_torch import Parameters
    from rts_tpu_torch.core.constants import SCENE_EPS
    from rts_tpu_torch.engine.animate import animate_scene
    from rts_tpu_torch.engine.cpi import trace_cpi
    from rts_tpu_torch.engine.fan import generate_fan_c
    from rts_tpu_torch.engine.intersect import closest_hit_bruteforce
    from rts_tpu_torch.sim import prepare_cpi, run, run_all_cpi

    f64 = torch.float64
    t_k = time.perf_counter()

    # ---- k. the brute-force engine at full width, f64, bare defaults and parity
    brute = {}
    for what, options in (("bare defaults", {}), ("preset='parity'", {"preset": "parity"})):
        t0 = time.perf_counter()
        state = prepare_cpi(sphere_world(1), params, dtype=f64, device=dev, **options)
        prep_s = time.perf_counter() - t0
        base, batch, cfg, spec = state
        if cfg.accel != "brute" or base.tri_verts.dtype != f64 or base.tri_verts.device.type != dev.type:
            raise AssertionError(f"phase k {what}: not the f64 brute-force engine on {dev}")
        torch.cuda.reset_peak_memory_stats(dev)
        secs = []
        for _ in range(1 if brute else 2):  # the first call of all pays cuBLAS's and the allocator's start-up
            sync()
            t0 = time.perf_counter()
            out = trace_cpi(*state)
            sync()
            secs.append(time.perf_counter() - t0)
        # the second run, under the profiler, through trace_cpi's pulse
        # function: it keeps the trace that phase l holds the contract to
        again = []
        t0 = time.perf_counter()
        launches, dev_ms = device_launches(lambda: again.append(f64_pulse(state, 0)))
        prof_s = time.perf_counter() - t0
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        if not same_result(first_pulse(out), again[0][2]):
            raise AssertionError(f"phase k {what}: a second run differs: not deterministic")
        r = cfg.rays_per_fan
        received = int((out.received >= 0).sum())
        if tuple(out.received.shape) != (1, r) or received == 0:
            raise AssertionError(f"phase k {what}: {received} lanes received, shape {tuple(out.received.shape)}")
        if not bool(torch.isfinite(out.power).all() and torch.isfinite(out.agg.power).all()):
            raise AssertionError(f"phase k {what}: non-finite power")
        n_tris = int(base.tri_verts.shape[0])
        chunk = min(cfg.tri_chunk, n_tris)
        pairs = cfg.num_segments * r * (-(-n_tris // chunk) * chunk)
        seen = ("not measured (the profiler recorded no device event)" if launches is None else
                f"{launches} device launches ({launches / (cfg.num_segments * -(-n_tris // chunk)):.1f} a "
                f"chunk), {dev_ms:.1f} ms of device time under the profiler ({prof_s:.1f} s of wall, the "
                f"profiler's own work included)")
        first = f", the first run of all, with start-up, {1e3 * secs[0]:.1f}" if len(secs) == 2 else ""
        stamp(card, f"phase k {what}: f64 brute force, {n_tris} triangles x {r} rays x "
                    f"{cfg.num_segments} segments, chunks of {chunk}; {received} received lanes, "
                    f"{int(out.agg.emit.sum())} emitted paths; {1e3 * secs[-1]:.1f} ms/pulse{first}; "
                    f"bit-identical to a second run; {pairs / secs[-1]:.4g} pairs/s; {seen}; peak device "
                    f"memory {peak_gb:.2f} GB (the tensors earlier phases hold included); prepare_cpi "
                    f"{prep_s:.2f} s")
        brute[what] = state, again[0]
    del out, again
    # no options at all (float32 brute force), through run_all_cpi
    outs = run_all_cpi(sphere_world(1), params, device=dev, attach_responses=False)
    out32 = outs[0]
    if len(outs) != 1 or out32.power.dtype != torch.float32 or out32.power.device.type != dev.type:
        raise AssertionError(f"phase k run_all_cpi (no options): {len(outs)} results, {out32.power.dtype} "
                             f"on {out32.power.device}")
    if not (bool(torch.isfinite(out32.power).all()) and int((out32.received >= 0).sum()) > 0):
        raise AssertionError("phase k run_all_cpi (no options): nothing received, or non-finite power")
    rec64 = brute["bare defaults"][1][0].received
    stamp(card, f"phase k run_all_cpi with no options (prepare_cpi's defaults: float32 brute force): "
                f"{int((out32.received >= 0).sum())} received lanes; "
                f"{int((out32.received[0] != rec64).sum())} lanes received otherwise than by the f64 engine")
    del outs, out32
    # segment 1 on the card against the port on the CPU
    base, batch, cfg, spec = brute["bare defaults"][0]
    scene = animate_scene(base, batch.rot[0], batch.pos[0], batch.vel[0])
    fan = generate_fan_c(cfg.num_rays, (batch.tx_dir[0, 0], batch.tx_dir[0, 1]), spec.tx_span, dtype=f64,
                         device=dev)
    n = min(CPU_CHECK_RAYS, fan.shape[1])
    sel = torch.linspace(0, fan.shape[1] - 1, n, device=dev).round().long()
    d = fan[:, sel].T.contiguous()
    o = batch.tx_origin[0][None].expand(n, 3).contiguous()
    tmin = torch.full((n,), SCENE_EPS, dtype=f64, device=dev)
    fields = (scene.tri_p0, scene.tri_e0, scene.tri_e1, scene.tri_n, scene.tri_c1, scene.tri_c0, scene.tri_np0)
    got = closest_hit_bruteforce(o, d, tmin, *fields, tri_chunk=cfg.tri_chunk)
    ref = closest_hit_bruteforce(o.cpu(), d.cpu(), tmin.cpu(), *(a.cpu() for a in fields), tri_chunk=cfg.tri_chunk)
    for name in ("found", "tri"):
        if not torch.equal(getattr(got, name).cpu(), getattr(ref, name)):
            raise AssertionError(f"phase k: segment 1 {name} differs between the card and the CPU")
    f = ref.found
    err = max(float(((getattr(got, k).cpu()[f] - getattr(ref, k)[f]).abs() / getattr(ref, k)[f].abs().clamp(min=1.0)
                     ).max()) if bool(f.any()) else 0.0 for k in ("t", "beta", "gamma"))
    if err > 1e-12:
        raise AssertionError(f"phase k: segment 1 t/beta/gamma differ by {err:.3e} between the card and the CPU")
    stamp(card, f"phase k: segment 1, {n} rays ({int(f.sum())} hits): tri/found identical on the card and "
                f"the CPU, t/beta/gamma within {err:.3e} (relative; absolute below 1)")
    del scene, fan, got, ref
    t_l = time.perf_counter()

    # ---- l. the 1e-6 power/phase contract on the card: the production
    # preset (f32 kernel + f64 replay) against the card's own f64 engine
    prod = prepare_cpi(sphere_world(1), params, preset="production", device=dev, **SPHERE_KNOBS)
    contract(card, dev, "sphere (config 1)", brute["bare defaults"][0][0], [brute["bare defaults"][1]], prod)
    del prod, brute
    moving64 = prepare_cpi(moving_world(1, subdiv=SPHERE_SUBDIV), params, dtype=f64, device=dev)
    moving32 = prepare_cpi(moving_world(1, subdiv=SPHERE_SUBDIV), params, device=dev, **MOVING_KNOBS)
    contract(card, dev, f"moving (config 2, subdivision {SPHERE_SUBDIV})", moving64[0], [f64_pulse(moving64, 0)],
             moving32)
    del moving64, moving32
    t_m = time.perf_counter()

    # ---- m. README.md's quick start through the sequential driver, card against CPU
    rparams = Parameters(num_rays=9, max_refl_depth=2)
    worlds, sums, secs = [], [], []
    for where in (dev, "cpu"):
        w = readme_world()
        sync()
        t0 = time.perf_counter()
        sums.append(run(w, rparams, device=where))
        sync()
        secs.append(time.perf_counter() - t0)
        worlds.append(w)
    key = lambda s_: [(p.pulse, p.received_rays, p.responses) for p in s_.pulses]
    if key(sums[0]) != key(sums[1]) or sums[0].total_responses == 0:
        raise AssertionError("phase m: the card and the CPU received or responded differently")
    errs = dict(power=0.0, delay=0.0, doppler=0.0, phase=0.0)
    for rx_card, rx_cpu in zip(*(w.receivers for w in worlds)):
        if len(rx_card.responses) != len(rx_cpu.responses):
            raise AssertionError("phase m: a receiver collected another number of responses")
        for a, b in zip(rx_card.responses, rx_cpu.responses):
            a, b = a.points[0], b.points[0]
            for k in errs:
                errs[k] = max(errs[k], abs(getattr(a, k) - getattr(b, k)) / max(abs(getattr(b, k)), 1e-300
                                                                                 if k != "phase" else 1.0))
    stamp(card, f"phase m README quick start (run, f64 brute force): {README_PULSES} pulses x 9^3 rays, "
                f"{sums[0].total_received} received lanes, {sums[0].total_responses} responses, identical "
                f"counts on the card and the CPU; largest relative difference power {errs['power']:.3e}, "
                f"delay {errs['delay']:.3e}, Doppler {errs['doppler']:.3e}, phase {errs['phase']:.3e} "
                f"(absolute below 1 rad); card {1e3 * secs[0] / README_PULSES:.1f} ms/pulse, CPU "
                f"{1e3 * secs[1] / README_PULSES:.1f} ms/pulse (host scene rebuild included)")
    if max(errs.values()) > 1e-9:
        raise AssertionError(f"phase m: the card's responses differ from the CPU's by more than 1e-9: {errs}")
    t_end = time.perf_counter()
    stamp(card, f"phases k, l, m: {t_l - t_k:.1f} s, {t_m - t_l:.1f} s, {t_end - t_m:.1f} s")


def imaging_world(pulses: int, tris: int):
    """BASELINE config 5 as examples/terrain_imaging.py:37-69 builds it: the
    fractal terrain of config 4 (~``tris`` triangles, 12 km, 300 m peaks)
    and a 30 m plate 400 m up moving at 12 m/s, a chirped radar (LFM 5e12
    Hz/s over 4 us, 2 kHz) 4 km up looking down (capture sphere (30, 1.2,
    1.2))."""
    from rts_tpu_torch.sim import (AttitudePath, Path, RadarSignal, Receiver, RotationPath,
                                   Target, Transmitter, World)

    n = max(2, round(math.sqrt(tris / 2)) + 1)
    down = RotationPath(elevation=-math.pi / 2)
    w = World()
    w.add(Transmitter(path=Path.fixed(0.0, 0.0, IMAGING_ALT), rotation=down, pulse_count=pulses, prf=IMAGING_PRF,
                      wave=RadarSignal(carrier=10e9, chirp_rate=IMAGING_CHIRP, length=IMAGING_PULSE),
                      tx_span=(0.15, 0.15, 0.0)))
    w.add(Receiver(path=Path.fixed(0.0, 0.0, IMAGING_ALT), rotation=down, sphere=(30.0, 1.2, 1.2)))
    w.add(Target(shape="terrain", terrain=(n, 12000.0, 300.0, 3), refl_coeff=0.9))
    w.add(Target(shape="rect", rect=(2.0, 30.0, 30.0), attitude=AttitudePath(pitch=math.pi / 2),
                 path=Path.linear([(0.0, (0.0, 0.0, 400.0)), (1.0, (12.0, 0.0, 400.0))]), refl_coeff=0.9))
    return w


def to_cpu(x):
    """A result (nested named tuples of tensors) moved to the CPU."""
    if isinstance(x, tuple):
        return type(x)(*(to_cpu(y) for y in x))
    return x.cpu()


def segment_calls(state, p: int):
    """Pulse p of a clustered CPI through trace_cpi's pulse function, with
    every traversal call's phase-2 operands kept: (its trace, [(inp,
    shape), ...] in segment order)."""
    from rts_tpu_torch.engine import wavefront as W
    from rts_tpu_torch.engine.cpi import make_pulse_fn, pulse_args
    from rts_tpu_torch.ops import cluster_trace as CT

    calls = []
    inner = W.closest_hit_clustered

    def spy(*a, **k):
        def keep(inp, shape):
            calls.append((inp, shape))
            return CT.mt_traverse(inp, shape)

        return inner(*a, **{**k, "traverse": keep})

    W.closest_hit_clustered = spy
    try:
        res = make_pulse_fn(state[0], state[2], state[3])[0](*pulse_args(state[1], p))[0]
    finally:
        W.closest_hit_clustered = inner
    return res, calls


def window_edge(state, p: int, lane: int) -> float:
    """The angular distance (rad) to its acceptance window's nearest edge
    of every point where lane ``lane`` of pulse p, traced again with
    ``state``'s geometry, crosses a receiver sphere on a missing segment:
    the smallest over segments, receivers and roots (inf if none)."""
    from rts_tpu_torch.engine import wavefront as W
    from rts_tpu_torch.engine.cpi import make_pulse_fn, pulse_args

    seen = []
    inner = W._process_miss, W.shade_cuda

    def see(st, miss, rx):
        seen.append((st.origin[:, lane].double(), st.direction[:, lane].double(), bool((miss & ~st.end)[lane]), rx))

    def spy(st, miss, rx, *a, **k):
        see(st, miss, rx)
        return inner[0](st, miss, rx, *a, **k)

    def shade_spy(st, bufs, hit, scene, rx, *a, **k):  # the card's segments: the miss program in the kernel
        see(st, st.active & ~hit.found, rx)
        return inner[1](st, bufs, hit, scene, rx, *a, **k)

    W._process_miss, W.shade_cuda = spy, shade_spy
    try:  # every segment at full width, so that lane indexes the state (bit-identical)
        make_pulse_fn(state[0], dataclasses.replace(state[2], compact_narrow=0), state[3])[0](*pulse_args(state[1], p))
    finally:
        W._process_miss, W.shade_cuda = inner
    wrap = lambda x: abs((x + math.pi) % (2 * math.pi) - math.pi)
    half = math.pi / 2
    best = float("inf")
    for o, d, live, rx in seen:
        for i in range(rx.num_rx) if live else ():
            # the window's edges, with the second region of a window over a
            # pole (wavefront._process_miss): theta + pi, phi folded back
            t0, t1, p0, p1 = (float(x[i]) for x in (rx.min_theta, rx.max_theta, rx.min_phi, rx.max_phi))
            over_pole = p0 < -half or p1 > half
            th_edges = [t0, t1] + ([t0 + math.pi, t1 + math.pi] if over_pole else [])
            ph_edges = ([e for e in (p0, p1) if -half < e < half] + ([-math.pi - p0] if p0 < -half else [])
                        + ([math.pi - p1] if p1 > half else []))
            c, r = rx.centre[i].double(), float(rx.radius[i])
            b, cq, a = 2.0 * float((o - c) @ d), float((o - c) @ (o - c)) - r * r, float(d @ d)
            disc = b * b - 4.0 * a * cq
            for t in ((-b - math.sqrt(disc)) / (2 * a), (-b + math.sqrt(disc)) / (2 * a)) if disc > 0 else ():
                if t < 0:
                    continue
                rel = o + t * d - c
                th = math.atan2(float(rel[1]), float(rel[0]))
                ph = math.atan2(float(rel[2]), math.hypot(float(rel[0]), float(rel[1])))
                best = min([best] + [wrap(th - e) for e in th_edges] + [abs(ph - e) for e in ph_edges])
    return best


def render_phases(card: str, dev) -> dict:
    """Phases p, q and r: BASELINE config 5 rendered to a compressed
    range-Doppler map, the physics models and the on-device receiver
    geometry, and the CLI on examples/scene.xml.  Returns what the kernels
    line adds: K1's launches on config 5 and through the CLI, and the
    config-5 segment-1 call."""
    import numpy as np

    from rts_tpu_torch import Parameters
    from rts_tpu_torch.__main__ import main as cli
    from rts_tpu_torch.engine.cpi import make_pulse_fn, pulse_args, trace_cpi
    from rts_tpu_torch.ops import cluster_trace as CT
    from rts_tpu_torch.physics import antenna as A
    from rts_tpu_torch.physics import rcs as R
    from rts_tpu_torch.sim import (RenderGrid, load_world, prepare_cpi, render_cpi_result, run_all_cpi,
                                   run_cpi)
    from rts_tpu_torch.sim.export import load_responses

    t_p = time.perf_counter()
    C = 299792458.0
    params = Parameters(num_rays=IMAGING_RAYS, max_refl_depth=2)

    # ---- p. BASELINE config 5: the 256-pulse CPI, then its map
    occ = (ctypes.c_int * 3)()
    err = CT._load().mt_traverse_occupancy(IMAGING_KNOBS["ray_tile"], IMAGING_KNOBS["sub_tiles"], occ)
    if err:
        raise RuntimeError(f"occupancy query failed: cudaError {err}")
    stamp(card, f"phase p occupancy (ray_tile {IMAGING_KNOBS['ray_tile']}, sub_tiles "
                f"{IMAGING_KNOBS['sub_tiles']}): blocks of {occ[0]} threads; candidate grid {occ[1]} blocks, "
                f"{occ[1] * occ[0] // 32} warps per SM; sweep grid {occ[2]} blocks, {occ[2] * occ[0] // 32} "
                f"warps per SM")
    knobs = dict(IMAGING_KNOBS)
    for attempt in range(2):
        held0 = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counts(dev)
        sync()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            t0 = time.perf_counter()
            out = run_cpi(imaging_world(IMAGING_PULSES, TRIS), params, preset="production", device=dev,
                          attach_responses=False, **knobs)
            sync()
            run_s = time.perf_counter() - t0
        launches, (sweeps, swept) = kernel_calls(), sweep_counts()
        p1 = phase1_calls("phase p")
        shade = shade_calls("phase p")
        trace_peak = (torch.cuda.max_memory_allocated(dev) - held0) / 1e9
        per_pulse = (out.received >= 0).sum(1)
        most = int(per_pulse.max())
        if not any("replay cap overflow" in str(w.message) for w in caught):
            break
        if attempt:
            raise AssertionError(f"phase p: the replay cap {knobs['replay_cap']} overflowed again")
        knobs["replay_cap"] = 1 << max(0, most - 1).bit_length()
        stamp(card, f"phase p: a pulse received {most} lanes, over the replay cap {IMAGING_KNOBS['replay_cap']}: "
                    f"the cap is now {knobs['replay_cap']}, the smallest power of two at or above it")
    if launches == 0 or most == 0:
        raise AssertionError(f"phase p: {launches} kernel launches, {most} lanes received at most a pulse")
    if tuple(out.received.shape) != (IMAGING_PULSES, IMAGING_RAYS**3):
        raise AssertionError(f"phase p: result shape {tuple(out.received.shape)}")
    if not all(bool(torch.isfinite(a).all()) for a in (out.power, out.doppler, out.delay, *out.agg)
               if a.dtype.is_floating_point):
        raise AssertionError("phase p: a non-finite output")
    t0 = time.perf_counter()
    state = prepare_cpi(imaging_world(IMAGING_PULSES, TRIS), params, preset="production", device=dev, **knobs)
    prep_s = time.perf_counter() - t0
    sync()
    t0 = time.perf_counter()
    again = trace_cpi(*state)
    sync()
    warm_s = time.perf_counter() - t0
    if not same_result(out, again):
        raise AssertionError("phase p: the warm run differs from the first: not deterministic")
    n_tris = int(state[0].tri_verts.shape[0])
    stamp(card, f"phase p config 5 (examples/terrain_imaging.py's scene, {n_tris} triangles; {IMAGING_PULSES} "
                f"pulses x {IMAGING_RAYS}^3 rays, ray_tile {knobs['ray_tile']}, sub_tiles {knobs['sub_tiles']}, "
                f"candidates {knobs['candidates']}, replay cap {knobs['replay_cap']}): {warm_s:.3f} s per "
                f"{IMAGING_PULSES}-pulse CPI on the warm run ({1e3 * warm_s / IMAGING_PULSES:.1f} ms/pulse, "
                f"bit-identical to the first; run_cpi with its prep {run_s:.3f} s, prepare_cpi {prep_s:.2f} s); "
                f"received lanes a pulse {int(per_pulse.min())}-{most} (mean "
                f"{float(per_pulse.float().mean()):.1f}), no replay-cap overflow; {launches} K1 launches "
                f"({launches / IMAGING_PULSES:.2f} a pulse; {sweeps} swept {swept} tiles); peak device memory "
                f"of the trace {trace_peak:.3f} GB above the {held0 / 1e9:.3f} GB held before it")
    del again

    # the map on the card, against the same render of the same CpiResult on the CPU
    grid = RenderGrid(IMAGING_FS, 1024, 2 * (IMAGING_ALT - 450.0) / C)
    rkw = dict(pulse_length=IMAGING_PULSE, chirp_rate=IMAGING_CHIRP, compress=True, range_window="taylor")
    render_cpi_result(out, 0, grid, **rkw)
    sync()
    held0 = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    reps = 5
    t0 = time.perf_counter()
    for _ in range(reps):
        rd, samples = render_cpi_result(out, 0, grid, **rkw)
    sync()
    render_ms = 1e3 * (time.perf_counter() - t0) / reps
    render_peak = (torch.cuda.max_memory_allocated(dev) - held0) / 1e9
    cpu_out = to_cpu(out)
    t0 = time.perf_counter()
    rd_cpu, _ = render_cpi_result(cpu_out, 0, grid, **rkw)
    cpu_ms = 1e3 * (time.perf_counter() - t0)
    peak = float(rd_cpu.max())
    map_err = float((rd.cpu() - rd_cpu).abs().max()) / peak
    if tuple(rd.shape) != (IMAGING_PULSES, 1024) or not bool(torch.isfinite(rd).all()) or peak <= 0:
        raise AssertionError(f"phase p: map of shape {tuple(rd.shape)}, peak {peak}")
    if map_err > 1e-5 or int(rd.argmax()) != int(rd_cpu.argmax()):
        raise AssertionError(f"phase p: the card's map is {map_err:.3e} of its peak from the CPU's, or its "
                             f"argmax differs ({int(rd.argmax())} against {int(rd_cpu.argmax())})")
    row, col = divmod(int(rd.argmax()), rd.shape[1])
    valid = out.agg.emit & (out.received == 0)
    stamp(card, f"phase p render (render_cpi_result, LFM, compressed, Taylor range window; {rd.dtype} map "
                f"{tuple(rd.shape)} from {int(valid.sum())} emitted lanes, at most {int(valid.sum(1).max())} a "
                f"pulse): {render_ms:.2f} ms on the card (CPU {cpu_ms:.1f} ms), peak device memory "
                f"{render_peak:.4f} GB above what the trace holds; the card's map within {map_err:.3e} of its "
                f"peak of the CPU's, argmax equal; strongest return: range "
                f"{(grid.window_start + col / IMAGING_FS) * C / 2:.1f} m, Doppler "
                f"{(row - IMAGING_PULSES // 2) * IMAGING_PRF / IMAGING_PULSES:+.1f} Hz (bin {row}, {col})")
    del rd, samples, rd_cpu, cpu_out

    # K1 on pulse 0's segment-1 operands at this shape
    res0, calls = segment_calls(state, 0)
    if not torch.equal(res0.received, out.received[0]):
        raise AssertionError("phase p: the seen pulse differs from the CPI's pulse 0")
    k1 = check_call(*calls[0], "config 5 segment 1")
    inp = calls[0][0]
    k1.update(tiles=int(inp.meta.shape[0]), swept_tiles=int((inp.meta[:, 1] != 0).sum()),
              live_lanes=state[2].rays_per_fan)  # segment 1: every primary
    stamp(card, f"phase p segment 1: kernel bit-equal to plain (t/tri/beta/gamma, counters); {k1['tiles']} "
                f"tiles of {knobs['ray_tile']} ({k1['swept_tiles']} swept); kernel {k1['ms']:.4f} ms, plain "
                f"{k1['plain_ms']:.3f} ms; {k1['pairs']} pairs over {k1['clusters']} clusters; bound "
                f"{k1['bound_ms']:.4f} ms by {k1['bound_by']} ({100 * k1['bound_ms'] / k1['ms']:.2f}%), "
                f"{1e9 * k1['ms'] / k1['pairs']:.3f} ps/pair")
    try:
        one, agg = make_pulse_fn(state[0], state[2], state[3])
        args0 = pulse_args(state[1], 0)
        profile_pulse(card, "config 5", lambda: agg(*one(*args0)))
    except Exception as exc:  # the profile measures; it gates nothing
        stamp(card, f"phase j config 5: the profiler failed: {exc!r}")
    del res0, calls, inp  # out and state: phase s
    t_q = time.perf_counter()

    # ---- q. the physics models on the card against the CPU
    # float32 on uniform directions; float64 with half of them within ~0.05
    # rad of the boresight, where an f32 off_angle is ill-conditioned (acos
    # near 1: ~3.5e-4 rad an ulp) and steep patterns part by more than 1e-3
    gen = torch.Generator().manual_seed(5)
    n = MODEL_DIRS
    bore = (0.3, -0.2)
    uniform = (torch.rand(n, generator=gen, dtype=torch.float64) * 2 * math.pi - math.pi,
               torch.rand(n, generator=gen, dtype=torch.float64) * math.pi - math.pi / 2)
    near = torch.randn(2, n // 2, generator=gen, dtype=torch.float64) * 0.05
    dirs = {torch.float32: uniform,
            torch.float64: tuple(torch.cat([u[n // 2:], b + x]) for u, b, x in zip(uniform, bore, near))}
    wl = C / 10e9
    table = tuple(map(tuple, torch.rand(7, 13, generator=gen, dtype=torch.float64).add(0.5).tolist()))
    models = [A.IsotropicAntenna(), A.SincAntenna(alpha=2.0, beta=1.0, gamma=2.0),
              A.GaussianAntenna(az_scale=8.0, el_scale=8.0), A.SquareHornAntenna(dimension=0.3),
              A.ParabolicAntenna(diameter=1.0),
              A.TableAntenna(angles=(0.0, 0.1, 0.3, 0.8, 1.5), gains=(30.0, 25.0, 6.0, 0.5, 0.01)),
              R.IsoRCS(sigma=1.5), R.SphereRCS(radius=2.0), R.PlateRCS(width=2.0, height=3.0),
              R.TableRCS(az_grid=tuple(np.linspace(-math.pi, math.pi, 13).tolist()),
                         el_grid=tuple(np.linspace(-math.pi / 2, math.pi / 2, 7).tolist()), table=table)]
    worst = {}
    for dtype, tol in ((torch.float32, 1e-3), (torch.float64, 1e-10)):
        for m in models:
            def ev(device):
                a, e = (x.to(device, dtype) for x in dirs[dtype])
                if hasattr(m, "gain"):
                    return m.gain(a, e, *bore, wl)
                return m.rcs(3 * a, 3 * e, wl)  # angle sums past the half-angle domain
            got, ref = ev(dev), ev("cpu")
            if got.device.type != dev.type or got.dtype != dtype:
                raise AssertionError(f"phase q: {type(m).__name__} gave {got.dtype} on {got.device}")
            err = float((got.cpu() - ref).abs().max() / ref.abs().max())
            worst[(type(m).__name__, str(dtype)[6:])] = err
            if err > tol:
                raise AssertionError(f"phase q: {type(m).__name__} {dtype} on the card is {err:.3e} of its peak "
                                     f"from the CPU's (over {tol})")
    stamp(card, f"phase q models on {n} seeded directions (uniform; in float64 half of them within ~0.05 rad "
                f"of the boresight), card against CPU, largest error relative to the model's peak: "
                + ", ".join(f"{k[0]} {k[1]} {v:.2e}" for k, v in worst.items()))

    # the terrain CPI of phase 3 unrefined, receiver geometry on the device against the host's
    tparams = Parameters(num_rays=NUM_RAYS, max_refl_depth=2)
    states, outs = [], []
    for on_device in (False, True):
        st = prepare_cpi(terrain_world(PULSES, TRIS), tparams, preset="production", device=dev, refine=False,
                         rx_geom_on_device=on_device)
        states.append(st)
        outs.append(trace_cpi(*st))
    sync()
    for name in ("centre", "radius", "min_theta", "max_theta", "min_phi", "max_phi"):
        a, b = getattr(states[1][1].rx_geom, name), getattr(states[0][1].rx_geom, name)
        if not bool(torch.allclose(a, b, rtol=1e-6, atol=5e-6)):
            raise AssertionError(f"phase q: on-device {name} differs from the host's by "
                                 f"{float((a - b).abs().max()):.3e}")
    geo_err = max(float((getattr(states[1][1].rx_geom, f) - getattr(states[0][1].rx_geom, f)).abs().max())
                  for f in ("centre", "min_theta", "max_theta", "min_phi", "max_phi"))
    differ = torch.nonzero(outs[0].received != outs[1].received).tolist()
    for p, lane in differ:
        edge = min(window_edge(states[0], p, lane), window_edge(states[1], p, lane))
        stamp(card, f"phase q pulse {p} lane {lane}: received {int(outs[0].received[p, lane])} (host geometry) / "
                    f"{int(outs[1].received[p, lane])} (on the device), {edge:.3e} rad from its window's edge")
        if edge > 1e-5:
            raise AssertionError(f"phase q: lane {lane} of pulse {p} is received otherwise {edge:.3e} rad "
                                 f"from the window's edge")
    stamp(card, f"phase q receiver geometry on the device: terrain CPI ({PULSES} pulses x {NUM_RAYS}^3, "
                f"refine=False): geometry within {geo_err:.3e} of the host's (rtol 1e-6, atol 5e-6); "
                f"{int((outs[1].received >= 0).sum())} received lanes, {len(differ)} received otherwise")
    del states, outs
    t_r = time.perf_counter()

    # ---- r. the CLI on examples/scene.xml, card against CPU
    scene = os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples", "scene.xml")
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "rts_tpu_torch")
    os.makedirs(out_dir, exist_ok=True)
    import contextlib
    import io

    def run_cli(*argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            if cli(list(argv)) != 0:
                raise AssertionError(f"phase r: {argv} failed")
        return buf.getvalue()

    files, printed = {}, {}
    reset_counts(dev)
    sync()
    for what, extra in (("cpi", ["--cpi", "--accel", "cluster", "--refine"]), ("run", [])):
        for where in ("cuda", "cpu"):
            files[what, where] = os.path.join(out_dir, f"cli_{what}_{where}.npz")
            t0 = time.perf_counter()
            printed[what, where] = run_cli("run", scene, *extra, "--out", files[what, where],
                                           *(["--device", "cpu"] if where == "cpu" else []))
            stamp(card, f"phase r run {' '.join(extra) or '(the f64 driver)'} on the {where}: "
                        f"{time.perf_counter() - t0:.2f} s; " + printed[what, where].splitlines()[0])
            printed[what, where] = printed[what, where].replace(files[what, where], "OUT")
        if what == "cpi":
            cli_launches = kernel_calls()
            if cli_launches == 0:
                raise AssertionError("phase r: the CLI's clustered CPI never launched the traversal kernel")
            cli_p1 = phase1_calls("phase r, the CLI's clustered CPI")
            cli_shade = shade_calls("phase r, the CLI's clustered CPI")
    worst = {}
    for what, tol in (("cpi", 1e-6), ("run", 1e-9)):
        if printed[what, "cuda"] != printed[what, "cpu"]:
            raise AssertionError(f"phase r {what}: the card printed {printed[what, 'cuda']!r}, the CPU "
                                 f"{printed[what, 'cpu']!r}")
        a, b = load_responses(files[what, "cuda"]), load_responses(files[what, "cpu"])
        oa = np.lexsort((a["delay"], a["time"], a["rx_index"]))
        ob = np.lexsort((b["delay"], b["time"], b["rx_index"]))
        if not np.array_equal(a["rx_index"][oa], b["rx_index"][ob]) or a["power"].size == 0:
            raise AssertionError(f"phase r {what}: the receivers' responses differ in number")
        def rel(k, floor):
            d = np.abs(a[k][oa] - b[k][ob])
            if k == "phase":  # wrapped, relative to max(|phase|, 1 rad): phase m's rule
                d = np.minimum(d % (2 * np.pi), 2 * np.pi - d % (2 * np.pi))
            return float((d / np.maximum(np.abs(b[k][ob]), floor)).max())

        worst[what] = {k: rel(k, 1.0 if k == "phase" else 1e-300) for k in ("power", "delay", "doppler", "phase")}
        if max(worst[what]["power"], worst[what]["phase"]) > tol or (what == "run" and max(worst[what].values()) > tol):
            raise AssertionError(f"phase r {what}: card against CPU {worst[what]} (over {tol})")
    # the saved file read back against the in-memory responses of the same run
    world, wparams = load_world(scene)
    run_all_cpi(world, wparams, device=dev, accel="cluster", refine=True)
    back = load_responses(files["cpi", "cuda"])
    mem = [(i, p) for i, rx in enumerate(world.receivers) for r in rx.responses for p in r.points]
    for k in ("power", "time", "delay", "doppler", "phase"):
        if not np.array_equal(back[k], np.array([getattr(p, k) for _, p in mem])):
            raise AssertionError(f"phase r: the saved {k} differs from the in-memory responses")
    if not np.array_equal(back["rx_index"], np.array([i for i, _ in mem])):
        raise AssertionError("phase r: the saved receivers differ from the in-memory responses")
    info = run_cli("info", scene)
    names = [rx.name for rx in world.receivers] + [t.name for t in world.targets]
    if not all(name in info for name in names) or "transmitters (1)" not in info:
        raise AssertionError(f"phase r: info printed {info!r}")
    stamp(card, f"phase r CLI on examples/scene.xml: {printed['cpi', 'cuda'].splitlines()[0]} on both; "
                f"--cpi --accel cluster --refine ({cli_launches} K1 launches) card against CPU: power "
                f"{worst['cpi']['power']:.3e}, phase {worst['cpi']['phase']:.3e} rad; the f64 driver: power "
                f"{worst['run']['power']:.3e}, delay {worst['run']['delay']:.3e}, Doppler "
                f"{worst['run']['doppler']:.3e}, phase {worst['run']['phase']:.3e}; the .npz equals the "
                f"in-memory responses; info lists {len(names)} receivers and targets")
    stamp(card, f"phases p, q, r: {t_q - t_p:.1f} s, {t_r - t_q:.1f} s, {time.perf_counter() - t_r:.1f} s")
    return dict(launches=launches, p1=p1, shade=shade, cli_launches=cli_launches, cli_p1=cli_p1, cli_shade=cli_shade,
                call=k1, render_ms=render_ms, state=state, out=out, warm_s=warm_s)


def split_phases(card: str, dev, img: dict) -> dict:
    """Phases s-w: the pulse x ray split through trace_cpi_sharded at full
    width (a world of one rank over NCCL) and its ray blocks' lane layout
    and replay offsets with the kernel, the native host geometry, the
    NumPy oracle against the card's f64 engine, and the port's examples.
    ``img`` is render_phases' result: phase p's config-5 state and CPI.
    Returns K1's launches in phases s and t."""
    import contextlib
    import io
    import runpy
    import tempfile

    import numpy as np
    import torch.distributed as dist

    from rts_tpu_torch import Parameters, native
    from rts_tpu_torch.accel.cluster import morton_order
    from rts_tpu_torch.engine.cpi import make_pulse_fn, pulse_args, trace_cpi
    from rts_tpu_torch.engine.types import RxGeomDevice, TraceConfig, scene_to_device
    from rts_tpu_torch.engine.wavefront import TraceResult, trace_pulse
    from rts_tpu_torch.geometry import filemesh, sphere_mesh, terrain_mesh
    from rts_tpu_torch.oracle import trace_pulse as oracle_pulse
    from rts_tpu_torch.parallel import make_mesh, regather_lanes, trace_cpi_sharded
    from rts_tpu_torch.sim import prepare_cpi

    root = os.path.dirname(os.path.abspath(__file__))
    build = os.path.join(root, "build")
    os.makedirs(build, exist_ok=True)

    # ---- s. the split through trace_cpi_sharded on phase p's config-5 CPI
    t_s = time.perf_counter()
    state, out = img["state"], img["out"]
    init = os.path.join(build, f"chip_smoke_pg_{os.getpid()}")
    dist.init_process_group("nccl", init_method=f"file://{init}", rank=0, world_size=1)
    try:
        mesh = make_mesh(1, 1)
        reset_counts(dev)
        sync()
        t0 = time.perf_counter()
        split = trace_cpi_sharded(*state, mesh)
        sync()
        split_s = time.perf_counter() - t0
        s_launches = kernel_calls()
        s_p1 = phase1_calls("phase s")
        s_shade = shade_calls("phase s")
        backend = dist.get_backend(mesh.get_group("ray"))
        t0 = time.perf_counter()  # trace_cpi again after the split: phase p, split, phase p
        trace_cpi(*state)
        sync()
        after_s = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()
        if os.path.exists(init):
            os.unlink(init)
    if not same_result(split, out):
        raise AssertionError("phase s: trace_cpi_sharded differs from phase p's trace_cpi")
    if s_launches != img["launches"]:
        raise AssertionError(f"phase s: {s_launches} K1 launches, phase p had {img['launches']}")
    stamp(card, f"phase s split config 5 (trace_cpi_sharded, make_mesh(1, 1), one {backend} rank): "
                f"{IMAGING_PULSES} pulses x {IMAGING_RAYS}^3 rays bit-identical to phase p's trace_cpi; "
                f"{split_s:.3f} s per CPI ({1e3 * split_s / IMAGING_PULSES:.1f} ms/pulse) against trace_cpi's "
                f"{img['warm_s']:.3f} s before it (phase p's warm run) and {after_s:.3f} s after it; "
                f"{s_launches} K1 launches")
    del split, state, out, img["state"], img["out"]
    t_t = time.perf_counter()

    # ---- t. the ray split's lane layout and replay offsets, with the kernel
    params = Parameters(num_rays=NUM_RAYS, max_refl_depth=2)
    base, batch, cfg, spec = prepare_cpi(terrain_world(SPLIT_PULSES, TRIS), params, preset="production",
                                         device=dev)
    n3 = cfg.rays_per_fan
    one, aggregate = make_pulse_fn(base, cfg, spec)
    split_fns = {k: [make_pulse_fn(base, cfg, spec, fan_slice=(k, i))[0] for i in range(k)] for k in RAY_BLOCKS}

    def pulse_in_blocks(k: int, p: int, launches: list | None = None):
        """Pulse p traced whole (k = 1) or in k ray blocks put back in the
        whole fan's order on the card: (its TraceResult, its CpiResult)."""
        if k == 1:
            res, *rest = one(*pulse_args(batch, p))
            return res, aggregate(res, *rest)
        parts = []
        for blk in split_fns[k]:
            before = kernel_calls()
            parts.append(blk(*pulse_args(batch, p)))
            if launches is not None:
                launches.append(kernel_calls() - before)
        rg = lambda xs: regather_lanes(xs, cfg.slot_multiplier, n3 // k)
        res = TraceResult(*(rg([part[0][j] for part in parts]) for j in range(len(TraceResult._fields))))
        return res, aggregate(res, *(rg([part[j] for part in parts]) for j in (1, 2, 3)))

    refs = [pulse_in_blocks(1, p) for p in range(SPLIT_PULSES)]
    reset_counts(dev)
    t_launches, t_rows = 0, {}
    for k in RAY_BLOCKS:
        if n3 % k:
            raise AssertionError(f"phase t: {n3} rays do not divide into {k} blocks")
        per_block, ties = [], 0
        for p in range(SPLIT_PULSES):
            res, got = pulse_in_blocks(k, p, per_block)
            if any(x.device != base.tri_verts.device for x in (*res, *got[:4], *got.agg)):
                raise AssertionError("phase t: a result left the card")
            ref, ref_out = refs[p]
            n_ties = compare_pulse_ties(res, ref, base.tri_verts, f"phase t {k} blocks pulse {p}",
                                        "the unsplit pulse")
            ties += n_ties
            for name, a, b in (("received", got.received, ref_out.received), ("path rows", res.path, ref.path),
                               ("emit", got.agg.emit, ref_out.agg.emit)):
                if not torch.equal(a, b):
                    raise AssertionError(f"phase t {k} blocks pulse {p}: {name} differs from the unsplit pulse")
            if n_ties == 0 and not same_result(got, ref_out):
                raise AssertionError(f"phase t {k} blocks pulse {p}: power, phase or an aggregate differs from "
                                     "the unsplit pulse")
            if n_ties:
                same = (res.tri_seq == ref.tri_seq).all(0)
                for name, a, b in (("power", got.power, ref_out.power), ("phase", got.agg.phase,
                                                                         ref_out.agg.phase)):
                    if not bit_equal(a[same], b[same]):
                        raise AssertionError(f"phase t {k} blocks pulse {p}: {name} differs on a lane whose "
                                             "chain is the unsplit pulse's")
        if min(per_block) == 0:
            raise AssertionError(f"phase t {k} blocks: a block never launched K1")
        t_launches += sum(per_block)
        t_rows[k] = dict(ties=ties, launches=per_block)
    t_p1 = phase1_calls("phase t")
    t_shade = shade_calls("phase t")
    # ms per pulse of each split, in turns: whole, 3, 9, 9, 3, whole
    turns = {k: [] for k in (1, *RAY_BLOCKS)}
    for k in (1, *RAY_BLOCKS, *reversed(RAY_BLOCKS), 1):
        sync()
        t0 = time.perf_counter()
        for p in range(SPLIT_PULSES):
            pulse_in_blocks(k, p)
        sync()
        turns[k].append(1e3 * (time.perf_counter() - t0) / SPLIT_PULSES)
    whole = min(turns[1])
    for k in RAY_BLOCKS:
        row = t_rows[k]
        row["ms"] = turns[k]
        stamp(card, f"phase t terrain (config 4, {int(base.tri_verts.shape[0])} triangles, {NUM_RAYS}^3 rays, "
                    f"production preset, {SPLIT_PULSES} pulses) in {k} ray blocks of {n3 // k} rays: received "
                    f"lanes, path rows and emit identical to the unsplit pulses, every lane of the same chain "
                    f"bit-equal (power, phase and the rest), {row['ties']} lanes parted on an exact-t tie; K1 "
                    f"launches per block {min(row['launches'])}-{max(row['launches'])} ({sum(row['launches'])} in "
                    f"all); in turns {' / '.join(f'{x:.1f}' for x in turns[k])} ms per pulse against the whole "
                    f"pulse's {' / '.join(f'{x:.1f}' for x in turns[1])} ({min(turns[k]) / whole:.2f}x, best "
                    f"against best)")
    del base, batch, refs, res, got, split_fns
    t_u = time.perf_counter()

    # ---- u. native host geometry on the card's machine
    if not native.available():
        raise AssertionError("phase u: the native library did not build (g++ is on this machine: nvcc needs it)")
    n = max(2, round(math.sqrt(TRIS / 2)) + 1)
    terrain = terrain_mesh(n, 12000.0, 300.0, seed=3)
    soup = terrain.verts[terrain.tris]
    t0 = time.perf_counter()
    perm_native = morton_order(soup)
    native_s = time.perf_counter() - t0
    os.environ["RTS_NO_NATIVE"] = "1"
    try:
        t0 = time.perf_counter()
        perm_numpy = morton_order(soup)
        numpy_s = time.perf_counter() - t0
    finally:
        del os.environ["RTS_NO_NATIVE"]
    if not np.array_equal(perm_native, perm_numpy):
        raise AssertionError(f"phase u: the Morton permutations differ on {int((perm_native != perm_numpy).sum())} "
                             "triangles")
    ball, _ = sphere_mesh(4, 30.0)
    v_file, n_file = os.path.join(build, "chip_smoke_v.txt"), os.path.join(build, "chip_smoke_n.txt")
    filemesh.write_mesh_files(ball, v_file, n_file)
    try:
        loaded = native.load_triplets(v_file)
        os.environ["RTS_NO_NATIVE"] = "1"
        try:
            parsed = filemesh._read_triplets(v_file)
        finally:
            del os.environ["RTS_NO_NATIVE"]
    finally:
        os.unlink(v_file)
        os.unlink(n_file)
    if not np.array_equal(loaded, parsed):
        raise AssertionError("phase u: load_triplets differs from the NumPy parser")
    stamp(card, f"phase u native host geometry (g++ build {native.build().name}): Morton permutation of the "
                f"{soup.shape[0]}-triangle terrain equal with and without the library, {native_s:.3f} s native "
                f"against {numpy_s:.3f} s NumPy (host); load_triplets equals _read_triplets on a "
                f"{ball.tris.shape[0]}-triangle mesh from write_mesh_files")
    del terrain, soup, perm_native, perm_numpy
    t_v = time.perf_counter()

    # ---- v. the NumPy oracle against the card's f64 brute-force engine
    worst = {}
    for name, (scn, vparams, tx_origin, tx_dir, tx_span, rx) in oracle_scenes().items():
        o = oracle_pulse(scn, vparams, tx_origin, tx_dir, tx_span, rx, strict_parity=False)
        e = trace_pulse(scene_to_device(scn, dtype=torch.float64, device=dev),
                        RxGeomDevice.from_host(rx, dtype=torch.float64, device=dev),
                        torch.as_tensor(np.asarray(tx_origin, np.float64), device=dev), tuple(tx_dir),
                        tuple(tx_span), TraceConfig.from_parameters(vparams, strict_parity=False, tri_chunk=64))
        if e.ray_length.device.type != dev.type:
            raise AssertionError(f"phase v {name}: the engine ran on {e.ray_length.device}")
        got = {f: getattr(e, f).cpu().numpy() for f in e._fields}
        for f in ("received", "refl_depth", "refr_depth"):
            if not np.array_equal(got[f], getattr(o, f)):
                raise AssertionError(f"phase v {name}: {f} differs from the oracle")
        if not np.array_equal(got["path"].T, o.path):
            raise AssertionError(f"phase v {name}: path differs from the oracle")
        pairs = [("ray_length", got["ray_length"], o.ray_length, 1e-9), ("power", got["power"], o.power, 1e-300),
                 ("doppler", got["doppler"], o.doppler, 1e-9), ("first_hit", got["first_hit"].T, o.first_hit, 1e-9),
                 ("prev_hit", got["prev_hit"].T, o.prev_hit, 1e-9),
                 ("rcs", np.transpose(got["rcs"], (2, 1, 0)), o.rcs_angle, 1e-9)]
        rel = 0.0
        for f, a, b, atol in pairs:
            over = np.abs(a - b) - (atol + ORACLE_RTOL * np.abs(b))
            if (over > 0).any():
                raise AssertionError(f"phase v {name}: {f} beyond rtol {ORACLE_RTOL} of the oracle")
            big = np.abs(b) > atol
            rel = max(rel, float((np.abs(a - b)[big] / np.abs(b)[big]).max()) if big.any() else 0.0)
        worst[name] = (int((o.received >= 0).sum()), int(o.received.shape[0]), rel)
    stamp(card, "phase v the f64 brute-force engine on the card against rts_tpu_torch.oracle (assert_match: "
                f"discrete equal, continuous within rtol {ORACLE_RTOL}): "
                + "; ".join(f"{k} {r} of {n_l} lanes received, largest relative difference {e:.3e}"
                            for k, (r, n_l, e) in worst.items()))
    t_w = time.perf_counter()

    # ---- w. the port's examples on the card, at reduced sizes
    closing = {"torch_from_xml.py": ([], "total responses:"),
               "torch_monostatic_sphere.py": ([], "range-Doppler peak:"),
               "torch_terrain_imaging.py": (["--tris", str(EXAMPLE_TRIS), "--pulses", "8", "--rays", "7"],
                                            "strongest compressed return")}
    argv, tmp = sys.argv, tempfile.tempdir
    tempfile.tempdir = build  # the examples save their archives there
    try:
        for name, (args, last) in closing.items():
            sys.argv = [name, *args, "--device", dev.type]
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                runpy.run_path(os.path.join(root, "examples", name), run_name="__main__")
            sync()
            lines = [ln for ln in buf.getvalue().splitlines() if last in ln]
            if not lines:
                raise AssertionError(f"phase w {name}: no '{last}' line in {buf.getvalue()!r}")
            stamp(card, f"phase w {name} {' '.join(args)}: {lines[-1].strip()} ({time.perf_counter() - t0:.1f} s)")
    finally:
        sys.argv, tempfile.tempdir = argv, tmp
    stamp(card, f"phases s, t, u, v, w: {t_t - t_s:.1f} s, {t_u - t_t:.1f} s, {t_v - t_u:.1f} s, "
                f"{t_w - t_v:.1f} s, {time.perf_counter() - t_w:.1f} s")
    return dict(s_launches=s_launches, s_p1=s_p1, s_shade=s_shade, t_launches=t_launches, t_p1=t_p1,
                t_shade=t_shade)


def quiet(fn, *args):
    """fn(*args) with what it prints (stdout and stderr) kept: (its
    result, the lines)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(buf):
        result = fn(*args)
    return result, buf.getvalue().splitlines()


def bench_phases(card: str, dev) -> dict:
    """Phases x and y: the port's bench (rts_tpu_torch.bench.main) and its
    contract check (rts_tpu_torch.contract.main) in process, each run's
    printed lines stamped.  Returns the bench's K1 launches on the
    terrain, and its K3 launches and swept tiles on the sphere."""
    from rts_tpu_torch import bench, contract
    from rts_tpu_torch.engine.wavefront import shade_on_card

    t_x = time.perf_counter()
    # ---- x. the bench: --tiny, and configs 4 and 1 at full width
    launches = {}
    for what, argv in BENCH_RUNS:
        traces, brute, trace = [], [], bench.trace_cpi

        def traced(*state, traces=traces, brute=brute, trace=trace):
            # a brute-force CPI on the card shades every segment of every pulse
            base_, batch_, cfg_, _ = state
            if cfg_.accel != "cluster" and shade_on_card(base_.tri_verts, cfg_):
                brute.append(batch_.tx_origin.shape[0] * cfg_.num_segments)
            traces.append(trace(*state))
            return traces[-1]

        bench.trace_cpi = traced
        reset_counts(dev)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            record, lines = quiet(bench.main, [*argv, "--device", dev.type])
        finally:
            bench.trace_cpi = trace
        sync()
        seconds = time.perf_counter() - t0
        k3 = kernel_calls("K3")
        k1 = kernel_calls() - k3 - kernel_calls("K5") - kernel_calls("K6")
        sweeps, swept = sweep_counts()
        launches[what] = dict(K1=k1, K3=k3, P1=phase1_calls(f"phase x {what}"), sweeps=sweeps, swept=swept)
        # --stats traces segment 1 once more outside a CPI (bench._stats): no shading
        launches[what]["S"] = shade_calls(f"phase x {what}", kernel_calls() - int("--stats" in argv) + sum(brute))
        received = int((traces[-1].received >= 0).sum())
        for line in lines:
            stamp(card, f"phase x {what}: {line}")
        if not math.isfinite(record["value"]) or received == 0:
            raise AssertionError(f"phase x {what}: value {record['value']}, {received} lanes received")
        if what == "terrain-1M":
            if not same_result(traces[0], traces[1]):
                raise AssertionError("phase x terrain-1M: a second trace_cpi differs from the first")
            if k1 == 0 or k3:
                raise AssertionError(f"phase x terrain-1M: {k1} K1 and {k3} K3 launches")
        if what == "sphere-1.31M" and k3 == 0:
            raise AssertionError("phase x sphere-1.31M: the prune (K3) never launched")
        stamp(card, f"phase x {what}: {len(traces)} trace_cpi runs in {seconds:.1f} s (prepare_cpi "
                    f"included), {received} lanes received in the last; launches K1 {k1}, K3 {k3}, "
                    f"{sweeps} of them swept {swept} tiles; peak device memory "
                    f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB"
                    + ("; the second run bit-identical to the first" if what == "terrain-1M" else ""))
        del traces
    t_y = time.perf_counter()
    # ---- y. the 1e-6 contract: the production trace on the card, the
    # f64 brute-force reference on the host CPU
    for argv in ([], ["--refr"]):
        record, lines = quiet(contract.main, [*argv, "--device", dev.type])
        for line in lines:
            stamp(card, f"phase y {' '.join(argv) or 'plain'}: {line}")
        if not record["ok"]:
            raise AssertionError(f"phase y {argv}: the 1e-6 contract fails: {record}")
    stamp(card, f"phases x and y: {t_y - t_x:.1f} s, {time.perf_counter() - t_y:.1f} s")
    return dict(k1_terrain=launches["terrain-1M"]["K1"], k3_sphere=launches["sphere-1.31M"]["K3"],
                sphere_sweeps=launches["sphere-1.31M"]["sweeps"], sphere_swept=launches["sphere-1.31M"]["swept"],
                p1={what: n["P1"] for what, n in launches.items()}, shade={what: n["S"] for what, n in launches.items()})


def oracle_scenes() -> dict:
    """Phase v's scenes of tests/test_engine_vs_oracle.py, built with the
    port: the 27-ray moving sphere fan, the two-plate double bounce, and
    the dielectric slab with two receivers."""
    import numpy as np

    from rts_tpu_torch import Parameters
    from rts_tpu_torch.geometry import rect_mesh, sphere_mesh
    from rts_tpu_torch.geometry.scene import compile_scene
    from rts_tpu_torch.physics import rx_sphere_geometry

    def rx(pos, az, radius):
        k = len(pos)
        return rx_sphere_geometry(rx_pos=np.asarray(pos, float), rx_azimuth=np.asarray(az, float),
                                  rx_elevation=np.zeros(k), sphere_radius=np.full(k, radius),
                                  theta_span=np.ones(k), phi_span=np.ones(k))

    z = [0.0, 0.0, 0.0]
    ball, _ = sphere_mesh(2, 10.0)
    m1 = rect_mesh(2.0, 120.0, 120.0, yaw=-np.pi / 4).translated([500.0, 0.0, 0.0])
    m2 = rect_mesh(2.0, 120.0, 120.0, yaw=np.pi / 4).translated([500.0, 300.0, 0.0])
    slab = rect_mesh(10.0, 300.0, 300.0).translated([500.0, 0.0, 0.0])
    return {
        "sphere fan": (compile_scene([ball.translated([800.0, 0.0, 0.0])], [1.0], [1.0],
                                     [np.array([-150.0, 30.0, 5.0])]),
                       Parameters(num_rays=3, max_refl_depth=2), z, [0.0, 0.0], [0.03, 0.03, 0.0],
                       rx([z], [0.0], 15.0)),
        "two plates": (compile_scene([m1, m2], [1.0, 0.7], [1.0, 1.0], [np.zeros(3), np.zeros(3)]),
                       Parameters(num_rays=3, max_refl_depth=3), z, [0.0, 0.0], [0.02, 0.02, 0.0],
                       rx([z], [0.0], 5.0)),
        "dielectric slab": (compile_scene([slab], [0.5], [1.5], [np.array([0.0, 20.0, 0.0])]),
                            Parameters(num_rays=2, max_refl_depth=2, max_refr_depth=2), z, [0.0, 0.0],
                            [0.01, 0.01, 0.0], rx([z, [2000.0, 0.0, 0.0]], [0.0, np.pi], 8.0)),
    }


def phase1_phases(card: str, dev) -> dict:
    """Phase z: phase 1's kernel on every closest_hit_clustered call of
    pulse 0 of the terrain CPI and of config 5 (cpi256 knobs): the lists
    its launch in the pulse gave phase 2 against _tile_candidates' on the
    CPU, element for element; its time and the plain version's on the same
    operands on the card (CUDA events); its bound, the larger of
    P1_SLAB_OPS per live ray and tested box over the FP32 peak and the
    rays, cluster boxes and lists, each moved once, over the memory rate.
    Returns the kernels line's entry, less its launches (main's, read from
    the main paths' runs)."""
    from rts_tpu_torch import Parameters
    from rts_tpu_torch.ops import cluster_trace as CT
    from rts_tpu_torch.sim import prepare_cpi

    calls = []
    for what, world, rays, knobs in (("terrain", terrain_world(1, TRIS), NUM_RAYS, {}),
                                     ("config 5", imaging_world(1, TRIS), IMAGING_RAYS, IMAGING_KNOBS)):
        state = prepare_cpi(world, Parameters(num_rays=rays, max_refl_depth=2), preset="production",
                            device=dev, **knobs)
        cfg = state[2]
        opts = dict(cand_order=cfg.cand_order, p1_fanout=cfg.p1_fanout, p1_super_k=cfg.p1_super_k,
                    p1_fanout0=cfg.p1_fanout0, p1_super_k0=cfg.p1_super_k0)
        for seg, (inp, shape) in enumerate(segment_calls(state, 0)[1], 1):
            a = (inp.origin, inp.direction, inp.tmin, inp.mn, inp.mx, shape.ray_tile, shape.sub_tiles,
                 shape.k_max)
            ref = CT._tile_candidates(*(x.cpu() if isinstance(x, torch.Tensor) else x for x in a), **opts)
            for x, y, name in zip((inp.cand, inp.meta, inp.bits, inp.ent), ref, ("cand", "meta", "bits", "ent")):
                if not torch.equal(x.cpu(), y):
                    raise AssertionError(f"phase z {what} segment {seg}: {name} differs from the plain "
                                         f"version's in {int((x.cpu() != y).sum())} places")
            ms = time_ms(lambda: CT.tile_candidates(*a, **opts), 20)
            plain_ms = time_ms(lambda: CT._tile_candidates(*a, **opts), 3)
            o, d, _, mn = a[:4]
            shp = CT.phase1_shape(o.shape[1], mn.shape[0], *a[5:], **opts)
            live = int(((d * d).sum(0) > 0).sum())
            boxes = shp.s0 + (shp.k0 * shp.f0 if shp.s0 else shp.s) + shp.kf
            ops = P1_SLAB_OPS * live * boxes
            nbytes = 28 * o.shape[1] + 24 * mn.shape[0] + 4 * shp.tiles * (3 * shape.k_max + 2)
            t_ops, t_bytes = ops / FP32_PEAK, nbytes / HBM_RATE
            r = {"what": f"{what} segment {seg}", "tiles": shp.tiles, "live_rays": live,
                 "boxes_a_ray": boxes, "level0": shp.s0 > 0, "ms": ms, "plain_ms": plain_ms,
                 "ops": ops, "bytes": nbytes, "bound_ms": 1e3 * max(t_ops, t_bytes),
                 "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
            r["share"] = r["bound_ms"] / ms
            calls.append(r)
            stamp(card, f"phase z {r['what']}: {shp.tiles} tiles of {shape.ray_tile}, {live} live rays x "
                        f"{boxes} boxes, the pulse's lists equal to the plain version's; kernel {ms:.4f} ms, "
                        f"plain {plain_ms:.3f} ms a call; bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
                        f"{100 * r['share']:.1f}% of it")
        del state
    return {"name": "phase1 (tile candidates)", "route": "cuda",
            "source": "rts_tpu_torch/ops/csrc/phase1.cu",
            "replaces": "none: rts_tpu/ops/cluster_trace.py:_tile_candidates is plain XLA",
            "calls": calls}


SHADE_REPS = 20  # phase 5: kernel launches timed a call


def plain_shade(state, bufs, hit, scene, rx, tx_origin, cfg, miss_only: bool):
    """What one shade_cuda call computes, by the plain programs:
    _process_miss, then unless ``miss_only`` _process_hit without the
    spawn (both leave their operands as they were)."""
    from rts_tpu_torch.engine import wavefront as W

    hit_mask = state.active & hit.found
    state = W._process_miss(state, state.active & ~hit.found, rx, tx_origin, cfg)
    if miss_only:
        return state, bufs
    return W._process_hit(state, bufs, hit, hit_mask, scene, tx_origin, cfg, state.origin.shape[1], spawn=False)


def shade_bytes(st, hit, cfg, miss_only: bool, smooth: bool, shade_rows: bool, num_rx: int, nt: int) -> int:
    """The bytes one shading kernel call must move, from its lanes as the
    call found them (``st``, ``hit``): each field the lane's program reads
    or writes, once.  Every lane reads its active flag; a dead one reads and
    writes its range and Doppler (not in the miss half).  A live lane reads
    its origin, direction, depths, range, power, Doppler, end flag, found
    flag, receiver and capture bits and writes the last three, then writes
    range, power, Doppler, end and active.  A lane the closest-hit program
    shades reads t, its triangle, its target, its normal (the corner
    normals and barycentrics where smooth), the refraction index and
    writes the old index, the depth and the origin; its path and triangle
    records where their rows exist, the first hit on a first bounce, and on
    a reflection reads its segment direction and writes it, the direction,
    tmin and the RCS angles (with rcs_angles).  The receivers, the
    transmitter and the per-target tables are read once."""
    act = st.active
    n_live = int(act.sum())
    nbytes = (act.numel() - n_live) * (1 if miss_only else 17) + n_live * (71 + 14)
    if not miss_only:
        refl, refr = st.refl_depth, st.refr_depth
        gate = act & hit.found & ~st.end & ((refr < cfg.max_refr_dev) | (refl < cfg.max_refl_dev - 1))
        col = refl + refr
        reflects = gate & (refl + 1 < cfg.max_refl_dev)
        depth, width = cfg.depth_total, st.tri_seq.shape[0]
        nbytes += int(gate.sum()) * (8 + 4 + (44 if smooth else 12) + 4 + 8 + 12)
        nbytes += 4 * int((gate & (refr != 1) & (col < depth)).sum()) + 4 * int((gate & (col < width)).sum())
        nbytes += 12 * int((gate & (refl == 0) & (refr == 0)).sum()) + 40 * int(reflects.sum())
        if cfg.rcs_angles:
            nbytes += 8 * int((reflects & (col < depth)).sum())
    return nbytes + num_rx * 32 + 12 + nt * (16 + (36 if shade_rows else 0))


def kernel_device_ms(fn, name: str, reps: int):
    """The mean device time (ms) of the kernels whose name holds ``name``
    over ``reps`` calls of fn, by torch.profiler; None when the profiler
    recorded none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        sync()
    us = [device_us(e) for e in prof.key_averages()
          if getattr(e, "device_type", None) == DeviceType.CUDA and name in e.key]
    return sum(us) / 1e3 / reps if us and sum(us) > 0 else None


def shade_phases(card: str, dev) -> dict:
    """Phase 5: the shading kernel (csrc/shade.cu) on every segment of pulse
    0 of the terrain CPI, the dielectric CPI and config 5, each launch's
    operands kept as the pulse gave them: the kernel on copies against the
    plain programs on copies, every LaneState field and both buffers bit
    for bit (float32 as its bits); the kernel's device time, its wrapper's
    host time a call, the plain programs' time (CUDA events), launches and
    device time; the bound, shade_bytes over the memory rate (the
    operations, a few hundred a lane at most, are not counted: at the
    FP32 peak they take a tenth of the bytes' time or less).  Returns the
    kernels line's entry, less its launches (main's, read from the main
    paths' runs)."""
    from rts_tpu_torch import Parameters
    from rts_tpu_torch.engine import wavefront as W
    from rts_tpu_torch.engine.animate import ClusterScene
    from rts_tpu_torch.engine.cpi import make_pulse_fn, pulse_args
    from rts_tpu_torch.engine.intersect import HitResult
    from rts_tpu_torch.sim import prepare_cpi

    calls, pulses = [], {}
    for what, world, params, knobs in (
            ("terrain", terrain_world(1, TRIS), Parameters(num_rays=NUM_RAYS, max_refl_depth=2), {}),
            ("dielectric", dielectric_world(1, TRIS),
             Parameters(num_rays=NUM_RAYS, max_refl_depth=2, max_refr_depth=2), {}),
            ("config 5", imaging_world(1, TRIS), Parameters(num_rays=IMAGING_RAYS, max_refl_depth=2),
             IMAGING_KNOBS)):
        state = prepare_cpi(world, params, preset="production", device=dev, **knobs)
        kept, inner = [], W.shade_cuda

        def keep(st, bufs, hit, scene, rx, tx_origin, cfg, miss_only=False, tables=None):
            kept.append((W.LaneState(*(x.clone() for x in st)), W.TraceBuffers(*(x.clone() for x in bufs)),
                         HitResult(*(None if x is None else x.clone() for x in hit)), scene, rx, tx_origin, cfg,
                         miss_only))
            return inner(st, bufs, hit, scene, rx, tx_origin, cfg, miss_only, tables)

        W.shade_cuda = keep
        try:
            make_pulse_fn(state[0], state[2], state[3])[0](*pulse_args(state[1], 0))
        finally:
            W.shade_cuda = inner
        sync()
        cfg = state[2]
        halves = sum(k[-1] for k in kept)  # a dead narrow segment is skipped
        if not 1 <= len(kept) <= cfg.num_segments or halves != (2 if cfg.refraction_on else 0):
            raise AssertionError(f"phase 5 {what}: {len(kept)} launches of {cfg.num_segments} segments, "
                                 f"{halves} of them the miss half")
        total = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, plain_launches=0)
        for seg, (st, bufs, hit, scene, rx, tx, c, miss_only) in enumerate(kept, 1):
            def fresh():
                return W.LaneState(*(x.clone() for x in st)), W.TraceBuffers(*(x.clone() for x in bufs))

            got = inner(*fresh(), hit, scene, rx, tx, c, miss_only)
            ref = plain_shade(*fresh(), hit, scene, rx, tx, c, miss_only)
            for name, a, b in zip((*W.LaneState._fields, *W.TraceBuffers._fields), (*got[0], *got[1]),
                                  (*ref[0], *ref[1])):
                if not bit_equal(a, b):
                    raise AssertionError(f"phase 5 {what} segment {seg}: {name} differs from the plain "
                                         f"programs' in {int((bits_of(a) != bits_of(b)).sum())} places")
            copies = [fresh() for _ in range(SHADE_REPS)]
            sync()
            t0 = time.perf_counter()
            for s_, b_ in copies:
                inner(s_, b_, hit, scene, rx, tx, c, miss_only)
            host_us = 1e6 * (time.perf_counter() - t0) / SHADE_REPS
            del copies
            ms = kernel_device_ms(lambda: inner(*fresh(), hit, scene, rx, tx, c, miss_only), "shade_kernel",
                                  SHADE_REPS)
            plain_ms = time_ms(lambda: plain_shade(st, bufs, hit, scene, rx, tx, c, miss_only), 3)
            plain_launches, plain_device_ms = device_launches(
                lambda: plain_shade(st, bufs, hit, scene, rx, tx, c, miss_only))
            shade_rows = isinstance(scene, ClusterScene) and c.interpolate_smooth
            nbytes = shade_bytes(st, hit, c, miss_only, c.interpolate_smooth, shade_rows, rx.num_rx,
                                 scene.target_refl.shape[0])
            r = {"what": f"{what} segment {seg}" + (" (miss half)" if miss_only else ""),
                 "lanes": st.origin.shape[1], "live_lanes": int(st.active.sum()),
                 "hits": int((st.active & hit.found).sum()), "ms": ms, "host_us": host_us,
                 "plain_ms": plain_ms, "plain_launches": plain_launches, "plain_device_ms": plain_device_ms,
                 "bytes": nbytes, "bound_ms": 1e3 * nbytes / HBM_RATE, "bound_by": "bytes"}
            r["share"] = None if ms is None else r["bound_ms"] / ms
            calls.append(r)
            for k in ("ms", "plain_ms", "bound_ms", "plain_launches"):
                total[k] += r[k] or 0
            kernel = "not recorded by the profiler" if ms is None else f"{ms:.4f} ms on the device"
            share = "" if ms is None else f", {100 * r['share']:.1f}% of it"
            stamp(card, f"phase 5 {r['what']}: {r['lanes']} lanes ({r['live_lanes']} live, {r['hits']} found a "
                        f"triangle), every field bit-equal to the plain programs'; kernel {kernel}, its wrapper "
                        f"{host_us:.1f} us of host time a call; plain {plain_ms:.3f} ms ({plain_launches} launches, "
                        f"{plain_device_ms} ms on the device); bound {r['bound_ms']:.4f} ms ({nbytes} bytes){share}")
        pulses[what] = total
        stamp(card, f"phase 5 {what}: a pulse's {len(kept)} launches {total['ms']:.4f} ms on the device, the "
                    f"plain programs {total['plain_ms']:.3f} ms ({total['plain_launches']} launches); bound "
                    f"{total['bound_ms']:.4f} ms")
        del state, kept
    return {"name": "shade (miss and closest-hit programs)", "route": "cuda",
            "source": "rts_tpu_torch/ops/csrc/shade.cu",
            "replaces": "none: rts_tpu/engine/wavefront.py:_process_miss and _process_hit are plain XLA",
            "pulse": pulses, "calls": calls}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from rts_tpu_torch import Parameters
    from rts_tpu_torch.core.constants import SCENE_EPS
    from rts_tpu_torch.engine.animate import animate_packed
    from rts_tpu_torch.engine.cpi import make_pulse_fn, pulse_args, trace_cpi
    from rts_tpu_torch.engine.fan import generate_fan_c
    from rts_tpu_torch.engine.replay import replay_refine
    from rts_tpu_torch.ops import cluster_trace as CT
    from rts_tpu_torch.sim import check_replay_overflow, prepare_cpi

    dev = torch.device(DEVICE)
    card = card_line()
    torch.manual_seed(0)
    params = Parameters(num_rays=NUM_RAYS, max_refl_depth=2)

    # ---- 1. build
    t0 = time.perf_counter()
    lib = CT.build_kernel(verbose=True)
    CT._load()
    stamp(card, f"phase 1 build: {lib.name} in {time.perf_counter() - t0:.2f} s")
    occ = (ctypes.c_int * 3)()
    err = CT._load().mt_traverse_occupancy(512, 8, occ)  # both paths' ray_tile and sub_tiles
    if err:
        raise RuntimeError(f"occupancy query failed: cudaError {err}")
    stamp(card, f"phase 1 occupancy (ray_tile 512, sub_tiles 8: both paths): blocks of {occ[0]} "
                f"threads; candidate grid {occ[1]} blocks, {occ[1] * occ[0] // 32} warps per SM; "
                f"sweep grid {occ[2]} blocks, {occ[2] * occ[0] // 32} warps per SM")
    # ---- 2. kernel against plain
    def segment1(world, **options):
        """CPI state and the segment-1 closest_hit_clustered arguments of
        pulse 0 of ``world``."""
        t0 = time.perf_counter()
        state = prepare_cpi(world, params, device=dev, **options)
        base, batch, cfg, spec = state
        scene = animate_packed(base, batch.rot[0], batch.pos[0], batch.vel[0])
        fan = generate_fan_c(cfg.num_rays, (batch.tx_dir[0, 0], batch.tx_dir[0, 1]), spec.tx_span,
                             device=dev)
        origin = batch.tx_origin[0][:, None].expand(3, fan.shape[1]).contiguous()
        tmin = torch.full((fan.shape[1],), SCENE_EPS, device=dev)
        knobs = dict(cluster_size=cfg.cluster_size, ray_tile=cfg.ray_tile,
                     group_size=cfg.group_size, super_size=cfg.super_size,
                     sub_tiles=cfg.sub_tiles, candidates=cfg.candidates, mt_group=cfg.mt_group,
                     mt_tail=cfg.mt_tail, mt_prune=cfg.mt_prune, p1_fanout=cfg.p1_fanout,
                     p1_super_k=cfg.p1_super_k)
        args = (origin, fan, tmin, scene.tri_pack, scene.aabb_mn, scene.aabb_mx, batch.tx_origin[0])
        stamp(card, f"prepare_cpi: {int(base.tri_verts.shape[0])} triangles, "
                    f"{cfg.rays_per_fan} rays/pulse, {time.perf_counter() - t0:.2f} s")
        return state, scene, args, knobs

    def captured(args, knobs):
        """One kernel call of closest_hit_clustered: its hit, and the
        phase-2 operands it launched the kernel on, (inp, shape)."""
        calls = []

        def keep(inp, shape):
            calls.append((inp, shape))
            return CT.mt_traverse(inp, shape)

        return CT.closest_hit_clustered(*args, traverse=keep, **knobs), calls[0]

    def check(args, knobs, what, plain_reps=2):
        """Kernel against plain on one segment (hits and work counters);
        times of each version on the same phase-1 lists (captured from the
        kernel's call), and the pairs and clusters the plain version
        evaluated."""
        got, stats = CT.closest_hit_clustered(*args, with_stats=True, **knobs)
        (ref, ref_stats), pairs, clusters = plain_counted(
            lambda: CT.closest_hit_clustered(*args, with_stats=True,
                                             traverse=CT.mt_traverse_reference, **knobs),
            knobs["cluster_size"])
        sync()
        err = compare_hits(got, ref, what)
        if knobs.get("emit_shade"):
            if not bit_equal(got.shade, ref.shade):
                raise AssertionError(f"{what}: shade not bit-equal to the plain gather")
        if not torch.equal(stats, ref_stats):
            raise AssertionError(f"{what}: work counters differ from the plain version's")
        inp, shape = captured(args, knobs)[1]
        ms = time_ms(lambda: CT.mt_traverse(inp, shape), 20)
        plain_ms = time_ms(lambda: CT.mt_traverse_reference(inp, shape), plain_reps)
        stamp(card, f"{what}: {int(got.found.sum())} of {args[1].shape[1]} rays hit, "
                    f"{inp.meta.shape[0]} tiles ({int(inp.meta[:, 1].sum())} swept), tri/found "
                    f"identical, t/beta/gamma{'/shade' if shape.emit_shade else ''} and counters "
                    f"bit-equal; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms per call; the plain "
                    f"version evaluated {pairs} pairs over {clusters} clusters; the kernel "
                    f"{1e9 * ms / pairs:.3f} ps per pair")
        return dict(hit=got, err=err, ms=ms, plain_ms=plain_ms, call=(inp, shape), stats=stats,
                    pairs=pairs, clusters=clusters, what=what)

    def bounds(rows):
        """Give each of ``rows`` (modes whose hits are bit-identical on the
        same inputs) the bound of the function they all compute: the fewest
        pairs and clusters that any of them evaluated."""
        pairs, clusters = min(r["pairs"] for r in rows), min(r["clusters"] for r in rows)
        for r in rows:
            inp, shape = r["call"]
            b = bound(inp, shape, r["stats"], pairs, clusters)
            r.update(b, bound_pairs=pairs)
            stamp(card, f"{r['what']} bound: the fewest of {len(rows)} bit-identical modes, "
                        f"{pairs} pairs over {clusters} clusters (this mode {r['pairs']}), "
                        f"{b['ops'] / 1e9:.3f} GFLOP, {b['bytes'] / 1e6:.3f} MB; bound "
                        f"{b['bound_ms']:.4f} ms by {b['bound_by']}, the kernel at "
                        f"{100 * b['bound_ms'] / r['ms']:.2f}% of it")

    (base, batch, cfg, spec), _, hit_args, knobs = segment1(terrain_world(PULSES, TRIS),
                                                            preset="production")
    k1 = check(hit_args, knobs, "phase 2 terrain segment 1")
    # sweep mode: a small terrain with candidates=0 (every tile walks the
    # supergroup/group/cluster hierarchy)
    _, s_args, s_knobs = segment1(terrain_world(PULSES, SMALL_TRIS), preset="production",
                                  candidates=0)[1:]
    k2 = check(s_args, s_knobs, "phase 2 sweep mode (candidates=0)")
    bounds([k2])
    k2["what"] = "terrain-20k sweep-only (candidates=0)"
    del s_args

    # ---- 3. terrain main path
    reset_counts(dev)
    sync()
    t0 = time.perf_counter()
    out = trace_cpi(base, batch, cfg, spec)
    sync()
    first_s = time.perf_counter() - t0
    launches = kernel_calls()
    p1_terrain = phase1_calls("phase 3")
    shade_terrain = shade_calls("phase 3")
    t_sweeps, t_swept = sweep_counts()
    received = int((out.received >= 0).sum())
    if launches == 0:
        raise AssertionError("the terrain path never launched the traversal kernel")
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
        if not same_result(a, b):
            raise AssertionError(f"second run differs in {name}: reductions are not deterministic")
    best_s = min(first_s, second_s)
    stamp(card, f"phase 3 terrain main path (refine=True): {P} pulses x {R} rays, {received} "
                f"received lanes, {int(out.agg.emit.sum())} emitted paths, {launches} kernel "
                f"launches ({t_sweeps} of them swept {t_swept} tiles in all); "
                f"{1e3 * best_s / P:.1f} ms/pulse, {P * R / best_s:.4g} rays/s "
                f"(first run {first_s:.2f} s, second {second_s:.2f} s, bit-identical)")
    terrain_ms_pulse = 1e3 * best_s / P
    # ---- 4. one terrain pulse through the plain traversal, against the kernel
    runs = []
    for traverse in (None, CT.mt_traverse_reference):
        one_pulse, aggregate = make_pulse_fn(base, cfg, spec, traverse=traverse)
        res, power, doppler, delay = one_pulse(*pulse_args(batch, 0))
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
    del again, runs, res_k, res_p, out_k, out_p  # base, batch: phase j
    # ---- 5. the shading kernel against the plain programs
    shade_entry = shade_phases(card, dev)

    # ---- a. moving scene, segment 1, with the prune (K3)
    (mbase, mbatch, mcfg, mspec), mscene, m_args, m_knobs = segment1(moving_world(PULSES), **MOVING_KNOBS)
    k3 = check(m_args, m_knobs, "phase a moving segment 1, mt_prune")
    hit_p, (inp, shape) = k3["hit"], k3["call"]
    hit_np = CT.closest_hit_clustered(*m_args, **{**m_knobs, "mt_prune": False})
    sync()
    compare_hits(hit_p, hit_np, "phase a moving segment 1", against="the kernel without the prune")
    ms_np = time_ms(lambda: CT.mt_traverse(inp, shape._replace(mt_prune=False)), 20)
    stamp(card, f"phase a: the kernel with the prune equals it without, bit for bit; without the "
                f"prune {ms_np:.3f} ms per call")
    # the swept tiles alone (the sweep, K2) and the candidate tiles alone
    # (the candidate grid): the two parts of the call
    def tiles_of(sel):
        lanes = (sel[:, None] * shape.ray_tile + torch.arange(shape.ray_tile, device=dev)).reshape(-1)
        return inp._replace(origin=inp.origin[:, lanes].contiguous(),
                            direction=inp.direction[:, lanes].contiguous(),
                            tmin=inp.tmin[lanes].contiguous(),
                            **{k: getattr(inp, k)[sel].contiguous() for k in ("cand", "meta", "bits", "ent")})

    swept = inp.meta[:, 1] != 0
    if not bool(swept.any()):
        raise AssertionError("phase a: no tile of the moving segment 1 sweeps")
    sw_inp = tiles_of(torch.nonzero(swept).reshape(-1))
    k2m = check_call(sw_inp, shape, f"moving segment 1, its {int(swept.sum())} swept tiles alone")
    cand_inp = tiles_of(torch.nonzero(~swept).reshape(-1))
    ms_cand = time_ms(lambda: CT.mt_traverse(cand_inp, shape), 20)
    stamp(card, f"phase a: its {int(swept.sum())} swept tiles alone (the sweep) {k2m['ms']:.3f} ms per "
                f"call, bit-equal to plain with its counters ({k2m['pairs']} pairs over {k2m['clusters']} "
                f"clusters, bound {k2m['bound_ms']:.4f} ms); its {int((~swept).sum())} candidate tiles alone "
                f"(the candidate grid) {ms_cand:.3f} ms; the whole call {k3['ms']:.3f} ms")
    del sw_inp, cand_inp

    # ---- b. the same segment with the shade emit (K4)
    s_knobs = {**m_knobs, "emit_shade": True}
    k4 = check(m_args, {**s_knobs, "shade_pack": mscene.shade_pack},
               "phase b moving segment 1, emit_shade")
    compare_hits(k4["hit"], hit_p, "phase b moving segment 1", against="the run without the emit")

    # ---- c. moving main path
    reset_counts(dev)
    sync()
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message="replay cap overflow")  # fails the run
        t0 = time.perf_counter()
        mout = trace_cpi(mbase, mbatch, mcfg, mspec)
        sync()
        first_s = time.perf_counter() - t0
        k3_launches = kernel_calls("K3")
        m_launches = kernel_calls()
        m_p1 = phase1_calls("phase c")
        m_shade = shade_calls("phase c")
        k2_launches, m_swept = sweep_counts()
        counts = check_replay_overflow(mout, mcfg)
    m_received = int((mout.received >= 0).sum())
    if k3_launches == 0:
        raise AssertionError("the moving path never launched the kernel with the prune")
    if k2_launches == 0:
        raise AssertionError("the moving path never swept a tile")
    if m_received == 0 or (counts == 0).any():
        raise AssertionError(f"the moving path received too little: {counts.tolist()} lanes per pulse")
    for name in ("power", "doppler", "delay"):
        if not bool(torch.isfinite(getattr(mout, name)).all()):
            raise AssertionError(f"non-finite {name} on the moving path")
    if not all(bool(torch.isfinite(a).all()) for a in mout.agg if a.dtype.is_floating_point):
        raise AssertionError("non-finite aggregate on the moving path")
    t0 = time.perf_counter()
    magain = trace_cpi(mbase, mbatch, mcfg, mspec)
    sync()
    second_s = time.perf_counter() - t0
    if not same_result(mout, magain):
        raise AssertionError("second moving run differs: not deterministic")
    best_s = min(first_s, second_s)
    m_ms_pulse = 1e3 * best_s / P
    stamp(card, f"phase c moving main path (mt_prune, refine): {P} pulses x {R} rays, "
                f"{int(mbase.tri_verts.shape[0])} triangles, {m_received} received lanes "
                f"({counts.min()}-{counts.max()} per pulse, cap {mcfg.replay_cap}), "
                f"{int(mout.agg.emit.sum())} emitted paths, {m_launches} kernel launches "
                f"({k3_launches} with the prune; {k2_launches} swept {m_swept} tiles in all, "
                f"{m_swept / P:.1f} a pulse); {m_ms_pulse:.1f} ms/pulse, "
                f"{P * R / best_s:.4g} rays/s (first run {first_s:.2f} s, second "
                f"{second_s:.2f} s, bit-identical)")

    # ---- d. one moving pulse with the shade emit against the gather
    args0 = pulse_args(mbatch, 0)
    reset_counts(dev)
    one_s, agg_s = make_pulse_fn(mbase, dataclasses.replace(mcfg, shade_emit=True), mspec)
    res_s = one_s(*args0)
    out_s = agg_s(*res_s)
    sync()
    k4_launches = kernel_calls("K4")
    d_p1 = phase1_calls("phase d")
    d_shade = shade_calls("phase d")
    one_g, agg_g = make_pulse_fn(mbase, mcfg, mspec)
    res_g = one_g(*args0)
    out_g = agg_g(*res_g)
    if k4_launches == 0:
        raise AssertionError("the shade-emit pulse never launched the kernel's shade epilogue")
    for name, a, b in (("received", res_s[0].received, res_g[0].received),
                       ("path rows", res_s[0].path, res_g[0].path),
                       ("emit", out_s.agg.emit, out_g.agg.emit),
                       ("trace_cpi pulse 0", out_g.received, mout.received[0])):
        if not torch.equal(a, b):
            raise AssertionError(f"shade-emit pulse differs in {name}")
    stamp(card, f"phase d shade-emit pulse: {k4_launches} launches with the emit; received "
                f"({int((res_s[0].received >= 0).sum())} lanes), path rows and emit identical to "
                f"the gather; whole result bit-identical: {same_result(out_s, out_g)}")

    # ---- e. one moving pulse refined against unrefined
    one_u, agg_u = make_pulse_fn(mbase, dataclasses.replace(mcfg, refine=False), mspec)
    res_u = one_u(*args0)
    out_u = agg_u(*res_u)
    for name, a, b in (("received", res_u[0].received, res_g[0].received),
                       ("path rows", res_u[0].path, res_g[0].path),
                       ("tri_seq", res_u[0].tri_seq, res_g[0].tri_seq),
                       ("emit", out_u.agg.emit, out_g.agg.emit),
                       ("npath", out_u.agg.npath, out_g.agg.npath),
                       ("path_match", out_u.agg.path_match, out_g.agg.path_match)):
        if not torch.equal(a, b):
            raise AssertionError(f"the replay changed a decision: {name}")
    got = out_g.received >= 0
    d_power = float((out_g.power[got].double() / out_u.power[got].double() - 1.0).abs().max())
    ph = lambda o: o.agg.phase.double() + o.agg.phase_lo.double()
    d_phase = (ph(out_g) - ph(out_u)).abs()[got]
    d_phase = float(torch.minimum(d_phase, 2 * math.pi - d_phase).max())
    replay_ms = time_ms(lambda: replay_refine(mbase, res_u[0], mcfg, args0[-1], tx_span=mspec.tx_span), 10)
    stamp(card, f"phase e replay: decisions identical refined and unrefined; largest change "
                f"power {d_power:.3e} (relative), phase {d_phase:.3e} rad; replay "
                f"{replay_ms:.3f} ms per pulse, {100 * replay_ms / m_ms_pulse:.2f}% of the "
                f"{m_ms_pulse:.1f} ms pulse")
    del mout, magain, res_s, res_g, res_u, out_s, out_g, out_u, args0  # mbase, mbatch: phase j

    # ---- f. terrain segment 1 with the live pack (K5)
    k1_call = k1["call"]
    k5 = check(hit_args, {**knobs, "resident_cap": RESIDENT_CAP},
               f"phase f terrain segment 1, resident_cap={RESIDENT_CAP} (K5)")
    compare_hits(k5["hit"], k1["hit"], "phase f", against="phase 2's kernel (K1)")
    k5_call = k5["call"]
    swept = [int(c[0].meta[:, 1].sum()) for c in (k1_call, k5_call)]
    if swept[0] != swept[1]:
        raise AssertionError(f"phase f: {swept[1]} swept tiles, phase 2 had {swept[0]}")
    n_live = torch.unique(k1_call[0].cand).numel()
    (t1a, t1b), (t5a, t5b) = in_turns(lambda: CT.mt_traverse(*k1_call), lambda: CT.mt_traverse(*k5_call))
    stamp(card, f"phase f: bit-equal to phase 2's kernel; live set {n_live} clusters of the cap "
                f"{RESIDENT_CAP}, {swept[1]} swept tiles as in phase 2; in turns K1 {t1a:.3f} ms, "
                f"K5 {t5a:.3f} ms, K5 {t5b:.3f} ms, K1 {t1b:.3f} ms per call")
    k8 = check(hit_args, {**knobs, "resident_cap": 8}, "phase f terrain segment 1, resident_cap=8",
               plain_reps=1)
    hit0 = CT.closest_hit_clustered(*hit_args, **{**knobs, "candidates": 0})
    sync()
    compare_hits(k8["hit"], hit0, "phase f resident_cap=8", against="the sweep-only kernel (candidates=0)")
    ties = compare_ties(k8["hit"], k1["hit"], "phase f resident_cap=8", "phase 2's kernel (K1)")
    swept8 = int(k8["call"][0].meta[:, 1].sum())
    if swept8 != k8["call"][0].meta.shape[0]:
        raise AssertionError(f"phase f resident_cap=8: {swept8} swept tiles, not every tile")
    bounds([k8])
    k8["what"] = f"terrain-1M segment 1, resident_cap=8 (live-set overflow, all {swept8} tiles swept)"
    stamp(card, f"phase f resident_cap=8: the live set overflows, all {swept8} tiles sweep; "
                f"bit-equal to the sweep-only kernel, and to K1 but for {ties} lanes of an exact "
                f"t tie that the sweep's visit order breaks the other way")
    del hit0

    # ---- g. terrain segment 1 with per-candidate windows (K6), and the mask order
    k6 = check(hit_args, {**knobs, "mt_union": False}, "phase g terrain segment 1, mt_union=False (K6)")
    compare_hits(k6["hit"], k1["hit"], "phase g K6", against="phase 2's kernel (K1)")
    km = check(hit_args, {**knobs, "cand_order": "mask"}, "phase g terrain segment 1, cand_order=mask")
    mask_ties = compare_ties(km["hit"], k1["hit"], "phase g mask order", "phase 2's kernel (K1)")
    (t1a, t1b), (t6a, t6b) = in_turns(lambda: CT.mt_traverse(*k1_call),
                                      lambda: CT.mt_traverse(*k6["call"]))
    stamp(card, f"phase g: K6 bit-equal to phase 2's kernel, the mask order too but for "
                f"{mask_ties} lanes of an exact t tie broken the other way; in turns K1 "
                f"{t1a:.3f} ms, K6 {t6a:.3f} ms, K6 {t6b:.3f} ms, K1 {t1b:.3f} ms per call; "
                f"mask order {km['ms']:.3f} ms")
    del km
    bounds([k1, k5, k6])

    # ---- h. moving segment 1: K6 with the prune, 4 clusters of 1,024 a window
    k6p = check(m_args, {**m_knobs, "mt_group": 4, "mt_union": False, "mt_prune": True},
                "phase h moving segment 1, mt_group=4, mt_union=False, mt_prune (K6 + K3)")
    compare_hits(k6p["hit"], hit_p, "phase h", against="phase a's kernel (K3)")
    stamp(card, f"phase h: bit-equal to phase a's kernel; K6 + K3 {k6p['ms']:.3f} ms against K3 "
                f"{k3['ms']:.3f} ms per call (phase a)")
    bounds([k3, k4, k6p])
    del m_args, mscene, hit_p, hit_np, k6p, inp

    # ---- i. the terrain CPI with the live pack (K5) and per-candidate windows (K6)
    CT.mt_traverse.resident_overflows = torch.zeros((), dtype=torch.int32, device=dev)
    mode_runs, mode_p1, mode_shade = {}, {}, {}
    for mode, option in (("K5", dict(resident_cap=RESIDENT_CAP)), ("K6", dict(mt_union=False))):
        t0 = time.perf_counter()
        state = prepare_cpi(terrain_world(PULSES, TRIS), params, preset="production", device=dev,
                            **option)
        prep_s = time.perf_counter() - t0
        reset_counts(dev)
        sync()
        t0 = time.perf_counter()
        first = trace_cpi(*state)
        sync()
        first_s = time.perf_counter() - t0
        n_mode, n_all = kernel_calls(mode), kernel_calls()
        mode_p1[mode] = phase1_calls(f"phase i {mode}")
        mode_shade[mode] = shade_calls(f"phase i {mode}")
        if n_mode == 0:
            raise AssertionError(f"the terrain CPI with {option} never launched mode {mode}")
        if not same_result(first, out):
            raise AssertionError(f"the terrain CPI with {option} differs from phase 3's")
        t0 = time.perf_counter()
        again = trace_cpi(*state)
        sync()
        second_s = time.perf_counter() - t0
        if not same_result(again, first):
            raise AssertionError(f"second terrain CPI with {option} differs: not deterministic")
        best_s = min(first_s, second_s)
        mode_runs[mode] = n_mode
        stamp(card, f"phase i terrain main path with {option}: bit-identical to phase 3, {n_mode} "
                    f"of {n_all} launches in mode {mode}; {1e3 * best_s / P:.1f} ms/pulse, "
                    f"{P * R / best_s:.4g} rays/s (first run {first_s:.2f} s, second "
                    f"{second_s:.2f} s, bit-identical; phase 3 {terrain_ms_pulse:.1f} ms/pulse; "
                    f"prepare_cpi {prep_s:.2f} s)")
        del state, first, again
    overflows = int(CT.mt_traverse.resident_overflows)
    if overflows:
        raise AssertionError(f"{overflows} segments overflowed the live pack's cap {RESIDENT_CAP}")
    stamp(card, f"phase i: no segment overflowed the live pack's cap {RESIDENT_CAP}")

    # ---- j. profile one warm pulse of each main path
    for what, state in (("terrain", (base, batch, cfg, spec)), ("moving", (mbase, mbatch, mcfg, mspec))):
        one, agg = make_pulse_fn(state[0], state[2], state[3])
        args_j = pulse_args(state[1], 0)
        try:
            profile_pulse(card, what, lambda: agg(*one(*args_j)))
        except Exception as exc:  # the phase measures; it gates nothing
            stamp(card, f"phase j {what}: the profiler failed: {exc!r}")
    del base, batch, mbase, mbatch
    brute_phases(card, dev, params)
    diel = dielectric_phases(card, dev)
    img = render_phases(card, dev)
    split = split_phases(card, dev, img)
    xy = bench_phases(card, dev)
    p1 = phase1_phases(card, dev)
    k2_calls = [k2m, k2, k8]
    k1_paths = {"terrain": launches, "dielectric": diel["launches"], "config 5": img["launches"],
                "cli": img["cli_launches"], "split config 5": split["s_launches"],
                "ray blocks": split["t_launches"], "bench terrain": xy["k1_terrain"]}
    k3_paths = {"moving": k3_launches, "bench sphere": xy["k3_sphere"]}
    p1_paths = {"terrain": p1_terrain, "terrain K5": mode_p1["K5"], "terrain K6": mode_p1["K6"],
                "moving": m_p1, "moving shade-emit pulse": d_p1, "dielectric": diel["p1"],
                "config 5": img["p1"], "cli": img["cli_p1"], "split config 5": split["s_p1"],
                "ray blocks": split["t_p1"], **{f"bench {what}": n for what, n in xy["p1"].items() if n}}
    shade_paths = {"terrain": shade_terrain, "terrain K5": mode_shade["K5"], "terrain K6": mode_shade["K6"],
                   "moving": m_shade, "moving shade-emit pulse": d_shade, "dielectric": diel["shade"],
                   "config 5": img["shade"], "cli": img["cli_shade"], "split config 5": split["s_shade"],
                   "ray blocks": split["t_shade"], **{f"bench {what}": n for what, n in xy["shade"].items()}}
    kernels = [
        # the terrain segment 1 (phase 2); its launches are those of the
        # terrain, dielectric and config-5 main paths and the CLI's, with
        # the dielectric segment-2 and segment-3 calls and config 5's
        # segment 1 (ray_tile 128) beside it
        {**entry("mt_traverse K1 (candidate windows)", "249", sum(k1_paths.values()), k1),
         "launches_by_path": k1_paths,
         "calls": [{k: r[k] for k in ("what", "err", "ms", "plain_ms", "pairs", "bound_ms", "bound_by",
                                      "tiles", "swept_tiles", "live_lanes")}
                   | {"ps_per_pair": 1e9 * r["ms"] / r["pairs"]} for r in diel["calls"] + [img["call"]]]},
        # the sweep's main-path call: the moving segment's swept tiles; its
        # launches are the moving CPI's calls that swept a tile (the
        # dielectric path's beside them)
        {**entry("mt_traverse K2 (sweep)", "568", k2_launches,
                 {**k2m, "err": max(r["err"] for r in k2_calls), "bound_pairs": k2m["pairs"]}),
         "swept_tiles": m_swept, "dielectric_sweep_calls": diel["sweeps"],
         "dielectric_swept_tiles": diel["swept"], "bench_sphere_sweep_calls": xy["sphere_sweeps"],
         "bench_sphere_swept_tiles": xy["sphere_swept"], "calls": sweep_calls(card, k2_calls)},
        # the moving main path's and the bench sphere's (config 1 at 1.31M)
        {**entry("mt_traverse K3 (mt_prune)", "557", sum(k3_paths.values()), k3),
         "launches_by_path": k3_paths},
        entry("mt_traverse K4 (emit_shade)", "521", k4_launches, k4),
        entry(f"mt_traverse K5 (resident live pack, cap {RESIDENT_CAP})", "398", mode_runs["K5"], k5),
        entry("mt_traverse K6 (mt_union=False)", "710", mode_runs["K6"], k6),
        {**p1, "launches": sum(p1_paths.values()), "launches_by_path": p1_paths},
        {**shade_entry, "launches": sum(shade_paths.values()), "launches_by_path": shade_paths},
    ]

    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
