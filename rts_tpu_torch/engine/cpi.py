"""CPI tracing: a loop over pulses (counterpart of ``rts_tpu.engine.cpi``).

Each pulse runs animate (into the clustered layout, or a ``DeviceScene``
for the brute-force path) -> fan -> trace -> (replay) -> post-process ->
aggregate on the device; ``map_pulses`` loops over the pulses in Python
and stacks the per-pulse results on a leading pulse axis.  The pulse and
ray axes are split across processes by ``rts_tpu_torch.parallel``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rts_tpu_torch.aggregate import LaneAggregate, aggregate_lanes
from rts_tpu_torch.engine.animate import SceneBase, animate_packed, animate_scene
from rts_tpu_torch.engine.compact import received_first_idx, take_lanes
from rts_tpu_torch.engine.fan import generate_fan_c
from rts_tpu_torch.engine.replay import replay_refine
from rts_tpu_torch.engine.types import RxGeomDevice, TraceConfig
from rts_tpu_torch.engine.wavefront import TraceResult, trace_fan
from rts_tpu_torch.physics.postprocess import postprocess
from rts_tpu_torch.utils.timing import trace_annotation


class CpiResult(NamedTuple):
    """Per-pulse, per-lane outputs ([P, R] unless noted)."""

    power: torch.Tensor
    doppler: torch.Tensor
    delay: torch.Tensor
    received: torch.Tensor  # int32
    agg: LaneAggregate


class RefineExtras(NamedTuple):
    """Per-pulse float64 state of the precision replay ([P, ...] leading
    pulse axis), built on the host in f64 (``sim.prepare_cpi``).  The JAX
    package's ``RefineExtras`` holds f32 residuals beside the f32 values
    for its double-single arithmetic; these are the f64 values."""

    rot: torch.Tensor  # [P, NT, 3, 3]
    pos: torch.Tensor  # [P, NT, 3]
    vel: torch.Tensor  # [P, NT, 3]
    tx_origin: torch.Tensor  # [P, 3]
    rx_centre: torch.Tensor  # [P, NR, 3]
    rx_radius: torch.Tensor  # [P, NR]
    fan_rot: torch.Tensor  # [P, 3, 3] composed fan rotation r1 @ rz (engine/fan.py)
    bore: torch.Tensor  # [P, 3] boresight direction (the num_rays == 1 fan)


class PulseBatch(NamedTuple):
    """Per-pulse dynamic inputs (leading axis P)."""

    rot: torch.Tensor  # [P, NT, 3, 3] extra attitude rotations
    pos: torch.Tensor  # [P, NT, 3] target centres
    vel: torch.Tensor  # [P, NT, 3] target velocities
    rx_geom: RxGeomDevice  # leaves [P, NR, ...]
    rx_pos: torch.Tensor  # [P, NR, 3] receiver positions
    tx_origin: torch.Tensor  # [P, 3]
    tx_dir: torch.Tensor  # [P, 2] boresight (azimuth, elevation)
    times: torch.Tensor  # [P] pulse start times
    refine: RefineExtras | None = None  # when cfg.refine


class CpiSpec(NamedTuple):
    """Static closure parameters of a CPI trace (physics models, spans)."""

    tx_span: tuple
    rcs_models: tuple
    tx_gain: object
    rx_gains: tuple
    rx_rotation_fns: tuple
    carrier: float
    cspeed: float
    num_rx: int


def make_pulse_fn(base: SceneBase, cfg: TraceConfig, spec: CpiSpec, traverse=None, fan_slice=None):
    """Build the single-pulse (trace -> postprocess, aggregate) pair.

    ``traverse`` swaps the phase-2 traversal function (default: the CUDA
    kernel on CUDA tensors, the plain version on CPU tensors).
    ``fan_slice=(n_blocks, index)`` traces only ray block ``index`` of the
    fan cut into ``n_blocks`` contiguous blocks of F = N^3 / n_blocks
    cells: ``one_pulse`` then returns ``slot_multiplier * F`` lanes, slot
    by slot (``slot * F + f``), and the replay is told which fan cells
    they are.  The blocks' lanes, put back in the whole fan's order by
    ``parallel.sharding.regather_lanes``, are what ``aggregate`` takes."""

    def one_pulse(rot, pos, vel, rx_geom: RxGeomDevice, rx_pos, tx_origin, tx_dir, time_t,
                  refine: RefineExtras | None = None):
        with trace_annotation("rts.animate"):
            if cfg.accel == "cluster":
                scene = animate_packed(base, rot, pos, vel)
            else:
                scene = animate_scene(base, rot, pos, vel)
            fan = generate_fan_c(cfg.num_rays, (tx_dir[0], tx_dir[1]), spec.tx_span,
                                 dtype=base.tri_verts.dtype, device=base.tri_verts.device)
            block, offset = cfg.rays_per_fan, 0
            if fan_slice is not None:
                n_blocks, index = fan_slice
                block = cfg.rays_per_fan // n_blocks
                offset = index * block
                fan = fan[:, offset:offset + block].contiguous()
        res = trace_fan(scene, rx_geom, tx_origin, fan, cfg, traverse=traverse)
        if cfg.refine:
            res = replay_refine(base, res, cfg, refine, tx_span=spec.tx_span, fan_block=block,
                                fan_offset=offset)

        def post(sub: TraceResult):
            with trace_annotation("rts.postprocess"):
                return postprocess(
                    sub, tx_origin=tx_origin, rx_positions=rx_pos, rcs_models=spec.rcs_models,
                    tx_gain=spec.tx_gain, rx_gains=spec.rx_gains, tx_rotation=(tx_dir[0], tx_dir[1]),
                    rx_rotation_fns=spec.rx_rotation_fns, time_t=time_t,
                    carrier=spec.carrier, cspeed=spec.cspeed,
                )

        total = res.received.shape[0]
        cap = min(cfg.agg_cap, total) if cfg.agg_cap else 0
        count = int((res.received >= 0).sum()) if cap and cap < total else total
        if count <= cap < total:
            # post-process only a block of the received lanes (postprocess
            # is per lane and changes only received lanes), then write the
            # first ``count`` slots back: identical per lane to the full pass
            idx = received_first_idx(res.received, cap)
            sub = TraceResult(*(take_lanes(a, idx) for a in res))
            sub = sub._replace(received=take_lanes(res.received, idx, fill=-1))
            pw_c, dp_c, _ = post(sub)
            power, doppler = res.power.clone(), res.doppler.clone()
            power[idx[:count]] = pw_c[:count]
            doppler[idx[:count]] = dp_c[:count]
            delay = res.ray_length / spec.cspeed
        else:
            power, doppler, delay = post(res)
        return res, power, doppler, delay

    def aggregate(res: TraceResult, power, doppler, delay) -> CpiResult:
        with trace_annotation("rts.aggregate"):
            agg = aggregate_lanes(
                res.received, res.refl_depth, res.refr_depth, res.path, power,
                res.ray_length, doppler, num_rx=spec.num_rx, cspeed=spec.cspeed,
                carrier=spec.carrier, ray_length_lo=res.ray_length_lo if cfg.refine else None,
            )
        return CpiResult(power=power, doppler=doppler, delay=delay, received=res.received, agg=agg)

    return one_pulse, aggregate


def pulse_args(batch: PulseBatch, p: int) -> tuple:
    """Pulse ``p`` of the batch as the arguments of ``one_pulse``."""
    refine = None if batch.refine is None else RefineExtras(*(a[p] for a in batch.refine))
    return (batch.rot[p], batch.pos[p], batch.vel[p], RxGeomDevice(*(a[p] for a in batch.rx_geom)),
            batch.rx_pos[p], batch.tx_origin[p], batch.tx_dir[p], batch.times[p], refine)


def _stack(results):
    first = results[0]
    if isinstance(first, tuple):
        return type(first)(*(_stack([r[i] for r in results]) for i in range(len(first))))
    return torch.stack(results)


def map_pulses(full, batch: PulseBatch):
    """``full`` (one pulse's arguments -> its result) over every pulse of
    ``batch``, stacked on a leading pulse axis.

    A Python loop on both paths, where the JAX package vmaps the dense
    path and ``lax.map``s the clustered one: a pulse makes host decisions
    on its own data (how many lanes were received against the caps, how
    many ray tiles are still live for the narrow late segments), and the
    traversal kernel is a ``ctypes`` launch, so neither can be batched over
    pulses by ``torch.func.vmap``.  Each pulse fills the card on its own
    through the kernel's ray-tile grid.  Each pulse is an ``rts.pulse``
    span."""
    results = []
    for p in range(batch.times.shape[0]):
        with trace_annotation("rts.pulse"):
            results.append(full(*pulse_args(batch, p)))
    return _stack(results)


def trace_cpi(base: SceneBase, batch: PulseBatch, cfg: TraceConfig, spec: CpiSpec) -> CpiResult:
    """Trace a whole CPI, pulse by pulse, on the tensors' device (the
    ``rts.cpi`` span)."""
    with trace_annotation("rts.cpi"):
        one_pulse, aggregate = make_pulse_fn(base, cfg, spec)
        return map_pulses(lambda *args: aggregate(*one_pulse(*args)), batch)
