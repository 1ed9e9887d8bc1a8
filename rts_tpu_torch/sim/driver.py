"""Simulation driver — the ``rs::RTS`` equivalent (ray_tracer.cpp:509-1363),
counterpart of ``rts_tpu.sim.driver``.

For each transmitter, for each pulse: rebuild the moving scene on the
host, trace the ray fan on the device, post-process (RCS, antenna gains,
relativistic Doppler), combine multipath returns coherently, and attach
one ``Response`` per unique propagation path to its receiver
(ray_tracer.cpp:1290-1321).

Reference quirks preserved, as in the JAX driver:
  * Receiver noise temperature is *accumulated* per transmitter loop:
    ``SetNoiseTemperature(wave.GetTemp() + GetNoiseTemperature())``
    (ray_tracer.cpp:829).
  * A rotating target's time-varying attitude is applied ON TOP of its
    t=0 attitude (composite R(t)·R(0)), and only when ``t > start_time``
    (ray_tracer.cpp:993-1007).
  * ``InterpPoint`` takes the path-group AGGREGATED power, Doppler, delay
    and phase (aggregation.cu:89-93, 169; ray_tracer.cpp:1310-1316).
  * Target velocity is finite-differenced over one CW sample
    (ray_tracer.cpp:941-948).
"""

from __future__ import annotations

import dataclasses
import time as _time
from typing import List

import numpy as np
import torch

from rts_tpu_torch.accel.cluster import cluster_reorder
from rts_tpu_torch.aggregate import aggregate_lanes
from rts_tpu_torch.config import Parameters
from rts_tpu_torch.core.rotation import vertex_rotation
from rts_tpu_torch.engine.types import RxGeomDevice, TraceConfig, scene_to_device
from rts_tpu_torch.engine.wavefront import trace_pulse
from rts_tpu_torch.geometry.mesh import Mesh
from rts_tpu_torch.geometry.scene import compile_scene
from rts_tpu_torch.physics.postprocess import postprocess
from rts_tpu_torch.physics.receiver_geom import rx_sphere_geometry
from rts_tpu_torch.sim.response import InterpPoint, Response
from rts_tpu_torch.sim.waveform import TransmitterPulse
from rts_tpu_torch.sim.world import World


@dataclasses.dataclass
class PulseStats:
    transmitter: str
    pulse: int
    time: float
    received_rays: int
    responses: int
    trace_seconds: float


@dataclasses.dataclass
class RunSummary:
    pulses: List[PulseStats] = dataclasses.field(default_factory=list)

    @property
    def total_responses(self) -> int:
        return sum(p.responses for p in self.pulses)

    @property
    def total_received(self) -> int:
        return sum(p.received_rays for p in self.pulses)


def _target_mesh_at(target, time_t: float, start_time: float, *, strict_parity: bool) -> Mesh:
    """Target mesh in world frame at pulse time (ray_tracer.cpp:956-1014
    minus the final translation, which the caller applies)."""
    mesh = target.base_mesh(strict_parity=strict_parity)
    if target.attitude.is_rotating and time_t > start_time:
        yaw, pitch, roll = target.attitude.ypr(time_t)
        verts = vertex_rotation(mesh.verts, yaw, pitch, roll, strict_parity=False)
        normals = vertex_rotation(mesh.normals, yaw, pitch, roll, strict_parity=False)
        mesh = Mesh(verts, mesh.tris, normals)
    return mesh


def run(
    world: World,
    params: Parameters,
    *,
    dtype=torch.float64,
    device="cuda",
    strict_parity: bool = False,
    tri_chunk: int = 512,
    pad_tris_to: int = 1,
    accel: str = "brute",
    cluster_size: int = 256,
    verbose: bool = False,
    **trace_options,
) -> RunSummary:
    """Run the full simulation, mutating receiver response lists.

    The analogue of ``rs::RTS(world, MaxThreads, MaxBlocks)``, with the
    JAX driver's options: float64 brute force by default, or the
    clustered traversal (``accel="cluster"``, float32).  Every pulse is
    traced on ``device``, the card unless the caller asks for another.
    Extra keyword options pass through to :class:`TraceConfig` (e.g.
    ``ray_tile``, ``compact_narrow``).
    """
    cfg = TraceConfig.from_parameters(
        params, strict_parity=strict_parity, tri_chunk=tri_chunk,
        accel=accel, cluster_size=cluster_size, **trace_options,
    )
    if accel == "cluster" and dtype != torch.float32:
        raise ValueError("accel='cluster' traces in float32, the traversal kernel's type")
    cspeed = params.c
    num_rx = len(world.receivers)
    summary = RunSummary()
    t = lambda a: torch.as_tensor(np.array(a, np.float64), dtype=dtype, device=device)
    host = lambda a: a.cpu().numpy()

    for trans in world.transmitters:
        signal = TransmitterPulse()
        trans.GetPulse(signal, 0)
        wave = signal.wave
        carrier = wave.GetCarrier()
        tx_span = tuple(float(x) for x in trans.GetTxSpan())

        # Accumulating noise-temperature quirk (ray_tracer.cpp:829).
        for rx in world.receivers:
            rx.SetNoiseTemperature(wave.GetTemp() + rx.GetNoiseTemperature())

        for k in range(trans.GetPulseCount()):
            trans.GetPulse(signal, k)
            time_t = float(signal.time)
            tx_origin = np.asarray(trans.GetPosition(time_t), dtype=np.float64).reshape(3)
            tx_az, tx_el = (float(a) for a in trans.GetRotation(time_t))

            # Receiver spheres + acceptance windows (ray_tracer.cpp:894-925).
            rx_pos = np.array(
                [np.asarray(rx.GetPosition(time_t), np.float64).reshape(3) for rx in world.receivers]
            ).reshape(num_rx, 3)
            rx_rot = [tuple(float(a) for a in rx.GetRotation(time_t)) for rx in world.receivers]
            spheres = np.array([rx.GetRxSphere() for rx in world.receivers], np.float64).reshape(num_rx, 3)
            rx_geom = rx_sphere_geometry(
                rx_pos, np.array([r[0] for r in rx_rot]), np.array([r[1] for r in rx_rot]),
                spheres[:, 0], spheres[:, 1], spheres[:, 2], strict_parity=True,
            )

            # Per-pulse scene rebuild (ray_tracer.cpp:936-1146).
            meshes, velocities = [], []
            for targ in world.targets:
                pos = np.asarray(targ.GetPosition(time_t), np.float64).reshape(3)
                pos_end = np.asarray(targ.GetPosition(time_t + params.sample_time), np.float64).reshape(3)
                velocities.append((pos_end - pos) / params.sample_time)
                mesh = _target_mesh_at(targ, time_t, params.start_time, strict_parity=strict_parity)
                meshes.append(mesh.translated(pos))
            scene = compile_scene(
                meshes,
                [t_.GetReflCoeff() for t_ in world.targets],
                [t_.GetRefrIndex() for t_ in world.targets],
                velocities,
                pad_to=pad_tris_to,
            )
            if accel == "cluster":
                scene = cluster_reorder(scene, cluster_size=cluster_size)

            t0 = _time.perf_counter()
            res = trace_pulse(
                scene_to_device(scene, dtype=dtype, device=device),
                RxGeomDevice.from_host(rx_geom, dtype=dtype, device=device),
                t(tx_origin), (tx_az, tx_el), tx_span, cfg,
            )
            power, doppler, _delay = postprocess(
                res,
                tx_origin=t(tx_origin),
                rx_positions=t(rx_pos),
                rcs_models=[t_.rcs_model for t_ in world.targets],
                tx_gain=trans.antenna,
                rx_gains=[rx.antenna for rx in world.receivers],
                tx_rotation=(tx_az, tx_el),
                rx_rotation_fns=[rx.rotation.azel for rx in world.receivers],
                time_t=time_t,
                carrier=carrier,
                cspeed=cspeed,
            )
            lane = aggregate_lanes(
                res.received, res.refl_depth, res.refr_depth, res.path, power, res.ray_length,
                doppler, num_rx=num_rx, cspeed=cspeed, carrier=carrier,
            )
            emit_idx = np.flatnonzero(host(lane.emit))
            trace_s = _time.perf_counter() - t0

            # Hand-off: one Response per unique path (ray_tracer.cpp:1290-1321).
            h_received = host(res.received)
            h_power, h_doppler, h_delay = host(lane.power), host(lane.doppler), host(lane.delay)
            h_phase = host(lane.phase).astype(np.float64) + host(lane.phase_lo).astype(np.float64)
            for i in emit_idx:
                rx = world.receivers[int(h_received[i])]
                response = Response(wave, trans)
                response.AddInterpPoint(InterpPoint(
                    power=float(h_power[i]),
                    time=time_t + float(h_delay[i]),
                    delay=float(h_delay[i]),
                    doppler=float(h_doppler[i]),
                    phase=float(h_phase[i]),
                    noise_temperature=rx.GetNoiseTemperature(),
                ))
                rx.AddResponse(response)

            received_rays = int((h_received >= 0).sum())
            if verbose:
                print(
                    f"[{trans.name} pulse {k}] rays received: {received_rays}, "
                    f"responses: {len(emit_idx)}, trace {trace_s:.3f}s"
                )
            summary.pulses.append(PulseStats(
                transmitter=trans.name, pulse=k, time=time_t, received_rays=received_rays,
                responses=len(emit_idx), trace_seconds=trace_s,
            ))

    return summary
