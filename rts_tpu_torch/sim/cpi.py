"""CPI front end: World -> device tensors -> run (counterpart of
``rts_tpu.sim.cpi``).

Builds the static ``SceneBase`` once and a ``PulseBatch`` of per-pulse
transforms and receiver geometry (host NumPy, as in the JAX package),
puts every tensor on the given device, and traces the CPI pulse by pulse
(``engine.cpi.trace_cpi``).  ``sim.driver.run`` is the reference-shaped
sequential driver beside it.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from rts_tpu_torch.accel.cluster import cluster_reorder
from rts_tpu_torch.config import Parameters
from rts_tpu_torch.engine.animate import attitude_rotations, scene_base, target_motion
from rts_tpu_torch.core.rotation import rot_axis_reversed, rot_z
from rts_tpu_torch.engine.cpi import CpiResult, CpiSpec, PulseBatch, RefineExtras, trace_cpi
from rts_tpu_torch.engine.types import RxGeomDevice, TraceConfig
from rts_tpu_torch.geometry.scene import compile_scene
from rts_tpu_torch.physics.receiver_geom import rx_sphere_geometry, rx_sphere_geometry_device
from rts_tpu_torch.sim.response import InterpPoint, Response
from rts_tpu_torch.sim.waveform import TransmitterPulse
from rts_tpu_torch.sim.world import World

# Named option bundles, value for value those of rts_tpu.sim.cpi.PRESETS.
# "production" is the JAX package's measured-best TPU configuration, with
# the precision replay on (refine=True: here in native float64); "parity"
# the dense engine with the reference's float32 narrowing points.
PRESETS = {
    "production": dict(
        accel="cluster",
        cluster_size=128,
        ray_tile=512,
        candidates=48,
        sub_tiles=8,
        mt_group=8,
        p1_fanout=8,
        p1_super_k=10,
        mt_tail=True,
        refine=True,
        replay_cap=256,
        compact_narrow=-1,
    ),
    "parity": dict(strict_parity=True),
}

_PREPARE_DEFAULTS = dict(
    strict_parity=False,
    tri_chunk=512,
    pad_tris_to=1,
    accel="brute",
    cluster_size=256,
    ray_tile=256,
    candidates=64,
    sub_tiles=4,
    mt_group=2,
    mt_union=True,
    mt_tail=False,
    mt_prune=False,
    cand_order="near",
    resident_cap=0,
    shade_emit=False,
    p1_fanout=None,
    p1_super_k=None,
    p1_fanout0=None,
    p1_super_k0=None,
    compact_narrow=0,
    agg_cap=4096,
    fan_order="raster",
    interpret=False,
    refine=False,
    replay_cap=0,
    rx_geom_on_device=False,
    rcs_angles=None,
)


def prepare_cpi(
    world: World,
    params: Parameters,
    *,
    tx_index: int = 0,
    dtype=torch.float32,
    device="cuda",
    preset: str | None = None,
    **options,
):
    """Compile (base scene, pulse batch, cfg, spec) for one transmitter's CPI.

    Same options, presets and defaults as ``rts_tpu.sim.prepare_cpi``;
    explicit keyword options override the preset.  With none, the scene
    is traced by brute force (``accel="brute"``) in ``dtype``; with
    ``dtype=torch.float64`` that is the port's f64 engine, and
    ``preset="parity"`` adds the reference's float32 narrowing points.
    ``accel="cluster"`` (the production preset) needs float32, the
    traversal kernel's type.  ``device`` is where every tensor is
    created: the card unless the caller asks for another (there is no
    fallback; the CPU runs the traversal's plain version).
    ``rx_geom_on_device=True`` evaluates the [P, NR] receiver geometry on
    ``device`` in ``dtype`` (``rx_sphere_geometry_device``) instead of in
    host NumPy; it refuses ``refine=True``, as ``rts_tpu`` does.

    ``refine=True`` (the production preset) also builds the float64 state
    of the precision replay: f64 copies of the base corners, normals and
    reflection coefficients (``SceneBase.*_f64``) and the per-pulse
    ``RefineExtras`` (rotations, centres, velocities, Tx origin, receiver
    centres and radii, fan rotation and boresight), all f64 tensors."""
    opts = dict(_PREPARE_DEFAULTS)
    if preset is not None:
        if preset not in PRESETS:
            raise ValueError(f"unknown preset {preset!r}; available: {sorted(PRESETS)}")
        opts.update(PRESETS[preset])
    unknown = set(options) - set(opts)
    if unknown:
        raise TypeError(f"prepare_cpi() got unexpected options {sorted(unknown)}")
    opts.update(options)
    if opts["rx_geom_on_device"] and opts["refine"]:
        raise ValueError(
            "rx_geom_on_device=True is incompatible with refine=True: the replay "
            "takes the f64 host receiver centres"
        )
    accel = opts["accel"]
    if accel == "cluster" and dtype != torch.float32:
        raise ValueError("accel='cluster' traces in float32, the traversal kernel's type")
    if opts["refine"] and dtype != torch.float32:
        raise ValueError("refine=True refines the float32 engine")
    needs_angles = any(not getattr(t.rcs_model, "aspect_free", False) for t in world.targets)
    rcs_angles = opts["rcs_angles"]
    if rcs_angles is None:
        rcs_angles = needs_angles
    elif not rcs_angles and needs_angles:
        raise ValueError(
            "rcs_angles=False but some target's rcs_model is aspect-dependent; "
            "its RCS would be evaluated on sentinel angles"
        )
    cluster_size = opts["cluster_size"]

    trans = world.transmitters[tx_index]
    signal = TransmitterPulse()
    trans.GetPulse(signal, 0)
    carrier = signal.wave.GetCarrier()
    num_rx = len(world.receivers)
    pulse_count = trans.GetPulseCount()
    times = np.array([trans.pulse_time(k) for k in range(pulse_count)], np.float64)

    # static scene (t=0 attitude, origin-centred), Morton-clustered for
    # the clustered engine
    meshes = [t.base_mesh(strict_parity=opts["strict_parity"]) for t in world.targets]
    scene = compile_scene(
        meshes,
        [t.GetReflCoeff() for t in world.targets],
        [t.GetRefrIndex() for t in world.targets],
        pad_to=opts["pad_tris_to"],
    )
    if accel == "cluster":
        scene = cluster_reorder(scene, cluster_size=cluster_size)
    base = scene_base(scene, cluster_size if accel == "cluster" else 0, dtype=dtype, device=device,
                      with_f64=opts["refine"])

    # per-pulse transforms and tx/rx geometry, vectorised over pulses
    rot = attitude_rotations(world.targets, times, params.start_time)
    pos, vel = target_motion(world.targets, times, params.sample_time)
    txo = np.asarray(trans.GetPosition(times), np.float64).reshape(pulse_count, 3)
    tx_az, tx_el = trans.GetRotation(times)
    txd = np.stack([np.broadcast_to(tx_az, times.shape), np.broadcast_to(tx_el, times.shape)], axis=-1)
    if num_rx:
        spheres = np.array([rx.GetRxSphere() for rx in world.receivers], np.float64).reshape(num_rx, 3)
        rx_pos = np.stack(
            [np.asarray(rx.GetPosition(times), np.float64).reshape(pulse_count, 3) for rx in world.receivers],
            axis=1,
        )  # [P, NR, 3]
        rx_az = np.stack([np.broadcast_to(rx.GetRotation(times)[0], times.shape) for rx in world.receivers], axis=1)
        rx_el = np.stack([np.broadcast_to(rx.GetRotation(times)[1], times.shape) for rx in world.receivers], axis=1)
        if opts["rx_geom_on_device"]:
            # one batched [P, NR] evaluation on the device
            span = lambda k: np.tile(spheres[:, k], (pulse_count, 1))
            g = rx_sphere_geometry_device(rx_pos, rx_az, rx_el, span(0), span(1), span(2),
                                          dtype=dtype, device=device)
        else:
            g = rx_sphere_geometry(
                rx_pos.reshape(-1, 3), rx_az.reshape(-1), rx_el.reshape(-1),
                np.tile(spheres[:, 0], pulse_count), np.tile(spheres[:, 1], pulse_count),
                np.tile(spheres[:, 2], pulse_count), strict_parity=True,
            )
        geo = [g.centre.reshape(pulse_count, num_rx, 3)] + [
            getattr(g, f).reshape(pulse_count, num_rx)
            for f in ("radius", "min_theta", "max_theta", "min_phi", "max_phi")
        ]
    else:
        rx_pos = np.zeros((pulse_count, 0, 3))
        geo = [np.zeros((pulse_count, 0, 3))] + [np.zeros((pulse_count, 0))] * 5

    t = lambda a: (a if torch.is_tensor(a) else
                   torch.as_tensor(np.array(a, np.float64), dtype=dtype, device=device))
    extras = None
    if opts["refine"]:
        # per-pulse fan rotation r1 @ rz in f64 (engine/fan.py), vectorised
        # over the pulse axis, and the boresight of a one-ray fan
        az, el = txd[:, 0].astype(np.float64), txd[:, 1].astype(np.float64)
        rz = rot_z(az, xp=np)  # [P, 3, 3]
        orth = rz[:, :, 1] / np.linalg.norm(rz[:, :, 1], axis=-1, keepdims=True)
        fan_rot = rot_axis_reversed(orth, el, xp=np) @ rz
        bore = np.stack([np.cos(el) * np.cos(az), np.cos(el) * np.sin(az), np.sin(el)], axis=-1)
        t64 = lambda a: torch.as_tensor(np.array(a, np.float64), device=device)
        extras = RefineExtras(rot=t64(rot), pos=t64(pos), vel=t64(vel), tx_origin=t64(txo),
                              rx_centre=t64(geo[0]), rx_radius=t64(geo[1]),
                              fan_rot=t64(fan_rot), bore=t64(bore))
    batch = PulseBatch(
        rot=t(rot), pos=t(pos), vel=t(vel),
        rx_geom=RxGeomDevice(*(t(a) for a in geo)),
        rx_pos=t(rx_pos), tx_origin=t(txo), tx_dir=t(txd), times=t(times), refine=extras,
    )
    cfg = TraceConfig.from_parameters(
        params,
        **{k: opts[k] for k in (
            "strict_parity", "tri_chunk", "accel", "cluster_size", "ray_tile", "candidates",
            "sub_tiles", "mt_group", "mt_union", "mt_tail", "mt_prune", "cand_order",
            "resident_cap", "shade_emit", "p1_fanout", "p1_super_k", "p1_fanout0",
            "p1_super_k0", "compact_narrow", "agg_cap", "fan_order", "interpret", "refine",
            "replay_cap",
        )},
        rcs_angles=rcs_angles,
    )
    spec = CpiSpec(
        tx_span=tuple(float(x) for x in trans.GetTxSpan()),
        rcs_models=tuple(t_.rcs_model for t_ in world.targets),
        tx_gain=trans.antenna,
        rx_gains=tuple(rx.antenna for rx in world.receivers),
        rx_rotation_fns=tuple(rx.rotation.azel for rx in world.receivers),
        carrier=float(carrier),
        cspeed=float(params.c),
        num_rx=num_rx,
    )
    return base, batch, cfg, spec


def check_replay_overflow(out: CpiResult, cfg: TraceConfig, *, warn: bool = True):
    """Per-pulse received-lane counts ([P] int array); warns when a pulse
    received more lanes than ``cfg.replay_cap`` under ``cfg.refine``: its
    replay block grew past the cap to refine them, so the cap does not
    bound the replay's work and memory on this scene.  ``run_cpi`` calls
    it on every trace."""
    counts = (out.received >= 0).sum(dim=1).cpu().numpy()
    if cfg.refine and cfg.replay_cap and counts.size:
        worst = int(counts.max())
        if worst > cfg.replay_cap and warn:
            over = int((counts > cfg.replay_cap).sum())
            warnings.warn(
                f"replay cap overflow: {over} pulse(s) received more lanes than "
                f"replay_cap={cfg.replay_cap} (worst {worst}); the replay block grew to hold them",
                UserWarning, stacklevel=2,
            )
    return counts


def run_all_cpi(world: World, params: Parameters, **kw) -> list:
    """Trace every transmitter's CPI (the outer loop of rs::RTS,
    ray_tracer.cpp:806); one CpiResult per transmitter.  ``kw`` goes to
    :func:`run_cpi`."""
    return [run_cpi(world, params, tx_index=i, **kw) for i in range(len(world.transmitters))]


def run_cpi(
    world: World,
    params: Parameters,
    *,
    tx_index: int = 0,
    dtype=torch.float32,
    device="cuda",
    preset: str | None = None,
    attach_responses: bool = True,
    **options,
) -> CpiResult:
    """Trace one transmitter's whole CPI, then (optionally) attach a
    Response per emitted path to its receiver, as the JAX ``run_cpi``."""
    base, batch, cfg, spec = prepare_cpi(
        world, params, tx_index=tx_index, dtype=dtype, device=device, preset=preset, **options
    )
    out = trace_cpi(base, batch, cfg, spec)
    check_replay_overflow(out, cfg)
    if attach_responses:
        trans = world.transmitters[tx_index]
        signal = TransmitterPulse()
        trans.GetPulse(signal, 0)
        wave = signal.wave
        for rx in world.receivers:
            rx.SetNoiseTemperature(wave.GetTemp() + rx.GetNoiseTemperature())
        host = lambda a: a.cpu().numpy()
        emit, received = host(out.agg.emit), host(out.received)
        power, doppler, delay = host(out.agg.power), host(out.agg.doppler), host(out.agg.delay)
        phase = host(out.agg.phase).astype(np.float64) + host(out.agg.phase_lo).astype(np.float64)
        times = host(batch.times)
        for p in range(emit.shape[0]):
            for i in np.flatnonzero(emit[p]):
                rx = world.receivers[int(received[p, i])]
                response = Response(wave, trans)
                response.AddInterpPoint(InterpPoint(
                    power=float(power[p, i]),
                    time=float(times[p]) + float(delay[p, i]),
                    delay=float(delay[p, i]),
                    doppler=float(doppler[p, i]),
                    phase=float(phase[p, i]),
                    noise_temperature=rx.GetNoiseTemperature(),
                ))
                rx.AddResponse(response)
    return out
