"""Post-processing of traced rays (counterpart of ``rts_tpu.physics.postprocess``).

Equivalent of the per-received-ray host loop at ray_tracer.cpp:1184-1258:
per-bounce RCS multiplication, antenna gains at transmit/arrival times,
the lambda^2*Gt*Gr factor, and the relativistic Doppler conversion.

Quirk preserved: for direct Tx->Rx rays the reference evaluates the Tx
gain along (Tx - Rx) and the Rx gain along (Rx - Tx) (ray_tracer.cpp:
1205-1206); indirect rays use (firstHit - Tx) departure and
(lastHit - Rx) arrival vectors (:1209-1210).
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from rts_tpu_torch.engine.wavefront import TraceResult


def _azel(v):
    az = torch.atan2(v[1], v[0])
    el = torch.atan2(v[2], torch.sqrt(v[0] ** 2 + v[1] ** 2))
    return az, el


def postprocess(
    res: TraceResult,
    *,
    tx_origin,  # [3]
    rx_positions,  # [NR, 3]
    rcs_models: Sequence,  # per-target .rcs(az_sum, el_sum, wl)
    tx_gain,  # .gain(az, el, bore_az, bore_el, wl)
    rx_gains: Sequence,
    tx_rotation,  # (az, el) boresight at pulse time
    rx_rotation_fns: Sequence[Callable],  # t -> (az, el) on tensors
    time_t,
    carrier,
    cspeed,
):
    """Returns (power, doppler, delay) lane tensors ready for aggregation."""
    valid = res.received >= 0
    num_rx = rx_positions.shape[0]
    if num_rx:
        rxi = res.received.clamp(0, num_rx - 1).long()
        repos = rx_positions.to(res.power.dtype)[rxi].T  # [3, R]
    else:
        repos = torch.zeros_like(res.first_hit)

    wavelength = cspeed / carrier
    direct = (res.refl_depth == 0) & (res.refr_depth == 0)
    tx_origin = tx_origin[:, None]

    transvec = torch.where(direct, tx_origin - repos, res.first_hit - tx_origin)
    recvvec = torch.where(direct, repos - tx_origin, res.prev_hit - repos)
    t_az, t_el = _azel(transvec)
    r_az, r_el = _azel(recvvec)

    delay = res.ray_length / cspeed
    power = res.power

    # per-bounce RCS (ray_tracer.cpp:1219-1230); rcs is [2, D, R]
    for t_idx, model in enumerate(rcs_models):
        vals = model.rcs(res.rcs[0], res.rcs[1], wavelength)  # [D, R]
        factor = torch.where(res.path == t_idx, vals, 1.0)
        power = power * torch.prod(factor, dim=0)

    # antenna gains (ray_tracer.cpp:1232-1247)
    gt = tx_gain.gain(t_az, t_el, tx_rotation[0], tx_rotation[1], wavelength)
    gr = torch.ones_like(power)
    for j, g in enumerate(rx_gains):
        b_az, b_el = rx_rotation_fns[j](delay + time_t)
        gj = g.gain(r_az, r_el, b_az, b_el, wavelength)
        gr = torch.where(res.received == j, gj, gr)

    power = torch.where(valid, power * (wavelength**2 * gt * gr), res.power)

    # relativistic Doppler (ray_tracer.cpp:1251-1253), in the f32-safe
    # form 2x/(1-x) of (1+x)/(1-x) - 1
    x = (res.doppler / 2.0) / cspeed
    doppler = torch.where(valid, carrier * (2.0 * x / (1.0 - x)), res.doppler)
    return power, doppler, delay
