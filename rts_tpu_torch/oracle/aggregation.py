"""NumPy reference for multipath coherent aggregation (a copy of
``rts_tpu.oracle.aggregation``).

Mirrors the semantics of the two CUDA kernels in aggregation.cu:32-97 and
the unique-path response selection at ray_tracer.cpp:1290-1321, expressed
directly (O(N^2) over received rays) so the vectorised sort/segment
implementation in rts_tpu_torch.aggregate can be validated against it.

Inputs operate on the *filtered* received-ray list like the reference
(ray_tracer.cpp:1190-1257 builds h_rx_results from lanes with
received >= 0).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class AggregateResult:
    npath: np.ndarray  # [M]
    power: np.ndarray  # [M] (mean-voltage squared)
    delay: np.ndarray  # [M] mean
    phase: np.ndarray  # [M] mean
    doppler: np.ndarray  # [M] mean
    path_match: np.ndarray  # [M] min matching index
    unique_rays: np.ndarray  # sorted unique path_match values (response reps)


def aggregate(
    received: np.ndarray,  # [M] receiver index of each received ray
    refl_depth: np.ndarray,  # [M]
    refr_depth: np.ndarray,  # [M]
    path: np.ndarray,  # [M, D] target-id rows
    power: np.ndarray,  # [M] post-processed power
    ray_length: np.ndarray,  # [M]
    doppler: np.ndarray,  # [M] post-processed Doppler frequency
    cspeed: float,
    carrier: float,
) -> AggregateResult:
    m = received.shape[0]
    npath = np.zeros(m)
    p_sum = np.zeros(m)
    d_sum = np.zeros(m)
    ph_sum = np.zeros(m)
    do_sum = np.zeros(m)
    path_match = np.full(m, m + 1, dtype=np.int64)  # "rayTotal + 1" analogue

    delay_r = ray_length / cspeed
    phase_r = -np.mod(delay_r * 2 * np.pi * carrier, 2 * np.pi)

    for i in range(m):
        direct_i = refl_depth[i] == 0 and refr_depth[i] == 0
        for r in range(m):
            if received[i] != received[r]:
                continue
            if not (direct_i or np.array_equal(path[i], path[r])):
                continue
            npath[i] += 1
            p_sum[i] += np.sqrt(power[r])
            d_sum[i] += delay_r[r]
            ph_sum[i] += phase_r[r]
            do_sum[i] += doppler[r]
            if r < path_match[i]:
                path_match[i] = r

    out_power = power.copy()
    out_delay = d_sum.copy()
    out_phase = ph_sum.copy()
    out_doppler = doppler.copy()
    nz = npath > 0
    out_power[nz] = (p_sum[nz] / npath[nz]) ** 2
    out_delay[nz] = d_sum[nz] / npath[nz]
    out_phase[nz] = ph_sum[nz] / npath[nz]
    out_doppler[nz] = do_sum[nz] / npath[nz]

    unique_rays = np.unique(path_match[: m])
    return AggregateResult(
        npath=npath,
        power=out_power,
        delay=out_delay,
        phase=out_phase,
        doppler=out_doppler,
        path_match=path_match,
        unique_rays=unique_rays,
    )
