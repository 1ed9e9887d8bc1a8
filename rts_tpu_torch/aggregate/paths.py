"""Multipath coherent combining (counterpart of ``rts_tpu.aggregate.paths``).

Received rays are grouped by (receiver, target-path row) and their
voltages, delays, phases and Dopplers combined per group
(aggregation.cu:32-97).  The grouping is one stable sort of the received
lanes by (receiver, path row) — the JAX package's sort fallback — and
the group sums are pairwise tree sums over each sorted segment, in an
order fixed by the sort: no float atomics, so a run repeats bit for bit.

Semantics follow the JAX package exactly, including the reference's
asymmetric "direct transmission" rule (aggregation.cu:56): a ray with no
bounce matches every received ray at its receiver, so direct rays read
the receiver-level aggregates instead of their path group's.  ``emit``
marks each group's representative lane, its lowest lane id
(ray_tracer.cpp:1290-1321).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


class LaneAggregate(NamedTuple):
    npath: torch.Tensor  # [R] number of coherently-combined rays
    power: torch.Tensor  # [R] (mean voltage)^2  (aggregation.cu:89)
    delay: torch.Tensor  # [R] mean delay
    phase: torch.Tensor  # [R] mean phase
    doppler: torch.Tensor  # [R] mean Doppler
    path_match: torch.Tensor  # [R] min matching lane (R+1 for invalid lanes)
    emit: torch.Tensor  # [R] bool — this lane produces a Response
    # f32 residual of ``phase`` (phase + phase_lo is the f64 mean phase)
    # when the ray lengths were refined by the replay; zeros otherwise, as
    # in the JAX package
    phase_lo: torch.Tensor


def _segment_sums(vals, start):
    """Sums of the rows of ``vals`` [n, M] over runs that begin where
    ``start`` [n] is True (start[0] must be True), broadcast back to every
    row of the run.  Pairwise tree order within each run: deterministic."""
    n = vals.shape[0]
    idx = torch.arange(n, device=vals.device)
    first = torch.where(start, idx, 0).cummax(0).values  # run start of each row
    pos = idx - first
    run_id = torch.cumsum(start.to(torch.int64), 0) - 1
    run_len = torch.bincount(run_id, minlength=int(run_id[-1]) + 1)
    end = first + run_len[run_id]
    acc = vals
    step = 1
    while step < n:
        src = idx + step
        ok = ((pos % (2 * step)) == 0) & (src < end)
        acc = torch.where(ok[:, None], acc + acc[src.clamp(max=n - 1)], acc)
        step *= 2
    return acc[first]


def aggregate_lanes(
    received,  # [R] int32, -1 = not received
    refl_depth,  # [R] int32
    refr_depth,  # [R] int32
    path,  # [D, R] int32
    power,  # [R] post-processed power
    ray_length,  # [R]
    doppler,  # [R] post-processed Doppler frequency
    num_rx: int,
    cspeed,
    carrier,
    ray_length_lo=None,  # [R] f32 residual of ray_length from the replay
) -> LaneAggregate:
    """Group, combine and pick representatives over the received lanes.

    Only received lanes take part in a group (every other lane has zero
    weight in the reference), so the work runs on exactly those lanes —
    their count is read back from the device — which covers both the
    capped and the full-width branch of the JAX function.  Lanes that
    were not received keep their own power, delay and Doppler, phase 0,
    npath 0 and path_match R+1.

    The phase is reduced and averaged in float64 from the ray length
    (``ray_length + ray_length_lo`` when the replay refined it); it is
    returned as the JAX package returns it: f32 ``phase`` plus, for
    refined lengths, the f32 residual ``phase_lo``.
    """
    r = received.shape[0]
    dev = received.device
    fdtype = power.dtype
    delay = ray_length / cspeed
    valid = received >= 0
    lanes = torch.nonzero(valid).reshape(-1)  # ascending lane ids
    npath = torch.zeros(r, dtype=fdtype, device=dev)
    phase = torch.zeros(r, dtype=fdtype, device=dev)
    phase_lo = torch.zeros(r, dtype=fdtype, device=dev)
    out_power = power.clone()
    out_delay = delay.clone()
    out_dopp = doppler.clone()
    match = torch.full((r,), r + 1, dtype=torch.int64, device=dev)
    if lanes.numel():
        rx = received[lanes].long()
        pth = path[:, lanes].long()
        # phase of the received path, reduced in float64 (aggregation.cu:59-60
        # computes it in double): -(2*pi*f/c * L mod 2*pi)
        k = 2.0 * math.pi * float(carrier) / float(cspeed)
        length = ray_length[lanes].double()
        if ray_length_lo is not None:
            length = length + ray_length_lo[lanes].double()
        ph = -torch.remainder(length * k, 2.0 * math.pi)
        vals = torch.stack(
            [torch.ones_like(ph), torch.sqrt(power[lanes]).double(), delay[lanes].double(), ph,
             doppler[lanes].double()], dim=1
        )

        def grouped(keys):
            """Per-lane group sums and group min lane under a stable
            lexicographic sort by ``keys`` (most significant first)."""
            perm = torch.arange(lanes.numel(), device=dev)
            for key in reversed(keys):  # LSD radix order of stable sorts
                perm = perm[torch.sort(key[perm], stable=True).indices]
            sk = torch.stack([key[perm] for key in keys])
            start = torch.ones(perm.numel(), dtype=torch.bool, device=dev)
            start[1:] = (sk[:, 1:] != sk[:, :-1]).any(0)
            sums = _segment_sums(vals[perm], start)
            first = torch.where(start, torch.arange(perm.numel(), device=dev), 0).cummax(0).values
            out_sums = torch.empty_like(sums)
            out_sums[perm] = sums
            out_min = torch.empty_like(perm)
            out_min[perm] = lanes[perm[first]]  # lanes ascend within a stable run
            return out_sums, out_min

        g_sums, g_min = grouped([rx] + [pth[k_] for k_ in range(pth.shape[0])])
        r_sums, r_min = grouped([rx])
        direct = ((refl_depth == 0) & (refr_depth == 0))[lanes]
        sums = torch.where(direct[:, None], r_sums, g_sums)
        match[lanes] = torch.where(direct, r_min, g_min)
        n = sums[:, 0]
        npath[lanes] = n.to(fdtype)
        out_power[lanes] = ((sums[:, 1] / n) ** 2).to(fdtype)
        out_delay[lanes] = (sums[:, 2] / n).to(fdtype)
        mean_ph = sums[:, 3] / n
        phase[lanes] = mean_ph.to(fdtype)
        if ray_length_lo is not None:
            phase_lo[lanes] = (mean_ph - phase[lanes].double()).to(fdtype)
        out_dopp[lanes] = (sums[:, 4] / n).to(fdtype)
    emit = valid & (match == torch.arange(r, device=dev))
    return LaneAggregate(
        npath=npath, power=out_power, delay=out_delay, phase=phase, doppler=out_dopp,
        path_match=match.to(torch.int32), emit=emit, phase_lo=phase_lo,
    )
