"""The comparison that decides ``correct``: the timed path's last CPI against
the plain reference, lane by lane, aggregate by aggregate, map by map.

Five numbers, each beside its limit (``LIMITS``; PERF.md gives the
readings each was set from):

* ``rx_differ``: lanes whose receiver differs (one side received them,
  the other did not, or another receiver did), or whose multipath group
  (npath, path_match, emit) differs.  The configuration states that the
  received lanes are identical: limit 0;
* ``rx_power_rel``: the widest relative gap of a received lane's power
  and of its aggregated power.  The configuration states 1e-6;
* ``phase_rad``: the widest gap of a received lane's aggregated phase
  (float64: the ``phase`` and ``phase_lo`` parts).  The configuration
  states 1e-6 rad;
* ``lanes_far``: lanes both sides treat alike at the receivers whose
  delay, power or Doppler is so far off (``DELAY_FAR``, ``POWER_FAR``,
  ``DOPPLER_FAR``) that the lane met another surface or made another
  number of bounces: float32 traversal decisions against float64 ones;
* ``map_rel``: the widest gap of the range-Doppler map over its peak.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

DELAY_FAR = 1e-4
POWER_FAR = 1e-2
DOPPLER_FAR = 1e-3  # Hz on received lanes, m/s (the raw sum) elsewhere

# limit of each number; PERF.md gives the readings each was set from
LIMITS = {
    "rx_differ": 0.0,
    "rx_power_rel": 1e-6,
    "phase_rad": 1e-6,
    "lanes_far": 256.0,
    "map_rel": 1e-3,
}


class Output(NamedTuple):
    """What is judged, [P, R] per field (map [P, Ns] or None)."""

    received: torch.Tensor
    power: torch.Tensor
    doppler: torch.Tensor
    delay: torch.Tensor
    npath: torch.Tensor
    agg_power: torch.Tensor
    phase: torch.Tensor  # float64 aggregated phase
    match: torch.Tensor
    emit: torch.Tensor
    map: torch.Tensor | None


def from_program(out, rmap) -> Output:
    """The program's CpiResult (and map) as an ``Output``."""
    a = out.agg
    return Output(out.received.long(), out.power, out.doppler, out.delay, a.npath, a.power,
                  a.phase.double() + a.phase_lo.double(), a.path_match.long(), a.emit, rmap)


def from_reference(ref) -> Output:
    """A reference CPI (``benchmark.reference.ReferenceCpi``) as an ``Output``,
    for a control that puts the reference in the program's place."""
    ln, a = ref.lanes, ref.agg
    return Output(ln.received, ln.power, ln.doppler, ln.delay, a.npath, a.power, a.phase, a.path_match,
                  a.emit, ref.map)


def _rel(x, ref):
    x, ref = x.double(), ref.double()
    return (x - ref).abs() / ref.abs().clamp(min=1e-300)


def compare(got: Output, ref) -> dict:
    """The numbers of ``got`` against the reference CPI ``ref``."""
    ln, a = ref.lanes, ref.agg
    dev = ln.received.device
    g = lambda x: x.to(dev)
    rx_same = g(got.received) == ln.received
    rx = rx_same & (ln.received >= 0)
    group_same = (g(got.npath).double() == a.npath) & (g(got.match) == a.path_match) & (g(got.emit) == a.emit)
    zero = torch.zeros((), dtype=torch.float64, device=dev)
    num = {"rx_differ": float((~rx_same | (rx & ~group_same)).sum())}
    p_rel = _rel(g(got.power), ln.power)
    agg_rel = _rel(g(got.agg_power), a.power)
    num["rx_power_rel"] = float(torch.where(rx, torch.maximum(p_rel, agg_rel), zero).max())
    gap = torch.remainder(g(got.phase).double() - a.phase + math.pi, 2 * math.pi) - math.pi
    num["phase_rad"] = float(torch.where(rx & group_same, gap.abs(), zero).max())
    d_rel = _rel(g(got.delay), ln.delay)
    dop = (g(got.doppler).double() - ln.doppler).abs()
    far = ~((d_rel <= DELAY_FAR) & (p_rel <= POWER_FAR) & (dop <= DOPPLER_FAR))  # NaN counts as far
    num["lanes_far"] = float((rx_same & ~rx & far).sum())
    if ref.map is not None:
        m = g(got.map).double() if got.map is not None else torch.zeros_like(ref.map)
        num["map_rel"] = float((m - ref.map).abs().max() / ref.map.abs().max().clamp(min=1e-300))
    return num


def verdict(numbers: dict) -> bool:
    """Every number finite and within its limit."""
    return all(math.isfinite(v) and v <= LIMITS[k] for k, v in numbers.items())
