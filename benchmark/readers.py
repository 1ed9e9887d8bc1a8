"""Reductions shared by the per-layer metric readers in ``metrics/``.

A reader takes the traced run's record (``benchmark.run.Record``) and
returns one number, or None when the record holds nothing to read.  The
record's device events are ``(name, start_ns, end_ns)`` of what ran on
the card inside the profiled stretch (kernels, copies, sets); its host
operators are the profiler's ``aten::*`` events there.
"""

from __future__ import annotations

TRAVERSAL_KERNELS = ("cand_kernel", "sweep_kernel")


def union_ns(intervals) -> int:
    """Length of the union of ``(start, end)`` intervals (overlaps once)."""
    total, reach = 0, None
    for s, e in sorted(intervals):
        if reach is None or s > reach:
            total += e - s
            reach = e
        elif e > reach:
            total += e - reach
            reach = e
    return total


def busy_ns(record) -> int:
    """Nanoseconds of the stretch in which some device event ran."""
    lo, hi = record.stretch_ns
    return union_ns((max(s, lo), min(e, hi)) for _, s, e in record.device_events if min(e, hi) > max(s, lo))


def device_idle_pct(record):
    lo, hi = record.stretch_ns
    if not record.device_events or hi <= lo:
        return None
    return 100.0 * (1.0 - busy_ns(record) / (hi - lo))


def host_ops_per_pulse(record):
    if not record.pulses:
        return None
    return record.host_ops / record.pulses


def launches_per_pulse(record):
    if not record.pulses or not record.device_events:
        return None
    return len(record.device_events) / record.pulses


def kernel_roofline_pct(record):
    """Percent of the traversal kernel's device time (the union of its
    grids' events) that the captured calls' bound accounts for."""
    from benchmark.roofline import needed_work

    spans = [(s, e) for name, s, e in record.device_events if any(k in name for k in TRAVERSAL_KERNELS)]
    if not spans or not record.traversal_calls:
        return None
    bound = sum(needed_work(*call)["bound_s"] for call in record.traversal_calls)
    return 100.0 * bound / (union_ns(spans) * 1e-9)


def render_ms(record):
    if not record.render_s:
        return None
    return 1e3 * sum(record.render_s) / len(record.render_s)


def prepare_s(record):
    return record.prepare_s
