"""The program's spans in a traced run, and what each layer of a pulse
took.

``rts_tpu_torch`` opens a span (``utils.timing.trace_annotation``) at each
layer boundary of a pulse: ``rts.cpi`` > ``rts.pulse`` > ``rts.animate``,
``rts.segment`` (> ``rts.phase1``, ``rts.traverse``), ``rts.replay``,
``rts.postprocess``, ``rts.aggregate``; on the split ``rts.gather.ray``
in the pulse and ``rts.gather.pulse`` after the pulses; ``rts.render``
around a map.  The profiler keeps each as a host event on the operators'
clock.

Attribution: a device event belongs to the innermost span open on the host
when its launch was issued (the runtime call that shares its correlation
id; failing that, the host operator it is linked to), a host operator to
the innermost span open at its start.  A span's self time is its duration
less what its child spans cover.

The readers take the traced run's ``benchmark.run.Record``: its spans,
each device event's launch time, the program's counters and, on rank 0 of
a split, each rank's device time under ``rts.gather.pulse``.  Each returns
None where the record holds no such span.
"""

from __future__ import annotations

import bisect

from benchmark.readers import union_ns

NO_SPAN = "(no span)"
UNLINKED = "(unlinked)"


def partition(spans) -> list:
    """The time the spans cover, cut into disjoint pieces (start, end, index
    of the innermost span there), in time order.  A span that outlasts its
    parent is cut at the parent's end."""
    order = sorted(range(len(spans)), key=lambda i: (spans[i][1], -spans[i][2]))
    pieces, stack = [], []  # stack entries: [index, end, where its own time resumes]

    def close(t):
        while stack and stack[-1][1] <= t:
            i, end, cursor = stack.pop()
            if end > cursor:
                pieces.append((cursor, end, i))
            if stack:
                stack[-1][2] = end

    for i in order:
        _, s, e = spans[i]
        close(s)
        if stack:
            parent = stack[-1]
            e = min(e, parent[1])
            if s > parent[2]:
                pieces.append((parent[2], s, parent[0]))
        stack.append([i, e, s])
    close(float("inf"))
    return sorted(pieces)


class _Lookup:
    """The innermost span open at a time."""

    def __init__(self, spans):
        self.spans = spans
        self.pieces = partition(spans)
        self.starts = [p[0] for p in self.pieces]

    def __call__(self, t):
        """The name of the innermost span open at ``t``, or NO_SPAN."""
        k = bisect.bisect_right(self.starts, t) - 1
        if k >= 0 and t < self.pieces[k][1]:
            return self.spans[self.pieces[k][2]][0]
        return NO_SPAN


def _spans(record):
    lo, hi = record.stretch_ns
    return [sp for sp in record.spans if lo <= sp[1] < hi]


def _gaps(record) -> list:
    """The device's idle intervals inside the stretch, in time order."""
    lo, hi = record.stretch_ns
    gaps, reach = [], lo
    for _, s, e in sorted(record.device_events, key=lambda ev: ev[1]):
        if s > reach:
            gaps.append((reach, s))
        reach = max(reach, e)
    if hi > reach:
        gaps.append((reach, hi))
    return gaps


def _overlap(intervals, gaps) -> int:
    """Nanoseconds of ``intervals`` (disjoint, sorted) that fall in ``gaps``."""
    total, k = 0, 0
    for s, e in intervals:
        while k < len(gaps) and gaps[k][1] <= s:
            k += 1
        j = k
        while j < len(gaps) and gaps[j][0] < e:
            total += max(0, min(e, gaps[j][1]) - max(s, gaps[j][0]))
            j += 1
    return total


def layers(record) -> dict | None:
    """For each span name, and NO_SPAN for the rest of the stretch, a
    pulse's: calls, host self ms, aten operators (all those the profiler
    saw, nested ones too, by where they start), device busy ms of the work
    launched there (the union of its events; UNLINKED for events with no
    launch found), and device idle ms inside its self intervals."""
    spans = _spans(record)
    if not spans or not record.pulses:
        return None
    lo, hi = record.stretch_ns
    where = _Lookup(spans)
    rows = {}

    def row(name):
        return rows.setdefault(name, dict(calls=0, host_self_ms=0.0, aten_ops=0, busy_ms=0.0, idle_ms=0.0))

    for name, _, _ in spans:
        row(name)["calls"] += 1
    own = {}
    for s, e, i in where.pieces:
        own.setdefault(spans[i][0], []).append((max(s, lo), min(e, hi)))
    covered = sorted(iv for ivs in own.values() for iv in ivs)
    outside, reach = [], lo
    for s, e in covered:
        if s > reach:
            outside.append((reach, s))
        reach = max(reach, e)
    if hi > reach:
        outside.append((reach, hi))
    own[NO_SPAN] = outside
    gaps = _gaps(record)
    for name, ivs in own.items():
        r = row(name)
        r["host_self_ms"] = sum(e - s for s, e in ivs) * 1e-6
        r["idle_ms"] = _overlap(sorted(ivs), gaps) * 1e-6
    for _, s, _ in record.host_events:
        row(where(s))["aten_ops"] += 1
    launched = {}
    for (_, s, e), t in zip(record.device_events, record.launches):
        launched.setdefault(UNLINKED if t is None else where(t), []).append((max(s, lo), min(e, hi)))
    for name, ivs in launched.items():
        row(name)["busy_ms"] = union_ns(iv for iv in ivs if iv[1] > iv[0]) * 1e-6
    p = record.pulses
    return {name: {k: v / p for k, v in r.items()} for name, r in sorted(rows.items())}


def named_gaps(record) -> list:
    """The ten longest idle gaps of the device inside the stretch, longest
    first, each named by the host operator that overlaps it most, prefixed
    with the innermost span open at that operator's start
    (``rts.phase1/aten::where``; the operator alone outside every span)."""
    where = _Lookup(_spans(record))
    gaps = sorted(_gaps(record), key=lambda g: g[0] - g[1])[:10]
    named = []
    for g0, g1 in gaps:
        best, label = 0, "host (no aten operator)"
        for name, s, e in record.host_events:
            ov = min(e, g1) - max(s, g0)
            if ov > best:
                span = where(s)
                best, label = ov, name if span == NO_SPAN else f"{span}/{name}"
        named.append([label, (g1 - g0) * 1e-9])
    return named


def _opener(record, name):
    """A function of a host time: the start of the ``name`` span open then,
    or None; None itself where the record holds no ``name`` span."""
    inside = sorted((s, e) for n, s, e in _spans(record) if n == name)
    if not inside:
        return None
    starts = [s for s, _ in inside]

    def opened(t):
        k = -1 if t is None else bisect.bisect_right(starts, t) - 1
        return inside[k][0] if k >= 0 and t < inside[k][1] else None

    return opened


def span_ms(record, *names, self_time: bool = False):
    """Host ms a pulse of the spans ``names``: their durations, or their
    self time; None where the record holds none of them."""
    spans = _spans(record)
    if not record.pulses or not any(sp[0] in names for sp in spans):
        return None
    if self_time:
        total = sum(e - s for s, e, i in partition(spans) if spans[i][0] in names)
    else:
        total = sum(e - s for n, s, e in spans if n in names)
    return total * 1e-6 / record.pulses


def launched_busy_ms(record, name):
    """Device ms (the union of the events) of the work launched inside a
    ``name`` span, over the whole stretch; None where there is no such span."""
    opened = _opener(record, name)
    if opened is None:
        return None
    lo, hi = record.stretch_ns
    ivs = [(max(s, lo), min(e, hi)) for (_, s, e), t in zip(record.device_events, record.launches)
           if opened(t) is not None]
    return union_ns(iv for iv in ivs if iv[1] > iv[0]) * 1e-6


def phase1_busy_ms(record):
    busy = launched_busy_ms(record, "rts.phase1")
    return None if busy is None or not record.pulses else busy / record.pulses


def shade_ms(record):
    return span_ms(record, "rts.segment", self_time=True)


def replay_ms(record):
    return span_ms(record, "rts.replay")


def post_ms(record):
    return span_ms(record, "rts.postprocess", "rts.aggregate")


def exchange_ms(record):
    """The least of the ranks' device ms under ``rts.gather.pulse``: the rank
    that arrives last waits for no one."""
    ms = [m for m in record.gather_ms if m is not None]
    return min(ms) if ms else None


def rank_skew_ms(record):
    """The most less the least of the same: how long the first rank to
    finish waits for the last."""
    ms = [m for m in record.gather_ms if m is not None]
    return max(ms) - min(ms) if ms else None


def clock_check(record, kernel: str = "cand_kernel", span: str = "rts.traverse") -> dict:
    """Whether the spans share the device's clock: of the ``kernel`` events,
    how many had their launch recorded, how many were launched inside a
    ``span`` span, how many of those started on the device after that span
    started on the host, and the least such lead (us; negative where the
    device's clock reads earlier than the host's)."""
    opened = _opener(record, span) or (lambda t: None)
    n = rec = 0
    leads = []
    for (name, s, _), t in zip(record.device_events, record.launches):
        if kernel in name:
            n += 1
            rec += t is not None
            start = opened(t)
            if start is not None:
                leads.append((s - start) * 1e-3)
    return {"events": n, "launch_recorded": rec, "launched_inside": len(leads),
            "started_after": sum(x >= 0 for x in leads), "lead_us_min": min(leads) if leads else None}


def skew_bounds(device, calls, windows=()) -> dict:
    """Bounds on the offset of the device's clock from the host's in the
    profiler's events (us; positive where the device reads later), from
    ``device`` events and runtime ``calls``, each (name, start_ns, end_ns,
    correlation id); a device event shares its launching call's id (an
    operator's ids are another count: a device event's linked id can name
    an unrelated call).  No device event starts before the start of the
    call that launched it: the offset is at most the least such lead.  A copy to
    pageable host memory has ended when its call returns: the offset is at
    least the greatest lag of such a copy's end over its call's end.  A
    bound is None where no event gives it.

    The two clocks may drift apart within a stretch, so the offset is also
    bounded in each of ``windows`` (host (start_ns, end_ns), by the start of
    the call) that holds both bounds: ``offset_us_range`` is the least and
    the most it can be in those, ``crossed`` counts the windows whose two
    bounds cross."""
    by_id = {c[3]: c for c in calls}
    leads, lags = [], []  # (the call's start, ns)
    for name, s, e, corr in device:
        call = by_id.get(corr)
        if call is None:
            continue
        leads.append((call[1], s - call[1]))
        if "DtoH" in name and "Pageable" in name:
            lags.append((call[1], e - call[2]))
    pinned = []
    for lo, hi in windows:
        up = [v for t, v in leads if lo <= t < hi]
        down = [v for t, v in lags if lo <= t < hi]
        if up and down:
            pinned.append((max(down) * 1e-3, min(up) * 1e-3))
    return {"offset_us_max": min(v for _, v in leads) * 1e-3 if leads else None, "launches": len(leads),
            "offset_us_min": max(v for _, v in lags) * 1e-3 if lags else None, "copies": len(lags),
            "calls": len(calls), "windows": len(pinned), "crossed": sum(lo > hi for lo, hi in pinned),
            "offset_us_range": [min(p[0] for p in pinned), max(p[1] for p in pinned)] if pinned else None}
