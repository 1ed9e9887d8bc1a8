"""Phase timing + profiling scaffolding (counterpart of
``rts_tpu.utils.timing``).

The reference's observability is gettimeofday printfs around setup /
kernel / post-processing / aggregation (ray_tracer.cpp:1156-1170,
1329-1332; aggregation.cu:137-166).  ``PhaseTimer`` is the structured
equivalent; ``trace_annotation`` adds named regions to ``torch.profiler``
traces so device timelines show simulation phases.

PyTorch returns before the card finishes: pass a tensor (or a nested
tuple of them) as ``PhaseTimer.phase(sync=...)`` to wait for the card
before the phase's clock stops.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, List, Optional

import torch


@dataclasses.dataclass
class PhaseTimer:
    """Accumulating named-phase wall-clock timer."""

    totals: Dict[str, float] = dataclasses.field(default_factory=dict)
    counts: Dict[str, int] = dataclasses.field(default_factory=dict)
    _order: List[str] = dataclasses.field(default_factory=list)

    @contextlib.contextmanager
    def phase(self, name: str, sync=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                _sync(sync)
            dt = time.perf_counter() - t0
            if name not in self.totals:
                self.totals[name] = 0.0
                self.counts[name] = 0
                self._order.append(name)
            self.totals[name] += dt
            self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name in self._order:
            n = self.counts[name]
            tot = self.totals[name]
            lines.append(f"{name}: {tot:.4f}s total, {n} calls, {tot / n:.4f}s avg")
        return "\n".join(lines)

    def rays_per_second(self, phase: str, rays: int) -> Optional[float]:
        tot = self.totals.get(phase)
        return rays / tot if tot else None


def _first_tensor(x):
    if torch.is_tensor(x):
        return x
    if isinstance(x, (tuple, list)):
        for y in x:
            t = _first_tensor(y)
            if t is not None:
                return t
    return None


def _sync(x):
    """Wait for the card when ``x`` holds a CUDA tensor (a CPU tensor is
    ready when the call returns)."""
    t = _first_tensor(x)
    if t is not None and t.is_cuda:
        torch.cuda.synchronize(t.device)


@contextlib.contextmanager
def trace_annotation(name: str):
    """Named region in torch.profiler traces (no-op if profiler inactive)."""
    with torch.profiler.record_function(name):
        yield
