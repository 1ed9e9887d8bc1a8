"""Monte-Carlo / parameter sweep runner with checkpointing (counterpart of
``rts_tpu.sim.sweep``).

The reference has no checkpoint or multi-run machinery (SURVEY.md §5);
production sweeps need both.  A sweep is a list of named cases (scene
builders); each case's traced CPI is written to ``<dir>/<name>.npz`` as
it completes, so an interrupted sweep resumes for free, and independent
cases can be partitioned across hosts with ``shard=(i, n)`` — case k runs
on host i iff k % n == i.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, List, Optional, Sequence, Tuple

from rts_tpu_torch.config import Parameters
from rts_tpu_torch.engine.cpi import trace_cpi
from rts_tpu_torch.sim.cpi import prepare_cpi
from rts_tpu_torch.sim.export import save_cpi
from rts_tpu_torch.sim.world import World


@dataclasses.dataclass
class SweepCase:
    name: str
    build: Callable[[], Tuple[World, Parameters]]  # fresh world per case


@dataclasses.dataclass
class SweepReport:
    completed: List[str]
    skipped: List[str]
    seconds: float


def run_sweep(
    cases: Sequence[SweepCase],
    out_dir: str,
    *,
    shard: Tuple[int, int] = (0, 1),
    mesh=None,
    accel: str = "brute",
    overwrite: bool = False,
    trace_kwargs: Optional[dict] = None,
    device="cuda",
) -> SweepReport:
    """Run every case assigned to this shard on ``device`` (the card unless
    the caller asks for another), checkpointing as we go.  ``mesh`` (the
    JAX package's pulse-axis split over a device mesh) is not ported yet
    and refuses."""
    if mesh is not None:
        raise NotImplementedError(
            "run_sweep(mesh=...) needs the pulse-axis split (parallel/sharding.py), "
            "not ported to rts_tpu_torch yet (ROADMAP A.11)"
        )
    os.makedirs(out_dir, exist_ok=True)
    me, n = shard
    t0 = time.time()
    completed, skipped = [], []
    kw = dict(trace_kwargs or {})

    for k, case in enumerate(cases):
        if k % n != me:
            continue
        path = os.path.join(out_dir, f"{case.name}.npz")
        if os.path.exists(path) and not overwrite:
            skipped.append(case.name)
            continue
        world, params = case.build()
        base, batch, cfg, spec = prepare_cpi(world, params, accel=accel, device=device, **kw)
        out = trace_cpi(base, batch, cfg, spec)
        tmp = path + ".tmp.npz"
        save_cpi(tmp, out, times=batch.times)
        os.replace(tmp, path)
        completed.append(case.name)

    return SweepReport(completed=completed, skipped=skipped, seconds=time.time() - t0)
