"""Monte-Carlo / parameter sweep runner with checkpointing (counterpart of
``rts_tpu.sim.sweep``).

The reference has no checkpoint or multi-run machinery (SURVEY.md §5);
production sweeps need both.  A sweep is a list of named cases (scene
builders); each case's traced CPI is written to ``<dir>/<name>.npz`` as
it completes, so an interrupted sweep resumes for free, and independent
cases can be partitioned across hosts with ``shard=(i, n)`` — case k runs
on host i iff k % n == i.  Within a host, each case can split its pulse and
ray axes over a process mesh (``rts_tpu_torch.parallel``).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, List, Optional, Sequence, Tuple

from torch.distributed.device_mesh import DeviceMesh

from rts_tpu_torch.config import Parameters
from rts_tpu_torch.engine.cpi import trace_cpi
from rts_tpu_torch.parallel import trace_cpi_sharded
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
    mesh=None,  # optional parallel.make_mesh mesh: split each case's pulses/rays over it
    accel: str = "brute",
    overwrite: bool = False,
    trace_kwargs: Optional[dict] = None,
    device="cuda",
) -> SweepReport:
    """Run every case assigned to this shard on ``device`` (the card unless
    the caller asks for another), checkpointing as we go.  With ``mesh``,
    every rank of it calls this and traces its part of each case through
    ``trace_cpi_sharded``; only the rank at mesh coordinate (0, 0) writes
    the ``.npz`` files, so that ranks never race on one file."""
    if mesh is not None and not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a parallel.make_mesh mesh, got {type(mesh).__name__}")
    writer = mesh is None or tuple(mesh.get_coordinate()) == (0, 0)
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
        if mesh is not None:
            out = trace_cpi_sharded(base, batch, cfg, spec, mesh)
        else:
            out = trace_cpi(base, batch, cfg, spec)
        completed.append(case.name)
        if not writer:
            continue
        tmp = path + ".tmp.npz"
        save_cpi(tmp, out, times=batch.times)
        os.replace(tmp, path)

    return SweepReport(completed=completed, skipped=skipped, seconds=time.time() - t0)
