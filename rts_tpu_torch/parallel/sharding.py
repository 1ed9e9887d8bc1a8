"""The pulse x ray split of a CPI across processes (counterpart of
``rts_tpu.parallel.sharding``).

The reference traces pulses in a sequential host loop (ray_tracer.cpp:843)
and rays fill one launch grid.  Here both are axes of a process mesh,
``("pulse", "ray")``, one process per device:

  * ``pulse`` — each process traces a contiguous block of the CPI's
    pulses (BASELINE config 5);
  * ``ray``   — the N^3 launch fan is cut into contiguous blocks; each
    process traces its block through every bounce, then the per-receiver
    multipath aggregation needs every lane of the pulse, so the lanes are
    gathered over the ray axis before it.  The trace itself needs no
    communication; only the aggregation boundary does.

Lane layout: a fan block of F rays produces ``slot_multiplier * F`` lanes,
slot-major (``slot * F + f``).  The whole pulse's layout interleaves the
blocks per slot, ``slot * N^3 + block * F + f``; ``regather_lanes``
restores it, so the split result is bit-identical to ``trace_cpi``'s as
long as the per-block caps hold (the replay cap and ``agg_cap`` act on
each block's lanes, as in the JAX package).

The collectives are ``torch.distributed``'s: NCCL for CUDA tensors, gloo
for CPU tensors, and no other pairing.  Every leaf travels as a
same-width integer view, so no value is converted on the way.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from rts_tpu_torch.engine.animate import SceneBase
from rts_tpu_torch.engine.cpi import CpiResult, CpiSpec, PulseBatch, make_pulse_fn, map_pulses
from rts_tpu_torch.engine.types import TraceConfig
from rts_tpu_torch.engine.wavefront import TraceResult
from rts_tpu_torch.utils.timing import trace_annotation

_BACKEND = {"cuda": "nccl", "cpu": "gloo"}
# what each dtype of a CpiResult or TraceResult travels as: the integer
# type of its width (int32 leaves travel as they are)
_WIRE = {torch.float64: torch.int64, torch.float32: torch.int32, torch.bool: torch.uint8}


def make_mesh(pulse_shards: int, ray_shards: int = 1, device_type: str = "cuda") -> DeviceMesh:
    """A ("pulse", "ray") mesh over the default process group's ranks, rank
    ``r`` at ``(r // ray_shards, r % ray_shards)``.  The process group must
    be initialised, with the world size the mesh asks for."""
    n = pulse_shards * ray_shards
    have = dist.get_world_size()
    if have < n:
        raise ValueError(f"need {n} devices, have {have}")
    if have > n:
        raise ValueError(f"the process group has {have} ranks; a mesh of {n} needs a world of {n}")
    return init_device_mesh(device_type, (pulse_shards, ray_shards), mesh_dim_names=("pulse", "ray"))


def _device(mesh: DeviceMesh) -> torch.device:
    """This process's device in ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _tree(fn, x):
    """``fn`` over every tensor of a (nested) NamedTuple; None passes."""
    if x is None:
        return None
    if isinstance(x, tuple):
        return type(x)(*(_tree(fn, a) for a in x))
    return fn(x)


def shard_batch(batch: PulseBatch, mesh: DeviceMesh) -> PulseBatch:
    """This process's contiguous block of the batch's pulses, on its device."""
    p, shards = batch.times.shape[0], mesh.size(0)
    if p % shards:
        raise ValueError(f"pulse count {p} not divisible by pulse shards {shards}")
    block = p // shards
    first = mesh.get_local_rank("pulse") * block
    dev = _device(mesh)
    return _tree(lambda a: a[first:first + block].to(dev), batch)


def regather_lanes(blocks: list[torch.Tensor], slot_mult: int, f_local: int) -> torch.Tensor:
    """The whole pulse's lanes from its ray blocks, in block order.

    Lanes are the LAST axis of every leaf.  Block ``k``'s lanes are
    ``slot * F + f``; laid side by side they are ``k * (slot_mult * F) +
    slot * F + f``, and the whole pulse wants ``slot * (K * F) + k * F + f``
    (ray_tracer.cpp:626's layout)."""
    g = torch.stack(blocks, -2)  # [..., K, slot_mult * F]
    head = g.shape[:-2]
    g = g.reshape(*head, len(blocks), slot_mult, f_local).transpose(-3, -2)
    return g.reshape(*head, slot_mult * len(blocks) * f_local)


def _all_gather(x: torch.Tensor, group) -> list[torch.Tensor]:
    """Every rank's ``x`` over ``group``, in rank order, bit for bit."""
    wire = x.contiguous().view(_WIRE.get(x.dtype, x.dtype))
    out = [torch.empty_like(wire) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, wire, group=group)
    return [o.view(x.dtype) for o in out]


def _check_backend(mesh: DeviceMesh, dev: torch.device) -> None:
    for name in ("pulse", "ray"):
        backend = dist.get_backend(mesh.get_group(name))
        if mesh.device_type != dev.type or _BACKEND.get(dev.type) != backend:
            raise ValueError(f"the {name} group runs {backend} on a {mesh.device_type} mesh, and the scene is "
                             f"on {dev.type}: the split gathers CUDA tensors over nccl and CPU tensors "
                             f"over gloo")


def trace_cpi_sharded(base: SceneBase, batch: PulseBatch, cfg: TraceConfig, spec: CpiSpec,
                      mesh: DeviceMesh) -> CpiResult:
    """Trace a CPI split over the mesh's (pulse, ray) axes; every rank calls
    it with the whole batch (``prepare_cpi``'s, on any device) and gets the
    whole CPI back, equal to ``trace_cpi``'s.

    Each rank traces its block of pulses through ``make_pulse_fn(...,
    fan_slice=(ray_shards, its ray index))``; each pulse's lanes are
    gathered over the ray group and put back in order (``regather_lanes``)
    before the aggregation (the ``rts.gather.ray`` spans), and the pulse
    blocks over the pulse group (``rts.gather.pulse``); the call is the
    ``rts.cpi`` span."""
    with trace_annotation("rts.cpi"):
        p = batch.times.shape[0]
        pulse_shards, ray_shards = mesh.size(0), mesh.size(1)
        if p % pulse_shards:
            raise ValueError(f"pulse count {p} not divisible by pulse shards {pulse_shards}")
        if cfg.rays_per_fan % ray_shards:
            raise ValueError(f"N^3={cfg.rays_per_fan} not divisible by ray shards {ray_shards}")
        _check_backend(mesh, base.tri_verts.device)
        f_local = cfg.rays_per_fan // ray_shards
        ray_group, pulse_group = mesh.get_group("ray"), mesh.get_group("pulse")
        one_pulse, aggregate = make_pulse_fn(base, cfg, spec, fan_slice=(ray_shards, mesh.get_local_rank("ray")))

        def regather(x):
            return regather_lanes(_all_gather(x, ray_group), cfg.slot_multiplier, f_local)

        def per_pulse(*args):
            res, power, doppler, delay = one_pulse(*args)
            with trace_annotation("rts.gather.ray"):
                res = TraceResult(*(regather(a) for a in res))
                power, doppler, delay = regather(power), regather(doppler), regather(delay)
            return aggregate(res, power, doppler, delay)

        local = map_pulses(per_pulse, shard_batch(batch, mesh))
        with trace_annotation("rts.gather.pulse"):
            return _tree(lambda x: torch.cat(_all_gather(x, pulse_group)), local)
