"""Engine-facing data containers and static configuration
(counterpart of ``rts_tpu.engine.types``).

``TraceConfig`` has the same fields and derived properties as the JAX
one, so a configuration converts one to one (``rts_tpu_torch.convert``).
Options whose work is not ported yet are kept as fields but refused by
the code that would read them, with a pointer to ROADMAP (see
``sim.cpi.prepare_cpi`` and ``engine.wavefront.trace_fan``).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from rts_tpu_torch.config import Parameters


class DeviceScene(NamedTuple):
    """Flat triangle soup + per-target attributes (brute-force layout).

    The clustered main path uses ``engine.animate.ClusterScene``; this
    container is the input of the brute-force intersector, which is not
    ported yet (ROADMAP A.3)."""

    tri_p0: torch.Tensor  # [T, 3]
    tri_e0: torch.Tensor  # [T, 3]  p1 - p0
    tri_e1: torch.Tensor  # [T, 3]  p0 - p2
    tri_n: torch.Tensor  # [T, 3]  cross(e1, e0)
    tri_c1: torch.Tensor  # [T, 3]  cross(p0, e1)
    tri_c0: torch.Tensor  # [T, 3]  cross(p0, e0)
    tri_np0: torch.Tensor  # [T]    dot(n, p0)
    tri_corner_normals: torch.Tensor  # [T, 3, 3]
    tri_target: torch.Tensor  # [T] int32 (-1 padding)
    target_refl: torch.Tensor  # [NT]
    target_refr: torch.Tensor  # [NT]
    target_vel: torch.Tensor  # [NT, 3]


class RxGeomDevice(NamedTuple):
    """Receiver spheres + acceptance windows (see receiver_geom.py).
    Leaves are [NR, ...] for one pulse, [P, NR, ...] in a PulseBatch."""

    centre: torch.Tensor  # [NR, 3]
    radius: torch.Tensor  # [NR]
    min_theta: torch.Tensor  # [NR]
    max_theta: torch.Tensor  # [NR]
    min_phi: torch.Tensor  # [NR]
    max_phi: torch.Tensor  # [NR]

    @property
    def num_rx(self) -> int:
        return int(self.centre.shape[-2])


@dataclasses.dataclass(frozen=True)
class TraceConfig:
    """Static trace parameters; field for field the JAX ``TraceConfig``.

    ``max_refl_dev`` is the device-side "stop index" (user max_refl + 1,
    ray_tracer.cpp:776); ``max_refr_dev`` the refraction cap (0 or 2).
    See ``rts_tpu.engine.types.TraceConfig`` for what each traversal knob
    does; the comments here say only how the port treats it.
    """

    num_rays: int
    max_refl_dev: int
    max_refr_dev: int  # the port traces reflections only (0); see ROADMAP
    interpolate_smooth: bool = True
    strict_parity: bool = False  # f64 parity engine: not ported
    tri_chunk: int = 512  # brute-force intersector: not ported
    accel: str = "brute"  # the port runs "cluster" only
    cluster_size: int = 256
    ray_tile: int = 512  # rays per kernel thread block
    group_size: int = 16  # clusters per sweep group
    super_size: int = 1  # groups per sweep supergroup
    sub_tiles: int = 4  # ray sub-blocks per tile, gated by phase-1 bits
    candidates: int = 64  # phase-1 list width; 0 = sweep-only
    mt_group: int = 2  # candidates per MT window
    mt_union: bool = True  # False: one window per candidate (kernel mode K6)
    mt_tail: bool = False  # half-width tail window
    mt_prune: bool = False  # running-best window prune (kernel mode K3)
    cand_order: str = "near"  # "mask": window-mates grouped by sub-block bits
    resident_cap: int = 0  # >0: windows read a compacted live-cluster pack (K5)
    p1_fanout: int | None = None
    p1_super_k: int | None = None
    p1_fanout0: int | None = None
    p1_super_k0: int | None = None
    fan_order: str = "raster"  # Morton fan tiling: not ported

    @property
    def fan_tiling(self) -> bool:
        return self.fan_order != "raster"

    compact_lanes: bool = False  # lane sort before late segments: not ported
    compact_narrow: int = 0  # narrow late segments (0/1 off, -1 auto, N)
    interpret: bool = False  # Pallas interpreter flag: no meaning here
    refine: bool = False  # precision replay, native float64 here (engine/replay.py)
    replay_cap: int = 0
    agg_cap: int = 4096  # received-lane block for postprocess
    shade_emit: bool = False  # kernel-emitted winner shade rows (kernel mode K4)
    rcs_angles: bool = True

    @classmethod
    def from_parameters(cls, p: Parameters, **kw) -> "TraceConfig":
        return cls(
            num_rays=p.num_rays,
            max_refl_dev=p.max_refl_depth + 1,
            max_refr_dev=p.max_refr_depth,
            interpolate_smooth=p.interpolate_smooth,
            **kw,
        )

    @property
    def rays_per_fan(self) -> int:
        return self.num_rays**3

    @property
    def refraction_on(self) -> bool:
        return self.max_refr_dev == 2

    @property
    def slot_multiplier(self) -> int:
        # ray_tracer.cpp:608-623: 1 + (max_refl + 1) + 1 with refraction.
        return ((self.max_refl_dev - 1) + 3) if self.refraction_on else 1

    @property
    def ray_total(self) -> int:
        return self.slot_multiplier * self.rays_per_fan

    @property
    def depth_total(self) -> int:
        return (self.max_refl_dev - 1) + self.max_refr_dev

    @property
    def tri_seq_width(self) -> int:
        """Chain-record width: one slot per possible gated hit."""
        return self.depth_total + 1

    @property
    def num_segments(self) -> int:
        """Static wavefront iteration count (see the JAX TraceConfig)."""
        extra = 2 if self.refraction_on else 0
        return self.max_refl_dev + 1 + extra
