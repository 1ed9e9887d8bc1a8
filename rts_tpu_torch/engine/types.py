"""Engine-facing data containers and static configuration
(counterpart of ``rts_tpu.engine.types``).

``TraceConfig`` has the same fields and derived properties as the JAX
one, so a configuration converts one to one (``rts_tpu_torch.convert``).

``DeviceScene`` is the flat scene of the brute-force intersector, with
the per-triangle vectors it needs precomputed once
(``derive_tri_arrays``; see ``engine.intersect``).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from rts_tpu_torch.config import Parameters
from rts_tpu_torch.core.vec import cross3
from rts_tpu_torch.geometry.scene import SceneArrays
from rts_tpu_torch.physics.receiver_geom import RxSphereGeometry


class DeviceScene(NamedTuple):
    """Flat triangle soup + per-target attributes (brute-force layout).

    The input of ``engine.intersect.closest_hit_bruteforce`` and of the
    dense path through the bounce loop (``accel="brute"``, the default
    and the f64 parity engine); the clustered path reads
    ``engine.animate.ClusterScene`` instead."""

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


def derive_tri_arrays(tri_verts):
    """Per-triangle precomputation from corner positions [T, 3, 3]:
    (p0, e0, e1, n, c1, c0, np0) with e0 = p1 - p0, e1 = p0 - p2,
    n = e1 x e0, c1 = p0 x e1, c0 = p0 x e0 and np0 = n . p0.  Per-pulse
    animation re-derives them from the moved corners
    (``engine.animate.animate_scene`` and ``animate_packed``)."""
    p0 = tri_verts[:, 0]
    e0 = tri_verts[:, 1] - tri_verts[:, 0]
    e1 = tri_verts[:, 0] - tri_verts[:, 2]
    n = cross3(e1, e0)
    np0 = n[:, 0] * p0[:, 0] + n[:, 1] * p0[:, 1] + n[:, 2] * p0[:, 2]
    return p0, e0, e1, n, cross3(p0, e1), cross3(p0, e0), np0


def scene_to_device(scene: SceneArrays, dtype=torch.float32, device="cuda") -> DeviceScene:
    """Upload a compiled scene to ``device`` (the card unless the caller
    asks for another) in ``dtype`` and derive the intersector's vectors."""
    f = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float64), dtype=dtype, device=device)
    p0, e0, e1, n, c1, c0, np0 = derive_tri_arrays(f(scene.tri_verts))
    return DeviceScene(
        tri_p0=p0,
        tri_e0=e0,
        tri_e1=e1,
        tri_n=n,
        tri_c1=c1,
        tri_c0=c0,
        tri_np0=np0,
        tri_corner_normals=f(scene.tri_normals),
        tri_target=torch.as_tensor(scene.tri_target, dtype=torch.int32, device=device),
        target_refl=f(scene.target_refl_coeff),
        target_refr=f(scene.target_refr_index),
        target_vel=f(scene.target_velocity),
    )


class RxGeomDevice(NamedTuple):
    """Receiver spheres + acceptance windows (see receiver_geom.py).
    Leaves are [NR, ...] for one pulse, [P, NR, ...] in a PulseBatch."""

    centre: torch.Tensor  # [NR, 3]
    radius: torch.Tensor  # [NR]
    min_theta: torch.Tensor  # [NR]
    max_theta: torch.Tensor  # [NR]
    min_phi: torch.Tensor  # [NR]
    max_phi: torch.Tensor  # [NR]

    @classmethod
    def from_host(cls, rx: RxSphereGeometry, dtype=torch.float32, device="cuda") -> "RxGeomDevice":
        return cls(*(
            torch.as_tensor(np.asarray(getattr(rx, f), np.float64), dtype=dtype, device=device)
            for f in cls._fields
        ))

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
    max_refr_dev: int
    interpolate_smooth: bool = True
    strict_parity: bool = False  # the reference's float32 narrowings (the parity engine)
    tri_chunk: int = 512  # triangles per brute-force chunk
    accel: str = "brute"  # "brute": dense intersector; "cluster": the CUDA traversal
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
    fan_order: str = "raster"  # "morton2"/"morton3": the fan traced in a Morton tile order

    @property
    def fan_tiling(self) -> bool:
        return self.fan_order != "raster"

    compact_lanes: bool = False  # lane sort after the spawn segments
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
