"""Closest-hit result container (counterpart of ``rts_tpu.engine.intersect``).

The brute-force intersector of the JAX package is not ported yet
(ROADMAP A.3); the clustered traversal (``ops.cluster_trace``) returns
this type.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

RT_DEFAULT_MAX = 1e27  # OptiX RT_DEFAULT_MAX (float 1.e27f)


class HitResult(NamedTuple):
    t: torch.Tensor  # [R] hit distance (+inf when no hit)
    tri: torch.Tensor  # [R] int32 triangle index (valid only when found)
    beta: torch.Tensor  # [R]
    gamma: torch.Tensor  # [R]
    found: torch.Tensor  # [R] bool
    shade: torch.Tensor | None = None  # [10, R] winner's shade_pack row (emit_shade), else None
