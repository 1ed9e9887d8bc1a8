"""Batched closest-hit search by brute force (counterpart of
``rts_tpu.engine.intersect``).

The reference's double-precision Möller–Trumbore test
(triangle_mesh.cu:121-199), with the triple-product identities

    n     = (p0-p2) x (p1-p0)
    denom = n . d
    t     = n . (p0 - o) / denom
    beta  = [d.(p0 x e1) - (d x o).e1] / denom
    gamma = [d.(p0 x e0) - (d x o).e0] / denom

becomes six [R, 3] @ [3, C] contractions per chunk of C triangles over the
per-ray vectors {o, d, d x o} and the per-triangle vectors {n, p0 x e1,
p0 x e0, e1, e0} precomputed by ``engine.types.derive_tri_arrays``.  The
contractions are ``torch.matmul`` in the engine's dtype (full f32, TF32
off: ``rts_tpu_torch/__init__.py``).  It is the JAX function's plain XLA,
not a Pallas kernel, ported as plain PyTorch.

The clustered traversal (``ops.cluster_trace``) returns the same
``HitResult``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rts_tpu_torch.core.vec import cross3

RT_DEFAULT_MAX = 1e27  # OptiX RT_DEFAULT_MAX (float 1.e27f)


class HitResult(NamedTuple):
    t: torch.Tensor  # [R] hit distance (+inf when no hit)
    tri: torch.Tensor  # [R] int32 triangle index (valid only when found)
    beta: torch.Tensor  # [R]
    gamma: torch.Tensor  # [R]
    found: torch.Tensor  # [R] bool
    shade: torch.Tensor | None = None  # [10, R] winner's shade_pack row (emit_shade), else None


def closest_hit_bruteforce(
    origin: torch.Tensor,  # [R, 3]
    direction: torch.Tensor,  # [R, 3]
    tmin: torch.Tensor,  # [R] per-ray minimum segment length
    tri_p0,
    tri_e0,
    tri_e1,
    tri_n,
    tri_c1,
    tri_c0,
    tri_np0,
    *,
    tri_chunk: int = 512,
) -> HitResult:
    """Closest valid triangle per ray over the whole flat soup.

    Triangles go in chunks of ``tri_chunk``; T is padded to a whole chunk
    with all-zero triangles (denominator 0: NaN, rejected).  Within a
    chunk the first minimum wins (``argmin``); across chunks a strict
    ``<`` keeps the earlier chunk on ties.  ``tri_p0`` is not read (it
    stays in the signature, as in the JAX function)."""
    r = origin.shape[0]
    t_count = tri_n.shape[0]
    dtype, dev = origin.dtype, origin.device
    chunk = min(tri_chunk, t_count)
    if t_count % chunk:
        pad = chunk - t_count % chunk
        z = lambda a: torch.cat([a, a.new_zeros((pad,) + a.shape[1:])])
        tri_e0, tri_e1, tri_n, tri_c1, tri_c0, tri_np0 = map(
            z, (tri_e0, tri_e1, tri_n, tri_c1, tri_c0, tri_np0))
        t_count += pad

    m = cross3(direction, origin)  # [R, 3] the (d x o) term
    rows = torch.arange(r, device=dev)
    best_t = torch.full((r,), float("inf"), dtype=dtype, device=dev)
    best_tri = torch.zeros(r, dtype=torch.int32, device=dev)
    best_beta = torch.zeros(r, dtype=dtype, device=dev)
    best_gamma = torch.zeros(r, dtype=dtype, device=dev)
    for base in range(0, t_count, chunk):
        s = slice(base, base + chunk)
        inv = 1.0 / (direction @ tri_n[s].T)  # [R, C]
        t = (tri_np0[s][None, :] - origin @ tri_n[s].T) * inv
        beta = (direction @ tri_c1[s].T - m @ tri_e1[s].T) * inv
        gamma = (direction @ tri_c0[s].T - m @ tri_e0[s].T) * inv
        valid = (
            (t < RT_DEFAULT_MAX)
            & (t > tmin[:, None])
            & (beta >= 0.0)
            & (gamma >= 0.0)
            & (beta + gamma <= 1.0)
        )
        t_m = torch.where(valid, t, float("inf"))
        j = torch.argmin(t_m, dim=1)  # first minimum within the chunk
        tj = t_m[rows, j]
        better = tj < best_t  # strict: the earlier chunk wins ties
        best_t = torch.where(better, tj, best_t)
        best_tri = torch.where(better, (base + j).to(torch.int32), best_tri)
        best_beta = torch.where(better, beta[rows, j], best_beta)
        best_gamma = torch.where(better, gamma[rows, j], best_gamma)
    return HitResult(t=best_t, tri=best_tri, beta=best_beta, gamma=best_gamma,
                     found=torch.isfinite(best_t))
