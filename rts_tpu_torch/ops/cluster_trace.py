"""Clustered closest-hit traversal (counterpart of ``rts_tpu.ops.cluster_trace``).

Triangles arrive Morton-clustered (``accel``) in the packed [16, T] field
layout (rows n, c1, c0, e1, e0, np0; triangles on the last axis); rays
arrive components-major ([3, L]) and are processed in tiles of
``ray_tile``.  Two phases, as in the JAX package:

  PHASE 1 (``_tile_candidates``, plain PyTorch, once per segment): per
  ray tile, the near-to-far list of clusters that some ray of the tile
  overlaps (exact per-ray slab tests, evaluated hierarchically), the
  per-sub-block overlap bits, and an overflow flag for tiles that overlap
  more clusters than the list holds.  Bit-identical to the JAX phase 1:
  every ``jax.lax.top_k`` / ``jnp.argsort`` becomes a STABLE
  ``torch.sort`` (ties toward the lower index, as ``top_k`` breaks them).

  PHASE 2 (``mt_traverse``): per tile, Moller-Trumbore over the
  candidate windows (K1), optionally with the running-best window prune
  (K3), one window per candidate (K6, ``mt_union=False``) and windows
  read from a compacted live-cluster pack (K5, ``resident_cap``), or the
  hierarchical sweep for overflowed tiles (K2); optionally the winner's
  shade row as an extra output (K4); always the per-tile work counters.
  On a CUDA tensor it launches the hand-written kernel
  ``csrc/mt_traverse.cu``; on a CPU tensor it runs the plain PyTorch
  version ``mt_traverse_reference``.

The TPU-only machinery of the JAX module (SMEM row packing and grid
chunking, the f32-encoded tri ids of the packed I/O, the ``RTS_*``
experiment switches) has no counterpart.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import NamedTuple

import torch

from rts_tpu_torch.engine.intersect import RT_DEFAULT_MAX, HitResult

_BIG = 3.0e38  # "no hit" running-best sentinel, as in the JAX kernel
_INF = float("inf")

# Phase-1 hierarchy defaults (the JAX module's constants; per call
# overridable through TraceConfig.p1_*): level 1 tests rays against
# supergroup boxes of _P1_FANOUT clusters and admits at most _P1_SUPER_K
# of them per tile; level 0 (when the supergroup count reaches
# _P1_L0_MIN_S) first tests runs of _P1_FANOUT0 supergroups and admits at
# most _P1_SUPER_K0 runs per tile.  Tiles admitting more overflow to the
# sweep.
_P1_FANOUT = 16
_P1_SUPER_K = 16
_P1_FANOUT0 = 8
_P1_SUPER_K0 = 12
_P1_L0_MIN_S = 192
# Level 2 runs in chunks of tiles whose [tiles, rays, members] slab
# tensors hold at most this many elements (128 MiB per f32 tensor): each
# tile is independent, so chunking changes no bit, only peak memory.
_P1_CHUNK_ELEMS = 1 << 25
_ENT_PAD = 2**30  # entry-table value of padding slots (never loosens a window min)
_LIVE_PACK_MAX = 12 * 1024 * 1024  # K5 live-pack limit, rts_tpu's VMEM budget


def _top_k_indices(key, k: int):
    """Indices of the k largest entries along the last axis, ties toward
    the lower index (the order ``jax.lax.top_k`` returns)."""
    return torch.sort(key, dim=-1, descending=True, stable=True).indices[..., :k]


def _tile_candidates(origin, direction, tmin, mn, mx, ray_tile, sub_tiles, k_max,
                     cand_order="near", p1_fanout=None, p1_super_k=None, p1_fanout0=None,
                     p1_super_k0=None):
    """Phase 1: per-ray-tile candidate cluster lists.

    Returns (cand [tiles, k_max] int32, meta [tiles, 2] int32,
    bits [tiles, k_max] int32, ent [tiles, k_max] int32): meta[:, 0] is
    the candidate count and meta[:, 1] is 1 when the tile overlaps more
    clusters than the list holds (the traversal then sweeps the tile);
    bit b of ``bits`` is set when ray sub-block b overlaps the candidate;
    ``ent`` is the candidate's entry distance over the tile's rays,
    floored to 1/16 m (the ``mt_prune`` table; 2**30 in padding slots).
    Candidates are sorted near-to-far by entry distance (``cand_order=
    "mask"`` regroups them by sub-block mask); slots past the count
    repeat the last valid candidate with bits 0.  ``rts_tpu.ops.
    cluster_trace._tile_candidates`` documents the design; this is the
    same computation, operation for operation.
    """
    dev = origin.device
    l = origin.shape[1]
    c = mn.shape[0]
    f32 = torch.float32
    o = origin.to(f32)
    d = direction.to(f32)
    alive = (d[0] * d[0] + d[1] * d[1] + d[2] * d[2]) > 0.0
    big = _BIG
    mnf = mn.to(f32)
    mxf = mx.to(f32)
    tiles = l // ray_tile
    inv = 1.0 / torch.where(d == 0.0, 1.0, d)
    tmin_f = tmin.to(f32)
    arange = lambda n: torch.arange(n, dtype=torch.int32, device=dev)

    def batch_slab(bmn, bmx, ts=slice(None)):
        """Exact per-ray slab vs a box set ([B, 3] shared, or [n, B, 3] per
        tile of the tile slice ``ts``): [l, B] or [n, rt, B] overlap and
        entry distance."""
        if bmn.dim() == 2:
            comp = lambda a, ax: a[ax]
            al_, tm_ = alive, tmin_f
            expand = lambda a: a[:, None]
            bsel = lambda a, ax: a[None, :, ax]
        else:
            comp = lambda a, ax: a[ax].reshape(tiles, ray_tile)[ts]
            al_ = alive.reshape(tiles, ray_tile)[ts]
            tm_ = tmin_f.reshape(tiles, ray_tile)[ts]
            expand = lambda a: a[..., None]
            bsel = lambda a, ax: a[:, None, :, ax]
        shape = al_.shape + (bmn.shape[-2],)
        tn = torch.full(shape, -big, dtype=f32, device=dev)
        tf = torch.full(shape, big, dtype=f32, device=dev)
        for ax in range(3):
            oa = expand(comp(o, ax))
            ia = expand(comp(inv, ax))
            t1 = (bsel(bmn, ax) - oa) * ia
            t2 = (bsel(bmx, ax) - oa) * ia
            lo = torch.minimum(t1, t2)
            hi = torch.maximum(t1, t2)
            inside = (oa >= bsel(bmn, ax)) & (oa <= bsel(bmx, ax))
            dz = expand(comp(d, ax)) == 0.0
            lo = torch.where(dz, torch.where(inside, -big, big), lo)
            hi = torch.where(dz, torch.where(inside, big, -big), hi)
            tn = torch.maximum(tn, lo)
            tf = torch.minimum(tf, hi)
        box_ok = (torch.isfinite(bmn) & torch.isfinite(bmx) & (bmn <= bmx)).all(-1)
        ok = box_ok[None, :] if bmn.dim() == 2 else box_ok[:, None, :]
        ov = (tf >= tn) & (tf >= expand(tm_)) & expand(al_) & ok
        return ov, torch.where(ov, torch.maximum(tn, torch.zeros((), dtype=f32, device=dev)), _INF)

    def pad_inf(a, rows):
        if rows > a.shape[0]:
            return torch.cat([a, torch.full((rows - a.shape[0], 3), _INF, dtype=a.dtype, device=dev)])
        return a

    def run_boxes(bmn, bmx, n_runs, fan):
        """Bounding boxes of runs of ``fan`` boxes; all-sentinel runs get
        the [+inf, +inf] sentinel."""
        fin = torch.isfinite(bmn[:, 0:1]) & torch.isfinite(bmx[:, 0:1])
        r_mn = torch.where(fin, bmn, big).reshape(n_runs, fan, 3).amin(1)
        r_mx = torch.where(fin, bmx, -big).reshape(n_runs, fan, 3).amax(1)
        bad = (r_mn[:, 0] > r_mx[:, 0])[:, None]
        return torch.where(bad, _INF, r_mn), torch.where(bad, _INF, r_mx)

    # --- level 1: supergroup boxes (runs of ``fanout`` clusters)
    fanout = p1_fanout or _P1_FANOUT
    s = -(-c // fanout)
    c_pad1 = s * fanout
    mnp, mxp = pad_inf(mnf, c_pad1), pad_inf(mxf, c_pad1)
    s_mn, s_mx = run_boxes(mnp, mxp, s, fanout)

    ks = min(p1_super_k or _P1_SUPER_K, s)
    if s >= _P1_L0_MIN_S:
        # --- level 0: runs of f0 supergroups tested dense, then only the
        # member supergroups of each tile's admitted level-0 boxes
        f0 = p1_fanout0 or _P1_FANOUT0
        s0 = -(-s // f0)
        s_pad0 = s0 * f0
        smnp, smxp = pad_inf(s_mn, s_pad0), pad_inf(s_mx, s_pad0)
        fin0 = torch.isfinite(smnp[:, 0:1])
        z_mn = torch.where(fin0, smnp, big).reshape(s0, f0, 3).amin(1)
        z_mx = torch.where(fin0, smxp, -big).reshape(s0, f0, 3).amax(1)
        z_bad = (z_mn[:, 0] > z_mx[:, 0])[:, None]
        z_mn = torch.where(z_bad, _INF, z_mn)
        z_mx = torch.where(z_bad, _INF, z_mx)
        ov_z, _ = batch_slab(z_mn, z_mx)  # [l, S0]
        ov_z_t = ov_z.reshape(tiles, ray_tile, s0).any(1)
        k0 = min(p1_super_k0 or _P1_SUPER_K0, s0)
        z_count = ov_z_t.sum(1)
        z_order = _top_k_indices(ov_z_t.to(torch.int32) * (s0 - arange(s0)), k0)
        l0_over = z_count > k0
        sg_slots = (z_order[..., None] * f0 + arange(f0)).reshape(tiles, k0 * f0)
        sg_slots = sg_slots.clamp(max=s_pad0 - 1)
        ov_s1, _ = batch_slab(smnp[sg_slots], smxp[sg_slots])  # [tiles, rt, k0*f0]
        ov_s_t = ov_s1.any(1)
        nsl = k0 * f0
        s_count = ov_s_t.sum(1)
        sel1 = _top_k_indices(ov_s_t.to(torch.int32) * (nsl - arange(nsl)), min(ks, nsl))
        s_order = torch.gather(sg_slots, 1, sel1)
        ks = min(ks, nsl)
        s_over = l0_over | (s_count > ks)
    else:
        ov_s, _ = batch_slab(s_mn, s_mx)  # [l, S]
        ov_s_t = ov_s.reshape(tiles, ray_tile, s).any(1)
        s_count = ov_s_t.sum(1)
        s_order = _top_k_indices(ov_s_t.to(torch.int32) * (s - arange(s)), ks)
        s_over = s_count > ks

    # --- level 2: member clusters of each tile's admitted supergroups
    members = (s_order[..., None] * fanout + arange(fanout)).reshape(tiles, ks * fanout)
    members = members.clamp(max=c_pad1 - 1)
    rs = ray_tile // sub_tiles
    kf = ks * fanout
    step = max(1, _P1_CHUNK_ELEMS // (ray_tile * kf))
    parts = []
    for t0 in range(0, tiles, step):
        ts = slice(t0, t0 + step)
        ov_c, tnear_c = batch_slab(mnp[members[ts]], mxp[members[ts]], ts)  # [n, rt, kf]
        n = ov_c.shape[0]
        parts.append((ov_c.reshape(n, sub_tiles, rs, kf).any(2),  # [n, st, kf]
                      tnear_c.reshape(n, sub_tiles, rs, kf).amin(2)))
        del ov_c, tnear_c
    ov_sb = torch.cat([p[0] for p in parts])
    tnear_sb = torch.cat([p[1] for p in parts])
    ov_ct = ov_sb.any(1)
    tnear_t = tnear_sb.amin(1)
    weights = torch.bitwise_left_shift(torch.ones((), dtype=torch.int32, device=dev), arange(sub_tiles))
    bits_all = (ov_sb.to(torch.int32) * weights[None, :, None]).sum(1, dtype=torch.int32)

    count = ov_ct.sum(1).to(torch.int32)
    k_eff = min(k_max, kf)
    tkey = torch.where(ov_ct, tnear_t, _INF)
    sel = _top_k_indices(-tkey, k_eff)
    order = torch.gather(members, 1, sel).to(torch.int32)
    bits = torch.gather(bits_all, 1, sel)
    # per-candidate entry distance (the sort key) floored to 1/16 m: the
    # mt_prune table; the floor only under-estimates, keeping the prune exact
    ent_f = torch.gather(tnear_t, 1, sel)
    entq = torch.floor(torch.clamp(ent_f, max=8.0e5) * 16.0).to(torch.int32)
    if k_eff < k_max:
        zpad = torch.zeros((tiles, k_max - k_eff), dtype=torch.int32, device=dev)
        order = torch.cat([order, zpad], 1)
        bits = torch.cat([bits, zpad], 1)
        entq = torch.cat([entq, zpad + _ENT_PAD], 1)
    over = s_over | (count > k_eff)
    meta = torch.stack([count.clamp(max=k_eff), over.to(torch.int32)], dim=1)
    pos = arange(k_max)[None, :]
    count_col = meta[:, 0:1]
    if cand_order == "mask":
        # window-mates share sub-block masks: sort key (bits, near-to-far
        # rank), slots past the count last (the keys are unique)
        if sub_tiles > 16:
            raise ValueError("cand_order='mask' supports sub_tiles <= 16")
        key = torch.where(pos < count_col, torch.bitwise_left_shift(bits, 12) | pos, _ENT_PAD + pos)
        perm = torch.argsort(key, dim=1, stable=True)
        order, bits, entq = (torch.gather(a, 1, perm) for a in (order, bits, entq))
    elif cand_order != "near":
        raise ValueError(f"cand_order must be 'near' or 'mask', got {cand_order!r}")
    # pad slots >= count with the last valid candidate, bits 0 and an entry
    # that never loosens a window's minimum
    last = torch.clamp(torch.minimum(pos, count_col - 1), min=0).long()
    order = torch.where(count_col > 0, torch.gather(order, 1, last), 0).to(torch.int32)
    bits = torch.where(pos < count_col, bits, 0).to(torch.int32)
    entq = torch.where(pos < count_col, entq, _ENT_PAD).to(torch.int32)
    return order.contiguous(), meta.contiguous(), bits.contiguous(), entq.contiguous()


def _live_set(cand, meta, tri_pack, cap, c, cs):
    """K5's live-cluster pack, step for step as ``rts_tpu``'s resident
    wrapper: the distinct clusters of every tile's list (overflow tiles'
    lists and the zeros of empty tiles included), sorted, the first ``cap``
    of them padded with 2**30; candidate ids remapped to their live slots;
    every tile flagged for the sweep when more than ``cap`` are live.
    Static shapes only (sort, first-occurrence mask, cumsum,
    searchsorted), so it never reads the device from the host.

    Returns (slots [tiles, K], meta, live_pack [16, cap * cs], live_tab
    [cap]) and adds the overflow flag to ``mt_traverse.resident_overflows``.
    """
    dev = cand.device
    i32 = torch.int32
    s = torch.sort(cand.reshape(-1)).values
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), s[1:] != s[:-1]])
    nlive = first.sum(dtype=i32)
    rank = torch.cumsum(first, 0, dtype=i32)  # 1-based rank of each distinct id
    jj = torch.arange(cap, dtype=i32, device=dev)
    idx = torch.searchsorted(rank, jj + 1).clamp(max=s.numel() - 1)
    live_sorted = torch.where(jj < nlive, s[idx], 2**30)
    slots = torch.searchsorted(live_sorted, cand).clamp(0, cap - 1).to(i32)
    ovf = (nlive > cap).to(i32)
    meta = torch.stack([meta[:, 0], torch.maximum(meta[:, 1], ovf)], 1)
    mt_traverse.resident_overflows = mt_traverse.resident_overflows.to(dev) + ovf
    # candidates are real clusters (padding boxes never overlap): the 2**30
    # tail clips to the last one
    live_tab = live_sorted.clamp(0, c - 1)
    cols = (live_tab[:, None] * cs + torch.arange(cs, dtype=i32, device=dev)).reshape(-1)
    return slots.contiguous(), meta.contiguous(), tri_pack[:, cols.long()].contiguous(), live_tab


class TraversalInputs(NamedTuple):
    """Phase-2 operands, shared by the CUDA kernel and its plain version.
    Lanes are padded to whole tiles; every float is f32, every id int32."""

    origin: torch.Tensor  # [3, lanes]
    direction: torch.Tensor  # [3, lanes] (zero = dead lane)
    tmin: torch.Tensor  # [lanes]
    tri_pack: torch.Tensor  # [16, T]
    mn: torch.Tensor  # [Cp, 3] cluster boxes, +inf-padded to group*super
    mx: torch.Tensor
    g_mn: torch.Tensor  # [Cp / group_size, 3]
    g_mx: torch.Tensor
    s_mn: torch.Tensor  # [n_super, 3]
    s_mx: torch.Tensor
    s_order: torch.Tensor  # [n_super] supergroup visit order (near-to-far)
    g_order: torch.Tensor  # [n_groups] group order within each supergroup
    cand: torch.Tensor  # [tiles, K] (K = 1 dummy when sweep-only)
    meta: torch.Tensor  # [tiles, 2] (count, overflow)
    bits: torch.Tensor  # [tiles, K]
    ent: torch.Tensor  # [tiles, K] entry distance, 1/16 m units (read under mt_prune)
    shade_pack: torch.Tensor  # [T, 10] winner shade rows (read under emit_shade), else [0, 10]
    live_pack: torch.Tensor  # [16, resident_cap * cs] live clusters' columns (K5), else [16, 0]
    live_tab: torch.Tensor  # [resident_cap] global cluster id of each live slot (K5), else [0]


class TraversalShape(NamedTuple):
    ray_tile: int
    cluster_size: int
    group_size: int
    super_size: int
    sub_tiles: int
    k_max: int  # candidate-list width; 0 = sweep every tile
    mt_group: int
    mt_tail: bool
    mt_prune: bool = False  # K3: running-best window prune
    emit_shade: bool = False  # K4: winner's shade_pack row as a [10, lanes] output
    mt_union: bool = True  # False (K6): one window per candidate, gated by its own bits
    resident_cap: int = 0  # K5: cand holds live slots; windows read live_pack


def _slab_rays(o, d, tmin, alive, mn, mx, best):
    """The kernel's per-ray slab test (``_slab_overlap``) of rays [3, R]
    against boxes [B, 3] with running bests ``best`` [R, 1]: [R, B]."""
    o, d = o[..., None], d[..., None]
    inv = 1.0 / torch.where(d == 0.0, 1.0, d)
    tn = tf = None
    for ax in range(3):
        t1 = (mn[:, ax] - o[ax]) * inv[ax]
        t2 = (mx[:, ax] - o[ax]) * inv[ax]
        lo = torch.minimum(t1, t2)
        hi = torch.maximum(t1, t2)
        inside = (o[ax] >= mn[:, ax]) & (o[ax] <= mx[:, ax])
        dz = d[ax] == 0.0
        lo = torch.where(dz, torch.where(inside, -_BIG, _BIG), lo)
        hi = torch.where(dz, torch.where(inside, _BIG, -_BIG), hi)
        tn = lo if tn is None else torch.maximum(tn, lo)
        tf = hi if tf is None else torch.minimum(tf, hi)
    return (tf >= tn) & (tf >= tmin[:, None]) & (tn <= best) & alive[:, None]


def _mt_window(o, d, m, tmin, f, gate, tri_ids, best):
    """One MT window for a batch of tiles, the JAX kernel's ``_eval``.

    o, d, m [3, n, rt, 1]; tmin [n, rt, 1]; f [16, n, 1, W] fields;
    gate bool broadcastable to [n, rt, W]; tri_ids [n, 1, W] int32;
    best = (t, tri, beta, gamma) [n, rt] tensors, updated in place where
    the window's first-minimum valid hit is strictly nearer.
    """

    def sdot(a, k):
        return a[0] * f[k] + a[1] * f[k + 1] + a[2] * f[k + 2]

    inv = 1.0 / sdot(d, 0)
    t = (f[15] - sdot(o, 0)) * inv
    beta = (sdot(d, 3) - sdot(m, 9)) * inv
    gamma = (sdot(d, 6) - sdot(m, 12)) * inv
    valid = (t > tmin) & (torch.minimum(beta, gamma) >= 0.0) & (beta + gamma <= 1.0) & gate
    t_m = torch.where(valid, t, _BIG)
    tj = t_m.amin(-1)
    cols = torch.arange(t_m.shape[-1], device=t_m.device)
    j = torch.where(t_m == tj[..., None], cols, 2**30).amin(-1, keepdim=True)
    better = tj < best[0]
    # + 0.0: the JAX kernel extracts the winner by a masked sum, which
    # turns a -0.0 barycentric into +0.0
    best[0].copy_(torch.where(better, tj, best[0]))
    tri = torch.gather(tri_ids.expand(-1, j.shape[1], -1), -1, j)[..., 0]
    best[1].copy_(torch.where(better, tri, best[1]))
    best[2].copy_(torch.where(better, torch.gather(beta, -1, j)[..., 0] + 0.0, best[2]))
    best[3].copy_(torch.where(better, torch.gather(gamma, -1, j)[..., 0] + 0.0, best[3]))


def mt_traverse_reference(inp: TraversalInputs, shape: TraversalShape, tile_chunk: int = 16):
    """Plain PyTorch version of the traversal kernel: (t, tri, beta, gamma,
    shade, stats) per lane, t = 3e38 where no hit, shade None unless
    ``shape.emit_shade``.

    Candidate tiles (K1) evaluate the same windows as the kernel,
    vectorised over a chunk of tiles and the window's columns, window by
    window in list order.  A window is G wide here, and the columns of its
    padding slots (past the tile's count) are gated off: the kernel does
    not stage them, and as repeats of the last candidate they could not
    change a result.  Under ``mt_union=False`` (K6) every candidate is a
    window of its own, gated by its own bits: K1 at ``mt_group`` 1.  Under ``mt_prune`` (K3) a
    sub-block skips a window whose minimum entry (``ent``, 1/16 m units;
    padding slots hold 2**30) exceeds 16 x the largest running best of its
    rays as the previous window left it, the TPU kernel's gate at its
    granularity.  Under ``resident_cap`` (K5) ``cand`` holds live slots: a
    window reads its columns from ``live_pack`` at ``slot * cs + j`` and
    its triangle ids are ``live_tab[slot] * cs + j``.  Under
    ``emit_shade`` (K4) the winner's ``shade_pack`` row is gathered at the
    end (zeros where no triangle won).

    Sweep tiles (K2) walk the kernel's hierarchy, vectorised over the swept
    tiles: each supergroup, group and cluster box in visit order is tested
    against every ray with its running best (``tn <= best``), a tile skips
    the box when none of its rays passes, and a cluster is evaluated at
    once for the sub-blocks with a passing ray.  The sweep reads the global
    pack, under K5 too.

    ``stats`` [tiles, 2] int32 are the kernel's work counters: a candidate
    tile's count twice; for a swept tile the groups visited (supergroups
    when ``super_size == 1``) and the clusters whose tile-level test passed.
    """
    rt, cs, st = shape.ray_tile, shape.cluster_size, shape.sub_tiles
    rs = rt // st
    dev = inp.origin.device
    lanes = inp.origin.shape[1]
    tiles = lanes // rt
    o = inp.origin.reshape(3, tiles, rt)
    d = inp.direction.reshape(3, tiles, rt)
    m = torch.stack([
        d[1] * o[2] - d[2] * o[1],
        d[2] * o[0] - d[0] * o[2],
        d[0] * o[1] - d[1] * o[0],
    ])
    tmin = inp.tmin.reshape(tiles, rt)
    best = (
        torch.full((tiles, rt), _BIG, dtype=torch.float32, device=dev),
        torch.zeros((tiles, rt), dtype=torch.int32, device=dev),
        torch.zeros((tiles, rt), dtype=torch.float32, device=dev),
        torch.zeros((tiles, rt), dtype=torch.float32, device=dev),
    )
    stats = torch.zeros((tiles, 2), dtype=torch.int32, device=dev)
    sub = torch.arange(rt, device=dev) // rs
    ar_cs = torch.arange(cs, dtype=torch.int32, device=dev)

    def run(tsel, src, cols, ids, gate):
        # tsel [n] tile ids; cols [n, W] columns of src; ids [n, W] their
        # triangle ids; gate -> [n, rt, W]
        n, w = cols.shape
        f = src[:, cols.reshape(-1).long()].reshape(16, n, 1, w)
        b = tuple(x[tsel] for x in best)
        _mt_window(o[:, tsel, :, None], d[:, tsel, :, None], m[:, tsel, :, None],
                   tmin[tsel][..., None], f, gate, ids[:, None, :], b)
        for x, y in zip(best, b):
            x[tsel] = y

    sweep = inp.meta[:, 1] != 0
    if shape.k_max > 0:
        g = shape.mt_group if shape.mt_union else 1
        resident = shape.resident_cap > 0
        src = inp.live_pack if resident else inp.tri_pack
        count = inp.meta[:, 0]
        n_win = (count + g - 1) // g
        cand_tiles = torch.nonzero(~sweep).reshape(-1)
        stats[cand_tiles] = count[cand_tiles, None].expand(-1, 2)
        max_win = int(n_win[cand_tiles].max()) if cand_tiles.numel() else 0
        ar_g = torch.arange(g, device=dev)
        for s in range(max_win):
            act = cand_tiles[n_win[cand_tiles] > s]
            for tsel in act.split(tile_chunk):
                n = len(tsel)
                slots = inp.cand[tsel, g * s : g * s + g]
                wbits = inp.bits[tsel, g * s : g * s + g]
                uni = wbits[:, 0]
                for k in range(1, g):
                    uni = uni | wbits[:, k]
                gate = (torch.bitwise_right_shift(uni[:, None], sub[None, :]) & 1) != 0
                if shape.mt_prune:
                    em = inp.ent[tsel, g * s : g * s + g].amin(1).to(torch.float32)
                    bmax = best[0][tsel].reshape(n, st, rs).amax(-1)
                    gate = gate & (em[:, None] <= bmax * 16.0)[:, sub]
                real = (g * s + ar_g)[None, :] < count[tsel, None]  # [n, g]
                cols = (slots[:, :, None] * cs + ar_cs).reshape(n, g * cs)
                ids = cols
                if resident:
                    ids = (inp.live_tab[slots.long()][:, :, None] * cs + ar_cs).reshape(n, g * cs)
                gate = gate[..., None] & real.repeat_interleave(cs, dim=1)[:, None, :]
                run(tsel, src, cols, ids, gate)
    else:
        sweep = torch.ones_like(sweep)

    sweep_tiles = torch.nonzero(sweep).reshape(-1)
    if sweep_tiles.numel():
        n = sweep_tiles.numel()
        so = o[:, sweep_tiles].reshape(3, -1)
        sd = d[:, sweep_tiles].reshape(3, -1)
        stmin = tmin[sweep_tiles].reshape(-1)
        alive = (sd[0] * sd[0] + sd[1] * sd[1] + sd[2] * sd[2]) > 0.0
        visits = torch.zeros(n, dtype=torch.int32, device=dev)
        hits = torch.zeros(n, dtype=torch.int32, device=dev)

        def passes(bmn, bmx, act):
            """[n, rt]: the swept tiles' rays that pass one box's slab test
            with their running bests, on the tiles in ``act`` [n]."""
            bt = best[0][sweep_tiles].reshape(-1, 1)
            ov = _slab_rays(so, sd, stmin, alive, bmn[None], bmx[None], bt)
            return ov.reshape(n, rt) & act[:, None]

        gs, ss = shape.group_size, shape.super_size
        g_order = inp.g_order.tolist()
        every = torch.ones(n, dtype=torch.bool, device=dev)
        for sg in inp.s_order.tolist():
            act_s = passes(inp.s_mn[sg], inp.s_mx[sg], every).any(1)
            if not bool(act_s.any()):
                continue
            if ss == 1:
                visits += act_s  # the supergroup box is the group box
            for grp in [sg] if ss == 1 else g_order[sg * ss : (sg + 1) * ss]:
                act = act_s
                if ss > 1:
                    act = passes(inp.g_mn[grp], inp.g_mx[grp], act_s).any(1)
                    if not bool(act.any()):
                        continue
                    visits += act
                for c in range(grp * gs, (grp + 1) * gs):
                    ov = passes(inp.mn[c], inp.mx[c], act)
                    hit = ov.any(1)
                    sel = torch.nonzero(hit).reshape(-1)
                    if not sel.numel():
                        continue
                    hits += hit
                    gate = ov[sel].reshape(-1, st, rs).any(2)[:, sub]  # [k, rt]
                    cols = (c * cs + ar_cs).expand(len(sel), cs)
                    run(sweep_tiles[sel], inp.tri_pack, cols, cols, gate[..., None])
        stats[sweep_tiles] = torch.stack([visits, hits], 1)
    t, tri, beta, gamma = (x.reshape(-1) for x in best)
    shade = None
    if shape.emit_shade:
        shade = torch.where((t < _BIG)[None], inp.shade_pack[tri.long()].T, 0.0)
    return t, tri, beta, gamma, shade, stats


# ---------------------------------------------------------------------------
# CUDA kernel binding

_CSRC = Path(__file__).resolve().parent / "csrc" / "mt_traverse.cu"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "rts_tpu_torch"
_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the traversal kernel is built from source at first use")


def build_kernel(verbose: bool = False) -> Path:
    """Compile ``csrc/mt_traverse.cu`` for sm_90a into ``build/rts_tpu_torch``
    (once per source hash) and return the shared library's path.
    ``verbose`` adds ``-Xptxas -v`` and prints the compiler's report."""
    src = _CSRC.read_bytes()
    tag = hashlib.sha256(src + " ".join(_NVCC_FLAGS).encode()).hexdigest()[:16]
    out = _BUILD_DIR / f"libmt_traverse_{tag}.so"
    if out.exists() and not verbose:
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *_NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ()), "-o", tmp, str(_CSRC)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    if verbose:
        print(proc.stderr.strip())
    os.replace(tmp, out)  # atomic: a concurrent build never sees a partial file
    return out


class _Kernel:
    """Loaded library (one per process) and the launch counter."""

    lib = None


def _load():
    if _Kernel.lib is None:
        lib = ctypes.CDLL(str(build_kernel()))
        fn = lib.mt_traverse_launch
        fn.argtypes = [ctypes.c_void_p] * 27 + [ctypes.c_int] * 15 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.mt_traverse_sweep_words.argtypes = [ctypes.c_int] * 3
        lib.mt_traverse_sweep_words.restype = ctypes.c_int
        _Kernel.lib = lib
    return _Kernel.lib


def _check(name, x, dtype, shape, device):
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise ValueError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _mt_traverse_cuda(inp: TraversalInputs, shape: TraversalShape):
    dev = inp.origin.device
    rt, cs = shape.ray_tile, shape.cluster_size
    lanes = inp.origin.shape[1]
    tiles = lanes // rt
    n_tris = inp.tri_pack.shape[1]
    cp = inp.mn.shape[0]
    n_groups = cp // shape.group_size
    n_super = n_groups // shape.super_size
    k_width = inp.cand.shape[1]
    cap = shape.resident_cap
    f32, i32 = torch.float32, torch.int32
    if not (32 <= rt <= 1024 and lanes == tiles * rt):
        raise ValueError(f"ray_tile must be in [32, 1024] and divide the lanes; got {rt}, {lanes}")
    if not 1 <= shape.sub_tiles <= 32:
        raise ValueError(f"sub_tiles must be in [1, 32]; got {shape.sub_tiles}")
    # a block of either grid is one sub-block of rs rays, or one warp of
    # 32 / rs sub-blocks; a window's or cluster's columns are copied four at
    # a time (16 bytes), so every pack row must start 16-B aligned
    rs = rt // shape.sub_tiles
    if rs < 32 and (32 % rs or rt % 32):
        raise ValueError(f"ray_tile / sub_tiles ({rs}) below 32 must divide 32, with ray_tile a "
                         f"multiple of 32; got ray_tile={rt}, sub_tiles={shape.sub_tiles}")
    if cs % 4 or n_tris % cs:
        raise ValueError(f"cluster_size must be a multiple of 4 that divides the tri_pack's "
                         f"{n_tris} columns; got {cs}")
    for name, shp, dt in (
        ("origin", (3, lanes), f32), ("direction", (3, lanes), f32), ("tmin", (lanes,), f32),
        ("tri_pack", (16, n_tris), f32), ("mn", (cp, 3), f32), ("mx", (cp, 3), f32),
        ("g_mn", (n_groups, 3), f32), ("g_mx", (n_groups, 3), f32),
        ("s_mn", (n_super, 3), f32), ("s_mx", (n_super, 3), f32),
        ("s_order", (n_super,), i32), ("g_order", (n_groups,), i32),
        ("cand", (tiles, k_width), i32), ("meta", (tiles, 2), i32), ("bits", (tiles, k_width), i32),
        ("ent", (tiles, k_width), i32),
        ("shade_pack", (n_tris if shape.emit_shade else 0, 10), f32),
        ("live_pack", (16, cap * cs), f32), ("live_tab", (cap,), i32),
    ):
        _check(name, getattr(inp, name), dt, shp, dev)
    for name in ("tri_pack", "live_pack"):
        if getattr(inp, name).data_ptr() % 16:  # a view at an odd offset: the 16-byte copies need 16 B
            inp = inp._replace(**{name: getattr(inp, name).clone()})
    # K6 is K1 with windows of one cluster and no tail
    g, tail = (shape.mt_group, shape.mt_tail) if shape.mt_union else (1, False)
    out_t = torch.empty(lanes, dtype=f32, device=dev)
    out_tri = torch.empty(lanes, dtype=i32, device=dev)
    out_b = torch.empty(lanes, dtype=f32, device=dev)
    out_g = torch.empty(lanes, dtype=f32, device=dev)
    out_shade = torch.empty((10, lanes) if shape.emit_shade else (0,), dtype=f32, device=dev)
    out_stats = torch.empty((tiles, 2), dtype=i32, device=dev)
    lib = _load()
    # the swept tiles' bitmaps of the groups and clusters their sub-blocks passed
    sweep_bits = torch.zeros(lib.mt_traverse_sweep_words(tiles, cp, shape.group_size), dtype=i32,
                             device=dev)
    if mt_traverse.sweep_counts.device != dev:
        mt_traverse.sweep_counts = torch.zeros(2, dtype=i32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.mt_traverse_launch(
            *(x.data_ptr() for x in inp), out_t.data_ptr(), out_tri.data_ptr(),
            out_b.data_ptr(), out_g.data_ptr(), out_shade.data_ptr(), out_stats.data_ptr(),
            sweep_bits.data_ptr(), mt_traverse.sweep_counts.data_ptr(),
            tiles, rt, n_tris, cp, cs, shape.group_size, shape.super_size,
            shape.sub_tiles, shape.k_max, k_width, g, int(tail),
            int(shape.mt_prune), int(shape.emit_shade), cap, stream,
        )
    if err != 0:
        raise RuntimeError(f"mt_traverse kernel launch failed: cudaError {err}")
    mt_traverse.launches += 1
    for mode, on in (("K3", shape.mt_prune), ("K4", shape.emit_shade), ("K5", cap > 0),
                     ("K6", shape.k_max > 0 and not shape.mt_union)):
        mt_traverse.mode_launches[mode] += int(on)
    return out_t, out_tri, out_b, out_g, out_shade if shape.emit_shade else None, out_stats


def mt_traverse(inp: TraversalInputs, shape: TraversalShape):
    """Phase 2: (t, tri, beta, gamma, shade) per lane, t = 3e38 where no
    hit, shade [10, lanes] under ``shape.emit_shade``, else None; and the
    per-tile work counters ``stats`` [tiles, 2] int32.

    CUDA tensors launch ``csrc/mt_traverse.cu`` (the sweep grid and, when
    ``k_max > 0``, beside it the candidate grid, each one block per ray
    sub-block) and count the call in ``mt_traverse.launches`` (every
    call) and ``mt_traverse.mode_launches`` (calls with the K3 prune, the
    K4 shade epilogue, the K5 live pack, the K6 per-candidate windows):
    one count per call, whatever number of grids it launches.  Which tiles
    sweep (K2) is known only on the device, so the sweep counts itself
    there: ``mt_traverse.sweep_counts`` is an int32 tensor [2] on the last
    CUDA call's device that the kernel adds to, (calls that swept a tile,
    swept tiles).  CPU tensors run ``mt_traverse_reference``.
    ``mt_traverse.resident_overflows`` is a 0-d int32 tensor on the last K5
    call's device that counts the ``closest_hit_clustered`` calls whose
    live set overflowed the cap (every tile then sweeps).  Both are added
    to without a host read.
    """
    kind = inp.origin.device.type
    if kind == "cuda":
        return _mt_traverse_cuda(inp, shape)
    if kind == "cpu":
        return mt_traverse_reference(inp, shape)
    raise ValueError(f"mt_traverse runs on CUDA or CPU tensors, got {kind}")


mt_traverse.launches = 0
mt_traverse.mode_launches = {"K3": 0, "K4": 0, "K5": 0, "K6": 0}
mt_traverse.resident_overflows = torch.zeros((), dtype=torch.int32)
mt_traverse.sweep_counts = torch.zeros(2, dtype=torch.int32)


def closest_hit_clustered(
    origin,  # [3, L]
    direction,  # [3, L]
    tmin,  # [L]
    tri_pack,  # [16, T] packed fields, T = C * cluster_size
    aabb_mn,  # [C, 3]
    aabb_mx,  # [C, 3]
    sort_origin=None,  # [3] — visit groups near-to-far from here (the Tx)
    *,
    cluster_size: int = 256,
    ray_tile: int = 256,
    group_size: int = 8,
    super_size: int = 8,
    sub_tiles: int = 4,
    candidates: int = 64,
    mt_group: int = 2,
    mt_union: bool = True,
    mt_tail: bool = False,
    mt_prune: bool = False,
    cand_order: str = "near",
    p1_fanout: int | None = None,
    p1_super_k: int | None = None,
    p1_fanout0: int | None = None,
    p1_super_k0: int | None = None,
    resident_cap: int = 0,
    emit_shade: bool = False,
    shade_pack=None,  # [T, 10] winner shade rows, required by emit_shade
    with_stats: bool = False,
    traverse=None,  # phase-2 function; default mt_traverse
):
    """Closest valid triangle per ray via clustered traversal (float32).

    Rays are components-major ([3, L], the engine layout: the JAX
    function's ``components=True``).  The wrapper logic is the JAX one:
    outward f32 narrowing of wider boxes, ``+inf`` sentinel padding of the
    cluster list, group and supergroup boxes, near-to-far visit orders
    from ``sort_origin``, lane padding to whole tiles, phase 1, phase 2.
    ``traverse`` swaps the phase-2 function (``mt_traverse_reference``
    runs the plain version on any device).

    ``emit_shade`` returns ``HitResult.shade`` [10, L], the winner's row
    of ``shade_pack`` (zeros where no triangle won).  The JAX kernel
    carries those rows in a 32-row ``tri_pack`` for its DMA tiling; here
    the pack keeps its 16 geometry rows and the kernel's epilogue reads
    the winner's row of ``shade_pack`` from device memory.

    ``resident_cap > 0`` (with candidates) gathers the columns of the
    tiles' live clusters, up to ``resident_cap`` of them, into one
    compacted pack that the candidate windows read (K5); on this card the
    pack lives in device memory like the global one.  A live set over the
    cap sends every tile to the sweep.  ``mt_union=False`` evaluates one
    window per candidate (K6).  Both give the default's result bit for
    bit.  ``with_stats`` returns ``(hit, stats)``, stats the int32
    [tiles, 2] work counters of ``mt_traverse``.
    """
    dev = origin.device
    l = origin.shape[1]
    t_total = tri_pack.shape[1]
    if tri_pack.shape[0] != 16:
        raise ValueError(f"tri_pack must have 16 rows; got {tri_pack.shape[0]}")
    if t_total % cluster_size:
        raise ValueError(
            f"tri_pack columns ({t_total}) must be a multiple of cluster_size ({cluster_size})"
        )
    if ray_tile % sub_tiles:
        raise ValueError(f"ray_tile ({ray_tile}) must be divisible by sub_tiles ({sub_tiles})")
    c = t_total // cluster_size
    if aabb_mn.shape[0] != c or aabb_mx.shape[0] != c:
        raise ValueError(f"AABB rows ({aabb_mn.shape[0]}) != cluster count ({c})")
    if emit_shade and (shade_pack is None or tuple(shade_pack.shape) != (t_total, 10)):
        raise ValueError(f"emit_shade needs shade_pack [{t_total}, 10]; got "
                         f"{None if shade_pack is None else tuple(shade_pack.shape)}")
    if mt_group not in (1, 2, 4, 8, 16, 32):
        raise ValueError(f"mt_group must be 1/2/4/8/16/32, got {mt_group}")
    if candidates > 0:
        mt_group = min(mt_group, candidates)
        if candidates % mt_group:
            raise ValueError(f"candidates ({candidates}) must be a multiple of mt_group ({mt_group})")
    resident = resident_cap > 0 and candidates > 0
    if resident:
        # rts_tpu's VMEM budget for the live pack, counted at its pack's
        # rows (32 with the shade rows), so that both packages accept the
        # same configurations
        live_bytes = resident_cap * cluster_size * (32 if emit_shade else 16) * 4
        if live_bytes > _LIVE_PACK_MAX:
            raise ValueError(
                f"resident_cap={resident_cap} makes a {live_bytes / 1e6:.1f} MB live pack "
                f"({resident_cap} x {cluster_size} columns f32), over the "
                f"{_LIVE_PACK_MAX / 1e6:.0f} MB that rts_tpu allows; lower resident_cap or "
                "cluster_size"
            )
    rt = ray_tile
    f32 = torch.float32

    # narrow wider boxes to f32 OUTWARD, so a box never shrinks below its
    # (independently rounded) triangles
    if aabb_mn.dtype != f32:
        mn32, mx32 = aabb_mn.to(f32), aabb_mx.to(f32)
        aabb_mn = torch.where(mn32.to(aabb_mn.dtype) > aabb_mn,
                              torch.nextafter(mn32, torch.full_like(mn32, -_INF)), mn32)
        aabb_mx = torch.where(mx32.to(aabb_mx.dtype) < aabb_mx,
                              torch.nextafter(mx32, torch.full_like(mx32, _INF)), mx32)

    # pad the cluster list to a group*supergroup multiple with [+inf, +inf]
    # boxes, which every slab test rejects (an inverted box would not be)
    gs, ss = group_size, super_size
    c_pad = -(-c // (gs * ss)) * (gs * ss)
    if c_pad > c:
        pad = torch.full((c_pad - c, 3), _INF, dtype=f32, device=dev)
        aabb_mn = torch.cat([aabb_mn, pad])
        aabb_mx = torch.cat([aabb_mx, pad])
    n_groups = c_pad // gs
    n_super = n_groups // ss
    g_mn = aabb_mn.reshape(n_groups, gs, 3).amin(1)
    g_mx = aabb_mx.reshape(n_groups, gs, 3).amax(1)
    s_mn = g_mn.reshape(n_super, ss, 3).amin(1)
    s_mx = g_mx.reshape(n_super, ss, 3).amax(1)
    i32 = torch.int32
    if sort_origin is None:
        s_order = torch.arange(n_super, dtype=i32, device=dev)
        g_order = torch.arange(n_groups, dtype=i32, device=dev)
    else:
        so = torch.as_tensor(sort_origin, dtype=f32, device=dev)

        def dist2(bmn, bmx):
            q = (bmn + bmx) * 0.5 - so
            dd = q[:, 0] * q[:, 0] + q[:, 1] * q[:, 1] + q[:, 2] * q[:, 2]
            # never-overlapping (all-padding) boxes go last
            return torch.where(torch.isfinite(dd) & (bmn[:, 0] <= bmx[:, 0]), dd, _INF)

        s_order = torch.argsort(dist2(s_mn, s_mx), stable=True).to(i32)
        local = torch.argsort(dist2(g_mn, g_mx).reshape(n_super, ss), dim=1, stable=True)
        base_i = (torch.arange(n_super, device=dev) * ss)[:, None]
        g_order = (base_i + local).reshape(-1).to(i32)

    l_pad = -(-l // rt) * rt
    origin, direction, tmin = origin.to(f32), direction.to(f32), tmin.to(f32)
    if l_pad > l:
        z3 = torch.zeros((3, l_pad - l), dtype=f32, device=dev)
        origin = torch.cat([origin, z3], 1)
        direction = torch.cat([direction, z3], 1)
        tmin = torch.cat([tmin, torch.zeros(l_pad - l, dtype=f32, device=dev)])
    n_tiles = l_pad // rt
    if candidates > 0:
        cand, meta, bits, ent = _tile_candidates(
            origin, direction, tmin, aabb_mn, aabb_mx, rt, sub_tiles, candidates,
            cand_order, p1_fanout, p1_super_k, p1_fanout0, p1_super_k0,
        )
    else:
        # sweep-only: dummy lists, the overflow flag sends every tile to the sweep
        cand = torch.zeros((n_tiles, 1), dtype=i32, device=dev)
        meta = torch.tensor([[0, 1]], dtype=i32, device=dev).repeat(n_tiles, 1)
        bits = torch.zeros((n_tiles, 1), dtype=i32, device=dev)
        ent = torch.zeros((n_tiles, 1), dtype=i32, device=dev)
    if emit_shade:
        shade_pack = shade_pack.to(f32).contiguous()
    else:
        shade_pack = torch.zeros((0, 10), dtype=f32, device=dev)
    tri_pack = tri_pack.to(f32).contiguous()
    if resident:
        cand, meta, live_pack, live_tab = _live_set(cand, meta, tri_pack, resident_cap, c, cluster_size)
    else:
        live_pack = torch.zeros((16, 0), dtype=f32, device=dev)
        live_tab = torch.zeros((0,), dtype=i32, device=dev)
    inp = TraversalInputs(
        origin.contiguous(), direction.contiguous(), tmin.contiguous(),
        tri_pack, aabb_mn.contiguous(), aabb_mx.contiguous(),
        g_mn.contiguous(), g_mx.contiguous(), s_mn.contiguous(), s_mx.contiguous(),
        s_order.contiguous(), g_order.contiguous(), cand, meta, bits, ent, shade_pack,
        live_pack, live_tab,
    )
    shape = TraversalShape(rt, cluster_size, gs, ss, sub_tiles, candidates, mt_group, mt_tail,
                           bool(mt_prune and candidates > 0), bool(emit_shade),
                           bool(mt_union or candidates <= 0), resident_cap if resident else 0)
    best_t, best_tri, best_b, best_g, shade, stats = (traverse or mt_traverse)(inp, shape)
    best_t = best_t[:l]
    found = best_t < RT_DEFAULT_MAX
    hit = HitResult(
        t=torch.where(found, best_t, _INF),
        tri=best_tri[:l],
        beta=best_b[:l],
        gamma=best_g[:l],
        found=found,
        shade=None if shade is None else shade[:, :l],
    )
    return (hit, stats) if with_stats else hit
