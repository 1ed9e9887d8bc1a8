"""The port's brute-force intersector against rts_tpu's.

``rts_tpu_torch.engine.intersect.closest_hit_bruteforce`` and
``rts_tpu.engine.intersect.closest_hit_bruteforce`` get the same
numpy-seeded rays and per-triangle vectors (derived once in float64, then
rounded to the engine dtype), so the comparison isolates the intersector:
the hit triangle and found mask must be identical, t/beta/gamma agree to
1e-12 in float64 and 5e-6 in float32 (XLA's CPU backend contracts the
MT numerators into FMAs under jit; PyTorch does not).  Cases: T not a
multiple of the chunk, an exact t tie inside one chunk and one across
chunks (the first triangle wins both), all-zero padding triangles (never
hit) and rays that miss.  ``derive_tri_arrays``/``scene_to_device`` are
held to rts_tpu's on a compiled scene.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rts_tpu.engine.intersect import closest_hit_bruteforce as j_brute
from rts_tpu.engine.types import scene_to_device as j_scene_to_device
from rts_tpu.geometry import rect_mesh, sphere_mesh
from rts_tpu.geometry.scene import compile_scene

from rts_tpu_torch import convert
from rts_tpu_torch.engine.intersect import closest_hit_bruteforce
from rts_tpu_torch.engine.types import scene_to_device

torch.set_num_threads(1)

DEVICE = "cpu"  # the port's entry points default to the card
CHUNK = 64
TOL = {np.float64: 1e-12, np.float32: 5e-6}
_j_brute = jax.jit(j_brute, static_argnames="tri_chunk")


def _derive(verts):
    """(p0, e0, e1, n, c1, c0, np0) in float64 NumPy."""
    p0 = verts[:, 0]
    e0 = verts[:, 1] - verts[:, 0]
    e1 = verts[:, 0] - verts[:, 2]
    n = np.cross(e1, e0)
    return p0, e0, e1, n, np.cross(p0, e1), np.cross(p0, e0), (n * p0).sum(-1)


def _soup(case, rng):
    """Triangles [T, 3, 3] and rays (origin, direction, tmin) for a case,
    with the indices of triangles that tie (None when no tie is built)."""
    t_count = 331  # not a multiple of CHUNK
    centres = rng.uniform(-50.0, 50.0, (t_count, 3)) + np.array([400.0, 0.0, 0.0])
    verts = centres[:, None, :] + rng.uniform(-6.0, 6.0, (t_count, 3, 3))
    tie = None
    if case == "tie_in_chunk":
        tie = (70, 75)  # both in chunk 1
    elif case == "tie_across_chunks":
        tie = (70, 70 + 2 * CHUNK)
    if tie:
        verts[tie[1]] = verts[tie[0]]
        # push every other triangle far behind, so the pair is the nearest hit
        keep = np.zeros(t_count, bool)
        keep[list(tie)] = True
        verts[~keep] += np.array([300.0, 0.0, 0.0])
    if case == "padding":
        verts[::3] = 0.0  # all-zero triangles, as compile_scene pads
    r = 192
    origin = rng.uniform(-5.0, 5.0, (r, 3))
    # aim at triangle interiors (hits), plus a block aimed away (misses)
    pick = rng.integers(0, t_count, r) if tie is None else np.full(r, tie[0])
    bary = rng.dirichlet(np.ones(3), r)
    target = np.einsum("rc,rcx->rx", bary, verts[pick])
    direction = target - origin
    if case == "miss":
        direction[r // 2:] *= -1.0
    direction /= np.linalg.norm(direction, axis=1, keepdims=True)
    tmin = rng.uniform(0.0, 1e-3, r)
    return verts, (origin, direction, tmin), tie


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("case", ["random", "tie_in_chunk", "tie_across_chunks", "padding", "miss"])
def test_brute_matches_rts_tpu(case, dtype):
    rng = np.random.default_rng(sum(map(ord, case)))
    verts, rays, tie = _soup(case, rng)
    tris = [a.astype(dtype) for a in _derive(verts)]
    rays = [a.astype(dtype) for a in rays]
    ref = _j_brute(*(jnp.asarray(a) for a in rays + tris), tri_chunk=CHUNK)
    got = closest_hit_bruteforce(*(torch.as_tensor(a) for a in rays + tris), tri_chunk=CHUNK)
    np.testing.assert_array_equal(got.found.numpy(), np.asarray(ref.found))
    np.testing.assert_array_equal(got.tri.numpy(), np.asarray(ref.tri))
    assert got.tri.dtype == torch.int32 and got.t.dtype == getattr(torch, np.dtype(dtype).name)
    f = np.asarray(ref.found)
    tol = TOL[dtype]
    for name in ("t", "beta", "gamma"):
        np.testing.assert_allclose(getattr(got, name).numpy()[f], np.asarray(getattr(ref, name))[f],
                                   rtol=tol, atol=tol, err_msg=name)
    assert np.isinf(got.t.numpy()[~f]).all()
    if case == "miss":
        assert f[: len(f) // 2].mean() > 0.5 and not f[len(f) // 2:].any()
    elif case == "padding":
        assert f.mean() > 0.5 and (got.tri.numpy()[f] % 3 != 0).all()
    elif tie:
        assert f.all() and (got.tri.numpy() == tie[0]).all()  # the first of the pair
    else:
        assert f.mean() > 0.5


@pytest.mark.parametrize("dtype", [jnp.float64, jnp.float32], ids=["f64", "f32"])
def test_scene_to_device_matches_rts_tpu(dtype):
    plate = rect_mesh(2.0, 40.0, 30.0, yaw=0.3).translated([500.0, 20.0, 0.0])
    ball, _ = sphere_mesh(1, 12.0)
    scene = compile_scene([plate, ball.translated([700.0, -30.0, 5.0])], [0.9, 0.7], [1.0, 1.5],
                          [np.array([5.0, 0.0, 1.0]), np.zeros(3)], pad_to=64)
    ref = convert.device_scene(j_scene_to_device(scene, dtype=dtype), device=DEVICE)
    got = scene_to_device(scene, dtype=getattr(torch, jnp.dtype(dtype).name), device=DEVICE)
    tol = 1e-15 if dtype == jnp.float64 else 1e-6
    for name, a, b in zip(got._fields, got, ref):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        if a.dtype.is_floating_point:
            scale = float(b.abs().max()) or 1.0
            assert float((a - b).abs().max()) <= tol * scale, name
        else:
            assert torch.equal(a, b), name
