"""The port's C++ host runtime (``rts_tpu_torch.native``) against
``rts_tpu.native`` and the NumPy paths, as ``tests/test_native.py`` holds
``rts_tpu``'s; and its two callers, ``accel.cluster.morton_order`` and
``geometry.filemesh._read_triplets``, with the library and without it
(``RTS_NO_NATIVE``).  Every test skips, as ``tests/test_native.py``'s do,
when no library builds; that is decided in a fixture, at run time.
"""

import numpy as np
import pytest

from rts_tpu import native as j_native
from rts_tpu_torch import native
from rts_tpu_torch.accel.cluster import _expand_bits, morton_order
from rts_tpu_torch.geometry import filemesh, sphere_mesh, terrain_mesh


@pytest.fixture(autouse=True)
def _library():
    if not native.available():
        pytest.skip("native lib not built")


def _numpy_morton(tv: np.ndarray) -> np.ndarray:
    c = tv.mean(axis=1)
    lo = c.min(axis=0)
    span = c.max(axis=0) - lo
    span[span == 0] = 1.0
    q = np.clip(((c - lo) / span) * 1023.0, 0, 1023).astype(np.uint64)
    code = (_expand_bits(q[:, 0]) << np.uint64(2)) | (_expand_bits(q[:, 1]) << np.uint64(1)) | _expand_bits(q[:, 2])
    return np.argsort(code, kind="stable")


def test_library_builds_outside_the_source_tree():
    path = native.build()
    assert path is not None and path.parent.name == "rts_tpu_torch" and path.parent.parent.name == "build"


def test_icosphere_equals_rts_tpu_and_invariants():
    v, t, n = native.icosphere(3, 2.5)
    assert v.shape == (642, 3) and t.shape == (1280, 3)
    np.testing.assert_allclose(np.linalg.norm(v, axis=1), 2.5, rtol=1e-12)
    np.testing.assert_allclose(np.linalg.norm(n, axis=1), 1.0, rtol=1e-12)
    assert v.shape[0] - (t.shape[0] * 3 // 2) + t.shape[0] == 2  # closed manifold
    if j_native.available():
        for got, ref in zip(native.icosphere(2, 1.0, yaw=0.3, pitch=-0.2, roll=0.7),
                            j_native.icosphere(2, 1.0, yaw=0.3, pitch=-0.2, roll=0.7)):
            np.testing.assert_array_equal(got, ref)


def test_icosphere_rotation_matches_rotzyx():
    from rts_tpu_torch.core.rotation import vertex_rotation

    v0, t0, _ = native.icosphere(2, 1.0)
    v1, t1, _ = native.icosphere(2, 1.0, yaw=0.3, pitch=-0.2, roll=0.7)
    np.testing.assert_array_equal(t0, t1)
    np.testing.assert_allclose(v1, vertex_rotation(v0, 0.3, -0.2, 0.7, strict_parity=False), atol=1e-12)


@pytest.mark.parametrize("seed", [1, 2])
def test_morton_equals_numpy_and_rts_tpu(seed):
    tv = np.random.default_rng(seed).uniform(-100, 100, (4096, 3, 3))
    got = native.morton_order(tv)
    np.testing.assert_array_equal(got, _numpy_morton(tv))
    if j_native.available():
        np.testing.assert_array_equal(got, j_native.morton_order(tv))


def test_morton_order_with_and_without_native(monkeypatch):
    """morton_order's native leg and NumPy leg give the same permutation,
    with the stable target-major re-sort, on a terrain and two spheres."""
    terrain = terrain_mesh(40, 1500.0, 300.0, seed=3)
    ball, _ = sphere_mesh(3, 20.0)
    tris = [m.verts[m.tris] for m in (terrain, ball, ball.translated([50.0, 0.0, 0.0]))]
    tv = np.concatenate(tris)
    target = np.concatenate([np.full(len(t), k, np.int32) for k, t in enumerate(tris)])
    with_native = [morton_order(tv), morton_order(tv, target)]
    monkeypatch.setenv("RTS_NO_NATIVE", "1")
    assert not native.available() and native.morton_order(tv) is None
    without = [morton_order(tv), morton_order(tv, target)]
    for a, b in zip(with_native, without):
        np.testing.assert_array_equal(a, b)
    assert (target[with_native[1]] == np.sort(target)).all()  # target-major


def test_flatten_matches_fancy_indexing():
    rng = np.random.default_rng(2)
    verts = rng.normal(size=(500, 3))
    tris = rng.integers(0, 500, (900, 3)).astype(np.int32)
    np.testing.assert_array_equal(native.flatten(verts, tris), verts[tris])
    perm = rng.permutation(900)
    np.testing.assert_array_equal(native.flatten(verts, tris, perm), verts[tris[perm]])
    with pytest.raises(ValueError, match="past the vertices"):
        native.flatten(verts[:10], tris)


def test_loader_trailing_commas_and_rts_tpu(tmp_path):
    p = tmp_path / "v.txt"
    p.write_text("1 2 3, 4 5 6, 7 8 9,\n10 11 12, 13 14 15, 16 17 18,\n")
    out = native.load_triplets(str(p))
    np.testing.assert_array_equal(out, np.arange(1, 19).reshape(6, 3))
    if j_native.available():
        np.testing.assert_array_equal(out, j_native.load_triplets(str(p)))


def test_read_triplets_with_and_without_native(tmp_path, monkeypatch):
    """A mesh written by write_mesh_files reads back the same through the
    native loader and the NumPy parser."""
    mesh, _ = sphere_mesh(2, 7.5)
    v_file, n_file = str(tmp_path / "v.txt"), str(tmp_path / "n.txt")
    filemesh.write_mesh_files(mesh, v_file, n_file)
    native_vals = [filemesh._read_triplets(f) for f in (v_file, n_file)]
    np.testing.assert_array_equal(native_vals[0], native.load_triplets(v_file))
    monkeypatch.setenv("RTS_NO_NATIVE", "1")
    for f, got in zip((v_file, n_file), native_vals):
        np.testing.assert_array_equal(got, filemesh._read_triplets(f))
    np.testing.assert_array_equal(native_vals[0], mesh.verts[mesh.tris].reshape(-1, 3))
