"""The eight ``core/vec`` helpers the port added (``cart_to_sph``,
``cross3c``, ``dot3``, ``length3``, ``mag_squared3``, ``reflect3``,
``refract3``, ``triangle_area``) against ``rts_tpu.core.vec``.

Inputs are seeded normal draws (no subnormal: XLA's CPU backend flushes
them, PyTorch does not).  Both sides perform the same operations in the
same order, so the results agree to rounding: each is held to 2 ulp of
its dtype, exactly where noted, and a refracted unit vector to 4 ulp of
1.  The JAX helpers run eagerly (no jit,
so XLA does not contract products into FMAs).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rts_tpu.core import vec as jv
from rts_tpu_torch.core import vec as tv

torch.set_num_threads(1)

MAXULP = 2  # PyTorch's CPU atan2 and sqrt against XLA's: within 2 ulp (ROADMAP C)


def _draw(seed: int, shape, dtype):
    x = np.random.default_rng(seed).normal(size=shape)
    return x.astype(dtype)


def _both(fn_t, fn_j, *arrays):
    got = fn_t(*(torch.from_numpy(a) for a in arrays))
    ref = fn_j(*(jnp.asarray(a) for a in arrays))
    return got, ref


def _close(got, ref, dtype):
    ref = np.asarray(ref)
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.dtype == ref.dtype == dtype
    np.testing.assert_array_max_ulp(got, ref, maxulp=MAXULP)


DTYPES = [np.float32, np.float64]


@pytest.mark.parametrize("dtype", DTYPES)
def test_dot_length_magnitude(dtype):
    a, b = _draw(0, (257, 3), dtype), _draw(1, (257, 3), dtype)
    _close(*_both(tv.dot3, jv.dot3, a, b), dtype)
    _close(*_both(tv.mag_squared3, jv.mag_squared3, a), dtype)
    _close(*_both(tv.length3, jv.length3, a), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_cross3c_components_major(dtype):
    a, b = _draw(2, (3, 4, 65), dtype), _draw(3, (3, 4, 65), dtype)
    got, ref = _both(tv.cross3c, jv.cross3c, a, b)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))  # products and a subtraction: exact
    np.testing.assert_array_equal(tv.cross3c(torch.from_numpy(a), torch.from_numpy(b)).movedim(0, -1).numpy(),
                                  tv.cross3(torch.from_numpy(a).movedim(0, -1), torch.from_numpy(b).movedim(0, -1)))


@pytest.mark.parametrize("dtype", DTYPES)
def test_cart_to_sph(dtype):
    v = _draw(4, (5, 111, 3), dtype)
    got, ref = _both(tv.cart_to_sph, jv.cart_to_sph, v)
    assert got.shape == (5, 111, 2)
    _close(got, ref, dtype)
    back = tv.sph_to_cart(got[..., 0], got[..., 1]) * torch.from_numpy(v).norm(dim=-1, keepdim=True)
    np.testing.assert_allclose(back.numpy(), v, rtol=1e-4 if dtype == np.float32 else 1e-12, atol=1e-5)


@pytest.mark.parametrize("dtype", DTYPES)
def test_reflect3(dtype):
    i = _draw(5, (300, 3), dtype)
    n = _draw(6, (300, 3), dtype)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    _close(*_both(tv.reflect3, jv.reflect3, i, n), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_refract3(dtype):
    """Both sides of the surface, indices above and below 1 (total
    internal reflection on some lanes: a zero direction and ok=False)."""
    i = _draw(7, (400, 3), dtype)
    i /= np.linalg.norm(i, axis=-1, keepdims=True)
    n = _draw(8, (400, 3), dtype)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    for ior in (1.5, 1.0 / 1.5):
        (r_t, ok_t), (r_j, ok_j) = _both(lambda a, b: tv.refract3(a, b, ior), lambda a, b: jv.refract3(a, b, ior), i, n)
        np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
        # a unit vector, whose small components carry the cancellation of
        # eta i - c n: held to 4 ulp of 1, not of each component
        np.testing.assert_allclose(r_t.numpy(), np.asarray(r_j), rtol=0, atol=4 * np.finfo(dtype).eps)
    assert not bool(ok_t.all()) and bool(ok_t.any())  # ior < 1 reflects totally on some lanes
    assert bool((r_t[~ok_t] == 0).all())


def test_triangle_area():
    rng = np.random.default_rng(9)
    for _ in range(20):
        p1, p2, p3 = rng.normal(size=(3, 3)) * 100.0
        assert tv.triangle_area(p1, p2, p3) == jv.triangle_area(p1, p2, p3)
    assert tv.triangle_area([0, 0, 0], [3, 0, 0], [0, 4, 0]) == 6.0
    assert tv.triangle_area([0, 0, 0], [1, 1, 1], [2, 2, 2]) == 0.0  # collinear: clamped, not NaN
