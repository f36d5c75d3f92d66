"""Unit tests for the flat symmetric-6x6 block algebra (ops/sym6.py)."""

import numpy as np
import jax.numpy as jnp

from bundle_adjustment_solver.ops.sym6 import (
    _TRI6,
    inverse_tri6,
    tri6_damp,
    tri6_matvec,
)


def _random_spd_tri(n, rng):
    J = rng.standard_normal((n, 10, 6)).astype(np.float32)
    A = np.einsum("nra,nrb->nab", J, J) + 0.5 * np.eye(6, dtype=np.float32)
    tri = np.stack([A[:, a, b] for (a, b) in _TRI6], axis=1)
    return A, tri


def test_tri6_matvec_matches_dense(rng):
    A, tri = _random_spd_tri(37, rng)
    x = rng.standard_normal((37, 6)).astype(np.float32)
    y = np.asarray(tri6_matvec(jnp.asarray(tri), jnp.asarray(x)))
    np.testing.assert_allclose(y, np.einsum("nab,nb->na", A, x), rtol=2e-5)


def test_tri6_damp_scales_diagonal_only(rng):
    A, tri = _random_spd_tri(5, rng)
    lam = 2.5
    damped = np.asarray(tri6_damp(jnp.asarray(tri), jnp.float32(lam)))
    for n, (a, b) in enumerate(_TRI6):
        expected = A[:, a, b] * ((1.0 + lam) if a == b else 1.0)
        np.testing.assert_allclose(damped[:, n], expected, rtol=1e-6)


def test_inverse_tri6_matches_numpy(rng):
    A, tri = _random_spd_tri(29, rng)
    inv_tri = np.asarray(inverse_tri6(jnp.asarray(tri)))
    inv_np = np.linalg.inv(A.astype(np.float64))
    for n, (a, b) in enumerate(_TRI6):
        np.testing.assert_allclose(
            inv_tri[:, n], inv_np[:, a, b], rtol=5e-3, atol=1e-5
        )


def test_inverse_tri6_singular_guard():
    tri = jnp.zeros((3, 21), jnp.float32)
    assert np.all(np.asarray(inverse_tri6(tri)) == 0.0)
