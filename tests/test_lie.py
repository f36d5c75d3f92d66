"""Unit tests for ops/lie.py: round-trips, autodiff parity, batching.

The reference has no unit tests for its geometry layer
(utility/geometry_library); these cover the function list it exposes
(geometry_library.h:10-55) per SURVEY.md §4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bundle_adjustment_solver.ops import lie


def random_rotvec(rng, n, scale=2.0):
    return rng.normal(0, scale, (n, 3)).astype(np.float32)


class TestSkew:
    def test_cross_product(self, rng):
        w = rng.normal(size=(10, 3)).astype(np.float32)
        v = rng.normal(size=(10, 3)).astype(np.float32)
        got = np.einsum("nij,nj->ni", lie.skew(jnp.asarray(w)), v)
        np.testing.assert_allclose(got, np.cross(w, v), atol=1e-6)

    def test_unskew_roundtrip(self, rng):
        w = rng.normal(size=(5, 3)).astype(np.float32)
        np.testing.assert_allclose(lie.unskew(lie.skew(jnp.asarray(w))), w, atol=1e-7)


class TestSO3:
    def test_exp_is_rotation(self, rng):
        w = random_rotvec(rng, 50)
        R = np.asarray(lie.so3_exp(jnp.asarray(w)))
        eye = np.einsum("nij,nkj->nik", R, R)
        np.testing.assert_allclose(eye, np.broadcast_to(np.eye(3), eye.shape), atol=1e-5)
        np.testing.assert_allclose(np.linalg.det(R), 1.0, atol=1e-5)

    def test_exp_log_roundtrip(self, rng):
        # Keep |w| < pi: so3_log returns the principal branch.
        w = random_rotvec(rng, 100, scale=1.0)
        norms = np.linalg.norm(w, axis=-1, keepdims=True)
        w = np.where(norms > 3.0, w * (3.0 / norms), w).astype(np.float32)
        R = lie.so3_exp(jnp.asarray(w))
        w_back = np.asarray(lie.so3_log(R))
        np.testing.assert_allclose(w_back, w, atol=1e-4)

    def test_log_exp_identity_any_angle(self, rng):
        # For arbitrary rotations (even built from |w| > pi), exp(log(R)) == R.
        w = random_rotvec(rng, 50, scale=3.0)
        R = lie.so3_exp(jnp.asarray(w))
        R_back = lie.so3_exp(lie.so3_log(R))
        np.testing.assert_allclose(np.asarray(R_back), np.asarray(R), atol=1e-5)

    def test_small_angle(self):
        w = jnp.asarray([[1e-9, -2e-9, 3e-10], [0.0, 0.0, 0.0]], dtype=jnp.float32)
        R = np.asarray(lie.so3_exp(w))
        np.testing.assert_allclose(R[1], np.eye(3), atol=1e-7)
        assert np.all(np.isfinite(R))
        np.testing.assert_allclose(np.asarray(lie.so3_log(lie.so3_exp(w))), w, atol=1e-7)

    def test_near_pi(self, rng):
        axis = rng.normal(size=(20, 3))
        axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
        w = (axis * (np.pi - 1e-3)).astype(np.float32)
        w_back = np.asarray(lie.so3_log(lie.so3_exp(jnp.asarray(w))))
        np.testing.assert_allclose(w_back, w, atol=1e-3)


class TestSE3:
    def test_exp_log_roundtrip(self, rng):
        xi = rng.normal(0, 1.0, (100, 6)).astype(np.float32)
        # Principal branch: keep the rotation part below pi.
        norms = np.linalg.norm(xi[:, 3:], axis=-1, keepdims=True)
        xi[:, 3:] = np.where(norms > 3.0, xi[:, 3:] * (3.0 / norms), xi[:, 3:])
        R, t = lie.se3_exp(jnp.asarray(xi))
        xi_back = np.asarray(lie.se3_log(R, t))
        np.testing.assert_allclose(xi_back, xi, atol=2e-4)

    def test_matches_matrix_expm(self, rng):
        """se3_exp against the brute-force matrix exponential of the 4x4 twist."""
        from scipy.linalg import expm

        xi = rng.normal(0, 0.8, (10, 6)).astype(np.float64)
        R, t = lie.se3_exp(jnp.asarray(xi))
        for i in range(10):
            m = np.zeros((4, 4))
            m[:3, :3] = np.asarray(lie.skew(jnp.asarray(xi[i, 3:])))
            m[:3, 3] = xi[i, :3]
            T = expm(m)
            np.testing.assert_allclose(np.asarray(R[i]), T[:3, :3], atol=1e-5)
            np.testing.assert_allclose(np.asarray(t[i]), T[:3, 3], atol=1e-5)

    def test_inverse(self, rng):
        xi = rng.normal(0, 1.0, (20, 6)).astype(np.float32)
        R, t = lie.se3_exp(jnp.asarray(xi))
        Ri, ti = lie.inverse_se3(R, t)
        Rc, tc = lie.compose(R, t, Ri, ti)
        np.testing.assert_allclose(Rc, np.broadcast_to(np.eye(3), Rc.shape), atol=1e-6)
        np.testing.assert_allclose(tc, np.zeros_like(tc), atol=1e-6)

    def test_add_front_se3_first_order(self, rng):
        """exp(xi) T == left-composed update; derivative matches autodiff."""
        xi0 = rng.normal(0, 0.5, (6,)).astype(np.float32)
        R0, t0 = lie.se3_exp(jnp.asarray(xi0))
        X = jnp.asarray(rng.normal(0, 1.0, (3,)).astype(np.float32))

        def warped(eps):
            R, t = lie.add_front_se3(R0, t0, eps)
            return R @ X + t

        J = jax.jacobian(warped)(jnp.zeros(6, dtype=jnp.float32))
        X_ref = R0 @ X + t0
        J_expected = jnp.concatenate(
            [jnp.eye(3), -lie.skew(X_ref)], axis=-1
        )
        np.testing.assert_allclose(np.asarray(J), np.asarray(J_expected), atol=1e-5)


class TestQuaternion:
    def test_quat_rotation_roundtrip(self, rng):
        w = random_rotvec(rng, 50, scale=1.5)
        R = lie.so3_exp(jnp.asarray(w))
        q = lie.rotation_to_quat(R)
        R_back = lie.quat_to_rotation(q)
        np.testing.assert_allclose(np.asarray(R_back), np.asarray(R), atol=1e-5)

    def test_rotvec_to_quat(self, rng):
        w = random_rotvec(rng, 30, scale=1.5)
        R1 = lie.quat_to_rotation(lie.rotvec_to_quat(jnp.asarray(w)))
        R2 = lie.so3_exp(jnp.asarray(w))
        np.testing.assert_allclose(np.asarray(R1), np.asarray(R2), atol=1e-5)

    def test_multiply_matches_rotation_compose(self, rng):
        w1 = random_rotvec(rng, 20, scale=1.0)
        w2 = random_rotvec(rng, 20, scale=1.0)
        q1 = lie.rotvec_to_quat(jnp.asarray(w1))
        q2 = lie.rotvec_to_quat(jnp.asarray(w2))
        R_q = lie.quat_to_rotation(lie.quat_multiply(q1, q2))
        R_m = lie.so3_exp(jnp.asarray(w1)) @ lie.so3_exp(jnp.asarray(w2))
        np.testing.assert_allclose(np.asarray(R_q), np.asarray(R_m), atol=1e-5)

    def test_left_right_matrices(self, rng):
        w1 = random_rotvec(rng, 5, scale=1.0)
        w2 = random_rotvec(rng, 5, scale=1.0)
        q1 = lie.rotvec_to_quat(jnp.asarray(w1))
        q2 = lie.rotvec_to_quat(jnp.asarray(w2))
        prod = lie.quat_multiply(q1, q2)
        via_left = jnp.einsum("nij,nj->ni", lie.quat_left_matrix(q1), q2)
        via_right = jnp.einsum("nij,nj->ni", lie.quat_right_matrix(q2), q1)
        np.testing.assert_allclose(np.asarray(via_left), np.asarray(prod), atol=1e-6)
        np.testing.assert_allclose(np.asarray(via_right), np.asarray(prod), atol=1e-6)


class TestEulerPlanar:
    def test_euler_roundtrip(self, rng):
        roll = rng.uniform(-1.2, 1.2, 20).astype(np.float32)
        pitch = rng.uniform(-1.2, 1.2, 20).astype(np.float32)
        yaw = rng.uniform(-3.0, 3.0, 20).astype(np.float32)
        R = lie.euler_to_rotation(jnp.asarray(roll), jnp.asarray(pitch), jnp.asarray(yaw))
        r2, p2, y2 = lie.rotation_to_euler(R)
        np.testing.assert_allclose(np.asarray(r2), roll, atol=1e-5)
        np.testing.assert_allclose(np.asarray(p2), pitch, atol=1e-5)
        np.testing.assert_allclose(np.asarray(y2), yaw, atol=1e-5)

    def test_planar_roundtrip(self, rng):
        theta = rng.normal(0, 1.0, (20, 3)).astype(np.float32)
        R, t = lie.planar_to_se3(jnp.asarray(theta))
        theta_back = np.asarray(lie.se3_to_planar(R, t))
        np.testing.assert_allclose(theta_back, theta, atol=1e-5)


def test_jit_and_vmap_compatible(rng):
    xi = jnp.asarray(rng.normal(0, 0.5, (16, 6)).astype(np.float32))
    f = jax.jit(jax.vmap(lambda x: lie.se3_log(*lie.se3_exp(x))))
    np.testing.assert_allclose(np.asarray(f(xi)), np.asarray(xi), atol=2e-4)
