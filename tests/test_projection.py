"""Jacobian correctness tests: analytic kernels vs jax.jacobian autodiff.

The reference has no Jacobian unit tests (SURVEY.md §4); every hand-derived
kernel here is checked against autodiff of the actual residual function.
"""

import jax
import jax.numpy as jnp
import numpy as np

from bundle_adjustment_solver.ops import lie, projection


def _rand_rotation(rng, n=1):
    return lie.so3_exp(jnp.asarray(rng.normal(0, 0.5, (n, 3)).astype(np.float32)))


def _residual_fn_pose_only(X, pixel, fx, fy, cx, cy):
    def fn(xi, R, t):
        dR, dt = lie.se3_exp(xi)
        Rn, tn = lie.compose(dR, dt, R, t)
        Xc = Rn @ X + tn
        u = fx * Xc[0] / Xc[2] + cx
        v = fy * Xc[1] / Xc[2] + cy
        return jnp.stack([u, v]) - pixel

    return fn


class TestPoseOnly6DofJacobian:
    def test_matches_autodiff(self, rng):
        fx, fy, cx, cy = 338.0, 338.0, 320.0, 240.0
        for _ in range(5):
            R = _rand_rotation(rng)[0]
            t = jnp.asarray(rng.normal(0, 0.3, 3).astype(np.float32))
            X = jnp.asarray(
                rng.uniform([-1.5, -1.0, 1.5], [1.5, 1.0, 6.0]).astype(np.float32)
            )
            pixel = jnp.asarray(rng.uniform(0, 640, 2).astype(np.float32))
            Xc = R @ X + t
            J_analytic = projection.pose_only_jacobian_6dof(
                Xc[None], jnp.float32(fx), jnp.float32(fy)
            )[0]
            fn = _residual_fn_pose_only(X, pixel, fx, fy, cx, cy)
            J_auto = jax.jacobian(fn)(jnp.zeros(6, jnp.float32), R, t)
            np.testing.assert_allclose(
                np.asarray(J_analytic), np.asarray(J_auto), rtol=1e-4, atol=1e-3
            )


class TestFullBAJacobians:
    def test_matches_autodiff(self, rng):
        """Q (pose twist) and Rj (point) Jacobians vs autodiff through the
        full two-stage warp chain (full cpp:744-828)."""
        fx, fy = 5.25, 5.25  # scaled intrinsics, as the solver uses them
        cx, cy = 3.2, 2.4
        for _ in range(5):
            R_jw = _rand_rotation(rng)[0]
            t_jw = jnp.asarray(rng.normal(0, 0.1, 3).astype(np.float32))
            R_cam = _rand_rotation(rng)[0]
            t_cam = jnp.asarray(rng.normal(0, 0.01, 3).astype(np.float32))
            X = jnp.asarray(rng.uniform([5, 1, 1], [9, 20, 5]).astype(np.float32))
            # keep the point in front of the camera
            X_ref = R_jw @ X + t_jw
            X_cam = R_cam @ X_ref + t_cam
            if float(X_cam[2]) < 0.1:
                continue
            pixel = jnp.asarray(rng.uniform(0, 6.4, 2).astype(np.float32))

            def residual(xi, dX):
                dR, dt = lie.se3_exp(xi)
                Rn, tn = lie.compose(dR, dt, R_jw, t_jw)
                Xr = Rn @ (X + dX) + tn
                Xc = R_cam @ Xr + t_cam
                u = fx * Xc[0] / Xc[2] + cx
                v = fy * Xc[1] / Xc[2] + cy
                return jnp.stack([u, v]) - pixel

            Q, Rj = projection.full_ba_jacobians(
                R_jw[None],
                X_ref[None],
                X_cam[None],
                jnp.float32(fx),
                jnp.float32(fy),
                R_cam[None],
            )
            J_pose_auto = jax.jacobian(residual, argnums=0)(
                jnp.zeros(6, jnp.float32), jnp.zeros(3, jnp.float32)
            )
            J_point_auto = jax.jacobian(residual, argnums=1)(
                jnp.zeros(6, jnp.float32), jnp.zeros(3, jnp.float32)
            )
            np.testing.assert_allclose(
                np.asarray(Q[0]), np.asarray(J_pose_auto), rtol=1e-4, atol=1e-4
            )
            np.testing.assert_allclose(
                np.asarray(Rj[0]), np.asarray(J_point_auto), rtol=1e-4, atol=1e-4
            )


class TestPlanarJacobian:
    def test_matches_autodiff(self, rng):
        """Planar (x, y, psi) Jacobian vs autodiff through the base-motion
        chain (pose-only cpp:1454-1515). The reference's update is
        left-compositional, but its Jacobian treats (x, y) as additive in the
        base frame and psi through the rotation -- autodiff of exactly that
        parameterization must match."""
        fx, fy, cx, cy = 525.0, 525.0, 320.0, 240.0
        R_cb = _rand_rotation(rng)[0]
        t_cb = jnp.asarray(rng.normal(0, 0.1, 3).astype(np.float32))
        for _ in range(5):
            theta = jnp.asarray(rng.normal(0, 0.5, 3).astype(np.float32))
            X_b = jnp.asarray(rng.uniform([2, -3, -1], [8, 3, 1]).astype(np.float32))
            pixel = jnp.asarray(rng.uniform(0, 640, 2).astype(np.float32))

            def residual(th):
                Rp, tp = lie.planar_to_se3(th)
                Xb2 = Rp @ X_b + tp
                Xc = R_cb @ Xb2 + t_cb
                u = fx * Xc[0] / Xc[2] + cx
                v = fy * Xc[1] / Xc[2] + cy
                return jnp.stack([u, v]) - pixel

            Rp, tp = lie.planar_to_se3(theta)
            Xc = R_cb @ (Rp @ X_b + tp) + t_cb
            if float(Xc[2]) < 0.2:
                continue
            J = projection.pose_only_jacobian_planar3dof(
                Xc[None],
                X_b[None],
                jnp.float32(fx),
                jnp.float32(fy),
                R_cb,
                jnp.cos(theta[2]),
                jnp.sin(theta[2]),
            )[0]
            J_auto = jax.jacobian(residual)(theta)
            np.testing.assert_allclose(
                np.asarray(J), np.asarray(J_auto), rtol=1e-3, atol=1e-2
            )


class TestResidualAndWeight:
    def test_huber_weight(self, rng):
        X_cam = jnp.asarray([[0.1, 0.2, 2.0], [0.0, 0.0, 1.0]], dtype=jnp.float32)
        fx = fy = jnp.float32(100.0)
        cx = cy = jnp.float32(0.0)
        # pixel chosen so |r|_1 is tiny for row 0, large for row 1
        pixels = jnp.asarray([[5.0, 10.0], [50.0, 50.0]], dtype=jnp.float32)
        r, w, man = projection.residual_and_weight(
            X_cam, pixels, fx, fy, cx, cy, huber_delta=1.0
        )
        np.testing.assert_allclose(np.asarray(r[0]), [0.0, 0.0], atol=1e-5)
        assert float(w[0]) == 1.0
        assert float(man[1]) == 100.0
        np.testing.assert_allclose(float(w[1]), 1.0 / 100.0, rtol=1e-6)
