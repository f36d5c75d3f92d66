"""Autodiff oracle solvers: the Ceres stand-in for parity testing.

The reference validates its analytic solvers against Ceres autodiff cost
functions (core/pose_only_bundle_adjustment_solver_ceres.h:16-128, driven by
test/test_compare_ceres_vs_native.cpp:177-251). Ceres is not in this
environment (SURVEY.md §4), so the oracle here is:

  - residuals defined ONCE as plain JAX functions (no hand-derived math),
  - Jacobians from `jax.jacobian` in float64,
  - trust-region least squares from scipy (`scipy.optimize.least_squares`,
    method='trf' -- the same Levenberg-Marquardt family Ceres uses).

Deliberately slow and dense -- it exists to certify the analytic solvers'
final costs/poses, not to be fast. CPU/f64 only.
"""

from __future__ import annotations

import numpy as np


def _se3_exp_np(xi: np.ndarray) -> np.ndarray:
    """f64 numpy se3 exp (twist [v; w]) -> 4x4, for oracle parameterization."""
    v, w = xi[:3], xi[3:]
    theta = np.linalg.norm(w)
    wx = np.array(
        [[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]], dtype=np.float64
    )
    if theta < 1e-10:
        R = np.eye(3) + wx + 0.5 * wx @ wx
        V = np.eye(3) + 0.5 * wx + wx @ wx / 6.0
    else:
        s, c = np.sin(theta), np.cos(theta)
        R = np.eye(3) + (s / theta) * wx + ((1 - c) / theta**2) * (wx @ wx)
        V = (
            np.eye(3)
            + ((1 - c) / theta**2) * wx
            + ((theta - s) / theta**3) * (wx @ wx)
        )
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = V @ v
    return T


def pose_only_oracle(
    points: np.ndarray,
    pixels: np.ndarray,
    intrinsics: np.ndarray,
    pose_reference_to_current: np.ndarray,
    max_nfev: int = 200,
) -> tuple[np.ndarray, float]:
    """Mono 6-DoF pose-only oracle: unweighted least squares on the same
    residual model as the reference's Ceres functor
    (pose_only_bundle_adjustment_solver_ceres.h:93-115: plain squared
    reprojection error, no robustifier).

    Returns (optimized pose_reference_to_current, final cost 0.5*sum r^2).
    """
    import jax
    import jax.numpy as jnp
    from scipy.optimize import least_squares

    fx, fy, cx, cy = (float(x) for x in intrinsics)
    T0 = np.linalg.inv(np.asarray(pose_reference_to_current, dtype=np.float64))

    from ..ops import lie

    with jax.enable_x64(True):
        # All device constants are created INSIDE the x64 scope; outside it
        # jnp.asarray(..., float64) silently truncates to f32 and the whole
        # oracle runs single precision.
        R0 = jnp.asarray(T0[:3, :3])
        t0 = jnp.asarray(T0[:3, 3])
        pts = jnp.asarray(points, dtype=jnp.float64)
        pix = jnp.asarray(pixels, dtype=jnp.float64)
        assert pts.dtype == jnp.float64, "oracle must run in f64"

        def residuals(xi):
            dR, dt = lie.se3_exp(xi)
            R = dR @ R0
            t = dR @ t0 + dt
            Xc = pts @ R.T + t
            u = fx * Xc[:, 0] / Xc[:, 2] + cx
            v = fy * Xc[:, 1] / Xc[:, 2] + cy
            return jnp.concatenate([u - pix[:, 0], v - pix[:, 1]])

        res_fn = jax.jit(residuals)
        jac_fn = jax.jit(jax.jacobian(residuals))

        sol = least_squares(
            lambda x: np.asarray(res_fn(jnp.asarray(x))),
            np.zeros(6),
            jac=lambda x: np.asarray(jac_fn(jnp.asarray(x))),
            method="trf",
            max_nfev=max_nfev,
        )
    T_opt = _se3_exp_np(sol.x) @ T0
    return np.linalg.inv(T_opt), float(sol.cost)


def full_ba_oracle(
    cameras,
    poses_world_to_camera: np.ndarray,  # (N, 4, 4) initial
    points: np.ndarray,  # (M, 3) initial
    obs_cam: np.ndarray,
    obs_pose: np.ndarray,
    obs_point: np.ndarray,
    obs_pixel: np.ndarray,
    fixed_pose_mask: np.ndarray,
    fixed_point_mask: np.ndarray | None = None,
    max_nfev: int = 100,
) -> tuple[np.ndarray, np.ndarray, float]:
    """Full-BA oracle: joint least squares over all free poses + points.

    Residual model identical to the engine's (two-stage warp through the rig
    extrinsic, pinhole projection), but: f64, autodiff Jacobian, scipy TRF,
    no robustifier, no scaling conditioner -- an independent implementation
    path for differential testing (SURVEY.md §4 category 2).

    Returns (poses (N,4,4), points (M,3), final cost).
    """
    import jax
    import jax.numpy as jnp
    from scipy.optimize import least_squares

    from ..ops import lie

    N = poses_world_to_camera.shape[0]
    M = points.shape[0]
    if fixed_point_mask is None:
        fixed_point_mask = np.zeros(M, dtype=bool)
    free_pose = np.nonzero(~np.asarray(fixed_pose_mask))[0]
    free_point = np.nonzero(~np.asarray(fixed_point_mask))[0]
    n_free_pose, n_free_point = len(free_pose), len(free_point)

    T0 = np.linalg.inv(poses_world_to_camera.astype(np.float64))  # T_cw
    cam_R = np.stack([np.asarray(c.R_cam_from_ref) for c in cameras])
    cam_t = np.stack([np.asarray(c.t_cam_from_ref) for c in cameras])
    cam_f = np.array([[c.fx, c.fy, c.cx, c.cy] for c in cameras])

    with jax.enable_x64(True):
        jT0_R = jnp.asarray(T0[:, :3, :3])
        jT0_t = jnp.asarray(T0[:, :3, 3])
        jX0 = jnp.asarray(points, dtype=jnp.float64)
        assert jX0.dtype == jnp.float64, "oracle must run in f64"
        j_cam_R = jnp.asarray(cam_R[obs_cam])
        j_cam_t = jnp.asarray(cam_t[obs_cam])
        j_f = jnp.asarray(cam_f[obs_cam])
        j_pix = jnp.asarray(obs_pixel, dtype=jnp.float64)
        j_obs_pose = jnp.asarray(obs_pose)
        j_obs_point = jnp.asarray(obs_point)
        j_free_pose = jnp.asarray(free_pose)
        j_free_point = jnp.asarray(free_point)

        def unpack(params):
            xi = params[: 6 * n_free_pose].reshape(n_free_pose, 6)
            dX = params[6 * n_free_pose :].reshape(n_free_point, 3)
            dR, dt = lie.se3_exp(xi)
            R_free = dR @ jT0_R[j_free_pose]
            t_free = (
                jnp.einsum("nij,nj->ni", dR, jT0_t[j_free_pose]) + dt
            )
            R_all = jT0_R.at[j_free_pose].set(R_free)
            t_all = jT0_t.at[j_free_pose].set(t_free)
            X_all = jX0.at[j_free_point].add(dX)
            return R_all, t_all, X_all

        def residuals(params):
            R_all, t_all, X_all = unpack(params)
            Xr = (
                jnp.einsum(
                    "oij,oj->oi", R_all[j_obs_pose], X_all[j_obs_point]
                )
                + t_all[j_obs_pose]
            )
            Xc = jnp.einsum("oij,oj->oi", j_cam_R, Xr) + j_cam_t
            u = j_f[:, 0] * Xc[:, 0] / Xc[:, 2] + j_f[:, 2]
            v = j_f[:, 1] * Xc[:, 1] / Xc[:, 2] + j_f[:, 3]
            return jnp.concatenate([u - j_pix[:, 0], v - j_pix[:, 1]])

        res_fn = jax.jit(residuals)
        jac_fn = jax.jit(jax.jacobian(residuals))
        x0 = np.zeros(6 * n_free_pose + 3 * n_free_point)
        sol = least_squares(
            lambda x: np.asarray(res_fn(jnp.asarray(x))),
            x0,
            jac=lambda x: np.asarray(jac_fn(jnp.asarray(x))),
            method="trf",
            max_nfev=max_nfev,
        )
        R_all, t_all, X_all = unpack(jnp.asarray(sol.x))

    R_all = np.asarray(R_all)
    t_all = np.asarray(t_all)
    poses_out = np.zeros((N, 4, 4))
    poses_out[:, 3, 3] = 1.0
    # invert T_cw -> T_wc
    poses_out[:, :3, :3] = np.transpose(R_all, (0, 2, 1))
    poses_out[:, :3, 3] = -np.einsum(
        "nji,nj->ni", R_all, t_all
    )
    return poses_out, np.asarray(X_all), float(sol.cost)
