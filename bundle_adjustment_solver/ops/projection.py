"""Fused warp -> project -> residual -> robust-weight -> Jacobian math.

This is the per-observation hot path of the whole engine: the JAX
re-design of the reference's hand-expanded scalar loops
(core/full_bundle_adjustment_solver.cpp:716-831 observation loop,
core/pose_only_bundle_adjustment_solver.cpp:1350-1583 Jacobian kernels).

Everything is written batched over a leading observation axis so XLA fuses
the whole chain into a handful of elementwise kernels; the rank-1 Hessian
accumulations downstream become matmuls / segment-sums (see ops/hessian.py).

Conventions (identical to the reference):
  - poses are world->rig-reference-frame transforms T_jw = (R_jw, t_jw);
  - each camera k has an extrinsic (R_ck, t_ck) mapping rig-reference-frame
    points into camera-k's frame;
  - residual r = project(X_cam) - observed_pixel;
  - robust weight w = min(1, huber_delta / (|r_u| + |r_v|)) -- the reference's
    Manhattan-distance Huber (full cpp:763-766, pose-only cpp:1402-1410);
  - pose twist layout [v; w] (translation first), left-multiplicative update
    T <- exp(xi) T.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_HIGHEST = jax.lax.Precision.HIGHEST

__all__ = [
    "warp_to_cameras",
    "residual_and_weight",
    "full_ba_jacobians",
    "pose_only_jacobian_6dof",
    "pose_only_jacobian_planar3dof",
]


def warp_to_cameras(
    R_jw: jax.Array,  # (O, 3, 3) world->ref-frame rotation per observation
    t_jw: jax.Array,  # (O, 3)
    X: jax.Array,  # (O, 3) world points per observation
    R_cam: jax.Array,  # (O, 3, 3) rig-ref->camera rotation per observation
    t_cam: jax.Array,  # (O, 3)
) -> tuple[jax.Array, jax.Array]:
    """Two-stage warp: world -> rig reference frame -> camera frame.

    Returns (X_ref, X_cam): the reference-frame point Xij (needed for the pose
    Jacobian lever arm) and the camera-frame point Xijc (needed for projection),
    mirroring full cpp:744-747.
    """
    X_ref = jnp.einsum("oij,oj->oi", R_jw, X, precision=_HIGHEST) + t_jw
    X_cam = jnp.einsum("oij,oj->oi", R_cam, X_ref, precision=_HIGHEST) + t_cam
    return X_ref, X_cam


def residual_and_weight(
    X_cam: jax.Array,  # (O, 3)
    pixel: jax.Array,  # (O, 2)
    fx: jax.Array,
    fy: jax.Array,
    cx: jax.Array,
    cy: jax.Array,
    huber_delta: float,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Project, take the residual, and compute the Manhattan-Huber weight.

    Returns (residual (O, 2), weight (O,), manhattan (O,)); `manhattan` is the
    |r_u|+|r_v| outlier-gate statistic the reference thresholds against
    (pose-only cpp:1404-1406: `error_nonweighted`).
    """
    inv_z = 1.0 / X_cam[..., 2]
    u = fx * X_cam[..., 0] * inv_z + cx
    v = fy * X_cam[..., 1] * inv_z + cy
    r = jnp.stack([u, v], axis=-1) - pixel
    manhattan = jnp.abs(r[..., 0]) + jnp.abs(r[..., 1])
    weight = jnp.where(manhattan > huber_delta, huber_delta / manhattan, 1.0)
    return r, weight, manhattan


def _projection_jacobian_times_rcam(
    X_cam: jax.Array, fx: jax.Array, fy: jax.Array, R_cam: jax.Array
) -> jax.Array:
    """J_p = d(pixel)/d(X_ref) = d(project)/d(X_cam) @ R_cam, shape (O, 2, 3).

    Exploits the projection Jacobian's zero pattern exactly like the
    reference's hand expansion (full cpp:770-787): row u only mixes rows 0 and
    2 of R_cam, row v only rows 1 and 2.
    """
    inv_z = 1.0 / X_cam[..., 2]
    fx_inv_z = fx * inv_z
    fy_inv_z = fy * inv_z
    # d(project)/dX_cam = [[fx/z, 0, -fx x/z^2], [0, fy/z, -fy y/z^2]]
    du_dz = -fx_inv_z * X_cam[..., 0] * inv_z
    dv_dz = -fy_inv_z * X_cam[..., 1] * inv_z
    row_u = fx_inv_z[..., None] * R_cam[..., 0, :] + du_dz[..., None] * R_cam[..., 2, :]
    row_v = fy_inv_z[..., None] * R_cam[..., 1, :] + dv_dz[..., None] * R_cam[..., 2, :]
    return jnp.stack([row_u, row_v], axis=-2)


def full_ba_jacobians(
    R_jw: jax.Array,  # (O, 3, 3)
    X_ref: jax.Array,  # (O, 3) point in rig reference frame (Xij)
    X_cam: jax.Array,  # (O, 3) point in camera frame (Xijc)
    fx: jax.Array,
    fy: jax.Array,
    R_cam: jax.Array,  # (O, 3, 3)
) -> tuple[jax.Array, jax.Array]:
    """Analytic full-BA Jacobians per observation.

    Returns:
      Q: (O, 2, 6) residual Jacobian w.r.t. the pose twist [v; w] of the
         left-multiplicative update of T_jw (full cpp:795-800:
         Q = [J_p | -J_p [X_ref]_x]).
      Rj: (O, 2, 3) residual Jacobian w.r.t. the world point
         (full cpp:812-814: Rj = J_p R_jw).
    """
    J_p = _projection_jacobian_times_rcam(X_cam, fx, fy, R_cam)
    # -[X_ref]_x without materializing the skew matrix:
    # (J_p @ (-skew(X)))[:, c] = J_p[:, a] X_b - J_p[:, b] X_a pattern.
    x, y, z = X_ref[..., 0:1], X_ref[..., 1:2], X_ref[..., 2:3]
    col0 = J_p[..., 2] * y - J_p[..., 1] * z
    col1 = J_p[..., 0] * z - J_p[..., 2] * x
    col2 = J_p[..., 1] * x - J_p[..., 0] * y
    Q_rot = jnp.stack([col0, col1, col2], axis=-1)
    Q = jnp.concatenate([J_p, Q_rot], axis=-1)
    Rj = jnp.einsum("oab,obc->oac", J_p, R_jw, precision=_HIGHEST)
    return Q, Rj


def pose_only_jacobian_6dof(
    X_cam: jax.Array,  # (..., 3) point in camera frame (pose being optimized
    #                    IS the camera pose T_cw; no rig extrinsic in the chain)
    fx: jax.Array,
    fy: jax.Array,
) -> jax.Array:
    """(..., 2, 6) Jacobian of the reprojection residual w.r.t. the twist of a
    left-multiplicative update of T_cw.

    Matches ComputeJacobianResidual_ReprojectionError_6Dof
    (core/pose_only_bundle_adjustment_solver.cpp:1350-1384): row u =
    [fx/z, 0, -fx x/z^2, -fx x y / z^2, fx (1 + x^2/z^2), -fx y/z], etc.
    """
    inv_z = 1.0 / X_cam[..., 2]
    x_inv_z = X_cam[..., 0] * inv_z
    y_inv_z = X_cam[..., 1] * inv_z
    fx_x_inv_z = fx * x_inv_z
    fy_y_inv_z = fy * y_inv_z
    zero = jnp.zeros_like(inv_z)
    row_u = jnp.stack(
        [
            fx * inv_z,
            zero,
            -fx_x_inv_z * inv_z,
            -fx_x_inv_z * y_inv_z,
            fx * (1.0 + x_inv_z * x_inv_z),
            -fx * y_inv_z,
        ],
        axis=-1,
    )
    row_v = jnp.stack(
        [
            zero,
            fy * inv_z,
            -fy_y_inv_z * inv_z,
            -fy * (1.0 + y_inv_z * y_inv_z),
            fy_y_inv_z * x_inv_z,
            fy * x_inv_z,
        ],
        axis=-1,
    )
    return jnp.stack([row_u, row_v], axis=-2)


def pose_only_jacobian_planar3dof(
    X_cam: jax.Array,  # (..., 3) point warped into the current camera frame
    X_base: jax.Array,  # (..., 3) the same point in the source base frame
    fx: jax.Array,
    fy: jax.Array,
    R_cam_from_base: jax.Array,  # (3, 3) camera<-base rotation (R_cb)
    cos_psi: jax.Array,
    sin_psi: jax.Array,
) -> jax.Array:
    """(..., 2, 3) Jacobian w.r.t. planar base-motion params (x, y, psi).

    Matches ComputeJacobianResidual_ReprojectionError_Planar3Dof
    (core/pose_only_bundle_adjustment_solver.cpp:1454-1515): the translation
    columns go through columns 0/1 of R_cb; the psi column uses the lever
    terms A = -sin(psi) x_b - cos(psi) y_b, B = cos(psi) x_b - sin(psi) y_b.
    """
    inv_z = 1.0 / X_cam[..., 2]
    fx_inv_z = fx * inv_z
    fy_inv_z = fy * inv_z
    du_dz = -fx_inv_z * X_cam[..., 0] * inv_z
    dv_dz = -fy_inv_z * X_cam[..., 1] * inv_z

    r = R_cam_from_base
    ju_x = fx_inv_z * r[0, 0] + du_dz * r[2, 0]
    ju_y = fx_inv_z * r[0, 1] + du_dz * r[2, 1]
    jv_x = fy_inv_z * r[1, 0] + dv_dz * r[2, 0]
    jv_y = fy_inv_z * r[1, 1] + dv_dz * r[2, 1]

    xb, yb = X_base[..., 0], X_base[..., 1]
    A = -sin_psi * xb - cos_psi * yb
    B = cos_psi * xb - sin_psi * yb
    ju_psi = ju_x * A + ju_y * B
    jv_psi = jv_x * A + jv_y * B

    row_u = jnp.stack([ju_x, ju_y, ju_psi], axis=-1)
    row_v = jnp.stack([jv_x, jv_y, jv_psi], axis=-1)
    return jnp.stack([row_u, row_v], axis=-2)
