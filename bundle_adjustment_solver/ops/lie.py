"""Batched Lie-group / rotation operations for SE(3), SO(3) and quaternions.

JAX re-design of the reference geometry layer
(reference: utility/geometry_library.h:10-55, utility/geometry_library.cpp and
the solver-local exponentials, core/full_bundle_adjustment_solver.cpp:1046-1102,
core/pose_only_bundle_adjustment_solver.cpp:1280-1336).

Everything here is fully batched: inputs may carry arbitrary leading batch
dimensions, e.g. ``se3_exp`` maps ``(..., 6) -> ((..., 3, 3), (..., 3))``.
All trig singularities are handled with Taylor expansions selected by
``jnp.where`` so the functions are safe under ``jit``/``vmap``/``grad``
(no data-dependent branching, which XLA cannot compile).

Unless noted otherwise rotations are 3x3 matrices, quaternions are (w, x, y, z)
with ``w >= 0`` not enforced, and SE(3) elements are (R, t) pairs rather than
4x4 homogeneous matrices (no work wasted on the constant bottom row).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Small-angle cutoff: below this theta**2, use Taylor series.  f32-safe.
_SMALL_ANGLE_SQ = 1e-12

# Geometry must be exact f32: an accelerator's DEFAULT matmul precision may
# round inputs (TF32 on a GPU's tensor cores), which destroys rotation
# orthogonality. Every contraction in this module pins HIGHEST precision
# (the 3x3/4x4 shapes are too small for tensor cores to pay anyway).
_HIGHEST = jax.lax.Precision.HIGHEST


def _mm(a: jax.Array, b: jax.Array) -> jax.Array:
    """Batched matmul at HIGHEST precision."""
    return jnp.matmul(a, b, precision=_HIGHEST)

__all__ = [
    "skew",
    "unskew",
    "so3_exp",
    "so3_log",
    "se3_exp",
    "se3_log",
    "se3_exp_matrix",
    "compose",
    "inverse_se3",
    "transform_points",
    "add_front_se3",
    "quat_multiply",
    "quat_left_matrix",
    "quat_right_matrix",
    "quat_to_rotation",
    "rotation_to_quat",
    "rotvec_to_quat",
    "euler_to_rotation",
    "rotation_to_euler",
    "planar_to_se3",
    "se3_to_planar",
]


def skew(w: jax.Array) -> jax.Array:
    """(..., 3) -> (..., 3, 3) cross-product matrix [w]x.

    Reference parity: geometry::skewMat (utility/geometry_library.cpp:6-21).
    """
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zero = jnp.zeros_like(wx)
    rows = [
        jnp.stack([zero, -wz, wy], axis=-1),
        jnp.stack([wz, zero, -wx], axis=-1),
        jnp.stack([-wy, wx, zero], axis=-1),
    ]
    return jnp.stack(rows, axis=-2)


def unskew(m: jax.Array) -> jax.Array:
    """(..., 3, 3) -> (..., 3): inverse of `skew` for antisymmetric input."""
    return jnp.stack([m[..., 2, 1], m[..., 0, 2], m[..., 1, 0]], axis=-1)


def _sin_theta_over_theta(theta_sq: jax.Array) -> jax.Array:
    """sin(t)/t with Taylor fallback 1 - t^2/6.

    The sqrt is taken on a guarded value so reverse-mode AD through the
    untaken branch stays finite at theta == 0 (the standard where-where trick).
    """
    small = theta_sq < _SMALL_ANGLE_SQ
    safe = jnp.sqrt(jnp.where(small, 1.0, theta_sq))
    return jnp.where(small, 1.0 - theta_sq / 6.0, jnp.sin(safe) / safe)


def _one_minus_cos_over_theta_sq(theta_sq: jax.Array) -> jax.Array:
    """(1-cos t)/t^2 with Taylor fallback 1/2 - t^2/24."""
    small = theta_sq < _SMALL_ANGLE_SQ
    safe = jnp.where(small, 1.0, theta_sq)
    theta = jnp.sqrt(safe)
    return jnp.where(small, 0.5 - theta_sq / 24.0, (1.0 - jnp.cos(theta)) / safe)


def _theta_minus_sin_over_theta_cubed(theta_sq: jax.Array) -> jax.Array:
    """(t - sin t)/t^3 with Taylor fallback 1/6 - t^2/120."""
    small = theta_sq < _SMALL_ANGLE_SQ
    safe = jnp.where(small, 1.0, theta_sq)
    theta = jnp.sqrt(safe)
    return jnp.where(
        small, 1.0 / 6.0 - theta_sq / 120.0, (theta - jnp.sin(theta)) / (safe * theta)
    )


def so3_exp(w: jax.Array) -> jax.Array:
    """Rodrigues: (..., 3) rotation vector -> (..., 3, 3) rotation matrix.

    Reference parity: geometry::so3Exp (utility/geometry_library.cpp:590-658)
    and CalculateMatrixExpoenetial_so3
    (core/pose_only_bundle_adjustment_solver.cpp:1318-1336).
    """
    theta_sq = jnp.sum(w * w, axis=-1)
    wx = skew(w)
    wx2 = _mm(wx, wx)
    a = _sin_theta_over_theta(theta_sq)[..., None, None]
    b = _one_minus_cos_over_theta_sq(theta_sq)[..., None, None]
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), wx.shape)
    return eye + a * wx + b * wx2


def so3_log(R: jax.Array) -> jax.Array:
    """(..., 3, 3) rotation matrix -> (..., 3) rotation vector.

    Reference parity: geometry::SO3Log (utility/geometry_library.cpp:659-702).
    Handles theta ~ 0 via Taylor; theta ~ pi via the quaternion route
    (numerically stable where (R - R^T) vanishes).
    """
    q = rotation_to_quat(R)
    # rotvec from quaternion: 2 * atan2(|xyz|, w) * xyz/|xyz|
    qw = q[..., 0]
    qv = q[..., 1:]
    norm_qv = jnp.linalg.norm(qv, axis=-1)
    theta = 2.0 * jnp.arctan2(norm_qv, qw)
    small = norm_qv < 1e-12
    scale = jnp.where(small, 2.0, theta / jnp.where(small, 1.0, norm_qv))
    return scale[..., None] * qv


def se3_exp(xi: jax.Array) -> tuple[jax.Array, jax.Array]:
    """(..., 6) twist [v; w] -> ((..., 3, 3) R, (..., 3) t).

    Twist layout matches the reference solvers: translation first, rotation
    last (core/pose_only_bundle_adjustment_solver.cpp:1289-1295,
    core/full_bundle_adjustment_solver.cpp:1046-1102).
    """
    v = xi[..., :3]
    w = xi[..., 3:]
    theta_sq = jnp.sum(w * w, axis=-1)
    wx = skew(w)
    wx2 = _mm(wx, wx)
    a = _sin_theta_over_theta(theta_sq)[..., None, None]
    b = _one_minus_cos_over_theta_sq(theta_sq)[..., None, None]
    c = _theta_minus_sin_over_theta_cubed(theta_sq)[..., None, None]
    eye = jnp.broadcast_to(jnp.eye(3, dtype=xi.dtype), wx.shape)
    R = eye + a * wx + b * wx2
    V = eye + b * wx + c * wx2
    t = jnp.einsum("...ij,...j->...i", V, v, precision=_HIGHEST)
    return R, t


def se3_exp_matrix(xi: jax.Array) -> jax.Array:
    """(..., 6) twist -> (..., 4, 4) homogeneous matrix (convenience)."""
    R, t = se3_exp(xi)
    batch = xi.shape[:-1]
    T = jnp.zeros(batch + (4, 4), dtype=xi.dtype)
    T = T.at[..., :3, :3].set(R)
    T = T.at[..., :3, 3].set(t)
    T = T.at[..., 3, 3].set(1.0)
    return T


def se3_log(R: jax.Array, t: jax.Array) -> jax.Array:
    """((..., 3, 3), (..., 3)) -> (..., 6) twist [v; w].

    Reference parity: geometry::SE3Log (utility/geometry_library.cpp:488-589).
    """
    w = so3_log(R)
    theta_sq = jnp.sum(w * w, axis=-1)
    wx = skew(w)
    wx2 = _mm(wx, wx)
    # V^-1 = I - wx/2 + coeff * wx^2,
    # coeff = 1/theta^2 - (1 + cos)/(2 theta sin); Taylor: 1/12 + theta^2/720.
    small = theta_sq < _SMALL_ANGLE_SQ
    safe_sq = jnp.where(small, 1.0, theta_sq)
    theta = jnp.sqrt(safe_sq)
    coeff_large = 1.0 / safe_sq - (1.0 + jnp.cos(theta)) / (
        2.0 * theta * jnp.sin(theta)
    )
    coeff = jnp.where(small, 1.0 / 12.0 + theta_sq / 720.0, coeff_large)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=R.dtype), R.shape)
    V_inv = eye - 0.5 * wx + coeff[..., None, None] * wx2
    v = jnp.einsum("...ij,...j->...i", V_inv, t, precision=_HIGHEST)
    return jnp.concatenate([v, w], axis=-1)


def compose(
    R1: jax.Array, t1: jax.Array, R2: jax.Array, t2: jax.Array
) -> tuple[jax.Array, jax.Array]:
    """(R1, t1) * (R2, t2): first apply 2, then 1."""
    R = jnp.einsum("...ij,...jk->...ik", R1, R2, precision=_HIGHEST)
    t = jnp.einsum("...ij,...j->...i", R1, t2, precision=_HIGHEST) + t1
    return R, t


def compose_flat(
    dR: jax.Array, dt: jax.Array, R9: jax.Array, t: jax.Array
) -> tuple[jax.Array, jax.Array]:
    """`compose` with the right-hand pose in flat row-major 9-column form.

    The point-major solvers carry poses as packed (rows, 16) gather tables
    (R row-major in columns 0:9, t in 9:12) -- the layout the point-major
    operators gather from -- so that no LM iteration rebuilds the table
    from (N, 3, 3) arrays. This computes (dR @ R, dR @ t + dt) column
    by column in exact f32 multiplies, staying in flat form throughout.

    dR (..., 3, 3), dt (..., 3), R9 (..., 9), t (..., 3) -> ((..., 9),
    (..., 3)).
    """
    d = [[dR[..., i, k] for k in range(3)] for i in range(3)]
    Rn = jnp.stack(
        [
            d[i][0] * R9[..., j] + d[i][1] * R9[..., 3 + j]
            + d[i][2] * R9[..., 6 + j]
            for i in range(3)
            for j in range(3)
        ],
        axis=-1,
    )
    tn = jnp.stack(
        [
            d[i][0] * t[..., 0] + d[i][1] * t[..., 1] + d[i][2] * t[..., 2]
            + dt[..., i]
            for i in range(3)
        ],
        axis=-1,
    )
    return Rn, tn


def inverse_se3(R: jax.Array, t: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Inverse rigid transform: (R^T, -R^T t).

    Reference parity: geometry::inverseSE3 (utility/geometry_library.cpp:721-737).
    """
    Rt = jnp.swapaxes(R, -1, -2)
    return Rt, -jnp.einsum("...ij,...j->...i", Rt, t, precision=_HIGHEST)


def transform_points(R: jax.Array, t: jax.Array, X: jax.Array) -> jax.Array:
    """Apply rigid transform to points: R @ X + t, broadcasting over batches.

    The replacement for the reference's AVX point warper
    (utility/simd_library.cpp:36-137) -- XLA vectorizes this and fuses it
    with downstream projection math.
    """
    return jnp.einsum("...ij,...j->...i", R, X, precision=_HIGHEST) + t


def add_front_se3(R: jax.Array, t: jax.Array, xi: jax.Array):
    """Left-compose an se(3) increment: exp(xi) * (R, t).

    Reference parity: geometry::addFrontse3 (utility/geometry_library.cpp:703-720)
    and the solver update rule (core/full_bundle_adjustment_solver.cpp:484-494).
    """
    dR, dt = se3_exp(xi)
    return compose(dR, dt, R, t)


# ---------------------------------------------------------------------------
# Quaternions (w, x, y, z)
# ---------------------------------------------------------------------------


def quat_left_matrix(q: jax.Array) -> jax.Array:
    """4x4 left-multiplication matrix L(q) with q1*q2 = L(q1) @ q2.

    Reference parity: geometry::q_left_mult (utility/geometry_library.cpp:23-80).
    """
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    rows = [
        jnp.stack([w, -x, -y, -z], axis=-1),
        jnp.stack([x, w, -z, y], axis=-1),
        jnp.stack([y, z, w, -x], axis=-1),
        jnp.stack([z, -y, x, w], axis=-1),
    ]
    return jnp.stack(rows, axis=-2)


def quat_right_matrix(q: jax.Array) -> jax.Array:
    """4x4 right-multiplication matrix R(q) with q1*q2 = R(q2) @ q1.

    Reference parity: geometry::q_right_mult (utility/geometry_library.cpp).
    """
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    rows = [
        jnp.stack([w, -x, -y, -z], axis=-1),
        jnp.stack([x, w, z, -y], axis=-1),
        jnp.stack([y, -z, w, x], axis=-1),
        jnp.stack([z, y, -x, w], axis=-1),
    ]
    return jnp.stack(rows, axis=-2)


def quat_multiply(q1: jax.Array, q2: jax.Array) -> jax.Array:
    """Hamilton product q1 * q2 on (..., 4) (w, x, y, z) quaternions.

    Reference parity: geometry::q1_mult_q2 (utility/geometry_library.cpp).
    """
    w1, x1, y1, z1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    w2, x2, y2, z2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return jnp.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        axis=-1,
    )


def quat_to_rotation(q: jax.Array) -> jax.Array:
    """(..., 4) unit quaternion -> (..., 3, 3) rotation matrix.

    Reference parity: geometry::q2r (utility/geometry_library.cpp).
    """
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    rows = [
        jnp.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], axis=-1),
        jnp.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], axis=-1),
        jnp.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], axis=-1),
    ]
    return jnp.stack(rows, axis=-2)


def rotation_to_quat(R: jax.Array) -> jax.Array:
    """(..., 3, 3) rotation -> (..., 4) quaternion (w, x, y, z), w >= 0.

    Branchless Shepperd's method: computes all four candidate quaternions and
    selects the best-conditioned one with `jnp.where` (XLA-friendly -- the
    reference's geometry::r2q uses data-dependent branches which cannot trace).
    """
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    # Four candidates, each scaled by 4*component^2 (always >= 0).
    qw_sq = jnp.maximum(1.0 + tr, 0.0)
    qx_sq = jnp.maximum(1.0 + m00 - m11 - m22, 0.0)
    qy_sq = jnp.maximum(1.0 - m00 + m11 - m22, 0.0)
    qz_sq = jnp.maximum(1.0 - m00 - m11 + m22, 0.0)

    # Candidate assuming w is largest.
    sw = jnp.sqrt(qw_sq)
    cand_w = jnp.stack([sw * sw, m21 - m12, m02 - m20, m10 - m01], axis=-1)
    # Candidate assuming x is largest.
    sx = jnp.sqrt(qx_sq)
    cand_x = jnp.stack([m21 - m12, sx * sx, m01 + m10, m02 + m20], axis=-1)
    # Candidate assuming y is largest.
    sy = jnp.sqrt(qy_sq)
    cand_y = jnp.stack([m02 - m20, m01 + m10, sy * sy, m12 + m21], axis=-1)
    # Candidate assuming z is largest.
    sz = jnp.sqrt(qz_sq)
    cand_z = jnp.stack([m10 - m01, m02 + m20, m12 + m21, sz * sz], axis=-1)

    comps = jnp.stack([qw_sq, qx_sq, qy_sq, qz_sq], axis=-1)
    best = jnp.argmax(comps, axis=-1)
    cands = jnp.stack([cand_w, cand_x, cand_y, cand_z], axis=-2)
    q = jnp.take_along_axis(cands, best[..., None, None], axis=-2)[..., 0, :]
    q = q / jnp.linalg.norm(q, axis=-1, keepdims=True)
    return q * jnp.where(q[..., :1] < 0, -1.0, 1.0)


def rotvec_to_quat(w: jax.Array) -> jax.Array:
    """(..., 3) rotation vector -> (..., 4) quaternion.

    Reference parity: geometry::rotvec2q (utility/geometry_library.cpp).
    """
    theta_sq = jnp.sum(w * w, axis=-1)
    theta = jnp.sqrt(jnp.where(theta_sq < _SMALL_ANGLE_SQ, 1.0, theta_sq))
    half = 0.5 * theta
    sin_half_over_theta = jnp.where(
        theta_sq < _SMALL_ANGLE_SQ, 0.5 - theta_sq / 48.0, jnp.sin(half) / theta
    )
    qw = jnp.where(theta_sq < _SMALL_ANGLE_SQ, 1.0 - theta_sq / 8.0, jnp.cos(half))
    return jnp.concatenate(
        [qw[..., None], sin_half_over_theta[..., None] * w], axis=-1
    )


def euler_to_rotation(roll: jax.Array, pitch: jax.Array, yaw: jax.Array) -> jax.Array:
    """ZYX euler angles -> rotation matrix R = Rz(yaw) Ry(pitch) Rx(roll).

    Reference parity: geometry::a2r (utility/geometry_library.cpp:181-205).
    """
    cr, sr = jnp.cos(roll), jnp.sin(roll)
    cp, sp = jnp.cos(pitch), jnp.sin(pitch)
    cy, sy = jnp.cos(yaw), jnp.sin(yaw)
    rows = [
        jnp.stack([cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr], axis=-1),
        jnp.stack([sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr], axis=-1),
        jnp.stack([-sp, cp * sr, cp * cr], axis=-1),
    ]
    return jnp.stack(rows, axis=-2)


def rotation_to_euler(R: jax.Array) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Rotation matrix -> (roll, pitch, yaw), inverse of `euler_to_rotation`.

    Reference parity: geometry::r2euler (utility/geometry_library.cpp:322-369).
    """
    pitch = jnp.arcsin(jnp.clip(-R[..., 2, 0], -1.0, 1.0))
    roll = jnp.arctan2(R[..., 2, 1], R[..., 2, 2])
    yaw = jnp.arctan2(R[..., 1, 0], R[..., 0, 0])
    return roll, pitch, yaw


# ---------------------------------------------------------------------------
# Planar (x, y, yaw) parameterization used by the 3-DoF pose-only solvers
# (core/pose_only_bundle_adjustment_solver.cpp:449-547)
# ---------------------------------------------------------------------------


def planar_to_se3(theta: jax.Array) -> tuple[jax.Array, jax.Array]:
    """(..., 3) planar params (x, y, psi) -> SE(3) with rotation about +z."""
    x, y, psi = theta[..., 0], theta[..., 1], theta[..., 2]
    c, s = jnp.cos(psi), jnp.sin(psi)
    zero = jnp.zeros_like(c)
    one = jnp.ones_like(c)
    rows = [
        jnp.stack([c, -s, zero], axis=-1),
        jnp.stack([s, c, zero], axis=-1),
        jnp.stack([zero, zero, one], axis=-1),
    ]
    R = jnp.stack(rows, axis=-2)
    t = jnp.stack([x, y, zero], axis=-1)
    return R, t


def se3_to_planar(R: jax.Array, t: jax.Array) -> jax.Array:
    """Extract (x, y, psi) from an (approximately) planar SE(3) transform.

    psi is read from the first column of R as atan2(R10, R00), matching the
    reference prior extraction (core/pose_only_bundle_adjustment_solver.cpp:456-460).
    """
    psi = jnp.arctan2(R[..., 1, 0], R[..., 0, 0])
    return jnp.stack([t[..., 0], t[..., 1], psi], axis=-1)
