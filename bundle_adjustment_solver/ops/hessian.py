"""Block-sparse Hessian assembly and the Schur-complement reduced system.

JAX re-design of the reference's Schur pipeline
(core/full_bundle_adjustment_solver.cpp):
  - per-observation rank-1 accumulation into A (6x6 per pose), C (3x3 per
    point), gradients a/b, and B coupling blocks (6x3 per (pose, point) pair)
    -- the serial observation loop at cpp:716-831 becomes one fused batched
    kernel + `segment_sum`s;
  - (1 + lambda) diagonal damping and per-landmark C^-1 (cpp:833-856) --
    batched closed-form 3x3 inverses instead of M serial LDLT solves;
  - the Schur product S = A - B C^-1 B^T and reduced rhs (cpp:858-888);
  - the reduced camera solve (cpp:890-908), in two interchangeable forms:
      * 'dense'  -- materialize S (6N x 6N) exactly like the reference and
        Cholesky-solve it; right for N_opt up to ~1k. The two big einsums are
        (6N, 3M) x (3M, 6N) matmuls.
      * 'cg'     -- matrix-free block-Jacobi-preconditioned conjugate
        gradients on S, whose matvec is two observation-indexed passes
        (O(#obs) per iteration); required at the 10k-pose / 1M-landmark scale
        where dense N x M storage is impossible (SURVEY.md §6).
  - back-substitution y = C^-1 (b - B^T x) (cpp:911-917).

One deliberate fix vs the reference: the reference *overwrites* B[j][i] per
observation (cpp:826: `B_[j][i] = ...`), so when two cameras of a rig observe
the same (pose, point) pair the first camera's coupling is lost. We
accumulate, which is the mathematically correct Gauss-Newton coupling block.

Index conventions: every observation carries `pose_opt` in [0, N_opt] and
`point_opt` in [0, M_opt], where the sentinel value N_opt / M_opt means "the
pose/point is fixed (gauge)" -- segment sums use num_segments = N_opt + 1 and
the padding row is dropped, so fixed parameters contribute to cost but never
to the normal equations, replacing the reference's index remapping
(FinalizeParameters, cpp:182-206).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

_HIGHEST = jax.lax.Precision.HIGHEST


class BlockSystem(NamedTuple):
    """The damped block normal equations of one LM iteration.

    Shapes: A (N_opt, 6, 6), a (N_opt, 6), C (M_opt, 3, 3), Cinv like C,
    b (M_opt, 3), U (O, 6, 3) per-observation coupling contributions.
    A and C carry the (1 + lambda) diagonal damping already applied
    (reference cpp:833-856); `A_undamped`/`C_undamped` keep the raw blocks
    for the quadratic-model bookkeeping (cpp:435-455 uses damped blocks, but
    GN/GD modes and diagnostics want the raw ones).
    """

    A: jax.Array
    a: jax.Array
    C: jax.Array
    Cinv: jax.Array
    b: jax.Array
    U: jax.Array


def inverse_3x3(C: jax.Array) -> jax.Array:
    """Batched closed-form (adjugate) inverse of (..., 3, 3) matrices.

    Replaces the reference's per-landmark `C.ldlt().solve(I)` (cpp:854) with
    branch-free elementwise math -- no factorization, one reciprocal per matrix.
    """
    a, b, c = C[..., 0, 0], C[..., 0, 1], C[..., 0, 2]
    d, e, f = C[..., 1, 0], C[..., 1, 1], C[..., 1, 2]
    g, h, i = C[..., 2, 0], C[..., 2, 1], C[..., 2, 2]
    co00 = e * i - f * h
    co01 = f * g - d * i
    co02 = d * h - e * g
    det = a * co00 + b * co01 + c * co02
    # Singular guard: a landmark with no (or rank-deficient) observations has
    # det(C) == 0; its inverse is defined as 0, freezing that landmark for
    # the iteration (b is also 0, so y = 0 and the Schur correction vanishes).
    # The reference NaNs in this case (cpp:854 LDLT of a zero matrix) -- its
    # tests just never register an unobserved landmark.
    inv_det = jnp.where(det > 1e-30, 1.0 / jnp.where(det > 1e-30, det, 1.0), 0.0)
    rows = [
        jnp.stack([co00, c * h - b * i, b * f - c * e], axis=-1),
        jnp.stack([co01, a * i - c * g, c * d - a * f], axis=-1),
        jnp.stack([co02, b * g - a * h, a * e - b * d], axis=-1),
    ]
    return jnp.stack(rows, axis=-2) * inv_det[..., None, None]


def assemble_block_system(
    Q: jax.Array,  # (O, 2, 6) pose Jacobians
    Rj: jax.Array,  # (O, 2, 3) point Jacobians
    r: jax.Array,  # (O, 2) residuals
    w: jax.Array,  # (O,) robust weights (0 for padded observations)
    pose_opt: jax.Array,  # (O,) int32 in [0, N_opt]; N_opt == fixed sentinel
    point_opt: jax.Array,  # (O,) int32 in [0, M_opt]
    n_opt_poses: int,
    n_opt_points: int,
    lam: jax.Array,  # () damping
) -> BlockSystem:
    """Build the damped block normal equations from per-observation Jacobians.

    Mirrors the accumulation of the reference observation loop
    (cpp:795-828) with `segment_sum` over optimization indices, then applies
    the (1 + lambda) diagonal damping (cpp:833-856).
    """
    wQ = Q * w[:, None, None]
    wRj = Rj * w[:, None, None]
    wr = r * w[:, None]

    # Gradients: a_j = -sum Q^T w r ; b_i = -sum R^T w r  (cpp:809, 823)
    grad_pose = -jnp.einsum("ora,or->oa", Q, wr, precision=_HIGHEST)
    grad_point = -jnp.einsum("ora,or->oa", Rj, wr, precision=_HIGHEST)
    a = jax.ops.segment_sum(grad_pose, pose_opt, num_segments=n_opt_poses + 1)[
        :n_opt_poses
    ]
    b = jax.ops.segment_sum(grad_point, point_opt, num_segments=n_opt_points + 1, indices_are_sorted=True)[
        :n_opt_points
    ]

    # Block Hessians: A_j = sum w Q^T Q, C_i = sum w R^T R (cpp:804-821)
    AtA = jnp.einsum("ora,orb->oab", wQ, Q, precision=_HIGHEST)
    RtR = jnp.einsum("ora,orb->oab", wRj, Rj, precision=_HIGHEST)
    A = jax.ops.segment_sum(AtA, pose_opt, num_segments=n_opt_poses + 1)[
        :n_opt_poses
    ]
    C = jax.ops.segment_sum(RtR, point_opt, num_segments=n_opt_points + 1, indices_are_sorted=True)[
        :n_opt_points
    ]

    # Per-observation coupling U_o = w Q^T R (accumulated into B downstream;
    # the reference overwrites -- see module docstring).
    U = jnp.einsum("ora,orb->oab", wQ, Rj, precision=_HIGHEST)

    # (1 + lambda) diagonal damping (cpp:838-852).
    damp = 1.0 + lam
    eye6 = jnp.eye(6, dtype=Q.dtype)
    eye3 = jnp.eye(3, dtype=Q.dtype)
    A_damped = A * (1.0 + (damp - 1.0) * eye6)
    C_damped = C * (1.0 + (damp - 1.0) * eye3)

    Cinv = inverse_3x3(C_damped)
    return BlockSystem(A=A_damped, a=a, C=C_damped, Cinv=Cinv, b=b, U=U)


def dense_coupling(
    U: jax.Array,
    pose_opt: jax.Array,
    point_opt: jax.Array,
    n_opt_poses: int,
    n_opt_points: int,
) -> jax.Array:
    """Materialize the dense coupling tensor B (N_opt, 6, M_opt, 3).

    This is the reference's dense N x M block storage (SetProblemSize,
    cpp:243-308) -- only valid for small problems; the 'cg' path never calls
    this.
    """
    pair_key = pose_opt * (n_opt_points + 1) + point_opt
    num_pairs = (n_opt_poses + 1) * (n_opt_points + 1)
    B_pairs = jax.ops.segment_sum(U, pair_key, num_segments=num_pairs)
    B = B_pairs.reshape(n_opt_poses + 1, n_opt_points + 1, 6, 3)[
        :n_opt_poses, :n_opt_points
    ]
    return jnp.transpose(B, (0, 2, 1, 3))  # (N_opt, 6, M_opt, 3)


def schur_reduce_dense(
    sys: BlockSystem,
    B: jax.Array,  # (N_opt, 6, M_opt, 3)
) -> tuple[jax.Array, jax.Array]:
    """Explicit reduced camera system: S = A - B C^-1 B^T, rhs = a - B C^-1 b.

    Reference cpp:858-888, restructured as two fat matmuls:
    BCinv is (6N, 3M) and S's correction term is (6N, 3M) @ (3M, 6N).
    """
    n_opt = sys.A.shape[0]
    BCinv = jnp.einsum("jaib,ibc->jaic", B, sys.Cinv, precision=_HIGHEST)
    corr = jnp.einsum("jaic,kbic->jakb", BCinv, B, precision=_HIGHEST)
    S = -corr
    diag = jnp.arange(n_opt)
    S = S.at[diag, :, diag, :].add(sys.A)
    rhs = sys.a - jnp.einsum("jaib,ib->ja", BCinv, sys.b, precision=_HIGHEST)
    return S.reshape(n_opt * 6, n_opt * 6), rhs.reshape(n_opt * 6)


def back_substitute_dense(
    sys: BlockSystem,
    B: jax.Array,  # (N_opt, 6, M_opt, 3)
    x: jax.Array,  # (N_opt, 6) pose steps
) -> jax.Array:
    """y_i = C^-1 (b_i - sum_j B_ji^T x_j)  (reference cpp:911-917)."""
    Bt_x = jnp.einsum("jaib,ja->ib", B, x, precision=_HIGHEST)
    return jnp.einsum(
        "iab,ib->ia", sys.Cinv, sys.b - Bt_x, precision=_HIGHEST
    )


# ---------------------------------------------------------------------------
# Matrix-free path: S matvec + preconditioned CG (the scalable reduced solve)
# ---------------------------------------------------------------------------


def _gather_padded(blocks: jax.Array, idx: jax.Array, n_real: int) -> jax.Array:
    """Gather per-observation rows from (n_real, ...) blocks where idx may be
    the fixed-sentinel n_real; sentinel rows read zeros."""
    padded = jnp.concatenate(
        [blocks, jnp.zeros((1,) + blocks.shape[1:], blocks.dtype)], axis=0
    )
    return padded[idx]


def schur_matvec(
    sys: BlockSystem,
    pose_opt: jax.Array,
    point_opt: jax.Array,
    n_opt_poses: int,
    n_opt_points: int,
    x: jax.Array,  # (N_opt, 6)
) -> jax.Array:
    """S @ x without materializing S or B: two observation-indexed passes.

    S x = A x - sum_i B_:i C_i^-1 B_:i^T x, where B_ji = sum_{o in (j,i)} U_o:
      pass 1: t_i = sum_o U_o^T x_{j(o)}  (segment over points)
      v_i = C_i^-1 t_i
      pass 2: (Sx)_j -= sum_o U_o v_{i(o)} (segment over poses)
    Cost O(#obs) -- the landmark axis never materializes pose-pair storage,
    which is what lets M scale to 10^6+ (SURVEY.md §5 long-axis scaling).
    """
    xg = _gather_padded(x, pose_opt, n_opt_poses)  # (O, 6)
    u = jnp.einsum("oab,oa->ob", sys.U, xg, precision=_HIGHEST)  # (O, 3)
    t = jax.ops.segment_sum(u, point_opt, num_segments=n_opt_points + 1, indices_are_sorted=True)[
        :n_opt_points
    ]
    v = jnp.einsum("iab,ib->ia", sys.Cinv, t, precision=_HIGHEST)
    vg = _gather_padded(v, point_opt, n_opt_points)  # (O, 3)
    wvec = jnp.einsum("oab,ob->oa", sys.U, vg, precision=_HIGHEST)  # (O, 6)
    corr = jax.ops.segment_sum(wvec, pose_opt, num_segments=n_opt_poses + 1)[
        :n_opt_poses
    ]
    Ax = jnp.einsum("jab,jb->ja", sys.A, x, precision=_HIGHEST)
    return Ax - corr


def schur_rhs(
    sys: BlockSystem,
    pose_opt: jax.Array,
    point_opt: jax.Array,
    n_opt_poses: int,
    n_opt_points: int,
) -> jax.Array:
    """rhs = a - B C^-1 b, matrix-free (reference cpp:887-888)."""
    Cinv_b = jnp.einsum("iab,ib->ia", sys.Cinv, sys.b, precision=_HIGHEST)
    cb = _gather_padded(Cinv_b, point_opt, n_opt_points)  # (O, 3)
    contrib = jnp.einsum("oab,ob->oa", sys.U, cb, precision=_HIGHEST)
    BCinv_b = jax.ops.segment_sum(
        contrib, pose_opt, num_segments=n_opt_poses + 1
    )[:n_opt_poses]
    return sys.a - BCinv_b


def back_substitute_matfree(
    sys: BlockSystem,
    pose_opt: jax.Array,
    point_opt: jax.Array,
    n_opt_poses: int,
    n_opt_points: int,
    x: jax.Array,
) -> jax.Array:
    """y = C^-1 (b - B^T x) via one observation pass (reference cpp:911-917)."""
    xg = _gather_padded(x, pose_opt, n_opt_poses)
    u = jnp.einsum("oab,oa->ob", sys.U, xg, precision=_HIGHEST)
    Bt_x = jax.ops.segment_sum(u, point_opt, num_segments=n_opt_points + 1, indices_are_sorted=True)[
        :n_opt_points
    ]
    return jnp.einsum(
        "iab,ib->ia", sys.Cinv, sys.b - Bt_x, precision=_HIGHEST
    )


def schur_diag_correction(
    sys: BlockSystem,
    pose_opt: jax.Array,
    point_opt: jax.Array,
    n_opt_poses: int,
    n_opt_points: int,
) -> jax.Array:
    """Per-pose (N_opt, 6, 6) correction sum_o U_o Cinv_{i(o)} U_o^T of the
    Schur-Jacobi preconditioner (one observation-indexed pass).

    Per-OBSERVATION approximation of the exact Schur diagonal
    sum_i B_ji Cinv_i B_ji^T: exact when every (pose, point) pair has one
    observation (mono); for multi-camera rigs it drops the cross-camera
    terms U_o1 Cinv U_o2^T, which keeps it cheap and -- by the per-residual
    Schur-complement bound w Q_o^T Q_o >= U_o (w R_o^T R_o)^-1 U_o^T >=
    U_o Cinv_i U_o^T -- guarantees A_damped - correction stays positive
    definite, the only property a preconditioner needs. (The point-major
    engine computes the pair-exact version in its assembly,
    ops/point_major.py.)
    """
    return schur_diag_correction_arrays(
        sys.U, sys.Cinv, pose_opt, point_opt, n_opt_poses, n_opt_points
    )


def schur_diag_correction_arrays(
    U: jax.Array,  # (O, 6, 3)
    Cinv: jax.Array,  # (M_opt, 3, 3)
    pose_opt: jax.Array,  # (O,)
    point_opt: jax.Array,  # (O,)
    n_opt_poses: int,
    n_opt_points: int,
) -> jax.Array:
    """Array-level core of `schur_diag_correction`, shared with the
    shard_map engine (parallel/sharded_ba.py, which psums the per-shard
    partial this returns)."""
    Cinv_g = _gather_padded(Cinv, point_opt, n_opt_points)  # (O, 3, 3)
    UC = jnp.einsum("oab,obc->oac", U, Cinv_g, precision=_HIGHEST)
    UCUt = jnp.einsum("oac,obc->oab", UC, U, precision=_HIGHEST)
    return jax.ops.segment_sum(
        UCUt, pose_opt, num_segments=n_opt_poses + 1
    )[:n_opt_poses]


def block_pcg(
    matvec,
    rhs: jax.Array,  # (N_opt, 6)
    precond_inv: jax.Array,  # (N_opt, 6, 6) block preconditioner inverse
    max_iterations: int,
    tolerance,
    x0: jax.Array | None = None,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Block-preconditioned conjugate gradients on the reduced system.

    Replaces the reference's dense `S.ldlt()` (cpp:905) beyond ~1k poses.
    `tolerance` may be traced (Eisenstat-Walker forcing); `x0` warm-starts
    (one extra matvec). Returns (x, final |r|^2, iterations used).
    """

    def apply_precond(r):
        return jnp.einsum("jab,jb->ja", precond_inv, r, precision=_HIGHEST)

    if x0 is None:
        x0 = jnp.zeros_like(rhs)
        r0 = rhs
    else:
        r0 = rhs - matvec(x0)
    z0 = apply_precond(r0)
    p0 = z0
    rz0 = jnp.sum(r0 * z0)
    rhs_sq = jnp.maximum(jnp.sum(rhs * rhs), 1e-30)

    def cond(state):
        _, r, _, _, rz, it = state
        return jnp.logical_and(
            it < max_iterations, jnp.sum(r * r) > tolerance * rhs_sq
        )

    def body(state):
        x, r, z, p, rz, it = state
        Sp = matvec(p)
        alpha = rz / jnp.maximum(jnp.sum(p * Sp), 1e-30)
        x = x + alpha * p
        r = r - alpha * Sp
        z = apply_precond(r)
        rz_new = jnp.sum(r * z)
        beta = rz_new / jnp.maximum(rz, 1e-30)
        p = z + beta * p
        return (x, r, z, p, rz_new, it + 1)

    x, r, _, _, _, it = jax.lax.while_loop(
        cond, body, (x0, r0, z0, p0, rz0, jnp.asarray(0, jnp.int32))
    )
    return x, jnp.sum(r * r), it


def inverse_6x6(A: jax.Array) -> jax.Array:
    """Batched 6x6 inverse (block-Jacobi preconditioner for PCG).

    Uses blockwise 2x2-of-3x3 inversion (Schur on the 3x3 sub-blocks) so the
    whole thing stays closed-form elementwise math -- no LU pivoting.
    Damped Gauss-Newton pose blocks are SPD, so the (1,1) sub-block and its
    Schur complement are invertible.
    """
    P = A[..., :3, :3]
    Q = A[..., :3, 3:]
    R = A[..., 3:, :3]
    S = A[..., 3:, 3:]
    Pinv = inverse_3x3(P)
    RPinv = jnp.einsum("...ab,...bc->...ac", R, Pinv, precision=_HIGHEST)
    schur = S - jnp.einsum("...ab,...bc->...ac", RPinv, Q, precision=_HIGHEST)
    schur_inv = inverse_3x3(schur)
    PinvQ = jnp.einsum("...ab,...bc->...ac", Pinv, Q, precision=_HIGHEST)
    top_left = Pinv + jnp.einsum(
        "...ab,...bc,...cd->...ad", PinvQ, schur_inv, RPinv, precision=_HIGHEST
    )
    top_right = -jnp.einsum(
        "...ab,...bc->...ac", PinvQ, schur_inv, precision=_HIGHEST
    )
    bottom_left = -jnp.einsum(
        "...ab,...bc->...ac", schur_inv, RPinv, precision=_HIGHEST
    )
    top = jnp.concatenate([top_left, top_right], axis=-1)
    bottom = jnp.concatenate([bottom_left, schur_inv], axis=-1)
    return jnp.concatenate([top, bottom], axis=-2)
