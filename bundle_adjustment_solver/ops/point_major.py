"""Point-major full-BA operators in plain XLA.

Three operators over the point-major layout (models/layout.py), each a
jitted jnp/lax program on the layout's (slots, landmarks) planes:

  * `assemble_pm_tbl` -- one pass per LM iteration: gather each slot's pose
    row -> warp -> project -> residual -> Manhattan-Huber weight ->
    analytic Jacobians -> damped point blocks C/b/Cinv (reductions over the
    slot axis) + per-slot coupling blocks U + the pose-system partials
    (A, a, B Cinv b and optionally the Schur diagonal) summed into
    (n_opt, cols) rows by one segment-sum over `slot_opt`.
  * `matvec_corr_pm` -- the B Cinv B^T x correction of S @ x for block-PCG:
    gather x per slot -> t = U^T x -> v = Cinv t -> U v -> segment-sum;
    also returns t for back-substitution. `rhs_corr_pm` is the same
    operator with t := b (the B Cinv b correction of the reduced rhs).
  * `cost_pm_tbl` -- residual-only pass: sum of residual L2 norms (the
    reference cost metric, full cpp:427), the robust squared cost, the raw
    squared error, and the valid count.

Every per-observation quantity is elementwise f32 (no contraction runs at
reduced precision); the only cross-landmark traffic is the pose-row gather
and the segment-sum into pose rows. Padding and fixed-pose slots carry
`slot_opt = -1`, which the segment-sum drops and the x-gather maps to a
zero row.

Symmetric 3x3 component order: [xx, xy, xz, yy, yz, zz] (diag at 0, 3, 5).
U (pose 6 x point 3) component order: row-major e = a * 3 + c.
Cb plane rows: [0:6) damped C, [6:9) b, [9:15) Cinv, 15 slot-use count.
Pose-system columns: [0:21) upper-tri A, [21:27) a, [27:33) B Cinv b (the
reduced-rhs correction), and with emit_schur [33:54) the upper-tri
Schur-diagonal correction sum_i B_ji Cinv_i B_ji^T (the Schur-Jacobi
preconditioner by-product -- exact because each pose-slot of a landmark is
a unique (pose, landmark) pair, models/layout.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..models.layout import PMShape, PointMajorProblem
from .sym6 import _inv_sym3_cols as _inverse_sym3

_HI = jax.lax.Precision.HIGHEST

A_COLS = 33  # 21 upper-tri A + 6 gradient a + 6 rhs-corr (B Cinv b)
A_COLS_SCHUR = 54  # + 21 upper-tri Schur-diagonal correction columns

# Upper-triangle (a <= b) index pairs for the 6x6 pose block, row-major.
_TRI6 = [(a, b) for a in range(6) for b in range(a, 6)]
_SYM3 = [(0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)]


def pose_table(R_cw, t_cw):
    """Pack (N, 3, 3) + (N, 3) into the (N, 16) pose table
    [R row-major (9) | t (3) | zeros (4)] that the point-major solvers carry
    across LM iterations and the operators gather per slot."""
    N = R_cw.shape[0]
    return jnp.concatenate(
        [R_cw.reshape(N, 9), t_cw, jnp.zeros((N, 4), R_cw.dtype)], axis=1
    )


def _cam_table(rig):
    """(C, 16) camera table: [fx, fy, cx, cy, R(9), t(3)]."""
    C = rig.fx.shape[0]
    return jnp.concatenate(
        [
            jnp.stack([rig.fx, rig.fy, rig.cx, rig.cy], axis=1),
            rig.R_cam_from_ref.reshape(C, 9),
            rig.t_cam_from_ref,
        ],
        axis=1,
    ).astype(jnp.float32)


def _gather_pose_planes(pose_tbl, slot_pose):
    """(12, Kp, Mp) component planes [r00..r22, tx, ty, tz] of every slot's
    pose (padding slots carry pose 0 and are masked by the valid plane)."""
    g = jnp.take(pose_tbl[:, :12], slot_pose, axis=0)  # (Kp, Mp, 12)
    return jnp.moveaxis(g, -1, 0)


def _slot_values(v, slot_opt):
    """(k, Kp, Mp) planes of v (n_opt, k) at every slot's optimization
    index; fixed-pose and padding slots (slot_opt = -1) read a zero row."""
    n, k = v.shape
    tbl = jnp.concatenate([v, jnp.zeros((1, k), v.dtype)], axis=0)
    idx = jnp.where(slot_opt >= 0, slot_opt, n)
    return jnp.moveaxis(jnp.take(tbl, idx, axis=0), -1, 0)


def _sum_into_poses(rows, slot_opt, n_opt):
    """Segment-sum per-slot rows (each (Kp, Mp)) into (n_opt, len(rows)):
    one scatter-add; slots with slot_opt = -1 are dropped."""
    data = jnp.stack(rows, axis=-1).reshape(-1, len(rows))
    return jax.ops.segment_sum(
        data, slot_opt.reshape(-1), num_segments=n_opt
    )


def _warp_and_project(shape: PMShape, g, X, obs, cam_tbl, huber):
    """Shared residual-pass math on (Kp, Mp) component planes.

    g: (12, Kp, Mp) gathered pose rows; X: (4, Mp); obs: (3*Kp*C, Mp).
    Returns per-camera dicts of residual/weight/Jacobian inputs and the
    rig-reference-frame point coordinates."""
    Kp, C = shape.slots, shape.cams
    r = [g[i] for i in range(9)]  # row-major R_jw components, (Kp, Mp)
    t = [g[9 + i] for i in range(3)]
    x, y, z = X[0], X[1], X[2]  # (Mp,) broadcast over slots

    # World -> rig reference frame (full cpp:744-745).
    xr = r[0] * x + r[1] * y + r[2] * z + t[0]
    yr = r[3] * x + r[4] * y + r[5] * z + t[1]
    zr = r[6] * x + r[7] * y + r[8] * z + t[2]

    KC = Kp * C
    per_cam = []
    for c in range(C):
        fx, fy, cx, cy = (cam_tbl[c, k] for k in range(4))
        rc = [cam_tbl[c, 4 + i] for i in range(9)]
        tc = [cam_tbl[c, 13 + i] for i in range(3)]

        # Rig reference -> camera frame (full cpp:746-747).
        xc = rc[0] * xr + rc[1] * yr + rc[2] * zr + tc[0]
        yc = rc[3] * xr + rc[4] * yr + rc[5] * zr + tc[1]
        zc = rc[6] * xr + rc[7] * yr + rc[8] * zr + tc[2]

        pix_u = obs[c * Kp : (c + 1) * Kp]
        pix_v = obs[KC + c * Kp : KC + (c + 1) * Kp]
        valid = obs[2 * KC + c * Kp : 2 * KC + (c + 1) * Kp]

        # Guard padded slots (pose 0 may put them behind the camera).
        zsafe = jnp.where(jnp.abs(zc) > 1e-12, zc, 1.0)
        inv_z = 1.0 / zsafe
        ru = fx * xc * inv_z + cx - pix_u
        rv = fy * yc * inv_z + cy - pix_v
        man = jnp.abs(ru) + jnp.abs(rv)
        w = jnp.where(man > huber, huber / jnp.maximum(man, 1e-30), 1.0) * valid
        per_cam.append(
            dict(
                xc=xc, yc=yc, inv_z=inv_z, ru=ru, rv=rv, w=w, valid=valid,
                fx=fx, fy=fy, rc=rc,
            )
        )
    return per_cam, (xr, yr, zr)


def _jacobians(cam, lever):
    """Analytic Q (pose, 6) and Rj (point, 3) rows for one camera.

    Returns (Qu, Qv, Rju, Rjv): lists of 6/6/3/3 (Kp, Mp) planes.
    Mirrors full cpp:770-828 (projection Jacobian zero pattern, the
    [J_p | -J_p [X_ref]_x] pose block, Rj = J_p R_jw).
    """
    xr, yr, zr, Rjw = lever
    fx, fy, rc = cam["fx"], cam["fy"], cam["rc"]
    inv_z, xc, yc = cam["inv_z"], cam["xc"], cam["yc"]

    fx_iz = fx * inv_z
    fy_iz = fy * inv_z
    du_dz = -fx_iz * xc * inv_z
    dv_dz = -fy_iz * yc * inv_z
    # J_p rows through the rig extrinsic rotation (2x3).
    ju = [fx_iz * rc[0 + i] + du_dz * rc[6 + i] for i in range(3)]
    jv = [fy_iz * rc[3 + i] + dv_dz * rc[6 + i] for i in range(3)]

    # Rotation columns: J_p @ (-[X_ref]_x).
    qu_rot = [
        ju[2] * yr - ju[1] * zr,
        ju[0] * zr - ju[2] * xr,
        ju[1] * xr - ju[0] * yr,
    ]
    qv_rot = [
        jv[2] * yr - jv[1] * zr,
        jv[0] * zr - jv[2] * xr,
        jv[1] * xr - jv[0] * yr,
    ]
    # Rj = J_p @ R_jw: Rj[c] = sum_k J_p[k] R_jw[k, c].
    Rju = [
        ju[0] * Rjw[0 + c] + ju[1] * Rjw[3 + c] + ju[2] * Rjw[6 + c]
        for c in range(3)
    ]
    Rjv = [
        jv[0] * Rjw[0 + c] + jv[1] * Rjw[3 + c] + jv[2] * Rjw[6 + c]
        for c in range(3)
    ]
    return ju + qu_rot, jv + qv_rot, Rju, Rjv


def _sym3_apply(s, v):
    """Symmetric 3x3 (6 component planes) times a 3-vector of planes."""
    return [
        s[0] * v[0] + s[1] * v[1] + s[2] * v[2],
        s[1] * v[0] + s[3] * v[1] + s[4] * v[2],
        s[2] * v[0] + s[4] * v[1] + s[5] * v[2],
    ]


@functools.partial(jax.jit, static_argnames=("shape", "u_dtype", "emit_schur"))
def assemble_pm_tbl(pm: PointMajorProblem, shape: PMShape, pose_tbl, X, rig,
                    lam, huber, u_dtype: str = "float32",
                    emit_schur: bool = False):
    """Fused assembly on the carried (N, 16) pose table.

    Returns (flat, Cb, U):
      flat (n_opt, A_COLS or A_COLS_SCHUR): [0:21) undamped upper-tri A,
      [21:27) gradient a, [27:33) B Cinv b, and with emit_schur=True
      [33:54) the Schur-diagonal correction (schur_precond_tri input) --
      per-shard partials in distributed mode (reduce them over the mesh);
      Cb (16, Mp) point-block planes (damped, local to this shard's points);
      U (18, Kp, Mp) coupling planes in `u_dtype`.
    """
    with jax.named_scope("pm_assemble"):
        Kp, C = shape.slots, shape.cams
        cam_tbl = _cam_table(rig)
        g = _gather_pose_planes(pose_tbl, pm.slot_pose)
        pmask = X[3]  # (Mp,) 1.0 for optimizable landmarks
        per_cam, (xr, yr, zr) = _warp_and_project(
            shape, g, X, pm.obs_f32, cam_tbl, huber
        )
        Rjw = [g[i] for i in range(9)]

        Csym = [0.0] * 6
        bvec = [0.0] * 3
        Ue = [0.0] * 18
        Atri = [0.0] * 21
        avec = [0.0] * 6
        slot_use = 0.0
        for c in range(C):
            cam = per_cam[c]
            w, ru, rv = cam["w"], cam["ru"], cam["rv"]
            Qu, Qv, Rju, Rjv = _jacobians(cam, (xr, yr, zr, Rjw))
            slot_use = jnp.maximum(slot_use, cam["valid"])
            # Point block C += w (Rju Rju^T + Rjv Rjv^T), gradient
            # b -= w Rj^T r (full cpp:812-823), reduced over slots.
            for n, (a, b) in enumerate(_SYM3):
                Csym[n] = Csym[n] + jnp.sum(
                    w * (Rju[a] * Rju[b] + Rjv[a] * Rjv[b]), axis=0
                )
            for a in range(3):
                bvec[a] = bvec[a] - jnp.sum(
                    w * (Rju[a] * ru + Rjv[a] * rv), axis=0
                )
            # Coupling U += w Q^T Rj (accumulated over cameras; the
            # reference overwrites -- deliberate fix, see ops/hessian.py).
            for a in range(6):
                for b in range(3):
                    Ue[a * 3 + b] = Ue[a * 3 + b] + w * (
                        Qu[a] * Rju[b] + Qv[a] * Rjv[b]
                    )
            # Pose block A += w Q^T Q (upper-tri), a -= w Q^T r
            # (cpp:795-809).
            for n, (a, b) in enumerate(_TRI6):
                Atri[n] = Atri[n] + w * (Qu[a] * Qu[b] + Qv[a] * Qv[b])
            for a in range(6):
                avec[a] = avec[a] - w * (Qu[a] * ru + Qv[a] * rv)

        # Damped point blocks + closed-form inverse; fixed landmarks
        # (pmask == 0) zero out C -> Cinv = 0 -> they drop out of the Schur
        # system.
        damp = 1.0 + lam
        Cd = [Csym[n] * pmask for n in range(6)]
        for n in (0, 3, 5):
            Cd[n] = Cd[n] * damp
        Cinv = _inverse_sym3(Cd)
        bm = [bvec[a] * pmask for a in range(3)]
        Cb = jnp.stack(
            Cd + bm + Cinv + [jnp.sum(slot_use, axis=0)]
        )  # (16, Mp)

        # U planes, masked so fixed landmarks never couple.
        Um = [Ue[e] * pmask for e in range(18)]
        U = jnp.stack(Um).astype(u_dtype)

        # Reduced-rhs correction B Cinv b per slot: U (Cinv b).
        v = _sym3_apply(Cinv, bm)
        rhs_rows = [
            Um[a * 3] * v[0] + Um[a * 3 + 1] * v[1] + Um[a * 3 + 2] * v[2]
            for a in range(6)
        ]
        # Schur-Jacobi by-product: per-slot U Cinv U^T, whose landmark sum
        # is exactly the Schur-diagonal correction for that slot's pose
        # (each slot is a unique (pose, landmark) pair).
        schur_rows = []
        if emit_schur:
            for a in range(6):
                wa = _sym3_apply(Cinv, Um[a * 3 : a * 3 + 3])
                for b in range(a, 6):
                    schur_rows.append(
                        wa[0] * Um[b * 3] + wa[1] * Um[b * 3 + 1]
                        + wa[2] * Um[b * 3 + 2]
                    )
        flat = _sum_into_poses(
            Atri + avec + rhs_rows + schur_rows, pm.slot_opt,
            shape.num_opt_poses,
        )
    return flat, Cb, U


def assemble_pm_partials(pm: PointMajorProblem, shape: PMShape, R_cw, t_cw,
                         X, rig, lam, huber, u_dtype: str = "float32",
                         emit_schur: bool = False):
    """`assemble_pm_tbl` from (N, 3, 3) rotations and (N, 3) translations."""
    return assemble_pm_tbl(
        pm, shape, pose_table(R_cw, t_cw), X, rig, lam, huber,
        u_dtype=u_dtype, emit_schur=emit_schur,
    )


def _tri_to_full(Atri):
    """(n, 21) upper-tri -> (n, 6, 6) symmetric."""
    n = Atri.shape[0]
    A = jnp.zeros((n, 6, 6), Atri.dtype)
    for k, (a, b) in enumerate(_TRI6):
        A = A.at[:, a, b].set(Atri[:, k])
        if a != b:
            A = A.at[:, b, a].set(Atri[:, k])
    return A


def finish_pose_system_tri(flat, lam):
    """Flat pose-system partials -> (damped Atri (n_opt, 21), a (n_opt, 6),
    rhs (n_opt, 6) = a - B Cinv b), staying in the flat layout (see
    ops/sym6.py). In distributed mode, reduce `flat` over the data axis
    first."""
    from .sym6 import tri6_damp

    # (1 + lambda) diagonal damping on the pose blocks (cpp:838-846).
    a = flat[:, 21:27]
    rhs = a - flat[:, 27:33]
    return tri6_damp(flat[:, :21], lam), a, rhs


def schur_precond_tri(flat, lam):
    """Schur-Jacobi preconditioner blocks from the assembly partials:
    diag_j(S) = damped A_jj - sum_i B_ji Cinv_i B_ji^T, flat (n_opt, 21) tri
    layout (invert with ops/sym6.inverse_tri6).

    This is the standard BA preconditioner (the diagonal blocks of the exact
    reduced camera matrix S; cf. the block-Jacobi-on-A baseline it replaces,
    which ignores the Schur correction entirely). SPD for lam > 0: per
    (pose j, landmark i) pair, C_i >= the pair's own R^T R sub-block, so
    B_ji Cinv_i B_ji^T <= the pair's Q^T Q contribution to A_jj (Schur
    complement of the pair's PSD normal block); summing over i and adding
    the (1 + lam) damping keeps diag_j(S) positive definite. In distributed
    mode reduce `flat` over the data axis first (landmark sums).
    """
    from .sym6 import tri6_damp

    if flat.shape[1] < A_COLS_SCHUR:
        raise ValueError(
            "flat has no Schur-diagonal columns; call assemble_pm_partials "
            "with emit_schur=True"
        )
    return tri6_damp(flat[:, :21], lam) - flat[:, 33:54]


def finish_pose_system(flat, lam):
    """Flat pose-system partials -> (damped A (n_opt, 6, 6), a (n_opt, 6)).
    Materialized form, for parity tests and external consumers; the solvers
    use finish_pose_system_tri."""
    Atri, a, _ = finish_pose_system_tri(flat, lam)
    return _tri_to_full(Atri), a


def assemble_pm(pm: PointMajorProblem, shape: PMShape, R_cw, t_cw, X, rig,
                lam, huber, u_dtype: str = "float32"):
    """Single-device assembly: (A damped, a, Cb, U). Defaults to f32
    coupling blocks for exact parity checks; solvers pass
    Options.coupling_dtype."""
    flat, Cb, U = assemble_pm_partials(
        pm, shape, R_cw, t_cw, X, rig, lam, huber, u_dtype=u_dtype,
    )
    A, a = finish_pose_system(flat, lam)
    return A, a, Cb, U


def _correction(pm, shape: PMShape, Cb, U, t):
    """Per-slot U (Cinv t) rows summed into (n_opt, 6)."""
    Uf = U.astype(jnp.float32)
    v = _sym3_apply([Cb[9 + n] for n in range(6)], t)
    rows = [
        Uf[a * 3] * v[0] + Uf[a * 3 + 1] * v[1] + Uf[a * 3 + 2] * v[2]
        for a in range(6)
    ]
    return _sum_into_poses(rows, pm.slot_opt, shape.num_opt_poses)


@functools.partial(jax.jit, static_argnames=("shape",))
def matvec_corr_pm(pm: PointMajorProblem, shape: PMShape, Cb, U, x):
    """The B Cinv B^T x correction of S @ x, as a per-shard partial (reduce
    over the mesh in distributed mode). Returns (corr (n_opt, 6),
    t (3, Mp)) where t = B^T x per landmark (used for back-substitution)."""
    with jax.named_scope("pm_matvec"):
        xg = _slot_values(x, pm.slot_opt)  # (6, Kp, Mp)
        Uf = U.astype(jnp.float32)
        t = [
            jnp.sum(sum(Uf[a * 3 + c] * xg[a] for a in range(6)), axis=0)
            for c in range(3)
        ]
        return _correction(pm, shape, Cb, U, t), jnp.stack(t)


@functools.partial(jax.jit, static_argnames=("shape",))
def rhs_corr_pm(pm: PointMajorProblem, shape: PMShape, Cb, U):
    """The B Cinv b correction of the reduced rhs, per-shard partial."""
    return _correction(pm, shape, Cb, U, [Cb[6], Cb[7], Cb[8]])


def schur_matvec_pm(pm: PointMajorProblem, shape: PMShape, A, Cb, U, x):
    """S @ x for a single-device PCG loop. x: (n_opt, 6). Returns
    (Sx (n_opt, 6), t (3, Mp))."""
    corr, t = matvec_corr_pm(pm, shape, Cb, U, x)
    Ax = jnp.einsum("jab,jb->ja", A, x, precision=_HI)
    return Ax - corr, t


def schur_rhs_pm(pm: PointMajorProblem, shape: PMShape, a, Cb, U):
    """Reduced rhs = a - B Cinv b, matrix-free (cpp:887-888)."""
    return a - rhs_corr_pm(pm, shape, Cb, U)


@functools.partial(jax.jit, static_argnames=("shape",))
def cost_pm_tbl(pm: PointMajorProblem, shape: PMShape, pose_tbl, X, rig,
                huber):
    """Residual-only cost pass on the carried (N, 16) pose table. Returns
    (sum ||r||, sum w r^2, sum r^2, valid count) as f32 scalars (scaled
    pixel units)."""
    with jax.named_scope("pm_cost"):
        g = _gather_pose_planes(pose_tbl, pm.slot_pose)
        per_cam, _ = _warp_and_project(
            shape, g, X, pm.obs_f32, _cam_table(rig), huber
        )
        s_norm = s_wsq = s_sq = s_cnt = 0.0
        for cam in per_cam:
            ru, rv, w, valid = cam["ru"], cam["rv"], cam["w"], cam["valid"]
            sq = ru * ru + rv * rv
            s_norm = s_norm + jnp.sum(valid * jnp.sqrt(jnp.maximum(sq, 0.0)))
            s_wsq = s_wsq + jnp.sum(w * sq)
            s_sq = s_sq + jnp.sum(valid * sq)
            s_cnt = s_cnt + jnp.sum(valid)
    return s_norm, s_wsq, s_sq, s_cnt


def cost_pm(pm: PointMajorProblem, shape: PMShape, R_cw, t_cw, X, rig, huber):
    """`cost_pm_tbl` from (N, 3, 3) rotations and (N, 3) translations."""
    return cost_pm_tbl(pm, shape, pose_table(R_cw, t_cw), X, rig, huber)
