"""Point-major full-BA solver: the engine for large problems.

Same algorithm and trust-region semantics as solvers/full_ba.py (the
observation-table engine; see its docstring for the reference file:line
mapping into core/full_bundle_adjustment_solver.cpp:630-1044), but running on
the point-major layout (models/layout.py) with the operators of
ops/point_major.py:

  * one `assemble_pm_tbl` pass per LM iteration builds the damped block
    normal equations (A, a, C, Cinv, b, U);
  * the reduced camera system is solved matrix-free with block-Jacobi PCG
    whose S @ x correction is one `matvec_corr_pm` call;
  * back-substitution reuses the matvec's t = B^T x output:
    y = Cinv (b - t);
  * the quadratic-model decrease needs no extra observation pass:
    B^T x == b - C y identically (from the back-substitution), so
    model = -(a^T x + x^T A x + b^T y + y^T C y + 2 y^T (b - C y));
  * candidate costs come from the residual-only `cost_pm_tbl` pass.

Every point-side reduction (C, b, Cinv) is a reduction over the static slot
axis instead of a per-observation segment-sum; only the pose side scatters.

Parity: identical math to full_ba.py up to f32 reduction order; tests assert
block-system and final-cost agreement.
"""

from __future__ import annotations

import functools
import time
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..models.layout import PMShape, PointMajorProblem, build_point_major
from ..models.problem import FinalizedProblem, ProblemShape
from ..ops.lie import compose_flat, inverse_se3, se3_exp
from ..ops import point_major as K
from ..options import IterationStatus, Options, SolverType
from ..summary import (
    INFO_ABS_GRADIENT,
    INFO_ABS_STEP,
    INFO_AVG_REPROJ,
    INFO_CG_ITERS,
    INFO_COST,
    INFO_COST_CHANGE,
    INFO_DAMPING,
    INFO_NUM_COLS,
    INFO_STATUS,
    Summary,
)
from ..utils.device import on_gpu
from .full_ba import FullBAState, _GN_LAMBDA, _cg_tolerance

_HI = jax.lax.Precision.HIGHEST


class _Carry(NamedTuple):
    # Poses live in the packed (N, 16) table the operators gather from
    # (R row-major in cols 0:9, t in 9:12, rest zero), so no LM iteration
    # rebuilds it from (N, 3, 3) arrays.
    tbl: jax.Array
    X: jax.Array  # (4, Mp) point-major (row 3 = opt mask, never changes)
    lam: jax.Array
    prev_cost: jax.Array
    it: jax.Array
    done: jax.Array
    converged: jax.Array
    info: jax.Array
    num_info: jax.Array
    # Inner-CG state across LM iterations: previous pose step (warm start),
    # previous reduced-rhs norm and forcing tolerance (Eisenstat-Walker).
    x_prev: jax.Array  # (n_opt, 6)
    rhs_norm_prev: jax.Array  # ()
    eta_prev: jax.Array  # ()


def pm_from_finalized(
    problem: FinalizedProblem,
    shape: ProblemShape,
    block_points: int | None = None,
    max_slots: int = 32,
    max_window: int = 2048,
    host: dict | None = None,
    pad_blocks_to: int = 1,
):
    """Build the point-major layout from a finalized problem, or None when
    the problem exceeds the layout's static bounds (fall back to full_ba).

    Pass `host` (from finalized_from_arrays(..., return_host=True)) to avoid
    reading the observation table back from the device.

    block_points default: 1024 landmarks per block at >= 100k landmarks,
    256 below (less padding waste on small problems).
    """
    if block_points is None:
        block_points = 1024 if shape.num_points >= 100_000 else 256
    if host is None:
        n_opt = shape.num_opt_poses
        pose_opt_of = np.full(shape.num_poses, n_opt, dtype=np.int32)
        pose_opt_of[np.asarray(problem.opt_pose_idx)] = np.arange(
            n_opt, dtype=np.int32
        )
        point_is_opt = np.zeros(shape.num_points, dtype=bool)
        point_is_opt[np.asarray(problem.opt_point_idx)] = True
        host = dict(
            obs_pose=np.asarray(problem.obs_pose),
            obs_point=np.asarray(problem.obs_point),
            obs_cam=np.asarray(problem.obs_cam),
            obs_pixel=np.asarray(problem.obs_pixel, dtype=np.float64),
            points=np.asarray(problem.points, dtype=np.float64),
            pose_opt_of=pose_opt_of,
            point_is_opt=point_is_opt,
        )
    return build_point_major(
        host["obs_pose"],
        host["obs_point"],
        host["obs_cam"],
        host["obs_pixel"],
        host["points"],
        host["pose_opt_of"],
        host["point_is_opt"],
        shape.num_cameras,
        shape.scale,
        num_opt_poses=shape.num_opt_poses,
        block_points=block_points,
        max_slots=max_slots,
        max_window=max_window,
        pad_blocks_to=pad_blocks_to,
    )


def pm_problem_from_arrays(
    cameras,
    poses_world_to_camera: np.ndarray,  # (N, 4, 4)
    points: np.ndarray,  # (M, 3)
    obs_cam: np.ndarray,
    obs_pose: np.ndarray,
    obs_point: np.ndarray,
    obs_pixel: np.ndarray,  # (O, 2) raw pixels
    fixed_pose_mask: np.ndarray | None = None,
    fixed_point_mask: np.ndarray | None = None,
    scale: float = 0.01,
    block_points: int | None = None,
    max_slots: int = 32,
    max_window: int = 2048,
    pad_blocks_to: int = 1,
    layout: str = "auto",
    return_cache: bool = False,
):
    """Direct arrays -> point-major problem, skipping the sorted
    observation table entirely.

    `finalized_from_arrays` spends ~2.5 s at the flagship scale (12M
    observations, single core) on the native counting-sort finalize -- the
    analogue of the reference's FinalizeParameters/SetProblemSize pass
    (core/full_bundle_adjustment_solver.cpp:631-663) -- but that sorted
    table only feeds the observation-table engine: the point-major layout
    build buckets observations by landmark itself (csrc ba_pm_probe /
    ba_pm_fill are input-order-independent). This is the fast arrays-to-
    solution path for PM-engine solves.

    `layout` picks where the plane build runs: "host" = the native/numpy
    fill (`build_point_major`); "device" = ship the raw observation
    columns and build the planes with XLA sort+scatter on the accelerator
    (`build_point_major_device`, bit-identical planes, ~25% fewer H2D
    bytes, no single-core host fill); "auto" = device on a GPU
    (`utils.device.on_gpu`), host otherwise.

    `return_cache=True` (device layout only) appends a
    `models.layout.PMLayoutCache` to the return tuple: repeated solves
    over the same observation topology then refill the value planes with
    pure gathers (`cache.refill(pm, obs_pixel * scale, points * scale)`)
    instead of re-sorting -- the SLAM serving pattern.

    Returns (problem, shape, pm, pshape[, cache]) or None when the problem
    exceeds the layout's static bounds. `problem` is a FinalizedProblem whose
    observation-table columns and points are EMPTY (0-length) -- the PM
    engines read only rig / R_cw / t_cw / opt indices from it; route
    through `finalized_from_arrays` when the observation-table engine may
    be needed.
    """
    from ..models.camera import CameraRig
    from ..models.layout import build_point_major, build_point_major_device
    from ..models.problem import FinalizedProblem, ProblemShape

    N = poses_world_to_camera.shape[0]
    M = points.shape[0]
    if block_points is None:
        # Same heuristic as pm_from_finalized.
        block_points = 1024 if M >= 100_000 else 256
    if fixed_pose_mask is None:
        fixed_pose_mask = np.zeros(N, dtype=bool)
    if fixed_point_mask is None:
        fixed_point_mask = np.zeros(M, dtype=bool)
    n_opt = int((~fixed_pose_mask).sum())
    m_opt = int((~fixed_point_mask).sum())
    pose_opt_of = np.full(N, n_opt, dtype=np.int32)
    pose_opt_of[~fixed_pose_mask] = np.arange(n_opt, dtype=np.int32)

    R_wc = poses_world_to_camera[:, :3, :3]
    t_wc = poses_world_to_camera[:, :3, 3]
    R_cw = np.transpose(R_wc, (0, 2, 1))
    t_cw = -np.einsum("nij,nj->ni", R_cw, t_wc) * scale

    if layout not in ("auto", "host", "device"):
        raise ValueError(f"layout must be auto|host|device, got {layout!r}")
    use_device = layout == "device" or (layout == "auto" and on_gpu())
    if return_cache and not use_device:
        raise ValueError(
            "return_cache requires the device layout build "
            "(layout='device', or 'auto' on a GPU)"
        )
    if use_device:
        # Scale-condition on host in f64 -> f32 (one vectorized pass; keeps
        # the planes bit-identical to the host builders), group/scatter on
        # device.
        res = build_point_major_device(
            np.asarray(obs_pose, np.int32),
            np.asarray(obs_point, np.int32),
            np.asarray(obs_cam, np.int32),
            (np.asarray(obs_pixel, np.float64) * scale).astype(np.float32),
            (np.asarray(points, np.float64) * scale).astype(np.float32),
            pose_opt_of,
            ~np.asarray(fixed_point_mask, bool),
            len(list(cameras)),
            scale,
            num_opt_poses=n_opt,
            block_points=block_points,
            max_slots=max_slots,
            max_window=max_window,
            pad_blocks_to=pad_blocks_to,
            return_cache=return_cache,
        )
    else:
        res = build_point_major(
            np.asarray(obs_pose, np.int32),
            np.asarray(obs_point, np.int32),
            np.asarray(obs_cam, np.int32),
            np.asarray(obs_pixel, np.float64) * scale,
            np.asarray(points, np.float64) * scale,
            pose_opt_of,
            ~np.asarray(fixed_point_mask, bool),
            len(list(cameras)),
            scale,
            num_opt_poses=n_opt,
            block_points=block_points,
            max_slots=max_slots,
            max_window=max_window,
            pad_blocks_to=pad_blocks_to,
        )
    if res is None:
        return None
    if return_cache:
        pm, pshape, cache = res
    else:
        pm, pshape = res

    rig = CameraRig.from_cameras(list(cameras), scale=scale)
    empty_i = jnp.zeros((0,), jnp.int32)
    problem = FinalizedProblem(
        rig=rig,
        R_cw=jnp.asarray(R_cw, jnp.float32),
        t_cw=jnp.asarray(t_cw, jnp.float32),
        points=jnp.zeros((0, 3), jnp.float32),
        obs_cam=empty_i,
        obs_pose=empty_i,
        obs_point=empty_i,
        obs_pixel=jnp.zeros((0, 2), jnp.float32),
        obs_pose_opt=empty_i,
        obs_point_opt=empty_i,
        obs_valid=jnp.zeros((0,), bool),
        opt_pose_idx=jnp.asarray(
            np.nonzero(~fixed_pose_mask)[0].astype(np.int32)
        ),
        opt_point_idx=jnp.asarray(
            np.nonzero(~np.asarray(fixed_point_mask, bool))[0].astype(
                np.int32
            )
        ),
    )
    shape = ProblemShape(
        num_poses=N,
        num_points=M,
        num_observations=int(np.asarray(obs_pose).shape[0]),
        num_opt_poses=n_opt,
        num_opt_points=m_opt,
        num_cameras=len(list(cameras)),
        scale=scale,
    )
    if return_cache:
        return problem, shape, pm, pshape, cache
    return problem, shape, pm, pshape


def gather_opt_rows(tbl, opt_pose_idx, shape: PMShape):
    """The optimizable poses' (n_opt, 16) table rows. Uses a static slice
    when the opt range is contiguous (PMShape.opt_start), the general
    gather otherwise -- identical values either way."""
    s = shape.opt_start
    if s is not None:
        return jax.lax.slice_in_dim(tbl, s, s + shape.num_opt_poses)
    return tbl[opt_pose_idx]


def scatter_opt_rows(tbl, rows, opt_pose_idx, shape: PMShape):
    """Write updated opt-pose rows back into the full pose table.

    A contiguous opt range turns the general `.at[idx].set` scatter into
    one dynamic-update-slice on the flat (rows, 16) table."""
    s = shape.opt_start
    if s is not None:
        return jax.lax.dynamic_update_slice_in_dim(tbl, rows, s, 0)
    return tbl.at[opt_pose_idx].set(rows)


def retract_opt_rows(tbl, x, opt_pose_idx, shape: PMShape):
    """Candidate pose table: rows[opt] <- exp(x) * rows[opt], entirely in
    flat table form (cf. the reference's per-pose update at
    core/full_bundle_adjustment_solver.cpp:955-1000)."""
    dR, dt = se3_exp(x)
    opt_rows = gather_opt_rows(tbl, opt_pose_idx, shape)
    R9n, t3n = compose_flat(dR, dt, opt_rows[:, :9], opt_rows[:, 9:12])
    rows = jnp.concatenate(
        [R9n, t3n, jnp.zeros((x.shape[0], 4), tbl.dtype)], axis=1
    )
    return scatter_opt_rows(tbl, rows, opt_pose_idx, shape)


def _apply_cinv(Cb, t):
    """y = Cinv (b - t) on the point-major planes; Cb rows 9:15 hold Cinv,
    6:9 hold b. t: (4, Mp). Returns (3, Mp)."""
    ci = [Cb[9 + n] for n in range(6)]
    r0 = Cb[6] - t[0]
    r1 = Cb[7] - t[1]
    r2 = Cb[8] - t[2]
    y0 = ci[0] * r0 + ci[1] * r1 + ci[2] * r2
    y1 = ci[1] * r0 + ci[3] * r1 + ci[4] * r2
    y2 = ci[2] * r0 + ci[4] * r1 + ci[5] * r2
    return jnp.stack([y0, y1, y2])


def _c_times(Cb, y):
    """C @ y on the planes (C damped, rows 0:6). y: (3, Mp) -> (3, Mp)."""
    c = [Cb[n] for n in range(6)]
    return jnp.stack(
        [
            c[0] * y[0] + c[1] * y[1] + c[2] * y[2],
            c[1] * y[0] + c[3] * y[1] + c[4] * y[2],
            c[2] * y[0] + c[4] * y[1] + c[5] * y[2],
        ]
    )


def reduced_pcg(padded_points, Atri, rhs, precond_tri, max_iter, tol,
                corr_fn, x0=None):
    """Shared PCG driver on the reduced system; the pose blocks stay in the
    flat tri layout (ops/sym6.py).

    `corr_fn(x (n_opt, 6)) -> (corr (n_opt, 6), t (3, padded_points))` is
    the landmark-side B Cinv B^T correction -- the only piece that differs
    between the single-device engine (matvec_corr_pm) and the shard_map
    engine (same + psum over the data axis; t stays shard-local).

    `tol` may be a traced scalar (the Eisenstat-Walker forcing tolerance on
    ||r||^2 / ||rhs||^2). `x0` warm-starts the iteration (one extra matvec
    for the initial residual); None starts from zero as the reference's
    direct solve effectively does (full cpp:890-908).

    Returns (x, t_at_x, iters) where t_at_x = B^T x accumulated alongside
    (exact at the returned x, needed by back-substitution)."""
    from ..ops.sym6 import tri6_matvec

    def matvec(x):
        corr, t = corr_fn(x)
        return tri6_matvec(Atri, x) - corr, t

    def apply_precond(r):
        return tri6_matvec(precond_tri, r)

    if x0 is None:
        x_init = jnp.zeros_like(rhs)
        r0 = rhs
        t_init = jnp.zeros((3, padded_points), jnp.float32)
    else:
        Sx0, t_init = matvec(x0)
        x_init = x0
        r0 = rhs - Sx0
    z0 = apply_precond(r0)
    rz0 = jnp.sum(r0 * z0)
    rhs_sq = jnp.maximum(jnp.sum(rhs * rhs), 1e-30)

    def cond(state):
        _, r, _, _, rz, _, it = state
        return jnp.logical_and(
            it < max_iter, jnp.sum(r * r) > tol * rhs_sq
        )

    def body(state):
        x, r, z, p, rz, t_acc, it = state
        Sp, tp = matvec(p)
        alpha = rz / jnp.maximum(jnp.sum(p * Sp), 1e-30)
        x = x + alpha * p
        # t = B^T x is linear in x: accumulate alongside so no extra matvec
        # is needed for the back-substitution at the final x.
        t_acc = t_acc + alpha * tp
        r = r - alpha * Sp
        z = apply_precond(r)
        rz_new = jnp.sum(r * z)
        beta = rz_new / jnp.maximum(rz, 1e-30)
        p = z + beta * p
        return (x, r, z, p, rz_new, t_acc, it + 1)

    x, _, _, _, _, t, it = jax.lax.while_loop(
        cond, body, (x_init, r0, z0, z0, rz0, t_init,
                     jnp.asarray(0, jnp.int32))
    )
    return x, t, it


def _block_pcg_pm(pm, shape, Atri, Cb, U, rhs, precond_tri, max_iter, tol,
                  x0=None):
    """Single-device PCG: `reduced_pcg` over matvec_corr_pm."""

    def corr_fn(x):
        return K.matvec_corr_pm(pm, shape, Cb, U, x)

    return reduced_pcg(
        shape.padded_points, Atri, rhs, precond_tri, max_iter, tol,
        corr_fn, x0=x0,
    )


def _pm_loop_pieces(
    pm: PointMajorProblem,
    shape: PMShape,
    rig,
    opt_pose_idx,
    options: Options,
):
    """(cond, body, eval_cost) of the point-major LM loop -- shared by the
    all-device while_loop and the chunked-dispatch `Options.time_iterations`
    driver (which jits `body` alone per step, cf. solvers/full_ba.py)."""
    opts = options
    max_iter = opts.iteration_handle.max_num_iterations
    huber = opts.outlier_handle.threshold_huber_loss * shape.scale
    thr_step = opts.convergence_handle.threshold_step_size
    thr_cost = opts.convergence_handle.threshold_cost_change
    tr = opts.trust_region_handle
    inv_scale = 1.0 / shape.scale
    metric = getattr(opts, "cost_metric", "reference")
    dtype = jnp.float32
    n_obs = shape.num_observations
    is_lm = opts.solver_type == SolverType.LEVENBERG_MARQUARDT
    is_gd = opts.solver_type == SolverType.GRADIENT_DESCENT
    n_params = shape.num_opt_poses + jnp.sum(pm.X[3])  # opt poses + landmarks

    def eval_cost(tbl, X):
        s_norm, s_wsq, _, _ = K.cost_pm_tbl(pm, shape, tbl, X, rig, huber)
        return s_wsq if metric == "squared" else s_norm

    from ..ops.sym6 import inverse_tri6, tri6_matvec

    u_dtype = getattr(opts, "coupling_dtype", "float32")

    use_schur = getattr(opts, "cg_precond", "jacobi") == "schur_jacobi"
    warm = getattr(opts, "cg_warm_start", False)

    def body(c: _Carry):
        lam_eff = c.lam if is_lm else jnp.asarray(_GN_LAMBDA, dtype)
        flat, Cb, U = K.assemble_pm_tbl(
            pm, shape, c.tbl, c.X, rig, lam_eff, huber,
            u_dtype=u_dtype, emit_schur=use_schur,
        )
        Atri, a, rhs = K.finish_pose_system_tri(flat, lam_eff)

        if is_gd:
            def clip_blocks(g, clip):
                norms = jnp.linalg.norm(g, axis=0, keepdims=True)
                return g * jnp.minimum(1.0, clip / jnp.maximum(norms, 1e-30))

            x = clip_blocks(a.T, opts.gd_step_clip).T  # (n_opt, 6)
            b_planes = Cb[6:9]
            y = clip_blocks(b_planes, opts.gd_step_clip)  # (3, Mp)
            cg_it = jnp.asarray(0, jnp.int32)
            eta = jnp.asarray(0.0, jnp.float32)
            rhs_norm = jnp.asarray(0.0, jnp.float32)
        else:
            # rhs = a - B Cinv b arrives with the assembly.
            precond_tri = inverse_tri6(
                K.schur_precond_tri(flat, lam_eff) if use_schur else Atri
            )
            tol, eta, rhs_norm = _cg_tolerance(
                opts, rhs, c.rhs_norm_prev, c.eta_prev
            )
            x, t, cg_it = _block_pcg_pm(
                pm, shape, Atri, Cb, U, rhs, precond_tri,
                opts.cg_max_iterations, tol,
                x0=c.x_prev if warm else None,
            )
            y = _apply_cinv(Cb, t)  # (3, Mp)

        # Candidate update: T_cw <- exp(x) T_cw, X += y.
        tbl_cand = retract_opt_rows(c.tbl, x, opt_pose_idx, shape)
        X_cand = c.X.at[:3].add(y * c.X[3:4])

        current_cost = eval_cost(tbl_cand, X_cand)
        # NaN/inf guard (see solvers/full_ba.py): reject non-finite
        # candidates without poisoning prev_cost.
        cost_ok = jnp.isfinite(current_cost)

        if is_lm:
            # Quadratic-model decrease without an extra observation pass:
            # B^T x = b - C y identically from the back-substitution.
            term_pose = jnp.sum(a * x) + jnp.sum(x * tri6_matvec(Atri, x))
            b_pl = Cb[6:9]
            Cy = _c_times(Cb, y)
            term_point = jnp.sum(b_pl * y) + jnp.sum(y * Cy)
            cross = 2.0 * jnp.sum(y * (b_pl - Cy))
            model_decrease = -(term_pose + term_point + cross)
            rho = (current_cost - c.prev_cost) * inv_scale / model_decrease
            accept = jnp.logical_and(rho > tr.threshold_update, cost_ok)
            trust_more = jnp.logical_and(rho > tr.threshold_trust_more, cost_ok)
            lam_new = jnp.where(
                trust_more,
                jnp.maximum(tr.min_lambda, c.lam * tr.decrease_ratio_lambda),
                jnp.where(
                    rho <= tr.threshold_update,
                    jnp.minimum(tr.max_lambda, c.lam * tr.increase_ratio_lambda),
                    c.lam,
                ),
            )
            status = jnp.where(
                trust_more,
                float(int(IterationStatus.UPDATE_TRUST_MORE)),
                jnp.where(
                    accept,
                    float(int(IterationStatus.UPDATE)),
                    float(int(IterationStatus.SKIPPED)),
                ),
            )
        else:
            accept = cost_ok
            lam_new = c.lam
            status = jnp.asarray(float(int(IterationStatus.UPDATE)), dtype)

        tbl_next = jnp.where(accept, tbl_cand, c.tbl)
        X_next = jnp.where(accept, X_cand, c.X)

        cost_change = jnp.abs(current_cost - c.prev_cost)
        step_pose = jnp.sum(jnp.linalg.norm(x, axis=-1))
        step_point = jnp.sum(
            jnp.sqrt(jnp.maximum(jnp.sum(y * y, axis=0), 0.0)) * c.X[3]
        )
        avg_step = (step_pose + step_point) / n_params
        conv_now = jnp.logical_or(avg_step < thr_step, cost_change < thr_cost)
        at_last = c.it >= max_iter - 1
        converged = jnp.where(at_last, False, conv_now)

        skipped = jnp.logical_not(accept)
        row = jnp.zeros((INFO_NUM_COLS,), dtype=dtype)
        row = row.at[INFO_COST].set(
            jnp.where(skipped, c.prev_cost, current_cost)
        )
        row = row.at[INFO_COST_CHANGE].set(jnp.where(skipped, 0.0, cost_change))
        row = row.at[INFO_AVG_REPROJ].set(
            jnp.where(
                skipped,
                jnp.sqrt(c.prev_cost / n_obs),
                current_cost / n_obs,
            )
        )
        row = row.at[INFO_ABS_STEP].set(avg_step)
        row = row.at[INFO_ABS_GRADIENT].set(0.0)
        row = row.at[INFO_DAMPING].set(lam_new)
        row = row.at[INFO_STATUS].set(status)
        row = row.at[INFO_CG_ITERS].set(cg_it.astype(dtype))

        return _Carry(
            tbl=tbl_next,
            X=X_next,
            lam=lam_new,
            prev_cost=jnp.where(cost_ok, current_cost, c.prev_cost),
            it=c.it + 1,
            done=jnp.logical_or(conv_now, at_last),
            converged=converged,
            info=c.info.at[c.it].set(row),
            num_info=c.num_info + 1,
            x_prev=x,
            rhs_norm_prev=rhs_norm,
            eta_prev=eta,
        )

    def cond(c: _Carry):
        return jnp.logical_and(c.it < max_iter, jnp.logical_not(c.done))

    return cond, body, eval_cost


@functools.partial(
    jax.jit, static_argnames=("shape", "options")
)
def _pm_init_carry_jax(
    pm, shape: PMShape, rig, R_cw0, t_cw0, opt_pose_idx,
    options: Options,
) -> _Carry:
    _, _, eval_cost = _pm_loop_pieces(pm, shape, rig, opt_pose_idx, options)
    max_iter = options.iteration_handle.max_num_iterations
    tbl0 = K.pose_table(R_cw0, t_cw0)
    return _Carry(
        tbl=tbl0,
        X=pm.X,
        lam=jnp.asarray(options.trust_region_handle.initial_lambda,
                        jnp.float32),
        prev_cost=eval_cost(tbl0, pm.X),
        it=jnp.asarray(0, jnp.int32),
        done=jnp.asarray(False),
        converged=jnp.asarray(False),
        info=jnp.zeros((max_iter, INFO_NUM_COLS), dtype=jnp.float32),
        num_info=jnp.asarray(0, jnp.int32),
        x_prev=jnp.zeros((shape.num_opt_poses, 6), jnp.float32),
        rhs_norm_prev=jnp.asarray(0.0, jnp.float32),
        eta_prev=jnp.asarray(0.0, jnp.float32),
    )


@functools.partial(
    jax.jit, static_argnames=("shape", "options")
)
def _pm_step_jax(
    pm, shape: PMShape, rig, opt_pose_idx, carry: _Carry,
    options: Options,
) -> _Carry:
    """ONE LM iteration of the point-major loop, for chunked timing."""
    _, body, _ = _pm_loop_pieces(pm, shape, rig, opt_pose_idx, options)
    return body(carry)


@functools.partial(
    jax.jit, static_argnames=("shape", "options")
)
def _pm_finalize_jax(
    pm, shape: PMShape, rig, carry: _Carry,
    options: Options,
) -> tuple:
    huber = options.outlier_handle.threshold_huber_loss * shape.scale
    inv_scale = 1.0 / shape.scale
    _, _, s_sq, s_cnt = K.cost_pm_tbl(pm, shape, carry.tbl, carry.X, rig, huber)
    rmse_px = jnp.sqrt(s_sq / jnp.maximum(s_cnt, 1.0)) * inv_scale
    N = shape.num_poses
    return (
        carry.tbl[:N, :9].reshape(N, 3, 3),
        carry.tbl[:N, 9:12],
        carry.X,
        carry.converged,
        carry.it,
        carry.info,
        carry.num_info,
        carry.prev_cost,
        rmse_px,
    )


@functools.partial(
    jax.jit, static_argnames=("shape", "options")
)
def _solve_pm_jax(
    pm: PointMajorProblem,
    shape: PMShape,
    rig,
    R_cw0,
    t_cw0,
    opt_pose_idx,
    options: Options,
) -> tuple:
    """Returns (R_cw, t_cw, X(4, Mp), converged, iters, info, num_info,
    final_cost, final_rmse_px)."""
    cond, body, _ = _pm_loop_pieces(pm, shape, rig, opt_pose_idx, options)
    carry0 = _pm_init_carry_jax(
        pm, shape, rig, R_cw0, t_cw0, opt_pose_idx, options
    )
    carry = jax.lax.while_loop(cond, body, carry0)
    return _pm_finalize_jax(pm, shape, rig, carry, options)


def solve_pm(
    problem: FinalizedProblem,
    shape: ProblemShape,
    options: Options,
    pm_and_shape=None,
    host: dict | None = None,
) -> tuple[FullBAState, Summary]:
    """Host entry point mirroring full_ba.solve on the point-major engine.

    `pm_and_shape` may carry a pre-built layout (from pm_from_finalized) so
    repeated solves skip the host-side repack. Raises ValueError when the
    problem does not fit the layout's static bounds.
    """
    if pm_and_shape is None:
        pm_and_shape = pm_from_finalized(problem, shape, host=host)
    if pm_and_shape is None:
        raise ValueError(
            "problem exceeds point-major static bounds; use full_ba.solve"
        )
    pm, pshape = pm_and_shape

    iter_times_ms = None
    total_ms_override = None
    t0 = time.perf_counter()
    if getattr(options, "time_iterations", False) == "device":
        # Device-clock reporting: run the whole solve in ONE dispatch under
        # a profiler trace, compiled with one trace event per op; each LM
        # iteration's time runs from one `pm_assemble` scope's first kernel
        # to the next one's (utils/profiling.py). Raises when the trace has
        # no GPU events.
        from ..utils.profiling import (
            compile_per_op,
            iteration_times_ms,
            run_traced,
        )

        run = compile_per_op(
            _solve_pm_jax, ("shape", "options"), pm=pm, shape=pshape,
            rig=problem.rig, R_cw0=problem.R_cw, t_cw0=problem.t_cw,
            opt_pose_idx=problem.opt_pose_idx, options=options,
        )
        jax.block_until_ready(run())  # warm
        out, total_ms_override, events = run_traced(run)
        iter_times_ms = np.asarray(iteration_times_ms(
            events, "pm_assemble", int(out[4])
        ))
    elif getattr(options, "time_iterations", False):
        # Chunked-dispatch reporting mode (reference iter_time parity,
        # full cpp:981-992), one jit step per LM iteration.
        max_iter = options.iteration_handle.max_num_iterations
        carry = jax.block_until_ready(_pm_init_carry_jax(
            pm, pshape, problem.rig, problem.R_cw, problem.t_cw,
            problem.opt_pose_idx, options,
        ))
        iter_times_ms = []
        for _ in range(max_iter):
            t_it = time.perf_counter()
            carry = _pm_step_jax(
                pm, pshape, problem.rig, problem.opt_pose_idx, carry, options,
            )
            done = bool(np.asarray(carry.done))  # fetch doubles as sync
            iter_times_ms.append((time.perf_counter() - t_it) * 1e3)
            if done:
                break
        out = _pm_finalize_jax(pm, pshape, problem.rig, carry, options)
        iter_times_ms = np.asarray(iter_times_ms)
    else:
        out = _solve_pm_jax(
            pm, pshape, problem.rig, problem.R_cw, problem.t_cw,
            problem.opt_pose_idx, options,
        )
    (R_cw, t_cw, Xpm, converged, iters, info, num_info, final_cost,
     rmse_px) = jax.block_until_ready(out)
    total_ms = (
        total_ms_override if total_ms_override is not None
        else (time.perf_counter() - t0) * 1e3
    )

    inv_scale = 1.0 / shape.scale
    t_user = t_cw * inv_scale
    R_wc, t_wc = inverse_se3(R_cw, t_user)
    N = R_wc.shape[0]
    T = jnp.zeros((N, 4, 4), jnp.float32)
    T = T.at[:, :3, :3].set(R_wc)
    T = T.at[:, :3, 3].set(t_wc)
    T = T.at[:, 3, 3].set(1.0)

    # Un-permute landmarks back to their original rows.
    ref = np.asarray(pm.point_ref)
    Xh = np.asarray(Xpm)
    points = np.zeros((shape.num_points, 3), np.float32)
    live = ref >= 0
    points[ref[live]] = Xh[:3, live].T
    points = jnp.asarray(points) * inv_scale

    state = FullBAState(
        poses_world_to_camera=T,
        points=points,
        converged=converged,
        num_iterations=iters,
        info=info,
        num_info=num_info,
        final_cost=final_cost,
        final_rmse_px=rmse_px,
    )
    summary = Summary.from_device_buffers(
        info=np.asarray(info),
        num_iterations=int(num_info),
        converged=bool(converged),
        max_iteration=options.iteration_handle.max_num_iterations,
        threshold_step_size=options.convergence_handle.threshold_step_size,
        threshold_cost_change=options.convergence_handle.threshold_cost_change,
        total_time_ms=total_ms,
        iter_times_ms=iter_times_ms,
        final_rmse_px=float(rmse_px),
    )
    return state, summary
