"""Full bundle adjustment: Schur-complement LM/GN/GD inside `lax.while_loop`.

JAX re-design of FullBundleAdjustmentSolver::Solve
(core/full_bundle_adjustment_solver.cpp:630-1044) and the refactor's explicit
SolverType dispatch + gradient-descent mode
(core/full_bundle_adjustment_solver_refactor.cpp:641-1367).

Faithfully reproduced semantics:
  - cost metric: sum of residual L2 *norms* in scaled pixel units (cpp:427)
    while the quadratic model is in squared units (cpp:435-455) and
    rho = (cost_new - cost_prev) / scale / model_change (cpp:930) -- the
    reference's exact trust-region arithmetic, quirks included (`Options`
    exposes `cost_metric='squared'` for the sane alternative);
  - previous_cost is overwritten with the *candidate* cost even when the step
    is rejected (cpp:1005);
  - rho thresholds 0.25 / 0.5, lambda x0.33 / x3.0 clamped to [1e-10, 100]
    (cpp:933-953), rejected steps revert parameters (cpp:943) -- revert here
    is a `jnp.where`, not a snapshot/rollback (SURVEY.md §5 checkpoint note);
  - convergence on average step size or cost change (cpp:955-975), with
    convergence forced false when max iterations is reached (cpp:977-979);
  - per-iteration info rows appended every iteration, with the SKIP rewrite
    of cost / cost_change / avg-reprojection (cpp:983-1003).

Deliberate fix vs the reference: coupling blocks B[j][i] are accumulated over
observations, not overwritten (see ops/hessian.py docstring).

The reduced camera solve is 'dense' (materialized S, Cholesky -- reference
semantics, fine to ~1k poses) or 'cg' (matrix-free block-PCG -- the scalable
path for 10k poses / 1M landmarks, where iteration counts may differ from the
reference so parity is defined on final cost, SURVEY.md §7).
"""

from __future__ import annotations

import functools
import time
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..models.problem import FinalizedProblem, ProblemShape
from ..ops import hessian as H
from ..ops.lie import compose, inverse_se3, se3_exp
from ..ops.projection import (
    full_ba_jacobians,
    residual_and_weight,
    warp_to_cameras,
)
from ..options import IterationStatus, Options, SolverType
from ..utils.device import on_gpu
from ..summary import (
    INFO_ABS_GRADIENT,
    INFO_ABS_STEP,
    INFO_CG_ITERS,
    INFO_AVG_REPROJ,
    INFO_COST,
    INFO_COST_CHANGE,
    INFO_DAMPING,
    INFO_NUM_COLS,
    INFO_STATUS,
    Summary,
)

_HIGHEST = jax.lax.Precision.HIGHEST

# Fixed damping of the reference's plain Gauss-Newton modes (pose-only
# cpp:57; the refactor's GN branch keeps LM's evolving lambda -- we pin the
# small constant instead, which is strictly better conditioned).
_GN_LAMBDA = 1e-5

# Smallest problem `reduced_system='auto'` sends to the point-major engine
# on a GPU (below it the observation-table engine's scatters are small).
_PM_MIN_OBSERVATIONS = 200_000


class FullBAState(NamedTuple):
    """Device-side result of a full-BA solve."""

    poses_world_to_camera: jax.Array  # (N, 4, 4) user-facing, unscaled
    points: jax.Array  # (M, 3) unscaled
    converged: jax.Array  # () bool
    num_iterations: jax.Array  # () int32
    info: jax.Array  # (max_iter, INFO_NUM_COLS)
    num_info: jax.Array  # () int32
    final_cost: jax.Array  # () reference-metric cost (scaled units)
    final_rmse_px: jax.Array  # () unscaled reprojection RMSE in pixels


class _Carry(NamedTuple):
    R_cw: jax.Array
    t_cw: jax.Array
    X: jax.Array
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


def _cg_tolerance(opts: Options, rhs, rhs_norm_prev, eta_prev):
    """Per-LM-iteration inner-CG relative tolerance.

    'fixed': the constant Options.cg_tolerance (on ||r||^2/||rhs||^2).
    'ew': Eisenstat-Walker choice 2 (eta_k = gamma (||rhs_k||/||rhs_{k-1}||)^2
    with the gamma eta_{k-1}^2 safeguard, clamped to
    [cg_forcing_min, cg_forcing_max]); the first LM iteration uses the max.
    Returns (tol, eta, rhs_norm) with tol = eta^2 so the PCG's
    squared-residual test stops at ||r|| <= eta ||rhs||.
    """
    return _cg_tolerance_from_norm(
        opts, jnp.sqrt(jnp.sum(rhs * rhs)), rhs_norm_prev, eta_prev
    )


def _cg_tolerance_from_norm(opts: Options, rhs_norm, rhs_norm_prev,
                            eta_prev):
    """`_cg_tolerance` on a precomputed ||rhs|| -- the pose-sharded engine
    reduces the norm across the mesh before the forcing choice."""
    # eta/rhs_norm ride the LM while_loop carry, so they must match the
    # problem dtype (f64 problems via finalized_from_arrays(dtype=...)).
    if getattr(opts, "cg_forcing", "fixed") != "ew":
        return (
            jnp.asarray(opts.cg_tolerance, rhs_norm.dtype),
            jnp.asarray(0.0, rhs_norm.dtype),
            rhs_norm,
        )
    gamma = 0.9
    eta_raw = gamma * (rhs_norm / jnp.maximum(rhs_norm_prev, 1e-30)) ** 2
    guard = gamma * eta_prev * eta_prev
    eta = jnp.where(guard > 0.1, jnp.maximum(eta_raw, guard), eta_raw)
    eta = jnp.where(rhs_norm_prev > 0.0, eta, opts.cg_forcing_max)
    eta = jnp.clip(eta, opts.cg_forcing_min, opts.cg_forcing_max)
    return eta * eta, eta, rhs_norm


def _residuals(problem: FinalizedProblem, R_cw, t_cw, X, huber):
    """Fused per-observation residual pass (cpp:716-766 / 381-433)."""
    fx, fy, cx, cy, R_cam, t_cam = problem.rig.gather(problem.obs_cam)
    R_jw = R_cw[problem.obs_pose]
    t_jw = t_cw[problem.obs_pose]
    Xo = X[problem.obs_point]
    X_ref, X_cam = warp_to_cameras(R_jw, t_jw, Xo, R_cam, t_cam)
    r, w, man = residual_and_weight(
        X_cam, problem.obs_pixel, fx, fy, cx, cy, huber
    )
    w = w * problem.obs_valid.astype(w.dtype)
    return X_ref, X_cam, r, w, (fx, fy, R_jw, R_cam)


def _cost(problem, r, w, metric: str):
    """Reference cost: sum of residual L2 norms, scaled units (cpp:427).
    'squared' uses the robust squared cost instead."""
    validf = problem.obs_valid.astype(r.dtype)
    if metric == "squared":
        return jnp.sum(w * (r[:, 0] ** 2 + r[:, 1] ** 2))
    return jnp.sum(validf * jnp.linalg.norm(r, axis=-1))


def _model_decrease(sys: H.BlockSystem, problem, shape, x, y):
    """-(a^T x + x^T A x + b^T y + y^T C y + 2 y^T B^T x), the quadratic-model
    cost change with damped blocks (reference cpp:435-455, sign flipped so a
    good step gives a positive value)."""
    term_pose = jnp.sum(sys.a * x) + jnp.einsum(
        "ja,jab,jb->", x, sys.A, x, precision=_HIGHEST
    )
    term_point = jnp.sum(sys.b * y) + jnp.einsum(
        "ia,iab,ib->", y, sys.C, y, precision=_HIGHEST
    )
    xg = H._gather_padded(x, problem.obs_pose_opt, shape.num_opt_poses)
    u = jnp.einsum("oab,oa->ob", sys.U, xg, precision=_HIGHEST)
    Bt_x = jax.ops.segment_sum(
        u, problem.obs_point_opt, num_segments=shape.num_opt_points + 1
    )[: shape.num_opt_points]
    cross = 2.0 * jnp.sum(y * Bt_x)
    return -(term_pose + term_point + cross)


def _reduced_solve(sys, problem, shape: ProblemShape, options: Options,
                   mode: str, cg_state=None):
    """Solve the reduced camera system for x (N_opt, 6) and back-substitute
    y (M_opt, 3). Returns (x, y, cg_iters, eta, rhs_norm) -- the last three
    are 0 for the dense mode. `cg_state` = (x_prev, rhs_norm_prev, eta_prev)
    feeds the CG path's warm start and Eisenstat-Walker forcing."""
    if mode == "dense":
        B = H.dense_coupling(
            sys.U,
            problem.obs_pose_opt,
            problem.obs_point_opt,
            shape.num_opt_poses,
            shape.num_opt_points,
        )
        S, rhs = H.schur_reduce_dense(sys, B)
        # The reference's S.ldlt() (cpp:905) tolerates a PSD-singular reduced
        # system (gauge-free directions survive the multiplicative (1 +
        # lambda) damping at the GN lambda of 1e-5); Cholesky does not, so
        # add an absolute Tikhonov floor of 1e-6 x mean diagonal --
        # negligible against LM's lambda, rescues plain Gauss-Newton.
        n6 = S.shape[0]
        jitter = 1e-6 * (jnp.trace(S) / n6)
        S = S + jitter * jnp.eye(n6, dtype=S.dtype)
        x = jax.scipy.linalg.cho_solve(
            jax.scipy.linalg.cho_factor(S), rhs
        ).reshape(shape.num_opt_poses, 6)
        y = H.back_substitute_dense(sys, B, x)
    else:
        rhs = H.schur_rhs(
            sys,
            problem.obs_pose_opt,
            problem.obs_point_opt,
            shape.num_opt_poses,
            shape.num_opt_points,
        )
        if getattr(options, "cg_precond", "jacobi") == "schur_jacobi":
            # Schur-Jacobi: diag blocks of S itself (A minus the
            # observation-pass Schur correction) -- roughly halves CG
            # iteration counts vs plain block-Jacobi on A (see the PM
            # engine's measurement in PERF.md).
            corr = H.schur_diag_correction(
                sys,
                problem.obs_pose_opt,
                problem.obs_point_opt,
                shape.num_opt_poses,
                shape.num_opt_points,
            )
            precond = H.inverse_6x6(sys.A - corr)
        else:
            precond = H.inverse_6x6(sys.A)
        if cg_state is not None:
            x_prev, rhs_norm_prev, eta_prev = cg_state
            tol, eta, rhs_norm = _cg_tolerance(
                options, rhs, rhs_norm_prev, eta_prev
            )
            x0 = x_prev if getattr(options, "cg_warm_start", False) else None
        else:
            tol, eta, rhs_norm = (
                options.cg_tolerance,
                jnp.asarray(0.0, rhs.dtype),
                jnp.sqrt(jnp.sum(rhs * rhs)),
            )
            x0 = None
        x, _, cg_it = H.block_pcg(
            lambda v: H.schur_matvec(
                sys,
                problem.obs_pose_opt,
                problem.obs_point_opt,
                shape.num_opt_poses,
                shape.num_opt_points,
                v,
            ),
            rhs,
            precond,
            options.cg_max_iterations,
            tol,
            x0=x0,
        )
        y = H.back_substitute_matfree(
            sys,
            problem.obs_pose_opt,
            problem.obs_point_opt,
            shape.num_opt_poses,
            shape.num_opt_points,
            x,
        )
        return x, y, cg_it, eta, rhs_norm
    return (
        x,
        y,
        jnp.asarray(0, jnp.int32),
        jnp.asarray(0.0, x.dtype),
        jnp.asarray(0.0, x.dtype),
    )


def _apply_step(problem, R_cw, t_cw, X, x, y):
    """Candidate update: T_cw <- exp(x) T_cw per opt pose, X += y per opt
    point (reference UpdateParameters, cpp:484-500)."""
    dR, dt = se3_exp(x)
    R_opt = R_cw[problem.opt_pose_idx]
    t_opt = t_cw[problem.opt_pose_idx]
    R_new, t_new = compose(dR, dt, R_opt, t_opt)
    R_cand = R_cw.at[problem.opt_pose_idx].set(R_new)
    t_cand = t_cw.at[problem.opt_pose_idx].set(t_new)
    X_cand = X.at[problem.opt_point_idx].add(y)
    return R_cand, t_cand, X_cand


def _resolve_mode(shape: ProblemShape, options: Options) -> str:
    if options.reduced_system != "auto":
        return options.reduced_system
    dense_b_floats = shape.num_opt_poses * 6 * shape.num_opt_points * 3
    if shape.num_opt_poses <= 1024 and dense_b_floats <= 120_000_000:
        return "dense"
    # Large problems on a GPU: the point-major engine, the faster of the two
    # CG engines at the 10k-pose / 1M-landmark flagship on an H100 (both
    # wall times in PERF.md). solve() falls back to 'cg' when the problem
    # exceeds the layout's static bounds.
    if on_gpu() and shape.num_observations >= _PM_MIN_OBSERVATIONS:
        return "pm"
    return "cg"


def _loop_pieces(
    problem: FinalizedProblem,
    shape: ProblemShape,
    options: Options,
    mode: str,
):
    """The LM loop's (cond, body, eval_cost) closures -- shared by the
    all-device `_solve_jax` while_loop and the chunked-dispatch
    `Options.time_iterations` driver (which jits `body` alone per step so
    the host can wall-clock each iteration, reference cpp:981-992)."""
    opts = options
    max_iter = opts.iteration_handle.max_num_iterations
    huber = opts.outlier_handle.threshold_huber_loss * shape.scale
    thr_step = opts.convergence_handle.threshold_step_size
    thr_cost = opts.convergence_handle.threshold_cost_change
    tr = opts.trust_region_handle
    inv_scale = 1.0 / shape.scale
    metric = getattr(opts, "cost_metric", "reference")
    dtype = problem.points.dtype
    n_obs = shape.num_observations
    n_params = shape.num_opt_poses + shape.num_opt_points
    is_lm = opts.solver_type == SolverType.LEVENBERG_MARQUARDT
    is_gd = opts.solver_type == SolverType.GRADIENT_DESCENT

    def eval_cost(R_cw, t_cw, X):
        _, _, r, w, _ = _residuals(problem, R_cw, t_cw, X, huber)
        return _cost(problem, r, w, metric)

    def body(c: _Carry):
        X_ref, X_cam, r, w, (fx, fy, R_jw, R_cam) = _residuals(
            problem, c.R_cw, c.t_cw, c.X, huber
        )
        Q, Rj = full_ba_jacobians(R_jw, X_ref, X_cam, fx, fy, R_cam)
        lam_eff = c.lam if is_lm else jnp.asarray(_GN_LAMBDA, dtype)
        sys = H.assemble_block_system(
            Q,
            Rj,
            r,
            w,
            problem.obs_pose_opt,
            problem.obs_point_opt,
            shape.num_opt_poses,
            shape.num_opt_points,
            lam_eff,
        )

        if is_gd:
            # Gradient descent with per-block step clipping to `gd_step_clip`
            # (refactor cpp:1246-1285). sys.a / sys.b are descent directions.
            def clip_blocks(g, clip):
                norms = jnp.linalg.norm(g, axis=-1, keepdims=True)
                scale_f = jnp.minimum(1.0, clip / jnp.maximum(norms, 1e-30))
                return g * scale_f

            x = clip_blocks(sys.a, opts.gd_step_clip)
            y = clip_blocks(sys.b, opts.gd_step_clip)
            cg_it = jnp.asarray(0, jnp.int32)
            eta = jnp.asarray(0.0, dtype)
            rhs_norm = jnp.asarray(0.0, dtype)
        else:
            x, y, cg_it, eta, rhs_norm = _reduced_solve(
                sys, problem, shape, opts, mode,
                cg_state=(c.x_prev, c.rhs_norm_prev, c.eta_prev),
            )

        R_cand, t_cand, X_cand = _apply_step(problem, c.R_cw, c.t_cw, c.X, x, y)
        current_cost = eval_cost(R_cand, t_cand, X_cand)
        # NaN/inf guard: a divergent candidate (e.g. a landmark crossing the
        # camera plane) must be rejected AND must not poison prev_cost -- the
        # reference overwrites previous_cost unconditionally (cpp:1005),
        # which permanently corrupts rho once a non-finite cost appears; we
        # keep that quirk only for finite candidates.
        cost_ok = jnp.isfinite(current_cost)

        if is_lm:
            model_decrease = _model_decrease(sys, problem, shape, x, y)
            rho = (
                (current_cost - c.prev_cost) * inv_scale / model_decrease
            )
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

        R_next = jnp.where(accept, R_cand, c.R_cw)
        t_next = jnp.where(accept, t_cand, c.t_cw)
        X_next = jnp.where(accept, X_cand, c.X)

        cost_change = jnp.abs(current_cost - c.prev_cost)
        step_pose = jnp.sum(jnp.linalg.norm(x, axis=-1))
        step_point = jnp.sum(jnp.linalg.norm(y, axis=-1))
        avg_step = (step_pose + step_point) / n_params
        conv_now = jnp.logical_or(avg_step < thr_step, cost_change < thr_cost)
        at_last = c.it >= max_iter - 1
        converged = jnp.where(at_last, False, conv_now)

        # Info row (cpp:983-1003), including the SKIP rewrite.
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
            R_cw=R_next,
            t_cw=t_next,
            X=X_next,
            lam=lam_new,
            # Unconditional even on SKIP (cpp:1005) -- unless non-finite.
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


@functools.partial(jax.jit, static_argnames=("shape", "options", "mode"))
def _init_carry_jax(
    problem: FinalizedProblem,
    shape: ProblemShape,
    options: Options,
    mode: str,
) -> _Carry:
    _, _, eval_cost = _loop_pieces(problem, shape, options, mode)
    dtype = problem.points.dtype
    max_iter = options.iteration_handle.max_num_iterations
    initial_cost = eval_cost(problem.R_cw, problem.t_cw, problem.points)
    return _Carry(
        R_cw=problem.R_cw,
        t_cw=problem.t_cw,
        X=problem.points,
        lam=jnp.asarray(options.trust_region_handle.initial_lambda, dtype),
        prev_cost=initial_cost,
        it=jnp.asarray(0, jnp.int32),
        done=jnp.asarray(False),
        converged=jnp.asarray(False),
        info=jnp.zeros((max_iter, INFO_NUM_COLS), dtype=dtype),
        num_info=jnp.asarray(0, jnp.int32),
        x_prev=jnp.zeros((shape.num_opt_poses, 6), dtype),
        rhs_norm_prev=jnp.asarray(0.0, dtype),
        eta_prev=jnp.asarray(0.0, dtype),
    )


@functools.partial(jax.jit, static_argnames=("shape", "options", "mode"))
def _step_jax(
    problem: FinalizedProblem,
    shape: ProblemShape,
    options: Options,
    mode: str,
    carry: _Carry,
) -> _Carry:
    """ONE LM iteration (the while_loop body) as its own dispatch, for the
    chunked-dispatch timing mode."""
    _, body, _ = _loop_pieces(problem, shape, options, mode)
    return body(carry)


@functools.partial(jax.jit, static_argnames=("shape", "options", "mode"))
def _solve_jax(
    problem: FinalizedProblem,
    shape: ProblemShape,
    options: Options,
    mode: str,
) -> FullBAState:
    cond, body, _ = _loop_pieces(problem, shape, options, mode)
    carry0 = _init_carry_jax(problem, shape, options, mode)
    carry = jax.lax.while_loop(cond, body, carry0)
    return _finalize_state_jax(problem, shape, options, carry)


@functools.partial(jax.jit, static_argnames=("shape", "options"))
def _finalize_state_jax(
    problem: FinalizedProblem,
    shape: ProblemShape,
    options: Options,
    carry: _Carry,
) -> FullBAState:
    dtype = problem.points.dtype
    inv_scale = 1.0 / shape.scale
    huber = options.outlier_handle.threshold_huber_loss * shape.scale
    # Write-back: unscale translations/points, re-invert poses (cpp:1010-1022).
    t_user = carry.t_cw * inv_scale
    R_wc, t_wc = inverse_se3(carry.R_cw, t_user)
    N = R_wc.shape[0]
    T = jnp.zeros((N, 4, 4), dtype=dtype)
    T = T.at[:, :3, :3].set(R_wc)
    T = T.at[:, :3, 3].set(t_wc)
    T = T.at[:, 3, 3].set(1.0)

    # Unscaled final reprojection RMSE in pixels (extra diagnostic).
    _, _, r, _, _ = _residuals(problem, carry.R_cw, carry.t_cw, carry.X, huber)
    validf = problem.obs_valid.astype(dtype)
    rmse_px = (
        jnp.sqrt(jnp.sum(validf * jnp.sum(r * r, axis=-1)) / jnp.sum(validf))
        * inv_scale
    )

    return FullBAState(
        poses_world_to_camera=T,
        points=carry.X * inv_scale,
        converged=carry.converged,
        num_iterations=carry.it,
        info=carry.info,
        num_info=carry.num_info,
        final_cost=carry.prev_cost,
        final_rmse_px=rmse_px,
    )


def solve(
    problem: FinalizedProblem, shape: ProblemShape, options: Options,
    host: dict | None = None,
) -> tuple[FullBAState, Summary]:
    """Host entry point: jit-solve + host-side Summary (timings in ms).

    `host` (from finalized_from_arrays(return_host=True) or the builder's
    finalize()) lets the point-major layout build avoid device readback."""
    mode = _resolve_mode(shape, options)
    timed = getattr(options, "time_iterations", False)
    if mode == "pm":
        from . import full_ba_pm  # local import to avoid cycle

        try:
            return full_ba_pm.solve_pm(problem, shape, options, host=host)
        except ValueError:
            mode = "cg"  # exceeds point-major static bounds

    if timed == "device":
        # Device-clock timing derives iter_time from the point-major
        # assembly scope's trace events; the observation-table engine has
        # no such anchor. Refuse rather than silently reporting chunked
        # dispatch+fetch wall times (the artifact "device" exists to avoid).
        raise ValueError(
            "time_iterations='device' requires the point-major engine "
            f"(resolved mode: {mode!r}); use reduced_system='pm' on a "
            "problem within its static bounds, or time_iterations=True for "
            "chunked wall-clock timing"
        )

    iter_times_ms = None
    if timed:
        # Chunked-dispatch reporting mode (reference iter_time parity,
        # full cpp:981-992): jit ONE LM iteration per dispatch and
        # wall-clock it on the host, dispatch + fetch included.
        max_iter = options.iteration_handle.max_num_iterations
        t0 = time.perf_counter()
        carry = _init_carry_jax(problem, shape, options, mode)
        jax.block_until_ready(carry)
        iter_times_ms = []
        for _ in range(max_iter):
            t_it = time.perf_counter()
            carry = _step_jax(problem, shape, options, mode, carry)
            done = bool(np.asarray(carry.done))  # fetch doubles as sync
            iter_times_ms.append((time.perf_counter() - t_it) * 1e3)
            if done:
                break
        state = jax.block_until_ready(
            _finalize_state_jax(problem, shape, options, carry)
        )
        total_ms = (time.perf_counter() - t0) * 1e3
        iter_times_ms = np.asarray(iter_times_ms)
    else:
        t0 = time.perf_counter()
        state = jax.block_until_ready(_solve_jax(problem, shape, options, mode))
        total_ms = (time.perf_counter() - t0) * 1e3
    summary = Summary.from_device_buffers(
        info=np.asarray(state.info),
        num_iterations=int(state.num_info),
        converged=bool(state.converged),
        max_iteration=options.iteration_handle.max_num_iterations,
        threshold_step_size=options.convergence_handle.threshold_step_size,
        threshold_cost_change=options.convergence_handle.threshold_cost_change,
        total_time_ms=total_ms,
        iter_times_ms=iter_times_ms,
        final_rmse_px=float(state.final_rmse_px),
    )
    return state, summary
