"""Pose-only (motion-only) bundle adjustment: 4 modes, batched, jitted.

JAX re-design of the reference PoseOnlyBundleAdjustmentSolver
(core/pose_only_bundle_adjustment_solver.h:28-67, .cpp:8-900):

  - `solve_monocular_6dof`      (cpp:8-170)
  - `solve_stereo_6dof`         (cpp:172-399)
  - `solve_monocular_planar3dof`(cpp:401-615)
  - `solve_stereo_planar3dof`   (cpp:617-900)

Design changes vs the reference (behavior-preserving):
  - the per-point scalar loops become batched elementwise math; the 6x6/3x3
    normal equations are built with one weighted J^T J contraction instead
    of the reference's structured-sparsity scalar kernels (cpp:907-1177);
  - the Gauss-Newton iteration loop runs inside `lax.while_loop` with zero
    host round-trips; per-iteration telemetry and the debug-pose trace
    (`debug_poses_`, cpp:111/341) are fixed-size carry buffers;
  - every entry point also has a `*_batched` variant: `vmap` over thousands of
    independent frames per device, the embarrassingly-parallel axis the
    reference executes one call at a time (SURVEY.md §2).

Cost accounting: the reference's per-observation `error_i` drops one of the
u/v terms depending on the Huber branch (cpp:1432 vs 1450 -- a known quirk,
SURVEY.md §7). We use the correct robust cost w*(r_u^2 + r_v^2) everywhere;
per-mode normalization of the printed cost matches the reference
(mono: * 0.5/n, cpp:113; stereo: / (0.5*(n_l + n_r)), cpp:343).

All solvers keep the reference's fixed damping lambda = 1e-5 (cpp:57,235,472),
Manhattan-Huber weights, output-only outlier masks (they never gate the
normal equations, exactly like the reference), update-before-convergence-
check ordering, and the NaN write-back guard (cpp:159-167). Mask semantics
are selectable via ``Options.outlier_mask``: the default 'final' reports the
final evaluated iteration's mask (a deliberate deviation -- the reference
accumulates outlier flags stickily from iteration 0, cpp:95-98, so any
coarse initial guess permanently flags points); 'reference' reproduces that
sticky accumulation exactly for parity.
"""

from __future__ import annotations

import functools
import time
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.lie import (
    add_front_se3,
    compose,
    inverse_se3,
    planar_to_se3,
    se3_to_planar,
)
from ..ops.projection import (
    pose_only_jacobian_6dof,
    pose_only_jacobian_planar3dof,
    residual_and_weight,
)
from ..options import IterationHandle, IterationStatus, Options
from ..summary import (
    INFO_ABS_GRADIENT,
    INFO_ABS_STEP,
    INFO_AVG_REPROJ,
    INFO_COST,
    INFO_COST_CHANGE,
    INFO_DAMPING,
    INFO_NUM_COLS,
    INFO_STATUS,
    Summary,
)

_FIXED_LAMBDA = 1e-5  # reference: pose-only solvers never adapt damping (cpp:57)
_HIGHEST = jax.lax.Precision.HIGHEST

class PoseOnlyResult(NamedTuple):
    """Device-side result of one pose-only solve (mono or stereo)."""

    pose: jax.Array  # (4, 4) optimized user-facing pose
    mask_inlier: jax.Array  # (P,) bool, left camera
    mask_inlier_right: jax.Array  # (P,) bool (== mask_inlier for mono)
    success: jax.Array  # () bool: NaN guard (cpp:159-167)
    converged: jax.Array  # () bool
    num_iterations: jax.Array  # () int32: loop trips executed
    info: jax.Array  # (max_iter, INFO_NUM_COLS)
    num_info: jax.Array  # () int32: valid rows in `info`
    debug_poses: jax.Array  # (max_iter, 4, 4) per-iteration pose trace
    num_debug: jax.Array  # () int32


class _Carry(NamedTuple):
    R: jax.Array
    t: jax.Array
    err_prev: jax.Array
    it: jax.Array
    done: jax.Array
    converged: jax.Array
    mask_left: jax.Array
    mask_right: jax.Array
    info: jax.Array
    num_info: jax.Array
    debug_R: jax.Array
    debug_t: jax.Array
    step_norm: jax.Array


def _to_Rt(T: jax.Array) -> tuple[jax.Array, jax.Array]:
    return T[..., :3, :3], T[..., :3, 3]


def _to_T(R: jax.Array, t: jax.Array) -> jax.Array:
    batch = R.shape[:-2]
    T = jnp.zeros(batch + (4, 4), dtype=R.dtype)
    T = T.at[..., :3, :3].set(R)
    T = T.at[..., :3, 3].set(t)
    return T.at[..., 3, 3].set(1.0)


def _normal_equations(J, r, w, dim):
    """Weighted normal equations from (P, 2, dim) Jacobians.

    JtWJ = sum_p w_p J_p^T J_p and g = sum_p w_p J_p^T r_p, contracted over
    both residual rows: one (2P, dim)^T @ (2P, dim) contraction at HIGHEST
    precision, replacing the reference's scalar rank-1 kernels
    (pose_only cpp:907-1177).
    """
    Jw = J * w[:, None, None]
    JtWJ = jnp.einsum("pri,prj->ij", Jw, J, precision=_HIGHEST)
    g = jnp.einsum("pri,pr->i", Jw, r, precision=_HIGHEST)
    return JtWJ, g


def _damped_solve(JtWJ, g, dim):
    """(1 + lambda) diagonal damping + solve, reference cpp:102-105.

    `jnp.linalg.solve` (one small LU call per frame; the batched solvers
    vmap it).
    """
    H = JtWJ + jnp.diag(jnp.diag(JtWJ)) * _FIXED_LAMBDA
    delta = jnp.linalg.solve(H, -g)
    # A frame with no valid observations (e.g. a compaction padding row)
    # has an exactly-ZERO system: LU back-substitution emits NaN/inf, which
    # would poison step_norm and keep the frame "unconverged" forever. Give
    # those frames a zero step (they converge on their first iteration),
    # (a zero step for a zero system). The guard
    # keys on the INPUT being all-zero, not on the output being non-finite,
    # so genuinely broken systems (e.g. NaN residuals from z=0 points)
    # still propagate to the solver's NaN failure guard (success=False).
    zero_sys = jnp.logical_and(
        jnp.all(JtWJ == 0.0), jnp.all(g == 0.0)
    )
    return jnp.where(zero_sys, jnp.zeros_like(delta), delta)


def _record_iteration(
    carry: _Carry,
    err_curr,
    step_norm,
    conv_now,
    at_last,
    R_new,
    t_new,
    debug_pose,
):
    """Shared bookkeeping: info row (skipped on the converging iteration,
    matching the reference's break-before-push, cpp:116-121 vs 128-147),
    debug-pose trace (always pushed, cpp:111), convergence flags.

    With Options.record_history=False the buffers have one row (index via
    min(it, rows-1) -> always 0): the reference's `summary == nullptr` mode.
    """
    it = carry.it
    delta_err = jnp.abs(err_curr - carry.err_prev)
    row = jnp.zeros((INFO_NUM_COLS,), dtype=carry.info.dtype)
    row = row.at[INFO_COST].set(err_curr)
    row = row.at[INFO_COST_CHANGE].set(delta_err)
    row = row.at[INFO_AVG_REPROJ].set(err_curr)
    row = row.at[INFO_ABS_STEP].set(step_norm)
    row = row.at[INFO_ABS_GRADIENT].set(0.0)
    row = row.at[INFO_DAMPING].set(-1.0)
    row = row.at[INFO_STATUS].set(float(int(IterationStatus.UPDATE)))

    write = jnp.logical_not(conv_now)
    slot = jnp.minimum(it, carry.info.shape[0] - 1)
    info = carry.info.at[slot].set(jnp.where(write, row, carry.info[slot]))
    num_info = carry.num_info + write.astype(jnp.int32)

    dbg_R, dbg_t = _to_Rt(debug_pose)
    dslot = jnp.minimum(it, carry.debug_R.shape[0] - 1)
    debug_R = carry.debug_R.at[dslot].set(dbg_R)
    debug_t = carry.debug_t.at[dslot].set(dbg_t)

    done = conv_now | at_last
    converged = jnp.where(conv_now, True, jnp.logical_not(at_last))
    return carry._replace(
        R=R_new,
        t=t_new,
        err_prev=err_curr,
        it=it + 1,
        done=done,
        converged=converged,
        info=info,
        num_info=num_info,
        debug_R=debug_R,
        debug_t=debug_t,
        step_norm=step_norm,
    )


def _finish(carry: _Carry, pose_out: jax.Array) -> PoseOnlyResult:
    finite = jnp.all(jnp.isfinite(pose_out))
    return PoseOnlyResult(
        pose=pose_out,
        mask_inlier=carry.mask_left,
        mask_inlier_right=carry.mask_right,
        success=finite,
        converged=carry.converged,
        num_iterations=carry.it,
        info=carry.info,
        num_info=carry.num_info,
        debug_poses=_to_T(carry.debug_R, carry.debug_t),
        num_debug=carry.it,
    )


def _init_carry(
    R0, t0, valid_left, valid_right, max_iter, dtype, record=True
) -> _Carry:
    hist = max_iter if record else 1
    return _Carry(
        R=R0,
        t=t0,
        err_prev=jnp.asarray(1e10, dtype=dtype),
        it=jnp.asarray(0, jnp.int32),
        done=jnp.asarray(False),
        converged=jnp.asarray(True),
        mask_left=valid_left,
        mask_right=valid_right,
        info=jnp.zeros((hist, INFO_NUM_COLS), dtype=dtype),
        num_info=jnp.asarray(0, jnp.int32),
        debug_R=jnp.zeros((hist, 3, 3), dtype=dtype),
        debug_t=jnp.zeros((hist, 3), dtype=dtype),
        step_norm=jnp.asarray(0.0, dtype=dtype),
    )


# ---------------------------------------------------------------------------
# 6-DoF
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("options",))
def solve_monocular_6dof_jax(
    points: jax.Array,  # (P, 3) points in the reference frame
    pixels: jax.Array,  # (P, 2) matched pixels in the current frame
    valid: jax.Array,  # (P,) bool validity (all True for unpadded input)
    intrinsics: jax.Array,  # (4,) fx, fy, cx, cy
    pose_reference_to_current: jax.Array,  # (4, 4)
    options: Options,
) -> PoseOnlyResult:
    """Monocular 6-DoF pose-only BA (reference cpp:8-170).

    Optimizes T_cw (the inverse of the input pose, cpp:51-52) by damped
    Gauss-Newton with analytic Jacobians; returns the optimized
    reference->current pose (re-inverted, cpp:160).
    """
    dtype = points.dtype
    fx, fy, cx, cy = intrinsics[0], intrinsics[1], intrinsics[2], intrinsics[3]
    opts = options
    max_iter = opts.iteration_handle.max_num_iterations
    huber = opts.outlier_handle.threshold_huber_loss
    thr_outlier = opts.outlier_handle.threshold_outlier_rejection
    thr_step = opts.convergence_handle.threshold_step_size
    thr_cost = opts.convergence_handle.threshold_cost_change

    R0, t0 = _to_Rt(pose_reference_to_current)
    R0, t0 = inverse_se3(R0, t0)  # optimize T_cw

    validf = valid.astype(dtype)
    inv_n = 1.0 / jnp.maximum(jnp.sum(validf), 1.0)

    sticky = getattr(opts, "outlier_mask", "final") == "reference"

    def cond(c: _Carry):
        return jnp.logical_and(c.it < max_iter, jnp.logical_not(c.done))

    def body(c: _Carry):
        X_c = jnp.einsum("ij,pj->pi", c.R, points, precision=_HIGHEST) + c.t
        r, w, manhattan = residual_and_weight(
            X_c, pixels, fx, fy, cx, cy, huber
        )
        J = pose_only_jacobian_6dof(X_c, fx, fy)
        wv = w * validf
        JtWJ, g = _normal_equations(J, r, wv, 6)
        err_sum = jnp.sum(wv * (r[:, 0] ** 2 + r[:, 1] ** 2))
        # Default 'final': the mask reports the final evaluated iteration
        # (documented deviation). 'reference' parity: sticky accumulation
        # from iteration 0 (cpp:95-98) -- once out, always out.
        mask_now = valid & (manhattan < thr_outlier)
        mask_left = c.mask_left & mask_now if sticky else mask_now
        delta = _damped_solve(JtWJ, g, 6)
        R_new, t_new = add_front_se3(c.R, c.t, delta)

        err_curr = 0.5 * inv_n * err_sum

        step_norm = jnp.linalg.norm(delta)
        conv_now = jnp.logical_or(
            step_norm < thr_step, jnp.abs(err_curr - c.err_prev) < thr_cost
        )
        at_last = c.it == max_iter - 1
        debug_pose = _to_T(*inverse_se3(R_new, t_new))
        c = c._replace(mask_left=mask_left, mask_right=mask_left)
        return _record_iteration(
            c, err_curr, step_norm, conv_now, at_last, R_new, t_new, debug_pose
        )

    carry0 = _init_carry(
        R0, t0, valid, valid, max_iter, dtype,
        record=getattr(opts, "record_history", True),
    )
    carry = jax.lax.while_loop(cond, body, carry0)
    R_out, t_out = inverse_se3(carry.R, carry.t)
    return _finish(carry, _to_T(R_out, t_out))


@functools.partial(jax.jit, static_argnames=("options",))
def solve_stereo_6dof_jax(
    points: jax.Array,  # (P, 3)
    pixels_left: jax.Array,  # (P, 2)
    pixels_right: jax.Array,  # (P, 2); x<0 or y<0 marks "no right match"
    valid: jax.Array,  # (P,) bool
    intrinsics_left: jax.Array,  # (4,)
    intrinsics_right: jax.Array,  # (4,)
    pose_left_to_right: jax.Array,  # (4, 4) rig extrinsic (cpp:179)
    pose_reference_to_current_left: jax.Array,  # (4, 4)
    options: Options,
) -> PoseOnlyResult:
    """Stereo 6-DoF pose-only BA (reference cpp:172-399).

    The right-camera Jacobian is taken w.r.t. a perturbation in the right
    frame, exactly like the reference (cpp:304-307) -- exact when the rig
    rotation is identity, first-order otherwise.
    """
    dtype = points.dtype
    fxl, fyl, cxl, cyl = (intrinsics_left[i] for i in range(4))
    fxr, fyr, cxr, cyr = (intrinsics_right[i] for i in range(4))
    opts = options
    max_iter = opts.iteration_handle.max_num_iterations
    huber = opts.outlier_handle.threshold_huber_loss
    thr_outlier = opts.outlier_handle.threshold_outlier_rejection
    thr_step = opts.convergence_handle.threshold_step_size
    thr_cost = opts.convergence_handle.threshold_cost_change

    R_rl, t_rl = _to_Rt(pose_left_to_right)
    R_rl, t_rl = inverse_se3(R_rl, t_rl)  # right<-left (cpp:228)
    R0, t0 = _to_Rt(pose_reference_to_current_left)
    R0, t0 = inverse_se3(R0, t0)

    has_right = (pixels_right[:, 0] >= 0) & (pixels_right[:, 1] >= 0)  # cpp:298
    valid_right = valid & has_right
    validf_l = valid.astype(dtype)
    validf_r = valid_right.astype(dtype)
    inv_n = 1.0 / jnp.maximum(jnp.sum(validf_l) + jnp.sum(validf_r), 1.0)
    sticky = getattr(opts, "outlier_mask", "final") == "reference"

    def cond(c: _Carry):
        return jnp.logical_and(c.it < max_iter, jnp.logical_not(c.done))

    def body(c: _Carry):
        X_l = jnp.einsum("ij,pj->pi", c.R, points, precision=_HIGHEST) + c.t
        X_r = jnp.einsum("ij,pj->pi", R_rl, X_l, precision=_HIGHEST) + t_rl

        r_l, w_l, man_l = residual_and_weight(
            X_l, pixels_left, fxl, fyl, cxl, cyl, huber
        )
        r_r, w_r, man_r = residual_and_weight(
            X_r, pixels_right, fxr, fyr, cxr, cyr, huber
        )
        J_l = pose_only_jacobian_6dof(X_l, fxl, fyl)
        J_r = pose_only_jacobian_6dof(X_r, fxr, fyr)

        wv_l = w_l * validf_l
        wv_r = w_r * validf_r
        JtWJ_l, g_l = _normal_equations(J_l, r_l, wv_l, 6)
        JtWJ_r, g_r = _normal_equations(J_r, r_r, wv_r, 6)
        JtWJ, g = JtWJ_l + JtWJ_r, g_l + g_r
        err_sum = jnp.sum(
            wv_l * (r_l[:, 0] ** 2 + r_l[:, 1] ** 2)
        ) + jnp.sum(wv_r * (r_r[:, 0] ** 2 + r_r[:, 1] ** 2))
        # 'final' mask (deviation note in the mono solver) or sticky
        # 'reference' accumulation (cpp:95-98).
        mask_l_now = valid & (man_l < thr_outlier)
        mask_r_now = valid_right & (man_r < thr_outlier)
        mask_left = c.mask_left & mask_l_now if sticky else mask_l_now
        mask_right = c.mask_right & mask_r_now if sticky else mask_r_now

        delta = _damped_solve(JtWJ, g, 6)
        R_new, t_new = add_front_se3(c.R, c.t, delta)

        # Reference normalization: err / (0.5 * (n_left + n_right)), cpp:343.
        err_curr = err_sum * (2.0 * inv_n)

        step_norm = jnp.linalg.norm(delta)
        conv_now = jnp.logical_or(
            step_norm < thr_step, jnp.abs(err_curr - c.err_prev) < thr_cost
        )
        at_last = c.it == max_iter - 1
        debug_pose = _to_T(*inverse_se3(R_new, t_new))
        c = c._replace(mask_left=mask_left, mask_right=mask_right)
        return _record_iteration(
            c, err_curr, step_norm, conv_now, at_last, R_new, t_new, debug_pose
        )

    carry0 = _init_carry(
        R0, t0, valid, valid & has_right, max_iter, dtype,
        record=getattr(opts, "record_history", True),
    )
    carry = jax.lax.while_loop(cond, body, carry0)
    R_out, t_out = inverse_se3(carry.R, carry.t)
    return _finish(carry, _to_T(R_out, t_out))


# ---------------------------------------------------------------------------
# Planar 3-DoF
# ---------------------------------------------------------------------------


class _PlanarCarry(NamedTuple):
    theta: jax.Array  # (3,) current (x, y, psi) of base2<-base1
    err_prev: jax.Array
    it: jax.Array
    done: jax.Array
    converged: jax.Array
    mask_left: jax.Array
    mask_right: jax.Array
    info: jax.Array
    num_info: jax.Array
    debug_R: jax.Array
    debug_t: jax.Array


def _planar_prior(
    pose_base_to_camera, pose_world_to_last, pose_world_to_current
):
    """Extract the planar prior theta = (x, y, psi) of base2<-base1 from the
    camera-pose prior chain T_b2b1 = T_bc (T_wc2)^-1 T_wc1 T_cb
    (reference cpp:449-460)."""
    R_bc, t_bc = _to_Rt(pose_base_to_camera)
    R_cb, t_cb = inverse_se3(R_bc, t_bc)
    R_wc2, t_wc2 = _to_Rt(pose_world_to_current)
    R_c2w, t_c2w = inverse_se3(R_wc2, t_wc2)
    R_wc1, t_wc1 = _to_Rt(pose_world_to_last)
    R_c2c1, t_c2c1 = compose(R_c2w, t_c2w, R_wc1, t_wc1)
    R_tmp, t_tmp = compose(R_bc, t_bc, R_c2c1, t_c2c1)
    R_b2b1, t_b2b1 = compose(R_tmp, t_tmp, R_cb, t_cb)
    return se3_to_planar(R_b2b1, t_b2b1), (R_cb, t_cb), (R_bc, t_bc)


def _planar_update(theta, delta):
    """Left-compose a planar delta and re-extract params (cpp:536-547):
    translation from the composed pose, psi accumulated additively."""
    dx, dy, dpsi = delta[0], delta[1], delta[2]
    c, s = jnp.cos(dpsi), jnp.sin(dpsi)
    x, y, psi = theta[0], theta[1], theta[2]
    return jnp.stack([c * x - s * y + dx, s * x + c * y + dy, psi + dpsi])


def _planar_record(
    c: _PlanarCarry, theta_new, err_curr, step_norm, conv_now, at_last, debug_pose
) -> _PlanarCarry:
    it = c.it
    delta_err = jnp.abs(err_curr - c.err_prev)
    row = jnp.zeros((INFO_NUM_COLS,), dtype=c.info.dtype)
    row = row.at[INFO_COST].set(err_curr)
    row = row.at[INFO_COST_CHANGE].set(delta_err)
    row = row.at[INFO_AVG_REPROJ].set(err_curr)
    row = row.at[INFO_ABS_STEP].set(step_norm)
    row = row.at[INFO_DAMPING].set(-1.0)
    row = row.at[INFO_STATUS].set(float(int(IterationStatus.UPDATE)))
    write = jnp.logical_not(conv_now)
    slot = jnp.minimum(it, c.info.shape[0] - 1)
    info = c.info.at[slot].set(jnp.where(write, row, c.info[slot]))
    dbg_R, dbg_t = _to_Rt(debug_pose)
    dslot = jnp.minimum(it, c.debug_R.shape[0] - 1)
    return c._replace(
        theta=theta_new,
        err_prev=err_curr,
        it=it + 1,
        done=conv_now | at_last,
        converged=jnp.where(conv_now, True, jnp.logical_not(at_last)),
        info=info,
        num_info=c.num_info + write.astype(jnp.int32),
        debug_R=c.debug_R.at[dslot].set(dbg_R),
        debug_t=c.debug_t.at[dslot].set(dbg_t),
    )


def _planar_result(c: _PlanarCarry, R_bc, t_bc) -> PoseOnlyResult:
    """Final pose: T_b2b1^-1 * T_bc (reference cpp:549-550, 839-840)."""
    R_p, t_p = planar_to_se3(c.theta)
    R_inv, t_inv = inverse_se3(R_p, t_p)
    R_out, t_out = compose(R_inv, t_inv, R_bc, t_bc)
    pose_out = _to_T(R_out, t_out)
    finite = jnp.all(jnp.isfinite(pose_out))
    return PoseOnlyResult(
        pose=pose_out,
        mask_inlier=c.mask_left,
        mask_inlier_right=c.mask_right,
        success=finite,
        converged=c.converged,
        num_iterations=c.it,
        info=c.info,
        num_info=c.num_info,
        debug_poses=_to_T(c.debug_R, c.debug_t),
        num_debug=c.it,
    )


@functools.partial(jax.jit, static_argnames=("options",))
def solve_monocular_planar3dof_jax(
    points: jax.Array,  # (P, 3) positions in the last (base1) frame
    pixels: jax.Array,  # (P, 2)
    valid: jax.Array,  # (P,) bool
    intrinsics: jax.Array,  # (4,)
    pose_base_to_camera: jax.Array,  # (4, 4)
    pose_world_to_last: jax.Array,  # (4, 4)
    pose_world_to_current: jax.Array,  # (4, 4) initial guess
    options: Options,
) -> PoseOnlyResult:
    """Monocular planar 3-DoF pose-only BA (reference cpp:401-615)."""
    dtype = points.dtype
    fx, fy, cx, cy = (intrinsics[i] for i in range(4))
    opts = options
    max_iter = opts.iteration_handle.max_num_iterations
    huber = opts.outlier_handle.threshold_huber_loss
    thr_outlier = opts.outlier_handle.threshold_outlier_rejection
    thr_step = opts.convergence_handle.threshold_step_size
    thr_cost = opts.convergence_handle.threshold_cost_change

    theta0, (R_cb, t_cb), (R_bc, t_bc) = _planar_prior(
        pose_base_to_camera, pose_world_to_last, pose_world_to_current
    )
    validf = valid.astype(dtype)
    inv_n = 1.0 / jnp.maximum(jnp.sum(validf), 1.0)
    sticky = getattr(opts, "outlier_mask", "final") == "reference"

    def cond(c: _PlanarCarry):
        return jnp.logical_and(c.it < max_iter, jnp.logical_not(c.done))

    def body(c: _PlanarCarry):
        R_p, t_p = planar_to_se3(c.theta)
        cos_psi, sin_psi = jnp.cos(c.theta[2]), jnp.sin(c.theta[2])
        R_cb1, t_cb1 = compose(R_cb, t_cb, R_p, t_p)  # camera<-base1 (cpp:490)
        X_c = (
            jnp.einsum("ij,pj->pi", R_cb1, points, precision=_HIGHEST) + t_cb1
        )
        r, w, manhattan = residual_and_weight(
            X_c, pixels, fx, fy, cx, cy, huber
        )
        J = pose_only_jacobian_planar3dof(
            X_c, points, fx, fy, R_cb, cos_psi, sin_psi
        )
        wv = w * validf
        JtWJ, g = _normal_equations(J, r, wv, 3)
        err_sum = jnp.sum(wv * (r[:, 0] ** 2 + r[:, 1] ** 2))
        mask_now = valid & (manhattan < thr_outlier)
        mask_left = c.mask_left & mask_now if sticky else mask_now
        delta = _damped_solve(JtWJ, g, 3)
        theta_new = _planar_update(c.theta, delta)

        err_curr = 0.5 * inv_n * err_sum
        step_norm = jnp.linalg.norm(delta)
        conv_now = jnp.logical_or(
            step_norm < thr_step, jnp.abs(err_curr - c.err_prev) < thr_cost
        )
        at_last = c.it == max_iter - 1
        Rn, tn = planar_to_se3(theta_new)
        Rni, tni = inverse_se3(Rn, tn)
        debug_pose = _to_T(*compose(Rni, tni, R_bc, t_bc))
        c = c._replace(mask_left=mask_left, mask_right=mask_left)
        return _planar_record(
            c, theta_new, err_curr, step_norm, conv_now, at_last, debug_pose
        )

    hist = max_iter if getattr(opts, "record_history", True) else 1
    carry0 = _PlanarCarry(
        theta=theta0,
        err_prev=jnp.asarray(1e10, dtype=dtype),
        it=jnp.asarray(0, jnp.int32),
        done=jnp.asarray(False),
        converged=jnp.asarray(True),
        mask_left=valid,
        mask_right=valid,
        info=jnp.zeros((hist, INFO_NUM_COLS), dtype=dtype),
        num_info=jnp.asarray(0, jnp.int32),
        debug_R=jnp.zeros((hist, 3, 3), dtype=dtype),
        debug_t=jnp.zeros((hist, 3), dtype=dtype),
    )
    carry = jax.lax.while_loop(cond, body, carry0)
    return _planar_result(carry, R_bc, t_bc)


@functools.partial(jax.jit, static_argnames=("options",))
def solve_stereo_planar3dof_jax(
    points: jax.Array,  # (P, 3) positions in the last (base1) frame
    pixels_left: jax.Array,  # (P, 2)
    pixels_right: jax.Array,  # (P, 2); x<0 or y<0 marks "no right match"
    valid: jax.Array,  # (P,) bool
    intrinsics_left: jax.Array,
    intrinsics_right: jax.Array,
    pose_base_to_camera: jax.Array,  # (4, 4)
    pose_left_to_right: jax.Array,  # (4, 4)
    pose_world_to_last: jax.Array,  # (4, 4)
    pose_world_to_current: jax.Array,  # (4, 4) initial guess
    options: Options,
) -> PoseOnlyResult:
    """Stereo planar 3-DoF pose-only BA (reference cpp:617-900)."""
    dtype = points.dtype
    fxl, fyl, cxl, cyl = (intrinsics_left[i] for i in range(4))
    fxr, fyr, cxr, cyr = (intrinsics_right[i] for i in range(4))
    opts = options
    max_iter = opts.iteration_handle.max_num_iterations
    huber = opts.outlier_handle.threshold_huber_loss
    thr_outlier = opts.outlier_handle.threshold_outlier_rejection
    thr_step = opts.convergence_handle.threshold_step_size
    thr_cost = opts.convergence_handle.threshold_cost_change

    theta0, (R_cb, t_cb), (R_bc, t_bc) = _planar_prior(
        pose_base_to_camera, pose_world_to_last, pose_world_to_current
    )
    R_lr, t_lr = _to_Rt(pose_left_to_right)
    R_rl, t_rl = inverse_se3(R_lr, t_lr)
    # Right-camera<-base rotation for the Jacobian chain (cpp:680-681).
    R_cb_right = jnp.einsum("ij,jk->ik", R_rl, R_cb, precision=_HIGHEST)

    has_right = (pixels_right[:, 0] >= 0) & (pixels_right[:, 1] >= 0)
    valid_right = valid & has_right
    validf_l = valid.astype(dtype)
    validf_r = valid_right.astype(dtype)
    inv_n = 1.0 / jnp.maximum(jnp.sum(validf_l) + jnp.sum(validf_r), 1.0)
    sticky = getattr(opts, "outlier_mask", "final") == "reference"

    def cond(c: _PlanarCarry):
        return jnp.logical_and(c.it < max_iter, jnp.logical_not(c.done))

    def body(c: _PlanarCarry):
        R_p, t_p = planar_to_se3(c.theta)
        cos_psi, sin_psi = jnp.cos(c.theta[2]), jnp.sin(c.theta[2])
        R_l, t_l = compose(R_cb, t_cb, R_p, t_p)
        R_r, t_r = compose(R_rl, t_rl, R_l, t_l)
        X_l = jnp.einsum("ij,pj->pi", R_l, points, precision=_HIGHEST) + t_l
        X_r = jnp.einsum("ij,pj->pi", R_r, points, precision=_HIGHEST) + t_r

        r_l, w_l, man_l = residual_and_weight(
            X_l, pixels_left, fxl, fyl, cxl, cyl, huber
        )
        r_r, w_r, man_r = residual_and_weight(
            X_r, pixels_right, fxr, fyr, cxr, cyr, huber
        )
        J_l = pose_only_jacobian_planar3dof(
            X_l, points, fxl, fyl, R_cb, cos_psi, sin_psi
        )
        J_r = pose_only_jacobian_planar3dof(
            X_r, points, fxr, fyr, R_cb_right, cos_psi, sin_psi
        )
        wv_l = w_l * validf_l
        wv_r = w_r * validf_r
        JtWJ_l, g_l = _normal_equations(J_l, r_l, wv_l, 3)
        JtWJ_r, g_r = _normal_equations(J_r, r_r, wv_r, 3)
        JtWJ, g = JtWJ_l + JtWJ_r, g_l + g_r
        err_sum = (
            jnp.sum(wv_l * (r_l[:, 0] ** 2 + r_l[:, 1] ** 2))
            + jnp.sum(wv_r * (r_r[:, 0] ** 2 + r_r[:, 1] ** 2))
        )
        # 'final' mask or sticky 'reference' accumulation (cpp:95-98).
        mask_l_now = valid & (man_l < thr_outlier)
        mask_r_now = valid_right & (man_r < thr_outlier)
        mask_left = c.mask_left & mask_l_now if sticky else mask_l_now
        mask_right = c.mask_right & mask_r_now if sticky else mask_r_now
        delta = _damped_solve(JtWJ, g, 3)
        theta_new = _planar_update(c.theta, delta)

        err_curr = err_sum * (2.0 * inv_n)
        step_norm = jnp.linalg.norm(delta)
        conv_now = jnp.logical_or(
            step_norm < thr_step, jnp.abs(err_curr - c.err_prev) < thr_cost
        )
        at_last = c.it == max_iter - 1
        Rn, tn = planar_to_se3(theta_new)
        Rni, tni = inverse_se3(Rn, tn)
        debug_pose = _to_T(*compose(Rni, tni, R_bc, t_bc))
        c = c._replace(mask_left=mask_left, mask_right=mask_right)
        return _planar_record(
            c, theta_new, err_curr, step_norm, conv_now, at_last, debug_pose
        )

    hist = max_iter if getattr(opts, "record_history", True) else 1
    carry0 = _PlanarCarry(
        theta=theta0,
        err_prev=jnp.asarray(1e10, dtype=dtype),
        it=jnp.asarray(0, jnp.int32),
        done=jnp.asarray(False),
        converged=jnp.asarray(True),
        mask_left=valid,
        mask_right=valid & has_right,
        info=jnp.zeros((hist, INFO_NUM_COLS), dtype=dtype),
        num_info=jnp.asarray(0, jnp.int32),
        debug_R=jnp.zeros((hist, 3, 3), dtype=dtype),
        debug_t=jnp.zeros((hist, 3), dtype=dtype),
    )
    carry = jax.lax.while_loop(cond, body, carry0)
    return _planar_result(carry, R_bc, t_bc)


# ---------------------------------------------------------------------------
# Batched (embarrassingly parallel over frames) variants
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("options",))
def solve_monocular_6dof_batched(
    points, pixels, valid, intrinsics, poses, options: Options
) -> PoseOnlyResult:
    """Batched mono 6-DoF over a leading frame axis.

    The reference runs one frame per call (pose_only...h:50-67); here
    thousands of frames solve concurrently -- SURVEY.md §2 "embarrassingly-
    parallel batch solve" -- as a vmap of the per-frame solver (frames
    iterate in lockstep until the last one stops). Inputs gain a leading
    (B,) axis; `intrinsics` may be (4,) shared or (B, 4).
    """
    in_axes = (0, 0, 0, 0 if intrinsics.ndim == 2 else None, 0, None)
    return jax.vmap(
        solve_monocular_6dof_jax, in_axes=in_axes
    )(points, pixels, valid, intrinsics, poses, options)


@functools.partial(jax.jit, static_argnames=("options",))
def solve_stereo_6dof_batched(
    points,
    pixels_left,
    pixels_right,
    valid,
    intrinsics_left,
    intrinsics_right,
    pose_left_to_right,
    poses,
    options: Options,
) -> PoseOnlyResult:
    """Batched stereo 6-DoF over a leading frame axis: vmap of the
    per-frame solver (see the mono batched docstring); rig arrays may be
    shared or carry a leading (B,) axis."""
    in_axes = (
        0,
        0,
        0,
        0,
        0 if intrinsics_left.ndim == 2 else None,
        0 if intrinsics_right.ndim == 2 else None,
        0 if pose_left_to_right.ndim == 3 else None,
        0,
        None,
    )
    return jax.vmap(solve_stereo_6dof_jax, in_axes=in_axes)(
        points,
        pixels_left,
        pixels_right,
        valid,
        intrinsics_left,
        intrinsics_right,
        pose_left_to_right,
        poses,
        options,
    )


_DISPATCH_MS = None
_KERNEL_RATE_MS: dict = {}

# A segment boundary (dispatch + convergence-mask fetch) must be repaid by
# at least this multiple of its cost in projected kernel savings before the
# auto policy takes it.
_COMPACT_GATE = 2.0


def _dispatch_ms() -> float:
    """Measured dispatch+fetch round-trip (ms), cached per process. The
    auto compaction policy compares every segment boundary's projected
    device savings against this cost."""
    global _DISPATCH_MS
    if _DISPATCH_MS is None:
        x = jnp.zeros((), jnp.float32)
        float(x + 1.0)  # compile + warm the trivial add
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            float(x + 1.0)
            times.append((time.perf_counter() - t0) * 1e3)
        _DISPATCH_MS = sorted(times)[1]
    return _DISPATCH_MS


def _segment_economics(tag, cur, solve_fn, options, total_max):
    """(boundary_cost_ms, kernel_ms_per_iter) for this bucket, measured.

    A 1-iteration solve's wall time IS a segment boundary's true cost
    (dispatch + fetch through whatever link this rig has, real argument
    paths); the full-length solve adds (total_max - 1) kernel iterations
    on top. Medians of 3 alternating pairs keep dispatch jitter from
    flipping the decision -- the round-trip-vs-kernel gap this measures is
    exactly the quantity the noise rides on. Cached per (solver, bucket
    shape): in a serving loop the calibration (3 short + 3 full solves +
    their compiles) amortizes to zero."""
    key = (tag, cur[0].shape[:2], total_max)
    if key not in _KERNEL_RATE_MS:
        def timed(n):
            o = options.replace(iteration_handle=IterationHandle(n))
            t0 = time.perf_counter()
            res = solve_fn(cur, o)
            float(jnp.asarray(res.pose[0, 0, 0]))  # fetch = sync
            return (time.perf_counter() - t0) * 1e3

        timed(1), timed(total_max)  # compile + warm both executables
        t1s, tfs = [], []
        for _ in range(3):
            t1s.append(timed(1))
            tfs.append(timed(total_max))
        d_eff = sorted(t1s)[1]
        k_total = max(sorted(tfs)[1] - d_eff, 0.0)
        _KERNEL_RATE_MS[key] = (
            d_eff, k_total / max(total_max - 1, 1)
        )
    return _KERNEL_RATE_MS[key]


def _compacting_solve(
    frame_arrays,
    pose_slot: int,
    valid_slot: int,
    solve_fn,
    options: Options,
    check_every,
    min_bucket: int,
    carry_pose=None,
) -> PoseOnlyResult:
    """Generic STRAGGLER-COMPACTION driver core (all four batched modes).

    The lockstep batched loop pays a full kernel pass for every frame until
    the LAST frame converges; on a realistic mixed-difficulty batch the
    measured waste is severe (benchmarks/straggler_study.py: p50 = 5
    iterations but one runaway frame pins the loop at max_iter, 94.7% of
    frame-passes wasted). This driver runs the batched solver in
    `check_every`-iteration segments; between segments it fetches the
    per-frame convergence mask, retires finished frames, and re-packs the
    survivors into the smallest power-of-two bucket >= `min_bucket` (a
    gather along the frame axis), so stragglers iterate in a shrunken
    batch.

    `frame_arrays` is a tuple of per-frame (B, ...) arrays re-packed
    between segments; `solve_fn(arrays, options)` runs the lockstep batched
    solver on one bucket; `pose_slot` names the array that carries the
    pose estimate between segments and `valid_slot` the per-point validity
    mask (cleared on padding rows). `carry_pose(res, arrays)` maps a
    segment result to the next segment's pose-slot value -- `res.pose` by
    default (6-DoF modes); the planar modes reconstruct the world-to-
    current pose T_wl @ T_cb @ res.pose from the relative-pose result
    convention (cf. _planar_result, reference cpp:549-550).

    Cost model: each segment boundary costs one dispatch + mask fetch
    against device savings of (retired_frames / batch) x segment time.
    `check_every="auto"` (default) makes that trade explicitly: it
    calibrates the dispatch round-trip (`_dispatch_ms`, cached per
    process) and the bucket's per-iteration kernel rate
    (`_segment_economics`, 3 short + 3 full solves cached per solver/shape),
    runs pure lockstep in ONE segment when the whole solve's device time
    cannot repay a single boundary (the driver then never loses to the
    lockstep solver), and otherwise keeps taking
    boundaries only while the next one's best-case savings exceed
    `_COMPACT_GATE` x dispatch cost. An integer `check_every` forces fixed
    segmenting (the benchmarks/straggler_study.py A/B).

    Semantics vs the lockstep solver: identical GN trajectory per frame
    (the update is memoryless; for the planar modes the restarted prior
    theta equals the previous segment's final theta identically), except
    that `err_prev` resets at segment boundaries, so a frame converging by
    the COST-CHANGE criterion exactly at a boundary may run up to one
    extra segment; the step-size criterion is unaffected. Requires
    record_history=False (the reference's summary == nullptr mode) and a
    shared rig (per-frame intrinsics/extrinsics are not re-packed).
    """
    if getattr(options, "record_history", True):
        raise ValueError(
            "compacting driver requires Options.record_history=False"
        )
    if getattr(options, "outlier_mask", "final") == "reference":
        # Sticky masks carry err_prev-style state ACROSS iterations; the
        # segment restarts would silently reset them, so the reported
        # mask_inlier would diverge from the lockstep result.
        raise ValueError(
            "compacting driver does not support outlier_mask='reference' "
            "(sticky masks reset at segment boundaries); use the lockstep "
            "batched solver"
        )
    if carry_pose is None:
        def carry_pose(res, arrays):
            return res.pose
    cur = tuple(jnp.asarray(a) for a in frame_arrays)
    B, P = cur[valid_slot].shape[0], cur[valid_slot].shape[1]
    total_max = options.iteration_handle.max_num_iterations

    auto_policy = check_every == "auto"
    if auto_policy:
        # Dispatch-aware policy: a segment boundary costs one dispatch +
        # mask fetch, so take boundaries only while their projected device
        # savings repay that cost. When the WHOLE solve's device time
        # cannot repay even one boundary, run pure lockstep in a single
        # segment -- the driver then never loses to the lockstep solver
        # beyond the cached one-time calibration (amortized to zero in
        # serving).
        disp, k_ms = _segment_economics(
            getattr(solve_fn, "__qualname__", repr(solve_fn)),
            cur, solve_fn, options, total_max,
        )
        disp = max(disp, _dispatch_ms())
        if k_ms * total_max < _COMPACT_GATE * disp:
            # One-segment regime: DELEGATE to the lockstep solver outright.
            # The compacting driver's bucket pack + per-field host readback
            # costs 3-4 extra round trips even when it takes no boundary;
            # the lockstep call is the same GN
            # trajectory bitwise, returns device-resident arrays, and
            # therefore never loses by construction.
            return solve_fn(cur, options)
        check_every = 8

    import numpy as onp

    out_pose = onp.zeros((B, 4, 4), onp.float32)
    out_mask_l = onp.zeros((B, P), bool)
    out_mask_r = onp.zeros((B, P), bool)
    out_succ = onp.zeros(B, bool)
    out_conv = onp.zeros(B, bool)
    out_iters = onp.zeros(B, onp.int32)

    def bucket_of(n):
        b = min_bucket
        while b < n:
            b *= 2
        return min(b, B)

    active = onp.arange(B)
    used = 0
    while used < total_max and active.size:
        seg = min(check_every, total_max - used)
        o = options.replace(iteration_handle=IterationHandle(seg))
        res = solve_fn(cur, o)
        nb = cur[valid_slot].shape[0]
        live = onp.arange(active.size)  # rows of this bucket that are real
        conv_seg = onp.asarray(res.converged)[:nb][: active.size]
        it_seg = onp.asarray(res.num_iterations)[:nb][: active.size]
        used += seg
        out_iters[active] += it_seg.astype(onp.int32)
        finished = conv_seg | (used >= total_max)

        fin_rows = live[finished]
        if fin_rows.size:
            fin_ids = active[finished]
            # Gather the retired rows on device BEFORE fetching: the host
            # readback then moves only the finished frames' data, not the
            # whole bucket's (B, P) masks.
            fidx = jnp.asarray(fin_rows)
            out_pose[fin_ids] = onp.asarray(jnp.take(res.pose, fidx, axis=0))
            out_mask_l[fin_ids] = onp.asarray(
                jnp.take(res.mask_inlier, fidx, axis=0)
            )
            out_mask_r[fin_ids] = onp.asarray(
                jnp.take(res.mask_inlier_right, fidx, axis=0)
            )
            out_succ[fin_ids] = onp.asarray(jnp.take(res.success, fidx))
            out_conv[fin_ids] = conv_seg[finished]

        keep_rows = live[~finished]
        active = active[~finished]
        if not active.size:
            break
        nb_new = bucket_of(active.size)
        if auto_policy and used < total_max:
            # Keep segmenting only while the NEXT boundary's best-case
            # savings (half the survivors retiring for the remaining
            # iterations; device rate scales with bucket rows) repay it.
            remaining = total_max - used
            k_now = k_ms * nb_new / max(B, 1)
            if (0.5 * k_now * max(remaining - check_every, 0)
                    < _COMPACT_GATE * disp):
                check_every = total_max  # run survivors to completion
        # Re-pack survivors to the head of a (possibly smaller) bucket.
        # Padding rows replicate row 0 with valid=False: they converge on
        # their first iteration (zero system -> zero step) and never gate
        # the lockstep loop.
        pad = nb_new - active.size
        idx = jnp.asarray(
            onp.concatenate([keep_rows, onp.zeros(pad, onp.int64)])
        )
        pose_next = carry_pose(res, cur)
        new_cur = []
        for k, arr in enumerate(cur):
            g = jnp.take(pose_next if k == pose_slot else arr, idx, axis=0)
            if k == valid_slot and pad:
                g = g.at[active.size:].set(False)
            new_cur.append(g)
        cur = tuple(new_cur)

    hist = 1
    return PoseOnlyResult(
        pose=jnp.asarray(out_pose),
        mask_inlier=jnp.asarray(out_mask_l),
        mask_inlier_right=jnp.asarray(out_mask_r),
        success=jnp.asarray(out_succ),
        converged=jnp.asarray(out_conv),
        num_iterations=jnp.asarray(out_iters),
        info=jnp.zeros((B, hist, INFO_NUM_COLS), jnp.float32),
        num_info=jnp.zeros(B, jnp.int32),
        debug_poses=jnp.zeros((B, hist, 4, 4), jnp.float32),
        num_debug=jnp.zeros(B, jnp.int32),
    )


def _require_shared_rig(*mats):
    """The compaction driver re-packs only per-frame data; reject per-frame
    rigs (leading batch axis on intrinsics/extrinsics) loudly."""
    for name, m, nd in mats:
        if jnp.asarray(m).ndim != nd:
            raise ValueError(
                f"compacting driver requires a shared rig: {name} must be "
                f"{nd}-D (got shape {jnp.asarray(m).shape})"
            )


def solve_stereo_6dof_batched_compacting(
    points,
    pixels_left,
    pixels_right,
    valid,
    intrinsics_left,
    intrinsics_right,
    pose_left_to_right,
    poses,
    options: Options,
    check_every: int | str = "auto",
    min_bucket: int = 64,
) -> PoseOnlyResult:
    """Batched stereo 6-DoF with periodic straggler compaction (see
    `_compacting_solve` for the algorithm and cost model)."""
    _require_shared_rig(
        ("intrinsics_left", intrinsics_left, 1),
        ("intrinsics_right", intrinsics_right, 1),
        ("pose_left_to_right", pose_left_to_right, 2),
    )
    il, ir = jnp.asarray(intrinsics_left), jnp.asarray(intrinsics_right)
    T_lr = jnp.asarray(pose_left_to_right)

    def solve_fn(arr, o):
        return solve_stereo_6dof_batched(
            arr[0], arr[1], arr[2], arr[3], il, ir, T_lr, arr[4], o
        )

    return _compacting_solve(
        (points, pixels_left, pixels_right, valid, poses),
        pose_slot=4, valid_slot=3, solve_fn=solve_fn, options=options,
        check_every=check_every, min_bucket=min_bucket,
    )


def solve_monocular_6dof_batched_compacting(
    points,
    pixels,
    valid,
    intrinsics,
    poses,
    options: Options,
    check_every: int | str = "auto",
    min_bucket: int = 64,
) -> PoseOnlyResult:
    """Batched mono 6-DoF with periodic straggler compaction (see
    `_compacting_solve`)."""
    _require_shared_rig(("intrinsics", intrinsics, 1))
    intr = jnp.asarray(intrinsics)

    def solve_fn(arr, o):
        return solve_monocular_6dof_batched(
            arr[0], arr[1], arr[2], intr, arr[3], o
        )

    return _compacting_solve(
        (points, pixels, valid, poses),
        pose_slot=3, valid_slot=2, solve_fn=solve_fn, options=options,
        check_every=check_every, min_bucket=min_bucket,
    )


def _planar_carry_pose(T_bc):
    """Planar restart carry: the planar solvers return T_b2b1^-1 @ T_bc
    (_planar_result, reference cpp:549-550) and take a world-to-current
    initial guess; the exact restart is T_wc = T_wl @ T_cb @ res.pose
    (the restarted prior theta then equals the previous segment's final
    theta identically)."""
    R_bc, t_bc = _to_Rt(jnp.asarray(T_bc))
    R_cb, t_cb = inverse_se3(R_bc, t_bc)
    T_cb = _to_T(R_cb, t_cb)

    def carry(res, arrays):
        T_wl = arrays[-2]  # poses_world_to_last rides just before the slot
        return jnp.einsum("bij,jk,bkl->bil", T_wl, T_cb, res.pose)

    return carry


def solve_monocular_planar3dof_batched_compacting(
    points,
    pixels,
    valid,
    intrinsics,
    pose_base_to_camera,
    poses_world_to_last,
    poses_world_to_current,
    options: Options,
    check_every: int | str = "auto",
    min_bucket: int = 64,
) -> PoseOnlyResult:
    """Batched planar 3-DoF mono with periodic straggler compaction (see
    `_compacting_solve`)."""
    _require_shared_rig(
        ("intrinsics", intrinsics, 1),
        ("pose_base_to_camera", pose_base_to_camera, 2),
    )
    intr = jnp.asarray(intrinsics)
    T_bc = jnp.asarray(pose_base_to_camera)

    def solve_fn(arr, o):
        return solve_monocular_planar3dof_batched(
            arr[0], arr[1], arr[2], intr, T_bc, arr[3], arr[4], o
        )

    return _compacting_solve(
        (points, pixels, valid, poses_world_to_last,
         poses_world_to_current),
        pose_slot=4, valid_slot=2, solve_fn=solve_fn, options=options,
        check_every=check_every, min_bucket=min_bucket,
        carry_pose=_planar_carry_pose(T_bc),
    )


def solve_stereo_planar3dof_batched_compacting(
    points,
    pixels_left,
    pixels_right,
    valid,
    intrinsics_left,
    intrinsics_right,
    pose_base_to_camera,
    pose_left_to_right,
    poses_world_to_last,
    poses_world_to_current,
    options: Options,
    check_every: int | str = "auto",
    min_bucket: int = 64,
) -> PoseOnlyResult:
    """Batched planar 3-DoF stereo with periodic straggler compaction (see
    `_compacting_solve`)."""
    _require_shared_rig(
        ("intrinsics_left", intrinsics_left, 1),
        ("intrinsics_right", intrinsics_right, 1),
        ("pose_base_to_camera", pose_base_to_camera, 2),
        ("pose_left_to_right", pose_left_to_right, 2),
    )
    il, ir = jnp.asarray(intrinsics_left), jnp.asarray(intrinsics_right)
    T_bc = jnp.asarray(pose_base_to_camera)
    T_lr = jnp.asarray(pose_left_to_right)

    def solve_fn(arr, o):
        return solve_stereo_planar3dof_batched(
            arr[0], arr[1], arr[2], arr[3], il, ir, T_bc, T_lr,
            arr[4], arr[5], o
        )

    return _compacting_solve(
        (points, pixels_left, pixels_right, valid, poses_world_to_last,
         poses_world_to_current),
        pose_slot=5, valid_slot=3, solve_fn=solve_fn, options=options,
        check_every=check_every, min_bucket=min_bucket,
        carry_pose=_planar_carry_pose(T_bc),
    )


@functools.partial(jax.jit, static_argnames=("options",))
def solve_monocular_planar3dof_batched(
    points, pixels, valid, intrinsics, pose_base_to_camera,
    poses_world_to_last, poses_world_to_current, options: Options,
) -> PoseOnlyResult:
    """Batched planar mono over a leading frame axis: vmap of the
    per-frame solver."""
    in_axes = (
        0, 0, 0,
        0 if intrinsics.ndim == 2 else None,
        0 if pose_base_to_camera.ndim == 3 else None,
        0, 0, None,
    )
    return jax.vmap(solve_monocular_planar3dof_jax, in_axes=in_axes)(
        points, pixels, valid, intrinsics, pose_base_to_camera,
        poses_world_to_last, poses_world_to_current, options,
    )


@functools.partial(jax.jit, static_argnames=("options",))
def solve_stereo_planar3dof_batched(
    points, pixels_left, pixels_right, valid, intrinsics_left,
    intrinsics_right, pose_base_to_camera, pose_left_to_right,
    poses_world_to_last, poses_world_to_current, options: Options,
) -> PoseOnlyResult:
    """Batched planar stereo over a leading frame axis: vmap of the
    per-frame solver."""
    in_axes = (
        0, 0, 0, 0,
        0 if intrinsics_left.ndim == 2 else None,
        0 if intrinsics_right.ndim == 2 else None,
        0 if pose_base_to_camera.ndim == 3 else None,
        0 if pose_left_to_right.ndim == 3 else None,
        0, 0, None,
    )
    return jax.vmap(solve_stereo_planar3dof_jax, in_axes=in_axes)(
        points, pixels_left, pixels_right, valid, intrinsics_left,
        intrinsics_right, pose_base_to_camera, pose_left_to_right,
        poses_world_to_last, poses_world_to_current, options,
    )


# ---------------------------------------------------------------------------
# Host-side convenience wrappers (numpy in/out + Summary)
# ---------------------------------------------------------------------------


def _timed(options: Options) -> bool:
    """Chunked-timing gate. time_iterations='device' is a full-BA
    point-major mode (its iter_time anchors on the assembly scope's trace
    events); refuse it here instead of silently reporting chunked
    dispatch+fetch wall times."""
    timed = getattr(options, "time_iterations", False)
    if timed == "device":
        raise ValueError(
            "time_iterations='device' requires the full-BA point-major "
            "engine; pose-only solvers support time_iterations=True "
            "(chunked wall-clock) only"
        )
    return bool(timed)


def _chunked_pose_only(step, pose0, options: Options):
    """Chunked-dispatch reporting mode for the pose-only solvers
    (Options.time_iterations): dispatch ONE GN iteration per jit call so
    the host can wall-clock each (the reference's per-iteration
    `iter_time`, pose_only cpp:126/139). Pose-only GN carries only the
    pose between iterations, so a max_iter=1 call per step with host-side
    convergence checks replays the in-jit while_loop exactly; sticky
    'reference' masks accumulate across chunks by the same AND the
    reference applies per iteration.

    `step(pose, opts1)` runs one iteration from `pose`. Returns
    (pose, mask_l, mask_r, summary).

    Note: each chunk round-trips the pose through the user-facing
    write-back (T_cw -> T_wc -> T_cw in f32), so the trajectory can differ
    from the monolithic loop by rounding -- near a convergence threshold
    that can shift the stop point by one iteration. Final poses agree to
    f32 precision.
    """
    import time as _time

    from ..options import ConvergenceHandle, IterationHandle

    opts1 = options.replace(
        iteration_handle=IterationHandle(1),
        convergence_handle=ConvergenceHandle(0.0, 0.0),
        record_history=True,
    )
    max_iter = options.iteration_handle.max_num_iterations
    thr_step = options.convergence_handle.threshold_step_size
    thr_cost = options.convergence_handle.threshold_cost_change
    sticky = getattr(options, "outlier_mask", "final") == "reference"

    err_prev = 1e10
    pose = jnp.asarray(pose0, jnp.float32)
    info_rows, iter_times = [], []
    mask_l = mask_r = None
    converged = True
    for it in range(max_iter):
        t0 = _time.perf_counter()
        res = step(pose, opts1)
        err_curr = float(res.info[0, INFO_COST])  # fetch doubles as sync
        iter_times.append((_time.perf_counter() - t0) * 1e3)
        step_norm = float(res.info[0, INFO_ABS_STEP])
        pose = res.pose
        ml = np.asarray(res.mask_inlier)
        mr = np.asarray(res.mask_inlier_right)
        if sticky and mask_l is not None:
            mask_l = mask_l & ml
            mask_r = mask_r & mr
        else:
            mask_l, mask_r = ml, mr
        # Convergence math in f32, exactly like the in-jit loop (host f64
        # can flip the final iteration at the threshold boundary).
        delta_err = abs(
            np.float32(np.float32(err_curr) - np.float32(err_prev))
        )
        conv_now = bool(
            np.float32(step_norm) < np.float32(thr_step)
            or delta_err < np.float32(thr_cost)
        )
        at_last = it == max_iter - 1
        if not conv_now:
            # The in-chunk cost_change column compared against the chunk's
            # own 1e10 init; restore the cross-iteration value.
            row = np.asarray(res.info[0]).copy()
            row[INFO_COST_CHANGE] = delta_err
            info_rows.append(row)
        if conv_now:
            break
        if at_last:
            converged = False
        err_prev = err_curr
        if not np.isfinite(err_curr):
            break
    info = (
        np.stack(info_rows)
        if info_rows
        else np.zeros((0, INFO_NUM_COLS), np.float32)
    )
    iter_times = np.asarray(iter_times[: len(info_rows)])
    summary = Summary.from_device_buffers(
        info=info,
        num_iterations=len(info_rows),
        converged=converged,
        max_iteration=max_iter,
        threshold_step_size=thr_step,
        threshold_cost_change=thr_cost,
        total_time_ms=float(np.asarray(iter_times).sum()) if len(iter_times) else 0.0,
        iter_times_ms=iter_times if len(iter_times) else None,
    )
    return pose, mask_l, mask_r, summary


def _result_summary(res: PoseOnlyResult, options: Options) -> Summary:
    return Summary.from_device_buffers(
        info=np.asarray(res.info),
        num_iterations=int(res.num_info),
        converged=bool(res.converged),
        max_iteration=options.iteration_handle.max_num_iterations,
        threshold_step_size=options.convergence_handle.threshold_step_size,
        threshold_cost_change=options.convergence_handle.threshold_cost_change,
        total_time_ms=0.0,
    )


def solve_monocular_6dof(
    points, pixels, intrinsics, pose_reference_to_current, options: Options
):
    """Host wrapper: numpy in, (pose, mask_inlier, summary, success) out.

    Mirrors the reference signature Solve_Monocular_6Dof
    (pose_only_bundle_adjustment_solver.h:28-35).
    """
    points = jnp.asarray(points, dtype=jnp.float32)
    pixels = jnp.asarray(pixels, dtype=jnp.float32)
    valid = jnp.ones(points.shape[0], dtype=bool)
    intr = jnp.asarray(intrinsics, dtype=jnp.float32)
    if _timed(options):
        def step(pose, o1):
            return solve_monocular_6dof_jax(
                points, pixels, valid, intr, pose, o1
            )

        pose_d, mask, _, summary = _chunked_pose_only(
            step, pose_reference_to_current, options
        )
        pose = np.asarray(pose_d)
        ok = bool(np.isfinite(pose).all())
        if not ok:
            pose = np.asarray(pose_reference_to_current)
        return pose, mask, summary, ok
    res = solve_monocular_6dof_jax(
        points,
        pixels,
        valid,
        intr,
        jnp.asarray(pose_reference_to_current, dtype=jnp.float32),
        options,
    )
    summary = _result_summary(res, options)
    pose = np.asarray(res.pose)
    if not bool(res.success):  # NaN guard: keep the input pose (cpp:159-167)
        pose = np.asarray(pose_reference_to_current)
    return pose, np.asarray(res.mask_inlier), summary, bool(res.success)


def solve_stereo_6dof(
    points,
    pixels_left,
    pixels_right,
    intrinsics_left,
    intrinsics_right,
    pose_left_to_right,
    pose_reference_to_current_left,
    options: Options,
):
    """Host wrapper mirroring Solve_Stereo_6Dof (h:36-49)."""
    points = jnp.asarray(points, dtype=jnp.float32)
    valid = jnp.ones(points.shape[0], dtype=bool)
    sargs = (
        jnp.asarray(pixels_left, dtype=jnp.float32),
        jnp.asarray(pixels_right, dtype=jnp.float32),
        valid,
        jnp.asarray(intrinsics_left, dtype=jnp.float32),
        jnp.asarray(intrinsics_right, dtype=jnp.float32),
        jnp.asarray(pose_left_to_right, dtype=jnp.float32),
    )
    if _timed(options):
        def step(pose, o1):
            return solve_stereo_6dof_jax(points, *sargs, pose, o1)

        pose_d, mask_l, mask_r, summary = _chunked_pose_only(
            step, pose_reference_to_current_left, options
        )
        pose = np.asarray(pose_d)
        ok = bool(np.isfinite(pose).all())
        if not ok:
            pose = np.asarray(pose_reference_to_current_left)
        return pose, mask_l, mask_r, summary, ok
    res = solve_stereo_6dof_jax(
        points,
        *sargs,
        jnp.asarray(pose_reference_to_current_left, dtype=jnp.float32),
        options,
    )
    summary = _result_summary(res, options)
    pose = np.asarray(res.pose)
    if not bool(res.success):
        pose = np.asarray(pose_reference_to_current_left)
    return (
        pose,
        np.asarray(res.mask_inlier),
        np.asarray(res.mask_inlier_right),
        summary,
        bool(res.success),
    )


def solve_monocular_planar3dof(
    points,
    pixels,
    intrinsics,
    pose_base_to_camera,
    pose_world_to_last,
    pose_world_to_current,
    options: Options,
):
    """Host wrapper mirroring Solve_Monocular_Planar3Dof (h:50-58)."""
    points = jnp.asarray(points, dtype=jnp.float32)
    valid = jnp.ones(points.shape[0], dtype=bool)
    pargs = (
        jnp.asarray(pixels, dtype=jnp.float32),
        valid,
        jnp.asarray(intrinsics, dtype=jnp.float32),
        jnp.asarray(pose_base_to_camera, dtype=jnp.float32),
        jnp.asarray(pose_world_to_last, dtype=jnp.float32),
    )
    if _timed(options):
        def step(pose, o1):
            return solve_monocular_planar3dof_jax(points, *pargs, pose, o1)

        pose_d, mask, _, summary = _chunked_pose_only(
            step, pose_world_to_current, options
        )
        pose = np.asarray(pose_d)
        ok = bool(np.isfinite(pose).all())
        if not ok:
            pose = np.asarray(pose_world_to_current)
        return pose, mask, summary, ok
    res = solve_monocular_planar3dof_jax(
        points,
        *pargs,
        jnp.asarray(pose_world_to_current, dtype=jnp.float32),
        options,
    )
    summary = _result_summary(res, options)
    pose = np.asarray(res.pose)
    if not bool(res.success):
        pose = np.asarray(pose_world_to_current)
    return pose, np.asarray(res.mask_inlier), summary, bool(res.success)


def solve_stereo_planar3dof(
    points,
    pixels_left,
    pixels_right,
    intrinsics_left,
    intrinsics_right,
    pose_base_to_camera,
    pose_left_to_right,
    pose_world_to_last,
    pose_world_to_current,
    options: Options,
):
    """Host wrapper mirroring Solve_Stereo_Planar3Dof (h:59-67)."""
    points = jnp.asarray(points, dtype=jnp.float32)
    valid = jnp.ones(points.shape[0], dtype=bool)
    pargs = (
        jnp.asarray(pixels_left, dtype=jnp.float32),
        jnp.asarray(pixels_right, dtype=jnp.float32),
        valid,
        jnp.asarray(intrinsics_left, dtype=jnp.float32),
        jnp.asarray(intrinsics_right, dtype=jnp.float32),
        jnp.asarray(pose_base_to_camera, dtype=jnp.float32),
        jnp.asarray(pose_left_to_right, dtype=jnp.float32),
        jnp.asarray(pose_world_to_last, dtype=jnp.float32),
    )
    if _timed(options):
        def step(pose, o1):
            return solve_stereo_planar3dof_jax(points, *pargs, pose, o1)

        pose_d, mask_l, mask_r, summary = _chunked_pose_only(
            step, pose_world_to_current, options
        )
        pose = np.asarray(pose_d)
        ok = bool(np.isfinite(pose).all())
        if not ok:
            pose = np.asarray(pose_world_to_current)
        return pose, mask_l, mask_r, summary, ok
    res = solve_stereo_planar3dof_jax(
        points,
        *pargs,
        jnp.asarray(pose_world_to_current, dtype=jnp.float32),
        options,
    )
    summary = _result_summary(res, options)
    pose = np.asarray(res.pose)
    if not bool(res.success):
        pose = np.asarray(pose_world_to_current)
    return (
        pose,
        np.asarray(res.mask_inlier),
        np.asarray(res.mask_inlier_right),
        summary,
        bool(res.success),
    )
