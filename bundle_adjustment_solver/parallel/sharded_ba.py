"""Distributed full bundle adjustment: shard_map over a device mesh.

The scaling design (SURVEY.md §2/§5):
  - **landmarks and their observations are sharded** over the mesh's data
    axis: each device owns a contiguous range of landmarks (observations are
    already sorted by landmark at finalize time) and every observation lives
    on the device that owns its landmark, so the landmark blocks C, C^-1, b
    and the back-substituted point steps y are computed entirely locally --
    landmarks never communicate with each other;
  - **pose state is replicated**: the per-shard partial A, a and the Schur
    matvec partials are `psum`'d over ICI (6 N_opt floats per CG step --
    240 KB at N_opt = 10k), which is exactly the all-reduce pattern the
    survey prescribes;
  - the reduced camera solve is matrix-free block-PCG (ops/hessian.py); a
    dense 6N x 6N solve is meaningless to distribute at this N.

Everything below runs INSIDE `shard_map` (one program per device, explicit
collectives), with the whole LM loop on-device: zero host round-trips per
iteration, one compile for the full solve.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from ..models.camera import CameraRig
from ..models.problem import FinalizedProblem, ProblemShape
from ..ops import hessian as H
from ..ops.lie import compose, inverse_se3, se3_exp
from ..ops.projection import (
    full_ba_jacobians,
    residual_and_weight,
    warp_to_cameras,
)
from ..options import IterationStatus, Options, SolverType
from ..solvers.full_ba import _cg_tolerance
from ..summary import (
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
from .mesh import DATA_AXIS, data_mesh, to_global

_HIGHEST = jax.lax.Precision.HIGHEST


class ShardedProblem(NamedTuple):
    """Per-device problem slices; every array has a leading (num_shards,)
    axis that shard_map splits over the data axis of the mesh."""

    rig: CameraRig  # replicated
    R_cw: jax.Array  # (N, 3, 3) replicated pose state
    t_cw: jax.Array  # (N, 3)
    points: jax.Array  # (S, M_local, 3) sharded landmark positions
    point_opt_local: jax.Array  # (S, M_local) int32: local opt slot or M_opt_local
    point_global: jax.Array  # (S, M_local) int32: global point index (or M for pad)
    obs_cam: jax.Array  # (S, O_local)
    obs_pose: jax.Array  # (S, O_local)
    obs_point_local: jax.Array  # (S, O_local) index into this shard's points
    obs_pixel: jax.Array  # (S, O_local, 2)
    obs_pose_opt: jax.Array  # (S, O_local) in [0, N_opt]
    obs_point_opt_local: jax.Array  # (S, O_local) in [0, M_opt_local]
    obs_valid: jax.Array  # (S, O_local) bool
    opt_pose_idx: jax.Array  # (N_opt,) replicated
    opt_point_local: jax.Array  # (S, M_opt_local) int32 local point slot of each
    #                             local opt landmark (or M_local for padding)


@dataclasses.dataclass(frozen=True)
class ShardedShape:
    num_shards: int
    num_poses: int
    num_opt_poses: int
    obs_per_shard: int
    points_per_shard: int
    opt_points_per_shard: int
    num_observations: int  # true total (before padding)
    num_opt_points: int  # true total
    scale: float


def shard_problem(
    problem: FinalizedProblem, shape: ProblemShape, num_shards: int
) -> tuple[ShardedProblem, ShardedShape]:
    """Partition landmarks (and their observations) into `num_shards`
    contiguous, observation-balanced ranges, pad to uniform per-shard sizes.

    Host-side numpy; runs once at setup. Observations arrive sorted by
    (point_opt, pose_opt) from finalize(), with fixed-point observations
    (sentinel M_opt) last -- partition boundaries are chosen on point ids so
    an observation always lands on its landmark's shard.
    """
    obs_point = np.asarray(problem.obs_point)
    obs_order = np.argsort(obs_point, kind="stable")
    obs_point_sorted = obs_point[obs_order]

    M = shape.num_points
    O = shape.num_observations
    counts = np.bincount(obs_point_sorted, minlength=M)

    # Greedy contiguous partition of point ids balancing observation counts
    # (native when the C library is available).
    from ..utils.native import partition_landmarks

    boundaries = partition_landmarks(counts, O, num_shards)

    point_opt_of = np.full(M, -1, dtype=np.int32)
    point_opt_of[np.asarray(problem.opt_point_idx)] = np.arange(
        shape.num_opt_points, dtype=np.int32
    )

    obs_start = np.concatenate([[0], np.cumsum(counts)])
    m_local = max(
        boundaries[s + 1] - boundaries[s] for s in range(num_shards)
    )
    o_local = max(
        int(obs_start[boundaries[s + 1]] - obs_start[boundaries[s]])
        for s in range(num_shards)
    )
    # Round up for tiling friendliness.
    o_local = max(o_local, 1)
    m_local = max(m_local, 1)

    def pad_to(arr, n, fill):
        pad_width = [(0, n - arr.shape[0])] + [(0, 0)] * (arr.ndim - 1)
        return np.pad(arr, pad_width, constant_values=fill)

    np_points = np.asarray(problem.points)
    np_obs_cam = np.asarray(problem.obs_cam)[obs_order]
    np_obs_pose = np.asarray(problem.obs_pose)[obs_order]
    np_obs_pixel = np.asarray(problem.obs_pixel)[obs_order]
    np_obs_pose_opt = np.asarray(problem.obs_pose_opt)[obs_order]

    sh_points, sh_popt_local, sh_pglobal = [], [], []
    sh_ocam, sh_opose, sh_opoint_local, sh_opix = [], [], [], []
    sh_opose_opt, sh_opoint_opt_local, sh_ovalid = [], [], []
    sh_opt_point_local = []
    m_opt_local_max = 0

    per_shard = []
    for s in range(num_shards):
        lo, hi = boundaries[s], boundaries[s + 1]
        pids = np.arange(lo, hi, dtype=np.int32)
        olo, ohi = int(obs_start[lo]), int(obs_start[hi])
        opt_mask = point_opt_of[pids] >= 0 if pids.size else np.zeros(0, bool)
        local_opt_ids = np.nonzero(opt_mask)[0].astype(np.int32)
        per_shard.append((pids, olo, ohi, local_opt_ids))
        m_opt_local_max = max(m_opt_local_max, local_opt_ids.size)
    m_opt_local = max(m_opt_local_max, 1)

    for s in range(num_shards):
        pids, olo, ohi, local_opt_ids = per_shard[s]
        n_pts = pids.size
        n_obs = ohi - olo

        # local opt slot per local point (sentinel m_opt_local if fixed/pad)
        popt_local = np.full(n_pts, m_opt_local, dtype=np.int32)
        popt_local[local_opt_ids] = np.arange(local_opt_ids.size, dtype=np.int32)

        sh_points.append(pad_to(np_points[pids], m_local, 0.0))
        sh_popt_local.append(pad_to(popt_local, m_local, m_opt_local))
        sh_pglobal.append(pad_to(pids, m_local, M))

        obs_pt_local = (obs_point_sorted[olo:ohi] - pids[0]).astype(np.int32) \
            if n_pts else np.zeros(0, np.int32)
        sh_ocam.append(pad_to(np_obs_cam[olo:ohi], o_local, 0))
        sh_opose.append(pad_to(np_obs_pose[olo:ohi], o_local, 0))
        sh_opoint_local.append(pad_to(obs_pt_local, o_local, 0))
        sh_opix.append(pad_to(np_obs_pixel[olo:ohi], o_local, 0.0))
        sh_opose_opt.append(
            pad_to(np_obs_pose_opt[olo:ohi], o_local, shape.num_opt_poses)
        )
        sh_opoint_opt_local.append(
            pad_to(popt_local[obs_pt_local], o_local, m_opt_local)
        )
        valid = np.zeros(o_local, dtype=bool)
        valid[:n_obs] = True
        sh_ovalid.append(valid)
        sh_opt_point_local.append(pad_to(local_opt_ids, m_opt_local, m_local))

    dtype = problem.points.dtype
    sharded = ShardedProblem(
        rig=problem.rig,
        R_cw=problem.R_cw,
        t_cw=problem.t_cw,
        points=jnp.asarray(np.stack(sh_points), dtype=dtype),
        point_opt_local=jnp.asarray(np.stack(sh_popt_local)),
        point_global=jnp.asarray(np.stack(sh_pglobal)),
        obs_cam=jnp.asarray(np.stack(sh_ocam)),
        obs_pose=jnp.asarray(np.stack(sh_opose)),
        obs_point_local=jnp.asarray(np.stack(sh_opoint_local)),
        obs_pixel=jnp.asarray(np.stack(sh_opix), dtype=dtype),
        obs_pose_opt=jnp.asarray(np.stack(sh_opose_opt)),
        obs_point_opt_local=jnp.asarray(np.stack(sh_opoint_opt_local)),
        obs_valid=jnp.asarray(np.stack(sh_ovalid)),
        opt_pose_idx=problem.opt_pose_idx,
        opt_point_local=jnp.asarray(np.stack(sh_opt_point_local)),
    )
    sshape = ShardedShape(
        num_shards=num_shards,
        num_poses=shape.num_poses,
        num_opt_poses=shape.num_opt_poses,
        obs_per_shard=o_local,
        points_per_shard=m_local,
        opt_points_per_shard=m_opt_local,
        num_observations=shape.num_observations,
        num_opt_points=shape.num_opt_points,
        scale=shape.scale,
    )
    return sharded, sshape


class ShardedBAState(NamedTuple):
    poses_world_to_camera: jax.Array  # (N, 4, 4) unscaled
    points: jax.Array  # (S, M_local, 3) unscaled, sharded layout
    point_global: jax.Array  # (S, M_local) mapping back to user point ids
    converged: jax.Array
    num_iterations: jax.Array
    info: jax.Array
    num_info: jax.Array
    final_cost: jax.Array
    final_rmse_px: jax.Array


def _psum(x):
    return jax.lax.psum(x, DATA_AXIS)


def problem_in_specs() -> "ShardedProblem":
    """PartitionSpecs for every ShardedProblem field (landmark/observation
    leaves split over the data axis, pose state + rig replicated). Public so
    multi-host launchers can `mesh.to_global` the problem before jit."""
    sh, rp = P(DATA_AXIS), P()
    return ShardedProblem(
        rig=rp,
        R_cw=rp,
        t_cw=rp,
        points=sh,
        point_opt_local=sh,
        point_global=sh,
        obs_cam=sh,
        obs_pose=sh,
        obs_point_local=sh,
        obs_pixel=sh,
        obs_pose_opt=sh,
        obs_point_opt_local=sh,
        obs_valid=sh,
        opt_pose_idx=rp,
        opt_point_local=sh,
    )


@functools.partial(
    jax.jit, static_argnames=("sshape", "options")
)
def _solve_sharded_jax(
    sharded: ShardedProblem, sshape: ShardedShape, options: Options
):
    """jit wrapper: shard_map the per-device LM-CG program over the mesh."""
    mesh = data_mesh(sshape.num_shards)
    pspec_sharded = P(DATA_AXIS)
    pspec_repl = P()

    in_specs = problem_in_specs()
    out_specs = ShardedBAState(
        poses_world_to_camera=pspec_repl,
        points=pspec_sharded,
        point_global=pspec_sharded,
        converged=pspec_repl,
        num_iterations=pspec_repl,
        info=pspec_repl,
        num_info=pspec_repl,
        final_cost=pspec_repl,
        final_rmse_px=pspec_repl,
    )

    program = functools.partial(_device_program, sshape=sshape, options=options)
    return jax.shard_map(
        program, mesh=mesh, in_specs=(in_specs,), out_specs=out_specs
    )(sharded)


def _device_program(
    local: ShardedProblem, *, sshape: ShardedShape, options: Options
) -> ShardedBAState:
    """The per-device LM loop. `local` arrives with the leading shard axis
    reduced to 1; squeeze it. Pose state and the reduced system are
    replicated via psum; landmark state stays local."""
    sq = lambda a: a[0]
    points0 = sq(local.points)
    point_opt_local = sq(local.point_opt_local)
    obs_cam = sq(local.obs_cam)
    obs_pose = sq(local.obs_pose)
    obs_point_local = sq(local.obs_point_local)
    obs_pixel = sq(local.obs_pixel)
    obs_pose_opt = sq(local.obs_pose_opt)
    obs_point_opt = sq(local.obs_point_opt_local)
    obs_valid = sq(local.obs_valid)
    opt_point_local = sq(local.opt_point_local)
    rig = local.rig

    opts = options
    n_opt = sshape.num_opt_poses
    m_opt_l = sshape.opt_points_per_shard
    m_local = sshape.points_per_shard
    max_iter = opts.iteration_handle.max_num_iterations
    huber = opts.outlier_handle.threshold_huber_loss * sshape.scale
    thr_step = opts.convergence_handle.threshold_step_size
    thr_cost = opts.convergence_handle.threshold_cost_change
    tr = opts.trust_region_handle
    inv_scale = 1.0 / sshape.scale
    dtype = points0.dtype
    n_obs_total = sshape.num_observations
    n_params = n_opt + sshape.num_opt_points
    is_lm = opts.solver_type == SolverType.LEVENBERG_MARQUARDT

    def residual_pass(R_cw, t_cw, X_local):
        fx, fy, cx, cy, R_cam, t_cam = rig.gather(obs_cam)
        R_jw = R_cw[obs_pose]
        t_jw = t_cw[obs_pose]
        Xo = X_local[obs_point_local]
        X_ref, X_cam = warp_to_cameras(R_jw, t_jw, Xo, R_cam, t_cam)
        r, w, _ = residual_and_weight(X_cam, obs_pixel, fx, fy, cx, cy, huber)
        w = w * obs_valid.astype(dtype)
        return X_ref, X_cam, r, w, (fx, fy, R_jw, R_cam)

    def eval_cost(R_cw, t_cw, X_local):
        _, _, r, w, _ = residual_pass(R_cw, t_cw, X_local)
        validf = obs_valid.astype(dtype)
        if opts.cost_metric == "squared":
            local_cost = jnp.sum(w * (r[:, 0] ** 2 + r[:, 1] ** 2))
        else:
            local_cost = jnp.sum(validf * jnp.linalg.norm(r, axis=-1))
        return _psum(local_cost)

    def body(c):
        (R_cw, t_cw, X_local, lam, prev_cost, it, done, converged, info,
         num_info, x_prev, rhs_norm_prev, eta_prev) = c
        X_ref, X_cam, r, w, (fx, fy, R_jw, R_cam) = residual_pass(
            R_cw, t_cw, X_local
        )
        Q, Rj = full_ba_jacobians(R_jw, X_ref, X_cam, fx, fy, R_cam)
        lam_eff = lam if is_lm else jnp.asarray(1e-5, dtype)

        wQ = Q * w[:, None, None]
        wr = r * w[:, None]
        # Pose blocks: local partials + psum (replicated afterwards).
        grad_pose = -jnp.einsum("ora,or->oa", Q, wr, precision=_HIGHEST)
        a = _psum(
            jax.ops.segment_sum(grad_pose, obs_pose_opt, num_segments=n_opt + 1)[
                :n_opt
            ]
        )
        AtA = jnp.einsum("ora,orb->oab", wQ, Q, precision=_HIGHEST)
        A = _psum(
            jax.ops.segment_sum(AtA, obs_pose_opt, num_segments=n_opt + 1)[
                :n_opt
            ]
        )
        # Landmark blocks: fully local.
        wRj = Rj * w[:, None, None]
        grad_point = -jnp.einsum("ora,or->oa", Rj, wr, precision=_HIGHEST)
        b = jax.ops.segment_sum(
            grad_point, obs_point_opt, num_segments=m_opt_l + 1
        )[:m_opt_l]
        RtR = jnp.einsum("ora,orb->oab", wRj, Rj, precision=_HIGHEST)
        C = jax.ops.segment_sum(RtR, obs_point_opt, num_segments=m_opt_l + 1, indices_are_sorted=True)[
            :m_opt_l
        ]
        U = jnp.einsum("ora,orb->oab", wQ, Rj, precision=_HIGHEST)

        damp = 1.0 + lam_eff
        A_d = A * (1.0 + (damp - 1.0) * jnp.eye(6, dtype=dtype))
        C_d = C * (1.0 + (damp - 1.0) * jnp.eye(3, dtype=dtype))
        Cinv = H.inverse_3x3(C_d)

        def matvec(x):
            xg = H._gather_padded(x, obs_pose_opt, n_opt)
            u = jnp.einsum("oab,oa->ob", U, xg, precision=_HIGHEST)
            t_seg = jax.ops.segment_sum(
                u, obs_point_opt, num_segments=m_opt_l + 1,
                indices_are_sorted=True,
            )[:m_opt_l]
            v = jnp.einsum("iab,ib->ia", Cinv, t_seg, precision=_HIGHEST)
            vg = H._gather_padded(v, obs_point_opt, m_opt_l)
            wv = jnp.einsum("oab,ob->oa", U, vg, precision=_HIGHEST)
            corr = _psum(
                jax.ops.segment_sum(
                    wv, obs_pose_opt, num_segments=n_opt + 1
                )[:n_opt]
            )
            Ax = jnp.einsum("jab,jb->ja", A_d, x, precision=_HIGHEST)
            return Ax - corr

        Cinv_b = jnp.einsum("iab,ib->ia", Cinv, b, precision=_HIGHEST)
        cb = H._gather_padded(Cinv_b, obs_point_opt, m_opt_l)
        contrib = jnp.einsum("oab,ob->oa", U, cb, precision=_HIGHEST)
        rhs = a - _psum(
            jax.ops.segment_sum(contrib, obs_pose_opt, num_segments=n_opt + 1)[
                :n_opt
            ]
        )

        if getattr(opts, "cg_precond", "jacobi") == "schur_jacobi":
            # Schur-Jacobi: per-shard observation-pass correction
            # sum_o U_o Cinv U_o^T, psum'd into the replicated pose blocks
            # (see ops/hessian.schur_diag_correction for the SPD argument).
            corr_diag = _psum(
                H.schur_diag_correction_arrays(
                    U, Cinv, obs_pose_opt, obs_point_opt, n_opt, m_opt_l
                )
            )
            precond = H.inverse_6x6(A_d - corr_diag)
        else:
            precond = H.inverse_6x6(A_d)
        tol, eta, rhs_norm = _cg_tolerance(opts, rhs, rhs_norm_prev, eta_prev)
        x, _, cg_it = H.block_pcg(
            matvec, rhs, precond, opts.cg_max_iterations, tol,
            x0=x_prev if getattr(opts, "cg_warm_start", False) else None,
        )

        # Back-substitution: local landmarks only.
        xg = H._gather_padded(x, obs_pose_opt, n_opt)
        u = jnp.einsum("oab,oa->ob", U, xg, precision=_HIGHEST)
        Bt_x = jax.ops.segment_sum(
            u, obs_point_opt, num_segments=m_opt_l + 1,
            indices_are_sorted=True,
        )[:m_opt_l]
        y = jnp.einsum("iab,ib->ia", Cinv, b - Bt_x, precision=_HIGHEST)

        # Candidate update.
        dR, dt = se3_exp(x)
        R_opt = R_cw[local.opt_pose_idx]
        t_opt = t_cw[local.opt_pose_idx]
        R_new, t_new = compose(dR, dt, R_opt, t_opt)
        R_cand = R_cw.at[local.opt_pose_idx].set(R_new)
        t_cand = t_cw.at[local.opt_pose_idx].set(t_new)
        # Scatter y into local point slots: opt slot k lives at point slot
        # opt_point_local[k] (sentinel m_local rows land in the pad slot).
        X_pad = jnp.concatenate([X_local, jnp.zeros((1, 3), dtype)], axis=0)
        X_pad = X_pad.at[opt_point_local].add(y)
        X_cand = X_pad[:m_local]

        current_cost = eval_cost(R_cand, t_cand, X_cand)
        # NaN/inf guard (see solvers/full_ba.py).
        cost_ok = jnp.isfinite(current_cost)

        if is_lm:
            # Quadratic model decrease (damped blocks): pose terms replicated,
            # landmark + cross terms psum'd.
            term_pose = jnp.sum(a * x) + jnp.einsum(
                "ja,jab,jb->", x, A_d, x, precision=_HIGHEST
            )
            term_point = _psum(
                jnp.sum(b * y)
                + jnp.einsum("ia,iab,ib->", y, C_d, y, precision=_HIGHEST)
                + 2.0 * jnp.sum(y * Bt_x)
            )
            model_decrease = -(term_pose + term_point)
            rho = (current_cost - prev_cost) * inv_scale / model_decrease
            accept = jnp.logical_and(rho > tr.threshold_update, cost_ok)
            trust_more = jnp.logical_and(rho > tr.threshold_trust_more, cost_ok)
            lam_new = jnp.where(
                trust_more,
                jnp.maximum(tr.min_lambda, lam * tr.decrease_ratio_lambda),
                jnp.where(
                    rho <= tr.threshold_update,
                    jnp.minimum(tr.max_lambda, lam * tr.increase_ratio_lambda),
                    lam,
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
            lam_new = lam
            status = jnp.asarray(float(int(IterationStatus.UPDATE)), dtype)

        R_next = jnp.where(accept, R_cand, R_cw)
        t_next = jnp.where(accept, t_cand, t_cw)
        X_next = jnp.where(accept, X_cand, X_local)

        cost_change = jnp.abs(current_cost - prev_cost)
        step_pose = jnp.sum(jnp.linalg.norm(x, axis=-1))
        step_point = _psum(jnp.sum(jnp.linalg.norm(y, axis=-1)))
        avg_step = (step_pose + step_point) / n_params
        conv_now = jnp.logical_or(avg_step < thr_step, cost_change < thr_cost)
        at_last = it >= max_iter - 1
        converged = jnp.where(at_last, False, conv_now)

        skipped = jnp.logical_not(accept)
        row = jnp.zeros((INFO_NUM_COLS,), dtype=dtype)
        row = row.at[INFO_COST].set(jnp.where(skipped, prev_cost, current_cost))
        row = row.at[INFO_COST_CHANGE].set(jnp.where(skipped, 0.0, cost_change))
        row = row.at[INFO_AVG_REPROJ].set(
            jnp.where(
                skipped,
                jnp.sqrt(prev_cost / n_obs_total),
                current_cost / n_obs_total,
            )
        )
        row = row.at[INFO_ABS_STEP].set(avg_step)
        row = row.at[INFO_DAMPING].set(lam_new)
        row = row.at[INFO_STATUS].set(status)
        row = row.at[INFO_CG_ITERS].set(cg_it.astype(dtype))

        return (
            R_next,
            t_next,
            X_next,
            lam_new,
            jnp.where(cost_ok, current_cost, prev_cost),
            it + 1,
            jnp.logical_or(conv_now, at_last),
            converged,
            info.at[it].set(row),
            num_info + 1,
            x,
            rhs_norm,
            eta,
        )

    def cond(c):
        return jnp.logical_and(c[5] < max_iter, jnp.logical_not(c[6]))

    R_cw0, t_cw0 = local.R_cw, local.t_cw
    carry0 = (
        R_cw0,
        t_cw0,
        points0,
        jnp.asarray(tr.initial_lambda, dtype),
        eval_cost(R_cw0, t_cw0, points0),
        jnp.asarray(0, jnp.int32),
        jnp.asarray(False),
        jnp.asarray(False),
        jnp.zeros((max_iter, INFO_NUM_COLS), dtype=dtype),
        jnp.asarray(0, jnp.int32),
        jnp.zeros((n_opt, 6), dtype),
        jnp.asarray(0.0, dtype),
        jnp.asarray(0.0, dtype),
    )
    (R_cw, t_cw, X_local, lam, final_cost, it, _, converged, info,
     num_info, _, _, _) = jax.lax.while_loop(cond, body, carry0)

    t_user = t_cw * inv_scale
    R_wc, t_wc = inverse_se3(R_cw, t_user)
    N = R_wc.shape[0]
    T = jnp.zeros((N, 4, 4), dtype=dtype)
    T = T.at[:, :3, :3].set(R_wc)
    T = T.at[:, :3, 3].set(t_wc)
    T = T.at[:, 3, 3].set(1.0)

    _, _, r, _, _ = residual_pass(R_cw, t_cw, X_local)
    validf = obs_valid.astype(dtype)
    sq_sum = _psum(jnp.sum(validf * jnp.sum(r * r, axis=-1)))
    rmse_px = jnp.sqrt(sq_sum / n_obs_total) * inv_scale

    return ShardedBAState(
        poses_world_to_camera=T,
        points=(X_local * inv_scale)[None],
        point_global=local.point_global,
        converged=converged,
        num_iterations=it,
        info=info,
        num_info=num_info,
        final_cost=final_cost,
        final_rmse_px=rmse_px,
    )


def solve_sharded(
    problem: FinalizedProblem,
    shape: ProblemShape,
    options: Options,
    num_shards: int | None = None,
) -> tuple[ShardedBAState, Summary, np.ndarray]:
    """Host entry: shard, solve on the mesh, and return
    (device state, summary, gathered points in user order (M, 3))."""
    if num_shards is None:
        num_shards = len(jax.devices())
    if getattr(options, "time_iterations", False):
        # Loud refusal (reference iter_time parity at
        # full cpp:981-992): this engine runs one shard_map dispatch with
        # no per-iteration device marker to segment a profiler trace on;
        # the PM engines support time_iterations (solve_pm: chunked and
        # 'device'; solve_sharded_pm: 'device').
        raise ValueError(
            "time_iterations is not supported on the sharded observation-"
            "table engine; use parallel.sharded_pm.solve_sharded_pm "
            "(time_iterations='device') or solvers.full_ba.solve"
        )
    sharded, sshape = shard_problem(problem, shape, num_shards)
    # Place on the mesh: a device-resident problem is committed to one
    # device, which the mesh program would otherwise refuse.
    sharded = to_global(sharded, problem_in_specs(), data_mesh(num_shards))
    t0 = time.perf_counter()
    state = jax.block_until_ready(
        _solve_sharded_jax(sharded, sshape, options)
    )
    total_ms = (time.perf_counter() - t0) * 1e3

    # Gather sharded points back to user order.
    pts = np.asarray(state.points).reshape(-1, 3)
    gidx = np.asarray(state.point_global).reshape(-1)
    out_points = np.zeros((shape.num_points, 3), dtype=pts.dtype)
    keep = gidx < shape.num_points
    out_points[gidx[keep]] = pts[keep]

    summary = Summary.from_device_buffers(
        info=np.asarray(state.info),
        num_iterations=int(state.num_info),
        converged=bool(state.converged),
        max_iteration=options.iteration_handle.max_num_iterations,
        threshold_step_size=options.convergence_handle.threshold_step_size,
        threshold_cost_change=options.convergence_handle.threshold_cost_change,
        total_time_ms=total_ms,
        final_rmse_px=float(state.final_rmse_px),
    )
    return state, summary, out_points
