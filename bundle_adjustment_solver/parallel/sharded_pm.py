"""Distributed point-major full BA: the point-major engine over a device mesh.

Landmarks + observations are sharded over the mesh's data axis (the same
decomposition as parallel/sharded_ba.py, SURVEY.md §2/§5), running the
point-major layout and the operators of ops/point_major.py on each shard:

  - the point-major planes (models/layout.py) are sharded along the landmark
    axis at block granularity -- no repacking: `shard_map` in_specs simply
    split the last axis, and each device runs the operators over its own
    landmarks;
  - landmark state (C, Cinv, b, U, back-substituted y, point updates) never
    leaves its shard;
  - the POSE side is sharded too (default; the distributed answer to the
    serial reduced solve at core/full_bundle_adjustment_solver.cpp:890-908):
    the assembly partials arrive by reduce-scatter, and each device owns
    Nl = ceil(N_opt / D) pose rows through the finish, the preconditioner
    inversions, the entire CG vector algebra, and the SE(3) retraction.
    `pose_sharded=False` replicates that pose-side work on every device
    instead (kept for A/B).

Communication per LM iteration (pose_sharded, N_opt = 10k): one (Ns, 33|54)
partials reduce-scatter (~1.3 MB payload, half an all-reduce's ring bytes),
one (Ns, 6) all-gather + one (Ns, 6) reduce-scatter + two scalar psums per
CG iteration (~480 KB payload), and one (Ns, 12) all-gather of updated pose
rows (~480 KB). See `comm_volume_model` for the exact accounting in both
modes.
"""

from __future__ import annotations

import dataclasses
import functools
import time

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from ..models.layout import PMShape, PointMajorProblem
from ..models.problem import FinalizedProblem, ProblemShape
from ..ops.lie import compose_flat, inverse_se3, se3_exp
from ..ops.sym6 import inverse_tri6, plane_sym6_matvec, tri6_matvec
from ..ops import point_major as K
from ..options import IterationStatus, Options, SolverType
from ..solvers.full_ba import (
    FullBAState,
    _GN_LAMBDA,
    _cg_tolerance,
    _cg_tolerance_from_norm,
)
from ..solvers.full_ba_pm import (
    _apply_cinv,
    _c_times,
    pm_from_finalized,
    retract_opt_rows,
    scatter_opt_rows,
)
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
from .mesh import DATA_AXIS, data_mesh

_HI = jax.lax.Precision.HIGHEST


def _psum(x):
    return jax.lax.psum(x, DATA_AXIS)


def _pose_shard_rows(n_opt: int, num_shards: int) -> int:
    """Per-device opt-pose rows, rounded up to a multiple of 128 so every
    shard holds the same number of rows for the reduce-scatter/all-gather."""
    return -(-n_opt // (num_shards * 128)) * 128


def _pose_sharded_pcg(n_opt, Nl, padded_points, Atri_l, rhs_l, precond_l,
                      max_iter, tol, rhs_sq, corr_fn, to_full, to_local,
                      x0=None):
    """Distributed PCG on the reduced camera system with the POSE side
    sharded: each device owns Nl = ceil(n_opt / D) pose rows.

    Per CG iteration: one all-gather of the search direction (the landmark
    matvec gathers arbitrary pose rows, so it needs the full vector), one
    reduce-scatter of the landmark-side correction, and two scalar psums
    (alpha's p.Sp and [r.z, r.r] -- CG's two synchronization points). The
    local pose algebra runs on (components, Nl) planes.

    `corr_fn(x_full (n_opt, 6)) -> (corr partial (n_opt, 6), t (3, Mp))`;
    `to_full`/`to_local` are the all-gather / reduce-scatter row maps.
    Returns (x_local (Nl, 6), t = B^T x (3, Mp) shard-local, iters).
    """
    A21 = Atri_l.T  # (21, Nl) tri planes, columns = local poses
    M21 = precond_l.T
    rhs_pl = rhs_l.T
    f32 = jnp.float32

    def corr_local_planes(v_pl):
        corr, t = corr_fn(to_full(v_pl.T))
        return to_local(corr).T, t

    if x0 is None:
        x_init = jnp.zeros((6, Nl), f32)
        r0 = rhs_pl
        t_init = jnp.zeros((3, padded_points), f32)
    else:
        x_init = x0.T
        corr0, t_init = corr_local_planes(x_init)
        r0 = rhs_pl - (plane_sym6_matvec(A21, x_init) - corr0)
    z0 = plane_sym6_matvec(M21, r0)
    scal0 = _psum(jnp.stack([jnp.sum(r0 * z0), jnp.sum(r0 * r0)]))

    def cond(s):
        return jnp.logical_and(s[8] < max_iter, s[6] > tol * rhs_sq)

    def body(s):
        x, r, z, p_prev, beta, rz, _, t_acc, it = s
        # p' = z + beta p fuses into the all-gather operand build.
        p = z + beta * p_prev
        corr_pl, tp = corr_local_planes(p)
        Sp = plane_sym6_matvec(A21, p) - corr_pl
        alpha = rz / jnp.maximum(_psum(jnp.sum(p * Sp)), 1e-30)
        x = x + alpha * p
        r = r - alpha * Sp
        z = plane_sym6_matvec(M21, r)
        rz_l, rr_l = jnp.sum(r * z), jnp.sum(r * r)
        sums = _psum(jnp.stack([rz_l, rr_l]))
        beta = sums[0] / jnp.maximum(rz, 1e-30)
        t_acc = t_acc + alpha * tp
        return (x, r, z, p, beta, sums[0], sums[1], t_acc, it + 1)

    state0 = (
        x_init, r0, z0, jnp.zeros((6, Nl), f32), jnp.asarray(0.0, f32),
        scal0[0], scal0[1], t_init, jnp.asarray(0, jnp.int32),
    )
    x, _, _, _, _, _, _, t_acc, it = jax.lax.while_loop(cond, body, state0)
    return x.T, t_acc, it


def _local_shape(pshape: PMShape, num_shards: int) -> PMShape:
    assert pshape.num_blocks % num_shards == 0, (
        "num_blocks must divide evenly over shards "
        "(build the layout with pad_blocks_to=num_shards, as the sharded "
        "builders do)"
    )
    return dataclasses.replace(
        pshape, padded_points=pshape.padded_points // num_shards
    )


def pm_in_specs() -> PointMajorProblem:
    """PartitionSpecs for the point-major planes (landmark lane axis split
    over the data axis at block granularity). Public so multi-host launchers
    can `mesh.to_global` the planes before jit."""
    return PointMajorProblem(
        obs_f32=P(None, DATA_AXIS),
        slot_pose=P(None, DATA_AXIS),
        slot_opt=P(None, DATA_AXIS),
        X=P(None, DATA_AXIS),
        point_ref=P(DATA_AXIS),
        gbase=P(DATA_AXIS),
        sbase=P(DATA_AXIS),
    )


def place_pm_sharded(pm: PointMajorProblem, num_shards: int, cache=None,
                     mesh=None):
    """device_put the point-major planes -- and optionally a
    `PMLayoutCache` -- with the landmark-sharded NamedShardings the
    shard_map engine consumes.

    After placement every later `cache.refill` runs as device-local
    gathers per shard (the cache's (Kp*C, Mp) cell index shards along the
    same lane axis as the planes), so a multi-chip deployment re-solving
    the same observation graph ships only the raw value columns and never
    funnels plane traffic through one device. Single-process meshes only;
    multi-process launchers route through `mesh.to_global` with
    `pm_in_specs()` instead.

    Returns the placed `pm` (and `(pm, cache)` when a cache is given)."""
    from jax.sharding import NamedSharding

    if mesh is None:
        mesh = data_mesh(num_shards)
    specs = pm_in_specs()
    pm = type(pm)(*(
        jax.device_put(getattr(pm, f), NamedSharding(mesh, getattr(specs, f)))
        for f in pm._fields
    ))
    if cache is None:
        return pm
    cache = dataclasses.replace(
        cache,
        gsrc=jax.device_put(
            cache.gsrc, NamedSharding(mesh, P(None, DATA_AXIS))
        ),
    )
    return pm, cache


def sharded_pm_problem_from_arrays(
    cameras,
    poses_world_to_camera,
    points,
    obs_cam,
    obs_pose,
    obs_point,
    obs_pixel,
    fixed_pose_mask=None,
    fixed_point_mask=None,
    scale: float = 0.01,
    num_shards: int | None = None,
    layout: str = "device",
    return_cache: bool = False,
    mesh=None,
    **build_kw,
):
    """Direct arrays -> mesh-placed point-major problem for
    `solve_sharded_pm(..., pm_and_shape=...)`.

    The distributed serving entry: wraps
    `solvers.full_ba_pm.pm_problem_from_arrays` with the layout padded to
    `num_shards` block groups (`pad_blocks_to`), builds the planes ON
    DEVICE by default (`layout='device'`: XLA 2-key sort + flat scalar
    scatters, vs the reference's per-Solve
    host finalize at core/full_bundle_adjustment_solver.cpp:631-663), and
    `device_put`s them with the landmark-sharded NamedShardings of
    `pm_in_specs()`.

    `return_cache=True` appends a mesh-placed `PMLayoutCache`: repeated
    solves over the same observation topology (the SLAM per-frame
    pattern) then refill only the value planes with per-shard local
    gathers -- `cache.refill(pm, obs_pixel * scale, points * scale)` --
    and re-enter `solve_sharded_pm` without any rebuild.

    Returns (problem, shape, pm, pshape[, cache]) or None when the
    problem exceeds the layout's static bounds."""
    from ..solvers.full_ba_pm import pm_problem_from_arrays

    if num_shards is None:
        num_shards = len(jax.devices())
    res = pm_problem_from_arrays(
        cameras, poses_world_to_camera, points, obs_cam, obs_pose,
        obs_point, obs_pixel, fixed_pose_mask=fixed_pose_mask,
        fixed_point_mask=fixed_point_mask, scale=scale,
        pad_blocks_to=num_shards, layout=layout,
        return_cache=return_cache, **build_kw,
    )
    if res is None:
        return None
    if return_cache:
        problem, shape, pm, pshape, cache = res
        pm, cache = place_pm_sharded(pm, num_shards, cache=cache, mesh=mesh)
        return problem, shape, pm, pshape, cache
    problem, shape, pm, pshape = res
    pm = place_pm_sharded(pm, num_shards, mesh=mesh)
    return problem, shape, pm, pshape


def comm_volume_model(
    num_opt_poses: int, cg_iterations: int, dtype_bytes: int = 4,
    emit_schur: bool = False, pose_sharded: bool = True,
    num_shards: int = 2,
) -> dict:
    """Per-LM-iteration collective volume of the sharded PM engine, as
    machine-readable bytes (the prose model in the module docstring).

    pose_sharded=True (default engine): counted from the collective call
    sites in `_device_program` / `_pose_sharded_pcg`:
      - assembly partials reduce-scatter ((Ns, 33|54), HALF an
        all-reduce's ring bytes);
      - per CG iteration: one (Ns, 6) all-gather of the search direction
        + one (Ns, 6) reduce-scatter of the landmark correction (together
        = one all-reduce's bytes) + two scalar psums;
      - one (Ns, 12) all-gather of the updated pose rows per LM iteration;
      - scalar psums (rhs norm, candidate cost, model decrease, step).

    pose_sharded=False (replicated pose side): one (N_opt, cols) psum, one
    (N_opt, 6) psum per CG iteration, three scalar psums.

    Ring-transit bytes per collective of payload S: all-reduce moves
    2*S*(D-1)/D through each link; reduce-scatter and all-gather move
    S*(D-1)/D each. The returned `*_bytes` fields are PAYLOAD sizes; the
    `ring_transit_bytes_per_lm_iter` field applies the (D-1)/D factors.
    """
    cols = K.A_COLS_SCHUR if emit_schur else K.A_COLS
    D = max(1, int(num_shards))
    frac = (D - 1) / D
    if not pose_sharded:
        assembly = num_opt_poses * cols * dtype_bytes
        per_cg = num_opt_poses * 6 * dtype_bytes
        scalars = 3 * dtype_bytes
        return {
            "pose_sharded": False,
            "num_opt_poses": num_opt_poses,
            "cg_iterations_per_lm": cg_iterations,
            "assembly_panel_bytes": assembly,
            "cg_matvec_bytes_per_cg_iter": per_cg,
            "scalar_bytes_per_lm_iter": scalars,
            "total_bytes_per_lm_iter": (
                assembly + cg_iterations * per_cg + scalars
            ),
            "ring_transit_bytes_per_lm_iter": 2.0 * frac * (
                assembly + cg_iterations * per_cg + scalars
            ),
            "collectives_per_lm_iter": 4 + cg_iterations,
        }
    Nl = _pose_shard_rows(num_opt_poses, D)
    Ns = Nl * D
    assembly = Ns * cols * dtype_bytes  # reduce-scatter
    per_cg_gather = Ns * 6 * dtype_bytes  # all-gather of p
    per_cg_scatter = Ns * 6 * dtype_bytes  # reduce-scatter of corr
    pose_rows = Ns * 12 * dtype_bytes  # all-gather of updated (R | t)
    scalars = 7 * dtype_bytes  # rhs/cost/model/step + 2-vec dots per CG
    payload = (
        assembly + pose_rows
        + cg_iterations * (per_cg_gather + per_cg_scatter)
        + scalars
    )
    return {
        "pose_sharded": True,
        "num_opt_poses": num_opt_poses,
        "num_shards": D,
        "local_pose_rows": Nl,
        "cg_iterations_per_lm": cg_iterations,
        "assembly_panel_bytes": assembly,
        "cg_bytes_per_cg_iter": per_cg_gather + per_cg_scatter,
        "pose_row_gather_bytes": pose_rows,
        "scalar_bytes_per_lm_iter": scalars,
        "total_bytes_per_lm_iter": payload,
        # reduce-scatter / all-gather each transit S*(D-1)/D; the scalar
        # psums are latency-, not bandwidth-, bound.
        "ring_transit_bytes_per_lm_iter": frac * payload,
        "collectives_per_lm_iter": 6 + 4 * cg_iterations,
    }


@functools.partial(
    jax.jit,
    static_argnames=("pshape", "options", "num_shards", "pose_sharded"),
)
def _solve_sharded_pm_jax(
    pm: PointMajorProblem,
    pshape: PMShape,
    rig,
    R_cw0,
    t_cw0,
    opt_pose_idx,
    options: Options,
    num_shards: int,
    pose_sharded: bool = True,
):
    mesh = data_mesh(num_shards)
    lshape = _local_shape(pshape, num_shards)

    pm_specs = pm_in_specs()
    out_specs = (
        P(),  # R_cw
        P(),  # t_cw
        P(None, DATA_AXIS),  # X (4, Mp)
        P(),  # converged
        P(),  # iters
        P(),  # info
        P(),  # num_info
        P(),  # final cost
        P(),  # final rmse
    )
    program = functools.partial(
        _device_program,
        lshape=lshape,
        options=options,
        num_shards=num_shards,
        pose_sharded=pose_sharded,
    )
    return jax.shard_map(
        program,
        mesh=mesh,
        in_specs=(pm_specs, P(), P(), P(), P()),
        out_specs=out_specs,
        # The LM/CG loop carries start replicated and become shard-varying
        # in the body; every collective here is explicit.
        check_vma=False,
    )(pm, rig, R_cw0, t_cw0, opt_pose_idx)


def _device_program(pm_local, rig, R_cw0, t_cw0, opt_pose_idx, *, lshape,
                    options, num_shards, pose_sharded):
    """Per-device LM loop on the local point-major shard.

    `pose_sharded=True` (default) additionally partitions the POSE side of
    every iteration over the same mesh axis -- the assembly panel arrives
    by reduce-scatter instead of psum, and the second-level finish, the
    block-Jacobi/Schur-Jacobi inversions, all CG vector algebra, and the
    SE(3) retraction run on each device's own Nl = ceil(n_opt / D) pose
    rows, with one all-gather per CG iteration (search direction) and one
    per LM iteration (updated pose rows). False replicates the pose side
    on every device (kept for A/B and as the semantics reference)."""
    opts = options
    shape = lshape
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
    n_params = shape.num_opt_poses + _psum(jnp.sum(pm_local.X[3]))

    n_opt = shape.num_opt_poses
    Nl = _pose_shard_rows(n_opt, num_shards)  # local opt-pose rows
    Ns = Nl * num_shards
    shard = jax.lax.axis_index(DATA_AXIS)

    def to_full(v_local):
        """(Nl, k) local rows -> (n_opt, k) via tiled all-gather."""
        return jax.lax.all_gather(
            v_local, DATA_AXIS, axis=0, tiled=True
        )[:n_opt]

    def to_local(v_partial):
        """(n_opt, k) per-shard partial -> summed (Nl, k) local rows via
        tiled reduce-scatter (each device keeps rows
        [shard*Nl, (shard+1)*Nl); rows past n_opt are zero padding)."""
        pad = jnp.zeros((Ns - n_opt, v_partial.shape[1]), v_partial.dtype)
        return jax.lax.psum_scatter(
            jnp.concatenate([v_partial, pad]), DATA_AXIS,
            scatter_dimension=0, tiled=True,
        )

    def eval_cost(tbl, X):
        s_norm, s_wsq, _, _ = K.cost_pm_tbl(pm_local, shape, tbl, X, rig, huber)
        return _psum(s_wsq if metric == "squared" else s_norm)

    use_schur = getattr(opts, "cg_precond", "jacobi") == "schur_jacobi"
    warm = getattr(opts, "cg_warm_start", False)

    def pcg(Cb, U, Atri, rhs, precond_tri, tol, x_start):
        """Replicated-pose PCG (solvers/full_ba_pm.reduced_pcg) with the
        shard-local correction psum'd across the data axis (t stays
        local)."""
        from ..solvers.full_ba_pm import reduced_pcg

        def corr_fn(x):
            corr, t = K.matvec_corr_pm(pm_local, shape, Cb, U, x)
            return _psum(corr), t

        return reduced_pcg(
            shape.padded_points, Atri, rhs, precond_tri,
            opts.cg_max_iterations, tol, corr_fn, x0=x_start,
        )

    def body(c):
        (tbl, X, lam, prev_cost, it, done, converged, info,
         num_info, x_prev, rhs_norm_prev, eta_prev) = c
        lam_eff = lam if is_lm else jnp.asarray(_GN_LAMBDA, dtype)
        flat, Cb, U = K.assemble_pm_tbl(
            pm_local, shape, tbl, X, rig, lam_eff, huber,
            u_dtype=getattr(opts, "coupling_dtype", "float32"),
            emit_schur=use_schur,
        )
        # Pose-sharded: reduce-scatter the partials so each device finishes
        # and preconditions only its own Nl pose rows (half the bytes of
        # the replicating psum, 1/D the downstream pose algebra).
        flat_g = to_local(flat) if pose_sharded else _psum(flat)
        Atri, a, rhs = K.finish_pose_system_tri(flat_g, lam_eff)

        if is_gd:
            def clip_blocks(g, clip):
                norms = jnp.linalg.norm(g, axis=0, keepdims=True)
                return g * jnp.minimum(1.0, clip / jnp.maximum(norms, 1e-30))

            x = clip_blocks(a.T, opts.gd_step_clip).T
            y = clip_blocks(Cb[6:9], opts.gd_step_clip)
            cg_it = jnp.asarray(0, jnp.int32)
            eta = jnp.asarray(0.0, dtype)
            rhs_norm = jnp.asarray(0.0, dtype)
        else:
            # rhs = a - B Cinv b arrives fused from the (reduced) assembly;
            # the Schur-Jacobi blocks ride the same reduction
            # (flat[:, 33:54]).
            precond_tri = inverse_tri6(
                K.schur_precond_tri(flat_g, lam_eff) if use_schur else Atri
            )
            if pose_sharded:
                rhs_sq = jnp.maximum(_psum(jnp.sum(rhs * rhs)), 1e-30)
                tol, eta, rhs_norm = _cg_tolerance_from_norm(
                    opts, jnp.sqrt(rhs_sq), rhs_norm_prev, eta_prev
                )

                def corr_partial(x_full):
                    return K.matvec_corr_pm(pm_local, shape, Cb, U, x_full)

                x, t, cg_it = _pose_sharded_pcg(
                    n_opt, Nl, shape.padded_points, Atri, rhs,
                    precond_tri, opts.cg_max_iterations, tol, rhs_sq,
                    corr_partial, to_full, to_local,
                    x0=x_prev if warm else None,
                )
            else:
                tol, eta, rhs_norm = _cg_tolerance(
                    opts, rhs, rhs_norm_prev, eta_prev
                )
                x, t, cg_it = pcg(
                    Cb, U, Atri, rhs, precond_tri, tol,
                    x_prev if warm else None,
                )
            y = _apply_cinv(Cb, t)

        if pose_sharded:
            # Retract only this device's pose rows, then all-gather the
            # updated (Nl, 16) table rows once per LM iteration and write
            # them into every device's full pose table.
            dR, dt = se3_exp(x)
            idx_pad = jnp.full((Ns,), shape.num_poses, jnp.int32)
            idx_pad = idx_pad.at[:n_opt].set(opt_pose_idx)
            idx_l = jax.lax.dynamic_slice_in_dim(idx_pad, shard * Nl, Nl)
            idx_safe = jnp.minimum(idx_l, shape.num_poses - 1)
            opt_rows = tbl[idx_safe]
            R9n, t3n = compose_flat(
                dR, dt, opt_rows[:, :9], opt_rows[:, 9:12]
            )
            upd = jnp.concatenate(
                [R9n, t3n, jnp.zeros((Nl, 4), tbl.dtype)], axis=1
            )
            upd_full = jax.lax.all_gather(
                upd, DATA_AXIS, axis=0, tiled=True
            )[:n_opt]
            tbl_cand = scatter_opt_rows(tbl, upd_full, opt_pose_idx, shape)
        else:
            tbl_cand = retract_opt_rows(tbl, x, opt_pose_idx, shape)
        X_cand = X.at[:3].add(y * X[3:4])

        current_cost = eval_cost(tbl_cand, X_cand)
        # NaN/inf guard (see solvers/full_ba.py).
        cost_ok = jnp.isfinite(current_cost)

        if is_lm:
            term_pose = jnp.sum(a * x) + jnp.sum(x * tri6_matvec(Atri, x))
            b_pl = Cb[6:9]
            Cy = _c_times(Cb, y)
            term_point_l = (
                jnp.sum(b_pl * y) + jnp.sum(y * Cy)
                + 2.0 * jnp.sum(y * (b_pl - Cy))
            )
            if pose_sharded:
                # Both terms are shard-local sums: one combined psum.
                model_decrease = -_psum(term_pose + term_point_l)
            else:
                model_decrease = -(term_pose + _psum(term_point_l))
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

        tbl_next = jnp.where(accept, tbl_cand, tbl)
        X_next = jnp.where(accept, X_cand, X)

        cost_change = jnp.abs(current_cost - prev_cost)
        step_pose = jnp.sum(jnp.linalg.norm(x, axis=-1))
        step_point_l = jnp.sum(
            jnp.sqrt(jnp.maximum(jnp.sum(y * y, axis=0), 0.0)) * X[3]
        )
        if pose_sharded:
            avg_step = _psum(step_pose + step_point_l) / n_params
        else:
            avg_step = (step_pose + _psum(step_point_l)) / n_params
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
                jnp.sqrt(prev_cost / n_obs),
                current_cost / n_obs,
            )
        )
        row = row.at[INFO_ABS_STEP].set(avg_step)
        row = row.at[INFO_DAMPING].set(lam_new)
        row = row.at[INFO_STATUS].set(status)
        row = row.at[INFO_CG_ITERS].set(cg_it.astype(dtype))

        return (
            tbl_next, X_next, lam_new,
            jnp.where(cost_ok, current_cost, prev_cost), it + 1,
            jnp.logical_or(conv_now, at_last), converged,
            info.at[it].set(row), num_info + 1,
            x, rhs_norm, eta,
        )

    def cond(c):
        return jnp.logical_and(c[4] < max_iter, jnp.logical_not(c[5]))

    tbl0 = K.pose_table(R_cw0, t_cw0)
    carry0 = (
        tbl0,
        pm_local.X,
        jnp.asarray(tr.initial_lambda, dtype),
        eval_cost(tbl0, pm_local.X),
        jnp.asarray(0, jnp.int32),
        jnp.asarray(False),
        jnp.asarray(False),
        jnp.zeros((max_iter, INFO_NUM_COLS), dtype=dtype),
        jnp.asarray(0, jnp.int32),
        jnp.zeros((Nl if pose_sharded else n_opt, 6), jnp.float32),
        jnp.asarray(0.0, dtype),
        jnp.asarray(0.0, dtype),
    )
    (tbl, X, lam, final_cost, it, _, converged, info,
     num_info, _, _, _) = jax.lax.while_loop(cond, body, carry0)

    _, _, s_sq, s_cnt = K.cost_pm_tbl(pm_local, shape, tbl, X, rig, huber)
    rmse_px = jnp.sqrt(
        _psum(s_sq) / jnp.maximum(_psum(s_cnt), 1.0)
    ) * inv_scale

    N = shape.num_poses
    return (tbl[:N, :9].reshape(N, 3, 3), tbl[:N, 9:12], X, converged, it,
            info, num_info, final_cost, rmse_px)


def solve_sharded_pm(
    problem: FinalizedProblem,
    shape: ProblemShape,
    options: Options,
    num_shards: int | None = None,
    host: dict | None = None,
    pose_sharded: bool = True,
    pm_and_shape=None,
) -> tuple[FullBAState, Summary]:
    """Host entry: build a shard-aligned point-major layout, shard_map the
    LM program over the mesh, return user-facing results.

    `pose_sharded=False` selects the replicated-pose-side program (see
    `_device_program`).

    `pm_and_shape` may carry a pre-built (pm, pshape) layout -- e.g. from
    `sharded_pm_problem_from_arrays` (device-side build, mesh-placed) or a
    `PMLayoutCache.refill` over the same topology -- so repeated solves
    skip the host build entirely (the SLAM serving pattern; contrast the
    reference's per-Solve finalize,
    core/full_bundle_adjustment_solver.cpp:631-663)."""
    if num_shards is None:
        num_shards = len(jax.devices())
    if pm_and_shape is None:
        res = pm_from_finalized(
            problem, shape, host=host, pad_blocks_to=num_shards
        )
        if res is None:
            raise ValueError(
                "problem exceeds point-major static bounds; use "
                "parallel.sharded_ba.solve_sharded"
            )
        pm, pshape = res
    else:
        pm, pshape = pm_and_shape
        if pshape.num_blocks % num_shards != 0:
            raise ValueError(
                f"pre-built layout has {pshape.num_blocks} blocks, not "
                f"divisible over {num_shards} shards; build it with "
                f"pad_blocks_to={num_shards} "
                "(sharded_pm_problem_from_arrays does this)"
            )

    time_mode = getattr(options, "time_iterations", False)
    if time_mode and time_mode != "device":
        # Loud refusal: the sharded engine runs its
        # whole LM loop as ONE shard_map dispatch, so chunked wall-clock
        # per-iteration timing would re-dispatch the mesh program per LM
        # iteration -- not implemented. The device-clock mode works here
        # exactly as on the single-chip engine.
        raise ValueError(
            "time_iterations=True (chunked wall-clock) is not supported on "
            "the sharded PM engine; use time_iterations='device' (profiler "
            "trace, per-iteration device times) or the single-chip "
            "solvers.full_ba_pm.solve_pm"
        )

    # Place the inputs on the mesh: a device-resident problem is committed
    # to one device, which the mesh program would otherwise refuse.
    from jax.sharding import NamedSharding

    if pm_and_shape is None:
        pm = place_pm_sharded(pm, num_shards)
    rig, R_cw, t_cw, opt_pose_idx = jax.device_put(
        (problem.rig, problem.R_cw, problem.t_cw, problem.opt_pose_idx),
        NamedSharding(data_mesh(num_shards), P()),
    )
    args = (pm, pshape, rig, R_cw, t_cw, opt_pose_idx, options, num_shards)
    kw = dict(pose_sharded=pose_sharded)
    iter_times_ms = None
    if time_mode == "device":
        from ..utils.profiling import (
            compile_per_op,
            iteration_times_ms,
            run_traced,
        )

        run = compile_per_op(
            _solve_sharded_pm_jax,
            ("pshape", "options", "num_shards", "pose_sharded"),
            pm=pm, pshape=pshape, rig=rig, R_cw0=R_cw, t_cw0=t_cw,
            opt_pose_idx=opt_pose_idx, options=options,
            num_shards=num_shards,
            pose_sharded=pose_sharded,
        )
        jax.block_until_ready(run())  # warm
        out, total_ms, events = run_traced(run)
        iter_times_ms = np.asarray(iteration_times_ms(
            events, "pm_assemble", int(out[4])
        ))
    else:
        t0 = time.perf_counter()
        out = jax.block_until_ready(_solve_sharded_pm_jax(*args, **kw))
        total_ms = (time.perf_counter() - t0) * 1e3
    (R_cw, t_cw, Xpm, converged, iters, info, num_info, final_cost,
     rmse_px) = out

    inv_scale = 1.0 / shape.scale
    t_user = t_cw * inv_scale
    R_wc, t_wc = inverse_se3(R_cw, t_user)
    N = R_wc.shape[0]
    T = jnp.zeros((N, 4, 4), jnp.float32)
    T = T.at[:, :3, :3].set(R_wc)
    T = T.at[:, :3, 3].set(t_wc)
    T = T.at[:, 3, 3].set(1.0)

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
