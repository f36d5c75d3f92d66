"""Parity tests for the point-major full-BA engine.

The PM engine (solvers/full_ba_pm.py + ops/point_major.py) must agree with
the observation-table engine (solvers/full_ba.py + ops/hessian.py) on every
intermediate quantity and on the final solution.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from bundle_adjustment_solver.models.problem import finalized_from_arrays
from bundle_adjustment_solver.options import (
    ConvergenceHandle,
    IterationHandle,
    Options,
    SolverType,
)
from bundle_adjustment_solver.ops import hessian as H
from bundle_adjustment_solver.ops import point_major as K
from bundle_adjustment_solver.ops.projection import full_ba_jacobians
from bundle_adjustment_solver.solvers import full_ba
from bundle_adjustment_solver.solvers.full_ba_pm import (
    pm_from_finalized,
    solve_pm,
)
from bundle_adjustment_solver.utils.synthetic import corridor_ba_problem

_SYM6 = [(0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)]


def _small_problem(num_fixed_points=0):
    prob = corridor_ba_problem(
        num_poses=12, num_points=300, window=4, seed=7, num_fixed_poses=2
    )
    fixed_pose = np.zeros(12, bool)
    fixed_pose[prob.fixed_pose_ids] = True
    fixed_point = np.zeros(300, bool)
    if num_fixed_points:
        fixed_point[:num_fixed_points] = True
    problem, shape = finalized_from_arrays(
        prob.cameras,
        prob.poses_initial,
        prob.points_initial,
        prob.obs_camera,
        prob.obs_pose,
        prob.obs_point,
        prob.obs_pixel,
        fixed_pose_mask=fixed_pose,
        fixed_point_mask=fixed_point,
    )
    return problem, shape


def _reference_system(problem, shape, lam, huber):
    X_ref, X_cam, r, w, (fx, fy, R_jw, R_cam) = full_ba._residuals(
        problem, problem.R_cw, problem.t_cw, problem.points, huber
    )
    Q, Rj = full_ba_jacobians(R_jw, X_ref, X_cam, fx, fy, R_cam)
    return H.assemble_block_system(
        Q, Rj, r, w, problem.obs_pose_opt, problem.obs_point_opt,
        shape.num_opt_poses, shape.num_opt_points, lam,
    ), (r, w)


@pytest.mark.parametrize("num_fixed_points", [0, 17])
def test_assemble_parity(num_fixed_points):
    problem, shape = _small_problem(num_fixed_points)
    res = pm_from_finalized(problem, shape, block_points=64)
    assert res is not None
    pm, pshape = res
    huber = 1.0 * shape.scale
    lam = jnp.float32(2.0)

    sys, _ = _reference_system(problem, shape, lam, huber)
    A, a, Cb, U = K.assemble_pm(
        pm, pshape, problem.R_cw, problem.t_cw, pm.X, problem.rig, lam,
        huber,
    )

    # f32 on both sides, summed in a different order.
    np.testing.assert_allclose(np.asarray(A), np.asarray(sys.A),
                               rtol=3e-4, atol=1e-3)
    np.testing.assert_allclose(np.asarray(a), np.asarray(sys.a),
                               rtol=3e-4, atol=1e-3)

    # Map point-major rows back to opt-point rows to compare C and b.
    ref = np.asarray(pm.point_ref)
    point_opt_of = np.full(shape.num_points, -1, np.int32)
    point_opt_of[np.asarray(problem.opt_point_idx)] = np.arange(
        shape.num_opt_points
    )
    live = (ref >= 0) & (point_opt_of[np.maximum(ref, 0)] >= 0)
    rows_opt = point_opt_of[ref[live]]
    Cb_h = np.asarray(Cb)
    Cref = np.asarray(sys.C)
    for n, (i, j) in enumerate(_SYM6):
        np.testing.assert_allclose(
            Cb_h[n, live], Cref[rows_opt, i, j], rtol=2e-5, atol=1e-3
        )
    np.testing.assert_allclose(
        Cb_h[6:9, live].T, np.asarray(sys.b)[rows_opt], rtol=2e-5, atol=1e-4
    )


def test_matvec_rhs_parity():
    problem, shape = _small_problem()
    pm, pshape = pm_from_finalized(problem, shape, block_points=64)
    huber = 1.0 * shape.scale
    lam = jnp.float32(0.5)
    sys, _ = _reference_system(problem, shape, lam, huber)
    A, a, Cb, U = K.assemble_pm(
        pm, pshape, problem.R_cw, problem.t_cw, pm.X, problem.rig, lam,
        huber,
    )
    x = jnp.asarray(
        np.random.default_rng(0).standard_normal(
            (shape.num_opt_poses, 6)
        ).astype(np.float32)
    )
    Sx_ref = H.schur_matvec(
        sys, problem.obs_pose_opt, problem.obs_point_opt,
        shape.num_opt_poses, shape.num_opt_points, x,
    )
    Sx_pm, t = K.schur_matvec_pm(pm, pshape, A, Cb, U, x)
    scale_ref = float(jnp.max(jnp.abs(Sx_ref)))
    np.testing.assert_allclose(
        np.asarray(Sx_pm), np.asarray(Sx_ref), rtol=1e-4,
        atol=1e-6 * scale_ref,
    )

    rhs_ref = H.schur_rhs(
        sys, problem.obs_pose_opt, problem.obs_point_opt,
        shape.num_opt_poses, shape.num_opt_points,
    )
    rhs_pm = K.schur_rhs_pm(pm, pshape, a, Cb, U)
    np.testing.assert_allclose(
        np.asarray(rhs_pm), np.asarray(rhs_ref), rtol=1e-4, atol=1e-4
    )


def test_cost_parity():
    problem, shape = _small_problem()
    pm, pshape = pm_from_finalized(problem, shape, block_points=64)
    huber = 1.0 * shape.scale
    _, (r, w) = _reference_system(problem, shape, jnp.float32(0.0), huber)
    c_ref = float(full_ba._cost(problem, r, w, "reference"))
    c_sq_ref = float(full_ba._cost(problem, r, w, "squared"))
    s_norm, s_wsq, s_sq, s_cnt = K.cost_pm(
        pm, pshape, problem.R_cw, problem.t_cw, pm.X, problem.rig, huber,
    )
    assert float(s_cnt) == shape.num_observations
    np.testing.assert_allclose(float(s_norm), c_ref, rtol=1e-5)
    np.testing.assert_allclose(float(s_wsq), c_sq_ref, rtol=1e-5)


def test_solve_pm_matches_full_ba():
    problem, shape = _small_problem()
    opts = Options(
        solver_type=SolverType.LEVENBERG_MARQUARDT,
        convergence_handle=ConvergenceHandle(0.0, 0.0),
        iteration_handle=IterationHandle(15),
        reduced_system="cg",
        cg_max_iterations=40,
        cg_tolerance=1e-10,
    )
    state_ref, _ = full_ba.solve(problem, shape, opts)
    state_pm, summary = solve_pm(problem, shape, opts)
    assert float(state_pm.final_rmse_px) < 1e-3
    np.testing.assert_allclose(
        float(state_pm.final_cost), float(state_ref.final_cost),
        rtol=1e-2, atol=1e-3,
    )
    np.testing.assert_allclose(
        np.asarray(state_pm.points), np.asarray(state_ref.points),
        rtol=1e-3, atol=1e-4,
    )
    np.testing.assert_allclose(
        np.asarray(state_pm.poses_world_to_camera),
        np.asarray(state_ref.poses_world_to_camera),
        rtol=1e-3, atol=1e-5,
    )
    assert len(summary.optimization_info_list) == 15


def test_solve_pm_gradient_descent():
    problem, shape = _small_problem()
    opts = Options(
        solver_type=SolverType.GRADIENT_DESCENT,
        convergence_handle=ConvergenceHandle(0.0, 0.0),
        iteration_handle=IterationHandle(5),
    )
    sg_ref, _ = full_ba.solve(problem, shape, opts)
    sg_pm, _ = solve_pm(problem, shape, opts)
    np.testing.assert_allclose(
        float(sg_pm.final_cost), float(sg_ref.final_cost), rtol=1e-4
    )


def test_layout_bounds_fallback(monkeypatch):
    """A landmark seen from more poses than max_slots must return None, and
    solve_pm must surface that as ValueError (full_ba.solve then falls back
    to the observation-table path)."""
    problem, shape = _small_problem()
    assert pm_from_finalized(problem, shape, max_slots=2) is None

    import bundle_adjustment_solver.solvers.full_ba_pm as mod

    monkeypatch.setattr(mod, "pm_from_finalized", lambda *a, **k: None)
    with pytest.raises(ValueError):
        mod.solve_pm(problem, shape, Options())


def test_irregular_visibility_parity():
    """Random observation dropout creates irregular per-landmark slot counts
    (padding exercises the valid masks); PM must match the obs-table engine."""
    prob = corridor_ba_problem(
        num_poses=12, num_points=300, window=4, seed=7, num_fixed_poses=2
    )
    rng = np.random.default_rng(99)
    keep = rng.random(prob.obs_camera.shape[0]) > 0.3
    fixed_pose = np.zeros(12, bool)
    fixed_pose[prob.fixed_pose_ids] = True
    problem, shape = finalized_from_arrays(
        prob.cameras, prob.poses_initial, prob.points_initial,
        prob.obs_camera[keep], prob.obs_pose[keep], prob.obs_point[keep],
        prob.obs_pixel[keep], fixed_pose_mask=fixed_pose,
    )
    opts = Options(
        solver_type=SolverType.LEVENBERG_MARQUARDT,
        convergence_handle=ConvergenceHandle(0.0, 0.0),
        iteration_handle=IterationHandle(10),
        reduced_system="cg", cg_max_iterations=40, cg_tolerance=1e-10,
    )
    state_ref, _ = full_ba.solve(problem, shape, opts)
    state_pm, _ = solve_pm(problem, shape, opts)
    np.testing.assert_allclose(
        float(state_pm.final_cost), float(state_ref.final_cost),
        rtol=1e-2, atol=1e-3,
    )


def test_loop_closure_observations():
    """Long-range (loop-closure-like) observations widen the per-block pose
    window; the layout must either absorb them (larger P) or return None so
    full_ba.solve falls back -- never silently drop them."""
    prob = corridor_ba_problem(
        num_poses=24, num_points=600, window=4, seed=5, num_fixed_poses=2
    )
    # Rewire 2% of observations to a far-away pose (keeps pixels valid-ish;
    # the solver just needs to process them consistently).
    rng = np.random.default_rng(3)
    obs_pose = prob.obs_pose.copy()
    sel = rng.random(obs_pose.shape[0]) < 0.02
    obs_pose[sel] = (obs_pose[sel] + 12) % 24
    fixed_pose = np.zeros(24, bool)
    fixed_pose[prob.fixed_pose_ids] = True
    problem, shape = finalized_from_arrays(
        prob.cameras, prob.poses_initial, prob.points_initial,
        prob.obs_camera, obs_pose, prob.obs_point, prob.obs_pixel,
        fixed_pose_mask=fixed_pose,
    )
    res = pm_from_finalized(problem, shape, block_points=64)
    assert res is not None  # 24 poses always fit max_window
    pm, pshape = res
    assert pshape.window >= 16
    opts = Options(
        solver_type=SolverType.LEVENBERG_MARQUARDT,
        convergence_handle=ConvergenceHandle(0.0, 0.0),
        iteration_handle=IterationHandle(5),
        reduced_system="cg", cg_max_iterations=40, cg_tolerance=1e-10,
    )
    state_ref, _ = full_ba.solve(problem, shape, opts)
    state_pm, _ = solve_pm(problem, shape, opts, pm_and_shape=res)
    np.testing.assert_allclose(
        float(state_pm.final_cost), float(state_ref.final_cost),
        rtol=1e-2, atol=1e-2,
    )


@pytest.mark.parametrize("reduced_system", ["cg", "dense"])
def test_solve_pm_gauss_newton(reduced_system):
    """GN (fixed 1e-5 damping) through both reference-path reduced solves;
    the dense path needs the Tikhonov floor (the reduced system is
    PSD-singular at GN damping -- the reference's LDLT tolerated that)."""
    problem, shape = _small_problem()
    opts = Options(
        solver_type=SolverType.GAUSS_NEWTON,
        convergence_handle=ConvergenceHandle(0.0, 0.0),
        iteration_handle=IterationHandle(8),
        reduced_system=reduced_system,
        cg_max_iterations=40,
        cg_tolerance=1e-10,
    )
    state_ref, _ = full_ba.solve(problem, shape, opts)
    state_pm, _ = solve_pm(problem, shape, opts)
    np.testing.assert_allclose(
        float(state_pm.final_cost), float(state_ref.final_cost),
        rtol=1e-2, atol=1e-3,
    )
    assert float(state_pm.final_rmse_px) < 1e-2


def test_trinocular_rig():
    """Rigs beyond stereo: 3 cameras through both engines (the reference's
    _BA_Camera list is arbitrary-K too, full_bundle_adjustment_solver.h:92)."""
    from bundle_adjustment_solver.models.camera import Camera

    prob = corridor_ba_problem(
        num_poses=10, num_points=200, window=3, seed=13, num_fixed_poses=2
    )
    # Add a third camera: offset down by 10 cm; synthesize its observations
    # by shifting the left camera's pixels with the known geometry is
    # overkill -- instead just re-project through the true poses.
    third = Camera(525.0, 525.0, 320.0, 240.0, np.eye(3),
                   np.array([0.0, -0.10, 0.0]))
    cameras = list(prob.cameras) + [third]
    T_cw = np.linalg.inv(prob.poses_true)  # (N, 4, 4) world->cam0
    sel = prob.obs_camera == 0  # reuse cam0's visibility
    j = prob.obs_pose[sel]
    i = prob.obs_point[sel]
    Xc0 = np.einsum("oab,ob->oa", T_cw[j, :3, :3], prob.points_true[i]) + T_cw[j, :3, 3]
    Xc2 = Xc0 + third.t_cam_from_ref
    pix2 = np.stack([
        525.0 * Xc2[:, 0] / Xc2[:, 2] + 320.0,
        525.0 * Xc2[:, 1] / Xc2[:, 2] + 240.0,
    ], axis=-1)
    obs_cam = np.concatenate([prob.obs_camera, np.full(j.shape[0], 2)])
    obs_pose = np.concatenate([prob.obs_pose, j])
    obs_point = np.concatenate([prob.obs_point, i])
    obs_pixel = np.concatenate([prob.obs_pixel, pix2])

    fixed_pose = np.zeros(10, bool)
    fixed_pose[prob.fixed_pose_ids] = True
    problem, shape = finalized_from_arrays(
        cameras, prob.poses_initial, prob.points_initial,
        obs_cam, obs_pose, obs_point, obs_pixel, fixed_pose_mask=fixed_pose,
    )
    assert shape.num_cameras == 3
    opts = Options(
        solver_type=SolverType.LEVENBERG_MARQUARDT,
        convergence_handle=ConvergenceHandle(0.0, 0.0),
        iteration_handle=IterationHandle(12),
        reduced_system="cg", cg_max_iterations=40, cg_tolerance=1e-10,
    )
    state_ref, _ = full_ba.solve(problem, shape, opts)
    state_pm, _ = solve_pm(problem, shape, opts)
    assert float(state_pm.final_rmse_px) < 1e-2
    np.testing.assert_allclose(
        float(state_pm.final_cost), float(state_ref.final_cost),
        rtol=1e-2, atol=1e-2,
    )


def test_single_fixed_pose():
    """Regression: with exactly ONE fixed pose the sentinel convention is
    ambiguous from values alone (0..N-1 either way); the layout must take
    num_opt_poses from the shape, not infer it (found by
    tools/stress_parity.py -- the inferred n_opt was off by one and the
    step application crashed on a shape mismatch)."""
    prob = corridor_ba_problem(
        num_poses=12, num_points=300, window=4, seed=7, num_fixed_poses=1
    )
    fixed = np.zeros(12, bool)
    fixed[prob.fixed_pose_ids] = True
    assert fixed.sum() == 1
    problem, shape = finalized_from_arrays(
        prob.cameras, prob.poses_initial, prob.points_initial,
        prob.obs_camera, prob.obs_pose, prob.obs_point, prob.obs_pixel,
        fixed_pose_mask=fixed,
    )
    pm, pshape = pm_from_finalized(problem, shape, block_points=64)
    assert pshape.num_opt_poses == shape.num_opt_poses == 11
    opts = Options(
        solver_type=SolverType.LEVENBERG_MARQUARDT,
        convergence_handle=ConvergenceHandle(0.0, 0.0),
        iteration_handle=IterationHandle(10),
        reduced_system="cg", cg_max_iterations=40, cg_tolerance=1e-10,
    )
    state_ref, _ = full_ba.solve(problem, shape, opts)
    state_pm, _ = solve_pm(problem, shape, opts)
    np.testing.assert_allclose(
        float(state_pm.final_cost), float(state_ref.final_cost),
        rtol=1e-2, atol=1e-3,
    )


def test_duplicate_observation_fallback():
    """A duplicate (landmark, pose, camera) observation is two residuals in
    the reference and the observation-table engine; the point-major layout
    has one plane cell per (slot, camera) and must refuse rather than
    silently overwrite (found by tools/stress_parity.py)."""
    prob = corridor_ba_problem(
        num_poses=10, num_points=200, window=3, seed=2, num_fixed_poses=2
    )
    dup = slice(0, 1)
    obs_cam = np.concatenate([prob.obs_camera, prob.obs_camera[dup]])
    obs_pose = np.concatenate([prob.obs_pose, prob.obs_pose[dup]])
    obs_point = np.concatenate([prob.obs_point, prob.obs_point[dup]])
    obs_pixel = np.concatenate([prob.obs_pixel, prob.obs_pixel[dup] + 0.5])
    fixed = np.zeros(10, bool)
    fixed[prob.fixed_pose_ids] = True
    problem, shape = finalized_from_arrays(
        prob.cameras, prob.poses_initial, prob.points_initial,
        obs_cam, obs_pose, obs_point, obs_pixel, fixed_pose_mask=fixed,
    )
    assert pm_from_finalized(problem, shape, block_points=64) is None


def test_wide_window_chunking():
    """Global co-visibility (every landmark also seen from the far end of the
    trajectory) widens each landmark block's pose window to hundreds of
    poses; the point-major engine must agree with the observation-table
    engine."""
    n_poses = 700  # window spans ~350 of 700 poses
    prob = corridor_ba_problem(
        num_poses=n_poses, num_points=500, window=3, seed=21,
        num_fixed_poses=2,
    )
    rng = np.random.default_rng(4)
    obs_pose = prob.obs_pose.copy()
    sel = rng.random(obs_pose.shape[0]) < 0.05
    obs_pose[sel] = (obs_pose[sel] + n_poses // 2) % n_poses
    # Dedupe triples the rewiring may create.
    tri = (prob.obs_point.astype(np.int64) * (n_poses * 2)
           + obs_pose.astype(np.int64) * 2 + prob.obs_camera)
    _, uniq_idx = np.unique(tri, return_index=True)
    uniq = np.zeros(obs_pose.shape[0], bool)
    uniq[uniq_idx] = True
    fixed = np.zeros(n_poses, bool)
    fixed[prob.fixed_pose_ids] = True
    problem, shape = finalized_from_arrays(
        prob.cameras, prob.poses_initial, prob.points_initial,
        prob.obs_camera[uniq], obs_pose[uniq], prob.obs_point[uniq],
        prob.obs_pixel[uniq], fixed_pose_mask=fixed,
    )
    res = pm_from_finalized(problem, shape)
    assert res is not None
    _, pshape = res
    assert pshape.window > 256  # a wide window
    opts = Options(
        solver_type=SolverType.LEVENBERG_MARQUARDT,
        convergence_handle=ConvergenceHandle(0.0, 0.0),
        iteration_handle=IterationHandle(4),
        reduced_system="cg", cg_max_iterations=30, cg_tolerance=1e-10,
    )
    state_ref, _ = full_ba.solve(problem, shape, opts)
    state_pm, _ = solve_pm(problem, shape, opts, pm_and_shape=res)
    np.testing.assert_allclose(
        float(state_pm.final_cost), float(state_ref.final_cost),
        rtol=1e-2, atol=1e-2,
    )


class TestCouplingDtype:
    """Options.coupling_dtype='bfloat16' halves the matvec's U traffic at a
    documented small accuracy cost; the solve must still converge near the
    f32 result."""

    def test_bf16_coupling_converges(self):
        import numpy as np

        from bundle_adjustment_solver.models.problem import (
            finalized_from_arrays,
        )
        from bundle_adjustment_solver.options import (
            ConvergenceHandle,
            IterationHandle,
            Options,
            SolverType,
        )
        from bundle_adjustment_solver.solvers import full_ba_pm
        from bundle_adjustment_solver.utils.synthetic import (
            corridor_ba_problem,
        )

        prob = corridor_ba_problem(
            num_poses=16, num_points=500, window=4, seed=3
        )
        fixed = np.zeros(16, bool)
        fixed[prob.fixed_pose_ids] = True
        problem, shape, host = finalized_from_arrays(
            prob.cameras, prob.poses_initial, prob.points_initial,
            prob.obs_camera, prob.obs_pose, prob.obs_point, prob.obs_pixel,
            fixed_pose_mask=fixed, return_host=True,
        )
        opts = Options(
            solver_type=SolverType.LEVENBERG_MARQUARDT,
            convergence_handle=ConvergenceHandle(0.0, 0.0),
            iteration_handle=IterationHandle(15),
            reduced_system="cg", cg_max_iterations=25, cg_tolerance=1e-10,
        )
        s32, _ = full_ba_pm.solve_pm(problem, shape, opts, host=host)
        s16, _ = full_ba_pm.solve_pm(
            problem, shape, opts.replace(coupling_dtype="bfloat16"),
            host=host,
        )
        r32 = float(s32.final_rmse_px)
        r16 = float(s16.final_rmse_px)
        # bf16 coupling costs a small convergence-floor factor (documented
        # in Options); both must reach sub-0.05 px on this problem.
        assert r32 < 0.05 and r16 < 0.05, (r32, r16)
        assert r16 < max(4.0 * r32, 0.02), (r32, r16)


class TestPMTimedIterations:
    """Options.time_iterations on the point-major engine: chunked dispatch
    with identical results and real per-iteration times."""

    def test_pm_chunked_matches_monolithic(self):
        import numpy as np

        from bundle_adjustment_solver.models.problem import (
            finalized_from_arrays,
        )
        from bundle_adjustment_solver.options import (
            ConvergenceHandle,
            IterationHandle,
            Options,
            SolverType,
        )
        from bundle_adjustment_solver.solvers import full_ba_pm
        from bundle_adjustment_solver.utils.synthetic import (
            corridor_ba_problem,
        )

        prob = corridor_ba_problem(
            num_poses=14, num_points=420, window=4, seed=9
        )
        fixed = np.zeros(14, bool)
        fixed[prob.fixed_pose_ids] = True
        problem, shape, host = finalized_from_arrays(
            prob.cameras, prob.poses_initial, prob.points_initial,
            prob.obs_camera, prob.obs_pose, prob.obs_point, prob.obs_pixel,
            fixed_pose_mask=fixed, return_host=True,
        )
        opts = Options(
            solver_type=SolverType.LEVENBERG_MARQUARDT,
            convergence_handle=ConvergenceHandle(1e-8, 1e-8),
            iteration_handle=IterationHandle(12),
            reduced_system="cg", cg_max_iterations=20, cg_tolerance=1e-10,
        )
        s_plain, sum_plain = full_ba_pm.solve_pm(
            problem, shape, opts, host=host
        )
        s_timed, sum_timed = full_ba_pm.solve_pm(
            problem, shape, opts.replace(time_iterations=True), host=host
        )
        np.testing.assert_allclose(
            float(s_timed.final_cost), float(s_plain.final_cost), rtol=1e-6
        )
        np.testing.assert_allclose(
            np.asarray(s_timed.poses_world_to_camera),
            np.asarray(s_plain.poses_world_to_camera),
            atol=1e-6,
        )
        infos = sum_timed.optimization_info_list
        assert len(infos) == len(sum_plain.optimization_info_list)
        assert all(oi.iter_time > 0.0 for oi in infos)


class TestSchurJacobiPrecond:
    """The Schur-Jacobi preconditioner columns of the point-major assembly
    (ops/point_major.py pose-system columns [33:54)) and the CG policy
    knobs built on them (Options.cg_precond / cg_forcing / cg_warm_start).
    Replaces the reduced solve the reference does densely
    (core/full_bundle_adjustment_solver.cpp:890-908)."""

    def test_schur_diag_parity_dense(self):
        """Assembled Schur-diag == dense per-pose diag of B Cinv B^T."""
        problem, shape = _small_problem()
        res = pm_from_finalized(problem, shape, block_points=64)
        assert res is not None
        pm, pshape = res
        huber = 1.0 * shape.scale
        lam = jnp.float32(2.0)

        sys, _ = _reference_system(problem, shape, lam, huber)
        B = H.dense_coupling(
            sys.U, problem.obs_pose_opt, problem.obs_point_opt,
            shape.num_opt_poses, shape.num_opt_points,
        )  # (N_opt, 6, M_opt, 3)
        BC = jnp.einsum("jaib,ibc->jaic", B, sys.Cinv)
        corr = jnp.einsum("jaic,jbic->jab", BC, B)  # exact Schur-diag corr
        expected = np.asarray(sys.A - corr)  # sys.A is damped

        flat, _, _ = K.assemble_pm_partials(
            pm, pshape, problem.R_cw, problem.t_cw, pm.X, problem.rig,
            lam, huber, emit_schur=True,
        )
        got = np.asarray(K._tri_to_full(K.schur_precond_tri(flat, lam)))
        # f32 on both sides, summed in a different order.
        np.testing.assert_allclose(got, expected, rtol=3e-4, atol=2e-3)

    def test_schur_precond_cuts_cg_iterations(self):
        """On the same reduced system, Schur-Jacobi PCG must not need more
        iterations than block-Jacobi-on-A PCG to hit a tight tolerance."""
        problem, shape = _small_problem()
        huber = 1.0 * shape.scale
        sys, _ = _reference_system(problem, shape, jnp.float32(1e-3), huber)
        args = (problem.obs_pose_opt, problem.obs_point_opt,
                shape.num_opt_poses, shape.num_opt_points)
        rhs = H.schur_rhs(sys, *args)
        matvec = lambda v: H.schur_matvec(sys, *args, v)

        pj = H.inverse_6x6(sys.A)
        corr = H.schur_diag_correction(sys, *args)
        psj = H.inverse_6x6(sys.A - corr)
        _, _, it_j = H.block_pcg(matvec, rhs, pj, 200, 1e-10)
        _, _, it_sj = H.block_pcg(matvec, rhs, psj, 200, 1e-10)
        assert int(it_sj) <= int(it_j)
        assert int(it_sj) < 200

    def test_ew_forcing_and_warm_start_converge(self):
        """Adaptive-CG + warm-start solves reach the same solution as the
        fixed tight-CG solve, in fewer total CG iterations."""
        problem, shape = _small_problem()
        base = Options(
            solver_type=SolverType.LEVENBERG_MARQUARDT,
            convergence_handle=ConvergenceHandle(0.0, 0.0),
            iteration_handle=IterationHandle(10),
            reduced_system="cg",
            cg_max_iterations=40,
            cg_tolerance=1e-12,
            cg_forcing="fixed",  # the tight deterministic-budget baseline
        )
        s_ref, _ = solve_pm(problem, shape, base)
        s_ada, sum_ada = solve_pm(
            problem, shape,
            base.replace(cg_forcing="ew", cg_warm_start=True),
        )
        assert float(s_ada.final_rmse_px) < max(
            2.0 * float(s_ref.final_rmse_px), 0.05
        )
        cg_ada = [oi.cg_iterations for oi in sum_ada.optimization_info_list]
        assert all(c >= 1 for c in cg_ada)
        # The forcing sequence must actually terminate CG early somewhere.
        assert min(cg_ada) < 40

    def test_obs_table_schur_jacobi_matches_default(self):
        """The observation-table engine with the per-observation Schur
        correction converges to the same solution."""
        problem, shape = _small_problem()
        opts = Options(
            solver_type=SolverType.LEVENBERG_MARQUARDT,
            convergence_handle=ConvergenceHandle(1e-8, 1e-8),
            iteration_handle=IterationHandle(12),
            reduced_system="cg",
            cg_max_iterations=40,
            cg_tolerance=1e-12,
            cg_forcing="fixed",  # tight-tolerance preconditioner comparison
        )
        st_sj, sum_sj = full_ba.solve(
            problem, shape, opts.replace(cg_precond="schur_jacobi")
        )
        st_j, _ = full_ba.solve(
            problem, shape, opts.replace(cg_precond="jacobi")
        )
        np.testing.assert_allclose(
            float(st_sj.final_cost), float(st_j.final_cost), rtol=1e-4
        )
        assert all(
            oi.cg_iterations >= 1 for oi in sum_sj.optimization_info_list
        )


def test_time_iterations_device_mode_cpu_fallback():
    """time_iterations='device' reports device time per LM iteration from a
    GPU trace; on the CPU backend the trace has no GPU plane, and the solve
    must refuse instead of reporting nothing."""
    from bundle_adjustment_solver.solvers import full_ba_pm

    problem, shape = _small_problem()
    opts = Options(
        solver_type=SolverType.LEVENBERG_MARQUARDT,
        convergence_handle=ConvergenceHandle(1e-8, 1e-8),
        iteration_handle=IterationHandle(8),
        reduced_system="cg", cg_max_iterations=20, cg_tolerance=1e-10,
        time_iterations="device",
    )
    with pytest.raises(RuntimeError, match="GPU"):
        full_ba_pm.solve_pm(problem, shape, opts)


def test_contiguous_opt_fast_path_matches_scatter():
    """PMShape.opt_start routes the pose update through static slices /
    dynamic-update-slice; it must be detected only for contiguous
    identity-ordered opt ranges and be bit-exact vs the general scatter."""
    import dataclasses

    prob = corridor_ba_problem(num_poses=14, num_points=260, window=4, seed=5)
    opts = Options(
        solver_type=SolverType.LEVENBERG_MARQUARDT,
        convergence_handle=ConvergenceHandle(0.0, 0.0),
        iteration_handle=IterationHandle(4),
        reduced_system="cg",
        cg_max_iterations=15,
        cg_tolerance=1e-8,
    )

    def build(mask):
        return finalized_from_arrays(
            prob.cameras, prob.poses_initial, prob.points_initial,
            prob.obs_camera, prob.obs_pose, prob.obs_point, prob.obs_pixel,
            fixed_pose_mask=mask,
        )

    # Non-contiguous fixed set -> no fast path.
    split = np.zeros(14, bool)
    split[[0, 7]] = True
    _, sshape = build(split)
    pm_s = pm_from_finalized(*build(split))
    assert pm_s[1].opt_start is None

    # Contiguous opt range [1, 14) -> fast path, bit-exact vs forcing the
    # scatter path on the identical layout.
    contig = np.zeros(14, bool)
    contig[0] = True
    problem, shape = build(contig)
    pm, pshape = pm_from_finalized(problem, shape)
    assert pshape.opt_start == 1
    state_fast, _ = solve_pm(problem, shape, opts, pm_and_shape=(pm, pshape))
    state_gen, _ = solve_pm(
        problem, shape, opts,
        pm_and_shape=(pm, dataclasses.replace(pshape, opt_start=None)),
    )
    np.testing.assert_array_equal(
        np.asarray(state_fast.poses_world_to_camera),
        np.asarray(state_gen.poses_world_to_camera),
    )
    np.testing.assert_array_equal(
        np.asarray(state_fast.points), np.asarray(state_gen.points)
    )


def test_pm_problem_from_arrays_matches_finalized():
    """The direct arrays->PM constructor (skips the sorted observation
    table, the expensive finalize pass) must produce bit-identical planes
    and solves vs routing through finalized_from_arrays."""
    from bundle_adjustment_solver.solvers.full_ba_pm import (
        pm_from_finalized,
        pm_problem_from_arrays,
    )

    prob = corridor_ba_problem(num_poses=24, num_points=700, window=5, seed=9)
    fixed = np.zeros(24, bool)
    fixed[prob.fixed_pose_ids] = True
    problem, shape, host = finalized_from_arrays(
        prob.cameras, prob.poses_initial, prob.points_initial,
        prob.obs_camera, prob.obs_pose, prob.obs_point, prob.obs_pixel,
        fixed_pose_mask=fixed, return_host=True,
    )
    pm1, ps1 = pm_from_finalized(problem, shape, host=host)
    p2, s2, pm2, ps2 = pm_problem_from_arrays(
        prob.cameras, prob.poses_initial, prob.points_initial,
        prob.obs_camera, prob.obs_pose, prob.obs_point, prob.obs_pixel,
        fixed_pose_mask=fixed,
    )
    assert ps1 == ps2
    assert s2.num_observations == shape.num_observations
    for name in pm1._fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(pm1, name)), np.asarray(getattr(pm2, name)),
            err_msg=f"plane {name} differs",
        )
    opts = Options(
        solver_type=SolverType.LEVENBERG_MARQUARDT,
        convergence_handle=ConvergenceHandle(0.0, 0.0),
        iteration_handle=IterationHandle(5),
        reduced_system="cg", cg_max_iterations=20, cg_tolerance=1e-9,
    )
    a, _ = solve_pm(problem, shape, opts, pm_and_shape=(pm1, ps1))
    b, _ = solve_pm(p2, s2, opts, pm_and_shape=(pm2, ps2))
    np.testing.assert_array_equal(
        np.asarray(a.poses_world_to_camera),
        np.asarray(b.poses_world_to_camera),
    )
    np.testing.assert_array_equal(np.asarray(a.points), np.asarray(b.points))


def test_pm_problem_from_arrays_device_layout():
    """layout='device' (XLA sort+scatter build, the serving path that skips
    both the host fill and the derived-plane H2D) must produce bit-identical
    planes and solves vs the host build."""
    from bundle_adjustment_solver.solvers.full_ba_pm import (
        pm_problem_from_arrays,
    )

    prob = corridor_ba_problem(num_poses=24, num_points=700, window=5, seed=9)
    fixed = np.zeros(24, bool)
    fixed[prob.fixed_pose_ids] = True
    outs = {}
    for mode in ("host", "device"):
        outs[mode] = pm_problem_from_arrays(
            prob.cameras, prob.poses_initial, prob.points_initial,
            prob.obs_camera, prob.obs_pose, prob.obs_point, prob.obs_pixel,
            fixed_pose_mask=fixed, layout=mode,
        )
        assert outs[mode] is not None
    (_, _, pm_h, ps_h), (p_d, s_d, pm_d, ps_d) = outs["host"], outs["device"]
    assert ps_h == ps_d
    for name in pm_h._fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(pm_h, name)), np.asarray(getattr(pm_d, name)),
            err_msg=f"plane {name} differs (device vs host layout)",
        )
    opts = Options(
        solver_type=SolverType.LEVENBERG_MARQUARDT,
        convergence_handle=ConvergenceHandle(0.0, 0.0),
        iteration_handle=IterationHandle(15),
        reduced_system="cg", cg_max_iterations=20, cg_tolerance=1e-9,
    )
    a, _ = solve_pm(p_d, s_d, opts, pm_and_shape=(pm_d, ps_d))
    rmse = float(np.asarray(a.final_rmse_px))
    assert rmse < 0.01


def test_pm_problem_from_arrays_layout_cache():
    """return_cache=True + PMLayoutCache.refill: a re-solve after refilling
    with perturbed pixel values must equal a from-scratch build+solve."""
    from bundle_adjustment_solver.solvers.full_ba_pm import (
        pm_problem_from_arrays,
    )

    prob = corridor_ba_problem(num_poses=24, num_points=700, window=5, seed=9)
    fixed = np.zeros(24, bool)
    fixed[prob.fixed_pose_ids] = True
    scale = 0.01
    p, s, pm, ps, cache = pm_problem_from_arrays(
        prob.cameras, prob.poses_initial, prob.points_initial,
        prob.obs_camera, prob.obs_pose, prob.obs_point, prob.obs_pixel,
        fixed_pose_mask=fixed, layout="device", return_cache=True,
        scale=scale,
    )
    rng = np.random.default_rng(4)
    pix2 = prob.obs_pixel + rng.normal(scale=0.05, size=prob.obs_pixel.shape)
    pm2 = cache.refill(
        pm, (pix2 * scale).astype(np.float32)
    )
    _, _, pm2_ref, ps2_ref = pm_problem_from_arrays(
        prob.cameras, prob.poses_initial, prob.points_initial,
        prob.obs_camera, prob.obs_pose, prob.obs_point, pix2,
        fixed_pose_mask=fixed, layout="device", scale=scale,
    )
    assert ps2_ref == ps
    for name in pm2._fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(pm2_ref, name)), np.asarray(getattr(pm2, name)),
            err_msg=f"plane {name}: refill differs from fresh build",
        )
    opts = Options(
        solver_type=SolverType.LEVENBERG_MARQUARDT,
        convergence_handle=ConvergenceHandle(0.0, 0.0),
        iteration_handle=IterationHandle(10),
        reduced_system="cg", cg_max_iterations=20, cg_tolerance=1e-9,
    )
    a, _ = solve_pm(p, s, opts, pm_and_shape=(pm2, ps))
    b, _ = solve_pm(p, s, opts, pm_and_shape=(pm2_ref, ps2_ref))
    np.testing.assert_array_equal(
        np.asarray(a.poses_world_to_camera),
        np.asarray(b.poses_world_to_camera),
    )

    # points-provided refill (the bench/SLAM per-frame path) must also
    # equal a fresh build with the new landmark values.
    pts3 = prob.points_initial + rng.normal(
        scale=0.01, size=prob.points_initial.shape
    )
    pm3 = cache.refill(
        pm, (pix2 * scale).astype(np.float32), (pts3 * scale).astype(np.float32)
    )
    _, _, pm3_ref, _ = pm_problem_from_arrays(
        prob.cameras, prob.poses_initial, pts3,
        prob.obs_camera, prob.obs_pose, prob.obs_point, pix2,
        fixed_pose_mask=fixed, layout="device", scale=scale,
    )
    for name in pm3._fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(pm3_ref, name)), np.asarray(getattr(pm3, name)),
            err_msg=f"plane {name}: points refill differs from fresh build",
        )

    # mask-only refill: coordinates keep plane order, mask row regathers.
    mask2 = np.ones(prob.points_initial.shape[0], bool)
    mask2[::7] = False
    pm4 = cache.refill(
        pm, (pix2 * scale).astype(np.float32), point_is_opt=mask2
    )
    np.testing.assert_array_equal(np.asarray(pm4.X[:3]), np.asarray(pm2.X[:3]))
    pr = np.asarray(pm.point_ref)
    expect_m = np.where(pr >= 0, mask2[np.maximum(pr, 0)], False)
    np.testing.assert_array_equal(np.asarray(pm4.X[3]) > 0, expect_m)

    import pytest
    with pytest.raises(ValueError, match="return_cache"):
        pm_problem_from_arrays(
            prob.cameras, prob.poses_initial, prob.points_initial,
            prob.obs_camera, prob.obs_pose, prob.obs_point, prob.obs_pixel,
            fixed_pose_mask=fixed, layout="host", return_cache=True,
        )
