"""End-to-end full BA tests: the test_ba stereo problem, asserting recovery.

Ports the reference's primary workload (test/test_ba.cpp:100-295: 60 stereo
frames, 5 fixed, ~730 wall landmarks, LM) into asserting pytest tests
(SURVEY.md §4), plus Schur-identity and dense-vs-CG consistency checks the
reference lacks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bundle_adjustment_solver.models.problem import FullBundleAdjustmentSolver
from bundle_adjustment_solver.options import (
    ConvergenceHandle,
    IterationHandle,
    Options,
    OutlierHandle,
    SolverType,
)
from bundle_adjustment_solver.utils.synthetic import stereo_ba_problem


def build_solver(prob) -> FullBundleAdjustmentSolver:
    solver = FullBundleAdjustmentSolver()
    for k, cam in enumerate(prob.cameras):
        solver.add_camera(k, cam)
    for j in range(prob.poses_initial.shape[0]):
        solver.add_pose(j, prob.poses_initial[j])
    for i in range(prob.points_initial.shape[0]):
        solver.add_point(i, prob.points_initial[i])
    for j in prob.fixed_pose_ids:
        solver.make_pose_fixed(int(j))
    solver.add_observations(prob.obs_camera, prob.obs_pose, prob.obs_point,
                            prob.obs_pixel)
    return solver


def lm_options(max_iter=100, thr=1e-6, **kw):
    return Options(
        solver_type=SolverType.LEVENBERG_MARQUARDT,
        convergence_handle=ConvergenceHandle(thr, thr),
        iteration_handle=IterationHandle(max_iter),
        **kw,
    )


def pose_errors(est, true):
    """Per-pose (rotation rad, translation m) errors."""
    rot, trans = [], []
    for T_est, T_true in zip(est, true):
        dT = np.linalg.inv(T_est) @ T_true
        ang = np.arccos(np.clip((np.trace(dT[:3, :3]) - 1) / 2, -1, 1))
        rot.append(ang)
        trans.append(np.linalg.norm(dT[:3, 3]))
    return np.asarray(rot), np.asarray(trans)


class TestFullBA_TestBaWorkload:
    """The reference's primary workload, small variant for CI speed."""

    @pytest.fixture(scope="class")
    def problem(self):
        return stereo_ba_problem(num_poses=20, num_fixed_poses=3, seed=11)

    def test_lm_dense_recovers_truth(self, problem):
        solver = build_solver(problem)
        summary = solver.solve(lm_options(reduced_system="dense"))
        assert summary.convergence_status
        # Final unscaled reprojection RMSE must be sub-0.05 px on zero-noise data.
        assert summary.final_reprojection_rmse_px < 0.05, (
            summary.final_reprojection_rmse_px
        )
        rot, trans = pose_errors(solver.get_all_poses(), problem.poses_true)
        assert rot.max() < 1e-3, rot.max()
        assert trans.max() < 5e-3, trans.max()
        # Fixed poses must be untouched.
        for j in problem.fixed_pose_ids:
            np.testing.assert_allclose(
                solver.get_pose(int(j)), problem.poses_true[j], atol=1e-6
            )
        # Landmarks recovered (gauge fixed by the 3 fixed poses). Only
        # observed landmarks carry information; unobserved ones keep their
        # perturbed initial values (frozen by the singular-C guard).
        observed = np.unique(problem.obs_point)
        pt_err = np.linalg.norm(
            solver.get_all_points()[observed] - problem.points_true[observed],
            axis=-1,
        )
        assert np.median(pt_err) < 5e-3, np.median(pt_err)
        assert pt_err.max() < 5e-2, pt_err.max()

    def test_cg_matches_dense(self, problem):
        s_dense = build_solver(problem)
        s_cg = build_solver(problem)
        sum_dense = s_dense.solve(lm_options(reduced_system="dense"))
        sum_cg = s_cg.solve(
            lm_options(reduced_system="cg", cg_max_iterations=200,
                       cg_tolerance=1e-12)
        )
        # Parity on final quality, not trajectories (inexact Newton may take
        # different iteration counts, SURVEY.md §7).
        assert sum_cg.final_reprojection_rmse_px < 0.05
        rot_d, trans_d = pose_errors(s_dense.get_all_poses(), problem.poses_true)
        rot_c, trans_c = pose_errors(s_cg.get_all_poses(), problem.poses_true)
        assert rot_c.max() < 2 * max(rot_d.max(), 1e-4)
        assert trans_c.max() < 2 * max(trans_d.max(), 1e-3)

    def test_gauss_newton_mode(self, problem):
        solver = build_solver(problem)
        opts = lm_options().replace(solver_type=SolverType.GAUSS_NEWTON)
        summary = solver.solve(opts)
        assert summary.final_reprojection_rmse_px < 0.05
        rot, trans = pose_errors(solver.get_all_poses(), problem.poses_true)
        assert rot.max() < 1e-3

    def test_gradient_descent_mode(self, problem):
        """GD with 0.001 step clip (refactor cpp:1075-1367) must strictly
        decrease the cost; it is far too slow to converge fully."""
        solver = build_solver(problem)
        opts = lm_options(max_iter=30, thr=1e-12).replace(
            solver_type=SolverType.GRADIENT_DESCENT
        )
        summary = solver.solve(opts)
        costs = [i.cost for i in summary.optimization_info_list]
        assert len(costs) >= 2
        assert costs[-1] < costs[0]

    def test_brief_report_renders(self, problem):
        solver = build_solver(problem)
        summary = solver.solve(lm_options(max_iter=20))
        report = summary.brief_report()
        assert "Analytic Solver Report" in report
        assert "itr" in report


class TestSchurIdentity:
    """S x = rhs implies H [x; y] = [a; b]: the Schur reduction must be
    algebraically consistent with the full normal equations."""

    def test_schur_identity(self):
        from bundle_adjustment_solver.ops import hessian as Hs
        from bundle_adjustment_solver.solvers import full_ba

        prob = stereo_ba_problem(num_poses=8, num_fixed_poses=2, seed=3)
        solver = build_solver(prob)
        problem, shape = solver.finalize()
        huber = 1.0 * shape.scale
        X_ref, X_cam, r, w, (fx, fy, R_jw, R_cam) = full_ba._residuals(
            problem, problem.R_cw, problem.t_cw, problem.points, huber
        )
        from bundle_adjustment_solver.ops.projection import full_ba_jacobians

        Q, Rj = full_ba_jacobians(R_jw, X_ref, X_cam, fx, fy, R_cam)
        lam = jnp.asarray(0.1, problem.points.dtype)
        sys = Hs.assemble_block_system(
            Q, Rj, r, w, problem.obs_pose_opt, problem.obs_point_opt,
            shape.num_opt_poses, shape.num_opt_points, lam,
        )
        B = Hs.dense_coupling(
            sys.U, problem.obs_pose_opt, problem.obs_point_opt,
            shape.num_opt_poses, shape.num_opt_points,
        )
        S, rhs = Hs.schur_reduce_dense(sys, B)
        x = jnp.linalg.solve(S, rhs).reshape(shape.num_opt_poses, 6)
        y = Hs.back_substitute_dense(sys, B, x)

        # Full system residual: A x + B y = a ; B^T x + C y = b
        Bx = jnp.einsum("jaib,ib->ja", B, y)
        top = jnp.einsum("jab,jb->ja", sys.A, x) + Bx
        np.testing.assert_allclose(np.asarray(top), np.asarray(sys.a),
                                   rtol=1e-3, atol=1e-6)
        Bty = jnp.einsum("jaib,ja->ib", B, x)
        bottom = jnp.einsum("iab,ib->ia", sys.C, y) + Bty
        np.testing.assert_allclose(np.asarray(bottom), np.asarray(sys.b),
                                   rtol=1e-3, atol=1e-6)

        # Matrix-free matvec must agree with the dense S.
        v = jnp.asarray(
            np.random.default_rng(0).normal(size=(shape.num_opt_poses, 6)),
            problem.points.dtype,
        )
        Sv_dense = (S @ v.reshape(-1)).reshape(shape.num_opt_poses, 6)
        Sv_free = Hs.schur_matvec(
            sys, problem.obs_pose_opt, problem.obs_point_opt,
            shape.num_opt_poses, shape.num_opt_points, v,
        )
        np.testing.assert_allclose(
            np.asarray(Sv_free), np.asarray(Sv_dense), rtol=1e-4, atol=1e-6
        )
        # And the matrix-free rhs with the dense one.
        rhs_free = Hs.schur_rhs(
            sys, problem.obs_pose_opt, problem.obs_point_opt,
            shape.num_opt_poses, shape.num_opt_points,
        )
        np.testing.assert_allclose(
            np.asarray(rhs_free).reshape(-1), np.asarray(rhs), rtol=1e-4,
            atol=1e-7,
        )


class TestBuilderValidation:
    def test_unknown_ids_raise(self):
        from bundle_adjustment_solver.models.camera import Camera

        solver = FullBundleAdjustmentSolver()
        solver.add_camera(0, Camera(100.0, 100.0, 50.0, 50.0))
        solver.add_pose(0, np.eye(4))
        solver.add_point(0, np.ones(3))
        with pytest.raises(RuntimeError):
            solver.add_observation(1, 0, 0, np.zeros(2))  # bad camera
        with pytest.raises(RuntimeError):
            solver.add_observation(0, 7, 0, np.zeros(2))  # bad pose
        with pytest.raises(RuntimeError):
            solver.add_observation(0, 0, 7, np.zeros(2))  # bad point
        with pytest.raises(RuntimeError):
            solver.make_pose_fixed(9)
        with pytest.raises(RuntimeError):
            solver.make_point_fixed(9)

    def test_mutation_after_finalize_rejected(self):
        from bundle_adjustment_solver.models.camera import Camera

        solver = FullBundleAdjustmentSolver()
        solver.add_camera(0, Camera(100.0, 100.0, 50.0, 50.0))
        solver.add_pose(0, np.eye(4))
        solver.add_point(0, np.array([0.0, 0.0, 2.0]))
        solver.add_observation(0, 0, 0, np.array([50.0, 50.0]))
        solver.finalize()
        with pytest.raises(RuntimeError):
            solver.add_pose(1, np.eye(4))

    def test_empty_problem_raises(self):
        solver = FullBundleAdjustmentSolver()
        with pytest.raises(RuntimeError):
            solver.finalize()

    def test_statistics_string(self):
        prob = stereo_ba_problem(num_poses=6, num_fixed_poses=1, seed=5)
        solver = build_solver(prob)
        stats = solver.get_solver_statistics()
        assert "# of total poses: 6" in stats
        assert "# fix  poses: 1" in stats


class TestTimedIterations:
    """Options.time_iterations=True: chunked-dispatch reporting mode fills
    the reference's per-iteration iter_time (full cpp:981-992) while
    producing the identical solve."""

    def test_iter_times_recorded_and_solution_identical(self):
        prob = stereo_ba_problem(num_poses=8, num_fixed_poses=2, seed=21)
        solver = build_solver(prob)
        opts = Options(
            solver_type=SolverType.LEVENBERG_MARQUARDT,
            convergence_handle=ConvergenceHandle(1e-8, 1e-8),
            iteration_handle=IterationHandle(30),
            reduced_system="dense",
        )
        s_plain = solver.solve(opts)
        poses_plain = solver.get_all_poses().copy()

        solver2 = build_solver(prob)
        s_timed = solver2.solve(opts.replace(time_iterations=True))
        poses_timed = solver2.get_all_poses()

        np.testing.assert_allclose(poses_timed, poses_plain, atol=1e-6)
        infos = s_timed.optimization_info_list
        assert len(infos) == len(s_plain.optimization_info_list)
        assert all(oi.iter_time > 0.0 for oi in infos)
        # The on-device loop reports -1 (no host timing inside jit).
        assert all(oi.iter_time == -1.0 for oi in s_plain.optimization_info_list)
        # brief_report prints the real numbers.
        assert "itr_time" in s_timed.brief_report()


class TestCgDtypeAndDeviceModeGuards:
    """Round-3 review regressions: carry-dtype consistency for f64 problems
    and the time_iterations='device' routing guard."""

    def test_cg_f64_carry_dtype(self):
        """An f64 problem with reduced_system='cg' must trace: _cg_tolerance
        previously returned f32 eta against an f64 eta_prev carry and the
        while_loop carry check raised at trace time (both 'fixed' and 'ew'
        forcing ride the same carry)."""
        from bundle_adjustment_solver.models.problem import (
            finalized_from_arrays,
        )
        from bundle_adjustment_solver.solvers import full_ba

        prob = stereo_ba_problem(num_poses=5, num_fixed_poses=1, seed=3)
        fixed = np.zeros(prob.poses_initial.shape[0], bool)
        fixed[prob.fixed_pose_ids] = True
        with jax.enable_x64(True):
            problem, shape = finalized_from_arrays(
                prob.cameras, prob.poses_initial, prob.points_initial,
                prob.obs_camera, prob.obs_pose, prob.obs_point,
                prob.obs_pixel, fixed_pose_mask=fixed, dtype=jnp.float64,
            )
            for forcing in ("fixed", "ew"):
                opts = lm_options(max_iter=3, reduced_system="cg",
                                  cg_forcing=forcing, cg_max_iterations=10)
                state = full_ba._solve_jax(problem, shape, opts, "cg")
                assert state.final_cost.dtype == jnp.float64
                assert np.isfinite(float(state.final_cost))

    def test_device_mode_refused_off_pm_engine(self):
        """time_iterations='device' anchors on the point-major assembly
        scope's trace events; the obs-table route must refuse it instead
        of silently reporting chunked dispatch wall times."""
        prob = stereo_ba_problem(num_poses=5, num_fixed_poses=1, seed=3)
        solver = build_solver(prob)
        opts = lm_options(max_iter=3, reduced_system="dense",
                          time_iterations="device")
        with pytest.raises(ValueError, match="point-major"):
            solver.solve(opts)

    def test_time_iterations_typo_rejected(self):
        """Near-miss strings ('Device') must raise at Options construction
        instead of silently selecting chunked wall-clock mode."""
        for bad in ("Device", "dev", "wall"):
            with pytest.raises(ValueError, match="time_iterations"):
                lm_options(max_iter=3, time_iterations=bad)
        # The three valid values still construct.
        for good in (False, True, "device"):
            lm_options(max_iter=3, time_iterations=good)

    def test_device_mode_refused_pose_only(self):
        from bundle_adjustment_solver.solvers import pose_only
        from bundle_adjustment_solver.utils.synthetic import (
            mono_pose_only_problem,
        )

        p = mono_pose_only_problem(num_points=50, seed=1)
        opts = lm_options(max_iter=3, time_iterations="device")
        with pytest.raises(ValueError, match="point-major"):
            pose_only.solve_monocular_6dof(
                p.points, p.pixels, p.intrinsics, p.pose_initial, opts
            )


class TestDefaultOptionsAreTheStudiedConfig:
    """`Options()` must hand a new user the configuration bench.py runs
    (Eisenstat-Walker forcing, block-Jacobi preconditioning; compared in
    benchmarks/cg_study.py). 'fixed' stays available as the
    deterministic-budget mode."""

    def test_defaults_match_bench_configuration(self):
        opts = Options()
        assert opts.cg_forcing == "ew"
        # 'jacobi', not 'schur_jacobi': iteration-neutral on the flagship,
        # and it scatters 21 fewer pose-system columns per LM iteration.
        assert opts.cg_precond == "jacobi"
        # bench.py's full_ba_options differs from Options() only in
        # workload-shaping fields (thresholds/iteration counts/system
        # routing), never in solver-quality knobs.
        assert opts.cg_forcing_max == 0.1 and opts.cg_forcing_min == 1e-3

    def test_default_options_solve_equals_explicit_bench_config(self):
        """A default-Options CG solve must be bit-identical to one that
        spells out the bench configuration explicitly."""
        from bundle_adjustment_solver.models.problem import (
            finalized_from_arrays,
        )
        from bundle_adjustment_solver.solvers import full_ba

        prob = stereo_ba_problem(num_poses=8, num_fixed_poses=1, seed=7)
        fixed = np.zeros(prob.poses_initial.shape[0], bool)
        fixed[prob.fixed_pose_ids] = True
        problem, shape = finalized_from_arrays(
            prob.cameras, prob.poses_initial, prob.points_initial,
            prob.obs_camera, prob.obs_pose, prob.obs_point, prob.obs_pixel,
            fixed_pose_mask=fixed,
        )
        opts_default = lm_options(max_iter=5, reduced_system="cg")
        opts_explicit = opts_default.replace(
            cg_forcing="ew", cg_precond="jacobi"
        )
        st_d = full_ba._solve_jax(problem, shape, opts_default, "cg")
        st_e = full_ba._solve_jax(problem, shape, opts_explicit, "cg")
        np.testing.assert_array_equal(
            np.asarray(st_d.poses_world_to_camera),
            np.asarray(st_e.poses_world_to_camera),
        )
        assert float(st_d.final_cost) == float(st_e.final_cost)
