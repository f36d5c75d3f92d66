"""Differential parity tests: analytic solvers vs the autodiff oracle.

This is the JAX build's version of test_compare_ceres_vs_native.cpp: same
synthetic data into (a) the native analytic solver and (b) an independent
autodiff/f64/scipy least-squares oracle; assert final poses and RMSE agree
(the reference only eyeballs stdout, cpp:228-251 -- here we assert).
"""

import numpy as np
import pytest

from bundle_adjustment_solver.options import (
    ConvergenceHandle,
    IterationHandle,
    Options,
    OutlierHandle,
    SolverType,
)
from bundle_adjustment_solver.solvers import oracle, pose_only
from bundle_adjustment_solver.utils.synthetic import (
    mono_pose_only_problem,
    stereo_ba_problem,
)

from tests.test_full_ba import build_solver, pose_errors


class TestPoseOnlyParity:
    def test_oracle_runs_in_float64(self):
        """The oracle's JAX residual path must be genuine f64 (no silent f32
        truncation); jnp.asarray(..., float64) outside an enable_x64 scope
        emits a 'will be truncated' UserWarning -- assert none appear."""
        import warnings

        prob = mono_pose_only_problem(num_points=200, seed=1, pixel_noise=0.5)
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            oracle.pose_only_oracle(
                prob.points,
                prob.pixels,
                prob.intrinsics,
                prob.pose_initial,
                max_nfev=5,
            )
        trunc = [w for w in rec if "truncated" in str(w.message)]
        assert not trunc, [str(w.message) for w in trunc]

    def test_mono_6dof_matches_oracle_with_noise(self):
        """With pixel noise the minimum is nontrivial; native (Huber
        disabled via a huge delta, to match the oracle's unrobust cost) and
        oracle must land on the same pose."""
        prob = mono_pose_only_problem(num_points=3000, seed=5, pixel_noise=0.8)
        opts = Options(
            convergence_handle=ConvergenceHandle(1e-10, 1e-10),
            outlier_handle=OutlierHandle(1e9, 1e9),  # disable robustifier
            iteration_handle=IterationHandle(200),
        )
        pose_native, _, _, ok = pose_only.solve_monocular_6dof(
            prob.points, prob.pixels, prob.intrinsics, prob.pose_initial, opts
        )
        assert ok
        pose_oracle, _ = oracle.pose_only_oracle(
            prob.points, prob.pixels, prob.intrinsics, prob.pose_initial
        )
        dT = np.linalg.inv(pose_native) @ pose_oracle
        ang = np.arccos(np.clip((np.trace(dT[:3, :3]) - 1) / 2, -1, 1))
        assert ang < 2e-4, ang
        assert np.linalg.norm(dT[:3, 3]) < 1e-3

    def test_mono_6dof_oracle_cost_parity(self):
        """Final unrobust cost within 1% of the oracle's optimum."""
        prob = mono_pose_only_problem(num_points=2000, seed=9, pixel_noise=1.0)
        opts = Options(
            convergence_handle=ConvergenceHandle(1e-10, 1e-10),
            outlier_handle=OutlierHandle(1e9, 1e9),
            iteration_handle=IterationHandle(200),
        )
        pose_native, _, _, _ = pose_only.solve_monocular_6dof(
            prob.points, prob.pixels, prob.intrinsics, prob.pose_initial, opts
        )
        _, cost_oracle = oracle.pose_only_oracle(
            prob.points, prob.pixels, prob.intrinsics, prob.pose_initial
        )

        def unrobust_cost(T_wc):
            T_cw = np.linalg.inv(T_wc)
            loc = prob.points @ T_cw[:3, :3].T + T_cw[:3, 3]
            fx, fy, cx, cy = prob.intrinsics
            u = fx * loc[:, 0] / loc[:, 2] + cx
            v = fy * loc[:, 1] / loc[:, 2] + cy
            r = np.stack([u, v], -1) - prob.pixels
            return 0.5 * np.sum(r**2)

        cost_native = unrobust_cost(pose_native)
        assert cost_native <= cost_oracle * 1.01, (cost_native, cost_oracle)


class TestFullBAParity:
    def test_full_ba_matches_oracle(self):
        """Small stereo BA with pixel noise: native LM final RMSE within 2%
        of the f64 oracle's, poses agree to sub-mm/sub-1e-4 rad after gauge
        alignment (both anchored by the same fixed poses)."""
        prob = stereo_ba_problem(
            num_poses=10, num_fixed_poses=3, seed=31, pixel_noise=0.3
        )
        solver = build_solver(prob)
        opts = Options(
            solver_type=SolverType.LEVENBERG_MARQUARDT,
            convergence_handle=ConvergenceHandle(1e-9, 1e-9),
            outlier_handle=OutlierHandle(1e9, 1e9),  # unrobust, match oracle
            iteration_handle=IterationHandle(200),
            reduced_system="dense",
        )
        summary = solver.solve(opts)

        fixed_pose = np.zeros(prob.poses_initial.shape[0], dtype=bool)
        fixed_pose[prob.fixed_pose_ids] = True
        # Oracle must only see observed points (unobserved ones are frozen in
        # the native solver and unconstrained in the oracle).
        observed = np.zeros(prob.points_initial.shape[0], dtype=bool)
        observed[np.unique(prob.obs_point)] = True
        poses_o, points_o, cost_o = oracle.full_ba_oracle(
            prob.cameras,
            prob.poses_initial,
            prob.points_initial,
            prob.obs_camera,
            prob.obs_pose,
            prob.obs_point,
            prob.obs_pixel,
            fixed_pose_mask=fixed_pose,
            fixed_point_mask=~observed,
        )
        n_obs = prob.obs_camera.shape[0]
        rmse_oracle = np.sqrt(2.0 * cost_o / n_obs)
        rmse_native = summary.final_reprojection_rmse_px
        assert rmse_native <= rmse_oracle * 1.02, (rmse_native, rmse_oracle)

        rot, trans = pose_errors(solver.get_all_poses(), poses_o)
        # f32 engine vs f64 oracle at a noise-broadened minimum: agreement
        # to ~1e-3 rad / mm is the meaningful parity bound.
        assert rot.max() < 2e-3, rot.max()
        assert trans.max() < 2e-3, trans.max()
        pt_err = np.linalg.norm(
            solver.get_all_points()[observed] - points_o[observed], axis=-1
        )
        assert np.median(pt_err) < 1e-3, np.median(pt_err)
