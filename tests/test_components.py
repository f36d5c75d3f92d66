"""Tests for auxiliary components: triangulation, checkpointing, factory
interface, refactor API aliases, visualization, sharded batched pose-only."""

import jax.numpy as jnp
import numpy as np
import pytest

from bundle_adjustment_solver.options import (
    ConvergenceHandle,
    IterationHandle,
    Options,
    OutlierHandle,
)


class TestTriangulation:
    def test_stereo_roundtrip(self, rng):
        """Project random points through a rectified stereo pair, triangulate
        back (test_projection_of_3d_point.cc parity, but asserted)."""
        from bundle_adjustment_solver.ops.triangulation import (
            triangulate_stereo,
        )

        fx = fy = 525.0
        cx, cy = 320.0, 240.0
        baseline = 0.12
        pts = np.stack(
            [rng.uniform(-2, 2, 100), rng.uniform(-1, 1, 100),
             rng.uniform(1, 8, 100)],
            axis=-1,
        ).astype(np.float32)
        pix_l = np.stack(
            [fx * pts[:, 0] / pts[:, 2] + cx, fy * pts[:, 1] / pts[:, 2] + cy],
            axis=-1,
        )
        right = pts - np.array([baseline, 0, 0])
        pix_r = np.stack(
            [fx * right[:, 0] / right[:, 2] + cx,
             fy * right[:, 1] / right[:, 2] + cy],
            axis=-1,
        )
        rec = triangulate_stereo(
            jnp.asarray(pix_l), jnp.asarray(pix_r), fx, fy, cx, cy, baseline
        )
        np.testing.assert_allclose(np.asarray(rec), pts, rtol=1e-3, atol=1e-3)

    def test_two_view_midpoint(self, rng):
        from bundle_adjustment_solver.ops import lie
        from bundle_adjustment_solver.ops.triangulation import (
            triangulate_two_view,
        )

        pts = np.stack(
            [rng.uniform(-2, 2, 50), rng.uniform(-1, 1, 50),
             rng.uniform(2, 8, 50)],
            axis=-1,
        ).astype(np.float32)
        R1 = jnp.eye(3)
        t1 = jnp.zeros(3)
        xi = jnp.asarray([0.5, 0.1, 0.0, 0.02, -0.3, 0.01], jnp.float32)
        R2, t2 = lie.se3_exp(xi)
        loc1 = pts
        loc2 = np.asarray(pts @ np.asarray(R2).T + np.asarray(t2))
        ray1 = loc1 / loc1[:, 2:3]
        ray2 = loc2 / loc2[:, 2:3]
        rec = triangulate_two_view(
            jnp.broadcast_to(R1, (50, 3, 3)), jnp.broadcast_to(t1, (50, 3)),
            jnp.broadcast_to(R2, (50, 3, 3)), jnp.broadcast_to(t2, (50, 3)),
            jnp.asarray(ray1), jnp.asarray(ray2),
        )
        np.testing.assert_allclose(np.asarray(rec), pts, rtol=1e-3, atol=1e-3)


class TestCheckpoint:
    def test_save_load_resume(self, tmp_path, rng):
        from bundle_adjustment_solver.models.problem import (
            finalized_from_arrays,
        )
        from bundle_adjustment_solver.utils import checkpoint
        from bundle_adjustment_solver.utils.synthetic import (
            corridor_ba_problem,
        )

        prob = corridor_ba_problem(num_poses=6, num_points=50, window=3)
        problem, shape = finalized_from_arrays(
            prob.cameras, prob.poses_initial, prob.points_initial,
            prob.obs_camera, prob.obs_pose, prob.obs_point, prob.obs_pixel,
        )
        path = checkpoint.save_state(
            str(tmp_path / "ck.npz"),
            np.asarray(problem.R_cw),
            np.asarray(problem.t_cw) + 1.0,
            np.asarray(problem.points) * 2.0,
            lam=0.5,
            iteration=7,
            prev_cost=123.0,
        )
        state = checkpoint.load_state(path)
        assert state["iteration"] == 7 and state["lam"] == 0.5
        resumed = checkpoint.resume_problem(problem, state)
        np.testing.assert_allclose(
            np.asarray(resumed.t_cw), np.asarray(problem.t_cw) + 1.0
        )
        np.testing.assert_allclose(
            np.asarray(resumed.points), np.asarray(problem.points) * 2.0
        )


class TestFactoryAndAliases:
    def test_factory_backends(self):
        from bundle_adjustment_solver.interfaces import (
            BundleAdjustmentSolverInterface,
            create_solver,
        )

        analytic = create_solver("analytic")
        assert isinstance(analytic, BundleAdjustmentSolverInterface)
        oracle = create_solver("oracle")
        assert isinstance(oracle, BundleAdjustmentSolverInterface)
        with pytest.raises(ValueError):
            create_solver("nope")

    def test_refactor_register_api_solves(self):
        """The Register* surface drives a full solve end-to-end
        (test_ba_refactor.cpp parity)."""
        from bundle_adjustment_solver.interfaces import create_solver
        from bundle_adjustment_solver.options import SolverType
        from bundle_adjustment_solver.utils.synthetic import (
            stereo_ba_problem,
        )

        prob = stereo_ba_problem(num_poses=10, num_fixed_poses=2, seed=13)
        solver = create_solver("analytic")
        for k, cam in enumerate(prob.cameras):
            solver.register_camera(k, cam)
        for j in range(prob.poses_initial.shape[0]):
            solver.register_world_to_body_pose(j, prob.poses_initial[j])
        for i in range(prob.points_initial.shape[0]):
            solver.register_world_point(i, prob.points_initial[i])
        for j in prob.fixed_pose_ids:
            solver.fix_registered_pose(int(j))
        for k in range(prob.obs_camera.shape[0]):
            solver.add_point_observation(
                int(prob.obs_camera[k]),
                int(prob.obs_pose[k]),
                int(prob.obs_point[k]),
                prob.obs_pixel[k],
            )
        opts = Options(
            solver_type=SolverType.LEVENBERG_MARQUARDT,
            convergence_handle=ConvergenceHandle(1e-6, 1e-6),
            iteration_handle=IterationHandle(60),
        )
        summary = solver.solve(opts)
        assert summary.final_reprojection_rmse_px < 0.05

    def test_gradient_descent_alias(self):
        from bundle_adjustment_solver.interfaces import create_solver
        from bundle_adjustment_solver.utils.synthetic import (
            stereo_ba_problem,
        )

        prob = stereo_ba_problem(num_poses=8, num_fixed_poses=2, seed=14)
        solver = create_solver("analytic")
        for k, cam in enumerate(prob.cameras):
            solver.register_camera(k, cam)
        for j in range(prob.poses_initial.shape[0]):
            solver.register_world_to_body_pose(j, prob.poses_initial[j])
        for i in range(prob.points_initial.shape[0]):
            solver.register_world_point(i, prob.points_initial[i])
        for j in prob.fixed_pose_ids:
            solver.fix_registered_pose(int(j))
        solver.add_observations(
            prob.obs_camera, prob.obs_pose, prob.obs_point, prob.obs_pixel
        )
        opts = Options(
            convergence_handle=ConvergenceHandle(1e-12, 1e-12),
            iteration_handle=IterationHandle(20),
        )
        summary = solver.solve_by_gradient_descent(opts)
        costs = [i.cost for i in summary.optimization_info_list]
        assert costs[-1] < costs[0]


class TestVisualization:
    def test_reprojection_replay_writes_pngs(self, tmp_path):
        from bundle_adjustment_solver.solvers import pose_only
        from bundle_adjustment_solver.utils.synthetic import (
            mono_pose_only_problem,
        )
        from bundle_adjustment_solver.utils.visualization import (
            save_reprojection_replay,
            save_trajectory_plot,
        )

        prob = mono_pose_only_problem(num_points=300, seed=3)
        opts = Options(
            convergence_handle=ConvergenceHandle(1e-6, 1e-6),
            outlier_handle=OutlierHandle(1.0, 2.5),
            iteration_handle=IterationHandle(20),
        )
        res = pose_only.solve_monocular_6dof_jax(
            jnp.asarray(prob.points, jnp.float32),
            jnp.asarray(prob.pixels, jnp.float32),
            jnp.ones(prob.points.shape[0], bool),
            jnp.asarray(prob.intrinsics, jnp.float32),
            jnp.asarray(prob.pose_initial, jnp.float32),
            opts,
        )
        n = int(res.num_debug)
        paths = save_reprojection_replay(
            np.asarray(res.debug_poses[:n]),
            prob.points,
            prob.pixels,
            prob.intrinsics,
            str(tmp_path / "replay"),
        )
        assert len(paths) == n
        import os

        assert all(os.path.getsize(p) > 0 for p in paths)
        traj = save_trajectory_plot(
            np.asarray(res.debug_poses[:n]),
            np.asarray(res.debug_poses[:n]),
            str(tmp_path / "traj.png"),
        )
        assert traj is not None


class TestShardedBatchedPoseOnly:
    def test_sharded_matches_unsharded(self):
        from bundle_adjustment_solver.parallel.batched_pose_only import (
            solve_monocular_6dof_sharded,
        )
        from bundle_adjustment_solver.parallel.mesh import data_mesh
        from bundle_adjustment_solver.solvers.pose_only import (
            solve_monocular_6dof_batched,
        )
        from bundle_adjustment_solver.utils.synthetic import (
            mono_pose_only_problem,
        )

        B, P = 16, 400
        probs = [mono_pose_only_problem(num_points=P, seed=s) for s in range(B)]
        points = jnp.asarray(np.stack([p.points for p in probs]), jnp.float32)
        pixels = jnp.asarray(np.stack([p.pixels for p in probs]), jnp.float32)
        valid = jnp.ones((B, P), bool)
        intr = jnp.asarray(probs[0].intrinsics, jnp.float32)
        poses0 = jnp.asarray(
            np.stack([p.pose_initial for p in probs]), jnp.float32
        )
        opts = Options(
            convergence_handle=ConvergenceHandle(1e-6, 1e-6),
            outlier_handle=OutlierHandle(1.0, 2.5),
            iteration_handle=IterationHandle(40),
        )
        mesh = data_mesh(8)
        sharded = solve_monocular_6dof_sharded(
            points, pixels, valid, intr, poses0, opts, mesh=mesh
        )
        plain = solve_monocular_6dof_batched(
            points, pixels, valid, intr, poses0, opts
        )
        assert bool(sharded.success.all())
        np.testing.assert_allclose(
            np.asarray(sharded.pose), np.asarray(plain.pose), atol=1e-5
        )

    def test_sharded_fused_kernel_matches_unsharded(self):
        """Stereo frames sharded over the mesh: each device runs the
        vmapped solver on its local frames, with per-frame iteration counts
        identical to the unsharded batched solve."""
        from bundle_adjustment_solver.parallel.batched_pose_only import (
            solve_stereo_6dof_sharded,
        )
        from bundle_adjustment_solver.parallel.mesh import data_mesh
        from bundle_adjustment_solver.solvers.pose_only import (
            solve_stereo_6dof_batched,
        )
        from bundle_adjustment_solver.utils.synthetic import (
            batched_stereo_pose_only_problem,
        )

        B, P = 8, 200
        prob = batched_stereo_pose_only_problem(
            num_frames=B, points_per_frame=P, seed=3, drop_right_frac=0.1
        )
        args = (
            jnp.asarray(prob.points, jnp.float32),
            jnp.asarray(prob.pixels_left, jnp.float32),
            jnp.asarray(prob.pixels_right, jnp.float32),
            jnp.ones((B, P), bool),
            jnp.asarray(prob.intrinsics, jnp.float32),
            jnp.asarray(prob.intrinsics, jnp.float32),
            jnp.asarray(prob.pose_left_to_right, jnp.float32),
            jnp.asarray(prob.poses_initial, jnp.float32),
        )
        opts = Options(
            convergence_handle=ConvergenceHandle(1e-6, 1e-6),
            outlier_handle=OutlierHandle(1.0, 2.5),
            iteration_handle=IterationHandle(40),
        )
        sharded = solve_stereo_6dof_sharded(*args, opts, mesh=data_mesh(8))
        plain = solve_stereo_6dof_batched(*args, opts)
        assert bool(sharded.success.all())
        np.testing.assert_allclose(
            np.asarray(sharded.pose), np.asarray(plain.pose), atol=1e-5
        )
        np.testing.assert_array_equal(
            np.asarray(sharded.num_iterations),
            np.asarray(plain.num_iterations),
        )


class TestCorridorGenerator:
    def test_projection_chunking_is_value_invariant(self, monkeypatch):
        """The chunked projection pass (memory-bounding at 24M obs) must be
        bit-identical to the one-shot pass at any chunk size."""
        from bundle_adjustment_solver.utils import synthetic

        one_shot = synthetic.corridor_ba_problem(50, 2000, window=4, seed=9)
        monkeypatch.setattr(synthetic, "_PROJECTION_CHUNK", 1000)
        chunked = synthetic.corridor_ba_problem(50, 2000, window=4, seed=9)
        np.testing.assert_array_equal(
            one_shot.obs_pixel, chunked.obs_pixel
        )
