"""Distributed point-major engine: multi-device parity on the CPU mesh.

The sharded PM solver (parallel/sharded_pm.py) must reproduce the
single-device PM solver's results bit-closely: landmark shards only interact
with the replicated pose system through psums, so the only tolerated
difference is f32 reduction order.
"""

import numpy as np
import jax
import pytest

from bundle_adjustment_solver.models.problem import finalized_from_arrays
from bundle_adjustment_solver.options import (
    ConvergenceHandle,
    IterationHandle,
    Options,
    SolverType,
)
from bundle_adjustment_solver.parallel.sharded_pm import solve_sharded_pm
from bundle_adjustment_solver.solvers.full_ba_pm import solve_pm
from bundle_adjustment_solver.utils.synthetic import corridor_ba_problem


def _problem():
    prob = corridor_ba_problem(
        num_poses=16, num_points=600, window=4, seed=11, num_fixed_poses=2
    )
    fixed = np.zeros(16, bool)
    fixed[prob.fixed_pose_ids] = True
    return finalized_from_arrays(
        prob.cameras,
        prob.poses_initial,
        prob.points_initial,
        prob.obs_camera,
        prob.obs_pose,
        prob.obs_point,
        prob.obs_pixel,
        fixed_pose_mask=fixed,
    )


@pytest.mark.parametrize("num_shards", [2, 8])
def test_sharded_pm_matches_single_device(num_shards):
    assert len(jax.devices()) >= num_shards
    problem, shape = _problem()
    opts = Options(
        solver_type=SolverType.LEVENBERG_MARQUARDT,
        convergence_handle=ConvergenceHandle(0.0, 0.0),
        iteration_handle=IterationHandle(8),
        cg_max_iterations=30,
        cg_tolerance=1e-10,
    )
    s1, _ = solve_pm(problem, shape, opts)
    sN, summary = solve_sharded_pm(problem, shape, opts, num_shards=num_shards)
    np.testing.assert_allclose(
        float(sN.final_cost), float(s1.final_cost), rtol=1e-4
    )
    np.testing.assert_allclose(
        np.asarray(sN.points), np.asarray(s1.points), rtol=1e-3, atol=1e-4
    )
    np.testing.assert_allclose(
        np.asarray(sN.poses_world_to_camera),
        np.asarray(s1.poses_world_to_camera),
        rtol=1e-3,
        atol=1e-5,
    )
    assert len(summary.optimization_info_list) == 8


def test_sharded_pm_converges_to_truth():
    prob = corridor_ba_problem(
        num_poses=16, num_points=600, window=4, seed=11, num_fixed_poses=2
    )
    problem, shape = _problem()
    opts = Options(
        solver_type=SolverType.LEVENBERG_MARQUARDT,
        convergence_handle=ConvergenceHandle(1e-10, 1e-10),
        iteration_handle=IterationHandle(30),
        cg_max_iterations=50,
        cg_tolerance=1e-12,
    )
    state, _ = solve_sharded_pm(problem, shape, opts, num_shards=4)
    assert float(state.final_rmse_px) < 5e-3
    pose_err = np.abs(
        np.asarray(state.poses_world_to_camera)[:, :3, 3]
        - prob.poses_true[:, :3, 3]
    ).max()
    assert pose_err < 0.05  # absolute recovery up to corridor gauge drift


@pytest.mark.parametrize("num_shards", [2, 8])
def test_pose_sharded_matches_replicated(num_shards):
    """The default pose-sharded program (reduce-scatter partials, local CG,
    pose-row all-gather) vs the replicated-pose program: same trust-region
    trace and solution up to f32 reduction order."""
    problem, shape = _problem()
    opts = Options(
        solver_type=SolverType.LEVENBERG_MARQUARDT,
        convergence_handle=ConvergenceHandle(0.0, 0.0),
        iteration_handle=IterationHandle(8),
        reduced_system="cg",
        cg_max_iterations=25,
        cg_tolerance=1e-9,
        cg_forcing="ew",
        cg_warm_start=True,
    )
    a, _ = solve_sharded_pm(
        problem, shape, opts, num_shards=num_shards, pose_sharded=True
    )
    b, _ = solve_sharded_pm(
        problem, shape, opts, num_shards=num_shards, pose_sharded=False
    )
    np.testing.assert_allclose(
        float(a.final_cost), float(b.final_cost), rtol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(a.poses_world_to_camera),
        np.asarray(b.poses_world_to_camera), rtol=1e-4, atol=1e-5,
    )
    from bundle_adjustment_solver.summary import INFO_STATUS

    np.testing.assert_array_equal(
        np.asarray(a.info)[:, INFO_STATUS], np.asarray(b.info)[:, INFO_STATUS]
    )  # identical accept/reject trace


def test_sharded_time_iterations_refuses_chunked():
    """Chunked wall-clock iteration timing is a loud ValueError on the
    sharded engines (a silent no-op must not survive); the 'device' mode
    needs GPU kernel events in the trace and refuses without them."""
    problem, shape = _problem()
    opts = Options(
        solver_type=SolverType.LEVENBERG_MARQUARDT,
        convergence_handle=ConvergenceHandle(0.0, 0.0),
        iteration_handle=IterationHandle(2),
        reduced_system="cg",
        cg_max_iterations=10,
        cg_tolerance=1e-8,
        time_iterations=True,
    )
    with pytest.raises(ValueError, match="time_iterations"):
        solve_sharded_pm(problem, shape, opts, num_shards=2)

    from bundle_adjustment_solver.parallel.sharded_ba import (
        solve_sharded,
    )

    with pytest.raises(ValueError, match="time_iterations"):
        solve_sharded(problem, shape, opts, num_shards=2)

    opts_dev = opts.replace(time_iterations="device")
    with pytest.raises(RuntimeError, match="GPU"):
        solve_sharded_pm(problem, shape, opts_dev, num_shards=2)


class TestShardedServingPath:
    """Serving path: device-side layout build +
    warm-topology PMLayoutCache refill, mesh-placed, under the sharded PM
    engine. A multi-chip SLAM deployment re-solving the same observation
    graph per frame must ship only raw value columns per shard."""

    def _arrays(self, seed=11):
        prob = corridor_ba_problem(
            num_poses=16, num_points=600, window=4, seed=seed,
            num_fixed_poses=2,
        )
        fixed = np.zeros(16, bool)
        fixed[prob.fixed_pose_ids] = True
        return prob, fixed

    def _opts(self):
        return Options(
            solver_type=SolverType.LEVENBERG_MARQUARDT,
            convergence_handle=ConvergenceHandle(0.0, 0.0),
            iteration_handle=IterationHandle(6),
            reduced_system="cg",
            cg_max_iterations=25,
        )

    def test_device_build_matches_host_build(self):
        """sharded_pm_problem_from_arrays(layout='device') solved on the
        mesh == the host-built pm_from_finalized route."""
        from bundle_adjustment_solver.parallel.sharded_pm import (
            sharded_pm_problem_from_arrays,
        )

        prob, fixed = self._arrays()
        opts = self._opts()
        res = sharded_pm_problem_from_arrays(
            prob.cameras, prob.poses_initial, prob.points_initial,
            prob.obs_camera, prob.obs_pose, prob.obs_point, prob.obs_pixel,
            fixed_pose_mask=fixed, num_shards=4, layout="device",
        )
        assert res is not None
        problem_d, shape_d, pm_d, pshape_d = res
        a, _ = solve_sharded_pm(
            problem_d, shape_d, opts, num_shards=4,
            pm_and_shape=(pm_d, pshape_d),
        )
        problem_h, shape_h = _problem()
        b, _ = solve_sharded_pm(problem_h, shape_h, opts, num_shards=4)
        # The device build produces bit-identical planes, so the whole
        # solve trajectory matches exactly.
        np.testing.assert_array_equal(
            np.asarray(a.poses_world_to_camera),
            np.asarray(b.poses_world_to_camera),
        )
        np.testing.assert_array_equal(
            np.asarray(a.points), np.asarray(b.points)
        )

    def test_sharded_refill_matches_fresh_build(self):
        """cache.refill with new pixel + landmark values, re-solved on the
        mesh, == a fresh device build with those values."""
        from bundle_adjustment_solver.parallel.sharded_pm import (
            sharded_pm_problem_from_arrays,
        )

        prob, fixed = self._arrays()
        opts = self._opts()
        res = sharded_pm_problem_from_arrays(
            prob.cameras, prob.poses_initial, prob.points_initial,
            prob.obs_camera, prob.obs_pose, prob.obs_point, prob.obs_pixel,
            fixed_pose_mask=fixed, num_shards=4, layout="device",
            return_cache=True,
        )
        assert res is not None
        problem, shape, pm, pshape, cache = res
        scale = shape.scale

        rng = np.random.default_rng(3)
        pix2 = prob.obs_pixel + rng.normal(scale=0.2, size=prob.obs_pixel.shape)
        pts2 = prob.points_initial + rng.normal(
            scale=0.01, size=prob.points_initial.shape
        )
        pm2 = cache.refill(
            pm, (pix2 * scale).astype(np.float32),
            (pts2 * scale).astype(np.float32),
        )
        a, _ = solve_sharded_pm(
            problem, shape, opts, num_shards=4, pm_and_shape=(pm2, pshape)
        )

        res2 = sharded_pm_problem_from_arrays(
            prob.cameras, prob.poses_initial, pts2,
            prob.obs_camera, prob.obs_pose, prob.obs_point, pix2,
            fixed_pose_mask=fixed, num_shards=4, layout="device",
        )
        problem_f, shape_f, pm_f, pshape_f = res2
        for name in pm2._fields:
            np.testing.assert_array_equal(
                np.asarray(getattr(pm_f, name)),
                np.asarray(getattr(pm2, name)),
                err_msg=f"plane {name}: sharded refill != fresh build",
            )
        b, _ = solve_sharded_pm(
            problem_f, shape_f, opts, num_shards=4,
            pm_and_shape=(pm_f, pshape_f),
        )
        np.testing.assert_array_equal(
            np.asarray(a.poses_world_to_camera),
            np.asarray(b.poses_world_to_camera),
        )

    def test_block_misalignment_refused(self):
        """A layout built without pad_blocks_to=num_shards must be refused
        loudly, not wrapped incorrectly. A shard count coprime to the
        layout's block count always exists among {3, 5, 7} (num_blocks
        would have to be a multiple of 105 to divide by all three), so
        the refusal branch is exercised on EVERY run -- the old version
        skipped whenever the default padding happened to align."""
        from bundle_adjustment_solver.solvers.full_ba_pm import (
            pm_from_finalized,
        )

        problem, shape = _problem()
        pm, pshape = pm_from_finalized(problem, shape, pad_blocks_to=1)
        num_shards = next(
            s for s in (3, 5, 7) if pshape.num_blocks % s != 0
        )
        with pytest.raises(ValueError, match="pad_blocks_to"):
            solve_sharded_pm(
                problem, shape, self._opts(), num_shards=num_shards,
                pm_and_shape=(pm, pshape),
            )
