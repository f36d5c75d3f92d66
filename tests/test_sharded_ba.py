"""Distributed full-BA tests on the 8-virtual-device CPU mesh.

Checks the sharding design of parallel/sharded_ba.py: landmark-aligned
observation sharding, psum'd pose system, sharded CG -- results must match
the single-device solver (same algorithm, same arithmetic up to reduction
order) and be invariant to the shard count (determinism requirement,
SURVEY.md §5 "race detection" note).
"""

import jax
import numpy as np
import pytest

from bundle_adjustment_solver.models.problem import FullBundleAdjustmentSolver
from bundle_adjustment_solver.options import (
    ConvergenceHandle,
    IterationHandle,
    Options,
    SolverType,
)
from bundle_adjustment_solver.parallel.sharded_ba import (
    shard_problem,
    solve_sharded,
)
from bundle_adjustment_solver.utils.synthetic import stereo_ba_problem

from tests.test_full_ba import build_solver, pose_errors


def cg_options(max_iter=60, thr=1e-6):
    return Options(
        solver_type=SolverType.LEVENBERG_MARQUARDT,
        convergence_handle=ConvergenceHandle(thr, thr),
        iteration_handle=IterationHandle(max_iter),
        reduced_system="cg",
        cg_max_iterations=200,
        cg_tolerance=1e-12,
        # Pinned (the default is 'ew'): these invariance tests isolate
        # SHARDING effects, and adaptive forcing derives its inner
        # tolerance from ||rhs||, whose f32 value varies with the psum
        # reduction order -- near convergence that flips one CG/LM
        # iteration across shard counts and moves the (near-zero) final
        # cost by more than the tolerance here. Deterministic-forcing
        # convention as in the other parity-calibrated tests.
        cg_forcing="fixed",
    )


@pytest.fixture(scope="module")
def problem():
    return stereo_ba_problem(num_poses=16, num_fixed_poses=3, seed=21)


@pytest.fixture(scope="module")
def finalized(problem):
    solver = build_solver(problem)
    return solver.finalize()


class TestShardPartition:
    def test_partition_covers_everything(self, finalized):
        fin, shape = finalized
        sharded, sshape = shard_problem(fin, shape, 8)
        assert sshape.num_shards == 8
        # Every true observation appears exactly once across shards.
        valid = np.asarray(sharded.obs_valid)
        assert valid.sum() == shape.num_observations
        # Every point id appears exactly once (padding uses sentinel M).
        gidx = np.asarray(sharded.point_global).reshape(-1)
        real = gidx[gidx < shape.num_points]
        assert len(real) == shape.num_points
        assert len(np.unique(real)) == shape.num_points
        # Observations are aligned: each shard's obs reference only local
        # points.
        for s in range(8):
            v = np.asarray(sharded.obs_valid[s])
            local_pt = np.asarray(sharded.obs_point_local[s])[v]
            assert local_pt.max(initial=0) < sshape.points_per_shard

    def test_balance(self, finalized):
        fin, shape = finalized
        sharded, sshape = shard_problem(fin, shape, 8)
        counts = np.asarray(sharded.obs_valid).sum(axis=1)
        # Greedy contiguous balancing: no shard more than 2x the mean.
        assert counts.max() <= 2.0 * counts.mean() + 1


class TestShardedSolve:
    def test_matches_single_device(self, problem, finalized):
        fin, shape = finalized
        opts = cg_options()
        state, summary, points = solve_sharded(fin, shape, opts, num_shards=8)
        assert summary.convergence_status
        assert summary.final_reprojection_rmse_px < 0.05

        # Single-device reference run (same CG algorithm).
        single = build_solver(problem)
        sum_single = single.solve(opts)
        rot_s, trans_s = pose_errors(single.get_all_poses(), problem.poses_true)
        rot_d, trans_d = pose_errors(
            np.asarray(state.poses_world_to_camera), problem.poses_true
        )
        assert rot_d.max() < max(2 * rot_s.max(), 1e-4)
        assert trans_d.max() < max(2 * trans_s.max(), 1e-3)

        # Observed landmark recovery in user order.
        observed = np.unique(problem.obs_point)
        pt_err = np.linalg.norm(
            points[observed] - problem.points_true[observed], axis=-1
        )
        assert np.median(pt_err) < 5e-3

    def test_shard_count_invariance(self, finalized):
        """Same problem on 2 vs 8 shards: same final cost (determinism across
        shardings, the device-mesh analogue of race-freedom)."""
        fin, shape = finalized
        opts = cg_options(max_iter=20)
        s2, sum2, pts2 = solve_sharded(fin, shape, opts, num_shards=2)
        s8, sum8, pts8 = solve_sharded(fin, shape, opts, num_shards=8)
        # f32 + different psum reduction orders: agreement is to rounding
        # noise amplified over ~20 LM iterations, not bitwise.
        assert abs(float(s2.final_cost) - float(s8.final_cost)) <= 0.05 * max(
            float(s2.final_cost), 1e-6
        )
        np.testing.assert_allclose(pts2, pts8, atol=1e-3)
        np.testing.assert_allclose(
            np.asarray(s2.poses_world_to_camera),
            np.asarray(s8.poses_world_to_camera),
            atol=1e-3,
        )
