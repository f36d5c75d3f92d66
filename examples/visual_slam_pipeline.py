#!/usr/bin/env python
"""End-to-end visual-SLAM-style pipeline on the bundle-adjustment engine.

A compact tour of everything a user of the reference C++ solver
(ChanghyeonKim93/bundle_adjustment_solver) would reach for, in one runnable
script:

  1. synthesize a stereo sequence (the reference's test_ba workload shape);
  2. triangulate initial landmarks from stereo disparity (the reference's
     test_projection_of_3d_point math, ops/triangulation.py);
  3. track one frame with pose-only BA (mono + stereo entry points, and the
     batched variant the reference lacks);
  4. refine everything with full bundle adjustment through the registration
     API (reference README walkthrough), printing the BriefReport table;
  5. large problems: bulk construction + the point-major engine, and
     (on a multi-device mesh) the sharded solver.

Run on CPU (deterministic):
    JAX_PLATFORMS=cpu PYTHONPATH= python examples/visual_slam_pipeline.py
or on a GPU: python examples/visual_slam_pipeline.py
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np

import bundle_adjustment_solver as ba
from bundle_adjustment_solver.ops.triangulation import triangulate_stereo
from bundle_adjustment_solver.options import (
    ConvergenceHandle,
    IterationHandle,
    Options,
    OutlierHandle,
    SolverType,
)
from bundle_adjustment_solver.solvers import pose_only
from bundle_adjustment_solver.utils.synthetic import (
    mono_pose_only_problem,
    stereo_ba_problem,
)


def main() -> int:
    rng = np.random.default_rng(7)

    # -- 1. synthetic stereo sequence (test_ba.cpp workload shape) ----------
    prob = stereo_ba_problem(seed=7)
    fx, fy, cx, cy = 525.0, 525.0, 320.0, 240.0
    baseline = 0.12
    print(
        f"sequence: {prob.poses_true.shape[0]} stereo frames, "
        f"{prob.points_true.shape[0]} landmarks, "
        f"{prob.obs_pixel.shape[0]} observations"
    )

    # -- 2. stereo triangulation sanity (test_projection_of_3d_point) -------
    # Take the first frame's left/right pixel pair for one landmark and
    # recover its camera-frame depth from disparity.
    f0 = prob.obs_pose == 0
    left0 = f0 & (prob.obs_camera == 0)
    right0 = f0 & (prob.obs_camera == 1)
    common = np.intersect1d(prob.obs_point[left0], prob.obs_point[right0])[:5]
    li = {p: i for i, p in zip(np.nonzero(left0)[0], prob.obs_point[left0])}
    ri = {p: i for i, p in zip(np.nonzero(right0)[0], prob.obs_point[right0])}
    pix_l = np.stack([prob.obs_pixel[li[p]] for p in common])
    pix_r = np.stack([prob.obs_pixel[ri[p]] for p in common])
    X_cam = np.asarray(
        triangulate_stereo(pix_l, pix_r, fx, fy, cx, cy, baseline)
    )
    print(f"triangulated {len(common)} landmarks; depths {X_cam[:, 2].round(2)}")

    # -- 3. pose-only tracking (motion-only BA) ------------------------------
    mono = mono_pose_only_problem(num_points=5000, seed=1)
    opts = Options(
        convergence_handle=ConvergenceHandle(1e-6, 1e-6),
        outlier_handle=OutlierHandle(1.0, 2.5),
        iteration_handle=IterationHandle(100),
    )
    pose, inliers, summary, ok = pose_only.solve_monocular_6dof(
        mono.points, mono.pixels, mono.intrinsics, mono.pose_initial, opts
    )
    err = np.linalg.norm(pose[:3, 3] - mono.pose_true[:3, 3])
    print(f"pose-only track: ok={ok} inliers={int(inliers.sum())} "
          f"translation error {err:.2e} m")

    # -- 4. full bundle adjustment through the registration API -------------
    solver = ba.FullBundleAdjustmentSolver()
    for i, cam in enumerate(prob.cameras):
        solver.add_camera(i, cam)
    for j in range(prob.poses_initial.shape[0]):
        solver.add_pose(j, prob.poses_initial[j])
    for i in range(prob.points_initial.shape[0]):
        solver.add_point(i, prob.points_initial[i])
    for j in prob.fixed_pose_ids:
        solver.make_pose_fixed(j)
    solver.add_observations(
        prob.obs_camera, list(prob.obs_pose), list(prob.obs_point),
        prob.obs_pixel,
    )
    print(solver.get_solver_statistics())
    for line in solver.check_connectivity():
        print("warning:", line)
    summary = solver.solve(
        Options(
            solver_type=SolverType.LEVENBERG_MARQUARDT,
            convergence_handle=ConvergenceHandle(1e-7, 1e-7),
            iteration_handle=IterationHandle(60),
        )
    )
    print(summary.brief_report())
    pose_err = np.abs(
        solver.get_all_poses()[:, :3, 3] - prob.poses_true[:, :3, 3]
    ).max()
    print(f"full BA: rmse {summary.final_reprojection_rmse_px:.5f} px, "
          f"max pose error {pose_err:.4f} m")

    # -- 5. large problems: direct arrays -> point-major engine -------------
    # The serving path: skip the sorted observation table entirely
    # (pm_problem_from_arrays) and keep the layout/pm tables resident for
    # repeated solves. bench.py runs this at 10k poses / 1M landmarks.
    import jax

    from bundle_adjustment_solver.models.problem import (
        finalized_from_arrays,
    )
    from bundle_adjustment_solver.solvers import full_ba_pm
    from bundle_adjustment_solver.utils.synthetic import (
        corridor_ba_problem,
    )

    big = corridor_ba_problem(num_poses=60, num_points=4000, window=5, seed=3)
    fixed = np.zeros(60, bool)
    fixed[big.fixed_pose_ids] = True
    pm_opts = Options(
        solver_type=SolverType.LEVENBERG_MARQUARDT,
        convergence_handle=ConvergenceHandle(1e-7, 1e-7),
        iteration_handle=IterationHandle(30),
        reduced_system="cg",
        cg_max_iterations=25,
        cg_forcing="ew",
    )
    problem_pm, shape_pm, pm, pshape, cache = (
        full_ba_pm.pm_problem_from_arrays(
            big.cameras, big.poses_initial, big.points_initial,
            big.obs_camera, big.obs_pose, big.obs_point, big.obs_pixel,
            fixed_pose_mask=fixed, layout="device", return_cache=True,
        )
    )
    state, pm_summary = full_ba_pm.solve_pm(
        problem_pm, shape_pm, pm_opts, pm_and_shape=(pm, pshape)
    )
    print(
        f"point-major engine: {shape_pm.num_observations} obs, "
        f"rmse {float(state.final_rmse_px):.5f} px in "
        f"{int(state.num_iterations)} LM iterations"
    )

    # Warm-topology re-solve (every SLAM frame): same observation graph,
    # new measurements -- PMLayoutCache.refill re-gathers just the value
    # planes (no host fill, no re-sort).
    rng2 = np.random.default_rng(11)
    pix_next = big.obs_pixel + rng2.normal(
        scale=0.2, size=big.obs_pixel.shape
    )
    pm_next = cache.refill(
        pm, (pix_next * shape_pm.scale).astype(np.float32)
    )
    state2, _ = full_ba_pm.solve_pm(
        problem_pm, shape_pm, pm_opts, pm_and_shape=(pm_next, pshape)
    )
    print(
        f"warm-topology re-solve (refilled planes): rmse "
        f"{float(state2.final_rmse_px):.5f} px"
    )

    # Multi-device mesh (pose-sharded distributed engine): runs on however
    # many devices are visible (8 virtual CPU devices under the test rig).
    if len(jax.devices()) > 1:
        from bundle_adjustment_solver.parallel.sharded_pm import (
            solve_sharded_pm,
        )

        problem_f, shape_f = finalized_from_arrays(
            big.cameras, big.poses_initial, big.points_initial,
            big.obs_camera, big.obs_pose, big.obs_point, big.obs_pixel,
            fixed_pose_mask=fixed,
        )
        n_sh = min(4, len(jax.devices()))
        state_sh, _ = solve_sharded_pm(
            problem_f, shape_f, pm_opts, num_shards=n_sh
        )
        print(
            f"sharded over {n_sh} devices: rmse "
            f"{float(state_sh.final_rmse_px):.5f} px (matches single-device "
            f"to f32 reduction order)"
        )

    print("done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
