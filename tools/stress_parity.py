#!/usr/bin/env python
"""Randomized point-major vs observation-table parity sweep.

Generates random problem configurations (sizes, windows, fixed sets,
observation dropout, loop closures) and asserts that the point-major engine
matches the observation-table engine's final cost on every one. The unit
tests run the same comparisons on tiny shapes; this sweeps shape variety at
larger sizes, on whatever device JAX selects (a GPU when present).

    python tools/stress_parity.py [num_cases]
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np


def main() -> int:
    n_cases = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    rng = np.random.default_rng(int(sys.argv[2]) if len(sys.argv) > 2 else 20260816)

    from bundle_adjustment_solver.models.problem import (
        finalized_from_arrays,
    )
    from bundle_adjustment_solver.options import (
        ConvergenceHandle,
        IterationHandle,
        Options,
        SolverType,
    )
    from bundle_adjustment_solver.solvers import full_ba
    from bundle_adjustment_solver.solvers.full_ba_pm import solve_pm
    from bundle_adjustment_solver.utils.synthetic import (
        corridor_ba_problem,
    )

    failures = 0
    for case in range(n_cases):
        n_poses = int(rng.integers(8, 60))
        n_points = int(rng.integers(150, 1200))
        window = int(rng.integers(2, min(6, n_poses - 2)))
        n_fixed = int(rng.integers(1, 3))
        drop = float(rng.uniform(0.0, 0.4))
        closures = float(rng.uniform(0.0, 0.03))
        seed = int(rng.integers(0, 10_000))
        # LM only: on ill-conditioned random problems the reduced system
        # can leave CG unconverged at the iteration cap, making the "step"
        # an arbitrary element of the Krylov space -- the trust region
        # bounds the resulting trajectory difference, but raw Gauss-Newton
        # amplifies it into genuinely different (equally valid) descent
        # paths. GN parity is covered by unit tests on well-posed problems.
        solver_type = SolverType.LEVENBERG_MARQUARDT

        prob = corridor_ba_problem(
            num_poses=n_poses, num_points=n_points, window=window,
            seed=seed, num_fixed_poses=n_fixed,
        )
        keep = rng.random(prob.obs_camera.shape[0]) > drop
        obs_pose = prob.obs_pose[keep].copy()
        sel = rng.random(obs_pose.shape[0]) < closures
        obs_pose[sel] = (obs_pose[sel] + n_poses // 2) % n_poses
        # Rewiring can create duplicate (point, pose, cam) triples; the PM
        # layout correctly refuses those (two residuals vs one plane cell),
        # so dedupe to keep exercising the point-major engine.
        obs_cam_k = prob.obs_camera[keep]
        obs_point_k = prob.obs_point[keep]
        triple = (obs_point_k.astype(np.int64) * (n_poses * 2)
                  + obs_pose.astype(np.int64) * 2 + obs_cam_k)
        _, uniq_idx = np.unique(triple, return_index=True)
        uniq = np.zeros(obs_pose.shape[0], bool)
        uniq[uniq_idx] = True
        fixed = np.zeros(n_poses, bool)
        fixed[prob.fixed_pose_ids] = True
        fixed_pt = rng.random(n_points) < rng.uniform(0, 0.1)
        problem, shape = finalized_from_arrays(
            prob.cameras, prob.poses_initial, prob.points_initial,
            obs_cam_k[uniq], obs_pose[uniq], obs_point_k[uniq],
            prob.obs_pixel[keep][uniq], fixed_pose_mask=fixed,
            fixed_point_mask=fixed_pt,
        )
        # Enough iterations to converge: mid-trajectory GN paths diverge
        # transiently between engines (no trust region to damp step
        # differences); parity is defined at the optimum.
        opts = Options(
            solver_type=solver_type,
            convergence_handle=ConvergenceHandle(0.0, 0.0),
            iteration_handle=IterationHandle(20),
            reduced_system="cg", cg_max_iterations=60, cg_tolerance=1e-10,
        )
        s_ref, _ = full_ba.solve(problem, shape, opts)
        s_pm, _ = solve_pm(problem, shape, opts)
        c_ref = float(s_ref.final_cost)
        c_pm = float(s_pm.final_cost)
        rel = abs(c_pm - c_ref) / max(abs(c_ref), 1e-6)
        # Heavily-outliered random problems are nonconvex: tiny step
        # perturbations can land the two engines in different basins, both
        # valid LM outcomes. Accept when costs agree OR the point-major engine
        # found an equal-or-better minimum.
        ok = rel < 2e-2 or c_pm <= c_ref * 1.001
        print(
            f"case {case}: N={n_poses} M={n_points} w={window} drop={drop:.2f}"
            f" lc={closures:.3f} {solver_type.name[:2]}"
            f" ref={c_ref:.4f} pm={c_pm:.4f} rel={rel:.2e}"
            f" {'OK' if ok else 'MISMATCH'}"
        )
        failures += 0 if ok else 1

    # STRICT sweep: noise-free, well-conditioned cases (no dropout, no
    # loop-closure rewiring, mild perturbations). These are effectively
    # convex around the noise-free optimum -- a unique global minimum both
    # engines MUST hit, so the equal-or-better escape hatch above does not
    # apply and agreement is demanded tightly. This keeps the tool's
    # bug-finding power after the nonconvex-case loosening (commit 6c4e1ca).
    for case in range(n_cases):
        n_poses = int(rng.integers(8, 60))
        n_points = int(rng.integers(150, 1200))
        window = int(rng.integers(2, min(6, n_poses - 2)))
        n_fixed = int(rng.integers(1, 3))
        seed = int(rng.integers(0, 10_000))
        prob = corridor_ba_problem(
            num_poses=n_poses, num_points=n_points, window=window,
            seed=seed, num_fixed_poses=n_fixed,
            point_error=0.05, pose_translation_error=0.01,
        )
        fixed = np.zeros(n_poses, bool)
        fixed[prob.fixed_pose_ids] = True
        problem, shape = finalized_from_arrays(
            prob.cameras, prob.poses_initial, prob.points_initial,
            prob.obs_camera, prob.obs_pose, prob.obs_point, prob.obs_pixel,
            fixed_pose_mask=fixed,
        )
        opts = Options(
            solver_type=SolverType.LEVENBERG_MARQUARDT,
            convergence_handle=ConvergenceHandle(0.0, 0.0),
            iteration_handle=IterationHandle(25),
            reduced_system="cg", cg_max_iterations=60, cg_tolerance=1e-10,
        )
        s_ref, _ = full_ba.solve(problem, shape, opts)
        s_pm, _ = solve_pm(problem, shape, opts)
        c_ref = float(s_ref.final_cost)
        c_pm = float(s_pm.final_cost)
        rmse_ref = float(s_ref.final_rmse_px)
        rmse_pm = float(s_pm.final_rmse_px)
        rel = abs(c_pm - c_ref) / max(abs(c_ref), 1e-6)
        # Noise-free problems converge to the f32 rounding floor, where
        # per-observation residuals are ~1e-7 of the scaled pixel values
        # and RELATIVE cost agreement is ill-conditioned. Strict = BOTH
        # engines below a milli-pixel RMSE (vs a ~10-100 px initial
        # misalignment -- 4+ orders of magnitude of agreed convergence),
        # or tight relative cost agreement away from the floor.
        at_floor = rmse_ref < 1e-3 and rmse_pm < 1e-3
        ok = at_floor or (rel < 1e-3 and rmse_pm < 0.02 and rmse_ref < 0.02)
        print(
            f"strict {case}: N={n_poses} M={n_points} w={window}"
            f" ref={c_ref:.6f} pm={c_pm:.6f} rel={rel:.2e}"
            f" rmse_px=({rmse_ref:.5f},{rmse_pm:.5f})"
            f" {'OK' if ok else 'MISMATCH'}"
        )
        failures += 0 if ok else 1

    print(f"{2 * n_cases - failures}/{2 * n_cases} cases match")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
