#!/usr/bin/env python
"""Time-to-solution benchmark: wall time for a full converged BA solve.

Complements bench.py (fixed-work throughput) with the number users feel:
seconds from problem-on-device to a converged solution, per engine and
problem size, on one GPU (it refuses to run without one).

    python benchmarks/convergence.py            # both engines, two sizes
    python benchmarks/convergence.py --quick    # small size only
"""

import argparse
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--quick", action="store_true")
    parser.add_argument("--iters", type=int, default=30)
    args = parser.parse_args()

    import jax
    import numpy as np

    from bundle_adjustment_solver.utils.device import (
        enable_compile_cache,
        gpu_name_and_power_limit,
        require_gpu,
    )

    require_gpu()
    enable_compile_cache()

    from bundle_adjustment_solver.models.problem import (
        finalized_from_arrays,
    )
    from bundle_adjustment_solver.options import (
        ConvergenceHandle,
        IterationHandle,
        Options,
        SolverType,
    )
    from bundle_adjustment_solver.solvers import full_ba, full_ba_pm
    from bundle_adjustment_solver.utils.synthetic import (
        corridor_ba_problem,
    )

    sizes = [(2000, 200_000)]
    if not args.quick:
        sizes.append((10_000, 1_000_000))

    opts = Options(
        solver_type=SolverType.LEVENBERG_MARQUARDT,
        convergence_handle=ConvergenceHandle(1e-8, 1e-8),
        iteration_handle=IterationHandle(args.iters),
        reduced_system="cg",
        cg_max_iterations=25,
        cg_tolerance=1e-6,
    )
    dev = jax.devices()[0]
    rows = []
    for n_poses, n_points in sizes:
        prob = corridor_ba_problem(
            num_poses=n_poses, num_points=n_points, window=6, seed=123
        )
        fixed = np.zeros(n_poses, bool)
        fixed[prob.fixed_pose_ids] = True
        problem, shape, host = finalized_from_arrays(
            prob.cameras, prob.poses_initial, prob.points_initial,
            prob.obs_camera, prob.obs_pose, prob.obs_point, prob.obs_pixel,
            fixed_pose_mask=fixed, return_host=True,
        )
        problem = jax.device_put(problem, dev)

        # Point-major engine.
        t0 = time.perf_counter()
        pm, pshape = full_ba_pm.pm_from_finalized(problem, shape, host=host)
        layout_s = time.perf_counter() - t0
        pm = jax.device_put(pm, dev)

        def run_pm():
            out = full_ba_pm._solve_pm_jax(
                pm, pshape, problem.rig, problem.R_cw, problem.t_cw,
                problem.opt_pose_idx, opts,
            )
            return float(out[7]), float(out[8]), int(out[4])

        run_pm()  # compile
        t0 = time.perf_counter()
        cost, rmse, iters = run_pm()
        pm_s = time.perf_counter() - t0
        rows.append(dict(
            engine="point-major", poses=n_poses, points=n_points,
            obs=shape.num_observations, solve_s=round(pm_s, 3),
            layout_s=round(layout_s, 2), lm_iters=iters,
            rmse_px=round(rmse, 6),
        ))
        print(rows[-1])

        # Observation-table engine.
        def run_cg():
            state = full_ba._solve_jax(problem, shape, opts, "cg")
            return (float(state.final_cost), float(state.final_rmse_px),
                    int(state.num_iterations))

        run_cg()
        t0 = time.perf_counter()
        cost, rmse, iters = run_cg()
        cg_s = time.perf_counter() - t0
        rows.append(dict(
            engine="obs-table", poses=n_poses, points=n_points,
            obs=shape.num_observations, solve_s=round(cg_s, 3),
            layout_s=0.0, lm_iters=iters, rmse_px=round(rmse, 6),
        ))
        print(rows[-1])

    print(json.dumps({"time_to_solution": rows,
                      "card": gpu_name_and_power_limit()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
