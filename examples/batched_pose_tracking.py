#!/usr/bin/env python
"""Production-style batched pose tracking: thousands of stereo frames per
device launch.

The reference solves one frame per call
(core/pose_only_bundle_adjustment_solver.h:36-49, driven one at a time by
test/test_6dof_stereo_poseonly_ba.cpp); a fleet-scale tracking service has
thousands of independent frames in flight. This example drives the
batched solver (solvers/pose_only.solve_stereo_6dof_batched) in its serving
configuration:

  - `Options.record_history=False` -> the reference's summary==nullptr
    mode; history buffers collapse to one row (the batched fast path);
  - one launch solves every frame in lockstep, each frame freezing at its
    own convergence point.

Run on CPU:  JAX_PLATFORMS=cpu python examples/batched_pose_tracking.py
             (64 frames x 128 points)
Run on GPU:  python examples/batched_pose_tracking.py   (2048 x 256)
"""

import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def main() -> int:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from bundle_adjustment_solver.options import (
        ConvergenceHandle,
        IterationHandle,
        Options,
        OutlierHandle,
    )
    from bundle_adjustment_solver.solvers import pose_only
    from bundle_adjustment_solver.utils.synthetic import (
        batched_stereo_pose_only_problem,
    )

    from bundle_adjustment_solver.utils.device import on_gpu

    B, P = (2048, 256) if on_gpu() else (64, 128)
    prob = batched_stereo_pose_only_problem(
        num_frames=B, points_per_frame=P, seed=42,
        pixel_noise=0.3, drop_right_frac=0.1,
    )

    opts = Options(
        convergence_handle=ConvergenceHandle(1e-6, 1e-6),
        outlier_handle=OutlierHandle(1.0, 2.5),
        iteration_handle=IterationHandle(50),
        record_history=False,  # serving mode: no per-iteration telemetry
    )

    args = (
        jax.device_put(jnp.asarray(prob.points, jnp.float32)),
        jax.device_put(jnp.asarray(prob.pixels_left, jnp.float32)),
        jax.device_put(jnp.asarray(prob.pixels_right, jnp.float32)),
        jnp.ones((B, P), bool),
        jnp.asarray(prob.intrinsics, jnp.float32),
        jnp.asarray(prob.intrinsics, jnp.float32),
        jnp.asarray(prob.pose_left_to_right, jnp.float32),
        jnp.asarray(prob.poses_initial, jnp.float32),
    )

    # --compact: straggler-compaction driver (solve_*_batched_compacting)
    # -- retires converged frames between 8-iteration segments instead of
    # paying full lockstep passes until the LAST frame converges (most
    # frame-passes are wasted on mixed batches, benchmarks/straggler_study.py).
    compact = "--compact" in sys.argv

    def solve():
        if compact:
            return pose_only.solve_stereo_6dof_batched_compacting(*args, opts)
        return pose_only.solve_stereo_6dof_batched(*args, opts)

    res = solve()  # compile
    t0 = time.perf_counter()
    res = jax.block_until_ready(solve())
    dt = time.perf_counter() - t0

    poses = np.asarray(res.pose)
    t_err = np.linalg.norm(
        poses[:, :3, 3] - prob.poses_true[:, :3, 3], axis=-1
    )
    iters = np.asarray(res.num_iterations)
    mode = "compacting" if compact else "lockstep"
    print(f"{B} frames x {P} points, warm {mode} solve: {dt * 1e3:.1f} ms")
    print(
        f"success {int(np.asarray(res.success).sum())}/{B}, "
        f"converged {int(np.asarray(res.converged).sum())}/{B}, "
        f"iterations p50={int(np.median(iters))} max={int(iters.max())}"
    )
    print(
        f"translation error: median {np.median(t_err):.2e} m, "
        f"p99 {np.quantile(t_err, 0.99):.2e} m"
    )
    print(
        f"inlier fraction: left {np.asarray(res.mask_inlier).mean():.3f}, "
        f"right {np.asarray(res.mask_inlier_right).mean():.3f}"
    )
    assert bool(np.asarray(res.success).all())
    assert np.median(t_err) < 5e-3
    return 0


if __name__ == "__main__":
    sys.exit(main())
