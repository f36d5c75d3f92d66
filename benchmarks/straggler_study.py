#!/usr/bin/env python
"""Lockstep straggler-waste study for the batched pose-only solvers.

Forced-iteration throughput is an upper bound on DELIVERED throughput: the
lockstep loop keeps paying full passes for frames that already converged
(masked out, but computed). This measures, on a mixed-difficulty batch with
REAL convergence thresholds, on one GPU:

  - the per-frame iterations-to-convergence distribution T_f;
  - the wasted-pass fraction: 1 - mean(T_f)/max(T_f) (share of lane-passes
    spent on frozen frames while stragglers finish);
  - wall time of the real-threshold lockstep solve vs the same batch forced
    to exactly max(T_f) iterations (the waste is real only if wall time
    scales with the straggler, which it does -- the loop trips to the last
    unconverged frame);
  - the compaction break-even: re-packing active frames needs a fresh
    dispatch (static shapes) and a mask fetch -- compare its measured cost
    with the device time the compaction would save.

Prints one JSON object (with the card's name and power limit):

    python benchmarks/straggler_study.py
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

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

B = int(os.environ.get("BENCH_FRAMES", 2048))
P = int(os.environ.get("BENCH_FRAME_POINTS", 256))
MAX_ITER = int(os.environ.get("STRAGGLER_MAX_ITER", 100))
# The "never lose" gate: the auto policy's wall must
# stay within this factor of the lockstep wall (best-of-3 both sides). In
# the one-segment regime the driver DELEGATES to the lockstep solver, so
# anything beyond measurement noise is a policy bug.
NEVER_LOSE_BOUND = 1.05


def main():
    from bundle_adjustment_solver.utils.device import (
        device_info,
        enable_compile_cache,
        gpu_name_and_power_limit,
        require_gpu,
    )

    require_gpu()
    enable_compile_cache()
    # Mixed difficulty: per-frame random motion magnitudes (the generator's
    # natural spread) + pixel noise so convergence iteration counts vary.
    prob = batched_stereo_pose_only_problem(
        num_frames=B, points_per_frame=P, seed=29, pixel_noise=0.4
    )
    pts = jax.device_put(jnp.asarray(prob.points, jnp.float32))
    pixl = jax.device_put(jnp.asarray(prob.pixels_left, jnp.float32))
    pixr = jax.device_put(jnp.asarray(prob.pixels_right, jnp.float32))
    valid = jnp.ones((B, P), bool)
    intr = jnp.asarray(prob.intrinsics, jnp.float32)
    T_lr = jnp.asarray(prob.pose_left_to_right, jnp.float32)
    poses0 = jnp.asarray(prob.poses_initial, jnp.float32)

    def opts(thr, n):
        return Options(
            convergence_handle=ConvergenceHandle(thr, thr),
            outlier_handle=OutlierHandle(1.0, 2.5),
            iteration_handle=IterationHandle(n),
            record_history=False,
        )

    def run(o):
        res = pose_only.solve_stereo_6dof_batched(
            pts, pixl, pixr, valid, intr, intr, T_lr, poses0, o
        )
        return jax.block_until_ready(res)

    # Real-threshold solve (reference defaults 1e-5). Best-of-3 walls on
    # both sides of the never-lose comparison, so that host-clock noise
    # does not decide the 1.05x bound below.
    o_real = opts(1e-5, MAX_ITER)
    res = run(o_real)  # compile + warm
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        res = run(o_real)
        walls.append(time.perf_counter() - t0)
    wall_real = min(walls)
    T_f = np.asarray(res.num_iterations).astype(int)
    conv = np.asarray(res.converged)
    T_last = int(T_f.max())
    waste = 1.0 - float(T_f.mean()) / T_last

    # Forced to exactly T_last iterations: isolates the convergence-check
    # cost (identical kernel passes, no early frame freezing semantics).
    o_forced = opts(0.0, T_last)
    run(o_forced)
    t0 = time.perf_counter()
    run(o_forced)
    wall_forced = time.perf_counter() - t0

    # Kernel-side cost model of compaction: after iteration k, only
    # active(k) frames need computing; a perfect compactor would run
    # sum_k active(k)/B of the passes; each re-pack costs a dispatch and
    # a mask fetch against the saved device time:
    active_per_iter = np.array([(T_f > k).sum() for k in range(T_last)])
    perfect_fraction = float(active_per_iter.sum()) / (B * T_last)
    per_iter_ms = wall_real * 1e3 / T_last
    savable_ms = wall_real * 1e3 * (1.0 - perfect_fraction)

    # Compacting driver on the same batch: retires converged frames every
    # check_every iterations and re-packs stragglers into shrinking
    # buckets. Wall time includes the per-segment dispatch+fetch cost; the
    # pass-count reduction is the hardware-independent quantity.
    def run_compacting():
        res = pose_only.solve_stereo_6dof_batched_compacting(
            pts, pixl, pixr, valid, intr, intr, T_lr, poses0, o_real,
            check_every=10, min_bucket=64,
        )
        return jax.block_until_ready(res)

    res_c = run_compacting()  # compile buckets + warm
    t0 = time.perf_counter()
    res_c = run_compacting()
    wall_compact = time.perf_counter() - t0
    T_c = np.asarray(res_c.num_iterations).astype(int)
    # Lane-passes actually paid by the compacting driver: each segment runs
    # bucket_size frames for <= check_every iterations; reconstruct from
    # the retirement schedule implied by T_f (bucket shrinks after each
    # 10-iteration boundary).
    passes = 0
    active = B
    for k in range(0, T_last, 10):
        bucket = max(64, 1 << int(np.ceil(np.log2(max(active, 1)))))
        seg_len = min(10, T_last - k)
        passes += min(bucket, B) * seg_len
        active = int((T_f > k + seg_len).sum())
        if active == 0:
            break

    out = {
        "batch": {"frames": B, "points_per_frame": P,
                  "pixel_noise": 0.4, "threshold": 1e-5},
        "iterations_to_convergence": {
            "min": int(T_f.min()), "p50": int(np.percentile(T_f, 50)),
            "p90": int(np.percentile(T_f, 90)),
            "p99": int(np.percentile(T_f, 99)), "max": T_last,
            "mean": round(float(T_f.mean()), 2),
            "converged_frames": int(conv.sum()),
        },
        "wasted_pass_fraction": round(waste, 4),
        "perfect_compaction_pass_fraction": round(perfect_fraction, 4),
        "wall_s_real_thresholds": round(wall_real, 4),
        "wall_s_forced_to_max": round(wall_forced, 4),
        "lockstep_iters_per_s": round(T_last / wall_real, 1),
        "per_lockstep_iter_ms": round(per_iter_ms, 3),
        "savable_kernel_ms_upper_bound": round(savable_ms, 1),
        "compacting_driver": {
            "wall_s": round(wall_compact, 4),
            "converged_frames": int(np.asarray(res_c.converged).sum()),
            "lane_pass_fraction_vs_lockstep": round(
                passes / (B * T_last), 4
            ),
            "note": (
                "wall includes per-segment dispatch+fetch; the pass "
                "fraction is the hardware-independent work reduction"
            ),
        },
    }

    # Dispatch-aware AUTO policy: check_every="auto" calibrates the
    # dispatch round-trip and the bucket's per-iteration rate, then takes
    # segment boundaries only while their projected savings repay them;
    # when the whole solve cannot repay one boundary it runs pure lockstep,
    # so it never loses to the lockstep solver.
    def run_auto():
        res = pose_only.solve_stereo_6dof_batched_compacting(
            pts, pixl, pixr, valid, intr, intr, T_lr, poses0, o_real,
            check_every="auto", min_bucket=64,
        )
        return jax.block_until_ready(res)  # sync inside the clock

    run_auto()  # compile + warm + one-time calibration (cached)
    walls_a = []
    for _ in range(3):
        t0 = time.perf_counter()
        res_a = run_auto()
        walls_a.append(time.perf_counter() - t0)
    wall_auto = min(walls_a)
    dispatch_ms = pose_only._dispatch_ms()
    out["auto_policy"] = {
        "wall_s": round(wall_auto, 4),
        "vs_lockstep": round(wall_auto / wall_real, 3),
        "measured_dispatch_ms": round(dispatch_ms, 2),
        "converged_frames": int(np.asarray(res_a.converged).sum()),
        "never_lose_bound": NEVER_LOSE_BOUND,
        "never_lose_check": bool(
            wall_auto <= wall_real * NEVER_LOSE_BOUND
        ),
        "note": (
            "best-of-3 walls both sides; bound = auto wall <= "
            f"{NEVER_LOSE_BOUND}x lockstep wall. calibration (two short "
            "solves) is cached per process and excluded by the warm-up, "
            "as in serving"
        ),
    }
    assert out["auto_policy"]["never_lose_check"], (
        f"auto compaction lost to lockstep beyond the {NEVER_LOSE_BOUND}x "
        f"bound: {wall_auto:.3f}s vs {wall_real:.3f}s "
        f"({wall_auto / wall_real:.3f}x)"
    )
    out["device"] = device_info()
    out["card"] = gpu_name_and_power_limit()
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
