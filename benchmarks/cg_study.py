#!/usr/bin/env python
"""Flagship CG-policy study: preconditioner x forcing x warm-start.

Measures on one GPU, at the flagship scale (10k poses / 1M landmarks / 12M
obs unless resized by env), for each CG configuration:
  - wall time of a fixed-LM-iteration solve (thresholds 0) and the resulting
    LM iters/s and obs*iter/s;
  - final RMSE (px) after those LM iterations;
  - per-LM-iteration inner-CG iteration counts (INFO_CG_ITERS telemetry);
  - CG-iterations-to-tolerance (fixed relative tolerance, high cap): the
    preconditioner-quality measurement.

Prints one JSON line per configuration, each naming the device:

    python benchmarks/cg_study.py
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

from bench import _device_fields, solve_device
from bundle_adjustment_solver.options import (
    ConvergenceHandle,
    IterationHandle,
    Options,
    SolverType,
)
from bundle_adjustment_solver.summary import INFO_CG_ITERS
from bundle_adjustment_solver.utils.device import (
    enable_compile_cache,
    require_gpu,
)
from bundle_adjustment_solver.utils.synthetic import corridor_problem_on_device

NUM_POSES = int(os.environ.get("BENCH_POSES", 10_000))
NUM_POINTS = int(os.environ.get("BENCH_POINTS", 1_000_000))
LM_ITERS = int(os.environ.get("BENCH_ITERS", 50))


def build():
    problem, shape, _host, pm, pshape = corridor_problem_on_device(
        NUM_POSES, NUM_POINTS, window=6, seed=123
    )
    return problem, shape, pm, pshape


def run_config(problem, shape, pm, pshape, name, opts, lm_iters, device):
    solve_device("pm", problem, shape, pm, pshape, opts)  # compile + warm
    t0 = time.perf_counter()
    info, rmse, _ = solve_device("pm", problem, shape, pm, pshape, opts)
    elapsed = time.perf_counter() - t0
    cg = np.asarray(info)[:lm_iters, INFO_CG_ITERS].astype(int).tolist()
    rec = dict(
        name=name,
        lm_iters=lm_iters,
        wall_s=elapsed,
        lm_iters_per_s=lm_iters / elapsed,
        obs_iters_per_s=shape.num_observations * lm_iters / elapsed,
        final_rmse_px=float(rmse),
        cg_iters=cg,
        cg_total=int(sum(cg)),
        **device,
    )
    print(json.dumps(rec), flush=True)
    return rec


def main():
    require_gpu()
    enable_compile_cache()
    device = _device_fields()
    problem, shape, pm, pshape = build()

    def mkopts(**kw):
        return Options(
            solver_type=SolverType.LEVENBERG_MARQUARDT,
            convergence_handle=ConvergenceHandle(0.0, 0.0),
            iteration_handle=IterationHandle(LM_ITERS),
            reduced_system="cg",
            **kw,
        )

    # Block-Jacobi on A with a fixed 25-iteration CG budget.
    run_config(
        problem, shape, pm, pshape, "jacobi_fixed25",
        mkopts(cg_max_iterations=25, cg_tolerance=0.0, cg_precond="jacobi"),
        LM_ITERS, device,
    )
    # Schur-Jacobi, same fixed budget (isolates preconditioner cost/benefit).
    run_config(
        problem, shape, pm, pshape, "schur_fixed25",
        mkopts(cg_max_iterations=25, cg_tolerance=0.0,
               cg_precond="schur_jacobi"),
        LM_ITERS, device,
    )
    # CG-to-tolerance: preconditioner quality in iteration counts.
    for pname in ("jacobi", "schur_jacobi"):
        run_config(
            problem, shape, pm, pshape, f"{pname}_tol1e-4_cap100",
            mkopts(cg_max_iterations=100, cg_tolerance=1e-8,
                   cg_precond=pname),  # tol on ||r||^2: 1e-8 => ||r||/||rhs||=1e-4
            LM_ITERS, device,
        )
    # Adaptive forcing (Eisenstat-Walker), with and without warm start.
    run_config(
        problem, shape, pm, pshape, "schur_ew_cap25",
        mkopts(cg_max_iterations=25, cg_tolerance=0.0,
               cg_precond="schur_jacobi", cg_forcing="ew"),
        LM_ITERS, device,
    )
    run_config(
        problem, shape, pm, pshape, "schur_ew_warm_cap25",
        mkopts(cg_max_iterations=25, cg_tolerance=0.0,
               cg_precond="schur_jacobi", cg_forcing="ew",
               cg_warm_start=True),
        LM_ITERS, device,
    )


if __name__ == "__main__":
    main()
