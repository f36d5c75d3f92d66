"""Solver options, per-iteration records and summaries.

Mirrors the reference's Options / Summary / OptimizationInfo / SolverType /
IterationStatus (core/solver_option_and_summary.h:25-93) with the same nested
handles and defaults, re-shaped for JAX: `Options` is a frozen (hashable)
dataclass so it can be passed as a static argument to jitted solvers, and the
per-iteration info lives in fixed-size arrays filled inside `lax.while_loop`
(the reference appends to a std::vector per iteration,
core/full_bundle_adjustment_solver.cpp:983-1003).
"""

from __future__ import annotations

import dataclasses
import enum


class SolverType(enum.Enum):
    """Reference parity: SolverType (core/solver_option_and_summary.h:25-30)."""

    UNDEFINED = -1
    GRADIENT_DESCENT = 0
    GAUSS_NEWTON = 1
    LEVENBERG_MARQUARDT = 2


class IterationStatus(enum.IntEnum):
    """Reference parity: IterationStatus (core/solver_option_and_summary.h:31-36)."""

    UNDEFINED = -1
    UPDATE = 0
    UPDATE_TRUST_MORE = 1
    SKIPPED = 2


@dataclasses.dataclass(frozen=True)
class ConvergenceHandle:
    threshold_step_size: float = 1e-5
    threshold_cost_change: float = 1e-5


@dataclasses.dataclass(frozen=True)
class OutlierHandle:
    threshold_huber_loss: float = 1.0  # pixels
    threshold_outlier_rejection: float = 2.0  # pixels


@dataclasses.dataclass(frozen=True)
class IterationHandle:
    max_num_iterations: int = 50


@dataclasses.dataclass(frozen=True)
class TrustRegionHandle:
    initial_lambda: float = 100.0
    decrease_ratio_lambda: float = 0.33
    increase_ratio_lambda: float = 3.0
    # Hard-coded in the reference; surfaced as config per SURVEY.md §5:
    threshold_update: float = 0.25  # rho above this -> accept step (full cpp:933-941)
    threshold_trust_more: float = 0.5  # rho above this -> shrink lambda (cpp:947)
    min_lambda: float = 1e-10  # lambda clamp (full cpp:948-953)
    max_lambda: float = 100.0


@dataclasses.dataclass(frozen=True)
class Options:
    """Reference parity: Options defaults (core/solver_option_and_summary.h:47-72).

    Extra knobs beyond the reference:
      - ``reduced_system``: 'dense' materializes the Schur complement S and
        solves it with Cholesky (reference semantics, full cpp:890-908);
        'cg' runs matrix-free block-preconditioned conjugate gradients on S
        (required beyond ~1k poses); 'pm' runs the point-major engine
        (solvers/full_ba_pm.py); 'auto' picks by problem size and device
        (solvers/full_ba._resolve_mode).
      - ``cg_max_iterations`` / ``cg_tolerance``: inner-CG controls.
      - ``gd_step_clip``: per-block step clip of the gradient-descent mode
        (reference refactor hard-codes 0.001,
        core/full_bundle_adjustment_solver_refactor.cpp:1276-1283).
    """

    solver_type: SolverType = SolverType.GAUSS_NEWTON
    convergence_handle: ConvergenceHandle = ConvergenceHandle()
    outlier_handle: OutlierHandle = OutlierHandle()
    iteration_handle: IterationHandle = IterationHandle()
    trust_region_handle: TrustRegionHandle = TrustRegionHandle()

    reduced_system: str = "auto"  # 'dense' | 'cg' | 'pm' | 'auto'
    cg_max_iterations: int = 100
    cg_tolerance: float = 1e-8
    # Preconditioner of the reduced-system CG. 'jacobi' (default) is the
    # block-diagonal of the damped A. 'schur_jacobi' uses the diagonal
    # blocks of the exact Schur complement S = A - B Cinv B^T, emitted with
    # the point-major assembly (21 more pose-system columns to scatter; one
    # extra observation pass in the observation-table engine). On the
    # 10k/1M corridor flagship it is iteration-neutral (high covisibility:
    # each landmark shared by `window` poses, so diag(S) ~ diag(A)); prefer
    # it on low-covisibility problems, where the correction approaches A_jj
    # and cuts CG iterations.
    cg_precond: str = "jacobi"  # 'jacobi' | 'schur_jacobi'
    # Inner-CG termination. 'ew' (default) derives the tolerance per LM
    # iteration with an Eisenstat-Walker choice-2 forcing sequence
    # (eta_k = gamma (||rhs_k|| / ||rhs_{k-1}||)^2, clamped to
    # [cg_forcing_min, cg_forcing_max]) so early LM iterations -- whose
    # linearization a tight solve cannot help -- terminate CG in a handful
    # of iterations, the standard inexact-Newton policy for BA
    # (benchmarks/cg_study.py compares it with 'fixed'). 'fixed' uses
    # cg_tolerance as a constant relative ||r||^2 / ||rhs||^2 threshold
    # (plus the cg_max_iterations cap), the deterministic-budget mode.
    cg_forcing: str = "ew"  # 'fixed' | 'ew'
    cg_forcing_max: float = 0.1  # eta upper clamp (also the first iteration)
    cg_forcing_min: float = 1e-3  # eta lower clamp
    # Start CG from the previous LM iteration's solution instead of 0 (costs
    # one extra matvec for the initial residual; pays when consecutive
    # reduced systems are similar -- e.g. retries after a rejected step).
    cg_warm_start: bool = False
    gd_step_clip: float = 0.001
    # 'reference' reproduces the reference's cost: sum of residual L2 norms
    # (full cpp:427, a quirk -- the quadratic model is in squared units);
    # 'squared' uses the robust squared cost.
    cost_metric: str = "reference"
    # Storage dtype of the Schur coupling blocks U in the point-major
    # engine. 'bfloat16' halves the matvec's U traffic (for a
    # bandwidth-bound matvec at very large M; it costs a slightly higher
    # convergence floor from the ~0.4% step perturbation).
    coupling_dtype: str = "float32"
    # Reporting mode for the reference's per-iteration `iter_time` (full
    # cpp:981-992 / pose_only cpp:126, printed by BriefReport):
    #   True     -- dispatch the loop one iteration at a time and wall-clock
    #               each dispatch (obs-table, point-major, and all four
    #               pose-only solvers); includes per-dispatch overhead.
    #   "device" -- (point-major engines, GPU) run the whole solve in ONE
    #               dispatch under a profiler trace and report DEVICE time
    #               per LM iteration, from the starts of consecutive
    #               `pm_assemble` scopes on the GPU (utils/profiling.py);
    #               raises when the trace holds no GPU events.
    #   False    -- production mode: whole loop on device, iter_time -1
    #               like the reference with a null summary.
    time_iterations: bool | str = False
    # Record per-iteration info rows and the debug-pose trace (pose-only
    # solvers). False mirrors the reference's `summary == nullptr` mode
    # (pose_only cpp:128-147: no OptimizationInfo is pushed): history
    # buffers shrink to one row, which removes the per-iteration masked
    # selects + dynamic-update-slices on the BATCHED solvers' (frames,
    # max_iter, .) carries.
    record_history: bool = True
    # Pose-only inlier-mask semantics. 'final' (default) reports the mask of
    # the final evaluated iteration; 'reference' reproduces the reference's
    # sticky accumulation from iteration 0 (pose_only cpp:95-98: a point
    # flagged outlier at ANY iteration -- including under the coarse initial
    # guess -- stays flagged).
    outlier_mask: str = "final"

    def __post_init__(self):
        # The solvers compare time_iterations == "device" exactly; reject
        # near-miss strings ('Device', 'dev') that would otherwise fall
        # through `if timed:` into chunked wall-clock mode silently.
        if not isinstance(self.time_iterations, bool) and (
            self.time_iterations != "device"
        ):
            raise ValueError(
                "time_iterations must be False, True, or 'device'; got "
                f"{self.time_iterations!r}"
            )

    def replace(self, **kwargs) -> "Options":
        return dataclasses.replace(self, **kwargs)
