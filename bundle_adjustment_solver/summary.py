"""Per-iteration optimization records and the BriefReport text table.

Reference parity: Summary / OptimizationInfo / BriefReport
(core/solver_option_and_summary.h:37-93, core/solver_option_and_summary.cpp:12-84).

The JAX solvers run their whole iteration loop inside `lax.while_loop`, so
per-iteration telemetry is carried as fixed-size device arrays (one row per
iteration, padded to max_num_iterations) and converted to this host-side
`Summary` once, after the solve returns -- zero host round-trips per iteration.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from .options import IterationStatus

TEXT_RED = lambda s: f"\033[0;31m{s}\033[0m"
TEXT_GREEN = lambda s: f"\033[0;32m{s}\033[0m"
TEXT_YELLOW = lambda s: f"\033[0;33m{s}\033[0m"
TEXT_BLUE = lambda s: f"\033[0;34m{s}\033[0m"
TEXT_MAGENTA = lambda s: f"\033[0;35m{s}\033[0m"
TEXT_CYAN = lambda s: f"\033[0;36m{s}\033[0m"


@dataclasses.dataclass
class OptimizationInfo:
    """One iteration row (core/solver_option_and_summary.h:37-46)."""

    cost: float = -1.0
    cost_change: float = -1.0
    average_reprojection_error: float = -1.0
    abs_gradient: float = -1.0
    abs_step: float = -1.0
    damping_term: float = -1.0
    iter_time: float = -1.0
    iteration_status: IterationStatus = IterationStatus.UNDEFINED
    # Extra (not in the reference, whose reduced solve is a dense LDLT):
    # inner-CG iterations spent by this LM iteration (0 for dense/GD modes).
    cg_iterations: int = 0


# Column layout of the device-side info buffer filled by the solvers.
INFO_COST = 0
INFO_COST_CHANGE = 1
INFO_AVG_REPROJ = 2
INFO_ABS_STEP = 3
INFO_ABS_GRADIENT = 4
INFO_DAMPING = 5
INFO_STATUS = 6
INFO_CG_ITERS = 7
INFO_NUM_COLS = 8


@dataclasses.dataclass
class Summary:
    """Host-side solve summary (core/solver_option_and_summary.h:74-93)."""

    optimization_info_list: List[OptimizationInfo] = dataclasses.field(
        default_factory=list
    )
    max_iteration: int = 0
    total_time_in_millisecond: float = 0.0
    threshold_step_size: float = 0.0
    threshold_cost_change: float = 0.0
    convergence_status: bool = False
    # Extra (not in the reference): final unscaled reprojection RMSE in pixels.
    final_reprojection_rmse_px: float = float("nan")

    @staticmethod
    def from_device_buffers(
        info: np.ndarray,  # (max_iter, INFO_NUM_COLS)
        num_iterations: int,
        converged: bool,
        max_iteration: int,
        threshold_step_size: float,
        threshold_cost_change: float,
        total_time_ms: float,
        iter_times_ms: np.ndarray | None = None,
        final_rmse_px: float = float("nan"),
    ) -> "Summary":
        summary = Summary(
            max_iteration=max_iteration,
            total_time_in_millisecond=total_time_ms,
            threshold_step_size=threshold_step_size,
            threshold_cost_change=threshold_cost_change,
            convergence_status=bool(converged),
            final_reprojection_rmse_px=float(final_rmse_px),
        )
        info = np.asarray(info)
        # With Options.record_history=False the buffer holds one row (the
        # reference's summary==nullptr mode): report only what exists.
        n = min(int(num_iterations), info.shape[0])
        for i in range(n):
            row = info[i]
            summary.optimization_info_list.append(
                OptimizationInfo(
                    cost=float(row[INFO_COST]),
                    cost_change=float(row[INFO_COST_CHANGE]),
                    average_reprojection_error=float(row[INFO_AVG_REPROJ]),
                    abs_step=float(row[INFO_ABS_STEP]),
                    abs_gradient=float(row[INFO_ABS_GRADIENT]),
                    damping_term=float(row[INFO_DAMPING]),
                    # A device-clock trace may yield fewer marker events
                    # than LM iterations (dropped/truncated profiler
                    # events); report -1 for the uncovered tail rather
                    # than crash a completed solve.
                    iter_time=(
                        float(iter_times_ms[i])
                        if iter_times_ms is not None and i < len(iter_times_ms)
                        else -1.0
                    ),
                    iteration_status=IterationStatus(int(row[INFO_STATUS])),
                    cg_iterations=int(row[INFO_CG_ITERS]),
                )
            )
        return summary

    def get_total_time_in_second(self) -> float:
        return self.total_time_in_millisecond * 1e-3

    def brief_report(self) -> str:
        """Ceres-style text table (core/solver_option_and_summary.cpp:12-84)."""
        lines = []
        header = (
            "itr   total_cost   avg.reproj.  cost_change  |step|   |gradient| "
            " damp_term  itr_time[ms] itr_stat"
        )
        lines.append(header)
        for i, info in enumerate(self.optimization_info_list):
            status = {
                IterationStatus.UPDATE: "UPDATE",
                IterationStatus.SKIPPED: TEXT_YELLOW(" SKIP "),
                IterationStatus.UPDATE_TRUST_MORE: TEXT_GREEN("UPDATE"),
            }.get(info.iteration_status, "")
            lines.append(
                f"{i:3d}  {info.cost:.6e}    {info.average_reprojection_error:.2e}"
                f"    {info.cost_change:.2e}   {info.abs_step:.2e}"
                f"   {info.abs_gradient:.2e}    {info.damping_term:.2e}"
                f"   {info.iter_time:.2e}     {status}"
            )
        n = len(self.optimization_info_list)
        lines.append("Analytic Solver Report:")
        lines.append(f"  Iterations      : {n}")
        lines.append(
            f"  Total time      : {self.total_time_in_millisecond * 1e-3:.5g} [second]"
        )
        if n:
            first = self.optimization_info_list[0]
            last = self.optimization_info_list[-1]
            lines.append(f"  Initial cost    : {first.cost:.5g}")
            lines.append(f"  Final cost      : {last.cost:.5g}")
            lines.append(
                f"  Initial reproj. : {first.average_reprojection_error:.5g} [pixel]"
            )
            lines.append(
                f"  Final reproj.   : {last.average_reprojection_error:.5g} [pixel]"
            )
        if not np.isnan(self.final_reprojection_rmse_px):
            lines.append(
                f"  Final RMSE      : {self.final_reprojection_rmse_px:.5g} [pixel,"
                " unscaled]"
            )
        verdict = (
            TEXT_GREEN("CONVERGENCE")
            if self.convergence_status
            else TEXT_YELLOW("NO_CONVERGENCE")
        )
        lines.append(f", Termination     : {verdict}")
        if self.max_iteration == n:
            lines.append(
                TEXT_YELLOW(
                    " WARNING: MAX ITERATION is reached ! The solution could be"
                    " local minima."
                )
            )
        return "\n".join(lines) + "\n"
