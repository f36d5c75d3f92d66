"""Abstract solver interface + factory.

Reference parity: the `programming_pattern/` design sketch -- a pure-virtual
`FullBundleAdjustmentSolver` interface with Register*/Fix*/Solve methods and
factory-style instantiation of pluggable backends
(programming_pattern/full_bundle_adjustment_solver.h:9-25,
programming_pattern/main_factory_pattern.cpp:8). Here the two registered
backends are the analytic engine and the autodiff oracle.
"""

from __future__ import annotations

import abc

import numpy as np


class BundleAdjustmentSolverInterface(abc.ABC):
    """The pluggable-solver interface (programming_pattern parity)."""

    @abc.abstractmethod
    def register_camera(self, camera_index, camera): ...

    @abc.abstractmethod
    def register_world_to_body_pose(self, pose_id, pose): ...

    @abc.abstractmethod
    def register_world_point(self, point_id, point): ...

    @abc.abstractmethod
    def fix_registered_pose(self, pose_id): ...

    @abc.abstractmethod
    def fix_registered_point(self, point_id): ...

    @abc.abstractmethod
    def add_point_observation(self, camera_index, pose_id, point_id, pixel): ...

    @abc.abstractmethod
    def solve(self, options): ...


class _OracleBackend(BundleAdjustmentSolverInterface):
    """Autodiff oracle behind the common interface (the 'ceres' analogue of
    programming_pattern's second implementation)."""

    def __init__(self):
        from .models.problem import FullBundleAdjustmentSolver

        self._builder = FullBundleAdjustmentSolver()

    def register_camera(self, camera_index, camera):
        self._builder.add_camera(camera_index, camera)

    def register_world_to_body_pose(self, pose_id, pose):
        self._builder.add_pose(pose_id, pose)

    def register_world_point(self, point_id, point):
        self._builder.add_point(point_id, point)

    def fix_registered_pose(self, pose_id):
        self._builder.make_pose_fixed(pose_id)

    def fix_registered_point(self, point_id):
        self._builder.make_point_fixed(point_id)

    def add_point_observation(self, camera_index, pose_id, point_id, pixel):
        self._builder.add_observation(camera_index, pose_id, point_id, pixel)

    def solve(self, options):
        from .solvers.oracle import full_ba_oracle

        reg = self._builder.export_registration()
        # Oracle cannot constrain never-observed free points.
        observed = np.zeros(reg["points"].shape[0], dtype=bool)
        observed[reg["obs_point"]] = True
        poses, points, cost = full_ba_oracle(
            reg["cameras"],
            reg["poses"],
            reg["points"],
            reg["obs_cam"],
            reg["obs_pose"],
            reg["obs_point"],
            reg["obs_pixel"],
            fixed_pose_mask=reg["fixed_pose_mask"],
            fixed_point_mask=reg["fixed_point_mask"] | ~observed,
            max_nfev=options.iteration_handle.max_num_iterations,
        )
        self._builder.set_solution(poses, points)
        return cost

    def get_pose(self, pose_id):
        return self._builder.get_pose(pose_id)

    def get_point(self, point_id):
        return self._builder.get_point(point_id)


def create_solver(backend: str = "analytic") -> BundleAdjustmentSolverInterface:
    """Factory (programming_pattern/main_factory_pattern.cpp:8):
    'analytic' -> the analytic engine; 'oracle' -> the autodiff stand-in."""
    if backend == "analytic":
        from .models.problem import FullBundleAdjustmentSolver

        return FullBundleAdjustmentSolver()  # implements the same surface
    if backend == "oracle":
        return _OracleBackend()
    raise ValueError(f"unknown solver backend: {backend!r}")


BundleAdjustmentSolverInterface.register(
    __import__(
        "bundle_adjustment_solver.models.problem",
        fromlist=["FullBundleAdjustmentSolver"],
    ).FullBundleAdjustmentSolver
)
