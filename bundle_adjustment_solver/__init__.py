"""bundle_adjustment_solver: a JAX bundle-adjustment engine.

Brand-new JAX/XLA re-design of the capabilities of the C++ reference
ChanghyeonKim93/bundle_adjustment_solver: robust reprojection-error
minimization for full BA (SE(3) poses + 3-D landmarks, multi-camera rigs,
Schur-complement LM) and pose-only BA (mono/stereo x 6-DoF/planar-3-DoF),
batched/sharded over device meshes.

Quick start (mirrors the reference README walkthrough):

    import bundle_adjustment_solver as ba

    solver = ba.FullBundleAdjustmentSolver()
    left, right = ba.stereo_rig(fx=525., fy=525., cx=320., cy=240.,
                                baseline=0.12)
    solver.add_camera(0, left)
    solver.add_camera(1, right)
    solver.add_pose(frame_id, T_wc)           # (4, 4) camera->world
    solver.add_point(landmark_id, X)          # (3,)
    solver.make_pose_fixed(frame_id)          # gauge fixing
    solver.add_observation(cam_idx, frame_id, landmark_id, pixel)
    summary = solver.solve(ba.Options(
        solver_type=ba.SolverType.LEVENBERG_MARQUARDT))
    print(summary.brief_report())
    T_opt = solver.get_pose(frame_id)
"""

from .options import (
    ConvergenceHandle,
    IterationHandle,
    IterationStatus,
    Options,
    OutlierHandle,
    SolverType,
    TrustRegionHandle,
)
from .summary import OptimizationInfo, Summary
from .models.camera import Camera, CameraRig, project, stereo_rig
from .models.problem import (
    FinalizedProblem,
    FullBundleAdjustmentSolver,
    ProblemShape,
    finalized_from_arrays,
)
from .interfaces import BundleAdjustmentSolverInterface, create_solver
from .solvers import full_ba, oracle, pose_only
from .types import Pixel, Point, Pose, make_pose

__version__ = "0.1.0"

__all__ = [
    "BundleAdjustmentSolverInterface",
    "Camera",
    "CameraRig",
    "ConvergenceHandle",
    "FinalizedProblem",
    "FullBundleAdjustmentSolver",
    "IterationHandle",
    "IterationStatus",
    "Options",
    "OptimizationInfo",
    "OutlierHandle",
    "Pixel",
    "Point",
    "Pose",
    "ProblemShape",
    "SolverType",
    "Summary",
    "TrustRegionHandle",
    "create_solver",
    "finalized_from_arrays",
    "full_ba",
    "make_pose",
    "oracle",
    "pose_only",
    "project",
    "stereo_rig",
]
