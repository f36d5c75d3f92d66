"""App-facing scalar/handle type aliases.

Reference parity: core/type_defines.h:9-52 (`Pose`, `Point`, `Pixel` float32
aliases and the app-level camera) and the per-solver numeric typedef blocks
(full_bundle_adjustment_solver.h:34-107). In this JAX build these are numpy /
JAX array conventions rather than Eigen typedefs; the canonical shapes are
documented here and re-exported for user code.
"""

from __future__ import annotations

import numpy as np

# User-facing conventions (float64 on the host, float32 on device):
#   Pose  -- (4, 4) homogeneous rigid transform, T_wc (camera -> world)
#   Point -- (3,) world position
#   Pixel -- (2,) image coordinates (u, v)
Pose = np.ndarray
Point = np.ndarray
Pixel = np.ndarray


def make_pose(rotation: np.ndarray, translation: np.ndarray) -> Pose:
    """Assemble a (4, 4) pose from (3, 3) R and (3,) t."""
    T = np.eye(4)
    T[:3, :3] = np.asarray(rotation)
    T[:3, 3] = np.asarray(translation)
    return T


from .models.camera import Camera, CameraRig, stereo_rig  # noqa: E402,F401

__all__ = ["Pose", "Point", "Pixel", "make_pose", "Camera", "CameraRig",
           "stereo_rig"]
