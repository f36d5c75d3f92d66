"""Camera models for the bundle-adjustment engine.

Re-design of the reference camera types:
  - `_BA_Camera` (core/full_bundle_adjustment_solver.h:92-107): pinhole
    intrinsics (fx, fy, cx, cy) plus a rigid extrinsic `pose_this_to_cam0`
    that maps points expressed in the rig reference (cam0 / body) frame into
    this camera's frame.
  - `visual_navigation::Camera` (core/type_defines.h:9-52): app-facing float
    camera (the reference version has a missing-return bug in its intrinsics
    getter, type_defines.cpp:21 -- not reproduced here).

Instead of per-camera C++ objects, cameras are packed into a `CameraRig`
struct-of-arrays pytree (K cameras), so per-observation camera parameters are
a single gather inside the fused residual kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass
class Camera:
    """A single pinhole camera in a (possibly multi-camera) rig.

    ``R_cam_from_ref`` / ``t_cam_from_ref`` map points from the rig-reference
    (cam0) frame to this camera's frame: ``X_cam = R @ X_ref + t``. This is the
    reference's `pose_this_to_cam0` (core/full_bundle_adjustment_solver.h:100,
    test/test_ba.cpp:97 sets it to `left_to_right_pose.inverse()`).
    """

    fx: float
    fy: float
    cx: float
    cy: float
    R_cam_from_ref: np.ndarray | None = None  # (3, 3); identity if None
    t_cam_from_ref: np.ndarray | None = None  # (3,); zeros if None

    def __post_init__(self):
        if self.R_cam_from_ref is None:
            self.R_cam_from_ref = np.eye(3)
        if self.t_cam_from_ref is None:
            self.t_cam_from_ref = np.zeros(3)
        self.R_cam_from_ref = np.asarray(self.R_cam_from_ref, dtype=np.float64)
        self.t_cam_from_ref = np.asarray(self.t_cam_from_ref, dtype=np.float64)


def stereo_rig(
    fx: float,
    fy: float,
    cx: float,
    cy: float,
    baseline: float,
) -> tuple[Camera, Camera]:
    """Build the canonical horizontal stereo pair used by the reference tests.

    Matches test/test_ba.cpp:79-98: identical intrinsics, right camera offset
    by ``baseline`` along +x of the left camera, so
    ``X_right = X_left - [baseline, 0, 0]``.
    """
    left = Camera(fx, fy, cx, cy)
    right = Camera(
        fx, fy, cx, cy, np.eye(3), np.array([-baseline, 0.0, 0.0])
    )
    return left, right


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class CameraRig:
    """K cameras packed as struct-of-arrays (a JAX pytree).

    Intrinsics and extrinsic translations may be pre-scaled by the problem's
    scale conditioner (reference: AddCamera,
    core/full_bundle_adjustment_solver.cpp:72-85).
    """

    fx: jax.Array  # (K,)
    fy: jax.Array  # (K,)
    cx: jax.Array  # (K,)
    cy: jax.Array  # (K,)
    R_cam_from_ref: jax.Array  # (K, 3, 3)
    t_cam_from_ref: jax.Array  # (K, 3)

    @staticmethod
    def from_cameras(
        cameras: Sequence[Camera], scale: float = 1.0, dtype=jnp.float32
    ) -> "CameraRig":
        """Pack cameras, applying the scale conditioner to fx/fy/cx/cy and the
        extrinsic translation exactly as the reference does at AddCamera time
        (core/full_bundle_adjustment_solver.cpp:74-79)."""
        fx = jnp.asarray([c.fx * scale for c in cameras], dtype=dtype)
        fy = jnp.asarray([c.fy * scale for c in cameras], dtype=dtype)
        cx = jnp.asarray([c.cx * scale for c in cameras], dtype=dtype)
        cy = jnp.asarray([c.cy * scale for c in cameras], dtype=dtype)
        R = jnp.asarray(
            np.stack([c.R_cam_from_ref for c in cameras]), dtype=dtype
        )
        t = jnp.asarray(
            np.stack([c.t_cam_from_ref * scale for c in cameras]), dtype=dtype
        )
        return CameraRig(fx, fy, cx, cy, R, t)

    @property
    def num_cameras(self) -> int:
        return self.fx.shape[0]

    def gather(self, cam_idx: jax.Array):
        """Per-observation camera parameters: returns (fx, fy, cx, cy, R, t)
        gathered at ``cam_idx`` (O,)."""
        return (
            self.fx[cam_idx],
            self.fy[cam_idx],
            self.cx[cam_idx],
            self.cy[cam_idx],
            self.R_cam_from_ref[cam_idx],
            self.t_cam_from_ref[cam_idx],
        )

    def tree_flatten(self):
        return (
            (self.fx, self.fy, self.cx, self.cy, self.R_cam_from_ref, self.t_cam_from_ref),
            None,
        )

    @classmethod
    def tree_unflatten(cls, aux, children):
        del aux
        return cls(*children)


def project(
    X_cam: jax.Array,
    fx: jax.Array,
    fy: jax.Array,
    cx: jax.Array,
    cy: jax.Array,
) -> jax.Array:
    """Pinhole projection of camera-frame points (..., 3) -> pixels (..., 2).

    Matches the reference projection (core/full_bundle_adjustment_solver.cpp:758-759).
    """
    inv_z = 1.0 / X_cam[..., 2]
    u = fx * X_cam[..., 0] * inv_z + cx
    v = fy * X_cam[..., 1] * inv_z + cy
    return jnp.stack([u, v], axis=-1)
