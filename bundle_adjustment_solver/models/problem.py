"""Problem builder: the user-facing registration API for full BA.

Re-design of the reference's pointer-keyed registration
(FullBundleAdjustmentSolver::AddCamera/AddPose/AddPoint/AddObservation/
MakePoseFixed/MakePointFixed, core/full_bundle_adjustment_solver.cpp:72-180;
the refactor's Register* naming, full_bundle_adjustment_solver_refactor.cpp:
69-124) as an id-keyed builder that `finalize()`s into static padded device
arrays -- the connectivity maps (cpp:669-700) dissolve into per-observation
index vectors consumed by `segment_sum`.

The load-bearing scale conditioner is preserved: `scaler = 0.01` multiplies
intrinsics, extrinsic translations, pose translations, point coordinates, and
pixels at registration time (cpp:38-39, 72-180), the trust-region rho uses
1/scaler (cpp:930), and the write-back undoes it (cpp:1010-1022). SURVEY.md §3
flags this as what keeps f32 arithmetic well-behaved.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .camera import Camera, CameraRig


class FinalizedProblem(NamedTuple):
    """Static-shape device arrays for one full-BA problem (a JAX pytree).

    Poses are stored as the solver-internal T_jw = world -> rig-reference
    transform (the INVERSE of the user-registered pose, cpp:96), with
    translations pre-scaled; points and pixels pre-scaled.
    """

    rig: CameraRig
    R_cw: jax.Array  # (N, 3, 3)
    t_cw: jax.Array  # (N, 3) scaled
    points: jax.Array  # (M, 3) scaled
    obs_cam: jax.Array  # (O,) int32
    obs_pose: jax.Array  # (O,) int32 index into N
    obs_point: jax.Array  # (O,) int32 index into M
    obs_pixel: jax.Array  # (O, 2) scaled
    obs_pose_opt: jax.Array  # (O,) int32 in [0, N_opt]; N_opt = fixed sentinel
    obs_point_opt: jax.Array  # (O,) int32 in [0, M_opt]
    obs_valid: jax.Array  # (O,) bool (False for padding rows)
    opt_pose_idx: jax.Array  # (N_opt,) int32: optimization slot -> pose index
    opt_point_idx: jax.Array  # (M_opt,) int32


@dataclasses.dataclass(frozen=True)
class ProblemShape:
    """Static (hashable) problem dimensions, passed as a jit-static arg."""

    num_poses: int
    num_points: int
    num_observations: int
    num_opt_poses: int
    num_opt_points: int
    num_cameras: int
    scale: float

    @property
    def num_fixed_poses(self) -> int:
        return self.num_poses - self.num_opt_poses

    @property
    def num_fixed_points(self) -> int:
        return self.num_points - self.num_opt_points


def finalized_from_arrays(
    cameras,
    poses_world_to_camera: np.ndarray,  # (N, 4, 4)
    points: np.ndarray,  # (M, 3)
    obs_cam: np.ndarray,  # (O,)
    obs_pose: np.ndarray,  # (O,)
    obs_point: np.ndarray,  # (O,)
    obs_pixel: np.ndarray,  # (O, 2)
    fixed_pose_mask: np.ndarray | None = None,  # (N,) bool
    fixed_point_mask: np.ndarray | None = None,  # (M,) bool
    scale: float = 0.01,
    dtype=jnp.float32,
    return_host: bool = False,
):
    """Vectorized bulk construction of a finalized problem.

    The builder below mirrors the reference's one-at-a-time registration
    (AddObservation per pixel, test_ba.cpp:254-274); at millions of
    observations that is a Python-loop bottleneck the reference never faced
    (its max workload is 300k). This is the array-native fast path.

    With ``return_host=True`` also returns the host-side numpy arrays
    (sorted observation table + scaled points + opt-index maps) so layout
    builders (models/layout.py) never read device arrays back to the host.
    """
    N = poses_world_to_camera.shape[0]
    M = points.shape[0]
    if fixed_pose_mask is None:
        fixed_pose_mask = np.zeros(N, dtype=bool)
    if fixed_point_mask is None:
        fixed_point_mask = np.zeros(M, dtype=bool)

    n_opt = int((~fixed_pose_mask).sum())
    m_opt = int((~fixed_point_mask).sum())
    pose_opt_of = np.full(N, n_opt, dtype=np.int32)
    pose_opt_of[~fixed_pose_mask] = np.arange(n_opt, dtype=np.int32)
    point_opt_of = np.full(M, m_opt, dtype=np.int32)
    point_opt_of[~fixed_point_mask] = np.arange(m_opt, dtype=np.int32)

    R_wc = poses_world_to_camera[:, :3, :3]
    t_wc = poses_world_to_camera[:, :3, 3]
    R_cw = np.transpose(R_wc, (0, 2, 1))
    t_cw = -np.einsum("nij,nj->ni", R_cw, t_wc) * scale

    obs_cam = np.asarray(obs_cam, dtype=np.int32)
    obs_pose = np.asarray(obs_pose, dtype=np.int32)
    obs_point = np.asarray(obs_point, dtype=np.int32)
    obs_pixel_raw = np.asarray(obs_pixel, dtype=np.float64)
    obs_pose_opt = pose_opt_of[obs_pose]
    obs_point_opt = point_opt_of[obs_point]

    from ..utils.native import finalize_obs, sort_by_segments

    # Fused native sort+permute of the whole table (pixel scale folded in):
    # one pass instead of an order array + six fancy-index gathers.
    fused = finalize_obs(
        obs_point_opt, obs_pose_opt, obs_cam, obs_pose, obs_point,
        obs_pixel_raw, scale, m_opt + 1, n_opt + 1,
    )
    if fused is not None:
        (obs_cam, obs_pose, obs_point, obs_pixel, obs_pose_opt,
         obs_point_opt) = fused
    else:
        obs_pixel = obs_pixel_raw * scale
        order = sort_by_segments(
            obs_point_opt, obs_pose_opt, m_opt + 1, n_opt + 1
        )
        obs_cam, obs_pose, obs_point = (
            obs_cam[order],
            obs_pose[order],
            obs_point[order],
        )
        obs_pixel = obs_pixel[order]
        obs_pose_opt, obs_point_opt = (
            obs_pose_opt[order], obs_point_opt[order]
        )

    rig = CameraRig.from_cameras(list(cameras), scale=scale, dtype=dtype)
    finalized = FinalizedProblem(
        rig=rig,
        R_cw=jnp.asarray(R_cw, dtype=dtype),
        t_cw=jnp.asarray(t_cw, dtype=dtype),
        points=jnp.asarray(points * scale, dtype=dtype),
        obs_cam=jnp.asarray(obs_cam),
        obs_pose=jnp.asarray(obs_pose),
        obs_point=jnp.asarray(obs_point),
        obs_pixel=jnp.asarray(obs_pixel, dtype=dtype),
        obs_pose_opt=jnp.asarray(obs_pose_opt),
        obs_point_opt=jnp.asarray(obs_point_opt),
        obs_valid=jnp.ones(obs_cam.shape[0], dtype=bool),
        opt_pose_idx=jnp.asarray(
            np.nonzero(~fixed_pose_mask)[0].astype(np.int32)
        ),
        opt_point_idx=jnp.asarray(
            np.nonzero(~fixed_point_mask)[0].astype(np.int32)
        ),
    )
    shape = ProblemShape(
        num_poses=N,
        num_points=M,
        num_observations=obs_cam.shape[0],
        num_opt_poses=n_opt,
        num_opt_points=m_opt,
        num_cameras=len(list(cameras)),
        scale=scale,
    )
    if return_host:
        point_is_opt = ~np.asarray(fixed_point_mask, dtype=bool)
        host = dict(
            obs_pose=obs_pose,
            obs_point=obs_point,
            obs_cam=obs_cam,
            obs_pixel=obs_pixel,
            points=np.asarray(points, dtype=np.float64) * scale,
            pose_opt_of=pose_opt_of,
            point_is_opt=point_is_opt,
        )
        return finalized, shape, host
    return finalized, shape


class FullBundleAdjustmentSolver:
    """Id-keyed full-BA problem builder + solve entry point.

    Mirrors the reference API surface (README.md:14-61):
        add_camera(index, Camera) / add_pose(id, T_wc) / add_point(id, X) /
        make_pose_fixed(id) / make_point_fixed(id) /
        add_observation(camera_index, pose_id, point_id, pixel) /
        solve(options) / get_pose(id) / get_point(id) /
        get_solver_statistics()

    Registration-time validation follows the refactor's throwing behavior
    (full_bundle_adjustment_solver_refactor.cpp:96-158) rather than the
    original's stderr prints.
    """

    def __init__(self, dtype=jnp.float32, scale: float = 0.01):
        self.dtype = dtype
        self.scale = float(scale)  # reference scaler_ = 0.01 (cpp:38)
        self._cameras: dict[int, Camera] = {}
        self._poses: dict[object, np.ndarray] = {}  # id -> T_wc (user frame)
        self._points: dict[object, np.ndarray] = {}
        self._fixed_poses: set = set()
        self._fixed_points: set = set()
        self._obs_cam: list[int] = []
        self._obs_pose: list = []
        self._obs_point: list = []
        self._obs_pixel: list[np.ndarray] = []
        self._finalized: FinalizedProblem | None = None
        self._shape: ProblemShape | None = None
        self._pose_ids: list = []
        self._point_ids: list = []
        self._host: dict | None = None
        self._solved_poses: np.ndarray | None = None
        self._solved_points: np.ndarray | None = None

    # -- registration ------------------------------------------------------

    def add_camera(self, camera_index: int, camera: Camera) -> None:
        """Register a rig camera (reference AddCamera, cpp:72-85)."""
        self._check_not_finalized()
        self._cameras[camera_index] = camera

    def add_pose(self, pose_id, pose_world_to_camera) -> None:
        """Register an optimizable pose given as the user-facing T_wc 4x4
        (reference AddPose, cpp:87-101 -- stores the inverse internally)."""
        self._check_not_finalized()
        if pose_id in self._poses:
            return
        self._poses[pose_id] = np.asarray(pose_world_to_camera, dtype=np.float64)
        self._pose_ids.append(pose_id)

    def add_point(self, point_id, world_point) -> None:
        """Register an optimizable landmark (reference AddPoint, cpp:103-117)."""
        self._check_not_finalized()
        if point_id in self._points:
            return
        self._points[point_id] = np.asarray(world_point, dtype=np.float64)
        self._point_ids.append(point_id)

    def make_pose_fixed(self, pose_id) -> None:
        """Gauge-fix a pose (reference MakePoseFixed, cpp:119-134)."""
        self._check_not_finalized()
        if pose_id not in self._poses:
            raise RuntimeError("There is no such id in the BA pose pool.")
        self._fixed_poses.add(pose_id)

    def make_point_fixed(self, point_id) -> None:
        """Gauge-fix a landmark (reference MakePointFixed, cpp:136-153)."""
        self._check_not_finalized()
        if point_id not in self._points:
            raise RuntimeError("There is no such id in the BA point pool.")
        self._fixed_points.add(point_id)

    def add_observation(self, camera_index: int, pose_id, point_id, pixel) -> None:
        """Register a pixel observation (reference AddObservation, cpp:155-180)."""
        if camera_index not in self._cameras:
            raise RuntimeError("Invalid camera index.")
        if pose_id not in self._poses:
            raise RuntimeError("Nonexistent pose.")
        if point_id not in self._points:
            raise RuntimeError("Nonexistent point.")
        self._obs_cam.append(camera_index)
        self._obs_pose.append(pose_id)
        self._obs_point.append(point_id)
        self._obs_pixel.append(np.asarray(pixel, dtype=np.float64))

    def add_observations(self, camera_indices, pose_ids, point_ids, pixels) -> None:
        """Vectorized bulk registration (no reference analogue; the reference
        loops AddObservation one pixel at a time, test_ba.cpp:254-274)."""
        camera_indices = np.asarray(camera_indices)
        pixels = np.asarray(pixels, dtype=np.float64)
        for k, (c, j, i) in enumerate(zip(camera_indices, pose_ids, point_ids)):
            self.add_observation(int(c), j, i, pixels[k])

    # -- finalize -----------------------------------------------------------

    def _check_not_finalized(self):
        if self._finalized is not None:
            raise RuntimeError(
                "Cannot enroll parameter (problem already finalized)."
            )

    def finalize(self) -> tuple[FinalizedProblem, ProblemShape]:
        """Freeze registration into static device arrays.

        Mirrors FinalizeParameters + SetProblemSize (cpp:182-308): assigns
        dense optimization indices to non-fixed poses/points and packs the
        observation table, sorted by (point_opt, pose_opt) so downstream
        `segment_sum`s see contiguous segments.
        """
        if self._finalized is not None:
            return self._finalized, self._shape
        if not self._obs_cam:
            raise RuntimeError("num_observations < 1")

        scale = self.scale
        pose_index = {pid: k for k, pid in enumerate(self._pose_ids)}
        point_index = {pid: k for k, pid in enumerate(self._point_ids)}

        n = len(self._pose_ids)
        m = len(self._point_ids)

        # Optimization index maps; fixed -> sentinel (N_opt / M_opt).
        opt_pose_ids = [p for p in self._pose_ids if p not in self._fixed_poses]
        opt_point_ids = [p for p in self._point_ids if p not in self._fixed_points]
        n_opt, m_opt = len(opt_pose_ids), len(opt_point_ids)
        pose_opt_of = np.full(n, n_opt, dtype=np.int32)
        for k, pid in enumerate(opt_pose_ids):
            pose_opt_of[pose_index[pid]] = k
        point_opt_of = np.full(m, m_opt, dtype=np.int32)
        for k, pid in enumerate(opt_point_ids):
            point_opt_of[point_index[pid]] = k

        # Internal pose state: T_cw = inverse(T_wc), translation scaled
        # (cpp:96-97).
        T_wc = np.stack([self._poses[pid] for pid in self._pose_ids])
        R_wc = T_wc[:, :3, :3]
        t_wc = T_wc[:, :3, 3]
        R_cw = np.transpose(R_wc, (0, 2, 1))
        t_cw = -np.einsum("nij,nj->ni", R_cw, t_wc) * scale

        points = (
            np.stack([self._points[pid] for pid in self._point_ids]) * scale
        )

        obs_cam = np.asarray(self._obs_cam, dtype=np.int32)
        obs_pose = np.asarray(
            [pose_index[p] for p in self._obs_pose], dtype=np.int32
        )
        obs_point = np.asarray(
            [point_index[p] for p in self._obs_point], dtype=np.int32
        )
        obs_pixel = np.stack(self._obs_pixel) * scale

        obs_pose_opt = pose_opt_of[obs_pose]
        obs_point_opt = point_opt_of[obs_point]

        # Sort by (point_opt, pose_opt) for segment locality (native
        # counting sort when the C library is available).
        from ..utils.native import sort_by_segments

        order = sort_by_segments(obs_point_opt, obs_pose_opt, m_opt + 1, n_opt + 1)
        obs_cam, obs_pose, obs_point = (
            obs_cam[order],
            obs_pose[order],
            obs_point[order],
        )
        obs_pixel = obs_pixel[order]
        obs_pose_opt, obs_point_opt = obs_pose_opt[order], obs_point_opt[order]

        opt_pose_idx = np.asarray(
            [pose_index[p] for p in opt_pose_ids], dtype=np.int32
        )
        opt_point_idx = np.asarray(
            [point_index[p] for p in opt_point_ids], dtype=np.int32
        )

        dtype = self.dtype
        rig = CameraRig.from_cameras(
            [self._cameras[k] for k in sorted(self._cameras)],
            scale=scale,
            dtype=dtype,
        )
        finalized = FinalizedProblem(
            rig=rig,
            R_cw=jnp.asarray(R_cw, dtype=dtype),
            t_cw=jnp.asarray(t_cw, dtype=dtype),
            points=jnp.asarray(points, dtype=dtype),
            obs_cam=jnp.asarray(obs_cam),
            obs_pose=jnp.asarray(obs_pose),
            obs_point=jnp.asarray(obs_point),
            obs_pixel=jnp.asarray(obs_pixel, dtype=dtype),
            obs_pose_opt=jnp.asarray(obs_pose_opt),
            obs_point_opt=jnp.asarray(obs_point_opt),
            obs_valid=jnp.ones(obs_cam.shape[0], dtype=bool),
            opt_pose_idx=jnp.asarray(opt_pose_idx),
            opt_point_idx=jnp.asarray(opt_point_idx),
        )
        shape = ProblemShape(
            num_poses=n,
            num_points=m,
            num_observations=obs_cam.shape[0],
            num_opt_poses=n_opt,
            num_opt_points=m_opt,
            num_cameras=len(self._cameras),
            scale=scale,
        )
        # Host-side copies for layout builders (no device readback; see
        # finalized_from_arrays(return_host=True)).
        self._host = dict(
            obs_pose=obs_pose,
            obs_point=obs_point,
            obs_cam=obs_cam,
            obs_pixel=obs_pixel,
            points=points,
            pose_opt_of=pose_opt_of,
            point_is_opt=point_opt_of < m_opt,
        )
        self._finalized, self._shape = finalized, shape
        return finalized, shape

    # -- solve & results ----------------------------------------------------

    def solve(self, options, summary=None):
        """Run the solver and write results back (reference Solve, cpp:630-1044).

        Returns the host-side Summary; optimized poses/points are readable via
        `get_pose` / `get_point` afterwards (the reference writes back through
        registered pointers, cpp:1010-1022 -- here results are pulled).
        """
        from ..solvers import full_ba  # local import to avoid cycle

        problem, shape = self.finalize()
        result, out_summary = full_ba.solve(
            problem, shape, options, host=self._host
        )
        self._solved_poses = np.asarray(result.poses_world_to_camera)
        self._solved_points = np.asarray(result.points)
        if summary is not None and hasattr(summary, "__dict__"):
            summary.__dict__.update(out_summary.__dict__)
        return out_summary

    def get_pose(self, pose_id) -> np.ndarray:
        """Optimized user-facing T_wc for `pose_id` (post-solve)."""
        if self._solved_poses is None:
            raise RuntimeError("solve() has not been run.")
        idx = self._pose_ids.index(pose_id)
        return self._solved_poses[idx]

    def get_point(self, point_id) -> np.ndarray:
        if self._solved_points is None:
            raise RuntimeError("solve() has not been run.")
        idx = self._point_ids.index(point_id)
        return self._solved_points[idx]

    def get_all_poses(self) -> np.ndarray:
        if self._solved_poses is None:
            raise RuntimeError("solve() has not been run.")
        return self._solved_poses

    def get_all_points(self) -> np.ndarray:
        if self._solved_points is None:
            raise RuntimeError("solve() has not been run.")
        return self._solved_points

    def export_registration(self) -> dict:
        """Registered problem state as dense index arrays (public accessor).

        Alternate backends (e.g. the autodiff oracle behind
        `interfaces.create_solver('oracle')`) consume this instead of
        reaching into builder internals: cameras sorted by index, poses and
        points in registration order, fixed masks, and observation columns
        re-keyed to dense row indices. Pixels/poses/points are UNscaled
        (user units).
        """
        pose_index = {pid: k for k, pid in enumerate(self._pose_ids)}
        point_index = {pid: k for k, pid in enumerate(self._point_ids)}
        return dict(
            cameras=[self._cameras[k] for k in sorted(self._cameras)],
            poses=np.stack([self._poses[p] for p in self._pose_ids]),
            points=np.stack([self._points[p] for p in self._point_ids]),
            fixed_pose_mask=np.asarray(
                [p in self._fixed_poses for p in self._pose_ids], dtype=bool
            ),
            fixed_point_mask=np.asarray(
                [p in self._fixed_points for p in self._point_ids], dtype=bool
            ),
            obs_cam=np.asarray(self._obs_cam, dtype=np.int32),
            obs_pose=np.asarray(
                [pose_index[p] for p in self._obs_pose], dtype=np.int32
            ),
            obs_point=np.asarray(
                [point_index[p] for p in self._obs_point], dtype=np.int32
            ),
            obs_pixel=np.stack(self._obs_pixel),
        )

    def set_solution(self, poses_world_to_camera, points) -> None:
        """Install externally computed results so `get_pose`/`get_point`/
        `get_all_*` read them (the write-back half of the public accessor
        pair; the reference writes through registered pointers,
        cpp:1010-1022)."""
        self._solved_poses = np.asarray(poses_world_to_camera)
        self._solved_points = np.asarray(points)

    # -- refactor-API aliases (reference FullBundleAdjustmentSolverRefactor,
    # full_bundle_adjustment_solver_refactor.h:117-136: Register* naming) ----

    def register_camera(self, camera_index: int, camera: Camera) -> None:
        """Alias of add_camera (refactor.cpp:69-80)."""
        self.add_camera(camera_index, camera)

    def register_world_to_body_pose(self, pose_id, pose) -> None:
        """Alias of add_pose (refactor.cpp:82-101 RegisterWorldToBodyPose)."""
        self.add_pose(pose_id, pose)

    def register_world_point(self, point_id, point) -> None:
        """Alias of add_point (refactor.cpp:103-124 RegisterWorldPoint)."""
        self.add_point(point_id, point)

    def fix_registered_pose(self, pose_id) -> None:
        """Alias of make_pose_fixed (refactor FixRegisteredPose)."""
        self.make_pose_fixed(pose_id)

    def fix_registered_point(self, point_id) -> None:
        """Alias of make_point_fixed (refactor FixRegisteredPosition)."""
        self.make_point_fixed(point_id)

    def add_point_observation(self, camera_index, pose_id, point_id, pixel):
        """Alias of add_observation (programming_pattern/
        full_bundle_adjustment_solver.h:9-25 AddPointObservation)."""
        self.add_observation(camera_index, pose_id, point_id, pixel)

    def solve_by_gradient_descent(self, options, summary=None):
        """Explicit gradient-descent entry (refactor SolveByGradientDescent,
        refactor.cpp:1075-1367: gradient blocks clipped to `gd_step_clip`)."""
        from ..options import SolverType

        return self.solve(
            options.replace(solver_type=SolverType.GRADIENT_DESCENT), summary
        )

    def check_connectivity(
        self, min_points_per_pose: int = 5, min_poses_per_point: int = 2
    ) -> list[str]:
        """Divergence-risk warnings, mirroring CheckPoseAndPointConnectivity
        (full cpp:310-341: a pose seeing < 5 points or a point seen by < 2
        poses may diverge). Unique-pair counts come from the native
        connectivity kernel (csrc/problem_compiler.cpp) when available."""
        from ..utils.native import connectivity

        _, s = self.finalize()
        fin = self._finalized
        ppp, ppt = connectivity(
            np.asarray(fin.obs_pose),
            np.asarray(fin.obs_point),
            s.num_poses,
            s.num_points,
        )
        warnings = []
        for j in np.nonzero(ppp < min_points_per_pose)[0]:
            warnings.append(
                f"{j}-th pose: it might diverge because this frame has "
                f"insufficient related points ({ppp[j]})."
            )
        for i in np.nonzero((ppt > 0) & (ppt < min_poses_per_point))[0]:
            warnings.append(
                f"{i}-th point: it might diverge because this point has "
                f"insufficient related poses ({ppt[i]})."
            )
        return warnings

    def get_solver_statistics(self) -> str:
        """Problem-shape dump (reference GetSolverStatistics, cpp:208-239;
        fixes its Jacobian row-count misprint -- rows are 2 x #obs, not 6 x)."""
        _, s = self.finalize()
        lines = [
            "| Bundle Adjustment Statistics:",
            f"| # cameras in rigid body system: {s.num_cameras}",
            "|   (Note: the rig reference frame is camera 0.)",
            f"|             # of total poses: {s.num_poses}",
            f"|               - # fix  poses: {s.num_fixed_poses}",
            f"|               - # opt. poses: {s.num_opt_poses}",
            f"|            # of total points: {s.num_points}",
            f"|              - # fix  points: {s.num_fixed_points}",
            f"|              - # opt. points: {s.num_opt_points}",
            f"|            # of observations: {s.num_observations}",
            f"|                Jacobian size: {2 * s.num_observations} rows x "
            f"{3 * s.num_opt_points + 6 * s.num_opt_poses} cols",
            f"|                Residual size: {2 * s.num_observations} rows",
        ]
        return "\n".join(lines)
