"""Seeded synthetic problem generators -- the reusable fixture library.

The reference generates synthetic data ad hoc inside each test `main()` with
non-reproducible `std::random_device` seeding (test/test_ba.cpp:110-111);
here the same workloads are promoted to seeded, reusable generators
(SURVEY.md §4 "Implication for the rebuild").

Workloads reproduced:
  - `frustum_cloud` / `mono_pose_only_problem`: the 300k-point monocular
    pose-only benchmark (test/test_compare_ceres_vs_native.cpp:21-99).
  - `landmark_wall`: the planar landmark grid (test/test_ba.cpp:53-77).
  - `stereo_ba_problem`: the full stereo BA problem -- arc trajectory,
    stereo rig, visibility culling, perturbed initials
    (test/test_ba.cpp:100-274), with configurable pose/landmark counts so the
    same generator scales to the 10k-pose / 1M-landmark target (BASELINE.json).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..models.camera import Camera, stereo_rig


# Observation-chunk size of corridor_ba_problem's projection pass: bounds
# the per-observation gather temporaries (~420 MB/chunk of f64) without
# changing any value (the pass is elementwise per observation row).
_PROJECTION_CHUNK = 2_000_000


def _rotz(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def _roty(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])


def _T(R, t):
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = t
    return T


def frustum_cloud(
    num_points: int,
    rng: np.random.Generator,
    x_dev: float = 1.7,
    y_dev: float = 1.3,
    z_default: float = 1.2,
    z_dev: float = 5.0,
) -> np.ndarray:
    """Random points in a camera frustum (test_compare_ceres_vs_native.cpp:32-47)."""
    x = rng.uniform(-x_dev, x_dev, num_points)
    y = rng.uniform(-y_dev, y_dev, num_points)
    z = rng.uniform(0.0, z_dev, num_points) + z_default
    return np.stack([x, y, z], axis=-1)


@dataclasses.dataclass
class MonoPoseOnlyProblem:
    points: np.ndarray  # (P, 3) world points
    pixels: np.ndarray  # (P, 2) observed pixels in the current frame
    intrinsics: np.ndarray  # (4,) fx, fy, cx, cy
    pose_true: np.ndarray  # (4, 4) true world<-current pose (T_wc)
    pose_initial: np.ndarray  # (4, 4) initial guess


def mono_pose_only_problem(
    num_points: int = 300_000,
    seed: int = 0,
    pixel_noise: float = 0.0,
    fx: float = 338.0,
    fy: float = 338.0,
    cx: float = 320.0,
    cy: float = 240.0,
) -> MonoPoseOnlyProblem:
    """The 300k-point monocular 6-DoF benchmark problem
    (test_compare_ceres_vs_native.cpp:73-111): true pose rotated -0.5 rad
    about +y, translated (0.2, 0.3, -1.9); identity initial guess."""
    rng = np.random.default_rng(seed)
    pose_true = _T(_roty(-0.5), np.array([0.2, 0.3, -1.9]))
    points = frustum_cloud(num_points, rng)

    T_cw = np.linalg.inv(pose_true)
    local = points @ T_cw[:3, :3].T + T_cw[:3, 3]
    inv_z = 1.0 / local[:, 2]
    pixels = np.stack(
        [fx * local[:, 0] * inv_z + cx, fy * local[:, 1] * inv_z + cy], axis=-1
    )
    if pixel_noise > 0:
        pixels = pixels + rng.normal(0.0, pixel_noise, pixels.shape)
    return MonoPoseOnlyProblem(
        points=points,
        pixels=pixels,
        intrinsics=np.array([fx, fy, cx, cy]),
        pose_true=pose_true,
        pose_initial=np.eye(4),
    )


def landmark_wall(
    x_nominal: float = 8.5,
    y_range: tuple[float, float] = (0.0, 26.0),
    z_range: tuple[float, float] = (1.7, 5.7),
    y_step: float = 0.4,
    z_step: float = 0.4,
) -> np.ndarray:
    """Planar landmark grid at x = x_nominal (test/test_ba.cpp:53-77)."""
    ys = np.arange(y_range[0], y_range[1] + 1e-9, y_step)
    zs = np.arange(z_range[0], z_range[1] + 1e-9, z_step)
    zz, yy = np.meshgrid(zs, ys, indexing="ij")
    xx = np.full_like(yy, x_nominal)
    return np.stack([xx.ravel(), yy.ravel(), zz.ravel()], axis=-1)


@dataclasses.dataclass
class StereoBAProblem:
    """A full stereo BA problem in builder-ready form."""

    cameras: list  # [Camera] (left, right)
    poses_true: np.ndarray  # (N, 4, 4) true T_wc (world<-ref-camera)
    poses_initial: np.ndarray  # (N, 4, 4) perturbed T_wc
    points_true: np.ndarray  # (M, 3)
    points_initial: np.ndarray  # (M, 3) perturbed
    fixed_pose_ids: np.ndarray  # (F,) indices of gauge-fixed poses
    obs_camera: np.ndarray  # (O,) camera index per observation
    obs_pose: np.ndarray  # (O,) pose index
    obs_point: np.ndarray  # (O,) point index
    obs_pixel: np.ndarray  # (O, 2)


def corridor_ba_problem(
    num_poses: int,
    num_points: int,
    window: int = 6,
    seed: int = 0,
    point_error: float = 0.3,
    pose_translation_error: float = 0.05,
    pixel_noise: float = 0.0,
    fx: float = 525.0,
    fy: float = 525.0,
    cx: float = 320.0,
    cy: float = 240.0,
    baseline: float = 0.12,
    num_fixed_poses: int = 2,
) -> StereoBAProblem:
    """Scalable 'corridor' stereo BA generator, fully vectorized.

    The camera travels along +y looking at a wall at x = 5 (same viewing
    geometry as test_ba.cpp but with bounded co-visibility): landmark i is
    anchored to a pose and observed by `window` consecutive poses through
    both cameras, so #observations = 2 * window * num_points independent of
    trajectory length. This is the 10k-pose / 1M-landmark workload shape
    (BASELINE.json "map-block partition") that the reference's dense N x M
    storage cannot represent (SURVEY.md §6).
    """
    rng = np.random.default_rng(seed)
    left, right = stereo_rig(fx, fy, cx, cy, baseline)
    cam_R = np.stack([left.R_cam_from_ref, right.R_cam_from_ref])
    cam_t = np.stack([left.t_cam_from_ref, right.t_cam_from_ref])

    # Camera mounted looking along +x of the base (test_ba.cpp:134-139).
    R_bc = _roty(np.pi / 2) @ _rotz(-np.pi / 2)
    y_step = 0.2
    t_wb = np.stack(
        [
            np.full(num_poses, -4.0),
            -2.5 + y_step * np.arange(num_poses),
            np.zeros(num_poses),
        ],
        axis=-1,
    )
    R_wc = np.broadcast_to(R_bc, (num_poses, 3, 3))
    poses_true = np.zeros((num_poses, 4, 4))
    poses_true[:, :3, :3] = R_wc
    poses_true[:, :3, 3] = t_wb
    poses_true[:, 3, 3] = 1.0

    # Landmarks on a wall at x ~ 5, spread along the trajectory.
    anchor = rng.integers(0, max(num_poses - window, 1), num_points)
    pts = np.stack(
        [
            rng.uniform(4.0, 7.0, num_points),
            t_wb[anchor, 1] + rng.uniform(0.0, window * y_step, num_points),
            rng.uniform(-1.5, 1.5, num_points),
        ],
        axis=-1,
    )

    # Observations: point i seen from poses anchor..anchor+window-1, 2 cams.
    obs_point = np.repeat(np.arange(num_points, dtype=np.int32), window)
    obs_pose = (
        anchor.astype(np.int32)[:, None] + np.arange(window, dtype=np.int32)
    ).reshape(-1)
    obs_pose = np.minimum(obs_pose, num_poses - 1)
    obs_point = np.concatenate([obs_point, obs_point])
    obs_pose = np.concatenate([obs_pose, obs_pose])
    obs_camera = np.concatenate(
        [
            np.zeros(num_points * window, dtype=np.int32),
            np.ones(num_points * window, dtype=np.int32),
        ]
    )

    # Project through the true geometry (vectorized, in observation chunks:
    # the per-observation R/t/X gathers would otherwise materialize ~5 GB
    # of f64 temporaries at 24M observations. Chunking is bit-identical --
    # every op below is elementwise per observation row).
    R_cw = np.transpose(poses_true[:, :3, :3], (0, 2, 1))
    t_cw = -np.einsum("nij,nj->ni", R_cw, poses_true[:, :3, 3])
    O = obs_pose.shape[0]
    obs_pixel = np.empty((O, 2), dtype=np.float64)
    chunk = _PROJECTION_CHUNK
    for s in range(0, O, chunk):
        e = min(s + chunk, O)
        jp, ip, cp = obs_pose[s:e], obs_point[s:e], obs_camera[s:e]
        local = np.einsum("oij,oj->oi", R_cw[jp], pts[ip]) + t_cw[jp]
        local = np.einsum("oij,oj->oi", cam_R[cp], local) + cam_t[cp]
        inv_z = 1.0 / local[:, 2]
        obs_pixel[s:e, 0] = fx * local[:, 0] * inv_z + cx
        obs_pixel[s:e, 1] = fy * local[:, 1] * inv_z + cy
    if pixel_noise > 0:
        obs_pixel = obs_pixel + rng.normal(0, pixel_noise, obs_pixel.shape)

    poses_initial = poses_true.copy()
    poses_initial[num_fixed_poses:, :3, 3] += rng.uniform(
        -pose_translation_error,
        pose_translation_error,
        (num_poses - num_fixed_poses, 3),
    )
    points_initial = pts + rng.uniform(-point_error, point_error, pts.shape)

    return StereoBAProblem(
        cameras=[left, right],
        poses_true=poses_true,
        poses_initial=poses_initial,
        points_true=pts,
        points_initial=points_initial,
        fixed_pose_ids=np.arange(num_fixed_poses),
        obs_camera=obs_camera,
        obs_pose=obs_pose,
        obs_point=obs_point,
        obs_pixel=obs_pixel,
    )


def stereo_ba_problem(
    num_poses: int = 60,
    num_fixed_poses: int = 5,
    seed: int = 42,
    pixel_noise: float = 0.0,
    point_error: float = 0.5,
    pose_translation_error: float = 0.1,
    image_width: int = 640,
    image_height: int = 480,
    landmarks: np.ndarray | None = None,
    fx: float = 525.0,
    fy: float = 525.0,
    cx: float = 320.0,
    cy: float = 240.0,
    baseline: float = 0.12,
) -> StereoBAProblem:
    """The test_ba synthetic stereo problem (test/test_ba.cpp:100-274).

    Trajectory: base frame starts at (-4, -2.5, 0) with -0.1 rad yaw and per
    frame advances yaw +0.005, x +0.005, y +0.2 (cpp:142-171); camera mounted
    with R = Ry(pi/2) Rz(-pi/2) (cpp:134-139). Pass a larger `landmarks` array
    and `num_poses` to scale the same geometry up to the 10k/1M target.
    """
    rng = np.random.default_rng(seed)
    left, right = stereo_rig(fx, fy, cx, cy, baseline)
    cameras = [left, right]
    # Right camera maps ref->right with t = -baseline (see stereo_rig); for
    # observation synthesis we need the same transform:
    cam_R = [c.R_cam_from_ref for c in cameras]
    cam_t = [c.t_cam_from_ref for c in cameras]

    if landmarks is None:
        landmarks = landmark_wall()
    M = landmarks.shape[0]

    base_to_camera = _T(_roty(np.pi / 2) @ _rotz(-np.pi / 2), np.zeros(3))

    poses_true = np.zeros((num_poses, 4, 4))
    R_wb = _rotz(-0.1)
    t_wb = np.array([-4.0, -2.5, 0.0])
    for j in range(num_poses):
        R_wb = R_wb @ _rotz(0.005)
        t_wb = t_wb + np.array([0.005, 0.2, 0.0])
        poses_true[j] = _T(R_wb, t_wb) @ base_to_camera

    poses_initial = poses_true.copy()
    for j in range(num_fixed_poses, num_poses):
        poses_initial[j, :3, 3] += rng.uniform(-pose_translation_error,
                                               pose_translation_error, 3)

    points_initial = landmarks + rng.uniform(-point_error, point_error,
                                             landmarks.shape)

    obs_camera, obs_pose, obs_point, obs_pixel = [], [], [], []
    for j in range(num_poses):
        T_cw = np.linalg.inv(poses_true[j])
        local = landmarks @ T_cw[:3, :3].T + T_cw[:3, 3]
        for k in range(2):
            lk = local @ cam_R[k].T + cam_t[k]
            with np.errstate(divide="ignore", invalid="ignore"):
                inv_z = 1.0 / lk[:, 2]
                u = fx * lk[:, 0] * inv_z + cx
                v = fy * lk[:, 1] * inv_z + cy
            if pixel_noise > 0:
                u = u + rng.normal(0, pixel_noise, M)
                v = v + rng.normal(0, pixel_noise, M)
            seen = (
                (lk[:, 2] > 0)
                & (u > 0) & (u < image_width)
                & (v > 0) & (v < image_height)
            )
            ids = np.nonzero(seen)[0]
            obs_camera.append(np.full(ids.shape, k, dtype=np.int32))
            obs_pose.append(np.full(ids.shape, j, dtype=np.int32))
            obs_point.append(ids.astype(np.int32))
            obs_pixel.append(np.stack([u[ids], v[ids]], axis=-1))

    return StereoBAProblem(
        cameras=cameras,
        poses_true=poses_true,
        poses_initial=poses_initial,
        points_true=landmarks,
        points_initial=points_initial,
        fixed_pose_ids=np.arange(num_fixed_poses),
        obs_camera=np.concatenate(obs_camera),
        obs_pose=np.concatenate(obs_pose),
        obs_point=np.concatenate(obs_point),
        obs_pixel=np.concatenate(obs_pixel),
    )


@dataclasses.dataclass
class BatchedStereoPoseOnlyProblem:
    """Many independent stereo pose-only frames (BASELINE config 2:
    'test_6dof_stereo_poseonly_ba: batched 6-DoF pose-only BA over many
    frames'). One shared rig; per-frame point clouds, pixels, and poses."""

    points: np.ndarray  # (B, P, 3) points in each frame's reference frame
    pixels_left: np.ndarray  # (B, P, 2)
    pixels_right: np.ndarray  # (B, P, 2); negative pixels mark no match
    intrinsics: np.ndarray  # (4,) shared fx, fy, cx, cy
    pose_left_to_right: np.ndarray  # (4, 4) rig extrinsic
    poses_true: np.ndarray  # (B, 4, 4) true reference->current poses
    poses_initial: np.ndarray  # (B, 4, 4) initial guesses (identity)


def batched_stereo_pose_only_problem(
    num_frames: int = 1024,
    points_per_frame: int = 512,
    seed: int = 0,
    pixel_noise: float = 0.0,
    drop_right_frac: float = 0.1,
    baseline: float = 0.12,
    fx: float = 525.0,
    fy: float = 525.0,
    cx: float = 320.0,
    cy: float = 240.0,
) -> BatchedStereoPoseOnlyProblem:
    """Vectorized batch of stereo 6-DoF pose-only problems: the reference
    solves one frame per call (test_6dof_stereo_poseonly_ba.cpp workload);
    here B frames share one device launch via the *_batched solvers.

    Per frame: a frustum point cloud, a small random true motion (axis-angle
    ~0.1 rad, translation ~0.2 m), exact left/right projections (rig offset
    `baseline` along +x, test_ba.cpp:82-85), a fraction of right matches
    dropped via negative pixels (pose_only cpp:298).
    """
    rng = np.random.default_rng(seed)
    B, P = int(num_frames), int(points_per_frame)

    pts = np.stack([frustum_cloud(P, rng) for _ in range(B)])  # (B, P, 3)

    # Rodrigues: per-frame small random rotation + translation.
    w = rng.normal(0.0, 0.06, (B, 3))
    th = np.linalg.norm(w, axis=-1, keepdims=True)
    k = w / np.maximum(th, 1e-12)
    K = np.zeros((B, 3, 3))
    K[:, 0, 1], K[:, 0, 2] = -k[:, 2], k[:, 1]
    K[:, 1, 0], K[:, 1, 2] = k[:, 2], -k[:, 0]
    K[:, 2, 0], K[:, 2, 1] = -k[:, 1], k[:, 0]
    s = np.sin(th)[..., None]
    c = np.cos(th)[..., None]
    R = np.eye(3)[None] + s * K + (1 - c) * (K @ K)
    t = rng.normal(0.0, [0.08, 0.08, 0.2], (B, 3))

    T_true = np.tile(np.eye(4), (B, 1, 1))
    T_true[:, :3, :3] = R
    T_true[:, :3, 3] = t

    T_lr = np.eye(4)
    T_lr[0, 3] = baseline
    T_rl = np.linalg.inv(T_lr)

    R_cw = np.transpose(R, (0, 2, 1))
    t_cw = -np.einsum("bij,bj->bi", R_cw, t)
    loc_l = np.einsum("bij,bpj->bpi", R_cw, pts) + t_cw[:, None, :]
    loc_r = loc_l @ T_rl[:3, :3].T + T_rl[:3, 3]

    def proj(loc):
        inv_z = 1.0 / loc[..., 2]
        return np.stack(
            [fx * loc[..., 0] * inv_z + cx, fy * loc[..., 1] * inv_z + cy],
            axis=-1,
        )

    pix_l, pix_r = proj(loc_l), proj(loc_r)
    if pixel_noise > 0:
        pix_l = pix_l + rng.normal(0.0, pixel_noise, pix_l.shape)
        pix_r = pix_r + rng.normal(0.0, pixel_noise, pix_r.shape)
    drop = rng.uniform(size=(B, P)) < drop_right_frac
    pix_r[drop] = -1.0

    return BatchedStereoPoseOnlyProblem(
        points=pts,
        pixels_left=pix_l,
        pixels_right=pix_r,
        intrinsics=np.array([fx, fy, cx, cy]),
        pose_left_to_right=T_lr,
        poses_true=T_true,
        poses_initial=np.tile(np.eye(4), (B, 1, 1)),
    )


@dataclasses.dataclass
class BatchedPlanarPoseOnlyProblem:
    """Many independent planar-3-DoF pose-only frames (the reference's
    test_3dof_mono_poseonly_ba.cpp workload shape, batched): one shared
    base->camera mounting (and stereo rig where present); per-frame point
    clouds in the base1 frame, pixel matches, and pose-prior chains."""

    points: np.ndarray  # (B, P, 3) points in each frame's base1 frame
    pixels_left: np.ndarray  # (B, P, 2)
    pixels_right: np.ndarray | None  # (B, P, 2); negative = no match
    intrinsics: np.ndarray  # (4,)
    base_to_camera: np.ndarray  # (4, 4) shared mounting extrinsic
    pose_left_to_right: np.ndarray | None  # (4, 4) rig extrinsic (stereo)
    poses_world_to_last: np.ndarray  # (B, 4, 4)
    poses_world_to_current_init: np.ndarray  # (B, 4, 4) initial guesses
    poses_world_to_current_true: np.ndarray  # (B, 4, 4)
    theta_true: np.ndarray  # (B, 3) true planar motions (x, y, psi)


def batched_planar_pose_only_problem(
    num_frames: int = 1024,
    points_per_frame: int = 512,
    seed: int = 0,
    stereo: bool = False,
    pixel_noise: float = 0.0,
    drop_right_frac: float = 0.1,
    baseline: float = 0.12,
    fx: float = 525.0,
    fy: float = 525.0,
    cx: float = 320.0,
    cy: float = 240.0,
) -> BatchedPlanarPoseOnlyProblem:
    """Vectorized batch of planar-3-DoF pose-only problems (mono or stereo).

    Geometry mirrors the reference's robot chain
    (test_3dof_mono_poseonly_ba.cpp:109-136): the camera looks along the
    base +x axis, points live 3-10 m ahead in the base1 frame, and each
    frame's true motion is a small planar (x, y, psi) twist of base2<-base1.
    world == base1, so pose_world_to_last is the mounting extrinsic itself
    and the solver must recover T_wc2 = T_b2b1^-1 @ base_to_camera.
    """
    rng = np.random.default_rng(seed)
    B, P = int(num_frames), int(points_per_frame)

    R_bc = _roty(np.pi / 2) @ _rotz(-np.pi / 2)
    base_to_camera = _T(R_bc, np.array([0.1, 0.05, 0.3]))
    T_cb = np.linalg.inv(base_to_camera)

    # Points in the base1 frame, in front of the camera (+x of base).
    pts = np.stack(
        [
            rng.uniform(3, 10, (B, P)),
            rng.uniform(-3, 3, (B, P)),
            rng.uniform(-1, 2, (B, P)),
        ],
        axis=-1,
    )

    theta = np.stack(
        [
            rng.uniform(-0.4, 0.4, B),
            rng.uniform(-0.4, 0.4, B),
            rng.uniform(-0.25, 0.25, B),
        ],
        axis=-1,
    )
    c, s = np.cos(theta[:, 2]), np.sin(theta[:, 2])
    T_b2b1 = np.tile(np.eye(4), (B, 1, 1))
    T_b2b1[:, 0, 0], T_b2b1[:, 0, 1] = c, -s
    T_b2b1[:, 1, 0], T_b2b1[:, 1, 1] = s, c
    T_b2b1[:, :2, 3] = theta[:, :2]

    T_c2b1 = np.einsum("ij,bjk->bik", T_cb, T_b2b1)
    loc_l = (
        np.einsum("bij,bpj->bpi", T_c2b1[:, :3, :3], pts)
        + T_c2b1[:, None, :3, 3]
    )

    def proj(loc):
        inv_z = 1.0 / loc[..., 2]
        return np.stack(
            [fx * loc[..., 0] * inv_z + cx, fy * loc[..., 1] * inv_z + cy],
            axis=-1,
        )

    pix_l = proj(loc_l)
    if pixel_noise > 0:
        pix_l = pix_l + rng.normal(0.0, pixel_noise, pix_l.shape)

    pix_r, T_lr = None, None
    if stereo:
        T_lr = np.eye(4)
        T_lr[0, 3] = baseline
        T_rl = np.linalg.inv(T_lr)
        loc_r = loc_l @ T_rl[:3, :3].T + T_rl[:3, 3]
        pix_r = proj(loc_r)
        if pixel_noise > 0:
            pix_r = pix_r + rng.normal(0.0, pixel_noise, pix_r.shape)
        drop = rng.uniform(size=(B, P)) < drop_right_frac
        pix_r[drop] = -1.0

    T_wc_true = np.einsum(
        "bij,jk->bik", np.linalg.inv(T_b2b1), base_to_camera
    )
    return BatchedPlanarPoseOnlyProblem(
        points=pts,
        pixels_left=pix_l,
        pixels_right=pix_r,
        intrinsics=np.array([fx, fy, cx, cy]),
        base_to_camera=base_to_camera,
        pose_left_to_right=T_lr,
        poses_world_to_last=np.tile(base_to_camera, (B, 1, 1)),
        poses_world_to_current_init=np.tile(base_to_camera, (B, 1, 1)),
        poses_world_to_current_true=T_wc_true,
        theta_true=theta,
    )


def corridor_problem_on_device(
    num_poses: int,
    num_points: int,
    window: int = 6,
    seed: int = 123,
    build_pm: bool = True,
):
    """Build the benchmark corridor problem, finalized and device-resident.

    The SHARED builder behind every flagship-scale benchmark harness
    (bench.py, chip_smoke.py, benchmarks/cg_study.py): one
    place defines the seed / window / fixed-pose policy, so all captured
    artifacts measure the SAME problem. Returns
    ``(problem, shape, host, pm, pshape)`` -- ``pm``/``pshape`` are the
    point-major tables (None when ``build_pm=False``, e.g. for the
    observation-table engine). The problem and tables are `device_put` once
    up front: production solvers keep state resident and pay no per-call
    host-to-device copy.
    """
    import jax

    from ..models.problem import finalized_from_arrays  # lazy: avoid cycle

    prob = corridor_ba_problem(
        num_poses=num_poses, num_points=num_points, window=window, seed=seed
    )
    fixed_pose = np.zeros(num_poses, dtype=bool)
    fixed_pose[prob.fixed_pose_ids] = True
    problem, shape, host = finalized_from_arrays(
        prob.cameras, prob.poses_initial, prob.points_initial,
        prob.obs_camera, prob.obs_pose, prob.obs_point, prob.obs_pixel,
        fixed_pose_mask=fixed_pose, return_host=True,
    )
    dev = jax.devices()[0]
    problem = jax.device_put(problem, dev)
    pm = pshape = None
    if build_pm:
        from ..solvers import full_ba_pm  # lazy: avoid cycle

        pm, pshape = full_ba_pm.pm_from_finalized(problem, shape, host=host)
        pm = jax.device_put(pm, dev)
    return problem, shape, host, pm, pshape
