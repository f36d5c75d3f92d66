"""Point-major padded observation layout for full BA.

The observation-table engine (solvers/full_ba.py) reduces every
per-observation quantity into its landmark with a `segment_sum` scatter and
works on (O, 3, 3)-shaped arrays with tiny trailing dimensions. The
reference's own answer to layout was an AoS->SoA repack in its AVX warper
(utility/simd_library.cpp:63-70); this module takes the same idea to the
whole Schur system:

  * observations are grouped by landmark ("point-major") and padded to a
    static number of pose-slots `Kp` per landmark, each slot carrying the
    problem's `C` rig cameras -- so every point-side reduction (the C/b/U
    blocks of the Schur system) becomes a reduction over a static axis
    instead of a segment_sum scatter;
  * all per-observation planes are stored with the LANDMARK axis LAST and
    small static leading axes, so elementwise math runs on long contiguous
    rows;
  * landmarks are sorted by their minimum observing pose, so each block of
    `bm` landmarks touches only a narrow window `P` of poses (`gbase`,
    `sbase`, `window`) and consecutive landmarks gather nearby pose rows.

Fixed (gauge) parameters dissolve into the layout: a fixed pose keeps its
real index in `slot_pose` (it must still be warped through) but carries
`slot_opt = -1`, which the pose-side segment-sum drops, so its Hessian
contribution is removed exactly like the reference's sentinel remap
(core/full_bundle_adjustment_solver.cpp:182-206). A fixed landmark gets
`point_mask = 0`, which zeroes C -> the closed-form inverse guard returns
Cinv = 0 -> its Schur correction, back-substituted step, and rhs contribution
all vanish while its residuals still weight the pose system.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "PointMajorProblem",
    "PMShape",
    "build_point_major",
    "build_point_major_device",
    "PMLayoutCache",
]


class PointMajorProblem(NamedTuple):
    """Static-shape point-major arrays (a JAX pytree).

    Plane layout conventions (last axis = landmarks, length Mp):
      obs_f32 (3*Kp*C, Mp): rows [0, KpC) = pixel u, [KpC, 2KpC) = pixel v,
        [2KpC, 3KpC) = validity (1.0/0.0); within a plane, row c*Kp + k is
        pose-slot k of camera c (cam-major, so each camera's Kp slots form a
        contiguous sub-plane). Pixels are scale-conditioned.
      slot_pose (Kp, Mp) int32: real pose index warped through (0 on padding).
      slot_opt (Kp, Mp) int32: optimization index of that pose, or -1 when the
        pose is fixed / the slot is padding.
      X (4, Mp): rows x, y, z (scale-conditioned), point_mask (1.0 for an
        optimizable landmark, 0.0 for fixed/padding).
      point_ref (Mp,) int32: original landmark row for write-back (-1 pad).
      gbase/sbase (nblocks,) int32: per-block pose-window bases in real
        and opt index space (aligned down to multiples of 8); each block's
        slots lie in [base, base + window).
    """

    obs_f32: jax.Array
    slot_pose: jax.Array
    slot_opt: jax.Array
    X: jax.Array
    point_ref: jax.Array
    gbase: jax.Array
    sbase: jax.Array


@dataclasses.dataclass(frozen=True)
class PMShape:
    """Hashable static dimensions of a point-major problem."""

    num_poses: int  # N
    num_opt_poses: int  # N_opt
    num_points: int  # M (real landmarks)
    padded_points: int  # Mp (multiple of block_points)
    num_observations: int  # real observation count
    slots: int  # Kp: padded pose-slots per landmark
    cams: int  # C: rig cameras
    block_points: int  # bm: landmarks per block (sharding granularity)
    window: int  # P: pose span of the widest block
    scale: float
    # When the optimizable poses are one contiguous, identity-ordered row
    # range [opt_start, opt_start + num_opt_poses) of the pose array (the
    # common SLAM case: fix the first/last K frames), the solvers replace
    # the per-iteration gather/scatter of pose rows with static slices /
    # dynamic-update-slice. None = the general gather/scatter path.
    opt_start: int | None = None

    @property
    def num_blocks(self) -> int:
        return self.padded_points // self.block_points


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def build_point_major(
    obs_pose: np.ndarray,  # (O,) int32 pose index per observation
    obs_point: np.ndarray,  # (O,) int32 landmark index
    obs_cam: np.ndarray,  # (O,) int32 rig camera index
    obs_pixel: np.ndarray,  # (O, 2) scale-conditioned pixels
    points: np.ndarray,  # (M, 3) scale-conditioned landmark positions
    pose_opt_of: np.ndarray,  # (N,) int32: opt index or num_opt_poses (fixed)
    point_is_opt: np.ndarray,  # (M,) bool
    num_cameras: int,
    scale: float,
    num_opt_poses: int | None = None,
    block_points: int = 256,
    max_slots: int = 32,
    max_window: int = 2048,
    pad_blocks_to: int = 1,  # make num_blocks divisible (sharding over blocks)
    dtype=np.float32,
) -> tuple[PointMajorProblem, PMShape] | None:
    """Build the point-major layout, or return None when the problem does not
    fit its static bounds (a landmark observed from > max_slots poses, or a
    landmark block whose pose span exceeds max_window) -- callers then fall
    back to the observation-table path.
    """
    block_points = max(1, int(block_points))

    O = int(obs_pose.shape[0])
    M = int(points.shape[0])
    N = int(pose_opt_of.shape[0])
    if O == 0:
        # A zero-observation problem has no point-major layout (and the
        # native probe returns None for n == 0); let callers fall back.
        return None
    if num_opt_poses is not None:
        n_opt = int(num_opt_poses)
    else:
        # Fall back to inferring from the sentinel convention (fixed poses
        # carry the value n_opt). The inference is AMBIGUOUS when the values
        # are exactly 0..N-1: that is either all-optimizable or exactly one
        # fixed pose whose sentinel N-1 masquerades as an opt index. Refuse
        # to guess -- every in-repo caller passes num_opt_poses explicitly.
        uniq = np.unique(pose_opt_of)
        if uniq.size == N:
            raise ValueError(
                "pose_opt_of values 0..N-1 are ambiguous (all-optimizable vs "
                "one fixed pose); pass num_opt_poses explicitly."
            )
        n_opt = int(uniq[-1])

    C = int(num_cameras)

    from ..utils.native import (
        DUPLICATE_OBSERVATION,
        pm_fill,
        pm_probe,
        pm_windows,
    )

    filled = None
    probe = pm_probe(obs_pose, obs_point, M, N)
    if probe is not None:
        # Native path (csrc/problem_compiler.cpp): counting-sort bucket
        # passes with an OpenMP per-point fill, ~35x the vectorized-numpy
        # fallback at 12M observations. Duplicate (landmark, pose, camera)
        # observations are detected DURING the fill (the planes have one
        # cell per slot-camera; a duplicate would silently overwrite its
        # sibling residual) -- no separate O(n log n) uniqueness pre-pass.
        kp_max, _, min_pose = probe
        if kp_max > max_slots:
            return None
        Kp = max(1, _round_up(kp_max, 4))
        pt_order = np.argsort(min_pose, kind="stable").astype(np.int32)
        rank_of_point = np.empty(M, dtype=np.int32)
        rank_of_point[pt_order] = np.arange(M, dtype=np.int32)
        bm = int(block_points)
        Mp = _round_up(max(M, bm), bm * max(1, int(pad_blocks_to)))
        nblocks = Mp // bm
        filled = pm_fill(
            obs_pose, obs_point, obs_cam, obs_pixel, points, pose_opt_of,
            point_is_opt, rank_of_point, n_opt, C, Kp, Mp,
        )
        if filled is DUPLICATE_OBSERVATION:
            # Two residuals for one plane cell: fall back to the
            # observation-table engine (which, like the reference's
            # AddObservation append, keeps both).
            return None
    if filled is not None:
        obs_f32, slot_pose, slot_opt, X, point_ref = filled
        kc = Kp * C
        valid_plane = obs_f32[2 * kc:]  # view into the [u|v|valid] stack
    else:
        # Duplicate check for the numpy path (the native fill detects these
        # in-pass; see above).
        triple = (
            obs_point.astype(np.int64) * (N * C)
            + obs_pose.astype(np.int64) * C
            + obs_cam.astype(np.int64)
        )
        if np.unique(triple).size != O:
            return None
        # Vectorized-numpy fallback: group observations by (landmark, pose);
        # each (i, j) pair becomes one slot with C camera entries.
        order = np.lexsort((obs_cam, obs_pose, obs_point))
        op = obs_point[order]
        oj = obs_pose[order]
        oc = obs_cam[order]
        opix = obs_pixel[order]

        # Unique (point, pose) pairs, their slot index within the point.
        pair_key = op.astype(np.int64) * N + oj
        pair_change = np.empty(O, dtype=bool)
        pair_change[0] = True
        np.not_equal(pair_key[1:], pair_key[:-1], out=pair_change[1:])
        pair_id = np.cumsum(pair_change) - 1  # (O,) dense pair index
        num_pairs = int(pair_id[-1]) + 1 if O else 0
        pair_point = op[pair_change]
        pair_pose = oj[pair_change]

        point_change = np.empty(num_pairs, dtype=bool)
        point_change[0] = True
        np.not_equal(pair_point[1:], pair_point[:-1], out=point_change[1:])
        point_first_pair = np.nonzero(point_change)[0]
        slot_of_pair = np.arange(num_pairs) - np.repeat(
            point_first_pair, np.diff(np.append(point_first_pair, num_pairs))
        )
        kp = int(slot_of_pair.max()) + 1 if num_pairs else 1
        if kp > max_slots:
            return None
        Kp = max(1, _round_up(kp, 4))

        # Sort landmarks by minimum observing pose for window locality;
        # landmarks with no observations keep their position at the end.
        min_pose = np.full(M, N, dtype=np.int64)
        np.minimum.at(min_pose, pair_point, pair_pose)
        pt_order = np.argsort(min_pose, kind="stable").astype(np.int32)
        rank_of_point = np.empty(M, dtype=np.int32)
        rank_of_point[pt_order] = np.arange(M, dtype=np.int32)

        bm = int(block_points)
        Mp = _round_up(max(M, bm), bm * max(1, int(pad_blocks_to)))
        nblocks = Mp // bm

        # Scatter observations into the padded planes.
        row_pt = rank_of_point[op]  # (O,) padded landmark row
        slot = slot_of_pair[pair_id]  # (O,) pose-slot within the landmark
        cam = oc  # camera within the slot

        u_plane = np.zeros((Kp * C, Mp), dtype=dtype)
        v_plane = np.zeros((Kp * C, Mp), dtype=dtype)
        valid_plane = np.zeros((Kp * C, Mp), dtype=dtype)
        slot_pose = np.zeros((Kp, Mp), dtype=np.int32)
        slot_opt = np.full((Kp, Mp), -1, dtype=np.int32)

        plane_row = cam * Kp + slot  # cam-major: each camera's slots adjoin
        u_plane[plane_row, row_pt] = opix[:, 0].astype(dtype)
        v_plane[plane_row, row_pt] = opix[:, 1].astype(dtype)
        valid_plane[plane_row, row_pt] = 1.0

        pair_row_pt = rank_of_point[pair_point]
        slot_pose[slot_of_pair, pair_row_pt] = pair_pose.astype(np.int32)
        so = pose_opt_of[pair_pose].astype(np.int32)
        so[so == n_opt] = -1  # fixed-pose sentinel -> one-hot never matches
        slot_opt[slot_of_pair, pair_row_pt] = so

        X = np.zeros((4, Mp), dtype=dtype)
        X[0, rank_of_point] = points[:, 0].astype(dtype)
        X[1, rank_of_point] = points[:, 1].astype(dtype)
        X[2, rank_of_point] = points[:, 2].astype(dtype)
        X[3, rank_of_point] = point_is_opt.astype(dtype)

        point_ref = np.full(Mp, -1, dtype=np.int32)
        point_ref[rank_of_point] = np.arange(M, dtype=np.int32)
        obs_f32 = np.concatenate([u_plane, v_plane, valid_plane], axis=0)

    # Per-block pose windows. Padding slots carry pose 0 / opt -1, so only
    # real slots (valid somewhere) constrain the gather window; slot_pose==0
    # on padding is harmless because the window always contains its base.
    # Raw per-block extrema (empty blocks: min = INT32_MAX, max = -1) come
    # from the native pass when available, the numpy reduction otherwise.
    win = pm_windows(slot_pose, slot_opt, valid_plane, Kp, C, Mp, bm)
    if win is not None:
        gmin, gmax, smin, smax = win
    else:
        sp_blocks = slot_pose.reshape(Kp, nblocks, bm)
        has_obs = (
            valid_plane.reshape(C, Kp, Mp).max(axis=0)
            .reshape(Kp, nblocks, bm) > 0
        )
        gmin = np.where(
            has_obs, sp_blocks, np.iinfo(np.int32).max
        ).min(axis=(0, 2))
        gmax = np.where(has_obs, sp_blocks, -1).max(axis=(0, 2))
        so_blocks = slot_opt.reshape(Kp, nblocks, bm)
        smin = np.where(
            so_blocks >= 0, so_blocks, np.iinfo(np.int32).max
        ).min(axis=(0, 2))
        smax = so_blocks.max(axis=(0, 2))

    empty = gmax < 0
    gmin[empty] = 0
    gmax[empty] = 0
    gbase = (gmin // 8) * 8
    gspan = int((gmax - gbase).max()) + 1 if nblocks else 1

    sempty = smax < 0
    smin[sempty] = 0
    smax[sempty] = 0
    sbase = (np.minimum(smin, np.iinfo(np.int32).max - 8) // 8) * 8
    sbase[sempty] = 0
    sspan = int((smax - sbase).max()) + 1 if nblocks else 1

    P = max(8, _round_up(max(gspan, sspan), 8))
    if P > max_window:
        return None

    pm = PointMajorProblem(
        obs_f32=jnp.asarray(obs_f32),
        slot_pose=jnp.asarray(slot_pose),
        slot_opt=jnp.asarray(slot_opt),
        X=jnp.asarray(X),
        point_ref=jnp.asarray(point_ref),
        gbase=jnp.asarray(gbase.astype(np.int32)),
        sbase=jnp.asarray(sbase.astype(np.int32)),
    )
    # Contiguity probe for the fast pose gather/scatter (see PMShape).
    opt_start = None
    if n_opt > 0:
        opt_rows = np.nonzero(pose_opt_of < n_opt)[0]
        if opt_rows.size == n_opt:
            s0 = int(opt_rows[0])
            if int(opt_rows[-1]) == s0 + n_opt - 1 and np.array_equal(
                pose_opt_of[s0 : s0 + n_opt],
                np.arange(n_opt, dtype=pose_opt_of.dtype),
            ):
                opt_start = s0

    shape = PMShape(
        num_poses=N,
        num_opt_poses=n_opt,
        num_points=M,
        padded_points=Mp,
        num_observations=O,
        slots=Kp,
        cams=C,
        block_points=bm,
        window=P,
        scale=scale,
        opt_start=opt_start,
    )
    return pm, shape


# ---------------------------------------------------------------------------
# Device-side layout build: the plane permutation as XLA sort + scatter.
#
# The host builders above (native csrc ba_pm_fill / vectorized numpy) write
# ~276 MB of planes (12M observations) on the host and then pay the full
# H2D transfer. On the serving path the raw observation arrays are what the
# user HAS -- so ship those (~26% fewer bytes: slot_pose/slot_opt/X are
# derived, not sent, and (pose, camera) ride one packed i32 column) and build
# the planes where they are consumed. The grouping is two static-shape XLA
# programs: a
# lexicographic sort by (landmark, pose*C + camera) + segmented slot ranks
# over just the index columns (the pixel/point value transfers overlap the
# sort -- they are first consumed by stage B), then big one-shot scatters
# into the padded planes, with exactly two tiny host fetches for the static
# dimensions the solver needs at trace time (Kp, window P). This replaces
# the reference's host-side FinalizeParameters/SetProblemSize pass
# (core/full_bundle_adjustment_solver.cpp:631-663).
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("C", "num_points"))
def _device_build_stage_a(obs_point, obs_posecam, C, num_points):
    """Sort observations by (landmark, pose*C + camera) and derive the
    pair/slot structure. Only the two index columns ride the sort (the
    value columns transfer concurrently and are gathered by `perm` in
    stage B). Returns sorted index columns + per-obs slot ranks + the
    scalars that must become static shapes (kp_max) or trigger fallback
    (dup)."""
    O = obs_point.shape[0]
    pt_s, pc_s, perm = jax.lax.sort(
        (obs_point, obs_posecam, jnp.arange(O, dtype=jnp.int32)),
        num_keys=2,
        is_stable=True,
    )
    po_s = pc_s // C
    cam_s = pc_s - po_s * C
    prev_pt = jnp.concatenate([jnp.full((1,), -1, pt_s.dtype), pt_s[:-1]])
    prev_po = jnp.concatenate([jnp.full((1,), -1, po_s.dtype), po_s[:-1]])
    prev_pc = jnp.concatenate([jnp.full((1,), -1, pc_s.dtype), pc_s[:-1]])
    point_change = pt_s != prev_pt
    pair_change = point_change | (po_s != prev_po)
    dup = jnp.any(~point_change & (pc_s == prev_pc))
    pair_id = jnp.cumsum(pair_change.astype(jnp.int32)) - 1
    # First pair id of each landmark, propagated forward: pair_id is
    # nondecreasing, so a running max of (pair_id where the landmark
    # changes) is exactly the landmark's first pair id at every row.
    first_pair = jax.lax.cummax(jnp.where(point_change, pair_id, -1))
    slot = pair_id - first_pair
    kp_max = jnp.max(slot) + 1
    # Min observing pose per landmark (unobserved -> int32 max, which sorts
    # to the end exactly like the host builders' sentinel N).
    min_pose = jax.ops.segment_min(
        po_s, pt_s, num_segments=num_points, indices_are_sorted=True
    )
    return pt_s, po_s, cam_s, perm, slot, min_pose, kp_max, dup


@functools.partial(
    jax.jit,
    static_argnames=("Kp", "C", "Mp", "bm", "n_opt", "num_points"),
)
def _device_build_stage_b(
    pt_s, po_s, cam_s, perm, slot, min_pose, obs_pixel,
    points, point_is_opt, pose_opt_of,
    Kp, C, Mp, bm, n_opt, num_points,
):
    """Scatter the sorted observations into the padded point-major planes
    (static Kp from stage A's kp_max) and compute the per-block pose
    windows. Returns the plane pytree fields + the scalar window span."""
    M = num_points
    imax = jnp.iinfo(jnp.int32).max
    u_s = obs_pixel[perm, 0]
    v_s = obs_pixel[perm, 1]

    pt_order = jnp.argsort(min_pose, stable=True).astype(jnp.int32)
    rank_of_point = (
        jnp.zeros(M, jnp.int32).at[pt_order].set(jnp.arange(M, dtype=jnp.int32))
    )
    row_pt = rank_of_point[pt_s]

    # Observation planes: ONE flat scalar scatter, 3*O rows, whose index
    # offsets land u/v/valid directly in the host builders' [u|v|valid]
    # stack order (no transpose).
    plane_row = cam_s * Kp + slot
    lin = plane_row * Mp + row_pt
    kcm = Kp * C * Mp
    planes = (
        jnp.zeros(3 * kcm, u_s.dtype)
        .at[jnp.concatenate([lin, lin + kcm, lin + 2 * kcm])].set(
            jnp.concatenate([u_s, v_s, jnp.ones_like(u_s)]),
            mode="drop", unique_indices=True,
        )
        .reshape(3 * Kp * C, Mp)
    )

    # Slot planes: every observation of a (landmark, pose) pair writes the
    # SAME value, so duplicate scatter indices are deterministic here.
    lin_kp = slot * Mp + row_pt
    slot_pose = (
        jnp.zeros(Kp * Mp, jnp.int32).at[lin_kp].set(po_s, mode="drop")
        .reshape(Kp, Mp)
    )
    so = pose_opt_of[po_s].astype(jnp.int32)
    so = jnp.where(so == n_opt, -1, so)
    slot_opt = (
        jnp.full(Kp * Mp, -1, jnp.int32).at[lin_kp].set(so, mode="drop")
        .reshape(Kp, Mp)
    )

    X = _scatter_x(rank_of_point, points, point_is_opt, Mp)
    point_ref = (
        jnp.full(Mp, -1, jnp.int32)
        .at[rank_of_point].set(
            jnp.arange(M, dtype=jnp.int32), mode="drop", unique_indices=True
        )
    )

    # Per-block pose windows (same formulas as the host builders).
    nblocks = Mp // bm
    valid_b = (
        planes[2 * Kp * C:].reshape(C, Kp, nblocks, bm).max(axis=0) > 0
    )
    sp_b = slot_pose.reshape(Kp, nblocks, bm)
    gmin = jnp.where(valid_b, sp_b, imax).min(axis=(0, 2))
    gmax = jnp.where(valid_b, sp_b, -1).max(axis=(0, 2))
    so_b = slot_opt.reshape(Kp, nblocks, bm)
    smin = jnp.where(so_b >= 0, so_b, imax).min(axis=(0, 2))
    smax = so_b.max(axis=(0, 2))

    empty = gmax < 0
    gmin = jnp.where(empty, 0, gmin)
    gmax = jnp.where(empty, 0, gmax)
    gbase = (gmin // 8) * 8
    gspan = jnp.max(gmax - gbase) + 1

    sempty = smax < 0
    smin = jnp.where(sempty, 0, smin)
    smax = jnp.where(sempty, 0, smax)
    sbase = (jnp.minimum(smin, imax - 8) // 8) * 8
    sbase = jnp.where(sempty, 0, sbase)
    sspan = jnp.max(smax - sbase) + 1

    span = jnp.maximum(jnp.maximum(gspan, sspan), 8)
    return (planes, slot_pose, slot_opt, X, point_ref, gbase, sbase, span,
            lin, rank_of_point)


def build_point_major_device(
    obs_pose: np.ndarray,
    obs_point: np.ndarray,
    obs_cam: np.ndarray,
    obs_pixel: np.ndarray,  # (O, 2) scale-conditioned, f32
    points: np.ndarray,  # (M, 3) scale-conditioned, f32
    pose_opt_of: np.ndarray,
    point_is_opt: np.ndarray,
    num_cameras: int,
    scale: float,
    num_opt_poses: int,
    block_points: int = 256,
    max_slots: int = 32,
    max_window: int = 2048,
    pad_blocks_to: int = 1,
    return_cache: bool = False,
) -> tuple[PointMajorProblem, PMShape] | None:
    """`build_point_major`, but the grouping/scatter runs ON DEVICE.

    Ships the raw per-observation columns (25% fewer bytes than the built
    planes) and replaces the host fill with two XLA programs; the only
    synchronization is one fetch of (kp_max, dup) -- Kp must be a static
    shape -- and one of the window span. Plane values are bit-identical to
    the host builders (pixels/points are copied, not recomputed; pass them
    already scale-conditioned in f32). Returns None on the same fallback
    conditions (slots/window bound exceeded, duplicate observation).

    `return_cache=True` additionally returns a `PMLayoutCache` holding the
    inverse cell -> raw-observation-row gather index (`gsrc`),
    device-resident, so later solves over the SAME observation topology
    (the SLAM re-solve pattern: new pixel measurements / re-initialized
    values each frame) refill the value planes by pure gathers -- no
    re-sort, no scatter -- see `PMLayoutCache.refill`."""
    block_points = max(1, int(block_points))
    O = int(obs_pose.shape[0])
    M = int(points.shape[0])
    N = int(pose_opt_of.shape[0])
    if O == 0:
        return None
    n_opt = int(num_opt_poses)
    C = int(num_cameras)

    # Pack (pose, camera) into one i32 column on the host (one fused
    # multiply-add pass): a whole 4-byte-per-observation column never
    # crosses the link, and the sort needs only 2 keys.
    posecam = np.asarray(obs_pose, np.int64) * C + np.asarray(obs_cam)
    # Launch the VALUE transfers first: stage A consumes only the index
    # columns, so the (bigger) pixel/point transfers overlap the sort and
    # the kp_max fetch instead of serializing in front of them.
    d_pixel = jax.device_put(np.ascontiguousarray(obs_pixel, np.float32))
    d_points = jax.device_put(np.ascontiguousarray(points, np.float32))
    (pt_s, po_s, cam_s, perm, slot, min_pose, kp_max_d, dup_d) = (
        _device_build_stage_a(
            jnp.asarray(obs_point, jnp.int32),
            jnp.asarray(posecam, jnp.int32),
            C=C,
            num_points=M,
        )
    )
    kp_max, dup = (
        int(np.asarray(kp_max_d)), bool(np.asarray(dup_d))
    )  # ONE sync: both scalars ride the same ready program
    if dup or kp_max > max_slots:
        return None
    Kp = max(1, _round_up(kp_max, 4))
    bm = int(block_points)
    Mp = _round_up(max(M, bm), bm * max(1, int(pad_blocks_to)))

    (planes, slot_pose, slot_opt, X, point_ref, gbase, sbase, span_d,
     lin, rank_of_point) = (
        _device_build_stage_b(
            pt_s, po_s, cam_s, perm, slot, min_pose, d_pixel,
            d_points,
            jnp.asarray(point_is_opt),
            jnp.asarray(pose_opt_of, jnp.int32),
            Kp=Kp, C=C, Mp=Mp, bm=bm, n_opt=n_opt, num_points=M,
        )
    )
    span = int(np.asarray(span_d))

    P = max(8, _round_up(span, 8))
    if P > max_window:
        return None

    pm = PointMajorProblem(
        obs_f32=planes,
        slot_pose=slot_pose,
        slot_opt=slot_opt,
        X=X,
        point_ref=point_ref,
        gbase=gbase.astype(jnp.int32),
        sbase=sbase.astype(jnp.int32),
    )
    opt_start = None
    if n_opt > 0:
        pose_opt_of = np.asarray(pose_opt_of)
        opt_rows = np.nonzero(pose_opt_of < n_opt)[0]
        if opt_rows.size == n_opt:
            s0 = int(opt_rows[0])
            if int(opt_rows[-1]) == s0 + n_opt - 1 and np.array_equal(
                pose_opt_of[s0 : s0 + n_opt],
                np.arange(n_opt, dtype=pose_opt_of.dtype),
            ):
                opt_start = s0
    shape = PMShape(
        num_poses=N,
        num_opt_poses=n_opt,
        num_points=M,
        padded_points=Mp,
        num_observations=O,
        slots=Kp,
        cams=C,
        block_points=bm,
        window=P,
        scale=scale,
        opt_start=opt_start,
    )
    if return_cache:
        # Invert the scatter once (one O-row scalar scatter) so every LATER
        # refill is pure gathers. gsrc[cell] = raw-input observation row whose (u, v) fills that
        # plane cell; padding cells alias row 0 and are masked by the
        # topology-constant valid plane at gather time.
        kcm = Kp * C * Mp
        src = (
            jnp.full(kcm, -1, jnp.int32)
            .at[lin].set(
                jnp.arange(O, dtype=jnp.int32), mode="drop",
                unique_indices=True,
            )
        )
        # (Kp*C, Mp): same cell order as one (u|v|valid) plane band, so the
        # cache shards along the landmark axis exactly like the planes
        # (parallel/sharded_pm.pm_in_specs) and a sharded refill's gathers
        # stay device-local.
        gsrc = jnp.take(perm, jnp.maximum(src, 0)).reshape(Kp * C, Mp)
        cache = PMLayoutCache(gsrc=gsrc, shape=shape)
        return pm, shape, cache
    return pm, shape


def _scatter_x(rank_of_point, points, point_is_opt, Mp):
    """(4, Mp) X plane via one flat scalar scatter (see the planes comment
    in _device_build_stage_b for why flat rows beat (M, 4) rows)."""
    mask = point_is_opt.astype(points.dtype)
    vals = jnp.concatenate(
        [points[:, 0], points[:, 1], points[:, 2], mask]
    )
    idx = jnp.concatenate(
        [rank_of_point + r * Mp for r in range(4)]
    )
    return (
        jnp.zeros(4 * Mp, points.dtype)
        .at[idx].set(vals, mode="drop", unique_indices=True)
        .reshape(4, Mp)
    )


@jax.jit
def _device_refill(gsrc, valid_rows, obs_pixel):
    """(u|v|valid) planes by pure gather: each plane cell reads its raw
    observation row through the cached inverse index. `jnp.where` (not a
    multiply) keeps padding cells bit-identical to the scatter builders'
    zeros. The valid rows are topology-constant and passed through."""
    flat = obs_pixel.reshape(-1)  # (O*2,) [u0 v0 u1 v1 ...]
    ok = valid_rows > 0
    zero = jnp.zeros((), flat.dtype)
    u = jnp.where(ok, jnp.take(flat, 2 * gsrc).reshape(ok.shape), zero)
    v = jnp.where(ok, jnp.take(flat, 2 * gsrc + 1).reshape(ok.shape), zero)
    return jnp.concatenate([u, v, valid_rows], axis=0)


@jax.jit
def _device_refill_x(point_ref, points, mask_of_point):
    """(4, Mp) X plane by gather through the padded-row -> landmark map."""
    ok = point_ref >= 0
    pr = jnp.maximum(point_ref, 0)
    pts = jnp.where(ok[None, :], points[pr].T, 0.0)
    m = jnp.where(ok, mask_of_point.astype(points.dtype)[pr], 0.0)
    return jnp.concatenate([pts, m[None, :]], axis=0)


@jax.jit
def _device_refill_x_coords(point_ref, points, X_prev):
    """(4, Mp) X plane: regathered coordinates + the EXISTING opt-mask row
    (already plane-order, zero-padded) carried from `X_prev`. The SLAM
    per-frame hot path: one jitted dispatch, no throwaway mask gather."""
    ok = point_ref >= 0
    pr = jnp.maximum(point_ref, 0)
    pts = jnp.where(ok[None, :], points[pr].T, 0.0)
    return jnp.concatenate([pts, X_prev[3:]], axis=0)


@dataclasses.dataclass(frozen=True)
class PMLayoutCache:
    """Device-resident inverse layout index of a built point-major layout.

    The observation TOPOLOGY (which landmark is seen from which pose and
    camera) fixes everything expensive about the layout: the sort order,
    the slot assignment, the landmark ordering, the pose windows. Only the
    VALUES (pixel measurements, initial landmark positions) change between
    a SLAM system's repeated solves. `refill` rebuilds just those -- one
    H2D of the raw value columns + pure device GATHERS through the cached
    cell -> raw-observation-row index (`gsrc`), so the per-solve layout
    cost drops from a full sort+build to one gather pass. The valid rows and the padded-row -> landmark map ride along in the built
    `PointMajorProblem` (both topology-constant). Contrast: the reference
    re-runs its whole FinalizeParameters host pass per Solve()
    (core/full_bundle_adjustment_solver.cpp:631-663)."""

    gsrc: jax.Array  # (Kp*C, Mp) raw observation row feeding each plane cell
    shape: PMShape

    def refill(
        self,
        pm: PointMajorProblem,
        obs_pixel: np.ndarray,  # (O, 2) scale-conditioned, f32
        points: np.ndarray | None = None,  # (M, 3) scale-conditioned, f32
        point_is_opt: np.ndarray | None = None,
    ) -> PointMajorProblem:
        """New PointMajorProblem with updated pixel (and optionally
        landmark-value) planes; slot planes and windows are shared with
        `pm` (same topology)."""
        sh = self.shape
        kc = sh.slots * sh.cams
        valid_rows = pm.obs_f32[2 * kc :]
        planes = _device_refill(
            self.gsrc, valid_rows, jnp.asarray(obs_pixel, jnp.float32)
        )
        if points is None and point_is_opt is None:
            X = pm.X  # same landmark values: the plane is unchanged
        elif points is None:
            # Only the opt-mask row changes; coordinates stay plane-order.
            ok = pm.point_ref >= 0
            prc = jnp.maximum(pm.point_ref, 0)
            m = jnp.where(
                ok, jnp.asarray(point_is_opt).astype(pm.X.dtype)[prc], 0.0
            )
            X = jnp.concatenate([pm.X[:3], m[None, :]], axis=0)
        else:
            pts = jnp.asarray(points, jnp.float32)
            if point_is_opt is None:
                # Keep the existing opt mask row (already in plane order,
                # zero-padded) and regather only the coordinates -- one
                # jitted dispatch on the per-frame hot path.
                X = _device_refill_x_coords(pm.point_ref, pts, pm.X)
            else:
                X = _device_refill_x(
                    pm.point_ref, pts, jnp.asarray(point_is_opt)
                )
        return pm._replace(obs_f32=planes, X=X)
