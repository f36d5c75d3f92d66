"""Multi-device batched pose-only BA: the embarrassingly-parallel axis.

The reference solves one frame per call (pose_only_...h:50-67); SURVEY.md §2
prescribes batching thousands of independent frames per chip AND sharding the
frame axis across the mesh. Frames never communicate, so this is pure data
parallelism: `shard_map` splits the leading frame axis over the mesh and each
device runs the full batched (vmapped) solver on its local block, with no
collective at all.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from ..options import Options
from ..solvers.pose_only import (
    PoseOnlyResult,
    solve_monocular_6dof_batched,
    solve_stereo_6dof_batched,
)
from .mesh import DATA_AXIS, data_mesh


def _shard_leading(mesh, *arrays):
    sharding = NamedSharding(mesh, P(DATA_AXIS))
    return tuple(jax.device_put(a, sharding) for a in arrays)


def _result_specs() -> PoseOnlyResult:
    """Every PoseOnlyResult leaf carries a leading frame axis."""
    return PoseOnlyResult(*([P(DATA_AXIS)] * len(PoseOnlyResult._fields)))


def solve_monocular_6dof_sharded(
    points,  # (B, P, 3)
    pixels,  # (B, P, 2)
    valid,  # (B, P) bool
    intrinsics,  # (4,) shared
    poses,  # (B, 4, 4)
    options: Options,
    mesh=None,
) -> PoseOnlyResult:
    """Shard B frames over the mesh's data axis and solve them all at once.

    B must be divisible by the mesh size (pad with valid=False frames
    otherwise).
    """
    if mesh is None:
        mesh = data_mesh()
    points, pixels, valid, poses = _shard_leading(
        mesh, points, pixels, valid, poses
    )
    intrinsics = jax.device_put(
        jnp.asarray(intrinsics), NamedSharding(mesh, P())
    )

    def local(p, x, v, i, ps):
        return solve_monocular_6dof_batched(p, x, v, i, ps, options)

    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(DATA_AXIS), P(DATA_AXIS), P(DATA_AXIS), P(),
                  P(DATA_AXIS)),
        out_specs=_result_specs(),
        # Frames are independent: there are no collectives to check.
        check_vma=False,
    )(points, pixels, valid, intrinsics, poses)


def solve_stereo_6dof_sharded(
    points,
    pixels_left,
    pixels_right,
    valid,
    intrinsics_left,
    intrinsics_right,
    pose_left_to_right,
    poses,
    options: Options,
    mesh=None,
) -> PoseOnlyResult:
    """Stereo variant of `solve_monocular_6dof_sharded`."""
    if mesh is None:
        mesh = data_mesh()
    points, pixels_left, pixels_right, valid, poses = _shard_leading(
        mesh, points, pixels_left, pixels_right, valid, poses
    )
    repl = NamedSharding(mesh, P())
    intrinsics_left = jax.device_put(jnp.asarray(intrinsics_left), repl)
    intrinsics_right = jax.device_put(jnp.asarray(intrinsics_right), repl)
    pose_left_to_right = jax.device_put(jnp.asarray(pose_left_to_right), repl)

    def local(p, xl, xr, v, il, ir, t_lr, ps):
        return solve_stereo_6dof_batched(
            p, xl, xr, v, il, ir, t_lr, ps, options
        )

    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(DATA_AXIS), P(DATA_AXIS), P(DATA_AXIS), P(DATA_AXIS),
                  P(), P(), P(), P(DATA_AXIS)),
        out_specs=_result_specs(),
        check_vma=False,
    )(points, pixels_left, pixels_right, valid, intrinsics_left,
      intrinsics_right, pose_left_to_right, poses)
