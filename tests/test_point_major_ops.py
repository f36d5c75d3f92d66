"""The point-major XLA operators against the observation-table engine.

`ops/point_major.py` (assembly, Schur matvec correction, cost) must
reproduce the plain observation-table reference (`ops/hessian.py`) on every
rig size, on contiguous and scattered fixed-pose sets (with fixed
landmarks), and with either coupling-block storage dtype.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from bundle_adjustment_solver.models.camera import Camera
from bundle_adjustment_solver.models.problem import finalized_from_arrays
from bundle_adjustment_solver.ops import hessian as H
from bundle_adjustment_solver.ops import point_major as K
from bundle_adjustment_solver.ops.projection import full_ba_jacobians
from bundle_adjustment_solver.solvers import full_ba
from bundle_adjustment_solver.solvers.full_ba_pm import pm_from_finalized
from bundle_adjustment_solver.utils.synthetic import corridor_ba_problem

_SYM3 = [(0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)]
# f32 on both sides, summed in a different order.
F32_RTOL = 2e-4
# bfloat16 coupling blocks keep 8 mantissa bits (relative rounding 2^-9
# per element), which the S x correction inherits.
BF16_RTOL = 2e-2


def _rig_problem(rig, fixed):
    N, M = 14, 320
    prob = corridor_ba_problem(
        num_poses=N, num_points=M, window=4, seed=17, pixel_noise=0.5,
        num_fixed_poses=2,
    )
    cameras = list(prob.cameras)
    cam, pose = prob.obs_camera, prob.obs_pose
    point, pixel = prob.obs_point, prob.obs_pixel
    if rig == "mono":
        keep = cam == 0
        cameras = cameras[:1]
        cam, pose, point, pixel = (
            cam[keep], pose[keep], point[keep], pixel[keep]
        )
    elif rig == "trinocular":
        third = Camera(525.0, 525.0, 320.0, 240.0, np.eye(3),
                       np.array([0.0, -0.10, 0.0]))
        cameras.append(third)
        sel = cam == 0
        T_cw = np.linalg.inv(prob.poses_true)
        j, i = pose[sel], point[sel]
        Xc = np.einsum("oab,ob->oa", T_cw[j, :3, :3], prob.points_true[i])
        Xc = Xc + T_cw[j, :3, 3] + third.t_cam_from_ref
        pix3 = np.stack([525.0 * Xc[:, 0] / Xc[:, 2] + 320.0,
                         525.0 * Xc[:, 1] / Xc[:, 2] + 240.0], axis=-1)
        cam = np.concatenate([cam, np.full(j.shape[0], 2)])
        pose = np.concatenate([pose, j])
        point = np.concatenate([point, i])
        pixel = np.concatenate([pixel, pix3])
    fixed_pose = np.zeros(N, bool)
    fixed_point = np.zeros(M, bool)
    if fixed == "contiguous":
        fixed_pose[:2] = True
    else:
        fixed_pose[[0, 5, 11]] = True
        fixed_point[::13] = True
    return finalized_from_arrays(
        cameras, prob.poses_initial, prob.points_initial, cam, pose, point,
        pixel, fixed_pose_mask=fixed_pose, fixed_point_mask=fixed_point,
    )


@pytest.mark.parametrize("u_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fixed", ["contiguous", "scattered"])
@pytest.mark.parametrize("rig", ["mono", "stereo", "trinocular"])
def test_operators_match_observation_table(rig, fixed, u_dtype):
    problem, shape = _rig_problem(rig, fixed)
    pm, pshape = pm_from_finalized(problem, shape, block_points=64)
    assert pshape.cams == {"mono": 1, "stereo": 2, "trinocular": 3}[rig]
    assert (pshape.opt_start is not None) == (fixed == "contiguous")
    huber = 1.0 * shape.scale
    lam = jnp.float32(0.7)

    X_ref, X_cam, r, w, (fx, fy, R_jw, R_cam) = full_ba._residuals(
        problem, problem.R_cw, problem.t_cw, problem.points, huber
    )
    Q, Rj = full_ba_jacobians(R_jw, X_ref, X_cam, fx, fy, R_cam)
    args = (problem.obs_pose_opt, problem.obs_point_opt,
            shape.num_opt_poses, shape.num_opt_points)
    sys = H.assemble_block_system(Q, Rj, r, w, *args, lam)
    A, a, Cb, U = K.assemble_pm(
        pm, pshape, problem.R_cw, problem.t_cw, pm.X, problem.rig, lam,
        huber, u_dtype=u_dtype,
    )
    assert U.dtype == jnp.dtype(u_dtype)

    def close(got, want, rtol):
        want = np.asarray(want)
        np.testing.assert_allclose(
            np.asarray(got), want, rtol=rtol,
            atol=rtol * float(np.abs(want).max()),
        )

    close(A, sys.A, F32_RTOL)
    close(a, sys.a, F32_RTOL)
    # Point blocks: map plane columns back to optimizable landmark rows.
    ref = np.asarray(pm.point_ref)
    opt_of = np.full(shape.num_points, -1)
    opt_of[np.asarray(problem.opt_point_idx)] = np.arange(shape.num_opt_points)
    live = (ref >= 0) & (opt_of[np.maximum(ref, 0)] >= 0)
    rows = opt_of[ref[live]]
    Cb_h = np.asarray(Cb)
    for n, (i, j) in enumerate(_SYM3):
        close(Cb_h[n, live], np.asarray(sys.C)[rows, i, j], F32_RTOL)
    close(Cb_h[6:9, live].T, np.asarray(sys.b)[rows], F32_RTOL)
    # Fixed landmarks drop out of the Schur system entirely.
    fixed_cols = (ref >= 0) & (opt_of[np.maximum(ref, 0)] < 0)
    assert np.all(Cb_h[9:15, fixed_cols] == 0.0)

    x = jnp.asarray(np.random.default_rng(3).standard_normal(
        (shape.num_opt_poses, 6)).astype(np.float32))
    Sx, _ = K.schur_matvec_pm(pm, pshape, A, Cb, U, x)
    u_tol = F32_RTOL if u_dtype == "float32" else BF16_RTOL
    close(Sx, H.schur_matvec(sys, *args, x), u_tol)
    close(K.schur_rhs_pm(pm, pshape, a, Cb, U), H.schur_rhs(sys, *args),
          u_tol)

    s_norm, s_wsq, s_sq, s_cnt = K.cost_pm(
        pm, pshape, problem.R_cw, problem.t_cw, pm.X, problem.rig, huber
    )
    assert float(s_cnt) == shape.num_observations
    close(s_norm, full_ba._cost(problem, r, w, "reference"), 1e-5)
    close(s_wsq, full_ba._cost(problem, r, w, "squared"), 1e-5)
