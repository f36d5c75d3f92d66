"""Pose-only Gauss-Newton statistics against automatic differentiation.

One damped GN step of every pose-only solver (four modes, single frame and
batched) must equal the step built from `jax.jacfwd` of the residuals:
H = J^T W J and g = J^T W r with the Manhattan-Huber weights W of the
current iterate, solved with the reference's (1 + 1e-5) diagonal damping
(pose_only cpp:57, 102-105). Each camera's Jacobian is taken w.r.t. a left
perturbation of the pose expressed in that camera's own frame -- the
reference's convention for the right camera (pose_only cpp:304-307). The
planar modes differentiate w.r.t. additive (x, y, psi), as the reference's
planar Jacobian does (pose_only cpp:1454-1515), and then apply the solver's
left-compositional update (cpp:536-547).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bundle_adjustment_solver.ops.lie import (
    add_front_se3,
    compose,
    inverse_se3,
    planar_to_se3,
)
from bundle_adjustment_solver.ops.projection import residual_and_weight
from bundle_adjustment_solver.options import (
    ConvergenceHandle,
    IterationHandle,
    Options,
    OutlierHandle,
)
from bundle_adjustment_solver.solvers import pose_only
from bundle_adjustment_solver.utils.synthetic import (
    batched_planar_pose_only_problem,
    batched_stereo_pose_only_problem,
)

HUBER = 1.0
_HI = jax.lax.Precision.HIGHEST
# Both sides solve the same f32 normal equations; only the summation order
# of J^T W J differs, which moves a unit-scale pose by well under this.
POSE_ATOL = 2e-5
ONE_STEP = Options(
    convergence_handle=ConvergenceHandle(0.0, 0.0),
    outlier_handle=OutlierHandle(HUBER, 2.5),
    iteration_handle=IterationHandle(1),
)


def _to_T(R, t):
    T = jnp.eye(4, dtype=R.dtype)
    return T.at[:3, :3].set(R).at[:3, 3].set(t)


def _autodiff_step(cameras, dim):
    """Damped GN step from jacfwd. `cameras`: list of (points_of(delta)
    -> (P, 3) camera-frame points, intrinsics (4,), pixels, validity)."""
    zero = jnp.zeros(dim, jnp.float32)
    H = jnp.zeros((dim, dim), jnp.float32)
    g = jnp.zeros(dim, jnp.float32)
    for points_of, intr, pixels, validf in cameras:
        def res(d, points_of=points_of, intr=intr, pixels=pixels):
            r, w, _ = residual_and_weight(
                points_of(d), pixels, intr[0], intr[1], intr[2], intr[3],
                HUBER,
            )
            return r, w

        r0, w = res(zero)
        J = jax.jacfwd(lambda d, res=res: res(d)[0])(zero)  # (P, 2, dim)
        wv = w * validf
        H = H + jnp.einsum("pri,p,prj->ij", J, wv, J, precision=_HI)
        g = g + jnp.einsum("pri,p,pr->i", J, wv, r0, precision=_HI)
    H = H + jnp.diag(jnp.diag(H)) * 1e-5
    return jnp.linalg.solve(H, -g)


def _left_perturbed(X_c):
    """Camera-frame points under a left SE(3) perturbation in that frame."""
    def points_of(d):
        R_d, t_d = add_front_se3(jnp.eye(3), jnp.zeros(3), d)
        return X_c @ R_d.T + t_d

    return points_of


def _expected_6dof(points, pix_l, pix_r, intr, T_lr, pose0):
    """One autodiff GN step of the 6-DoF modes (pix_r None = mono)."""
    R0, t0 = inverse_se3(pose0[:3, :3], pose0[:3, 3])
    X_l = points @ R0.T + t0
    cams = [(_left_perturbed(X_l), intr, pix_l,
             jnp.ones(points.shape[0], jnp.float32))]
    if pix_r is not None:
        R_rl, t_rl = inverse_se3(T_lr[:3, :3], T_lr[:3, 3])
        X_r = X_l @ R_rl.T + t_rl
        has_r = ((pix_r[:, 0] >= 0) & (pix_r[:, 1] >= 0)).astype(jnp.float32)
        cams.append((_left_perturbed(X_r), intr, pix_r, has_r))
    delta = _autodiff_step(cams, 6)
    R1, t1 = add_front_se3(R0, t0, delta)
    return _to_T(*inverse_se3(R1, t1)), delta


def _expected_planar(points, pix_l, pix_r, intr, T_bc, T_lr, T_wl, T_wc0):
    """One autodiff GN step of the planar modes (pix_r None = mono)."""
    theta0, (R_cb, t_cb), (R_bc, t_bc) = pose_only._planar_prior(
        T_bc, T_wl, T_wc0
    )

    def left(d):
        R_p, t_p = planar_to_se3(theta0 + d)
        R_l, t_l = compose(R_cb, t_cb, R_p, t_p)
        return points @ R_l.T + t_l, (R_l, t_l)

    cams = [(lambda d: left(d)[0], intr, pix_l,
             jnp.ones(points.shape[0], jnp.float32))]
    if pix_r is not None:
        R_rl, t_rl = inverse_se3(T_lr[:3, :3], T_lr[:3, 3])

        def right(d):
            R_r, t_r = compose(R_rl, t_rl, *left(d)[1])
            return points @ R_r.T + t_r

        has_r = ((pix_r[:, 0] >= 0) & (pix_r[:, 1] >= 0)).astype(jnp.float32)
        cams.append((right, intr, pix_r, has_r))
    delta = _autodiff_step(cams, 3)
    R_p, t_p = planar_to_se3(pose_only._planar_update(theta0, delta))
    return _to_T(*compose(*inverse_se3(R_p, t_p), R_bc, t_bc)), delta


def _frames(mode, B):
    """Noisy synthetic frames (so Huber weights are active) as f32 jnp."""
    f = lambda a: jnp.asarray(a, jnp.float32)  # noqa: E731
    if mode.endswith("6dof"):
        p = batched_stereo_pose_only_problem(
            num_frames=B, points_per_frame=96, seed=7, pixel_noise=2.0,
            drop_right_frac=0.2,
        )
        return dict(points=f(p.points), pix_l=f(p.pixels_left),
                    pix_r=f(p.pixels_right), intr=f(p.intrinsics),
                    T_lr=f(p.pose_left_to_right), pose0=f(p.poses_initial))
    p = batched_planar_pose_only_problem(
        num_frames=B, points_per_frame=96, seed=9, stereo=True,
        pixel_noise=2.0, drop_right_frac=0.2,
    )
    # Start away from the truth so the step is not ~0.
    T_wc0 = np.array(p.poses_world_to_current_true, np.float64)
    T_wc0[:, :3, 3] += np.array([0.05, -0.03, 0.0])
    return dict(points=f(p.points), pix_l=f(p.pixels_left),
                pix_r=f(p.pixels_right), intr=f(p.intrinsics),
                T_bc=f(p.base_to_camera), T_lr=f(p.pose_left_to_right),
                T_wl=f(p.poses_world_to_last), T_wc0=f(T_wc0))


def _solve_one_step(mode, d, batched):
    valid = jnp.ones(d["points"].shape[:-1], bool)
    if mode == "mono6dof":
        fn = (pose_only.solve_monocular_6dof_batched if batched
              else pose_only.solve_monocular_6dof_jax)
        return fn(d["points"], d["pix_l"], valid, d["intr"], d["pose0"],
                  ONE_STEP).pose
    if mode == "stereo6dof":
        fn = (pose_only.solve_stereo_6dof_batched if batched
              else pose_only.solve_stereo_6dof_jax)
        return fn(d["points"], d["pix_l"], d["pix_r"], valid, d["intr"],
                  d["intr"], d["T_lr"], d["pose0"], ONE_STEP).pose
    if mode == "mono_planar":
        fn = (pose_only.solve_monocular_planar3dof_batched if batched
              else pose_only.solve_monocular_planar3dof_jax)
        return fn(d["points"], d["pix_l"], valid, d["intr"], d["T_bc"],
                  d["T_wl"], d["T_wc0"], ONE_STEP).pose
    fn = (pose_only.solve_stereo_planar3dof_batched if batched
          else pose_only.solve_stereo_planar3dof_jax)
    return fn(d["points"], d["pix_l"], d["pix_r"], valid, d["intr"],
              d["intr"], d["T_bc"], d["T_lr"], d["T_wl"], d["T_wc0"],
              ONE_STEP).pose


PER_FRAME = ("points", "pix_l", "pix_r", "pose0", "T_wl", "T_wc0")


def _expected(mode, d, b):
    stereo = mode.startswith("stereo")
    pix_r = d["pix_r"][b] if stereo else None
    if mode.endswith("6dof"):
        return _expected_6dof(d["points"][b], d["pix_l"][b], pix_r,
                              d["intr"], d["T_lr"], d["pose0"][b])
    return _expected_planar(d["points"][b], d["pix_l"][b], pix_r, d["intr"],
                            d["T_bc"], d["T_lr"], d["T_wl"][b], d["T_wc0"][b])


@pytest.mark.parametrize("batched", [False, True], ids=["single", "batched"])
@pytest.mark.parametrize(
    "mode", ["mono6dof", "stereo6dof", "mono_planar", "stereo_planar"]
)
def test_gn_step_matches_autodiff(mode, batched):
    B = 3 if batched else 1
    d = _frames(mode, B)
    if batched:
        got = np.asarray(_solve_one_step(mode, d, True))
    else:
        one = {k: (v[0] if k in PER_FRAME else v) for k, v in d.items()}
        got = np.asarray(_solve_one_step(mode, one, False))[None]
    for b in range(B):
        want, delta = _expected(mode, d, b)
        assert float(jnp.linalg.norm(delta)) > 1e-3, "step must not be ~0"
        np.testing.assert_allclose(
            got[b], np.asarray(want), rtol=0, atol=POSE_ATOL
        )
