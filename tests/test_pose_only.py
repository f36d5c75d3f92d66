"""End-to-end pose-only solver tests on synthetic ground truth.

Asserting ports of the reference's eyeball tests (SURVEY.md §4): the
test_compare mono 6-DoF problem (test_compare_ceres_vs_native.cpp:73-136),
a stereo 6-DoF problem (test_6dof_stereo_poseonly_ba.cpp workload), and
planar 3-DoF problems (test_3dof_mono_poseonly_ba.cpp workload).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from bundle_adjustment_solver import Options
from bundle_adjustment_solver.ops import lie
from bundle_adjustment_solver.solvers import pose_only
from bundle_adjustment_solver.utils.synthetic import mono_pose_only_problem


def _pose_error(T_est, T_true):
    dT = np.linalg.inv(T_est) @ T_true
    rot_err = np.linalg.norm(np.asarray(lie.so3_log(jnp.asarray(dT[:3, :3]))))
    trans_err = np.linalg.norm(dT[:3, 3])
    return rot_err, trans_err


def make_options(max_iter=100, thr=1e-6, huber=1.0, outlier=2.5):
    from bundle_adjustment_solver.options import (
        ConvergenceHandle,
        IterationHandle,
        OutlierHandle,
    )

    return Options(
        convergence_handle=ConvergenceHandle(thr, thr),
        outlier_handle=OutlierHandle(huber, outlier),
        iteration_handle=IterationHandle(max_iter),
    )


class TestMono6Dof:
    def test_recovers_truth_small(self):
        """Fast version of the 300k benchmark: 5k points, zero noise."""
        prob = mono_pose_only_problem(num_points=5000, seed=0)
        opts = make_options()
        pose, mask, summary, ok = pose_only.solve_monocular_6dof(
            prob.points, prob.pixels, prob.intrinsics, prob.pose_initial, opts
        )
        assert ok
        rot_err, trans_err = _pose_error(pose, prob.pose_true)
        assert rot_err < 1e-3, f"rotation error {rot_err}"
        assert trans_err < 1e-3, f"translation error {trans_err}"
        assert summary.convergence_status
        assert mask.all()  # zero noise: everything is an inlier

    def test_with_pixel_noise(self):
        prob = mono_pose_only_problem(num_points=5000, seed=1, pixel_noise=0.5)
        opts = make_options()
        pose, mask, summary, ok = pose_only.solve_monocular_6dof(
            prob.points, prob.pixels, prob.intrinsics, prob.pose_initial, opts
        )
        assert ok
        rot_err, trans_err = _pose_error(pose, prob.pose_true)
        assert rot_err < 5e-3
        assert trans_err < 1e-2

    def test_debug_pose_trace(self):
        prob = mono_pose_only_problem(num_points=1000, seed=2)
        opts = make_options(max_iter=30)
        points = jnp.asarray(prob.points, jnp.float32)
        pixels = jnp.asarray(prob.pixels, jnp.float32)
        valid = jnp.ones(points.shape[0], bool)
        res = pose_only.solve_monocular_6dof_jax(
            points,
            pixels,
            valid,
            jnp.asarray(prob.intrinsics, jnp.float32),
            jnp.asarray(prob.pose_initial, jnp.float32),
            opts,
        )
        n = int(res.num_debug)
        assert n >= 1
        # Trace entries are valid SE(3) poses and converge toward the answer.
        for i in range(n):
            T = np.asarray(res.debug_poses[i])
            np.testing.assert_allclose(
                T[:3, :3] @ T[:3, :3].T, np.eye(3), atol=1e-4
            )
        final_from_trace = np.asarray(res.debug_poses[n - 1])
        np.testing.assert_allclose(final_from_trace, np.asarray(res.pose), atol=1e-5)


class TestStereo6Dof:
    def _make_problem(self, n=3000, seed=3, drop_right_frac=0.2):
        rng = np.random.default_rng(seed)
        prob = mono_pose_only_problem(num_points=n, seed=seed, fx=525.0, fy=525.0)
        baseline = 0.12
        T_lr = np.eye(4)
        T_lr[0, 3] = baseline  # left_to_right_pose (test_ba.cpp:82-85)
        T_rl = np.linalg.inv(T_lr)
        T_cw = np.linalg.inv(prob.pose_true)
        local_l = prob.points @ T_cw[:3, :3].T + T_cw[:3, 3]
        local_r = local_l @ T_rl[:3, :3].T + T_rl[:3, 3]
        fx, fy, cx, cy = prob.intrinsics
        pix_r = np.stack(
            [
                fx * local_r[:, 0] / local_r[:, 2] + cx,
                fy * local_r[:, 1] / local_r[:, 2] + cy,
            ],
            axis=-1,
        )
        # Mark a fraction as "no right match" with negative pixels (cpp:298).
        drop = rng.uniform(size=n) < drop_right_frac
        pix_r[drop] = -1.0
        return prob, pix_r, T_lr

    def test_recovers_truth(self):
        prob, pix_r, T_lr = self._make_problem()
        opts = make_options()
        pose, mask_l, mask_r, summary, ok = pose_only.solve_stereo_6dof(
            prob.points,
            prob.pixels,
            pix_r,
            prob.intrinsics,
            prob.intrinsics,
            T_lr,
            prob.pose_initial,
            opts,
        )
        assert ok
        rot_err, trans_err = _pose_error(pose, prob.pose_true)
        assert rot_err < 1e-3
        assert trans_err < 1e-3
        assert summary.convergence_status


class TestPlanar3Dof:
    def _make_problem(self, n=2000, seed=4, stereo=False):
        rng = np.random.default_rng(seed)
        # Base->camera mounting: camera looks along base +x
        # (test_3dof-style robot extrinsic chain).
        from bundle_adjustment_solver.utils.synthetic import _roty, _rotz, _T

        R_bc = _roty(np.pi / 2) @ _rotz(-np.pi / 2)
        base_to_camera = _T(R_bc, np.array([0.1, 0.05, 0.3]))

        # True planar motion of base2<-base1.
        theta_true = np.array([0.3, -0.2, 0.15])
        c, s = np.cos(theta_true[2]), np.sin(theta_true[2])
        T_b2b1 = np.eye(4)
        T_b2b1[:2, :2] = [[c, -s], [s, c]]
        T_b2b1[:2, 3] = theta_true[:2]

        # Points in the base1 frame, in front of the camera (+x of base).
        pts = np.stack(
            [
                rng.uniform(3, 10, n),
                rng.uniform(-3, 3, n),
                rng.uniform(-1, 2, n),
            ],
            axis=-1,
        )
        fx, fy, cx, cy = 525.0, 525.0, 320.0, 240.0
        T_cb = np.linalg.inv(base_to_camera)
        T_c2b1 = T_cb @ T_b2b1
        loc = pts @ T_c2b1[:3, :3].T + T_c2b1[:3, 3]
        pix = np.stack(
            [fx * loc[:, 0] / loc[:, 2] + cx, fy * loc[:, 1] / loc[:, 2] + cy],
            axis=-1,
        )
        # world == base1 frame, so the last frame's camera pose is the rig
        # extrinsic itself: T_wc1 = base_to_camera. The solver extracts the
        # planar prior from T_b2b1 = T_bc (T_wc2)^-1 T_wc1 T_cb (cpp:449-460).
        # True: T_wc2 = T_b2b1^-1 @ base_to_camera (cpp:549-550).
        T_wc2_true = np.linalg.inv(T_b2b1) @ base_to_camera
        # Initial guess: identity planar motion => T_wc2 = base_to_camera.
        T_wc2_init = base_to_camera.copy()

        out = dict(
            points=pts,
            pixels=pix,
            intrinsics=np.array([fx, fy, cx, cy]),
            base_to_camera=base_to_camera,
            T_wlast=base_to_camera.copy(),
            T_wc_init=T_wc2_init,
            T_wc_true=T_wc2_true,
            theta_true=theta_true,
        )
        if stereo:
            T_lr = np.eye(4)
            T_lr[0, 3] = 0.12
            T_rl = np.linalg.inv(T_lr)
            loc_r = loc @ T_rl[:3, :3].T + T_rl[:3, 3]
            pix_r = np.stack(
                [
                    fx * loc_r[:, 0] / loc_r[:, 2] + cx,
                    fy * loc_r[:, 1] / loc_r[:, 2] + cy,
                ],
                axis=-1,
            )
            out["pixels_right"] = pix_r
            out["T_lr"] = T_lr
        return out

    def test_mono_recovers_truth(self):
        p = self._make_problem()
        opts = make_options(max_iter=200)
        pose, mask, summary, ok = pose_only.solve_monocular_planar3dof(
            p["points"],
            p["pixels"],
            p["intrinsics"],
            p["base_to_camera"],
            p["T_wlast"],
            p["T_wc_init"],
            opts,
        )
        assert ok
        rot_err, trans_err = _pose_error(pose, p["T_wc_true"])
        assert rot_err < 1e-3, f"rotation error {rot_err}"
        assert trans_err < 1e-3, f"translation error {trans_err}"

    def test_stereo_recovers_truth(self):
        p = self._make_problem(stereo=True)
        opts = make_options(max_iter=200)
        pose, mask_l, mask_r, summary, ok = pose_only.solve_stereo_planar3dof(
            p["points"],
            p["pixels"],
            p["pixels_right"],
            p["intrinsics"],
            p["intrinsics"],
            p["base_to_camera"],
            p["T_lr"],
            p["T_wlast"],
            p["T_wc_init"],
            opts,
        )
        assert ok
        rot_err, trans_err = _pose_error(pose, p["T_wc_true"])
        assert rot_err < 1e-3
        assert trans_err < 1e-3


class TestBatched:
    def test_batched_mono_matches_single(self):
        B = 8
        probs = [mono_pose_only_problem(num_points=500, seed=s) for s in range(B)]
        opts = make_options(max_iter=50)
        points = jnp.asarray(np.stack([p.points for p in probs]), jnp.float32)
        pixels = jnp.asarray(np.stack([p.pixels for p in probs]), jnp.float32)
        valid = jnp.ones(points.shape[:2], bool)
        intr = jnp.asarray(probs[0].intrinsics, jnp.float32)
        poses0 = jnp.asarray(np.stack([p.pose_initial for p in probs]), jnp.float32)

        batched = pose_only.solve_monocular_6dof_batched(
            points, pixels, valid, intr, poses0, opts
        )
        assert bool(batched.success.all())
        for b in range(B):
            single = pose_only.solve_monocular_6dof_jax(
                points[b], pixels[b], valid[b], intr, poses0[b], opts
            )
            np.testing.assert_allclose(
                np.asarray(batched.pose[b]), np.asarray(single.pose), atol=1e-5
            )
            rot_err, trans_err = _pose_error(
                np.asarray(batched.pose[b]), probs[b].pose_true
            )
            assert rot_err < 2e-3
            assert trans_err < 2e-3


class TestPlanarBatched:
    """Batched planar-3-DoF variants: all four reference modes now have
    frame-parallel versions (SURVEY.md §2 embarrassingly-parallel solve)."""

    def test_batched_planar_mono_matches_single(self):
        import jax.numpy as jnp

        tp = TestPlanar3Dof()
        probs = [tp._make_problem(seed=s) for s in (0, 1, 2)]
        opts = make_options(max_iter=100)
        B = len(probs)
        pts = jnp.asarray(np.stack([p["points"] for p in probs]), jnp.float32)
        pix = jnp.asarray(np.stack([p["pixels"] for p in probs]), jnp.float32)
        valid = jnp.ones(pts.shape[:2], bool)
        intr = jnp.asarray(probs[0]["intrinsics"], jnp.float32)
        bc = jnp.asarray(probs[0]["base_to_camera"], jnp.float32)
        T_wl = jnp.asarray(
            np.stack([p["T_wlast"] for p in probs]), jnp.float32
        )
        T_wc0 = jnp.asarray(
            np.stack([p["T_wc_init"] for p in probs]), jnp.float32
        )
        batched = pose_only.solve_monocular_planar3dof_batched(
            pts, pix, valid, intr, bc, T_wl, T_wc0, opts
        )
        assert bool(batched.success.all())
        for b, p in enumerate(probs):
            single_pose, _, _, ok = pose_only.solve_monocular_planar3dof(
                p["points"], p["pixels"], p["intrinsics"],
                p["base_to_camera"], p["T_wlast"], p["T_wc_init"], opts,
            )
            assert ok
            np.testing.assert_allclose(
                np.asarray(batched.pose[b]), single_pose, atol=1e-5
            )

    def test_batched_planar_stereo_recovers_truth(self):
        import jax.numpy as jnp

        tp = TestPlanar3Dof()
        probs = [tp._make_problem(stereo=True, seed=s) for s in (3, 4)]
        opts = make_options(max_iter=100)
        pts = jnp.asarray(np.stack([p["points"] for p in probs]), jnp.float32)
        pixl = jnp.asarray(np.stack([p["pixels"] for p in probs]), jnp.float32)
        pixr = jnp.asarray(
            np.stack([p["pixels_right"] for p in probs]), jnp.float32
        )
        valid = jnp.ones(pts.shape[:2], bool)
        intr = jnp.asarray(probs[0]["intrinsics"], jnp.float32)
        bc = jnp.asarray(probs[0]["base_to_camera"], jnp.float32)
        T_lr = jnp.asarray(probs[0]["T_lr"], jnp.float32)
        T_wl = jnp.asarray(np.stack([p["T_wlast"] for p in probs]), jnp.float32)
        T_wc0 = jnp.asarray(
            np.stack([p["T_wc_init"] for p in probs]), jnp.float32
        )
        batched = pose_only.solve_stereo_planar3dof_batched(
            pts, pixl, pixr, valid, intr, intr, bc, T_lr, T_wl, T_wc0, opts
        )
        assert bool(batched.success.all())
        for b, p in enumerate(probs):
            err = np.abs(
                np.asarray(batched.pose[b]) - p["T_wc_true"]
            ).max()
            assert err < 1e-3, err


class TestStickyOutlierMask:
    """Options.outlier_mask='reference' reproduces the reference's sticky
    accumulation from iteration 0 (pose_only cpp:95-98)."""

    def _masks(self, outlier_mask):
        import jax.numpy as jnp

        prob = mono_pose_only_problem(num_points=2000, seed=7, pixel_noise=1.0)
        opts = make_options(max_iter=50, outlier=2.0).replace(
            outlier_mask=outlier_mask
        )
        points = jnp.asarray(prob.points, jnp.float32)
        pixels = jnp.asarray(prob.pixels, jnp.float32)
        valid = jnp.ones(points.shape[0], bool)
        res = pose_only.solve_monocular_6dof_jax(
            points,
            pixels,
            valid,
            jnp.asarray(prob.intrinsics, jnp.float32),
            jnp.asarray(prob.pose_initial, jnp.float32),
            opts,
        )
        return prob, opts, res

    @staticmethod
    def _manhattan(prob, T_wc):
        """Replay |r_u|+|r_v| (the reference's error_nonweighted outlier
        statistic, cpp:1404-1406) for a given user-facing pose, in f64."""
        T_cw = np.linalg.inv(np.asarray(T_wc, np.float64))
        X_c = prob.points @ T_cw[:3, :3].T + T_cw[:3, 3]
        fx, fy, cx, cy = prob.intrinsics
        u = fx * X_c[:, 0] / X_c[:, 2] + cx
        v = fy * X_c[:, 1] / X_c[:, 2] + cy
        r = np.stack([u, v], -1) - prob.pixels
        return np.abs(r[:, 0]) + np.abs(r[:, 1])

    def test_reference_mask_is_sticky_and_final_is_not(self):
        prob, opts, res_ref = self._masks("reference")
        _, _, res_fin = self._masks("final")
        mask_ref = np.asarray(res_ref.mask_inlier)
        mask_fin = np.asarray(res_fin.mask_inlier)
        # Same optimized pose either way (the mask never gates the normal
        # equations, exactly like the reference).
        np.testing.assert_allclose(
            np.asarray(res_ref.pose), np.asarray(res_fin.pose), atol=1e-6
        )
        # Sticky can only remove inliers relative to the final-iteration mask.
        assert not np.any(mask_ref & ~mask_fin)
        # The coarse initial guess flags points at iteration 0 that later
        # become inliers -- the modes must genuinely differ on this problem.
        assert mask_ref.sum() < mask_fin.sum(), (
            int(mask_ref.sum()), int(mask_fin.sum()),
        )

    def test_reference_mask_matches_replay(self):
        """The sticky mask equals the AND over iterations of the
        per-iteration outlier gate, replayed from the debug-pose trace."""
        prob, opts, res = self._masks("reference")
        n = int(res.num_iterations)
        thr = opts.outlier_handle.threshold_outlier_rejection
        # Iteration k evaluates the mask at the pose BEFORE its update:
        # the initial pose for k=0, debug_poses[k-1] after.
        poses = [prob.pose_initial] + [
            np.asarray(res.debug_poses[k]) for k in range(n - 1)
        ]
        expected = np.ones(prob.points.shape[0], dtype=bool)
        for T in poses:
            expected &= self._manhattan(prob, T) < thr
        mask = np.asarray(res.mask_inlier)
        # f32 engine vs f64 replay: allow a tiny boundary band.
        disagree = mask != expected
        assert disagree.mean() < 0.005, disagree.sum()


class TestRecordHistory:
    """Options.record_history=False mirrors the reference's summary==nullptr
    mode (pose_only cpp:128-147: no OptimizationInfo pushed): identical
    optimization, one-row history buffers."""

    def test_solution_identical_without_history(self):
        import jax.numpy as jnp

        prob = mono_pose_only_problem(num_points=1500, seed=13, pixel_noise=0.4)
        opts = make_options(max_iter=40)
        points = jnp.asarray(prob.points, jnp.float32)
        pixels = jnp.asarray(prob.pixels, jnp.float32)
        valid = jnp.ones(points.shape[0], bool)
        intr = jnp.asarray(prob.intrinsics, jnp.float32)
        p0 = jnp.asarray(prob.pose_initial, jnp.float32)
        full = pose_only.solve_monocular_6dof_jax(
            points, pixels, valid, intr, p0, opts
        )
        slim = pose_only.solve_monocular_6dof_jax(
            points, pixels, valid, intr, p0,
            opts.replace(record_history=False),
        )
        np.testing.assert_array_equal(
            np.asarray(slim.pose), np.asarray(full.pose)
        )
        assert int(slim.num_iterations) == int(full.num_iterations)
        assert slim.info.shape[0] == 1
        assert slim.debug_poses.shape[0] == 1
        # The single retained row is the last recorded one.
        np.testing.assert_array_equal(
            np.asarray(slim.debug_poses[0]),
            np.asarray(full.debug_poses[int(full.num_debug) - 1]),
        )

    def test_planar_history_off(self):
        import jax.numpy as jnp

        tp = TestPlanar3Dof()
        p = tp._make_problem(seed=9)
        opts = make_options(max_iter=60).replace(record_history=False)
        pose, mask, summary, ok = pose_only.solve_monocular_planar3dof(
            p["points"], p["pixels"], p["intrinsics"], p["base_to_camera"],
            p["T_wlast"], p["T_wc_init"], opts,
        )
        assert ok
        assert np.abs(pose - p["T_wc_true"]).max() < 1e-3


class TestChunkedIterTimes:
    """Options.time_iterations=True: per-iteration wall times in the
    summary (reference pose_only cpp:126/139), identical optimization."""

    def test_mono_chunked_matches_monolithic(self):
        prob = mono_pose_only_problem(num_points=2000, seed=4, pixel_noise=0.5)
        opts = make_options(max_iter=40)
        pose_m, mask_m, sum_m, ok_m = pose_only.solve_monocular_6dof(
            prob.points, prob.pixels, prob.intrinsics, prob.pose_initial, opts
        )
        pose_c, mask_c, sum_c, ok_c = pose_only.solve_monocular_6dof(
            prob.points, prob.pixels, prob.intrinsics, prob.pose_initial,
            opts.replace(time_iterations=True),
        )
        assert ok_m and ok_c
        np.testing.assert_allclose(pose_c, pose_m, atol=1e-5)
        assert (mask_c == mask_m).mean() > 0.995
        infos_m = sum_m.optimization_info_list
        infos_c = sum_c.optimization_info_list
        # The chunked pose round-trips through the user-facing write-back
        # each step (f32), so the stop point may shift by one iteration.
        assert abs(len(infos_c) - len(infos_m)) <= 1
        for a, b in zip(infos_c, infos_m):
            np.testing.assert_allclose(a.cost, b.cost, rtol=1e-4)
        assert all(oi.iter_time > 0.0 for oi in infos_c)
        assert all(oi.iter_time == -1.0 for oi in infos_m)
        assert sum_c.convergence_status == sum_m.convergence_status

    def test_mono_chunked_sticky_mask(self):
        prob = mono_pose_only_problem(num_points=1500, seed=7, pixel_noise=1.0)
        opts = make_options(max_iter=40, outlier=2.0).replace(
            outlier_mask="reference"
        )
        _, mask_m, _, _ = pose_only.solve_monocular_6dof(
            prob.points, prob.pixels, prob.intrinsics, prob.pose_initial, opts
        )
        _, mask_c, _, _ = pose_only.solve_monocular_6dof(
            prob.points, prob.pixels, prob.intrinsics, prob.pose_initial,
            opts.replace(time_iterations=True),
        )
        assert (mask_c == mask_m).mean() > 0.995

    def test_planar_chunked_matches_monolithic(self):
        tp = TestPlanar3Dof()
        p = tp._make_problem(seed=6)
        opts = make_options(max_iter=60)
        pose_m, _, sum_m, ok_m = pose_only.solve_monocular_planar3dof(
            p["points"], p["pixels"], p["intrinsics"], p["base_to_camera"],
            p["T_wlast"], p["T_wc_init"], opts,
        )
        pose_c, _, sum_c, ok_c = pose_only.solve_monocular_planar3dof(
            p["points"], p["pixels"], p["intrinsics"], p["base_to_camera"],
            p["T_wlast"], p["T_wc_init"],
            opts.replace(time_iterations=True),
        )
        assert ok_m and ok_c
        np.testing.assert_allclose(pose_c, pose_m, atol=1e-5)
        assert all(
            oi.iter_time > 0.0 for oi in sum_c.optimization_info_list
        )

    def test_stereo_chunked_matches_monolithic(self):
        ts = TestStereo6Dof()
        prob, pix_r, T_lr = ts._make_problem()
        opts = make_options(max_iter=40)
        args = (
            prob.points, prob.pixels, pix_r, prob.intrinsics,
            prob.intrinsics, T_lr, prob.pose_initial,
        )
        pose_m, ml_m, mr_m, sum_m, ok_m = pose_only.solve_stereo_6dof(
            *args, opts
        )
        pose_c, ml_c, mr_c, sum_c, ok_c = pose_only.solve_stereo_6dof(
            *args, opts.replace(time_iterations=True)
        )
        assert ok_m and ok_c
        np.testing.assert_allclose(pose_c, pose_m, atol=1e-5)
        assert (ml_c == ml_m).mean() > 0.99 and (mr_c == mr_m).mean() > 0.99
        assert all(
            oi.iter_time > 0.0 for oi in sum_c.optimization_info_list
        )


class TestCompactingBatched:
    """Straggler compaction driver (solve_stereo_6dof_batched_compacting):
    must reproduce the plain lockstep solve per frame while retiring
    converged frames between segments (benchmarks/straggler_study.py
    measured 94.7% wasted lockstep passes on a mixed-difficulty batch)."""

    def test_matches_lockstep(self):
        from bundle_adjustment_solver.utils.synthetic import (
            batched_stereo_pose_only_problem,
        )

        B, P = 24, 64
        prob = batched_stereo_pose_only_problem(
            num_frames=B, points_per_frame=P, seed=21, pixel_noise=0.3
        )
        pts = jnp.asarray(prob.points, jnp.float32)
        pixl = jnp.asarray(prob.pixels_left, jnp.float32)
        pixr = jnp.asarray(prob.pixels_right, jnp.float32)
        valid = jnp.ones((B, P), bool)
        intr = jnp.asarray(prob.intrinsics, jnp.float32)
        T_lr = jnp.asarray(prob.pose_left_to_right, jnp.float32)
        poses0 = jnp.asarray(prob.poses_initial, jnp.float32)
        opts = make_options(max_iter=40, thr=1e-6).replace(
            record_history=False
        )

        ref = pose_only.solve_stereo_6dof_batched(
            pts, pixl, pixr, valid, intr, intr, T_lr, poses0, opts
        )
        cmp = pose_only.solve_stereo_6dof_batched_compacting(
            pts, pixl, pixr, valid, intr, intr, T_lr, poses0, opts,
            check_every=6, min_bucket=4,
        )
        assert bool(np.asarray(cmp.converged).all())
        np.testing.assert_array_equal(
            np.asarray(cmp.converged), np.asarray(ref.converged)
        )
        # Per-frame poses agree with the lockstep trajectory (identical GN
        # up to the err_prev reset at segment boundaries).
        np.testing.assert_allclose(
            np.asarray(cmp.pose), np.asarray(ref.pose), atol=1e-4
        )
        # Iteration counts match up to one extra segment per frame.
        d = np.asarray(cmp.num_iterations) - np.asarray(ref.num_iterations)
        assert (d >= -1).all() and (d <= 7).all(), d

    def test_requires_history_off(self):
        with pytest.raises(ValueError):
            pose_only.solve_stereo_6dof_batched_compacting(
                jnp.zeros((2, 8, 3)), jnp.zeros((2, 8, 2)),
                jnp.zeros((2, 8, 2)), jnp.ones((2, 8), bool),
                jnp.zeros(4), jnp.zeros(4), jnp.eye(4),
                jnp.tile(jnp.eye(4), (2, 1, 1)), make_options(),
            )

    def test_requires_shared_rig(self):
        opts = make_options(max_iter=4).replace(record_history=False)
        with pytest.raises(ValueError, match="shared rig"):
            pose_only.solve_monocular_6dof_batched_compacting(
                jnp.zeros((2, 8, 3)), jnp.zeros((2, 8, 2)),
                jnp.ones((2, 8), bool), jnp.zeros((2, 4)),
                jnp.tile(jnp.eye(4), (2, 1, 1)), opts,
            )

    def test_rejects_reference_mask(self):
        """Sticky masks reset at segment boundaries, so the driver must
        refuse outlier_mask='reference' instead of silently diverging from
        the lockstep mask."""
        opts = make_options(max_iter=4).replace(
            record_history=False, outlier_mask="reference"
        )
        with pytest.raises(ValueError, match="outlier_mask"):
            pose_only.solve_stereo_6dof_batched_compacting(
                jnp.zeros((2, 8, 3)), jnp.zeros((2, 8, 2)),
                jnp.zeros((2, 8, 2)), jnp.ones((2, 8), bool),
                jnp.zeros(4), jnp.zeros(4), jnp.eye(4),
                jnp.tile(jnp.eye(4), (2, 1, 1)), opts,
            )

    def test_zero_system_zero_step(self):
        """A frame with no valid observations (compaction padding row) must
        take a ZERO step on the vmap path, not a NaN one -- otherwise pad
        rows never converge and gate every compaction segment."""
        delta = pose_only._damped_solve(jnp.zeros((6, 6)), jnp.zeros(6), 6)
        np.testing.assert_array_equal(np.asarray(delta), np.zeros(6))

    def test_all_invalid_frame_converges_immediately(self):
        """End-to-end form of the padding-row guarantee: an all-invalid
        frame in the vmap batched engine converges on its first iteration
        with an unchanged pose."""
        B, P = 2, 16
        pts = jnp.ones((B, P, 3), jnp.float32)
        pix = jnp.zeros((B, P, 2), jnp.float32)
        valid = jnp.zeros((B, P), bool).at[0].set(True)
        intr = jnp.asarray([500.0, 500.0, 320.0, 240.0], jnp.float32)
        poses0 = jnp.tile(jnp.eye(4, dtype=jnp.float32), (B, 1, 1))
        opts = make_options(max_iter=10, thr=1e-6).replace(
            record_history=False
        )
        res = pose_only.solve_monocular_6dof_batched(
            pts, pix, valid, intr, poses0, opts
        )
        assert bool(np.asarray(res.converged)[1])
        assert int(np.asarray(res.num_iterations)[1]) == 1
        np.testing.assert_allclose(
            np.asarray(res.pose)[1], np.eye(4), atol=1e-6
        )

    def test_mono_matches_lockstep(self):
        from bundle_adjustment_solver.utils.synthetic import (
            batched_stereo_pose_only_problem,
        )

        B, P = 16, 64
        prob = batched_stereo_pose_only_problem(
            num_frames=B, points_per_frame=P, seed=23, pixel_noise=0.3
        )
        pts = jnp.asarray(prob.points, jnp.float32)
        pixl = jnp.asarray(prob.pixels_left, jnp.float32)
        valid = jnp.ones((B, P), bool)
        intr = jnp.asarray(prob.intrinsics, jnp.float32)
        poses0 = jnp.asarray(prob.poses_initial, jnp.float32)
        opts = make_options(max_iter=40, thr=1e-6).replace(
            record_history=False
        )
        ref = pose_only.solve_monocular_6dof_batched(
            pts, pixl, valid, intr, poses0, opts
        )
        cmp = pose_only.solve_monocular_6dof_batched_compacting(
            pts, pixl, valid, intr, poses0, opts,
            check_every=6, min_bucket=4,
        )
        np.testing.assert_array_equal(
            np.asarray(cmp.converged), np.asarray(ref.converged)
        )
        np.testing.assert_allclose(
            np.asarray(cmp.pose), np.asarray(ref.pose), atol=1e-4
        )

    @pytest.mark.parametrize("stereo", [False, True])
    def test_planar_matches_lockstep(self, stereo):
        """Planar restart carry (T_wc = T_wl @ T_cb @ res.pose) must make
        the compacted trajectory match lockstep per frame."""
        from bundle_adjustment_solver.utils.synthetic import (
            batched_planar_pose_only_problem,
        )

        B, P = 16, 64
        prob = batched_planar_pose_only_problem(
            num_frames=B, points_per_frame=P, seed=29, stereo=stereo,
            pixel_noise=0.3,
        )
        pts = jnp.asarray(prob.points, jnp.float32)
        pixl = jnp.asarray(prob.pixels_left, jnp.float32)
        valid = jnp.ones((B, P), bool)
        intr = jnp.asarray(prob.intrinsics, jnp.float32)
        T_bc = jnp.asarray(prob.base_to_camera, jnp.float32)
        T_wl = jnp.asarray(prob.poses_world_to_last, jnp.float32)
        T_wc0 = jnp.asarray(prob.poses_world_to_current_init, jnp.float32)
        opts = make_options(max_iter=40, thr=1e-6).replace(
            record_history=False
        )
        if stereo:
            pixr = jnp.asarray(prob.pixels_right, jnp.float32)
            T_lr = jnp.asarray(prob.pose_left_to_right, jnp.float32)
            ref = pose_only.solve_stereo_planar3dof_batched(
                pts, pixl, pixr, valid, intr, intr, T_bc, T_lr, T_wl,
                T_wc0, opts,
            )
            cmp = pose_only.solve_stereo_planar3dof_batched_compacting(
                pts, pixl, pixr, valid, intr, intr, T_bc, T_lr, T_wl,
                T_wc0, opts, check_every=6, min_bucket=4,
            )
        else:
            ref = pose_only.solve_monocular_planar3dof_batched(
                pts, pixl, valid, intr, T_bc, T_wl, T_wc0, opts
            )
            cmp = pose_only.solve_monocular_planar3dof_batched_compacting(
                pts, pixl, valid, intr, T_bc, T_wl, T_wc0, opts,
                check_every=6, min_bucket=4,
            )
        np.testing.assert_array_equal(
            np.asarray(cmp.converged), np.asarray(ref.converged)
        )
        np.testing.assert_allclose(
            np.asarray(cmp.pose), np.asarray(ref.pose), atol=1e-4
        )


class TestCompactingAutoPolicy:
    """check_every='auto': dispatch-aware boundary
    policy. When the measured dispatch cost dwarfs the kernel work, the
    driver must run ONE lockstep segment and reproduce the lockstep result
    exactly (no segment-boundary err_prev resets)."""

    def _problem(self):
        from bundle_adjustment_solver.utils.synthetic import (
            batched_stereo_pose_only_problem,
        )

        B, P = 16, 64
        prob = batched_stereo_pose_only_problem(
            num_frames=B, points_per_frame=P, seed=5, pixel_noise=0.3
        )
        return (
            jnp.asarray(prob.points, jnp.float32),
            jnp.asarray(prob.pixels_left, jnp.float32),
            jnp.asarray(prob.pixels_right, jnp.float32),
            jnp.ones((B, P), bool),
            jnp.asarray(prob.intrinsics, jnp.float32),
            jnp.asarray(prob.pose_left_to_right, jnp.float32),
            jnp.asarray(prob.poses_initial, jnp.float32),
        )

    def test_expensive_dispatch_collapses_to_lockstep(self, monkeypatch):
        pts, pixl, pixr, valid, intr, T_lr, poses0 = self._problem()
        opts = make_options(max_iter=30, thr=1e-6).replace(
            record_history=False
        )
        ref = pose_only.solve_stereo_6dof_batched(
            pts, pixl, pixr, valid, intr, intr, T_lr, poses0, opts
        )
        monkeypatch.setattr(pose_only, "_DISPATCH_MS", 1e9)
        auto = pose_only.solve_stereo_6dof_batched_compacting(
            pts, pixl, pixr, valid, intr, intr, T_lr, poses0, opts,
            check_every="auto", min_bucket=4,
        )
        # One segment => bitwise-identical trajectory to lockstep,
        # including per-frame iteration counts.
        np.testing.assert_array_equal(
            np.asarray(auto.num_iterations), np.asarray(ref.num_iterations)
        )
        np.testing.assert_array_equal(
            np.asarray(auto.pose), np.asarray(ref.pose)
        )

    def test_cheap_dispatch_still_matches(self, monkeypatch):
        pts, pixl, pixr, valid, intr, T_lr, poses0 = self._problem()
        opts = make_options(max_iter=30, thr=1e-6).replace(
            record_history=False
        )
        ref = pose_only.solve_stereo_6dof_batched(
            pts, pixl, pixr, valid, intr, intr, T_lr, poses0, opts
        )
        monkeypatch.setattr(pose_only, "_DISPATCH_MS", 1e-6)
        auto = pose_only.solve_stereo_6dof_batched_compacting(
            pts, pixl, pixr, valid, intr, intr, T_lr, poses0, opts,
            check_every="auto", min_bucket=4,
        )
        np.testing.assert_array_equal(
            np.asarray(auto.converged), np.asarray(ref.converged)
        )
        np.testing.assert_allclose(
            np.asarray(auto.pose), np.asarray(ref.pose), atol=1e-5
        )

    def test_one_segment_regime_delegates_once(self, monkeypatch):
        """The explicit never-lose bound, expressed
        deterministically: when dispatch dwarfs kernel work, the auto
        policy must DELEGATE to the lockstep solver exactly once and hand
        back its result unchanged -- the structural guarantee behind the
        wall-clock bound `benchmarks/straggler_study.py::NEVER_LOSE_BOUND`
        asserts on hardware."""
        pts, pixl, pixr, valid, intr, T_lr, poses0 = self._problem()
        opts = make_options(max_iter=30, thr=1e-6).replace(
            record_history=False
        )
        real_solver = pose_only.solve_stereo_6dof_batched
        calls = []

        def counting_solver(*a, **kw):
            calls.append(1)
            return real_solver(*a, **kw)

        monkeypatch.setattr(pose_only, "_DISPATCH_MS", 1e9)
        # Warm the one-time economics calibration (cached per solver/shape,
        # amortized to zero in serving) BEFORE counting: the bound is on
        # the steady state.
        pose_only.solve_stereo_6dof_batched_compacting(
            pts, pixl, pixr, valid, intr, intr, T_lr, poses0, opts,
            check_every="auto", min_bucket=4,
        )
        monkeypatch.setattr(
            pose_only, "solve_stereo_6dof_batched", counting_solver
        )
        auto = pose_only.solve_stereo_6dof_batched_compacting(
            pts, pixl, pixr, valid, intr, intr, T_lr, poses0, opts,
            check_every="auto", min_bucket=4,
        )
        # Exactly one lockstep dispatch: zero extra kernel passes, zero
        # extra round trips -- "never lose" by construction.
        assert len(calls) == 1
        ref = real_solver(
            pts, pixl, pixr, valid, intr, intr, T_lr, poses0, opts
        )
        np.testing.assert_array_equal(
            np.asarray(auto.pose), np.asarray(ref.pose)
        )
