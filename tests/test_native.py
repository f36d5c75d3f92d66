"""Tests for the native problem compiler (csrc/problem_compiler.cpp) and its
numpy fallbacks: both paths must agree exactly."""

import numpy as np
import pytest

from bundle_adjustment_solver.utils import native


@pytest.fixture(scope="module")
def lib():
    return native.get_lib()


def test_native_library_builds(lib):
    # The toolchain is part of the environment contract; the native path
    # must actually be exercised in CI, not silently fall back.
    assert lib is not None, "native problem compiler failed to build"


def test_sort_by_segments_matches_lexsort(rng):
    n = 100_000
    point_opt = rng.integers(0, 500, n).astype(np.int32)
    pose_opt = rng.integers(0, 60, n).astype(np.int32)
    order_native = native.sort_by_segments(point_opt, pose_opt, 500, 60)
    order_numpy = np.lexsort((pose_opt, point_opt))
    np.testing.assert_array_equal(order_native, order_numpy)


def test_sort_is_stable(rng):
    n = 10_000
    point_opt = rng.integers(0, 5, n).astype(np.int32)
    pose_opt = rng.integers(0, 3, n).astype(np.int32)
    order = native.sort_by_segments(point_opt, pose_opt, 5, 3)
    keys = point_opt[order].astype(np.int64) * 3 + pose_opt[order]
    assert (np.diff(keys) >= 0).all()
    # stability: original indices increase within equal keys
    same = np.diff(keys) == 0
    assert (np.diff(order)[same] > 0).all()


def test_connectivity_counts(rng):
    obs_pose = np.array([0, 0, 0, 1, 1, 2, 2, 2, 2], dtype=np.int32)
    obs_point = np.array([0, 0, 1, 1, 2, 0, 1, 2, 3], dtype=np.int32)
    ppp, ppt = native.connectivity(obs_pose, obs_point, 3, 4)
    # pose 0 sees points {0,1}; pose 1 sees {1,2}; pose 2 sees {0,1,2,3}
    np.testing.assert_array_equal(ppp, [2, 2, 4])
    # point 0 seen by poses {0,2}; 1 by {0,1,2}; 2 by {1,2}; 3 by {2}
    np.testing.assert_array_equal(ppt, [2, 3, 2, 1])


def test_connectivity_matches_fallback(rng):
    n = 50_000
    obs_pose = rng.integers(0, 40, n).astype(np.int32)
    obs_point = rng.integers(0, 2000, n).astype(np.int32)
    ppp_n, ppt_n = native.connectivity(obs_pose, obs_point, 40, 2000)
    pairs = np.unique(np.stack([obs_pose, obs_point], -1), axis=0)
    ppp_f = np.bincount(pairs[:, 0], minlength=40).astype(np.int32)
    ppt_f = np.bincount(pairs[:, 1], minlength=2000).astype(np.int32)
    np.testing.assert_array_equal(ppp_n, ppp_f)
    np.testing.assert_array_equal(ppt_n, ppt_f)


def test_partition_landmarks_covers_and_balances(rng):
    m = 10_000
    counts = rng.integers(0, 20, m).astype(np.int64)
    total = int(counts.sum())
    cuts = native.partition_landmarks(counts, total, 8)
    assert cuts[0] == 0 and cuts[-1] == m
    assert (np.diff(cuts) >= 0).all()
    per_shard = np.array(
        [counts[cuts[s]:cuts[s + 1]].sum() for s in range(8)]
    )
    assert per_shard.sum() == total
    assert per_shard.max() <= 2 * per_shard.mean() + 20


def test_builder_connectivity_warnings():
    from bundle_adjustment_solver.models.camera import Camera
    from bundle_adjustment_solver.models.problem import (
        FullBundleAdjustmentSolver,
    )

    solver = FullBundleAdjustmentSolver()
    solver.add_camera(0, Camera(100.0, 100.0, 50.0, 50.0))
    for j in range(2):
        T = np.eye(4)
        T[0, 3] = j * 0.1
        solver.add_pose(j, T)
    for i in range(3):
        solver.add_point(i, np.array([0.1 * i, 0.0, 2.0]))
    # pose 0 sees all 3 points; pose 1 sees only point 0.
    for i in range(3):
        solver.add_observation(0, 0, i, np.array([50.0, 50.0]))
    solver.add_observation(0, 1, 0, np.array([50.0, 50.0]))
    warnings = solver.check_connectivity()
    assert any("0-th pose" in w for w in warnings)  # sees 3 < 5 points
    assert any("1-th pose" in w for w in warnings)
    assert any("1-th point" in w for w in warnings)  # seen by 1 < 2 poses
    assert any("2-th point" in w for w in warnings)


def _random_layout_inputs(rng, M=800, N=40, C=2, O=6000, dedup=True):
    obs_point = rng.integers(0, M, O).astype(np.int32)
    obs_pose = rng.integers(0, N, O).astype(np.int32)
    obs_cam = rng.integers(0, C, O).astype(np.int32)
    if dedup:
        tr = (obs_point.astype(np.int64) * (N * C)
              + obs_pose.astype(np.int64) * C + obs_cam)
        _, idx = np.unique(tr, return_index=True)
        obs_point, obs_pose, obs_cam = (
            obs_point[idx], obs_pose[idx], obs_cam[idx]
        )
    O = obs_point.size
    obs_pixel = rng.normal(size=(O, 2))
    points = rng.normal(size=(M, 3))
    n_opt = N - 2
    pose_opt_of = np.arange(N, dtype=np.int32)
    pose_opt_of[-2:] = n_opt
    point_is_opt = rng.uniform(size=M) < 0.9
    return (obs_pose, obs_point, obs_cam, obs_pixel, points, pose_opt_of,
            point_is_opt, n_opt, C)


class TestPointMajorNativePath:
    """The native fill/windows path must agree BIT-EXACTLY with the numpy
    fallback of models/layout.build_point_major (same planes, same gather
    windows), and both must reject duplicate (point, pose, camera)
    observations -- the native path detects them during the fill
    (csrc ba_pm_fill rc=-4) instead of a separate uniqueness pre-pass."""

    def _build_both(self, args, **kw):
        from bundle_adjustment_solver.models import layout

        a = layout.build_point_major(*args, **kw)
        lib, tried = native._LIB, native._TRIED
        try:
            native._LIB, native._TRIED = None, True  # force numpy fallback
            b = layout.build_point_major(*args, **kw)
        finally:
            native._LIB, native._TRIED = lib, tried
        return a, b

    def test_native_matches_numpy_bitexact(self, lib, rng):
        assert lib is not None
        (obs_pose, obs_point, obs_cam, obs_pixel, points, pose_opt_of,
         point_is_opt, n_opt, C) = _random_layout_inputs(rng)
        kw = dict(num_cameras=C, scale=1.0, num_opt_poses=n_opt,
                  block_points=128, max_slots=32, max_window=2048)
        a, b = self._build_both(
            (obs_pose, obs_point, obs_cam, obs_pixel, points, pose_opt_of,
             point_is_opt), **kw)
        assert a is not None and b is not None
        pa, sa = a
        pb, sb = b
        assert sa == sb
        for name in ("obs_f32", "slot_pose", "slot_opt", "X", "point_ref",
                     "gbase", "sbase"):
            np.testing.assert_array_equal(
                np.asarray(getattr(pa, name)), np.asarray(getattr(pb, name)),
                err_msg=name,
            )

    def test_duplicate_observation_rejected_both_paths(self, lib, rng):
        assert lib is not None
        obs_point = np.array([0, 1, 1, 2, 1], np.int32)
        obs_pose = np.array([3, 5, 5, 7, 5], np.int32)  # rows 1,2,4 repeat
        obs_cam = np.array([0, 0, 0, 1, 0], np.int32)
        obs_pixel = rng.normal(size=(5, 2))
        points = np.ones((3, 3))
        pose_opt_of = np.arange(8, dtype=np.int32)
        kw = dict(num_cameras=2, scale=1.0, num_opt_poses=8,
                  block_points=128, max_slots=8, max_window=2048)
        a, b = self._build_both(
            (obs_pose, obs_point, obs_cam, obs_pixel, points, pose_opt_of,
             np.ones(3, bool)), **kw)
        assert a is None and b is None

    def test_pm_windows_raw_extrema(self, lib):
        if lib is None or not hasattr(lib, "ba_pm_windows"):
            pytest.skip("native pm_windows unavailable")
        kp, C, mp, bm = 2, 1, 256, 128  # 2 blocks
        slot_pose = np.zeros((kp, mp), np.int32)
        slot_opt = np.full((kp, mp), -1, np.int32)
        valid = np.zeros((kp * C, mp), np.float32)
        # block 0: one observed cell (slot 1, row 5) with pose 7, opt 3
        slot_pose[1, 5] = 7
        slot_opt[1, 5] = 3
        valid[1, 5] = 1.0
        # block 1: empty (padding) -> sentinel extrema
        win = native.pm_windows(slot_pose, slot_opt, valid, kp, C, mp, bm)
        assert win is not None
        gmin, gmax, smin, smax = win
        np.testing.assert_array_equal(gmin, [7, np.iinfo(np.int32).max])
        np.testing.assert_array_equal(gmax, [7, -1])
        np.testing.assert_array_equal(smin, [3, np.iinfo(np.int32).max])
        np.testing.assert_array_equal(smax, [3, -1])


def test_finalize_obs_matches_sort_plus_gather(lib, rng):
    """ba_finalize_obs (fused counting-sort + whole-table permute with the
    pixel scale folded in) must equal sort_by_segments + fancy-index
    gathers bit-for-bit."""
    if lib is None or not hasattr(lib, "ba_finalize_obs"):
        pytest.skip("native finalize_obs unavailable")
    n, n_keys_pt, n_keys_ps = 40_000, 900, 50
    point_opt = rng.integers(0, n_keys_pt, n).astype(np.int32)
    pose_opt = rng.integers(0, n_keys_ps, n).astype(np.int32)
    cam = rng.integers(0, 2, n).astype(np.int32)
    pose = rng.integers(0, 60, n).astype(np.int32)
    point = rng.integers(0, 5000, n).astype(np.int32)
    pixel = rng.normal(size=(n, 2))
    scale = 0.01
    out = native.finalize_obs(
        point_opt, pose_opt, cam, pose, point, pixel, scale,
        n_keys_pt, n_keys_ps,
    )
    assert out is not None
    order = native.sort_by_segments(point_opt, pose_opt, n_keys_pt, n_keys_ps)
    want = (cam[order], pose[order], point[order], (pixel * scale)[order],
            pose_opt[order], point_opt[order])
    for got, ref, name in zip(
        out, want, ("cam", "pose", "point", "pixel", "pose_opt", "point_opt")
    ):
        np.testing.assert_array_equal(got, ref, err_msg=name)


def test_stale_abi_version_rejected(tmp_path, monkeypatch):
    """A cached .so reporting an old (or missing) ABI version must be
    rejected entirely -- e.g. a pre-duplicate-detection ba_pm_fill would
    silently corrupt problems now that the caller trusts the in-fill
    check -- so every entry point uses its numpy fallback."""
    import subprocess

    src = tmp_path / "stub.cpp"
    src.write_text(
        'extern "C" { long long ba_abi_version(void) { return 1; } }'
    )
    so = tmp_path / "stub.so"
    subprocess.run(
        ["g++", "-shared", "-fPIC", str(src), "-o", str(so)], check=True
    )
    monkeypatch.setattr(native, "_build", lambda: so)
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_TRIED", False)
    assert native.get_lib() is None


def test_pm_fill_error_codes(lib, rng):
    """Undersized kp (rc=-2) and out-of-range camera (rc=-3) must surface
    as None (fallback), not as silently truncated planes."""
    if lib is None:
        pytest.skip("native unavailable")
    # 1 point observed by 3 poses, but kp=2.
    obs_point = np.zeros(3, np.int32)
    obs_pose = np.array([0, 1, 2], np.int32)
    obs_cam = np.zeros(3, np.int32)
    pix = rng.normal(size=(3, 2))
    pts = np.ones((1, 3))
    poo = np.arange(4, dtype=np.int32)
    rop = np.zeros(1, np.int32)
    out = native.pm_fill(obs_pose, obs_point, obs_cam, pix, pts, poo,
                         np.ones(1, np.uint8), rop, n_opt=4, num_cams=1,
                         kp=2, mp=128)
    assert out is None
    # camera index out of range (num_cams=1, cam id 1).
    out = native.pm_fill(obs_pose, obs_point, np.array([0, 1, 0], np.int32),
                         pix, pts, poo, np.ones(1, np.uint8), rop,
                         n_opt=4, num_cams=1, kp=4, mp=128)
    assert out is None


class TestDeviceLayoutBuild:
    """build_point_major_device (XLA sort+scatter on the accelerator) must
    agree BIT-EXACTLY with the host builders -- planes, windows, shape --
    and take the same fallbacks (duplicate observation, slots bound)."""

    def _build_device(self, args, **kw):
        from bundle_adjustment_solver.models import layout

        (obs_pose, obs_point, obs_cam, obs_pixel, points, pose_opt_of,
         point_is_opt) = args
        scale = kw.pop("scale")
        return layout.build_point_major_device(
            obs_pose, obs_point, obs_cam,
            (np.asarray(obs_pixel, np.float64) * scale).astype(np.float32),
            (np.asarray(points, np.float64) * scale).astype(np.float32),
            pose_opt_of, point_is_opt, scale=scale, **kw,
        )

    def test_device_matches_host_bitexact(self, rng):
        from bundle_adjustment_solver.models import layout

        for seed_extra in range(3):
            (obs_pose, obs_point, obs_cam, obs_pixel, points, pose_opt_of,
             point_is_opt, n_opt, C) = _random_layout_inputs(rng)
            args = (obs_pose, obs_point, obs_cam, obs_pixel, points,
                    pose_opt_of, point_is_opt)
            kw = dict(num_cameras=C, scale=1.0, num_opt_poses=n_opt,
                      block_points=128, max_slots=32, max_window=2048)
            a = layout.build_point_major(*args, **kw)
            b = self._build_device(args, **kw)
            assert (a is None) == (b is None)
            if a is None:
                continue
            pa, sa = a
            pb, sb = b
            assert sa == sb
            for name in pa._fields:
                np.testing.assert_array_equal(
                    np.asarray(getattr(pa, name)),
                    np.asarray(getattr(pb, name)),
                    err_msg=f"plane {name} differs (device vs host)",
                )

    def test_device_duplicate_fallback(self, rng):
        (obs_pose, obs_point, obs_cam, obs_pixel, points, pose_opt_of,
         point_is_opt, n_opt, C) = _random_layout_inputs(rng)
        obs_pose = np.concatenate([obs_pose, obs_pose[:1]])
        obs_point = np.concatenate([obs_point, obs_point[:1]])
        obs_cam = np.concatenate([obs_cam, obs_cam[:1]])
        obs_pixel = np.concatenate([obs_pixel, obs_pixel[:1]])
        out = self._build_device(
            (obs_pose, obs_point, obs_cam, obs_pixel, points, pose_opt_of,
             point_is_opt),
            num_cameras=C, scale=1.0, num_opt_poses=n_opt,
        )
        assert out is None

    def test_device_slots_bound_fallback(self, rng):
        (obs_pose, obs_point, obs_cam, obs_pixel, points, pose_opt_of,
         point_is_opt, n_opt, C) = _random_layout_inputs(rng)
        out = self._build_device(
            (obs_pose, obs_point, obs_cam, obs_pixel, points, pose_opt_of,
             point_is_opt),
            num_cameras=C, scale=1.0, num_opt_poses=n_opt, max_slots=1,
        )
        assert out is None

    def test_layout_cache_refill(self, rng):
        """PMLayoutCache.refill with new pixel/point values must equal a
        fresh device build on those values; pixel-only refill keeps X."""
        from bundle_adjustment_solver.models import layout

        (obs_pose, obs_point, obs_cam, obs_pixel, points, pose_opt_of,
         point_is_opt, n_opt, C) = _random_layout_inputs(rng)
        pix = np.asarray(obs_pixel, np.float32)
        pts = np.asarray(points, np.float32)
        pm, sh, cache = layout.build_point_major_device(
            obs_pose, obs_point, obs_cam, pix, pts, pose_opt_of,
            point_is_opt, num_cameras=C, scale=1.0, num_opt_poses=n_opt,
            return_cache=True,
        )
        pix2, pts2 = pix + 0.25, pts - 0.5
        fresh = layout.build_point_major_device(
            obs_pose, obs_point, obs_cam, pix2, pts2, pose_opt_of,
            point_is_opt, num_cameras=C, scale=1.0, num_opt_poses=n_opt,
        )
        assert fresh is not None
        pm_fresh, sh_fresh = fresh
        assert sh_fresh == sh
        pm_re = cache.refill(pm, pix2, pts2)
        for name in pm_re._fields:
            np.testing.assert_array_equal(
                np.asarray(getattr(pm_fresh, name)),
                np.asarray(getattr(pm_re, name)),
                err_msg=f"refill plane {name} differs from fresh build",
            )
        pm_px = cache.refill(pm, pix2)
        np.testing.assert_array_equal(
            np.asarray(pm_px.X), np.asarray(pm.X)
        )
