"""Device capability, compile cache, trace reduction and the GPU-only entry
points, checked on the CPU backend.

The GPU itself is never needed here: the routing predicate is exercised by
patching the backend name, the trace reduction by a small hand-built GPU
trace, and the measurement entry points by their refusal to run without a
GPU.
"""

import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bundle_adjustment_solver.models.problem import ProblemShape
from bundle_adjustment_solver.options import Options
from bundle_adjustment_solver.solvers import full_ba
from bundle_adjustment_solver.utils import device, profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("env_set", [True, False], ids=["env", "default"])
def test_compile_cache_dir(env_set, monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    if env_set:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        path = device.enable_compile_cache()
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    if env_set:
        assert path == str(tmp_path)
    else:
        # A fixed directory inside the checkout, listed in .gitignore.
        assert path == os.path.join(REPO, ".jax_cache")
        with open(os.path.join(REPO, ".gitignore")) as f:
            assert ".jax_cache/" in f.read().split()


@pytest.mark.parametrize("backend", ["gpu", "cpu", "metal"])
def test_on_gpu_predicate(backend, monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    assert device.on_gpu() == (backend == "gpu")
    if backend != "gpu":
        with pytest.raises(RuntimeError, match="no GPU"):
            device.require_gpu()


def _shape(num_poses, num_observations):
    return ProblemShape(
        num_poses=num_poses, num_points=num_observations // 12,
        num_observations=num_observations, num_opt_poses=num_poses - 2,
        num_opt_points=num_observations // 12, num_cameras=2, scale=0.01,
    )


@pytest.mark.parametrize(
    "backend,num_poses,num_obs,mode",
    [
        ("gpu", 10_000, 12_000_000, "pm"),  # the flagship
        ("cpu", 10_000, 12_000_000, "cg"),
        ("gpu", 5_000, 150_000, "cg"),  # below the point-major threshold
        ("gpu", 300, 20_000, "dense"),
    ],
)
def test_auto_routing(backend, num_poses, num_obs, mode, monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    assert full_ba._resolve_mode(_shape(num_poses, num_obs), Options()) == mode
    # An explicit choice is never overridden.
    opts = Options(reduced_system="cg")
    assert full_ba._resolve_mode(_shape(num_poses, num_obs), opts) == "cg"


def test_layout_auto_builds_on_device_only_on_gpu(monkeypatch):
    from bundle_adjustment_solver.solvers.full_ba_pm import (
        pm_problem_from_arrays,
    )
    from bundle_adjustment_solver.utils.synthetic import (
        corridor_ba_problem,
    )

    prob = corridor_ba_problem(num_poses=10, num_points=120, window=3, seed=2)
    args = (prob.cameras, prob.poses_initial, prob.points_initial,
            prob.obs_camera, prob.obs_pose, prob.obs_point, prob.obs_pixel)
    # The layout cache exists only for the device build.
    with pytest.raises(ValueError, match="return_cache"):
        pm_problem_from_arrays(*args, layout="auto", return_cache=True)
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    res = pm_problem_from_arrays(*args, layout="auto", return_cache=True)
    assert len(res) == 5


def _gpu_trace(events, line="Stream #7(compute)", extra_lines=()):
    """A one-plane GPU XSpace: `events` = (name, start_ns, dur_ns, tf_op)."""
    meta = {}
    evs = []
    for name, start, dur, op in events:
        mid = meta.setdefault(name, len(meta) + 1)
        stat = (f' stats {{ metadata_id: 1 str_value: "{op}" }}'
                if op else "")
        evs.append(f"events {{ metadata_id: {mid} offset_ps: "
                   f"{int(start * 1000)} duration_ps: {int(dur * 1000)}"
                   f"{stat} }}")
    lines = [f'lines {{ id: 1 name: "{line}" timestamp_ns: 0 '
             + " ".join(evs) + " }"]
    for i, name in enumerate(extra_lines):
        lines.append(
            f'lines {{ id: {i + 2} name: "{name}" timestamp_ns: 0 '
            f"events {{ metadata_id: 1 offset_ps: 0 duration_ps: "
            f"{10**12} }} }}"
        )
    md = " ".join(
        f'event_metadata {{ key: {i} value {{ id: {i} name: "{n}" }} }}'
        for n, i in meta.items()
    )
    text = (
        'planes { id: 1 name: "/device:GPU:0" ' + " ".join(lines) + " " + md
        + ' stat_metadata { key: 1 value { id: 1 name: "tf_op" } } }'
    )
    return jax.profiler.ProfileData.from_serialized_xspace(
        jax.profiler.ProfileData.text_proto_to_serialized_xspace(text)
    )


def _two_lm_iterations(extra_lines=()):
    asm = "jit(_solve_pm_jax)/while/body/pm_assemble/mul"
    mv = "jit(_solve_pm_jax)/while/body/pm_matvec/scatter"
    return _gpu_trace(
        [
            ("fusion_a", 0, 3000, asm),
            ("scatter_a", 3000, 1000, asm),
            ("fusion_m", 5000, 2000, mv),  # 1 us idle before it
            ("fusion_a", 10000, 3000, asm),
            ("scatter_a", 13000, 1000, asm),
            ("fusion_m", 14000, 2000, mv),
        ],
        extra_lines=extra_lines,
    )


@pytest.mark.parametrize("derived", [False, True], ids=["streams", "derived"])
def test_trace_reduction(derived):
    """Iteration times from `pm_assemble` scope runs, busy time as the union
    of kernel intervals, and kernel totals by name; lines derived from the
    streams (e.g. one spanning the module) must not count."""
    prof = _two_lm_iterations(("XLA Modules",) if derived else ())
    events = profiling.device_events(prof)
    assert len(events) == 6
    np.testing.assert_allclose(
        profiling.iteration_times_ms(events, "pm_assemble"), [0.01, 0.006]
    )
    s = profiling.device_summary(events, top=2)
    assert s["window_ms"] == pytest.approx(0.016)
    assert s["busy_ms"] == pytest.approx(0.012)
    assert s["idle_share"] == pytest.approx(0.25)
    assert [o["name"] for o in s["top_ops"]] == ["fusion_a", "fusion_m"]
    assert s["top_ops"][0]["count"] == 2
    split = profiling.scope_breakdown(events)
    assert split["pm_assemble"] == pytest.approx(0.008)
    assert split["pm_matvec"] == pytest.approx(0.004)
    assert split["pm_cost"] == split["other"] == 0.0
    # One LM iteration whose assembly XLA split into two runs.
    np.testing.assert_allclose(
        profiling.iteration_times_ms(events, "pm_assemble", 1), [0.016]
    )
    with pytest.raises(RuntimeError, match="split"):
        profiling.iteration_times_ms(events, "pm_assemble", 3)
    with pytest.raises(RuntimeError, match="pm_cost"):
        profiling.iteration_times_ms(events, "pm_cost")


def test_trace_without_gpu_refuses(tmp_path):
    """A CPU trace has no GPU plane: the reduction raises instead of
    returning an empty (or host-clock) answer."""
    f = jax.jit(lambda x: jnp.sin(x).sum())
    x = jnp.ones(128)
    f(x).block_until_ready()
    with jax.profiler.trace(str(tmp_path)):
        f(x).block_until_ready()
    with pytest.raises(RuntimeError, match="GPU"):
        profiling.device_events(profiling.load_profile(str(tmp_path)))
    with pytest.raises(RuntimeError, match="no profiler trace"):
        profiling.load_profile(str(tmp_path / "empty"))


def test_chip_smoke_device_check_refuses_cpu():
    import chip_smoke

    with pytest.raises(RuntimeError, match="no GPU"):
        chip_smoke.phase0_device(1)


def _run(script_dir, *args):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH="")
    return subprocess.run(
        [sys.executable, "chip_smoke.py", *args], cwd=script_dir, env=env,
        capture_output=True, text=True, timeout=300,
    )


def _printed_result(stdout):
    for line in stdout.splitlines():
        try:
            if "ok" in json.loads(line):
                return True
        except ValueError:
            continue
    return False


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_exits_nonzero_without_gpu(where, tmp_path):
    """On a CPU-only machine, and in a directory holding chip_smoke.py and
    nothing else of the repository, the script fails and prints no
    result line."""
    if where == "alone":
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
        proc = _run(tmp_path)
    else:
        proc = _run(REPO)
        assert "no GPU" in proc.stderr
    assert proc.returncode != 0
    assert not _printed_result(proc.stdout)


def test_bench_refuses_cpu():
    import bench

    with pytest.raises(RuntimeError, match="no GPU"):
        bench.main()
