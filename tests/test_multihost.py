"""True multi-process mesh test: 2 `jax.distributed` CPU processes, one
global 8-device mesh, both distributed engines to parity with a local solve.

This is the only way, in this environment, to execute the multi-host entry
(`parallel.mesh.initialize_distributed`) and cross-process collectives for
real: each subprocess owns 4 virtual CPU devices and psums cross the process
boundary via Gloo.

Runs `tools/multihost_dryrun.py` in 2 fresh subprocesses (the current test
process already owns an initialized single-process backend and cannot join a
distributed rig).
"""

import json
import os
import socket
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_mesh_parity(tmp_path):
    port = _free_port()
    env = dict(os.environ)
    # Fresh processes run on the CPU backend with a clean import path.
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = ""
    env.pop("XLA_FLAGS", None)

    procs = []
    outs = []
    for pid in range(2):
        out = tmp_path / f"mh{pid}.json"
        outs.append(out)
        procs.append(
            subprocess.Popen(
                [
                    sys.executable,
                    os.path.join(REPO, "tools", "multihost_dryrun.py"),
                    "--coordinator", f"localhost:{port}",
                    "--num-processes", "2",
                    "--process-id", str(pid),
                    "--out", str(out),
                ],
                cwd=REPO,
                env=env,
                stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT,
                text=True,
            )
        )
    logs = [p.communicate(timeout=570)[0] for p in procs]
    for pid, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"process {pid} failed:\n{log[-4000:]}"

    results = [json.loads(o.read_text()) for o in outs]
    for r in results:
        assert r["ok"]
        assert r["num_processes"] == 2
        assert r["global_devices"] == 8
        # Parity asserted in-process; echoed values must agree across hosts.
        assert r["sharded_ba_cost"] == results[0]["sharded_ba_cost"]
        assert r["sharded_pm_cost"] == results[0]["sharded_pm_cost"]
    # The machine-readable collective-volume model is part of the artifact
    # (pose-sharded engine: reduce-scatter panel + per-CG gather/scatter +
    # pose-row gather + scalars).
    cm = results[0]["comm_model"]
    assert cm["pose_sharded"] is True
    assert cm["total_bytes_per_lm_iter"] == (
        cm["assembly_panel_bytes"]
        + cm["cg_iterations_per_lm"] * cm["cg_bytes_per_cg_iter"]
        + cm["pose_row_gather_bytes"]
        + cm["scalar_bytes_per_lm_iter"]
    )
    # Cross-process psum wall times (loopback Gloo, CPU devices).
    lat = results[0]["gloo_collective_latency"]
    assert len(lat) == 3 and all(r["median_ms"] > 0 for r in lat)
