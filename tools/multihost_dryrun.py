#!/usr/bin/env python
"""Multi-host dryrun: one process of an N-process `jax.distributed` rig.

Exercises the TRUE multi-host code path (BASELINE north star: "10k poses /
1M landmarks sharded across N>=2 hosts") within a single machine: each
process owns `--local-devices` virtual CPU devices, `jax.distributed`
connects them into one global mesh (collectives cross process boundaries
via Gloo), and BOTH distributed engines run one LM step
to numerical parity with a process-local single-device solve.

Launch (the test harness `tests/test_multihost.py` does this):

    PYTHONPATH= python tools/multihost_dryrun.py \
        --coordinator localhost:PORT --num-processes 2 --process-id K \
        --out /tmp/resultK.json

Every process builds the same seeded problem; global arrays are formed with
`mesh.to_global` (device_put with a global NamedSharding -- jit cannot
auto-shard host-local arrays across processes). Only replicated outputs are
fetched. Process 0 also writes the per-LM-iteration psum volume model
(`parallel.sharded_pm.comm_volume_model`) into the result JSON.

The reference has no distributed layer at all (SURVEY.md section 2); this
file is cited by PARITY.md's parallelism rows.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--num-processes", type=int, default=2)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--local-devices", type=int, default=4)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", args.local_devices)

    from bundle_adjustment_solver.parallel.mesh import (
        data_mesh,
        initialize_distributed,
        to_global,
    )

    initialize_distributed(
        args.coordinator, args.num_processes, args.process_id
    )
    assert jax.process_count() == args.num_processes
    n_global = len(jax.devices())
    assert n_global == args.num_processes * args.local_devices
    assert len(jax.local_devices()) == args.local_devices

    import numpy as np

    from bundle_adjustment_solver.options import (
        ConvergenceHandle,
        IterationHandle,
        Options,
        SolverType,
    )
    from bundle_adjustment_solver.parallel import sharded_ba, sharded_pm
    from bundle_adjustment_solver.solvers import full_ba, full_ba_pm
    from __graft_entry__ import _tiny_problem

    problem, shape = _tiny_problem(num_poses=8, num_points=64, window=3)
    options = Options(
        solver_type=SolverType.LEVENBERG_MARQUARDT,
        convergence_handle=ConvergenceHandle(0.0, 0.0),
        iteration_handle=IterationHandle(1),  # ONE full LM step
        reduced_system="cg",
        cg_max_iterations=10,
        cg_tolerance=1e-10,
    )
    mesh = data_mesh(n_global)

    # Process-local single-device ground truth.
    ref = full_ba._solve_jax(problem, shape, options, "cg")
    ref_cost = float(ref.final_cost)
    ref_poses = np.asarray(ref.poses_world_to_camera)

    # (a) observation-table shard_map engine over the global mesh.
    sharded, sshape = sharded_ba.shard_problem(problem, shape, n_global)
    sharded = to_global(sharded, sharded_ba.problem_in_specs(), mesh)
    state = _fetch_repl(
        sharded_ba._solve_sharded_jax(sharded, sshape, options)
    )
    np.testing.assert_allclose(state["final_cost"], ref_cost, rtol=1e-4)
    np.testing.assert_allclose(
        state["poses"], ref_poses, rtol=1e-4, atol=1e-5
    )

    # (b) point-major engine.
    res = full_ba_pm.pm_from_finalized(
        problem, shape, pad_blocks_to=n_global
    )
    assert res is not None
    pm, pshape = res
    pm = to_global(pm, sharded_pm.pm_in_specs(), mesh)
    from jax.sharding import PartitionSpec as P

    rig, R_cw0, t_cw0, opt_pose_idx = to_global(
        (problem.rig, problem.R_cw, problem.t_cw, problem.opt_pose_idx),
        (P(), P(), P(), P()),
        mesh,
    )
    out = sharded_pm._solve_sharded_pm_jax(
        pm, pshape, rig, R_cw0, t_cw0, opt_pose_idx, options, n_global,
    )
    pm_cost = float(np.asarray(out[7]))
    np.testing.assert_allclose(pm_cost, ref_cost, rtol=1e-3)

    result = {
        "ok": True,
        "process_id": args.process_id,
        "num_processes": args.num_processes,
        "global_devices": n_global,
        "ref_cost": ref_cost,
        "sharded_ba_cost": state["final_cost"],
        "sharded_pm_cost": pm_cost,
        "comm_model": sharded_pm.comm_volume_model(
            shape.num_opt_poses, options.cg_max_iterations,
            num_shards=n_global,
        ),
        # Cross-process psum wall times over loopback Gloo (CPU devices):
        # a check that collectives cross the process boundary, not a
        # device measurement.
        "gloo_collective_latency": _time_collectives(mesh, n_global),
    }
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)
    return 0


def _time_collectives(mesh, n_global: int) -> list[dict]:
    """Median wall time of a cross-process psum at the sharded PM engine's
    characteristic payloads (scalar sync, per-CG (Ns, 6) vector, (Ns, 54)
    assembly partials for the flagship's Ns = 10240 pose rows).

    Every process executes the same program in the same order (collective
    rendezvous); each timed call fetches one replicated scalar, so the
    number includes dispatch + rendezvous + transport + readback -- the
    honest per-collective cost a solver iteration pays on this rig."""
    import time

    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from bundle_adjustment_solver.parallel.mesh import DATA_AXIS

    rows = []
    for name, elems in (
        ("scalar", 1),
        ("cg_vector_Ns_x6", 10_240 * 6),
        ("partials_Ns_x54", 10_240 * 54),
    ):
        per_dev = max(1, -(-elems // n_global))
        x = jax.device_put(
            np.full((n_global, per_dev), 0.5, np.float32),
            NamedSharding(mesh, P(DATA_AXIS)),
        )
        f = jax.jit(
            jax.shard_map(
                lambda b: jax.lax.psum(b, DATA_AXIS),
                mesh=mesh, in_specs=P(DATA_AXIS), out_specs=P(),
            )
        )
        float(jnp.asarray(f(x)).ravel()[0])  # compile + warm
        times = []
        for _ in range(15):
            t0 = time.perf_counter()
            float(jnp.asarray(f(x)).ravel()[0])
            times.append((time.perf_counter() - t0) * 1e3)
        times.sort()
        rows.append({
            "payload": name,
            "payload_bytes": elems * 4,
            "median_ms": round(times[len(times) // 2], 4),
            "min_ms": round(times[0], 4),
            "runs": len(times),
        })
    return rows


def _fetch_repl(state) -> dict:
    """Fetch only the replicated outputs (sharded leaves are not fully
    addressable from one process)."""
    import numpy as np

    return {
        "final_cost": float(np.asarray(state.final_cost)),
        "poses": np.asarray(state.poses_world_to_camera),
        "num_iterations": int(np.asarray(state.num_iterations)),
    }


if __name__ == "__main__":
    sys.exit(main())
