"""Checkpoint / resume for long solves.

The reference has NO cross-run checkpointing (SURVEY.md §5); its only
rollback is the in-iteration snapshot/revert of LM, which the JAX engine
gets for free from functional updates. This module adds what the reference
lacks: durable snapshots of solver state (poses, points, lambda, iteration)
so a long distributed solve can resume after preemption -- table stakes for
production accelerator jobs.

Format: a single .npz (portable, no orbax dependency on the load path).
"""

from __future__ import annotations

import pathlib

import numpy as np


def save_state(
    path: str,
    R_cw: np.ndarray,
    t_cw: np.ndarray,
    points: np.ndarray,
    lam: float,
    iteration: int,
    prev_cost: float,
    meta: dict | None = None,
) -> str:
    """Write a solver-state snapshot (scaled, solver-internal frame)."""
    p = pathlib.Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(
        p,
        R_cw=np.asarray(R_cw),
        t_cw=np.asarray(t_cw),
        points=np.asarray(points),
        lam=np.asarray(lam),
        iteration=np.asarray(iteration),
        prev_cost=np.asarray(prev_cost),
        **{f"meta_{k}": np.asarray(v) for k, v in (meta or {}).items()},
    )
    return str(p)


def load_state(path: str) -> dict:
    """Read a snapshot back; returns a dict of numpy arrays/scalars."""
    with np.load(path) as data:
        out = {k: data[k] for k in data.files}
    out["lam"] = float(out["lam"])
    out["iteration"] = int(out["iteration"])
    out["prev_cost"] = float(out["prev_cost"])
    return out


def resume_problem(problem, state):
    """Return a FinalizedProblem whose parameters come from a snapshot."""
    import jax.numpy as jnp

    return problem._replace(
        R_cw=jnp.asarray(state["R_cw"], problem.R_cw.dtype),
        t_cw=jnp.asarray(state["t_cw"], problem.t_cw.dtype),
        points=jnp.asarray(state["points"], problem.points.dtype),
    )
