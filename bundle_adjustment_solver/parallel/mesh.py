"""Device mesh helpers for the distributed solvers.

The reference has no distributed layer at all (SURVEY.md §2: its only
parallelism is AVX within one core); this module provides the JAX
equivalent: a 1-D `jax.sharding.Mesh` over the data axis (observations +
landmarks), with pose state replicated -- collectives ride ICI within a
slice and DCN across slices.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

DATA_AXIS = "data"


def data_mesh(num_devices: int | None = None, devices=None) -> Mesh:
    """Build a 1-D mesh over `num_devices` (default: all local devices)."""
    if devices is None:
        devices = jax.devices()
    if num_devices is not None:
        devices = devices[:num_devices]
    return Mesh(np.asarray(devices), (DATA_AXIS,))


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Multi-host entry: thin wrapper over `jax.distributed.initialize`.

    On a managed cluster the arguments are discovered from the environment;
    elsewhere (a single GPU host, CPU rigs) pass them explicitly. Safe to call once per process before
    any JAX computation.
    """
    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    jax.distributed.initialize(**kwargs)


def to_global(tree, specs, mesh: Mesh):
    """device_put every leaf of `tree` with the NamedSharding given by the
    matching PartitionSpec in the prefix-pytree `specs`.

    Single-host meshes get the same placement jit would infer; on a
    MULTI-PROCESS mesh this is required -- jit cannot auto-shard host-local
    arrays across processes, but `jax.device_put` with a global
    NamedSharding can, provided every process passes identical data (true
    here: each host builds the same seeded problem). A spec leaf may cover a
    whole sub-pytree (e.g. a replicated CameraRig).
    """
    is_spec = lambda x: isinstance(x, P)
    treedef = jax.tree.structure(specs, is_leaf=is_spec)
    spec_leaves = jax.tree.leaves(specs, is_leaf=is_spec)
    groups = treedef.flatten_up_to(tree)
    out = [
        jax.tree.map(
            lambda a, s=s: jax.device_put(
                np.asarray(a), NamedSharding(mesh, s)
            ),
            g,
        )
        for g, s in zip(groups, spec_leaves)
    ]
    return jax.tree.unflatten(treedef, out)
