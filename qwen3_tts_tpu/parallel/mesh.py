"""Device mesh construction (`data`, `model`) for multi-chip / multi-host.

The reference has no distributed surface at all (SURVEY.md §2 "Parallelism
inventory": zero collectives, single process) — this is new first-class
design: utterance batches are data-parallel over `data`, the talker's
matmuls tensor-parallel over `model`, with XLA inserting the collectives
(psum/all-gather) from sharding annotations. The cards of one host are
joined all to all, so the mesh is a plain reshape of the device list.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"
MODEL_AXIS = "model"


def make_mesh(data: int = 1, model: int = 1,
              devices: Optional[Sequence[jax.Device]] = None) -> Mesh:
    """Mesh of shape (data, model). Uses all local devices by default."""
    n = data * model
    if devices is None:
        devices = jax.devices()[:n]
    if len(devices) < n:
        raise ValueError(f"need {n} devices, have {len(devices)}")
    dev_array = np.asarray(list(devices)[:n]).reshape(data, model)
    return Mesh(dev_array, (DATA_AXIS, MODEL_AXIS))


def single_device_mesh() -> Mesh:
    return make_mesh(1, 1)


def make_local_mesh(model: int = 1) -> Mesh:
    """Mesh over THIS process's devices only (host-level DP).

    Programs on a local mesh contain no cross-process collectives, so the
    per-frame decode loop never leaves the host: each host runs its own
    generation program over its own utterances, and hosts coordinate only
    at start/end (barriers, result gathers). This is the scaling design for
    DP across hosts — pure DP needs no per-frame cross-host traffic at all.
    TP *across* hosts remains available via the global-mesh path
    (make_mesh over jax.devices())."""
    local = list(jax.local_devices())
    if model <= 0 or len(local) % model:
        raise ValueError(
            f"model axis {model} must divide local device count "
            f"{len(local)}")
    return make_mesh(len(local) // model, model, devices=local)


def shard(mesh: Mesh, tree, specs):
    """device_put a pytree with a matching pytree of PartitionSpecs.

    `specs` is flattened up to `tree`'s leaves, so each PartitionSpec is
    passed whole even though it subclasses tuple."""
    return jax.tree_util.tree_map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), tree, specs
    )


def replicated(mesh: Mesh, tree):
    sharding = NamedSharding(mesh, P())
    return jax.tree_util.tree_map(lambda x: jax.device_put(x, sharding), tree)


def initialize_multihost(coordinator: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None) -> None:
    """`jax.distributed.initialize` wrapper for multi-host runs. No-op for a
    single process."""
    if num_processes is None or num_processes <= 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )
