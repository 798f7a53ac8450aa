"""Device mesh construction and sharding specs.

The reference is single-process, single-GPU (``cudaSetDevice(0)`` hardcoded
in every wrapper, SURVEY.md §2 "Parallelism"); its only parallelism is
per-pixel SIMT. This framework's scaling axes (BASELINE.json north star):

- **rays / image tiles** sharded across devices (pure data parallel — the
  multi-device analogue of the 1-thread-per-pixel launch, Trixel.cu:218);
- **primitive ranges** optionally sharded, with a nearest-hit min-combine
  across shards (parallel/collectives.py) — the role ring attention plays
  for attention, played for nearest-hit reduction;
- gradients for scene/camera/material parameters all-reduced by XLA's
  collectives, overlapped with backward.

Axis names: "rays" (data parallel over pixels), "prims" (primitive-range
sharding).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

RAYS_AXIS = "rays"
PRIMS_AXIS = "prims"


def make_mesh(n_devices: int | None = None, prims: int = 1,
              devices=None) -> Mesh:
    """1D or 2D mesh: (rays,) or (rays, prims)."""
    if devices is None:
        devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    devices = np.asarray(devices[:n_devices])
    if prims > 1:
        if n_devices % prims:
            raise ValueError(f"{n_devices} devices not divisible by "
                             f"prims={prims}")
        return Mesh(devices.reshape(n_devices // prims, prims),
                    (RAYS_AXIS, PRIMS_AXIS))
    return Mesh(devices, (RAYS_AXIS,))


def ray_sharding(mesh: Mesh) -> NamedSharding:
    """Shard the leading (pixel/row) axis of per-ray arrays."""
    return NamedSharding(mesh, P(RAYS_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def initialize_distributed(coordinator: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None) -> None:
    """Multi-host bring-up — the communication backend the reference lacks
    (no NCCL/MPI, SURVEY.md §5). Pass the coordinator address
    (``host:port``), process count and this process's id; without them
    ``jax.distributed.initialize`` relies on a cluster environment to
    supply them."""
    kwargs = {}
    if coordinator is not None:
        kwargs = dict(coordinator_address=coordinator,
                      num_processes=num_processes, process_id=process_id)
    jax.distributed.initialize(**kwargs)
