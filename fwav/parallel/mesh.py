"""Device mesh helpers.

The reference's parallelism is N CPU processes + 1 GPU process + mp.Queues on
one host (fractal.py:1176-1237). The equivalents here (SURVEY.md §2.5):

- 'dp' axis: ranges sharded across devices (the codec's batch axis) — the
  analog of the reference's np.array_split over cpu_worker processes;
- 'tp' axis: the domain bank sharded across devices with an all-gather
  best merge — the codec analog of tensor parallelism, needed when the
  bank outgrows one device's memory.

The mesh is a plain reshape of jax.devices(): the cards of one host are
joined all to all (NVLink), so no axis order is preferred; XLA lowers the
collectives to NCCL.
"""

from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DP_AXIS = "dp"
TP_AXIS = "tp"


def make_mesh(n_devices=None, dp=None, tp=1) -> Mesh:
    """1-D or 2-D mesh over the first n_devices. dp defaults to
    n_devices // tp."""
    devices = jax.devices()
    n = n_devices or len(devices)
    if n > len(devices):
        raise ValueError(
            f"requested {n} devices but only {len(devices)} are available "
            f"({jax.default_backend()} backend)"
        )
    if dp is None:
        dp = n // tp
    assert dp * tp == n, (dp, tp, n)
    arr = np.asarray(devices[:n]).reshape(dp, tp)
    return Mesh(arr, (DP_AXIS, TP_AXIS))


def ranges_sharding(mesh: Mesh) -> NamedSharding:
    """(M, N) ranges sharded over dp, replicated over tp."""
    return NamedSharding(mesh, P(DP_AXIS, None))


def bank_sharding(mesh: Mesh) -> NamedSharding:
    """(D, N) bank sharded over tp, replicated over dp."""
    return NamedSharding(mesh, P(TP_AXIS, None))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def fetch_global(x):
    """np.asarray(jax.device_get(x)) that also works when `x` spans multiple
    PROCESSES (a multi-host mesh after init_distributed, or the 2-process
    loopback dryrun in tests/test_distributed.py): a non-fully-addressable
    array is allgathered across processes so every process returns the
    full value —
    device_get raises on such arrays. Single-process arrays (the common
    case, including every single-host mesh) take the plain device_get path
    untouched."""
    if getattr(x, "is_fully_addressable", True):
        return np.asarray(jax.device_get(x))
    from jax.experimental import multihost_utils

    return np.asarray(multihost_utils.process_allgather(x, tiled=True))


def init_distributed(coordinator_address=None, num_processes=None, process_id=None):
    """Multi-host initialization (SURVEY.md §5 distributed backend): within
    a host, collectives run as NCCL over NVLink under the mesh created by
    make_mesh; across hosts, JAX's distributed runtime coordinates and NCCL
    runs over the network. Call once
    per process before any device use; arguments default to the standard
    JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID env vars."""
    import jax

    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    return make_mesh()
