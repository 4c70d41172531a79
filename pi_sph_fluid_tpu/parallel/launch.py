"""Multi-host launch plumbing for the slab domain decomposition.

The reference's entire parallelism story is one OpenMP region on one
machine (`pi_sph_fluid.c:610`).  The scale-out path (SURVEY.md §5
"distributed communication backend") is slab domain decomposition over a
device mesh — and past one host, that mesh must span *processes*: each
host runs the same program, `jax.distributed.initialize` wires them into
one JAX runtime, and the `Mesh` is built from the **global** device list
so `shard_map`'s ppermute halo exchanges ride the intra-host links within
a host and the network between hosts, exactly where XLA puts them.

Cluster launch recipe (same binary on every host)::

    # host 0 (also the coordinator):
    python -m pi_sph_fluid_tpu.cli run --backend pallas-dd \
        --coordinator 10.0.0.1:8476 --num-processes 4 --process-id 0 ...
    # hosts 1..3: same command with --process-id 1/2/3
    # (display/report default to process 0; others run headless)

The CPU-mesh analog (the test fixture, mirroring the reference's SDL
backend substitution): every process forces the CPU platform with N
virtual devices, so a 2-process x 4-device run exercises real
cross-process collectives (gloo) with no cluster — see
tools/multihost_worker.py and tests/test_multihost.py.
"""

from __future__ import annotations

import jax

__all__ = ["init_distributed", "is_multiprocess", "process_index",
           "to_host"]


def init_distributed(coordinator: str, num_processes: int, process_id: int,
                     local_device_ids=None,
                     initialization_timeout: int = 300) -> None:
    """Join (or start, for process 0) the cross-host JAX runtime.

    Must run before the first backend touch.  ``coordinator`` is
    ``host:port`` of process 0; every process passes the same value.
    """
    kw = {}
    if local_device_ids is not None:
        kw["local_device_ids"] = local_device_ids
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
        initialization_timeout=initialization_timeout,
        **kw,
    )


def is_multiprocess() -> bool:
    return jax.process_count() > 1


def process_index() -> int:
    return jax.process_index()


def to_host(arr):
    """Global array -> host numpy, multi-process aware.

    Single-process (or fully-replicated) arrays convert directly; an
    array sharded across processes is not fully addressable, so every
    process all-gathers the global value over the network first (tiled along the
    sharded dims).  Used by WindowDomain.gather/export so checkpoints and
    host-side views work unchanged on a cluster."""
    import numpy as np

    if getattr(arr, "is_fully_addressable", True):
        return np.asarray(arr)
    from jax.experimental import multihost_utils

    return np.asarray(multihost_utils.process_allgather(arr, tiled=True))
