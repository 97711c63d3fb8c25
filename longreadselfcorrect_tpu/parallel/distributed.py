"""Multi-host scaling: jax.distributed process groups + the ordered sink.

The reference's parallelism is a pthread pool feeding one ordered writer
(Concurrency/SequenceProcessFramework.h:183-195: results are buffered and
written strictly in input order).  The multi-host equivalent here:

* each host initializes `jax.distributed` (so collectives can span hosts),
  takes a deterministic contiguous shard of the input reads, and runs the
  data-parallel correction on its local devices (the FM-index tensors are
  replicated per host — no cross-host traffic on the hot path);
* per-host outputs are written to rank-tagged part files;
* `merge_ordered_parts` concatenates them in rank order, which equals
  input order because the shards are contiguous — the multi-host ordered
  sink;
* correction counters are summed across hosts with a global-mesh psum.
"""
from __future__ import annotations

import os

import numpy as np


def local_gpu_count() -> int:
    """GPUs this host exposes, counted without initialising a JAX backend
    (``CUDA_VISIBLE_DEVICES`` when set, else ``nvidia-smi --list-gpus``);
    0 when there are none or the driver tools are absent."""
    vis = os.environ.get("CUDA_VISIBLE_DEVICES")
    if vis is not None:
        return len([d for d in vis.split(",") if d.strip()])
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--list-gpus"], capture_output=True,
                             text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return 0
    if out.returncode != 0:
        return 0
    return sum(1 for line in out.stdout.splitlines() if line.startswith("GPU "))


def init(coordinator: str, num_processes: int, process_id: int) -> None:
    """Initialize the jax.distributed runtime.

    One process per card: on a GPU host each rank is pinned to local card
    ``process_id % local_gpu_count()``, so ranks that share a host each
    reserve the memory of their own card only (ranks are assumed to be
    numbered host by host).  On a host without GPUs nothing is pinned."""
    import jax

    n_gpu = local_gpu_count()
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=[process_id % n_gpu] if n_gpu else None,
    )


def shard_bounds(n_items: int, num_processes: int, process_id: int):
    """Contiguous per-host shard [lo, hi) — contiguity keeps rank-order
    concatenation equal to input order."""
    per = -(-n_items // num_processes)
    lo = min(process_id * per, n_items)
    return lo, min(lo + per, n_items)


def part_path(out_path: str, process_id: int) -> str:
    return f"{out_path}.part{process_id:04d}"


def merge_ordered_parts(out_path: str, num_processes: int,
                        cleanup: bool = True) -> None:
    """Rank-0 ordered merge of part files (the multi-host ordered sink)."""
    with open(out_path, "wb") as out:
        for r in range(num_processes):
            p = part_path(out_path, r)
            with open(p, "rb") as fh:
                out.write(fh.read())
            if cleanup:
                os.remove(p)


def kv_counter_sum(counters: np.ndarray, num_processes: int, process_id: int,
                   timeout_ms: int = 1_200_000) -> np.ndarray:
    """Sum per-host counter vectors through the jax.distributed
    coordination-service KV store (pure RPC over DCN, no device
    collectives).

    The CLI uses this instead of a mesh psum because ranks finish their
    shards minutes apart when compile caches are cold, and a device
    collective's peer setup has a short timeout; metrics reduction is not a
    hot path, so the KV exchange (which also acts as the completion
    barrier for the ordered merge) is the robust choice."""
    from jax._src import distributed as _dist

    client = _dist.global_state.client
    payload = ",".join(repr(float(x)) for x in np.asarray(counters).ravel())
    client.key_value_set(f"lrsc/counters/{process_id}", payload)
    total = np.zeros(len(counters), np.float64)
    for r in range(num_processes):
        v = client.blocking_key_value_get(f"lrsc/counters/{r}", timeout_ms)
        total += np.array([float(x) for x in v.split(",")])
    return total


def global_counter_sum(counters: np.ndarray):
    """Sum a per-host counter vector across every process in the global
    mesh (the metrics reduction of the reference's PostProcess sink)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    devices = np.array(jax.devices())          # global device list
    mesh = Mesh(devices, ("dp",))
    n_local = len(jax.local_devices())
    # each local device carries 1/n_local of the host's counters, so the
    # global sum over the dp axis is the sum over hosts
    local = np.broadcast_to(
        np.asarray(counters, np.float32) / n_local,
        (n_local, len(counters)),
    )
    arr = jax.make_array_from_process_local_data(
        NamedSharding(mesh, P("dp", None)), np.ascontiguousarray(local))

    @jax.jit
    def reduce(x):
        return x.sum(axis=0)  # GSPMD all-reduce over the dp axis

    del jnp
    return np.asarray(reduce(arr))
