"""Multi-chip scaling: data-parallel sharding of the correction kernels.

The reference's only parallel axis is reads over a pthread pool
(Concurrency/SequenceProcessFramework.h:90-230).  The device equivalent shards
the *gap-lane* axis G of the walk frontier (and the read axis of the seeding
scan) across a device mesh; the FM-index tensors are replicated on every
device, so a superstep needs no collectives — only metric reductions and the
ordered output merge touch the interconnect, mirroring the reference's
single-sink PostProcess semantics.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import walk


def make_mesh(devices=None, axis: str = "dp") -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.array(devices), (axis,))


def shard_walk_batch(mesh: Mesh, wx: walk.WalkIndex, consts, state, axis: str = "dp"):
    """Place a walk batch on the mesh: index replicated, gap lanes sharded."""
    repl = NamedSharding(mesh, P())
    shard0 = NamedSharding(mesh, P(axis))

    def put_gap_sharded(x):
        return jax.device_put(x, shard0 if hasattr(x, "ndim") and x.ndim >= 1 else repl)

    wx = jax.device_put(wx, repl)
    consts = jax.tree.map(
        lambda x: jax.device_put(x, shard0 if x.ndim >= 1 and x.shape[0] == state.code.shape[0] else repl),
        consts,
    )
    state = jax.tree.map(put_gap_sharded, state)
    return wx, consts, state


@partial(jax.jit, static_argnames=("cfg", "n"))
def sharded_multistep(wx, consts, state, cfg, n):
    """Same program as walk.multistep; under sharded inputs GSPMD runs the
    gap lanes data-parallel with the index replicated on every chip."""
    return walk.multistep(wx, consts, state, cfg, n)


def all_reduce_counters(mesh: Mesh, per_shard: jax.Array, axis: str = "dp") -> jax.Array:
    """Sum per-shard correction counters across chips (the metrics reduction
    of the PostProcess sink).  per_shard: [n_devices, K] sharded on axis 0."""

    def f(x):
        return jax.lax.psum(x, axis)

    return jax.shard_map(f, mesh=mesh, in_specs=P(axis, None), out_specs=P(axis, None))(
        per_shard
    )
