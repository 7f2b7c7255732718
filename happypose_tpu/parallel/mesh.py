"""Device-mesh construction and placement helpers.

The replacement for the reference's one-process-per-GPU NCCL runtime
(/root/reference/happypose/toolbox/utils/distributed.py:89-153): a single
program over a `jax.sharding.Mesh`, with data/hypothesis axes sharded by
NamedSharding and parameters replicated. The GPUs of one host are joined
all to all, so the mesh is a flat 1-D mesh over `jax.devices()`.
Multi-host: the same code runs under `jax.distributed.initialize` with a
global mesh.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(
    axis_sizes: Optional[Tuple[int, ...]] = None,
    axis_names: Tuple[str, ...] = ("dp",),
) -> Mesh:
    """Build a mesh over all available devices (default: 1-D 'dp')."""
    devices = np.asarray(jax.devices())
    if axis_sizes is None:
        axis_sizes = (len(devices),)
    assert int(np.prod(axis_sizes)) <= len(devices), (
        f"need {np.prod(axis_sizes)} devices, have {len(devices)}"
    )
    devices = devices[: int(np.prod(axis_sizes))].reshape(axis_sizes)
    return Mesh(devices, axis_names)


def replicate(tree, mesh: Mesh):
    """Place a pytree fully replicated on the mesh."""
    sharding = NamedSharding(mesh, P())
    return jax.device_put(tree, sharding)


def shard_leading(tree, mesh: Mesh, axis: str = "dp"):
    """Shard every array's leading dimension over `axis`."""
    sharding = NamedSharding(mesh, P(axis))
    return jax.tree.map(
        lambda x: jax.device_put(x, sharding)
        if hasattr(x, "ndim") and x.ndim > 0
        else x,
        tree,
    )


def shard_objects(db_tree, mesh: Mesh, axis: str = "dp"):
    """Shard a mesh-database pytree (RenderAssets / BatchedMeshes) over
    its leading object axis.

    The analog of the reference's `split_objects_across_gpus`
    (train_megapose.py:115-153): the 20k-object asset store is what does
    not fit a single accelerator, so each device holds a disjoint object
    shard. Per-instance `select(obj_ids)` gathers from the owning shard —
    XLA inserts the collectives when the select runs inside jit.

    Object count must divide the axis size; pad the database first
    (`pad_objects_to_multiple`).
    """
    n_shards = mesh.shape[axis]
    sharding = NamedSharding(mesh, P(axis))

    def place(x):
        if not hasattr(x, "ndim") or x.ndim == 0:
            return x
        assert x.shape[0] % n_shards == 0, (
            f"object axis {x.shape[0]} not divisible by {n_shards}; "
            "pad_objects_to_multiple first"
        )
        return jax.device_put(x, sharding)

    return jax.tree.map(place, db_tree)


def pad_objects_to_multiple(db_tree, multiple: int):
    """Zero-pad the leading object axis to a multiple (sharding prep);
    padded slots are never selected (obj_ids are bounded by real count)."""
    import jax.numpy as jnp

    def pad(x):
        if not hasattr(x, "ndim") or x.ndim == 0:
            return x
        n = x.shape[0]
        target = -(-n // multiple) * multiple
        if target == n:
            return x
        pad_width = [(0, target - n)] + [(0, 0)] * (x.ndim - 1)
        return jnp.pad(x, pad_width)

    return jax.tree.map(pad, db_tree)
