"""Column sharding over a device mesh.

Radiation is column-local (no halo; SURVEY.md par. 2.8): the horizontal
domain decomposition maps to a 1-D device mesh with every per-column array
sharded on its leading axis, and one jit program covers all devices. The
physics has no cross-column data flow, but XLA's partitioner is free to
insert collectives anyway (it has done so inside
generate_stochastic_clouds); a collective-free program needs the refresh
in shard_map or pinned intermediates (ROADMAP 3.4).

Daylight packing (the per-rank PackIt) is not mesh-safe yet (ROADMAP 2.2):
on a mesh, night columns are masked, not packed.
"""

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def column_mesh(devices=None, axis_name="columns"):
    """1-D mesh over all (or given) devices."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (axis_name,))


def column_sharding(mesh, axis_name="columns"):
    return NamedSharding(mesh, P(axis_name))


def shard_columns(mesh, tree, axis_name="columns"):
    """Place every array in the pytree with its leading (column) axis
    sharded across the mesh."""
    sh = column_sharding(mesh, axis_name)
    return jax.tree.map(lambda x: jax.device_put(x, sh), tree)


def pad_columns(tree, multiple):
    """Pad the leading axis of every array to a multiple (for even
    sharding); returns (padded_tree, original_ncol)."""
    ncol = jax.tree.leaves(tree)[0].shape[0]
    pad = (-ncol) % multiple
    if pad == 0:
        return tree, ncol

    def f(x):
        widths = [(0, pad)] + [(0, 0)] * (x.ndim - 1)
        return jnp.pad(x, widths, mode="edge")
    return jax.tree.map(f, tree), ncol
