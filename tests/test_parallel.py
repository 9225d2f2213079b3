"""Multi-host scale-out utilities: process slicing, staged feed overlap."""

import numpy as np
import jax
import jax.numpy as jnp

from geosradiation_gridcomp.parallel.distributed import (
    initialize_distributed, process_local_slice, StagedFeed,
    run_steps_overlapped)
from geosradiation_gridcomp.parallel.sharding import (column_mesh,
                                                          shard_columns)


def test_initialize_single_process_noop():
    pid, n = initialize_distributed()
    assert pid == 0 and n >= 1


def test_process_local_slice_covers():
    start, stop = process_local_slice(1000)
    assert start == 0 and stop == 1000     # single-process run


def test_staged_feed_roundtrip():
    mesh = column_mesh()
    feed = StagedFeed(mesh)
    x = {"a": np.arange(16.0, dtype=np.float32).reshape(16, 1)}
    feed.put(x)
    dev = feed.get()
    np.testing.assert_array_equal(np.asarray(dev["a"]), x["a"])
    # sharded over the mesh leading axis
    assert len(dev["a"].sharding.device_set) == len(jax.devices())


def test_run_steps_overlapped_order():
    mesh = column_mesh()
    batches = [{"a": np.full((8, 1), float(i), np.float32)}
               for i in range(5)]
    outs = run_steps_overlapped(
        lambda b: jnp.sum(b["a"]), batches, mesh)
    np.testing.assert_allclose([float(o) for o in outs],
                               [i * 8.0 for i in range(5)])
