"""Multi-host utilities: process init and local->global batch assembly.

Scaling from one host to a pod slice is the same ShardedTrainer code over
a bigger mesh (the reference needed a whole PS/worker deployment +
TF_CONFIG + protocol selection for this; here it is jax.distributed +
the named axis spanning every host's devices).

Usage on every host of the job:

    from deeprec_tpu.parallel import multihost
    multihost.initialize()                      # once, before jax use
    mesh = make_mesh()                          # all global devices
    tr = ShardedTrainer(..., mesh=mesh)
    # feed each host its own batch shard; prepare_batch globalizes it
"""
from __future__ import annotations

import os
from typing import Optional

import jax
import numpy as np


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """jax.distributed.initialize with env-var fallbacks
    (COORDINATOR_ADDRESS / NUM_PROCESSES / PROCESS_ID — the TF_CONFIG
    analog). No-op on single-process runs with no configuration."""
    addr = coordinator_address or os.environ.get("COORDINATOR_ADDRESS")
    if addr is None and num_processes is None:
        return  # single-process
    jax.distributed.initialize(
        coordinator_address=addr,
        num_processes=num_processes or int(os.environ.get("NUM_PROCESSES", "1")),
        process_id=process_id if process_id is not None
        else int(os.environ.get("PROCESS_ID", "0")),
    )


def globalize(mesh, spec, local_array):
    """Assemble a process-local numpy shard into a global jax.Array with
    the given PartitionSpec (each process holds its slice of the batch —
    the per-worker input pipeline of the reference)."""
    from jax.sharding import NamedSharding
    sharding = NamedSharding(mesh, spec)
    if jax.process_count() == 1:
        return jax.device_put(local_array, sharding)
    return jax.make_array_from_process_local_data(sharding, np.asarray(local_array))


def host_to_global(mesh, spec, x):
    """Place a host value that is IDENTICAL on every process (replicated
    inputs, freshly-initialised tables, restored checkpoint rows) into a
    global array with the given spec. Unlike ``jax.device_put``, this works
    when the sharding spans processes: each process materialises only its
    addressable shards via ``make_array_from_callback``."""
    from jax.sharding import NamedSharding
    sharding = NamedSharding(mesh, spec)
    x = np.asarray(x)
    if jax.process_count() == 1:
        return jax.device_put(x, sharding)
    return jax.make_array_from_callback(x.shape, sharding,
                                        lambda idx: x[idx])


def stack_rowsharded(mesh, axis, shard_trees):
    """Stack per-shard host pytrees into the mesh's row-sharded global
    arrays: leaves with ndim>=1 concatenate over shards onto P(axis);
    scalars replicate (shard 0's value). The one definition of the
    restore-time stacking rule — multi-process safe via host_to_global."""
    from jax.sharding import PartitionSpec as P

    def stack(*leaves):
        l0 = leaves[0]
        if hasattr(l0, "ndim") and l0.ndim >= 1:
            glob = np.concatenate([np.asarray(l) for l in leaves], axis=0)
            return host_to_global(mesh, P(axis), glob)
        return host_to_global(mesh, P(), leaves[0])

    return jax.tree_util.tree_map(stack, *shard_trees)


def barrier(name: str = "deeprec") -> None:
    """Cross-process sync point (checkpoint part-file completion etc.).
    No-op on single-process runs."""
    if jax.process_count() == 1:
        return
    from jax.experimental import multihost_utils
    multihost_utils.sync_global_devices(name)


# ---------------------------------------------------------------------------
# Host access to process-spanning arrays. Single-process fallbacks are the
# trivial numpy views, so callers need no jax.process_count() branches.


def addressable_blocks(arr, S: int, per: int):
    """Per-table-shard host views of a stacked ``[S*per, ...]`` row-sharded
    array: dict ``shard_id -> [per, ...]`` numpy block, containing every
    shard this process can read (all S single-process; only the local
    devices' shards on a multi-process mesh — the per-process unit for
    checkpoint parts and host-tier demotion)."""
    if isinstance(arr, jax.Array) and not arr.is_fully_addressable:
        out = {}
        for sh in arr.addressable_shards:
            start = sh.index[0].start or 0
            data = np.asarray(sh.data)
            for j in range(data.shape[0] // per):
                out[start // per + j] = data[j * per:(j + 1) * per]
        return out
    x = np.asarray(arr)
    return {s: x[s * per:(s + 1) * per] for s in range(S)}


def np_global(arr) -> np.ndarray:
    """Full host value of a possibly process-spanning array. Small arrays
    only (sizes / overflow / health counters): the multi-process path is a
    collective allgather every process must reach."""
    try:
        return np.asarray(arr)
    except Exception:
        from jax.experimental import multihost_utils
        return np.asarray(multihost_utils.process_allgather(arr, tiled=True))


def all_max(value: int) -> int:
    """Global max of a per-process host integer (collective; consistent
    branch decisions across processes). Identity single-process."""
    if jax.process_count() == 1:
        return int(value)
    from jax.experimental import multihost_utils
    g = multihost_utils.process_allgather(np.asarray([value], np.int64),
                                          tiled=True)
    return int(np.asarray(g).max())


def allgather_varlen(x: np.ndarray, fill=-1) -> np.ndarray:
    """Concatenate per-process host arrays of DIFFERENT leading sizes
    across processes (collective). Identity single-process.

    64-bit payloads ride as 32-bit bit-pattern planes: the gather traces
    through jax, and with x64 disabled an int64 array would be SILENTLY
    truncated to its low 32 bits — feature ids with high bits set (salted
    coalesced-column keys) would stop matching their own tier rows."""
    x = np.asarray(x)
    if jax.process_count() == 1:
        return x
    from jax.experimental import multihost_utils
    counts = np.asarray(multihost_utils.process_allgather(
        np.asarray([x.shape[0]], np.int32), tiled=True)).reshape(-1)
    m = max(int(counts.max()), 1)
    pad = np.full((m,) + x.shape[1:], fill, x.dtype)
    pad[:x.shape[0]] = x
    wide = x.dtype.itemsize == 8
    payload = pad.view(np.uint32) if wide else pad  # [m(, ...*2)]
    g = np.asarray(multihost_utils.process_allgather(payload))  # [P, m, ...]
    if wide:
        g = g.view(x.dtype)
    return np.concatenate([g[p, :counts[p]] for p in range(len(counts))])


def local_shard_range(mesh, axis: str, S: int):
    """(lo, hi) global table-shard ids owned by this process's devices on
    the mesh's ``axis`` (contiguous by mesh construction)."""
    rows = [i for i, d in enumerate(mesh.devices.reshape(-1))
            if d.process_index == jax.process_index()]
    assert rows, "process owns no devices on the mesh"
    assert rows == list(range(rows[0], rows[0] + len(rows))), \
        "local mesh rows must be contiguous"
    return rows[0], rows[0] + len(rows)
