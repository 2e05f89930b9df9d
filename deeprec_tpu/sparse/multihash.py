"""Multi-hash embedding variables (the Q-R compositional trick).

Rebuild of DeepRec's ``MultiHashVariable``
(reference: tensorflow/python/ops/kv_variable_ops.py:768,
``get_multihash_variable`` variable_scope.py:2292): instead of one huge
[vocab, dim] table, an id is decomposed into complementary partitions —
quotient ``id // R`` and remainder ``id % R`` — each indexing a much
smaller dense table; the final embedding combines the sub-rows with
``add`` / ``mult`` / ``concat``. Memory drops from O(vocab) to
O(Q + R) with Q·R ≥ vocab.

Design: the sub-tables are plain dense ``[size_i, dim_i]``
arrays (static shapes — ideal for XLA gathers), the lookup is pure and
differentiable, and sparse training uses the same
:mod:`deeprec_tpu.optim.sparse` updaters over per-table deduplicated
indices. No hash-table state is needed at all — this variant trades the
dynamic keyspace for a fixed compositional one.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.unique import unique_int32
from . import keys as K


@dataclasses.dataclass(frozen=True)
class MultiHashConfig:
    """``num_of_partitions`` complementary partitions (reference supports 2
    via Q-R; >2 generalises by repeated division)."""

    name: str
    embedding_dim: int
    table_sizes: Tuple[int, ...]       # e.g. (Q, R): Q*R >= vocab
    combiner: str = "add"              # add | mult | concat
    initializer_scale: float = 0.05
    seed: int = 0

    def __post_init__(self):
        if self.combiner not in ("add", "mult", "concat"):
            raise ValueError(self.combiner)

    @property
    def sub_dim(self) -> int:
        if self.combiner == "concat":
            d, r = divmod(self.embedding_dim, len(self.table_sizes))
            if r:
                raise ValueError("embedding_dim must divide evenly for concat")
            return d
        return self.embedding_dim


class MultiHashState(NamedTuple):
    tables: Tuple[jax.Array, ...]      # [size_i, sub_dim] each


def create(config: MultiHashConfig, rng: jax.Array | None = None) -> MultiHashState:
    rng = rng if rng is not None else jax.random.key(config.seed)
    ks = jax.random.split(rng, len(config.table_sizes))
    tables = tuple(
        jax.random.normal(k, (s, config.sub_dim), jnp.float32)
        * config.initializer_scale
        for k, s in zip(ks, config.table_sizes))
    return MultiHashState(tables=tables)


def sub_indices(config: MultiHashConfig, ids: K.Keys) -> Tuple[jax.Array, ...]:
    """Complementary partition indices per table. For 2 tables this is the
    classic (quotient, remainder); for k tables, mixed-radix digits. A
    per-table hash decorrelates collisions between partitions beyond the
    Q·R range (ids are arbitrary 64-bit)."""
    out = []
    for i, size in enumerate(config.table_sizes):
        if i == 0:
            idx = K.mod(ids, size)
        else:
            # divide by the product of previous sizes, then mod.
            # 64-bit division on split planes: do it via a mix-hash for
            # arbitrary ids (exact mixed-radix only matters for dense
            # contiguous vocabularies; hashing preserves the
            # complementary-partition property statistically).
            h = K.hash32(ids, seed=101 + i)
            idx = (h % np.uint32(size)).astype(jnp.int32)
        out.append(jnp.where(K.is_empty(ids), size, idx))  # pad -> null row
    return tuple(out)


def lookup(state: MultiHashState, config: MultiHashConfig, ids: K.Keys) -> jax.Array:
    """[n, embedding_dim]; padding ids return zeros. Differentiable."""
    subs = sub_indices(config, ids)
    rows = []
    for t, idx in zip(state.tables, subs):
        null = jnp.zeros((1, t.shape[1]), t.dtype)
        padded = jnp.concatenate([t, null], axis=0)
        rows.append(padded[idx])
    if config.combiner == "add":
        out = sum(rows)
    elif config.combiner == "mult":
        out = rows[0]
        for r in rows[1:]:
            out = out * r
    else:
        out = jnp.concatenate(rows, axis=-1)
    valid = ~K.is_empty(ids)
    return jnp.where(valid[..., None], out, 0.0)


def apply_gradients(
    state: MultiHashState,
    config: MultiHashConfig,
    opt,
    slot_states: Sequence,
    ids: K.Keys,
    grads: jax.Array,
    step: jax.Array,
) -> Tuple[MultiHashState, tuple]:
    """Sparse-apply the cotangent of :func:`lookup`'s output onto each
    sub-table: split the grad per combiner, dedup per-table indices,
    segment-sum, update with the shared sparse optimizer."""
    subs = sub_indices(config, ids)
    n_tables = len(state.tables)
    if config.combiner == "concat":
        gparts = jnp.split(grads, n_tables, axis=-1)
    elif config.combiner == "add":
        gparts = [grads] * n_tables
    else:  # mult: d/dt_i = grads * prod_{j!=i} rows_j
        rows = []
        for t, idx in zip(state.tables, subs):
            padded = jnp.concatenate([t, jnp.zeros((1, t.shape[1]), t.dtype)], 0)
            rows.append(padded[idx])
        gparts = []
        for i in range(n_tables):
            other = jnp.ones_like(grads)
            for j, r in enumerate(rows):
                if j != i:
                    other = other * r
            gparts.append(grads * other)

    new_tables, new_slots = [], []
    valid = ~K.is_empty(ids)
    for t, idx, g, slot in zip(state.tables, subs, gparts, slot_states):
        size = t.shape[0]
        uidx, inv, _counts = unique_int32(jnp.where(valid, idx, size))
        gu = jax.ops.segment_sum(g, inv, uidx.shape[0])
        mask = uidx < size
        # optimizer operates on a [size+1] padded view so masked rows drop
        padded = jnp.concatenate([t, jnp.zeros((1, t.shape[1]), t.dtype)], 0)
        padded, slot = opt.apply(padded, slot, jnp.where(mask, uidx, size),
                                 gu, mask, step)
        new_tables.append(padded[:size])
        new_slots.append(slot)
    return MultiHashState(tables=tuple(new_tables)), tuple(new_slots)


def init_slots(state: MultiHashState, opt) -> tuple:
    return tuple(
        opt.init(jnp.concatenate(
            [t, jnp.zeros((1, t.shape[1]), t.dtype)], 0))
        for t in state.tables)
