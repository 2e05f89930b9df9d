"""Multi-tier embedding storage: HBM (device) + host DRAM overflow.

Rebuild of DeepRec's multi-tier EmbeddingVariable storage
(reference: embedding/config.proto StorageType{DRAM,PMEM,SSD}, the
DRAM/PMEM ValuePtr tiers behind EmbeddingVar, and modelzoo/features/pmem).
The hot tier is the device HBM row store of :mod:`embedding_var`;
the cold tier is a native host-DRAM KV (:class:`deeprec_tpu.utils.native.
HostKV`, C++ sharded open-addressing arena).

Protocol (host-in-the-loop, mirroring the reference's CPU-side tier):

* **demote(state, slots)** — between steps, rows the eviction policy marks
  cold are exported to the host tier and dropped from HBM (capacity is
  reclaimed by the index rebuild). Their learned values survive.
* **lookup_or_create(...)** — the normal jitted lookup; afterwards the
  *created* keys (one small D2H transfer of the unique tail) are probed in
  the host tier and any hits are **promoted**: their saved rows overwrite
  the fresh init rows in HBM (one H2D scatter), and they leave the host
  tier. A cold feature recurring after demotion keeps its training state.

The device step itself stays pure/jittable; tier traffic happens at step
boundaries, so XLA's pipeline is never blocked by a host callback.
"""
from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import EmbeddingVariableConfig
from ..utils.native import HostKV
from . import embedding_var as ev
from . import keys as K


class TieredTable:
    """Host-tier manager paired with one EVState (and optionally its
    optimizer slot rows — demoted rows keep their optimizer state too)."""

    def __init__(self, config: EmbeddingVariableConfig,
                 capacity_hint: int = 1 << 16, track_slots: bool = False):
        self.config = config
        self._capacity_hint = capacity_hint
        self.host: Optional[HostKV] = None  # sized lazily: row width may
        #                                     include fused slot columns
        self.track_slots = track_slots

    def _host(self, width: int) -> HostKV:
        if self.host is None:
            self.host = HostKV(width, self._capacity_hint)
        assert self.host.dim == width, "row width changed under the tier"
        return self.host

    # -- promotion (after lookup) -------------------------------------------
    def promote_created(self, state: ev.EVState, aux: ev.LookupAux
                        ) -> Tuple[ev.EVState, ev.LookupAux]:
        """Patch rows created this step with their host-tier values (if
        any). Host round-trip on the unique keys only. Returns the patched
        state AND an aux whose ``created`` flags are cleared for promoted
        keys — under lazy init, gather adds the deterministic init to
        created rows (which hold zeros), and a promoted row is NOT zeros."""
        if self.host is None or len(self.host) == 0:
            return state, aux
        created = np.asarray(aux.created)
        if not created.any():
            return state, aux
        ukeys = K.to_numpy(K.Keys(np.asarray(aux.uniq.ukeys.hi),
                                  np.asarray(aux.uniq.ukeys.lo)))
        slots = np.asarray(aux.slots)
        idx = np.nonzero(created)[0]
        rows, found = self.host.lookup(ukeys[idx])
        if not found.any():
            return state, aux
        hit_u = idx[found]
        values = state.values.at[jnp.asarray(slots[hit_u])].set(
            jnp.asarray(rows[found], state.values.dtype))
        self.host.erase(ukeys[hit_u])
        new_created = created.copy()
        new_created[hit_u] = False
        aux = aux._replace(created=jnp.asarray(new_created))
        return state._replace(values=values), aux

    # -- demotion (between steps / at checkpoint) ------------------------------
    def demote(self, state: ev.EVState, global_step,
               slot_state=None) -> Tuple[ev.EVState, jax.Array]:
        """Move policy-cold rows to the host tier, then shrink HBM
        (embedding_var.shrink). Returns (state, old_to_new) — callers
        permute their slot rows with it, exactly like a plain shrink."""
        cfg = self.config
        cap = state.capacity
        gs = int(global_step)
        values_np = np.asarray(state.values)
        versions = np.asarray(state.versions)
        occupied = ~np.asarray(
            (np.asarray(state.index.key_hi) == -1)
            & (np.asarray(state.index.key_lo) == -1))
        # the ONE cold predicate, shared with shrink and the checkpoint
        # saver (ev.cold_mask_np) — divergence here silently loses rows
        cold = ev.cold_mask_np(cfg, values_np, versions, occupied, gs)
        if cold.any():
            idx = np.nonzero(cold)[0]
            keys64 = ((np.asarray(state.index.key_hi)[idx].astype(np.int64) << 32)
                      | np.asarray(state.index.key_lo)[idx].astype(np.uint32).astype(np.int64))
            self._host(values_np.shape[1]).upsert(
                keys64, values_np[idx].astype(np.float32))
        # drop exactly the exported rows (host predicate authoritative —
        # a device-recomputed L2 norm could diverge on float rounding)
        new_state, old_to_new = ev.shrink(state, cfg, jnp.asarray(gs, jnp.int32),
                                          keep_mask=jnp.asarray(~cold))
        return new_state, old_to_new

    # -- full lookup-or-create with tier promotion ----------------------------
    def lookup_or_create(self, state: ev.EVState, ids: K.Keys, step
                         ) -> Tuple[ev.EVState, ev.LookupAux]:
        state, aux = ev.lookup_or_create(state, self.config, ids,
                                         jnp.asarray(step, jnp.int32))
        state, aux = self.promote_created(state, aux)
        return state, aux

    # -- tier stats/persistence -------------------------------------------------
    def host_rows(self) -> int:
        return len(self.host) if self.host is not None else 0

    def export_host(self):
        """(keys int64[n], rows f32[n, width]) — for checkpointing the cold
        tier alongside the device table."""
        if self.host is None:
            return (np.zeros((0,), np.int64),
                    np.zeros((0, self.config.embedding_dim
                              + self.config.fused_slot_columns), np.float32))
        return self.host.export()

    def import_host(self, keys: np.ndarray, rows: np.ndarray):
        self._host(rows.shape[1]).upsert(keys, rows)
