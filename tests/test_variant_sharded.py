"""Variant collections (multi-hash / adaptive / dynamic-dim) on the mesh.

The same variant tables that train
through the single-device Trainer run under ShardedTrainer on a 4-device
mesh (reference shards every EV variant across PS tasks via `partitioner=`,
kv_variable_ops.py:768,782, variable_scope.py:2292,2348), and their
checkpoints reshard: save on 4 shards, restore on 2, identical state.
"""
import numpy as np
import optax
import pytest

import jax
import jax.numpy as jnp

import deeprec_tpu as dr
from deeprec_tpu import feature_column as fc
from deeprec_tpu.checkpoint import CheckpointManager
from deeprec_tpu.data.criteo import CAT_NAMES, DENSE_NAMES, SyntheticCriteo
from deeprec_tpu.feature_column_variants import (AdaptiveCollection,
                                                 DynamicDimCollection,
                                                 MultiHashCollection)
from deeprec_tpu.models import ctr
from deeprec_tpu.optim import sparse as sopt
from deeprec_tpu.parallel.trainer import ShardedTrainer, make_mesh
from deeprec_tpu.sparse.dynamicdim import DynamicDimConfig
from deeprec_tpu.train import metrics as M
from deeprec_tpu.train.trainer import Trainer
from deeprec_tpu.checkpoint.saver import table_snapshot_host

N_CAT, N_DENSE = 4, 3


def make_trainer(coll, mesh_devices=None):
    numeric = [fc.NumericColumn(n, log_normalize=True)
               for n in DENSE_NAMES[:N_DENSE]]
    model = ctr.DCN(emb_names=[c.name for c in coll.columns],
                    cross_layers=1, deep_units=(32,))
    common = dict(
        model=model, numeric_columns=numeric, collections={"emb": coll},
        sparse_optimizers={"emb": sopt.sparse_adagrad(
            0.5, initial_accumulator_value=0.01)},
        dense_optimizer=optax.adam(3e-3))
    if mesh_devices:
        return ShardedTrainer(mesh=make_mesh(mesh_devices), **common)
    return Trainer(**common)


def batches(n, bs=256, seed=0):
    return list(SyntheticCriteo(
        batch_size=bs, seed=seed, active_features=set(range(N_CAT)),
        noise=0.3, vocab_sizes=[100] * 26).take(n))


def cols(dim=8):
    return [fc.EmbeddingColumn(fc.CategoricalColumn(n), dim)
            for n in CAT_NAMES[:N_CAT]]


def mh_coll(sizes=(256, 64)):
    return MultiHashCollection(cols(), table_sizes=sizes, combiner_op="add")


def ad_coll():
    return AdaptiveCollection(cols(), buckets=128, capacity=1 << 10,
                              counter_filter=dr.CounterFilter(2),
                              initializer=dr.Initializer("normal", scale=0.05))


def dd_coll():
    dd = DynamicDimConfig(block_num=2, block_dim=4, freq_thresholds=(0, 20))
    return DynamicDimCollection(cols(dim=8), dynamic_dim=dd, capacity=1 << 10,
                                initializer=dr.Initializer("normal",
                                                           scale=0.05))


def run(tr, n_train=60, eval_batches=6):
    bs = batches(n_train + 1)
    state = tr.init(jax.random.key(0), bs[0])
    for b in bs[:n_train]:
        state = tr.train_step(state, b)
    ms = M.create()
    for b in batches(eval_batches, seed=77):
        ms = tr.eval_step(state, ms, b)
    return state, M.summarize(ms)["auc"]


@pytest.mark.parametrize("make_coll", [mh_coll, ad_coll, dd_coll],
                         ids=["multihash", "adaptive", "dynamicdim"])
def test_variant_trains_on_mesh(make_coll):
    tr = make_trainer(make_coll(), mesh_devices=4)
    state, auc = run(tr)
    assert auc > 0.54, auc


def test_multihash_mesh_matches_local():
    """Replicated MH tables + allgathered gradient union == the local
    trainer's global-batch update (same dedup'd math, float-assoc apart)."""
    tl = make_trainer(mh_coll())
    ts = make_trainer(mh_coll(), mesh_devices=4)
    bs = batches(10)
    sl = tl.init(jax.random.key(0), bs[0])
    ss = ts.init(jax.random.key(0), bs[0])
    for b in bs:
        sl = tl.train_step(sl, b)
        ss = ts.train_step(ss, b)
    for a, b_ in zip(jax.tree_util.tree_leaves(sl.tables["emb"].ev),
                     jax.tree_util.tree_leaves(ss.tables["emb"].ev)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b_),
                                   rtol=2e-4, atol=2e-5)


def test_adaptive_mesh_admission_matches_local():
    """Integer admission state (freqs, table membership) must be identical
    local vs mesh — the owner-side counting is exact, not approximate."""
    tl = make_trainer(ad_coll())
    ts = make_trainer(ad_coll(), mesh_devices=4)
    bs = batches(8)
    sl = tl.init(jax.random.key(0), bs[0])
    ss = ts.init(jax.random.key(0), bs[0])
    for b in bs:
        sl = tl.train_step(sl, b)
        ss = ts.train_step(ss, b)

    def freq_map(tr, st, S):
        snap = table_snapshot_host(tr.collections["emb"].config,
                                   st.tables["emb"].ev.ev,
                                   st.tables["emb"].slot["ev"],
                                   num_shards=S, evict=False)
        return dict(zip(snap["keys"].tolist(), snap["freqs"].tolist()))

    fl = freq_map(tl, sl, 1)
    fs = freq_map(ts, ss, 4)
    assert fl == fs
    assert len(fl) > 0


def test_dynamicdim_mesh_blocks_gate_on_freq():
    tr = make_trainer(dd_coll(), mesh_devices=4)
    state, auc = run(tr, n_train=60)
    snap = table_snapshot_host(tr.collections["emb"].config,
                               state.tables["emb"].ev,
                               state.tables["emb"].slot,
                               num_shards=4, evict=False)
    freqs = snap["freqs"]
    rare = (freqs > 0) & (freqs < 20)
    if rare.any():
        # block 2 of rare rows took no updates: adagrad acc still at init
        acc_key = next(k for k in snap if k.startswith("slot__")
                       and "acc" in k)
        acc = snap[acc_key][rare]
        np.testing.assert_allclose(acc[:, 4:], 0.01, atol=1e-6)
    assert auc > 0.54


@pytest.mark.parametrize("make_coll", [mh_coll, ad_coll, dd_coll],
                         ids=["multihash", "adaptive", "dynamicdim"])
def test_variant_save_on_4_restore_on_2(tmp_path, make_coll):
    tr4 = make_trainer(make_coll(), mesh_devices=4)
    bs = batches(6)
    st4 = tr4.init(jax.random.key(0), bs[0])
    for b in bs[:5]:
        st4 = tr4.train_step(st4, b)
    CheckpointManager(str(tmp_path)).save(tr4, st4, evict=False)

    tr2 = make_trainer(make_coll(), mesh_devices=2)
    st2 = tr2.init(jax.random.key(1), bs[0])
    st2, ok = CheckpointManager(str(tmp_path)).restore(tr2, st2)
    assert ok

    # evaluation over the restored state matches the source mesh exactly
    ms4, ms2 = M.create(), M.create()
    for b in batches(4, seed=99):
        ms4 = tr4.eval_step(st4, ms4, b)
        ms2 = tr2.eval_step(st2, ms2, b)
    s4, s2 = M.summarize(ms4), M.summarize(ms2)
    np.testing.assert_allclose(s4["auc"], s2["auc"], atol=1e-6)
    np.testing.assert_allclose(s4["loss"], s2["loss"], rtol=1e-5)

    # and training continues on the restored mesh
    st2 = tr2.train_step(st2, bs[5])
    assert np.isfinite(float(np.asarray(st2.metrics.loss_sum)))


def ht_coll(capacity=1 << 10, admit=None):
    from deeprec_tpu.feature_column_variants import HashTableCollection
    return HashTableCollection(cols(), name="emb", capacity=capacity,
                               admit=admit,
                               initializer=dr.Initializer("normal",
                                                          scale=0.05))


def test_hashtable_collection_trains_on_mesh():
    tr = make_trainer(ht_coll(), mesh_devices=4)
    state, auc = run(tr)
    assert auc > 0.54, auc
    # per-shard id spaces filled
    assert int(np.asarray(state.tables["emb"].ev.alloc.next_id).sum()) > 0


def test_hashtable_collection_mesh_admission_matches_local():
    """CBF admission (id allocation) identical local vs mesh: same key set
    allocated after the same batches."""
    import jax.numpy as jnp
    admit = dr.CBFFilter(filter_freq=3, max_element_size=4096)
    tl = make_trainer(ht_coll(admit=admit))
    ts = make_trainer(ht_coll(admit=admit), mesh_devices=4)
    bs = batches(6)
    sl = tl.init(jax.random.key(0), bs[0])
    ss = ts.init(jax.random.key(0), bs[0])
    for b in bs:
        sl = tl.train_step(sl, b)
        ss = ts.train_step(ss, b)

    def key_set(st):
        hi = np.asarray(st.tables["emb"].ev.alloc.index.key_hi)
        lo = np.asarray(st.tables["emb"].ev.alloc.index.key_lo)
        ids = np.asarray(st.tables["emb"].ev.alloc.ids)
        live = ~((hi == -1) & (lo == -1)) & (ids >= 0)
        return set((((hi[live].astype(np.int64) << 32)
                     | lo[live].astype(np.uint32).astype(np.int64))).tolist())

    kl, ks = key_set(sl), key_set(ss)
    assert kl == ks and len(kl) > 0


def test_hashtable_collection_sharded_grow_under_load():
    """The DHT version of test_sharded_maybe_grow_under_load: flood a
    small-capacity sharded hash-table collection, the per-shard allocators
    rebuild at 2x, ids and rows survive, health stays clean after."""
    tr = make_trainer(ht_coll(capacity=64), mesh_devices=4)
    coll = tr.collections["emb"]
    bs = batches(10, bs=128, seed=5)
    state = tr.init(jax.random.key(0), bs[0])
    for b in bs[:6]:
        state = tr.train_step(state, b)
    h0 = tr.table_health(state)["emb"]
    assert h0["load_factor"] >= 0.7 or h0["overflow"] > 0
    before = {}
    ev_st = state.tables["emb"].ev
    hi = np.asarray(ev_st.alloc.index.key_hi)
    lo = np.asarray(ev_st.alloc.index.key_lo)
    state = tr.maybe_grow(state)
    assert coll.config.capacity == 128
    # training continues, no overflow accumulation
    for b in bs[6:]:
        state = tr.train_step(state, b)
    h1 = tr.table_health(state)["emb"]
    assert h1["capacity"] == 128
    assert np.isfinite(float(np.asarray(state.metrics.loss_sum)))


def test_hashtable_collection_save_on_4_restore_on_2(tmp_path):
    """Reshard-restore equality for the second KV stack: per-key rows
    survive a 4 -> 2 shard change (ids re-allocate per shard)."""
    from deeprec_tpu.sparse import hash_table_api as hta
    from deeprec_tpu.sparse import keys as K
    tr4 = make_trainer(ht_coll(), mesh_devices=4)
    bs = batches(6)
    st4 = tr4.init(jax.random.key(0), bs[0])
    for b in bs[:5]:
        st4 = tr4.train_step(st4, b)
    CheckpointManager(str(tmp_path)).save(tr4, st4, evict=False)
    tr2 = make_trainer(ht_coll(), mesh_devices=2)
    st2 = tr2.init(jax.random.key(1), bs[0])
    st2, ok = CheckpointManager(str(tmp_path)).restore(tr2, st2)
    assert ok

    def rows_by_key(trx, stx, S):
        ev_st = stx.tables["emb"].ev
        cap = trx.collections["emb"].config.capacity
        hi = np.asarray(ev_st.alloc.index.key_hi).reshape(S, cap)
        lo = np.asarray(ev_st.alloc.index.key_lo).reshape(S, cap)
        ids = np.asarray(ev_st.alloc.ids).reshape(S, cap)
        rows = np.asarray(ev_st.table.rows).reshape(S, cap + 1, -1)
        out = {}
        for s in range(S):
            live = ~((hi[s] == -1) & (lo[s] == -1)) & (ids[s] >= 0)
            k64 = ((hi[s][live].astype(np.int64) << 32)
                   | lo[s][live].astype(np.uint32).astype(np.int64))
            r = rows[s][ids[s][live]]
            out.update({k: r[i].tobytes()
                        for i, k in enumerate(k64.tolist())})
        return out

    m4 = rows_by_key(tr4, st4, 4)
    m2 = rows_by_key(tr2, st2, 2)
    assert m4 == m2 and len(m4) > 0
    # eval parity + training continues on the restored mesh
    ms4, ms2 = M.create(), M.create()
    for b in batches(3, seed=99):
        ms4 = tr4.eval_step(st4, ms4, b)
        ms2 = tr2.eval_step(st2, ms2, b)
    np.testing.assert_allclose(M.summarize(ms4)["auc"],
                               M.summarize(ms2)["auc"], atol=1e-6)
    st2 = tr2.train_step(st2, bs[5])
    assert np.isfinite(float(np.asarray(st2.metrics.loss_sum)))


def test_variant_save_restore_key_state_equality(tmp_path):
    """Adaptive: per-key EV rows/meta survive 4->2 reshard bit-for-bit."""
    tr4 = make_trainer(ad_coll(), mesh_devices=4)
    bs = batches(6)
    st4 = tr4.init(jax.random.key(0), bs[0])
    for b in bs[:5]:
        st4 = tr4.train_step(st4, b)
    CheckpointManager(str(tmp_path)).save(tr4, st4, evict=False)
    tr2 = make_trainer(ad_coll(), mesh_devices=2)
    st2 = tr2.init(jax.random.key(1), bs[0])
    st2, ok = CheckpointManager(str(tmp_path)).restore(tr2, st2)
    assert ok

    def by_key(tr, st, S):
        snap = table_snapshot_host(tr.collections["emb"].config,
                                   st.tables["emb"].ev.ev,
                                   st.tables["emb"].slot["ev"],
                                   num_shards=S, evict=False)
        return {k: (snap["values"][i].tobytes(), snap["freqs"][i],
                    snap["versions"][i])
                for i, k in enumerate(snap["keys"].tolist())}

    m4 = by_key(tr4, st4, 4)
    m2 = by_key(tr2, st2, 2)
    assert m4 == m2 and len(m4) > 0
    # static table identical too
    np.testing.assert_array_equal(np.asarray(st4.tables["emb"].ev.static),
                                  np.asarray(st2.tables["emb"].ev.static))
