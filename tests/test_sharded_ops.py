"""Sharded operational behaviour: capacity growth, health counters
(bucket drops / dedup saturation), microbatch, and cross-trainer freq
semantics. Round-2 hardening of the mesh path."""
import dataclasses

import numpy as np
import optax
import pytest

import jax
import jax.numpy as jnp

import deeprec_tpu as dr
from deeprec_tpu import feature_column as fc
from deeprec_tpu.config import CounterFilter
from deeprec_tpu.models import ctr
from deeprec_tpu.optim import sparse as sopt
from deeprec_tpu.parallel.trainer import ShardedTrainer, make_mesh
from deeprec_tpu.train.trainer import Trainer

CATS = ["C1", "C2"]


def _make(trainer_cls, capacity=256, n_dev=None, filter_freq=0,
          sparse_lr=0.1, **kw):
    ev_kw = {}
    if filter_freq:
        ev_kw["counter_filter"] = CounterFilter(filter_freq)
    cols = [fc.EmbeddingColumn(fc.CategoricalColumn(n), 8) for n in CATS]
    coll = fc.EmbeddingCollection(
        cols, name="emb", capacity=capacity,
        initializer=dr.Initializer("normal", scale=0.1), **ev_kw)
    model = ctr.DCN(emb_names=CATS, cross_layers=1, deep_units=(16,))
    common = dict(model=model, numeric_columns=[fc.NumericColumn("I1")],
                  collections={"emb": coll},
                  sparse_optimizers={"emb": sopt.sparse_adagrad(sparse_lr)},
                  dense_optimizer=optax.adagrad(0.05))
    if trainer_cls is ShardedTrainer:
        common["mesh"] = make_mesh(n_dev or 4)
    return trainer_cls(**common, **kw)


def _batch(rng, bs=32, vocab=100_000, ids=None):
    b = {"label": rng.integers(0, 2, bs).astype(np.float32),
         "I1": rng.normal(size=bs).astype(np.float32)}
    for n in CATS:
        if ids is not None:
            b[n] = np.resize(np.asarray(ids, np.int64), bs)
        else:
            b[n] = rng.integers(0, vocab, bs).astype(np.int64)
    return b


def test_sharded_maybe_grow_under_load():
    tr = _make(ShardedTrainer, capacity=64, n_dev=4)
    rng = np.random.default_rng(0)
    state = tr.init(jax.random.key(0), _batch(rng))
    # flood with unique ids until the fullest shard passes the threshold
    for i in range(8):
        state = tr.train_step(state, _batch(rng, bs=64))
    h0 = tr.table_health(state)["emb"]
    assert h0["load_factor"] >= 0.7 or h0["overflow"] > 0
    old_size = h0["size"]
    grown = tr.maybe_grow(state)
    assert grown is not state
    assert tr.collections["emb"].config.capacity == 128
    h1 = tr.table_health(grown)["emb"]
    assert h1["capacity"] == 128
    assert h1["size"] == old_size  # growth loses no keys
    # training continues at the new capacity (re-jitted step runs)
    state = tr.train_step(grown, _batch(rng, bs=64))
    assert np.isfinite(float(state.metrics.loss_sum))
    # no NaN poisoning: vacated slot rows were re-filled with adagrad init
    assert np.isfinite(np.asarray(state.tables["emb"].slot["acc"])).all()


def test_sharded_health_reports_bucket_drops():
    tr = _make(ShardedTrainer, capacity=1024, n_dev=1, bucket_slack=1e-6)
    rng = np.random.default_rng(1)
    state = tr.init(jax.random.key(0), _batch(rng, bs=64))
    state = tr.train_step(state, _batch(rng, bs=64))
    h = tr.table_health(state)["emb"]
    # bucket_cap floors at 8; 2 columns x 64 ids of a 100k vocab >> 8 uniques
    assert h["dropped"] > 0
    # the remedy widens buckets and re-jits
    slack = tr.raise_bucket_slack(factor=1e7)
    assert slack > 1.0
    state = tr.train_step(state, _batch(rng, bs=64))
    h2 = tr.table_health(state)["emb"]
    assert h2["dropped"] == h["dropped"]  # no new drops after the raise


def test_health_reports_unique_saturation():
    tr = _make(Trainer)
    coll = tr.collections["emb"]
    coll.config = dataclasses.replace(coll.config, max_unique=8)
    rng = np.random.default_rng(2)
    state = tr.init(jax.random.key(0), _batch(rng, bs=32))
    state = tr.train_step(state, _batch(rng, bs=32))
    h = tr.table_health(state)["emb"]
    assert h["unique_saturated_steps"] >= 1
    assert h["max_n_unique"] >= 8


def _learnable_batch(rng, bs=32, vocab=64):
    """Labels are a deterministic function of one id — memorizable through
    its embedding, so loss decrease is signal, not noise."""
    b = {"I1": rng.normal(size=bs).astype(np.float32)}
    for n in CATS:
        b[n] = rng.integers(0, vocab, bs).astype(np.int64)
    b["label"] = (b["C1"] % 2).astype(np.float32)
    return b


def test_sharded_microbatch_runs_and_learns():
    tr = _make(ShardedTrainer, n_dev=4, microbatches=2, sparse_lr=0.5)
    rng = np.random.default_rng(3)
    state = tr.init(jax.random.key(0), _learnable_batch(rng))
    losses = []  # mean loss of each 10-step window
    for i in range(40):
        state = tr.train_step(state, _learnable_batch(rng))
        if (i + 1) % 10 == 0:
            assert int(state.metrics.count) == 10 * 32
            losses.append(float(state.metrics.loss_sum / state.metrics.count))
            state = tr.reset_metrics(state)
    assert np.isfinite(losses).all()
    # per-microbatch sparse updates + accumulated dense grads still learn
    # (the last window sits >0.1 below the first across init draws)
    assert losses[-1] < losses[0] - 0.05, losses


def test_sharded_microbatch_matches_single_batch_metrics_shape():
    """k=2 over bs=32 produces the same per-step example count and finite
    logits as k=1 (layout sanity for the scan split)."""
    rng = np.random.default_rng(7)
    b = _learnable_batch(rng)
    tr1 = _make(ShardedTrainer, n_dev=4, microbatches=1)
    tr2 = _make(ShardedTrainer, n_dev=4, microbatches=2)
    s1 = tr1.init(jax.random.key(0), b)
    s2 = tr2.init(jax.random.key(0), b)
    s1 = tr1.train_step(s1, b)
    s2 = tr2.train_step(s2, b)
    assert int(s1.metrics.count) == int(s2.metrics.count) == 32


def test_freq_semantics_identical_local_vs_sharded():
    """CounterFilter admission must not change when a run adds --mesh: freq
    counts within-batch MULTIPLICITY (reference AddFreq(count)) on BOTH
    trainers — the exchange routes the per-requester counts to the owner."""
    from deeprec_tpu.checkpoint.saver import table_snapshot_host

    ids = np.asarray([5, 5, 5, 7, 7, 9], np.int64)  # multiplicities 3/2/1
    tr_l = _make(Trainer, filter_freq=2)
    tr_s = _make(ShardedTrainer, n_dev=4, filter_freq=2)
    rng = np.random.default_rng(4)
    b = _batch(rng, bs=12, ids=ids)
    st_l = tr_l.init(jax.random.key(0), b)
    st_s = tr_s.init(jax.random.key(0), b)
    for _ in range(3):
        st_l = tr_l.train_step(st_l, b)
        st_s = tr_s.train_step(st_s, b)

    def freq_by_key(tr, st):
        snap = table_snapshot_host(tr.collections["emb"].config,
                                   st.tables["emb"].ev, st.tables["emb"].slot,
                                   num_shards=getattr(tr, "S", 1), evict=False)
        return dict(zip(snap["keys"].tolist(), snap["freqs"].tolist()))

    fl = freq_by_key(tr_l, st_l)
    fs = freq_by_key(tr_s, st_s)
    assert fl == fs
    # multiplicity: ids 5/7/9 appear 6/4/2 times per batch (bs=12 resize),
    # x3 batches -> freqs {18, 12, 6} (both salted columns alike)
    assert set(fl.values()) == {18, 12, 6}


def test_bf16_exchange_wire_matches_f32_closely():
    """config.exchange_dtype="bfloat16": rows/grads ride the all_to_all in
    bf16 (one rounding on the wire), everything else identical — training
    must track the exact exchange within bf16 tolerance and still learn."""
    def make(exchange):
        cols = [fc.EmbeddingColumn(fc.CategoricalColumn(n), 8) for n in CATS]
        coll = fc.EmbeddingCollection(
            cols, name="emb", capacity=256,
            initializer=dr.Initializer("normal", scale=0.1),
            exchange_dtype=exchange)
        model = ctr.DCN(emb_names=CATS, cross_layers=1, deep_units=(16,))
        return ShardedTrainer(
            model=model, numeric_columns=[fc.NumericColumn("I1")],
            collections={"emb": coll},
            sparse_optimizers={"emb": sopt.sparse_adagrad(0.5)},
            dense_optimizer=optax.adagrad(0.05), mesh=make_mesh(4))

    tr_f32, tr_b16 = make(None), make("bfloat16")
    rng = np.random.default_rng(3)
    batches = [_learnable_batch(rng, bs=64) for _ in range(24)]
    s32 = tr_f32.init(jax.random.key(0), batches[0])
    s16 = tr_b16.init(jax.random.key(0), batches[0])
    first = last = None
    for i, b in enumerate(batches):
        s32 = tr_f32.train_step(s32, b)
        s16 = tr_b16.train_step(s16, b)
        l32 = float(s32.metrics.loss_sum / s32.metrics.count)
        l16 = float(s16.metrics.loss_sum / s16.metrics.count)
        if i == 0:
            first = l16
        last = l16
        # same trajectory within bf16 wire rounding
        assert abs(l32 - l16) < 5e-2, (i, l32, l16)
    assert np.isfinite(last) and last < first + 5e-3  # still learns
    # trained rows track the exact-exchange run (insert order identical,
    # so slots line up; only wire rounding of rows/grads differs)
    v32 = np.asarray(s32.tables["emb"].ev.values)
    v16 = np.asarray(s16.tables["emb"].ev.values)
    np.testing.assert_allclose(v16, v32, rtol=0.1, atol=2e-2)
    # eval-path (readonly) exchange also rides the bf16 wire
    m32 = tr_f32.eval_step(s32, tr_f32.reset_metrics(s32).metrics, batches[0])
    m16 = tr_b16.eval_step(s16, tr_b16.reset_metrics(s16).metrics, batches[0])
    l32 = float(m32.loss_sum / m32.count)
    l16 = float(m16.loss_sum / m16.count)
    assert abs(l32 - l16) < 5e-2, (l32, l16)
