"""Sharded-table training over the 8-device virtual CPU mesh: the analog of
the reference's local-cluster distributed tests (grpc_testlib MakeTestCluster
/ SOK multi-GPU unit tests)."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

import deeprec_tpu as dr
from deeprec_tpu import feature_column as fc
from deeprec_tpu.data.criteo import CAT_NAMES, DENSE_NAMES, SyntheticCriteo
from deeprec_tpu.models import ctr
from deeprec_tpu.optim import sparse as sopt
from deeprec_tpu.parallel import sharded
from deeprec_tpu.parallel.trainer import ShardedTrainer, make_mesh
from deeprec_tpu.sparse import embedding_var as ev
from deeprec_tpu.sparse import keys as K
from deeprec_tpu.train import metrics as metrics_lib
from deeprec_tpu.train.trainer import Trainer

N_CAT = 6
EMB_DIM = 8


def _setup(capacity=1 << 10):
    numeric = [fc.NumericColumn(n, log_normalize=True) for n in DENSE_NAMES[:4]]
    emb_cols = [fc.EmbeddingColumn(fc.CategoricalColumn(n), EMB_DIM)
                for n in CAT_NAMES[:N_CAT]]
    # raw exchange tests read init rows without an optimizer update ->
    # eager materialisation
    coll = fc.EmbeddingCollection(emb_cols, name="emb", capacity=capacity,
                                  lazy_init=False,
                                  initializer=dr.Initializer(kind="normal", scale=0.05))
    model = ctr.DLRM(emb_names=[c.name for c in emb_cols], emb_dim=EMB_DIM,
                     bottom_units=(32,), top_units=(64, 32))
    return numeric, emb_cols, coll, model


def _batches(n, bs=256, seed=1):
    gen = SyntheticCriteo(batch_size=bs, vocab_sizes=[100] * 26, seed=seed,
                          noise=0.3, active_features=range(N_CAT))
    return list(gen.take(n))


def test_mesh_has_8_devices():
    assert len(jax.devices()) == 8


def test_exchange_matches_local_lookup():
    """The sharded exchange must return exactly the rows a single-device
    lookup would (same keys -> same deterministic init), and place each key
    on its hash-owner shard."""
    numeric, emb_cols, coll, model = _setup()
    mesh = make_mesh()
    S = 8
    B = 64  # per-device 8
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 500, size=(coll.total_width, B)).astype(np.int64)
    keys2d = K.Keys(jnp.asarray((ids >> 32).astype(np.int32)),
                    jnp.asarray((ids & 0xFFFFFFFF).astype(np.uint32).astype(np.int32)))

    cap_local = 512
    import dataclasses
    coll.config = dataclasses.replace(coll.config, capacity=cap_local)

    def tile(leaf):
        if hasattr(leaf, "ndim") and leaf.ndim >= 1:
            return jnp.tile(leaf, (S,) + (1,) * (leaf.ndim - 1))
        return leaf
    state0 = jax.tree_util.tree_map(tile, ev.create(coll.config))

    from jax.sharding import PartitionSpec as P
    ev_spec = jax.tree_util.tree_map(lambda _: P("dp"), ev.create(coll.config))

    bucket_cap = 80

    def step(state, kh, kl):
        flat = K.Keys(kh.reshape(-1), kl.reshape(-1))
        state, aux = sharded.exchange_lookup_or_create(
            coll, state, flat, jnp.zeros((), jnp.int32), "dp", bucket_cap)
        urows = sharded.gather_owner_rows(state.values, aux)
        rows, valid = sharded.rows_back(urows, aux, "dp", bucket_cap)
        return state, rows, valid, aux.n_dropped

    fn = jax.jit(jax.shard_map(
        step, mesh=mesh,
        in_specs=(ev_spec, P(None, "dp"), P(None, "dp")),
        out_specs=(ev_spec, P("dp"), P("dp"), P("dp")),
        check_vma=False))
    state, rows, valid, dropped = fn(state0, keys2d.hi, keys2d.lo)
    assert int(np.asarray(dropped).sum()) == 0

    # expected rows: deterministic init per key
    flat_global = ids.T  # [B, W] per-example? layout: rows returned are per
    # device-local flat [W * B/S]; global concat over devices along axis 0.
    # Reconstruct: device d handles batch columns d*B/S:(d+1)*B/S
    got = np.asarray(rows).reshape(S, coll.total_width, B // S, EMB_DIM)
    exp_keys = K.from_numpy(ids)  # [W, B]
    exp = np.asarray(ev.init_rows(coll.config, exp_keys.reshape(-1)).reshape(
        coll.total_width, B, EMB_DIM))
    for d in range(S):
        np.testing.assert_allclose(
            got[d], exp[:, d * (B // S):(d + 1) * (B // S)], rtol=1e-5)

    # each key landed on its owner shard
    snap_hi = np.asarray(state.index.key_hi).reshape(S, cap_local)
    snap_lo = np.asarray(state.index.key_lo).reshape(S, cap_local)
    uniq_ids = np.unique(ids)
    owners = np.asarray(sharded._owner_of(K.from_numpy(uniq_ids), S))
    for key, own in zip(uniq_ids, owners):
        khi = np.int32(key >> 32)
        klo = np.int32(np.uint32(key & 0xFFFFFFFF))
        found_on = [d for d in range(S)
                    if ((snap_hi[d] == khi) & (snap_lo[d] == klo)).any()]
        assert found_on == [int(own)], (key, found_on, own)


def test_sharded_training_lifts_auc():
    numeric, emb_cols, coll, model = _setup(capacity=512)  # local cap/shard
    # 4 of the 8 virtual devices: XLA:CPU runs each device's all_to_all on
    # a shared thread pool, and on a loaded host an 8-way rendezvous can
    # miss its 40 s termination timeout (the process aborts)
    tr = ShardedTrainer(
        model, numeric, {"emb": coll},
        {"emb": sopt.sparse_adagrad(0.5, initial_accumulator_value=0.01)},
        optax.adam(3e-3), mesh=make_mesh(4))
    # lift = AUC of steps 121-240 over AUC of steps 1-40. Across init
    # draws the first window reads 0.50-0.51, the late one 0.545-0.57
    # (lift 0.04-0.06) and held-out eval 0.58-0.59
    batches = _batches(240)
    state = tr.init(jax.random.key(0), batches[0])
    for i, b in enumerate(batches):
        state = tr.train_step(state, b)
        if i == 39:
            early = metrics_lib.summarize(state.metrics)
        if i in (39, 119):
            state = tr.reset_metrics(state)
    late = metrics_lib.summarize(state.metrics)
    assert early["examples"] == 40 * 256
    assert late["examples"] == 120 * 256
    assert late["auc"] > early["auc"] + 0.02, (early, late)

    m = metrics_lib.create()
    for b in _batches(8, seed=42):
        m = tr.eval_step(state, m, b)
    es = metrics_lib.summarize(m)
    assert es["auc"] > 0.54, es


def test_sharded_matches_single_device_trajectory():
    """Sync-DP sharded training should track the single-device trajectory
    closely (same data, same init, same optimizer)."""
    batches = _batches(30, bs=128)

    numeric, emb_cols, coll1, model = _setup(capacity=1 << 12)
    tr1 = Trainer(model, numeric, {"emb": coll1},
                  {"emb": sopt.sparse_adagrad(0.3)}, optax.sgd(0.1))
    s1 = tr1.init(jax.random.key(0), batches[0])

    numeric2, emb_cols2, coll2, model2 = _setup(capacity=512)
    tr2 = ShardedTrainer(model2, numeric2, {"emb": coll2},
                         {"emb": sopt.sparse_adagrad(0.3)}, optax.sgd(0.1),
                         mesh=make_mesh())
    s2 = tr2.init(jax.random.key(0), batches[0])

    for b in batches:
        s1 = tr1.train_step(s1, b)
        s2 = tr2.train_step(s2, b)
    m1 = metrics_lib.summarize(s1.metrics)
    m2 = metrics_lib.summarize(s2.metrics)
    assert abs(m1["loss"] - m2["loss"]) < 0.02, (m1, m2)
    assert abs(m1["auc"] - m2["auc"]) < 0.05, (m1, m2)
    # table contents: global row count matches
    n1 = int(s1.tables["emb"].ev.index.size.sum())
    n2 = int(np.asarray(s2.tables["emb"].ev.index.size).sum())
    assert n1 == n2, (n1, n2)
