"""Host-tier serving: a model larger than the device row budget serves
from device(hot) + host-DRAM(cold) with predictions identical to all-HBM.

Reference: CPU-resident EV serving via
the Triton shim, triton/tensorflow_backend_tf.cc — cold rows never need
accelerator residency."""
import numpy as np
import optax
import pytest

import jax

import deeprec_tpu as dr
from deeprec_tpu import feature_column as fc
from deeprec_tpu.checkpoint import CheckpointManager
from deeprec_tpu.data.criteo import CAT_NAMES, DENSE_NAMES, SyntheticCriteo
from deeprec_tpu.models import ctr
from deeprec_tpu.optim import sparse as sopt
from deeprec_tpu.serving import Predictor, TieredPredictor
from deeprec_tpu.train.trainer import Trainer

N_CAT, N_DENSE = 4, 3


def make_collection():
    emb_cols = [fc.EmbeddingColumn(fc.CategoricalColumn(n), 8)
                for n in CAT_NAMES[:N_CAT]]
    return fc.EmbeddingCollection(
        emb_cols, name="emb", capacity=1 << 11,
        initializer=dr.Initializer(kind="normal", scale=0.05),
        track_freq=True, track_version=True)


def make_trainer():
    numeric = [fc.NumericColumn(n, log_normalize=True)
               for n in DENSE_NAMES[:N_DENSE]]
    coll = make_collection()
    model = ctr.DCN(emb_names=[c.name for c in coll.columns],
                    cross_layers=1, deep_units=(32,))
    return Trainer(model, numeric, {"emb": coll},
                   {"emb": sopt.sparse_adagrad(0.1)}, optax.adagrad(0.05))


def batches(n, bs=128, seed=0):
    return list(SyntheticCriteo(
        batch_size=bs, seed=seed, active_features=set(range(N_CAT)),
        vocab_sizes=[400] * 26).take(n))


@pytest.fixture(scope="module")
def trained_ckpt(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tiered_serving"))
    tr = make_trainer()
    bs = batches(8)
    state = tr.init(jax.random.key(0), bs[0])
    for b in bs:
        state = tr.train_step(state, b)
    CheckpointManager(d).save(tr, state, evict=False)
    return d, tr


def _predictors(trained_ckpt, budget):
    d, tr = trained_ckpt
    full = Predictor(tr.model, tr.numeric_columns,
                     {"emb": make_collection()}, d)
    tiered = TieredPredictor(tr.model, tr.numeric_columns,
                             {"emb": make_collection()}, d,
                             device_row_budget=budget)
    return full, tiered


def test_tiered_matches_full_hbm(trained_ckpt):
    full, tiered = _predictors(trained_ckpt, budget=0)  # sized below
    n_rows = len(tiered._device_keys["emb"]) + tiered.host_rows("emb")
    # rebuild with a budget 4x smaller than the table
    _, tiered = _predictors(trained_ckpt, budget=max(n_rows // 4, 1))
    assert tiered.host_rows("emb") >= 3 * len(tiered._device_keys["emb"]) \
        - 8, (tiered.host_rows("emb"), len(tiered._device_keys["emb"]))
    for b in batches(4, seed=55):
        pf = full.predict(b)
        pt = tiered.predict(b)
        np.testing.assert_allclose(pf, pt, rtol=1e-5, atol=1e-6)


def test_tiered_unknown_keys_read_default(trained_ckpt):
    full, tiered = _predictors(trained_ckpt, budget=64)
    b = batches(1, seed=123)[0]
    for n in CAT_NAMES[:N_CAT]:
        b[n] = b[n] + 10_000_000  # ids never trained
    np.testing.assert_allclose(full.predict(b), tiered.predict(b),
                               rtol=1e-5, atol=1e-6)


def test_tiered_incremental_refresh(trained_ckpt, tmp_path):
    import shutil
    d_src, tr = trained_ckpt
    d = str(tmp_path / "ckpt")
    shutil.copytree(d_src, d)
    full = Predictor(tr.model, tr.numeric_columns,
                     {"emb": make_collection()}, d)
    tiered = TieredPredictor(tr.model, tr.numeric_columns,
                             {"emb": make_collection()}, d,
                             device_row_budget=128)
    # continue training (new + updated keys), write an incremental
    tr2 = make_trainer()
    bs = batches(10, seed=9)
    st = tr2.init(jax.random.key(1), bs[0])
    mgr = CheckpointManager(d)
    st, ok = mgr.restore(tr2, st)
    assert ok
    for b in bs[:3]:
        st = tr2.train_step(st, b)
    mgr.save_incremental(tr2, st)
    assert full.refresh() and tiered.refresh()
    for b in batches(3, seed=77):
        np.testing.assert_allclose(full.predict(b), tiered.predict(b),
                                   rtol=1e-5, atol=1e-6)
