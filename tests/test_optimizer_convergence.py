"""Per-optimizer convergence matrix: every registered EV optimizer must
actually learn (loss decreases, AUC lifts) on a memorizable stream — the
analog of the reference's per-optimizer EmbeddingVariable tests
(python/ops/embedding_variable_ops_test.py:654-1244, one test per
KvSparseApply* kernel)."""
import numpy as np
import optax
import pytest

import jax

import deeprec_tpu as dr
from deeprec_tpu import feature_column as fc
from deeprec_tpu.models import ctr
from deeprec_tpu.optim import sparse as sopt
from deeprec_tpu.train import metrics as M
from deeprec_tpu.train.trainer import Trainer

CATS = ["C1", "C2"]

# optimizer name -> (ctor kwargs, fused_slot_columns multiplier)
MATRIX = {
    "sgd": (dict(learning_rate=0.5), 0),
    "adagrad": (dict(learning_rate=0.5), 0),
    "adagrad_fused": (dict(learning_rate=0.5), 1),
    "adagrad_decay": (dict(learning_rate=0.5, accumulator_decay_step=20), 0),
    "adagrad_decay_v2": (dict(learning_rate=0.5, accumulator_decay_step=20), 0),
    "adam": (dict(learning_rate=0.05), 0),
    "adam_fused": (dict(learning_rate=0.05), 2),
    "adam_async": (dict(learning_rate=0.05), 0),
    "ftrl": (dict(learning_rate=0.5), 0),
    "momentum": (dict(learning_rate=0.2), 0),
    "proximal_gd": (dict(learning_rate=0.5,
                         l1_regularization_strength=1e-4,
                         l2_regularization_strength=1e-4), 0),
    "proximal_adagrad": (dict(learning_rate=0.5,
                              l1_regularization_strength=1e-4,
                              l2_regularization_strength=1e-4), 0),
}

DIM = 8


def _batch(rng, bs=64, vocab=64):
    b = {"I1": rng.normal(size=bs).astype(np.float32)}
    for n in CATS:
        b[n] = rng.integers(0, vocab, bs).astype(np.int64)
    # memorizable per-id label: each C1 id fully determines the label
    b["label"] = (b["C1"] % 2).astype(np.float32)
    return b


def test_registry_covers_reference_ev_optimizers():
    """Every reference EV optimizer family has a registered analog."""
    for name in ["sgd", "adagrad", "adagrad_decay", "adagrad_decay_v2",
                 "adam", "adam_async", "ftrl", "momentum", "proximal_gd",
                 "proximal_adagrad"]:
        assert name in sopt.REGISTRY, name


@pytest.mark.parametrize("name", sorted(MATRIX))
def test_optimizer_learns(name):
    kwargs, fused_mult = MATRIX[name]
    opt = sopt.REGISTRY[name](**kwargs)
    fc_kw = {}
    if fused_mult:
        fc_kw = dict(fused_slot_columns=fused_mult * DIM,
                     fused_slot_init=0.1 if name == "adagrad_fused" else 0.0)
    cols = [fc.EmbeddingColumn(fc.CategoricalColumn(n), DIM) for n in CATS]
    coll = fc.EmbeddingCollection(
        cols, name="emb", capacity=256,
        initializer=dr.Initializer("normal", scale=0.1), **fc_kw)
    model = ctr.DCN(emb_names=CATS, cross_layers=1, deep_units=(16,))
    tr = Trainer(model, [fc.NumericColumn("I1")], {"emb": coll},
                 {"emb": opt}, optax.adagrad(0.05))
    rng = np.random.default_rng(5)
    state = tr.init(jax.random.key(0), _batch(rng))
    # 80 steps: plain SGD at 40 reaches the late-window bars for only
    # some init draws; at 80 every draw clears them by a wide margin
    for i in range(80):
        state = tr.train_step(state, _batch(rng))
    early = M.summarize(state.metrics)  # includes the random early phase
    state = tr.reset_metrics(state)
    for i in range(10):
        state = tr.train_step(state, _batch(rng))
    late = M.summarize(state.metrics)  # trained-model window
    assert np.isfinite(late["loss"]), (name, late)
    assert late["loss"] < early["loss"] - 0.01, (name, early, late)
    assert late["auc"] > 0.75, (name, late["auc"])
