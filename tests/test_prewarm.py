"""Growth compile-ahead (Trainer.prewarm_grow).

Capacity growth is a static-shape change, so the post-growth step is a
full XLA recompile. prewarm_grow compiles the 2x-capacity step in a
background thread against the persistent compilation cache while training
continues; the post-growth rejit then lowers identical HLO and hits the
cache. These tests pin the contract: the clone-trace must not disturb the
live trainer, the warm entry must actually land in the cache, and growth
after a prewarm must keep training bit-normally.
"""
import os
import time

import jax
import numpy as np
import optax
import pytest

import deeprec_tpu as dr
from deeprec_tpu import feature_column as fc
from deeprec_tpu.models import ctr
from deeprec_tpu.optim import sparse as sopt
from deeprec_tpu.train.trainer import Trainer
from deeprec_tpu.utils import compile_cache

CATS = ["C1", "C2"]


def make_trainer(capacity=64):
    cols = [fc.EmbeddingColumn(fc.CategoricalColumn(n), 8) for n in CATS]
    coll = fc.EmbeddingCollection(
        cols, name="emb", capacity=capacity,
        initializer=dr.Initializer("normal", scale=0.1))
    return Trainer(
        model=ctr.DCN(emb_names=CATS, cross_layers=1, deep_units=(16,)),
        numeric_columns=[fc.NumericColumn("I1")],
        collections={"emb": coll},
        sparse_optimizers={"emb": sopt.sparse_adagrad(0.05)},
        dense_optimizer=optax.adagrad(0.05))


def batch_of(ids, bs=16):
    rng = np.random.default_rng(7)
    b = {"label": rng.integers(0, 2, bs).astype(np.float32),
         "I1": rng.normal(size=bs).astype(np.float32)}
    for n in CATS:
        b[n] = np.resize(np.asarray(ids, np.int64), bs)
    return b


def _fill_to(tr, state, n_ids, start=0):
    """Insert ids [start, start+n_ids) through training steps."""
    for lo in range(start, start + n_ids, 8):
        state = tr.train_step(state, batch_of(range(lo, lo + 8)))
    return state


def test_prewarm_caches_grown_step_without_touching_live_trainer(tmp_path):
    from jax.experimental.compilation_cache import compilation_cache as cc

    cache = str(tmp_path / "jit_cache")
    jax.config.update("jax_compilation_cache_dir", cache)
    # a warm CI process can compile this small program in under the
    # persistent cache's min-compile-time threshold (default 1s), in which
    # case jax silently skips the disk write and the entry check below
    # would flake — persist everything for this test
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    # jax latches the persistent-cache object at its first compiled use:
    # when the suite's conftest cache dir has already been used, the
    # config update above is silently ignored and every write goes to the
    # old dir — reset so THIS test's dir takes effect (standalone runs
    # never hit this; a warm full-suite process always did)
    cc.reset_cache()
    try:
        tr = make_trainer(capacity=256)
        state = tr.init(jax.random.key(0), batch_of([0, 1]))
        # each raw id lands one key per column (2 columns) -> 144 keys,
        # load ~0.56: past 0.5, below 0.7
        state = _fill_to(tr, state, 72)
        lf = tr.collections["emb"].load_factor(state.tables["emb"].ev)
        assert 0.5 <= lf < 0.7, lf

        packed = tr.prepare_batch(batch_of([1, 2]))
        warmed = tr.prewarm_grow(state, packed)
        assert warmed == ["emb"]
        # the clone's config mutation must not leak into the live trainer
        assert tr.collections["emb"].config.capacity == 256

        # join the compile thread (deterministic, no cache-dir polling);
        # the timeout only guards a hung compile — the thread shares one
        # core with the rest of CI, so it can legitimately take minutes
        for t in getattr(tr, "_prewarm_threads", []):
            t.join(timeout=900)
            assert not t.is_alive(), "prewarm compile thread still running"
        assert not getattr(tr, "_prewarm_errors", []), tr._prewarm_errors
        entries = [f for f in (os.listdir(cache) if os.path.isdir(cache)
                               else []) if "train_step" in f]
        assert entries, "prewarm thread produced no train_step cache entry"

        # same signature is warmed once
        assert tr.prewarm_grow(state, packed) == []

        # growth then training proceeds normally on the grown table
        state = _fill_to(tr, state, 24, start=72)
        grown = tr.maybe_grow(state)
        assert tr.collections["emb"].config.capacity == 512
        step_before = int(grown.step)
        grown = tr.train_step(grown, batch_of([99, 100]))
        assert int(grown.step) == step_before + 1
        m = float(np.asarray(grown.metrics.loss_sum))
        assert np.isfinite(m)
    finally:
        # back to the suite-wide cache (conftest) for the remaining tests
        compile_cache.enable()
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
        cc.reset_cache()


def test_prewarm_noop_below_threshold_and_for_variants():
    tr = make_trainer(capacity=64)
    state = tr.init(jax.random.key(0), batch_of([0, 1]))
    packed = tr.prepare_batch(batch_of([1, 2]))
    assert tr.prewarm_grow(state, packed) == []  # near-empty table
    # restore the suite-wide cache dir (conftest) for later tests
    compile_cache.enable()


def test_compile_cache_dir_rule(monkeypatch, tmp_path):
    """JAX_COMPILATION_CACHE_DIR wins and nothing overrides it in code;
    otherwise the cache is the checkout's .jax_cache."""
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.cache_dir() == str(tmp_path)
    assert compile_cache.enable() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    repo = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
    assert compile_cache.cache_dir() == os.path.join(repo, ".jax_cache")
    assert compile_cache.enable() == os.path.join(repo, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == os.path.join(
        repo, ".jax_cache")
