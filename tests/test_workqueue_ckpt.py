"""WorkQueue position in training checkpoints.

The reference's WorkQueue is a SaveableObject: queue position lives in
the checkpoint (python/ops/work_queue.py:113), so restoring an older
checkpoint rewinds the data position consistently with table state —
work items consumed between that save and a crash are re-served exactly
once, not silently skipped. Here the channel is
CheckpointManager.attach_aux + WorkQueue.snapshot/restore_snapshot.
"""
import json
import os

import numpy as np
import pytest

import jax
import optax

import deeprec_tpu as dr
from deeprec_tpu import feature_column as fc
from deeprec_tpu.checkpoint.saver import CheckpointManager
from deeprec_tpu.data.work_queue import WorkQueue
from deeprec_tpu.models import ctr
from deeprec_tpu.optim import sparse as sopt
from deeprec_tpu.train.trainer import Trainer


def _tiny_trainer():
    cols = [fc.EmbeddingColumn(fc.CategoricalColumn("C1"), 4)]
    coll = fc.EmbeddingCollection(cols, name="emb", capacity=64,
                                  initializer=dr.Initializer("normal", 0.1))
    model = ctr.DCN(emb_names=["C1"], cross_layers=1, deep_units=(8,))
    return Trainer(model=model, numeric_columns=[fc.NumericColumn("I1")],
                   collections={"emb": coll},
                   sparse_optimizers={"emb": sopt.sparse_adagrad(0.1)},
                   dense_optimizer=optax.adagrad(0.05))


def _batch(i):
    rng = np.random.default_rng(i)
    return {"label": rng.integers(0, 2, 8).astype(np.float32),
            "I1": rng.normal(size=8).astype(np.float32),
            "C1": rng.integers(0, 32, 8).astype(np.int64)}


FILES = [f"f{i}" for i in range(4)]
EPOCHS = 2


def test_kill_restore_rewinds_queue_no_skip_no_dup(tmp_path):
    """Claim 3 items, checkpoint, claim 2 more, 'crash', restore: the
    2 post-checkpoint items are re-served; every (epoch, item) is
    consumed exactly once across the whole run."""
    qdir = str(tmp_path / "q")
    cdir = str(tmp_path / "c")
    tr = _tiny_trainer()
    state = tr.init(jax.random.key(0), _batch(0))
    mgr = CheckpointManager(cdir)
    q = WorkQueue(FILES, path=qdir, num_epochs=EPOCHS)
    mgr.attach_aux("workqueue", q.snapshot, q.restore_snapshot)

    consumed_before = [q.take() for _ in range(3)]
    state = tr.train_step(state, _batch(1))
    mgr.save(tr, state)
    claims_at_save = set(q.snapshot()["claims"])
    assert len(claims_at_save) == 3

    # work continues past the save... then the process dies
    lost = [q.take() for _ in range(2)]
    assert all(x is not None for x in lost)
    del q, tr, state

    # fresh process: new queue over the same dir (claims dir says 5 done),
    # restore the checkpoint -> queue rewinds to 3
    tr2 = _tiny_trainer()
    s2 = tr2.init(jax.random.key(1), _batch(0))
    q2 = WorkQueue(FILES, path=qdir, num_epochs=EPOCHS)
    assert q2.claimed() == 5  # pre-restore: the crashed run's claims
    mgr2 = CheckpointManager(cdir)
    mgr2.attach_aux("workqueue", q2.snapshot, q2.restore_snapshot)
    s2, ok = mgr2.restore(tr2, s2)
    assert ok
    assert set(q2.snapshot()["claims"]) == claims_at_save

    consumed_after = list(iter(q2))
    # exactly-once over the whole run: 3 before + 5 after = 4 files x 2
    # epochs, and the 2 'lost' items are among the re-served ones
    assert len(consumed_after) == len(FILES) * EPOCHS - 3
    from collections import Counter
    total = Counter(consumed_before) + Counter(consumed_after)
    assert total == Counter(FILES * EPOCHS)


def test_incremental_saves_carry_queue_state(tmp_path):
    qdir = str(tmp_path / "q")
    cdir = str(tmp_path / "c")
    tr = _tiny_trainer()
    state = tr.init(jax.random.key(0), _batch(0))
    mgr = CheckpointManager(cdir)
    q = WorkQueue(FILES, path=qdir, num_epochs=EPOCHS)
    mgr.attach_aux("workqueue", q.snapshot, q.restore_snapshot)
    q.take()
    state = tr.train_step(state, _batch(1))
    mgr.save(tr, state)
    q.take()
    state = tr.train_step(state, _batch(2))
    mgr.save_incremental(tr, state)
    q.take()  # lost after the incremental

    q2 = WorkQueue(FILES, path=qdir, num_epochs=EPOCHS)
    tr2 = _tiny_trainer()
    s2 = tr2.init(jax.random.key(1), _batch(0))
    mgr2 = CheckpointManager(cdir)
    mgr2.attach_aux("workqueue", q2.snapshot, q2.restore_snapshot)
    s2, ok = mgr2.restore(tr2, s2)
    assert ok
    # the NEWEST save (the incremental) wins: 2 claims, not 1 or 3
    assert len(q2.snapshot()["claims"]) == 2


def test_snapshot_restore_memory_mode():
    q = WorkQueue(FILES, num_epochs=1)
    a = q.take()
    snap = q.snapshot()
    b = q.take()
    q.restore_snapshot(snap)
    rest = list(iter(q))
    assert sorted([a] + rest) == sorted(FILES)
    assert b in rest  # the post-snapshot item was re-served


def test_cli_stream_rewinds_from_checkpoint(tmp_path):
    """criteo_train_stream applies the newest checkpoint's queue snapshot
    BEFORE any claim (so the restored run re-reads lost files)."""
    from deeprec_tpu.data.criteo import SyntheticCriteo
    from deeprec_tpu.train import cli

    # two tiny criteo files
    files = []
    for i in range(2):
        p = str(tmp_path / f"part{i}.tsv")
        with open(p, "w") as f:
            for r in range(8):
                f.write("1\t" + "\t".join(["1"] * 13) + "\t"
                        + "\t".join([f"{i:02x}{r:02x}"] * 26) + "\n")
        files.append(p)

    qdir = str(tmp_path / "q")
    cdir = str(tmp_path / "c")
    tr = _tiny_trainer()
    state = tr.init(jax.random.key(0), _batch(0))
    mgr = CheckpointManager(cdir)
    q0 = WorkQueue(files, path=qdir, num_epochs=1)
    mgr.attach_aux("workqueue", q0.snapshot, None)
    mgr.save(tr, state)          # snapshot: nothing claimed yet
    q0.take()
    q0.take()                    # both claimed after the save, then crash

    import argparse
    args = argparse.Namespace(data_location=",".join(files + [files[-1]]),
                              synthetic=False, workqueue=qdir,
                              checkpoint=cdir, batch_size=4,
                              seed=0)
    stream = cli.criteo_train_stream(args)
    # the rewind happened at stream creation, BEFORE any claim (the cli's
    # WorkQueue runs num_epochs=1000, so we sample rather than drain)
    assert args._workqueue.claimed() == 0
    next(stream)
    assert args._workqueue.claimed() >= 1  # lost file re-served