"""Multi-process distributed validation: the grpc_testlib local-cluster
analog (reference core/distributed_runtime/rpc/grpc_testlib.h:43
MakeTestCluster spawns subprocess workers; master_test/grpc_session_test
drive them).

Here: 2 subprocess workers x 4 virtual CPU devices each join one
jax.distributed cluster (gloo collectives over DCN-equivalent TCP), run
the REAL ShardedTrainer over the 8-device global mesh on per-process batch
shards, save a multi-part checkpoint, and the test asserts step / metric /
table equality against an in-process single-controller run of the same
global stream — then restores the 2-process checkpoint into a
single-process trainer with a DIFFERENT shard count (reshard-on-restore)
and trains on.
"""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

import jax

from mp_model import GLOBAL_BATCH, STEPS, global_batch, make_common

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "mp_worker.py")


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _spawn_cluster(tmp_path, nproc=2, dev_per=4, tiered=False,
                   host_index=False, timeout=600):
    port = _free_port()
    ckpt = str(tmp_path / "ckpt")
    outs = [str(tmp_path / f"out{p}.json") for p in range(nproc)]
    procs = []
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    env["PYTHONPATH"] = REPO
    for p in range(nproc):
        args = [sys.executable, WORKER, str(p), str(nproc), str(port),
                str(dev_per), ckpt, outs[p]] \
            + (["--tiered"] if tiered else []) \
            + (["--host_index"] if host_index else [])
        procs.append(subprocess.Popen(
            args, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, cwd=REPO))
    logs = []
    for p, proc in enumerate(procs):
        try:
            out, _ = proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        logs.append(out)
        assert proc.returncode == 0, f"worker {p} failed:\n{out[-4000:]}"
    return ckpt, [json.load(open(o)) for o in outs], logs


def _baseline():
    """Single-controller 8-device run of the same global stream."""
    from deeprec_tpu.parallel.trainer import ShardedTrainer, make_mesh
    from deeprec_tpu.train import metrics as M

    tr = ShardedTrainer(mesh=make_mesh(8), **make_common())
    state = tr.init(jax.random.key(0), global_batch(0))
    for i in range(STEPS):
        state = tr.train_step(state, global_batch(i))
    return tr, state, M.summarize(state.metrics)


def _snap(tr, state):
    from deeprec_tpu.checkpoint.saver import table_snapshot_host
    s = table_snapshot_host(tr.collections["emb"].config,
                            state.tables["emb"].ev, state.tables["emb"].slot,
                            num_shards=tr.S, evict=False)
    o = np.argsort(s["keys"])
    return {k: v[o] for k, v in s.items() if k not in ("cbf", "cbf_shards")}


@pytest.mark.slow
def test_two_process_cluster_matches_single_controller(tmp_path):
    ckpt, outs, logs = _spawn_cluster(tmp_path, nproc=2, dev_per=4)
    tr_b, st_b, m_b = _baseline()

    # step/metric equality: the 2-process run IS the same 8-device program
    for o in outs:
        assert o["step"] == STEPS
        assert o["count"] == STEPS * GLOBAL_BATCH
        assert abs(o["loss"] - m_b["loss"]) < 1e-5, (o, m_b)
        assert abs(o["auc"] - m_b["auc"]) < 1e-4
        assert o["health"]["dropped"] == 0

    # table equality: restore the multi-part checkpoint into a
    # single-process trainer with a DIFFERENT shard count (8 -> 4)
    from deeprec_tpu.checkpoint import CheckpointManager
    from deeprec_tpu.parallel.trainer import ShardedTrainer, make_mesh

    tr_r = ShardedTrainer(mesh=make_mesh(4), **make_common())
    st_r = tr_r.init(jax.random.key(0), global_batch(0))
    st_r, ok = CheckpointManager(ckpt).restore(tr_r, st_r)
    assert ok
    assert int(st_r.step) == STEPS

    sb, sr = _snap(tr_b, st_b), _snap(tr_r, st_r)
    np.testing.assert_array_equal(sb["keys"], sr["keys"])
    np.testing.assert_allclose(sb["values"], sr["values"], atol=1e-6)
    np.testing.assert_array_equal(sb["freqs"], sr["freqs"])
    np.testing.assert_array_equal(sb["versions"], sr["versions"])
    for k in sb:
        if k.startswith("slot__"):
            np.testing.assert_allclose(sb[k], sr[k], atol=1e-6)

    # ...and training continues from the restored state
    st_r = tr_r.train_step(st_r, global_batch(STEPS))
    assert np.isfinite(float(st_r.metrics.loss_sum))


def _tiered_baseline(tmp_path):
    """Single-controller 8-device tiered run of the same global stream,
    with the same demotion schedule as mp_worker."""
    from deeprec_tpu.checkpoint import CheckpointManager
    from deeprec_tpu.parallel.tiered import TieredShardedTrainer
    from deeprec_tpu.parallel.trainer import make_mesh
    from deeprec_tpu.train import metrics as M

    tr = TieredShardedTrainer(mesh=make_mesh(8), **make_common(tiered=True))
    state = tr.init(jax.random.key(0), global_batch(0))
    for i in range(STEPS):
        state = tr.train_step(state, global_batch(i))
        if i == STEPS - 2:
            state = tr.maybe_demote(state)
    ckpt_b = str(tmp_path / "ckpt_base")
    CheckpointManager(ckpt_b).save(tr, state, evict=False)
    return tr, state, M.summarize(state.metrics), ckpt_b


def _ckpt_rows(ckpt):
    """Per-key multimap of device + tier rows of a checkpoint (a key can
    appear in both: demoted, then re-created on device while its tier row
    stayed behind — the restore path reconciles by version). Values carry
    as float arrays so callers can compare within a ULP tolerance
    (cross-deployment collective reduction order differs)."""
    from deeprec_tpu.checkpoint import format as F
    base, _ = F.restore_plan(ckpt)
    dev = F.read_table(base["path"], "emb")
    out = {}
    for i, k in enumerate(dev["keys"]):
        out.setdefault(int(k), []).append(
            ("dev", dev["values"][i], int(dev["freqs"][i]),
             int(dev["versions"][i])))
    try:
        tier = F.read_table(base["path"], "__tier__emb")
    except FileNotFoundError:
        return {k: sorted(v, key=lambda e: e[0]) for k, v in out.items()}, 0
    for i, k in enumerate(tier["keys"]):
        out.setdefault(int(k), []).append(("tier", tier["rows"][i]))
    return {k: sorted(v, key=lambda e: e[0]) for k, v in out.items()}, \
        len(tier["keys"])


def _assert_rows_equal(rows_a, rows_b):
    """Structure (key sets, dev/tier placement), freqs and versions match
    EXACTLY; float rows match to 1e-6 (collective association differs
    between a gloo cluster and a single controller)."""
    assert rows_a.keys() == rows_b.keys()
    for k, ea in rows_a.items():
        eb = rows_b[k]
        assert [e[0] for e in ea] == [e[0] for e in eb], k
        for xa, xb in zip(ea, eb):
            np.testing.assert_allclose(xa[1], xb[1], atol=1e-6, rtol=1e-5)
            assert xa[2:] == xb[2:], k


@pytest.mark.slow
def test_two_process_tiered_cluster(tmp_path):
    """TieredShardedTrainer under 2 processes demotes/promotes against
    process-local shards AND matches a single-controller tiered run
    exactly: metrics, per-key device rows, per-key tier rows, and the
    per-shard CBF admission sketches all agree (the multi-part checkpoint
    carries tier rows and CBF blocks per part)."""
    ckpt, outs, logs = _spawn_cluster(tmp_path, nproc=2, dev_per=4,
                                      tiered=True)
    tr_b, st_b, m_b, ckpt_b = _tiered_baseline(tmp_path)
    for o in outs:
        assert o["step"] == STEPS
        assert abs(o["loss"] - m_b["loss"]) < 1e-5, (o["loss"], m_b["loss"])
        assert abs(o["auc"] - m_b["auc"]) < 1e-4

    rows_mp, tier_mp = _ckpt_rows(ckpt)
    rows_b, tier_b = _ckpt_rows(ckpt_b)
    assert tier_mp == tier_b > 0  # demotion really ran, same rows chosen
    assert len(rows_mp) > 0
    _assert_rows_equal(rows_mp, rows_b)

    # restore the 2-process ckpt at the SAME shard count: the per-shard CBF
    # sketches restore exactly, so admission behavior cannot diverge
    from deeprec_tpu.checkpoint import CheckpointManager
    from deeprec_tpu.parallel.tiered import TieredShardedTrainer
    from deeprec_tpu.parallel.trainer import make_mesh
    tr_r = TieredShardedTrainer(mesh=make_mesh(8), **make_common(tiered=True))
    st_r = tr_r.init(jax.random.key(0), global_batch(0))
    st_r, ok = CheckpointManager(ckpt).restore(tr_r, st_r)
    assert ok
    np.testing.assert_array_equal(
        np.asarray(st_r.tables["emb"].ev.cbf),
        np.asarray(st_b.tables["emb"].ev.cbf))
    # ...and training continues with identical admission on both
    st_b2 = tr_b.train_step(st_b, global_batch(STEPS))
    st_r2 = tr_r.train_step(st_r, global_batch(STEPS))
    np.testing.assert_array_equal(
        np.asarray(st_r2.tables["emb"].ev.cbf),
        np.asarray(st_b2.tables["emb"].ev.cbf))


def _snap_host_sharded(tr, state):
    """Key-sorted table snapshot of a HostShardedCollection trainer (its
    ckpt_arrays IS the standard 4-array format, keys from the per-shard
    resolvers)."""
    coll = tr.collections["emb"]
    b = state.tables["emb"]
    s = coll.ckpt_arrays(b, tr.S, None, False, int(state.step))
    o = np.argsort(s["keys"])
    nk = s["keys"].shape[0]
    return {k: v[o] for k, v in s.items()
            if getattr(v, "ndim", 0) >= 1 and v.shape[0] == nk}


@pytest.mark.slow
def test_two_process_host_sharded_matches_single_controller(tmp_path):
    """Round-5 host-resolved sharding BEYOND one controller: 2 processes x
    4 devices, per-process HostIndexResolvers owning the local shards,
    requester id buckets exchanged host-to-host one step ahead
    (parallel/host_exchange.py). Must equal the single-controller
    host-sharded run bit-for-bit on metrics and tables — and its
    multi-part checkpoint must restore into the DEVICE-index engine at a
    different shard count (the cross-engine interchange contract)."""
    from deeprec_tpu.utils.native import get_lib
    if get_lib() is None:
        pytest.skip("native toolchain unavailable")
    ckpt, outs, logs = _spawn_cluster(tmp_path, nproc=2, dev_per=4,
                                      host_index=True)

    # baseline: single-controller 8-device HOST-sharded run, same stream
    from deeprec_tpu.parallel.trainer import ShardedTrainer, make_mesh
    from deeprec_tpu.train import metrics as M
    tr_b = ShardedTrainer(mesh=make_mesh(8), **make_common(host_index=True))
    st_b = tr_b.init(jax.random.key(0), global_batch(0))
    for i in range(STEPS):
        st_b = tr_b.train_step(st_b, global_batch(i))
    m_b = M.summarize(st_b.metrics)

    for o in outs:
        assert o["step"] == STEPS
        assert o["count"] == STEPS * GLOBAL_BATCH
        assert abs(o["loss"] - m_b["loss"]) < 1e-5, (o["loss"], m_b["loss"])
        assert abs(o["auc"] - m_b["auc"]) < 1e-4
        assert o["health"]["dropped"] == 0

    # table equality: per-key values/freqs/versions/slot rows
    sb = _snap_host_sharded(tr_b, st_b)
    from deeprec_tpu.checkpoint import format as F
    base, _ = F.restore_plan(ckpt)
    mp_tab = F.read_table(base["path"], "emb")
    o = np.argsort(mp_tab["keys"])
    np.testing.assert_array_equal(sb["keys"], mp_tab["keys"][o])
    np.testing.assert_allclose(sb["values"], mp_tab["values"][o],
                               atol=1e-6, rtol=1e-5)
    np.testing.assert_array_equal(sb["freqs"], mp_tab["freqs"][o])
    np.testing.assert_array_equal(sb["versions"], mp_tab["versions"][o])
    for k in sb:
        if k.startswith("slot__"):
            np.testing.assert_allclose(sb[k], mp_tab[k][o],
                                       atol=1e-6, rtol=1e-5)

    # cross-engine + cross-shard-count restore: 2-process host-sharded
    # checkpoint -> single-process 4-shard DEVICE-index trainer
    from deeprec_tpu.checkpoint import CheckpointManager
    tr_r = ShardedTrainer(mesh=make_mesh(4), **make_common())
    st_r = tr_r.init(jax.random.key(0), global_batch(0))
    st_r, ok = CheckpointManager(ckpt).restore(tr_r, st_r)
    assert ok
    assert int(st_r.step) == STEPS
    sr = _snap(tr_r, st_r)
    np.testing.assert_array_equal(sb["keys"], sr["keys"])
    np.testing.assert_allclose(sb["values"], sr["values"], atol=1e-6)
    np.testing.assert_array_equal(sb["freqs"], sr["freqs"])
    st_r = tr_r.train_step(st_r, global_batch(STEPS))
    assert np.isfinite(float(st_r.metrics.loss_sum))
