"""Host-index TIERED storage: HBM + host DRAM/SSD on the host-index engine.

The fast host-index engine
covers tiered storage too. Demotion compacts the resolver + row stores at
fence points; PROMOTION rides the resolve wire — the host looks up
re-touched keys in the tier at resolve time and ships their payload with
the batch, so promotion costs zero extra device dispatches
(host_index.py _tier_promo / apply_promo).

The engine-equality contract mirrors tests/test_host_index.py: the same
stream + the same demote cadence on the DEVICE-engine TieredTrainer and
on the host-index tiered path must produce the SAME key -> (value row,
freq, version, optimizer slot) map and the same eval logits.
"""
import numpy as np
import optax
import pytest

import jax
import jax.numpy as jnp

import deeprec_tpu as dr
from deeprec_tpu.config import StorageOption, StorageType
from deeprec_tpu import feature_column as fc
from deeprec_tpu.host_index import HostIndexEmbeddingCollection
from deeprec_tpu.models import ctr
from deeprec_tpu.optim import sparse as sopt
from deeprec_tpu.train.tiered_trainer import TieredTrainer
from deeprec_tpu.train.trainer import Trainer
from deeprec_tpu.data.criteo import SyntheticCriteo
from deeprec_tpu.utils.native import get_lib

pytestmark = pytest.mark.skipif(get_lib() is None,
                                reason="native toolchain unavailable")

CATS = ["C1", "C2"]


def _cols():
    return [fc.EmbeddingColumn(fc.CategoricalColumn(n), 8) for n in CATS]


def make_host(steps_to_live=4, hbm_capacity=0, storage=StorageType.HBM_DRAM,
              ssd_path="", optimizer=None, counter_filter=None):
    kw = {}
    if counter_filter:
        kw["counter_filter"] = dr.CounterFilter(counter_filter)
    coll = HostIndexEmbeddingCollection(
        _cols(), name="emb", capacity=256,
        initializer=dr.Initializer("normal", scale=0.1),
        evict=(dr.GlobalStepEvict(steps_to_live=steps_to_live)
               if steps_to_live else None),
        storage=StorageOption(storage_type=storage,
                              hbm_capacity=hbm_capacity,
                              ssd_path=ssd_path,
                              dram_row_budget=8 if ssd_path else 0),
        **kw)
    model = ctr.DCN(emb_names=CATS, cross_layers=1, deep_units=(16,))
    return Trainer(
        model=model, numeric_columns=[fc.NumericColumn("I1")],
        collections={"emb": coll},
        sparse_optimizers={"emb": optimizer or sopt.sparse_adagrad(0.1)},
        dense_optimizer=optax.adagrad(0.05))


def make_device(steps_to_live=4, hbm_capacity=0, counter_filter=None):
    kw = {}
    if counter_filter:
        kw["counter_filter"] = dr.CounterFilter(counter_filter)
    coll = fc.EmbeddingCollection(
        _cols(), name="emb", capacity=256,
        initializer=dr.Initializer("normal", scale=0.1),
        evict=(dr.GlobalStepEvict(steps_to_live=steps_to_live)
               if steps_to_live else None),
        storage=StorageOption(storage_type=StorageType.HBM_DRAM,
                              hbm_capacity=hbm_capacity),
        **kw)
    model = ctr.DCN(emb_names=CATS, cross_layers=1, deep_units=(16,))
    return TieredTrainer(
        model=model, numeric_columns=[fc.NumericColumn("I1")],
        collections={"emb": coll},
        sparse_optimizers={"emb": sopt.sparse_adagrad(0.1)},
        dense_optimizer=optax.adagrad(0.05))


def batch_with(ids, bs=8, seed=0):
    rng = np.random.default_rng(seed)
    b = {"label": rng.integers(0, 2, bs).astype(np.float32),
         "I1": rng.normal(size=bs).astype(np.float32)}
    for n in CATS:
        b[n] = np.resize(np.asarray(ids, np.int64), bs)
    return b


def host_key_map(tr, state):
    """key -> (value row, freq, version, acc row) across BOTH tiers of the
    host-index engine."""
    coll = tr.collections["emb"]
    n = coll._resolver.size
    keys = coll._resolver.export_keys()
    vals = np.asarray(state.tables["emb"].ev.values)[:n]
    freqs = np.asarray(state.tables["emb"].ev.freqs)[:n]
    vers = np.asarray(state.tables["emb"].ev.versions)[:n]
    slot = state.tables["emb"].slot
    accs = (np.asarray(slot["acc"])[:n] if isinstance(slot, dict)
            else np.asarray(jax.tree_util.tree_leaves(slot)[0])[:n])
    out = {int(k): (vals[i], int(freqs[i]), int(vers[i]), accs[i])
           for i, k in enumerate(keys)}
    dim = coll.config.embedding_dim
    if coll.tier_store is not None and len(coll.tier_store):
        tk, rows = coll.tier_store.export()
        for k, row in zip(tk, rows):
            out[int(k)] = (row[:dim],
                           int(row[dim:dim + 1].view(np.int32)[0]),
                           int(row[dim + 1:dim + 2].view(np.int32)[0]),
                           row[dim + 3:dim + 3 + dim])
    return out


def device_key_map(tr, state):
    """Same map from the device-engine TieredTrainer (HBM + its tier)."""
    from deeprec_tpu.sparse import keys as K
    coll = tr.collections["emb"]
    st = state.tables["emb"].ev
    hi = np.asarray(st.index.key_hi)
    lo = np.asarray(st.index.key_lo)
    occ = ~((hi == -1) & (lo == -1))
    idx = np.nonzero(occ)[0]
    keys = (hi[idx].astype(np.int64) << 32) | lo[idx].astype(
        np.uint32).astype(np.int64)
    vals = np.asarray(st.values)[idx]
    freqs = np.asarray(st.freqs)[idx]
    vers = np.asarray(st.versions)[idx]
    slot = state.tables["emb"].slot
    accs = (np.asarray(slot["acc"])[idx] if isinstance(slot, dict)
            else np.asarray(jax.tree_util.tree_leaves(slot)[0])[idx])
    out = {int(k): (vals[i], int(freqs[i]), int(vers[i]), accs[i])
           for i, k in enumerate(keys)}
    dim = coll.config.embedding_dim
    kv = tr.tiers.get("emb")
    if kv is not None and len(kv):
        tk, rows = kv.export()
        for k, row in zip(tk, rows):
            out[int(k)] = (row[:dim],
                           int(row[dim:dim + 1].view(np.int32)[0]),
                           int(row[dim + 1:dim + 2].view(np.int32)[0]),
                           row[dim + 3:dim + 3 + dim])
    return out


def assert_maps_equal(a, b):
    assert set(a) == set(b), (len(a), len(b))
    for k in a:
        va, fa, ra, aa = a[k]
        vb, fb, rb, ab = b[k]
        np.testing.assert_array_equal(va, vb, err_msg=f"values key {k}")
        assert fa == fb, (k, fa, fb)
        assert ra == rb, (k, ra, rb)
        np.testing.assert_array_equal(aa, ab, err_msg=f"acc key {k}")


def test_demote_then_promote_roundtrip():
    """Rows demote to the host tier (resolver compacts), and a re-touch
    promotes them back with exact value + freq + version + slot rows —
    via the WIRE, no separate device dispatch."""
    tr = make_host(steps_to_live=3)
    coll = tr.collections["emb"]
    b0 = batch_with([1, 2, 3, 4])
    state = tr.init(jax.random.key(0), b0)
    state = tr.train_step(state, b0)
    before = host_key_map(tr, state)
    assert len(before) == 4 * len(CATS)

    # age the first group out: train other ids past steps_to_live.
    # At gs=5, cold = version <= 2: ids 1-4 (v0), 100 (v1), 101 (v2)
    # -> 6 ids x 2 columns = 12 demoted; 102/103 stay resident.
    for s in range(4):
        state = tr.train_step(state, batch_with([100 + s], seed=s))
    state = tr.maybe_demote(state)
    assert tr.host_tier_rows("emb") == 12
    assert coll._resolver.size == 4

    # demoted keys keep exact training state across the tiers
    after_demote = host_key_map(tr, state)
    for k, v in before.items():
        np.testing.assert_array_equal(v[0], after_demote[k][0])
        assert v[1] == after_demote[k][1]
        np.testing.assert_array_equal(v[3], after_demote[k][3])

    # re-touch: the resolve ships the payload; the step scatters it back
    # (ids 1-4 = 8 rows leave the tier; the aged 100/101 rows stay)
    state = tr.train_step(state, batch_with([1, 2, 3, 4], seed=9))
    assert tr.host_tier_rows("emb") == 4
    after = host_key_map(tr, state)
    for k, v in before.items():
        if k not in {int(x) for x in host_key_map(tr, state)}:
            continue
        a = after[k]
        # version re-stamped on TOP of the restored row; the adagrad acc
        # grew from its RESTORED value (restore-to-zero would show acc
        # falling back to the 0.1 init fill)
        assert a[2] > v[2], k
        assert np.all(a[3] >= v[3] - 1e-7), k


def test_engine_equality_with_device_tiered():
    """Same stream + same demote cadence: host-index tiered == device
    TieredTrainer on the full key->state map and on eval logits."""
    gen = SyntheticCriteo(batch_size=64, vocab_sizes=[64] * 26, seed=5,
                          active_features=range(2))
    batches = [{k: v for k, v in b.items()
                if k in ("label", "I1", "C1", "C2")}
               for b in gen.take(12)]
    th = make_host(steps_to_live=4)
    td = make_device(steps_to_live=4)
    sh = th.init(jax.random.key(0), batches[0])
    sd = td.init(jax.random.key(0), batches[0])
    for i, b in enumerate(batches):
        sh = th.train_step(sh, b)
        sd = td.train_step(sd, b)
        if i % 4 == 3:
            sh = th.maybe_demote(sh)
            sd = td.maybe_demote(sd)
    assert th.host_tier_rows("emb") > 0, "demotion never fired"
    assert_maps_equal(host_key_map(th, sh), device_key_map(td, sd))

    # eval: the host-index engine reads THROUGH the tier (readonly promo
    # patches the gathered rows without mutating) — the device engine's
    # eval falls back to init rows for demoted keys, so compare after one
    # step that promotes everything touched back into HBM on both
    eb = batches[0]
    sh = th.train_step(sh, eb)
    sd = td.train_step(sd, eb)
    from deeprec_tpu.train import metrics as M
    mh = th.eval_step(sh, M.create(), eb)
    md = td.eval_step(sd, M.create(), eb)
    np.testing.assert_allclose(float(mh.loss_sum), float(md.loss_sum),
                               rtol=1e-6)

    # and a readonly (eval) lookup of a still-demoted key returns its
    # SAVED row, not the init default — TieredPredictor read-through
    # semantics on the training-side eval path
    coll = th.collections["emb"]
    if th.host_tier_rows("emb"):
        tk, trows = coll.tier_store.export()
        probe = coll.pack_ids_eval(np.asarray([tk[0]], np.int64))
        aux, rows = coll.readonly_rows(sh.tables["emb"].ev, probe)
        lane = int(np.asarray(aux.ev_aux.uniq.inverse)[0])
        np.testing.assert_array_equal(
            np.asarray(rows)[lane],
            trows[0, :coll.config.embedding_dim])


def test_budget_demotion_hbm_capacity():
    """StorageOption.hbm_capacity forces the least-recently-touched rows
    out even with NO eviction policy (reference BatchCache LRU role)."""
    tr = make_host(steps_to_live=0, hbm_capacity=6)
    b0 = batch_with([1, 2, 3, 4])
    state = tr.init(jax.random.key(0), b0)
    state = tr.train_step(state, b0)
    state = tr.train_step(state, batch_with([10, 11, 12, 13], seed=1))
    state = tr.maybe_demote(state)
    coll = tr.collections["emb"]
    assert coll._resolver.size <= 6
    assert tr.host_tier_rows("emb") == 16 - coll._resolver.size


def test_tier_checkpoint_roundtrip(tmp_path):
    """Full + incremental saves span the tier (__tier__ tables via the
    saver's export_tiers/import_tier hooks); restore rebuilds resolver,
    device rows AND the tier; the restored trainer equals the live one."""
    from deeprec_tpu.checkpoint.saver import CheckpointManager
    tr = make_host(steps_to_live=3)
    b0 = batch_with([1, 2, 3, 4])
    state = tr.init(jax.random.key(0), b0)
    state = tr.train_step(state, b0)
    for s in range(4):
        state = tr.train_step(state, batch_with([100 + s], seed=s))
    state = tr.maybe_demote(state)
    assert tr.host_tier_rows("emb") > 0
    mgr = CheckpointManager(str(tmp_path / "c"))
    mgr.save(tr, state)

    # more training + another demote, then an incremental
    for s in range(3):
        state = tr.train_step(state, batch_with([200 + s], seed=10 + s))
    state = tr.maybe_demote(state)
    mgr.save_incremental(tr, state)
    live = host_key_map(tr, state)

    tr2 = make_host(steps_to_live=3)
    s2 = tr2.init(jax.random.key(1), b0)
    mgr2 = CheckpointManager(str(tmp_path / "c"))
    s2, ok = mgr2.restore(tr2, s2)
    assert ok
    assert_maps_equal(live, host_key_map(tr2, s2))

    # the restored trainer keeps training + promoting correctly
    s2 = tr2.train_step(s2, batch_with([100, 101], seed=99))
    state = tr.train_step(state, batch_with([100, 101], seed=99))
    assert_maps_equal(host_key_map(tr, state), host_key_map(tr2, s2))


def test_ssd_cascade_on_host_index(tmp_path):
    """HBM_DRAM_SSD: the DRAM tier spills its coldest rows to the
    file-backed store; lookups and promotion read through the cascade."""
    tr = make_host(steps_to_live=2, storage=StorageType.HBM_DRAM_SSD,
                   ssd_path=str(tmp_path / "tier.arena"))
    b0 = batch_with(list(range(1, 9)), bs=8)
    state = tr.init(jax.random.key(0), b0)
    state = tr.train_step(state, b0)
    for s in range(3):
        state = tr.train_step(state, batch_with([50 + s], seed=s))
    state = tr.maybe_demote(state)
    coll = tr.collections["emb"]
    demoted = tr.host_tier_rows("emb")
    assert demoted >= 16  # ids 1-8 (x2 cols) plus any aged 50-52 rows
    assert len(coll.tier_store.ssd) > 0, "DRAM budget never spilled"
    # promotion reads through DRAM -> SSD
    before = host_key_map(tr, state)
    state = tr.train_step(state, batch_with(list(range(1, 9)), bs=8,
                                            seed=7))
    assert tr.host_tier_rows("emb") == demoted - 16
    after = host_key_map(tr, state)
    for k in before:
        assert after[k][1] >= before[k][1]


def test_counter_filter_with_tier():
    """CounterFilter + tiered: admission freq survives demotion (payload
    carries freqs), so a returning key keeps its admitted status."""
    tr = make_host(steps_to_live=2, counter_filter=2)
    b0 = batch_with([1, 1, 2, 2], bs=8)   # each id x4 -> admitted
    state = tr.init(jax.random.key(0), b0)
    state = tr.train_step(state, b0)
    m0 = host_key_map(tr, state)
    for s in range(3):
        state = tr.train_step(state, batch_with([90 + s], seed=s))
    state = tr.maybe_demote(state)
    assert tr.host_tier_rows("emb") > 0
    state = tr.train_step(state, batch_with([1, 2], seed=5))
    m1 = host_key_map(tr, state)
    for k in m0:
        assert m1[k][1] >= m0[k][1]
