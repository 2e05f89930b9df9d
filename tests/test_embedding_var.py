"""EmbeddingVariable semantics tests — analog of the reference suite
tensorflow/python/ops/embedding_variable_ops_test.py (lookup, filters,
eviction, save/restore, per-optimizer end-to-end)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import deeprec_tpu as dr
from deeprec_tpu.sparse import embedding_var as ev
from deeprec_tpu.sparse import keys as K
from deeprec_tpu.optim import sparse as sopt


def _cfg(**kw):
    base = dict(name="t", embedding_dim=8, capacity=1 << 10,
                initializer=dr.Initializer(kind="normal", scale=0.1))
    base.update(kw)
    return dr.EmbeddingVariableConfig(**base)


def _ids(arr):
    return K.from_numpy(np.asarray(arr, np.int64))


class TestLookup:
    def test_create_and_deterministic_init(self):
        cfg = _cfg()
        st = ev.create(cfg)
        st, aux = ev.lookup_or_create(st, cfg, _ids([7, 9, 7, 11]), 0)
        e1 = np.asarray(ev.lookup_dense(st, cfg, aux, (4,)))
        assert e1.shape == (4, 8)
        np.testing.assert_array_equal(e1[0], e1[2])  # same id, same row
        assert not np.allclose(e1[0], e1[1])
        # a fresh table initialises the same ids to the same vectors
        st2 = ev.create(cfg)
        st2, aux2 = ev.lookup_or_create(st2, cfg, _ids([7, 9, 7, 11]), 5)
        e2 = np.asarray(ev.lookup_dense(st2, cfg, aux2, (4,)))
        np.testing.assert_allclose(e1, e2, rtol=1e-6)

    def test_constant_initializer(self):
        cfg = _cfg(initializer=dr.Initializer(kind="constant", constant=2.5))
        st = ev.create(cfg)
        st, aux = ev.lookup_or_create(st, cfg, _ids([1, 2, 3]), 0)
        e = np.asarray(ev.lookup_dense(st, cfg, aux, (3,)))
        np.testing.assert_allclose(e, 2.5)

    def test_freq_and_version_metadata(self):
        # explicit opt-in: a filter-less, evict-less table defaults to the
        # light layout (no metadata writes, kv_variable_ops.py:282-285)
        cfg = _cfg(track_freq=True, track_version=True)
        st = ev.create(cfg)
        st, aux = ev.lookup_or_create(st, cfg, _ids([5, 5, 5, 9]), 3)
        uk = K.to_numpy(aux.uniq.ukeys)
        slots = np.asarray(aux.slots)
        freqs = np.asarray(st.freqs)
        versions = np.asarray(st.versions)
        i5 = int(np.where(uk == 5)[0][0])
        i9 = int(np.where(uk == 9)[0][0])
        # freq counts occurrences (within-batch multiplicity — reference
        # AddFreq(count), embedding_filter.h:307-317)
        assert freqs[slots[i5]] == 3
        assert freqs[slots[i9]] == 1
        assert versions[slots[i5]] == 3
        # second batch accumulates
        st, aux = ev.lookup_or_create(st, cfg, _ids([5]), 7)
        assert np.asarray(st.freqs)[slots[i5]] == 4
        assert np.asarray(st.versions)[slots[i5]] == 7

    def test_light_layout_skips_metadata(self):
        # no filter + no evict -> the reference's "light" ValuePtr layout
        # (kv_variable_ops.py:282-285): no freq/version/create_step writes,
        # but insertion and lookup semantics are unchanged
        cfg = _cfg()
        assert not cfg.freq_tracked and not cfg.version_tracked
        st = ev.create(cfg)
        st, aux = ev.lookup_or_create(st, cfg, _ids([5, 5, 9]), 3)
        assert np.asarray(st.freqs).sum() == 0
        assert (np.asarray(st.versions) == -1).all()
        assert (np.asarray(st.create_steps) == -1).all()
        assert int(st.index.size.sum()) == 2

    def test_null_row_stays_zero(self):
        cfg = _cfg()
        st = ev.create(cfg)
        pad = K.empty_like((4,))
        st, aux = ev.lookup_or_create(st, cfg, pad, 0)
        e = np.asarray(ev.lookup_dense(st, cfg, aux, (4,)))
        np.testing.assert_array_equal(e, 0.0)
        assert int(st.index.size.sum()) == 0

    def test_pooled_lookup_combiners(self):
        cfg = _cfg(initializer=dr.Initializer(kind="constant", constant=1.0))
        st = ev.create(cfg)
        # 2 samples: sample0 has ids [1,2,3], sample1 has [4] + padding
        flat = _ids([1, 2, 3, 4, -1, -1])
        sample_ids = jnp.asarray([0, 0, 0, 1, 1, 1])
        st, aux = ev.lookup_or_create(st, cfg, flat, 0)
        mean = np.asarray(ev.pooled_lookup(st.values, aux, cfg, sample_ids, 2, combiner="mean"))
        # NOTE mean divides by count incl. padded rows? padding contributes
        # zero rows but also denominators — verify sum first
        s = np.asarray(ev.pooled_lookup(st.values, aux, cfg, sample_ids, 2, combiner="sum"))
        np.testing.assert_allclose(s[0], 3.0)
        np.testing.assert_allclose(s[1], 1.0)


class TestFilters:
    def test_counter_filter_blocks_until_threshold(self):
        cfg = _cfg(counter_filter=dr.CounterFilter(filter_freq=3))
        st = ev.create(cfg)
        st, aux = ev.lookup_or_create(st, cfg, _ids([42]), 0)
        assert not bool(np.asarray(aux.admitted)[0])
        st, aux = ev.lookup_or_create(st, cfg, _ids([42]), 1)
        assert not bool(np.asarray(aux.admitted)[0])
        st, aux = ev.lookup_or_create(st, cfg, _ids([42]), 2)
        assert bool(np.asarray(aux.admitted)[0])  # freq now 3

    def test_counter_filter_counts_multiplicity(self):
        # within-batch multiplicity counts (reference AddFreq(count) via
        # unique_with_counts) — identical on local/sharded trainers
        cfg = _cfg(counter_filter=dr.CounterFilter(filter_freq=3))
        st = ev.create(cfg)
        st, aux = ev.lookup_or_create(st, cfg, _ids([42, 42]), 0)
        assert not bool(np.asarray(aux.admitted)[0])  # freq 2 < 3
        st, aux = ev.lookup_or_create(st, cfg, _ids([42]), 1)
        assert bool(np.asarray(aux.admitted)[0])      # freq 3
        # a single batch with multiplicity >= threshold admits immediately
        st2 = ev.create(cfg)
        st2, aux2 = ev.lookup_or_create(st2, cfg, _ids([7, 7, 7]), 0)
        assert bool(np.asarray(aux2.admitted)[0])

    def test_cbf_filter_saves_slots(self):
        cfg = _cfg(cbf_filter=dr.CBFFilter(filter_freq=3, max_element_size=1000))
        st = ev.create(cfg)
        st, aux = ev.lookup_or_create(st, cfg, _ids([1, 2, 3]), 0)
        assert int(st.index.size.sum()) == 0  # nothing admitted -> no slots burned
        assert not np.asarray(aux.admitted).any()
        st, aux = ev.lookup_or_create(st, cfg, _ids([1, 2, 3]), 1)
        assert int(st.index.size.sum()) == 0
        st, aux = ev.lookup_or_create(st, cfg, _ids([1, 2, 3]), 2)
        assert int(st.index.size.sum()) == 3  # third sighting crosses freq=3
        assert np.asarray(aux.admitted).all()

    def test_cbf_counts_multiplicity(self):
        cfg = _cfg(cbf_filter=dr.CBFFilter(filter_freq=2, max_element_size=1000))
        st = ev.create(cfg)
        st, aux = ev.lookup_or_create(st, cfg, _ids([9, 9]), 0)
        assert int(st.index.size.sum()) == 1  # 2 sightings in one batch admit
        st2 = ev.create(cfg)
        st2, _ = ev.lookup_or_create(st2, cfg, _ids([9]), 0)
        assert int(st2.index.size.sum()) == 0  # single sighting does not


class TestEviction:
    def test_global_step_ttl(self):
        cfg = _cfg(evict=dr.GlobalStepEvict(steps_to_live=10))
        st = ev.create(cfg)
        st, _ = ev.lookup_or_create(st, cfg, _ids([1, 2]), 0)
        st, _ = ev.lookup_or_create(st, cfg, _ids([2, 3]), 8)
        st2, perm = ev.shrink(st, cfg, 12)
        # versions: 1->0 (evict: 12-0>=10), 2->8 keep, 3->8 keep
        assert int(st2.index.size.sum()) == 2
        from deeprec_tpu.sparse import hashtable as ht
        _, found = ht.lookup(st2.index, _ids([2, 3]))
        assert np.asarray(found).all()
        _, found1 = ht.lookup(st2.index, _ids([1]))
        assert not np.asarray(found1).any()

    def test_l2_evict(self):
        cfg = _cfg(evict=dr.L2WeightEvict(l2_weight_threshold=0.5),
                   initializer=dr.Initializer(kind="constant", constant=0.0))
        st = ev.create(cfg)
        st, aux = ev.lookup_or_create(st, cfg, _ids([1, 2]), 0)
        # give id 1 a large row
        slots = np.asarray(aux.slots)
        uk = K.to_numpy(aux.uniq.ukeys)
        s1 = int(slots[np.where(uk == 1)[0][0]])
        st = st._replace(values=st.values.at[s1].set(1.0))
        st2, perm = ev.shrink(st, cfg, 1)
        assert int(st2.index.size.sum()) == 1

    def test_shrink_permutes_values(self):
        # raw lookup -> shrink -> lookup without an update: eager rows
        cfg = _cfg(evict=dr.GlobalStepEvict(steps_to_live=100), lazy_init=False,
                   initializer=dr.Initializer(kind="normal", scale=1.0))
        st = ev.create(cfg)
        st, aux = ev.lookup_or_create(st, cfg, _ids(np.arange(50)), 0)
        before = np.asarray(ev.lookup_dense(st, cfg, aux, (50,)))
        st2, perm = ev.shrink(st, cfg, 1)
        assert int(st2.index.size.sum()) == 50
        st2, aux2 = ev.lookup_or_create(st2, cfg, _ids(np.arange(50)), 1)
        after = np.asarray(ev.lookup_dense(st2, cfg, aux2, (50,)))
        np.testing.assert_allclose(before, after, rtol=1e-6)

    def test_grow_preserves_rows(self):
        # raw lookup -> grow -> lookup without an update: eager rows
        cfg = _cfg(capacity=256, lazy_init=False)
        st = ev.create(cfg)
        st, aux = ev.lookup_or_create(st, cfg, _ids(np.arange(100)), 0)
        before = np.asarray(ev.lookup_dense(st, cfg, aux, (100,)))
        st2, perm = ev.grow(st, cfg, 1024)
        assert st2.capacity == 1024
        cfg2 = _cfg(capacity=1024, lazy_init=False)
        st2, aux2 = ev.lookup_or_create(st2, cfg2, _ids(np.arange(100)), 1)
        after = np.asarray(ev.lookup_dense(st2, cfg2, aux2, (100,)))
        np.testing.assert_allclose(before, after, rtol=1e-6)
        assert int(st2.index.size.sum()) == 100


class TestSnapshot:
    def test_export_import_roundtrip(self):
        # raw lookup -> export without an optimizer update: needs eager
        # row materialisation (lazy_init defers it to the first update)
        cfg = _cfg(lazy_init=False)
        st = ev.create(cfg)
        ids = np.array([3, 1 << 40, 7, 2**55 + 9], np.int64)
        st, aux = ev.lookup_or_create(st, cfg, _ids(ids), 5)
        rows = np.asarray(ev.lookup_dense(st, cfg, aux, (4,)))
        snap = ev.export(st)
        live = np.asarray(snap.live)
        lk = K.Keys(jnp.asarray(np.asarray(snap.keys_hi)[live]),
                    jnp.asarray(np.asarray(snap.keys_lo)[live]))
        st2 = ev.import_snapshot(
            cfg, lk,
            jnp.asarray(np.asarray(snap.values)[live]),
            jnp.asarray(np.asarray(snap.versions)[live]),
            jnp.asarray(np.asarray(snap.freqs)[live]),
        )
        st2, aux2 = ev.lookup_or_create(st2, cfg, _ids(ids), 6)
        rows2 = np.asarray(ev.lookup_dense(st2, cfg, aux2, (4,)))
        np.testing.assert_allclose(rows, rows2, rtol=1e-6)
        # metadata carried over (freq was 1, +1 from the new lookup)
        assert int(st2.index.size.sum()) == 4


class TestTraining:
    """End-to-end: each sparse optimizer drives a toy regression loss down
    (reference testEmbeddingVariableForAdagrad/Adam/Ftrl/... pattern)."""

    @pytest.mark.parametrize("opt_name,kwargs", [
        ("sgd", dict(learning_rate=0.5)),
        ("adagrad", dict(learning_rate=0.5)),
        ("adagrad_decay", dict(learning_rate=0.5, accumulator_decay_step=5)),
        ("adam", dict(learning_rate=0.1)),
        ("adam_async", dict(learning_rate=0.1)),
        ("ftrl", dict(learning_rate=0.5)),
        ("momentum", dict(learning_rate=0.1)),
    ])
    def test_converges(self, opt_name, kwargs):
        cfg = _cfg(embedding_dim=4)
        opt = sopt.make(opt_name, **kwargs)
        st = ev.create(cfg)
        slot_state = opt.init(st.values)
        ids = _ids([10, 20, 30, 10])  # note duplicate id
        target = jnp.asarray(np.tile(np.array([[1., -1., .5, 0.]]), (4, 1)), jnp.float32)

        def loss_fn(urows, aux):
            e = urows[aux.uniq.inverse]
            return jnp.mean((e - target) ** 2)

        losses = []
        for step in range(60):
            st, aux = ev.lookup_or_create(st, cfg, ids, step)
            urows = ev.gather(st.values, aux, cfg)
            loss, g = jax.value_and_grad(loss_fn)(urows, aux)
            mask = aux.admitted
            new_values, slot_state = opt.apply(st.values, slot_state, aux.slots, g, mask, step)
            st = st._replace(values=new_values)
            losses.append(float(loss))
        assert losses[-1] < losses[0] * 0.1, f"{opt_name}: {losses[0]} -> {losses[-1]}"

    def test_filtered_rows_not_updated(self):
        cfg = _cfg(embedding_dim=4, counter_filter=dr.CounterFilter(filter_freq=100),
                   initializer=dr.Initializer(kind="constant", constant=1.0))
        opt = sopt.sparse_sgd(learning_rate=1.0)
        st = ev.create(cfg)
        slot_state = opt.init(st.values)
        ids = _ids([5])
        for step in range(3):
            st, aux = ev.lookup_or_create(st, cfg, ids, step)
            urows = ev.gather(st.values, aux, cfg)
            g = jnp.ones_like(urows)
            new_values, slot_state = opt.apply(st.values, slot_state, aux.slots, g, aux.admitted, step)
            st = st._replace(values=new_values)
        st, aux = ev.lookup_or_create(st, cfg, ids, 10)
        e = np.asarray(ev.lookup_dense(st, cfg, aux, (1,)))
        np.testing.assert_allclose(e, 1.0)  # frozen at init: filter blocked updates

    def test_dedup_gradient_sums(self):
        """Autodiff through gather+inverse sums duplicate-id grads (the
        IndexedSlices dedup semantics)."""
        cfg = _cfg(embedding_dim=2, initializer=dr.Initializer(kind="zeros"))
        st = ev.create(cfg)
        ids = _ids([7, 7, 7, 8])
        st, aux = ev.lookup_or_create(st, cfg, ids, 0)
        urows = ev.gather(st.values, aux, cfg)

        def loss_fn(urows):
            e = urows[aux.uniq.inverse]
            return jnp.sum(e)

        g = jax.grad(loss_fn)(urows)
        uk = K.to_numpy(aux.uniq.ukeys)
        g = np.asarray(g)
        i7 = int(np.where(uk == 7)[0][0])
        i8 = int(np.where(uk == 8)[0][0])
        np.testing.assert_allclose(g[i7], 3.0)
        np.testing.assert_allclose(g[i8], 1.0)


class TestLazyInit:
    def test_created_rows_serve_init_and_materialise_on_update(self):
        """Lazy init (default): gather returns the deterministic init for
        created rows while the store holds zeros; one optimizer update
        persists init+update in a single scatter."""
        cfg = _cfg()  # lazy_init=True default, no filters
        st = ev.create(cfg)
        ids = _ids([5, 9])
        st, aux = ev.lookup_or_create(st, cfg, ids, 0)
        served = np.asarray(ev.gather(st.values, aux, cfg)[:2])
        expect_init = np.asarray(ev.init_rows(cfg, aux.uniq.ukeys)[:2])
        np.testing.assert_allclose(served, expect_init, rtol=1e-6)
        # store itself still zeros
        np.testing.assert_allclose(
            np.asarray(st.values[np.asarray(aux.slots)[:2]]), 0.0)
        # one SGD step with zero grads persists exactly the init
        opt = sopt.sparse_sgd(1.0)
        slot = opt.init(st.values)
        values, _ = opt.apply(st.values, slot, aux.slots,
                              jnp.zeros((aux.slots.shape[0], cfg.embedding_dim)),
                              aux.admitted, 0,
                              cur_rows=ev.gather(st.values, aux, cfg))
        np.testing.assert_allclose(
            np.asarray(values[np.asarray(aux.slots)[:2]]), expect_init,
            rtol=1e-6)

    def test_lazy_matches_eager_training(self):
        """A trained table ends identical under lazy and eager init."""
        opt = sopt.sparse_adagrad(0.3)
        outs = []
        for lazy in (True, False):
            cfg = _cfg(lazy_init=lazy)
            st = ev.create(cfg)
            slot = opt.init(st.values)
            for step in range(3):
                ids = _ids([1, 2, 3, 4, step + 10])
                st, aux = ev.lookup_or_create(st, cfg, ids, step)
                urows = ev.gather(st.values, aux, cfg)
                g = jnp.ones_like(urows) * 0.1
                values, slot = opt.apply(st.values, slot, aux.slots, g,
                                         aux.admitted, step, cur_rows=urows)
                st = st._replace(values=values)
            snap = ev.export(st)
            live = np.asarray(snap.live)
            keys = ((np.asarray(snap.keys_hi)[live].astype(np.int64) << 32)
                    | np.asarray(snap.keys_lo)[live].astype(np.uint32).astype(np.int64))
            order = np.argsort(keys)
            outs.append((keys[order], np.asarray(snap.values)[live][order]))
        np.testing.assert_array_equal(outs[0][0], outs[1][0])
        np.testing.assert_allclose(outs[0][1], outs[1][1], rtol=1e-6)


class TestMultiDimLookup:
    def test_pooled_lookup_multi_dim(self):
        """Sessions x clicks pooling (embedding_lookup_sparse_multi_dim)."""
        cfg = _cfg(embedding_dim=4, initializer=dr.Initializer("constant", constant=1.0))
        st = ev.create(cfg)
        # B=2 users, 2 sessions, 3 clicks; -1 = padding
        ids = np.array([
            [[1, 2, -1], [3, -1, -1]],
            [[4, 5, 6], [-1, -1, -1]],
        ], np.int64)
        st, aux = ev.lookup_or_create(st, cfg, _ids(ids.reshape(-1)), 0)
        out = ev.pooled_lookup_multi_dim(
            st.values, aux, cfg, (2, 2, 3), combiners=("mean", "mean"))
        out = np.asarray(out)
        assert out.shape == (2, 4)
        # all rows are 1.0 (constant init): mean over valid = 1 at every
        # level; user 1 has one empty session which must not dilute
        np.testing.assert_allclose(out, 1.0, rtol=1e-6)
        # sum-sum counts every valid click
        out2 = np.asarray(ev.pooled_lookup_multi_dim(
            st.values, aux, cfg, (2, 2, 3), combiners=("sum", "sum")))
        np.testing.assert_allclose(out2[0], 3.0)  # 2 + 1 clicks
        np.testing.assert_allclose(out2[1], 3.0)  # 3 + 0 clicks
