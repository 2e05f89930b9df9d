"""Hash table engine tests — the analog of the reference's KV-backend
coverage in embedding_variable_ops_test.cc (insert/lookup/snapshot)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from deeprec_tpu.sparse import hashtable as ht
from deeprec_tpu.sparse import keys as K
from deeprec_tpu.ops.unique import unique


def _keys(arr):
    return K.from_numpy(np.asarray(arr, dtype=np.int64))


class TestKeys:
    def test_roundtrip_64bit(self):
        ids = np.array([0, 1, -2, 2**40 + 7, -(2**35), 2**62], dtype=np.int64)
        k = _keys(ids)
        np.testing.assert_array_equal(K.to_numpy(k), ids)

    def test_empty_sentinel_is_minus_one(self):
        k = K.empty_like((3,))
        np.testing.assert_array_equal(K.to_numpy(k), np.full(3, -1, np.int64))
        assert bool(K.is_empty(k).all())

    def test_mod_matches_int64(self):
        ids = np.array([0, 5, 2**40 + 7, 2**33, 123456789012345], dtype=np.int64)
        for n in (7, 16, 1000):
            got = np.asarray(K.mod(_keys(ids), n))
            np.testing.assert_array_equal(got, ids % n)

    def test_hash_spreads(self):
        ids = np.arange(10000, dtype=np.int64)
        h = np.asarray(K.hash32(_keys(ids)))
        # nearly all buckets of a 1024-bucket table should be hit
        buckets = np.unique(h & 1023)
        assert len(buckets) >= 1015


class TestUnique:
    def test_basic(self):
        ids = _keys([5, 3, 5, 5, 9, 3, -1, 7])
        res = unique(ids)
        assert int(res.n_unique) == 4
        uk = K.to_numpy(res.ukeys)
        inv = np.asarray(res.inverse)
        orig = K.to_numpy(ids)
        np.testing.assert_array_equal(uk[inv], orig)
        counts = np.asarray(res.counts)
        # counts of the groups containing 5 and 3
        got = {int(uk[i]): int(counts[i]) for i in range(len(uk)) if uk[i] != -1 and counts[i] > 0}
        assert got == {5: 3, 3: 2, 9: 1, 7: 1}

    def test_all_same(self):
        res = unique(_keys([4] * 16))
        assert int(res.n_unique) == 1

    def test_64bit_keys_distinct(self):
        # same lo plane, different hi plane must stay distinct
        a, b = 7, 7 + (1 << 32)
        res = unique(_keys([a, b, a, b]))
        assert int(res.n_unique) == 2


class TestHashTable:
    def test_insert_then_lookup(self):
        t = ht.create(256)
        ids = _keys([10, 20, 30, 40, 10])
        u = unique(ids)
        t, slots, created = ht.lookup_or_insert(t, u.ukeys)
        assert int(t.size.sum()) == 4
        assert int(t.overflow.sum()) == 0
        slots2, found = ht.lookup(t, u.ukeys)
        valid = ~np.asarray(K.is_empty(u.ukeys))
        np.testing.assert_array_equal(np.asarray(found), valid)
        np.testing.assert_array_equal(np.asarray(slots2)[valid], np.asarray(slots)[valid])

    def test_lookup_missing(self):
        t = ht.create(64)
        slots, found = ht.lookup(t, _keys([1, 2, 3]))
        assert not np.asarray(found).any()
        np.testing.assert_array_equal(np.asarray(slots), [64, 64, 64])

    def test_idempotent_insert(self):
        t = ht.create(128)
        u = unique(_keys(np.arange(50)))
        t, slots1, created1 = ht.lookup_or_insert(t, u.ukeys)
        t, slots2, created2 = ht.lookup_or_insert(t, u.ukeys)
        np.testing.assert_array_equal(np.asarray(slots1), np.asarray(slots2))
        assert np.asarray(created2).sum() == 0
        assert int(t.size.sum()) == 50

    def test_high_load_factor(self):
        cap = 1024
        n = int(cap * 0.75)
        t = ht.create(cap)
        rng = np.random.default_rng(1)
        ids = rng.choice(2**60, size=n, replace=False).astype(np.int64)
        u = unique(_keys(ids))
        t, slots, created = ht.lookup_or_insert(t, u.ukeys)
        assert int(t.overflow.sum()) == 0, "0.75 load factor should fit within probe bound"
        assert int(t.size.sum()) == n
        # every id is retrievable and maps to its own slot
        slots2, found = ht.lookup(t, _keys(ids))
        assert np.asarray(found).all()
        assert len(np.unique(np.asarray(slots2))) == n

    def test_overflow_reported_when_full(self):
        cap = 64
        t = ht.create(cap)
        ids = np.arange(cap + 32, dtype=np.int64)
        u = unique(_keys(ids))
        t, slots, created = ht.lookup_or_insert(t, u.ukeys)
        assert int(t.size.sum()) <= cap
        assert int(t.overflow.sum()) >= 32 - (cap - int(t.size.sum()))

    def test_incremental_batches(self):
        t = ht.create(2048)
        rng = np.random.default_rng(2)
        store = {}
        for step in range(5):
            ids = rng.integers(0, 5000, size=256).astype(np.int64)
            u = unique(_keys(ids))
            t, slots, created = ht.lookup_or_insert(t, u.ukeys)
            uk = K.to_numpy(u.ukeys)
            s = np.asarray(slots)
            for i in range(len(uk)):
                if uk[i] == -1:
                    continue
                if uk[i] in store:
                    assert store[uk[i]] == s[i], f"slot moved for key {uk[i]}"
                else:
                    store[uk[i]] = s[i]
        assert int(t.size.sum()) == len(store)

    def test_rebuild_keep_subset(self):
        t = ht.create(256)
        ids = np.arange(100, dtype=np.int64)
        u = unique(_keys(ids))
        t, slots, _ = ht.lookup_or_insert(t, u.ukeys)
        # keep even ids only
        keep = np.zeros(256, bool)
        uk = K.to_numpy(u.ukeys)
        s = np.asarray(slots)
        for i in range(len(uk)):
            if uk[i] >= 0 and uk[i] % 2 == 0:
                keep[s[i]] = True
        t2, old_to_new = ht.rebuild(t, jnp.asarray(keep))
        assert int(t2.size.sum()) == 50
        slots_even, found_even = ht.lookup(t2, _keys(np.arange(0, 100, 2)))
        assert np.asarray(found_even).all()
        _, found_odd = ht.lookup(t2, _keys(np.arange(1, 100, 2)))
        assert not np.asarray(found_odd).any()

    def test_rebuild_grow(self):
        t = ht.create(128)
        ids = np.arange(80, dtype=np.int64)
        u = unique(_keys(ids))
        t, slots, _ = ht.lookup_or_insert(t, u.ukeys)
        t2, old_to_new = ht.rebuild(t, jnp.ones(128, bool), new_capacity=512)
        assert t2.capacity == 512
        assert int(t2.size.sum()) == 80
        _, found = ht.lookup(t2, _keys(ids))
        assert np.asarray(found).all()
        # permutation maps every live old slot to a valid new slot
        o2n = np.asarray(old_to_new)
        live = np.asarray(ht.occupied_mask(t))
        assert (o2n[live] < 512).all()

    def test_jit_composability(self):
        @jax.jit
        def step(t, hi, lo):
            u = unique(K.Keys(hi, lo))
            return ht.lookup_or_insert(t, u.ukeys)

        t = ht.create(256)
        k = _keys([3, 1, 4, 1, 5])
        t, slots, created = step(t, k.hi, k.lo)
        assert int(t.size.sum()) == 4
