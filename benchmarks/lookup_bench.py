"""Embedding-lookup microbenchmark (the modelzoo/features/pmem
benchmark.py analog): measures lookup-or-create and pure-gather
throughput of one table shard on the local chip, against the HBM
roofline.

Prints one JSON line per phase. Run on the GPU:
    python benchmarks/lookup_bench.py --batch 131072 --dim 16
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__), "..")))


def main():
    from deeprec_tpu.utils import compile_cache
    compile_cache.enable()
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=131072, help="flat ids/step")
    ap.add_argument("--dim", type=int, default=16)
    ap.add_argument("--capacity", type=int, default=1 << 21)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--zipf", type=float, default=1.2)
    ap.add_argument("--dtype", default="float32",
                    help="table value_dtype (e.g. bfloat16) — measures the "
                         "bf16-storage gather/scatter cost at this dim")
    args = ap.parse_args()

    import numpy as np
    import jax
    import jax.numpy as jnp

    import deeprec_tpu as dr
    from deeprec_tpu.sparse import embedding_var as ev
    from deeprec_tpu.sparse import keys as K

    rng = np.random.default_rng(0)
    cfg = dr.EmbeddingVariableConfig(
        name="bench", embedding_dim=args.dim, capacity=args.capacity,
        max_unique=args.batch // 4, value_dtype=args.dtype)
    st = ev.create(cfg)

    batches = [K.from_numpy((rng.zipf(args.zipf, size=args.batch)
                             % (args.capacity // 2)).astype(np.int64))
               for _ in range(args.steps)]

    step_fn = jax.jit(lambda s, i: ev.lookup_or_create(s, cfg, i, jnp.int32(0)))
    st, aux = step_fn(st, batches[0])
    float(aux.slots.sum())
    t0 = time.perf_counter()
    for b in batches[1:]:
        st, aux = step_fn(st, b)
    float(aux.slots.sum())
    dt = (time.perf_counter() - t0) / (args.steps - 1)
    print(json.dumps({
        "metric": "lookup_or_create_ids_per_sec", "value": round(args.batch / dt),
        "unit": "ids/s", "ms_per_step": round(dt * 1e3, 2)}))

    # the host-index resolver on the SAME id stream (the round-4 fast
    # path's host half: find-or-insert + in-batch dedup + inverse build,
    # single host core) — comparable row to the device number above
    from deeprec_tpu.utils.native import HostIndexResolver, get_lib
    if get_lib() is not None:
        r = HostIndexResolver(n_groups=16)
        u_out = args.batch // 4 + 1
        raw = [(rng.zipf(args.zipf, size=args.batch)
                % (args.capacity // 2)).astype(np.int64)
               for _ in range(args.steps)]
        r.resolve(raw[0], u_out, args.capacity, args.capacity)
        t0 = time.perf_counter()
        for b in raw[1:]:
            r.resolve(b, u_out, args.capacity, args.capacity)
        dt = (time.perf_counter() - t0) / (args.steps - 1)
        print(json.dumps({
            "metric": "host_index_resolve_ids_per_sec",
            "value": round(args.batch / dt),
            "unit": "ids/s", "ms_per_step": round(dt * 1e3, 2)}))

    # pure gather bandwidth over the unique slots
    u = args.batch // 4 + 1
    # without-replacement draw: the scatter below asserts unique_indices
    slots = jnp.asarray(rng.permutation(args.capacity)[:u], jnp.int32)
    g = jax.jit(lambda v, s: v[s].sum())
    float(g(st.values, slots))
    t0 = time.perf_counter()
    for _ in range(20):
        r = g(st.values, slots)
    float(r)
    dt = (time.perf_counter() - t0) / 20
    row_bytes = args.dim * jnp.dtype(st.values.dtype).itemsize
    gbs = u * row_bytes / dt / 1e9
    print(json.dumps({
        "metric": "row_gather_bandwidth", "value": round(gbs, 2), "unit": "GB/s",
        "rows_per_sec": round(u / dt), "dtype": str(st.values.dtype),
        "row_bytes": int(row_bytes),
        "note": "random small-row reads"}))

    # row scatter (the optimizer write-back path) over the same slots:
    # K scatters inside ONE jit call (lax.fori_loop, slots rotated per
    # iteration so the loop is neither collapsible nor cache-friendly
    # beyond the real access pattern), fenced by a D2H scalar read;
    # per-scatter time is the (T(4K)-T(K))/3K difference so dispatch
    # cost cancels.
    upd = jnp.ones((u, args.dim), st.values.dtype)
    cap = jnp.int32(args.capacity)

    def scat_loop(v, s, x, k):
        def body(i, vv):
            ss = (s + i * jnp.int32(7919)) % cap
            return vv.at[ss].set(x, unique_indices=True)
        return jax.lax.fori_loop(0, k, body, v)

    sc = jax.jit(scat_loop, static_argnums=3, donate_argnums=0)

    def timed(vals, k, reps=3):
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            vals = sc(vals, slots, upd, k)
            float(vals[0, 0].astype(jnp.float32))   # D2H fence
            best = min(best, time.perf_counter() - t0)
        return vals, best

    K = 200
    vals, _ = timed(st.values, K, reps=1)           # compile both variants
    vals, _ = timed(vals, 4 * K, reps=1)
    vals, t1 = timed(vals, K)
    vals, t4 = timed(vals, 4 * K)
    dt = max((t4 - t1) / (3 * K), 1e-9)
    print(json.dumps({
        "metric": "row_scatter_bandwidth",
        "value": round(u * row_bytes / dt / 1e9, 2), "unit": "GB/s",
        "rows_per_sec": round(u / dt), "dtype": str(st.values.dtype),
        "note": "in-jit fori_loop difference timing; random unique rows"}))


if __name__ == "__main__":
    main()
