"""Serving latency/throughput microbenchmark: Predictor.predict on one
device (the Triton-shim role). Prints one JSON line per batch size."""
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
    ap.add_argument("--batches", default="256,1024,4096")
    ap.add_argument("--capacity", type=int, default=1 << 18)
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--tiered", type=int, default=0, metavar="BUDGET",
                    help="also bench TieredPredictor with this device row "
                         "budget (host-DRAM cold tail, per-request staging)")
    ap.add_argument("--concurrency", type=int, default=0, metavar="K",
                    help="also bench K concurrent clients through "
                         "PredictService, serial-lock vs dynamic batching "
                         "(server.py --dynamic_batch_ms)")
    ap.add_argument("--conc_reps", type=int, default=12,
                    help="requests per concurrent client")
    args = ap.parse_args()

    import numpy as np
    import jax
    import optax

    import deeprec_tpu as dr
    from deeprec_tpu import feature_column as fc
    from deeprec_tpu.checkpoint import CheckpointManager
    from deeprec_tpu.data.criteo import CAT_NAMES, DENSE_NAMES, SyntheticCriteo
    from deeprec_tpu.models import ctr
    from deeprec_tpu.optim import sparse as sopt
    from deeprec_tpu.serving import Predictor
    from deeprec_tpu.train.trainer import Trainer

    def parts():
        numeric = [fc.NumericColumn(n, log_normalize=True) for n in DENSE_NAMES]
        cols = [fc.EmbeddingColumn(fc.CategoricalColumn(n), 16)
                for n in CAT_NAMES]
        coll = fc.EmbeddingCollection(
            cols, name="emb", capacity=args.capacity,
            initializer=dr.Initializer("normal", scale=0.05))
        model = ctr.DLRM(emb_names=[c.name for c in cols], emb_dim=16,
                         bottom_units=(512, 256), top_units=(1024, 512))
        return numeric, coll, model

    import tempfile
    ckdir = tempfile.mkdtemp(prefix="serving_bench_ckpt_")
    numeric, coll, model = parts()
    tr = Trainer(model, numeric, {"emb": coll},
                 {"emb": sopt.sparse_adagrad(0.05)}, optax.adagrad(0.05))
    gen = SyntheticCriteo(batch_size=2048, seed=7)
    state = tr.init(jax.random.key(0), next(gen))
    for b in gen.take(5):
        state = tr.train_step(state, b)
    CheckpointManager(ckdir).save(tr, state)

    n2, c2, m2 = parts()
    pred = Predictor(m2, n2, {"emb": c2}, ckdir)
    predictors = [("serving_latency_ms", pred)]
    if args.tiered:
        from deeprec_tpu.serving import TieredPredictor
        n3, c3, m3 = parts()
        predictors.append(("serving_tiered_latency_ms", TieredPredictor(
            m3, n3, {"emb": c3}, ckdir, device_row_budget=args.tiered)))
    for name, p_ in predictors:
        for bs in (int(x) for x in args.batches.split(",")):
            # cycle fresh batches so the tiered host-probe path does real
            # per-request work (datagen cost stays outside the timed loop)
            g = SyntheticCriteo(batch_size=bs, seed=9)
            pool = [next(g) for _ in range(8)]
            p = p_.predict(pool[0])  # compile
            t0 = time.perf_counter()
            for i in range(args.reps):
                p = p_.predict(pool[i % len(pool)])
            dt = (time.perf_counter() - t0) / args.reps
            print(json.dumps({
                "metric": name, "batch": bs,
                "value": round(dt * 1e3, 2), "unit": "ms",
                "throughput_per_sec": round(bs / dt)}))

    if args.concurrency:
        # K concurrent clients, small per-request batches: the dispatch
        # constant dominates (the latency table above), so coalescing K
        # requests into one device call approaches a Kx QPS win — the
        # Triton dynamic_batching effect server.py reproduces.
        import threading

        from deeprec_tpu.serving.server import PredictService

        K, R = args.concurrency, args.conc_reps
        bs = int(args.batches.split(",")[0])
        g = SyntheticCriteo(batch_size=bs, seed=11)
        pools = [[{k: v for k, v in next(g).items() if k != "label"}
                  for _ in range(4)] for _ in range(K)]
        for mode, ms in (("serial_lock", 0.0), ("dynamic_batch", 5.0)):
            svc = PredictService(pred, dynamic_batch_ms=ms, max_batch=1 << 14)
            barrier = threading.Barrier(K + 1)

            def client(i):
                barrier.wait()
                for r in range(R):
                    svc.predict({"inputs": pools[i][r % 4]})
            # warm: one concurrent volley compiles the coalesced shape
            ts = [threading.Thread(target=lambda: (barrier.wait(), svc.predict(
                {"inputs": pools[0][0]}))[1]) for _ in range(K)]
            for t in ts:
                t.start()
            barrier.wait()
            for t in ts:
                t.join()
            ts = [threading.Thread(target=client, args=(i,)) for i in range(K)]
            for t in ts:
                t.start()
            t0 = time.perf_counter()
            barrier.wait()
            for t in ts:
                t.join()
            dt = time.perf_counter() - t0
            out = {"metric": f"serving_concurrent_{mode}", "clients": K,
                   "batch": bs, "requests": K * R,
                   "value": round(K * R / dt, 1), "unit": "requests/s",
                   "examples_per_sec": round(K * R * bs / dt)}
            if svc.batcher is not None:
                out["device_batches"] = svc.batcher.batches
                svc.batcher.stop()
            print(json.dumps(out))


if __name__ == "__main__":
    main()
