"""Shared modelzoo trainer CLI.

Rebuild of the reference modelzoo trainer skeleton (modelzoo/WDL/train.py:
argparse CLI -> input pipeline -> feature columns -> model -> session loop
with saver/summary/timeline hooks -> AUC/accuracy eval). One runner serves
every model; each ``modelzoo/<model>/train.py`` supplies a ``ModelSpec``.

Flag parity map (reference flag -> here):
  --batch_size/--steps            same
  --learning_rate / --optimizer   same (sparse side; dense follows)
  --bf16 (keep_weights scopes)    --bf16: bf16 compute dtype in towers
  --smartstage / tf.staged        --prefetch_depth / --prefetch_workers
  --micro_batch (AutoMicroBatch)  --micro_batch
  --protocol grpc/grpc++/star     --mesh N (collectives replace RPC)
  --save_steps + incremental      --save_secs / --incr_save_secs
  --ev / filters / eviction       --ev_filter_freq / --ev_evict_steps
  StorageOption(DRAM/PMEM/SSD)    --ev_storage hbm_dram[_ssd] +
  (modelzoo/features/pmem)          --ev_hbm_capacity / --ev_dram_budget
  --timeline                      --profile DIR (jax.profiler trace)
  WorkQueue                       --workqueue DIR over input files
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
from typing import Callable, Dict, Optional, Sequence


@dataclasses.dataclass
class ModelSpec:
    name: str
    model: object
    numeric_columns: Sequence
    collections: Dict
    sparse_optimizers: Dict          # name -> SparseOptimizer
    train_data: Callable[[argparse.Namespace], "iter"]
    eval_data: Callable[[argparse.Namespace], "iter"]
    forward: Optional[Callable] = None
    aux_loss_weight: float = 0.0


def base_parser(desc: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=desc)
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--batch_size", type=int, default=512)
    p.add_argument("--eval_steps", type=int, default=20)
    p.add_argument("--eval_every", type=int, default=0,
                   help="also eval the held-out stream every N train steps "
                        "(0 = only at the end) — the learning-curve view "
                        "the reference gets from MonitoredTrainingSession "
                        "eval hooks")
    p.add_argument("--learning_rate", type=float, default=0.05)
    p.add_argument("--optimizer", default="adagrad",
                   choices=["sgd", "adagrad", "adagrad_decay",
                            "adagrad_decay_v2", "adam", "adam_async",
                            "ftrl", "momentum", "proximal_gd",
                            "proximal_adagrad"])
    p.add_argument("--emb_dim", type=int, default=16)
    p.add_argument("--capacity", type=int, default=1 << 19,
                   help="per-shard dynamic-table capacity (pow2)")
    p.add_argument("--bf16", action="store_true",
                   help="bf16 compute in dense towers (keep_weights analog)")
    p.add_argument("--micro_batch", type=int, default=1,
                   help="AutoMicroBatch pipeline count")
    p.add_argument("--prefetch_depth", type=int, default=2)
    p.add_argument("--prefetch_workers", type=int, default=2)
    p.add_argument("--mesh", type=int, default=0,
                   help="devices for the sharded trainer (0 = single-chip)")
    p.add_argument("--checkpoint", default="",
                   help="checkpoint directory (restores latest if present)")
    p.add_argument("--save_secs", type=float, default=None)
    p.add_argument("--incr_save_secs", type=float, default=None)
    p.add_argument("--ev_filter_freq", type=int, default=0)
    p.add_argument("--ev_evict_steps", type=int, default=0)
    p.add_argument("--exchange_dtype", default=None,
                   choices=["float32", "bfloat16"],
                   help="wire dtype of the --mesh row/grad exchange "
                        "(bfloat16 halves interconnect bytes; values rounded on "
                        "the wire only, see config.exchange_dtype)")
    p.add_argument("--ev_storage", default="hbm",
                   choices=["hbm", "hbm_dram", "hbm_dram_ssd"],
                   help="multi-tier embedding storage (reference "
                        "StorageType; modelzoo/features/pmem analog)")
    p.add_argument("--ev_hbm_capacity", type=int, default=0,
                   help="device-resident row budget per table (0 = "
                        "unbounded); excess LRU rows demote to the host "
                        "tier at --demote_steps cadence")
    p.add_argument("--ev_dram_budget", type=int, default=0,
                   help="hbm_dram_ssd: host-DRAM row cap before the "
                        "coldest rows spill to disk")
    p.add_argument("--ev_ssd_path", default="",
                   help="backing file for the SSD tier")
    p.add_argument("--demote_steps", type=int, default=0,
                   help="steps between host-tier demotion sweeps "
                        "(0 = every ev_evict_steps/2, else every "
                        "10*log_steps)")
    p.add_argument("--host_index", action="store_true",
                   help="host-index fast path: the key->slot index lives "
                        "in the C++ HostIndexResolver, pipelined with the "
                        "device step (no on-device dedup/probe; ~1.5x "
                        "throughput, bit-exact), including tiered "
                        "--ev_storage configs (promotion rides the resolve "
                        "wire). With --mesh this is the host-SHARDED "
                        "engine (single-controller meshes: the host "
                        "resolves the whole exchange; no id all_to_all). "
                        "Falls back to the device engine for multi-process "
                        "/ mesh-tiered / mesh-microbatch configs")
    p.add_argument("--max_unique_ratio", type=float, default=0.25,
                   help="static dedup-width cap as a fraction of the flat "
                        "id width (0 = exact dedup; see ops/unique.py)")
    p.add_argument("--data_location", default="",
                   help="Criteo-format file; empty = synthetic stream")
    p.add_argument("--workqueue", default="",
                   help="WorkQueue dir for elastic file sharding")
    p.add_argument("--profile", default="",
                   help="jax.profiler trace dir (timeline analog)")
    p.add_argument("--summary_dir", default="",
                   help="JSONL summary/event dir (tf.summary analog)")
    p.add_argument("--log_steps", type=int, default=50)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--synthetic", action="store_true",
                   help="force the synthetic stream (default when no "
                        "--data_location)")
    p.add_argument("--synthetic_items", type=int, default=50_000,
                   help="item-vocab size of the synthetic behaviour stream")
    p.add_argument("--synthetic_users", type=int, default=10_000)
    return p


def ev_kwargs(args) -> dict:
    import deeprec_tpu as dr
    kw = {}
    if args.ev_filter_freq:
        kw["counter_filter"] = dr.CounterFilter(args.ev_filter_freq)
    if args.ev_evict_steps:
        kw["evict"] = dr.GlobalStepEvict(args.ev_evict_steps)
    if getattr(args, "exchange_dtype", None) not in (None, "float32"):
        kw["exchange_dtype"] = args.exchange_dtype
    if getattr(args, "incr_save_secs", None):
        # version-delta incrementals need version stamps even on tables
        # with no eviction policy (else the light layout skips them)
        kw["track_version"] = True
    if getattr(args, "ev_storage", "hbm") != "hbm":
        from ..config import StorageOption, StorageType
        kw["storage"] = StorageOption(
            storage_type=StorageType(args.ev_storage),
            hbm_capacity=args.ev_hbm_capacity,
            dram_row_budget=args.ev_dram_budget,
            ssd_path=args.ev_ssd_path)
    return kw


def collection_cls(args):
    """EmbeddingCollection class for this run: the host-index fast path
    when --host_index is set and the config supports it, else the
    all-on-device engine."""
    from .. import feature_column as fc
    if not getattr(args, "host_index", False):
        return fc.EmbeddingCollection
    reasons = []
    if getattr(args, "mesh", 0) and getattr(args, "ev_storage",
                                            "hbm") != "hbm":
        reasons.append(f"--mesh with --ev_storage {args.ev_storage}")
    if getattr(args, "mesh", 0) and getattr(args, "micro_batch", 1) > 1:
        reasons.append("--mesh with --micro_batch")
    if reasons:
        print(f"NOTE: --host_index unsupported with {', '.join(reasons)}; "
              "using the device-index engine")
        return fc.EmbeddingCollection
    if getattr(args, "mesh", 0):
        from ..parallel.host_sharded import HostShardedCollection
        return HostShardedCollection
    from ..host_index import HostIndexEmbeddingCollection
    return HostIndexEmbeddingCollection


def make_sparse_opt(args):
    from ..optim import sparse as sopt
    return sopt.make(args.optimizer, learning_rate=args.learning_rate)


def make_dense_opt(args):
    import optax
    table = {
        "sgd": lambda: optax.sgd(args.learning_rate),
        "momentum": lambda: optax.sgd(args.learning_rate, momentum=0.9),
        "adagrad": lambda: optax.adagrad(args.learning_rate),
        "adagrad_decay": lambda: optax.adagrad(args.learning_rate),
        "adam": lambda: optax.adam(args.learning_rate),
        "adam_async": lambda: optax.adam(args.learning_rate),
        "ftrl": lambda: optax.adagrad(args.learning_rate),
        "adagrad_decay_v2": lambda: optax.adagrad(args.learning_rate),
        "proximal_gd": lambda: optax.sgd(args.learning_rate),
        "proximal_adagrad": lambda: optax.adagrad(args.learning_rate),
    }
    return table[args.optimizer]()


def _check_health(tr, state, writer, last: dict) -> dict:
    """Alarm on (and where possible self-heal) the silent degradation
    modes: exchange-bucket drops -> widen buckets; dedup-cap saturation ->
    double max_unique; index overflow is handled by maybe_grow. The
    reference's analog is the WorkQueue water-level summary
    (work_queue.py add_summary) — production runs must see these, not
    discover them in a quality regression weeks later."""
    if not hasattr(tr, "table_health"):
        return last
    health = tr.table_health(state)
    for name, h in health.items():
        prev = last.get(name, {})
        if h["dropped"] > prev.get("dropped", 0):
            msg = (f"WARNING table {name}: {h['dropped']} unique ids "
                   f"dropped by exchange buckets (cumulative)")
            if hasattr(tr, "raise_bucket_slack"):
                slack = tr.raise_bucket_slack()
                msg += f" -> bucket_slack raised to {slack:.2f}"
            print(msg)
        if h.get("exchange_late_steps", 0) > prev.get(
                "exchange_late_steps", 0):
            print(f"WARNING table {name}: host bucket exchange missed the "
                  f"one-step-ahead deadline "
                  f"{h['exchange_late_steps']} step(s) cumulative — the "
                  "DCN link is not keeping up with the device step; "
                  "steps stay correct but no longer overlap")
        if (h["max_unique"]
                and h["unique_saturated_steps"] > prev.get(
                    "unique_saturated_steps", 0)):
            import dataclasses as _dc
            coll = tr.collections[name]
            new_mu = coll.config.max_unique * 2
            coll.config = _dc.replace(coll.config, max_unique=new_mu)
            tr.rejit()
            print(f"WARNING table {name}: dedup cap saturated "
                  f"{h['unique_saturated_steps']} step(s) "
                  f"(max n_unique {h['max_n_unique']}) "
                  f"-> max_unique raised to {new_mu}")
        if writer:
            writer.write(int(state.step), h, table=name, phase="health")
    return health


def _tiering(spec: ModelSpec):
    """(any table tiered, device-index tiering needed). Host-index
    collections tier THEMSELVES (resolve-wire promotion + fence-point
    compaction, host_index.py) — plain Trainer drives them; TieredTrainer
    is the device-index engine's tier manager."""
    from ..config import StorageType
    tiered = any(c.config.storage.storage_type is not StorageType.HBM
                 for c in spec.collections.values())
    device_tiered = tiered and not all(
        hasattr(c, "demote_cold") for c in spec.collections.values()
        if c.config.storage.storage_type is not StorageType.HBM)
    return tiered, device_tiered


def make_trainer(spec: ModelSpec, args):
    """The trainer ``run`` drives for these flags: finalizes the
    collections' static configs (dedup cap, fused optimizer slots) and
    picks the engine (single device, mesh, tiered)."""
    import dataclasses

    from ..parallel.trainer import ShardedTrainer, make_mesh
    from ..train.trainer import Trainer

    # static dedup-width cap: the whole sparse path runs at unique-width
    # (per-device width on a mesh) instead of flat width — a large
    # throughput lever on heavy-tailed id streams
    if args.max_unique_ratio > 0:
        shards = max(args.mesh, 1)
        for coll in spec.collections.values():
            if coll.config.max_unique is None:
                local_flat = coll.total_width * args.batch_size // shards
                mu = max(256, int(local_flat * args.max_unique_ratio))
                coll.config = dataclasses.replace(coll.config, max_unique=mu)

    # fused slot storage: when the sparse optimizer is plain adagrad, store
    # its accumulator inside the values rows (ValuePtr layout) — one
    # optimizer scatter instead of two
    if args.optimizer in ("adagrad", "adam"):
        from ..feature_column import EmbeddingCollection
        from ..optim.sparse import sparse_adagrad_fused, sparse_adam_fused
        for name, coll in spec.collections.items():
            if (type(coll) is EmbeddingCollection
                    and coll.config.fused_slot_columns == 0
                    and spec.sparse_optimizers[name].name == args.optimizer):
                dim = coll.config.embedding_dim
                if args.optimizer == "adagrad":
                    coll.config = dataclasses.replace(
                        coll.config, fused_slot_columns=dim,
                        fused_slot_init=0.1)
                    spec.sparse_optimizers[name] = sparse_adagrad_fused(
                        args.learning_rate, initial_accumulator_value=0.1)
                else:  # adam: m and v ride in the values rows
                    coll.config = dataclasses.replace(
                        coll.config, fused_slot_columns=2 * dim,
                        fused_slot_init=0.0)
                    spec.sparse_optimizers[name] = sparse_adam_fused(
                        args.learning_rate)

    common = dict(
        model=spec.model, numeric_columns=spec.numeric_columns,
        collections=spec.collections,
        sparse_optimizers=spec.sparse_optimizers,
        dense_optimizer=make_dense_opt(args), forward=spec.forward,
        aux_loss_weight=spec.aux_loss_weight,
    )
    tiered, device_tiered = _tiering(spec)
    if args.mesh:
        if tiered:
            from ..parallel.tiered import TieredShardedTrainer
            return TieredShardedTrainer(mesh=make_mesh(args.mesh),
                                        microbatches=args.micro_batch,
                                        **common)
        return ShardedTrainer(mesh=make_mesh(args.mesh),
                              microbatches=args.micro_batch, **common)
    if device_tiered:
        from .tiered_trainer import TieredTrainer
        return TieredTrainer(microbatches=args.micro_batch, **common)
    return Trainer(microbatches=args.micro_batch, **common)


def run(spec: ModelSpec, args) -> dict:
    """Train/eval loop shared by every modelzoo trainer. Returns (and
    prints, as the reference trainers do) the summary metrics."""
    import jax

    from ..utils import compile_cache
    # restarted runs skip every compile; growth prewarm warms this cache
    compile_cache.enable()

    from ..checkpoint import CheckpointManager
    from ..data.prefetch import staged
    from ..train import metrics as M

    tr = make_trainer(spec, args)
    tiered, device_tiered = _tiering(spec)

    train_it = spec.train_data(args)
    first = next(iter(train_it))
    state = tr.init(jax.random.key(args.seed), first)

    mgr = None
    if args.checkpoint:
        mgr = CheckpointManager(args.checkpoint, full_secs=args.save_secs,
                                incr_secs=args.incr_save_secs)
        q = getattr(args, "_workqueue", None)
        if q is not None:
            # queue position saves with every checkpoint; the restore side
            # already ran at stream creation (criteo_train_stream)
            mgr.attach_aux("workqueue", q.snapshot, None)
        state, restored = mgr.restore(tr, state)
        if restored:
            print(f"restored from {args.checkpoint} at step {int(state.step)}")

    if args.profile:
        jax.profiler.start_trace(args.profile)
    writer = None
    if args.summary_dir:
        from .summary import SummaryWriter
        writer = SummaryWriter(args.summary_dir)

    # multi-tier tables: probe ids are computed in the prefetch workers
    # (pure numpy) and promoted on the main thread right before the step;
    # demotion sweeps run at fence points every demote_steps
    demote_steps = 0
    prepare = tr.prepare_batch
    finish = lambda p: p
    if tiered:
        demote_steps = args.demote_steps or (
            args.ev_evict_steps // 2 if args.ev_evict_steps
            else 10 * args.log_steps)
    if device_tiered:
        prepare = lambda b: (tr.prepare_batch(b), tr.prepare_probe(b))
    host_colls = {n: c for n, c in tr.collections.items()
                  if hasattr(c, "pack_ids_eval")}  # host-index tables
    staged_put = None
    if host_colls and not tiered and args.mesh:
        # mesh variant of the split below: workers pack numpy; the main
        # loop runs each host-SHARDED collection's exchange resolve
        # (sharded_pack) in step order
        from ..feature_column import pack_dense as _pd
        from ..parallel.multihost import globalize as _gl
        from jax.sharding import PartitionSpec as _P

        def prepare(b):
            dense = (_gl(tr.mesh, _P(tr.axis, None),
                         _pd(tr.numeric_columns, b))
                     if tr.numeric_columns else None)
            labels = (_gl(tr.mesh, _P(tr.axis),
                          np.asarray(b["label"], np.float32))
                      if "label" in b else None)
            cats = {n: c.sharded_pack(b, tr.S, 0, tr.mesh, tr.axis)
                    for n, c in tr.collections.items()
                    if n not in host_colls}
            host_np = {n: c.pack_ids_np(b) for n, c in host_colls.items()}
            return (dense, cats, labels), host_np

        def staged_put(item):
            return item  # already globalized; host ids stay host-side

        def finish(p):
            (dense, cats, labels), host_np = p
            cats = dict(cats)
            for n, v in host_np.items():
                c = host_colls[n]
                cap = tr._bucket_cap(
                    c, c.total_width * max(1, v.shape[1] // tr.S))
                cats[n] = c.sharded_pack(v, tr.S, cap, tr.mesh, tr.axis)
            return dense, cats, labels
    elif host_colls and not device_tiered and not args.mesh:
        # the host-index RESOLVE mutates the key index and must run
        # single-threaded in step order, and the H2D transfer BLOCKS its
        # calling thread — so the production loop runs the full
        # HostStepPipeline (train/pipeline.py): prefetch workers do only
        # pure-numpy packing; a dedicated resolve thread indexes step N+2
        # while the H2D thread ships step N+1 and the device executes
        # step N; the main thread only dispatches jitted steps
        from ..feature_column import pack_dense as _pd

        def prepare(b):
            dense = _pd(tr.numeric_columns, b) if tr.numeric_columns else None
            dev_cats = {n: c.pack_ids(b) for n, c in tr.collections.items()
                        if n not in host_colls}
            host_np = {n: c.pack_ids_np(b) for n, c in host_colls.items()}
            labels = (np.asarray(b["label"], np.float32)
                      if "label" in b else None)
            return (dense, dev_cats, labels), host_np

        def staged_put(item):
            return item  # all H2D happens on the pipeline transfer thread

        def finish(p):
            """Pipeline resolve stage: step-order index mutation, host
            (numpy) wire buffers — the transfer stage device_puts them."""
            (dense, dev_cats, labels), host_np = p
            cats = dict(dev_cats)
            for n, v in host_np.items():
                cats[n] = host_colls[n].pack_ids_host(v)
            return dense, cats, labels

    def run_eval():
        mstate = M.create()
        if args.mesh:
            from jax.sharding import NamedSharding, PartitionSpec as P
            mstate = jax.device_put(mstate, NamedSharding(tr.mesh, P()))
        for batch in spec.eval_data(args):
            mstate = tr.eval_step(state, mstate, batch)
        return M.summarize(mstate)

    t0 = time.perf_counter()
    done = 0
    eval_secs = 0.0
    last_health = {}

    def fence_work(state, packed, done):
        """Everything that happens at a device fence: metrics read (the
        fence itself), checkpoint timers, growth, health watchdog,
        periodic eval, demotion. For the pipelined host-index loop this
        runs only with the pipeline DRAINED (resolver == device state)."""
        nonlocal last_health, eval_secs
        # summarize() reads device scalars -> this is the loop's
        # device fence: python dispatch races ahead of execution
        # otherwise (async dispatch), which would make wall-clock
        # checkpoint timers fire against dispatched, not completed,
        # steps. Saves therefore also happen here, at fence points.
        m = M.summarize(state.metrics)
        dt = time.perf_counter() - t0
        eps = done * args.batch_size / dt
        print(f"step {int(state.step)}  loss={m['loss']:.5f}  "
              f"auc={m['auc']:.4f}  "
              f"({eps:.0f} ex/s)")
        if writer:
            writer.write(int(state.step), m, examples_per_sec=eps)
        if mgr is not None:
            mgr.maybe_save(tr, state)
        if hasattr(tr, "maybe_grow"):
            # capacity growth check (DenseHashMap resize analog):
            # a saturated table silently routes new keys to the
            # null row otherwise
            grown = tr.maybe_grow(state)
            if grown is not state:
                print(f"table growth at step {int(grown.step)}: "
                      + ", ".join(
                          f"{n}->{c.config.capacity}"
                          for n, c in tr.collections.items()))
                state = grown
            elif not args.mesh:
                # compile-ahead: tables past 0.5 load warm the
                # persistent cache with the 2x-capacity step so
                # the growth fence pays deserialize, not compile
                warmed = tr.prewarm_grow(state, packed)
                if warmed:
                    print(f"prewarming grown-step compile: {warmed}")
        # silent-degradation watchdog: bucket drops / dedup-cap
        # saturation are invisible in the loss until quality rots
        last_health = _check_health(tr, state, writer, last_health)
        if args.eval_every and done % args.eval_every < args.log_steps \
                and done >= args.eval_every:
            te = time.perf_counter()
            em = run_eval()
            eval_secs += time.perf_counter() - te
            print(f"eval @ step {int(state.step)}: "
                  f"auc={em['auc']:.4f} acc={em['accuracy']:.4f}")
            if writer:
                writer.write(int(state.step), em, phase="eval")
        if demote_steps and (done // args.log_steps) % max(
                demote_steps // args.log_steps, 1) == 0:
            state = tr.maybe_demote(state)
            rows = {n: tr.host_tier_rows(n) for n in tr.tiers}
            if any(rows.values()):
                print("host tier rows: " + ", ".join(
                    f"{n}={c}" for n, c in rows.items()))
                if writer:
                    writer.write(int(state.step), rows, phase="tier")
        return state

    import itertools
    stream = itertools.chain([first], train_it)
    use_pipeline = bool(host_colls) and not device_tiered and not args.mesh
    with staged(itertools.islice(stream, args.steps), prepare=prepare,
                depth=args.prefetch_depth, workers=args.prefetch_workers,
                device_put=staged_put) as pf:
        if use_pipeline:
            from .pipeline import HostStepPipeline
            pf_it = iter(pf)
            last_args = None
            with HostStepPipeline(finish,
                                  depth=max(2, args.prefetch_depth)) as pipe:
                exhausted = False
                while not exhausted or len(pipe):
                    while not exhausted and len(pipe) < pipe.depth:
                        try:
                            pipe.feed(next(pf_it))
                        except StopIteration:
                            exhausted = True
                    if not len(pipe):
                        break
                    last_args = pipe.take()
                    state = tr._jit_train(state, *last_args)
                    done += 1
                    if done % args.log_steps == 0:
                        # drain in-flight steps so fence work (save/grow/
                        # eval/health) sees resolver == device state
                        while len(pipe):
                            last_args = pipe.take()
                            state = tr._jit_train(state, *last_args)
                            done += 1
                        state = fence_work(state, last_args, done)
        else:
            for packed in pf:
                if device_tiered:
                    packed, probe = packed
                    state = tr.promote_packed(state, probe)
                packed = finish(packed)
                state = tr._jit_train(state, *packed)
                done += 1
                if done % args.log_steps == 0:
                    state = fence_work(state, packed, done)
    jax.block_until_ready(state.step)
    train_secs = time.perf_counter() - t0 - eval_secs

    if args.profile:
        jax.profiler.stop_trace()
    if mgr is not None:
        mgr.save(tr, state)

    train_m = M.summarize(state.metrics)

    # eval on a held-out stream (read-only lookups)
    eval_m = run_eval()

    out = {
        "model": spec.name,
        "steps": int(state.step),
        "train_loss": round(train_m["loss"], 5),
        "train_auc": round(train_m["auc"], 5),
        "eval_auc": round(eval_m["auc"], 5),
        "eval_accuracy": round(eval_m["accuracy"], 5),
        "examples_per_sec": round(done * args.batch_size / max(train_secs, 1e-9), 1),
    }
    if writer:
        writer.write(int(state.step), eval_m, phase="eval")
        writer.close()
    print(json.dumps(out))
    return out


# -- shared data plumbing -----------------------------------------------------


def criteo_train_stream(args):
    from ..data.criteo import SyntheticCriteo, read_criteo
    from ..data.work_queue import WorkQueue, input_producer
    if args.data_location and not args.synthetic:
        files = args.data_location.split(",")
        if len(files) > 1:
            files = files[:-1]  # last file is the eval holdout
        if args.workqueue:
            q = WorkQueue(files, path=args.workqueue, num_epochs=1000)
            if getattr(args, "checkpoint", ""):
                # rewind the queue to the newest checkpoint's saved claim
                # state BEFORE any item is claimed (reference WorkQueue
                # SaveableObject semantics, work_queue.py:113): work done
                # between that save and a crash is re-served, not skipped.
                # run() then attaches the snapshot side to the manager.
                import json as _json
                from ..checkpoint import format as F
                base, incrs = F.restore_plan(args.checkpoint)
                newest = (incrs[-1] if incrs else base) if base else None
                if newest:
                    p = os.path.join(newest["path"], "aux_workqueue.json")
                    if os.path.exists(p):
                        with open(p) as f:
                            q.restore_snapshot(_json.load(f))
            args._workqueue = q
            return input_producer(q, read_criteo, batch_size=args.batch_size)
        def gen():
            while True:
                for f in files:
                    yield from read_criteo(f, args.batch_size)
        return gen()
    return SyntheticCriteo(batch_size=args.batch_size, seed=args.seed)


def criteo_eval_stream(args):
    from ..data.criteo import SyntheticCriteo, read_criteo
    if args.data_location and not args.synthetic:
        # holdout: with several files, the LAST is reserved for eval and
        # excluded from training (criteo_train_stream); a single file has
        # no holdout — metrics are then train-set metrics
        f = args.data_location.split(",")[-1]
        import itertools
        return itertools.islice(read_criteo(f, args.batch_size), args.eval_steps)
    gen = SyntheticCriteo(batch_size=args.batch_size, seed=args.seed + 999)
    return gen.take(args.eval_steps)


def behavior_train_stream(args):
    from ..data.behavior import SyntheticBehavior
    return SyntheticBehavior(batch_size=args.batch_size, seed=args.seed,
                             n_items=args.synthetic_items,
                             n_users=args.synthetic_users)


def behavior_eval_stream(args):
    from ..data.behavior import SyntheticBehavior
    gen = SyntheticBehavior(batch_size=args.batch_size, seed=args.seed + 999,
                            n_items=args.synthetic_items,
                            n_users=args.synthetic_users)
    return gen.take(args.eval_steps)
