"""Long-run soak: the month-long-training story, compressed.

Step-time and quality stability through repeated grow -> demote ->
incremental-save -> restore cycles. This runs continuous DCN training on
the device for
``--minutes`` with every operational subsystem live at once:

  * capacity growth        (maybe_grow at fence points, like train.cli)
  * tiered demotion        (TieredTrainer.maybe_demote on a cadence)
  * incremental + full checkpoints on wall-clock timers (maybe_save)
  * ONE simulated failure at half-time: the trainer and all device state
    are discarded and rebuilt from the latest checkpoint (the
    tests/test_fault_tolerance.py scenario, inside a long run)
  * the health watchdog    (table_health; alarms are recorded, and the
    self-heals train.cli applies are applied here too)

Recorded: per-fence step-time series (p50/p90/p99 across the run),
capacity / HBM-rows / host-tier-rows trajectories, alarms, restore gap,
and final train+eval AUC. Output: ONE JSON line to stdout (plus a
trajectory dump to --out).

The reference's analog is its incremental-checkpoint + AdagradDecay
rationale (docs/Incremental-Checkpoint.md, docs/AdagradDecay-Optimizer.md:
month-scale continuous training); it ships no equivalent harness.

Run:  python benchmarks/soak.py --minutes 45
Smoke: python benchmarks/soak.py --smoke   (CPU-safe, ~1 min)
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def build_trainer(args):
    import jax.numpy as jnp
    import optax

    import deeprec_tpu as dr
    from deeprec_tpu import feature_column as fc
    from deeprec_tpu.config import StorageOption, StorageType
    from deeprec_tpu.data.criteo import CAT_NAMES, DENSE_NAMES
    from deeprec_tpu.models import ctr
    from deeprec_tpu.optim import sparse as sopt
    from deeprec_tpu.train.tiered_trainer import TieredTrainer

    numeric = [fc.NumericColumn(n, log_normalize=True) for n in DENSE_NAMES]
    cols = [fc.EmbeddingColumn(fc.CategoricalColumn(n), args.emb_dim)
            for n in CAT_NAMES]
    if args.host_index:
        # the host-index fast path's operational soak: growth, admission
        # filter, step eviction, incremental saves, failover AND the host
        # tier (round 5: promotion rides the resolve wire) — the plain
        # Trainer drives it (the collection tiers itself)
        from deeprec_tpu.host_index import HostIndexEmbeddingCollection
        from deeprec_tpu.train.trainer import Trainer
        coll = HostIndexEmbeddingCollection(
            cols, name="emb", capacity=args.capacity,
            initializer=dr.Initializer("normal", scale=0.05),
            max_unique=len(CAT_NAMES) * args.batch // 6,
            counter_filter=dr.CounterFilter(filter_freq=2),
            evict=dr.GlobalStepEvict(steps_to_live=args.steps_to_live),
            storage=StorageOption(storage_type=StorageType.HBM_DRAM))
        model = ctr.DCN(emb_names=CAT_NAMES, cross_layers=3,
                        deep_units=(512, 256, 64))
        return Trainer(
            model=model, numeric_columns=numeric, collections={"emb": coll},
            sparse_optimizers={"emb": sopt.sparse_adagrad(0.05)},
            dense_optimizer=optax.adagrad(0.05))
    coll = fc.EmbeddingCollection(
        cols, name="emb", capacity=args.capacity,
        initializer=dr.Initializer("normal", scale=0.05),
        max_unique=len(CAT_NAMES) * args.batch // 6,
        # the full operational layout: admission filter, step eviction,
        # host tier — the soak exercises the heavy path, not the light one
        counter_filter=dr.CounterFilter(filter_freq=2),
        evict=dr.GlobalStepEvict(steps_to_live=args.steps_to_live),
        storage=StorageOption(storage_type=StorageType.HBM_DRAM))
    model = ctr.DCN(emb_names=CAT_NAMES, cross_layers=3,
                    deep_units=(512, 256, 64))
    return TieredTrainer(
        model=model, numeric_columns=numeric, collections={"emb": coll},
        sparse_optimizers={"emb": sopt.sparse_adagrad(0.05)},
        dense_optimizer=optax.adagrad(0.05))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--minutes", type=float, default=45.0)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--emb-dim", type=int, default=16)
    ap.add_argument("--capacity", type=int, default=1 << 17,
                    help="deliberately small start so growth fires")
    ap.add_argument("--steps-to-live", type=int, default=1200)
    ap.add_argument("--fence-every", type=int, default=20,
                    help="steps between device fences (timing+ops points)")
    ap.add_argument("--demote-every", type=int, default=30,
                    help="fences between demotion sweeps")
    ap.add_argument("--full-secs", type=float, default=900.0)
    ap.add_argument("--incr-secs", type=float, default=180.0)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: a fresh temporary "
                         "directory)")
    ap.add_argument("--out", default="runs/soak_trajectory.json")
    ap.add_argument("--eval-batches", type=int, default=10)
    ap.add_argument("--prefetch-workers", type=int, default=6)
    ap.add_argument("--max-fences", type=int, default=None,
                    help="stop after N fences (deterministic smoke runs; "
                         "failover fires at N/2) instead of wall-clock")
    ap.add_argument("--host_index", action="store_true",
                    help="soak the host-index fast path (plain Trainer: "
                         "growth/filter/evict/ckpt/failover, no host tier)")
    ap.add_argument("--smoke", action="store_true")
    args = ap.parse_args()
    if args.smoke:
        # deterministic: fence-count driven, capacity small enough that
        # growth ALWAYS fires, timers short enough that both save kinds do
        args.minutes = 30.0          # deadline is the backstop, not the driver
        args.max_fences = 10
        args.batch, args.capacity = 512, 1 << 12
        args.steps_to_live, args.fence_every, args.demote_every = 10, 5, 2
        args.full_secs, args.incr_secs = 25.0, 8.0
        args.eval_batches = 3

    import jax

    from deeprec_tpu.checkpoint.saver import CheckpointManager
    from deeprec_tpu.data.criteo import SyntheticCriteo
    from deeprec_tpu.data.prefetch import staged
    from deeprec_tpu.train import metrics as M
    from deeprec_tpu.train.cli import _check_health

    import shutil
    import tempfile
    if args.ckpt_dir is None:
        args.ckpt_dir = tempfile.mkdtemp(prefix="deeprec_soak_ckpt_")
    shutil.rmtree(args.ckpt_dir, ignore_errors=True)

    tr = build_trainer(args)
    gen = SyntheticCriteo(batch_size=args.batch, seed=11)
    state = tr.init(jax.random.key(0), next(iter(gen)))
    mgr = CheckpointManager(args.ckpt_dir, full_secs=args.full_secs,
                            incr_secs=args.incr_secs)

    deadline = time.time() + args.minutes * 60.0
    half = time.time() + args.minutes * 30.0
    failed_over = False
    fence_times = []        # seconds per step, one sample per fence window
    traj = []               # ops trajectory rows
    alarms = 0
    saves = {"full": 0, "incr": 0}
    restore_gap = None
    last_health = {}
    t_run0 = time.time()

    def fence_stats(st):
        m = M.summarize(st.metrics)
        return m

    # promotion needs the RAW batch (host id packing); the jitted step
    # needs the PACKED one — workers produce both, device_put only the
    # packed side (device_put'ing raw arrays would force a D2H later).
    # host-index: workers do only numpy packing (the RESOLVE mutates the
    # key index and runs on the main thread, in step order — see
    # train/cli.py), and there is no promotion.
    stream = iter(gen)
    pipe = None
    if args.host_index:
        from deeprec_tpu.feature_column import pack_dense
        from deeprec_tpu.train.pipeline import HostStepPipeline

        prep = lambda b: (None, (pack_dense(tr.numeric_columns, b),
                                 tr.collections["emb"].pack_ids_np(b),
                                 np.asarray(b["label"], np.float32)))
        put = lambda rp: rp

        # the production pipeline (train/pipeline.py): resolve thread ->
        # H2D thread -> dispatch; run_step only consumes device-ready args.
        # `tr` rebinds at failover — resolve reads it late so the fresh
        # resolver is picked up (the pipeline is empty there: fences drain).
        def _resolve(packed):
            dense_np, ids_np, labels_np = packed
            return (dense_np,
                    {"emb": tr.collections["emb"].pack_ids_host(ids_np)},
                    labels_np)

        pipe = HostStepPipeline(_resolve, depth=3)

        def run_step(state, raw, packed):
            return tr._jit_train(state, *packed)
    else:
        prep = lambda b: (b, tr.prepare_batch(b))
        put = lambda rp: (rp[0], jax.device_put(rp[1]))

        def run_step(state, raw, packed):
            state = tr._promote_for_batch(state, raw)
            return tr._jit_train(state, *packed)
    with staged(stream, prepare=prep, depth=8, device_put=put,
                workers=args.prefetch_workers) as pf:
        pf_it = iter(pf)

        def take_step(state):
            """One train step; host-index mode keeps the pipeline primed
            (resolve + H2D threads run `depth` ahead of dispatch)."""
            if pipe is not None:
                while len(pipe) < pipe.depth:
                    pipe.feed(next(pf_it)[1])
                return run_step(state, None, pipe.take())
            raw, packed = next(pf_it)
            return run_step(state, raw, packed)

        def drain(state):
            """Consume in-flight pipeline steps: fence work (save/grow/
            health/failover) must see resolver == device state."""
            n = 0
            while pipe is not None and len(pipe):
                state = run_step(state, None, pipe.take())
                n += 1
            return state, n

        # warm the compile outside the timed region
        state = take_step(state)
        state, _ = drain(state)
        float(state.metrics.count)     # D2H fence
        n_fence = 0
        while (time.time() < deadline
               and (args.max_fences is None or n_fence < args.max_fences)):
            t0 = time.perf_counter()
            n_win = 0
            for _ in range(args.fence_every):
                state = take_step(state)
                n_win += 1
            state, k = drain(state)
            n_win += k
            m = fence_stats(state)     # D2H read = the fence
            dt = (time.perf_counter() - t0) / n_win
            n_fence += 1
            fence_times.append(dt)

            # --- the operational sweep, exactly train.cli's fence work ---
            kind = mgr.maybe_save(tr, state)
            if kind:
                saves["full" if "full" in os.path.basename(kind) else
                      "incr"] += 1
            grown = tr.maybe_grow(state)
            if grown is not state:
                state = grown
            if n_fence % args.demote_every == 0 \
                    and hasattr(tr, "maybe_demote"):
                state = tr.maybe_demote(state)
            h_prev = dict(last_health)
            last_health = _check_health(tr, state, None, last_health)
            for name, h in (last_health or {}).items():
                p = h_prev.get(name, {})
                if (h.get("dropped", 0) > p.get("dropped", 0)
                        or h.get("unique_saturated_steps", 0)
                        > p.get("unique_saturated_steps", 0)):
                    alarms += 1
            traj.append({
                "t": round(time.time() - t_run0, 1),
                "step": int(state.step),
                "loss": round(m["loss"], 5),
                "auc": round(m["auc"], 5),
                "ms_per_step": round(dt * 1e3, 3),
                "capacity": tr.collections["emb"].config.capacity,
                "hbm_rows": (last_health or {}).get("emb", {}).get("size", 0),
                "tier_rows": (tr.host_tier_rows("emb")
              if hasattr(tr, "host_tier_rows") else 0),
                "saves": dict(saves),
            })

            # --- one mid-run failure + restore-from-latest -------------
            at_half = (n_fence >= args.max_fences // 2
                       if args.max_fences is not None
                       else time.time() >= half)
            if not failed_over and at_half:
                failed_over = True
                step_before = int(state.step)
                # graceful failover: the timers if due, else a forced
                # incremental — steps_lost then measures restore FIDELITY
                # (crash loss is tests/test_fault_tolerance.py's job)
                mgr.maybe_save(tr, state) or mgr.save_incremental(tr, state)
                del state
                tr = build_trainer(args)    # fresh process-equivalent
                state = tr.init(jax.random.key(1), next(iter(
                    SyntheticCriteo(batch_size=args.batch, seed=12))))
                mgr2 = CheckpointManager(args.ckpt_dir,
                                         full_secs=args.full_secs,
                                         incr_secs=args.incr_secs)
                state, ok = mgr2.restore(tr, state)
                assert ok, "mid-run restore found no checkpoint"
                mgr = mgr2
                restore_gap = step_before - int(state.step)
                traj.append({"t": round(time.time() - t_run0, 1),
                             "event": "failover_restore",
                             "resumed_step": int(state.step),
                             "steps_lost": restore_gap})

    if pipe is not None:
        pipe.close()
    mgr.save(tr, state)
    train_m = M.summarize(state.metrics)

    # held-out eval (fresh seed -> unseen id mix)
    eval_gen = SyntheticCriteo(batch_size=args.batch, seed=999)
    mstate = M.create()
    for b in eval_gen.take(args.eval_batches):
        mstate = tr.eval_step(state, mstate, b)
    eval_m = M.summarize(mstate)

    if not fence_times:  # warm-up ate the whole budget (cold compile
        fence_times = [float("nan")]  # cache): report, don't crash
    ft = np.asarray(fence_times) * 1e3
    summary = {
        "metric": "soak_dcn_minutes",
        "value": round((time.time() - t_run0) / 60.0, 1),
        "unit": "min",
        "steps": int(state.step),
        "ms_per_step_p50": round(float(np.percentile(ft, 50)), 3),
        "ms_per_step_p90": round(float(np.percentile(ft, 90)), 3),
        "ms_per_step_p99": round(float(np.percentile(ft, 99)), 3),
        "ms_per_step_last10_over_first10": round(
            float(np.mean(ft[-10:]) / np.mean(ft[:10])), 3) if len(ft) >= 20
            else None,
        "capacity_final": tr.collections["emb"].config.capacity,
        "tier_rows_final": (tr.host_tier_rows("emb")
                    if hasattr(tr, "host_tier_rows") else 0),
        "growth_events": int(sum(
            1 for a, b in zip(traj, traj[1:])
            if "capacity" in a and "capacity" in b
            and b["capacity"] > a["capacity"])),
        "saves": saves,
        "failover_steps_lost": restore_gap,
        "health_alarms": alarms,
        "train_auc": round(train_m["auc"], 5),
        "eval_auc": round(eval_m["auc"], 5),
    }
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"summary": summary, "trajectory": traj}, f, indent=1)
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
