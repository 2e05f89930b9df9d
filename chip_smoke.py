#!/usr/bin/env python3
"""GPU smoke test: DLRM training and serving through the entry points users
call, on one card, checked against CPU references.

    python chip_smoke.py               # device, train, parity, serve, gather
    python chip_smoke.py --four-cards  # only the sharded paths, on 4 cards

Everything runs in this one process: a JAX process reserves most of a
card's memory, so no second JAX process may open the card meanwhile. Any
failure raises and exits non-zero; without a GPU the script exits before
any phase. The last stdout line is one JSON object naming the device.

Phases (one card):
  device  JAX/card identity, compile-cache directory, native host library.
  train   modelzoo DLRM at its full widths (26 tables of dim 16, bottom MLP
          512-256, top MLP 1024-1024-512-256, fused Adagrad slots), B=4096,
          through ``train/cli.py run()`` once per index engine (host-index,
          device-index), checkpointing; plus the train step's compile time,
          ``memory_analysis()`` and an informative ms/step.
  parity  the same widths at B=512 for 3 steps at "highest" matmul
          precision: the GPU step against the same step on the CPU device,
          and the host-index engine against the device-index engine on the
          GPU; also the GPU/CPU gap at default precision (TF32 may apply).
  serve   ``serving/server.py`` over the host-index run's checkpoint, one
          request and a concurrent pair through the dynamic batcher, against
          a ``Predictor`` on the CPU device.
  gather  XLA's row gather and gather + masked mean-pool, timed and checked
          against numpy.
"""
import argparse
import contextlib
import importlib
import itertools
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

# Parity tolerances. Both sides compute in float32 at "highest" matmul
# precision, so they differ only by the order of floating-point sums
# (XLA:GPU and XLA:CPU reduce in different trees), grown through 3 Adagrad
# steps. On an H100 that left a loss gap of 1.7e-7 relative, while the
# same steps at default precision (TF32 towers) moved the loss by 4.6e-6:
# the loss limit sits between the two, so a tower silently computed in a
# lower precision fails it, and the default-precision run must fail it as
# a control. Parameters and rows keep 1e-4: at "highest" they already
# differ by up to 1.4e-5 (Adagrad's first steps scale tiny gradient
# differences up), so they do not separate the precisions, but a racing
# scatter (a duplicate index behind a unique_indices promise) moves a row
# by a whole update, ~1e-2 at these learning rates.
LOSS_RTOL = 1e-6
PARAM_ATOL = 1e-4
ROW_ATOL = 1e-4
# served click probabilities: one forward pass, no optimizer in between
PROB_ATOL = 1e-5


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def nvidia_smi():
    cmd = ["nvidia-smi", "--query-gpu=name,power.limit",
           "--format=csv,noheader"]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unavailable ({e})"
    return r.stdout.strip() or f"unavailable (rc {r.returncode})"


def dlrm():
    return importlib.import_module("modelzoo.DLRM.train")


def dlrm_args(*flags):
    from deeprec_tpu.train import cli
    return cli.base_parser("chip smoke").parse_args(
        ["--synthetic", *map(str, flags)])


def maxdiff(a, b):
    """(max abs difference over two same-structure trees, its leaf path)."""
    import jax
    la = jax.tree_util.tree_flatten_with_path(a)[0]
    lb = jax.tree_util.tree_leaves(b)
    assert len(la) == len(lb)
    return max((float(np.max(np.abs(np.asarray(x, np.float64)
                                    - np.asarray(y, np.float64)))),
                jax.tree_util.keystr(path)) for (path, x), y in zip(la, lb))


def platforms(tree):
    import jax
    return sorted({d.platform for x in jax.tree_util.tree_leaves(tree)
                   if hasattr(x, "devices") for d in x.devices()})


def table_rows(tr, state, name="emb"):
    """key -> trained embedding row of one table (optimizer slots left
    out: the CLI fuses them into the rows on the device engine only)."""
    coll, bundle = tr.collections[name], state.tables[name]
    a = coll.ckpt_arrays(bundle, getattr(tr, "S", 1), None, False,
                         int(np.max(np.asarray(state.step))))
    dim = coll.config.embedding_dim
    return dict(zip(a["keys"].tolist(), np.asarray(a["values"])[:, :dim]))


def rows_maxdiff(ra, rb):
    if ra.keys() != rb.keys():
        raise AssertionError(f"touched keys differ: {len(ra)} vs {len(rb)}, "
                             f"{len(ra.keys() ^ rb.keys())} not shared")
    return max(float(np.max(np.abs(ra[k] - rb[k]))) for k in ra)


# -- phases -------------------------------------------------------------------


def phase_device():
    import jax
    from deeprec_tpu.utils import compile_cache, native
    devs = jax.devices()
    log("device", f"jax {jax.__version__}; backend {jax.default_backend()}; "
                  f"device_kind {devs[0].device_kind}; count {len(devs)}")
    log("device", f"nvidia-smi name, power.limit: {nvidia_smi()}")
    log("device", f"compile cache: {compile_cache.enable()}")
    if native.get_lib() is None:
        raise RuntimeError("native host library did not build:\n"
                           + native.build_error())
    log("device", f"native host library: built {native.library_path()}")


def phase_train(engine, workdir, steps=20, batch=4096, capacity=None,
                timed_steps=8):
    """modelzoo DLRM through ``cli.run`` on one index engine ("host" or
    "device"); returns the checkpoint directory it wrote."""
    import jax
    from deeprec_tpu.train import cli
    from deeprec_tpu.train.summary import read_events

    tag = f"train/{engine}"
    ckpt = os.path.join(workdir, f"ckpt_{engine}")
    summ = os.path.join(workdir, f"summary_{engine}")
    flags = ["--steps", steps, "--batch_size", batch, "--log_steps", 4,
             "--eval_steps", 2, "--checkpoint", ckpt, "--summary_dir", summ]
    if engine == "host":
        flags.append("--host_index")
    if capacity:
        flags += ["--capacity", capacity]
    args = dlrm_args(*flags)

    # the jitted train step alone: compile time, memory, steady ms/step
    # (host half staged ahead in step order; device path only)
    spec = dlrm().build(args)
    tr = cli.make_trainer(spec, args)
    batches = list(itertools.islice(iter(spec.train_data(args)),
                                    timed_steps + 3))
    state = tr.init(jax.random.key(args.seed), batches[0])
    packed = [tr.prepare_batch(b) for b in batches]
    t0 = time.perf_counter()
    compiled = tr._jit_train.lower(state, *packed[0]).compile()
    log(tag, f"train step compile {time.perf_counter() - t0:.2f} s")
    mem = compiled.memory_analysis()
    if mem is not None:
        log(tag, "memory_analysis: " + ", ".join(
            f"{k}={getattr(mem, k)}" for k in (
                "argument_size_in_bytes", "output_size_in_bytes",
                "alias_size_in_bytes", "temp_size_in_bytes",
                "generated_code_size_in_bytes") if hasattr(mem, k)))
    for p in packed[:3]:
        state = compiled(state, *p)
    jax.block_until_ready(state)
    t0 = time.perf_counter()
    for p in packed[3:]:
        state = compiled(state, *p)
    jax.block_until_ready(state)
    ms = (time.perf_counter() - t0) / timed_steps * 1e3
    log(tag, f"steady train step {ms:.3f} ms/step at B={batch} "
             f"(informative; device path with the host half staged ahead) "
             f"on {nvidia_smi()}")
    del state, compiled, packed, tr, spec

    # the loop a user runs
    out = cli.run(dlrm().build(args), args)
    fences = [e for e in read_events(summ) if "phase" not in e]
    traj, prev = [], (0, 0.0)
    for e in fences:  # cumulative means -> the mean loss of each window
        n, s = e["examples"], e["loss"] * e["examples"]
        traj.append((e["step"], (s - prev[1]) / (n - prev[0])))
        prev = (n, s)
    log(tag, "loss per 4-step window: " + ", ".join(
        f"step {st}: {l:.5f}" for st, l in traj))
    losses = np.array([l for _, l in traj])
    if out["steps"] != steps or not np.isfinite(losses).all() \
            or not len(losses):
        raise AssertionError(f"{tag}: bad run {out} {traj}")
    if not 0.0 <= out["eval_auc"] <= 1.0:
        raise AssertionError(f"{tag}: eval AUC {out['eval_auc']}")
    log(tag, f"result {json.dumps(out)}")
    return ckpt


def _train_steps(engine, batches, device=None, precision="highest",
                 mesh=0, capacity=1 << 16):
    """``len(batches)`` train steps of modelzoo DLRM (exact dedup) on one
    engine; returns (trainer, state, per-step losses, dense params)."""
    import jax
    from deeprec_tpu.train import cli

    flags = ["--batch_size", len(batches[0]["label"]), "--capacity",
             capacity, "--max_unique_ratio", 0, "--mesh", mesh]
    if engine == "host":
        flags.append("--host_index")
    args = dlrm_args(*flags)
    tr = cli.make_trainer(dlrm().build(args), args)
    placed = (jax.default_device(device) if device is not None
              else contextlib.nullcontext())
    with placed, jax.default_matmul_precision(precision):
        state = tr.init(jax.random.key(0), batches[0])
        losses, prev = [], (0.0, 0.0)
        for b in batches:
            state = tr.train_step(state, b)
            m = state.metrics
            s, n = float(m.loss_sum), float(m.count)
            losses.append((s - prev[0]) / (n - prev[1]))
            prev = (s, n)
    return tr, state, np.array(losses), jax.device_get(state.params)


def _compare(tag, a, b, label):
    """a, b: (trainer, state, losses, params) of two runs on one stream."""
    dl = float(np.max(np.abs(a[2] - b[2]) / np.abs(b[2])))
    dp, where = maxdiff(a[3], b[3])
    dr = rows_maxdiff(table_rows(a[0], a[1]), table_rows(b[0], b[1]))
    log(tag, f"{label}: loss max abs diff "
             f"{float(np.max(np.abs(a[2] - b[2]))):.3e}, "
             f"max rel diff {dl:.3e} (tol {LOSS_RTOL}), "
             f"dense param max abs diff {dp:.3e} at {where} "
             f"(tol {PARAM_ATOL}), "
             f"touched-row max abs diff {dr:.3e} (tol {ROW_ATOL}) over "
             f"{len(table_rows(b[0], b[1]))} rows")
    return dl, dp, dr


def _check(tag, diffs):
    dl, dp, dr = diffs
    if not (dl <= LOSS_RTOL and dp <= PARAM_ATOL and dr <= ROW_ATOL):
        raise AssertionError(f"{tag}: outside tolerance {diffs}")


def phase_parity(batch=512, steps=3, capacity=1 << 16):
    import jax
    from deeprec_tpu.data.criteo import SyntheticCriteo

    cpu = jax.devices("cpu")[0]
    batches = list(SyntheticCriteo(batch_size=batch, seed=5).take(steps))
    runs = {}
    for engine in ("device", "host"):
        runs[engine, "gpu"] = _train_steps(engine, batches,
                                           capacity=capacity)
        runs[engine, "cpu"] = _train_steps(engine, batches, device=cpu,
                                           capacity=capacity)
        placed = [platforms(runs[engine, d][1].params) for d in ("gpu", "cpu")]
        if placed != [[jax.default_backend()], ["cpu"]]:
            raise AssertionError(f"runs not placed as intended: {placed}")
        log("parity", f"{engine} engine per-step loss: "
                      f"{np.array2string(runs[engine, 'gpu'][2], precision=6)}")
        _check("parity", _compare("parity", runs[engine, "gpu"],
                                  runs[engine, "cpu"],
                                  f"{engine} engine, default device vs CPU"))
    _check("parity", _compare("parity", runs["host", "gpu"],
                              runs["device", "gpu"],
                              "host-index vs device-index engine"))
    # the dense towers at default precision (TF32 on the card): the number
    # a precision stance starts from, and the control that shows the loss
    # limit can tell the precisions apart (the CPU has no TF32)
    default = _train_steps("device", batches, precision="default",
                           capacity=capacity)
    dl = _compare("parity", default, runs["device", "cpu"],
                  "device engine at default precision vs CPU at highest")[0]
    if jax.default_backend() == "gpu" and dl <= LOSS_RTOL:
        raise AssertionError(
            f"parity: default precision is within the loss tolerance "
            f"({dl:.3e} <= {LOSS_RTOL}), so it cannot tell whether the "
            f'"highest" runs ran at highest precision')


def _post(port, payload):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/predict",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        return json.loads(r.read())


def phase_serve(ckpt, n=8):
    import jax
    from deeprec_tpu.data.criteo import SyntheticCriteo
    from deeprec_tpu.serving.predictor import Predictor
    from deeprec_tpu.serving.server import make_server

    b = next(iter(SyntheticCriteo(batch_size=n, seed=123)))
    cols = {k: np.asarray(v) for k, v in b.items() if k != "label"}
    payload = lambda sl: {"inputs": {k: v[sl].tolist()
                                     for k, v in cols.items()}}
    prev = jax.config.jax_default_matmul_precision
    # global, not a context: the server answers from its own threads
    jax.config.update("jax_default_matmul_precision", "highest")
    try:
        spec = dlrm().build(dlrm_args())
        pred = Predictor(spec.model, spec.numeric_columns, spec.collections,
                         ckpt)
        srv = make_server(pred, port=0, dynamic_batch_ms=2.0)
        th = threading.Thread(target=srv.serve_forever, daemon=True)
        th.start()
        port = srv.server_address[1]
        try:
            t0 = time.perf_counter()
            one = _post(port, payload(slice(None)))["predictions"]
            log("serve", f"one request of {n}: "
                         f"{(time.perf_counter() - t0) * 1e3:.1f} ms "
                         "(first call, compile included)")
            pair = [None, None]
            halves = [slice(0, n // 2), slice(n // 2, n)]

            def hit(i):
                pair[i] = _post(port, payload(halves[i]))["predictions"]
            ts = [threading.Thread(target=hit, args=(i,)) for i in (0, 1)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(300)
            if any(p is None for p in pair):
                raise AssertionError("concurrent request did not complete")
            batches = srv.service.health().get("device_batches")
        finally:
            srv.shutdown()
            srv.server_close()
            th.join(30)
        cpu = jax.devices("cpu")[0]
        spec_c = dlrm().build(dlrm_args())
        with jax.default_device(cpu):
            ref_pred = Predictor(spec_c.model, spec_c.numeric_columns,
                                 spec_c.collections, ckpt)
            ref = ref_pred.predict(cols)
    finally:
        jax.config.update("jax_default_matmul_precision", prev)
    placed = [platforms((p.params, p.tables)) for p in (pred, ref_pred)]
    one, pair = np.asarray(one), np.concatenate(pair)
    d1, d2 = (float(np.max(np.abs(x - ref))) for x in (one, pair))
    log("serve", f"served from {placed[0]} vs Predictor on {placed[1]}: "
                 f"max abs diff single {d1:.3e}, concurrent pair {d2:.3e} "
                 f"(tol {PROB_ATOL}); batcher device calls {batches}; "
                 f"probs {np.round(one, 5)}")
    if placed != [[jax.default_backend()], ["cpu"]]:
        raise AssertionError(f"predictors not placed as intended: {placed}")
    if one.shape != (n,) or not (d1 <= PROB_ATOL and d2 <= PROB_ATOL):
        raise AssertionError("served predictions disagree with the CPU "
                             "Predictor")


def _time_loop(fn, args, iters):
    """ms per iteration of ``fn`` run ``iters`` times inside one jit (the
    per-call dispatch cost is paid once)."""
    import jax
    loop = jax.jit(lambda *a: jax.lax.fori_loop(
        0, iters, lambda i, acc: fn(i, *a), fn(0, *a)))
    jax.block_until_ready(loop(*args))
    t0 = time.perf_counter()
    jax.block_until_ready(loop(*args))
    return (time.perf_counter() - t0) / (iters + 1) * 1e3


def phase_gather(rows=1 << 21, n=32768, n_big=1 << 19, batch=4096,
                 width=16, dim_pool=128, valid_frac=0.7, iters=200):
    """XLA's plain row gather and gather + masked mean-pool: the times a
    hand-written gather kernel would have to beat. Each time is printed
    beside the timing loop's own cost per iteration (a one-row gather): a
    time within 3x of it is overhead-bound and says little of the gather,
    so D=16 is also timed over ``n_big`` rows."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    stride = jnp.int32(7919)  # each iteration reads other rows

    def gather_ms(values, slots):
        return _time_loop(lambda i, v, s: v[(s + i * stride) % rows],
                          (values, slots), iters)

    def versus_loop(ms):
        return (f"{ms / loop_ms:.1f}x the loop's own {loop_ms:.4f} ms"
                + (", overhead-bound" if ms < 3 * loop_ms else ""))

    loop_ms = None
    for d, sizes in ((16, (n, n_big)), (128, (n,))):
        values = jax.random.normal(jax.random.key(d), (rows, d), jnp.float32)
        if loop_ms is None:
            loop_ms = gather_ms(values, jnp.zeros((1,), jnp.int32))
            log("gather", f"timing loop alone (one-row gather): "
                          f"{loop_ms:.4f} ms per iteration")
        for m in sizes:
            slots_np = rng.integers(0, rows, m).astype(np.int32)
            slots = jnp.asarray(slots_np)
            got = np.asarray(jax.jit(lambda v, s: v[s])(values, slots))
            np.testing.assert_array_equal(got, np.asarray(values)[slots_np])
            ms = gather_ms(values, slots)
            gbs = 2 * m * d * 4 / ms / 1e6  # rows read + rows written
            log("gather", f"values[slots] D={d}: {m} random rows of {rows}: "
                          f"{ms:.4f} ms, {gbs:.1f} GB/s (read+write; "
                          f"{versus_loop(ms)})")
        del values

    d = dim_pool
    values = jax.random.normal(jax.random.key(1), (rows, d), jnp.float32)
    slots_np = rng.integers(0, rows, (batch, width)).astype(np.int32)
    valid_np = rng.random((batch, width)) < valid_frac
    slots, valid = jnp.asarray(slots_np), jnp.asarray(valid_np)

    def pool(i, v, s, m):
        g = jnp.where(m[..., None], v[(s + i * stride) % rows], 0.0)
        return g.sum(1) / jnp.maximum(m.sum(1, keepdims=True), 1)

    got = np.asarray(jax.jit(lambda v, s, m: pool(0, v, s, m))(
        values, slots, valid))
    vals = np.asarray(values)[slots_np].astype(np.float64)
    want = (vals * valid_np[..., None]).sum(1) / np.maximum(
        valid_np.sum(1, keepdims=True), 1)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    ms = _time_loop(pool, (values, slots, valid), iters)
    gbs = (batch * width + batch) * d * 4 / ms / 1e6
    log("gather", f"gather + masked mean-pool B={batch} w={width} D={d} "
                  f"({valid_np.mean():.0%} valid): {ms:.4f} ms, "
                  f"{gbs:.1f} GB/s (all B*w rows read + pooled rows "
                  f"written; {versus_loop(ms)})")


def phase_four_cards(workdir, batch=4096, steps=3, capacity=1 << 16):
    """The device-sharded and host-sharded engines over make_mesh(4)
    against the single-device Trainer, then a 4-shard save restored on one
    device and trained one more step."""
    import jax
    from deeprec_tpu.checkpoint import CheckpointManager
    from deeprec_tpu.data.criteo import SyntheticCriteo
    from deeprec_tpu.train import cli

    if len(jax.devices()) < 4:
        raise RuntimeError(f"--four-cards needs 4 devices, found "
                           f"{len(jax.devices())}")
    batches = list(SyntheticCriteo(batch_size=batch, seed=3).take(steps + 1))
    train, extra = batches[:steps], batches[steps]
    ref = _train_steps("device", train, capacity=capacity)
    log("four-cards", "single-device per-step loss: "
                      f"{np.array2string(ref[2], precision=6)}")
    runs = {}
    for engine in ("device", "host"):
        runs[engine] = _train_steps(engine, train, mesh=4, capacity=capacity)
        health = runs[engine][0].table_health(runs[engine][1])["emb"]
        log("four-cards", f"{engine}-sharded health {health}")
        _check("four-cards", _compare(
            "four-cards", runs[engine], ref,
            f"{engine}-sharded on 4 cards vs single-device Trainer"))

    tr4, st4 = runs["device"][:2]
    ckpt = os.path.join(workdir, "ckpt_four")
    CheckpointManager(ckpt).save(tr4, st4)
    args1 = dlrm_args("--batch_size", batch, "--capacity", capacity,
                      "--max_unique_ratio", 0)
    tr1 = cli.make_trainer(dlrm().build(args1), args1)
    with jax.default_matmul_precision("highest"):
        st1 = tr1.init(jax.random.key(1), train[0])
        st1, ok = CheckpointManager(ckpt).restore(tr1, st1)
        if not ok:
            raise AssertionError("no checkpoint restored")
        dr = rows_maxdiff(table_rows(tr1, st1), table_rows(tr4, st4))
        dp = maxdiff(jax.device_get(st1.params), runs["device"][3])[0]
        st1 = tr1.train_step(st1, extra)
        loss = float(st1.metrics.loss_sum) / float(st1.metrics.count)
    log("four-cards", f"4-shard save restored on 1 device: row max abs diff "
                      f"{dr:.3e}, dense param max abs diff {dp:.3e}; "
                      f"step {int(st1.step)} loss {loss:.5f}")
    if dr != 0.0 or dp != 0.0 or not np.isfinite(loss) \
            or int(st1.step) != steps + 1:
        raise AssertionError("4-shard checkpoint did not restore on 1 device")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded engines over 4 cards and "
                         "what they are compared with")
    opts = ap.parse_args(argv)

    import jax
    if jax.default_backend() != "gpu":
        print(f"chip_smoke: needs a GPU; JAX's default backend is "
              f"{jax.default_backend()}", file=sys.stderr)
        return 2
    phase_device()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        if opts.four_cards:
            phase_four_cards(work)
        else:
            ckpt = phase_train("host", work)
            phase_train("device", work)
            phase_parity()
            phase_serve(ckpt)
            phase_gather()
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
