"""Sequence-model fidelity bisect.

DIN/DIEN eval AUC (~0.63 at a few thousand steps) sits between the
behaviour stream's bias-only ceiling (0.635) and its bias+repeat floor
(0.669, benchmarks/behavior_oracle.py) — consistent with BOTH "the
attention stack is broken" and "the attention signal is representation-
bound and slow". This experiment separates the two:

  * Arm PLANTED: the item-embedding table is initialised with the
    generator's own latent item vectors (first 8 dims = item_vec, the
    perfectly-learned representation), everything trainable.
  * Arm RANDOM: same architecture, same optimizer, 0.05-normal init
    (exactly the modelzoo initializer).

Both arms train the *plain DIN module* (the same class the modelzoo
trainer wraps, deeprec_tpu/models/sequence.py) over a simple dense
embedding matrix — the EV engine is deliberately bypassed so the verdict
is about the ARCHITECTURE, not the table machinery (the engine has its
own equality tests).

Interpretation:
  * PLANTED >> bias-only ceiling (0.635) and near the feature-observable
    ceiling (0.775 upper / 0.669 no-taste floor): the attention stack can
    express and exploit the repeat-interest signal — the modelzoo gap is
    representation learning (50k items x ~80 impressions is a slow
    matrix-factorisation problem), not model fidelity.
  * PLANTED ~= RANDOM ~= bias-only: the architecture cannot use good
    representations — a real fidelity bug.

Run: python benchmarks/sequence_fidelity.py [--steps N] [--model din|dien]
"""
import argparse
import json
import sys
import time

sys.path.insert(0, ".")

import jax
import jax.numpy as jnp
import numpy as np
import optax

from deeprec_tpu.data.behavior import SyntheticBehavior, _rank_auc
from deeprec_tpu.models import sequence

N_ITEMS = 50_000
N_CATES = 200
N_USERS = 10_000
LATENT = 8


def build_batches(batch_size, n, seed):
    gen = SyntheticBehavior(batch_size=batch_size, seed=seed)
    return list(gen.take(n))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--batch_size", type=int, default=2048)
    ap.add_argument("--emb_dim", type=int, default=16)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--eval_every", type=int, default=250)
    ap.add_argument("--eval_batches", type=int, default=20)
    ap.add_argument("--model", choices=["din", "dien"], default="din")
    args = ap.parse_args()

    if args.model == "din":
        model = sequence.DIN(
            candidate_name="item", seq_name="hist_item",
            candidate_context_names=["cate"], seq_context_names=["hist_cate"],
            context_names=["uid"], hidden_units=(200, 80), att_units=(80, 40))
    else:
        model = sequence.DIEN(
            candidate_name="item", seq_name="hist_item",
            candidate_context_names=["cate"], seq_context_names=["hist_cate"],
            context_names=["uid"], hidden_units=(200, 80), att_units=(80, 40))

    d = args.emb_dim
    gen = SyntheticBehavior(batch_size=args.batch_size, seed=0)
    eval_batches = build_batches(args.batch_size, args.eval_batches, seed=777)

    def embed(tables, b):
        ei, ec, eu = tables["item"], tables["cate"], tables["uid"]
        item = jnp.asarray(b["item"]); cate = jnp.asarray(b["cate"])
        uid = jnp.asarray(b["uid"])
        hi = jnp.asarray(b["hist_item"]); hc = jnp.asarray(b["hist_cate"])
        mask = hi >= 0
        emb = {"item": ei[item], "cate": ec[cate], "uid": eu[uid]}
        seq = {"hist_item": (ei[jnp.maximum(hi, 0)] * mask[..., None], mask),
               "hist_cate": (ec[jnp.maximum(hc, 0)] * mask[..., None], mask)}
        return emb, seq

    def run_arm(arm):
        rng = np.random.default_rng(42)
        e_item = (0.05 * rng.normal(size=(N_ITEMS, d))).astype(np.float32)
        if arm == "planted":
            e_item[:, :LATENT] = gen.item_vec
        tables = {
            "item": jnp.asarray(e_item),
            "cate": jnp.asarray(0.05 * rng.normal(size=(N_CATES, d)),
                                jnp.float32),
            "uid": jnp.asarray(0.05 * rng.normal(size=(N_USERS, d)),
                               jnp.float32),
        }
        b0 = next(iter(SyntheticBehavior(batch_size=args.batch_size, seed=9)))
        emb0, seq0 = embed(tables, b0)
        variables = model.init(jax.random.PRNGKey(0), None, emb0, seq0,
                               train=True)
        params = variables["params"]
        batch_stats = variables.get("batch_stats", {})
        opt = optax.adam(args.lr)
        opt_state = opt.init((params, tables))

        def loss_fn(params, tables, batch_stats, b, train):
            emb, seq = embed(tables, b)
            if train:
                logits, mut = model.apply(
                    {"params": params, "batch_stats": batch_stats}, None,
                    emb, seq, train=True, mutable=["batch_stats"])
                bs = mut["batch_stats"]
            else:
                logits = model.apply(
                    {"params": params, "batch_stats": batch_stats}, None,
                    emb, seq, train=False)
                bs = batch_stats
            y = jnp.asarray(b["label"])
            loss = jnp.mean(
                optax.sigmoid_binary_cross_entropy(logits, y))
            return loss, (bs, logits)

        @jax.jit
        def step(params, tables, batch_stats, opt_state, b):
            (loss, (bs, _)), grads = jax.value_and_grad(
                loss_fn, argnums=(0, 1), has_aux=True)(
                    params, tables, batch_stats, b, True)
            updates, opt_state = opt.update(grads, opt_state)
            params, tables = optax.apply_updates((params, tables), updates)
            return params, tables, bs, opt_state, loss

        @jax.jit
        def predict(params, tables, batch_stats, b):
            _, (_, logits) = loss_fn(params, tables, batch_stats, b, False)
            return logits

        def eval_auc():
            scores, labels = [], []
            for b in eval_batches:
                scores.append(np.asarray(
                    predict(params, tables, batch_stats, b)))
                labels.append(b["label"])
            return _rank_auc(np.concatenate(scores), np.concatenate(labels))

        stream = SyntheticBehavior(batch_size=args.batch_size, seed=1)
        t0 = time.time()
        curve = []
        for i, b in enumerate(stream.take(args.steps), start=1):
            params, tables, batch_stats, opt_state, loss = step(
                params, tables, batch_stats, opt_state, b)
            if i % args.eval_every == 0 or i == args.steps:
                auc = eval_auc()
                curve.append((i, round(auc, 4)))
                print(json.dumps({"arm": arm, "step": i,
                                  "loss": float(loss), "eval_auc": auc,
                                  "elapsed_s": round(time.time() - t0, 1)}),
                      flush=True)
        return curve

    out = {}
    for arm in ("planted", "random"):
        out[arm] = run_arm(arm)
    print(json.dumps({"model": args.model, "curves": out,
                      "ceilings": {"bias_only": 0.635,
                                   "bias_repeat_floor": 0.669,
                                   "observable": 0.775, "bayes": 0.821}}))


if __name__ == "__main__":
    main()
