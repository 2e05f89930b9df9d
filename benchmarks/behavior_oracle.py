"""Achievable-AUC ceilings for the synthetic behaviour stream.

DIN/DIEN's eval AUC needs its own denominator, not the *Criteo*
oracle: the behaviour stream has its own label process and its
own Bayes optimum. This script computes the denominators the modelzoo
table uses for the "% of achievable lift" column:

  1. bayes       — rank by the generator's noiseless logit (latents
                   visible). No model can beat this; the label noise is
                   additive pre-sigmoid, so E[y | everything] is monotone
                   in the clean logit.
  2. observable  — rank by the same logit with the per-example taste
                   latent replaced by its best feature-based estimate
                   (mean latent vector of the history items — history was
                   sampled by affinity with the taste, so this is the
                   natural plug-in estimator, using the generator's own
                   item vectors as "perfectly learned" embeddings). A
                   model sees only features, so this — not bayes — is the
                   practically achievable ceiling. It is a lower bound on
                   the true observable optimum E[y|features], but a tight
                   one: the remaining gap is irreducible per-example
                   taste noise.
  3. bias+repeat — drop the taste term entirely: what a model that never
                   learns co-occurrence structure tops out at.
  4. bias_only   — candidate-item hidden bias alone: the fast, purely
                   id->label signal any CTR model lifts on first. A
                   sequence model stuck at this line has learned nothing
                   from the history (the bisect line for DIN/DIEN;
                   benchmarks/sequence_fidelity.py separates architecture
                   from representation-learning speed against it).

Reference anchor: docs/Performance.md gives DCN the same treatment on the
Criteo stream (96% of achievable lift); this closes the gap for the
sequence models. Run: python benchmarks/behavior_oracle.py
"""
import sys

sys.path.insert(0, ".")

import numpy as np

from deeprec_tpu.data.behavior import SyntheticBehavior, _rank_auc


def main(n_batches: int = 50, batch_size: int = 4096, **gen_kwargs):
    gen = SyntheticBehavior(batch_size=batch_size, emit_clean_logit=True,
                            **gen_kwargs)
    iv = gen.item_vec
    scores = {"bayes": [], "observable": [], "two_tower": [],
              "bias_only": [], "bias_repeat": []}
    labels = []
    for b in gen.take(n_batches):
        labels.append(b["label"])
        scores["bayes"].append(b["_clean_logit"])
        cand = b["item"]
        hist = b["hist_item"]
        mask = hist >= 0
        # recompute the two feature-visible signals with the label
        # model's own item vectors (= a perfectly learned embedding)
        h = (cand.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)
             + np.uint64(77))
        h ^= h >> np.uint64(29)
        h *= np.uint64(0xBF58476D1CE4E5B9)
        bias = ((h >> np.uint64(40)).astype(np.float64) / (1 << 24) - 0.5) * 2
        aff = np.einsum("bd,bld->bl", iv[cand], iv[np.maximum(hist, 0)])
        aff = np.where(mask, aff, -np.inf)
        repeat = np.tanh(np.max(aff, axis=1) / 2.0)
        base = 1.2 * bias + 1.2 * repeat
        scores["bias_only"].append(1.2 * bias)
        scores["bias_repeat"].append(base)
        # taste plug-in: mean history vector, rescaled so taste_hat.cand
        # matches the scale of the true taste.cand term
        taste_hat = np.where(mask, 1.0, 0.0)[:, :, None] * iv[np.maximum(hist, 0)]
        taste_hat = taste_hat.sum(1) / np.maximum(mask.sum(1), 1)[:, None]
        t_term = np.einsum("bd,bd->b", taste_hat, iv[cand])
        t_term = t_term / max(t_term.std(), 1e-9) * np.sqrt(iv.shape[1])
        scores["observable"].append(base + 0.5 * t_term)
        # two-tower expressible: user-vector dot item-vector only — no
        # query-key interaction, so the max-affinity repeat term is out.
        # Lands at ~0.773 (vs observable 0.775): the mean-history taste
        # estimate subsumes most of the repeat signal on this stream, so
        # DSSM shares DIN/DIEN's 0.775-ish lift denominator.
        scores["two_tower"].append(1.2 * bias + 0.5 * t_term)
    y = np.concatenate(labels)
    out = {}
    for k, v in scores.items():
        out[k] = _rank_auc(np.concatenate(v), y)
        print(f"{k:12s} AUC = {out[k]:.4f}")
    return out


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-items", type=int, default=50_000)
    ap.add_argument("--n-users", type=int, default=10_000)
    ap.add_argument("--n-batches", type=int, default=50)
    a = ap.parse_args()
    main(n_batches=a.n_batches, n_items=a.n_items, n_users=a.n_users)
