"""Behaviour-stream oracle: the '% of achievable lift' denominator.

The sequence models need their own oracle, not the Criteo one; this
pins the behaviour stream's own ceilings so the modelzoo
table can state what fraction of the achievable lift DIN/DIEN capture.
"""
import numpy as np

from deeprec_tpu.data.behavior import SyntheticBehavior, _rank_auc, oracle_auc


def test_rank_auc_exact():
    # hand-checkable: 2 pos, 2 neg, one tie straddling the classes
    s = np.array([0.9, 0.1, 0.5, 0.5], np.float64)
    y = np.array([1.0, 0.0, 1.0, 0.0], np.float32)
    # pairs: (0.9,0.1)=1, (0.9,0.5)=1, (0.5,0.1)=1, (0.5,0.5)=0.5 -> 3.5/4
    assert abs(_rank_auc(s, y) - 0.875) < 1e-12


def test_oracle_beats_models_and_is_stable():
    a = oracle_auc(n_batches=8, batch_size=4096, seed=3)
    b = oracle_auc(n_batches=8, batch_size=4096, seed=4)
    # the ceiling is a property of the label process, not the sample
    assert abs(a - b) < 0.01
    # recorded value 0.821; noise=0.5 pre-sigmoid keeps
    # it far from 1.0 — a near-1.0 oracle would mean the stream lost its
    # irreducible noise and every model AUC comparison breaks
    assert 0.79 < a < 0.85


def test_clean_logit_opt_in_only():
    gen = SyntheticBehavior(batch_size=64)
    assert "_clean_logit" not in next(iter(gen))
    gen = SyntheticBehavior(batch_size=64, emit_clean_logit=True)
    b = next(iter(gen))
    assert b["_clean_logit"].shape == (64,)
    # trainers must not choke on the extra key: it is underscore-private
    assert all(not k.startswith("_") for k in b if k != "_clean_logit")


def test_ceiling_ladder_ordering():
    """The full ladder (benchmarks/behavior_oracle.py) must stay ordered:
    bayes > observable >= two_tower > bias+repeat > bias_only > 0.5 —
    the modelzoo lift columns and the fidelity-bisect verdict read these
    relationships, so a generator change that collapses the ladder must
    fail loudly here."""
    import sys
    sys.path.insert(0, ".")
    from benchmarks.behavior_oracle import main as ceilings

    c = ceilings(n_batches=6, batch_size=4096)
    assert c["bayes"] > c["observable"] >= c["two_tower"] > 0.5
    assert c["two_tower"] > c["bias_repeat"] > c["bias_only"] > 0.55
    # recorded values within sampling tolerance
    for k, v in {"bayes": 0.821, "observable": 0.775, "two_tower": 0.773,
                 "bias_repeat": 0.669, "bias_only": 0.635}.items():
        assert abs(c[k] - v) < 0.012, (k, c[k], v)
