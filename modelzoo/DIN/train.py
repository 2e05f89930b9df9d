"""DIN trainer: attention pooling over the behaviour sequence.

Rebuild of reference modelzoo/DIN (script/model.py:11-465): the candidate
item embedding attends over the clicked-item history (DIN local activation
unit), Dice activations in the MLP. Candidate and history share the item
embedding space (shared_embedding group).
"""
import os
import sys

sys.path.insert(0, os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..")))

from deeprec_tpu import Initializer, feature_column as fc
from deeprec_tpu.models import sequence
from deeprec_tpu.train import cli

MAX_LEN = 32


def build(args) -> cli.ModelSpec:
    cols = [
        fc.EmbeddingColumn(
            fc.CategoricalColumn("item", shared_embedding="item_space"),
            args.emb_dim),
        # candidate cate and history cates SHARE rows (reference
        # shared_embedding_columns, DIN/script/train.py cat_his joins the
        # candidate's category space)
        fc.EmbeddingColumn(
            fc.CategoricalColumn("cate", shared_embedding="cate_space"),
            args.emb_dim),
        fc.EmbeddingColumn(fc.CategoricalColumn("uid"), args.emb_dim),
        fc.SequenceEmbeddingColumn(
            fc.CategoricalColumn("hist_item", max_length=MAX_LEN,
                                 shared_embedding="item_space"),
            args.emb_dim),
        fc.SequenceEmbeddingColumn(
            fc.CategoricalColumn("hist_cate", max_length=MAX_LEN,
                                 shared_embedding="cate_space"),
            args.emb_dim),
    ]
    coll = cli.collection_cls(args)(
        cols, name="emb", capacity=args.capacity,
        initializer=Initializer("normal", scale=0.05), **cli.ev_kwargs(args))
    model = sequence.DIN(
        candidate_name="item", seq_name="hist_item",
        # attention over per-position [item; cate] against [cand; cate]
        # (reference item_eb/item_his_eb concat, DIN/script/model.py:36-43)
        candidate_context_names=["cate"], seq_context_names=["hist_cate"],
        context_names=["uid"],
        hidden_units=(200, 80), att_units=(80, 40))
    return cli.ModelSpec(
        name="DIN", model=model, numeric_columns=[],
        collections={"emb": coll},
        sparse_optimizers={"emb": cli.make_sparse_opt(args)},
        train_data=cli.behavior_train_stream,
        eval_data=cli.behavior_eval_stream)


if __name__ == "__main__":
    p = cli.base_parser("DIN on behaviour data")
    # adam converges better than adagrad on the attention stack.
    # Reproducible protocol (--steps 3000 --batch_size 2048 --eval_steps
    # 40): eval AUC 0.6288 @3k, 0.6318 @6k, 0.6337 @10k (the bias-only
    # ceiling of the stream; history co-occurrence learns slower) —
    # representation-bound, not architecture-bound: with oracle item
    # vectors planted as init the same module reaches 0.770 (98% of the
    # feature-observable ceiling) in 2k steps. See
    # benchmarks/sequence_fidelity.py.
    p.set_defaults(optimizer="adam", learning_rate=0.002,
                   # behaviour sequences dedup poorly: most
                   # history ids are unique within a batch
                   max_unique_ratio=0.75)
    args = p.parse_args()
    cli.run(build(args), args)
