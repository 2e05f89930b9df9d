"""The plain-JAX model layer: parameter layout, numerics against numpy
references, and no flax dependency.

``model_param_layout.json`` records, per modelzoo model at the settings
below, every variable path and shape of the tree the models had when they
were flax modules; checkpoints and ``checkpoint/migrate.py`` address
parameters by these paths.
"""
import importlib
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from deeprec_tpu.models import layers
from deeprec_tpu.train import cli
from deeprec_tpu.train.trainer import Trainer

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
with open(os.path.join(os.path.dirname(__file__),
                       "model_param_layout.json")) as f:
    LAYOUT = json.load(f)


@pytest.mark.parametrize("name", sorted(LAYOUT))
def test_param_tree_matches_recorded_layout(name):
    mod = importlib.import_module(f"modelzoo.{name}.train")
    args = cli.base_parser("t").parse_args([
        "--batch_size", "8", "--capacity", "1024", "--emb_dim", "4",
        "--synthetic", "--synthetic_items", "500", "--synthetic_users", "50"])
    spec = mod.build(args)
    tr = Trainer(spec.model, spec.numeric_columns, spec.collections,
                 spec.sparse_optimizers, optax.sgd(0.1), forward=spec.forward,
                 aux_loss_weight=spec.aux_loss_weight)
    state = tr.init(jax.random.key(0), next(iter(spec.train_data(args))))
    got = {"/".join(k.key for k in path): list(v.shape)
           for path, v in jax.tree_util.tree_flatten_with_path(state.params)[0]}
    assert got == LAYOUT[name]
    for path, v in jax.tree_util.tree_flatten_with_path(state.params)[0]:
        assert v.dtype == jnp.float32, path
        leaf = path[-1].key
        if leaf == "bias":
            assert not np.any(np.asarray(v)), path  # zero biases
        if leaf == "kernel":
            # LeCun normal: std ~ 1/sqrt(fan_in) (truncated at 2 sigma)
            std = float(np.std(np.asarray(v)))
            assert 0.5 < std * np.sqrt(v.shape[0]) < 1.2, (path, std)


def _relu(x):
    return np.maximum(x, 0.0)


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def _p(variables, *path):
    node = variables["params"]
    for k in path:
        node = node[k]
    return {k: np.asarray(v, np.float64) for k, v in node.items()}


def _ref_mlp(v, x):
    for i in range(2):
        d = _p(v, f"dense_{i}")
        x = _relu(x @ d["kernel"] + d["bias"])
    h = _p(v, "head")
    return x @ h["kernel"] + h["bias"]


def _ref_dot(v, f):
    F = f.shape[1]
    gram = np.einsum("bfd,bgd->bfg", f, f)
    r, c = np.tril_indices(F, -1)
    return gram[:, r, c]


def _ref_cross(v, x0):
    x = x0
    for i in range(2):
        w = _p(v, f"w_{i}")
        x = x0 * (x @ w["kernel"] + w["bias"]) + x
    return x


def _ref_fm(v, f):
    s = f.sum(1)
    return 0.5 * (s * s - (f * f).sum(1)).sum(-1, keepdims=True)


def _ref_gru_cell(p, h, x):
    zr = _sigmoid(np.concatenate([x, h], -1) @ p["gates"]["kernel"]
                  + p["gates"]["bias"])
    z, r = np.split(zr, 2, axis=-1)
    n = np.tanh(np.concatenate([x, r * h], -1) @ p["cand"]["kernel"]
                + p["cand"]["bias"])
    return z, n


def _ref_gru(v, xs, mask):
    p = {k: _p(v, "gru", "GRUCellP_0", k) for k in ("gates", "cand")}
    h = np.zeros((xs.shape[0], 5))
    out = []
    for t in range(xs.shape[1]):
        z, n = _ref_gru_cell(p, h, xs[:, t])
        h = np.where(mask[:, t, None], (1 - z) * h + z * n, h)
        out.append(h)
    return np.stack(out, 1)


def _ref_augru(v, xs, att, mask):
    p = {k: _p(v, "augru", "AUGRUCell_0", k) for k in ("gates", "cand")}
    h = np.zeros((xs.shape[0], 5))
    for t in range(xs.shape[1]):
        z, n = _ref_gru_cell(p, h, xs[:, t])
        z = att[:, t, None] * z
        h = np.where(mask[:, t, None], (1 - z) * h + z * n, h)
    return h


_rng = np.random.default_rng(0)
_x = _rng.normal(size=(6, 7)).astype(np.float32)
_f = _rng.normal(size=(6, 5, 3)).astype(np.float32)
_mask = np.arange(4)[None, :] < np.array([4, 2, 0, 3, 1, 4])[:, None]
_att = _rng.uniform(size=(6, 4)).astype(np.float32)
LAYER_CASES = {
    "MLPTower": (layers.MLPTower((8, 4), final_units=2), (_x,), _ref_mlp),
    "DotInteraction": (layers.DotInteraction(), (_f,), _ref_dot),
    "CrossNetV2": (layers.CrossNetV2(2), (_x,), _ref_cross),
    "FMInteraction": (layers.FMInteraction(), (_f,), _ref_fm),
    "GRU": (layers.GRU(5), (_f[:, :4], _mask), _ref_gru),
    "AUGRU": (layers.AUGRU(5), (_f[:, :4], _att, _mask), _ref_augru),
}


@pytest.mark.parametrize("name", sorted(LAYER_CASES))
def test_layer_matches_numpy_reference(name):
    module, inputs, ref = LAYER_CASES[name]
    args = tuple(jnp.asarray(a) for a in inputs)
    v = module.init(jax.random.key(1), *args)
    with jax.default_matmul_precision("highest"):
        got = np.asarray(module.apply(v, *args))
    want = ref(v, *(np.asarray(a, np.float64) if a.dtype != bool else a
                    for a in inputs))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_apply_mutable_returns_updates_and_leaves_input_untouched():
    """apply(..., mutable=[c]) returns (out, {c: new}) without mutating the
    caller's tree; a model without that collection returns {}."""
    d = layers.Dice()
    x = jnp.asarray(_x)
    v = d.init(jax.random.key(0), x)
    mean0 = np.asarray(v["batch_stats"]["mean"]).copy()
    out, upd = d.apply(v, x, train=True, mutable=["batch_stats"])
    assert out.shape == x.shape
    np.testing.assert_allclose(np.asarray(v["batch_stats"]["mean"]), mean0)
    np.testing.assert_allclose(
        np.asarray(upd["batch_stats"]["mean"]),
        0.99 * mean0 + 0.01 * np.asarray(x).mean(0), rtol=1e-5, atol=1e-7)
    m = layers.MLPTower((4,))
    vm = m.init(jax.random.key(0), x)
    _, upd = m.apply(vm, x, mutable=["batch_stats"])
    assert upd == {}


def test_package_and_model_inits_do_not_import_flax():
    code = (
        "import sys, jax, jax.numpy as jnp\n"
        "import deeprec_tpu\n"
        "from deeprec_tpu.models import ctr, sequence\n"
        "k = jax.random.key(0)\n"
        "d, e = jnp.ones((2, 3)), {'a': jnp.ones((2, 4)), 'b': jnp.ones((2, 4))}\n"
        "ctr.DLRM(emb_names=['a', 'b'], emb_dim=4).init(k, d, e)\n"
        "ctr.DCN(emb_names=['a', 'b']).init(k, d, e)\n"
        "seq = {'h': (jnp.ones((2, 5, 4)), jnp.ones((2, 5), bool))}\n"
        "sequence.DIEN(candidate_name='a', seq_name='h').init(\n"
        "    k, None, e, seq, return_aux=True)\n"
        "assert not [m for m in sys.modules if m.split('.')[0] == 'flax'], "
        "sorted(m for m in sys.modules if 'flax' in m)\n"
        "print('ok')\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and r.stdout.strip().endswith("ok"), r.stderr
