"""Sparse optimizers for EmbeddingVariable rows.

Rebuild of DeepRec's EV optimizer kernels
(tensorflow/core/kernels/training_ali_ops.cc — KvSparseApplyAdagradOp:62,
SparseApplyAdagradDecayOp:495, KvSparseApplyAdamOp:848,
KvSparseApplyAdamAsyncOp:1404, KvSparseApplyFtrlOp:167,
KvResourceSparseApplyGradientDescentOp:1598) and the Python optimizer EV
branches (python/training/{adagrad,adagrad_decay,adam,adam_async,ftrl}.py).

Semantics:
  * updates are applied to **deduplicated** rows — gradients for repeated
    ids are pre-summed by autodiff through the gather/inverse indexing
    (DeepRec dedups inside the kernel via its per-key loop).
  * non-admitted keys are skipped (the ``is_filter`` check,
    training_ali_ops.cc:124-133) — their freq still advanced at lookup.
  * optimizer slot rows live in arrays parallel to ``values`` and share row
    lifetime with the primary (slot_creator.py:82-115): eviction/growth
    permutations from ``embedding_var.shrink``/``grow`` must be applied via
    :func:`permute_slot_state`.

All updaters are pure: ``(values, slot_state, slots, grads, mask, step,
cur_rows=None) -> (values, slot_state)`` with scatter writes that drop
masked rows by indexing one past the null row (out-of-bounds scatter with
mode='drop'). ``cur_rows`` supplies the *effective* current rows when the
store uses lazy initialisation (embedding_var.gather): created rows hold
zeros in the store but their logical value is the deterministic init, and
the write-back below persists init+update in one scatter.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from ..sparse import embedding_var as ev_mod

Schedule = Union[float, Callable[[jax.Array], jax.Array]]


def _lr_at(lr: Schedule, step: jax.Array) -> jax.Array:
    return jnp.asarray(lr(step) if callable(lr) else lr, jnp.float32)


class SparseOptimizer(NamedTuple):
    name: str
    init: Callable[[jax.Array], Any]          # values [cap+1, dim] -> slot pytree
    apply: Callable[..., tuple]               # see module docstring
    # Per-leaf initial fill values, same structure as init's pytree (python
    # scalars). Invariant: *unclaimed* slot rows always hold these fills —
    # rebuilds (grow/shrink) must re-fill vacated rows with them, not zeros,
    # or a row claimed later starts from acc=0 (rsqrt(0) = inf -> NaN on a
    # zero gradient, and a wrong first-update magnitude otherwise).
    fills: Any = ()


def _dest(slots: jax.Array, mask: jax.Array, nrows: int) -> jax.Array:
    """Scatter destination: masked-out rows index out of bounds (dropped)."""
    return jnp.where(mask, slots, nrows)


def _scatter_set(arr: jax.Array, dest: jax.Array, rows: jax.Array) -> jax.Array:
    # dest is unique by construction (deduped admitted slots; masked rows
    # out of bounds) -> XLA's parallel scatter, not the serial fallback
    return arr.at[dest].set(rows.astype(arr.dtype), mode="drop",
                            unique_indices=True)


# ---------------------------------------------------------------------------


def sparse_sgd(learning_rate: Schedule = 0.01) -> SparseOptimizer:
    """KvResourceSparseApplyGradientDescent (training_ali_ops.cc:1598)."""

    def init(values):
        return ()

    def apply(values, slot_state, slots, grads, mask, step,
              cur_rows=None, created=None):
        lr = _lr_at(learning_rate, step)
        dest = _dest(slots, mask, values.shape[0])
        cur = cur_rows if cur_rows is not None else values[slots]
        new = cur - lr * grads.astype(cur.dtype)
        return _scatter_set(values, dest, new), slot_state

    return SparseOptimizer("sgd", init, apply, fills=())


def sparse_adagrad(learning_rate: Schedule = 0.05,
                   initial_accumulator_value: float = 0.1) -> SparseOptimizer:
    """KvSparseApplyAdagrad (training_ali_ops.cc:62): a += g²;
    v -= lr·g·rsqrt(a)."""

    def init(values):
        return {"acc": jnp.full(values.shape, initial_accumulator_value, jnp.float32)}

    def apply(values, slot_state, slots, grads, mask, step,
              cur_rows=None, created=None):
        lr = _lr_at(learning_rate, step)
        dest = _dest(slots, mask, values.shape[0])
        g = grads.astype(jnp.float32)
        acc0 = slot_state["acc"][slots]
        if created is not None:
            # rows claimed this step logically start at the init accumulator
            # regardless of what the (rebuild-filled) store holds
            acc0 = jnp.where(created[:, None],
                             np.float32(initial_accumulator_value), acc0)
        acc = acc0 + g * g
        cur = (cur_rows if cur_rows is not None
               else values[slots]).astype(jnp.float32)
        new = cur - lr * g * jax.lax.rsqrt(acc)
        return (
            _scatter_set(values, dest, new),
            {"acc": _scatter_set(slot_state["acc"], dest, acc)},
        )

    return SparseOptimizer("adagrad", init, apply,
                           fills={"acc": initial_accumulator_value})


def sparse_adagrad_decay(
    learning_rate: Schedule = 0.05,
    initial_accumulator_value: float = 0.1,
    accumulator_decay_step: int = 10000,
    accumulator_decay_rate: float = 0.9,
    accumulator_baseline: float = 1e-7,
) -> SparseOptimizer:
    """AdagradDecay (reference python/training/adagrad_decay.py +
    KvSparseApplyAdagradDecayOp, training_ali_ops.cc:703): the accumulator is
    periodically discounted — every ``accumulator_decay_step`` global steps
    it is multiplied by ``accumulator_decay_rate`` with a floor at
    ``accumulator_baseline`` — so month-long incremental training doesn't
    freeze the effective lr. Sparse rows decay lazily: each row catches up
    on the decay periods it missed since its last update."""

    def init(values):
        return {
            "acc": jnp.full(values.shape, initial_accumulator_value, jnp.float32),
            "last_period": jnp.zeros((values.shape[0],), jnp.int32),
        }

    def apply(values, slot_state, slots, grads, mask, step,
              cur_rows=None, created=None):
        lr = _lr_at(learning_rate, step)
        dest = _dest(slots, mask, values.shape[0])
        g = grads.astype(jnp.float32)
        period = (jnp.asarray(step, jnp.int32) // accumulator_decay_step)
        last = slot_state["last_period"][slots]
        n = jnp.maximum(period - last, 0).astype(jnp.float32)
        decay = jnp.power(accumulator_decay_rate, n)[..., None]
        acc0 = slot_state["acc"][slots]
        if created is not None:
            acc0 = jnp.where(created[:, None],
                             np.float32(initial_accumulator_value), acc0)
        acc = jnp.maximum(acc0 * decay, accumulator_baseline)
        acc = acc + g * g
        cur = (cur_rows if cur_rows is not None
               else values[slots]).astype(jnp.float32)
        new = cur - lr * g * jax.lax.rsqrt(acc)
        return (
            _scatter_set(values, dest, new),
            {
                "acc": _scatter_set(slot_state["acc"], dest, acc),
                "last_period": slot_state["last_period"].at[dest].set(period, mode="drop"),
            },
        )

    return SparseOptimizer("adagrad_decay", init, apply,
                           fills={"acc": initial_accumulator_value,
                                  "last_period": 0})


def sparse_adam(
    learning_rate: Schedule = 0.001,
    beta1: float = 0.9,
    beta2: float = 0.999,
    epsilon: float = 1e-8,
) -> SparseOptimizer:
    """KvSparseApplyAdam (training_ali_ops.cc:848). Bias correction uses the
    global step (β powers derived from ``step``, as the EV branch passes
    global_step into the kernel)."""

    def init(values):
        # distinct buffers (donation-safety)
        return {"m": jnp.zeros(values.shape, jnp.float32),
                "v": jnp.zeros(values.shape, jnp.float32)}

    def apply(values, slot_state, slots, grads, mask, step,
              cur_rows=None, created=None):
        lr = _lr_at(learning_rate, step)
        t = jnp.asarray(step, jnp.float32) + 1.0
        b1p = jnp.power(beta1, t)
        b2p = jnp.power(beta2, t)
        alpha = lr * jnp.sqrt(1.0 - b2p) / (1.0 - b1p)
        g = grads.astype(jnp.float32)
        dest = _dest(slots, mask, values.shape[0])
        m = beta1 * slot_state["m"][slots] + (1.0 - beta1) * g
        v = beta2 * slot_state["v"][slots] + (1.0 - beta2) * g * g
        cur = (cur_rows if cur_rows is not None
               else values[slots]).astype(jnp.float32)
        new = cur - alpha * m / (jnp.sqrt(v) + epsilon)
        return (
            _scatter_set(values, dest, new),
            {"m": _scatter_set(slot_state["m"], dest, m),
             "v": _scatter_set(slot_state["v"], dest, v)},
        )

    return SparseOptimizer("adam", init, apply,
                           fills={"m": 0.0, "v": 0.0})


def sparse_adam_async(
    learning_rate: Schedule = 0.001,
    beta1: float = 0.9,
    beta2: float = 0.999,
    epsilon: float = 1e-8,
    apply_sparse_rmsprop: bool = False,
) -> SparseOptimizer:
    """AdamAsync (reference python/training/adam_async.py +
    KvSparseApplyAdamAsyncOp, training_ali_ops.cc:1404): β-power factors are
    *per-variable slots* advanced on each apply — no dependency on a global
    step, so asynchronous/elastic workers stay well-conditioned. With
    ``apply_sparse_rmsprop`` the sparse branch skips bias correction and
    uses an RMSProp-style update (the reference's fast path)."""

    def init(values):
        return {
            "m": jnp.zeros(values.shape, jnp.float32),
            "v": jnp.zeros(values.shape, jnp.float32),
            "beta1_power": jnp.asarray(beta1, jnp.float32),
            "beta2_power": jnp.asarray(beta2, jnp.float32),
        }

    def apply(values, slot_state, slots, grads, mask, step,
              cur_rows=None, created=None):
        lr = _lr_at(learning_rate, step)
        g = grads.astype(jnp.float32)
        dest = _dest(slots, mask, values.shape[0])
        cur = (cur_rows if cur_rows is not None
               else values[slots]).astype(jnp.float32)
        if apply_sparse_rmsprop:
            v = beta2 * slot_state["v"][slots] + (1.0 - beta2) * g * g
            m = beta1 * slot_state["m"][slots] + (1.0 - beta1) * g
            new = cur - lr * m * jax.lax.rsqrt(v + epsilon)
            b1p, b2p = slot_state["beta1_power"], slot_state["beta2_power"]
        else:
            b1p, b2p = slot_state["beta1_power"], slot_state["beta2_power"]
            alpha = lr * jnp.sqrt(1.0 - b2p) / (1.0 - b1p)
            m = beta1 * slot_state["m"][slots] + (1.0 - beta1) * g
            v = beta2 * slot_state["v"][slots] + (1.0 - beta2) * g * g
            new = cur - alpha * m / (jnp.sqrt(v) + epsilon)
        return (
            _scatter_set(values, dest, new),
            {
                "m": _scatter_set(slot_state["m"], dest, m),
                "v": _scatter_set(slot_state["v"], dest, v),
                "beta1_power": b1p * beta1,
                "beta2_power": b2p * beta2,
            },
        )

    return SparseOptimizer("adam_async", init, apply,
                           fills={"m": 0.0, "v": 0.0,
                                  "beta1_power": 0.0, "beta2_power": 0.0})


def sparse_ftrl(
    learning_rate: Schedule = 0.1,
    learning_rate_power: float = -0.5,
    initial_accumulator_value: float = 0.1,
    l1_regularization_strength: float = 0.0,
    l2_regularization_strength: float = 0.0,
) -> SparseOptimizer:
    """KvSparseApplyFtrl (training_ali_ops.cc:167): FTRL-proximal — the wide
    (linear) tower optimizer of WDL (modelzoo/WDL/train.py)."""

    l1 = l1_regularization_strength
    l2 = l2_regularization_strength

    def init(values):
        return {
            "accum": jnp.full(values.shape, initial_accumulator_value, jnp.float32),
            "linear": jnp.zeros(values.shape, jnp.float32),
        }

    def apply(values, slot_state, slots, grads, mask, step,
              cur_rows=None, created=None):
        lr = _lr_at(learning_rate, step)
        g = grads.astype(jnp.float32)
        dest = _dest(slots, mask, values.shape[0])
        accum = slot_state["accum"][slots]
        if created is not None:
            accum = jnp.where(created[:, None],
                              np.float32(initial_accumulator_value), accum)
        linear = slot_state["linear"][slots]
        cur = (cur_rows if cur_rows is not None
               else values[slots]).astype(jnp.float32)

        new_accum = accum + g * g
        p = -learning_rate_power
        sigma = (jnp.power(new_accum, p) - jnp.power(accum, p)) / lr
        new_linear = linear + g - sigma * cur
        quad = jnp.power(new_accum, p) / lr + 2.0 * l2
        l1_reg = jnp.clip(new_linear, -l1, l1) if l1 > 0 else jnp.zeros_like(new_linear)
        new = (l1_reg - new_linear) / quad
        if l1 > 0:
            new = jnp.where(jnp.abs(new_linear) > l1, new, 0.0)
        return (
            _scatter_set(values, dest, new),
            {"accum": _scatter_set(slot_state["accum"], dest, new_accum),
             "linear": _scatter_set(slot_state["linear"], dest, new_linear)},
        )

    return SparseOptimizer("ftrl", init, apply,
                           fills={"accum": initial_accumulator_value,
                                  "linear": 0.0})


def sparse_adagrad_fused(learning_rate: Schedule = 0.05,
                         initial_accumulator_value: float = 0.1) -> SparseOptimizer:
    """Adagrad with the accumulator stored in the values array's fused slot
    columns — the reference's ValuePtr row layout (value_ptr.h:141: primary
    and slot values share one allocation). One row gather + ONE row scatter
    per step instead of two of each (scatters are issue-bound per row).

    Pair with ``EmbeddingVariableConfig(fused_slot_columns=dim,
    fused_slot_init=initial_accumulator_value)``.
    """
    acc0 = np.float32(initial_accumulator_value)

    def init(values):
        return ()  # slot state lives inside the values array

    def apply(values, slot_state, slots, grads, mask, step,
              cur_rows=None, created=None):
        lr = _lr_at(learning_rate, step)
        g = grads.astype(jnp.float32)
        dim = g.shape[-1]
        full = values[slots]
        acc_raw = full[:, dim:].astype(jnp.float32)
        if created is not None:
            # lazy-init rows hold zeros; their logical accumulator is acc0
            acc_raw = jnp.where(created[:, None], acc0, acc_raw)
        acc = acc_raw + g * g
        cur = (cur_rows if cur_rows is not None
               else full[:, :dim]).astype(jnp.float32)
        new = cur - lr * g * jax.lax.rsqrt(acc)
        packed = jnp.concatenate([new, acc], axis=-1)
        dest = _dest(slots, mask, values.shape[0])
        return _scatter_set(values, dest, packed), slot_state

    return SparseOptimizer("adagrad_fused", init, apply, fills=())


def sparse_adam_fused(
    learning_rate: Schedule = 0.001,
    beta1: float = 0.9,
    beta2: float = 0.999,
    epsilon: float = 1e-8,
) -> SparseOptimizer:
    """Adam with m and v stored in the values array's fused slot columns
    (ValuePtr row layout, value_ptr.h:141): one row gather + one row
    scatter per step instead of three of each. β-powers are per-variable
    scalars exactly like :func:`sparse_adam_async` (adam_async.py:39).

    Pair with ``EmbeddingVariableConfig(fused_slot_columns=2*dim,
    fused_slot_init=0.0)``.
    """

    def init(values):
        return {"beta1_power": jnp.asarray(beta1, jnp.float32),
                "beta2_power": jnp.asarray(beta2, jnp.float32)}

    def apply(values, slot_state, slots, grads, mask, step,
              cur_rows=None, created=None):
        lr = _lr_at(learning_rate, step)
        g = grads.astype(jnp.float32)
        dim = g.shape[-1]
        full = values[slots]
        mv = full[:, dim:].astype(jnp.float32)
        if created is not None:
            # lazy-init rows hold zeros; logical m0 = v0 = 0 already
            mv = jnp.where(created[:, None], 0.0, mv)
        m = beta1 * mv[:, :dim] + (1.0 - beta1) * g
        v = beta2 * mv[:, dim:] + (1.0 - beta2) * g * g
        b1p = slot_state["beta1_power"]
        b2p = slot_state["beta2_power"]
        alpha = lr * jnp.sqrt(1.0 - b2p) / (1.0 - b1p)
        cur = (cur_rows if cur_rows is not None
               else full[:, :dim]).astype(jnp.float32)
        new = cur - alpha * m / (jnp.sqrt(v) + epsilon)
        packed = jnp.concatenate([new, m, v], axis=-1)
        dest = _dest(slots, mask, values.shape[0])
        return (_scatter_set(values, dest, packed),
                {"beta1_power": b1p * beta1, "beta2_power": b2p * beta2})

    return SparseOptimizer("adam_fused", init, apply,
                           fills={"beta1_power": beta1,
                                  "beta2_power": beta2})


def sparse_proximal_gradient_descent(
    learning_rate: Schedule = 0.01,
    l1_regularization_strength: float = 0.0,
    l2_regularization_strength: float = 0.0,
) -> SparseOptimizer:
    """ProximalGradientDescent (python/training/proximal_gradient_descent.py,
    kernel ApplyProximalGradientDescent): a gradient step followed by the
    l1/l2 proximal operator::

        prox = var - lr*g
        var  = sign(prox) / (1 + lr*l2) * max(|prox| - lr*l1, 0)
    """
    l1 = np.float32(l1_regularization_strength)
    l2 = np.float32(l2_regularization_strength)

    def init(values):
        return ()

    def apply(values, slot_state, slots, grads, mask, step,
              cur_rows=None, created=None):
        lr = _lr_at(learning_rate, step)
        g = grads.astype(jnp.float32)
        cur = (cur_rows if cur_rows is not None
               else values[slots]).astype(jnp.float32)
        prox = cur - lr * g
        new = (jnp.sign(prox) / (1.0 + lr * l2)
               * jnp.maximum(jnp.abs(prox) - lr * l1, 0.0))
        dest = _dest(slots, mask, values.shape[0])
        return _scatter_set(values, dest, new), slot_state

    return SparseOptimizer("proximal_gd", init, apply, fills=())


def sparse_proximal_adagrad(
    learning_rate: Schedule = 0.05,
    initial_accumulator_value: float = 0.1,
    l1_regularization_strength: float = 0.0,
    l2_regularization_strength: float = 0.0,
) -> SparseOptimizer:
    """ProximalAdagrad (python/training/proximal_adagrad.py, kernel
    SparseApplyProximalAdagrad)::

        acc += g*g;  lr_t = lr * rsqrt(acc)
        prox = var - lr_t*g
        var  = sign(prox) / (1 + lr_t*l2) * max(|prox| - lr_t*l1, 0)
    """
    l1 = np.float32(l1_regularization_strength)
    l2 = np.float32(l2_regularization_strength)

    def init(values):
        return {"acc": jnp.full(values.shape, initial_accumulator_value,
                                jnp.float32)}

    def apply(values, slot_state, slots, grads, mask, step,
              cur_rows=None, created=None):
        lr = _lr_at(learning_rate, step)
        g = grads.astype(jnp.float32)
        acc0 = slot_state["acc"][slots]
        if created is not None:
            acc0 = jnp.where(created[:, None],
                             np.float32(initial_accumulator_value), acc0)
        acc = acc0 + g * g
        lr_t = lr * jax.lax.rsqrt(acc)
        cur = (cur_rows if cur_rows is not None
               else values[slots]).astype(jnp.float32)
        prox = cur - lr_t * g
        new = (jnp.sign(prox) / (1.0 + lr_t * l2)
               * jnp.maximum(jnp.abs(prox) - lr_t * l1, 0.0))
        dest = _dest(slots, mask, values.shape[0])
        return (_scatter_set(values, dest, new),
                {"acc": _scatter_set(slot_state["acc"], dest, acc)})

    return SparseOptimizer("proximal_adagrad", init, apply,
                           fills={"acc": initial_accumulator_value})


def sparse_adagrad_decay_v2(
    learning_rate: Schedule = 0.05,
    initial_accumulator_value: float = 0.1,
    accumulator_decay_step: int = 100_000,
    accumulator_decay_rate: float = 0.9,
) -> SparseOptimizer:
    """AdagradDecayOptimizerV2 (python/training/adagrad_decay_v2.py): same
    periodic accumulator decay as V1, but the decay floor is the INITIAL
    accumulator value itself (V2 drops V1's separate baseline knob — the
    accumulator never decays below its starting point, so the effective lr
    never exceeds the initial lr)."""
    return sparse_adagrad_decay(
        learning_rate,
        initial_accumulator_value=initial_accumulator_value,
        accumulator_decay_step=accumulator_decay_step,
        accumulator_decay_rate=accumulator_decay_rate,
        accumulator_baseline=initial_accumulator_value,
    )._replace(name="adagrad_decay_v2")


def sparse_momentum(learning_rate: Schedule = 0.01, momentum: float = 0.9,
                    use_nesterov: bool = False) -> SparseOptimizer:
    def init(values):
        return {"mom": jnp.zeros(values.shape, jnp.float32)}

    def apply(values, slot_state, slots, grads, mask, step,
              cur_rows=None, created=None):
        lr = _lr_at(learning_rate, step)
        g = grads.astype(jnp.float32)
        dest = _dest(slots, mask, values.shape[0])
        mom = momentum * slot_state["mom"][slots] + g
        cur = (cur_rows if cur_rows is not None
               else values[slots]).astype(jnp.float32)
        if use_nesterov:
            new = cur - lr * (g + momentum * mom)
        else:
            new = cur - lr * mom
        return (_scatter_set(values, dest, new),
                {"mom": _scatter_set(slot_state["mom"], dest, mom)})

    return SparseOptimizer("momentum", init, apply, fills={"mom": 0.0})


def group_lasso(inner: SparseOptimizer, strength: float) -> SparseOptimizer:
    """Group-lasso proximal wrapper: after the inner update, each touched row
    is shrunk toward zero as a group — ``row ·= max(0, 1 − λ·lr/‖row‖)`` —
    driving rarely-useful embedding rows exactly to zero so L2 eviction can
    reclaim them (the sparse-regularization companion to L2WeightEvict)."""

    def init(values):
        return {"inner": inner.init(values)}

    def apply(values, slot_state, slots, grads, mask, step,
              cur_rows=None, created=None):
        values, inner_state = inner.apply(values, slot_state["inner"], slots,
                                          grads, mask, step,
                                          cur_rows=cur_rows, created=created)
        dest = _dest(slots, mask, values.shape[0])
        rows = values[slots].astype(jnp.float32)
        norm = jnp.sqrt(jnp.sum(rows * rows, axis=-1, keepdims=True))
        scale = jnp.maximum(0.0, 1.0 - strength / jnp.maximum(norm, 1e-12))
        return _scatter_set(values, dest, rows * scale), {"inner": inner_state}

    return SparseOptimizer(f"group_lasso({inner.name})", init, apply,
                           fills={"inner": inner.fills})


# ---------------------------------------------------------------------------


def permute_slot_state(slot_state, old_to_new: jax.Array, new_cap: int,
                       fills=None):
    """Carry optimizer slot rows through an eviction/growth rebuild (slots
    share row lifetime with the primary — slot_creator.py:82-115). Leaves
    whose leading dim doesn't match the row count (e.g. AdamAsync β-power
    scalars) pass through unchanged.

    ``fills`` is the optimizer's ``SparseOptimizer.fills`` pytree: vacated /
    fresh slot rows are re-filled with the optimizer's init value (adagrad
    acc = 0.1, ...), preserving the unclaimed-rows-hold-init invariant —
    zero-filling them poisons the first update of any key that later claims
    the row (rsqrt(0) on a zero gradient writes NaN)."""
    old_rows = int(old_to_new.shape[0]) + 1

    def fix(leaf, fill):
        if hasattr(leaf, "shape") and leaf.ndim >= 1 and leaf.shape[0] == old_rows:
            return ev_mod.permute_rows(leaf, old_to_new, new_cap, fill=fill)
        return leaf

    if fills is None:
        return jax.tree_util.tree_map(lambda l: fix(l, 0), slot_state)
    return jax.tree_util.tree_map(fix, slot_state, fills)


REGISTRY = {
    "sgd": sparse_sgd,
    "adagrad": sparse_adagrad,
    "adagrad_fused": sparse_adagrad_fused,
    "adagrad_decay": sparse_adagrad_decay,
    "adagrad_decay_v2": sparse_adagrad_decay_v2,
    "adam": sparse_adam,
    "adam_fused": sparse_adam_fused,
    "adam_async": sparse_adam_async,
    "ftrl": sparse_ftrl,
    "momentum": sparse_momentum,
    "proximal_gd": sparse_proximal_gradient_descent,
    "proximal_adagrad": sparse_proximal_adagrad,
}


def make(name: str, **kwargs) -> SparseOptimizer:
    return REGISTRY[name](**kwargs)
