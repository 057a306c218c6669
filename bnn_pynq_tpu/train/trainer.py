"""Optax training loop (SURVEY.md C13 `binary_net.train` rebuilt).

Reference recipe reproduced: squared hinge loss, Adam, exponential LR
decay from lr_start to lr_end over the epoch budget, hard weight clipping
to [-1,1] after each update, optional Glorot LR scaling for quantized
kernels, best-validation checkpointing to .npz.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np
import optax
from flax import traverse_util

from bnn_pynq_tpu.models.config import NetworkConfig
from bnn_pynq_tpu.train import data as data_mod
from bnn_pynq_tpu.train.model import QuantNet


# Reference training recipes (SURVEY.md C13 «bnn/src/training/{mnist,
# cifar10,svhn,gtsrb}.py», BinaryNet conventions; epoch counts/LRs are the
# published BNN-paper schedules — confidence [M], tune when real data is
# wired in). Keys match NetworkConfig.dataset.
TRAINING_PRESETS = {
    "mnist": dict(epochs=1000, batch_size=100, lr_start=3e-3, lr_end=3e-7),
    "cifar10": dict(epochs=500, batch_size=50, lr_start=1e-3, lr_end=1e-6),
    "svhn": dict(epochs=200, batch_size=50, lr_start=1e-3, lr_end=1e-6),
    "gtsrb": dict(epochs=200, batch_size=50, lr_start=1e-3, lr_end=1e-6),
}


def preset_for(config: NetworkConfig) -> dict:
    return dict(TRAINING_PRESETS.get(config.dataset,
                                     dict(epochs=100, batch_size=100,
                                          lr_start=1e-3, lr_end=1e-6)))


@dataclass
class TrainResult:
    params: Any
    batch_stats: Any
    history: list = field(default_factory=list)
    best_val_acc: float = 0.0


def squared_hinge_loss(logits, labels, num_classes: int):
    """Multi-class squared hinge on ±1 targets (the reference's loss)."""
    t = 2.0 * jax.nn.one_hot(labels, num_classes) - 1.0
    return jnp.mean(jnp.square(jnp.maximum(0.0, 1.0 - t * logits)))


def _is_quant_kernel(path) -> bool:
    return any(str(p).startswith("quant_") for p in path) and \
        str(path[-1]) == "kernel"


def _glorot_scale_tree(params):
    """Per-kernel LR multiplier 1/sqrt(1.5/(fan_in+fan_out)) (BinaryNet's
    W_LR_scale='Glorot' convention)."""
    flat = traverse_util.flatten_dict(params)
    scales = {}
    for path, leaf in flat.items():
        if _is_quant_kernel(path):
            if leaf.ndim == 2:
                fan_in, fan_out = leaf.shape
            else:
                kh, kw, cin, cout = leaf.shape
                fan_in, fan_out = kh * kw * cin, kh * kw * cout
            scales[path] = float(1.0 / np.sqrt(1.5 / (fan_in + fan_out)))
        else:
            scales[path] = 1.0
    return traverse_util.unflatten_dict(scales)


def make_train_step(config: NetworkConfig, model: QuantNet, tx):
    return jax.jit(_make_raw_step(config, model, tx))


def make_epoch_fn(config: NetworkConfig, model: QuantNet, tx,
                  steps_per_epoch: int, batch_size: int):
    """One jitted `lax.scan` over a whole epoch — ONE dispatch per epoch
    with the dataset DEVICE-RESIDENT and the shuffle computed on device
    (`jax.random.permutation` from a per-epoch key): no per-step Python
    dispatch and no per-epoch host shuffle re-upload, so the reference's
    per-minibatch Theano loop («binary_net.py train», C13) maps to
    scan-over-device-data, not a Python loop. Same ops per step as
    make_train_step."""
    step = _make_raw_step(config, model, tx)
    n_scan = steps_per_epoch * batch_size

    @jax.jit
    def epoch(params, batch_stats, opt_state, x_all, y_all, key):
        perm = jax.random.permutation(key, x_all.shape[0])[:n_scan]
        xs = x_all[perm].reshape((steps_per_epoch, batch_size)
                                 + x_all.shape[1:])
        ys = y_all[perm].reshape(steps_per_epoch, batch_size)

        def body(carry, batch):
            p, bs, os_ = carry
            x, y = batch
            p, bs, os_, loss = step(p, bs, os_, x, y)
            return (p, bs, os_), loss
        (params, batch_stats, opt_state), losses = jax.lax.scan(
            body, (params, batch_stats, opt_state), (xs, ys))
        return params, batch_stats, opt_state, losses

    return epoch


def _make_raw_step(config: NetworkConfig, model: QuantNet, tx):
    """The un-jitted step body (shared by make_train_step's jit and the
    epoch scan)."""
    def step(params, batch_stats, opt_state, x, y):
        def loss_fn(p):
            out, updates = model.apply(
                {"params": p, "batch_stats": batch_stats}, x, train=True,
                mutable=["batch_stats"])
            loss = squared_hinge_loss(out, y, config.num_classes)
            return loss, updates["batch_stats"]

        (loss, new_stats), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        # Hard clip quantized kernels to [-1, 1] (reference weight clip).
        flat = traverse_util.flatten_dict(params)
        flat = {k: (jnp.clip(v, -1.0, 1.0) if _is_quant_kernel(k) else v)
                for k, v in flat.items()}
        params = traverse_util.unflatten_dict(flat)
        return params, new_stats, opt_state, loss
    return step


def make_eval_fn(config: NetworkConfig, model: QuantNet):
    @jax.jit
    def logits_fn(params, batch_stats, x):
        return model.apply({"params": params, "batch_stats": batch_stats},
                           x, train=False)
    return logits_fn


def evaluate(config, model, params, batch_stats, x, y, batch_size=1024,
             logits_fn=None):
    """logits_fn: pass make_eval_fn(config, model) when calling in a loop
    — building it here creates a FRESH jit closure each call, which
    recompiles every time."""
    if logits_fn is None:
        logits_fn = make_eval_fn(config, model)
    correct = 0
    for i in range(0, len(x), batch_size):
        out = logits_fn(params, batch_stats, x[i:i + batch_size])
        correct += int((np.argmax(np.asarray(out), -1) == y[i:i + batch_size]).sum())
    return correct / len(x)


def train(config: NetworkConfig, dataset=None, *, epochs: int = 10,
          batch_size: int = 100, lr_start: float = 1e-3,
          lr_end: float = 1e-6, glorot_lr_scale: bool = True,
          seed: int = 0, checkpoint_path: Optional[str] = None,
          log_every: int = 0, max_train: Optional[int] = None,
          resume_from: Optional[str] = None) -> TrainResult:
    """Train a quantized network; returns best-validation params.

    `resume_from`: warm-start params/batch_stats from a prior .npz
    checkpoint (SURVEY.md §5.4 checkpoint/resume)."""
    if dataset is None:
        dataset = data_mod.load(config.dataset)
    x_train = data_mod.train_inputs(config.dataset, dataset.x_train,
                                    config.input_kind)
    x_test = data_mod.train_inputs(config.dataset, dataset.x_test,
                                   config.input_kind)
    y_train, y_test = dataset.y_train, dataset.y_test
    if max_train:
        x_train, y_train = x_train[:max_train], y_train[:max_train]

    model = QuantNet(config)
    rng = jax.random.PRNGKey(seed)
    variables = model.init(rng, x_train[:2], train=False)
    params, batch_stats = variables["params"], variables["batch_stats"]
    if resume_from:
        params, batch_stats, _ = load_checkpoint(resume_from)

    # fewer images than batch_size → one step over everything (the old
    # Python-slice loop clamped implicitly; the epoch scan's reshape
    # needs the clamp explicit)
    batch_size = min(batch_size, len(x_train))
    steps_per_epoch = max(1, len(x_train) // batch_size)
    total_steps = epochs * steps_per_epoch
    schedule = optax.exponential_decay(
        lr_start, total_steps, lr_end / lr_start)
    tx = optax.adam(schedule)
    if glorot_lr_scale:
        tx = optax.chain(tx, _per_leaf_scale(_glorot_scale_tree(params)))
    opt_state = tx.init(params)

    epoch_fn = make_epoch_fn(config, model, tx, steps_per_epoch, batch_size)
    eval_fn = make_eval_fn(config, model)   # ONE jit closure for all epochs

    # dataset lives on device for the whole run; the per-epoch shuffle is
    # a device-side permutation (no re-upload from the host)
    x_dev = jax.device_put(x_train)
    y_dev = jax.device_put(np.asarray(y_train, np.int32))
    shuffle_key = jax.random.PRNGKey(seed + 1)

    best = TrainResult(params=params, batch_stats=batch_stats)
    for epoch in range(epochs):
        params, batch_stats, opt_state, losses = epoch_fn(
            params, batch_stats, opt_state, x_dev, y_dev,
            jax.random.fold_in(shuffle_key, epoch))
        losses = np.asarray(jax.device_get(losses), np.float32)
        val_acc = evaluate(config, model, params, batch_stats, x_test,
                           y_test, logits_fn=eval_fn)
        best.history.append({"epoch": epoch, "loss": float(np.mean(losses)),
                             "val_acc": val_acc})
        if log_every and (epoch % log_every == 0 or epoch == epochs - 1):
            print(f"[{config.name}] epoch {epoch}: loss={np.mean(losses):.4f} "
                  f"val_acc={val_acc:.4f}")
        if val_acc >= best.best_val_acc:
            # in-memory best holds device refs (free); the npz WRITE
            # (device_get of all params + file IO) only happens on strict
            # improvement so an accuracy plateau doesn't pay it every
            # epoch
            improved = val_acc > best.best_val_acc
            best.best_val_acc = val_acc
            best.params = params
            best.batch_stats = batch_stats
            if checkpoint_path and (improved or epoch == 0):
                save_checkpoint(checkpoint_path, params, batch_stats,
                                meta={"val_acc": val_acc, "epoch": epoch,
                                      "config": config.name})
    return best


def _per_leaf_scale(scales_tree):
    """optax transform multiplying updates by a static per-leaf scale."""
    def init_fn(params):
        return optax.EmptyState()

    def update_fn(updates, state, params=None):
        flat_u = traverse_util.flatten_dict(updates)
        flat_s = traverse_util.flatten_dict(scales_tree)
        out = {k: v * flat_s.get(k, 1.0) for k, v in flat_u.items()}
        return traverse_util.unflatten_dict(out), state

    return optax.GradientTransformation(init_fn, update_fn)


# --------------------------------------------------------------------------
# Checkpointing (.npz, the reference's format — SURVEY.md §5.4)
# --------------------------------------------------------------------------

def save_checkpoint(path: str, params, batch_stats, meta: Dict = None):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = {"params/" + "/".join(map(str, k)): np.asarray(v)
            for k, v in traverse_util.flatten_dict(dict(params)).items()}
    flat.update({"batch_stats/" + "/".join(map(str, k)): np.asarray(v)
                 for k, v in
                 traverse_util.flatten_dict(dict(batch_stats)).items()})
    if meta:
        flat.update({f"meta/{k}": np.asarray(v) for k, v in meta.items()})
    np.savez(path, **flat)


def load_checkpoint(path: str):
    z = np.load(path, allow_pickle=False)
    params, batch_stats, meta = {}, {}, {}
    for key in z.files:
        kind, _, rest = key.partition("/")
        if kind == "params":
            params[tuple(rest.split("/"))] = z[key]
        elif kind == "batch_stats":
            batch_stats[tuple(rest.split("/"))] = z[key]
        else:
            meta[rest] = z[key]
    return (traverse_util.unflatten_dict(params),
            traverse_util.unflatten_dict(batch_stats), meta)
