"""Sharded (dp × tp) training step.

Training is a float flax graph, so GSPMD partitions it: we annotate
parameter shardings (quantized kernels and the following BN vectors
sharded on the output-feature dim over 'model') and batch sharding over
'data', jit, and XLA inserts the all-reduce/all-gather collectives
(SURVEY.md §5.8).
"""

from __future__ import annotations

import jax
import numpy as np
import optax
from flax import traverse_util
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from bnn_pynq_tpu.models.config import NetworkConfig
from bnn_pynq_tpu.train.model import QuantNet
from bnn_pynq_tpu.train.trainer import make_train_step


def _param_spec(path, leaf, model_size: int) -> P:
    """Sharding rule: quant kernels on last (output) dim over 'model';
    BN per-channel vectors over 'model'; replicate anything whose
    output dim is not divisible by the model axis (e.g. the classes-wide
    final layer, matching parallel/tp.py)."""
    name = str(path[-1])
    owner = str(path[0]) if path else ""
    if owner.startswith("quant_") and name == "kernel" \
            and leaf.shape[-1] % model_size == 0:
        return P(*([None] * (leaf.ndim - 1) + ["model"]))
    if owner.startswith("bn_") and leaf.ndim == 1 \
            and leaf.shape[0] % model_size == 0:
        return P("model")
    return P()


def make_param_shardings(params, mesh: Mesh):
    model_size = mesh.shape["model"]
    flat = traverse_util.flatten_dict(params)
    specs = {k: NamedSharding(mesh, _param_spec(k, v, model_size))
             for k, v in flat.items()}
    return traverse_util.unflatten_dict(specs)


def shard_train_state(params, batch_stats, opt_state, mesh: Mesh):
    model_size = mesh.shape["model"]
    p_sh = make_param_shardings(params, mesh)
    params = jax.device_put(params, p_sh)
    # batch_stats mirror BN vectors
    bs_flat = traverse_util.flatten_dict(batch_stats)
    bs_sh = traverse_util.unflatten_dict({
        k: NamedSharding(mesh, P("model") if (v.ndim == 1 and
                                              v.shape[0] % model_size == 0)
                         else P())
        for k, v in bs_flat.items()})
    batch_stats = jax.device_put(batch_stats, bs_sh)
    # Optimizer moments are small for these nets; replicate them.
    opt_state = jax.device_put(opt_state)
    return params, batch_stats, opt_state


def make_sharded_train_step(config: NetworkConfig, mesh: Mesh, tx):
    """Jitted dp×tp train step: same math as trainer.make_train_step, with
    batch inputs sharded over 'data'."""
    model = QuantNet(config)
    base_step = make_train_step(config, model, tx)
    data_sharding = NamedSharding(mesh, P("data"))

    def step(params, batch_stats, opt_state, x, y):
        x = jax.device_put(x, data_sharding)
        y = jax.device_put(y, NamedSharding(mesh, P("data")))
        return base_step(params, batch_stats, opt_state, x, y)

    return step


def make_sharded_epoch_fn(config: NetworkConfig, mesh: Mesh, tx):
    """dp×tp analogue of trainer.make_epoch_fn: one jitted lax.scan over
    an epoch of batches with the batch dim sharded over 'data' and the
    GSPMD param shardings preserved through the carry — one dispatch per
    epoch instead of one per step (the same pattern is how multi-host
    training avoids per-step host sync).
    Takes xs [steps, batch, ...], ys [steps, batch]."""
    from bnn_pynq_tpu.train.trainer import _make_raw_step
    model = QuantNet(config)
    step = _make_raw_step(config, model, tx)

    @jax.jit
    def epoch(params, batch_stats, opt_state, xs, ys):
        def body(carry, batch):
            p, bs, os_ = carry
            x, y = batch
            p, bs, os_, loss = step(p, bs, os_, x, y)
            return (p, bs, os_), loss
        (params, batch_stats, opt_state), losses = jax.lax.scan(
            body, (params, batch_stats, opt_state), (xs, ys))
        return params, batch_stats, opt_state, losses

    data_sh = NamedSharding(mesh, P(None, "data"))

    def run(params, batch_stats, opt_state, xs, ys):
        xs = jax.device_put(np.asarray(xs), data_sh)
        ys = jax.device_put(np.asarray(ys), data_sh)
        return epoch(params, batch_stats, opt_state, xs, ys)

    return run


def init_sharded(config: NetworkConfig, mesh: Mesh, *, lr: float = 1e-3,
                 seed: int = 0, sample_input=None):
    """Initialize model + optimizer with dp×tp shardings applied."""
    model = QuantNet(config)
    if sample_input is None:
        if config.input_kind == "bipolar":
            sample_input = np.zeros(
                (2, int(np.prod(config.input_shape))), np.float32)
        else:
            sample_input = np.zeros((2,) + config.input_shape, np.float32)
    variables = model.init(jax.random.PRNGKey(seed), sample_input,
                           train=False)
    params, batch_stats = variables["params"], variables["batch_stats"]
    tx = optax.adam(lr)
    opt_state = tx.init(params)
    params, batch_stats, opt_state = shard_train_state(
        params, batch_stats, opt_state, mesh)
    return model, params, batch_stats, opt_state, tx
