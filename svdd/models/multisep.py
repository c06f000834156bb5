"""Time-binned multi-trunk value model (BaseModelMultiSep).

Rebuild of the reference's MultiSep variant (reference
Enformer.py:867-1102): ``n_models`` separate trunk+head pairs, each
owning a contiguous bin of diffusion timesteps
(get_model_components:1028-1051 maps step -> model index).

Design: all trunks are one vmapped parameter stack; selecting the
bin is a gather on the stacked params (lax.switch-free, so the guided
sampler can call it with a traced step index).
"""

from __future__ import annotations

from typing import Any

import flax.linen as nn
import jax
import jax.numpy as jnp

Array = jnp.ndarray


class MultiSepValueModel:
  """n_models stacked copies of a value module, binned by timestep."""

  def __init__(self, module: nn.Module, n_models: int = 10,
               num_steps: int = 128):
    self.module = module
    self.n_models = n_models
    self.num_steps = num_steps

  def init(self, rng: jax.Array, dummy: Array) -> Any:
    keys = jax.random.split(rng, self.n_models)
    return jax.vmap(lambda k: self.module.init(k, dummy))(keys)

  def model_index(self, step: Array) -> Array:
    """step in [0, num_steps) -> model bin (Enformer.py:1028-1051)."""
    bin_size = self.num_steps // self.n_models
    return jnp.clip(step // bin_size, 0, self.n_models - 1)

  def apply_at_step(self, stacked_vars: Any, onehot4: Array,
                    step: Array) -> Array:
    """Score with the trunk owning ``step`` (traced-index gather)."""
    idx = self.model_index(step)
    variables = jax.tree.map(lambda x: x[idx], stacked_vars)
    return self.module.apply(variables, onehot4)

  def apply_all(self, stacked_vars: Any, onehot4: Array) -> Array:
    """(n_models, N) scores — used by per-bin training losses."""
    return jax.vmap(
        lambda v: self.module.apply(v, onehot4))(stacked_vars)


def multisep_losses(msm: MultiSepValueModel, stacked_vars: Any,
                    states_by_step: Array, targets: Array) -> Array:
  """Per-bin MSE (BaseModelMultiSep.forward's multimodel_losses):
  states_by_step (S, B, L, 4) one-hots, targets (B,). Returns
  (n_models,) losses, each over its bin's timesteps."""
  s = states_by_step.shape[0]
  bin_size = max(1, s // msm.n_models)

  def bin_loss(model_vars, bin_idx):
    sl = jax.lax.dynamic_slice_in_dim(states_by_step,
                                      bin_idx * bin_size, bin_size, 0)
    flat = sl.reshape((-1,) + sl.shape[2:])
    preds = msm.module.apply(model_vars, flat)
    t = jnp.tile(targets, bin_size)
    return jnp.mean((preds.reshape(-1) - t) ** 2)

  return jax.vmap(bin_loss)(stacked_vars, jnp.arange(msm.n_models))
