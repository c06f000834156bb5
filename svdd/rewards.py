"""Reward oracles.

The reference scores sequences with frozen pretrained grelu
LightningModel oracles (DNA: Enformer-architecture 3-task model,
Enformer.py:133; RNA: ConvGRU MRL model, :110) fetched from W&B
artifacts (allmodels/model_load.py). Here oracles are flax modules of
the same architectures (svdd.models.{enformer,convgru}) whose
weights come from training (train/oracle.py), orbax checkpoints, or the
torch-checkpoint importer (utils_import.py).

For tests/demos without trained weights there is a deterministic
differentiable synthetic oracle (motif-PWM scanner) so the full
value-training + guided-decoding pipeline can be exercised end-to-end
and verified to *lift* rewards.
"""

from __future__ import annotations

from typing import Any, Callable

import jax
import jax.numpy as jnp
import numpy as np

from svdd.models.convgru import ConvGRUValueModel
from svdd.models.enformer import EnformerValueModel

Array = jnp.ndarray
RewardFn = Callable[[Array], Array]   # (N, L, 4) one-hot -> (N,)


class RewardOracle:
  """A frozen scoring model: (module, variables, task_index).

  DNA oracle predicts (hepg2, k562, sknsh); decode uses index 0
  (decode.py / oracle.cal_gosai_pred:63-72 squeeze to [n, 3])."""

  def __init__(self, module, variables, task_index: int = 0):
    self.module = module
    self.variables = variables
    self.task_index = task_index

  @classmethod
  def create_dna(cls, length: int, rng: jax.Array, n_tasks: int = 3,
                 **kwargs) -> 'RewardOracle':
    module = EnformerValueModel(n_tasks=n_tasks, **kwargs)
    variables = jax.jit(module.init)(rng, jnp.zeros((1, length, 4)))
    return cls(module, variables, task_index=0)

  @classmethod
  def create_rna(cls, length: int, rng: jax.Array) -> 'RewardOracle':
    module = ConvGRUValueModel(n_tasks=1)
    variables = jax.jit(module.init)(rng, jnp.zeros((1, length, 4)))
    return cls(module, variables, task_index=0)

  @classmethod
  def create_saluki(cls, rng: jax.Array,
                    final_length: int = 12288) -> 'RewardOracle':
    """Saluki RNA-stability oracle: 6-channel ConvGRU over the padded
    12288-length input (Enformer.py:110-133; fed through
    mdlm.transform_samples_saluki)."""
    module = ConvGRUValueModel(n_tasks=1, in_channels=6)
    variables = jax.jit(module.init)(
        rng, jnp.zeros((1, final_length, 6)))
    return cls(module, variables, task_index=0)

  def __call__(self, onehot4: Array) -> Array:
    out = self.module.apply(self.variables, onehot4)
    if out.ndim == 2:
      out = out[:, self.task_index]
    return out

  def as_fn(self) -> RewardFn:
    return lambda onehot: self(onehot)

  def as_pair(self):
    """(apply_fn, variables) form — variables hoisted to jit args."""
    module, idx = self.module, self.task_index
    def apply_fn(variables, onehot):
      out = module.apply(variables, onehot)
      return out[:, idx] if out.ndim == 2 else out
    return apply_fn, self.variables


def synthetic_motif_oracle(length: int, motif: str = 'GCGC',
                           weight: float = 1.0) -> RewardFn:
  """Deterministic differentiable reward: summed PWM match score for a
  fixed motif. Used by tests to verify guided decoding lifts rewards
  without trained oracles."""
  alphabet = {'A': 0, 'C': 1, 'G': 2, 'T': 3}
  k = len(motif)
  pwm = np.full((k, 4), -0.5, np.float32)
  for i, ch in enumerate(motif):
    pwm[i, alphabet[ch]] = 1.0
  pwm_arr = jnp.asarray(pwm) * weight

  def reward(onehot4: Array) -> Array:
    # (N, L, 4) conv against (k, 4) PWM: windowed sum of match scores
    windows = jnp.stack(
        [onehot4[:, i:length - k + 1 + i, :] for i in range(k)],
        axis=2)                                   # (N, L-k+1, k, 4)
    scores = jnp.einsum('nlka,ka->nl', windows, pwm_arr)
    return jax.nn.relu(scores).sum(axis=-1) / length

  return reward


def count_kmers(seqs, k: int = 3):
  """k-mer counting over detokenized strings (oracle.py:75-85)."""
  counts: dict = {}
  for seq in seqs:
    for i in range(len(seq) - k + 1):
      sub = seq[i:i + k]
      counts[sub] = counts.get(sub, 0) + 1
  return counts
