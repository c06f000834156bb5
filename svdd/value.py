"""Value-function API and value-network training targets (MC / CD-Q).

Replaces the reference's BaseModel wrapper (reference
Enformer.py:21-864), which owned a frozen diffusion model, a frozen
reward oracle, and self-generating training forwards. Per SURVEY.md §1
("L3 constructs L2" inversion), here the decode pipeline *composes*
(diffusion, value_fn, reward_fn) as peers; this module provides:

  ValueFunction       — a flax trunk+head bundle exposing the pure
                        score fns guidance needs
  mc_targets          — full-trajectory MC regression targets
                        (BaseModel.forward training branch,
                        Enformer.py:192-225)
  cdq_targets         — bootstrapped CD-Q targets (Enformer.py:226-259)
  value_loss          — the MSE objective (Enformer.py:54 loss_fct)
"""

from __future__ import annotations

import os
from typing import Any, Callable, NamedTuple, Optional

import flax.linen as nn
import jax
import jax.numpy as jnp

from svdd import mdlm
from svdd.models.convgru import ConvGRUValueModel
from svdd.models.enformer import EnformerValueModel

Array = jnp.ndarray


def build_value_module(task: str, model: str = 'enformer',
                       timed: bool = False, n_tasks: int = 1,
                       **kwargs) -> nn.Module:
  """Value-net factory mirroring the decode CLI's model choices
  (decode.py:73-95: enformer / multienformer / timedenformer; rna tasks
  hard-swap to ConvGRU, Enformer.py:31-50)."""
  if task in ('rna', 'rna_saluki'):
    return ConvGRUValueModel(n_tasks=n_tasks)
  # SVDD_VALUE_BF16=1 opts the Enformer value net into bf16 compute
  # (params/grads/BatchNorm stats stay f32 — flax computes norm stats
  # in f32). The decode bench path always passes compute_dtype
  # explicitly; this env default covers the CLIs and the value
  # TRAINER. Default f32 = exact reference parity (trainer.py:150-208
  # trains f32).
  if ('compute_dtype' not in kwargs
      and os.environ.get('SVDD_VALUE_BF16') == '1'):
    kwargs['compute_dtype'] = jnp.bfloat16
  if model == 'enformer':
    return EnformerValueModel(n_tasks=n_tasks, timed=timed, **kwargs)
  if model == 'timedenformer':
    return EnformerValueModel(n_tasks=n_tasks, timed=True, **kwargs)
  raise NotImplementedError(model)


class ValueFunction:
  """Bundle of (module, variables) exposing the pure functions the
  guided samplers consume. ``variables`` may include 'batch_stats'
  (Enformer conv tower BatchNorm) — frozen at scoring time."""

  def __init__(self, module: nn.Module, variables: Any,
               length: int, timed: bool = False):
    self.module = module
    self.variables = variables
    self.length = length
    self.timed = timed

  @classmethod
  def create(cls, task: str, length: int, rng: jax.Array,
             model: str = 'enformer', timed: bool = False,
             n_tasks: int = 1, **kwargs) -> 'ValueFunction':
    module = build_value_module(task, model, timed, n_tasks, **kwargs)
    dummy = jnp.zeros((1, length, 4), jnp.float32)
    if timed:
      variables = jax.jit(module.init)(
          rng, dummy, jnp.zeros((1, length), jnp.int32))
    else:
      variables = jax.jit(module.init)(rng, dummy)
    return cls(module, variables, length, timed)

  # -- pure scoring fns -----------------------------------------------------

  def score_onehot(self, onehot4: Array, variables: Any = None,
                   time_indices: Array | None = None) -> Array:
    """(N, L, 4) one-hot -> (N,) value."""
    variables = self.variables if variables is None else variables
    if self.timed:
      return self.module.apply(variables, onehot4, time_indices)
    return self.module.apply(variables, onehot4)

  def score_tokens(self, tokens: Array, variables: Any = None,
                   time_indices: Array | None = None) -> Array:
    """(N, L) int tokens (MASK rows zeroed in the one-hot) -> (N,)."""
    return self.score_onehot(mdlm.transform_samples(tokens), variables,
                             time_indices)

  def as_token_fn(self, variables: Any = None) -> Callable[[Array], Array]:
    return lambda tokens: self.score_tokens(tokens, variables)

  def as_onehot_fn(self, variables: Any = None) -> Callable[[Array], Array]:
    return lambda onehot: self.score_onehot(onehot, variables)

  # hoisted (apply_fn, variables) pairs: the samplers jit these with
  # the variables as ARGUMENTS so the net's weights never get inlined
  # as HLO constants (see Diffusion._hoist)

  def as_token_pair(self):
    module = self.module
    def apply_fn(variables, tokens):
      return module.apply(variables, mdlm.transform_samples(tokens))
    return apply_fn, self.variables

  def as_onehot_pair(self):
    module = self.module
    def apply_fn(variables, onehot):
      return module.apply(variables, onehot)
    return apply_fn, self.variables


# ---------------------------------------------------------------------------
# Training targets
# ---------------------------------------------------------------------------


def split_reward_fn(fn_or_pair):
  """Normalize a reward oracle to hoisted (apply_fn(vars, x), vars)
  form. Plain callables get empty variables; (apply_fn, variables)
  pairs (RewardOracle.as_pair) pass through — keeping oracle weights
  as jit ARGUMENTS instead of closure constants (see
  Diffusion._hoist)."""
  if isinstance(fn_or_pair, tuple):
    return fn_or_pair
  return (lambda _unused_vars, x: fn_or_pair(x)), ()


def as_reward_callable(fn_or_pair) -> Callable[[Array], Array]:
  """Eager-call form of a reward oracle (for non-jitted eval paths)."""
  apply_fn, variables = split_reward_fn(fn_or_pair)
  return lambda x: apply_fn(variables, x)


def make_reward_transform(task: str = 'dna', saluki_body=None,
                          saluki_final_length: int = 12288
                          ) -> Callable[[Array], Array]:
  """Tokens -> reward-oracle input. ``rna_saluki`` builds the padded
  (N, 12288, 6) saluki tensor; everything else the plain 4-channel
  one-hot. This is the reference's target-side branch
  (Enformer.py:142-143, 195-196): only the REWARD consumes saluki
  inputs — the value net itself always sees (N, L, 4) states."""
  if task == 'rna_saluki':
    return lambda samples: mdlm.transform_samples_saluki(
        samples, saluki_body, final_length=saluki_final_length)
  return mdlm.transform_samples


class ValueBatch(NamedTuple):
  onehots: Array   # (N, L, 4) states (all timesteps flattened)
  targets: Array   # (N,) regression targets
  time_indices: Optional[Array] = None  # (N, L) for timed models


def mc_targets(samples: Array, mid_x: Array, reward_fn,
               subsample_key: Optional[jax.Array] = None,
               num_subsample: Optional[int] = None,
               reward_transform=mdlm.transform_samples) -> ValueBatch:
  """Monte-Carlo targets: every intermediate state regresses onto the
  final sample's reward (Enformer.py:192-225).

  samples: (B, L) final tokens; mid_x: (S-1, B, L) intermediates.
  Produces S*B training pairs (S-1 mids + the final state).

  ``num_subsample`` keeps only that many RANDOM intermediate timesteps
  per iteration (equal in expectation to the reference's train-on-all-
  timesteps loss; used for the big Enformer value net where the full
  S*B grad batch does not fit in device memory).

  ``reward_transform`` (see make_reward_transform) builds the oracle's
  input from the final tokens — saluki tasks feed the (N, 12288, 6)
  tensor there while the value-net states stay 4-channel
  (Enformer.py:195-196)."""
  s_minus_1, b, l = mid_x.shape
  target = reward_fn(reward_transform(samples))          # (B,)
  if num_subsample is not None and num_subsample < s_minus_1:
    if subsample_key is None:
      raise ValueError('num_subsample requires subsample_key')
    idx = jax.random.choice(subsample_key, s_minus_1,
                            (num_subsample,), replace=False)
    mid_x = jnp.take(mid_x, idx, axis=0)
    steps = jnp.concatenate([idx, jnp.asarray([s_minus_1])])
    s_minus_1 = num_subsample
  else:
    steps = jnp.arange(s_minus_1 + 1)
  states = jnp.concatenate(
      [mid_x.reshape(-1, l), samples], axis=0)           # (S'*B, L)
  onehots = mdlm.transform_samples(states)
  targets = jnp.tile(target, s_minus_1 + 1)
  time_idx = jnp.repeat(steps, b)[:, None] * jnp.ones((1, l), jnp.int32)
  return ValueBatch(onehots, targets, time_idx)


def cdq_targets(samples: Array, mid_x: Array, all_candidates: Array,
                reward_fn, value_fn,
                reward_transform=mdlm.transform_samples) -> ValueBatch:
  """CD-Q bootstrapped targets (Enformer.py:226-259): the target for
  the state after step j is the mean value of the candidate next-states
  drawn at step j+1 (stop-gradient), and the final state regresses on
  the true reward (through ``reward_transform`` — saluki tasks build
  the 12288x6 oracle input; the bootstrap value_fn stays 4-channel).

  all_candidates: (S, B, M, L) per-step rollouts from cdq_sampler.
  """
  s, b, m, l = all_candidates.shape
  target = reward_fn(reward_transform(samples))          # (B,)

  # mean value over candidates at times 1..S-1 (skip time 0, :233-235)
  cand = all_candidates[1:].reshape((s - 1) * b * m, l)
  cand_vals = jax.lax.stop_gradient(
      value_fn(mdlm.transform_samples(cand)))
  case_avg = cand_vals.reshape(s - 1, b, m).mean(axis=-1)  # (S-1, B)

  states = jnp.concatenate([mid_x.reshape(-1, l), samples], axis=0)
  onehots = mdlm.transform_samples(states)
  targets = jnp.concatenate([case_avg.reshape(-1), target], axis=0)
  return ValueBatch(onehots, targets)


def value_loss(value_fn_onehot, batch: ValueBatch) -> Array:
  """MSE objective (Enformer.py:54, :222-225)."""
  preds = value_fn_onehot(batch.onehots)
  return jnp.mean((preds.reshape(-1) - batch.targets.reshape(-1)) ** 2)
