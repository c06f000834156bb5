"""Exponential moving average of a parameter pytree.

Functional rewrite of the reference ExponentialMovingAverage
(reference models/ema.py:4-97), wired into training exactly as the
reference does (update after each optimizer step, diffusion_gosai.py:279-284;
store/copy_to/restore around eval, :1560-1579). Because parameters are
immutable pytrees in JAX, ``store/restore`` collapse to just keeping the
original pytree — ``swap`` returns the EMA params for eval and the caller
retains its own reference to the live params.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import jax
import jax.numpy as jnp


class EMAState(NamedTuple):
  decay: float
  num_updates: jnp.ndarray   # int32 scalar; negative => disabled warmup
  shadow: Any                # pytree matching params


def init(params: Any, decay: float, use_num_updates: bool = True) -> EMAState:
  if not 0.0 <= decay <= 1.0:
    raise ValueError('Decay must be between 0 and 1')
  n = jnp.asarray(0 if use_num_updates else -1, jnp.int32)
  # deep-copy so shadow never aliases the live params (aliasing breaks
  # buffer donation in the jitted train step)
  shadow = jax.tree.map(lambda x: jnp.array(x, copy=True), params)
  return EMAState(decay, n, shadow)


def update(state: EMAState, params: Any) -> EMAState:
  """shadow -= (1 - decay) * (shadow - params), with the warmup-adjusted
  decay min(decay, (1+n)/(10+n)) (models/ema.py:38-49)."""
  n = jnp.where(state.num_updates >= 0,
                state.num_updates + 1, state.num_updates)
  decay = jnp.where(
      n >= 0,
      jnp.minimum(state.decay, (1.0 + n) / (10.0 + n)),
      state.decay)
  one_minus = 1.0 - decay
  shadow = jax.tree.map(
      lambda s, p: s - one_minus * (s - p.astype(s.dtype)),
      state.shadow, params)
  return EMAState(state.decay, n, shadow)


def params(state: EMAState) -> Any:
  """The averaged parameters (``copy_to`` equivalent, models/ema.py:55-66)."""
  return state.shadow
