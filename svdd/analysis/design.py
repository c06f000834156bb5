"""Directed-evolution sequence designers.

Rebuild of the reference design.py (reference design.py):
greedy ISM evolution (evolve:21-218) and the Ledidi continuous-
relaxation optimizer (ledidi:221-400).

Design: each evolution round scores ALL single-base mutants in one
batched forward (ism_predict); Ledidi is a jitted optax loop over
logits with a straight-through categorical sample.
"""

from __future__ import annotations

from typing import Callable, List, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

Array = jnp.ndarray
PredictFn = Callable[[Array], Array]


def evolve(predict_fn: PredictFn, onehot: Array, rounds: int = 10,
           maximize: bool = True) -> Tuple[Array, List[float]]:
  """Greedy directed evolution (design.py evolve:21-218): each round,
  take the single-base substitution with the best predicted score."""
  from svdd.analysis.interpret import ism_predict
  history = [float(predict_fn(onehot[None])[0])]
  best = onehot
  for _ in range(rounds):
    ism = ism_predict(predict_fn, best)           # (L, 4)
    flat = np.asarray(ism).reshape(-1)
    idx = int(flat.argmax() if maximize else flat.argmin())
    l, b = divmod(idx, 4)
    cand_score = flat[idx]
    if maximize and cand_score <= history[-1]:
      break
    if not maximize and cand_score >= history[-1]:
      break
    best = best.at[l].set(jax.nn.one_hot(b, 4))
    history.append(float(cand_score))
  return best, history


def ledidi(predict_fn: PredictFn, onehot: Array, target: float,
           key: jax.Array, steps: int = 200, lr: float = 0.1,
           l: float = 0.01) -> Tuple[Array, List[float]]:
  """Ledidi-style design (design.py ledidi:221-400): optimize input
  logits so a straight-through categorical draw hits ``target`` while
  penalizing edits from the seed sequence.

  loss = (pred - target)^2 + l * n_edits(soft)
  """
  logits0 = 10.0 * onehot

  def sample_st(logits, k):
    g = jax.random.gumbel(k, logits.shape)
    soft = jax.nn.softmax(logits + g, axis=-1)
    hard = jax.nn.one_hot(jnp.argmax(soft, -1), 4, dtype=soft.dtype)
    return soft + jax.lax.stop_gradient(hard - soft)

  def loss_fn(logits, k):
    x = sample_st(logits, k)
    pred = predict_fn(x[None])[0]
    edits = jnp.sum((1 - onehot) * jax.nn.softmax(logits, -1))
    return (pred - target) ** 2 + l * edits

  opt = optax.adam(lr)
  opt_state = opt.init(logits0)

  @jax.jit
  def step(logits, opt_state, k):
    loss, g = jax.value_and_grad(loss_fn)(logits, k)
    updates, opt_state = opt.update(g, opt_state)
    return optax.apply_updates(logits, updates), opt_state, loss

  logits = logits0
  history = []
  for i in range(steps):
    key, sub = jax.random.split(key)
    logits, opt_state, loss = step(logits, opt_state, sub)
    history.append(float(loss))
  final = jax.nn.one_hot(jnp.argmax(logits, -1), 4)
  return final, history
