"""Shared utilities: logging, RNG plumbing, LR schedules, samplers.

Counterpart of the reference's utils.py (rank-zero logger
:96-111, CosineDecayWarmupLRScheduler :39, straight-through samplers
:137-215) minus the fsspec/lightning machinery that has no JAX analogue.
"""

from __future__ import annotations

import logging
from typing import Iterator

import jax
import jax.numpy as jnp
import optax


def enable_compile_cache() -> None:
  """Turn on JAX's persistent compile cache.

  When JAX_COMPILATION_CACHE_DIR is set, JAX already uses exactly that
  directory and nothing is changed here. Otherwise the cache lives at
  <checkout>/.jax_cache, a fixed path so later processes hit it."""
  import os
  if os.environ.get('JAX_COMPILATION_CACHE_DIR'):
    return
  checkout = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
  jax.config.update('jax_compilation_cache_dir',
                    os.path.join(checkout, '.jax_cache'))


def parse_m_schedule(spec):
  """Parse a scheduled-M spec "96:10,32:4" into ((96, 10), (32, 4)).

  One validated parser shared by the decode CLIs, bench, and the demo
  pipeline (previously four copy-pasted parsers whose typos surfaced
  only as opaque unpack errors at trace time). None/'' -> None."""
  if not spec:
    return None
  phases = []
  for part in str(spec).split(','):
    pieces = part.split(':')
    if len(pieces) != 2:
      raise ValueError(
          f'm_schedule phase {part!r} must be "steps:M" (got {spec!r})')
    n, m = (int(v) for v in pieces)
    if n < 1 or m < 1:
      raise ValueError(f'm_schedule phase {part!r}: steps and M must '
                       'be >= 1')
    phases.append((n, m))
  return tuple(phases)


def get_logger(name: str = 'svdd') -> logging.Logger:
  """Process-zero-only logger (utils.py:96-111 is rank-zero via
  lightning; here process_index gates it)."""
  logger = logging.getLogger(name)
  if not logger.handlers:
    handler = logging.StreamHandler()
    handler.setFormatter(logging.Formatter(
        '[%(asctime)s %(name)s %(levelname)s] %(message)s'))
    logger.addHandler(handler)
    logger.setLevel(logging.INFO if jax.process_index() == 0
                    else logging.WARNING)
  return logger


def print_nans(x: jnp.ndarray, name: str) -> jnp.ndarray:
  """Debug-callback NaN reporter (utils.py:34-36). No-op on clean data;
  safe under jit."""
  def _report(has_nan):
    if has_nan:
      print(f'{name} contains NaNs')
  jax.debug.callback(_report, jnp.isnan(x).any())
  return x


def key_iter(seed: int) -> Iterator[jax.Array]:
  """Infinite stream of fresh PRNG keys."""
  key = jax.random.key(seed)
  while True:
    key, sub = jax.random.split(key)
    yield sub


def constant_warmup_schedule(lr: float, warmup_steps: int) -> optax.Schedule:
  """transformers.get_constant_schedule_with_warmup equivalent
  (configs_gosai/lr_scheduler/constant_warmup.yaml)."""
  return optax.join_schedules(
      [optax.linear_schedule(0.0, lr, warmup_steps),
       optax.constant_schedule(lr)],
      [warmup_steps])


def cosine_decay_warmup_schedule(lr: float, warmup_steps: int,
                                 total_steps: int,
                                 lr_min: float = 1e-6,
                                 warmup_lr_init: float = 1e-6
                                 ) -> optax.Schedule:
  """timm CosineLRScheduler equivalent with warmup_prefix=True
  (utils.py:39-93; configs_gosai/lr_scheduler/cosine_decay_warmup.yaml)."""
  return optax.join_schedules(
      [optax.linear_schedule(warmup_lr_init, lr, warmup_steps),
       optax.cosine_decay_schedule(
           lr, max(total_steps - warmup_steps, 1), alpha=lr_min / lr)],
      [warmup_steps])


def token_cosine_lr_mult(tokens: jnp.ndarray, warmup_tokens: float,
                         final_tokens: float) -> jnp.ndarray:
  """Token-based warmup + cosine decay multiplier used by the value-net
  trainer (trainer.py:211-223): linear warmup to 1, cosine decay
  floored at 0.1."""
  warm = tokens / jnp.maximum(warmup_tokens, 1.0)
  progress = (tokens - warmup_tokens) / jnp.maximum(
      final_tokens - warmup_tokens, 1.0)
  decay = jnp.maximum(0.1, 0.5 * (1.0 + jnp.cos(jnp.pi * progress)))
  return jnp.where(tokens < warmup_tokens, warm, decay)


# --- Straight-through / relaxed samplers (utils.py:118-215) -----------------


def gumbel_softmax(key: jax.Array, logits: jnp.ndarray,
                   temperature: float = 1.0, hard: bool = True
                   ) -> jnp.ndarray:
  """Gumbel-softmax with straight-through hard sampling
  (utils.py GumbelSampler:183-205)."""
  g = jax.random.gumbel(key, logits.shape)
  y_soft = jax.nn.softmax((logits + g) / temperature, axis=-1)
  if not hard:
    return y_soft
  idx = jnp.argmax(y_soft, axis=-1)
  y_hard = jax.nn.one_hot(idx, logits.shape[-1], dtype=y_soft.dtype)
  return y_soft + jax.lax.stop_gradient(y_hard - y_soft)


def topk_mask_st(logits: jnp.ndarray, k: int) -> jnp.ndarray:
  """Straight-through top-k mask (utils.py TopKSampler:137-160)."""
  kth = jnp.sort(logits, axis=-1)[..., -k][..., None]
  hard = (logits >= kth).astype(logits.dtype)
  soft = jax.nn.sigmoid(logits)
  return soft + jax.lax.stop_gradient(hard - soft)


def binary_discretization_st(z: jnp.ndarray) -> jnp.ndarray:
  """Sign with straight-through gradient (noise_schedule.py:31-34)."""
  z_hard = jnp.sign(z)
  z_soft = z / jnp.linalg.norm(z, axis=-1, keepdims=True)
  return z_soft + jax.lax.stop_gradient(z_hard - z_soft)


def topk_gamma_noise(key: jax.Array, shape, k: int,
                     gamma_tau: float = 1.0,
                     num_betas: int = 10) -> jnp.ndarray:
  """Sum-of-scaled-Gammas perturbation for relaxed top-k sampling
  (utils.py TopKSampler._sampling_noise:145-156)."""
  import math as _math
  g = jax.random.gamma(key, 1.0 / k, (num_betas,) + tuple(shape))
  beta = k / jnp.arange(1, num_betas + 1, dtype=jnp.float32)
  s = (g / beta[:, None, None]).sum(axis=0) - _math.log(10.0)
  return gamma_tau * (s / k)


def binary_sample_st(key: jax.Array, probs: jnp.ndarray) -> jnp.ndarray:
  """Relaxed Bernoulli with straight-through hard sample
  (utils.py BinarySampler:205-218)."""
  k1, k2 = jax.random.split(key)
  pos = jax.random.gumbel(k1, probs.shape)
  neg = jax.random.gumbel(k2, probs.shape)
  del_noise_exp = jnp.exp(neg - pos)
  hard = (probs * (1 + del_noise_exp) > 1).astype(probs.dtype)
  soft = probs / (probs + (1 - probs) * del_noise_exp)
  return soft + jax.lax.stop_gradient(hard - soft)


def gaussian_sample(key: jax.Array, x: jnp.ndarray) -> jnp.ndarray:
  """Reparameterized gaussian from concatenated (mu, pre-softplus var)
  (utils.py GaussianSampler:221-229)."""
  n = x.shape[-1] // 2
  mu = x[..., :n]
  sigma = jnp.sqrt(jax.nn.softplus(x[..., n:]))
  return mu + sigma * jax.random.normal(key, mu.shape)
