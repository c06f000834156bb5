"""Noise schedules as pure functions of continuous time ``t in [0, 1]``.

Each schedule maps t -> (total_noise sigma(t), rate_noise dsigma(t)).
The forward (masking) process masks each token independently with
probability ``1 - exp(-sigma(t))``.

Rewrite of the reference schedule classes
(reference noise_schedule.py:13-152). Schedules here are
stateless pure functions usable inside jit/scan/vmap; there are no
learnable schedule parameters (matching the reference, whose modules
hold no trainable state either).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Tuple

import jax.numpy as jnp

Array = jnp.ndarray
ScheduleFn = Callable[[Array], Tuple[Array, Array]]


@dataclasses.dataclass(frozen=True)
class Schedule:
  """A noise schedule: callable t -> (sigma, dsigma), plus its extremes."""

  name: str
  total: Callable[[Array], Array]
  rate: Callable[[Array], Array]
  # importance-sampling change of variables u -> t (optional)
  importance_transform: Callable[[Array], Array] | None = None

  def __call__(self, t: Array) -> Tuple[Array, Array]:
    t = jnp.asarray(t)
    return self.total(t), self.rate(t)

  @property
  def sigma_max(self) -> Array:
    return self.total(jnp.asarray(1.0))

  @property
  def sigma_min(self) -> Array:
    return self.total(jnp.asarray(0.0))


def loglinear(eps: float = 1e-3) -> Schedule:
  """sigma(t) = -log1p(-(1-eps) t); masking prob = (1-eps) t.

  Default schedule for both bio tasks (reference
  noise_schedule.py:126-152; configs_gosai/noise/loglinear.yaml).
  """

  def total(t):
    return -jnp.log1p(-(1 - eps) * t)

  def rate(t):
    return (1 - eps) / (1 - (1 - eps) * t)

  sigma_max = -math.log1p(-(1 - eps))
  # Reference quirk preserved: its sigma_min is eps + total(0) = eps.
  sigma_min = eps

  def importance_transform(t):
    f_T = math.log1p(-math.exp(-sigma_max))
    f_0 = math.log1p(-math.exp(-sigma_min))
    sigma_t = -jnp.log1p(-jnp.exp(t * f_T + (1 - t) * f_0))
    return -jnp.expm1(-sigma_t) / (1 - eps)

  return Schedule('loglinear', total, rate, importance_transform)


def cosine(eps: float = 1e-3) -> Schedule:
  """sigma(t) = -log(eps + (1-eps) cos(pi t / 2))  (noise_schedule.py:60-73)."""

  def total(t):
    return -jnp.log(eps + (1 - eps) * jnp.cos(t * jnp.pi / 2))

  def rate(t):
    cos = (1 - eps) * jnp.cos(t * jnp.pi / 2)
    sin = (1 - eps) * jnp.sin(t * jnp.pi / 2)
    return (jnp.pi / 2) * sin / (cos + eps)

  return Schedule('cosine', total, rate)


def cosinesqr(eps: float = 1e-3) -> Schedule:
  """sigma(t) = -log(eps + (1-eps) cos^2(pi t / 2))  (noise_schedule.py:76-90)."""

  def total(t):
    return -jnp.log(eps + (1 - eps) * jnp.cos(t * jnp.pi / 2) ** 2)

  def rate(t):
    cos2 = (1 - eps) * jnp.cos(t * jnp.pi / 2) ** 2
    sin = (1 - eps) * jnp.sin(t * jnp.pi)
    return (jnp.pi / 2) * sin / (cos2 + eps)

  return Schedule('cosinesqr', total, rate)


def linear(sigma_min: float = 0.0, sigma_max: float = 10.0) -> Schedule:
  """sigma(t) = sigma_min + t (sigma_max - sigma_min)  (noise_schedule.py:93-110)."""

  def total(t):
    return sigma_min + t * (sigma_max - sigma_min)

  def rate(t):
    return jnp.full_like(jnp.asarray(t, jnp.float32), sigma_max - sigma_min)

  def importance_transform(t):
    f_T = math.log1p(-math.exp(-sigma_max))
    f_0 = math.log1p(-math.exp(-sigma_min)) if sigma_min > 0 else -float('inf')
    sigma_t = -jnp.log1p(-jnp.exp(t * f_T + (1 - t) * f_0))
    return (sigma_t - sigma_min) / (sigma_max - sigma_min)

  return Schedule('linear', total, rate, importance_transform)


def geometric(sigma_min: float = 1e-3, sigma_max: float = 1.0) -> Schedule:
  """sigma(t) = sigma_min^(1-t) sigma_max^t  (noise_schedule.py:113-123)."""
  log_ratio = math.log(sigma_max) - math.log(sigma_min)

  def total(t):
    return sigma_min ** (1 - t) * sigma_max ** t

  def rate(t):
    return total(t) * log_ratio

  return Schedule('geometric', total, rate)


def get_schedule(noise_type: str, *,
                 sigma_min: float = 1e-4,
                 sigma_max: float = 20.0,
                 eps: float = 1e-3) -> Schedule:
  """Factory mirroring the reference's get_noise (noise_schedule.py:13-28)."""
  if noise_type == 'loglinear':
    return loglinear(eps)
  if noise_type == 'cosine':
    return cosine(eps)
  if noise_type == 'cosinesqr':
    return cosinesqr(eps)
  if noise_type == 'linear':
    return linear(sigma_min, sigma_max)
  if noise_type == 'geometric':
    return geometric(sigma_min, sigma_max)
  raise ValueError(f'{noise_type} is not a valid noise schedule')
