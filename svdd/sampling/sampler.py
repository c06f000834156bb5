"""The reverse process as a single jitted ``lax.scan``.

The reference runs 128 python-level loop iterations with per-step
device syncs (diffusion_gosai.py:821-886, the HOT LOOP of SURVEY.md
§3.1). Here the entire trajectory — every denoiser forward, candidate
draw, value forward and selection — lives inside one compiled scan with
no host round-trips: the carry is donated, shapes are static, and the
per-step transition is a plugged-in ``step_fn`` so uncontrolled and all
guided samplers share one loop skeleton.

step_fn signature:
    step_fn(aux, x, t, t_next, key) -> (aux, x_next)
where ``aux`` is an arbitrary carry pytree (e.g. the cached p_x0 of the
ddpm_cache predictor; () when unused).
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from svdd import mdlm
from svdd.schedules import Schedule

Array = jnp.ndarray
StepFn = Callable[[Any, Array, Array, Array, jax.Array],
                  Tuple[Any, Array]]
DenoiseFn = Callable[[Array, Array], Array]   # (x, sigma_b) -> log_p_x0


class SampleResult(NamedTuple):
  samples: Array               # (B, L) final tokens (mask-free)
  mid_x: Optional[Array]       # (num_steps-1, B, L) intermediate states
  extra: Any = None


def timestep_grid(num_steps: int, eps: float) -> Array:
  """linspace(1, eps, num_steps+1) (diffusion_gosai.py:835-837)."""
  return jnp.linspace(1.0, eps, num_steps + 1)


def sigma_batch(schedule: Schedule, t: Array, batch: int) -> Array:
  """Broadcast scalar t to per-row conditioning sigma (B,)."""
  sigma, _ = schedule(t)
  return jnp.full((batch,), sigma)


def ddpm_step(denoise_fn: DenoiseFn, schedule: Schedule,
              mask_index: int) -> StepFn:
  """Uncontrolled ddpm ancestral step (diffusion_gosai.py:775-800)."""

  def step(aux, x, t, t_next, key):
    sigma_t, _ = schedule(t)
    sigma_s, _ = schedule(t_next)
    mct = 1 - jnp.exp(-sigma_t)
    mcs = 1 - jnp.exp(-sigma_s)
    log_p = denoise_fn(x, jnp.full((x.shape[0],), sigma_t))
    log_q = mdlm.log_q_xs(log_p, mct, mcs, mask_index)
    draw = mdlm.sample_categorical(key, log_q)
    x_next = jnp.where(x != mask_index, x, draw)
    return aux, x_next

  return step


def ddpm_cache_step(denoise_fn: DenoiseFn, schedule: Schedule,
                    mask_index: int) -> StepFn:
  """Caching variant: reuse p_x0 while x is unchanged
  (diffusion_gosai.py:755-773, cache-invalidation check at :874-879).
  aux carries (log_p_cache, valid_flag)."""

  def step(aux, x, t, t_next, key):
    log_p_cache, valid = aux
    sigma_t, _ = schedule(t)
    # loglinear: move chances are t and t_next directly (:762-765)
    mct, mcs = t, t_next
    log_p = jax.lax.cond(
        valid,
        lambda: log_p_cache,
        lambda: denoise_fn(x, jnp.full((x.shape[0],), sigma_t)))
    log_q = mdlm.log_q_xs(log_p, mct, mcs, mask_index)
    draw = mdlm.sample_categorical(key, log_q)
    x_next = jnp.where(x != mask_index, x, draw)
    # cache stays valid iff nothing changed this step (:874-879)
    valid_next = jnp.all(x_next == x)
    return (log_p, valid_next), x_next

  return step


def analytic_step(denoise_fn: DenoiseFn, schedule: Schedule,
                  mask_index: int, vocab_size: int) -> StepFn:
  """Analytic (score-based) update (diffusion_gosai.py:1633-1640)."""

  def step(aux, x, t, t_next, key):
    curr_sigma, _ = schedule(t)
    next_sigma, _ = schedule(t_next)
    dsigma = jnp.full((x.shape[0],), curr_sigma - next_sigma)
    sigma_b = jnp.full((x.shape[0],), curr_sigma)
    log_p = denoise_fn(x, sigma_b)
    score = mdlm.get_score(log_p, x, sigma_b, mask_index)
    stag = mdlm.staggered_score(score, dsigma, mask_index)
    probs = stag * mdlm.transp_transition(x, dsigma, vocab_size,
                                          mask_index)
    x_next = mdlm.sample_categorical_probs(key, probs)
    return aux, x_next

  return step


def denoiser_final(denoise_fn: DenoiseFn, schedule: Schedule,
                   mask_index: int, vocab_size: int,
                   x: Array, t: Array, key: jax.Array) -> Array:
  """Analytic-sampler noise removal (diffusion_gosai.py:1642-1649)."""
  sigma_b = sigma_batch(schedule, t, x.shape[0])
  log_p = denoise_fn(x, sigma_b)
  score = mdlm.get_score(log_p, x, sigma_b, mask_index)
  stag = mdlm.staggered_score(score, sigma_b, mask_index)
  probs = stag * mdlm.transp_transition(x, sigma_b, vocab_size,
                                        mask_index)
  probs = probs.at[..., mask_index].set(0)
  return mdlm.sample_categorical_probs(key, probs)


def argmax_noise_removal(denoise_fn: DenoiseFn, schedule: Schedule,
                         x: Array, t: Array) -> Array:
  """Final forward + argmax over non-mask vocab
  (diffusion_gosai.py:1049-1060)."""
  sigma_b = sigma_batch(schedule, t, x.shape[0])
  logits = denoise_fn(x, sigma_b)
  return jnp.argmax(logits[..., :-1], axis=-1)


def reverse_process(
    step_fn,
    denoise_fn: DenoiseFn,
    schedule: Schedule,
    *,
    batch_size: int,
    length: int,
    mask_index: int,
    vocab_size: int,
    num_steps: int,
    eps: float = 1e-5,
    noise_removal: bool = True,
    analytic_removal: bool = False,
    removal_from_aux: bool = False,
    collect_mid: bool = False,
    collect_aux: bool = False,
    aux_init: Any = (),
    shard_constraint: Optional[Callable[[Array], Array]] = None,
) -> Callable[[jax.Array], SampleResult]:
  """Build the full jitted sampler: prior -> scan(num_steps) -> removal.

  Matches the reference loop structure (diffusion_gosai.py:821-886):
  timesteps linspace(1, eps, steps+1), per-step transition, final
  noise-removal argmax (or analytic denoiser), mid-state collection for
  value-net training targets.

  ``step_fn`` is either one StepFn or a PHASE LIST
  ``[(step_fn_i, n_steps_i), ...]`` with sum(n_steps_i) == num_steps:
  each phase runs its own lax.scan over its contiguous step range and
  the carry (aux, x, key-chain) flows through unchanged, so a
  single-phase list is bit-identical to the plain form. Phases let a
  guided decode change its per-step transition shape mid-trajectory
  (e.g. scheduled-M SVDD: fewer value-net candidates on the early
  all-mask steps) while every phase stays a static-shape scan.
  """
  timesteps = timestep_grid(num_steps, eps)
  phases = step_fn if isinstance(step_fn, (list, tuple)) else \
      [(step_fn, num_steps)]
  if any(n < 1 for _, n in phases):
    # a negative length can still satisfy the sum check while pushing
    # another phase past the timestep grid (clamped indexing would
    # silently corrupt the trajectory)
    raise ValueError(f'phase lengths must be >= 1: '
                     f'{[n for _, n in phases]}')
  if sum(n for _, n in phases) != num_steps:
    raise ValueError(f'phase lengths {[n for _, n in phases]} do not '
                     f'sum to num_steps={num_steps}')

  def sample(key: jax.Array) -> SampleResult:
    x = mdlm.sample_prior((batch_size, length), mask_index)
    if shard_constraint is not None:
      # pin the batch dim to the 'data' mesh axis; XLA propagates the
      # layout through the whole scan (DDP decode semantics)
      x = shard_constraint(x)
    key, scan_key, final_key = jax.random.split(key, 3)

    def make_body(fn):
      def body(carry, idx):
        aux, x, k = carry
        k, sub = jax.random.split(k)
        t = timesteps[idx]
        t_next = timesteps[idx + 1]
        aux, x_next = fn(aux, x, t, t_next, sub)
        out = (x_next if collect_mid else None,
               aux if collect_aux else None)
        return (aux, x_next, k), out
      return body

    carry = (aux_init, x, scan_key)
    start = 0
    mids_parts, aux_parts = [], []
    for fn, n in phases:
      carry, (m, a) = jax.lax.scan(
          make_body(fn), carry, jnp.arange(start, start + n))
      start += n
      mids_parts.append(m)
      aux_parts.append(a)
    aux, x, _ = carry
    mids = (jnp.concatenate(mids_parts) if collect_mid
            and len(mids_parts) > 1 else mids_parts[0])
    aux_seq = (jax.tree.map(lambda *xs: jnp.concatenate(xs), *aux_parts)
               if collect_aux and len(aux_parts) > 1 else aux_parts[0])

    if noise_removal:
      t_last = timesteps[-1]
      if analytic_removal:
        x = denoiser_final(denoise_fn, schedule, mask_index,
                           vocab_size, x, t_last, final_key)
      elif removal_from_aux:
        # the posterior carry (log_p, valid) holds
        # denoise_fn(x, sigma(t_last)) exactly (the guided step's
        # carry_posterior contract) — argmax it directly instead of
        # re-running the removal forward (diffusion_gosai.py:1049-1060
        # semantics preserved). TDS with ESS telemetry nests the carry
        # under aux['post'] (guidance.tds_aux_init).
        post = aux['post'] if isinstance(aux, dict) else aux
        x = jnp.argmax(post[0][..., :-1], axis=-1)
      else:
        x = argmax_noise_removal(denoise_fn, schedule, x, t_last)

    # mid_x excludes the final step's state (diffusion_gosai.py:866-867)
    mid = mids[:-1] if collect_mid else None
    return SampleResult(samples=x, mid_x=mid,
                        extra=aux_seq if collect_aux else aux)

  return sample
