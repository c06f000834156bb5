"""Semi-autoregressive strided sampling (legacy text MDLM path).

Rebuild of the reference's sample_subs_guidance /
restore_model_and_semi_ar_sample (reference
diffusion_gosai.py:1822-1895): long sequences are generated block-wise
— each stride re-runs the reverse process on a window whose prefix is
pinned to previously-generated tokens, then the window slides by
``stride_length``.

Design: each stride's 1/dt-step loop is one jitted lax.scan using
the caching ddpm update (p_x0 reused while x is static); the number of
ACTUAL denoiser calls (cache misses) is counted in-scan and returned,
matching the reference's ``sampling_steps`` accounting (:1846-1850).
"""

from __future__ import annotations

from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from svdd import mdlm

Array = jnp.ndarray


def semi_ar_sample(diffusion, n_samples: int, stride_length: int,
                   num_strides: int, key: jax.Array,
                   dt: float = 0.001) -> Tuple[int, List[np.ndarray],
                                               np.ndarray]:
  """Returns (sampling_steps, per-stride token blocks, full samples)."""
  cfg = diffusion.config
  L = cfg.model.length
  mask = diffusion.mask_index
  num_steps = int(1 / dt)
  denoise = diffusion.denoise_fn()

  @jax.jit
  def run_stride(x_init: Array, k: jax.Array):
    def body(carry, i):
      x, log_p_cache, valid, misses, kk = carry
      kk, sub = jax.random.split(kk)
      t = 1.0 - i * dt
      # loglinear caching update: move chances are t and t - dt
      sigma_t, _ = diffusion.schedule(t)
      log_p = jax.lax.cond(
          valid, lambda: log_p_cache,
          lambda: denoise(x, jnp.full((x.shape[0],), sigma_t)))
      misses = misses + jnp.where(valid, 0, 1)
      log_q = mdlm.log_q_xs(log_p, t, jnp.maximum(t - dt, 1e-9), mask)
      draw = mdlm.sample_categorical(sub, log_q)
      x_next = jnp.where(x != mask, x, draw)
      valid_next = jnp.all(x_next == x)
      return (x_next, log_p, valid_next, misses, kk), None

    init = (x_init,
            jnp.zeros((x_init.shape[0], L, diffusion.vocab_size)),
            jnp.asarray(False), jnp.asarray(0), k)
    (x, _, _, misses, _), _ = jax.lax.scan(body, init,
                                           jnp.arange(num_steps + 1))
    # final denoise at t=0 + argmax (diffusion_gosai.py:1851)
    logits = denoise(x, jnp.zeros((x.shape[0],)))
    x = jnp.argmax(logits[..., :-1], axis=-1)
    return x, misses

  target = None
  blocks: List[np.ndarray] = []
  sampling_steps = 0
  for _ in range(num_strides + 1):
    key, sub = jax.random.split(key)
    x = mdlm.sample_prior((n_samples, L), mask)
    if target is not None:
      x = x.at[:, :L - stride_length].set(target)
    x, misses = run_stride(x, sub)
    sampling_steps += int(misses)
    blocks.append(np.asarray(x[:, :stride_length]))
    target = x[:, stride_length:]
  blocks.append(np.asarray(target))
  full = np.concatenate(blocks, axis=1)
  return sampling_steps, blocks, full
