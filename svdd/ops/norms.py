"""Residual-add + RMSNorm.

Replaces the Triton rms_norm_fn/layer_norm_fn the reference imports for
its DiMamba blocks (reference models/dimamba.py:27-37, 446-459). XLA
fuses the add, the reduction and the scale into one pass.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

Array = jnp.ndarray


def fused_add_rmsnorm(x: Array, residual: Array | None, scale: Array,
                      eps: float = 1e-5) -> Array:
  """y = rmsnorm(x + residual) * scale (Triton-fused in the reference);
  the mean square is taken in f32."""
  if residual is not None:
    x = x + residual
  var = jnp.mean(jnp.square(x.astype(jnp.float32)), axis=-1,
                 keepdims=True)
  y = x * jax.lax.rsqrt(var + eps).astype(x.dtype)
  return y * scale
