"""One layer of the CNN denoiser: bias + LayerNorm + dilated conv +
relu + residual.

The MDLM denoiser (models/cnn.py, mirroring reference
models/dnaconv.py:196-205) runs, per layer,

    h = x + time_bias[:, None, :]        # per-sample conditioning
    h = LayerNorm(h)
    h = relu(conv1d(h, k=9, dilation=d))
    x = h + x                            # residual

in plain jnp; XLA fuses the elementwise chain around the conv's single
im2col matmul (ops/conv1d.py). Its gradient is XLA's differentiation of
this function.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from svdd.ops.conv1d import conv1d_shifted

Array = jnp.ndarray


def cnn_layer_reference(x: Array, bias_row: Array, ln_scale: Array,
                        ln_bias: Array, kernel: Array, conv_bias: Array,
                        dilation: int = 1, eps: float = 1e-6,
                        residual: Array | None = None) -> Array:
  """relu(conv(LN(x + bias_row))) + residual, in x's dtype.

  x (N, L, C); bias_row (N, C); ln_scale/ln_bias (C,); kernel (K, C, C)
  flax layout; conv_bias (C,). LayerNorm statistics are taken in f32.
  ``residual`` defaults to x; the training path passes the pre-dropout
  activations (dnaconv.py:200-205 adds the residual from BEFORE the
  dropout)."""
  h = x + bias_row[:, None, :].astype(x.dtype)
  h32 = h.astype(jnp.float32)
  mu = h32.mean(-1, keepdims=True)
  var = ((h32 - mu) ** 2).mean(-1, keepdims=True)
  h = ((h32 - mu) * jax.lax.rsqrt(var + eps)).astype(x.dtype)
  h = h * ln_scale.astype(x.dtype) + ln_bias.astype(x.dtype)
  # kernel and bias take the activation dtype (as Conv1D does): an f32
  # bias would promote a bf16 layer's output to f32
  h = conv1d_shifted(h, kernel.astype(x.dtype),
                     None if conv_bias is None
                     else conv_bias.astype(x.dtype), dilation)
  return jax.nn.relu(h) + (x if residual is None else residual)
