"""DiMamba backbone: bidirectional Mamba MDLM denoiser.

Flax rebuild of the reference DiMamba (reference models/
dimamba.py:50-1136 — Caduceus-style BiMamba blocks with adaLN time
modulation, weight-tied forward/reverse). The reference's three CUDA
dependencies map to plain JAX constructs (SURVEY.md §2.1):

  mamba-ssm selective_scan  -> jax.lax.associative_scan over the linear
                               recurrence h_t = Abar_t h_{t-1} + Bbar_t x_t
                               (parallel prefix scan — O(log L) depth)
  causal-conv1d             -> lax-padded depthwise conv
                               (lax.conv_general_dilated feature_group_count)
  Triton fused add+RMSNorm  -> svdd.ops.norms.fused_add_rmsnorm

Bidirectionality = scan + flipped scan with (by default) tied weights,
matching BiMambaWrapper (dimamba.py:590-683).
"""

from __future__ import annotations

import math

import flax.linen as nn
import jax
import jax.numpy as jnp

from svdd.config import Config
from svdd.models.dit import TimestepEmbedder, modulate
from svdd.ops.norms import fused_add_rmsnorm

Array = jnp.ndarray


def selective_scan(u: Array, dt: Array, A: Array, B: Array, C: Array,
                   D: Array) -> Array:
  """Parallel selective state-space scan.

  u:  (b, l, d)   input sequence
  dt: (b, l, d)   softplus-activated timestep deltas
  A:  (d, n)      state matrix (negative real, log-parameterized)
  B:  (b, l, n)   input->state projection (input-dependent)
  C:  (b, l, n)   state->output projection (input-dependent)
  D:  (d,)        skip connection

  Discretization (ZOH on A, Euler on B, as in mamba-ssm):
    Abar = exp(dt A);  Bbar x = dt * B * u
    h_t = Abar_t h_{t-1} + Bbar_t u_t ;  y_t = C_t . h_t + D u_t

  The recurrence is a first-order linear scan, solved with
  jax.lax.associative_scan (Blelloch prefix) instead of the reference's
  sequential CUDA kernel.
  """
  # (b, l, d, n) element-wise factors
  dA = jnp.exp(dt[..., None] * A[None, None])            # Abar
  dBu = dt[..., None] * B[:, :, None, :] * u[..., None]  # Bbar u

  def combine(left, right):
    a_l, b_l = left
    a_r, b_r = right
    return a_r * a_l, a_r * b_l + b_r

  _, h = jax.lax.associative_scan(combine, (dA, dBu), axis=1)
  y = jnp.einsum('bldn,bln->bld', h, C)
  return y + u * D[None, None]


def causal_depthwise_conv(x: Array, kernel: Array, bias: Array) -> Array:
  """Depthwise causal conv over (b, l, d); kernel (k, d).
  Replaces causal-conv1d CUDA (dimamba.py:202-211). Expressed as k
  shifted elementwise multiply-adds, which XLA fuses into one pass."""
  k = kernel.shape[0]
  l = x.shape[1]
  xp = jnp.pad(x, ((0, 0), (k - 1, 0), (0, 0)))
  out = None
  for i in range(k):
    tap = xp[:, i:i + l, :] * kernel[i]
    out = tap if out is None else out + tap
  return out + bias[None, None]


class MambaMixer(nn.Module):
  """One Mamba SSM mixer (dimamba.py Mamba:50-365)."""
  d_model: int
  d_state: int = 16
  d_conv: int = 4
  expand: int = 2
  dt_rank: int | None = None

  @nn.compact
  def __call__(self, x: Array) -> Array:
    d_inner = self.expand * self.d_model
    dt_rank = self.dt_rank or math.ceil(self.d_model / 16)

    xz = nn.Dense(2 * d_inner, use_bias=False, name='in_proj')(x)
    u, z = jnp.split(xz, 2, axis=-1)

    conv_kernel = self.param(
        'conv_kernel', nn.initializers.lecun_normal(),
        (self.d_conv, d_inner))
    conv_bias = self.param('conv_bias', nn.initializers.zeros,
                           (d_inner,))
    u = causal_depthwise_conv(u, conv_kernel.astype(u.dtype),
                              conv_bias.astype(u.dtype))
    u = jax.nn.silu(u)

    x_dbl = nn.Dense(dt_rank + 2 * self.d_state, use_bias=False,
                     name='x_proj')(u)
    dt, B, C = jnp.split(x_dbl, [dt_rank, dt_rank + self.d_state],
                         axis=-1)
    dt = nn.Dense(d_inner, name='dt_proj')(dt)
    dt = jax.nn.softplus(dt)

    # A log-parameterized negative-real (S4D-real init)
    A_log = self.param(
        'A_log',
        lambda key, shape: jnp.log(jnp.broadcast_to(
            jnp.arange(1, shape[1] + 1, dtype=jnp.float32)[None],
            shape)),
        (d_inner, self.d_state))
    A = -jnp.exp(A_log).astype(u.dtype)
    D = self.param('D', nn.initializers.ones, (d_inner,)).astype(u.dtype)

    y = selective_scan(u, dt, A, B, C, D)
    y = y * jax.nn.silu(z)
    return nn.Dense(self.d_model, use_bias=False, name='out_proj')(y)


class BiMambaWrapper(nn.Module):
  """Forward + reverse mixers with optional weight tying
  (dimamba.py:590-683)."""
  d_model: int
  tie_weights: bool = True

  @nn.compact
  def __call__(self, x: Array) -> Array:
    fwd = MambaMixer(self.d_model, name='mixer')
    out = fwd(x)
    if self.tie_weights:
      out_rev = fwd(jnp.flip(x, axis=1))
    else:
      out_rev = MambaMixer(self.d_model, name='mixer_rev')(
          jnp.flip(x, axis=1))
    return out + jnp.flip(out_rev, axis=1)


class DiMambaBlock(nn.Module):
  """Fused add+RMSNorm -> adaLN modulation -> BiMamba -> gated residual
  (dimamba.py Block:368-459 + adaLN wiring in BiMambaMixerModel)."""
  d_model: int
  cond_dim: int

  @nn.compact
  def __call__(self, x: Array, c: Array) -> Array:
    mods = nn.Dense(3 * self.d_model, name='adaLN',
                    kernel_init=nn.initializers.zeros,
                    bias_init=nn.initializers.zeros)(c)
    shift, scale, gate = jnp.split(mods, 3, axis=-1)
    norm_scale = self.param('norm_scale', nn.initializers.ones,
                            (self.d_model,))
    h = fused_add_rmsnorm(x, None, norm_scale.astype(x.dtype))
    h = modulate(h, shift, scale)
    h = BiMambaWrapper(self.d_model)(h)
    return x + gate[:, None] * h


class DiMamba(nn.Module):
  """Bidirectional Mamba MDLM denoiser (dimamba.py DiMamba:1096-1136).
  Tokens (B, L) -> logits (B, L, V)."""
  config: Config
  vocab_size: int
  compute_dtype: jnp.dtype = jnp.bfloat16

  @nn.compact
  def __call__(self, indices: Array, sigma: Array, *,
               x_onehot: Array | None = None,
               train: bool = False) -> Array:
    mcfg = self.config.model
    d = mcfg.d_model
    embed = self.param('vocab_embed', nn.initializers.normal(0.02),
                       (self.vocab_size, d))
    x = (embed[indices] if x_onehot is None
         else x_onehot @ embed).astype(self.compute_dtype)
    c = jax.nn.silu(TimestepEmbedder(mcfg.cond_dim)(sigma))
    c = c.astype(self.compute_dtype)
    for i in range(mcfg.n_layer):
      x = DiMambaBlock(d, mcfg.cond_dim, name=f'block_{i}')(x, c)
    norm_scale = self.param('final_norm_scale', nn.initializers.ones,
                            (d,))
    x = fused_add_rmsnorm(x, None, norm_scale.astype(x.dtype))
    logits = nn.Dense(self.vocab_size, name='lm_head')(x)
    return logits.astype(jnp.float32)
