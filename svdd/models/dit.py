"""DiT denoiser backbone (adaLN-zero diffusion transformer).

Flax rebuild of the reference DIT (reference models/dit.py:324-370):
rotary embeddings (dit.py:81-117), adaLN-zero modulation blocks
(DDiTBlock :214-288), sinusoidal timestep embedder (:150-189), and the
zero-initialized final layer (:302-321).

Differences from the reference:
  * attention runs through ``svdd.ops.attention`` (XLA dot-product
    attention), replacing flash-attn's CUDA varlen kernel
    (dit.py:272-273).
  * rotary embedding is fused into the QKV preparation as pure jnp;
    XLA fuses it with the projection matmul epilogue (no separate
    CUDA rotary kernel needed, dit.py:112-115).
  * the TorchScript-fused bias-dropout-scale helpers (dit.py:52-78)
    are plain jnp expressions — XLA fuses them automatically.
"""

from __future__ import annotations

import math

import flax.linen as nn
import jax
import jax.numpy as jnp

from svdd.config import Config
from svdd.ops import attention as attn_ops

Array = jnp.ndarray


def timestep_embedding(t: Array, dim: int, max_period: int = 10_000
                       ) -> Array:
  """Sinusoidal features (dit.py:161-186): [cos | sin] halves."""
  half = dim // 2
  freqs = jnp.exp(-math.log(max_period)
                  * jnp.arange(half, dtype=jnp.float32) / half)
  args = t[:, None].astype(jnp.float32) * freqs[None]
  emb = jnp.concatenate([jnp.cos(args), jnp.sin(args)], axis=-1)
  if dim % 2:
    emb = jnp.concatenate([emb, jnp.zeros_like(emb[:, :1])], axis=-1)
  return emb


class TimestepEmbedder(nn.Module):
  """MLP over sinusoidal features (dit.py:150-189)."""
  hidden_size: int
  frequency_embedding_size: int = 256

  @nn.compact
  def __call__(self, t: Array) -> Array:
    x = timestep_embedding(t, self.frequency_embedding_size)
    x = nn.Dense(self.hidden_size)(x)
    x = jax.nn.silu(x)
    return nn.Dense(self.hidden_size)(x)


def rotary_cos_sin(seq_len: int, head_dim: int, base: float = 10_000.0):
  """(L, D/2) cos/sin tables (dit.py:81-104)."""
  inv_freq = 1.0 / (base ** (jnp.arange(0, head_dim, 2,
                                        dtype=jnp.float32) / head_dim))
  t = jnp.arange(seq_len, dtype=jnp.float32)
  freqs = jnp.einsum('i,j->ij', t, inv_freq)
  return jnp.cos(freqs), jnp.sin(freqs)


def apply_rotary(x: Array, cos: Array, sin: Array) -> Array:
  """Rotate interleaved half-dims; x: (B, L, H, D). Matches
  flash-attn's non-interleaved rotary on the first half (dit.py:107-115)."""
  d2 = x.shape[-1] // 2
  x1, x2 = x[..., :d2], x[..., d2:]
  cos = cos[None, :, None, :]
  sin = sin[None, :, None, :]
  return jnp.concatenate(
      [x1 * cos - x2 * sin, x2 * cos + x1 * sin], axis=-1)


def modulate(x: Array, shift: Array, scale: Array) -> Array:
  """x * (1 + scale) + shift with (B, D) conditioning (dit.py:119-121)."""
  return x * (1 + scale[:, None]) + shift[:, None]


class DDiTBlock(nn.Module):
  """adaLN-zero transformer block (dit.py:214-288)."""
  dim: int
  n_heads: int
  cond_dim: int
  mlp_ratio: int = 4
  dropout: float = 0.1

  @nn.compact
  def __call__(self, x: Array, cos: Array, sin: Array, c: Array,
               train: bool = False) -> Array:
    mods = nn.Dense(6 * self.dim, name='adaLN',
                    kernel_init=nn.initializers.zeros,
                    bias_init=nn.initializers.zeros)(c)
    (shift_msa, scale_msa, gate_msa,
     shift_mlp, scale_mlp, gate_mlp) = jnp.split(mods, 6, axis=-1)

    b, l, _ = x.shape
    h = self.n_heads
    hd = self.dim // h

    skip = x
    xm = modulate(nn.LayerNorm(epsilon=1e-5, use_bias=False, dtype=x.dtype)(x),
                  shift_msa, scale_msa)
    qkv = nn.Dense(3 * self.dim, use_bias=False, name='attn_qkv')(xm)
    q, k, v = jnp.split(qkv.reshape(b, l, 3, h, hd), 3, axis=2)
    q, k, v = q[:, :, 0], k[:, :, 0], v[:, :, 0]
    q = apply_rotary(q, cos, sin)
    k = apply_rotary(k, cos, sin)
    o = attn_ops.mha(q, k, v)                   # (B, L, H, hd)
    o = nn.Dense(self.dim, use_bias=False, name='attn_out')(
        o.reshape(b, l, self.dim))
    o = nn.Dropout(self.dropout, deterministic=not train)(o)
    x = skip + gate_msa[:, None] * o

    xm = modulate(nn.LayerNorm(epsilon=1e-5, use_bias=False, dtype=x.dtype)(x),
                  shift_mlp, scale_mlp)
    y = nn.Dense(self.mlp_ratio * self.dim, name='mlp_0')(xm)
    y = jax.nn.gelu(y, approximate=True)
    y = nn.Dense(self.dim, name='mlp_1')(y)
    y = nn.Dropout(self.dropout, deterministic=not train)(y)
    return x + gate_mlp[:, None] * y


class DDitFinalLayer(nn.Module):
  """Zero-init output head with adaLN (dit.py:302-321)."""
  hidden_size: int
  out_channels: int
  cond_dim: int

  @nn.compact
  def __call__(self, x: Array, c: Array) -> Array:
    mods = nn.Dense(2 * self.hidden_size, name='adaLN',
                    kernel_init=nn.initializers.zeros,
                    bias_init=nn.initializers.zeros)(c)
    shift, scale = jnp.split(mods, 2, axis=-1)
    x = modulate(nn.LayerNorm(epsilon=1e-5, use_bias=False, dtype=x.dtype)(x),
                 shift, scale)
    return nn.Dense(self.out_channels,
                    kernel_init=nn.initializers.zeros,
                    bias_init=nn.initializers.zeros, name='linear')(x)


class DIT(nn.Module):
  """Rotary adaLN-zero DiT (dit.py:324-370). Tokens (B, L) -> logits
  (B, L, V). ``x_onehot`` enables the gradient-guidance (forward2) path
  via a soft embedding lookup."""
  config: Config
  vocab_size: int
  compute_dtype: jnp.dtype = jnp.bfloat16

  @nn.compact
  def __call__(self, indices: Array, sigma: Array, *,
               x_onehot: Array | None = None,
               train: bool = False) -> Array:
    mcfg = self.config.model
    dim = mcfg.hidden_size
    embed = self.param('vocab_embed', nn.initializers.kaiming_uniform(),
                       (self.vocab_size, dim))
    if x_onehot is None:
      x = embed[indices]
    else:
      x = x_onehot @ embed
    x = x.astype(self.compute_dtype)

    c = jax.nn.silu(TimestepEmbedder(mcfg.cond_dim)(sigma))
    c = c.astype(self.compute_dtype)
    cos, sin = rotary_cos_sin(x.shape[1], dim // mcfg.n_heads)
    cos = cos.astype(self.compute_dtype)
    sin = sin.astype(self.compute_dtype)

    for i in range(mcfg.n_blocks):
      x = DDiTBlock(dim, mcfg.n_heads, mcfg.cond_dim,
                    dropout=mcfg.dropout, name=f'block_{i}')(
                        x, cos, sin, c, train=train)
    x = DDitFinalLayer(dim, self.vocab_size, mcfg.cond_dim)(x, c)
    return x.astype(jnp.float32)
