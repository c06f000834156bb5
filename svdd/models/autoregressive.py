"""AR (causal transformer) baseline backbone + decode loop.

Flax rebuild of the reference AR model (reference models/
autoregressive.py:273-358 — a causal DDiT without time conditioning)
and its sampling loop (_ar_sampler, diffusion_gosai.py:802-818).

Design: the decode loop is a lax.scan over positions with
pre-drawn Gumbel noise (exactly the reference's trick of presampling
the noise tensor :810-813); attention is causal XLA attention
(ops.attention) instead of flash-attn varlen.
"""

from __future__ import annotations

import flax.linen as nn
import jax
import jax.numpy as jnp

from svdd.config import Config
from svdd.models.dit import rotary_cos_sin, apply_rotary
from svdd.ops import attention as attn_ops

Array = jnp.ndarray


class ARBlock(nn.Module):
  """Causal transformer block (autoregressive.py DDIT blocks)."""
  dim: int
  n_heads: int
  mlp_ratio: int = 4
  dropout: float = 0.1

  @nn.compact
  def __call__(self, x: Array, cos: Array, sin: Array,
               train: bool = False) -> Array:
    b, l, _ = x.shape
    h = self.n_heads
    hd = self.dim // h
    skip = x
    xm = nn.LayerNorm(use_bias=False, dtype=x.dtype)(x)
    qkv = nn.Dense(3 * self.dim, use_bias=False, name='attn_qkv')(xm)
    q, k, v = jnp.split(qkv.reshape(b, l, 3, h, hd), 3, axis=2)
    q, k, v = q[:, :, 0], k[:, :, 0], v[:, :, 0]
    q = apply_rotary(q, cos, sin)
    k = apply_rotary(k, cos, sin)
    o = attn_ops.mha(q, k, v, causal=True)
    o = nn.Dense(self.dim, use_bias=False, name='attn_out')(
        o.reshape(b, l, self.dim))
    x = skip + nn.Dropout(self.dropout, deterministic=not train)(o)
    xm = nn.LayerNorm(use_bias=False, dtype=x.dtype)(x)
    y = nn.Dense(self.mlp_ratio * self.dim, name='mlp_0')(xm)
    y = jax.nn.gelu(y, approximate=True)
    y = nn.Dense(self.dim, name='mlp_1')(y)
    return x + nn.Dropout(self.dropout, deterministic=not train)(y)


class ARModel(nn.Module):
  """Causal LM over the DNA vocab. sigma is accepted and ignored
  (parameterization 'ar' passes None/zeros)."""
  config: Config
  vocab_size: int
  compute_dtype: jnp.dtype = jnp.bfloat16

  @nn.compact
  def __call__(self, indices: Array, sigma: Array = None, *,
               x_onehot: Array | None = None,
               train: bool = False) -> Array:
    mcfg = self.config.model
    dim = mcfg.hidden_size
    embed = self.param('vocab_embed', nn.initializers.normal(0.02),
                       (self.vocab_size, dim))
    x = (embed[indices] if x_onehot is None
         else x_onehot @ embed).astype(self.compute_dtype)
    cos, sin = rotary_cos_sin(x.shape[1], dim // mcfg.n_heads)
    cos = cos.astype(self.compute_dtype)
    sin = sin.astype(self.compute_dtype)
    for i in range(mcfg.n_blocks):
      x = ARBlock(dim, mcfg.n_heads, dropout=mcfg.dropout,
                  name=f'block_{i}')(x, cos, sin, train=train)
    x = nn.LayerNorm(use_bias=False, dtype=x.dtype)(x)
    logits = nn.Dense(self.vocab_size, name='lm_head')(x)
    # log-probs (the AR loss gathers log p directly,
    # diffusion_gosai.py:1765-1768)
    return jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)


def ar_sample(model: ARModel, variables, batch_size: int, length: int,
              key: jax.Array, bos_token: int = 0) -> Array:
  """AR ancestral decode (_ar_sampler, diffusion_gosai.py:802-818):
  pre-draw Gumbel noise, then scan over positions. Each step re-runs
  the full prefix forward (as the reference does — no KV cache in
  either implementation; L<=200 keeps this cheap)."""
  num_pred = length - 1
  noise = jax.random.gumbel(
      key, (batch_size, num_pred, model.vocab_size))
  x0 = jnp.zeros((batch_size, length), jnp.int32).at[:, 0].set(bos_token)

  def body(x, i):
    logits = model.apply(variables, x, jnp.zeros((batch_size,)))
    next_logits = jnp.take_along_axis(
        logits, i[None, None, None].repeat(batch_size, 0), axis=1
    )[:, 0]
    y = jnp.argmax(next_logits + noise[:, i], axis=-1)
    x = jax.lax.dynamic_update_index_in_dim(
        x.T, y, i + 1, axis=0).T
    return x, None

  x, _ = jax.lax.scan(body, x0, jnp.arange(num_pred))
  return x


def ar_sample_kv(model: ARModel, variables, batch_size: int,
                 length: int, key: jax.Array,
                 bos_token: int = 0) -> Array:
  """KV-cached AR ancestral decode — beyond-parity speedup.

  Numerically equivalent to ``ar_sample`` (same Gumbel pre-draw, same
  sampling rule) but each position runs a SINGLE-token forward against
  per-block K/V caches instead of re-running the whole prefix
  (the reference's loop, diffusion_gosai.py:802-818, has no cache
  either): per-position Dense work drops from O(L·D²) to O(D²).
  Attention reads the full-length cache with a position mask so every
  scan step has static shapes.
  """
  import math

  p = variables['params']
  mcfg = model.config.model
  dim = mcfg.hidden_size
  h = mcfg.n_heads
  hd = dim // h
  nb = mcfg.n_blocks
  dtype = model.compute_dtype
  b = batch_size

  cos, sin = rotary_cos_sin(length, hd)
  cos = cos.astype(dtype)
  sin = sin.astype(dtype)
  embed = p['vocab_embed']
  num_pred = length - 1
  noise = jax.random.gumbel(
      key, (b, num_pred, model.vocab_size))

  def ln(scale, x):
    x32 = x.astype(jnp.float32)
    mu = x32.mean(-1, keepdims=True)
    var = ((x32 - mu) ** 2).mean(-1, keepdims=True)
    out = (x32 - mu) * jax.lax.rsqrt(var + 1e-6)
    return (out.astype(x.dtype) * scale.astype(x.dtype))

  def rot1(x, c, s):
    # x (B, H, D); c/s (D/2,)
    d2 = hd // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    return jnp.concatenate(
        [x1 * c - x2 * s, x2 * c + x1 * s], axis=-1)

  def block_step(pb, xi, ck, cv, i):
    # xi (B, D); ck/cv (B, L, H, hd)
    xm = ln(pb['LayerNorm_0']['scale'], xi)
    qkv = (xm @ pb['attn_qkv']['kernel'].astype(xm.dtype)
           ).reshape(b, 3, h, hd)
    q, k1, v1 = qkv[:, 0], qkv[:, 1], qkv[:, 2]
    c_i = jax.lax.dynamic_index_in_dim(cos, i, 0, keepdims=False)
    s_i = jax.lax.dynamic_index_in_dim(sin, i, 0, keepdims=False)
    q = rot1(q, c_i, s_i)
    k1 = rot1(k1, c_i, s_i)
    ck = jax.lax.dynamic_update_index_in_dim(ck, k1, i, 1)
    cv = jax.lax.dynamic_update_index_in_dim(cv, v1, i, 1)
    logits = jnp.einsum('bhd,bjhd->bhj', q, ck,
                        preferred_element_type=jnp.float32
                        ) / math.sqrt(hd)
    mask = jnp.arange(length) <= i
    logits = jnp.where(mask[None, None, :], logits, -jnp.inf)
    w = jax.nn.softmax(logits, axis=-1).astype(cv.dtype)
    o = jnp.einsum('bhj,bjhd->bhd', w, cv).reshape(b, dim)
    o = o @ pb['attn_out']['kernel'].astype(o.dtype)
    x = xi + o
    xm = ln(pb['LayerNorm_1']['scale'], x)
    y = xm @ pb['mlp_0']['kernel'].astype(xm.dtype) + pb['mlp_0'][
        'bias'].astype(xm.dtype)
    y = jax.nn.gelu(y, approximate=True)
    y = y @ pb['mlp_1']['kernel'].astype(y.dtype) + pb['mlp_1'][
        'bias'].astype(y.dtype)
    return x + y, ck, cv

  ck0 = jnp.zeros((nb, b, length, h, hd), dtype)
  cv0 = jnp.zeros((nb, b, length, h, hd), dtype)
  x0 = jnp.zeros((b, length), jnp.int32).at[:, 0].set(bos_token)

  def body(carry, i):
    x, ck, cv = carry
    tok = jnp.take_along_axis(x, i[None, None].repeat(b, 0),
                              axis=1)[:, 0]
    xi = embed[tok].astype(dtype)
    new_ck, new_cv = [], []
    for j in range(nb):
      xi, ckj, cvj = block_step(p[f'block_{j}'], xi, ck[j], cv[j], i)
      new_ck.append(ckj)
      new_cv.append(cvj)
    ck = jnp.stack(new_ck)
    cv = jnp.stack(new_cv)
    xi = ln(p['LayerNorm_0']['scale'], xi)
    logits = (xi @ p['lm_head']['kernel'].astype(xi.dtype)
              + p['lm_head']['bias'].astype(xi.dtype)
              ).astype(jnp.float32)
    logp = jax.nn.log_softmax(logits, axis=-1)
    y = jnp.argmax(logp + noise[:, i], axis=-1)
    x = jax.lax.dynamic_update_index_in_dim(x.T, y, i + 1, axis=0).T
    return (x, ck, cv), None

  (x, _, _), _ = jax.lax.scan(body, (x0, ck0, cv0),
                              jnp.arange(num_pred))
  return x
