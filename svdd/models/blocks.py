"""Shared value/reward-net building blocks.

Flax rebuilds of the reference's grelu-style layer library
(reference Enformer.py:2050-2660: ConvBlock with "CDNRA"/"NACDR"
op-order strings, LinearBlock, FeedForwardBlock, Stem, Pool, AdaptivePool,
Norm, ChannelTransform, Crop, Activation incl. gelu_enformer).

All blocks use channel-LAST (B, L, C) layout, where 1-D convs lower to
plain matmuls, whereas the reference is channel-first (N, C, L) with
transpose shims. BatchNorm uses flax's
'batch_stats' collection: frozen running stats at decode (eval mode),
mutable during training (SURVEY.md §7.3 hard-parts list).
"""

from __future__ import annotations

from typing import Optional

import flax.linen as nn
import jax
import jax.numpy as jnp

from svdd.ops.conv1d import Conv1D

Array = jnp.ndarray


class FastLayerNorm(nn.LayerNorm):
  """nn.LayerNorm whose elementwise apply runs in the input dtype.

  flax's LayerNorm promotes the whole normalize chain to f32 and casts
  only the final result (normalization._normalize), so under a bf16
  trunk the sub/mul/mul/add ops that XLA fuses into the following
  dot's operand read run as f32 work. Here the mean/rsqrt stats stay
  f32, but mean/rstd/scale/bias are cast to the input dtype BEFORE the
  apply, so the chain fused into the qkv / FFN dot operands is
  all-bf16. Param tree ('scale'/'bias') and the
  f32 input path are identical to nn.LayerNorm; only bf16 inputs with
  the default last-axis reduction take the fast path.
  """

  @nn.compact
  def __call__(self, x, *, mask=None):
    assert (mask is None and self.reduction_axes == -1
            and self.feature_axes == -1 and self.axis_name is None), (
        'FastLayerNorm only supports the default last-axis config')
    features = x.shape[-1]
    x32 = x.astype(jnp.float32)
    mean = jnp.mean(x32, axis=-1, keepdims=True)
    if self.use_fast_variance:
      var = jnp.maximum(
          jnp.mean(jnp.square(x32), axis=-1, keepdims=True)
          - jnp.square(mean), 0.0)
    else:
      var = jnp.mean(jnp.square(x32 - mean), axis=-1, keepdims=True)
    rstd = jax.lax.rsqrt(var + self.epsilon)
    scale = (self.param('scale', self.scale_init, (features,),
                        self.param_dtype)
             if self.use_scale else None)
    bias = (self.param('bias', self.bias_init, (features,),
                       self.param_dtype)
            if self.use_bias else None)
    if x.dtype == jnp.bfloat16:
      # bf16 apply: all ops XLA fuses into the next dot's operand
      # read are bf16 (stats above stay f32)
      y = (x - mean.astype(x.dtype)) * rstd.astype(x.dtype)
      if scale is not None:
        y = y * scale.astype(x.dtype)
      if bias is not None:
        y = y + bias.astype(x.dtype)
      return y
    # f32/other dtypes: flax's exact op order (normalization._normalize)
    y = x32 - mean
    mul = rstd
    if scale is not None:
      mul = mul * scale.astype(jnp.float32)
    y = y * mul
    if bias is not None:
      y = y + bias.astype(jnp.float32)
    return y.astype(x.dtype)


def gelu_enformer(x: Array) -> Array:
  """Enformer's sigmoid-approx GELU: x * sigmoid(1.702 x)
  (enformer_pytorch GELU, imported at Enformer.py:8)."""
  return x * jax.nn.sigmoid(1.702 * x)


def activation(name: Optional[str], x: Array) -> Array:
  """Activation registry (Enformer.py:2371-2410)."""
  if name is None:
    return x
  if name == 'relu':
    return jax.nn.relu(x)
  if name == 'elu':
    return jax.nn.elu(x)
  if name == 'gelu':
    return jax.nn.gelu(x, approximate=False)
  if name == 'gelu_enformer':
    return gelu_enformer(x)
  if name == 'softplus':
    return jax.nn.softplus(x)
  if name == 'exp':
    return jnp.exp(x)
  raise NotImplementedError(name)


class Norm(nn.Module):
  """'batch' / 'layer' / None normalization over the channel axis
  (Enformer.py:2504-2558). Input (B, L, C)."""
  func: Optional[str]
  momentum: float = 0.9
  epsilon: float = 1e-5

  @nn.compact
  def __call__(self, x: Array, train: bool = False) -> Array:
    if self.func is None:
      return x
    if self.func == 'layer':
      return FastLayerNorm(epsilon=self.epsilon, dtype=x.dtype,
                           name='LayerNorm_0')(x)
    if self.func == 'batch':
      return nn.BatchNorm(
          use_running_average=not train, momentum=self.momentum,
          epsilon=self.epsilon, dtype=x.dtype)(x)
    raise NotImplementedError(self.func)


class AttentionPool(nn.Module):
  """Enformer attention pooling over groups of ``pool_size`` positions
  (enformer_pytorch AttentionPool, used via Pool('attn'),
  Enformer.py:2416-2460). Logits come from a dim->dim linear initialized
  at 2*identity; odd-length tails are -inf masked. The logits leave
  the matmul in f32 and are not rounded to x.dtype; the softmax and the
  weighted sum run in f32, and the result is cast back to x.dtype."""
  dim: int
  pool_size: int = 2

  @nn.compact
  def __call__(self, x: Array) -> Array:      # (B, L, C)
    b, n, c = x.shape
    p = self.pool_size
    pad = -n % p
    logits_w = self.param(
        'to_attn_logits',
        lambda key, shape: 2.0 * jnp.eye(shape[0], dtype=jnp.float32),
        (c, c))
    logits = jnp.dot(x, logits_w.astype(x.dtype),
                     preferred_element_type=jnp.float32)
    if pad:
      x = jnp.pad(x, ((0, 0), (0, pad), (0, 0)))
      logits = jnp.pad(logits, ((0, 0), (0, pad), (0, 0)),
                       constant_values=jnp.finfo(jnp.float32).min)
    attn = jax.nn.softmax(logits.reshape(b, -1, p, c), axis=2)
    xg = x.reshape(b, -1, p, c).astype(jnp.float32)
    return (xg * attn).sum(axis=2).astype(x.dtype)


class Pool(nn.Module):
  """'avg' / 'max' / 'attn' / None pooling (Enformer.py:2416-2460)."""
  func: Optional[str]
  pool_size: Optional[int] = None
  in_channels: Optional[int] = None

  @nn.compact
  def __call__(self, x: Array) -> Array:
    if self.func is None:
      return x
    p = self.pool_size
    if self.func == 'avg':
      return nn.avg_pool(x, (p,), strides=(p,))
    if self.func == 'max':
      return nn.max_pool(x, (p,), strides=(p,))
    if self.func == 'attn':
      return AttentionPool(dim=self.in_channels, pool_size=p)(x)
    raise NotImplementedError(self.func)


def adaptive_pool(func: Optional[str], x: Array) -> Array:
  """Pool the whole length axis (Enformer.py:2463-2501). (B,L,C)->(B,C)."""
  if func is None:
    return x
  if func == 'avg':
    return x.mean(axis=1)
  if func == 'max':
    return x.max(axis=1)
  raise NotImplementedError(func)


class ChannelTransform(nn.Module):
  """1x1 conv channel resize; identity when channels already match
  (Enformer.py:2561-2593)."""
  in_channels: int
  out_channels: int
  if_equal: bool = False

  @nn.compact
  def __call__(self, x: Array) -> Array:
    if self.in_channels == self.out_channels and not self.if_equal:
      return x
    return Conv1D(self.out_channels, 1, dtype=x.dtype)(x)


class ConvBlock(nn.Module):
  """Conv + {norm, dropout, residual, activation} in configurable order,
  pooling always last (Enformer.py:2176-2292).

  order: permutation of "CDNRA" — Conv, Dropout, Norm, Residual, Act.
  """
  in_channels: int
  out_channels: int
  kernel_size: int
  dilation: int = 1
  act_func: Optional[str] = 'relu'
  pool_func: Optional[str] = None
  pool_size: Optional[int] = None
  dropout: float = 0.0
  norm: bool = True
  residual: bool = False
  order: str = 'CDNRA'

  @nn.compact
  def __call__(self, x: Array, train: bool = False) -> Array:
    assert sorted(self.order) == list('ACDNR'), self.order
    norm = Norm('batch' if self.norm else None)
    conv = Conv1D(self.out_channels, self.kernel_size,
                  dilation=self.dilation, dtype=x.dtype)
    drop = nn.Dropout(self.dropout, deterministic=not train)
    if self.residual:
      x_input = ChannelTransform(self.in_channels, self.out_channels)(x)
    for name in self.order:
      if name == 'C':
        x = conv(x)
      elif name == 'D':
        x = drop(x)
      elif name == 'N':
        x = norm(x, train=train)
      elif name == 'R':
        if self.residual:
          x = x + x_input
      elif name == 'A':
        x = activation(self.act_func, x)
    return Pool(self.pool_func, self.pool_size,
                in_channels=self.out_channels)(x)


class ChannelTransformBlock(nn.Module):
  """1x1 conv + optional norm/act/dropout in "CDNA" order
  (Enformer.py:2295-2368)."""
  in_channels: int
  out_channels: int
  norm: bool = False
  act_func: Optional[str] = 'relu'
  dropout: float = 0.0
  order: str = 'CDNA'
  if_equal: bool = False

  @nn.compact
  def __call__(self, x: Array, train: bool = False) -> Array:
    assert sorted(self.order) == list('ACDN'), self.order
    norm = Norm('batch' if self.norm else None)
    conv = ChannelTransform(self.in_channels, self.out_channels,
                            if_equal=self.if_equal)
    drop = nn.Dropout(self.dropout, deterministic=not train)
    for name in self.order:
      if name == 'C':
        x = conv(x)
      elif name == 'D':
        x = drop(x)
      elif name == 'N':
        x = norm(x, train=train)
      elif name == 'A':
        x = activation(self.act_func, x)
    return x


class LinearBlock(nn.Module):
  """Norm -> Linear -> Dropout -> Act (Enformer.py:2050-2106)."""
  in_len: int
  out_len: int
  act_func: Optional[str] = 'relu'
  dropout: float = 0.0
  norm: bool = False
  bias: bool = True

  @nn.compact
  def __call__(self, x: Array, train: bool = False) -> Array:
    x = Norm('layer' if self.norm else None)(x, train=train)
    x = nn.Dense(self.out_len, use_bias=self.bias, dtype=x.dtype)(x)
    x = nn.Dropout(self.dropout, deterministic=not train)(x)
    return activation(self.act_func, x)


class FeedForwardBlock(nn.Module):
  """2-layer FFN: in -> 2*in (norm+act) -> in (Enformer.py:2010-2047)."""
  in_len: int
  dropout: float = 0.0
  act_func: str = 'relu'

  @nn.compact
  def __call__(self, x: Array, train: bool = False) -> Array:
    x = LinearBlock(self.in_len, self.in_len * 2, norm=True,
                    dropout=self.dropout, act_func=self.act_func)(
                        x, train=train)
    x = LinearBlock(self.in_len * 2, self.in_len, norm=False,
                    dropout=self.dropout, act_func=None)(x, train=train)
    return x


class Stem(nn.Module):
  """Stem conv + act (+ optional pool); takes one-hot DNA
  (Enformer.py:1754-1804 — its layer-norm is defined but unused)."""
  in_channels: int
  out_channels: int
  kernel_size: int
  act_func: str = 'relu'
  pool_func: Optional[str] = None
  pool_size: Optional[int] = None

  @nn.compact
  def __call__(self, x: Array, train: bool = False) -> Array:
    x = Conv1D(self.out_channels, self.kernel_size, dtype=x.dtype)(x)
    x = activation(self.act_func, x)
    return Pool(self.pool_func, self.pool_size,
                in_channels=self.out_channels)(x)


class ConvHead(nn.Module):
  """1x1-conv channel head + adaptive pool (Enformer.py:2131-2173).
  (B, L, C) -> (B, n_tasks)."""
  n_tasks: int
  in_channels: int
  act_func: Optional[str] = None
  pool_func: Optional[str] = 'avg'
  norm: bool = False

  @nn.compact
  def __call__(self, x: Array, train: bool = False) -> Array:
    x = ChannelTransformBlock(self.in_channels, self.n_tasks,
                              act_func=self.act_func, norm=self.norm)(
                                  x, train=train)
    return adaptive_pool(self.pool_func, x)
