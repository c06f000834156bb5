"""CNN denoiser backbone (default for both bio tasks).

Flax rebuild of the reference CNNModel / PromoterModel
(reference models/dnaconv.py:135-247; selected by
``backbone: cnn`` in configs_gosai/config_gosai.yaml:12). Channel-last
(B, L, C) layout throughout so XLA lowers the dilated 1-D convs to
batched matmuls without transposes.

Architecture parity notes:
  * 5 * num_cnn_stacks dilated convs, k=9, dilation pattern
    [1, 1, 4, 16, 64] with each distinct conv repeated ``num_cnn_stacks``
    times *consecutively* (dnaconv.py:156-161 builds
    ``[copy.deepcopy(l) for l in convs for _ in range(stacks)]`` —
    layer varies slowly).
  * per-layer time injection h + Dense(time_emb) (dnaconv.py:196-199)
  * LayerNorm over channels, ReLU conv, residual add (dnaconv.py:200-205)
  * final 1x1 conv -> ReLU -> 1x1 conv to vocab (dnaconv.py:164-166)
  * GaussianFourierProjection time features with frozen random weights
    (dnaconv.py:8-21) — stored in the 'buffers' collection, never
    updated by the optimizer.
"""

from __future__ import annotations

import os
from typing import Optional

import flax.linen as nn
import jax
import jax.numpy as jnp

from svdd.config import Config
from svdd.ops.cnn_layer import cnn_layer_reference
from svdd.ops.conv1d import Conv1D

Array = jnp.ndarray


class _LNParams(nn.Module):
  """Param-holder with nn.LayerNorm's exact tree ({scale, bias})."""

  @nn.compact
  def __call__(self, c: int):
    return (self.param('scale', nn.initializers.ones, (c,)),
            self.param('bias', nn.initializers.zeros, (c,)))


class _ConvParams(nn.Module):
  """Param-holder with ops.conv1d.Conv1D's exact tree
  ({kernel (K, Cin, Cout), bias (Cout,)})."""
  features: int
  kernel_size: int

  @nn.compact
  def __call__(self, c_in: int):
    return (self.param('kernel', nn.initializers.lecun_normal(),
                       (self.kernel_size, c_in, self.features)),
            self.param('bias', nn.initializers.zeros,
                       (self.features,)))


class GaussianFourierProjection(nn.Module):
  """Random-feature time encoding (dnaconv.py:8-21). W is a frozen
  buffer, matching ``requires_grad=False`` in the reference."""
  embed_dim: int
  scale: float = 30.0

  @nn.compact
  def __call__(self, t: Array) -> Array:
    w = self.variable(
        'buffers', 'W',
        lambda: self.scale * jax.random.normal(
            self.make_rng('params'), (self.embed_dim // 2,)))
    x_proj = t[:, None] * w.value[None, :] * 2 * jnp.pi
    return jnp.concatenate([jnp.sin(x_proj), jnp.cos(x_proj)], axis=-1)


class CNNModel(nn.Module):
  """Dilated-conv MDLM denoiser (dnaconv.py:135-247).

  Input: int tokens (B, L) (or one-hot (B, L, V) via ``x_onehot``, the
  ``forward2`` path used by DPS gradient guidance, dnaconv.py:212-247).
  Output: logits (B, L, V).
  """
  config: Config
  alphabet_size: int = 5
  num_cls: int = 3
  classifier: bool = False
  compute_dtype: jnp.dtype = jnp.float32

  @nn.compact
  def __call__(self, seq: Array, sigma: Array, *,
               x_onehot: Optional[Array] = None,
               cls: Optional[Array] = None,
               train: bool = False) -> Array:
    mcfg = self.config.model
    hidden = mcfg.hidden_dim
    num_layers = 5 * mcfg.num_cnn_stacks
    dtype = self.compute_dtype

    if x_onehot is None:
      feat = jax.nn.one_hot(seq, self.alphabet_size, dtype=dtype)
    else:
      feat = x_onehot.astype(dtype)

    # time embedding: relu(Linear(GFP(sigma)))
    t_feats = GaussianFourierProjection(embed_dim=hidden)(sigma)
    time_emb = jax.nn.relu(
        nn.Dense(hidden, dtype=dtype, name='time_linear')(
            t_feats.astype(dtype)))

    feat = jax.nn.relu(
        Conv1D(hidden, 9, dtype=dtype, name='stem')(feat))

    # classifier-free guidance conditioning (dnaconv.py:174-177,
    # 198-199): class embedding added per layer like the time emb
    cls_emb = None
    if mcfg.cls_free_guidance and not self.classifier:
      if cls is None:
        cls = jnp.full((feat.shape[0],), self.num_cls, jnp.int32)
      cls_emb = nn.Embed(self.num_cls + 1, hidden, dtype=dtype,
                         name='cls_embedder')(cls)

    # dilation varies slowly: [1]*s + [1]*s + [4]*s + [16]*s + [64]*s
    dilations = [d for d in (1, 1, 4, 16, 64)
                 for _ in range(mcfg.num_cnn_stacks)]
    assert len(dilations) == num_layers

    # Each layer is relu(conv(LN(x + bias_row))) + x
    # (ops/cnn_layer.py). Params live in holder modules so the tree
    # keeps the historical nn.LayerNorm / Conv1D names.
    #
    # SVDD_REMAT_CNN_LAYERS=1 wraps each layer body in jax.checkpoint,
    # trading a recomputed forward for activation memory in the
    # 20-layer backward.
    remat = os.environ.get('SVDD_REMAT_CNN_LAYERS', '0') == '1'
    for i, dilation in enumerate(dilations):
      ln_scale, ln_bias = _LNParams(name=f'norm_{i}')(hidden)
      kernel, conv_bias = _ConvParams(
          features=hidden, kernel_size=9, name=f'conv_{i}')(hidden)
      bias_row = nn.Dense(hidden, dtype=dtype, name=f'time_{i}')(
          time_emb)
      if cls_emb is not None:
        bias_row = bias_row + nn.Dense(
            hidden, dtype=dtype, name=f'cls_{i}')(cls_emb)
      # dropout is applied to the layer input; the residual adds the
      # pre-dropout activations (dnaconv.py:200-205)
      h = (nn.Dropout(mcfg.dropout, deterministic=False)(feat)
           if train and mcfg.dropout > 0 else feat)
      body = lambda *a, _d=dilation: cnn_layer_reference(
          *a[:6], dilation=_d, residual=a[6])
      if remat:
        body = jax.checkpoint(body)
      feat = body(h, bias_row, ln_scale, ln_bias,
                  kernel.astype(dtype), conv_bias, feat)

    feat = Conv1D(hidden, 1, dtype=dtype, name='final_0')(feat)
    feat = jax.nn.relu(feat)
    out_dim = hidden if self.classifier else self.alphabet_size
    feat = Conv1D(out_dim, 1, dtype=dtype, name='final_1')(feat)

    if self.classifier:
      feat = feat.mean(axis=1)
      feat = nn.Dense(hidden, dtype=dtype, name='cls_0')(feat)
      feat = jax.nn.relu(feat)
      feat = nn.Dense(self.num_cls, dtype=dtype, name='cls_1')(feat)
      return feat.astype(jnp.float32)
    return feat.astype(jnp.float32)
