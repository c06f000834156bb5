"""Enformer value/reward trunk (DNA enhancer task).

Flax rebuild of the reference EnformerTrunk (reference
Enformer.py:1271-1334): conv tower with attention pooling and an
exponential channel schedule to 1536 (EnformerConvTower, :1807-1884),
11 relative-position transformer blocks (EnformerTransformerTower /
Block, :1887-2007, which wrap enformer_pytorch.Attention), and a
pointwise 2x-channel conv head stage.

The relative-position attention (exponential / central-mask / gamma
positional basis + relative-shift) is re-derived here in pure JAX from
the published Enformer architecture — at L=200 the post-tower sequence
is tiny (200 / 2^7 -> 2), so plain XLA dot-product attention serves
(SURVEY.md §7.2 step 5).
"""

from __future__ import annotations

import math
import os

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np

from svdd.models import blocks

Array = jnp.ndarray


def exponential_linspace_int(start: int, end: int, num: int,
                             divisible_by: int = 1) -> list[int]:
  """Exponentially spaced channel schedule (enformer_pytorch util used
  at Enformer.py:1838)."""
  def _round(x):
    return int(round(x / divisible_by) * divisible_by)
  base = math.exp(math.log(end / start) / (num - 1))
  return [_round(start * base ** i) for i in range(num)]


# ---------------------------------------------------------------------------
# Relative positional basis (Enformer's exponential/central_mask/gamma)
# ---------------------------------------------------------------------------


def _pos_feats_exponential(positions: np.ndarray, features: int,
                           seq_len: int, min_half_life: float = 3.0
                           ) -> np.ndarray:
  max_range = math.log(seq_len) / math.log(2.0)
  half_life = 2.0 ** np.linspace(min_half_life, max_range, features)
  return np.exp(-math.log(2.0) / half_life[None, :]
                * np.abs(positions)[:, None])


def _pos_feats_central_mask(positions: np.ndarray, features: int
                            ) -> np.ndarray:
  center_widths = 2.0 ** np.arange(1, features + 1) - 1
  return (center_widths[None, :] > np.abs(positions)[:, None]
          ).astype(np.float32)


def _gamma_log_pdf(x: np.ndarray, concentration: np.ndarray,
                   rate: np.ndarray) -> np.ndarray:
  # log p = conc*log(rate) + (conc-1)*log(x) - rate*x - lgamma(conc)
  from scipy.special import gammaln
  logx = np.where(x > 0, np.log(np.maximum(x, 1e-20)), -np.inf)
  with np.errstate(invalid='ignore'):
    out = (np.log(rate) * concentration
           + np.where(concentration == 1.0, 0.0,
                      logx * (concentration - 1))
           - rate * x - gammaln(concentration))
  return np.where(np.isfinite(out), out, -np.inf)


def _pos_feats_gamma(positions: np.ndarray, features: int, seq_len: int,
                     eps: float = 1e-8) -> np.ndarray:
  stddev = seq_len / (2 * features)
  start_mean = seq_len / features
  mean = np.linspace(start_mean, seq_len, features)[None, :]
  concentration = (mean / stddev) ** 2
  rate = mean / stddev ** 2
  # normalize in LOG space: at short seq_len the concentration grows to
  # ~1e4 and the pdf under/overflows float64, which NaN'd the
  # probs/amax normalization
  logp = _gamma_log_pdf(np.abs(positions).astype(np.float64)[:, None],
                        concentration, rate)
  logmax = np.amax(logp, axis=-1, keepdims=True)
  logmax = np.where(np.isfinite(logmax), logmax, 0.0)
  probs = np.exp(logp - logmax) + eps
  return (probs / np.amax(probs, axis=-1, keepdims=True)
          ).astype(np.float32)


def relative_positional_basis(seq_len: int, feature_size: int
                              ) -> np.ndarray:
  """Positional embedding over distances [-(L-1), L-1]: three basis
  families, each mirrored by sign(distance). Shape (2L-1, feature_size).
  Computed host-side once (static) and baked as a constant."""
  distances = np.arange(-seq_len + 1, seq_len)
  num_components = 6   # 3 basis fns x 2 (symmetric + antisymmetric)
  # at the reference size (192) this divides exactly; for other sizes
  # the basis is simply 6 * floor(size/6) wide — to_rel_k adapts.
  n = max(1, feature_size // num_components)
  emb = np.concatenate([
      _pos_feats_exponential(distances, n, seq_len),
      _pos_feats_central_mask(distances, n),
      _pos_feats_gamma(distances, n, seq_len),
  ], axis=-1)
  emb = np.concatenate([emb, np.sign(distances)[:, None] * emb], axis=-1)
  return emb.astype(np.float32)


def relative_shift(x: Array) -> Array:
  """Skew trick turning (B, H, L, 2L-1) rel-position logits into
  (B, H, L, L) aligned ones (enformer_pytorch relative_shift)."""
  b, h, l, _ = x.shape
  x = jnp.pad(x, ((0, 0), (0, 0), (0, 0), (1, 0)))   # (b,h,l,2l)
  x = x.reshape(b, h, 2 * l, l)
  x = x[:, :, 1:, :]                                 # (b,h,2l-1,l)
  x = x.reshape(b, h, l, 2 * l - 1)
  return x[..., :l]


class EnformerAttention(nn.Module):
  """MHA with Enformer relative positional bias
  (enformer_pytorch.Attention, used at Enformer.py:1905-1915)."""
  dim: int
  heads: int = 8
  dim_key: int = 64
  dim_value: int = 192
  num_rel_pos_features: int = 192

  @nn.compact
  def __call__(self, x: Array, train: bool = False) -> Array:
    b, n, _ = x.shape
    h, dk, dv = self.heads, self.dim_key, self.dim_value

    q = nn.Dense(h * dk, use_bias=False, dtype=x.dtype, name='to_q')(x)
    k = nn.Dense(h * dk, use_bias=False, dtype=x.dtype, name='to_k')(x)
    v = nn.Dense(h * dv, use_bias=False, dtype=x.dtype, name='to_v')(x)

    rel_content_bias = self.param(
        'rel_content_bias', nn.initializers.normal(1.0), (1, h, 1, dk))
    rel_pos_bias = self.param(
        'rel_pos_bias', nn.initializers.normal(1.0), (1, h, 1, dk))

    q = q.reshape(b, n, h, dk).transpose(0, 2, 1, 3)
    k = k.reshape(b, n, h, dk).transpose(0, 2, 1, 3)
    v = v.reshape(b, n, h, dv).transpose(0, 2, 1, 3)
    q = q / math.sqrt(dk)

    content_logits = jnp.einsum(
        'bhid,bhjd->bhij', q + rel_content_bias.astype(q.dtype), k)

    positions = jnp.asarray(
        relative_positional_basis(n, self.num_rel_pos_features),
        dtype=x.dtype)
    rel_k = nn.Dense(h * dk, use_bias=False, dtype=x.dtype,
                     name='to_rel_k')(positions)
    rel_k = rel_k.reshape(2 * n - 1, h, dk).transpose(1, 0, 2)
    rel_logits = jnp.einsum(
        'bhid,hjd->bhij', q + rel_pos_bias.astype(q.dtype), rel_k)
    rel_logits = relative_shift(rel_logits)

    attn = jax.nn.softmax(
        (content_logits + rel_logits).astype(jnp.float32),
        axis=-1).astype(x.dtype)
    # attention-map extraction hook (reference score.py
    # get_attention_scores:393-437): a no-op unless the caller applies
    # with mutable=['intermediates'] (analysis/interpret.py)
    self.sow('intermediates', 'attention', attn)
    out = jnp.einsum('bhij,bhjd->bhid', attn, v)
    out = out.transpose(0, 2, 1, 3).reshape(b, n, h * dv)
    return nn.Dense(self.dim, dtype=x.dtype, name='to_out')(out)


class EnformerTransformerBlock(nn.Module):
  """Pre-LN MHA + FFN with residuals (Enformer.py:1887-1949)."""
  in_len: int
  n_heads: int = 8
  key_len: int = 64
  attn_dropout: float = 0.05
  pos_dropout: float = 0.01
  ff_dropout: float = 0.4

  @nn.compact
  def __call__(self, x: Array, train: bool = False) -> Array:
    skip = x
    # epsilon 1e-5 matches torch.nn.LayerNorm for checkpoint parity;
    # FastLayerNorm keeps the qkv-dot operand chain bf16 (blocks.py)
    x = blocks.FastLayerNorm(epsilon=1e-5, dtype=x.dtype,
                             name='LayerNorm_0')(x)
    x = EnformerAttention(
        dim=self.in_len, heads=self.n_heads, dim_key=self.key_len,
        dim_value=self.in_len // self.n_heads,
        num_rel_pos_features=self.in_len // self.n_heads)(
            x, train=train)
    x = nn.Dropout(self.ff_dropout, deterministic=not train)(x)
    x = skip + x
    ffn_in = x
    x = blocks.FeedForwardBlock(self.in_len, dropout=self.ff_dropout,
                                act_func='relu')(x, train=train)
    return ffn_in + x


class EnformerConvTower(nn.Module):
  """Stem + attention-pooled conv blocks with exponential channel
  schedule (Enformer.py:1807-1884). Input one-hot (B, L, 4)."""
  n_blocks: int = 7
  out_channels: int = 1536

  @nn.compact
  def __call__(self, x: Array, train: bool = False) -> Array:
    half = self.out_channels // 2
    from svdd.ops.conv1d import Conv1D
    x = Conv1D(half, 15, dtype=x.dtype, name='stem_conv')(x)
    x = blocks.ConvBlock(
        in_channels=half, out_channels=half, kernel_size=1,
        act_func='gelu_enformer', residual=True, order='NACDR',
        pool_func='attn', pool_size=2, name='stem_block')(
            x, train=train)

    filters = [half] + exponential_linspace_int(
        half, self.out_channels, num=self.n_blocks - 1, divisible_by=128)
    for i in range(1, self.n_blocks):
      x = blocks.ConvBlock(
          in_channels=filters[i - 1], out_channels=filters[i],
          kernel_size=5, act_func='gelu_enformer', residual=False,
          order='NACDR', name=f'conv_{i}')(x, train=train)
      x = blocks.ConvBlock(
          in_channels=filters[i], out_channels=filters[i],
          kernel_size=1, act_func='gelu_enformer', residual=True,
          order='NACDR', pool_func='attn', pool_size=2,
          name=f'pool_{i}')(x, train=train)
    return x


class EnformerTrunk(nn.Module):
  """Conv tower + transformer tower + pointwise 2x conv
  (Enformer.py:1271-1334). (B, L, 4) one-hot -> (B, L', 2*channels)."""
  n_conv: int = 7
  channels: int = 1536
  n_transformers: int = 11
  n_heads: int = 8
  key_len: int = 64
  attn_dropout: float = 0.05
  pos_dropout: float = 0.01
  ff_dropout: float = 0.4
  crop_len: int = 0
  # scan-over-layers: the 11 identical transformer blocks compile as
  # ONE block body inside a lax.scan with stacked params instead of 11
  # inlined copies — an order-of-magnitude smaller XLA graph for the
  # guided-decode scan, identical math.
  scan_blocks: bool = True

  @nn.compact
  def __call__(self, x: Array, train: bool = False) -> Array:
    x = EnformerConvTower(n_blocks=self.n_conv,
                          out_channels=self.channels)(x, train=train)
    block_kwargs = dict(
        in_len=self.channels, n_heads=self.n_heads,
        key_len=self.key_len, attn_dropout=self.attn_dropout,
        pos_dropout=self.pos_dropout, ff_dropout=self.ff_dropout)
    if self.scan_blocks and self.n_transformers > 1:
      class _ScanBody(nn.Module):
        @nn.compact
        def __call__(self, carry, _):
          return EnformerTransformerBlock(**block_kwargs)(
              carry, train=train), None

      # SVDD_UNROLL_TOWER=n unrolls the scan body n-fold (param tree
      # unchanged — still stacked): trades XLA graph size for the
      # per-iteration loop overhead.
      unroll = int(os.environ.get('SVDD_UNROLL_TOWER', '1'))
      scanner = nn.scan(
          _ScanBody,
          variable_axes={'params': 0, 'batch_stats': 0,
                         'intermediates': 0},
          split_rngs={'params': True, 'dropout': True},
          length=self.n_transformers,
          unroll=min(unroll, self.n_transformers))
      x, _ = scanner(name='transformer_stack')(x, None)
    else:
      for i in range(self.n_transformers):
        x = EnformerTransformerBlock(
            **block_kwargs, name=f'transformer_{i}')(x, train=train)
    x = blocks.ConvBlock(
        in_channels=self.channels, out_channels=self.channels * 2,
        kernel_size=1, act_func='gelu_enformer',
        dropout=self.ff_dropout // 8, order='NACDR',
        name='pointwise')(x, train=train)
    x = blocks.gelu_enformer(x)
    if self.crop_len:
      x = x[:, self.crop_len:-self.crop_len]
    return x


class TimeEmbedding(nn.Module):
  """Per-timestep additive embedding for the timed value-model variant
  (Enformer.py TimedEnformerTrunk:1202-1268)."""
  max_time_steps: int = 128
  embedding_size: int = 4

  @nn.compact
  def __call__(self, time_indices: Array) -> Array:
    table = self.param('embedding', nn.initializers.normal(1.0),
                       (self.max_time_steps, self.embedding_size))
    return table[time_indices]


class EnformerValueModel(nn.Module):
  """Trunk + ConvHead scalar value model for DNA (decode.py:78-80:
  EnformerTrunk + ConvHead(n_tasks=1, in_channels=2*1536, pool='avg')).

  ``timed=True`` adds the 128-step time embedding of
  TimedEnformerTrunk (Enformer.py:1255-1266).
  """
  n_tasks: int = 1
  n_conv: int = 7
  channels: int = 1536
  n_transformers: int = 11
  n_heads: int = 8
  key_len: int = 64
  timed: bool = False
  compute_dtype: jnp.dtype = jnp.float32

  @nn.compact
  def __call__(self, x: Array, time_indices: Array | None = None,
               train: bool = False) -> Array:
    x = x.astype(self.compute_dtype)
    if self.timed:
      if time_indices is None:
        raise ValueError('timed model requires time_indices')
      emb = TimeEmbedding()(time_indices)
      x = x + 0.01 * emb
    x = EnformerTrunk(
        n_conv=self.n_conv, channels=self.channels,
        n_transformers=self.n_transformers, n_heads=self.n_heads,
        key_len=self.key_len)(x, train=train)
    x = blocks.ConvHead(n_tasks=self.n_tasks,
                        in_channels=2 * self.channels,
                        act_func=None, pool_func='avg', norm=False)(
                            x, train=train)
    x = x.astype(jnp.float32)
    return x[..., 0] if self.n_tasks == 1 else x
