"""Basenji trunk — the reference's unused alternative value-net tower
(reference Enformer.py:1494-1568 + dilated_residual:1429-1460):
conv tower + dilated-residual tower + 1x1 conv head + adaptive pool.
Included for component-inventory parity (SURVEY.md §2)."""

from __future__ import annotations

import flax.linen as nn
import jax.numpy as jnp

from svdd.models import blocks
from svdd.models.convgru import ConvTower

Array = jnp.ndarray


class DilatedResidualBlock(nn.Module):
  """gelu conv (dilated) -> gelu conv (1x) -> residual add
  (Enformer.py dilated_residual:1429-1460)."""
  in_channels: int
  channels: int
  kernel_size: int = 3
  dilation: int = 1
  dropout: float = 0.0

  @nn.compact
  def __call__(self, x: Array, train: bool = False) -> Array:
    h = blocks.ConvBlock(
        self.in_channels, self.channels, self.kernel_size,
        dilation=self.dilation, act_func='gelu', norm=True,
        order='NACDR')(x, train=train)
    h = blocks.ConvBlock(
        self.channels, self.in_channels, self.kernel_size,
        act_func='gelu', norm=True, dropout=self.dropout,
        order='NACDR')(h, train=train)
    return x + h


class Basenji(nn.Module):
  """(Enformer.py:1494-1568). Input one-hot (B, L, 4) -> (B, n_tasks)."""
  n_tasks: int = 1
  conv_blocks: int = 4
  channel_init: int = 256
  kernel_size: int = 5
  pool_func: str = 'max'
  conv_dropout: float = 0.05
  residual_channels: int = 108
  residual_blocks: int = 6
  residual_dropout: float = 0.1
  conv_channel_mult: float = 1.125
  dilation_mult: float = 1.2
  final_pool_func: str = 'avg'

  @nn.compact
  def __call__(self, x: Array, train: bool = False) -> Array:
    x = ConvTower(
        stem_in_channels=4,
        stem_channels=self.channel_init,
        stem_kernel_size=15,
        n_blocks=self.conv_blocks,
        channel_init=self.channel_init,
        channel_mult=self.conv_channel_mult,
        kernel_size=self.kernel_size,
        act_func='gelu',
        norm=True,
        pool_func=self.pool_func,
        pool_size=2,
        residual=True,
        dropout=self.conv_dropout)(x, train=train)
    channels = x.shape[-1]
    dilation = 1.0
    for _ in range(self.residual_blocks):
      x = DilatedResidualBlock(
          channels, self.residual_channels, self.kernel_size,
          dilation=max(1, int(round(dilation))),
          dropout=self.residual_dropout)(x, train=train)
      dilation *= self.dilation_mult
    x = blocks.ConvBlock(channels, channels, 1,
                         dropout=self.conv_dropout)(x, train=train)
    x = blocks.ChannelTransform(channels, self.n_tasks)(x)
    x = blocks.adaptive_pool(self.final_pool_func, x)
    return x[..., 0] if self.n_tasks == 1 else x
