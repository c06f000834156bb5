"""ConvGRU value/reward trunk (RNA tasks).

Flax rebuild of the reference ConvGRUTrunk + GRUBlock + ConvTower
(reference Enformer.py:1337-1426, 1571-1751), hard-wired for
task=="rna"/"rna_saluki" at Enformer.py:31-49: stem conv(4->64, k15) +
5 residual batch-norm conv blocks (k5, order "CDNRA") + bidirectional
GRU (fwd+bwd outputs summed, Enformer.py:1620) + 2-layer FFN.

The GRU replaces cuDNN (implicit native dep, SURVEY.md §2.1) with a
``jax.lax.scan`` over gates: input projections for the whole sequence
are one big (B,L,3H) matmul; the scan carries only the
(B,H) hidden state. Bidirectional = scan + flipped scan. Differentiable
by construction — no ``cudnn.enabled=False`` workaround needed for
classifier guidance (reference score.py:16).
"""

from __future__ import annotations

from typing import Optional

import flax.linen as nn
import jax
import jax.numpy as jnp

from svdd.models import blocks

Array = jnp.ndarray


class GRUCellScan(nn.Module):
  """Single-direction GRU over (B, L, C) via lax.scan.

  Gate math matches torch.nn.GRU:
    r = sig(W_ir x + b_ir + W_hr h + b_hr)
    z = sig(W_iz x + b_iz + W_hz h + b_hz)
    n = tanh(W_in x + b_in + r * (W_hn h + b_hn))
    h' = (1 - z) n + z h
  """
  hidden_size: int
  reverse: bool = False

  @nn.compact
  def __call__(self, x: Array) -> Array:
    H = self.hidden_size
    h0 = jnp.zeros((x.shape[0], H), x.dtype)
    # one bulk input projection: (B, L, 3H) — a single matmul
    xw = nn.Dense(3 * H, name='ih')(x)
    hh_kernel = self.param('hh_kernel', nn.initializers.lecun_normal(),
                           (H, 3 * H)).astype(x.dtype)
    hh_bias = self.param('hh_bias', nn.initializers.zeros,
                         (3 * H,)).astype(x.dtype)

    def step(h, xw_t):
      gates_h = h @ hh_kernel + hh_bias
      r = jax.nn.sigmoid(xw_t[..., :H] + gates_h[..., :H])
      z = jax.nn.sigmoid(xw_t[..., H:2 * H] + gates_h[..., H:2 * H])
      n = jnp.tanh(xw_t[..., 2 * H:] + r * gates_h[..., 2 * H:])
      h_new = (1 - z) * n + z * h
      return h_new, h_new

    xs = jnp.swapaxes(xw, 0, 1)        # (L, B, 3H)
    _, ys = jax.lax.scan(step, h0, xs, reverse=self.reverse)
    return jnp.swapaxes(ys, 0, 1)      # (B, L, H)


class GRUBlock(nn.Module):
  """Bidirectional GRU (sum of directions) + FFN (Enformer.py:1571-1630)."""
  in_channels: int
  n_layers: int = 1
  dropout: float = 0.0
  act_func: str = 'relu'
  norm: bool = False

  @nn.compact
  def __call__(self, x: Array, train: bool = False) -> Array:
    for layer in range(self.n_layers):
      fwd = GRUCellScan(self.in_channels, reverse=False,
                        name=f'gru_fwd_{layer}')(x)
      bwd = GRUCellScan(self.in_channels, reverse=True,
                        name=f'gru_bwd_{layer}')(x)
      x = fwd + bwd if layer == self.n_layers - 1 else jnp.concatenate(
          [fwd, bwd], axis=-1)
      # torch multi-layer GRU feeds concat(fwd,bwd) to the next layer;
      # only the final output is direction-summed (Enformer.py:1620).
      if layer < self.n_layers - 1:
        x = nn.Dropout(self.dropout, deterministic=not train)(x)
    # FFN always layer-norms its first dense, matching the reference
    # (its GRUBlock ``norm`` arg is accepted but unused).
    x = blocks.FeedForwardBlock(
        self.in_channels, dropout=self.dropout,
        act_func=self.act_func)(x, train=train)
    return x


class ConvTower(nn.Module):
  """Stem + (n_blocks-1) conv blocks (Enformer.py:1634-1751)."""
  stem_in_channels: int
  stem_channels: int
  stem_kernel_size: int
  n_blocks: int = 2
  channel_init: int = 16
  channel_mult: float = 1.0
  kernel_size: int = 5
  act_func: str = 'relu'
  norm: bool = False
  pool_func: Optional[str] = None
  pool_size: Optional[int] = None
  residual: bool = False
  dropout: float = 0.0
  order: str = 'CDNRA'

  @nn.compact
  def __call__(self, x: Array, train: bool = False) -> Array:
    x = blocks.Stem(self.stem_in_channels, self.stem_channels,
                    self.stem_kernel_size, act_func=self.act_func)(
                        x, train=train)
    in_ch = self.stem_channels
    out_ch = self.channel_init
    for _ in range(1, self.n_blocks):
      x = blocks.ConvBlock(
          in_channels=in_ch, out_channels=out_ch,
          kernel_size=self.kernel_size, act_func=self.act_func,
          norm=self.norm, residual=self.residual,
          pool_func=self.pool_func, pool_size=self.pool_size,
          dropout=self.dropout, order=self.order)(x, train=train)
      in_ch = out_ch
      out_ch = int(out_ch * self.channel_mult)
    return x


class ConvGRUTrunk(nn.Module):
  """RNA value-net trunk (Enformer.py:1337-1426 with the BaseModel
  rna hyperparameters at :31-49). Input one-hot (B, L, 4)."""
  stem_in_channels: int = 4
  stem_channels: int = 64
  stem_kernel_size: int = 15
  n_conv: int = 6
  channel_init: int = 64
  channel_mult: float = 1.0
  kernel_size: int = 5
  act_func: str = 'relu'
  conv_norm: bool = True
  pool_func: Optional[str] = None
  pool_size: Optional[int] = None
  residual: bool = True
  n_gru: int = 1
  dropout: float = 0.1
  gru_norm: bool = True

  @nn.compact
  def __call__(self, x: Array, train: bool = False) -> Array:
    x = ConvTower(
        stem_in_channels=self.stem_in_channels,
        stem_channels=self.stem_channels,
        stem_kernel_size=self.stem_kernel_size,
        n_blocks=self.n_conv,
        channel_init=self.channel_init,
        channel_mult=self.channel_mult,
        kernel_size=self.kernel_size,
        act_func=self.act_func,
        norm=self.conv_norm,
        pool_func=self.pool_func,
        pool_size=self.pool_size,
        residual=self.residual,
        dropout=self.dropout,
        order='CDNRA')(x, train=train)
    x = GRUBlock(self.stem_channels, n_layers=self.n_gru,
                 dropout=self.dropout, act_func=self.act_func,
                 norm=self.gru_norm)(x, train=train)
    return x


class ConvGRUValueModel(nn.Module):
  """Trunk + ConvHead scalar value model for RNA (Enformer.py:33-50).
  Input one-hot (B, L, 4) -> (B,) value. ``in_channels=6`` builds the
  saluki stability-oracle variant (Enformer.py:110-127, whose
  ConvGRUTrunk keeps the 6-channel default stem)."""
  n_tasks: int = 1
  dropout: float = 0.1
  in_channels: int = 4
  compute_dtype: jnp.dtype = jnp.float32

  @nn.compact
  def __call__(self, x: Array, train: bool = False) -> Array:
    x = x.astype(self.compute_dtype)
    x = ConvGRUTrunk(stem_in_channels=self.in_channels,
                     dropout=self.dropout)(x, train=train)
    x = blocks.ConvHead(n_tasks=self.n_tasks, in_channels=64,
                        act_func=None, pool_func='avg', norm=False)(
                            x, train=train)
    x = x.astype(jnp.float32)
    return x[..., 0] if self.n_tasks == 1 else x
