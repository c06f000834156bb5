"""Hand-built torch mirrors of the reference architectures: the value
nets and the CNN denoiser.

The reference's Enformer.py cannot be imported stand-alone (it pulls in
enformer_pytorch, grelu, hydra and lightning at module level,
Enformer.py:8-19), so full-model importer parity tests need local torch
replicas. Every module here reproduces the corresponding reference
module's *state-dict key layout* exactly (same attribute names, same
nested-module structure) so that the importers in ``svdd.importers``
are exercised against the same key schema a real reference checkpoint
has (saved by trainer.py:73-96 as ``embedding.*`` / ``head.*``).

Behavior citations:
  grelu-style blocks   reference Enformer.py:2010-2660
  ConvTower/GRUBlock   reference Enformer.py:1571-1751
  ConvGRUTrunk         reference Enformer.py:1337-1426
  EnformerConvTower    reference Enformer.py:1807-1884
  Transformer tower    reference Enformer.py:1887-2007
  EnformerTrunk        reference Enformer.py:1271-1334
  TimedEnformerTrunk   reference Enformer.py:1202-1268
  CNNModel             reference models/dnaconv.py:8-21, 135-247
  noise schedules      reference noise_schedule.py:60-152
  Attention/AttentionPool/relative_shift/positional features follow the
  published enformer-pytorch model (imported at Enformer.py:8-9),
  re-derived here from its documented math.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


# ---------------------------------------------------------------------------
# grelu-style primitive layers (Enformer.py:2371-2660)
# ---------------------------------------------------------------------------


class GELUEnformer(nn.Module):
  def forward(self, x):
    return torch.sigmoid(1.702 * x) * x


class Activation(nn.Module):
  def __init__(self, func: Optional[str]):
    super().__init__()
    table = {
        'relu': nn.ReLU, 'elu': nn.ELU, 'gelu': nn.GELU,
        'gelu_enformer': GELUEnformer, 'softplus': nn.Softplus,
        None: nn.Identity,
    }
    self.layer = table[func]()

  def forward(self, x):
    return self.layer(x)


class Dropout(nn.Module):
  def __init__(self, p: float = 0.0):
    super().__init__()
    self.layer = nn.Dropout(p) if p > 0 else nn.Identity()

  def forward(self, x):
    return self.layer(x)


class Norm(nn.Module):
  """Batch/layer norm with the reference's auto-transpose shim
  (Enformer.py:2504-2558)."""

  def __init__(self, func: Optional[str] = None,
               in_dim: Optional[int] = None):
    super().__init__()
    self.func = func
    self.in_dim = in_dim
    if func == 'batch':
      self.layer = nn.BatchNorm1d(in_dim)
    elif func == 'layer':
      self.layer = nn.LayerNorm(in_dim)
    else:
      self.layer = nn.Identity()

  def forward(self, x):
    if self.func == 'layer' and x.shape[2] != self.in_dim:
      return self.layer(x.transpose(1, 2)).transpose(1, 2)
    if self.func == 'batch' and x.shape[1] != self.in_dim:
      return self.layer(x.transpose(1, 2)).transpose(1, 2)
    return self.layer(x)


class ChannelTransform(nn.Module):
  def __init__(self, in_channels: int, out_channels: int = 1,
               if_equal: bool = False):
    super().__init__()
    if in_channels == out_channels and not if_equal:
      self.layer = nn.Identity()
    else:
      self.layer = nn.Conv1d(in_channels, out_channels, 1, padding='same')

  def forward(self, x):
    return self.layer(x)


class AttentionPool(nn.Module):
  """enformer-pytorch AttentionPool: per-group softmax over logits from
  a 1x1 Conv2d initialized at 2x identity. Input (B, C, L)."""

  def __init__(self, dim: int, pool_size: int = 2):
    super().__init__()
    self.pool_size = pool_size
    self.to_attn_logits = nn.Conv2d(dim, dim, 1, bias=False)
    nn.init.dirac_(self.to_attn_logits.weight)
    with torch.no_grad():
      self.to_attn_logits.weight.mul_(2.0)

  def forward(self, x):
    b, c, n = x.shape
    remainder = n % self.pool_size
    if remainder:
      pad = self.pool_size - remainder
      x = F.pad(x, (0, pad), value=0.0)
      mask = torch.zeros((b, 1, n), dtype=torch.bool, device=x.device)
      mask = F.pad(mask, (0, pad), value=True)
    x = x.reshape(b, c, -1, self.pool_size)
    logits = self.to_attn_logits(x)
    if remainder:
      mask_value = -torch.finfo(logits.dtype).max
      logits = logits.masked_fill(
          mask.reshape(b, 1, -1, self.pool_size), mask_value)
    attn = logits.softmax(dim=-1)
    return (x * attn).sum(dim=-1)


class Pool(nn.Module):
  def __init__(self, func: Optional[str], pool_size: Optional[int] = None,
               in_channels: Optional[int] = None):
    super().__init__()
    if func == 'avg':
      self.layer = nn.AvgPool1d(kernel_size=pool_size)
    elif func == 'max':
      self.layer = nn.MaxPool1d(kernel_size=pool_size)
    elif func == 'attn':
      self.layer = AttentionPool(dim=in_channels, pool_size=pool_size)
    else:
      self.layer = nn.Identity()

  def forward(self, x):
    return self.layer(x)


class AdaptivePool(nn.Module):
  def __init__(self, func: Optional[str] = None):
    super().__init__()
    if func == 'avg':
      self.layer = nn.AdaptiveAvgPool1d(1)
    elif func == 'max':
      self.layer = nn.AdaptiveMaxPool1d(1)
    else:
      self.layer = nn.Identity()

  def forward(self, x):
    return self.layer(x)


class Crop(nn.Module):
  def __init__(self, crop_len: int = 0):
    super().__init__()
    self.layer = (nn.Identity() if crop_len == 0
                  else nn.ConstantPad1d(-crop_len, 0))

  def forward(self, x):
    return self.layer(x)


# ---------------------------------------------------------------------------
# grelu-style composite blocks (Enformer.py:2010-2368)
# ---------------------------------------------------------------------------


class LinearBlock(nn.Module):
  def __init__(self, in_len: int, out_len: int, act_func='relu',
               dropout: float = 0.0, norm: bool = False, bias: bool = True):
    super().__init__()
    self.norm = Norm('layer' if norm else None, in_dim=in_len)
    self.linear = nn.Linear(in_len, out_len, bias=bias)
    self.dropout = Dropout(dropout)
    self.act = Activation(act_func)

  def forward(self, x):
    return self.act(self.dropout(self.linear(self.norm(x))))


class FeedForwardBlock(nn.Module):
  """dense1/dense2 used; ``dense`` is the reference's dead saluki branch
  — present only so state-dict keys match (Enformer.py:2030-2032)."""

  def __init__(self, in_len: int, dropout: float = 0.0, act_func='relu'):
    super().__init__()
    self.dense1 = LinearBlock(in_len, in_len * 2, norm=True,
                              dropout=dropout, act_func=act_func)
    self.dense2 = LinearBlock(in_len * 2, in_len, norm=False,
                              dropout=dropout, act_func=None)
    self.dense = LinearBlock(in_len, in_len, norm=True,
                             dropout=dropout, act_func=act_func)

  def forward(self, x):
    return self.dense2(self.dense1(x))


class ConvBlock(nn.Module):
  def __init__(self, in_channels, out_channels, kernel_size, dilation=1,
               act_func='relu', pool_func=None, pool_size=None,
               dropout: float = 0.0, norm: bool = True,
               residual: bool = False, order: str = 'CDNRA'):
    super().__init__()
    self.order = order
    if norm:
      norm_dim = (out_channels if order.index('N') > order.index('C')
                  else in_channels)
      self.norm = Norm('batch', in_dim=norm_dim)
    else:
      self.norm = Norm(None)
    self.conv = nn.Conv1d(in_channels, out_channels, kernel_size,
                          padding='same', dilation=dilation)
    self.act = Activation(act_func)
    self.pool = Pool(pool_func, pool_size=pool_size,
                     in_channels=out_channels)
    self.dropout = Dropout(dropout)
    self.residual = residual
    if residual:
      self.channel_transform = ChannelTransform(in_channels, out_channels)

  def forward(self, x):
    if self.residual:
      x_input = self.channel_transform(x)
    for name in self.order:
      if name == 'C':
        x = self.conv(x)
      elif name == 'D':
        x = self.dropout(x)
      elif name == 'N':
        x = self.norm(x)
      elif name == 'R' and self.residual:
        x = x + x_input
      elif name == 'A':
        x = self.act(x)
    return self.pool(x)


class ChannelTransformBlock(nn.Module):
  def __init__(self, in_channels, out_channels, norm: bool = False,
               act_func=None, dropout: float = 0.0, order: str = 'CDNA',
               if_equal: bool = False):
    super().__init__()
    self.order = order
    if norm:
      norm_dim = (out_channels if order.index('N') > order.index('C')
                  else in_channels)
      self.norm = Norm('batch', in_dim=norm_dim)
    else:
      self.norm = Norm(None)
    self.conv = ChannelTransform(in_channels, out_channels,
                                 if_equal=if_equal)
    self.act = Activation(act_func)
    self.dropout = Dropout(dropout)

  def forward(self, x):
    for name in self.order:
      if name == 'C':
        x = self.conv(x)
      elif name == 'D':
        x = self.dropout(x)
      elif name == 'N':
        x = self.norm(x)
      elif name == 'A':
        x = self.act(x)
    return x


class ConvHead(nn.Module):
  def __init__(self, n_tasks: int, in_channels: int, act_func=None,
               pool_func=None, norm: bool = False):
    super().__init__()
    self.channel_transform = ChannelTransformBlock(
        in_channels, n_tasks, act_func=act_func, norm=norm)
    self.pool = AdaptivePool(pool_func)

  def forward(self, x):
    return self.pool(self.channel_transform(x))


class Stem(nn.Module):
  """Note the reference's Stem builds an UNUSED layer-norm whose params
  still appear in checkpoints (Enformer.py:1788) — replicated."""

  def __init__(self, in_channels, out_channels, kernel_size,
               act_func='relu', pool_func=None, pool_size=None):
    super().__init__()
    self.conv = nn.Conv1d(in_channels, out_channels, kernel_size,
                          padding='same')
    self.act = Activation(act_func)
    self.pool = Pool(pool_func, pool_size=pool_size)
    self.norm = Norm('layer', in_dim=out_channels)

  def forward(self, x):
    return self.pool(self.act(self.conv(x)))


# ---------------------------------------------------------------------------
# RNA ConvGRU trunk (Enformer.py:1337-1426, 1571-1751)
# ---------------------------------------------------------------------------


class ConvTower(nn.Module):
  def __init__(self, stem_in_channels, stem_channels, stem_kernel_size,
               n_blocks=2, channel_init=16, channel_mult=1.0,
               kernel_size=5, act_func='relu', norm=False,
               pool_func=None, pool_size=None, residual=False,
               dropout: float = 0.0, order='CDNRA', crop_len=0):
    super().__init__()
    self.blocks = nn.ModuleList()
    self.blocks.append(Stem(stem_in_channels, stem_channels,
                            stem_kernel_size, act_func=act_func))
    in_ch, out_ch = stem_channels, channel_init
    for _ in range(1, n_blocks):
      self.blocks.append(ConvBlock(
          in_channels=in_ch, out_channels=out_ch,
          kernel_size=kernel_size, act_func=act_func, norm=norm,
          residual=residual, pool_func=pool_func, pool_size=pool_size,
          dropout=dropout, order=order))
      in_ch = out_ch
      out_ch = int(out_ch * channel_mult)
    self.crop = Crop(crop_len)

  def forward(self, x):
    for block in self.blocks:
      x = block(x)
    return self.crop(x)


class GRUBlock(nn.Module):
  def __init__(self, in_channels: int, n_layers: int = 1,
               dropout: float = 0.0, act_func='relu', norm: bool = False):
    super().__init__()
    self.gru = nn.GRU(input_size=in_channels, hidden_size=in_channels,
                      dropout=dropout if n_layers > 1 else 0,
                      bidirectional=True, batch_first=True,
                      num_layers=n_layers)
    self.ffn = FeedForwardBlock(in_len=in_channels, dropout=dropout,
                                act_func=act_func)

  def forward(self, x):                       # (B, C, L)
    x = x.transpose(1, 2)
    x = self.gru(x)[0]
    h = self.gru.hidden_size
    x = x[:, :, :h] + x[:, :, h:]
    x = self.ffn(x)
    return x.transpose(1, 2)


class ConvGRUTrunk(nn.Module):
  def __init__(self, stem_in_channels=6, stem_channels=16,
               stem_kernel_size=15, n_conv=2, channel_init=16,
               channel_mult=1.0, kernel_size=5, act_func='relu',
               conv_norm=False, pool_func=None, pool_size=None,
               residual=False, crop_len=0, n_gru=1,
               dropout: float = 0.0, gru_norm=False):
    super().__init__()
    self.conv_tower = ConvTower(
        stem_in_channels=stem_in_channels, stem_channels=stem_channels,
        stem_kernel_size=stem_kernel_size, n_blocks=n_conv,
        channel_init=channel_init, channel_mult=channel_mult,
        kernel_size=kernel_size, act_func=act_func, norm=conv_norm,
        pool_func=pool_func, pool_size=pool_size, residual=residual,
        dropout=dropout, order='CDNRA', crop_len=crop_len)
    self.gru_tower = GRUBlock(in_channels=channel_init, n_layers=n_gru,
                              dropout=dropout, act_func=act_func,
                              norm=gru_norm)

  def forward(self, x):                       # (B, L, C) or (B, C, L)
    if x.shape[1] != self.conv_tower.blocks[0].conv.in_channels:
      x = x.transpose(1, 2)
    return self.gru_tower(self.conv_tower(x))


# ---------------------------------------------------------------------------
# Enformer relative-position attention (enformer-pytorch math)
# ---------------------------------------------------------------------------


def _pos_exponential(positions, features, seq_len, min_half_life=3.0):
  max_range = math.log(seq_len) / math.log(2.0)
  half_life = 2 ** torch.linspace(min_half_life, max_range, features)
  return torch.exp(-math.log(2.0) / half_life[None]
                   * positions.abs().float()[:, None])


def _pos_central_mask(positions, features):
  widths = 2 ** torch.arange(1, features + 1).float() - 1
  return (widths[None] > positions.abs().float()[:, None]).float()


def _pos_gamma(positions, features, seq_len, eps=1e-8):
  stddev = seq_len / (2 * features)
  start_mean = seq_len / features
  mean = torch.linspace(start_mean, seq_len, features)[None]
  concentration = (mean / stddev) ** 2
  rate = mean / stddev ** 2
  x = positions.abs().float()[:, None]
  log_unnorm = torch.xlogy(concentration - 1.0, x) - rate * x
  log_norm = torch.lgamma(concentration) - concentration * torch.log(rate)
  probs = torch.exp(log_unnorm - log_norm) + eps
  return probs / torch.amax(probs, dim=-1, keepdim=True)


def get_positional_embed(seq_len: int, feature_size: int) -> torch.Tensor:
  distances = torch.arange(-seq_len + 1, seq_len)
  n = feature_size // 6
  emb = torch.cat([
      _pos_exponential(distances, n, seq_len),
      _pos_central_mask(distances, n),
      _pos_gamma(distances, n, seq_len),
  ], dim=-1)
  return torch.cat([emb, torch.sign(distances)[:, None] * emb], dim=-1)


def relative_shift(x: torch.Tensor) -> torch.Tensor:
  to_pad = torch.zeros_like(x[..., :1])
  x = torch.cat((to_pad, x), dim=-1)
  _, h, t1, t2 = x.shape
  x = x.reshape(-1, h, t2, t1)
  x = x[:, :, 1:, :]
  x = x.reshape(-1, h, t1, t2 - 1)
  return x[..., : ((t2 + 1) // 2)]


class Attention(nn.Module):
  def __init__(self, dim, *, num_rel_pos_features, heads=8, dim_key=64,
               dim_value=64, dropout=0.0, pos_dropout=0.0,
               use_tf_gamma=False):
    super().__init__()
    self.heads = heads
    self.dim_key = dim_key
    self.dim_value = dim_value
    self.scale = dim_key ** -0.5
    self.to_q = nn.Linear(dim, dim_key * heads, bias=False)
    self.to_k = nn.Linear(dim, dim_key * heads, bias=False)
    self.to_v = nn.Linear(dim, dim_value * heads, bias=False)
    self.to_out = nn.Linear(dim_value * heads, dim)
    self.num_rel_pos_features = num_rel_pos_features
    self.to_rel_k = nn.Linear(num_rel_pos_features, dim_key * heads,
                              bias=False)
    self.rel_content_bias = nn.Parameter(
        torch.randn(1, heads, 1, dim_key))
    self.rel_pos_bias = nn.Parameter(torch.randn(1, heads, 1, dim_key))
    self.pos_dropout = Dropout(pos_dropout)
    self.attn_dropout = Dropout(dropout)

  def forward(self, x):                        # (B, N, dim)
    b, n, _ = x.shape
    h, dk, dv = self.heads, self.dim_key, self.dim_value
    q = self.to_q(x).reshape(b, n, h, dk).permute(0, 2, 1, 3)
    k = self.to_k(x).reshape(b, n, h, dk).permute(0, 2, 1, 3)
    v = self.to_v(x).reshape(b, n, h, dv).permute(0, 2, 1, 3)
    q = q * self.scale
    content_logits = torch.einsum(
        'bhid,bhjd->bhij', q + self.rel_content_bias, k)
    positions = get_positional_embed(n, self.num_rel_pos_features)
    positions = self.pos_dropout(positions)
    rel_k = self.to_rel_k(positions)
    rel_k = rel_k.reshape(2 * n - 1, h, dk).permute(1, 0, 2)
    rel_logits = torch.einsum(
        'bhid,hjd->bhij', q + self.rel_pos_bias, rel_k)
    rel_logits = relative_shift(rel_logits)
    attn = (content_logits + rel_logits).softmax(dim=-1)
    attn = self.attn_dropout(attn)
    out = torch.einsum('bhij,bhjd->bhid', attn, v)
    out = out.permute(0, 2, 1, 3).reshape(b, n, h * dv)
    return self.to_out(out)


# ---------------------------------------------------------------------------
# Enformer towers / trunks (Enformer.py:1807-2007, 1271-1334, 1202-1268)
# ---------------------------------------------------------------------------


def exponential_linspace_int(start, end, num, divisible_by=1):
  def _round(x):
    return int(round(x / divisible_by) * divisible_by)
  base = math.exp(math.log(end / start) / (num - 1))
  return [_round(start * base ** i) for i in range(num)]


class EnformerConvTower(nn.Module):
  def __init__(self, n_blocks: int, out_channels: int):
    super().__init__()
    half = out_channels // 2
    self.blocks = nn.ModuleList()
    self.blocks.append(nn.Sequential(
        nn.Conv1d(4, half, 15, padding='same'),
        ConvBlock(in_channels=half, out_channels=half, kernel_size=1,
                  act_func='gelu_enformer', residual=True, order='NACDR',
                  pool_func='attn', pool_size=2)))
    filters = [half] + exponential_linspace_int(
        half, out_channels, num=n_blocks - 1, divisible_by=128)
    for i in range(1, n_blocks):
      self.blocks.append(nn.Sequential(
          ConvBlock(in_channels=filters[i - 1], out_channels=filters[i],
                    kernel_size=5, act_func='gelu_enformer',
                    residual=False, order='NACDR'),
          ConvBlock(in_channels=filters[i], out_channels=filters[i],
                    kernel_size=1, act_func='gelu_enformer',
                    residual=True, order='NACDR', pool_func='attn',
                    pool_size=2)))

  def forward(self, x):
    for block in self.blocks:
      x = block(x)
    return x


class EnformerTransformerBlock(nn.Module):
  def __init__(self, in_len, n_heads, key_len, attn_dropout,
               pos_dropout, ff_dropout):
    super().__init__()
    self.norm = Norm('layer', in_len)
    self.mha = Attention(dim=in_len, heads=n_heads, dim_key=key_len,
                         dim_value=in_len // n_heads,
                         dropout=attn_dropout, pos_dropout=pos_dropout,
                         num_rel_pos_features=in_len // n_heads)
    self.dropout = Dropout(ff_dropout)
    self.ffn = FeedForwardBlock(in_len=in_len, dropout=ff_dropout,
                                act_func='relu')

  def forward(self, x):
    x_input = x
    x = self.norm(x)
    x = self.mha(x)
    x = self.dropout(x)
    x = x_input + x
    ffn_input = x
    x = self.ffn(x)
    return ffn_input + x


class EnformerTransformerTower(nn.Module):
  def __init__(self, in_channels, n_blocks, n_heads, key_len,
               attn_dropout, pos_dropout, ff_dropout):
    super().__init__()
    self.blocks = nn.ModuleList([
        EnformerTransformerBlock(
            in_len=in_channels, n_heads=n_heads, key_len=key_len,
            attn_dropout=attn_dropout, pos_dropout=pos_dropout,
            ff_dropout=ff_dropout)
        for _ in range(n_blocks)])

  def forward(self, x):                        # (B, C, L)
    x = x.transpose(1, 2)
    for block in self.blocks:
      x = block(x)
    return x.transpose(1, 2)


class TimeEmbedding(nn.Module):
  def __init__(self, max_time_steps, embedding_size):
    super().__init__()
    self.time_embedding = nn.Embedding(max_time_steps, embedding_size)

  def forward(self, time_indices):
    return self.time_embedding(time_indices)


class EnformerTrunk(nn.Module):
  def __init__(self, n_conv=7, channels=1536, n_transformers=11,
               n_heads=8, key_len=64, attn_dropout=0.05,
               pos_dropout=0.01, ff_dropout=0.4, crop_len=0):
    super().__init__()
    self.conv_tower = EnformerConvTower(n_blocks=n_conv,
                                        out_channels=channels)
    self.transformer_tower = EnformerTransformerTower(
        in_channels=channels, n_blocks=n_transformers, n_heads=n_heads,
        key_len=key_len, attn_dropout=attn_dropout,
        pos_dropout=pos_dropout, ff_dropout=ff_dropout)
    self.pointwise_conv = ConvBlock(
        in_channels=channels, out_channels=channels * 2, kernel_size=1,
        act_func='gelu_enformer', dropout=ff_dropout // 8, order='NACDR')
    self.act = Activation('gelu_enformer')
    self.crop = Crop(crop_len)

  def forward(self, x):                        # (B, L, 4)
    x = x.transpose(1, 2)
    x = self.conv_tower(x)
    x = self.transformer_tower(x)
    x = self.pointwise_conv(x)
    x = self.act(x)
    return self.crop(x)


class TimedEnformerTrunk(EnformerTrunk):
  def __init__(self, **kwargs):
    super().__init__(**kwargs)
    self.time_embedding = TimeEmbedding(max_time_steps=128,
                                        embedding_size=4)

  def forward(self, x, time_indices):          # (B, L, 4), (B,) or scalar
    x = x + 0.01 * self.time_embedding(time_indices)
    return super().forward(x)


class BaseModelMirror(nn.Module):
  """embedding/head wrapper matching the checkpoint prefix the reference
  BaseModel produces (Enformer.py:26-52: attributes ``embedding`` and
  ``head``; trainer.py saves ``model_state_dict`` of the whole model)."""

  def __init__(self, embedding: nn.Module, head: nn.Module):
    super().__init__()
    self.embedding = embedding
    self.head = head

  def forward(self, x, *args):
    return self.head(self.embedding(x, *args))


def make_rna_value_mirror() -> BaseModelMirror:
  """The hard-wired RNA value net (Enformer.py:31-49)."""
  trunk = ConvGRUTrunk(
      stem_in_channels=4, stem_channels=64, stem_kernel_size=15,
      n_conv=6, channel_init=64, channel_mult=1, kernel_size=5,
      act_func='relu', conv_norm=True, pool_func=None, pool_size=None,
      residual=True, crop_len=0, n_gru=1, dropout=0.1, gru_norm=True)
  head = ConvHead(n_tasks=1, in_channels=64, act_func=None,
                  pool_func='avg', norm=False)
  return BaseModelMirror(trunk, head)


def make_dna_value_mirror(n_conv=7, channels=1536, n_transformers=11,
                          n_heads=8, key_len=64,
                          timed: bool = False) -> BaseModelMirror:
  """The DNA value net as built in decode.py:78-80 (EnformerTrunk +
  ConvHead(n_tasks=1, in_channels=2*channels, pool='avg'))."""
  cls = TimedEnformerTrunk if timed else EnformerTrunk
  trunk = cls(n_conv=n_conv, channels=channels,
              n_transformers=n_transformers, n_heads=n_heads,
              key_len=key_len)
  head = ConvHead(n_tasks=1, in_channels=2 * channels, act_func=None,
                  pool_func='avg', norm=False)
  return BaseModelMirror(trunk, head)


def randomize_state_dict(model: nn.Module, seed: int = 0) -> None:
  """Perturb the degenerate initializations (norm scales at 1, running
  stats at 0/1, AttentionPool at 2*identity) so parity tests exercise
  the full weight mapping; matmul weights keep their torch random
  init, which preserves sane activation magnitudes through deep nets."""
  gen = torch.Generator().manual_seed(seed)
  sd = model.state_dict()
  for key, t in sd.items():
    if not torch.is_floating_point(t):
      continue
    if key.endswith('running_var'):
      sd[key] = 0.5 + torch.rand(t.shape, generator=gen)
    elif key.endswith('running_mean'):
      sd[key] = torch.randn(t.shape, generator=gen) * 0.1
    elif 'to_attn_logits' in key:
      sd[key] = (torch.randn(t.shape, generator=gen)
                 * t.shape[1] ** -0.5)
    elif t.ndim == 1:
      base = 1.0 if key.endswith('weight') else 0.0
      sd[key] = base + torch.randn(t.shape, generator=gen) * 0.1
  model.load_state_dict(sd)


# ---------------------------------------------------------------------------
# DiT backbone mirror (models/dit.py) — flash-attn varlen replaced by
# plain softmax attention (numerically identical for the unpadded,
# non-causal case the reference uses at dit.py:272-273)
# ---------------------------------------------------------------------------


class DiTLayerNorm(nn.Module):
  """Weight-only LayerNorm computed in fp32 (dit.py:127-136)."""

  def __init__(self, dim: int):
    super().__init__()
    self.weight = nn.Parameter(torch.ones([dim]))
    self.dim = dim

  def forward(self, x):
    x = F.layer_norm(x.float(), [self.dim])
    return x * self.weight[None, None, :]


class TimestepEmbedder(nn.Module):
  def __init__(self, hidden_size, frequency_embedding_size=256):
    super().__init__()
    self.mlp = nn.Sequential(
        nn.Linear(frequency_embedding_size, hidden_size, bias=True),
        nn.SiLU(),
        nn.Linear(hidden_size, hidden_size, bias=True))
    self.frequency_embedding_size = frequency_embedding_size

  def forward(self, t):
    dim = self.frequency_embedding_size
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32) / half)
    args = t[:, None].float() * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    return self.mlp(emb)


def _rotary_tables(seq_len: int, head_dim: int):
  inv_freq = 1.0 / (10000.0 ** (torch.arange(0, head_dim, 2).float()
                                / head_dim))
  t = torch.arange(seq_len).float()
  freqs = torch.einsum('i,j->ij', t, inv_freq)
  return freqs.cos(), freqs.sin()           # (L, D/2) each


def _apply_rotary(x, cos, sin):
  """GPT-NeoX half rotation, the flash-attn non-interleaved convention
  (dit.py:107-115)."""
  d2 = x.shape[-1] // 2
  x1, x2 = x[..., :d2], x[..., d2:]
  cos = cos[None, :, None, :]
  sin = sin[None, :, None, :]
  return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


class DDiTBlock(nn.Module):
  def __init__(self, dim, n_heads, cond_dim, mlp_ratio=4, dropout=0.1):
    super().__init__()
    self.n_heads = n_heads
    self.norm1 = DiTLayerNorm(dim)
    self.attn_qkv = nn.Linear(dim, 3 * dim, bias=False)
    self.attn_out = nn.Linear(dim, dim, bias=False)
    self.dropout1 = nn.Dropout(dropout)
    self.norm2 = DiTLayerNorm(dim)
    self.mlp = nn.Sequential(
        nn.Linear(dim, mlp_ratio * dim, bias=True),
        nn.GELU(approximate='tanh'),
        nn.Linear(mlp_ratio * dim, dim, bias=True))
    self.dropout2 = nn.Dropout(dropout)
    self.adaLN_modulation = nn.Linear(cond_dim, 6 * dim, bias=True)
    self.adaLN_modulation.weight.data.zero_()
    self.adaLN_modulation.bias.data.zero_()

  def forward(self, x, rotary_cos_sin, c):
    b, s, dim = x.shape
    h = self.n_heads
    (shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp,
     gate_mlp) = self.adaLN_modulation(c)[:, None].chunk(6, dim=2)
    x_skip = x
    x = self.norm1(x) * (1 + scale_msa) + shift_msa
    qkv = self.attn_qkv(x).reshape(b, s, 3, h, dim // h)
    cos, sin = rotary_cos_sin
    q = _apply_rotary(qkv[:, :, 0], cos, sin)
    k = _apply_rotary(qkv[:, :, 1], cos, sin)
    v = qkv[:, :, 2]
    q = q.permute(0, 2, 1, 3)
    k = k.permute(0, 2, 1, 3)
    v = v.permute(0, 2, 1, 3)
    attn = (q @ k.transpose(-1, -2)) * (dim // h) ** -0.5
    o = attn.softmax(dim=-1) @ v
    o = o.permute(0, 2, 1, 3).reshape(b, s, dim)
    x = x_skip + gate_msa * self.attn_out(o)
    y = self.norm2(x) * (1 + scale_mlp) + shift_mlp
    return x + gate_mlp * self.mlp(y)


class DDitFinalLayer(nn.Module):
  def __init__(self, hidden_size, out_channels, cond_dim):
    super().__init__()
    self.norm_final = DiTLayerNorm(hidden_size)
    self.linear = nn.Linear(hidden_size, out_channels)
    self.linear.weight.data.zero_()
    self.linear.bias.data.zero_()
    self.adaLN_modulation = nn.Linear(cond_dim, 2 * hidden_size,
                                      bias=True)
    self.adaLN_modulation.weight.data.zero_()
    self.adaLN_modulation.bias.data.zero_()

  def forward(self, x, c):
    shift, scale = self.adaLN_modulation(c)[:, None].chunk(2, dim=2)
    x = self.norm_final(x) * (1 + scale) + shift
    return self.linear(x)


class DIT(nn.Module):
  """models/dit.py:324-370 with a plain-attention core."""

  def __init__(self, hidden_size, cond_dim, n_heads, n_blocks,
               vocab_size, dropout=0.1):
    super().__init__()
    self.n_heads = n_heads
    self.vocab_embed = nn.ParameterDict(
        {'embedding': nn.Parameter(torch.empty(vocab_size, hidden_size))})
    nn.init.kaiming_uniform_(self.vocab_embed['embedding'],
                             a=math.sqrt(5))
    self.sigma_map = TimestepEmbedder(cond_dim)
    self.blocks = nn.ModuleList([
        DDiTBlock(hidden_size, n_heads, cond_dim, dropout=dropout)
        for _ in range(n_blocks)])
    self.output_layer = DDitFinalLayer(hidden_size, vocab_size, cond_dim)

  def forward(self, indices, sigma):
    x = self.vocab_embed['embedding'][indices]
    c = F.silu(self.sigma_map(sigma))
    rot = _rotary_tables(x.shape[1],
                         x.shape[-1] // self.n_heads)
    for block in self.blocks:
      x = block(x, rot, c)
    return self.output_layer(x, c)


# ---------------------------------------------------------------------------
# CNN denoiser mirror (reference models/dnaconv.py). Attribute names
# follow the reference module so its state dict has the checkpoint key
# layout importers.cnn reads: linear.*, time_embedder.{0.W,1.*},
# convs.{i}.*, time_layers.{i}.dense.*, norms.{i}.*, final_conv.{0,2}.*
# ---------------------------------------------------------------------------


class GaussianFourierProjection(nn.Module):
  """Frozen random time features (dnaconv.py:8-21)."""

  def __init__(self, embed_dim: int, scale: float = 30.0):
    super().__init__()
    self.W = nn.Parameter(torch.randn(embed_dim // 2) * scale,
                          requires_grad=False)

  def forward(self, x):
    x_proj = x[:, None] * self.W[None, :] * 2 * math.pi
    return torch.cat([torch.sin(x_proj), torch.cos(x_proj)], dim=-1)


class Dense(nn.Module):
  """Linear wrapper whose output broadcasts over length (dnaconv.py)."""

  def __init__(self, input_dim: int, output_dim: int):
    super().__init__()
    self.dense = nn.Linear(input_dim, output_dim)

  def forward(self, x):
    return self.dense(x)


class CNNModel(nn.Module):
  """Dilated-conv MDLM denoiser (dnaconv.py:135-247): one-hot stem conv
  k=9, then 5 * num_cnn_stacks layers of
  ``feat = relu(conv(LayerNorm(dropout(feat) + time_bias))) + feat``
  with dilations [1, 1, 4, 16, 64] each repeated num_cnn_stacks times
  consecutively, then a 1x1 -> relu -> 1x1 head. ``forward`` takes
  tokens, ``forward2`` a (B, L, V) one-hot (the DPS gradient path).
  Channel-first (B, C, L) internally, like the reference."""

  def __init__(self, args, alphabet_size: int = 5, num_cls: int = 3,
               classifier: bool = False):
    super().__init__()
    self.alphabet_size = alphabet_size
    self.args = args
    self.classifier = classifier
    hidden = args.hidden_dim
    self.linear = nn.Conv1d(alphabet_size, hidden, kernel_size=9,
                            padding=4)
    self.time_embedder = nn.Sequential(
        GaussianFourierProjection(embed_dim=hidden),
        nn.Linear(hidden, hidden))
    base = [nn.Conv1d(hidden, hidden, kernel_size=9, padding=4),
            nn.Conv1d(hidden, hidden, kernel_size=9, padding=4),
            nn.Conv1d(hidden, hidden, kernel_size=9, dilation=4,
                      padding=16),
            nn.Conv1d(hidden, hidden, kernel_size=9, dilation=16,
                      padding=64),
            nn.Conv1d(hidden, hidden, kernel_size=9, dilation=64,
                      padding=256)]
    import copy
    self.convs = nn.ModuleList([copy.deepcopy(layer) for layer in base
                                for _ in range(args.num_cnn_stacks)])
    self.num_layers = 5 * args.num_cnn_stacks
    self.time_layers = nn.ModuleList(
        [Dense(hidden, hidden) for _ in range(self.num_layers)])
    self.norms = nn.ModuleList(
        [nn.LayerNorm(hidden) for _ in range(self.num_layers)])
    self.final_conv = nn.Sequential(
        nn.Conv1d(hidden, hidden, kernel_size=1), nn.ReLU(),
        nn.Conv1d(hidden, hidden if classifier else alphabet_size,
                  kernel_size=1))
    self.dropout = nn.Dropout(args.dropout)

  def _trunk(self, seq_onehot, t):
    time_emb = F.relu(self.time_embedder(t))
    feat = F.relu(self.linear(seq_onehot.permute(0, 2, 1)))
    for i in range(self.num_layers):
      h = self.dropout(feat.clone())
      h = h + self.time_layers[i](time_emb)[:, :, None]
      h = self.norms[i](h.permute(0, 2, 1))
      h = F.relu(self.convs[i](h.permute(0, 2, 1)))
      feat = h + feat if h.shape == feat.shape else h
    return self.final_conv(feat).permute(0, 2, 1)

  def forward(self, seq, t):
    onehot = F.one_hot(seq, num_classes=self.alphabet_size).float()
    return self._trunk(onehot, t)

  def forward2(self, seq_onehot, t):
    return self._trunk(seq_onehot.float(), t)


# ---------------------------------------------------------------------------
# Noise schedules (reference noise_schedule.py): total_noise(t) = sigma(t)
# and rate_noise(t) = dsigma/dt, torch ops on a t tensor.
# ---------------------------------------------------------------------------


class CosineNoise:
  def __init__(self, eps: float = 1e-3):
    self.eps = eps

  def rate_noise(self, t):
    cos = (1 - self.eps) * torch.cos(t * torch.pi / 2)
    sin = (1 - self.eps) * torch.sin(t * torch.pi / 2)
    return (torch.pi / 2) * sin / (cos + self.eps)

  def total_noise(self, t):
    cos = torch.cos(t * torch.pi / 2)
    return -torch.log(self.eps + (1 - self.eps) * cos)


class CosineSqrNoise:
  def __init__(self, eps: float = 1e-3):
    self.eps = eps

  def rate_noise(self, t):
    cos = (1 - self.eps) * (torch.cos(t * torch.pi / 2) ** 2)
    sin = (1 - self.eps) * torch.sin(t * torch.pi)
    return (torch.pi / 2) * sin / (cos + self.eps)

  def total_noise(self, t):
    cos = torch.cos(t * torch.pi / 2) ** 2
    return -torch.log(self.eps + (1 - self.eps) * cos)


class Linear:
  def __init__(self, sigma_min: float = 0.0, sigma_max: float = 10.0):
    self.sigma_min = torch.tensor(sigma_min)
    self.sigma_max = torch.tensor(sigma_max)

  def rate_noise(self, t):
    return (self.sigma_max - self.sigma_min) * torch.ones_like(t)

  def total_noise(self, t):
    return self.sigma_min + t * (self.sigma_max - self.sigma_min)


class GeometricNoise:
  def __init__(self, sigma_min: float = 1e-3, sigma_max: float = 1.0):
    self.sigmas = 1.0 * torch.tensor([sigma_min, sigma_max])

  def rate_noise(self, t):
    return (self.sigmas[0] ** (1 - t) * self.sigmas[1] ** t
            * (self.sigmas[1].log() - self.sigmas[0].log()))

  def total_noise(self, t):
    return self.sigmas[0] ** (1 - t) * self.sigmas[1] ** t


class LogLinearNoise:
  """sigma(t) = -log(1 - (1 - eps) t): the masking probability
  1 - exp(-sigma) is linear in t."""

  def __init__(self, eps: float = 1e-3):
    self.eps = eps

  def rate_noise(self, t):
    return (1 - self.eps) / (1 - (1 - self.eps) * t)

  def total_noise(self, t):
    return -torch.log1p(-(1 - self.eps) * t)
