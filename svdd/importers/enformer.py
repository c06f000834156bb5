"""Enformer value-model torch-checkpoint importer (DNA task).

Maps the reference DNA value net's state dict — BaseModel(embedding=
EnformerTrunk, head=ConvHead) as built at decode.py:78-80 and saved by
trainer.py:73-96 under 'model_state_dict' with key prefixes
``embedding.conv_tower.blocks.{i}.{0,1}.*``,
``embedding.transformer_tower.blocks.{j}.*``,
``embedding.pointwise_conv.*``, ``head.channel_transform.*`` — onto
svdd.models.enformer.EnformerValueModel's flax variables.

Two structural conversions beyond the usual layout transposes:
  * the 11 transformer blocks are STACKED along a new leading axis to
    feed the scan-over-layers stack (EnformerTrunk.scan_blocks=True);
  * torch BatchNorm splits into flax params (scale/bias) +
    batch_stats (mean/var).

Layout conversions:
  torch Conv1d weight (out, in, k)   -> Conv1D kernel (k, in, out)
  torch Linear weight (out, in)      -> Dense kernel (in, out)
  AttentionPool Conv2d (C, C, 1, 1)  -> (C, C) logits matrix, transposed
  nn.Embedding weight                -> TimeEmbedding 'embedding' table
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def _np(t) -> np.ndarray:
  return np.asarray(t, dtype=np.float32)


def _conv(sd: Dict, prefix: str) -> Dict:
  return {'kernel': np.transpose(_np(sd[f'{prefix}.weight']), (2, 1, 0)),
          'bias': _np(sd[f'{prefix}.bias'])}


def _dense(sd: Dict, prefix: str, bias: bool = True) -> Dict:
  out = {'kernel': np.transpose(_np(sd[f'{prefix}.weight']))}
  if bias:
    out['bias'] = _np(sd[f'{prefix}.bias'])
  return out


def _layernorm(sd: Dict, prefix: str) -> Dict:
  return {'scale': _np(sd[f'{prefix}.weight']),
          'bias': _np(sd[f'{prefix}.bias'])}


def _batchnorm(sd: Dict, prefix: str):
  params = {'scale': _np(sd[f'{prefix}.weight']),
            'bias': _np(sd[f'{prefix}.bias'])}
  stats = {'mean': _np(sd[f'{prefix}.running_mean']),
           'var': _np(sd[f'{prefix}.running_var'])}
  return params, stats


def _attn_pool(sd: Dict, prefix: str) -> Dict:
  # Conv2d (C_out, C_in, 1, 1) acting channelwise == x @ W^T on the
  # channel-last layout our AttentionPool uses
  w = _np(sd[f'{prefix}.to_attn_logits.weight'])[:, :, 0, 0]
  return {'to_attn_logits': np.transpose(w)}


def _conv_block(sd: Dict, prefix: str, attn_pool: bool = False):
  """Reference ConvBlock (Enformer.py:2176-2292) -> flax blocks.ConvBlock
  subtree {Conv1D_0, Norm_0/BatchNorm_0[, Pool_0/AttentionPool_0]}."""
  bn_params, bn_stats = _batchnorm(sd, f'{prefix}.norm.layer')
  params = {'Conv1D_0': _conv(sd, f'{prefix}.conv'),
            'Norm_0': {'BatchNorm_0': bn_params}}
  if attn_pool:
    params['Pool_0'] = {'AttentionPool_0':
                        _attn_pool(sd, f'{prefix}.pool.layer')}
  if f'{prefix}.channel_transform.layer.weight' in sd:
    params['ChannelTransform_0'] = {
        'Conv1D_0': _conv(sd, f'{prefix}.channel_transform.layer')}
  stats = {'Norm_0': {'BatchNorm_0': bn_stats}}
  return params, stats


def _transformer_block(sd: Dict, prefix: str) -> Dict:
  """Reference EnformerTransformerBlock (Enformer.py:1887-1949) ->
  flax EnformerTransformerBlock subtree. The ffn's dead '.dense.'
  LinearBlock (saluki leftover, Enformer.py:2030) is ignored."""
  return {
      'LayerNorm_0': _layernorm(sd, f'{prefix}.norm.layer'),
      'EnformerAttention_0': {
          'to_q': _dense(sd, f'{prefix}.mha.to_q', bias=False),
          'to_k': _dense(sd, f'{prefix}.mha.to_k', bias=False),
          'to_v': _dense(sd, f'{prefix}.mha.to_v', bias=False),
          'to_rel_k': _dense(sd, f'{prefix}.mha.to_rel_k', bias=False),
          'to_out': _dense(sd, f'{prefix}.mha.to_out'),
          'rel_content_bias': _np(sd[f'{prefix}.mha.rel_content_bias']),
          'rel_pos_bias': _np(sd[f'{prefix}.mha.rel_pos_bias']),
      },
      'FeedForwardBlock_0': {
          'LinearBlock_0': {
              'Norm_0': {'LayerNorm_0':
                         _layernorm(sd, f'{prefix}.ffn.dense1.norm.layer')},
              'Dense_0': _dense(sd, f'{prefix}.ffn.dense1.linear'),
          },
          'LinearBlock_1': {
              'Dense_0': _dense(sd, f'{prefix}.ffn.dense2.linear'),
          },
      },
  }


def _stack(trees):
  import jax
  return jax.tree.map(lambda *xs: np.stack(xs), *trees)


def import_enformer_value_model(
    state_dict: Dict, n_conv: int = 7, n_transformers: int = 11,
    timed: bool = False, prefix: str = '') -> Dict:
  """Full torch BaseModel(EnformerTrunk, ConvHead) state dict ->
  EnformerValueModel ``{'params', 'batch_stats'}`` variables
  (scan_blocks layout). ``prefix`` prepends e.g. ``module.`` for
  DataParallel-saved checkpoints (trainer.py:69-71)."""
  sd = {k[len(prefix):]: v for k, v in state_dict.items()
        if k.startswith(prefix)}

  tower_p, tower_s = {}, {}
  tower_p['stem_conv'] = _conv(sd, 'embedding.conv_tower.blocks.0.0')
  tower_p['stem_block'], tower_s['stem_block'] = _conv_block(
      sd, 'embedding.conv_tower.blocks.0.1', attn_pool=True)
  for i in range(1, n_conv):
    base = f'embedding.conv_tower.blocks.{i}'
    tower_p[f'conv_{i}'], tower_s[f'conv_{i}'] = _conv_block(
        sd, f'{base}.0')
    tower_p[f'pool_{i}'], tower_s[f'pool_{i}'] = _conv_block(
        sd, f'{base}.1', attn_pool=True)

  blocks = [
      _transformer_block(sd, f'embedding.transformer_tower.blocks.{j}')
      for j in range(n_transformers)]
  if n_transformers > 1:
    # scan-over-layers layout: stacked leading axis
    tr_p = {'transformer_stack':
            {'EnformerTransformerBlock_0': _stack(blocks)}}
  else:
    # EnformerTrunk falls back to the unrolled layout for a single block
    tr_p = {'transformer_0': blocks[0]}

  pw_p, pw_s = _conv_block(sd, 'embedding.pointwise_conv')

  trunk_p = {'EnformerConvTower_0': tower_p, 'pointwise': pw_p, **tr_p}
  trunk_s = {'EnformerConvTower_0': tower_s, 'pointwise': pw_s}

  params = {
      'EnformerTrunk_0': trunk_p,
      'ConvHead_0': {'ChannelTransformBlock_0': {'ChannelTransform_0': {
          'Conv1D_0': _conv(sd, 'head.channel_transform.conv.layer')}}},
  }
  if timed:
    params['TimeEmbedding_0'] = {
        'embedding': _np(sd['embedding.time_embedding.time_embedding'
                            '.weight'])}

  import jax
  import jax.numpy as jnp
  to_jnp = lambda a: jnp.asarray(a)
  return {'params': jax.tree.map(to_jnp, params),
          'batch_stats': jax.tree.map(
              to_jnp, {'EnformerTrunk_0': trunk_s})}
