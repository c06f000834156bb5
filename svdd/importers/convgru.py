"""ConvGRU torch-checkpoint importer (RNA value nets).

Maps the reference ConvGRUTrunk/GRUBlock/ConvHead state dicts
(reference Enformer.py:1337-1426, 1571-1630, 2131-2173; saved by
trainer.py:73-96 as 'model_state_dict' with keys
``embedding.conv_tower.blocks.{i}.*``, ``embedding.gru_tower.gru.*``,
``head.channel_transform.*``) onto svdd.models.convgru modules.

The subtle part is torch.nn.GRU's weight layout: ``weight_ih_l0`` is
(3H, in) with gates stacked [r | z | n] — exactly the gate order
GRUCellScan computes — and the bidirectional reverse direction lives
in ``*_reverse`` keys.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def import_gru_cell(sd: Dict[str, np.ndarray], prefix: str = '',
                    reverse: bool = False) -> Dict:
  """torch nn.GRU layer-0 weights -> GRUCellScan params."""
  suffix = '_reverse' if reverse else ''
  w_ih = sd[f'{prefix}weight_ih_l0{suffix}']   # (3H, in)
  w_hh = sd[f'{prefix}weight_hh_l0{suffix}']   # (3H, H)
  b_ih = sd[f'{prefix}bias_ih_l0{suffix}']     # (3H,)
  b_hh = sd[f'{prefix}bias_hh_l0{suffix}']     # (3H,)
  return {
      'ih': {'kernel': np.transpose(w_ih), 'bias': b_ih},
      'hh_kernel': np.transpose(w_hh),
      'hh_bias': b_hh,
  }


def import_bidirectional_gru(sd: Dict[str, np.ndarray],
                             prefix: str = '') -> Dict:
  """torch bidirectional GRU -> {gru_fwd_0, gru_bwd_0} params."""
  return {
      'gru_fwd_0': import_gru_cell(sd, prefix, reverse=False),
      'gru_bwd_0': import_gru_cell(sd, prefix, reverse=True),
  }


def _np(t) -> np.ndarray:
  return np.asarray(t, dtype=np.float32)


def _conv(sd: Dict, prefix: str) -> Dict:
  return {'kernel': np.transpose(_np(sd[f'{prefix}.weight']), (2, 1, 0)),
          'bias': _np(sd[f'{prefix}.bias'])}


def _dense(sd: Dict, prefix: str) -> Dict:
  return {'kernel': np.transpose(_np(sd[f'{prefix}.weight'])),
          'bias': _np(sd[f'{prefix}.bias'])}


def import_convgru_value_model(state_dict: Dict, n_conv: int = 6,
                               prefix: str = '') -> Dict:
  """Full torch BaseModel RNA value net state dict (the hard-wired
  ConvGRUTrunk + ConvHead of Enformer.py:31-49, checkpoint keys
  ``embedding.conv_tower.blocks.{0..5}.*``, ``embedding.gru_tower.*``,
  ``head.channel_transform.*``) -> ConvGRUValueModel
  ``{'params', 'batch_stats'}`` variables.

  Ignored reference keys: the Stem's unused layer-norm
  (Enformer.py:1788) and the FFN's dead saluki '.dense.' LinearBlock
  (Enformer.py:2030)."""
  sd = {k[len(prefix):]: v for k, v in state_dict.items()
        if k.startswith(prefix)}

  tower_p = {'Stem_0': {'Conv1D_0':
                        _conv(sd, 'embedding.conv_tower.blocks.0.conv')}}
  tower_s = {}
  for i in range(1, n_conv):
    base = f'embedding.conv_tower.blocks.{i}'
    tower_p[f'ConvBlock_{i - 1}'] = {
        'Conv1D_0': _conv(sd, f'{base}.conv'),
        'Norm_0': {'BatchNorm_0': {
            'scale': _np(sd[f'{base}.norm.layer.weight']),
            'bias': _np(sd[f'{base}.norm.layer.bias'])}},
    }
    tower_s[f'ConvBlock_{i - 1}'] = {'Norm_0': {'BatchNorm_0': {
        'mean': _np(sd[f'{base}.norm.layer.running_mean']),
        'var': _np(sd[f'{base}.norm.layer.running_var'])}}}

  gru_p = import_bidirectional_gru(sd, 'embedding.gru_tower.gru.')
  gru_p['FeedForwardBlock_0'] = {
      'LinearBlock_0': {
          'Norm_0': {'LayerNorm_0': {
              'scale': _np(sd['embedding.gru_tower.ffn.dense1.norm'
                              '.layer.weight']),
              'bias': _np(sd['embedding.gru_tower.ffn.dense1.norm'
                             '.layer.bias'])}},
          'Dense_0': _dense(sd, 'embedding.gru_tower.ffn.dense1.linear'),
      },
      'LinearBlock_1': {
          'Dense_0': _dense(sd, 'embedding.gru_tower.ffn.dense2.linear'),
      },
  }

  params = {
      'ConvGRUTrunk_0': {'ConvTower_0': tower_p, 'GRUBlock_0': gru_p},
      'ConvHead_0': {'ChannelTransformBlock_0': {'ChannelTransform_0': {
          'Conv1D_0': _conv(sd, 'head.channel_transform.conv.layer')}}},
  }
  stats = {'ConvGRUTrunk_0': {'ConvTower_0': tower_s}}

  import jax
  import jax.numpy as jnp
  to_jnp = lambda a: jnp.asarray(a)
  return {'params': jax.tree.map(to_jnp, params),
          'batch_stats': jax.tree.map(to_jnp, stats)}
