"""DiT torch-checkpoint importer.

Maps the reference DIT state dict (reference models/dit.py:324-370;
keys ``vocab_embed.embedding``, ``sigma_map.mlp.{0,2}.*``,
``blocks.{i}.{norm1,attn_qkv,attn_out,norm2,mlp.0,mlp.2,
adaLN_modulation}.*``, ``output_layer.*``) onto
svdd.models.dit.DIT's flax tree. The ``rotary_emb.inv_freq`` buffer
is recomputed on the fly by our model (dit.py rotary tables are
deterministic functions of shape) and is ignored.

Layout: torch Linear (out, in) -> Dense kernel (in, out); the reference
LayerNorm is weight-only (dit.py:127-136) -> flax LayerNorm(use_bias=
False) {'scale'}.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def _np(t) -> np.ndarray:
  return np.asarray(t, dtype=np.float32)


def _dense(sd: Dict, prefix: str, bias: bool = True) -> Dict:
  out = {'kernel': np.transpose(_np(sd[f'{prefix}.weight']))}
  if bias:
    out['bias'] = _np(sd[f'{prefix}.bias'])
  return out


def import_dit_params(state_dict: Dict, n_blocks: int,
                      prefix: str = '') -> Dict:
  """torch DIT state dict -> {'params': ...} for svdd.models.dit.DIT."""
  sd = {k[len(prefix):]: v for k, v in state_dict.items()
        if k.startswith(prefix)}
  params = {
      'vocab_embed': _np(sd['vocab_embed.embedding']),
      'TimestepEmbedder_0': {
          'Dense_0': _dense(sd, 'sigma_map.mlp.0'),
          'Dense_1': _dense(sd, 'sigma_map.mlp.2'),
      },
      'DDitFinalLayer_0': {
          'adaLN': _dense(sd, 'output_layer.adaLN_modulation'),
          'LayerNorm_0': {'scale': _np(sd['output_layer.norm_final'
                                          '.weight'])},
          'linear': _dense(sd, 'output_layer.linear'),
      },
  }
  for i in range(n_blocks):
    base = f'blocks.{i}'
    params[f'block_{i}'] = {
        'adaLN': _dense(sd, f'{base}.adaLN_modulation'),
        'LayerNorm_0': {'scale': _np(sd[f'{base}.norm1.weight'])},
        'attn_qkv': _dense(sd, f'{base}.attn_qkv', bias=False),
        'attn_out': _dense(sd, f'{base}.attn_out', bias=False),
        'LayerNorm_1': {'scale': _np(sd[f'{base}.norm2.weight'])},
        'mlp_0': _dense(sd, f'{base}.mlp.0'),
        'mlp_1': _dense(sd, f'{base}.mlp.2'),
    }
  import jax
  import jax.numpy as jnp
  return {'params': jax.tree.map(lambda a: jnp.asarray(a), params)}
