"""CNN (dnaconv) torch-checkpoint importer.

Maps the reference CNNModel state dict (reference models/
dnaconv.py:135-210; checkpoint layout: linear.*, time_embedder.*,
convs.{i}.*, time_layers.{i}.dense.*, norms.{i}.*, final_conv.{0,2}.*)
onto svdd.models.cnn.CNNModel's flax tree.

Layout conversions:
  torch Conv1d weight (out, in, k)  -> flax Conv kernel (k, in, out)
  torch Linear weight (out, in)     -> flax Dense kernel (in, out)
  GaussianFourierProjection.W       -> 'buffers' collection W
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def _conv(w: np.ndarray, b: np.ndarray) -> Dict:
  return {'kernel': np.transpose(w, (2, 1, 0)), 'bias': b}


def _dense(w: np.ndarray, b: np.ndarray | None = None) -> Dict:
  out = {'kernel': np.transpose(w)}
  if b is not None:
    out['bias'] = b
  return out


def import_cnn_params(state_dict: Dict[str, np.ndarray],
                      num_layers: int) -> Dict:
  """torch CNNModel state dict -> {'params': ..., 'buffers': ...}."""
  sd = state_dict
  params = {
      'stem': _conv(sd['linear.weight'], sd['linear.bias']),
      'time_linear': _dense(sd['time_embedder.1.weight'],
                            sd['time_embedder.1.bias']),
      'final_0': _conv(sd['final_conv.0.weight'],
                       sd['final_conv.0.bias']),
      'final_1': _conv(sd['final_conv.2.weight'],
                       sd['final_conv.2.bias']),
  }
  for i in range(num_layers):
    params[f'conv_{i}'] = _conv(sd[f'convs.{i}.weight'],
                                sd[f'convs.{i}.bias'])
    params[f'time_{i}'] = _dense(sd[f'time_layers.{i}.dense.weight'],
                                 sd[f'time_layers.{i}.dense.bias'])
    params[f'norm_{i}'] = {'scale': sd[f'norms.{i}.weight'],
                           'bias': sd[f'norms.{i}.bias']}
  buffers = {
      'GaussianFourierProjection_0': {'W': sd['time_embedder.0.W']},
  }
  import jax.numpy as jnp
  to_jnp = lambda t: jnp.asarray(np.asarray(t))
  import jax
  return {'params': jax.tree.map(to_jnp, params),
          'buffers': jax.tree.map(to_jnp, buffers)}
