"""Model zoo: shapes, determinism, gradient flow."""

import jax
import jax.numpy as jnp
import numpy as np

from svdd.config import tiny_test_config
from svdd.models import ema
from svdd.models.cnn import CNNModel
from svdd.models.convgru import ConvGRUValueModel, GRUCellScan
from svdd.models.enformer import (EnformerValueModel,
                                      exponential_linspace_int,
                                      relative_shift)


def test_cnn_shapes(rng):
  cfg = tiny_test_config('rna')
  model = CNNModel(config=cfg, alphabet_size=5, num_cls=3)
  x = jnp.zeros((2, cfg.model.length), jnp.int32)
  sigma = jnp.zeros((2,))
  variables = model.init(rng, x, sigma)
  out = model.apply(variables, x, sigma)
  assert out.shape == (2, cfg.model.length, 5)
  # one-hot (forward2) path produces identical output for matching input
  oh = jax.nn.one_hot(x, 5)
  out2 = model.apply(variables, x, sigma, x_onehot=oh)
  np.testing.assert_allclose(np.asarray(out), np.asarray(out2),
                             atol=1e-5)


def test_cnn_fourier_buffer_not_in_params(rng):
  cfg = tiny_test_config('rna')
  model = CNNModel(config=cfg, alphabet_size=5, num_cls=3)
  variables = model.init(rng, jnp.zeros((1, 8), jnp.int32),
                         jnp.zeros((1,)))
  assert 'buffers' in variables  # frozen GFP weights live outside params


def test_gru_scan_matches_manual(rng):
  """GRU scan against a hand-rolled python recurrence."""
  H = 4
  cell = GRUCellScan(hidden_size=H)
  x = jax.random.normal(rng, (1, 5, 3))
  variables = cell.init(rng, x)
  out = cell.apply(variables, x)
  p = variables['params']
  xw = np.asarray(x @ p['ih']['kernel'] + p['ih']['bias'])
  hk, hb = np.asarray(p['hh_kernel']), np.asarray(p['hh_bias'])
  h = np.zeros((1, H), np.float32)
  for t in range(5):
    g = h @ hk + hb
    r = 1 / (1 + np.exp(-(xw[:, t, :H] + g[:, :H])))
    z = 1 / (1 + np.exp(-(xw[:, t, H:2*H] + g[:, H:2*H])))
    n = np.tanh(xw[:, t, 2*H:] + r * g[:, 2*H:])
    h = (1 - z) * n + z * h
    np.testing.assert_allclose(np.asarray(out[:, t]), h, atol=1e-5)


def test_convgru_value_model(rng):
  model = ConvGRUValueModel()
  x = jax.random.normal(rng, (3, 16, 4))
  variables = model.init(rng, x)
  out = model.apply(variables, x)
  assert out.shape == (3,)
  assert 'batch_stats' in variables
  # differentiable wrt input (needed for classifier guidance)
  g = jax.grad(lambda z: model.apply(variables, z).sum())(x)
  assert np.isfinite(np.asarray(g)).all()


def test_enformer_value_model_small(rng):
  model = EnformerValueModel(n_tasks=1, n_conv=3, channels=256,
                             n_transformers=1, n_heads=2, key_len=8)
  x = jax.random.normal(rng, (2, 24, 4))
  variables = model.init(rng, x)
  out = model.apply(variables, x)
  assert out.shape == (2,)


def test_exponential_linspace():
  # reference channel schedule: 768 -> 1536 over 6 steps, div 128
  assert exponential_linspace_int(768, 1536, 6, 128) == [
      768, 896, 1024, 1152, 1280, 1536]


def test_relative_shift():
  # (1,1,L,2L-1) -> (1,1,L,L): row i should pick diag-aligned entries
  L = 3
  x = jnp.arange(2 * L - 1, dtype=jnp.float32)
  x = jnp.broadcast_to(x, (1, 1, L, 2 * L - 1))
  out = relative_shift(x)
  assert out.shape == (1, 1, L, L)
  # distance j - i maps to index (L-1) + (j-i) of the rel axis
  for i in range(L):
    for j in range(L):
      assert float(out[0, 0, i, j]) == L - 1 + j - i


def test_ema_update():
  params = {'w': jnp.ones((2,))}
  st = ema.init(params, decay=0.999)
  new_params = {'w': jnp.zeros((2,))}
  st = ema.update(st, new_params)
  # warmup: decay = min(0.999, 2/11) -> shadow moves a lot initially
  assert float(st.shadow['w'][0]) < 0.5
  st2 = ema.init(params, decay=0.5, use_num_updates=False)
  st2 = ema.update(st2, new_params)
  np.testing.assert_allclose(np.asarray(st2.shadow['w']), 0.5)


def test_fast_layer_norm_matches_flax():
  """FastLayerNorm: bit-identical to nn.LayerNorm on f32 inputs
  (flax op order preserved); close on bf16 (the bf16 apply is the
  whole point — see models/blocks.py docstring)."""
  import flax.linen as nn
  from svdd.models.blocks import FastLayerNorm

  x = jax.random.normal(jax.random.key(3), (4, 6, 256), jnp.float32)
  ref = nn.LayerNorm(epsilon=1e-5)
  fast = FastLayerNorm(epsilon=1e-5)
  v = ref.init(jax.random.key(0), x)
  # non-trivial scale/bias so the apply order matters
  v = jax.tree_util.tree_map(
      lambda t: t + jax.random.normal(jax.random.key(1), t.shape) * 0.3,
      v)
  np.testing.assert_array_equal(np.asarray(ref.apply(v, x)),
                                np.asarray(fast.apply(v, x)))

  xb = x.astype(jnp.bfloat16)
  refb = nn.LayerNorm(epsilon=1e-5, dtype=jnp.bfloat16)
  fastb = FastLayerNorm(epsilon=1e-5, dtype=jnp.bfloat16)
  a = np.asarray(refb.apply(v, xb), np.float32)
  b = np.asarray(fastb.apply(v, xb), np.float32)
  assert b.dtype == np.float32 and fastb.apply(v, xb).dtype == jnp.bfloat16
  np.testing.assert_allclose(a, b, atol=0.05, rtol=0.05)

  # grads flow through both params
  g = jax.grad(lambda v_, x_: fastb.apply(v_, x_)
               .astype(jnp.float32).sum())(v, xb)
  assert float(jnp.abs(g['params']['scale']).sum()) > 0.0
