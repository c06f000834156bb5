"""Plain-XLA ops and value-tower blocks against independent oracles."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from svdd.ops import attention as attn_ops


def test_fused_rmsnorm_matches_reference():
  from svdd.ops.norms import fused_add_rmsnorm
  key = jax.random.key(1)
  x = jax.random.normal(key, (4, 16, 128))
  r = jax.random.normal(jax.random.key(2), (4, 16, 128))
  s = jnp.ones((128,)) * 1.5
  out = fused_add_rmsnorm(x, r, s)
  v = np.asarray(x + r, np.float64)
  ref = v / np.sqrt((v ** 2).mean(-1, keepdims=True) + 1e-5) * 1.5
  np.testing.assert_allclose(np.asarray(out), ref, atol=1e-5)
  # hand check: rms of output rows (pre-scale) ~= 1
  y = np.asarray(out) / 1.5
  np.testing.assert_allclose(np.sqrt((y ** 2).mean(-1)), 1.0,
                             rtol=1e-3)


def test_mha_causal_masks_future():
  key = jax.random.key(3)
  q = jax.random.normal(key, (1, 8, 1, 16))
  k, v = q, q
  out = attn_ops.mha(q, k, v, causal=True)
  # position 0 attends only to itself -> output == v[0]
  np.testing.assert_allclose(np.asarray(out[0, 0, 0]),
                             np.asarray(v[0, 0, 0]), atol=1e-5)


@pytest.mark.parametrize('dtype', [jnp.float32, jnp.bfloat16],
                         ids=['f32', 'bf16'])
@pytest.mark.parametrize('causal', [False, True])
@pytest.mark.parametrize('b,l,h,d', [(2, 50, 4, 32), (1, 128, 2, 64)])
def test_mha_matches_xla_dot_product_attention(b, l, h, d, causal, dtype):
  """mha == jax.nn.dot_product_attention's XLA implementation, the
  (B, L, H, D) layout both use."""
  q, k, v = jax.random.normal(jax.random.key(7), (3, b, l, h, d), dtype)
  got = attn_ops.mha(q, k, v, causal=causal)
  want = jax.nn.dot_product_attention(q, k, v, is_causal=causal,
                                      implementation='xla')
  assert got.dtype == dtype
  tol = 1e-5 if dtype == jnp.float32 else 2e-2
  np.testing.assert_allclose(np.asarray(got, np.float32),
                             np.asarray(want, np.float32), atol=tol,
                             rtol=tol)


def test_fused_gumbel_candidates_xla_dispatcher():
  """The candidate draw: distribution + copy-flag semantics."""
  from svdd.sampling.guidance import _draw_candidates
  log_q = jnp.log(jnp.broadcast_to(
      jnp.array([0.1, 0.2, 0.3, 0.4, 1e-9]), (64, 4, 5)))
  x = jnp.full((64, 4), 4, jnp.int32).at[:, 0].set(2)
  out = np.asarray(_draw_candidates(
      jax.random.key(0), log_q, x, mask_index=4, repeats=8))
  assert out.shape == (64, 8, 4)
  assert (out[:, :, 0] == 2).all()
  draws = out[:, :, 1:].reshape(-1)
  freqs = np.bincount(draws, minlength=5) / draws.size
  np.testing.assert_allclose(freqs[:4], [0.1, 0.2, 0.3, 0.4],
                             atol=0.035)
  assert freqs[4] == 0.0


def _pairwise_pool(x, w):
  """Explicit Enformer attention pooling in float64 numpy: for each
  pair (x0, x1), softmax over the pair of the per-channel logits
  x_i @ w; an odd tail pools its single member."""
  x = np.asarray(x, np.float64)
  w = np.asarray(w, np.float64)
  n, l, c = x.shape
  out = np.zeros((n, (l + 1) // 2, c))
  for j in range(0, l, 2):
    if j + 1 == l:
      out[:, j // 2] = x[:, j]
      continue
    l0, l1 = x[:, j] @ w, x[:, j + 1] @ w
    m = np.maximum(l0, l1)
    e0, e1 = np.exp(l0 - m), np.exp(l1 - m)
    out[:, j // 2] = (x[:, j] * e0 + x[:, j + 1] * e1) / (e0 + e1)
  return out


def test_attn_pool_module_odd_length_and_grad():
  """AttentionPool module: odd L masks the tail (pad logit -inf), and
  its gradient matches finite differences."""
  from svdd.models.blocks import AttentionPool

  pool = AttentionPool(dim=128, pool_size=2)
  x = jax.random.normal(jax.random.key(2), (4, 13, 128))
  v = pool.init(jax.random.key(3), x)
  out = pool.apply(v, x)
  assert out.shape == (4, 7, 128)
  # tail group has one real member -> softmax weight 1 on it
  np.testing.assert_allclose(np.asarray(out[:, -1]),
                             np.asarray(x[:, -1]), atol=1e-5)

  f = lambda x: (pool.apply(v, x) ** 2).sum()
  g = jax.grad(f)(x)
  d = jax.random.normal(jax.random.key(4), x.shape)
  eps = 1e-3
  fd = (f(x + eps * d) - f(x - eps * d)) / (2 * eps)
  np.testing.assert_allclose(float(jnp.vdot(g, d)), float(fd), rtol=2e-3)


@pytest.mark.parametrize('residual', [False, True],
                         ids=['pool', 'convblock_residual'])
@pytest.mark.parametrize('length', [12, 13])
@pytest.mark.parametrize('grad', [False, True], ids=['fwd', 'grad'])
def test_attn_pool_matches_pairwise_softmax(length, residual, grad):
  """AttentionPool (alone, or as the pool of a residual NACDR ConvBlock
  at eval) against the explicit pairwise softmax, odd and even L; with
  ``grad`` the input gradient against finite differences of the
  oracle."""
  from svdd.models import blocks
  c = 32
  x = jax.random.normal(jax.random.key(length), (3, length, c))
  w = 2.0 * jnp.eye(c) + 0.1 * jax.random.normal(jax.random.key(9),
                                                 (c, c))
  if residual:
    mod = blocks.ConvBlock(c, c, kernel_size=1, act_func='gelu_enformer',
                           residual=True, order='NACDR', pool_func='attn',
                           pool_size=2)
    v = mod.init(jax.random.key(0), x)
    v = jax.tree_util.tree_map(lambda a: a, v)
    v['params']['Pool_0']['AttentionPool_0']['to_attn_logits'] = w
    conv = v['params']['Conv1D_0']
    bn = v['batch_stats']['Norm_0']['BatchNorm_0']

    def pre_pool(x):
      h = (x - bn['mean']) / jnp.sqrt(bn['var'] + 1e-5)
      h = blocks.gelu_enformer(h)
      return h @ conv['kernel'][0] + conv['bias'] + x
    fn = lambda x: mod.apply(v, x)
  else:
    mod = blocks.AttentionPool(dim=c, pool_size=2)
    v = {'params': {'to_attn_logits': w}}
    pre_pool = lambda x: x
    fn = lambda x: mod.apply(v, x)

  oracle = lambda x: _pairwise_pool(np.asarray(pre_pool(x)), w)
  if not grad:
    np.testing.assert_allclose(np.asarray(fn(x)), oracle(x), atol=1e-5,
                               rtol=1e-5)
    return
  ct = np.asarray(jax.random.normal(jax.random.key(5),
                                    (3, (length + 1) // 2, c)))
  g = np.asarray(jax.grad(lambda x: jnp.sum(fn(x) * ct))(x))
  d = np.asarray(jax.random.normal(jax.random.key(6), x.shape))
  eps = 1e-3
  fd = ((oracle(x + eps * d) * ct).sum()
        - (oracle(x - eps * d) * ct).sum()) / (2 * eps)
  np.testing.assert_allclose((g * d).sum(), fd, rtol=1e-3)


def _frozen_stats_from_train(module, variables, x):
  """Run a train-mode forward, and recover every BatchNorm's own batch
  statistics from its running-average update
  (new = m * old + (1 - m) * batch, m = 0.9)."""
  _, upd = module.apply(variables, x, train=True,
                        mutable=['batch_stats'])
  old = variables['batch_stats']
  return jax.tree_util.tree_map(lambda n, o: (n - 0.9 * o) / 0.1,
                                upd['batch_stats'], old)


@pytest.mark.parametrize('length,n_conv,n_tr', [
    (64, 3, 1), (50, 3, 2), (37, 4, 1), (26, 3, 2)])
def test_enformer_eval_matches_train_with_frozen_stats(length, n_conv,
                                                       n_tr):
  """The trunk's eval forward (running BatchNorm stats) equals its
  train-mode forward when the running stats ARE the batch's own
  statistics: the single eval path computes the same network as the
  training path. Dropout is zero so train mode is deterministic."""
  from svdd.models.enformer import EnformerTrunk
  trunk = EnformerTrunk(n_conv=n_conv, channels=256, n_transformers=n_tr,
                        n_heads=2, key_len=8, ff_dropout=0.0,
                        attn_dropout=0.0, pos_dropout=0.0)
  x = jax.nn.one_hot(jax.random.randint(jax.random.key(length),
                                        (6, length), 0, 4), 4)
  variables = trunk.init(jax.random.key(1), x)
  stats = _frozen_stats_from_train(trunk, variables, x)
  train_out, _ = trunk.apply(variables, x, train=True,
                             mutable=['batch_stats'])
  eval_out = trunk.apply({**variables, 'batch_stats': stats}, x)
  assert eval_out.shape == train_out.shape
  np.testing.assert_allclose(np.asarray(eval_out), np.asarray(train_out),
                             atol=2e-4, rtol=2e-4)
