"""MDLM core math vs hand-computed expectations (diffusion_gosai.py)."""

import jax
import jax.numpy as jnp
import numpy as np

from svdd import mdlm

V = 5
MASK = 4


def test_subs_parameterization_masked_position():
  logits = jnp.zeros((1, 1, V))
  xt = jnp.full((1, 1), MASK)
  out = mdlm.subs_parameterization(logits, xt, MASK)
  # mask prob == 0, rest uniform over 4
  np.testing.assert_allclose(np.exp(out[0, 0, :4]), 0.25, rtol=1e-5)
  assert out[0, 0, MASK] < -100
  # normalized
  np.testing.assert_allclose(np.exp(out).sum(), 1.0, rtol=1e-5)


def test_subs_parameterization_unmasked_is_onehot():
  logits = jax.random.normal(jax.random.key(0), (2, 3, V))
  xt = jnp.array([[0, 2, MASK], [1, 3, 1]])
  out = mdlm.subs_parameterization(logits, xt, MASK)
  # unmasked position (0,0) token 0: log-prob 0 at token, -inf elsewhere
  assert out[0, 0, 0] == 0.0
  assert (out[0, 0, 1:] < -100).all()
  # masked position (0,2) stays a distribution over non-mask tokens
  np.testing.assert_allclose(np.exp(out[0, 2]).sum(), 1.0, rtol=1e-3)


def test_q_xt_masking_rate():
  key = jax.random.key(1)
  x0 = jnp.zeros((512, 64), jnp.int32)
  xt = mdlm.q_xt(key, x0, jnp.asarray(0.3), MASK)
  rate = float((xt == MASK).mean())
  assert abs(rate - 0.3) < 0.02


def test_sample_categorical_distribution():
  key = jax.random.key(2)
  probs = jnp.array([0.1, 0.2, 0.3, 0.4, 0.0])
  draws = mdlm.sample_categorical_probs(
      key, jnp.broadcast_to(probs, (20000, V)))
  freqs = np.bincount(np.asarray(draws), minlength=V) / 20000
  np.testing.assert_allclose(freqs, np.asarray(probs), atol=0.02)
  assert freqs[MASK] == 0.0


def test_sample_categorical_unnormalized_invariance():
  # scaling probs must not change the distribution (gumbel-max property)
  k = jax.random.key(3)
  probs = jnp.array([0.2, 0.5, 0.3])
  a = mdlm.sample_categorical_probs(k, jnp.broadcast_to(probs, (1000, 3)))
  b = mdlm.sample_categorical_probs(k, jnp.broadcast_to(7.3 * probs,
                                                        (1000, 3)))
  np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_nelbo_subs_weighting():
  # single token, p(x0)=0.5 -> nll = -log(0.5) * dsigma/expm1(sigma)
  log_p = jnp.log(jnp.array([[[0.5, 0.5, 0.0, 0.0, 0.0]]])
                  + 1e-30)
  x0 = jnp.array([[0]])
  sigma = jnp.array([1.0])
  dsigma = jnp.array([2.0])
  out = mdlm.nelbo_subs(log_p, x0, sigma, dsigma)
  expected = -np.log(0.5) * 2.0 / np.expm1(1.0)
  np.testing.assert_allclose(out.loss, expected, rtol=1e-5)


def test_sample_t_antithetic_coverage():
  t = mdlm.sample_t(jax.random.key(0), 128, 1e-3, antithetic=True)
  t = np.sort(np.asarray(t))
  # antithetic sampling stratifies: one sample per 1/n bin
  gaps = np.diff(t)
  assert gaps.max() < 2.5 / 128


def test_log_q_xs_matches_prob_space():
  key = jax.random.key(4)
  logits = jax.random.normal(key, (2, 3, V))
  xt = jnp.full((2, 3), MASK)
  log_p = mdlm.subs_parameterization(logits, xt, MASK)
  mct, mcs = 0.8, 0.5
  log_q = mdlm.log_q_xs(log_p, mct, mcs, MASK)
  # prob-space reference computation (diffusion_gosai.py:793-797)
  q_ref = np.exp(np.asarray(log_p)) * (mct - mcs)
  q_ref[..., MASK] = mcs
  # tolerance: exp/log precision differs slightly between XLA builds
  # (~2e-5 rel)
  np.testing.assert_allclose(np.exp(np.asarray(log_q)), q_ref,
                             rtol=1e-4, atol=1e-6)


def test_transform_samples_zeroes_mask_rows():
  s = jnp.array([[0, 2, MASK]])
  oh = mdlm.transform_samples(s)
  assert oh.shape == (1, 3, 4)
  np.testing.assert_array_equal(np.asarray(oh[0, 0]), [1, 0, 0, 0])
  np.testing.assert_array_equal(np.asarray(oh[0, 2]), [0, 0, 0, 0])


def test_d3pm_loss_masks_unmasked_positions():
  T = 10
  model_out = jnp.log(jnp.full((1, 2, V), 0.2))
  xt = jnp.array([[MASK, 1]])
  x0 = jnp.array([[0, 1]])
  t = jnp.array([0.5])
  loss = mdlm.d3pm_loss(model_out, xt, x0, t, MASK, T)
  assert loss.shape == (1, 2)
  assert float(loss[0, 1]) == 0.0   # unmasked position contributes 0
  assert float(loss[0, 0]) != 0.0


def test_score_entropy_zero_on_unmasked():
  log_score = jnp.zeros((1, 2, V))
  sigma = jnp.array([[0.5]])
  xt = jnp.array([[MASK, 1]])
  x0 = jnp.array([[0, 1]])
  ent = mdlm.score_entropy(log_score, sigma, xt, x0, MASK)
  assert float(ent[0, 1]) == 0.0
  assert np.isfinite(float(ent[0, 0]))


def test_get_score_shapes_and_cases():
  key = jax.random.key(5)
  logits = jax.random.normal(key, (2, 4, V))
  x = jnp.array([[MASK, 0, MASK, 3], [1, MASK, 2, MASK]])
  sigma = jnp.array([0.7, 0.9])
  log_p = mdlm.subs_parameterization(logits, x, MASK)
  score = mdlm.get_score(log_p, x, sigma, MASK)
  assert score.shape == (2, 4, V)
  # unmasked position: score 1 at own token
  np.testing.assert_allclose(score[0, 1, 0], 1.0, rtol=1e-5)
  # masked position: score at mask column is exp(0)=1
  np.testing.assert_allclose(score[0, 0, MASK], 1.0, rtol=1e-5)
