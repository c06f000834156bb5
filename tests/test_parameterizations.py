"""End-to-end coverage of the d3pm / sedd parameterizations, timed and
multisep guided decoding, and CNN classifier variants."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from svdd.config import tiny_test_config
from svdd.diffusion import Diffusion


def test_sedd_parameterization_end_to_end():
  cfg = tiny_test_config('rna')
  cfg.parameterization = 'sedd'
  cfg.sampling.predictor = 'analytic'
  model = Diffusion(cfg, rng=jax.random.key(0))
  x0 = jax.random.randint(jax.random.key(1), (4, cfg.model.length),
                          0, 4)
  out = model.loss(model.variables, jax.random.key(2), x0)
  assert np.isfinite(float(out.loss))
  x = np.asarray(model.sampler(4)(jax.random.key(3)).samples)
  assert (x >= 0).all() and (x < 4).all()


def test_d3pm_parameterization_loss():
  cfg = tiny_test_config('rna')
  cfg.parameterization = 'd3pm'
  cfg.T = 100
  model = Diffusion(cfg, rng=jax.random.key(0))
  x0 = jax.random.randint(jax.random.key(1), (4, cfg.model.length),
                          0, 4)
  out = model.loss(model.variables, jax.random.key(2), x0)
  assert np.isfinite(float(out.loss))


def test_subs_d3pm_discrete_T_loss():
  """SUBS with T>0 uses the d3pm VLB without reconstruction
  (diffusion_gosai.py:1735-1743)."""
  cfg = tiny_test_config('rna')
  cfg.T = 50
  model = Diffusion(cfg, rng=jax.random.key(0))
  x0 = jax.random.randint(jax.random.key(1), (4, cfg.model.length),
                          0, 4)
  out = model.loss(model.variables, jax.random.key(2), x0)
  assert np.isfinite(float(out.loss))


def test_timed_guided_decode():
  """Step-indexed SVDD-MC: the value fn receives the diffusion step."""
  cfg = tiny_test_config('rna')
  model = Diffusion(cfg, rng=jax.random.key(0))
  from svdd import rewards, mdlm
  reward = rewards.synthetic_motif_oracle(cfg.model.length)
  seen_steps = []

  def value_fn_timed(tokens, step_idx):
    # time-dependent tilt (exercises the step plumbing)
    return reward(mdlm.transform_samples(tokens)) * (1.0 + 0 * step_idx)

  sampler = model.controlled_sampler_timed(value_fn_timed, 4,
                                           sample_M=2)
  x = np.asarray(sampler(jax.random.key(1)).samples)
  assert (x >= 0).all() and (x < 4).all()


def test_multisep_guided_decode():
  from svdd.models.multisep import MultiSepValueModel
  from svdd.models.convgru import ConvGRUValueModel
  from svdd import mdlm
  cfg = tiny_test_config('rna')
  model = Diffusion(cfg, rng=jax.random.key(0))
  msm = MultiSepValueModel(ConvGRUValueModel(), n_models=2,
                           num_steps=cfg.sampling.steps)
  stacked = msm.init(jax.random.key(1),
                     jnp.zeros((1, cfg.model.length, 4)))

  def value_fn_timed(tokens, step_idx):
    return msm.apply_at_step(stacked, mdlm.transform_samples(tokens),
                             step_idx)

  sampler = model.controlled_sampler_timed(value_fn_timed, 4,
                                           sample_M=2)
  x = np.asarray(sampler(jax.random.key(2)).samples)
  assert (x >= 0).all() and (x < 4).all()


def test_cnn_classifier_and_cls_guidance():
  from svdd.models.cnn import CNNModel
  cfg = tiny_test_config('rna')
  clf = CNNModel(config=cfg, alphabet_size=5, num_cls=3,
                 classifier=True)
  x = jnp.zeros((2, cfg.model.length), jnp.int32)
  variables = clf.init(jax.random.key(0), x, jnp.zeros((2,)))
  out = clf.apply(variables, x, jnp.zeros((2,)))
  assert out.shape == (2, 3)

  cfg2 = tiny_test_config('rna')
  cfg2.model.cls_free_guidance = True
  gen = CNNModel(config=cfg2, alphabet_size=5, num_cls=3)
  v2 = gen.init(jax.random.key(1), x, jnp.zeros((2,)))
  out_uncond = gen.apply(v2, x, jnp.zeros((2,)))
  out_cls0 = gen.apply(v2, x, jnp.zeros((2,)),
                       cls=jnp.zeros((2,), jnp.int32))
  assert out_uncond.shape == (2, cfg.model.length, 5)
  assert not np.allclose(np.asarray(out_uncond), np.asarray(out_cls0))


def test_saluki_transform_shape():
  from svdd import mdlm
  s = jnp.array([[0, 1, 4, 3]])
  out = mdlm.transform_samples_saluki(s, final_length=32)
  assert out.shape == (1, 32, 6)
  np.testing.assert_array_equal(np.asarray(out[0, 2]), np.zeros(6))
  body = jnp.ones((5, 6))
  out2 = mdlm.transform_samples_saluki(s, saluki_body=body,
                                       final_length=32)
  np.testing.assert_array_equal(np.asarray(out2[0, 4:9]),
                                np.ones((5, 6)))


def test_saluki_tweedie_decode():
  """rna_saluki SVDD-PM: reward scored through the 12288-length
  6-channel saluki input (tiny final_length here)."""
  import jax.numpy as jnp
  from svdd import mdlm
  cfg = tiny_test_config('rna')
  cfg.task = 'rna_saluki'
  model = Diffusion(cfg, rng=jax.random.key(0))

  def saluki_reward(onehot6):
    assert onehot6.shape[-1] == 6
    return onehot6[..., 2].sum(axis=-1)   # count of G channel

  sampler = model.tweedie_sampler(saluki_reward, 4, sample_M=2,
                                  task='rna_saluki',
                                  saluki_final_length=32)
  x = np.asarray(sampler(jax.random.key(1)).samples)
  assert (x >= 0).all() and (x < 4).all()
