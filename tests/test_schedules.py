"""Schedules: closed-form expectations (reference noise_schedule.py)."""

import jax.numpy as jnp
import numpy as np
import pytest

from svdd import schedules


def test_loglinear_closed_form():
  s = schedules.loglinear(eps=1e-3)
  t = jnp.array([0.0, 0.25, 0.5, 0.9])
  sigma, dsigma = s(t)
  np.testing.assert_allclose(sigma, -np.log1p(-(1 - 1e-3) * np.asarray(t)),
                             rtol=5e-4)
  np.testing.assert_allclose(dsigma,
                             (1 - 1e-3) / (1 - (1 - 1e-3) * np.asarray(t)),
                             rtol=5e-4)
  # masking prob 1 - exp(-sigma) == (1-eps) t
  np.testing.assert_allclose(1 - np.exp(-np.asarray(sigma)),
                             (1 - 1e-3) * np.asarray(t),
                             rtol=5e-4, atol=1e-6)


def test_rate_is_derivative_of_total():
  # finite-difference check for every schedule
  for sched in [schedules.loglinear(), schedules.cosine(),
                schedules.cosinesqr(), schedules.linear(0.0, 10.0),
                schedules.geometric(1e-3, 1.0)]:
    t = jnp.linspace(0.05, 0.95, 7)
    h = 1e-4
    fd = (sched.total(t + h) - sched.total(t - h)) / (2 * h)
    np.testing.assert_allclose(sched.rate(t), fd, rtol=2e-2,
                               err_msg=sched.name)


def test_cosine_matches_reference_formula():
  eps = 1e-3
  s = schedules.cosine(eps)
  t = jnp.array([0.3])
  expected = -np.log(eps + (1 - eps) * np.cos(0.3 * np.pi / 2))
  np.testing.assert_allclose(s.total(t), [expected], rtol=1e-4)


def test_factory():
  assert schedules.get_schedule('loglinear').name == 'loglinear'
  assert schedules.get_schedule('geometric').name == 'geometric'
  with pytest.raises(ValueError):
    schedules.get_schedule('bogus')


def test_importance_transform_endpoints():
  s = schedules.loglinear()
  t = jnp.array([0.0, 1.0])
  out = s.importance_transform(t)
  assert float(out[0]) >= 0.0
  assert float(out[1]) <= 1.0 + 1e-6


def test_all_schedules_match_reference_module():
  """Pin every schedule against a torch mirror of the reference's
  noise_schedule.py (tests/torch_mirrors.py): total_noise and
  rate_noise agree on a t grid for all five schedule types."""
  import numpy as np
  import pytest
  torch = pytest.importorskip('torch')
  import torch_mirrors as ref_ns
  from svdd import schedules

  t = np.linspace(0.01, 0.99, 23).astype(np.float32)
  t_t = torch.tensor(t)
  # sigma_min/max per the reference's config yamls
  # (configs_gosai/noise/geometric.yaml: 1e-4/20;
  #  configs_gosai/noise/linear.yaml: 1e-3/7.0)
  cases = [
      ('loglinear', ref_ns.LogLinearNoise(), {}),
      ('cosine', ref_ns.CosineNoise(), {}),
      ('cosinesqr', ref_ns.CosineSqrNoise(), {}),
      ('linear', ref_ns.Linear(sigma_min=1e-3, sigma_max=7.0),
       dict(sigma_min=1e-3, sigma_max=7.0)),
      ('geometric', ref_ns.GeometricNoise(sigma_min=1e-4,
                                          sigma_max=20.0),
       dict(sigma_min=1e-4, sigma_max=20.0)),
  ]
  for name, ref, kw in cases:
    sched = schedules.get_schedule(name, **kw)
    total, rate = sched(t)
    np.testing.assert_allclose(
        np.asarray(total), ref.total_noise(t_t).numpy(),
        rtol=2e-5, atol=2e-6, err_msg=f'{name} total_noise')
    np.testing.assert_allclose(
        np.asarray(rate), ref.rate_noise(t_t).numpy(),
        rtol=2e-5, atol=2e-6, err_msg=f'{name} rate_noise')
