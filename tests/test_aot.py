"""AOT sampler serialization round-trip (svdd/aot.py).

The exported artifact must reproduce the live jitted sampler exactly
(same program, same key, same params) and must survive a fresh
deserialize with no svdd model code on the call path.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np

from svdd import aot, mdlm, rewards
from svdd.config import tiny_test_config
from svdd.diffusion import Diffusion


def _mc_sampler():
  cfg = tiny_test_config('rna')
  model = Diffusion(cfg, rng=jax.random.key(0))
  reward = rewards.synthetic_motif_oracle(cfg.model.length)
  value_fn = lambda tok: reward(mdlm.transform_samples(tok))
  return model.controlled_sampler(value_fn, 4, sample_M=2, num_steps=4)


def test_aot_sampler_roundtrip(tmp_path):
  sampler = _mc_sampler()
  key = jax.random.key(7)
  want = sampler(key)

  path = tmp_path / 'mc.svddx'
  size = aot.export_sampler(sampler, path)
  assert size > len(aot.MAGIC)

  call = aot.load_sampler(path)
  den_vars, extra_vars = sampler.default_args
  got = call(den_vars, extra_vars, key)
  np.testing.assert_array_equal(np.asarray(got.samples),
                                np.asarray(want.samples))


def test_aot_bad_magic(tmp_path):
  p = tmp_path / 'junk.svddx'
  p.write_bytes(b'not an artifact')
  try:
    aot.load(p)
  except ValueError as e:
    assert 'bad magic' in str(e)
  else:
    raise AssertionError('expected ValueError')


def test_aot_compiled_executable_roundtrip(tmp_path):
  """The executable artifact reproduces the live sampler with no
  recompile (same backend in-process, so load must succeed)."""
  sampler = _mc_sampler()
  key = jax.random.key(11)
  want = sampler(key)
  path = tmp_path / 'mc.svddc'
  size = aot.export_compiled(sampler, path)
  assert size > len(aot.MAGIC_EXEC)
  call = aot.load_compiled(path)
  den_vars, extra_vars = sampler.default_args
  got = call(den_vars, extra_vars, key)
  np.testing.assert_array_equal(np.asarray(got.samples),
                                np.asarray(want.samples))


def test_aot_cache_in_run_decode(tmp_path, monkeypatch):
  """SVDD_AOT_CACHE: first run_decode exports the artifact, second
  loads it (no compile) and reproduces the run exactly."""
  from svdd import decode, mdlm, rewards
  from svdd.config import tiny_test_config
  from svdd.diffusion import Diffusion

  monkeypatch.setenv('SVDD_AOT_CACHE', str(tmp_path))
  cfg = tiny_test_config('rna')
  model = Diffusion(cfg, rng=jax.random.key(0))
  reward = rewards.synthetic_motif_oracle(cfg.model.length)
  value_fn = lambda tok: reward(mdlm.transform_samples(tok))
  kwargs = dict(algo='svdd_mc', value_fn=value_fn, batch_size=4,
                sample_M=2, skip_best_of_n=True, task='rna')
  first = decode.run_decode(model, reward, **kwargs)
  arts = list(tmp_path.glob('*.svddc'))
  assert len(arts) == 1 and arts[0].stat().st_size > 0
  second = decode.run_decode(model, reward, **kwargs)
  np.testing.assert_array_equal(first.samples, second.samples)


def test_aot_tds_dict_aux_roundtrip(tmp_path):
  """The TDS sampler's ESS-telemetry aux is a DICT carry (r5): the
  exported executable must serialize/restore the dict result treedef
  and reproduce samples + the ESS trace exactly."""
  from svdd import rewards
  from svdd.config import tiny_test_config
  from svdd.diffusion import Diffusion

  cfg = tiny_test_config('rna')
  model = Diffusion(cfg, rng=jax.random.key(0))
  reward = rewards.synthetic_motif_oracle(cfg.model.length)
  sampler = model.tds_sampler(reward, 4, alpha=0.5, num_steps=4)
  key = jax.random.key(12)
  want = sampler(key)
  path = tmp_path / 'tds.svddc'
  aot.export_compiled(sampler, path)
  call = aot.load_compiled(path)
  den_vars, extra_vars = sampler.default_args
  got = call(den_vars, extra_vars, key)
  np.testing.assert_array_equal(np.asarray(got.samples),
                                np.asarray(want.samples))
  np.testing.assert_array_equal(np.asarray(got.extra['ess']),
                                np.asarray(want.extra['ess']))


def test_aot_export_fn_uncontrolled(tmp_path):
  """export_fn round-trips the plain (uncontrolled) sampler too."""
  cfg = tiny_test_config('rna')
  model = Diffusion(cfg, rng=jax.random.key(1))
  sampler = model.sampler(4, num_steps=4)
  key = jax.random.key(3)
  want = sampler(key)
  path = tmp_path / 'plain.svddx'
  aot.export_fn(sampler.jitted_fn, sampler.default_args + (key,), path)
  got = aot.load(path)(*sampler.default_args, key)
  np.testing.assert_array_equal(np.asarray(got.samples),
                                np.asarray(want.samples))
