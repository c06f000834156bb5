"""svdd._vendor: where ``import flax`` fails, ``import svdd`` loads the
vendored flax, and models built on it match the installed flax."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from svdd import _vendor

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)

# Run in a child process before anything imports flax: the installed
# flax no longer resolves, as on a host that lacks it.
_HIDE_FLAX = '''
import sys
class _NoFlax:
  def find_spec(self, name, path=None, target=None):
    if name == 'flax':
      raise ModuleNotFoundError("No module named 'flax'", name='flax')
sys.meta_path.insert(0, _NoFlax())
'''


def _forward(name: str) -> np.ndarray:
  """A small denoiser or value net, initialised and applied on the CPU."""
  key = jax.random.key(0)
  if name == 'cnn':
    from svdd.config import tiny_test_config
    from svdd.models.cnn import CNNModel
    cfg = tiny_test_config('dna')
    cfg.model.hidden_dim = 32
    cfg.model.num_cnn_stacks = 1
    cfg.model.length = 16
    model = CNNModel(config=cfg, alphabet_size=5, num_cls=3)
    args = (jax.random.randint(key, (2, 16), 0, 5), jnp.full((2,), 0.3))
  else:
    from svdd.models.enformer import EnformerValueModel
    model = EnformerValueModel(n_tasks=1, n_conv=3, channels=256,
                               n_transformers=1, n_heads=2, key_len=8)
    args = (jax.random.normal(key, (2, 24, 4)),)
  variables = model.init(jax.random.key(1), *args)
  return np.asarray(model.apply(variables, *args))


def _run_child(code: str) -> subprocess.CompletedProcess:
  env = dict(os.environ, PYTHONPATH=os.pathsep.join([REPO, TESTS]))
  return subprocess.run([sys.executable, '-c', _HIDE_FLAX + code],
                        cwd=REPO, env=env, capture_output=True, text=True,
                        timeout=300)


def test_installed_flax_is_preferred():
  import flax
  assert _vendor.ensure_flax() is flax
  assert not flax.__file__.startswith(_vendor.FLAX_DIR)


def test_vendored_flax_loads_without_installed_flax():
  r = _run_child(
      'import svdd, flax, flax.linen\n'
      'from svdd import _vendor\n'
      'assert flax.__file__.startswith(_vendor.FLAX_DIR), flax.__file__\n'
      'assert flax.linen.Module.__module__ == "flax.linen.module"\n'
      'print("OK")\n')
  assert r.returncode == 0, r.stderr[-4000:]
  assert r.stdout.strip().endswith('OK')


@pytest.mark.parametrize('name', ['cnn', 'enformer'])
def test_vendored_flax_matches_installed(name, tmp_path):
  out = tmp_path / 'out.npy'
  r = _run_child(
      'import sys, numpy as np\n'
      'import conftest\n'
      'import svdd, flax\n'
      'from svdd import _vendor\n'
      'assert flax.__file__.startswith(_vendor.FLAX_DIR)\n'
      'from test_vendored_flax import _forward\n'
      f'np.save({str(out)!r}, _forward({name!r}))\n')
  assert r.returncode == 0, r.stderr[-4000:]
  np.testing.assert_array_equal(np.load(out), _forward(name))
