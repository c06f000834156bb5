"""Test harness: force an 8-device virtual CPU mesh.

The reference never tests multi-device (SURVEY.md §4); we exercise every
sharded path on a virtual CPU mesh via
``--xla_force_host_platform_device_count=8``. Must be set before jax
initializes, hence the env mutation at import time. Tests always run on
the CPU, whatever accelerator the host has; code that needs a GPU is
covered by chip_smoke.py and by tests marked ``gpu``.
"""

import os
import sys

# the caller's environment, for tests that start a process on the GPU
HOST_ENV = dict(os.environ)

os.environ['JAX_PLATFORMS'] = 'cpu'
flags = os.environ.get('XLA_FLAGS', '')
if '--xla_force_host_platform_device_count' not in flags:
  os.environ['XLA_FLAGS'] = (
      flags + ' --xla_force_host_platform_device_count=8').strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

# jax may already be imported by a plugin; the config update still
# wins because backends initialize lazily on first computation.
jax.config.update('jax_platforms', 'cpu')
jax.config.update('jax_default_matmul_precision', 'highest')

import pytest  # noqa: E402


@pytest.fixture
def rng():
  return jax.random.key(0)


@pytest.fixture
def gpu_env():
  """Environment for a subprocess on the host's NVIDIA GPU; skips the
  test when the host has none. Decided here, never at import time."""
  import shutil
  import subprocess
  smi = shutil.which('nvidia-smi')
  if smi is None or subprocess.run(
      [smi, '-L'], capture_output=True).returncode != 0:
    pytest.skip('no NVIDIA GPU on this host')
  return HOST_ENV
