"""chip_smoke.py's contract: no result without a GPU or without the
repository around it, and the full main-path smoke passes on a GPU."""

import json
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _smoke(cwd, env, timeout, *args):
  return subprocess.run([sys.executable, 'chip_smoke.py', *args], cwd=cwd,
                        env=env, capture_output=True, text=True,
                        timeout=timeout)


@pytest.mark.parametrize('args', [(), ('--four',)], ids=['one', 'four'])
def test_chip_smoke_refuses_cpu(args):
  """No GPU: non-zero exit and no {"ok": true} line — there is no CPU
  path."""
  env = dict(os.environ, JAX_PLATFORMS='cpu')
  r = _smoke(REPO, env, 300, *args)
  assert r.returncode != 0
  assert '"ok": true' not in r.stdout
  assert 'no GPU' in r.stderr


def test_chip_smoke_needs_the_repository(tmp_path):
  shutil.copy(os.path.join(REPO, 'chip_smoke.py'), tmp_path)
  env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
  r = _smoke(str(tmp_path), env, 300)
  assert r.returncode != 0
  assert '"ok": true' not in r.stdout


@pytest.mark.gpu
def test_chip_smoke_passes_on_gpu(gpu_env):
  r = _smoke(REPO, gpu_env, 1500)
  assert r.returncode == 0, r.stderr[-4000:]
  last = json.loads(r.stdout.strip().splitlines()[-1])
  assert last['ok'] is True and last['device']['platform'] == 'gpu'
