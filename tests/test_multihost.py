"""REAL multi-process multi-host validation (SURVEY §2.2 comm
backend; §7.2 step 7 "multi-host via jax.distributed.initialize").

The reference bootstraps multi-process training with
dist.init_process_group("nccl", ...) + mp.spawn
(reference train.py:36-45,295-300). Our equivalent is
parallel.mesh.initialize_multihost (jax.distributed). The
single-process tests elsewhere exercise multi-DEVICE meshes; this one
spawns TWO actual processes (2 virtual CPU devices each, 4 global),
runs the real DP diffusion train step over the global mesh in both,
and pins:

  * jax.device_count()==4 / local_device_count()==2 per process,
  * local_shard_info() == (2, pid) (the distributed-sampler contract,
    reference dataloader_gosai.py:218-272),
  * both processes compute the IDENTICAL loss trajectory, which
    matches a single-process run of the same global batch (the DDP
    grad all-reduce semantics, numerics-pinned).
"""

import json
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = r"""
import json, sys
pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
from svdd.parallel import mesh as M
M.initialize_multihost(f'localhost:{port}', num_processes=nproc,
                       process_id=pid)
import jax
import jax.numpy as jnp
assert jax.device_count() == 2 * nproc, jax.devices()
assert jax.local_device_count() == 2
assert M.local_shard_info() == (nproc, pid)

from svdd.config import tiny_test_config
from svdd.diffusion import Diffusion
from svdd.train import diffusion as train_diff

cfg = tiny_test_config('rna')
model = Diffusion(cfg, rng=jax.random.key(0))
mesh = M.make_mesh()
trainer = train_diff.Trainer(model, cfg, mesh=mesh)
state = trainer.init_or_restore(jax.random.key(1))
key = jax.random.key(7)
batch = {'seqs': jax.random.randint(key, (8, cfg.model.length), 0, 4),
         'attention_mask': jnp.ones((8, cfg.model.length))}
losses = []
for _ in range(2):
  state, loss = trainer.train_step(state, trainer._put(dict(batch)))
  losses.append(float(loss))
print('RESULT ' + json.dumps({'pid': pid, 'losses': losses}), flush=True)
"""


def test_two_process_dp_train_matches_single_process(tmp_path):
  worker = tmp_path / 'mh_worker.py'
  worker.write_text(WORKER)
  env = dict(os.environ, JAX_PLATFORMS='cpu',
             XLA_FLAGS='--xla_force_host_platform_device_count=2',
             PYTHONPATH=REPO)

  # pick a free port (a hardcoded one collides with concurrent test
  # runs or a TIME_WAIT coordinator socket from a killed run)
  import socket
  with socket.socket() as s:
    s.bind(('localhost', 0))
    port = str(s.getsockname()[1])
  procs = [subprocess.Popen(
      [sys.executable, str(worker), str(pid), '2', port],
      stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
      cwd=REPO, env=env) for pid in range(2)]
  outs = [p.communicate(timeout=600) for p in procs]
  results = {}
  for p, (out, err) in zip(procs, outs):
    assert p.returncode == 0, err[-3000:]
    row = next(l for l in out.splitlines() if l.startswith('RESULT '))
    row = json.loads(row[len('RESULT '):])
    results[row['pid']] = row['losses']

  # both controllers computed the identical global step
  np.testing.assert_array_equal(results[0], results[1])

  # ... and it matches the single-process run of the same global batch
  import jax
  import jax.numpy as jnp

  from svdd.config import tiny_test_config
  from svdd.diffusion import Diffusion
  from svdd.train import diffusion as train_diff

  cfg = tiny_test_config('rna')
  model = Diffusion(cfg, rng=jax.random.key(0))
  trainer = train_diff.Trainer(model, cfg)
  state = trainer.init_or_restore(jax.random.key(1))
  key = jax.random.key(7)
  batch = {'seqs': jax.random.randint(key, (8, cfg.model.length), 0, 4),
           'attention_mask': jnp.ones((8, cfg.model.length))}
  ref = []
  for _ in range(2):
    state, loss = trainer.train_step(state, dict(batch))
    ref.append(float(loss))
  np.testing.assert_allclose(results[0], ref, rtol=1e-5)
