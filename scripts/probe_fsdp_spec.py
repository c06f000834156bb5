"""FSDP PartitionSpec axis-choice probe (VERDICT r3 item 5).

The r3 comm budget showed ~34-39% of FSDP train-step bytes in
all-to-all + collective-permute — XLA re-laying-out the ZeRO shards
around the all-gather-at-use / grad-reduce pattern. This probe
HLO-counts the per-step collective traffic of the REAL diffusion train
step under different fsdp_spec axis rules to find the layout XLA
gathers cheaply:

  largest  — shard the largest divisible axis (the r3 rule)
  first    — shard the first (major-most) divisible axis
  last     — shard the last (minor-most) divisible axis

Usage: python scripts/probe_fsdp_spec.py [--devices 8]
"""

from __future__ import annotations

import argparse
import os
import re
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from comm_budget import _force_virtual_cpu, parse_collectives  # noqa


def main() -> None:
  ap = argparse.ArgumentParser()
  ap.add_argument('--devices', type=int, default=8)
  args = ap.parse_args()
  _force_virtual_cpu(args.devices)
  import jax
  import jax.numpy as jnp
  jax.config.update('jax_platforms', 'cpu')

  from jax.sharding import PartitionSpec as P
  from svdd.config import tiny_test_config
  from svdd.diffusion import Diffusion
  from svdd.parallel import mesh as M
  from svdd.train import diffusion as train_diff

  n = args.devices

  def make_rule(which):
    def rule(x, mesh, min_size):
      n_data = mesh.shape[M.DATA_AXIS]
      if x.ndim == 0 or x.size < min_size:
        return P()
      cands = [i for i, d in enumerate(x.shape) if d % n_data == 0]
      if not cands:
        return P()
      if which == 'largest':
        axis = max((x.shape[i], i) for i in cands)[1]
      elif which == 'first':
        axis = cands[0]
      else:
        axis = cands[-1]
      spec = [None] * x.ndim
      spec[axis] = M.DATA_AXIS
      return P(*spec)
    return rule

  orig = M.fsdp_spec
  for which in ('largest', 'first', 'last'):
    M.fsdp_spec = make_rule(which)
    mesh = M.make_mesh(data=n, model=1, devices=jax.devices()[:n])
    cfg = tiny_test_config('dna')
    cfg.parallel.fsdp = True
    cfg.model.hidden_dim = 64
    cfg.loader.batch_size = 8 * n
    model = Diffusion(cfg, rng=jax.random.key(0))
    trainer = train_diff.Trainer(model, cfg, mesh=mesh)
    state = trainer.init_or_restore(jax.random.key(1))
    batch = {
        'seqs': jnp.zeros((cfg.loader.batch_size, cfg.model.length),
                          jnp.int32),
        'attention_mask': jnp.ones(
            (cfg.loader.batch_size, cfg.model.length)),
    }
    with mesh:
      sharded = trainer._put(batch)
      compiled = trainer.train_step.lower(state, sharded).compile()
    colls = parse_collectives(compiled.as_text())
    total = sum(sum(v) for v in colls.values())
    kinds = ', '.join(f'{k}x{len(v)} ({sum(v):,}B)'
                      for k, v in sorted(colls.items()))
    print(f'{which:8s} total {total:12,} B/step   {kinds}', flush=True)
  M.fsdp_spec = orig


if __name__ == '__main__':
  main()
