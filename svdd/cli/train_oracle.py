"""Reward-oracle training entry (reference rna_MRL_oracle.py).

Trains a reward oracle on labeled sequence data: ConvGRU for RNA MRL
(rna_MRL_oracle.py:22-75 trains a grelu ConvGRUModel on the
Sampson-2019 5'UTR CSV) or the 3-task Enformer model for DNA
(the gosai 'DNA_evaluation' artifact). With no CSV present the
synthetic dataset stands in, which yields a *real* learned oracle over
the planted-motif labels — enough to run the full train-value-net ->
guided-decode pipeline meaningfully offline.
"""

from __future__ import annotations

import argparse
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax

from svdd import utils
from svdd.checkpoint import save_pytree
from svdd.data.gosai import FaultTolerantIterator, GosaiDataset
from svdd.models.convgru import ConvGRUValueModel
from svdd.models.enformer import EnformerValueModel

LOGGER = utils.get_logger(__name__)


def build_module(task: str, small: bool):
  if task in ('rna', 'rna_saluki'):
    return ConvGRUValueModel(n_tasks=1)
  if small:
    return EnformerValueModel(n_tasks=3, n_conv=3, channels=256,
                              n_transformers=1, n_heads=2, key_len=8)
  return EnformerValueModel(n_tasks=3)


def run(args) -> None:
  length = args.length or (50 if args.task.startswith('rna') else 200)
  ds = GosaiDataset('train', length=length, data_dir=args.data_dir)
  val = GosaiDataset('val', length=length, data_dir=args.data_dir)
  if ds.synthetic:
    LOGGER.warning('no CSV found: training oracle on the synthetic '
                   'planted-motif dataset')
  it = iter(FaultTolerantIterator(ds, args.batch_size, seed=args.seed))

  module = build_module(args.task, args.small)
  n_tasks = 1 if args.task.startswith('rna') else 3
  variables = module.init(jax.random.key(args.seed),
                          jnp.zeros((1, length, 4)))
  params = variables.pop('params')
  extras = variables
  opt = optax.adamw(args.learning_rate)
  opt_state = opt.init(params)
  has_stats = 'batch_stats' in extras

  @jax.jit
  def step(params, extras, opt_state, seqs, labels, key):
    def loss_fn(p):
      onehot = jax.nn.one_hot(seqs, 4)
      v = {'params': p, **extras}
      if has_stats:
        preds, upd = module.apply(v, onehot, train=True,
                                  mutable=['batch_stats'],
                                  rngs={'dropout': key})
      else:
        preds, upd = module.apply(v, onehot, train=True,
                                  rngs={'dropout': key}), {}
      if n_tasks == 1:
        loss = jnp.mean((preds - labels[:, 0]) ** 2)
      else:
        loss = jnp.mean((preds - labels) ** 2)
      return loss, upd
    (loss, upd), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        params)
    updates, opt_state = opt.update(grads, opt_state, params)
    return (optax.apply_updates(params, updates), {**extras, **upd},
            opt_state, loss)

  key = jax.random.key(args.seed + 1)
  t0 = time.time()
  for i in range(args.max_iters):
    batch = next(it)
    key, sub = jax.random.split(key)
    params, extras, opt_state, loss = step(
        params, extras, opt_state, jnp.asarray(batch['seqs']),
        jnp.asarray(batch['clss']), sub)
    if (i + 1) % args.log_every == 0:
      LOGGER.info('oracle it %d MSE %.5f (%.1f it/s)', i + 1,
                  float(loss), args.log_every / (time.time() - t0))
      t0 = time.time()

  # validation pearson on held-out data
  v = {'params': params, **extras}
  preds = np.asarray(module.apply(
      v, jax.nn.one_hot(jnp.asarray(val.seqs[:512]), 4)))
  labels = val.clss[:512, 0] if n_tasks == 1 else val.clss[:512]
  p0 = preds if n_tasks == 1 else preds[:, 0]
  l0 = labels if n_tasks == 1 else labels[:, 0]
  denom = p0.std() * l0.std()
  r = float(((p0 - p0.mean()) * (l0 - l0.mean())).mean() / denom) \
      if denom > 0 else 0.0
  LOGGER.info('val pearson (task 0): %.4f', r)

  if args.save_path:
    save_pytree(args.save_path, v)
    LOGGER.info('saved oracle to %s', args.save_path)


def main() -> None:
  p = argparse.ArgumentParser(description='reward-oracle training')
  p.add_argument('--task', default='rna',
                 choices=['dna', 'rna', 'rna_saluki'])
  p.add_argument('--length', type=int, default=None)
  p.add_argument('--batch_size', type=int, default=64)
  p.add_argument('--max_iters', type=int, default=2000)
  p.add_argument('--learning_rate', type=float, default=1e-3)
  p.add_argument('--log_every', type=int, default=100)
  p.add_argument('--seed', type=int, default=0)
  p.add_argument('--data_dir', default=None)
  p.add_argument('--save_path', default=None)
  p.add_argument('--small', action='store_true', default=False)
  run(p.parse_args())


if __name__ == '__main__':
  main()
