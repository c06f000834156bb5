"""Value-net accuracy evaluation entry (reference eval.py).

Samples batches from the frozen diffusion model, compares value-net
predictions to reward-oracle outputs with streaming PearsonR
(eval.py:55-131, Enformer.py evaluation:343-397).
"""

from __future__ import annotations

import jax
import numpy as np

from svdd import mdlm, utils
from svdd.cli import common
from svdd.eval.metrics import PearsonState

LOGGER = utils.get_logger(__name__)


def run(args) -> None:
  cfg = common.task_config(args)
  diffusion = common.load_diffusion(args, cfg)
  reward_fn = common.load_reward_fn(args, cfg)
  vf = common.load_value_function(args, cfg)

  # rna_saluki: the oracle scores the padded (N, 12288, 6) saluki
  # input while the value net sees the plain 4-channel one-hot
  # (Enformer.py:142-143 / evaluation:343-397 target branch)
  from svdd.value import as_reward_callable, make_reward_transform
  reward_fn = as_reward_callable(reward_fn)
  reward_transform = make_reward_transform(
      args.task,
      common.load_saluki_body(args) if args.task == 'rna_saluki'
      else None,
      args.saluki_final_length)

  sampler = diffusion.sampler(args.batch_size)
  pearson = PearsonState.init(1)
  preds_all, targets_all = [], []
  key = jax.random.key(args.seed)
  for i in range(args.val_batch_num):
    key, sub = jax.random.split(key)
    samples = sampler(sub).samples
    onehot = mdlm.transform_samples(samples)
    target = reward_fn(reward_transform(samples))
    pred = vf.score_onehot(onehot)
    pearson = pearson.update(target, pred)
    preds_all.append(np.asarray(pred))
    targets_all.append(np.asarray(target))
    LOGGER.info('batch %d pearson so far %.4f', i,
                float(pearson.compute()))
  preds = np.concatenate(preds_all)
  targets = np.concatenate(targets_all)
  LOGGER.info('final pearson %.4f  MSE %.5f (n=%d)',
              float(pearson.compute()),
              float(np.mean((preds - targets) ** 2)), preds.size)
  from svdd.observability import MetricsLogger
  logger = MetricsLogger(
      log_dir=args.out_dir,
      run_name=args.run_name or f'{args.task}-{args.reward_name}-eval')
  logger.log({'eval/pearson': float(pearson.compute()),
              'eval/mse': float(np.mean((preds - targets) ** 2)),
              'eval/n': int(preds.size)})
  logger.finish()


def main() -> None:
  parser = common.make_parser('value-net accuracy evaluation')
  run(parser.parse_args())


if __name__ == '__main__':
  main()
