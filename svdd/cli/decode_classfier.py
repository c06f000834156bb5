"""Classifier-guidance decode CLI (reference decode_classfier.py —
filename typo preserved for script parity).

Adds --guidance_scale; writes log/{task}-{reward}-classfier.npz plus a
metrics JSONL row. The reference needs cudnn disabled for the GRU
backward (its diff sets torch.backends.cudnn.enabled=False); the
lax.scan GRU differentiates natively. rna_saluki is rejected: the
value-net gradient consumes (B, L, 4) one-hots.
"""

from __future__ import annotations

import time

from svdd import utils
from svdd.cli import common
from svdd.decode import run_decode

LOGGER = utils.get_logger(__name__)


def run(args) -> None:
  common.reject_saluki(args, 'decode_classfier')
  cfg = common.task_config(args)
  diffusion = common.load_diffusion(args, cfg)
  reward_fn = common.load_reward_fn(args, cfg)
  vf = common.load_value_function(args, cfg)

  t0 = time.perf_counter()
  result = run_decode(
      diffusion, reward_fn,
      algo='classifier',
      value_fn=vf.as_onehot_pair(),
      gen_batch_num=args.val_batch_num,
      batch_size=args.batch_size,
      sample_M=args.sample_M,
      guidance_scale=args.guidance_scale,
      seed=args.seed,
      skip_best_of_n=args.skip_best_of_n,
  )
  common.finish_run(args, result, '-classfier',
                    extra_metrics={'algo': 'classifier',
                                   'guidance_scale': args.guidance_scale,
                                   'wall_s': time.perf_counter() - t0})


def main() -> None:
  parser = common.make_parser('classifier-guidance decoding')
  parser.add_argument('--guidance_scale', type=float, default=1.0)
  run(parser.parse_args())


if __name__ == '__main__':
  main()
