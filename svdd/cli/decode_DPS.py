"""DPS (gradient guidance) decode CLI (reference decode_DPS.py).

Adds --guidance_scale; writes log/{task}-{reward}_DPS.npz plus a
metrics JSONL row. No model.train() toggle needed — jax.grad
differentiates the eval-mode forward directly. rna_saluki is rejected:
the in-scan reward gradient consumes (B, L, 4) one-hots (the reference
builds saluki inputs only inside the tweedie update,
diffusion_gosai.py:1426-1428).
"""

from __future__ import annotations

import time

from svdd import utils
from svdd.cli import common
from svdd.decode import run_decode

LOGGER = utils.get_logger(__name__)

NPZ_SUFFIX = '_DPS'


def run(args, suffix: str = NPZ_SUFFIX) -> None:
  common.reject_saluki(args, f'decode{suffix}')
  cfg = common.task_config(args)
  diffusion = common.load_diffusion(args, cfg)
  reward_fn = common.load_reward_fn(args, cfg)

  t0 = time.perf_counter()
  result = run_decode(
      diffusion, reward_fn,
      algo='dps',
      gen_batch_num=args.val_batch_num,
      batch_size=args.batch_size,
      sample_M=args.sample_M,
      guidance_scale=args.guidance_scale,
      seed=args.seed,
      skip_best_of_n=args.skip_best_of_n,
  )
  common.finish_run(args, result, suffix,
                    extra_metrics={'algo': 'dps',
                                   'guidance_scale': args.guidance_scale,
                                   'wall_s': time.perf_counter() - t0})


def main() -> None:
  parser = common.make_parser('DPS gradient-guided decoding')
  parser.add_argument('--guidance_scale', type=float, default=1e5)
  run(parser.parse_args())


if __name__ == '__main__':
  main()
