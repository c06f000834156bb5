"""SVDD-PM (Tweedie) decode CLI (reference decode_tweedie.py).

Adds --tweedie (posterior-mean vs mask-to-zero heuristic) and writes
log/{task}-{reward}_tw.npz plus a metrics JSONL row.
"""

from __future__ import annotations

import time

from svdd import utils
from svdd.cli import common
from svdd.decode import run_decode

LOGGER = utils.get_logger(__name__)


def run(args) -> None:
  cfg = common.task_config(args)
  diffusion = common.load_diffusion(args, cfg)
  reward_fn = common.load_reward_fn(args, cfg)

  from svdd.utils import parse_m_schedule
  m_schedule = parse_m_schedule(getattr(args, 'm_schedule', None))

  t0 = time.perf_counter()
  result = run_decode(
      diffusion, reward_fn,
      algo='svdd_pm',
      gen_batch_num=args.val_batch_num,
      batch_size=args.batch_size,
      sample_M=args.sample_M,
      tweedie=str(args.tweedie) == 'True',
      seed=args.seed,
      skip_best_of_n=args.skip_best_of_n,
      m_schedule=m_schedule,
      task=cfg.task,
      saluki_body=common.load_saluki_body(args),
      saluki_final_length=args.saluki_final_length,
  )
  common.finish_run(args, result, '_tw',
                    extra_metrics={'algo': 'svdd_pm',
                                   'tweedie': str(args.tweedie),
                                   'm_schedule': getattr(
                                       args, 'm_schedule', None),
                                   'wall_s': time.perf_counter() - t0})


def main() -> None:
  parser = common.make_parser('SVDD-PM (Tweedie) decoding')
  parser.add_argument('--tweedie', type=str, default='True',
                      help="'True' = posterior mean; else mask-to-zero "
                           'heuristic (decode_tweedie.py --tweedie)')
  parser.add_argument(
      '--m_schedule', type=str, default=None,
      help='opt-in scheduled-M phases "96:10,32:4" (see decode '
           '--m_schedule; both the candidate denoiser and reward '
           'forwards scale with M here)')
  run(parser.parse_args())


if __name__ == '__main__':
  main()
