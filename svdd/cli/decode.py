"""SVDD-MC decode CLI (reference decode.py).

Usage parity:
  python -m svdd.cli.decode --task rna --reward_name MRL --sample_M 10
Writes log/{task}-{reward}.npz with 'decoding'/'baseline' keys
(decode.py:117) and a metrics JSONL row (reference wandb-logs each run,
decode.py:55-62).
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
  vf = common.load_value_function(args, cfg)

  from svdd.utils import parse_m_schedule
  # phase lengths must also sum to the step count (validated in
  # sampler.reverse_process)
  m_schedule = parse_m_schedule(getattr(args, 'm_schedule', None))

  t0 = time.perf_counter()
  result = run_decode(
      diffusion, reward_fn,
      algo='svdd_mc',
      value_fn=vf.as_token_pair(),
      gen_batch_num=args.val_batch_num,
      batch_size=args.batch_size,
      sample_M=args.sample_M,
      seed=args.seed,
      skip_best_of_n=args.skip_best_of_n,
      m_schedule=m_schedule,
      task=cfg.task,
      saluki_body=common.load_saluki_body(args),
      saluki_final_length=args.saluki_final_length,
  )
  common.finish_run(args, result,
                    extra_metrics={'algo': 'svdd_mc',
                                   'm_schedule': getattr(
                                       args, 'm_schedule', None),
                                   'wall_s': time.perf_counter() - t0})


def main() -> None:
  parser = common.make_parser('SVDD-MC reward-guided decoding')
  parser.add_argument(
      '--m_schedule', type=str, default=None,
      help='opt-in scheduled-M decode: comma-separated steps:M phases '
           'covering the trajectory, e.g. "64:4,64:10" (4 candidates '
           'for the first 64 steps, 10 for the last 64). Overrides '
           '--sample_M.')
  run(parser.parse_args())


if __name__ == '__main__':
  main()
