"""Value-network training entry (reference train.py).

Builds the value model variant (enformer / multienformer /
timedenformer — train.py:165-185), fits with MC or CD-Q targets
against a frozen diffusion model, periodically evaluates per-timestep
MSE/Pearson and checkpoints (trainer.py:243-249).
"""

from __future__ import annotations

import jax

from svdd import utils, value as value_lib
from svdd.checkpoint import save_pytree
from svdd.cli import common
from svdd.train import value as train_val

LOGGER = utils.get_logger(__name__)


def _build_mesh(args):
  """--dist: data-parallel mesh over ALL local devices — the JAX
  equivalent of the reference's mp.spawn NCCL DDP value training
  (reference train.py:36-45,295-300). Multi-host slices join via
  initialize_multihost (jax.distributed replaces the process-group
  bootstrap)."""
  if not getattr(args, 'dist', False):
    return None
  from svdd.parallel import mesh as M
  M.initialize_multihost()
  mesh = M.make_mesh()
  if args.batch_size % mesh.shape[M.DATA_AXIS]:
    raise SystemExit(
        f'--batch_size {args.batch_size} must divide over the '
        f"{mesh.shape[M.DATA_AXIS]}-device 'data' axis (the reference "
        'enforces the same global-batch divisibility, '
        'dataloader_gosai.py:104-114)')
  LOGGER.info('--dist: value training over a %s mesh%s',
              dict(mesh.shape),
              ' with FSDP param sharding' if getattr(args, 'fsdp', False)
              else '')
  return mesh


def run(args) -> None:
  if getattr(args, 'fsdp', False) and not getattr(args, 'dist', False):
    raise SystemExit('--fsdp requires --dist (param sharding lives on '
                     "the 'data' mesh axis)")
  if getattr(args, 'fsdp', False) and args.model == 'multienformer':
    raise SystemExit('--fsdp is not supported with '
                     '--model multienformer (the time-binned trunk '
                     'stack trains replicated; drop --fsdp)')
  # The mesh (and its multi-host bootstrap) MUST come before anything
  # that initializes the JAX backend — jax.distributed.initialize
  # after first use is an error, which would silently degrade a
  # multi-host run to independent per-host training.
  mesh = _build_mesh(args)
  cfg = common.task_config(args)
  diffusion = common.load_diffusion(args, cfg)
  reward_fn = common.load_reward_fn(args, cfg)

  if args.model == 'multienformer':
    _run_multisep(args, cfg, diffusion, reward_fn, mesh)
    return
  vf = common.load_value_function(args, cfg)

  tcfg = train_val.ValueTrainerConfig(
      learning_rate=args.learning_rate,
      grad_norm_clip=args.grad_norm_clip,
      max_iter=args.max_iters,
      cdq=args.cdq,
      batch_size=args.batch_size,
      lr_decay=args.lr_decay,
      task=args.task,
      saluki_final_length=args.saluki_final_length,
  )
  saluki_body = (common.load_saluki_body(args)
                 if args.task == 'rna_saluki' else None)
  trainer = train_val.ValueTrainer(diffusion, vf, reward_fn, tcfg,
                                   sample_M=args.sample_M,
                                   saluki_body=saluki_body,
                                   mesh=mesh, fsdp=args.fsdp)
  if args.resume_state_path:
    state = trainer.restore_state(args.resume_state_path,
                                  jax.random.key(args.seed))
    LOGGER.info('resumed trainer state at step %d (tokens %.3g)',
                int(state.step), float(state.tokens))
  else:
    state = trainer.init_state(jax.random.key(args.seed))

  eval_batches = eval_targets = None
  if args.val_batch_num > 0:
    eval_batches, eval_targets = train_val.build_eval_timestep_batches(
        diffusion, reward_fn, args.batch_size, args.val_batch_num,
        jax.random.key(args.seed + 1), task=args.task,
        saluki_body=saluki_body,
        saluki_final_length=args.saluki_final_length)

  from svdd.observability import MetricsLogger
  logger = MetricsLogger(
      log_dir=args.out_dir,
      run_name=args.run_name
      or f'{args.task}-{args.reward_name}-valuetrain')
  iters_done = 0
  while iters_done < tcfg.max_iter:
    chunk = min(args.eval_every, tcfg.max_iter - iters_done)
    state = trainer.train(state, chunk)
    iters_done += chunk
    if eval_batches is not None:
      losses, pearsons = trainer.evaluate_seq_step(
          state, eval_batches, eval_targets)
      LOGGER.info('it %d per-timestep MSE head/mid/tail: '
                  '%.4f / %.4f / %.4f  pearson: %.3f / %.3f / %.3f',
                  iters_done, losses[0], losses[len(losses) // 2],
                  losses[-1], pearsons[0], pearsons[len(pearsons) // 2],
                  pearsons[-1])
      logger.log({'eval/mse_head': float(losses[0]),
                  'eval/mse_mid': float(losses[len(losses) // 2]),
                  'eval/mse_tail': float(losses[-1]),
                  'eval/pearson_head': float(pearsons[0]),
                  'eval/pearson_mid':
                      float(pearsons[len(pearsons) // 2]),
                  'eval/pearson_tail': float(pearsons[-1])},
                 step=iters_done)
    if args.save_path:
      save_pytree(args.save_path,
                  {'params': state.params, **state.extras})
      LOGGER.info('saved value net to %s', args.save_path)
    if args.save_state_path:
      trainer.save_state(args.save_state_path, state)
      LOGGER.info('saved full trainer state to %s',
                  args.save_state_path)
  logger.finish()


def _run_multisep(args, cfg, diffusion, reward_fn, mesh=None) -> None:
  """--model multienformer (reference train.py:172-178 ->
  BaseModelMultiSep, time-binned trunks)."""
  import jax
  from svdd.models.multisep import MultiSepValueModel
  from svdd.value import build_value_module
  module = build_value_module(
      args.task if args.task in ('rna', 'rna_saluki') else 'dna',
      'enformer', n_tasks=args.n_task)
  msm = MultiSepValueModel(module, n_models=10,
                           num_steps=cfg.sampling.steps)
  tcfg = train_val.ValueTrainerConfig(
      learning_rate=args.learning_rate, batch_size=args.batch_size,
      max_iter=args.max_iters, task=args.task,
      saluki_final_length=args.saluki_final_length)
  saluki_body = (common.load_saluki_body(args)
                 if args.task == 'rna_saluki' else None)
  trainer = train_val.MultiSepTrainer(diffusion, msm, reward_fn, tcfg,
                                      saluki_body=saluki_body,
                                      mesh=mesh)
  state = trainer.init_state(jax.random.key(args.seed))
  state = trainer.train(state, tcfg.max_iter, log_every=args.eval_every)
  if args.save_path:
    save_pytree(args.save_path, state[1])
    LOGGER.info('saved multisep value net to %s', args.save_path)


def main() -> None:
  parser = common.make_parser('value-network training (MC / CD-Q)')
  parser.add_argument('--max_iters', type=int, default=50_000)
  parser.add_argument('--learning_rate', type=float, default=2e-4)
  parser.add_argument('--grad_norm_clip', type=float, default=1.0)
  parser.add_argument('--lr_decay', action='store_true', default=False)
  parser.add_argument('--eval_every', type=int, default=200)
  parser.add_argument('--save_path', type=str, default=None)
  parser.add_argument('--save_state_path', type=str, default=None,
                      help='full trainer state (params + optimizer + '
                           'token counter + rng) for exact resume, '
                           'like the reference trainer.py:73-96 dicts')
  parser.add_argument('--resume_state_path', type=str, default=None)
  parser.add_argument('--fsdp', action='store_true', default=False,
                      help='with --dist: shard value-net params + '
                           "optimizer state over the 'data' axis "
                           '(ZeRO-style; beyond the reference, which '
                           'replicates value nets under DDP)')
  run(parser.parse_args())


if __name__ == '__main__':
  main()
