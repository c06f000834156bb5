"""Shared decode-CLI scaffold.

The reference's six decode scripts share one argparse surface
(reference decode.py:122-213) and model-building preamble
(:52-108); this module centralizes both. Flag names are preserved
verbatim (--task, --reward_name, --sample_M, --batch_size,
--val_batch_num, --load_checkpoint_path, --alpha, --guidance_scale,
--tweedie, --cdq, --seed, --model ...) so reference users can switch
without relearning the CLI.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional

import jax

from svdd import rewards, utils, value as value_lib
from svdd.checkpoint import load_pytree
from svdd.config import Config, dna_config, rna_config
from svdd.diffusion import Diffusion

LOGGER = utils.get_logger(__name__)

# guided-decode compiles take minutes and are reusable across processes
utils.enable_compile_cache()


def make_parser(description: str) -> argparse.ArgumentParser:
  p = argparse.ArgumentParser(description=description)
  # the reference's flag surface (decode.py:122-213), minus dead
  # molecule-generation flags that nothing reads
  p.add_argument('--run_name', type=str, required=False)
  p.add_argument('--debug', action='store_true', default=False)
  p.add_argument('--task', type=str, default='dna',
                 help='dna / rna / rna_saluki')
  p.add_argument('--saluki_body', type=int, default=0,
                 help='reference surface parity: selects '
                      'saluki_body[_{N}].npy inside SVDD_DATA_DIR '
                      '(the reference hardcodes absolute paths, '
                      'Enformer.py:292-300)')
  p.add_argument('--saluki_body_path', type=str, default=None,
                 help=".npy file with the saluki constant 'body' "
                      'tensor appended behind each sequence '
                      '(rna_saluki task)')
  p.add_argument('--saluki_final_length', type=int, default=12288,
                 help='padded saluki oracle input length '
                      '(Enformer.py:279 final_length)')
  p.add_argument('--n_task', type=int, default=1)
  p.add_argument('--model', type=str, default='enformer',
                 help='enformer / multienformer / timedenformer')
  p.add_argument('--batch_size', type=int, default=256)
  p.add_argument('--sample_M', type=int, default=5)
  p.add_argument('--val_batch_num', type=int, default=1)
  p.add_argument('--seed', type=int, default=44)
  p.add_argument('--reward_name', type=str, default='HepG2')
  p.add_argument('--load_checkpoint_path', type=str, default=None,
                 help='value-net checkpoint (orbax dir or torch .pt)')
  p.add_argument('--pre_model_path', type=str, default=None)
  p.add_argument('--cdq', action='store_true', default=False)
  p.add_argument('--dist', action='store_true', default=False,
                 help='value training: shard the self-generated batch '
                      "over a 'data' mesh of all devices (the "
                      'reference spawns NCCL DDP here, '
                      'train.py:36-45,295-300)')
  # flags beyond the reference surface
  p.add_argument('--diffusion_checkpoint_path', type=str, default=None,
                 help='pretrained diffusion orbax checkpoint')
  p.add_argument('--reward_checkpoint_path', type=str, default=None,
                 help='reward-oracle orbax checkpoint')
  p.add_argument('--num_steps', type=int, default=None,
                 help='override sampling steps')
  p.add_argument('--length', type=int, default=None,
                 help='override sequence length')
  p.add_argument('--out_dir', type=str, default='./log')
  p.add_argument('--skip_best_of_n', action='store_true', default=False)
  return p


def task_config(args) -> Config:
  cfg = rna_config() if args.task in ('rna', 'rna_saluki') \
      else dna_config()
  cfg.task = args.task if args.task in ('dna', 'rna', 'rna_saluki') \
      else 'dna'
  if args.length:
    cfg.model.length = args.length
  if args.num_steps:
    cfg.sampling.steps = args.num_steps
  cfg.loader.eval_batch_size = args.batch_size
  return cfg


def _is_torch_ckpt(path: str) -> bool:
  return path.endswith(('.pt', '.pth', '.ckpt'))


def _torch_prefix(sd: dict, candidates: tuple[str, ...]) -> str:
  """Detect the submodule prefix a torch checkpoint was saved under
  (Lightning prepends 'backbone.'; DataParallel prepends 'module.',
  trainer.py:69-71)."""
  for p in candidates:
    if any(k.startswith(p) for k in sd):
      return p
  return ''


def load_diffusion(args, cfg: Config) -> Diffusion:
  """(Enformer.py:75-101 loads the frozen ref_model; here from orbax,
  or imported directly from a reference torch/Lightning .ckpt.)"""
  model = Diffusion(cfg, rng=jax.random.key(cfg.seed))
  path = args.diffusion_checkpoint_path
  if path and _is_torch_ckpt(path):
    from svdd.checkpoint import import_torch_state_dict
    sd = import_torch_state_dict(path)
    prefix = _torch_prefix(sd, ('backbone.', 'module.backbone.'))
    sd = {k[len(prefix):]: v for k, v in sd.items()
          if k.startswith(prefix)}
    if cfg.backbone == 'cnn':
      from svdd.importers.cnn import import_cnn_params
      model.variables = import_cnn_params(
          sd, num_layers=5 * cfg.model.num_cnn_stacks)
    elif cfg.backbone == 'dit':
      from svdd.importers.dit import import_dit_params
      model.variables = import_dit_params(sd, n_blocks=cfg.model.n_blocks)
    else:
      raise NotImplementedError(
          f'torch import for backbone {cfg.backbone}')
    LOGGER.info('imported torch diffusion ckpt %s', path)
  elif path:
    model.variables = load_pytree(path, model.variables)
    LOGGER.info('loaded diffusion ckpt %s', path)
  else:
    LOGGER.warning('no --diffusion_checkpoint_path: using randomly '
                   'initialized diffusion model')
  return model


def load_saluki_body(args):
  """The constant saluki 'body' tensor (coding region + tracks) the
  reference appends behind each 5'UTR (Enformer.py:292-300, hardcoded
  absolute .npy paths there). --saluki_body_path wins; the reference's
  int flag maps to saluki_body[_{N}].npy under SVDD_DATA_DIR."""
  import numpy as np
  path = args.saluki_body_path
  if not path and args.saluki_body:
    data_dir = os.environ.get('SVDD_DATA_DIR', '.')
    path = os.path.join(data_dir, f'saluki_body_{args.saluki_body}.npy')
  if not path:
    return None
  body = np.load(path)
  LOGGER.info('loaded saluki body %s %s', path, body.shape)
  import jax.numpy as jnp
  return jnp.asarray(body, jnp.float32)


def load_reward_fn(args, cfg: Config):
  """Frozen reward oracle (Enformer.py:103-133). Without a checkpoint
  the synthetic motif oracle stands in so pipelines stay runnable."""
  key = jax.random.key(0)
  if args.task == 'rna_saluki':
    # 6-channel saluki stability oracle over the padded 12288 input
    oracle = rewards.RewardOracle.create_saluki(
        key, final_length=getattr(args, 'saluki_final_length', 12288))
    if args.reward_checkpoint_path:
      oracle.variables = load_pytree(args.reward_checkpoint_path,
                                     oracle.variables)
      LOGGER.info('loaded reward oracle %s', args.reward_checkpoint_path)
    else:
      LOGGER.warning('no --reward_checkpoint_path: saluki oracle is '
                     'randomly initialized')
    return oracle.as_pair()
  if args.reward_checkpoint_path:
    if args.task == 'rna':
      oracle = rewards.RewardOracle.create_rna(cfg.model.length, key)
    else:
      oracle = rewards.RewardOracle.create_dna(cfg.model.length, key)
    path = args.reward_checkpoint_path
    if _is_torch_ckpt(path):
      # grelu LightningModel oracle ckpts (Enformer.py:104-133) carry
      # the same trunk layouts as the value nets under a 'model.'
      # prefix — reuse the value-model importers
      from svdd.checkpoint import import_torch_state_dict
      sd = import_torch_state_dict(path)
      prefix = _torch_prefix(sd, ('model.', 'module.', ''))
      if args.task == 'rna':
        from svdd.importers.convgru import import_convgru_value_model
        oracle.variables = import_convgru_value_model(sd, prefix=prefix)
      else:
        from svdd.importers.enformer import (
            import_enformer_value_model)
        oracle.variables = import_enformer_value_model(sd, prefix=prefix)
      LOGGER.info('imported torch reward oracle %s', path)
    else:
      oracle.variables = load_pytree(path, oracle.variables)
      LOGGER.info('loaded reward oracle %s', path)
    return oracle.as_pair()
  LOGGER.warning('no --reward_checkpoint_path: using synthetic motif '
                 'oracle')
  return rewards.synthetic_motif_oracle(cfg.model.length)


def load_value_function(args, cfg: Config) -> value_lib.ValueFunction:
  """Value net (decode.py:73-104): architecture by --model/--task,
  weights from --load_checkpoint_path."""
  vf = value_lib.ValueFunction.create(
      args.task if args.task in ('rna', 'rna_saluki') else 'dna',
      cfg.model.length, jax.random.key(1),
      model=args.model, n_tasks=args.n_task)
  path = args.load_checkpoint_path or args.pre_model_path
  if path and _is_torch_ckpt(path):
    # reference value-net checkpoints (trainer.py:73-96 dicts)
    from svdd.checkpoint import import_torch_state_dict
    sd = import_torch_state_dict(path)
    prefix = _torch_prefix(sd, ('module.',))
    if args.task in ('rna', 'rna_saluki'):
      from svdd.importers.convgru import import_convgru_value_model
      vf.variables = import_convgru_value_model(sd, prefix=prefix)
    else:
      from svdd.importers.enformer import import_enformer_value_model
      vf.variables = import_enformer_value_model(
          sd, timed=(args.model == 'timedenformer'), prefix=prefix)
    LOGGER.info('imported torch value net %s', path)
  elif path:
    vf.variables = load_pytree(path, vf.variables)
    LOGGER.info('loaded value net %s', path)
  else:
    LOGGER.warning('no --load_checkpoint_path: value net is randomly '
                   'initialized')
  return vf


def npz_path(args, suffix: str = '') -> str:
  """'./log/{task}-{reward}{suffix}.npz' (decode.py:117 and variants)."""
  import os
  return os.path.join(args.out_dir,
                      f'{args.task}-{args.reward_name}{suffix}.npz')


def reject_saluki(args, cli_name: str) -> None:
  """The in-scan reward guidance of TDS/DPS/classifier consumes
  (B, L, 4) one-hots; only the tweedie path builds the 12288x6 saluki
  oracle input (reference too: diffusion_gosai.py:1426-1428 is inside
  _ddpm_update_finetune_controlled_twedie only)."""
  if args.task == 'rna_saluki':
    raise SystemExit(
        f'{cli_name} does not support --task rna_saluki; use '
        'decode.py (SVDD-MC) or decode_tweedie.py (SVDD-PM)')


def finish_run(args, result, suffix: str = '',
               extra_metrics: Optional[dict] = None) -> dict:
  """Shared decode-CLI tail: write the npz, print + JSONL-log the
  quantile report (the reference wandb-logs from every decode script,
  decode.py:55-62)."""
  from svdd.eval.metrics import quantile_report
  from svdd.observability import MetricsLogger

  path = npz_path(args, suffix)
  result.save_npz(path)
  LOGGER.info('wrote %s', path)
  report = quantile_report({'decoding': result.reward_preds,
                            'baseline': result.baseline_preds,
                            'best_of_n': result.top_k})
  for name, row in report.items():
    LOGGER.info('%s: %s', name, row)

  run_name = args.run_name or f'{args.task}-{args.reward_name}{suffix}'
  logger = MetricsLogger(log_dir=args.out_dir, run_name=run_name)
  row = {'npz': path, 'n': int(len(result.reward_preds)),
         'batch_size': args.batch_size, 'sample_M': args.sample_M,
         'seed': args.seed}
  for name, stats in report.items():
    for q, v in stats.items():
      row[f'{name}/{q}'] = float(v)
  row.update(extra_metrics or {})
  logger.log(row)
  logger.finish()
  return report
