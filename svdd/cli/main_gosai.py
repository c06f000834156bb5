"""Diffusion pretrain entry (reference main_gosai.py).

Modes: train / ppl_eval / sample_eval (main_gosai.py:205-226). Hydra is
replaced by the typed config (--config yaml overlay + dotted
--set key=value overrides). Multi-device runs shard the global batch
over the 'data' mesh axis automatically.
"""

from __future__ import annotations

import argparse
import functools
import json

import jax
import numpy as np

from svdd import utils
from svdd.config import Config, dna_config, rna_config
from svdd.data import gosai
from svdd.diffusion import Diffusion
from svdd.train import diffusion as train_diff

LOGGER = utils.get_logger(__name__)


def parse_overrides(pairs):
  out = {}
  for pair in pairs or []:
    k, v = pair.split('=', 1)
    cur = out
    parts = k.split('.')
    for p in parts[:-1]:
      cur = cur.setdefault(p, {})
    try:
      v = json.loads(v)
    except json.JSONDecodeError:
      pass
    cur[parts[-1]] = v
  return out


def build_config(args) -> Config:
  if args.config:
    cfg = Config.from_yaml(args.config)
  else:
    cfg = rna_config() if args.task == 'rna' else dna_config()
  overrides = parse_overrides(args.set)
  if overrides:
    cfg = cfg.override(**overrides)
  return cfg


def _print_config(cfg: Config) -> None:
  """Config tree dump (main_gosai.py:46-78 rich tree -> plain json)."""
  LOGGER.info('config:\n%s', json.dumps(cfg.to_dict(), indent=2,
                                        default=str))


def _make_sample_eval_fn(cfg: Config, args, model):
  """In-training sample-quality validation hook
  (diffusion_gosai.py:451-565): Wasserstein truth/pred per cell type,
  3-mer Pearson, emb-PCA Wasserstein, on EMA samples. Oracle = loaded
  checkpoint when given, else the synthetic motif oracle stand-in."""
  from svdd import rewards
  from svdd.eval import validation

  datasets = {}
  for split in ('train', 'val'):
    try:
      datasets[split] = gosai.GosaiDataset(
          split, length=cfg.model.length, data_dir=args.data_dir)
    except Exception as exc:                           # noqa: BLE001
      LOGGER.warning('sample-eval: no %s dataset (%s)', split, exc)
  if not datasets:
    return None

  if args.eval_oracle_checkpoint_path:
    from svdd.checkpoint import load_pytree
    oracle = (rewards.RewardOracle.create_rna(cfg.model.length,
                                              jax.random.key(0))
              if cfg.task.startswith('rna') else
              rewards.RewardOracle.create_dna(cfg.model.length,
                                              jax.random.key(0)))
    oracle.variables = load_pytree(args.eval_oracle_checkpoint_path,
                                   oracle.variables)
    apply_fn, ovars = oracle.as_pair()
    # weights as a jit ARGUMENT, not a closure (closed-over weights
    # inline as HLO constants -> >20 min remote compiles)
    oracle_fn = functools.partial(jax.jit(apply_fn), ovars)
  else:
    LOGGER.warning('sample-eval: no --eval_oracle_checkpoint_path, '
                   'using the synthetic motif oracle')
    oracle_fn = rewards.synthetic_motif_oracle(cfg.model.length)

  bs = min(cfg.loader.eval_batch_size, 64)

  def hook(ema_variables, key):
    return validation.distribution_eval(
        model, ema_variables, datasets, key, oracle_fn=oracle_fn,
        n_batches=2, batch_size=bs)

  return hook


def _train(cfg: Config, args) -> None:
  mesh = None
  n_dev = len(jax.devices())
  if cfg.parallel.pipeline_stages > 1:
    # pipeline-parallel DiT training: pipe-only mesh (the GPipe
    # schedule owns all devices; parallel/pipeline.py)
    import numpy as np
    from jax.sharding import Mesh
    s = cfg.parallel.pipeline_stages
    if n_dev < s:
      raise ValueError(f'pipeline_stages={s} but only {n_dev} devices')
    mesh = Mesh(np.asarray(jax.devices()[:s]).reshape(s), ('pipe',))
    LOGGER.info('pipeline mesh: %s', mesh)
  elif n_dev > 1:
    from svdd.parallel import mesh as M
    # the per-host batch must divide the data axis; clamp to the
    # largest usable device count rather than crash on tiny batches
    per_host = cfg.loader.global_batch_size // jax.process_count()
    model_axis = max(1, cfg.parallel.model_axis)
    data_axis = n_dev // model_axis
    while data_axis > 1 and per_host % data_axis:
      data_axis -= 1
    used = data_axis * model_axis
    if used < n_dev:
      LOGGER.warning(
          'per-host batch %d not divisible by %d devices; using a '
          '%dx%d mesh on %d of them', per_host, n_dev, data_axis,
          model_axis, used)
    mesh = M.make_mesh(data=data_axis, model=model_axis,
                       devices=jax.devices()[:used])
    LOGGER.info('mesh: %s', mesh)
  num_shards, shard_index = jax.process_count(), jax.process_index()
  train_it, valid_it, _ = gosai.get_dataloaders(
      cfg, num_shards=num_shards, shard_index=shard_index,
      data_dir=args.data_dir, shard_data=args.shard_data)
  model = Diffusion(cfg, rng=jax.random.key(cfg.seed))
  from svdd.observability import MetricsLogger
  logger = MetricsLogger(log_dir=args.log_dir,
                         run_name=f'{cfg.task}-pretrain')
  sample_eval_fn = (None if args.no_sample_eval
                    else _make_sample_eval_fn(cfg, args, model))
  trainer = train_diff.Trainer(model, cfg, mesh=mesh,
                               ckpt_dir=args.ckpt_dir, logger=logger,
                               sample_eval_fn=sample_eval_fn)
  state = trainer.init_or_restore(jax.random.key(cfg.seed), train_it)
  state = trainer.fit(state, train_it, valid_it,
                      num_steps=args.max_steps)
  if args.ckpt_dir:
    train_diff.save_checkpoint(args.ckpt_dir, state,
                               train_it.state_dict())
  logger.finish()


def _ppl_eval(cfg: Config, args) -> None:
  """(main_gosai.py:130-157): NLL/BPD/PPL over the validation split."""
  _, valid_it, _ = gosai.get_dataloaders(cfg, skip_train=True,
                                         data_dir=args.data_dir)
  model = Diffusion(cfg, rng=jax.random.key(cfg.seed))
  trainer = train_diff.Trainer(model, cfg, ckpt_dir=args.ckpt_dir)
  state = trainer.init_or_restore(jax.random.key(cfg.seed))
  nll = trainer.evaluate(state, valid_it, max_batches=16)
  LOGGER.info('val/nll %.4f bpd %.4f ppl %.4f', nll,
              nll / np.log(2), float(np.exp(nll)))


def _sample_eval(cfg: Config, args) -> None:
  """(main_gosai.py:98-128): generate + detokenize samples; with
  sampling.semi_ar, block-wise strided generation
  (restore_model_and_semi_ar_sample, diffusion_gosai.py:1864-1895)."""
  model = Diffusion(cfg, rng=jax.random.key(cfg.seed))
  if args.ckpt_dir:
    state = train_diff.restore_checkpoint(
        args.ckpt_dir, train_diff.init_state(model, cfg,
                                             jax.random.key(0)))
    model.variables = {'params': state.ema.shadow, **state.extras}
  if cfg.sampling.semi_ar:
    from svdd.sampling.semi_ar import semi_ar_sample
    steps, _, full = semi_ar_sample(
        model, cfg.loader.eval_batch_size, cfg.sampling.stride_length,
        cfg.sampling.num_strides, jax.random.key(0))
    LOGGER.info('semi-AR: %d denoiser calls, samples %s', steps,
                full.shape)
    for s in gosai.batch_dna_detokenize(full[:4]):
      LOGGER.info('sample: %s', s)
    return
  sampler = model.sampler(cfg.loader.eval_batch_size)
  all_seqs, all_tokens = [], []
  for i in range(cfg.sampling.num_sample_batches):
    res = sampler(jax.random.key(i))
    tokens = np.asarray(res.samples)
    all_tokens.append(tokens)
    seqs = gosai.batch_dna_detokenize(tokens)
    all_seqs.extend(seqs)
    for s in seqs[:4]:
      LOGGER.info('sample: %s', s)
  if args.gen_ppl_model:
    # generative perplexity under an external AR LM (the reference's
    # compute_generative_perplexity, diffusion_gosai.py:678-737; needs
    # a local HF cache for the model weights). --gen_ppl_model=ar (or
    # any HF-load failure) falls back to the repo's own AR backbone
    # over the raw token samples, so the metric runs offline.
    from svdd.eval import gen_ppl
    def _ar_fallback() -> None:
      if not args.gen_ppl_ar_checkpoint:
        LOGGER.warning('gen_ppl AR fallback: no --gen_ppl_ar_checkpoint'
                       ', scoring with a randomly initialized AR net')
      scorer = gen_ppl.ar_fallback_scorer(
          cfg, args.gen_ppl_ar_checkpoint)
      ppl = gen_ppl.compute_generative_perplexity_local(
          np.concatenate(all_tokens), scorer)
      LOGGER.info('val/gen_ppl (local ar backbone): %.4f', ppl)
    if args.gen_ppl_model == 'ar':
      _ar_fallback()
    else:
      try:
        ppl = gen_ppl.compute_generative_perplexity(
            all_seqs, eval_model_name_or_path=args.gen_ppl_model,
            max_length=cfg.model.length)
        LOGGER.info('val/gen_ppl (%s): %.4f', args.gen_ppl_model, ppl)
      except RuntimeError as exc:
        LOGGER.warning('gen_ppl: HF model unavailable (%s); falling '
                       'back to the local AR backbone', exc)
        _ar_fallback()


def main() -> None:
  p = argparse.ArgumentParser(description='MDLM diffusion pretraining')
  p.add_argument('--task', default='dna', choices=['dna', 'rna'])
  p.add_argument('--mode', default='train',
                 choices=['train', 'ppl_eval', 'sample_eval'])
  p.add_argument('--config', default=None, help='yaml config overlay')
  p.add_argument('--set', nargs='*', default=None,
                 help='dotted overrides, e.g. optim.lr=1e-3')
  p.add_argument('--ckpt_dir', default='./checkpoints')
  p.add_argument('--data_dir', default=None)
  p.add_argument('--max_steps', type=int, default=None)
  p.add_argument('--shard_data', action='store_true', default=False,
                 help='each host reads only its contiguous 1/N row '
                      'shard of the CSV (native sharded reader) '
                      'instead of holding the full dataset per rank')
  p.add_argument('--log_dir', default='./log',
                 help='metrics JSONL output directory')
  p.add_argument('--no_sample_eval', action='store_true', default=False,
                 help='skip the in-training sample-quality validation '
                      '(Wasserstein / k-mer / emb-PCA metrics)')
  p.add_argument('--eval_oracle_checkpoint_path', default=None,
                 help='reward-oracle checkpoint for the sample-quality '
                      'metrics (falls back to the synthetic oracle)')
  p.add_argument('--gen_ppl_model', default=None,
                 help='HF causal-LM name/path for generative-perplexity '
                      'eval in sample_eval mode (e.g. gpt2; needs a '
                      "local HF cache), or 'ar' to score with the "
                      "repo's own AR backbone offline")
  p.add_argument('--gen_ppl_ar_checkpoint', default=None,
                 help='pytree checkpoint for the AR-backbone gen_ppl '
                      'fallback (random init + warning without one)')
  args = p.parse_args()

  cfg = build_config(args)
  _print_config(cfg)
  if args.mode == 'train':
    _train(cfg, args)
  elif args.mode == 'ppl_eval':
    _ppl_eval(cfg, args)
  else:
    _sample_eval(cfg, args)


if __name__ == '__main__':
  main()
